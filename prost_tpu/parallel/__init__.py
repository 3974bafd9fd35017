"""Scale-out layer: device meshes, batched problem ensembles, and
spatially-sharded solving.

The reference is single-process single-GPU (SURVEY.md section 2.8); this
package adds what it lacks:

* ``mesh``     — mesh construction helpers over jax.devices().
* ``ensemble`` — solve B independent problem instances at once: the solver
  state (and any per-instance problem data) gains a leading batch axis,
  the PDHG step is vmapped, and the batch axis is sharded over the
  mesh ('dp'-style data parallelism over problem instances).
* ``spatial``  — shard the long pixel axis of a single big problem over the
  mesh: state vectors get named shardings and XLA's SPMD partitioner
  inserts the halo exchanges (gradient stencils) and psums (residual norms)
  — the "annotate shardings, let the compiler place collectives" recipe.
"""

from .ensemble import BatchedPDHG, stack_problems
from .mesh import make_mesh
from .spatial import ShardedPDHG

__all__ = ["make_mesh", "stack_problems", "BatchedPDHG", "ShardedPDHG"]
