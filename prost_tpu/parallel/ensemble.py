"""Batched problem ensembles: B instances solved as one vmapped program,
sharded over the mesh's batch axis.

This is data parallelism over *problem instances* (BASELINE.json config 5:
1024-instance ROF/TV ensemble) — a capability the single-GPU reference does
not have.  All instances must share the same static structure (same blocks,
same prox kinds/sizes); per-instance data (prox coefficients, block values)
may differ and is stacked along a leading batch axis.

Sharding follows the data: ``initial_state`` places the batch axis of the
state (and the stacked problem data) on the mesh's ``dp`` axis via
NamedSharding; the jitted vmapped loop then runs SPMD with zero
inter-instance communication except the single all-reduce in the
convergence test.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..backend.pdhg import BackendPDHG, PDHGOptions, PDHGState, pdhg_step
from ..config import ProstError
from ..problem import Problem
from ..solver import SolverOptions


def stack_problems(problems) -> Problem:
    """Stack structurally identical Problems into one batched pytree
    (array leaves gain a leading batch axis)."""
    if not problems:
        raise ProstError("stack_problems: empty list.")
    treedefs = {jax.tree.structure(p) for p in problems}
    if len(treedefs) != 1:
        raise ProstError(
            "stack_problems: problems have different static structure."
        )
    return jax.tree.map(lambda *leaves: jnp.stack(leaves), *problems)


class BatchedPDHG:
    """Solve a batch of problem instances concurrently with PDHG.

    The per-instance iteration is ``pdhg_step`` vmapped over (problem data,
    state); the batch axis is sharded over ``mesh`` axis ``axis_name``.
    The loop exits when every instance converged (converged instances keep
    iterating harmlessly — PDHG is a fixed-point iteration) or at the
    iteration bound.
    """

    def __init__(self, problems, opts: PDHGOptions = None,
                 solver_opts: SolverOptions = None, mesh=None,
                 axis_name: str = "dp"):
        # scale_steps_operator=False by default: per-instance normest would
        # run B host-side power iterations; pass explicit tau0/sigma0, or
        # enable it when instances share one operator
        self.opts = opts or PDHGOptions(scale_steps_operator=False)
        self.solver_opts = solver_opts or SolverOptions(verbose=False)
        self.mesh = mesh
        self.axis_name = axis_name
        self.batch = len(problems)
        if mesh is not None and self.batch % mesh.devices.size != 0:
            raise ProstError(
                f"BatchedPDHG: batch size {self.batch} must be divisible "
                f"by the mesh's {mesh.devices.size} devices (the batch "
                "axis is sharded evenly over the mesh)."
            )

        backends = [
            BackendPDHG(p, self.opts, self.solver_opts) for p in problems
        ]
        self._backend0 = backends[0]
        stack = lambda *leaves: jnp.stack(leaves)
        self.batched_problem = stack_problems(problems)
        self.prox_g = jax.tree.map(stack, *[b.prox_g for b in backends])
        self.prox_fstar = jax.tree.map(stack, *[b.prox_fstar for b in backends])
        if mesh is not None:
            put = self._put_batched
            self.batched_problem = put(self.batched_problem)
            self.prox_g = put(self.prox_g)
            self.prox_fstar = put(self.prox_fstar)

    def _put_batched(self, tree):
        sh = NamedSharding(self.mesh, P(self.axis_name))
        return jax.tree.map(lambda leaf: jax.device_put(leaf, sh), tree)

    # ------------------------------------------------------------------
    def initial_state(self) -> PDHGState:
        state0 = self._backend0.initial_state()
        batched = jax.tree.map(
            lambda leaf: jnp.broadcast_to(leaf, (self.batch,) + leaf.shape),
            state0,
        )
        if self.mesh is not None:
            batched = self._put_batched(batched)
        return batched

    # ------------------------------------------------------------------
    def run(self, state: PDHGState, until_iter: int) -> PDHGState:
        sopts = self.solver_opts
        tols = (sopts.tol_rel_primal, sopts.tol_rel_dual,
                sopts.tol_abs_primal, sopts.tol_abs_dual)
        return _batched_pdhg_run(
            self.opts, self.batched_problem, self.prox_g, self.prox_fstar,
            state, jnp.asarray(until_iter, jnp.int32), tols,
        )

    # ------------------------------------------------------------------
    def current_solution(self, state: PDHGState):
        """(x, z, y, w), each with leading batch axis."""
        p = self.batched_problem
        w = (state.x_prev - state.x) / (
            p.scaling_right * state.tau[:, None]
        ) - state.kty_prev
        z = (state.y_prev - state.y) / (
            state.sigma[:, None] * p.scaling_left
        ) + (1.0 + state.theta[:, None]) * state.kx \
            - state.theta[:, None] * state.kx_prev
        return state.x, z, state.y, w


@partial(jax.jit, static_argnums=(0,), donate_argnums=(4,))
def _batched_pdhg_run(opts, batched_problem, prox_g, prox_fstar, state,
                      until, tols):
    def step_one(problem, pg, pf, s):
        return pdhg_step(problem, pg, pf, opts, tols, s)

    vstep = jax.vmap(step_one, in_axes=(0, 0, 0, 0))

    def body(s):
        return vstep(batched_problem, prox_g, prox_fstar, s)

    def cond(s):
        return jnp.any((s.iteration < until) & ~s.converged)

    return jax.lax.while_loop(cond, body, state)
