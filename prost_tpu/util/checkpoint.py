"""Solver-state checkpointing.

The reference has no disk checkpointing; resume means re-solving with
Options.x0/y0 (solver.hpp:62-66).  Here the full solver state is a small
pytree, so checkpoint/resume is exact: every loop-carried quantity
(iterates, step sizes, adaptive-scheme state, iteration counter) survives
— a preempted run resumes where it stopped.
"""

from __future__ import annotations

import numpy as np

import jax


def save_state(path: str, state) -> None:
    """Serialize a solver-state pytree (PDHGState / ADMMState / batched
    variants) to an .npz file."""
    leaves, treedef = jax.tree.flatten(state)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    arrays["__treedef__"] = np.asarray(str(treedef))
    np.savez(path, **arrays)


def load_state(path: str, like):
    """Load a solver-state pytree saved by :func:`save_state`.  ``like`` is
    a state with the same structure (e.g. ``backend.initial_state()``) used
    for the tree definition and dtypes."""
    import jax.numpy as jnp

    data = np.load(path, allow_pickle=False)
    leaves_like, treedef = jax.tree.flatten(like)
    n = len(leaves_like)
    saved = str(data["__treedef__"])
    if saved != str(treedef):
        raise ValueError(
            "checkpoint structure mismatch:\n"
            f"  saved: {saved}\n  expected: {treedef}"
        )
    leaves = [
        jnp.asarray(data[f"leaf_{i}"], leaves_like[i].dtype) for i in range(n)
    ]
    return jax.tree.unflatten(treedef, leaves)
