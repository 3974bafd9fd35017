"""solve / options / backend factories / debug eval entry points.

Python counterparts of matlab/+prost/{solve.m, options.m, +backend/pdhg.m,
+backend/admm.m, eval_prox.m, eval_linop.m}.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..backend import ADMMOptions, BackendADMM, BackendPDHG, PDHGOptions
from ..solver import Solver, SolverOptions
from .problems import _GraphProblem


@dataclasses.dataclass
class Backend:
    kind: str
    opts: object

    def create(self, problem, solver_opts):
        if self.kind == "pdhg":
            return BackendPDHG(problem, self.opts, solver_opts)
        return BackendADMM(problem, self.opts, solver_opts)


def backend_pdhg(**kw) -> Backend:
    """PDHG backend with MATLAB defaults (+backend/pdhg.m)."""
    return Backend("pdhg", PDHGOptions(**kw))


def backend_admm(**kw) -> Backend:
    """Graph-projection ADMM backend with MATLAB defaults
    (+backend/admm.m)."""
    return Backend("admm", ADMMOptions(**kw))


def options(**kw) -> SolverOptions:
    """Solver options with MATLAB defaults (options.m:4-14)."""
    return SolverOptions(**kw)


def solve(problem, backend: Optional[Backend] = None,
          opts: Optional[SolverOptions] = None):
    """Finalize a modeling-layer problem, solve it, and scatter the solution
    back into the variables (solve.m:5-9).  Returns the SolverResult."""
    backend = backend or backend_pdhg()
    opts = opts or SolverOptions()
    core = problem.finalize() if isinstance(problem, _GraphProblem) else problem
    solver = Solver(core, backend.create, opts)
    result = solver.solve()
    if isinstance(problem, _GraphProblem):
        problem.fill_variables(result)
    return result


def get_all_variables(result, p_vars=(), pc_vars=(), d_vars=(), dc_vars=()):
    """Scatter a SolverResult's four vectors into variable lists
    (get_all_variables.m): x -> p_vars, z -> pc_vars, y -> d_vars,
    w -> dc_vars, each packed contiguously in list order."""
    for flat, var_list in (
        (result.x, p_vars),
        (result.z, pc_vars),
        (result.y, d_vars),
        (result.w, dc_vars),
    ):
        flat = np.asarray(flat)
        idx = 0
        for v in var_list:
            v.val = flat[idx : idx + v.dim]
            idx += v.dim


def eval_prox(func, arg, tau=1.0, tau_diag=None, invert_tau=False):
    """Debug entry point: evaluate a function factory's prox on a host
    vector; returns (result, wall_ms) like prost.eval_prox (eval_prox.m,
    prost.cpp:226-276)."""
    import jax
    import jax.numpy as jnp

    from ..config import dtype

    arg = np.asarray(arg).reshape(-1)
    prox = func(0, arg.size)
    dt = dtype()
    arg_j = jnp.asarray(arg, dt)
    tau_d = (
        jnp.ones(arg.size, dt)
        if tau_diag is None
        else jnp.asarray(np.asarray(tau_diag).reshape(-1), dt)
    )
    fn = jax.jit(
        lambda a, td: prox.eval_local(a, td, tau, invert_tau)
    )
    out = fn(arg_j, tau_d)  # compile
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(arg_j, tau_d)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) * 1e3
    return np.asarray(out), ms


def eval_linop(block_factories, x, adjoint=False):
    """Debug entry point: evaluate a linear operator built from a list of
    ``(block_factory, row, col, nrows, ncols)`` tuples on a host vector;
    returns (result, row_sums, col_sums, wall_ms) like prost.eval_linop
    (eval_linop.m, prost.cpp:157-224)."""
    import jax
    import jax.numpy as jnp

    from ..config import dtype
    from ..linop import LinearOperator

    blocks = []
    for factory, row, col, nrows, ncols in block_factories:
        blk, _sz = factory(row, col, nrows, ncols)
        blocks.append(blk)
    linop = LinearOperator.create(blocks)

    x = jnp.asarray(np.asarray(x).reshape(-1), dtype())
    fn = jax.jit(linop.apply_adjoint if adjoint else linop.apply)
    out = fn(x)
    jax.block_until_ready(out)
    # average over 5 repeats, matching the reference's timed eval
    # (linearoperator.cu:177-194)
    repeats = 5
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(x)
        jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) * 1e3 / repeats
    return (
        np.asarray(out),
        np.asarray(linop.row_sum(1.0)),
        np.asarray(linop.col_sum(1.0)),
        ms,
    )
