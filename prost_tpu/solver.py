"""Solver driver: outer loop, convergence test, callbacks.

Counterpart of /root/reference/src/solver.cu.  The iteration loop
itself lives inside the backend's jitted ``lax.while_loop``; the driver runs
it in chunks between callback epochs (linspace schedule, solver.cu:130-135)
so user callbacks observe (iter, x, y) on the host exactly like the
reference's MATLAB interm callback, while the hot loop never leaves the
device.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Callable, Optional

import numpy as np

from .common import linspace
from .config import ProstError


class ConvergenceResult(Enum):
    CONVERGED = "converged"
    STOPPED_MAX_ITERS = "max_iters"
    STOPPED_USER = "user"


@dataclasses.dataclass
class SolverOptions:
    """Mirror of Solver<T>::Options (solver.hpp:39-70) with the MATLAB
    defaults (matlab/+prost/options.m:4-14)."""

    tol_rel_primal: float = 1e-4
    tol_rel_dual: float = 1e-4
    tol_abs_primal: float = 1e-4
    tol_abs_dual: float = 1e-4
    max_iters: int = 1000
    num_cback_calls: int = 10
    verbose: bool = True
    interm_cb: Optional[Callable] = None   # (iter, x, y) -> bool (converged?)
    stopping_cb: Optional[Callable] = None  # () -> bool (user abort?)
    x0: Optional[np.ndarray] = None
    y0: Optional[np.ndarray] = None
    solve_dual: bool = False


@dataclasses.dataclass
class SolverResult:
    x: np.ndarray
    z: np.ndarray
    y: np.ndarray
    w: np.ndarray
    result: ConvergenceResult
    iterations: int
    primal_residual: float
    dual_residual: float


class Solver:
    """Drives a backend over a problem (Solver<T>, solver.cu)."""

    def __init__(self, problem, backend_factory, opts: SolverOptions):
        self.opts = opts
        if opts.solve_dual:
            # solve the dual problem, swap x0/y0 (solver.cu:80-84)
            problem = problem.dualize()
            opts = dataclasses.replace(opts, x0=opts.y0, y0=opts.x0)
            self.opts = opts
        self.problem = problem
        self.backend = backend_factory(problem, opts)

        if opts.verbose:
            print(f"# primal variables: {problem.ncols}")
            print(f"# dual variables: {problem.nrows}")
            self._print_memory_report()

    @staticmethod
    def _print_memory_report():
        """Device memory report (solver.cu:99-114 prints free/total GPU
        memory; here we read the live allocator stats when available)."""
        from .util.profiling import memory_stats

        try:
            stats = memory_stats()
        except Exception:
            return
        in_use = stats.get("bytes_in_use")
        limit = stats.get("bytes_limit")
        if in_use is not None and limit:
            print(
                f"# device memory: {in_use / 2**20:.1f} MB in use / "
                f"{limit / 2**20:.1f} MB"
            )

    def solve(self) -> SolverResult:
        opts = self.opts
        backend = self.backend
        state = backend.initial_state()

        if opts.num_cback_calls >= 2:
            cb_iters = [
                int(v) for v in linspace(0, opts.max_iters - 1, opts.num_cback_calls)
            ]
        else:
            cb_iters = [10**8]

        result = ConvergenceResult.STOPPED_MAX_ITERS
        i = 0
        stopped = False
        while i < opts.max_iters:
            # run on-device until the next callback epoch (inclusive) —
            # the jitted while_loop exits early on convergence
            next_stop = opts.max_iters
            for c in cb_iters:
                if c >= i:
                    next_stop = min(int(c) + 1, opts.max_iters)
                    break
            state = backend.run(state, next_stop)
            i = int(state.iteration)

            primal_res = float(state.primal_residual)
            dual_res = float(state.dual_residual)
            is_converged = bool(state.converged)
            is_stopped = bool(opts.stopping_cb()) if opts.stopping_cb else False

            # callback epoch (solver.cu:153-179)
            while cb_iters and cb_iters[0] < i:
                cb_iters.pop(0)

            if opts.num_cback_calls >= 1:
                if opts.verbose:
                    print(
                        f"It {i}: Feas_p={primal_res:.2e}, "
                        f"Feas_d={dual_res:.2e}"
                    )
                if opts.interm_cb is not None:
                    x, z, y, w = backend.current_solution(state)
                    if opts.solve_dual:
                        cb_out = opts.interm_cb(i, np.asarray(y), np.asarray(x))
                    else:
                        cb_out = opts.interm_cb(i, np.asarray(x), np.asarray(y))
                    is_converged |= bool(cb_out)

            if is_stopped:
                if opts.verbose:
                    print("Stopped by user.")
                result = ConvergenceResult.STOPPED_USER
                break
            if is_converged:
                if opts.verbose:
                    print("Reached convergence tolerance.")
                result = ConvergenceResult.CONVERGED
                break

        if opts.verbose and result == ConvergenceResult.STOPPED_MAX_ITERS:
            print(f"Reached maximum of {opts.max_iters} iterations.")

        x, z, y, w = backend.current_solution(state)
        x, z, y, w = (np.asarray(v) for v in (x, z, y, w))
        if opts.solve_dual:
            # un-swap (solver.cu:217-251): user-facing primal is the dual's dual
            x, z, y, w = y, w, x, z
        return SolverResult(
            x=x, z=z, y=y, w=w,
            result=result,
            iterations=i,
            primal_residual=primal_res,
            dual_residual=dual_res,
        )
