"""Extending the framework with a custom prox operator and block.

The reference exposes extension hooks through custom.cpp + CMake custom
sources (factory.cpp:1014-1035); here extension is plain subclassing:

* a custom prox = a pytree dataclass with ``eval_local`` (pure function)
* a custom block = a pytree dataclass with apply/apply_adjoint/row_sum/col_sum
* optional: register with modeling.wire for serialization

This example adds an elastic-net prox (lmb1 |x| + lmb2/2 x^2 data term) and
a scaled-permutation block, then solves a small denoising problem with them.

Usage: python examples/example_custom_prox.py [--cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from _common import setup_jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    setup_jax(cpu=args.cpu)

    import jax.numpy as jnp

    import prost_tpu as pt
    from prost_tpu.common import pytree_dataclass, static_field
    from prost_tpu.linop import Block
    from prost_tpu.prox import Prox
    from prost_tpu.prox.base import effective_tau

    # --- custom prox: elastic net around a target f --------------------
    @pytree_dataclass
    class ProxElasticNet(Prox):
        """prox of lmb1 |x - f| + lmb2/2 (x - f)^2."""

        index: int = static_field()
        size: int = static_field()
        lmb1: float = static_field()
        lmb2: float = static_field()
        f: jnp.ndarray = None

        @property
        def diagsteps(self):
            return True

        def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
            tau = effective_tau(tau_diag, tau_scal, invert_tau)
            d = arg - self.f
            shrunk = jnp.sign(d) * jnp.maximum(
                jnp.abs(d) - tau * self.lmb1, 0.0)
            return self.f + shrunk / (1.0 + tau * self.lmb2)

    # --- custom block: scaled permutation ------------------------------
    @pytree_dataclass
    class BlockScaledPermute(Block):
        """y = s * x[perm] — a toy structured operator."""

        row: int = static_field()
        col: int = static_field()
        n: int = static_field()
        s: float = static_field()
        perm: jnp.ndarray = None

        @property
        def nrows(self):
            return self.n

        @property
        def ncols(self):
            return self.n

        def apply(self, x_seg):
            return self.s * x_seg[self.perm]

        def apply_adjoint(self, y_seg):
            return self.s * jnp.zeros_like(y_seg).at[self.perm].add(y_seg)

        def row_sum(self, alpha):
            return jnp.full(self.n, abs(self.s) ** alpha)

        def col_sum(self, alpha):
            return jnp.full(self.n, abs(self.s) ** alpha)

    # --- use them through the modeling layer ---------------------------
    n = 256
    rng = np.random.RandomState(0)
    f = rng.rand(n).astype(np.float32)
    perm = np.argsort(rng.rand(n)).astype(np.int32)

    u = pt.Variable(n)
    q = pt.Variable(n)
    prob = pt.MinMaxProblem([u], [q])
    prob.add_function(
        u, lambda idx, cnt: ProxElasticNet(index=idx, size=cnt, lmb1=0.3,
                                           lmb2=2.0, f=jnp.asarray(f)))
    # dual of lmb |z|: ball indicator via built-in factory
    prob.add_function(q, pt.function.conjugate(pt.function.sum_1d("abs")))
    prob.add_dual_pair(
        u, q,
        lambda row, col, nrows, ncols: (
            BlockScaledPermute(row=row, col=col, n=n, s=0.5,
                               perm=jnp.asarray(perm)),
            (n, n)))

    res = pt.solve(prob, pt.backend_pdhg(),
                   pt.options(max_iters=2000, verbose=True,
                              tol_rel_primal=1e-6, tol_rel_dual=1e-6,
                              tol_abs_primal=1e-6, tol_abs_dual=1e-6))
    print("result:", res.result.value, "| u[:4] =", u.val[:4])
    return 0


if __name__ == "__main__":
    sys.exit(main())
