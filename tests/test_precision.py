"""Every matrix product and convolution of the solver asks for full
precision (``lax.Precision.HIGHEST``), read from the jaxpr of each site.
Without it a GPU may run float32 products in TF32 (~3 decimal digits);
tests/test_gpu.py checks the numbers on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import lax

from prost_tpu.linop import BlockConv2D, BlockDense, BlockIdKron, BlockKronId
from prost_tpu.prox import (ProxElemEigenNxN, ProxElemMassNorm,
                            ProxIndEpiPolyhedral, ProxIndRange)

PRODUCTS = ("dot_general", "conv_general_dilated")


def _product_eqns(jaxpr):
    """All matrix-product and convolution equations, sub-jaxprs included
    (loop bodies, conds, nested jits)."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in PRODUCTS:
            yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _product_eqns(inner)


def _sites():
    rng = np.random.RandomState(0)
    M = rng.rand(3, 4)
    dense = BlockDense.create(0, 0, M)
    kron = BlockKronId.create(0, 0, 5, M)
    idkron = BlockIdKron.create(0, 0, 5, M)
    conv = BlockConv2D.create(0, 0, 6, 7, 1, rng.rand(3, 3))
    count = 4
    eig = ProxElemEigenNxN(index=0, size=9 * count, count=count, n=3,
                           interleaved=False, fun="abs",
                           coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
    mass = ProxElemMassNorm(index=0, size=6 * count, count=count, n=4,
                            interleaved=False)
    epi = ProxIndEpiPolyhedral.create(index=0, size=3 * count, count=count,
                                      dim=3, a=rng.randn(5, 2),
                                      b=rng.rand(5))
    rng_proj = ProxIndRange.create(0, 8, np.linalg.qr(rng.randn(8, 3))[0])

    def prox(p):
        return lambda v: p.eval_local(v, jnp.ones_like(v), 1.0, False)

    return {
        "dense_apply": (dense.apply, 4),
        "dense_adjoint": (dense.apply_adjoint, 3),
        "kron_apply": (kron.apply, 20),
        "kron_adjoint": (kron.apply_adjoint, 15),
        "idkron_apply": (idkron.apply, 20),
        "idkron_adjoint": (idkron.apply_adjoint, 15),
        "conv_apply": (conv.apply, 42),
        "conv_adjoint": (conv.apply_adjoint, 8 * 9),
        "eigen_nxn": (prox(eig), 9 * count),
        "mass_norm": (prox(mass), 6 * count),
        "epi_polyhedral": (prox(epi), 3 * count),
        "ind_range": (prox(rng_proj), 8),
    }


SITES = sorted(_sites())


@pytest.mark.parametrize("site", SITES)
def test_products_ask_for_highest_precision(site):
    fn, size = _sites()[site]
    jaxpr = jax.make_jaxpr(fn)(jnp.ones(size, jnp.float32)).jaxpr
    eqns = list(_product_eqns(jaxpr))
    assert eqns, f"{site}: no matrix product found"
    for eqn in eqns:
        prec = eqn.params["precision"]
        prec = prec if isinstance(prec, tuple) else (prec,)
        assert all(p == lax.Precision.HIGHEST for p in prec), (site, prec)
