"""Card-only tests (marker ``gpu``): the generic path on the GPU against the
same program on the CPU, and full float32 precision of the matrix products
and convolutions.  They skip without a GPU; chip_smoke.py runs them on the
card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from prost_tpu.backend import BackendPDHG, PDHGOptions
from prost_tpu.linop import BlockConv2D, BlockIdKron, BlockKronId

from problems import (deblur_problem, ml_problem, rof_problem, tight_problem,
                      vol_problem, zero_tol_opts)

pytestmark = pytest.mark.gpu


def _build(structure):
    rng = np.random.RandomState(3)
    if structure == "rof":
        return rof_problem(64, 48, rng.rand(64 * 48), 8.0)
    if structure == "tvl1":
        return rof_problem(64, 48, rng.rand(64 * 48), 1.0, dataterm="abs")
    if structure == "multilabel":
        return ml_problem(32, 24, 4, rng.rand(32 * 24 * 4), 0.5)
    if structure == "tight":
        return tight_problem(24, 16, L=3, lmb=1.0, seed=3)
    if structure == "deblur":
        return deblur_problem(32, 24, lmb=30.0, seed=3)[0]
    return vol_problem(3, 32, 24, rng.rand(3 * 32 * 24), 6.0)


@pytest.mark.parametrize("structure", ["rof", "tvl1", "multilabel", "tight",
                                       "deblur", "vol"])
def test_gpu_matches_cpu(structure, gpu, cpu):
    """200 constant-step PDHG iterations on the card and on the CPU."""
    opts = PDHGOptions(stepsize="alg1", residual_iter=10,
                       scale_steps_operator=False)
    out = {}
    for dev in (gpu, cpu):
        with jax.default_device(dev):
            b = BackendPDHG(jax.device_put(_build(structure), dev), opts,
                            zero_tol_opts())
            s = b.run(b.initial_state(), 200)
            assert list(s.x.devices()) == [dev]
            out[dev.platform] = (np.asarray(s.x, np.float64),
                                 np.asarray(s.y, np.float64))
    for g, c in zip(out["gpu"], out["cpu"]):
        assert np.linalg.norm(g - c) <= 1e-5 * np.linalg.norm(c)


def test_products_are_full_float32(gpu):
    """The f32 kron and conv applies agree with the float64 product to
    rtol 1e-6.  Under TF32 (~3 decimal digits) they would not.  Data and
    kernel are positive, so no cancellation inflates the relative error."""
    rng = np.random.RandomState(0)
    L, n = 8, 4096
    M = rng.rand(L, L).astype(np.float32)
    x = rng.rand(L * n).astype(np.float32)
    m64, x64 = M.astype(np.float64), x.astype(np.float64)
    kern = rng.rand(3, 3).astype(np.float32)
    img = rng.rand(64 * 96).astype(np.float32)
    with jax.default_device(gpu):
        kron = BlockKronId.create(0, 0, n, M)
        idkron = BlockIdKron.create(0, 0, n, M)
        conv = BlockConv2D.create(0, 0, 64, 96, 1, kern)
        got = {
            "kron": np.asarray(kron.apply(jnp.asarray(x))),
            "kron_adj": np.asarray(kron.apply_adjoint(jnp.asarray(x))),
            "idkron": np.asarray(idkron.apply(jnp.asarray(x))),
            "conv": np.asarray(conv.apply(jnp.asarray(img))),
        }
    from scipy.signal import convolve2d

    want = {
        "kron": (m64 @ x64.reshape(L, n)).reshape(-1),
        "kron_adj": (m64.T @ x64.reshape(L, n)).reshape(-1),
        "idkron": (x64.reshape(n, L) @ m64.T).reshape(-1),
        # the block's planes are (x, y) with y fastest; its kernel is (ky, kx)
        "conv": convolve2d(img.astype(np.float64).reshape(64, 96),
                           kern.astype(np.float64).T).reshape(-1),
    }
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
