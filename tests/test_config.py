"""Config / dtype / device-management tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import prost_tpu as pt


def test_list_devices_and_set_device():
    devs = pt.list_devices()
    assert len(devs) == 8  # virtual CPU mesh from conftest
    pt.set_device(1)
    x = jnp.zeros(4) + 1.0
    assert list(x.devices())[0] == devs[1]
    pt.set_device(0)


def _f64_rof_solve():
    """Full ROF solve in float64 (x64 enabled) to tol 1e-8 on the default
    device: a tighter residual than single precision typically reaches —
    the reference's double mode (config.hpp:6-7)."""
    from prost_tpu.backend import BackendPDHG, PDHGOptions
    from prost_tpu.linop import BlockGradient2D, LinearOperator
    from prost_tpu.prox import ProxElem1D, ProxElemNorm2, ProxMoreau

    jax.config.update("jax_enable_x64", True)
    pt.set_dtype(jnp.float64)
    try:
        nx = ny = 16
        n = nx * ny
        rng = np.random.RandomState(0)
        f = rng.rand(n)
        grad = BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
        prox_g = [ProxElem1D(index=0, size=n, fun="square",
                             coeffs=(1.0, f, 5.0, 0.0, 0.0, 0.0, 0.0))]
        pn = ProxElemNorm2(index=0, size=2 * n, count=n, dim=2,
                           interleaved=False, fun="abs",
                           coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
        prob = pt.Problem.create(
            LinearOperator.create([grad]), prox_g=prox_g,
            prox_fstar=[ProxMoreau(index=0, size=2 * n, child=pn)])
        assert prob.scaling_left.dtype == jnp.float64
        opts = pt.SolverOptions(max_iters=20000, verbose=False,
                                tol_rel_primal=1e-8, tol_rel_dual=1e-8,
                                tol_abs_primal=1e-8, tol_abs_dual=1e-8)
        solver = pt.Solver(
            prob, lambda p, o: BackendPDHG(p, PDHGOptions(), o), opts)
        res = solver.solve()
        assert res.x.dtype == np.float64
        assert res.result == pt.ConvergenceResult.CONVERGED
        return prob
    finally:
        pt.set_dtype(jnp.float32)
        jax.config.update("jax_enable_x64", False)


def test_f64_solve_parity():
    _f64_rof_solve()


@pytest.mark.gpu
def test_f64_solve_parity_on_gpu(gpu):
    """The same float64 solve on the card (native f64 there)."""
    with jax.default_device(gpu):
        prob = _f64_rof_solve()
    assert list(prob.scaling_left.devices()) == [gpu]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    import os

    from prost_tpu.config import use_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    use_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(pt.__file__)))
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        root, ".jax_cache")


def test_compile_cache_env_wins(monkeypatch, restore_cache_dir, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it and the helper sets
    nothing."""
    from prost_tpu.config import use_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    use_compile_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)
