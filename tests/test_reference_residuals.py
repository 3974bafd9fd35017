"""Reference-exact residual mode (PDHGOptions.reference_residuals).

A pure-numpy PDHG transcribing the reference's EXACT operation order
(backend_pdhg.cu PerformIteration :313-381 — every-iteration prev swaps,
residuals from the stale kty pair before the kty refresh at :377-380,
boyd adaptation :462-476) is the oracle; the backend in reference mode
must match its residuals, adaptive step sizes, and iterates step for
step, while the default (consistent-iterates) mode must diverge from it
in the adaptation trajectory — that divergence is exactly what the flag
exists to eliminate for A/B validation.
"""

import numpy as np
import pytest

import prost_tpu as pt
from prost_tpu.backend import BackendPDHG, PDHGOptions

from problems import rof_problem, zero_tol_opts
from test_linop import spmat_gradient2d


def numpy_reference_pdhg(nx, ny, f, lmb, iters, ri, arb_delta=1.05,
                         arb_tau=0.8):
    """Transcription of the reference iteration order for the ROF problem
    with the alpha preconditioner (Sigma = 1/2, Tau = 1/4) and the boyd
    scheme.  All arrays float64; returns the full per-residual-iteration
    trace plus the final iterates."""
    n = nx * ny
    K = spmat_gradient2d(nx, ny, 1)
    Sigma, Tau = 0.5, 0.25
    sS, sT = np.sqrt(Sigma), np.sqrt(Tau)
    tau = sigma = 1.0
    theta = 1.0
    arb_l = arb_u = 0.0
    eps = 0.0  # zero tolerances: pure trajectory

    x = np.zeros(n)
    y = np.zeros(2 * n)
    kx = np.zeros(2 * n)
    kty = np.zeros(n)
    kx_prev = np.zeros(2 * n)
    kty_prev = np.zeros(n)
    trace = []
    for k in range(iters):
        temp = x - tau * Tau * kty
        x_prev = x
        # prox_g: lmb/2 (x - f)^2 with per-element step tau*Tau
        t = tau * Tau
        x = (temp + t * lmb * f) / (1.0 + t * lmb)
        kx_prev = kx.copy()
        kx = K @ x
        temp_y = y + sigma * Sigma * ((1 + theta) * kx - theta * kx_prev)
        y_prev = y
        # prox_fstar: projection onto the per-pixel unit ball
        g = temp_y.reshape(2, n)
        nrm = np.maximum(np.sqrt((g ** 2).sum(axis=0)), 1.0)
        y = (g / nrm[None, :]).reshape(-1)

        if k % ri == 0:
            z_hat = (y_prev - y) / (sigma * sS) + sS * (
                (1 + theta) * kx - theta * kx_prev)
            p_res = np.linalg.norm(z_hat - sS * kx)
            p_nrm = np.linalg.norm(z_hat)
            w_hat = (x_prev - x) / (tau * sT) - sT * kty_prev
            d_res = np.linalg.norm(w_hat + sT * kty)  # STALE kty = K^T y^k
            d_nrm = np.linalg.norm(w_hat)
            eps_pri = np.sqrt(2.0 * n) * eps + eps * p_nrm
            eps_dua = np.sqrt(1.0 * n) * eps + eps * d_nrm
            if d_res < eps_dua and arb_tau * k > arb_l:
                tau /= arb_delta
                sigma *= arb_delta
                arb_u = k
            elif p_res < eps_pri and arb_tau * k > arb_u:
                tau *= arb_delta
                sigma /= arb_delta
                arb_l = k
            trace.append((k, p_res, p_nrm, d_res, d_nrm, tau, sigma))

        kty_prev = kty.copy()
        kty = K.T @ y

    return x, y, tau, sigma, trace


@pytest.mark.parametrize("ri", [1, 3])
def test_reference_mode_matches_numpy_transcription(ri):
    nx, ny = 12, 10
    n = nx * ny
    rng = np.random.RandomState(4)
    f = rng.rand(n).astype(np.float32)
    lmb = 8.0
    iters = 25

    x_np, y_np, tau_np, sigma_np, trace = numpy_reference_pdhg(
        nx, ny, f.astype(np.float64), lmb, iters, ri)

    prob = rof_problem(nx, ny, f, lmb)
    popts = PDHGOptions(stepsize="boyd", residual_iter=ri,
                        scale_steps_operator=False,
                        reference_residuals=True)
    b = BackendPDHG(prob, popts, zero_tol_opts())
    s = b.run(b.initial_state(), iters)

    assert int(s.iteration) == iters
    np.testing.assert_allclose(np.asarray(s.x), x_np, atol=2e-5)
    np.testing.assert_allclose(np.asarray(s.y), y_np, atol=2e-5)
    # the adaptation trajectory — the whole point of the flag
    np.testing.assert_allclose(float(s.tau), tau_np, rtol=1e-5)
    np.testing.assert_allclose(float(s.sigma), sigma_np, rtol=1e-5)
    k, p_res, p_nrm, d_res, d_nrm, _, _ = trace[-1]
    np.testing.assert_allclose(float(s.primal_residual), p_res, rtol=1e-4)
    np.testing.assert_allclose(float(s.dual_residual), d_res, rtol=1e-4)
    np.testing.assert_allclose(float(s.dual_var_norm), d_nrm, rtol=1e-4)


def test_default_mode_differs_in_dual_residual():
    """The consistent-iterates default must NOT reproduce the stale dual
    residual — if it did, the flag would be pointless."""
    nx = ny = 12
    n = nx * ny
    rng = np.random.RandomState(5)
    f = rng.rand(n).astype(np.float32)
    prob = rof_problem(nx, ny, f, 8.0)

    common = dict(stepsize="boyd", residual_iter=1,
                  scale_steps_operator=False)
    ref = BackendPDHG(prob, PDHGOptions(reference_residuals=True, **common),
                      zero_tol_opts())
    dflt = BackendPDHG(prob, PDHGOptions(**common), zero_tol_opts())
    rs = ref.run(ref.initial_state(), 9)
    ds = dflt.run(dflt.initial_state(), 9)
    assert not np.isclose(float(rs.dual_residual), float(ds.dual_residual),
                          rtol=1e-3)
