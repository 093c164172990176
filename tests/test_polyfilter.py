"""Matmul-only PSD projection (composite polynomial sign filter)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cuadmm_jax.ops.polyfilter import (
    SIGN_SCHEDULE_F32,
    SIGN_SCHEDULE_F64,
    matrix_sign,
    psd_project_poly,
    spectral_scale,
)


def random_sym(b, n, seed=0, dtype=np.float64, scale=1.0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((b, n, n)).astype(dtype) * scale
    return (m + np.swapaxes(m, 1, 2)) / 2


def exact_proj(mats):
    w, v = np.linalg.eigh(np.asarray(mats, np.float64))
    return np.einsum("bij,bj,bkj->bik", v, np.maximum(w, 0), v)


def test_schedule_scalar_accuracy():
    """The hard-coded schedules meet their documented sign accuracy."""
    y = np.unique(np.concatenate([np.logspace(-12, 0, 5000), np.linspace(0, 1, 5000)]))
    for sched, l0, tol in [
        (SIGN_SCHEDULE_F64, 1e-6, 1e-12),
        (SIGN_SCHEDULE_F32, 1e-4, 1e-6),
    ]:
        s = y.copy()
        for a, b, c in sched:
            s = a * s + b * s**3 + c * s**5
        assert np.abs(s[y >= l0] - 1).max() < tol
        # Below l0 the estimate stays in [0, 1+eps]: bounded projection error.
        assert s.min() > -1e-9 and s.max() < 1 + 1e-6


def test_spectral_scale_bounds():
    mats = random_sym(9, 24, seed=1)
    s = np.asarray(spectral_scale(jnp.asarray(mats)))
    lam = np.abs(np.linalg.eigvalsh(mats)).max(axis=1)
    assert np.all(s >= lam - 1e-12)
    assert np.all(s <= lam * np.sqrt(24) + 1e-12)


def test_matrix_sign_f64():
    mats = random_sym(6, 16, seed=2)
    s = np.asarray(spectral_scale(jnp.asarray(mats)))[:, None, None]
    z = np.asarray(matrix_sign(jnp.asarray(mats / s)))
    w, v = np.linalg.eigh(mats / s)
    z_exact = np.einsum("bij,bj,bkj->bik", v, np.sign(w), v)
    # random eigenvalues are far from 0 at batch 6x16 w.h.p.
    assert np.abs(z - z_exact).max() < 1e-8


@pytest.mark.parametrize("n", [4, 16, 33])
def test_poly_projection_f64(n):
    mats = random_sym(8, n, seed=n, scale=3.0)
    p = np.asarray(psd_project_poly(jnp.asarray(mats)))
    p_exact = exact_proj(mats)
    scale = np.abs(mats).max()
    assert np.abs(p - p_exact).max() < 1e-7 * scale


def test_poly_projection_f32():
    mats = random_sym(8, 24, seed=5, dtype=np.float32, scale=2.0)
    with jax.default_matmul_precision("highest"):
        p = np.asarray(psd_project_poly(jnp.asarray(mats)))
    p_exact = exact_proj(mats)
    assert np.abs(p - p_exact).max() < 5e-4 * np.abs(mats).max()


def test_poly_projection_near_singular():
    """Matrices with tiny and zero eigenvalues: error stays ~l0*scale."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((16, 16)))
    w = np.array([1.0, 0.5, 1e-3, 1e-5, 1e-7, 0.0, -1e-7, -1e-5,
                  -1e-3, -0.2, -1.0, 2.0, -2.0, 1e-9, -1e-9, 0.3])
    mats = (q * w) @ q.T
    mats = ((mats + mats.T) / 2)[None]
    p = np.asarray(psd_project_poly(jnp.asarray(mats)))
    assert np.abs(p - exact_proj(mats)).max() < 5e-6


def test_poly_projection_zero_and_padding():
    """Zero matrices and zero padding rows stay exactly zero."""
    mats = np.zeros((2, 8, 8))
    mats[1, :4, :4] = np.eye(4)  # padded PSD block
    p = np.asarray(psd_project_poly(jnp.asarray(mats)))
    np.testing.assert_allclose(p[0], 0.0, atol=1e-12)
    np.testing.assert_allclose(p[1, 4:, :], 0.0, atol=1e-12)
    np.testing.assert_allclose(p[1, :4, :4], np.eye(4), atol=1e-9)


def test_poly_projection_psd_blockdiag_packing():
    """Packing exactness: projecting blkdiag(A, B) == blkdiag(proj A, proj B)."""
    a = random_sym(1, 5, seed=9)[0]
    b = random_sym(1, 7, seed=10)[0]
    m = np.zeros((1, 12, 12))
    m[0, :5, :5] = a
    m[0, 5:, 5:] = b
    p = np.asarray(psd_project_poly(jnp.asarray(m)))
    pa = exact_proj(a[None])[0]
    pb = exact_proj(b[None])[0]
    assert np.abs(p[0, :5, :5] - pa).max() < 1e-7
    assert np.abs(p[0, 5:, 5:] - pb).max() < 1e-7
    assert np.abs(p[0, :5, 5:]).max() < 1e-7


def test_solver_with_poly_projection():
    """End-to-end: certified random SDP converges with projection='poly'."""
    from cuadmm_jax import SDPSolver, SolverConfig
    from cuadmm_jax.models.random_sdp import random_certified_sdp

    blk = [("s", 6), ("s", 4), ("s", 5)]
    prob, *_, pobj = random_certified_sdp(blk, con_num=12, seed=13)
    cfg = SolverConfig(
        verbose=False, check_every=25, switch_admm=10**9, projection="poly",
        pack_to=16,
    )
    res = SDPSolver(prob, cfg).solve(max_iter=8000, stop_tol=1e-6)
    assert res.converged
    assert abs(res.pobj - pobj) / (1 + abs(pobj)) < 1e-4
