"""Batched Jacobi eigh vs numpy/XLA eigh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cuadmm_jax.ops.jacobi import jacobi_eigh_jnp


def random_sym(b, n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((b, n, n)).astype(dtype)
    return (m + np.swapaxes(m, 1, 2)) / 2


def check(mats, w, v, tol):
    w = np.asarray(w)
    v = np.asarray(v)
    b, n, _ = mats.shape
    # Eigen decomposition property: A v_i = w_i v_i.
    recon = np.einsum("bij,bj,bkj->bik", v, w, v)
    scale = np.abs(mats).max() + 1.0
    assert np.abs(recon - mats).max() < tol * scale
    # Orthogonality.
    vtv = np.einsum("bji,bjk->bik", v, v)
    eye = np.broadcast_to(np.eye(n), (b, n, n))
    assert np.abs(vtv - eye).max() < tol
    # Eigenvalues match numpy's (sorted).
    w_np = np.linalg.eigvalsh(mats)
    assert np.abs(np.sort(w, axis=1) - w_np).max() < tol * scale


@pytest.mark.parametrize("n", [2, 3, 4, 8, 16])
def test_jacobi_jnp_f64(n):
    mats = random_sym(17, n, seed=n)
    w, v = jacobi_eigh_jnp(jnp.asarray(mats))
    check(mats, w, v, 1e-9)


def test_jacobi_jnp_f32():
    mats = random_sym(33, 8, seed=1, dtype=np.float32)
    w, v = jacobi_eigh_jnp(jnp.asarray(mats))
    check(mats, w, v, 5e-5)


def test_jacobi_trivial_one():
    mats = random_sym(5, 1, seed=2)
    w, v = jacobi_eigh_jnp(jnp.asarray(mats))
    np.testing.assert_allclose(np.asarray(w), mats[:, :, 0])


def test_jacobi_degenerate_eigenvalues():
    """Repeated eigenvalues and zero matrices must not break rotations."""
    mats = np.zeros((3, 6, 6))
    mats[1] = np.eye(6) * 2.0
    q, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((6, 6)))
    mats[2] = (q[:, :3] * 1.5) @ q[:, :3].T  # rank-3, eigenvalues {1.5, 0}
    w, v = jacobi_eigh_jnp(jnp.asarray(mats))
    check(mats, w, v, 1e-9)
