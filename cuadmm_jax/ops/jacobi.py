"""Batched cyclic-Jacobi symmetric eigendecomposition in plain jnp.

The same method as cuSOLVER's DsyevjBatched (reference:
include/cuadmm/cusolver.h:102-171 -- batched Jacobi, tol 1e-6, <=15
sweeps), selectable per bucket as ``projection="jacobi"``. On the GPU,
``jnp.linalg.eigh`` itself already reaches cuSOLVER's batched Jacobi for
small blocks, so this module is the portable reference for the method.

Layout: the batch lives in the last dimension, so every rotation update
is one elementwise op across the whole batch. A (B, n, n) bucket is
transposed to (n, n, B), rotated, and transposed back.

Eigenvalues are NOT sorted (the PSD projection does not need ordering;
``jnp.linalg.eigh`` sorts, so tests compare against sorted outputs).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def default_sweeps(n: int) -> int:
    """Sweep counts sized for ~1e-6 off-diagonal reduction (cf. the
    reference's syevj tol 1e-6 / max 15 sweeps, cusolver.h:112-114)."""
    if n <= 4:
        return 6
    if n <= 8:
        return 8
    if n <= 16:
        return 10
    return 12


def _pair_schedule(n: int) -> np.ndarray:
    """Cyclic-by-rows pivot order: all (p, q), p < q."""
    return np.array([(p, q) for p in range(n) for q in range(p + 1, n)], dtype=np.int32)


def _rotation(app, aqq, apq, eps):
    """Jacobi rotation (c, s) zeroing a_pq; c=1, s=0 when already zero."""
    one = jnp.asarray(1.0, app.dtype)
    zero = jnp.asarray(0.0, app.dtype)
    safe = jnp.abs(apq) > eps
    denom = jnp.where(safe, 2.0 * apq, one)
    theta = (aqq - app) / denom
    t = jnp.sign(theta) / (jnp.abs(theta) + jnp.sqrt(1.0 + theta * theta))
    t = jnp.where(theta == 0.0, one, t)  # theta=0 -> 45-degree rotation
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    return jnp.where(safe, c, one), jnp.where(safe, s, zero)


def _rotate_ref(a, v, p, q, eps):
    """One Jacobi rotation applied in batch-last layout.

    ``a``/``v`` support __getitem__/__setitem__ on (n, n, B)-shaped data
    (the _AtWrapper adapter over jnp arrays)."""
    row_p = a[p, :, :]
    row_q = a[q, :, :]
    app = row_p[p, :]
    aqq = row_q[q, :]
    apq = row_p[q, :]
    c, s = _rotation(app, aqq, apq, eps)

    a[p, :, :] = c * row_p - s * row_q
    a[q, :, :] = s * row_p + c * row_q
    col_p = a[:, p, :]
    col_q = a[:, q, :]
    a[:, p, :] = c * col_p - s * col_q
    a[:, q, :] = s * col_p + c * col_q

    vrow_p = v[p, :, :]
    vrow_q = v[q, :, :]
    v[p, :, :] = c * vrow_p - s * vrow_q
    v[q, :, :] = s * vrow_p + c * vrow_q


class _AtWrapper:
    """Mutable-view adapter so the same rotation code drives jnp arrays."""

    def __init__(self, arr):
        self.arr = arr

    def __getitem__(self, idx):
        return self.arr[idx]

    def __setitem__(self, idx, val):
        self.arr = self.arr.at[idx].set(val)


# ----------------------------------------------------------------------
# Pure-jnp implementation.
# ----------------------------------------------------------------------


def jacobi_eigh_jnp(
    mats: jax.Array, sweeps: Optional[int] = None
) -> Tuple[jax.Array, jax.Array]:
    """Batched Jacobi eigh, pure jnp. mats: (B, n, n) symmetric.

    Returns (w (B, n) unsorted, v (B, n, n)) with mats @ v ~= v * w
    (columns of v are eigenvectors, jnp.linalg.eigh convention)."""
    b, n, _ = mats.shape
    if n == 1:
        return mats[:, :, 0], jnp.ones_like(mats)
    sweeps = default_sweeps(n) if sweeps is None else sweeps
    eps = 1e-30 if mats.dtype == jnp.float64 else 1e-18
    pairs = jnp.asarray(_pair_schedule(n))

    a0 = jnp.transpose(mats, (1, 2, 0))  # (n, n, B)
    v0 = jnp.broadcast_to(jnp.eye(n, dtype=mats.dtype)[:, :, None], (n, n, b))

    def body(step, carry):
        a, v = carry
        pair = step % pairs.shape[0]
        aw, vw = _AtWrapper(a), _AtWrapper(v)
        _rotate_ref(aw, vw, pairs[pair, 0], pairs[pair, 1], eps)
        return aw.arr, vw.arr

    a, v = jax.lax.fori_loop(0, sweeps * pairs.shape[0], body, (a0, v0))
    w = jnp.diagonal(a, axis1=0, axis2=1)  # (B, n)
    # Rows of v (in batch-last layout) are eigenvectors; convert to
    # batch-first with eigenvectors in columns: v_out[b, :, i] = eigvec i.
    v_out = jnp.transpose(v, (2, 1, 0))
    return w, v_out
