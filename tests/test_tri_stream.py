"""Packed/banded block-triangular Cholesky + sweeps (ops/tri_stream.py).

The large-con_num normal-equation path (the role CHOLMOD plays in the
reference, cholesky_cpu.h:62-155). The sweeps are plain XLA, so these
tests run them as compiled for the CPU against host f64 solves; the same
code as compiled for the GPU is checked by tests/test_gpu.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from cuadmm_jax.ops.tri_stream import (
    band_cholesky,
    band_solve,
    make_band_layout,
    make_layout,
    packed_cholesky,
    packed_solve,
    scatter_band_aat,
    scatter_packed_aat,
    tid,
    tid_band,
)


def _random_aat(n, density=0.05, seed=1):
    A = sp.random(n, 2 * n, density=density, random_state=seed, format="csr")
    aat = (A @ A.T).tocsr()
    return aat


@pytest.mark.parametrize("n,block", [(300, 64), (500, 128), (120, 128)])
def test_packed_cholesky_matches_dense(n, block):
    aat = _random_aat(n)
    lay = make_layout(n, block)
    dm = float(aat.diagonal().mean())
    coo = aat.tocoo()
    tiles = scatter_packed_aat(
        coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data,
        lay, 1e-6, dm, jnp.float64,
    )
    fac = np.asarray(packed_cholesky(tiles, lay))
    # Rebuild dense L (un-invert the diagonal tiles).
    B = block
    L = np.zeros((lay.n_pad, lay.n_pad))
    for i in range(lay.nb):
        for j in range(i + 1):
            blk = fac[tid(i, j)]
            if i == j:
                blk = np.linalg.inv(blk)
            L[i * B : (i + 1) * B, j * B : (j + 1) * B] = blk
    ref = np.asarray(aat.todense()) + 1e-6 * max(dm, 1.0) * np.eye(n)
    refp = np.pad(ref, ((0, lay.n_pad - n), (0, lay.n_pad - n)))
    refp += np.diag(np.r_[np.zeros(n), np.ones(lay.n_pad - n)])
    Lref = np.linalg.cholesky(refp)
    assert np.linalg.norm(np.tril(L) - Lref) / np.linalg.norm(Lref) < 1e-10


@pytest.mark.parametrize("n,block", [(300, 64), (257, 128), (1000, 128), (64, 64)])
def test_packed_solve_interpret(n, block):
    """Device factor + sweeps against a host f64 solve, at sizes that are
    and are not multiples of the block."""
    aat = _random_aat(n)
    lay = make_layout(n, block)
    dm = float(aat.diagonal().mean())
    coo = aat.tocoo()
    tiles = scatter_packed_aat(
        coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data,
        lay, 1e-6, dm, jnp.float64,
    )
    fac = packed_cholesky(tiles, lay)
    rng = np.random.default_rng(0)
    r = rng.standard_normal(n)
    y = packed_solve(fac, jnp.asarray(r), lay)
    ref = np.linalg.solve(
        np.asarray(aat.todense()) + 1e-6 * max(dm, 1.0) * np.eye(n), r
    )
    assert np.linalg.norm(np.asarray(y) - ref) / np.linalg.norm(ref) < 1e-10


@pytest.mark.parametrize("n,block", [(256, 128), (200, 128), (390, 128)])
def test_probe_interpret(n, block):
    """Sweeps over a hand-built packed factor (host Cholesky, inverted
    diagonal tiles, identity padding) against a host f64 solve: exercises
    the sweeps without the device factorization."""
    lay = make_layout(n, block)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n))
    p = a @ a.T + n * np.eye(n)
    pp = np.eye(lay.n_pad)
    pp[:n, :n] = p
    l = np.linalg.cholesky(pp)
    tiles = np.zeros((lay.T, block, block))
    for i in range(lay.nb):
        for j in range(i + 1):
            blk = l[i * block : (i + 1) * block, j * block : (j + 1) * block]
            tiles[tid(i, j)] = np.linalg.inv(blk) if i == j else blk
    r = rng.standard_normal(n)
    y = packed_solve(jnp.asarray(tiles), jnp.asarray(r), lay)
    ref = np.linalg.solve(p, r)
    assert np.linalg.norm(np.asarray(y) - ref) / np.linalg.norm(ref) < 1e-12


def test_split_mode_block_diagonal():
    """QUASAR-style structure: all AA^T coupling in a leading prefix +
    a pure-diagonal tail -> auto-detected 'split' mode with an exact
    prefix factor (reference counterpart: CHOLMOD handles the same system
    generically, cholesky_cpu.h:62-155)."""
    from cuadmm_jax.ops import chol as chol_ops
    from cuadmm_jax.ops import sparse as sparse_ops
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    p, tail, vec_len = 20, 200, 600
    Ap = sp.random(p, vec_len, density=0.2, random_state=1, format="lil")
    Ap[:, vec_len - tail :] = 0
    rowst = np.arange(tail)
    colst = vec_len - tail + np.arange(tail)
    Apt = sp.csr_matrix((np.ones(tail), (rowst, colst)), shape=(tail, vec_len))
    A = sp.vstack([Ap.tocsr(), Apt]).tocsr()
    con = p + tail
    coo = A.tocoo()
    r, c, v = coo.col.astype(np.int64), coo.row.astype(np.int64), coo.data
    sa = sparse_ops.build_sparse_a(r, c, v, con, vec_len, jnp.float64)
    neq = chol_ops.build_normal_solver(
        r, c, v, con, vec_len, sa, "auto", jnp.float64, dense_chol_max=64
    )
    assert neq.mode == "split" and neq.split_p == p
    rhs = jnp.asarray(A @ rng.standard_normal(vec_len))
    y = jax.jit(neq.solve)(rhs)
    assert float(neq.residual_norm(rhs, y)) < 1e-8


def test_split_mode_diagonal_and_permuted():
    """Generalized split: (a) fully-diagonal AA^T (ros_2000/rose13/cnhil10
    class) solves with no dense factor at all; (b) coupled rows scattered
    through the row order are gathered by the stored permutation."""
    from cuadmm_jax.ops import chol as chol_ops
    from cuadmm_jax.ops import sparse as sparse_ops
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    # (a) diagonal: every constraint touches distinct svec entries.
    con, vec_len = 50, 200
    r = np.arange(con, dtype=np.int64) * 3  # distinct svec cols
    c = np.arange(con, dtype=np.int64)
    v = rng.standard_normal(con) + 2.0
    sa = sparse_ops.build_sparse_a(r, c, v, con, vec_len, jnp.float64)
    neq = chol_ops.build_normal_solver(
        r, c, v, con, vec_len, sa, "auto", jnp.float64
    )
    assert neq.mode == "split" and neq.split_p == 0 and neq.inv_l is None
    rhs = jnp.asarray(rng.standard_normal(con) * v**2)
    y = jax.jit(neq.solve)(rhs)
    assert float(neq.residual_norm(rhs, y)) < 1e-12

    # (b) permuted: coupled rows at ODD indices (share svec columns).
    A = sp.lil_matrix((40, vec_len))
    for i in range(40):
        if i % 2 == 1:
            A[i, 0] = 1.0  # shared column -> coupled
            A[i, 1 + i] = 0.5
        else:
            A[i, 100 + i] = 2.0  # private column -> diagonal row
    A = A.tocsr()
    coo = A.tocoo()
    r2, c2, v2 = coo.col.astype(np.int64), coo.row.astype(np.int64), coo.data
    sa2 = sparse_ops.build_sparse_a(r2, c2, v2, 40, vec_len, jnp.float64)
    neq2 = chol_ops.build_normal_solver(
        r2, c2, v2, 40, vec_len, sa2, "split", jnp.float64
    )
    assert neq2.mode == "split" and neq2.split_p == 20
    assert neq2.split_perm is not None  # non-prefix coupling -> permuted
    rhs2 = jnp.asarray(A @ rng.standard_normal(vec_len))
    y2 = jax.jit(neq2.solve)(rhs2)
    assert float(neq2.residual_norm(rhs2, y2)) < 1e-8


def test_packed_mode_normal_solver():
    """build_normal_solver mode='packed': consistent-rhs solve with
    refinement reaches f64-refinement accuracy on a singular AA^T."""
    from cuadmm_jax.ops import chol as chol_ops
    from cuadmm_jax.ops import sparse as sparse_ops

    rng = np.random.default_rng(5)
    vec_len, con = 300, 120
    # rank-deficient A (some duplicate rows) -> singular AA^T
    A = sp.random(con - 20, vec_len, density=0.1, random_state=2, format="csr")
    A = sp.vstack([A, A[:20]]).tocsr()
    coo = A.tocoo()
    r, c, v = coo.col.astype(np.int64), coo.row.astype(np.int64), coo.data
    sa = sparse_ops.build_sparse_a(r, c, v, con, vec_len, jnp.float64)
    neq = chol_ops.build_normal_solver(
        r, c, v, con, vec_len, sa, "packed", jnp.float64, applies=0
    )
    assert neq.mode == "packed" and neq.packed_tiles is not None
    rhs = jnp.asarray(A @ rng.standard_normal(vec_len))  # consistent
    y = jax.jit(neq.solve)(rhs)
    res = float(neq.residual_norm(rhs, y))
    assert res < 1e-8, res


# ----------------------------------------------------------------------
# Banded mode (round 5): chain-structured AA^T under an RCM ordering.
# ----------------------------------------------------------------------


def _chain_A(n, vec_len_per=6, coupling=30, seed=3):
    """Sparse A whose AA^T is banded: constraint i touches svec columns
    in a window that slides with i (a trajectory/knot-point structure)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    vec_len = n * 2 + coupling + vec_len_per
    for i in range(n):
        base = 2 * i
        for k in rng.choice(coupling + vec_len_per, size=4, replace=False):
            rows.append(i)
            cols.append(base + int(k))
            vals.append(rng.standard_normal())
    return sp.csr_matrix(
        (vals, (rows, cols)), shape=(n, vec_len)
    ), vec_len


@pytest.mark.parametrize("n,block", [(500, 64), (333, 64), (256, 32)])
def test_band_cholesky_and_solve_match_dense(n, block):
    A, _ = _chain_A(n)
    aat = (A @ A.T).tocoo()
    bw = int(np.abs(aat.row - aat.col).max())
    lay = make_band_layout(n, bw, block=block)
    dm = float((A @ A.T).diagonal().mean())
    tiles = scatter_band_aat(
        aat.row.astype(np.int64), aat.col.astype(np.int64), aat.data,
        lay, 1e-8, dm, jnp.float64,
    )
    tiles = band_cholesky(tiles, lay)
    rng = np.random.default_rng(0)
    r = rng.standard_normal(n)
    y = np.asarray(band_solve(tiles, jnp.asarray(r), lay))
    dense = (A @ A.T).todense() + 1e-8 * max(dm, 1.0) * np.eye(n)
    ref = np.linalg.solve(dense, r)
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-7


@pytest.mark.parametrize("n,block,nbw", [(512, 128, 1), (450, 128, 1), (700, 64, 3)])
def test_probe_band_interpret(n, block, nbw):
    """Sweeps over a hand-built band factor (exactly banded SPD matrix,
    host Cholesky, inverted diagonal tiles): the first/off-diagonal/
    diagonal paths and the unused top-left slots all run."""
    rng = np.random.default_rng(0)
    lay = make_band_layout(n, bw=nbw * block, block=block)
    assert lay.nbw == nbw
    npad = lay.n_pad
    a = np.zeros((npad, npad))
    for i in range(lay.nb):
        for j in range(max(0, i - nbw), i + 1):
            a[i * block : (i + 1) * block, j * block : (j + 1) * block] = (
                rng.standard_normal((block, block))
            )
    p = a @ a.T + npad * np.eye(npad)
    for i in range(lay.nb):
        for j in range(lay.nb):
            if abs(i - j) > nbw:
                p[i * block : (i + 1) * block, j * block : (j + 1) * block] = 0.0
    p[n:, :] = 0.0
    p[:, n:] = 0.0
    p[n:, n:] = np.eye(npad - n)
    l = np.linalg.cholesky(p)
    tiles = np.zeros((lay.T + 1, block, block))
    for i in range(lay.nb):
        for j in range(max(0, i - nbw), i + 1):
            blk = l[i * block : (i + 1) * block, j * block : (j + 1) * block]
            tiles[tid_band(i, j, lay)] = np.linalg.inv(blk) if i == j else blk
    r = rng.standard_normal(n)
    y = band_solve(jnp.asarray(tiles), jnp.asarray(r), lay)
    ref = np.linalg.solve(p[:n, :n], r)
    assert np.linalg.norm(np.asarray(y) - ref) / np.linalg.norm(ref) < 1e-12


@pytest.mark.parametrize("shuffle", [False, True])
def test_banded_mode_normal_solver(shuffle):
    """mode='banded': refinement accuracy on a chain AA^T; with the rows
    shuffled the RCM permutation must recover the banded ordering."""
    from cuadmm_jax.ops import chol as chol_ops
    from cuadmm_jax.ops import sparse as sparse_ops

    rng = np.random.default_rng(7)
    A, vec_len = _chain_A(400)
    if shuffle:
        p = rng.permutation(400)
        A = A[p]
    con = 400
    coo = A.tocoo()
    r, c, v = coo.col.astype(np.int64), coo.row.astype(np.int64), coo.data
    sa = sparse_ops.build_sparse_a(r, c, v, con, vec_len, jnp.float64)
    neq = chol_ops.build_normal_solver(
        r, c, v, con, vec_len, sa, "banded", jnp.float64, applies=2
    )
    assert neq.mode == "banded" and neq.band_tiles is not None
    if shuffle:
        assert neq.band_perm is not None
    rhs = jnp.asarray(A @ rng.standard_normal(vec_len))  # consistent
    y = jax.jit(neq.solve)(rhs)
    res = float(neq.residual_norm(rhs, y))
    assert res < 1e-8, res
