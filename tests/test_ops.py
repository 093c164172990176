"""Sparse matvecs, row normalization, PSD projection, normal-equation solve.

Mirrors the reference's kernel/cusparse/cusolver/cholesky unit tests
(reference: test/kernels_test.hpp:35-83, test/cusparse_test.hpp:3-166,
test/cusolver_test.hpp:3-371, test/cholesky_cpu_test.hpp:3-160).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cuadmm_jax.ops import sparse as sparse_ops
from cuadmm_jax.ops import chol as chol_ops
from cuadmm_jax.ops.projection import psd_project, xla_eigh, reconstruct_clamped
from cuadmm_jax.ops.svec import device_maps
from cuadmm_jax.structure import BlockStructure


def random_sparse_at(rng, vec_len, con_num, density=0.3):
    mask = rng.random((vec_len, con_num)) < density
    At = np.where(mask, rng.standard_normal((vec_len, con_num)), 0.0)
    rows, cols = np.nonzero(At)
    return rows.astype(np.int32), cols.astype(np.int32), At[rows, cols], At


def test_spmv_both_directions():
    rng = np.random.default_rng(0)
    vec_len, con = 37, 11
    r, c, v, At = random_sparse_at(rng, vec_len, con)
    sa = sparse_ops.build_sparse_a(r, c, v, con, vec_len, jnp.float64)
    x = rng.standard_normal(vec_len)
    y = rng.standard_normal(con)
    np.testing.assert_allclose(
        np.asarray(sparse_ops.spmv_a(sa, jnp.asarray(x))), At.T @ x, rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(sparse_ops.spmv_at(sa, jnp.asarray(y))), At @ y, rtol=1e-12
    )


def test_normalize_rows():
    """Row norms clamped at 1; values divided (reference:
    src/kernels/sparse_matrix_norm.cu:11-44, test/kernels_test.hpp:35-83)."""
    # A^T with 2 constraints: col 0 has norm 5 (3,4), col 1 norm 0.5 (clamped).
    r = np.array([0, 1, 2], dtype=np.int32)
    c = np.array([0, 0, 1], dtype=np.int32)
    v = np.array([3.0, 4.0, 0.5])
    norm, scaled = sparse_ops.normalize_rows(r, c, v, 2)
    np.testing.assert_allclose(norm, [5.0, 1.0])
    np.testing.assert_allclose(scaled, [0.6, 0.8, 0.5])


def test_psd_projection_matches_numpy():
    blk = [("s", 5), ("s", 3), ("s", 5), ("u", 2)]
    st = BlockStructure(blk, rounding="pow2")
    rng = np.random.default_rng(4)
    x = rng.standard_normal(st.vec_len) * 3
    maps = device_maps(st, jnp.float64)
    xp = np.asarray(psd_project(jnp.asarray(x), maps))

    # NumPy reference projection block by block.
    off = 0
    expected = np.empty_like(x)
    for t, n in blk:
        if t == "u":
            expected[off : off + n] = x[off : off + n]
            off += n
            continue
        ln = n * (n + 1) // 2
        r, c = np.tril_indices(n)
        m = np.zeros((n, n))
        sc = np.where(r == c, 1.0, 1 / np.sqrt(2))
        m[r, c] = x[off : off + ln] * sc
        m[c, r] = x[off : off + ln] * sc
        w, v = np.linalg.eigh(m)
        p = (v * np.maximum(w, 0)) @ v.T
        expected[off : off + ln] = p[r, c] * np.where(r == c, 1.0, np.sqrt(2))
        off += ln
    np.testing.assert_allclose(xp, expected, rtol=1e-10, atol=1e-10)


def test_projection_idempotent_and_psd():
    blk = [("s", 8), ("s", 4)]
    st = BlockStructure(blk)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(st.vec_len)
    maps = device_maps(st, jnp.float64)
    p1 = psd_project(jnp.asarray(x), maps)
    p2 = psd_project(p1, maps)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-10)


def test_reconstruct_clamped():
    rng = np.random.default_rng(6)
    m = rng.standard_normal((3, 6, 6))
    m = (m + np.swapaxes(m, 1, 2)) / 2
    w, v = np.linalg.eigh(m)
    out = np.asarray(reconstruct_clamped(jnp.asarray(w), jnp.asarray(v)))
    for i in range(3):
        exp = (v[i] * np.maximum(w[i], 0)) @ v[i].T
        np.testing.assert_allclose(out[i], exp, atol=1e-12)


@pytest.mark.parametrize("mode", ["dense", "inv", "cg", "host"])
def test_normal_solver_modes(mode):
    """(AA^T) y = rhs against a dense numpy solve
    (reference: test/cholesky_cpu_test.hpp hand-computed systems)."""
    rng = np.random.default_rng(7)
    vec_len, con = 50, 12
    r, c, v, At = random_sparse_at(rng, vec_len, con, density=0.4)
    sa = sparse_ops.build_sparse_a(r, c, v, con, vec_len, jnp.float64)
    neq = chol_ops.build_normal_solver(
        r, c, v, con, vec_len, sa, mode, jnp.float64, cg_tol=1e-14, cg_max_iter=500
    )
    rhs = rng.standard_normal(con)
    sol = np.asarray(jax.jit(neq.solve)(jnp.asarray(rhs)))
    aat = At.T @ At  # (con, con): rows of A are columns of At
    expected = np.linalg.solve(aat + 1e-15 * np.eye(con), rhs)
    np.testing.assert_allclose(sol, expected, rtol=1e-6, atol=1e-8)


def test_normal_solver_semidefinite():
    """Rank-deficient AA^T must still factor via adaptive jitter."""
    vec_len, con = 10, 4
    At = np.zeros((vec_len, con))
    At[0, 0] = 1.0
    At[1, 1] = 2.0
    At[0, 2] = 1.0  # constraint 2 duplicates constraint 0 -> singular AA^T
    At[2, 3] = 1.0
    r, c = np.nonzero(At)
    v = At[r, c]
    sa = sparse_ops.build_sparse_a(r.astype(np.int32), c.astype(np.int32), v, con, vec_len, jnp.float64)
    neq = chol_ops.build_normal_solver(r, c, v, con, vec_len, sa, "dense", jnp.float64)
    rhs = np.array([1.0, 1.0, 1.0, 1.0])
    sol = np.asarray(neq.solve(jnp.asarray(rhs)))
    assert np.all(np.isfinite(sol))


def _moment_like_at(rng, vec_len, con_num, dup_frac=0.3):
    """A with near-duplicate rows: cond(AA^T) >= 1e12, the failure mode of
    SPOT moment relaxations (PushT N=10 measures cond ~ 2e17)."""
    base = con_num - int(con_num * dup_frac)
    mask = rng.random((base, vec_len)) < 0.05
    A = np.where(mask, rng.standard_normal((base, vec_len)), 0.0)
    A[np.nonzero(A.sum(axis=1) == 0)[0], 0] = 1.0  # no empty rows
    dups = []
    for i in range(con_num - base):
        j, k = rng.integers(0, base, 2)
        dups.append(A[j] + 1e-7 * A[k])  # nearly dependent
    A = np.vstack([A] + [np.asarray(dups)]) if dups else A
    r, c = np.nonzero(A.T)
    return r.astype(np.int32), c.astype(np.int32), A.T[r, c], A


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_precond_singular_consistent(dtype):
    """The round-1 regression: f32 normal solves on a numerically singular
    AA^T must reach relative residual < 1e-5 on consistent rhs (the VERDICT
    bar; the round-1 'inv' mode measured residual 41 on PushT and the bench
    diverged to NaN). Reference capability bar: CHOLMOD f64 LDLt with
    eps=1e-15 (include/cuadmm/cholesky_cpu.h:50-155)."""
    rng = np.random.default_rng(42)
    vec_len, con = 600, 300
    r, c, v, A = _moment_like_at(rng, vec_len, con)
    dt = jnp.dtype(dtype)
    sa_hp = sparse_ops.build_sparse_a(r, c, v, con, vec_len, jnp.float64)
    sa = sparse_ops.cast_sparse_a(sa_hp, dt)
    neq = chol_ops.build_normal_solver(
        r, c, v, con, vec_len, sa, "precond", dt, sparse_a_hp=sa_hp
    )
    aat = A @ A.T
    assert np.linalg.cond(aat) > 1e10  # the test is only meaningful if hard
    rhs = (aat @ rng.standard_normal(con)).astype(dt)  # consistent
    y = jax.jit(neq.solve)(jnp.asarray(rhs))
    assert np.all(np.isfinite(np.asarray(y)))
    res = float(neq.residual_norm(jnp.asarray(rhs), y))
    assert res < 1e-5, f"normal-solve relative residual {res:.2e} >= 1e-5"


def test_cg_block_jacobi_and_tol():
    """CG upgrades: dtype-aware default tolerance + block-Jacobi
    preconditioner path (reference capability bar: cholesky_cpu.h for
    con_num beyond the dense-factor budget)."""
    rng = np.random.default_rng(9)
    vec_len, con = 400, 96
    r, c, v, At = random_sparse_at(rng, vec_len, con, density=0.2)
    sa = sparse_ops.build_sparse_a(r, c, v, con, vec_len, jnp.float64)
    neq = chol_ops.build_normal_solver(
        r, c, v, con, vec_len, sa, "cg", jnp.float64, cg_block_jacobi=32,
        cg_precond="block_jacobi",
    )
    assert neq.bj_inv is not None and neq.bj_inv.shape == (3, 32, 32)
    assert neq.cg_tol > 0  # dtype-aware default kicked in
    rhs = rng.standard_normal(con)
    y = jax.jit(neq.solve)(jnp.asarray(rhs))
    res = float(neq.residual_norm(jnp.asarray(rhs), y))
    assert res < 1e-8


def test_cg_fsai_preconditioner():
    """FSAI CG preconditioner (ops/fsai.py): G is lower-triangular, the
    ELL tables reproduce G^T G r exactly, and the preconditioned solve
    reaches the same residual as Jacobi-CG. The device-resident analog of the
    reference's CHOLMOD triangular solves (cholesky_cpu.h:62-155)."""
    import scipy.sparse as sp

    from cuadmm_jax.ops.fsai import build_fsai, fsai_tables

    rng = np.random.default_rng(11)
    vec_len, con = 400, 96
    r, c, v, At = random_sparse_at(rng, vec_len, con, density=0.2)
    A = sp.csr_matrix((v, (c, r)), shape=(con, vec_len))
    aat = (A @ A.T).tocsr()

    G = build_fsai(aat, eps_rel=1e-10)
    Gd = np.asarray(G.todense())
    assert np.allclose(Gd, np.tril(Gd))  # lower triangular
    # Normalization: diag(G AAt G^T) ~ 1 on the rows FSAI solved exactly.
    M = G @ aat @ G.T
    assert np.allclose(M.diagonal(), 1.0, atol=1e-6)

    g_tbl, gt_tbl = fsai_tables(G, jnp.float64)
    rr = rng.standard_normal(con)
    z_ref = G.T @ (G @ rr)
    z = np.asarray(
        sparse_ops._ell_matvec(gt_tbl, sparse_ops._ell_matvec(g_tbl, jnp.asarray(rr)))
    )
    assert np.linalg.norm(z - z_ref) / np.linalg.norm(z_ref) < 1e-12

    sa = sparse_ops.build_sparse_a(r, c, v, con, vec_len, jnp.float64)
    neq = chol_ops.build_normal_solver(
        r, c, v, con, vec_len, sa, "cg", jnp.float64, cg_precond="fsai"
    )
    assert neq.fsai_g is not None and neq.bj_inv is None
    rhs = rng.standard_normal(con)
    y = jax.jit(neq.solve)(jnp.asarray(rhs))
    res = float(neq.residual_norm(jnp.asarray(rhs), y))
    assert res < 1e-8


def test_fsai_zero_rows():
    """All-zero AA^T rows (empty constraints) get a finite Jacobi-style
    diagonal entry, not a 1e30 spike (ADVICE r3 analog for FSAI)."""
    import scipy.sparse as sp

    from cuadmm_jax.ops.fsai import build_fsai

    n = 8
    d = np.ones(n)
    d[3] = 0.0  # structurally empty row
    aat = sp.diags(d, format="csr")
    G = build_fsai(aat.tocsr(), eps_rel=1e-8)
    Gd = np.asarray(G.todense())
    assert np.all(np.isfinite(Gd))
    assert Gd[3, 3] < 1e8  # no catastrophic spike


def test_eig_rank_low_rank_projection():
    """Top-k eigenvalue mask (reference get_eig_rank_mask analog)."""
    rng = np.random.default_rng(8)
    blk = [("s", 6)]
    st = BlockStructure(blk)
    x = rng.standard_normal(st.vec_len) * 2
    maps = device_maps(st, jnp.float64)
    xp = np.asarray(psd_project(jnp.asarray(x), maps, eig_rank=2))
    # NumPy reference: keep only the 2 largest clamped eigenvalues.
    r, c = np.tril_indices(6)
    m = np.zeros((6, 6))
    sc = np.where(r == c, 1.0, 1 / np.sqrt(2))
    m[r, c] = x * sc
    m[c, r] = x * sc
    w, v = np.linalg.eigh(m)
    wc = np.maximum(w, 0)
    wc[:-2] = 0
    p = (v * wc) @ v.T
    expected = p[r, c] * np.where(r == c, 1.0, np.sqrt(2))
    np.testing.assert_allclose(xp, expected, atol=1e-10)


def test_spmv_skewed_row_populations():
    """Bucketed ELL with a 1000-entry row next to singletons (moment-SDP
    profile) and empty rows in both directions."""
    rng = np.random.default_rng(17)
    con, vec = 700, 900
    rows = [np.full(1000, 3), rng.integers(0, vec, 800)]
    cols = [rng.integers(0, con, 1000), rng.integers(0, con, 800)]
    r = np.concatenate(rows).astype(np.int64)  # svec idx
    c = np.concatenate(cols).astype(np.int64)  # con idx
    v = rng.standard_normal(len(r))
    import scipy.sparse as sp

    At = sp.csr_matrix((v, (r, c)), shape=(vec, con))
    sa = sparse_ops.build_sparse_a(r, c, v, con, vec, jnp.float64)
    x = rng.standard_normal(vec)
    y = rng.standard_normal(con)
    np.testing.assert_allclose(
        np.asarray(sparse_ops.spmv_a(sa, jnp.asarray(x))), At.T @ x, rtol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(sparse_ops.spmv_at(sa, jnp.asarray(y))), At @ y, rtol=1e-11
    )


@pytest.mark.slow
def test_precond_real_pusht_aat_residual():
    """VERDICT round-1 'Done' bar, verbatim: the normal-solve relative
    residual must be < 1e-5 on the REAL PushT N=10 AA^T in the bench dtype
    (float32 state). Reference: examples/SPOT/data/TXT/PushT_N=10_MOMENT;
    capability bar include/cuadmm/cholesky_cpu.h:62-155 (CHOLMOD LDLt,
    eps 1e-15, exact solves)."""
    import os

    path = "/root/reference/examples/SPOT/data/TXT/PushT_N=10_MOMENT"
    if not os.path.isdir(path):
        pytest.skip("reference data unavailable")
    from cuadmm_jax.problem import Problem

    prob = Problem.from_txt(path)
    # Row-normalize exactly as the driver does (src/solver.cu:79-80).
    _, at_vals = sparse_ops.normalize_rows(
        prob.At_rows, prob.At_cols, prob.At_vals, prob.con_num
    )
    sa_hp = sparse_ops.build_sparse_a(
        prob.At_rows, prob.At_cols, at_vals, prob.con_num, prob.vec_len, jnp.float64
    )
    sa = sparse_ops.cast_sparse_a(sa_hp, jnp.float32)
    neq = chol_ops.build_normal_solver(
        prob.At_rows, prob.At_cols, at_vals, prob.con_num, prob.vec_len,
        sa, "precond", jnp.float32, sparse_a_hp=sa_hp,
    )
    # Consistent rhs of the shape the iteration produces: rhs = A(z).
    rng = np.random.default_rng(0)
    z = rng.standard_normal(prob.vec_len)
    rhs = np.asarray(sparse_ops.spmv_a(sa_hp, jnp.asarray(z)), np.float64)
    y = jax.jit(neq.solve)(jnp.asarray(rhs, jnp.float32))
    assert np.all(np.isfinite(np.asarray(y)))
    res = float(neq.residual_norm(jnp.asarray(rhs, jnp.float32), y))
    assert res < 1e-5, f"PushT normal-solve relative residual {res:.2e} >= 1e-5"


def test_blocked_tri_inv():
    """The accelerator preconditioner path inverts the triangular factor
    explicitly (ops/chol.py:_tri_inv); check the blocked algorithm against
    the identity at sizes that exercise multi-block recursion and padding."""
    import jax.numpy as jnp

    from cuadmm_jax.ops.chol import _tri_inv

    rng = np.random.default_rng(5)
    for n, block in [(500, 64), (300, 128), (64, 2048)]:
        a = rng.standard_normal((n, n))
        p = a @ a.T + n * np.eye(n)
        l = np.linalg.cholesky(p)
        li = np.asarray(_tri_inv(jnp.asarray(l, jnp.float32), block=block), np.float64)
        err = np.linalg.norm(li @ l - np.eye(n)) / np.sqrt(n)
        assert err < 1e-4, (n, block, err)


def test_compact_aat_matvec():
    """aat_matvec (the pool-free composed normal-equation operator) must
    agree with spmv_a(spmv_at(y)) and with the host scipy product."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from cuadmm_jax.ops.sparse import aat_matvec, build_sparse_a_pool, spmv_a, spmv_at
    from cuadmm_jax.structure import BlockStructure

    rng = np.random.default_rng(7)
    blk = [("s", 5)] * 40 + [("s", 13)] * 10 + [("u", 7)]
    st = BlockStructure(blk, "pow2", 64, 0)
    con, nnz = 150, 600
    rows_svec = rng.integers(0, st.vec_len, nnz)
    cols_con = rng.integers(0, con, nnz)
    vals = rng.standard_normal(nnz)
    key = cols_con.astype(np.int64) * st.vec_len + rows_svec
    _, keep = np.unique(key, return_index=True)
    rows_svec, cols_con, vals = rows_svec[keep], cols_con[keep], vals[keep]
    sa = build_sparse_a_pool(rows_svec, cols_con, vals, con, st, jnp.float64)
    assert sa.a_idx_compact is not None
    y = rng.standard_normal(con)
    composed = np.asarray(spmv_a(sa, spmv_at(sa, jnp.asarray(y))))
    got = np.asarray(aat_matvec(sa, jnp.asarray(y)))
    np.testing.assert_allclose(got, composed, atol=1e-12)
    A = sp.csr_matrix((vals, (cols_con, rows_svec)), shape=(con, st.vec_len))
    np.testing.assert_allclose(got, A @ (A.T @ y), atol=1e-10)
