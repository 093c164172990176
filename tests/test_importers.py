"""Format importers validated against the reference's own TXT exports.

The reference repo ships the same problems in multiple formats (MATLAB
SeDuMi .mat / SDPA .dat-s / MOSEK .mat alongside the TXT the MATLAB
converters produced), so we can check our direct importers reproduce the
reference TXT data exactly.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from cuadmm_jax.io.sdpa import load_sdpa
from cuadmm_jax.io.sedumi import load_sedumi_mat
from cuadmm_jax.io.mosek import load_mosek_mat
from cuadmm_jax.problem import Problem

REF = "/root/reference/examples"


def dense_at(p: Problem):
    return sp.csc_matrix(
        (p.At_vals, (p.At_rows, p.At_cols)), shape=(p.vec_len, p.con_num)
    )


def assert_same_problem(a: Problem, b: Problem, rtol=1e-9):
    assert [n for _, n in a.blk] == [n for _, n in b.blk]
    assert a.con_num == b.con_num
    assert a.vec_len == b.vec_len
    d = (dense_at(a) - dense_at(b)).tocoo()
    scale = np.abs(a.At_vals).max()
    assert np.abs(d.data).max() if d.nnz else 0.0 <= rtol * scale
    np.testing.assert_allclose(a.dense_b(), b.dense_b(), rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(a.dense_C(), b.dense_C(), rtol=rtol, atol=1e-12)


def test_sedumi_truss5_matches_txt():
    p_mat = load_sedumi_mat(f"{REF}/dimacs/data/MATLAB/truss5.mat")
    p_txt = Problem.from_txt(f"{REF}/dimacs/data/TXT/truss5")
    assert_same_problem(p_mat, p_txt)


def test_sdpa_trto5_diagonal_block():
    """trto5 has an LP (diagonal, size -3280) block. The reference's own
    TXT export is inconsistent for this case: blk.txt declares 's 3280'
    (svec length 5.38M) while At.txt indexes the block as a raw 3280-vector
    -- their loader even warns about it (src/problem.cu:58-66). We import
    the LP block correctly as 3280 1x1 PSD blocks; validate structure and
    that the PSD part matches the TXT."""
    p_dat = load_sdpa(f"{REF}/plato/MATLAB/trto5.dat-s")
    assert [n for t, n in p_dat.blk] == [1761] + [1] * 3280
    assert p_dat.con_num == 3280
    p_txt = Problem.from_txt(f"{REF}/plato/TXT/trto5")
    tri = 1761 * 1762 // 2
    a_dat = dense_at(p_dat).tocsr()[:tri]
    a_txt = dense_at(p_txt).tocsr()[:tri]
    d = (a_dat - a_txt).tocoo()
    assert (np.abs(d.data).max() if d.nnz else 0.0) <= 1e-9
    # The LP entries of the TXT (raw vector indices) match our diagonal
    # svec entries value-for-value.
    a_lp_txt = dense_at(p_txt).tocsr()[tri : tri + 3280]
    a_lp_dat = dense_at(p_dat).tocsr()[tri:]
    d = (a_lp_dat - a_lp_txt).tocoo()
    assert (np.abs(d.data).max() if d.nnz else 0.0) <= 1e-9


def test_sdpa_biggs_matches_txt():
    p_dat = load_sdpa(f"{REF}/plato/MATLAB/biggs.dat-s")
    p_txt = Problem.from_txt(f"{REF}/plato/TXT/biggs")
    assert_same_problem(p_dat, p_txt)


def test_mosek_pusht_matches_txt():
    p_mat = load_mosek_mat(f"{REF}/SPOT/data/MOSEK/PushT_N=10_MOMENT.mat")
    p_txt = Problem.from_txt(f"{REF}/SPOT/data/TXT/PushT_N=10_MOMENT")
    assert_same_problem(p_mat, p_txt)


def test_mosek_planarhand_loads():
    """PlanarHand N=1: TXT At was stripped from the reference copy; the
    MOSEK .mat is the only complete source. Structural checks only."""
    p = load_mosek_mat(f"{REF}/SPOT/data/MOSEK/PlanarHand_N=1_MOMENT.mat")
    assert p.con_num == 66008
    assert len(p.blk) == 122
    assert p.validate() == []


def test_admm_mat_1dc1024_matches_txt_at():
    """1dc.1024's TXT export has no C.txt; the cuADMM-layout .mat archive
    is the complete source. Its At must reproduce the committed At.txt
    bit-for-bit (same svec convention)."""
    from cuadmm_jax.io.admm_mat import load_admm_mat
    from cuadmm_jax.io.txt import read_coo_matrix

    p = load_admm_mat(f"{REF}/plato/MATLAB/1dc.1024.mat")
    assert p.blk == [("s", 1024)]
    assert p.con_num == 24064
    r, c, v = read_coo_matrix(f"{REF}/plato/TXT/1dc.1024/At.txt")
    order = np.lexsort((r, c))
    np.testing.assert_array_equal(r[order], p.At_rows)
    np.testing.assert_array_equal(c[order], p.At_cols)
    np.testing.assert_array_equal(v[order], p.At_vals)


def test_quasar_constraints_structure():
    """QUASAR constraint generator: counts pinned to the reference load
    log (quasar-500.log: 756501 constraints, 1515004 At nnz) and a known
    feasible point (X_ij = q q^T for a unit quaternion q) satisfies every
    constraint exactly."""
    from cuadmm_jax.models.quasar import load_quasar_txt, quasar_constraints

    r, c, v, m, n = quasar_constraints(2)
    assert (m, n) == (1 + 20 + 18, 12)
    rng = np.random.default_rng(0)
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    X = np.kron(np.ones((3, 3)), np.outer(q, q))
    tri_r, tri_c = np.tril_indices(n)
    vals = X[tri_r, tri_c] * np.where(tri_r == tri_c, 1.0, np.sqrt(2.0))
    svec = np.zeros(n * (n + 1) // 2)
    svec[tri_r * (tri_r + 1) // 2 + tri_c] = vals
    A = sp.csr_matrix((v, (c, r)), shape=(m, n * (n + 1) // 2))
    out = A @ svec
    assert abs(out[0] - 3.0) < 1e-12  # tr(X) = N+1
    assert np.abs(out[1:]).max() < 1e-12

    p = load_quasar_txt(f"{REF}/plato/TXT/quasar-500")
    assert p.con_num == 756501
    assert p.At_nnz == 1515004
    assert p.vec_len == 2009010
    assert p.validate() == []
