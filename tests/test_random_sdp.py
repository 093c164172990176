"""The certified generators: the sparse one against the dense one."""

import numpy as np
import pytest
import scipy.sparse as sp

from cuadmm_jax.models.random_sdp import (
    random_certified_sdp,
    random_certified_sdp_sparse,
)


def _blk(n, seed=0):
    rng = np.random.default_rng(seed)
    return [("s", int(k)) for k in rng.integers(1, 9, n)]


def _A(prob):
    return sp.csr_matrix(
        (prob.At_vals, (prob.At_cols, prob.At_rows)), shape=(prob.con_num, prob.vec_len)
    )


@pytest.mark.parametrize("coupling", ["chain", "random"])
def test_sparse_certificate_matches_dense(coupling):
    """Same blk and seed: the same certified (X*, S*) as the dense
    generator, and the same KKT certificate around it."""
    blk = _blk(30)
    dense = random_certified_sdp(blk, 40, seed=3)
    sparse = random_certified_sdp_sparse(blk, 40, coupling=coupling, seed=3)
    np.testing.assert_array_equal(sparse[1], dense[1])  # X*
    np.testing.assert_array_equal(sparse[3], dense[3])  # S*
    for prob, x, y, s, opt in (dense, sparse):
        A = _A(prob)
        np.testing.assert_allclose(A @ x, prob.dense_b(), atol=1e-12)
        np.testing.assert_allclose(prob.dense_C() - A.T @ y, s, atol=1e-12)
        assert abs(prob.dense_C() @ x - opt) < 1e-10
        assert abs(prob.dense_b() @ y - opt) < 1e-9 * max(1.0, abs(opt))
        assert abs(x @ s) < 1e-9  # complementary
    # The sparse A really is sparse: nnz_per_row entries (or fewer after
    # duplicates merge) per constraint.
    assert len(sparse[0].At_vals) <= 6 * 40 < len(dense[0].At_vals)


def test_sparse_chain_rows_touch_adjacent_blocks():
    blk = _blk(50, seed=1)
    prob, *_ = random_certified_sdp_sparse(blk, 120, coupling="chain", reach=1, seed=2)
    sizes = np.array([n * (n + 1) // 2 for _, n in blk])
    block_of = np.repeat(np.arange(len(blk)), sizes)
    own = np.arange(120) * len(blk) // 120
    touched = block_of[prob.At_rows]
    assert np.all((touched >= own[prob.At_cols]) & (touched <= own[prob.At_cols] + 1))
    aat = (_A(prob) @ _A(prob).T).tocoo()
    assert np.abs(aat.row - aat.col).max() < 20  # banded in natural order


def test_sparse_certified_solve_reaches_optimum():
    from cuadmm_jax import SDPSolver, SolverConfig

    prob, _, _, _, opt = random_certified_sdp_sparse(_blk(40, seed=4), 100, seed=5)
    res = SDPSolver(prob, SolverConfig(verbose=False, stop_tol=1e-4)).solve(max_iter=20000)
    assert res.converged
    assert abs(prob.dense_C() @ res.X - opt) / max(1.0, abs(opt)) < 1e-3
