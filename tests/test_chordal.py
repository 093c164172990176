"""Chordal clique-tree conversion (reference: examples/max-cut/ctc.m,
treeDecomp.m, genMAXCUT.m)."""

import numpy as np
import pytest
import scipy.sparse as sp

from cuadmm_jax import SDPSolver, SolverConfig
from cuadmm_jax.models.chordal import (
    clique_tree_conversion,
    complete_gram_vectors,
    extract_entries,
    maxcut_chordal,
    min_degree_ordering,
    tree_decomposition,
)
from cuadmm_jax.models.maxcut import cut_value, maxcut_sdp, random_graph


def path_graph(n):
    W = np.zeros((n, n))
    for i in range(n - 1):
        W[i, i + 1] = W[i + 1, i] = 1.0
    return W


def check_tree_invariants(T, adj):
    n = adj.shape[0]
    # Supernodes partition the vertices.
    cover = np.concatenate(T.super_)
    assert sorted(cover.tolist()) == list(range(n))
    # Every edge of the graph lies inside some clique.
    A = sp.coo_matrix(sp.triu(adj, 1))
    for i, j in zip(A.row, A.col):
        assert any(i in set(c) and j in set(c) for c in T.clique)
    # Running-intersection property: for every vertex v, the cliques
    # containing v form a connected subtree.
    for v in range(n):
        holds = [u for u in range(T.ell) if v in set(T.clique[u])]
        if len(holds) <= 1:
            continue
        in_set = set(holds)
        # Each clique but one must have its parent also containing v.
        roots = [u for u in holds if T.parent[u] < 0 or T.parent[u] not in in_set]
        assert len(roots) == 1, f"vertex {v} spans a disconnected subtree"


def test_tree_decomposition_path():
    W = path_graph(6)
    T = tree_decomposition(sp.csr_matrix(W + np.eye(6)))
    check_tree_invariants(T, sp.csr_matrix(W))
    # A path is already chordal: cliques are the edges, omega == 2.
    assert T.omega == 2
    assert T.ell == 5


def test_tree_decomposition_random():
    for seed in range(3):
        W = random_graph(12, p=0.25, seed=seed)
        adj = sp.csr_matrix(W + np.eye(12))
        T = tree_decomposition(adj)
        check_tree_invariants(T, sp.csr_matrix(W))


def test_min_degree_is_permutation():
    W = random_graph(15, p=0.3, seed=7)
    perm = min_degree_ordering(sp.csr_matrix(W + np.eye(15)))
    assert sorted(perm.tolist()) == list(range(15))


def test_ctc_objective_matches_dense_maxcut():
    """Decomposed and plain max-cut SDPs agree on the optimal value."""
    W = path_graph(8) + random_graph(8, p=0.15, seed=5)
    W = np.minimum(W, 1.0)
    cfg = SolverConfig(verbose=False, check_every=50, switch_admm=10**9)

    dense = SDPSolver(maxcut_sdp(W), cfg).solve(max_iter=20000, stop_tol=1e-7)
    prob, info = maxcut_chordal(W)
    assert prob.mat_num == info.tree.ell  # no slacks for k=2
    assert info.tree.omega < 8  # actually decomposed
    dec = SDPSolver(prob, cfg).solve(max_iter=20000, stop_tol=1e-7)

    assert dense.converged and dec.converged
    assert dec.pobj == pytest.approx(dense.pobj, abs=5e-4)

    # Entries on the chordal pattern agree with the dense solution.
    Xd = extract_entries(info, dec.X)
    assert np.allclose(Xd.diagonal(), 1.0, atol=5e-4)

    # PSD completion gives Gram vectors reproducing the clique entries
    # and a rounding-quality cut.
    V = complete_gram_vectors(info, dec.X)
    G = V @ V.T
    Xp = Xd.toarray()
    mask = np.abs(Xp) > 0
    assert np.allclose(G[mask], Xp[mask], atol=5e-3)
    rng = np.random.default_rng(0)
    best = max(cut_value(W, V @ rng.standard_normal(8)) for _ in range(64))
    assert best >= 0.878 * (-dec.pobj) - 1e-3


def test_ctc_inequality_slacks():
    """max-3-cut: edge lower bounds become slack rows; solve stays feasible."""
    W = path_graph(6)
    prob, info = maxcut_chordal(W, k=3)
    assert info.n_slack == 5  # one per edge of the path
    assert prob.blk[-1] == ("s", 1)
    cfg = SolverConfig(verbose=False, check_every=50, switch_admm=10**9)
    res = SDPSolver(prob, cfg).solve(max_iter=20000, stop_tol=1e-6)
    assert res.converged
    X = extract_entries(info, res.X)
    assert np.allclose(X.diagonal(), 1.0, atol=1e-4)
    # Edge entries respect X_ij >= -1/(k-1).
    for i in range(5):
        assert X[i, i + 1] >= -0.5 - 1e-4


def test_ctc_rejects_off_pattern_entries():
    T = tree_decomposition(sp.csr_matrix(path_graph(4) + np.eye(4)))
    C = sp.coo_matrix(([1.0, 1.0], ([0, 3], [3, 0])), shape=(4, 4))
    with pytest.raises(ValueError, match="outside the chordal"):
        clique_tree_conversion(
            C, [sp.eye(4).tocoo()], np.array([1.0]), tree=T
        )
