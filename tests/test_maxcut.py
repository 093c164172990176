"""Max-cut SDP generator + end-to-end solve + rounding."""

import itertools

import numpy as np
import pytest

from cuadmm_jax import SDPSolver, SolverConfig
from cuadmm_jax.models.maxcut import (
    cut_value,
    maxcut_sdp,
    random_graph,
    round_solution,
)


def brute_force_maxcut(W):
    n = W.shape[0]
    best = 0.0
    for bits in itertools.product([-1.0, 1.0], repeat=n - 1):
        s = np.array((1.0,) + bits)
        best = max(best, cut_value(W, s))
    return best


def test_maxcut_bound_and_rounding():
    W = random_graph(10, p=0.5, seed=3)
    exact = brute_force_maxcut(W)
    prob = maxcut_sdp(W)
    cfg = SolverConfig(verbose=False, check_every=50, switch_admm=10**9)
    res = SDPSolver(prob, cfg).solve(max_iter=10000, stop_tol=1e-6)
    assert res.converged
    sdp_bound = -res.pobj  # min <-L/4, X> = -(max-cut upper bound)
    # SDP relaxation upper-bounds the true max cut ...
    assert sdp_bound >= exact - 1e-4
    # ... within the Goemans-Williamson guarantee (and typically tight).
    assert sdp_bound <= exact / 0.878 + 1e-4
    # Hyperplane rounding recovers a near-optimal cut.
    cut = round_solution(W, res.X, trials=64)
    assert cut >= 0.878 * exact - 1e-6


def test_maxcut_structure():
    W = random_graph(6, seed=1)
    prob = maxcut_sdp(W)
    assert prob.blk == [("s", 6)]
    assert prob.con_num == 6
    # diag(X)=1 constraints touch only diagonal svec entries.
    A = np.zeros((6, prob.vec_len))
    A[prob.At_cols, prob.At_rows] = prob.At_vals
    assert (A.sum(axis=1) == 1).all()
