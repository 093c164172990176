"""Max-cut SDP relaxation generator.

Counterpart of the reference's MATLAB max-cut pipeline
(reference: examples/max-cut/genMAXCUT.m, run_maxcut.m -- which builds
max-cut SDPs from power-grid Ybus matrices). Given a symmetric weight
matrix W, the Goemans-Williamson relaxation is

    min <-L/4, X>  s.t.  X_ii = 1 (i in [n]),  X >= 0,

with graph Laplacian L = diag(W 1) - W. The optimal value is minus an
upper bound on the max-cut weight.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cuadmm_jax.io.conewise import svec_index
from cuadmm_jax.problem import Problem


def maxcut_sdp(W: np.ndarray, name: str = "maxcut") -> Problem:
    """Build the max-cut SDP relaxation for weight matrix W (n x n)."""
    W = np.asarray(W, dtype=np.float64)
    n = W.shape[0]
    if W.shape != (n, n):
        raise ValueError("W must be square")
    W = (W + W.T) / 2.0
    np.fill_diagonal(W, 0.0)
    L = np.diag(W.sum(axis=1)) - W

    # C = -L/4 in svec form (off-diagonal * sqrt(2)).
    r, c = np.tril_indices(n)
    C_vec = L[r, c] * np.where(r == c, 1.0, np.sqrt(2.0)) * (-0.25)

    # Constraint i: <e_i e_i^T, X> = X_ii = 1 -> single svec entry.
    diag_pos = np.array([svec_index(i, i) for i in range(n)], dtype=np.int32)
    at_rows = diag_pos
    at_cols = np.arange(n, dtype=np.int32)
    at_vals = np.ones(n)

    C_idx = np.nonzero(C_vec)[0].astype(np.int32)
    return Problem(
        blk=[("s", n)],
        con_num=n,
        At_rows=at_rows,
        At_cols=at_cols,
        At_vals=at_vals,
        b_indices=np.arange(n, dtype=np.int32),
        b_vals=np.ones(n),
        C_indices=C_idx,
        C_vals=C_vec[C_idx],
        name=name,
    )


def random_graph(n: int, p: float = 0.5, weighted: bool = False, seed: int = 0) -> np.ndarray:
    """Erdos-Renyi weight matrix for testing/benchmarks."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < p
    W = np.where(mask, rng.random((n, n)) if weighted else 1.0, 0.0)
    W = np.triu(W, 1)
    return W + W.T


def cut_value(W: np.ndarray, signs: np.ndarray) -> float:
    """Weight of the cut induced by a +-1 assignment."""
    s = np.sign(signs)
    return 0.25 * float(s @ (np.diag(W.sum(1)) - W) @ s)


def round_solution(W: np.ndarray, X_svec: np.ndarray, trials: int = 32, seed: int = 0) -> float:
    """Goemans-Williamson hyperplane rounding from the solved X."""
    n = W.shape[0]
    r, c = np.tril_indices(n)
    X = np.zeros((n, n))
    sc = np.where(r == c, 1.0, 1 / np.sqrt(2.0))
    X[r, c] = X_svec * sc
    X[c, r] = X[r, c]
    w, v = np.linalg.eigh(X)
    V = v * np.sqrt(np.maximum(w, 0))
    rng = np.random.default_rng(seed)
    best = -np.inf
    for _ in range(trials):
        g = rng.standard_normal(n)
        best = max(best, cut_value(W, V @ g))
    return best
