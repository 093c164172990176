"""Retrieve the primal minimizer from a small random SDP.

Python counterpart of the reference's MATLAB usage example
(reference: MATLAB/example_minimizer.m:1-77): build a random 3x3 SDP
through the reference-signature `cuadmm(...)` shim, solve, and convert the
svec solution back to a full symmetric matrix (off-diagonals / sqrt(2) --
the svec convention of reference/kernels/vec_mat_conversion.cu:5).

Run: python examples/minimizer.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)  # the shim solves in float64

import numpy as np

from cuadmm_jax.compat import cuadmm


def svec_to_full(v: np.ndarray, n: int) -> np.ndarray:
    """svec (tril row-major, off-diag * sqrt(2)) -> full symmetric matrix."""
    M = np.zeros((n, n))
    k = 0
    for i in range(n):
        for j in range(i + 1):
            M[i, j] = v[k] if i == j else v[k] / np.sqrt(2)
            M[j, i] = M[i, j]
            k += 1
    return M


def main() -> None:
    rng = np.random.default_rng(0)
    n = 3
    vec_len = n * (n + 1) // 2
    con_num = 3

    # NB: the MATLAB original draws a *square* random At, which generically
    # pins X to a unique non-PSD point; we instead make the problem
    # well-posed -- underdetermined constraints consistent with a random
    # PSD matrix, so the minimizer is PSD and recovery is meaningful.
    At = rng.random((vec_len, con_num))  # svec-stacked A^T
    C = rng.random(vec_len)
    g = rng.standard_normal((n, n))
    X_true = g @ g.T
    iu = np.tril_indices(n)
    scale = np.where(iu[0] == iu[1], 1.0, np.sqrt(2))
    x_true_svec = X_true[iu] * scale
    b = At.T @ x_true_svec

    X, y, S, info = cuadmm(
        12,  # eig_stream_num: signature parity only (XLA schedules the eigs)
        2000,  # max_iter
        1e-5,  # stop_tol
        At,
        b,
        C,
        [n],  # blk sizes
        sig=2e2,
    )

    print("X (svec):", np.array_str(X, precision=4))
    X_full = svec_to_full(X, n)
    print("X (full):\n", np.array_str(X_full, precision=4))
    print("min eigenvalue:", float(np.linalg.eigvalsh(X_full).min()))
    print("iterations:", int(info["iter_num"]), "errRp:", float(info["errRp_arr"][-1]))


if __name__ == "__main__":
    main()
