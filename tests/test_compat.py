"""Reference-signature shim and checkpoint helpers."""

import numpy as np
import scipy.sparse as sp

from cuadmm_jax.compat import cuadmm
from cuadmm_jax.models.random_sdp import random_certified_sdp
from cuadmm_jax.utils.checkpoint import load_checkpoint, save_checkpoint
from cuadmm_jax import SDPSolver, SolverConfig


def test_compat_signature(tmp_path):
    prob, x_star, y_star, s_star, pobj = random_certified_sdp(
        [("s", 5), ("s", 3)], con_num=8, seed=2
    )
    At = sp.coo_matrix(
        (prob.At_vals, (prob.At_rows, prob.At_cols)),
        shape=(prob.vec_len, prob.con_num),
    )
    X, y, S, info = cuadmm(
        15,  # eig_stream_num, ignored
        5000,
        1e-6,
        At,
        prob.dense_b(),
        prob.dense_C(),
        [5, 3],
        sig=1.0,
        verbose=False,
        switch_admm=10**9,
    )
    assert info["iter_num"] > 0
    assert abs(info["pobj_arr"][-1] - pobj) / (1 + abs(pobj)) < 1e-4
    assert len(info["errRp_arr"]) == info["iter_num"]

    # Checkpoint round trip resumes instantly.
    class R:
        pass

    r = R()
    r.X, r.y, r.S, r.sig = X, y, S, float(info["sig_arr"][-1])
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, r)
    kw = load_checkpoint(ck)
    solver = SDPSolver(prob, SolverConfig(verbose=False, switch_admm=10**9))
    res = solver.solve(max_iter=2000, stop_tol=1e-6, **kw)
    assert res.converged
    assert res.iterations <= 60
