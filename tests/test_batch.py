"""Batched multi-instance solve (shared structure, per-instance b/C)."""

import numpy as np
import jax
import pytest

from cuadmm_jax import Problem, SolverConfig
from cuadmm_jax.models.random_sdp import random_certified_sdp
from cuadmm_jax.parallel.batch import BatchedSDPSolver
from cuadmm_jax.parallel.mesh import make_mesh


def _family(n_instances, seed=0):
    """Instances sharing (blk, A) with different certified (b, C)."""
    blk = [("s", 5), ("s", 3)]
    base, *_ = random_certified_sdp(blk, con_num=10, seed=seed)
    probs, objs = [], []
    rng = np.random.default_rng(seed)
    A = np.zeros((base.con_num, base.vec_len))
    A[base.At_cols, base.At_rows] = base.At_vals
    for i in range(n_instances):
        # New certified optimum for the same A: rebuild X*, S* per instance.
        p, x_s, y_s, s_s, pobj = random_certified_sdp(
            blk, con_num=10, seed=seed
        )  # same seed -> same A
        # Perturb y* and rank split via a fresh seed but keep A: construct
        # by hand from the SAME A.
        from cuadmm_jax.models.random_sdp import _svec

        parts_x, parts_s = [], []
        for t, n in blk:
            q, _ = np.linalg.qr(rng.standard_normal((n, n)))
            k = max(1, n // 2)
            X = (q[:, :k] * rng.uniform(0.5, 2, k)) @ q[:, :k].T
            S = (q[:, k:] * rng.uniform(0.5, 2, n - k)) @ q[:, k:].T
            parts_x.append(_svec(X))
            parts_s.append(_svec(S))
        x_star = np.concatenate(parts_x)
        s_star = np.concatenate(parts_s)
        y_star = rng.standard_normal(base.con_num)
        b = A @ x_star
        C = s_star + A.T @ y_star
        probs.append(Problem.from_dense(blk, A, b, C, name=f"inst{i}"))
        objs.append(float(C @ x_star))
    return probs, objs


def test_batched_matches_individual():
    probs, objs = _family(3)
    cfg = SolverConfig(verbose=False, check_every=25, switch_admm=10**9)
    batch = BatchedSDPSolver(probs, cfg)
    results = batch.solve(max_iter=6000, stop_tol=1e-6)
    assert len(results) == 3
    for res, obj in zip(results, objs):
        assert res.converged
        assert abs(res.pobj - obj) / (1 + abs(obj)) < 1e-4


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_batched_sharded_over_mesh():
    probs, objs = _family(8, seed=4)
    cfg = SolverConfig(verbose=False, check_every=25, switch_admm=10**9)
    batch = BatchedSDPSolver(probs, cfg, mesh=make_mesh(8))
    results = batch.solve(max_iter=6000, stop_tol=1e-6)
    for res, obj in zip(results, objs):
        assert res.converged
        assert abs(res.pobj - obj) / (1 + abs(obj)) < 1e-4
    # Per-instance parity against independent single solves: the sharded
    # lockstep batch must reproduce the unsharded single-solver iterates.
    from cuadmm_jax.solver.driver import SDPSolver

    for i in (0, 5):
        single = SDPSolver(probs[i], cfg).solve(max_iter=6000, stop_tol=1e-6)
        assert abs(results[i].pobj - single.pobj) < 1e-6 * (1 + abs(single.pobj))
        np.testing.assert_allclose(results[i].X, single.X, atol=5e-5)


def test_batch_rejects_mismatched_pattern():
    p1, *_ = random_certified_sdp([("s", 4)], con_num=5, seed=1)
    p2, *_ = random_certified_sdp([("s", 5)], con_num=5, seed=1)
    with pytest.raises(ValueError):
        BatchedSDPSolver([p1, p2], SolverConfig(verbose=False))
