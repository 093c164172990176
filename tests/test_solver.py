"""End-to-end solver tests.

The KKT residuals (errRp, errRd, relgap) are self-certifying, so
convergence below tol on a certified random SDP + objective agreement with
the constructed optimum is a full correctness check (the reference's analog
is the env-gated DuoSolver integration test + MATLAB ground-truth drivers;
reference: test/duo_solver_test.hpp:6-145).
"""

import numpy as np
import pytest

from cuadmm_jax import Problem, SDPSolver, SolverConfig
from cuadmm_jax.models.random_sdp import random_certified_sdp

TRUSS5 = "/root/reference/examples/dimacs/data/TXT/truss5"


def _check_result(prob, res, tol):
    assert res.converged
    assert max(res.errRp, res.errRd, res.relgap) < tol
    # X PSD feasibility: spot-check via the projection residual on S blocks.
    assert np.all(np.isfinite(res.X))
    assert np.all(np.isfinite(res.y))
    assert np.all(np.isfinite(res.S))


@pytest.mark.parametrize("mode", ["dense", "cg"])
def test_certified_random_sdp(mode):
    blk = [("s", 6), ("s", 4), ("s", 6)]
    prob, x_star, y_star, s_star, pobj = random_certified_sdp(blk, con_num=12, seed=3)
    cfg = SolverConfig(
        verbose=False, check_every=25, normal_solver=mode, switch_admm=10**9
    )
    res = SDPSolver(prob, cfg).solve(max_iter=6000, stop_tol=1e-6)
    _check_result(prob, res, 1e-6)
    assert abs(res.pobj - pobj) / (1 + abs(pobj)) < 1e-4
    assert abs(res.dobj - pobj) / (1 + abs(pobj)) < 1e-4


def test_certified_with_free_blocks():
    blk = [("s", 5), ("u", 3), ("s", 4)]
    prob, x_star, y_star, s_star, pobj = random_certified_sdp(blk, con_num=10, seed=7)
    cfg = SolverConfig(verbose=False, check_every=25, switch_admm=10**9)
    res = SDPSolver(prob, cfg).solve(max_iter=8000, stop_tol=1e-6)
    _check_result(prob, res, 1e-6)
    assert abs(res.pobj - pobj) / (1 + abs(pobj)) < 1e-4
    # Dual slack on free blocks must vanish.
    st = SDPSolver(prob, cfg).structure
    np.testing.assert_allclose(res.S[st.free_pos], 0.0, atol=1e-5)


def test_warm_start_accelerates():
    blk = [("s", 6), ("s", 4)]
    prob, x_star, y_star, s_star, pobj = random_certified_sdp(blk, con_num=10, seed=11)
    cfg = SolverConfig(verbose=False, check_every=20, switch_admm=10**9)
    solver = SDPSolver(prob, cfg)
    cold = solver.solve(max_iter=5000, stop_tol=1e-5)
    assert cold.converged
    warm = solver.solve(
        max_iter=5000, stop_tol=1e-5, X0=cold.X, y0=cold.y, S0=cold.S, sig=cold.sig
    )
    assert warm.converged
    assert warm.iterations <= max(cold.iterations // 4, 40)


def test_reentrant_solve_tightening():
    """Reference's if_first=false re-entry (src/solver.cu:385-409): resume
    from an unscaled iterate and tighten the tolerance."""
    blk = [("s", 5)]
    prob, *_ = random_certified_sdp(blk, con_num=6, seed=13)
    cfg = SolverConfig(verbose=False, check_every=20, switch_admm=10**9)
    solver = SDPSolver(prob, cfg)
    r1 = solver.solve(max_iter=4000, stop_tol=1e-4)
    r2 = solver.solve(max_iter=4000, stop_tol=1e-7, X0=r1.X, y0=r1.y, S0=r1.S, sig=r1.sig)
    assert r2.converged
    assert max(r2.errRp, r2.errRd, r2.relgap) < 1e-7


def test_admm_switch_path():
    """Exercise the sGS->ADMM switch and best-iterate restoration."""
    blk = [("s", 6), ("s", 3)]
    prob, *_ , pobj = random_certified_sdp(blk, con_num=8, seed=17)
    cfg = SolverConfig(verbose=False, check_every=10, switch_admm=30)
    res = SDPSolver(prob, cfg).solve(max_iter=4000, stop_tol=1e-6)
    assert res.converged
    assert abs(res.pobj - pobj) / (1 + abs(pobj)) < 1e-4


def test_info_arrays():
    blk = [("s", 4)]
    prob, *_ = random_certified_sdp(blk, con_num=5, seed=19)
    cfg = SolverConfig(verbose=False, check_every=10, switch_admm=10**9)
    res = SDPSolver(prob, cfg).solve(max_iter=500, stop_tol=1e-6)
    n = res.iterations
    for k in ("pobj", "dobj", "errRp", "errRd", "relgap", "sig"):
        assert len(res.info[k]) == n
    assert res.info["errRp"][-1] == pytest.approx(res.errRp, rel=1e-9)


def test_float32_mode():
    blk = [("s", 5), ("s", 3)]
    prob, *_ , pobj = random_certified_sdp(blk, con_num=8, seed=23)
    cfg = SolverConfig(
        verbose=False, check_every=25, dtype="float32", switch_admm=10**9
    )
    res = SDPSolver(prob, cfg).solve(max_iter=6000, stop_tol=2e-4)
    assert res.converged
    assert abs(res.pobj - pobj) / (1 + abs(pobj)) < 5e-3


@pytest.mark.slow
def test_truss5_reference_problem():
    """DIMACS truss5 to 1e-3 KKT; optimum is ~132.6356895 (DIMACS tables)."""
    prob = Problem.from_txt(TRUSS5)
    # Early sGS->ADMM switch: truss5 converges in 14k iterations with it
    # vs 59k pure-sGS (the library default mirrors the reference's 5e4,
    # src/solver.cu:332; this test also exercises the switch path).
    cfg = SolverConfig(verbose=False, check_every=200, switch_admm=5000)
    res = SDPSolver(prob, cfg).solve(max_iter=30000, stop_tol=1e-3)
    assert res.converged
    assert abs(res.pobj - 132.6356895) / 132.6 < 5e-3
    assert abs(res.dobj - 132.6356895) / 132.6 < 5e-3


def test_packed_projection_same_solve():
    """pack_to must not change the algorithm: same iterate trajectory."""
    blk = [("s", 6), ("s", 4), ("s", 6), ("s", 3)]
    prob, *_ = random_certified_sdp(blk, con_num=12, seed=5)
    cfg = SolverConfig(verbose=False, check_every=25, switch_admm=10**9)
    res0 = SDPSolver(prob, cfg.replace(pack_to=0)).solve(max_iter=500, stop_tol=1e-6)
    res1 = SDPSolver(prob, cfg.replace(pack_to=16)).solve(max_iter=500, stop_tol=1e-6)
    assert res0.iterations == res1.iterations
    np.testing.assert_allclose(res1.X, res0.X, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(
        res1.info["errRp"], res0.info["errRp"], rtol=1e-6, atol=1e-12
    )


def test_profile_trace_capture(tmp_path):
    """profile_dir captures a jax.profiler trace of one steady-state chunk
    (the observability counterpart of the reference's cudaEvent timing,
    src/solver.cu:41-44)."""
    blk = [("s", 4), ("s", 3)]
    prob, *_ = random_certified_sdp(blk, con_num=8, seed=2)
    cfg = SolverConfig(
        verbose=False, check_every=10, switch_admm=10**9,
        profile_dir=str(tmp_path),
    )
    SDPSolver(prob, cfg).solve(max_iter=30, stop_tol=0.0)
    import glob
    traces = glob.glob(str(tmp_path / "**" / "*.trace*"), recursive=True) + glob.glob(
        str(tmp_path / "**" / "*.xplane.pb"), recursive=True
    )
    assert traces, "no profiler trace written"


def test_divergence_auto_recovery_broken_factor():
    """Inject a corrupted Cholesky factor into the normal solver; the driver
    must detect the non-finite chunk, restart from a finite iterate with
    escalated numerics (ultimately the factor-free CG solver), and still
    converge. Also check recovery can be disabled."""
    import dataclasses

    import jax.numpy as jnp

    blk = [("s", 6), ("s", 4), ("s", 6)]
    prob, *_, pobj = random_certified_sdp(blk, con_num=12, seed=3)
    cfg = SolverConfig(
        verbose=False, check_every=25, normal_solver="dense", switch_admm=10**9
    )
    solver = SDPSolver(prob, cfg)
    good_neq = solver.params.neq
    # Corrupt the factor: an all-zero triangle makes every P^{-1} r
    # application divide by zero, so the first chunk goes non-finite.
    bad_l = jnp.zeros_like(good_neq.chol_l)
    solver.params = dataclasses.replace(
        solver.params, neq=dataclasses.replace(good_neq, chol_l=bad_l)
    )
    res = solver.solve(max_iter=8000, stop_tol=1e-6)
    assert res.recoveries >= 1
    assert res.converged and not res.diverged
    assert abs(res.pobj - pobj) / (1 + abs(pobj)) < 1e-4

    # With recovery disabled the same corruption must abort cleanly.
    solver2 = SDPSolver(prob, cfg.replace(divergence_recovery=False))
    solver2.params = dataclasses.replace(
        solver2.params, neq=dataclasses.replace(solver2.params.neq, chol_l=bad_l)
    )
    res2 = solver2.solve(max_iter=200, stop_tol=1e-6)
    assert res2.diverged and res2.recoveries == 0


def test_solve_escalated_f32_then_f64_tail():
    """solve_escalated: easy tolerance resolves in f32 alone; a tolerance
    below the f32 certification floor warm-continues in f64 and reaches
    it (the rose13 pattern: reference runs end-to-end f64,
    src/solver.cu; our ladder does only the tail there)."""
    from cuadmm_jax import SolverConfig, solve_escalated
    from cuadmm_jax.models.random_sdp import random_certified_sdp

    prob, _, _, _, opt = random_certified_sdp(
        [("s", 6)] * 8, con_num=200, seed=3
    )
    cfg = SolverConfig(verbose=False, check_every=100, dtype="float32")
    # f32 DIVERGES on this instance even after in-dtype recoveries (a
    # pre-existing property of dense random SDPs in f32 on CPU) -- the
    # ladder must rescue it with a fresh f64 solve.
    res = solve_escalated(prob, cfg, max_iter=20000, stop_tol=1e-4)
    assert res.converged and abs(res.pobj - opt) / (1 + abs(opt)) < 1e-2

    res2 = solve_escalated(prob, cfg, max_iter=60000, stop_tol=1e-7)
    assert res2.converged, (res2.errRp, res2.errRd, res2.relgap)
    assert max(res2.errRp, res2.errRd, res2.relgap) < 1e-7
    assert abs(res2.pobj - opt) / (1 + abs(opt)) < 1e-5
