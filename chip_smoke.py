"""Smoke run of the sGS-ADMM solver on one GPU (or four with ``--four``).

Drives ``SDPSolver(prob, cfg).solve()`` through every normal-solver rung
that auto mode picks on the card, each at a size its users run, and
checks every answer against an independent host reference in f64:

  (a) precond  6,015 PSD blocks of sizes 1-13 and 17,150 coupled
               constraints (the shape of PushT N=10); certified optimum
  (b) split    Goemans-Williamson max-cut of a 2,000-node graph (G-set
               size, ~20k edges); one 2000x2000 block; KKT + rounding
  (c) packed   40,000 randomly coupled constraints; certified optimum,
               and the packed sweeps against host triangular solves
  (d) banded   100,000 chain-coupled constraints; certified optimum, and
               the band sweeps against host banded triangular solves
  (e) canaries f32 matmul precision, native f64, the host-callback
               normal solver

Usage:
  python chip_smoke.py          one GPU; the last line is the JSON result
  python chip_smoke.py --four   four GPUs: mesh, sharded and batched paths
  python chip_smoke.py --tiny   every phase at toy sizes on any backend
                                (a rehearsal: reports ok only on a GPU)

Every result line is a JSON object with the card's name and power limit
beside the numbers. The script exits non-zero, and prints no result,
when JAX finds no GPU or when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

# Phase (e)'s host-callback normal solver needs the CPU platform next to
# the GPU one.
_platforms = os.environ.get("JAX_PLATFORMS")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp

# H100 datasheet HBM bandwidth, the floor the sweep times are set against.
HBM_BYTES_PER_S = 3.35e12

FULL = {
    "a": (6015, 17150),
    "b": (2000, 0.01),
    "c": (14000, 40000),
    "d": (35000, 100000),
    "batch": (8, 2000, 5700),
}
TINY = {
    "a": (60, 170),
    "b": (40, 0.2),
    "c": (200, 600),
    "d": (300, 900),
    "batch": (8, 40, 110),
}
STOP_TOL = 1e-4
MAX_ITER = 20000
OBJ_TOL = 1e-3  # certified objective, relative
FEAS_TOL = 1e-3  # host f64 ||A x - b|| / (1 + ||b||)
SWEEP_TOL = 1e-4  # device sweep vs host f64 triangular solves, relative


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_info() -> str:
    """nvidia-smi's name and power limit, read by a child that never
    touches JAX."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if out.returncode or not lines:
        return f"nvidia-smi failed (rc={out.returncode})"
    return "; ".join(lines)


CARD = "unknown"


def report(phase, **kv):
    print(json.dumps({"phase": phase, **kv, "card": CARD}, default=str), flush=True)


def peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def device_time(fn, *args, reps=10):
    """Mean seconds per call of a jitted ``fn`` after a warm-up call."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


# ----------------------------------------------------------------------
# Problems and host references.
# ----------------------------------------------------------------------


def small_blocks(n_blocks, seed):
    rng = np.random.default_rng(seed)
    return [("s", int(n)) for n in rng.integers(1, 14, n_blocks)]


def problem_a(sizes):
    """Many small blocks, chain-coupled rows (phase a)."""
    from cuadmm_jax.models.random_sdp import random_certified_sdp_sparse

    n_blocks, con = sizes["a"]
    return random_certified_sdp_sparse(
        small_blocks(n_blocks, 1), con, coupling="chain", seed=2
    )


def problem_c(sizes):
    """Randomly coupled rows, dense enough (each row touches its own block
    and 4 random ones) that no ordering leaves a narrow band: AA^T's RCM
    bandwidth is over half its order, so packed beats banded (phase c)."""
    from cuadmm_jax.models.random_sdp import random_certified_sdp_sparse

    n_blocks, con = sizes["c"]
    return random_certified_sdp_sparse(
        small_blocks(n_blocks, 3), con, coupling="random", reach=4,
        nnz_per_row=8, seed=4,
    )


def a_matrix(prob):
    return sp.csr_matrix(
        (prob.At_vals, (prob.At_cols, prob.At_rows)), shape=(prob.con_num, prob.vec_len)
    )


def certified_errors(prob, X, opt):
    """Host f64 errors of a solution X against the certified optimum."""
    b = prob.dense_b()
    feas = np.linalg.norm(a_matrix(prob) @ X - b) / (1.0 + np.linalg.norm(b))
    obj = float(prob.dense_C() @ X)
    return {"obj_host": obj, "obj_opt": opt,
            "obj_rel_err": abs(obj - opt) / max(1.0, abs(opt)), "feas_host": feas}


def check_certified(errs):
    check(errs["obj_rel_err"] <= OBJ_TOL, f"objective off by {errs['obj_rel_err']:.3e}")
    check(errs["feas_host"] <= FEAS_TOL, f"host infeasibility {errs['feas_host']:.3e}")


def packed_dense_lower(tiles, lay):
    """Dense f64 L (n_pad x n_pad, Fortran order so LAPACK takes it without
    a copy) from packed tiles (inverted diagonals)."""
    from cuadmm_jax.ops.tri_stream import tid

    B = lay.block
    L = np.zeros((lay.n_pad, lay.n_pad), order="F")
    for i in range(lay.nb):
        for j in range(i + 1):
            t = np.asarray(tiles[tid(i, j)], np.float64)
            if i == j:
                t = np.tril(np.linalg.inv(t))
            L[i * B : (i + 1) * B, j * B : (j + 1) * B] = t
    return L


def band_lower_storage(tiles, lay):
    """LAPACK lower band storage ab[d, c] = L[c + d, c] (f64) of the band
    factor, for dtbtrs."""
    from cuadmm_jax.ops.tri_stream import tid_band

    B, w = lay.block, lay.nbw
    kd = (w + 1) * B - 1
    ab = np.zeros((kd + 1, lay.n_pad))
    a, b = np.meshgrid(np.arange(B), np.arange(B), indexing="ij")
    host = np.asarray(tiles)
    for i in range(lay.nb):
        for j in range(max(0, i - w), i + 1):
            t = host[tid_band(i, j, lay)].astype(np.float64)
            if i == j:
                t = np.tril(np.linalg.inv(t))
            d = (i - j) * B + a - b
            keep = d >= 0
            ab[d[keep], (j * B + b)[keep]] = t[keep]
    return ab, kd


def host_sweep_error(y_dev, r, lower_solve, upper_solve):
    x = lower_solve(r)
    y = upper_solve(x)
    return float(np.linalg.norm(np.asarray(y_dev, np.float64) - y) / np.linalg.norm(y))


# ----------------------------------------------------------------------
# One solve through the user entry point, with its timings.
# ----------------------------------------------------------------------


def step_memory(solver, stop_tol):
    """compiled.memory_analysis() of the chunk program the solve ran."""
    runner = next(
        r for (_, tol, _), r in solver._chunk_runners.items() if tol == stop_tol
    )
    state = solver._initial_state(*solver._initial_scaled, solver.config.sig)
    with jax.default_matmul_precision("highest"):
        ma = runner.lower(state, solver.params).compile().memory_analysis()
    if ma is None:
        return None
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    return {f: getattr(ma, f, None) for f in fields}


def projection_buckets(solver):
    proj = solver._projection
    out = []
    for i, bk in enumerate(solver.structure.buckets):
        meth = proj.get(i, "eigh") if isinstance(proj, dict) else proj
        out.append({"n": bk.n, "count": bk.count, "method": "clamp" if bk.n == 1 else meth})
    return out


def run_solve(phase, prob, cfg, expect_mode, mesh=None):
    from cuadmm_jax import SDPSolver

    t0 = time.perf_counter()
    solver = SDPSolver(prob, cfg, mesh=mesh)
    init_s = time.perf_counter() - t0
    mode = solver.params.neq.mode
    check(mode == expect_mode, f"normal solver is {mode!r}, expected {expect_mode!r}")
    t0 = time.perf_counter()
    solver.solve(max_iter=cfg.check_every, stop_tol=cfg.stop_tol)
    first_chunk_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solver.solve(max_iter=MAX_ITER, stop_tol=cfg.stop_tol)
    solve_s = time.perf_counter() - t0
    per_iter = solve_s / max(res.iterations, 1)
    report(
        phase, stage="solve", neq_mode=mode, con_num=prob.con_num,
        vec_len=prob.vec_len, n_blocks=len(prob.blk),
        projection=projection_buckets(solver), init_s=init_s,
        init_breakdown=solver.init_breakdown,
        first_chunk_s=first_chunk_s,
        compile_s=first_chunk_s - per_iter * cfg.check_every,
        solve_s=solve_s, s_per_iter=per_iter, iterations=res.iterations,
        converged=res.converged, errRp=res.errRp, errRd=res.errRd,
        relgap=res.relgap, pobj=res.pobj, dobj=res.dobj,
        step_memory=step_memory(solver, cfg.stop_tol),
        peak_bytes_in_use=peak_bytes(),
    )
    check(res.converged, f"not converged in {res.iterations} iterations: {res.message}")
    return solver, res


def config(args, rung, named=False):
    """Full size: auto mode must pick ``rung`` on its own. Tiny sizes sit
    under every auto threshold, so there (or with ``named``) the rung is
    named."""
    from cuadmm_jax import SolverConfig

    return SolverConfig(
        verbose=False, check_every=50, stop_tol=STOP_TOL,
        normal_solver=rung if (args.tiny or named) else "auto",
    )


# ----------------------------------------------------------------------
# Phases.
# ----------------------------------------------------------------------


def phase_a(args, sizes):
    prob, _, _, _, opt = problem_a(sizes)
    solver, res = run_solve("a", prob, config(args, "precond"), "precond")
    errs = certified_errors(prob, res.X, opt)
    neq = solver.params.neq
    apply = {}
    if neq.inv_l is not None:
        n = neq.inv_l.shape[0]
        r = jnp.asarray(np.random.default_rng(0).standard_normal(n))
        t = device_time(jax.jit(lambda nq, v: nq._apply_factor(v)), neq, r)
        nbytes = 2 * neq.inv_l.size * neq.inv_l.dtype.itemsize
        apply = {"dot_pair_s": t, "dot_pair_bytes": nbytes,
                 "dot_pair_bytes_per_s": nbytes / t,
                 "dot_pair_floor_s": nbytes / HBM_BYTES_PER_S}
    report("a", stage="check", **errs, **apply)
    check_certified(errs)


def phase_b(args, sizes):
    from cuadmm_jax.models.maxcut import maxcut_sdp, random_graph, round_solution

    n, p = sizes["b"]
    W = random_graph(n, p=p, seed=0)
    prob = maxcut_sdp(W, name=f"maxcut{n}")
    solver, res = run_solve("b", prob, config(args, "split"), "split")
    check(solver.params.neq.split_p == 0, "max-cut rows should not couple")
    r, c = np.tril_indices(n)
    X = np.zeros((n, n))
    X[r, c] = res.X * np.where(r == c, 1.0, 1.0 / np.sqrt(2.0))
    X[c, r] = X[r, c]
    pobj = float(prob.dense_C() @ res.X)
    dobj = float(prob.dense_b() @ res.y)
    sdp_value = -pobj
    cut = round_solution(W, res.X)
    kkt = {
        "edges": int(W.sum() // 2),
        "diag_err": float(np.abs(np.diag(X) - 1.0).max()),
        "min_eig_rel": float(np.linalg.eigvalsh(X)[0] / np.linalg.norm(X)),
        "relgap_host": abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj)),
        "sdp_value": sdp_value, "cut": cut, "cut_ratio": cut / sdp_value,
    }
    report("b", stage="check", **kkt)
    check(kkt["diag_err"] <= FEAS_TOL, "diag(X) != 1")
    check(kkt["min_eig_rel"] >= -1e-6, "X not PSD")
    check(kkt["relgap_host"] <= OBJ_TOL, "duality gap open")
    check(0.878 <= kkt["cut_ratio"] <= 1.0 + OBJ_TOL, "rounded cut out of [0.878, 1]")


def phase_c(args, sizes):
    from cuadmm_jax.ops.tri_stream import PackedLayout, packed_solve

    prob, _, _, _, opt = problem_c(sizes)
    solver, res = run_solve("c", prob, config(args, "packed"), "packed")
    errs = certified_errors(prob, res.X, opt)
    neq = solver.params.neq
    lay = PackedLayout(*neq.packed_layout)
    tiles = neq.packed_tiles
    r = np.zeros(lay.n_pad)  # the padding rows carry a unit diagonal
    r[: lay.n] = np.random.default_rng(1).standard_normal(lay.n)
    sweep = jax.jit(lambda t, v: packed_solve(t, v, lay))
    rd = jnp.asarray(r, tiles.dtype)
    y = sweep(tiles, rd)
    t = device_time(sweep, tiles, rd)
    L = packed_dense_lower(np.asarray(tiles), lay)
    tri = lambda v, trans: sla.solve_triangular(
        L, v, lower=True, trans=trans, check_finite=False
    )
    err = host_sweep_error(y, r, lambda v: tri(v, "N"), lambda v: tri(v, "T"))
    del L
    nbytes = 2 * lay.T * lay.block * lay.block * tiles.dtype.itemsize
    report("c", stage="check", **errs, layout=lay._asdict(), sweep_rel_err=err,
           sweep_s=t, sweep_bytes=nbytes, sweep_floor_s=nbytes / HBM_BYTES_PER_S)
    check_certified(errs)
    check(err <= SWEEP_TOL, f"packed sweep error {err:.3e}")


def phase_d(args, sizes):
    from cuadmm_jax.models.random_sdp import random_certified_sdp_sparse
    from cuadmm_jax.ops.tri_stream import BandLayout, band_solve

    n_blocks, con = sizes["d"]
    prob, _, _, _, opt = random_certified_sdp_sparse(
        small_blocks(n_blocks, 5), con, coupling="chain", seed=6
    )
    solver, res = run_solve("d", prob, config(args, "banded"), "banded")
    errs = certified_errors(prob, res.X, opt)
    neq = solver.params.neq
    lay = BandLayout(*neq.band_layout)
    tiles = neq.band_tiles
    r = np.zeros(lay.n_pad)
    r[: lay.n] = np.random.default_rng(1).standard_normal(lay.n)
    sweep = jax.jit(lambda t, v: band_solve(t, v, lay))
    rd = jnp.asarray(r, tiles.dtype)
    y = sweep(tiles, rd)
    t = device_time(sweep, tiles, rd)
    ab, kd = band_lower_storage(tiles, lay)

    def tb(v, trans):
        x, info = sla.lapack.dtbtrs(ab, v[:, None], uplo="L", trans=trans)
        check(info == 0, f"dtbtrs info {info}")
        return x[:, 0]

    err = host_sweep_error(y, r, lambda v: tb(v, "N"), lambda v: tb(v, "T"))
    nbytes = 2 * lay.T * lay.block * lay.block * tiles.dtype.itemsize
    report("d", stage="check", **errs, layout=lay._asdict(),
           rcm_permuted=neq.band_perm is not None, sweep_rel_err=err,
           sweep_s=t, sweep_bytes=nbytes, sweep_floor_s=nbytes / HBM_BYTES_PER_S)
    check_certified(errs)
    check(err <= SWEEP_TOL, f"band sweep error {err:.3e}")


def phase_e(args, sizes):
    from cuadmm_jax import SDPSolver, SolverConfig
    from cuadmm_jax.models.random_sdp import random_certified_sdp_sparse

    n = 512 if args.tiny else 4096
    rng = np.random.default_rng(0)
    a64 = rng.standard_normal((n, n))
    ref = a64 @ a64.T
    nrm = np.linalg.norm(ref)
    a32 = jnp.asarray(a64, jnp.float32)
    dflt = jax.jit(lambda x: x @ x.T)(a32)
    high = jax.jit(lambda x: jnp.matmul(x, x.T, precision="highest"))(a32)
    err = lambda m: float(np.linalg.norm(np.asarray(m, np.float64) - ref) / nrm)
    spd = ref / n + np.eye(n)
    a_d, spd_d = jnp.asarray(a64), jnp.asarray(spd)
    mm64 = jax.jit(lambda x: x @ x.T)
    chol = jax.jit(jnp.linalg.cholesky)(spd_d)
    t_mm64 = device_time(mm64, a_d)
    canary = {
        "matmul_f32_default_err": err(dflt),
        "matmul_f32_highest_err": err(high),
        "matmul_f64_err": err(mm64(a_d)),
        "cholesky_f64_err": float(
            np.linalg.norm(np.asarray(chol) @ np.asarray(chol).T - spd) / np.linalg.norm(spd)
        ),
        "matmul_f64_s": t_mm64, "matmul_f64_flop_per_s": 2 * n**3 / t_mm64,
    }
    # The host-callback normal solver (jax.pure_callback) on this device.
    prob, _, _, _, opt = random_certified_sdp_sparse(small_blocks(40, 7), 110, seed=8)
    res = SDPSolver(
        prob, SolverConfig(verbose=False, normal_solver="host", stop_tol=STOP_TOL)
    ).solve(max_iter=MAX_ITER)
    host = certified_errors(prob, res.X, opt)
    report("e", stage="check", **canary, host_mode_converged=res.converged,
           host_mode_obj_rel_err=host["obj_rel_err"], peak_bytes_in_use=peak_bytes())
    check(canary["matmul_f32_highest_err"] < 1e-5, "HIGHEST f32 matmul is not f32")
    check(canary["matmul_f64_err"] < 1e-12, "f64 matmul is not f64")
    check(canary["cholesky_f64_err"] < 1e-12, "f64 Cholesky is not f64")
    check(res.converged, "host-mode solve did not converge")
    check_certified(host)


# ----------------------------------------------------------------------
# Four devices.
# ----------------------------------------------------------------------


def phase_mesh(args, sizes):
    """Phase (a)'s problem with the block buckets sharded over 4 devices,
    against the same solve on one device."""
    from cuadmm_jax.parallel.mesh import make_mesh

    prob, _, _, _, opt = problem_a(sizes)
    cfg = config(args, "precond")
    _, one = run_solve("mesh_1", prob, cfg, "precond")
    _, four = run_solve("mesh_4", prob, cfg, "precond", mesh=make_mesh(4))
    e1, e4 = certified_errors(prob, one.X, opt), certified_errors(prob, four.X, opt)
    diff = abs(e1["obj_host"] - e4["obj_host"]) / max(1.0, abs(opt))
    report("mesh", stage="check", one=e1, four=e4, obj_rel_diff=diff)
    check_certified(e1)
    check_certified(e4)
    check(diff <= OBJ_TOL, f"mesh and single-device objectives differ by {diff:.3e}")


def phase_sharded(args, sizes):
    """normal_solver='sharded' on 4 devices against the one-device packed
    rung on phase (c)'s problem."""
    from cuadmm_jax.parallel.mesh import make_mesh

    prob, _, _, _, opt = problem_c(sizes)
    _, packed = run_solve("sharded_1", prob, config(args, "packed"), "packed")
    _, shard = run_solve(
        "sharded_4", prob, config(args, "sharded", named=True), "sharded",
        mesh=make_mesh(4),
    )
    e1, e4 = certified_errors(prob, packed.X, opt), certified_errors(prob, shard.X, opt)
    diff = abs(e1["obj_host"] - e4["obj_host"]) / max(1.0, abs(opt))
    report("sharded", stage="check", packed=e1, sharded=e4, obj_rel_diff=diff)
    check_certified(e1)
    check_certified(e4)
    check(diff <= OBJ_TOL, f"sharded and packed objectives differ by {diff:.3e}")


def phase_batch(args, sizes):
    """A BatchedSDPSolver batch (shared A, per-instance certified b, C)
    with its instance axis sharded over 4 devices."""
    from cuadmm_jax import Problem
    from cuadmm_jax.models.random_sdp import certified_pair, random_certified_sdp_sparse
    from cuadmm_jax.parallel.batch import BatchedSDPSolver
    from cuadmm_jax.parallel.mesh import make_mesh

    k, n_blocks, con = sizes["batch"]
    blk = small_blocks(n_blocks, 9)
    prob0, x0, y0, s0, opt0 = random_certified_sdp_sparse(blk, con, seed=10)
    A = a_matrix(prob0)
    probs, opts = [prob0], [opt0]
    rng = np.random.default_rng(11)
    for _ in range(k - 1):
        x, s = certified_pair(blk, 0.5, rng)
        y = rng.standard_normal(con)
        C = s + A.T @ y
        probs.append(Problem.from_sparse(blk, A, A @ x, C))
        opts.append(float(C @ x))
    cfg = config(args, "precond")
    t0 = time.perf_counter()
    bs = BatchedSDPSolver(probs, cfg, mesh=make_mesh(4))
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = bs.solve(max_iter=MAX_ITER)
    solve_s = time.perf_counter() - t0
    errs = [certified_errors(p, r.X, o) for p, r, o in zip(probs, results, opts)]
    report("batch", stage="check", instances=k, con_num=con,
           neq_mode=bs.params.neq.mode, init_s=init_s, solve_s=solve_s,
           iterations=[r.iterations for r in results],
           converged=[r.converged for r in results],
           obj_rel_err=[e["obj_rel_err"] for e in errs],
           feas_host=[e["feas_host"] for e in errs],
           state_sharding=str(bs._initial_states(cfg.sig).X.sharding),
           peak_bytes_in_use=peak_bytes())
    check(all(r.converged for r in results), "batch did not converge")
    for e in errs:
        check_certified(e)


PHASES = {"a": phase_a, "b": phase_b, "c": phase_c, "d": phase_d, "e": phase_e}
FOUR_PHASES = {"mesh": phase_mesh, "sharded": phase_sharded, "batch": phase_batch}


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true", help="toy sizes, any backend")
    ap.add_argument("--four", action="store_true", help="the four-device paths only")
    args = ap.parse_args()

    CARD = card_info()
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu" and not args.tiny:
        print(f"no GPU: JAX found {platform!r} devices", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"need {need} devices, JAX found {len(devices)}", file=sys.stderr)
        return 2

    from cuadmm_jax.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    report("setup", platform=platform, kind=devices[0].device_kind,
           count=len(devices), jax=jax.__version__, compile_cache=cache,
           tiny=args.tiny)

    table = FOUR_PHASES if args.four else PHASES
    sizes = TINY if args.tiny else FULL
    failed = []
    for name in table:
        t0 = time.perf_counter()
        try:
            table[name](args, sizes)
            report(name, stage="done", passed=True, wall_s=time.perf_counter() - t0)
        except Exception as e:  # report every phase, then fail as a whole
            traceback.print_exc()
            failed.append(name)
            report(name, stage="done", passed=False, wall_s=time.perf_counter() - t0,
                   error=f"{type(e).__name__}: {e}")
    print(CARD, flush=True)
    if failed or platform != "gpu":
        why = f"failed phases {failed}" if failed else f"rehearsal on {platform}"
        print(f"no result: {why}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
