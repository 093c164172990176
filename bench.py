"""Benchmark driver: steady-state ADMM iteration rate on PushT N=10.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Mode-matched comparison (the round-1 bench compared an sGS run against the
plain-ADMM baseline -- apples to oranges): we run **plain ADMM**
(switch_admm=0, one normal solve per iteration, tau=1.618), and the
baseline is the reference cuADMM in the same mode on the same problem:
0.0163 s/iteration = 61.35 it/s on its (unstated) GPU
(reference: examples/benchmarks/PushT_N=10_MOMENT/cuADMM.log tail).
The problem: 17150 constraints, 6015 PSD blocks of sizes 1..13.

Correctness gates (a perf harness must not report the iteration rate of a
diverged solver -- round-1 lesson): the run fails (value 0, non-zero exit)
unless (a) all residuals are finite end-to-end, and (b) errRp decreased
over the measured window.

Env knobs:
  BENCH_DTYPE=float64|float32   (default: float64, reference parity)
  BENCH_ITERS=N                 (timed iterations, default 600)
  BENCH_PROBLEM=path            (default PushT N=10)
  BENCH_MODE=admm|sgs           (default admm; sgs uses the 33.0 it/s
                                 sGS-cuADMM baseline, 0.0303 s/it)
"""

import json
import os
import sys
import time

import jax

# x64 is required regardless of the state dtype: the normal-equation solver
# accumulates refinement residuals in f64 (ops/chol.py).
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from cuadmm_jax import Problem, SDPSolver, SolverConfig
from cuadmm_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()

# Reference cuADMM on PushT N=10 (examples/benchmarks/PushT_N=10_MOMENT/):
BASELINES = {"admm": 61.35, "sgs": 33.0}  # it/s (0.0163 / 0.0303 s/it)
DEFAULT_PROBLEM = "/root/reference/examples/SPOT/data/TXT/PushT_N=10_MOMENT"


def on_chip_diagnostics(solver) -> dict:
    """Numerics canaries executed on the live backend before timing.

    A platform-robust bench must verify, on the device, the assumptions
    the solver rests on (round-2 lesson: the identical config converged on
    CPU and diverged on an accelerator, and the bench captured nothing
    that localized it):

    - matmul_hi / matmul_default: relative error of an f32 GEMM vs the f64
      host result, with explicit HIGHEST precision and ambient default.
      HIGHEST must be ~1e-7; default ~1e-3 reveals TF32.
    - f64_emul: error of an f64 dot needing > 24-bit mantissa -- verifies
      f64 arithmetic (the refinement path accumulates in f64).
    - neq_resid: relative residual of the normal solve on a consistent
      probe rhs = (AA^T) v -- verifies the factor + refinement on-device
      (reference bar: CHOLMOD's backward-stable f64 host solve,
      include/cuadmm/cholesky_cpu.h:62-155).
    """
    import jax.numpy as jnp

    diag = {}
    rng = np.random.default_rng(0)
    a64 = rng.standard_normal((256, 256))
    a = jnp.asarray(a64, jnp.float32)
    ref = a64 @ a64.T
    nrm = np.linalg.norm(ref)
    hi = jax.jit(
        lambda x: jax.lax.dot_general(
            x, x, (((1,), (1,)), ((), ())), precision="highest"
        )
    )(a)
    lo = jax.jit(lambda x: jax.lax.dot_general(x, x, (((1,), (1,)), ((), ()))))(a)
    diag["matmul_hi"] = float(np.linalg.norm(np.asarray(hi, np.float64) - ref) / nrm)
    diag["matmul_default"] = float(
        np.linalg.norm(np.asarray(lo, np.float64) - ref) / nrm
    )
    if jax.config.jax_enable_x64:
        v = jnp.asarray([1.0, 1e-14, -1.0], jnp.float64)
        diag["f64_emul"] = float(
            abs(float(jax.jit(jnp.sum)(v)) - 1e-14) / 1e-14
        )

    # The projection actually dispatched (a per-bucket dict when a
    # committed calibration table engaged -- the is_large_mat analog).
    diag["projection"] = str(solver._projection)
    neq = solver.params.neq
    diag["neq_mode"] = neq.mode
    diag["neq_eps_used"] = neq.eps_used
    if neq.sparse_a is not None:
        from cuadmm_jax.ops.sparse import spmv_a, spmv_at

        v = jnp.asarray(
            rng.standard_normal(solver.problem.con_num), solver.dtype
        )
        rhs = spmv_a(neq.sparse_a, spmv_at(neq.sparse_a, v.astype(jnp.float64))).astype(
            solver.dtype
        )
        # neq as an argument, not a closure constant (a ~GB factor baked
        # into the HLO bloats compilation).
        y = jax.jit(lambda nq, r: nq.solve(r))(neq, rhs)
        diag["neq_resid"] = float(neq.residual_norm(rhs, y))
    return diag


def main() -> None:
    dtype = os.environ.get("BENCH_DTYPE", "float64")
    iters = int(os.environ.get("BENCH_ITERS", "600"))
    path = os.environ.get("BENCH_PROBLEM", DEFAULT_PROBLEM)
    mode = os.environ.get("BENCH_MODE", "admm")
    baseline = BASELINES[mode]

    prob = Problem.from_txt(path)
    extra = {}
    # Numerics experiment knobs (BENCH_APPLIES=1 halves the per-iteration
    # factor traffic at the cost of a looser normal-solve residual; the
    # correctness gates below decide whether that trade is admissible).
    if os.environ.get("BENCH_APPLIES"):
        extra["precond_applies"] = int(os.environ["BENCH_APPLIES"])
    if os.environ.get("BENCH_PRECOND_EPS"):
        extra["precond_eps"] = float(os.environ["BENCH_PRECOND_EPS"])
    cfg = SolverConfig(
        dtype=dtype,
        verbose=False,
        check_every=100,
        # Plain-ADMM mode from iteration 0 (sgs: stay in sGS forever);
        # stop_tol=0 disables early exit so we time steady-state iterations.
        switch_admm=0 if mode == "admm" else 10**9,
        stop_tol=0.0,
        **extra,
    )
    t0 = time.perf_counter()
    solver = SDPSolver(prob, cfg)
    init_s = time.perf_counter() - t0
    diag = on_chip_diagnostics(solver)
    diag["init_s"] = round(init_s, 2)
    diag["init_breakdown"] = solver.init_breakdown

    # Warmup: compile + a few chunks.
    t0 = time.perf_counter()
    warm_res = solver.solve(max_iter=100, stop_tol=0.0)
    warm = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = solver.solve(max_iter=iters, stop_tol=0.0)
    elapsed = time.perf_counter() - t0
    its = res.iterations / elapsed

    # Correctness gates.
    err_hist = res.info["errRp"]
    finite = bool(
        np.isfinite(res.errRp)
        and np.isfinite(res.errRd)
        and np.isfinite(res.relgap)
        and not res.diverged
        and np.all(np.isfinite(err_hist))
    )
    decreased = bool(
        len(err_hist) >= 2 and float(err_hist[-1]) < float(err_hist[0])
    )
    ok = finite and decreased

    # Per-chunk errRp trace (check_every cadence): enough to see where a
    # divergence starts without flooding the one-line contract.
    stride = max(1, len(err_hist) // 12)
    trace = [round(float(v), 5) for v in err_hist[::stride][:12]]

    print(
        json.dumps(
            {
                "metric": f"pusht_n10_{mode}_iters_per_sec",
                "value": round(its, 3) if ok else 0.0,
                "unit": "iter/s",
                "vs_baseline": round(its / baseline, 4) if ok else 0.0,
                "dtype": dtype,
                "mode": mode,
                "iters_timed": res.iterations,
                "warmup_s": round(warm, 2),
                "errRp": float(res.errRp),
                "errRd": float(res.errRd),
                "errRp_first": float(err_hist[0]) if len(err_hist) else None,
                "errRp_trace": trace,
                "finite": finite,
                "errRp_decreased": decreased,
                "recoveries": res.recoveries + warm_res.recoveries,
                "diag": diag,
            }
        )
    )
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
