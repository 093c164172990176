"""Benchmark table runner: solve the reference problem set and record
wall-clock / iterations / objectives (regenerates BASELINE.md-style rows).

Usage:
  python benchmarks/run_problems.py [--dtype float32] [--problems truss5,...]
                                    [--out benchmarks/results.jsonl]

Problems resolve against the read-only reference data tree. The reference's
published numbers (examples/benchmarks/benchmarks.csv + logs) are included
as `ref_*` fields where known.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF = "/root/reference/examples"

# name -> (loader-kind, path, reference numbers where known).
# ref_pobj: objective from the reference's committed solve logs (all at
# stop_tol 1e-3) or the published DIMACS optima; obj_match in the output
# checks |pobj - ref_pobj| / (1 + |pobj| + |dobj|) < 5e-3 (the
# reference's own relgap normalization, src/solver.cu -- the old
# /(1+|ref|) gate was vacuous for near-zero objectives: PlanarHand
# passed with a 140x relative discrepancy on the optimum scale).
PROBLEMS = {
    "truss5": ("txt", f"{REF}/dimacs/data/TXT/truss5", {"ref_pobj": 132.6356895}),
    "truss8": ("txt", f"{REF}/dimacs/data/TXT/truss8", {"ref_pobj": 133.1145891}),
    "cnhil10": ("txt", f"{REF}/plato/TXT/cnhil10",
                {"ref_total_s": 3.1, "ref_s_per_iter": 0.0230, "ref_pobj": 0.0}),
    "rose13": ("txt", f"{REF}/plato/TXT/rose13",
               {"ref_total_s": 210.7, "ref_s_per_iter": 0.0035, "ref_pobj": 11.9744487}),
    "ros_2000": ("txt", f"{REF}/plato/TXT/ros_2000", {"ref_total_s": 3.4}),
    # The TXT export of 1dc.1024 is incomplete (no C.txt) -- load the
    # cuADMM-layout MATLAB archive instead (validated bit-exact against
    # the committed At.txt, tests/test_importers.py).
    "1dc.1024": ("admm_mat", f"{REF}/plato/MATLAB/1dc.1024.mat",
                 {"ref_total_s": 22.1, "ref_s_per_iter": 0.0624, "ref_pobj": -97.1043558}),
    # biggs: no reference log or benchmarks.csv row exists. Diagnosis
    # (r4, CPU f64, 4 configs x 20k iters): pure-sGS drives errRp to
    # 1.6e-9 while pobj falls to -1.2e9 with relgap ~ 1 -- the instance
    # behaves primal-unbounded / dual-infeasible for this ADMM family
    # (sigma slams into sig_max, dual residual stalls at 0.48). The
    # reference publishes no number for it either; kept in the table as a
    # documented non-convergent instance.
    "biggs": ("txt", f"{REF}/plato/TXT/biggs", {"ref_converged": False,
               "note": "primal-unbounded behavior; no reference result exists"}),
    # NB: plato/TXT/chs5000 and taha1a in the reference tree are incomplete
    # (no At.txt), so they cannot be loaded despite having benchmarks.csv rows.
    "pusht_n10": (
        "txt",
        f"{REF}/SPOT/data/TXT/PushT_N=10_MOMENT",
        {"ref_total_s": 117.8, "ref_s_per_iter": 0.0163, "ref_pobj": 9.69571718e-02},
    ),
    "planarhand_n1": (
        "mosek",
        f"{REF}/SPOT/data/MOSEK/PlanarHand_N=1_MOMENT.mat",
        {"ref_total_s": 54.2, "ref_s_per_iter": 0.0616, "ref_pobj": 1.37991189e-05},
    ),
    # quasar-500's At.txt is in the reference's own .MISSING_LARGE_BLOBS
    # (unrecoverable); models/quasar.py regenerates the canonical QUASAR
    # relaxation with exactly matching constraint/nnz counts. The r4
    # experiments show the reference's logged pobj (452.24) lies strictly
    # between the canonical reconstruction (461.55) and the only other
    # count-consistent variant (446.71) -- so no objective gate is
    # possible; ref numbers kept for timing comparison only.
    "quasar500": (
        "quasar",
        f"{REF}/plato/TXT/quasar-500",
        {"ref_total_s": 1538.2, "ref_s_per_iter": 0.2460,
         "ref_iterations": 6253,
         "note": "reference At unrecoverable (.MISSING_LARGE_BLOBS); "
                 "canonical reconstruction, KKT-gated only"},
    ),
    # Remaining plato problems whose TXT exports lack At.txt; loaded from
    # the MATLAB archives instead. Reference numbers from plato/logs/*.log
    # where a log exists (swissroll's reference run hit max_iter at
    # relgap 1e-1, so no objective gate there; neosfbr25's log is empty).
    "bqp-r1-40-1": ("admm_mat", f"{REF}/plato/MATLAB/bqp-r1-40-1.mat",
                    {"ref_total_s": 706.1, "ref_s_per_iter": 0.0679,
                     "ref_pobj": -283.8205300}),
    "swissroll": ("admm_mat", f"{REF}/plato/MATLAB/swissroll.mat",
                  {"ref_total_s": 1972.1, "ref_s_per_iter": 0.0197,
                   "ref_converged": False}),
    "neosfbr25": ("admm_mat", f"{REF}/plato/MATLAB/neosfbr25.mat", {}),
    # SeDuMi-format archives (benchmarks.csv rows exist for taha1a).
    "taha1a": ("sedumi_mat", f"{REF}/plato/MATLAB/taha1a.mat",
               {"ref_total_s": 2.3}),
    "chs5000": ("sedumi_mat", f"{REF}/plato/MATLAB/chs_5000.mat", {}),
    # --- Large SPOT problems (TXT At.txt exports are all in the
    # reference's .MISSING_LARGE_BLOBS; the MOSEK archives are complete
    # and the importer is validated against the N=1/N=10 TXT trees,
    # tests/test_importers.py). Reference numbers: benchmarks.csv rows
    # (plain cuADMM / sGS-cuADMM total seconds) + per-problem logs.
    "pusht_n30": (
        "mosek", f"{REF}/SPOT/data/MOSEK/PushT_N=30_MOMENT.mat",
        # Only the sGS-cuADMM log exists (cuADMM.log is empty):
        # 1070.2 s total, 0.6122 s/iter, pobj 5.50299406e-2.
        {"ref_total_s": 1070.2, "ref_s_per_iter": 0.6122,
         "ref_pobj": 5.50299406e-02, "ref_mode": "sgs"},
    ),
    "pushbox_n30": (
        "mosek", f"{REF}/SPOT/data/MOSEK/PushBox_N=30_MOMENT.mat",
        # benchmarks.csv:2-5: cuADMM 905.1 s / sGS-cuADMM 278.0 s.
        {"ref_total_s": 905.1, "ref_total_s_sgs": 278.0},
    ),
    "pushbox_n30_sos": (
        "mosek", f"{REF}/SPOT/data/MOSEK/PushBox_N=30_SOS.mat", {},
    ),
    "pushbox_n50": (
        "mosek", f"{REF}/SPOT/data/MOSEK/PushBox_N=50_MOMENT.mat", {},
    ),
    "planarhand_n10": (
        "mosek", f"{REF}/SPOT/data/MOSEK/PlanarHand_N=10_MOMENT.mat",
        # No log; the reference solves this with the 2-GPU duo solver
        # (src/duo_solver.cu).
        {},
    ),
    # Pendulum N=80 (112,028 cons): SeDuMi struct nested in SDP.sedumi.
    # Reference log examples/pendulum/N=80_licols.log: 0.0222 s/iter; the
    # run chased a ~1e-4 tolerance to max_iter (2218.7 s, best KKT
    # 1.5e-4) but CROSSED the 1e-3 tolerance this table solves to at
    # iteration 6,500 / 166.4 s -- that is the tolerance-matched bar.
    "pendulum_n80": (
        "pendulum", f"{REF}/pendulum/MATLAB/N=80_licols.mat",
        {"ref_total_s": 166.4, "ref_s_per_iter": 0.0222,
         "ref_total_s_tol1e4_maxiter": 2218.7},
    ),
    # DIMACS hinf12/13: complete TXT exports; no benchmarks.csv row or
    # reference log -- KKT-gated only.
    "hinf12": ("txt", f"{REF}/dimacs/data/TXT/hinf12", {}),
    "hinf13": ("txt", f"{REF}/dimacs/data/TXT/hinf13", {}),
    # PushBot N=1/N=10, Tunnel N=1 and PushT N=5 appear in
    # benchmarks.csv but the reference tree ships NO data files for them
    # (no TXT/MOSEK entries anywhere) -- not runnable.
}


def load(kind: str, path: str):
    from cuadmm_jax import Problem
    from cuadmm_jax.io.mosek import load_mosek_mat

    if kind == "txt":
        return Problem.from_txt(path)
    if kind == "mosek":
        return load_mosek_mat(path)
    if kind == "admm_mat":
        from cuadmm_jax.io.admm_mat import load_admm_mat

        return load_admm_mat(path)
    if kind == "quasar":
        from cuadmm_jax.models.quasar import load_quasar_txt

        return load_quasar_txt(path)
    if kind == "sedumi_mat":
        from cuadmm_jax.io.sedumi import load_sedumi_mat

        return load_sedumi_mat(path)
    if kind == "pendulum":
        # SeDuMi data nested as SDP.sedumi.{At,b,c,K} (a full MATLAB
        # workspace dump, not a flat sedumi file).
        import scipy.io as sio

        from cuadmm_jax.io.sedumi import sedumi_to_problem

        s = sio.loadmat(path)["SDP"][0, 0]["sedumi"][0, 0]
        K = s["K"][0, 0]
        return sedumi_to_problem(
            s["At"].T, s["b"], s["c"],
            {n: K[n] for n in K.dtype.names}, name=path.rsplit("/", 1)[-1],
        )
    raise ValueError(kind)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--problems", default=",".join(PROBLEMS))
    ap.add_argument("--out", default="benchmarks/results.jsonl")
    ap.add_argument("--stop-tol", type=float, default=1e-3)
    ap.add_argument("--max-iter", type=int, default=100_000)
    ap.add_argument("--sig", type=float, default=None, help="default: 200 for moment problems, 1 otherwise")
    ap.add_argument("--check-every", type=int, default=100)
    ap.add_argument(
        "--mode", default="auto", choices=["auto", "admm", "sgs"],
        help="auto: default sGS->ADMM switch at 5000; admm: plain ADMM "
        "from iter 0; sgs: stay in sGS mode (the reference's sGS-cuADMM)",
    )
    ap.add_argument("--platform", default=None, help="force a jax platform (e.g. cpu)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    # x64 always: the normal-equation refinement accumulates in f64 even
    # for float32 state (ops/chol.py).
    jax.config.update("jax_enable_x64", True)
    from cuadmm_jax import SDPSolver, SolverConfig
    from cuadmm_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    backend = jax.default_backend()
    # Incremental append: a crash or timeout on one problem must not lose
    # the completed rows (the reference ships per-problem logs,
    # examples/benchmarks/plato/logs/*.log -- same idea).
    open(args.out, "w").close()
    for name in args.problems.split(","):
        kind, path, ref = PROBLEMS[name]
        row = {"problem": name, "dtype": args.dtype, "backend": backend, **ref}
        try:
            prob = load(kind, path)
            sig = args.sig if args.sig is not None else (200.0 if "MOMENT" in path else 1.0)
            # auto = reference default (switch at 5e4, src/solver.cu:332;
            # pendulum's own log switches at 11k only because its run set
            # it -- pure sGS carried it through the 1e-3 crossing).
            switch = {"auto": 50_000, "admm": 0, "sgs": 10**9}[args.mode]
            cfg = SolverConfig(
                dtype=args.dtype,
                stop_tol=args.stop_tol,
                verbose=False,
                check_every=args.check_every,
                sig=sig,
                switch_admm=switch,
            )
            row["mode"] = args.mode
            t0 = time.perf_counter()
            solver = SDPSolver(prob, cfg)
            init_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = solver.solve(max_iter=args.max_iter)
            if (
                args.dtype == "float32"
                and not res.converged
                and not res.diverged
                and "float32 precision floor" in res.message
            ):
                # Mixed-precision ladder tail (driver.solve_escalated
                # semantics, reusing the already-initialized f32 solver's
                # result as the warm start).
                import dataclasses as _dc

                from cuadmm_jax import SolverConfig as _SC

                cfg64 = _dc.replace(cfg, dtype="float64")
                s64 = SDPSolver(prob, cfg64)
                res64 = s64.solve(
                    max_iter=max(args.max_iter - res.iterations, 1),
                    stop_tol=args.stop_tol,
                    X0=res.X, y0=res.y, S0=res.S, sig=res.sig,
                )
                res = _dc.replace(
                    res64, iterations=res.iterations + res64.iterations
                )
                row["escalated_f64"] = True
            solve_s = time.perf_counter() - t0
            row.update(
                converged=res.converged,
                iterations=res.iterations,
                solve_s=round(solve_s, 2),
                init_s=round(init_s, 2),
                s_per_iter=round(solve_s / max(res.iterations, 1), 5),
                pobj=res.pobj,
                dobj=res.dobj,
                errRp=res.errRp,
                errRd=res.errRd,
                relgap=res.relgap,
                neq_mode=solver.params.neq.mode,
                recoveries=res.recoveries,
            )
            if "ref_total_s" in ref:
                # Honest wall-clock: the reference's total includes its
                # CHOLMOD analyze+factorize, so ours must include init.
                row["speedup_total"] = round(
                    ref["ref_total_s"] / max(init_s + solve_s, 1e-9), 2
                )
                row["speedup_solve"] = round(
                    ref["ref_total_s"] / max(solve_s, 1e-9), 2
                )
            if "ref_pobj" in ref:
                # Relgap-style normalization (see PROBLEMS comment).
                row["obj_match"] = bool(
                    abs(res.pobj - ref["ref_pobj"])
                    / (1.0 + abs(res.pobj) + abs(res.dobj))
                    < 5e-3
                )
        except Exception as e:  # record the failure, keep going
            row.update(error=f"{type(e).__name__}: {e}")
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
