"""Command-line front end.

Counterpart of the reference executable (reference: src/main.cu:8-44):
``cuadmm_jax solve <dir>`` loads a TXT problem directory, runs the solver,
and writes ``X_opt.txt`` next to the inputs (or at --output).

Unlike the reference (positional hard-coded arguments), every solver knob
is a flag.
"""

from __future__ import annotations

import argparse
import os
import sys


def _force_platform(platform: str | None) -> None:
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="cuadmm_jax", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("solve", help="solve a TXT problem directory")
    ps.add_argument("dir", help="problem directory containing At.txt, b.txt, C.txt, blk.txt, con_num.txt")
    ps.add_argument("--max-iter", type=int, default=1_000_000)
    ps.add_argument("--stop-tol", type=float, default=1e-3)
    ps.add_argument("--sig", type=float, default=1.0)
    ps.add_argument("--switch-admm", type=int, default=5000,
                    help="iteration at which sGS-ADMM switches to plain ADMM (0 = plain ADMM)")
    ps.add_argument("--dtype", choices=["float32", "float64"], default="float64")
    ps.add_argument(
        "--normal-solver",
        choices=["auto", "precond", "dense", "packed", "split", "cg", "host"],
        default="auto",
    )
    ps.add_argument("--check-every", type=int, default=50)
    ps.add_argument("--warm-start", action="store_true", help="read X.txt/y.txt/S.txt from the directory")
    ps.add_argument("--output", default=None, help="output file (default <dir>/X_opt.txt)")
    ps.add_argument("--platform", default=None, help="force a jax platform (cpu/cuda)")
    ps.add_argument("--quiet", action="store_true")

    pi = sub.add_parser("info", help="print problem structure without solving")
    pi.add_argument("dir")

    args = parser.parse_args(argv)

    if args.cmd == "info":
        from cuadmm_jax.problem import Problem
        from cuadmm_jax.structure import BlockStructure

        prob = Problem.from_txt(args.dir)
        st = BlockStructure(prob.blk)
        print(f"problem: {prob.name}")
        print(f"  vec_len: {prob.vec_len}")
        print(f"  constraints: {prob.con_num}")
        print(f"  At nnz: {prob.At_nnz}")
        print("  " + st.describe().replace("\n", "\n  "))
        return 0

    import jax

    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    _force_platform(args.platform)

    from cuadmm_jax import Problem, SDPSolver, SolverConfig
    from cuadmm_jax.io import txt as txtio

    prob = Problem.from_txt(args.dir, warm_start=args.warm_start)
    cfg = SolverConfig(
        max_iter=args.max_iter,
        stop_tol=args.stop_tol,
        sig=args.sig,
        switch_admm=args.switch_admm,
        dtype=args.dtype,
        normal_solver=args.normal_solver,
        check_every=args.check_every,
        verbose=not args.quiet,
    )
    solver = SDPSolver(prob, cfg)
    res = solver.solve()

    out = args.output or os.path.join(args.dir, "X_opt.txt")
    txtio.write_dense_vector(out, res.X)
    if not args.quiet:
        print(f"wrote {out}")
    return 0 if res.converged else 2


if __name__ == "__main__":
    sys.exit(main())
