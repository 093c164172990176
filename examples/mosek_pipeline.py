"""Solve a MOSEK-format SPOT problem end to end.

Python counterpart of the reference's MATLAB pipeline
(reference: MATLAB/example_mosek.m:1-66), which chains
MOSEK -> SeDuMi -> SDPT3 -> cuADMM conversions across ~700 lines of
MATLAB utilities (examples/utils/*.m). Here the whole chain is
`load_mosek_mat` (cuadmm_jax/io/mosek.py).

Run: python examples/mosek_pipeline.py [path/to/problem.mat]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)  # default SolverConfig dtype is float64

from cuadmm_jax import SDPSolver, SolverConfig
from cuadmm_jax.io.mosek import load_mosek_mat

# PushT ships with the reference and solves its 200 demo iterations in
# ~1 min on CPU (PlanarHand N=1 has con_num ~ 66k -> the CG path, minutes).
DEFAULT = "/root/reference/examples/SPOT/data/MOSEK/PushT_N=10_MOMENT.mat"


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else DEFAULT
    if not os.path.exists(path):
        d = os.path.dirname(path)
        avail = sorted(f for f in os.listdir(d)) if os.path.isdir(d) else []
        sys.exit(f"{path} not found; available .mat files in {d}: {avail}")
    prob = load_mosek_mat(path)
    print(f"{os.path.basename(path)}: {len(prob.blk)} blocks, "
          f"{prob.con_num} constraints, vec_len {prob.vec_len}")

    # Same settings as the MATLAB example: sig=2e2, stop_tol=1e-3, 200 iters.
    cfg = SolverConfig(stop_tol=1e-3, sig=2e2, verbose=True, check_every=50)
    res = SDPSolver(prob, cfg).solve(max_iter=200)
    print(res.message)
    print(f"pobj {res.pobj:.6e}  dobj {res.dobj:.6e}  "
          f"errRp {res.errRp:.2e}  errRd {res.errRd:.2e}")


if __name__ == "__main__":
    main()
