"""cuadmm_jax: a JAX multi-block SDP solver (sGS-ADMM).

A from-scratch JAX/XLA re-design of the capabilities of
ComputationalRobotics/cuADMM (CUDA C++): solves
    min <C,X>  s.t.  <A_i,X> = b_i,  X in a product of PSD cones
with the symmetric Gauss-Seidel ADMM scheme, entirely on-device.

Public API:
    Problem        -- problem container + TXT/SDPA/SeDuMi loaders
    SDPSolver      -- init/solve driver (warm starts, re-entrant solves)
    SolverConfig   -- every algorithm & execution knob in one dataclass
    solve          -- one-shot convenience wrapper
"""

from cuadmm_jax.config import SolverConfig
from cuadmm_jax.problem import Problem
from cuadmm_jax.solver.driver import SDPResult, SDPSolver, solve, solve_escalated
from cuadmm_jax.structure import BlockStructure

__version__ = "0.1.0"

__all__ = [
    "Problem",
    "SDPSolver",
    "SDPResult",
    "SolverConfig",
    "BlockStructure",
    "solve",
]
