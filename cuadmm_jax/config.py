"""Solver configuration.

The reference scatters its knobs over hard-coded constants
(reference: src/solver.cu:16-19, src/main.cu:10-11, include/cuadmm/solver.h:236-243)
and positional arguments (a known pitfall: src/main.cu:39 silently sets
sig_update_threshold=0). Here every knob lives in one frozen dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Configuration for the sGS-ADMM SDP solver.

    Algorithm parameters (matching reference semantics):

    - ``max_iter``/``stop_tol``: termination; stop when
      max(errRp, errRd, relgap) < stop_tol (reference: src/solver.cu:419-427).
    - ``sig``: initial Lagrangian penalty sigma (reference: src/main.cu:24).
    - ``sig_update_threshold``/``sig_update_stage_1``/``sig_update_stage_2``:
      sigma is re-balanced every ``stage_1`` iterations while
      iter <= threshold, every ``stage_2`` after
      (reference: src/solver.cu:787-799). The reference CLI passes
      threshold=0 (src/main.cu:39), which we keep as the default since it
      produced the published benchmark numbers.
    - ``sigscale``: multiplicative sigma step (reference: src/solver.cu:19).
    - ``sig_min``/``sig_max``: sigma clamp (reference: src/solver.cu:326-327).
    - ``switch_admm``: iteration at which sGS-ADMM degrades to plain ADMM
      with best-iterate tracking (reference: src/solver.cu:681-690). Set to 0
      for plain ADMM from the start, or a huge value for pure sGS.

    Execution parameters (no reference equivalent; they replace CUDA
    streams / cuSOLVER workspace machinery):

    - ``dtype``: "float64" (reference parity; requires jax x64) or "float32".
    - ``check_every``: the jitted iteration loop runs in chunks of this many
      iterations between host-side convergence checks. The reference checks
      every iteration on the host, which stalls the device in between.
    - ``bucket_rounding``: "pow2" pads each PSD block bucket up to the next
      power of two (fewer XLA kernels, aligned shapes), "exact" keeps one
      bucket per distinct block size (reference behaviour: one
      syevjBatched/Xsyevd call per size class, src/solver.cu:540-592).
    - ``exact_above``: with "pow2" rounding, block sizes above this are
      never padded (padding large eigh is wasted FLOPs).
    - ``pack_to``: pack PSD blocks of size <= pack_to/2 along the diagonals
      of pack_to x pack_to super-matrices before eigh (exact: spectral
      functions respect block-diagonal structure). Turns thousands of tiny
      eigh problems into a few larger ones. 0 (default) = off. Ignored
      when ``eig_rank`` is set (top-k per block is not preserved under
      packing).
    - ``normal_solver``: how (AA^T) y = rhs is solved each iteration.
      "precond" = one-time f32 device Cholesky of the *regularized*
      AA^T + precond_eps*I whose triangular factor is inverted explicitly
      on the GPU (two matvecs per application), plus ``precond_applies``
      f64 refinement sweeps against the exact sparse AA^T per solve --
      correct even on the numerically singular AA^T of moment SDPs
      because ADMM right-hand sides are consistent (see ops/chol.py).
      "dense" = f64 Cholesky + cho_solve + the same refinement (CPU
      parity path). "packed" = packed block-triangular tiles + sweeps
      over block rows (past ``dense_chol_max``, up to a ceiling derived
      from the device's memory). "banded" = block-band factor under an
      RCM row permutation for chain/trajectory SDPs with banded AA^T
      (pendulum N=80, PushBox N=30) -- far fewer bytes per solve and
      coverage past the packed ceiling. "split" = exact
      direct solve when AA^T is block-diagonal under a permutation.
      "sharded" = distributed blocked Cholesky + triangular solves over
      a jax.sharding.Mesh (pass ``mesh=`` to SDPSolver) for problems no
      single device can factor. "cg" = device preconditioned conjugate
      gradient (FSAI / block-Jacobi). "host" = scipy sparse
      factorization with a host callback per solve (reference-style;
      jax.pure_callback needs the CPU platform too, e.g.
      JAX_PLATFORMS=cuda,cpu).
      "auto" picks by structural probes (split coupling, RCM bandwidth)
      and a device-memory model: split -> precond/dense ->
      banded/packed -> sharded -> cg.
    - ``precond_eps``: relative diagonal regularization of the f32
      preconditioner factor (escalates x10 on Cholesky failure).
    - ``precond_applies``: refinement sweeps per solve. Each sweep costs
      one factor application + two sparse matvecs and contracts the
      residual by ~precond_eps. 0 (default) calibrates the count on the
      target device at init against a dtype-aware residual target -- this
      doubles as an on-device factor sanity check (init fails loudly if the
      factor cannot reach 1e-2 relative residual).
    - ``cg_tol``/``cg_max_iter``: CG stopping parameters. cg_tol <= 0
      selects a dtype-aware default (64*eps -- an absolute 1e-12 is
      unreachable in f32 and burns cg_max_iter matvecs every solve).
    """

    # Termination.
    max_iter: int = 1_000_000
    stop_tol: float = 1e-3

    # Sigma adaptation.
    sig: float = 1.0
    sig_update_threshold: int = 0
    sig_update_stage_1: int = 50
    sig_update_stage_2: int = 100
    sigscale: float = 1.05
    sig_min: float = 1e-3
    sig_max: float = 1e3

    # sGS -> ADMM switch.
    switch_admm: int = 50_000  # reference default 5e4, src/solver.cu:332

    # Execution.
    dtype: str = "float64"
    check_every: int = 50
    bucket_rounding: str = "pow2"
    exact_above: int = 64
    pack_to: int = 0
    # PSD projection backend: "eigh" (batched eigendecomposition),
    # "poly" (matmul-only composite polynomial sign filter,
    # ops/polyfilter.py), "jacobi" (batched cyclic Jacobi, ops/jacobi.py),
    # or "auto" (calibrated per-bucket dispatch from the committed sweep
    # table of the running backend when one exists, else eigh).
    # eig_rank forces eigh.
    projection: str = "auto"
    normal_solver: str = "auto"
    dense_chol_max: int = 32768
    cg_tol: float = 0.0  # <= 0: dtype-aware default (64*eps)
    cg_max_iter: int = 400
    cg_block_jacobi: int = 2048  # block width of the CG preconditioner (0 = Jacobi)
    # CG preconditioner family: "auto" (FSAI, falling back to block-Jacobi
    # if the build fails), "fsai", "block_jacobi", or "jacobi". FSAI
    # (ops/fsai.py) is a sparse approximate inverse Cholesky factor applied
    # as two sparse matvecs -- the device-resident analog of the reference's
    # CHOLMOD triangular solves (cholesky_cpu.h:62-155); measured 3.5-5.6x
    # fewer CG iterations than (block-)Jacobi on PlanarHand N=1.
    cg_precond: str = "auto"
    fsai_cap: int = 64  # max pattern nonzeros per FSAI row
    fsai_pattern_power: int = 2  # FSAI pattern = tril((AA^T)^power)
    aat_eps: float = 1e-15  # diagonal regularization of AA^T (reference: src/solver.cu:94)
    precond_eps: float = 1e-4  # f32 preconditioner regularization (relative)
    precond_applies: int = 0  # refinement sweeps per solve; 0 = calibrate on device

    # Low-rank projection: keep only the top-k eigenvalues per block
    # (working version of the reference's get_eig_rank_mask experiment).
    eig_rank: int | None = None

    # Divergence auto-recovery: when a chunk produces non-finite residuals,
    # restart from the best finite iterate with escalated numerics (eigh
    # projection + extra refinement sweeps, then a factor-free CG normal
    # solver) before aborting. The reference never needs this -- CHOLMOD
    # f64 host solves are exact every iteration (cholesky_cpu.h:62-155);
    # a reduced-precision stage can corrupt the iterate, so the driver
    # self-heals instead of wasting the run.
    divergence_recovery: bool = True

    # Logging.
    verbose: bool = True

    # Profiling: when set, the driver captures a jax.profiler trace of one
    # steady-state iteration chunk (the second chunk of the solve -- the
    # first includes compilation) into this directory, viewable with
    # tensorboard / xprof. Counterpart of the reference's cudaEvent
    # timing pairs (reference: src/solver.cu:41-44, 435-438, 463-466).
    profile_dir: Optional[str] = None

    def __post_init__(self):
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be float32 or float64, got {self.dtype}")
        if self.bucket_rounding not in ("pow2", "exact"):
            raise ValueError(f"bucket_rounding must be pow2 or exact, got {self.bucket_rounding}")
        if self.normal_solver not in ("auto", "precond", "dense", "inv", "cg", "host", "packed", "banded", "sharded", "split"):
            raise ValueError(f"unknown normal_solver {self.normal_solver}")
        if self.cg_precond not in ("auto", "fsai", "block_jacobi", "jacobi"):
            raise ValueError(f"unknown cg_precond {self.cg_precond}")
        if self.projection not in ("auto", "eigh", "poly", "jacobi"):
            raise ValueError(f"unknown projection {self.projection}")

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)
