"""SDPSolver: the user-facing solve driver.

Replaces the reference's SDPSolver/SDPDuoSolver pair (reference:
src/solver.cu, src/duo_solver.cu). The duo solver exists only because of
CUDA-specific eig dispatch (multi-GPU moment matrices via host threads +
cudaMemcpyPeerAsync, duo_solver.cu:487-618); here one solver covers all
block profiles -- multi-device scaling is sharding annotations on the
same program (see cuadmm_jax.parallel).

Execution model: the sGS-ADMM iteration is jitted once; the driver runs it
in chunks of ``config.check_every`` iterations between host-side
convergence checks and log prints (the reference syncs the host every
iteration, which stalls the device between iterations).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from cuadmm_jax.config import SolverConfig
from cuadmm_jax.ops import chol as chol_ops
from cuadmm_jax.ops import sparse as sparse_ops
from cuadmm_jax.ops.svec import device_maps, pool_from_svec, svec_from_pool
from cuadmm_jax.problem import Problem
from cuadmm_jax.solver import scaling as scaling_mod
from cuadmm_jax.solver.state import INFO_FIELDS, SolveParams, SolverState
from cuadmm_jax.solver.step import make_chunk_runner, make_step
from cuadmm_jax.structure import BlockStructure
from cuadmm_jax.utils.logging import IterLogger


@dataclasses.dataclass
class SDPResult:
    """Solution + per-iteration history (the MEX info cell's contents;
    reference: MATLAB/cuadmm_MATLAB.cu:385-424)."""

    X: np.ndarray
    y: np.ndarray
    S: np.ndarray
    iterations: int
    converged: bool
    diverged: bool
    message: str
    pobj: float
    dobj: float
    errRp: float
    errRd: float
    relgap: float
    sig: float
    total_time: float
    info: Dict[str, np.ndarray]
    # Divergence auto-recovery restarts taken (0 = clean run).
    recoveries: int = 0


class SDPSolver:
    def __init__(
        self,
        problem: Problem,
        config: SolverConfig = SolverConfig(),
        eigh_by_bucket: Optional[Dict[int, Any]] = None,
        mesh=None,
    ):
        self.problem = problem
        self.config = config
        self.mesh = mesh
        self.dtype = jnp.dtype(config.dtype)
        if self.dtype == jnp.float64 and not jax.config.jax_enable_x64:
            raise RuntimeError(
                "float64 solve requires jax x64 (jax.config.update('jax_enable_x64', True)) "
                "or SolverConfig(dtype='float32')"
            )
        self._eigh_by_bucket = eigh_by_bucket
        self._init()

    # ------------------------------------------------------------------
    def _init(self) -> None:
        prob, cfg = self.problem, self.config
        t0 = time.perf_counter()
        # Per-stage timing of init (the reference's init is seconds; ours
        # must be too).
        self.init_breakdown: Dict[str, float] = {}
        _last = [t0]

        def mark(name: str) -> None:
            now = time.perf_counter()
            self.init_breakdown[name] = round(now - _last[0], 3)
            _last[0] = now

        backend = jax.default_backend()
        self._projection = cfg.projection
        pack_to = cfg.pack_to
        if cfg.eig_rank is not None:
            self._projection = "eigh"  # top-k needs explicit eigenvalues
            pack_to = 0  # per-block top-k is not preserved under packing
        self.structure = BlockStructure(
            prob.blk, cfg.bucket_rounding, cfg.exact_above, pack_to
        )
        if self._projection == "auto":
            # Calibrated per-bucket dispatch from the committed sweep of
            # this backend (the analog of is_large_mat, reference
            # src/matrix_sizes.cu:14-19, derived from
            # test/output/single_batched_comparison.txt).
            from cuadmm_jax.ops.dispatch import choose_methods

            per_bucket = choose_methods(
                [(bk.n, bk.count) for bk in self.structure.buckets],
                backend,
                "float32" if self.dtype == jnp.float32 else "float64",
            )
            if per_bucket is not None:
                self._projection = per_bucket
            else:
                self._projection = "eigh"
                if cfg.verbose:
                    print(
                        f"projection='auto': no calibration table for "
                        f"backend={backend!r} dtype={self.dtype.name!r} "
                        f"(run benchmarks/eig_sweep.py to generate one); "
                        f"using uncalibrated default {self._projection!r}"
                    )
        if self.structure.vec_len != prob.vec_len:
            raise ValueError("block structure does not match problem vec_len")
        vec_len, con_num = prob.vec_len, prob.con_num
        mark("structure")

        # Row-normalize A (reference: src/solver.cu:79-80).
        normA, at_vals = sparse_ops.normalize_rows(
            prob.At_rows, prob.At_cols, prob.At_vals, con_num
        )
        self._at_triplets = (prob.At_rows, prob.At_cols, at_vals)

        # Host copy of normalized A for initial residuals.
        self._A_host = sp.csr_matrix(
            (at_vals, (prob.At_cols, prob.At_rows)), shape=(con_num, vec_len)
        )

        # Scaling (reference: src/solver.cu:167-191).
        sc, b_s, C_s, X_s, y_s, S_s = scaling_mod.scale_problem(
            normA, prob.dense_b(), prob.dense_C(), prob.X0, prob.y0, prob.S0
        )
        self.scaling = sc
        self._b_scaled = b_s
        self._C_scaled = C_s
        self._initial_scaled = (X_s, y_s, S_s)
        mark("scaling")

        # Device-side problem constants. The hot loop keeps vec-space state
        # in POOL coordinates (ops/svec.py: flat dense-block storage with
        # mirrored off-diagonals at x/sqrt(2)), so the SpMV tables are built
        # directly in pool coordinates and the per-iteration svec<->matrix
        # conversions of the reference disappear.
        # Build the ELL tables once at the highest available precision, then
        # cast values for the state-dtype copy. The f64 copy feeds the
        # normal-equation residual refinement / CG (ops/chol.py).
        hp_dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        if self.dtype == jnp.dtype(hp_dtype):
            sa_hp = sparse_ops.build_sparse_a_pool(
                prob.At_rows, prob.At_cols, at_vals, con_num, self.structure, hp_dtype
            )
            sa = sa_hp
        else:
            # Both precision copies in one host build, sharing the uploaded
            # index buffers (no device-side casts or host pull-backs).
            sa_hp, sa = sparse_ops.build_sparse_a_pool(
                prob.At_rows, prob.At_cols, at_vals, con_num, self.structure,
                (hp_dtype, self.dtype),
            )
        self._sa_hp = sa_hp
        # True-residual probe: f64 evaluation of errRp for the current
        # scaled pool iterate (see the convergence loop for why). Only
        # meaningful when the state is f32 and an f64 A table exists.
        if self.dtype == jnp.float32 and jax.config.jax_enable_x64:

            _rp_fn = jax.jit(
                lambda sa64, b, na, X, bs, nb: jnp.linalg.norm(
                    na.astype(jnp.float64)
                    * (
                        b.astype(jnp.float64)
                        - sparse_ops.spmv_a(sa64, X.astype(jnp.float64))
                    )
                )
                * bs.astype(jnp.float64)
                / nb.astype(jnp.float64)
            )

            def _true_errRp(X_pool):
                p = self.params
                return float(
                    _rp_fn(
                        self._sa_hp, p.b, p.normA, X_pool, p.bscale, p.norm_borg
                    )
                )

            self._true_errRp = _true_errRp
        else:
            self._true_errRp = None
        mark("ell_tables")
        neq = chol_ops.build_normal_solver(
            prob.At_rows,
            prob.At_cols,
            at_vals,
            con_num,
            vec_len,
            sa,
            cfg.normal_solver,
            self.dtype,
            eps=cfg.aat_eps,
            dense_chol_max=cfg.dense_chol_max,
            cg_tol=cfg.cg_tol,
            cg_max_iter=cfg.cg_max_iter,
            precond_eps=cfg.precond_eps,
            applies=cfg.precond_applies,
            cg_block_jacobi=cfg.cg_block_jacobi,
            sparse_a_hp=sa_hp,
            cg_precond=cfg.cg_precond,
            fsai_cap=cfg.fsai_cap,
            fsai_pattern_power=cfg.fsai_pattern_power,
            mesh=self.mesh,
            # stop_tol-aware refinement target: the solve residual only
            # needs to sit well under the convergence tolerance; every
            # extra calibrated sweep is a full factor read per iteration.
            # f64 refinement keeps the tight default (reference parity).
            calibrate_target=(
                None
                if self.dtype == jnp.float64
                else float(np.clip(cfg.stop_tol * 0.03, 1e-6, 1e-5))
            ),
        )
        mark("normal_solver")
        self.init_breakdown.update(
            {f"neq.{k}": v for k, v in chol_ops.LAST_BUILD_TIMINGS.items()}
        )
        maps = device_maps(self.structure, self.dtype)
        self._maps = maps
        # NB: maps must be *arguments*, not closure constants -- XLA embeds
        # closed-over arrays as program constants, which poisons compile
        # time (constant folding over pool-length tables).
        self._to_pool_fn = jax.jit(pool_from_svec)
        self._from_pool_fn = jax.jit(svec_from_pool)
        self._to_pool = lambda v: self._to_pool_fn(v, self._maps)
        self._from_pool = lambda p: self._from_pool_fn(p, self._maps)
        # Host-side numpy casts before upload: jnp.asarray with a differing
        # dtype dispatches one trivial convert compile per distinct shape.
        npc = lambda x: jnp.asarray(np.asarray(x, dtype=self.dtype))
        self.params = SolveParams(
            sparse_a=sa,
            maps=maps,
            neq=neq,
            b=npc(b_s),
            C=self._to_pool(npc(C_s)),
            normA=npc(normA),
            bscale=npc(sc.bscale),
            Cscale=npc(sc.Cscale),
            objscale=npc(sc.objscale),
            norm_borg=npc(sc.norm_borg),
            norm_Corg=npc(sc.norm_Corg),
        )
        self._chunk_runners: Dict[int, Any] = {}
        # Steps memoized per (projection, rp_hp, stop_tol) across solve()
        # calls: _runner caches compiled chunk programs on the step
        # OBJECT, so a warm restart or a restored calibrated projection
        # after a recovery probation must return the SAME step object or
        # every chunk size recompiles (ADVICE r4).
        self._step_memo: Dict[Any, Any] = {}
        mark("params")
        self.init_time = time.perf_counter() - t0
        if cfg.verbose:
            print(f"init {self.init_time:.1f}s: {self.init_breakdown}")

    # ------------------------------------------------------------------
    def _initial_state(
        self, X_s, y_s, S_s, sig: float, scaling=None, b_scaled=None, C_scaled=None
    ) -> SolverState:
        """Initial residuals in scaled space (reference: src/solver.cu:194-228
        and the re-entrant path :385-409). The optional overrides let the
        batched solver evaluate per-instance (scaling, b, C) without
        mutating this solver's own caches."""
        sc = self.scaling if scaling is None else scaling
        b = self._b_scaled if b_scaled is None else b_scaled
        C = self._C_scaled if C_scaled is None else C_scaled
        A = self._A_host
        Rp = b - A @ X_s
        SmC = S_s - C
        Rd = A.T @ y_s + SmC
        errRp = float(np.linalg.norm(sc.normA * Rp) * sc.bscale / sc.norm_borg)
        errRd = float(np.linalg.norm(Rd) * sc.Cscale / sc.norm_Corg)
        pobj = float(C @ X_s * sc.objscale)
        dobj = float(b @ y_s * sc.objscale)
        relgap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
        dt = self.dtype
        dev = lambda x: jnp.asarray(np.asarray(x, dtype=dt))  # host-side cast (see _init)
        pool = lambda x: self._to_pool(dev(x))
        # NB: each zeros buffer must be a distinct array -- the chunk runner
        # donates the whole state, and XLA rejects donating one buffer twice.
        pool_zeros = lambda: jnp.zeros((self.structure.pool_len,), dtype=dt)
        zeros_like = lambda x: jnp.zeros(np.shape(x), dtype=dt)
        return SolverState(
            X=pool(X_s),
            y=dev(y_s),
            S=pool(S_s),
            SmC=pool(SmC),
            Rp=dev(Rp),
            sig=dev(sig),
            errRp=dev(errRp),
            errRd=dev(errRd),
            pobj=dev(pobj),
            dobj=dev(dobj),
            relgap=dev(relgap),
            maxfeas=dev(max(errRp, errRd)),
            prim_win=jnp.asarray(0, jnp.int32),
            dual_win=jnp.asarray(0, jnp.int32),
            it=jnp.asarray(0, jnp.int32),
            sig_stage_2=jnp.asarray(self.config.sig_update_stage_2, jnp.int32),
            sigscale=dev(self.config.sigscale),
            best_kkt=dev(np.inf),
            X_best=pool_zeros(),
            y_best=zeros_like(y_s),
            S_best=pool_zeros(),
        )

    def _runner(self, step, chunk: int, stop_tol: float):
        # Key on stop_tol and the step closure itself: the step bakes
        # stop_tol into the done-guard, and divergence recovery swaps in an
        # escalated step mid-solve -- each needs a distinct compilation.
        key = (chunk, stop_tol, step)
        if key not in self._chunk_runners:
            self._chunk_runners[key] = make_chunk_runner(step, chunk)
        return self._chunk_runners[key]

    def _recovery_restart(self, state: SolverState, level: int):
        """Escalated numerics + restart iterate after a non-finite chunk.

        Level 1 forces the eigh projection (exact, platform-independent) and
        adds refinement sweeps to the normal solver; level 2 swaps in a
        factor-free CG normal solver, which bypasses a possibly-corrupted
        Cholesky factor entirely. The iterate restarts from the best finite
        iterate seen so far (falling back to the initial point). The
        reference has no counterpart: its CHOLMOD f64 host solves are exact
        every iteration (reference: include/cuadmm/cholesky_cpu.h:62-155).
        """
        cfg, prob = self.config, self.problem
        neq = self.params.neq
        if level == 1:
            if neq.mode in ("precond", "dense", "packed", "split"):
                neq = dataclasses.replace(neq, applies=neq.applies + 2)
        else:
            rows, cols, vals = self._at_triplets
            neq = chol_ops.build_normal_solver(
                rows,
                cols,
                vals,
                prob.con_num,
                prob.vec_len,
                self.params.sparse_a,
                "cg",
                self.dtype,
                eps=cfg.aat_eps,
                cg_tol=cfg.cg_tol,
                cg_max_iter=max(cfg.cg_max_iter, 800),
                cg_block_jacobi=cfg.cg_block_jacobi,
                sparse_a_hp=self._sa_hp,
                cg_precond=cfg.cg_precond,
                fsai_cap=cfg.fsai_cap,
                fsai_pattern_power=cfg.fsai_pattern_power,
            )
        self.params = dataclasses.replace(self.params, neq=neq)

        X_s = y_s = S_s = None
        if np.isfinite(float(state.best_kkt)):
            X_s = np.asarray(self._from_pool(state.X_best), np.float64)
            y_s = np.asarray(state.y_best, np.float64)
            S_s = np.asarray(self._from_pool(state.S_best), np.float64)
            if not (
                np.all(np.isfinite(X_s))
                and np.all(np.isfinite(y_s))
                and np.all(np.isfinite(S_s))
            ):
                X_s = None  # best-iterate buffers were poisoned mid-update
        if X_s is None:
            X_s, y_s, S_s = self._initial_scaled
        sig = float(state.sig)
        if not np.isfinite(sig) or sig <= 0:
            sig = cfg.sig if prob.sig0 is None else float(prob.sig0)
        return self._initial_state(X_s, y_s, S_s, sig)

    # ------------------------------------------------------------------
    def solve(
        self,
        max_iter: Optional[int] = None,
        stop_tol: Optional[float] = None,
        X0: Optional[np.ndarray] = None,
        y0: Optional[np.ndarray] = None,
        S0: Optional[np.ndarray] = None,
        sig: Optional[float] = None,
    ) -> SDPResult:
        """Run the solver. Optional X0/y0/S0/sig are *unscaled* iterates,
        covering both warm starts and re-entrant calls (the reference's
        ``if_first=false`` path, src/solver.cu:385-409)."""
        cfg = self.config
        max_iter = cfg.max_iter if max_iter is None else int(max_iter)
        stop_tol = cfg.stop_tol if stop_tol is None else float(stop_tol)
        if sig is None:
            # Problem-provided warm-start sigma (reference: sig.txt,
            # src/problem.cu:82) wins over the config default.
            sig = cfg.sig if self.problem.sig0 is None else float(self.problem.sig0)
        else:
            sig = float(sig)

        if X0 is not None or y0 is not None or S0 is not None:
            sc = self.scaling
            Xd, yd, Sd = self._initial_scaled
            X_s = Xd if X0 is None else np.asarray(X0, np.float64) / sc.bscale
            y_s = yd if y0 is None else np.asarray(y0, np.float64) * sc.normA / sc.Cscale
            S_s = Sd if S0 is None else np.asarray(S0, np.float64) / sc.Cscale
        else:
            X_s, y_s, S_s = self._initial_scaled

        state = self._initial_state(X_s, y_s, S_s, sig)

        # Keyed by repr: projection may be a per-bucket dict.
        step_memo = self._step_memo

        def mk_step(projection, rp_hp=False):
            k = (repr(projection), rp_hp, stop_tol)
            if k not in step_memo:
                hp_tables = None
                if rp_hp:
                    # f64 A-product tables for Rp/errRp (see
                    # make_step.rp_hp). b/normA recast host-side via the
                    # stored scaled copies.
                    hp_tables = (
                        self._sa_hp,
                        jnp.asarray(self._b_scaled, jnp.float64),
                        jnp.asarray(self.scaling.normA, jnp.float64),
                    )
                step_memo[k] = make_step(
                    stop_tol=stop_tol,
                    switch_admm=cfg.switch_admm,
                    sig_update_threshold=cfg.sig_update_threshold,
                    sig_update_stage_1=cfg.sig_update_stage_1,
                    sig_min=cfg.sig_min,
                    sig_max=cfg.sig_max,
                    eigh_by_bucket=self._eigh_by_bucket,
                    mesh=self.mesh,
                    eig_rank=cfg.eig_rank,
                    projection=projection,
                    rp_hp=hp_tables,
                )
            return step_memo[k]

        step = mk_step(self._projection)

        log = IterLogger(enabled=cfg.verbose)
        log.header(self.scaling.norm_Corg, self.scaling.norm_borg)
        log.row(0, state)

        info_rows = []
        t0 = time.perf_counter()
        it_done = 0
        chunk_idx = 0
        profiled = False
        diverged = False
        stalled = False
        rp_hp_on = False  # f64 primal-residual step engaged after a stall
        kkt_trail = []  # best in-chunk KKT per check (stall detector)
        recoveries = 0
        converged = float(np.maximum(state.maxfeas, state.relgap)) < stop_tol

        # After a divergence recovery the step runs the exact eigh
        # projection for a probation window, then the calibrated projection
        # is restored (VERDICT r3: swapping it in forever silently changes
        # the perf profile for the rest of a 100k-iteration solve).
        eigh_until = -1
        while it_done < max_iter and not converged:
            if eigh_until >= 0 and it_done >= eigh_until:
                step = mk_step(self._projection)
                eigh_until = -1
            chunk = min(cfg.check_every, max_iter - it_done)
            runner = self._runner(step, chunk, stop_tol)
            # Profile one steady-state chunk (the second: the first chunk
            # pays compilation) -- the counterpart of the reference's
            # cudaEvent timing (src/solver.cu:41-44, 435-438).
            profiling = cfg.profile_dir is not None and chunk_idx == 1
            if profiling:
                jax.profiler.start_trace(cfg.profile_dir)
            try:
                # Trace-time matmul precision: f32 matmuls may default to
                # TF32 on the GPU, which would wreck the solve; force full
                # f32 (no-op for f64 / CPU).
                with jax.default_matmul_precision("highest"):
                    state, info = runner(state, self.params)
                if profiling:
                    jax.block_until_ready(info)
            finally:
                if profiling:
                    jax.profiler.stop_trace()
                    profiled = True
            chunk_idx += 1
            info_np = np.asarray(info, dtype=np.float64)  # (chunk, 8)
            kkt = np.maximum(np.maximum(info_np[:, 2], info_np[:, 3]), info_np[:, 4])
            # Divergence guard: the reference surfaces residuals on the host
            # every iteration (src/solver.cu:429-444) and a human would stop
            # it; a compiled chunk loop must detect non-finite state itself
            # rather than scan through NaNs forever.
            bad = np.nonzero(~np.isfinite(kkt))[0]
            if bad.size:
                keep = int(bad[0]) + 1
                info_rows.append(info_np[:keep])
                it_done += keep
                if cfg.divergence_recovery and recoveries < 2:
                    recoveries += 1
                    if cfg.verbose:
                        print(
                            f"  [recovery {recoveries}] non-finite residuals at "
                            f"iteration {it_done}; restarting from best iterate "
                            "with escalated numerics"
                            + (
                                " (eigh projection, +2 refinement sweeps)"
                                if recoveries == 1
                                else " (factor-free CG normal solver)"
                            )
                        )
                    state = self._recovery_restart(state, recoveries)
                    step = mk_step("eigh")
                    # Probation: exact projection for 5 checks, then restore
                    # the calibrated projection (see eigh_until above).
                    eigh_until = it_done + 5 * cfg.check_every
                    continue
                diverged = True
                break
            hits = np.nonzero(kkt < stop_tol)[0]
            if hits.size:
                converged = True
                keep = int(hits[0]) + 1
                info_np = info_np[:keep]
                it_done += keep
            else:
                it_done += chunk
                # f32-state errRp is a MEASUREMENT floor, not a property
                # of the iterate: b - A X evaluated in f32 carries
                # ~1e-7*||A||*||X|| of noise that grows with sigma
                # (pendulum N=80: reported errRp rises past 1e-3 while
                # the true residual keeps falling; the reference's f64
                # state reports 1e-12). When everything else has
                # converged and the f32 errRp is the only blocker, check
                # the TRUE residual once (an f64 spmv of the current
                # iterate) before burning thousands more iterations.
                last = info_np[-1]
                if (
                    stop_tol > 0.0
                    and max(last[3], last[4]) < stop_tol <= last[2] < 10 * stop_tol
                    and self._true_errRp is not None
                ):
                    rp_true = self._true_errRp(state.X)
                    if rp_true < stop_tol:
                        converged = True
                        info_np[-1, 2] = rp_true
                # Precision-floor stall detector (f32 state only): when
                # feasibility is already below tolerance but the best KKT
                # has improved < 2% over the last 10 checked chunks, the
                # iterate is grinding against the f32 gap floor (pendulum
                # N=80: relgap pinned at 4.7e-3 from iteration ~7k; the
                # f32-floored errRp also mis-biases the sigma vote, so
                # more f32 iterations cannot help). Exit early so
                # solve_escalated can run the f64 tail instead of burning
                # the remaining max_iter budget.
                if (
                    not converged
                    and stop_tol > 0.0
                    and self.dtype == jnp.float32
                ):
                    kkt_trail.append(float(np.min(kkt)))
                    if len(kkt_trail) > 10:
                        del kkt_trail[:-10]
                        old, new = kkt_trail[0], min(kkt_trail)
                        last = info_np[-1]
                        if (
                            max(last[2], last[3]) < stop_tol
                            and new > 0.98 * old
                        ):
                            if not rp_hp_on and jax.config.jax_enable_x64:
                                # First stall: the f32-floored errRp has
                                # been mis-biasing the sigma vote (the
                                # reference's feasratio here is ~1e-9 and
                                # grows sigma; ours reads ~1). Switch the
                                # step to f64 Rp/errRp (one emulated spmv
                                # per iteration) and keep iterating in
                                # f32 -- measured on pendulum N=80 this
                                # restores the reference's sigma schedule
                                # and closes the gap the stall was
                                # grinding against.
                                rp_hp_on = True
                                step = mk_step(self._projection, rp_hp=True)
                                kkt_trail.clear()
                                if cfg.verbose:
                                    print(
                                        "  [precision] errRp floor stall: "
                                        "switching to f64 primal residuals"
                                    )
                            else:
                                stalled = True
                                info_rows.append(info_np)
                                log.maybe_row(
                                    it_done, info_np[-1],
                                    time.perf_counter() - t0,
                                )
                                break
            info_rows.append(info_np)
            log.maybe_row(it_done, info_np[-1], time.perf_counter() - t0)
        total_time = time.perf_counter() - t0

        if cfg.profile_dir is not None and not profiled:
            import warnings

            warnings.warn(
                "profile_dir was set but the solve finished within the first "
                "chunk; no steady-state chunk was available to trace."
            )
        if diverged:
            message = (
                "Solver ABORTED: non-finite residuals at iteration "
                f"{it_done} (errRp/errRd/relgap contain NaN or Inf)"
                + (
                    f" after {recoveries} auto-recovery restart(s)"
                    if recoveries
                    else ""
                )
                + ". The iteration diverged -- try a smaller sig, a more "
                "accurate normal_solver, or dtype='float64'."
            )
        elif converged:
            message = "Solver ended: converged."
        elif stalled:
            message = (
                "Solver ended: stalled at the float32 precision floor "
                "(feasibility below tolerance, KKT not improving); use "
                "solve_escalated or dtype='float64' to close the gap"
            )
        else:
            message = "Solver ended: maximum iteration reached"

        # Restore best iterate after the ADMM switch
        # (reference: src/solver.cu:567-576).
        if it_done > cfg.switch_admm and np.isfinite(float(state.best_kkt)):
            X_fin, y_fin, S_fin = state.X_best, state.y_best, state.S_best
        else:
            X_fin, y_fin, S_fin = state.X, state.y, state.S

        X, y, S = scaling_mod.unscale_solution(
            self.scaling,
            np.asarray(self._from_pool(X_fin)),
            np.asarray(y_fin),
            np.asarray(self._from_pool(S_fin)),
        )
        info_mat = (
            np.concatenate(info_rows, axis=0)
            if info_rows
            else np.empty((0, len(INFO_FIELDS)))
        )
        info = {name: info_mat[:, i] for i, name in enumerate(INFO_FIELDS)}
        info["iter_num"] = np.asarray(it_done)
        info["total_time"] = np.asarray(total_time)

        result = SDPResult(
            X=X,
            y=y,
            S=S,
            iterations=it_done,
            converged=converged,
            diverged=diverged,
            message=message,
            pobj=float(state.pobj),
            dobj=float(state.dobj),
            # Last recorded row wins over chunk-end state: the true-errRp
            # boundary check patches it, and on early exit it is the hit
            # iteration's value.
            errRp=(
                float(info_mat[-1, 2]) if info_mat.size else float(state.errRp)
            ),
            errRd=float(state.errRd),
            relgap=float(state.relgap),
            sig=float(state.sig),
            total_time=total_time,
            info=info,
            recoveries=recoveries,
        )
        log.footer(result)
        return result


def solve(problem: Problem, config: SolverConfig = SolverConfig(), **kw) -> SDPResult:
    """One-shot convenience wrapper."""
    return SDPSolver(problem, config).solve(**kw)


def solve_escalated(
    problem: Problem,
    config: SolverConfig = SolverConfig(),
    max_iter: Optional[int] = None,
    stop_tol: Optional[float] = None,
    mesh=None,
) -> SDPResult:
    """Mixed-precision ladder: f32 solve, then an f64 warm-continued tail
    when the f32 state floor blocks convergence.

    Some instances (rose13: relgap tracks feasibility, which f32 state
    floors at errRp ~ 3e-5) satisfy maxfeas < tol quickly but cannot
    close the duality gap in f32: the gap is <S, X> of separately-rounded
    f32 iterates. The reference runs end-to-end f64 (src/solver.cu);
    where f64 costs more per iteration than f32, the cheap phase should
    do every iteration it can first. Escalation
    re-inits in f64 (one extra init) and warm-starts from the f32 best
    iterate -- measured on rose13 the f64 tail converges where 100k f32
    iterations stall at relgap 1.6%.

    Returns the final (f64) result when escalation fires, with
    ``iterations`` accumulated across both phases.
    """
    cfg32 = (
        config
        if jnp.dtype(config.dtype) == jnp.float32
        else dataclasses.replace(config, dtype="float32")
    )
    max_iter = cfg32.max_iter if max_iter is None else int(max_iter)
    stop_tol = cfg32.stop_tol if stop_tol is None else float(stop_tol)
    s32 = SDPSolver(problem, cfg32, mesh=mesh)
    res = s32.solve(max_iter=max_iter, stop_tol=stop_tol)
    # Escalate when f32 plausibly hit its precision limits rather than a
    # genuine algorithmic stall: feasibility met with only the gap open
    # (rose13), a tolerance below what f32 state can certify at all
    # (~1e-5), or divergence that survived the in-dtype auto-recoveries.
    floor_hit = (
        np.isfinite(res.relgap)
        and (max(res.errRp, res.errRd) < stop_tol or stop_tol <= 1e-5)
    )
    if res.converged or not (floor_hit or res.diverged):
        return res
    if not jax.config.jax_enable_x64:
        warnings.warn(
            "solve_escalated: f32 hit its precision limit but x64 is "
            "disabled; returning the f32 result."
        )
        return res
    cfg64 = dataclasses.replace(config, dtype="float64")
    s64 = SDPSolver(problem, cfg64, mesh=mesh)
    warm = {} if res.diverged else dict(
        X0=res.X, y0=res.y, S0=res.S, sig=res.sig
    )
    res64 = s64.solve(
        max_iter=max(max_iter - res.iterations, 1),
        stop_tol=stop_tol,
        **warm,
    )
    res64 = dataclasses.replace(
        res64,
        iterations=res.iterations + res64.iterations,
        total_time=res.total_time + res64.total_time,
    )
    return res64
