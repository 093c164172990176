"""Batched multi-instance solver: many SDPs, one SPMD program.

Solves a batch of SDP instances that share one block structure and one
constraint matrix A (the common parametric-family case: moment/SOS
relaxations where problem data enters only through b and C). The whole
batch advances in lockstep as a single vmapped sGS-ADMM step; the instance
axis is sharded over the device mesh, so 4 devices run 64 instances as 16
per device with zero cross-device traffic in the iteration (all
collectives are per-instance reductions, which stay local).

There is no reference equivalent -- cuADMM solves one problem per process
-- but this is the natural SPMD expression of its multi-GPU data
parallelism (reference: src/duo_solver.cu:269-295) applied one level up.

Instances that converge early are frozen by the per-instance done-guard
(zero wasted FLOPs beyond the lockstep shape).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cuadmm_jax.config import SolverConfig
from cuadmm_jax.parallel.mesh import BLOCK_AXIS
from cuadmm_jax.problem import Problem
from cuadmm_jax.solver import scaling as scaling_mod
from cuadmm_jax.solver.driver import SDPResult, SDPSolver
from cuadmm_jax.solver.state import INFO_FIELDS, SolveParams, SolverState
from cuadmm_jax.solver.step import make_step


def _same_pattern(p0: Problem, p: Problem) -> bool:
    return (
        p0.blk == p.blk
        and p0.con_num == p.con_num
        and len(p0.At_vals) == len(p.At_vals)
        and np.array_equal(p0.At_rows, p.At_rows)
        and np.array_equal(p0.At_cols, p.At_cols)
        and np.allclose(p0.At_vals, p.At_vals)
    )


class BatchedSDPSolver:
    """Lockstep batch solver over instances sharing (blk, A)."""

    def __init__(
        self,
        problems: List[Problem],
        config: SolverConfig = SolverConfig(),
        mesh=None,
    ):
        if not problems:
            raise ValueError("empty problem batch")
        base = problems[0]
        for p in problems[1:]:
            if not _same_pattern(base, p):
                raise ValueError(
                    "batched solve requires identical blk and At across instances"
                )
        self.problems = problems
        self.config = config
        self.mesh = mesh
        # Reuse the single-problem init for structure / A / factorization.
        self._base = SDPSolver(base, config)
        self.dtype = self._base.dtype

        # Per-instance scaling (normA is shared: it depends only on A).
        normA = self._base.scaling.normA
        self._scalings = []
        b_list, C_list, init_list = [], [], []
        for p in problems:
            sc, b_s, C_s, X_s, y_s, S_s = scaling_mod.scale_problem(
                normA, p.dense_b(), p.dense_C(), p.X0, p.y0, p.S0
            )
            self._scalings.append(sc)
            b_list.append(b_s)
            C_list.append(C_s)
            init_list.append((X_s, y_s, S_s))
        self._b_stack = np.stack(b_list)
        self._C_stack = np.stack(C_list)
        self._init_list = init_list

        bp = self._base.params
        dev = lambda x: jnp.asarray(x, dtype=self.dtype)
        self.params = SolveParams(
            sparse_a=bp.sparse_a,
            maps=bp.maps,
            neq=bp.neq,
            b=dev(self._b_stack),
            C=jax.vmap(self._base._to_pool)(dev(self._C_stack)),
            normA=bp.normA,
            bscale=dev([sc.bscale for sc in self._scalings]),
            Cscale=dev([sc.Cscale for sc in self._scalings]),
            objscale=dev([sc.objscale for sc in self._scalings]),
            norm_borg=dev([sc.norm_borg for sc in self._scalings]),
            norm_Corg=dev([sc.norm_Corg for sc in self._scalings]),
        )
        self._in_axes_params = SolveParams(
            sparse_a=None,
            maps=None,
            neq=None,
            b=0,
            C=0,
            normA=None,
            bscale=0,
            Cscale=0,
            objscale=0,
            norm_borg=0,
            norm_Corg=0,
        )
        self._runners: Dict[Any, Any] = {}

    # ------------------------------------------------------------------
    def _initial_states(self, sig: float) -> SolverState:
        states = [
            self._base._initial_state(
                X_s,
                y_s,
                S_s,
                sig,
                scaling=sc,
                b_scaled=self._b_stack[i],
                C_scaled=self._C_stack[i],
            )
            for i, ((X_s, y_s, S_s), sc) in enumerate(
                zip(self._init_list, self._scalings)
            )
        ]
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
        if self.mesh is not None and self.mesh.size > 1:
            sharding = NamedSharding(self.mesh, P(BLOCK_AXIS))
            stacked = jax.tree.map(
                lambda x: jax.device_put(x, sharding), stacked
            )
        return stacked

    def _runner(self, stop_tol: float, chunk: int):
        key = (stop_tol, chunk)
        if key in self._runners:
            return self._runners[key]
        cfg = self.config
        step = make_step(
            stop_tol=stop_tol,
            switch_admm=cfg.switch_admm,
            sig_update_threshold=cfg.sig_update_threshold,
            sig_update_stage_1=cfg.sig_update_stage_1,
            sig_min=cfg.sig_min,
            sig_max=cfg.sig_max,
        )
        batched_step = jax.vmap(step, in_axes=(0, self._in_axes_params))

        mesh = self.mesh
        if mesh is not None and mesh.size > 1:
            # Pin the instance axis to the mesh *inside* the compiled chunk
            # (not just on the inputs): relying on input-sharding
            # propagation alone leaves XLA free to resharde intermediates.
            def constrain(s):
                def pin(x):
                    if getattr(x, "ndim", 0) < 1:
                        return x
                    spec = P(*((BLOCK_AXIS,) + (None,) * (x.ndim - 1)))
                    return jax.lax.with_sharding_constraint(
                        x, NamedSharding(mesh, spec)
                    )

                return jax.tree.map(pin, s)

        else:
            constrain = lambda s: s

        @jax.jit
        def run_chunk(state, params):
            def body(s, _):
                s2, info = batched_step(s, params)
                return constrain(s2), info

            return jax.lax.scan(body, constrain(state), None, length=chunk)

        self._runners[key] = run_chunk
        return run_chunk

    # ------------------------------------------------------------------
    def solve(
        self,
        max_iter: Optional[int] = None,
        stop_tol: Optional[float] = None,
        sig: Optional[float] = None,
    ) -> List[SDPResult]:
        cfg = self.config
        max_iter = cfg.max_iter if max_iter is None else int(max_iter)
        stop_tol = cfg.stop_tol if stop_tol is None else float(stop_tol)
        sig = cfg.sig if sig is None else float(sig)
        B = len(self.problems)

        state = self._initial_states(sig)
        info_rows = []
        t0 = time.perf_counter()
        it_done = 0
        conv_iter = np.full(B, -1, dtype=np.int64)
        while it_done < max_iter:
            chunk = min(cfg.check_every, max_iter - it_done)
            runner = self._runner(stop_tol, chunk)
            with jax.default_matmul_precision("highest"):
                state, info = runner(state, self.params)
            info_np = np.asarray(info, dtype=np.float64)  # (chunk, B, 8)
            kkt = np.maximum(
                np.maximum(info_np[:, :, 2], info_np[:, :, 3]), info_np[:, :, 4]
            )
            for b in range(B):
                if conv_iter[b] < 0:
                    hits = np.nonzero(kkt[:, b] < stop_tol)[0]
                    if hits.size:
                        conv_iter[b] = it_done + int(hits[0]) + 1
            info_rows.append(info_np)
            it_done += chunk
            if np.all(conv_iter >= 0):
                break
        total_time = time.perf_counter() - t0

        info_mat = np.concatenate(info_rows, axis=0) if info_rows else np.empty((0, B, 8))
        results = []
        X_all = np.asarray(jax.vmap(self._base._from_pool)(state.X))
        y_all = np.asarray(state.y)
        S_all = np.asarray(jax.vmap(self._base._from_pool)(state.S))
        for b in range(B):
            converged = conv_iter[b] >= 0
            iters = int(conv_iter[b]) if converged else it_done
            X, y, S = scaling_mod.unscale_solution(
                self._scalings[b], X_all[b], y_all[b], S_all[b]
            )
            info_b = info_mat[:iters, b, :]
            info = {name: info_b[:, i] for i, name in enumerate(INFO_FIELDS)}
            info["iter_num"] = np.asarray(iters)
            info["total_time"] = np.asarray(total_time)
            results.append(
                SDPResult(
                    X=X,
                    y=y,
                    S=S,
                    iterations=iters,
                    converged=bool(converged),
                    diverged=not bool(
                        np.isfinite(np.asarray(state.errRp)[b])
                        and np.isfinite(np.asarray(state.errRd)[b])
                    ),
                    message=(
                        "Solver ended: converged."
                        if converged
                        else "Solver ended: maximum iteration reached"
                    ),
                    pobj=float(np.asarray(state.pobj)[b]),
                    dobj=float(np.asarray(state.dobj)[b]),
                    errRp=float(np.asarray(state.errRp)[b]),
                    errRd=float(np.asarray(state.errRd)[b]),
                    relgap=float(np.asarray(state.relgap)[b]),
                    sig=float(np.asarray(state.sig)[b]),
                    total_time=total_time,
                    info=info,
                )
            )
        return results
