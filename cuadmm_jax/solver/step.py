"""One sGS-ADMM iteration as a pure jittable function.

Algorithm and constants follow the reference's solve loop exactly
(reference: src/solver.cu:415-811; step numbering from the comments
there):

  1. rhs = Rp/sig - A(S - C);  y_half = (AA^T)^{-1} rhs
  2. Rd1 = A^T y_half - C;  Xb = X + sig*Rd1;  S = (Pi(Xb) - Xb)/sig
  3. second normal-equation solve while in sGS mode (iter < switch_admm);
     best-iterate tracking after the switch
  4. X += tau*sig*(Rd1 + S), tau = 1.95 (sGS) / 1.618 (ADMM)
  5. residuals, objectives, prim/dual vote, sigma re-balancing

The whole body is wrapped in a "done" guard so post-convergence
iterations inside a compiled chunk are no-ops (the reference instead
checks on the host every iteration, src/solver.cu:419-427 -- which
stalls the device between iterations).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from cuadmm_jax.ops.chol import NormalEqSolver
from cuadmm_jax.ops.projection import psd_project_pool
from cuadmm_jax.ops.sparse import spmv_a, spmv_at
from cuadmm_jax.parallel.mesh import shard_pool
from cuadmm_jax.solver.state import SolveParams, SolverState

def _seg_dot(u: jax.Array, v: jax.Array) -> jax.Array:
    """Dot product with a length-independent accumulation floor.

    f32 products, f32 partial sums over SEG-element segments, and an
    f64 (emulated, when x64 is on) reduction over the ~n/SEG partials.
    See the call site in ``step`` for the accuracy/cost rationale.
    """
    n = u.shape[0]
    seg = 2048
    k = -(-n // seg)
    pad = k * seg - n
    if pad:
        u = jnp.concatenate([u, jnp.zeros((pad,), u.dtype)])
        v = jnp.concatenate([v, jnp.zeros((pad,), v.dtype)])
    parts = jnp.sum(u.reshape(k, seg) * v.reshape(k, seg), axis=1)
    hp = jnp.float64 if jax.config.jax_enable_x64 else u.dtype
    return jnp.sum(parts.astype(hp))


TAU_SGS = 1.95  # reference: src/solver.cu:748
TAU_ADMM = 1.618  # reference: src/solver.cu:750
SWITCH_SIGSCALE_BOOST = 1.23  # reference: src/solver.cu:684


def make_step(
    stop_tol: float,
    switch_admm: int,
    sig_update_threshold: int,
    sig_update_stage_1: int,
    sig_min: float,
    sig_max: float,
    eigh_by_bucket: Optional[Dict[int, Any]] = None,
    mesh=None,
    eig_rank: Optional[int] = None,
    projection: str = "eigh",
    rp_hp: Optional[Any] = None,
):
    """Build the iteration body with static algorithm constants baked in.

    ``rp_hp``: optional (sparse_a_f64, b_f64, normA_f64) triple. When
    given, the primal residual Rp and errRp are evaluated through the f64
    A-product instead of the state dtype. f32 states floor the MEASURED
    errRp at ~1e-7*||A||*||X|| (pendulum N=80: reported 5e-4 while the
    true residual is far lower), and since the sigma vote compares
    errRp/errRd, the floor biases sigma DOWNWARD exactly when the
    reference's vote (feasratio ~ 1e-9) would grow sigma and close the
    dual gap. One emulated-f64 spmv per iteration (~25% on pendulum) --
    engaged by the driver only after a precision-floor stall, so small
    problems and the benchmark never pay it. The triple is deliberately a
    closure constant: a few MB of ELL tables embed fine in the HLO
    (unlike the ~GB factors, which must stay arguments)."""

    def step(state: SolverState, params: SolveParams) -> Tuple[SolverState, jax.Array]:
        sa = params.sparse_a

        def body(state: SolverState) -> SolverState:
            it = state.it + 1  # 1-based iteration number
            sig = state.sig

            # -- Step 1: first normal-equation solve ---------------------
            rhsy = state.Rp / sig - spmv_a(sa, state.SmC)
            y_half = params.neq.solve(rhsy, warm=state.y)

            # -- Step 2: PSD projection ----------------------------------
            Aty = spmv_at(sa, y_half)
            Rd1 = Aty - params.C
            Xb = state.X + sig * Rd1
            Xproj = psd_project_pool(
                Xb,
                params.maps,
                eigh_by_bucket,
                mesh=mesh,
                eig_rank=eig_rank,
                method=projection,
            )
            S = shard_pool((Xproj - state.X) / sig - Rd1, mesh)
            SmC = shard_pool(S - params.C, mesh)

            # -- Step 3: sGS second solve / best tracking ----------------
            in_sgs = it < switch_admm

            def sgs_branch(_):
                rhsy2 = state.Rp / sig - spmv_a(sa, SmC)
                y_new = params.neq.solve(rhsy2, warm=y_half)
                Rd1_new = spmv_at(sa, y_new) - params.C
                return y_new, Rd1_new

            def admm_branch(_):
                return y_half, Rd1

            y_new, Rd1_new = jax.lax.cond(in_sgs, sgs_branch, admm_branch, None)

            # Switch bookkeeping (reference: src/solver.cu:681-741). The
            # KKT metric compared here is the one from the *previous*
            # iteration, as in the reference.
            kkt_entry = jnp.maximum(state.maxfeas, state.relgap)
            at_switch = it == switch_admm
            sig_stage_2 = jnp.where(at_switch, state.sig_stage_2 // 2, state.sig_stage_2)
            sigscale = jnp.where(at_switch, state.sigscale * SWITCH_SIGSCALE_BOOST, state.sigscale)
            take_best = at_switch | ((it > switch_admm) & (state.best_kkt > kkt_entry))
            best_kkt = jnp.where(take_best, kkt_entry, state.best_kkt)
            X_best = jnp.where(take_best, state.X, state.X_best)
            y_best = jnp.where(take_best, y_new, state.y_best)
            S_best = jnp.where(take_best, S, state.S_best)

            # -- Step 4: primal update -----------------------------------
            Rd = Rd1_new + S
            tau = jnp.where(in_sgs, TAU_SGS, TAU_ADMM)
            tau = jnp.where(
                state.errRd < stop_tol, jnp.maximum(TAU_ADMM, tau / 1.1), tau
            )
            X = shard_pool(state.X + (tau * sig) * Rd, mesh)

            # -- Step 5: residuals, objectives, sigma --------------------
            if rp_hp is not None:
                sa64, b64, normA64 = rp_hp
                Rp64 = b64 - spmv_a(sa64, X.astype(b64.dtype))
                Rp = Rp64.astype(X.dtype)
                errRp = (
                    jnp.linalg.norm(normA64 * Rp64).astype(X.dtype)
                    * params.bscale
                    / params.norm_borg
                )
            else:
                Rp = params.b - spmv_a(sa, X)
                errRp = (
                    jnp.linalg.norm(params.normA * Rp)
                    * params.bscale
                    / params.norm_borg
                )
            errRd = jnp.linalg.norm(Rd) * params.Cscale / params.norm_Corg
            # Objective dots: an f32 dot over a ~1M-slot pool with
            # cancellation carries ~1e-2 relative error (rose13: relgap
            # stuck at 1.6% with KKT residuals at 2e-5 -- the gap was
            # pobj's own rounding, not the iterate's). Full f64 dots fix
            # that, but on hardware without fast f64 they slow every
            # iteration of the scan. Segmented dots --
            # f32 products + per-segment f32 partial sums, segment
            # partials reduced in f64 -- remove the length-dependent
            # accumulation floor (error ~ sqrt(SEG)*eps_f32 of the
            # magnitude sum, ~5e-6) at ~f32-dot cost: the emulated-f64
            # work touches only n/SEG elements.
            pobj = (_seg_dot(params.C, X) * params.objscale).astype(X.dtype)
            dobj = (_seg_dot(params.b, y_new) * params.objscale).astype(X.dtype)
            maxfeas = jnp.maximum(errRp, errRd)
            relgap = jnp.abs(pobj - dobj) / (1.0 + jnp.abs(pobj) + jnp.abs(dobj))

            feasratio = errRp / errRd  # ratioconst = 1 (solver.cu:325)
            prim_win = state.prim_win + jnp.where(feasratio < 1.0, 1, 0)
            dual_win = state.dual_win + jnp.where(feasratio < 1.0, 0, 1)

            do_update = jnp.where(
                it <= sig_update_threshold,
                it % sig_update_stage_1 == 1,
                it % sig_stage_2 == 1,
            )
            prim_dominates = prim_win > 1.2 * dual_win
            dual_dominates = dual_win > 1.2 * prim_win
            sig_up = do_update & prim_dominates
            sig_down = do_update & ~prim_dominates & dual_dominates
            sig_new = jnp.where(sig_up, jnp.minimum(sig_max, sig * sigscale), sig)
            sig_new = jnp.where(sig_down, jnp.maximum(sig_min, sig / sigscale), sig_new)
            prim_win = jnp.where(sig_up, 0, prim_win)
            dual_win = jnp.where(sig_down, 0, dual_win)

            return SolverState(
                X=X,
                y=y_new,
                S=S,
                SmC=SmC,
                Rp=Rp,
                sig=sig_new,
                errRp=errRp,
                errRd=errRd,
                pobj=pobj,
                dobj=dobj,
                relgap=relgap,
                maxfeas=maxfeas,
                prim_win=prim_win,
                dual_win=dual_win,
                it=it,
                sig_stage_2=sig_stage_2,
                sigscale=sigscale,
                best_kkt=best_kkt,
                X_best=X_best,
                y_best=y_best,
                S_best=S_best,
            )

        done = jnp.maximum(state.maxfeas, state.relgap) < stop_tol
        new_state = jax.lax.cond(done, lambda s: s, body, state)
        info_row = jnp.stack(
            [
                new_state.pobj,
                new_state.dobj,
                new_state.errRp,
                new_state.errRd,
                new_state.relgap,
                new_state.sig,
                params.bscale,
                params.Cscale,
            ]
        )
        return new_state, info_row

    return step


def make_chunk_runner(step, chunk: int):
    """Run ``chunk`` iterations under one jit; donates the state buffer."""

    @functools.partial(jax.jit, donate_argnums=0, static_argnums=())
    def run_chunk(state: SolverState, params: SolveParams):
        return jax.lax.scan(lambda s, _: step(s, params), state, None, length=chunk)

    return run_chunk
