"""Normal-equation solver for (A A^T) y = rhs.

The reference factorizes AA^T once with CHOLMOD on the CPU (f64 LDLt,
eps=1e-15) and ships the right-hand side device->host->device **twice per
iteration** for the triangular solves (reference:
include/cuadmm/cholesky_cpu.h:33-155, src/solver.cu:487-500 and :704-717).
Here the factor stays on the device. AA^T for moment-relaxation SDPs is
*numerically singular* (PushT N=10: lmax ~ 1.2e3, lmin ~ 5e-15 after row
normalization), so naive low-precision factorizations produce garbage.
What saves the day is that every rhs the ADMM iteration produces lies in
range(A) (rhs = Rp/sigma - A(S - C)), i.e. the systems are *consistent*.

Everything here is device-resident:

- ``precond`` (default on the GPU): one-time device Cholesky of the
  *regularized* P = AA^T + eps*I in float32. On the GPU the triangular
  factor is then explicitly inverted (error ~ cond(L)*eps32 =
  sqrt(cond(P))*eps32 -- safe for a *preconditioner*, unlike a full
  inverse of P whose error scales with cond(P)) so each application is
  two HIGHEST-precision matvecs instead of two triangular solves; on CPU
  the application stays a backward-stable cho_solve. Each solve runs
  refinement sweeps
      y <- y + P^{-1} (rhs - AA^T y)
  with the residual accumulated through the exact sparse A (two tiny
  spmv's) in the high-precision dtype (f64 under x64; with f32 state the
  sweeps run in f32, whose ~1e-7 residual floor matches the state). The
  sweep count is calibrated on the target device at init
  (``_calibrate_applies``), which doubles as an on-device factor sanity
  probe. For consistent rhs each sweep contracts
  the residual by ~eps regardless of the near-null spectrum (measured on
  the real PushT AA^T: eps=1e-4, two applications -> relative residual
  1.8e-8; the reference bar is CHOLMOD's backward-stable ~1e-15).
- ``dense``: identical solve path with an f64 factor (CPU parity path).
- ``packed``: past ``dense_chol_max``, the factor lives as packed
  block-triangular tiles applied by forward/backward sweeps over block
  rows (ops/tri_stream.py) -- same refinement loop as precond. Auto up to
  ``MemoryLimits.packed_max_con``, derived from the device's memory.
- ``split``: when AA^T is exactly block-diagonal with all coupling in a
  leading prefix (QUASAR: 5001 coupled + 751,500 diagonal rows), a dense
  prefix factor plus diagonal tail is an EXACT direct solve at any
  con_num. Auto-detected by a structural probe.
- ``banded``: trajectory/chain SDPs have banded AA^T under an RCM row
  permutation (pendulum N=80: bandwidth 1,615 of 112,028 rows). A
  block-band factor stores nb*(nbw+1) tiles vs the packed triangle's
  nb(nb+1)/2 -- both far fewer bytes per solve and coverage past the
  packed ceiling. Same sweep application and refinement as packed. Auto
  mode probes the RCM bandwidth for every past-dense-ceiling problem.
- ``sharded``: distributed blocked Cholesky + triangular solves over a
  jax.sharding.Mesh (parallel/tri_shard.py) -- for con_num past ANY
  single-device factor budget when a mesh is available. The reference
  has no analog (CHOLMOD is host-only; the duo solver only splits the
  moment eig).
- ``cg``: preconditioned conjugate gradient in f64 using only sparse
  matvecs, FSAI-preconditioned (ops/fsai.py) with block-Jacobi fallback.
  Last resort: ELL matvecs are gather-bound, so this costs hundreds of
  matvecs per solve -- kept for con_num beyond every dense-ish layout and
  as recovery fallback.
- ``host``: scipy sparse LU once, host callback (``jax.pure_callback``)
  per solve -- the reference-style fallback. On the GPU the callback
  needs the CPU platform enabled as well (JAX_PLATFORMS=cuda,cpu).

All modes expose ``solve(rhs, warm)`` usable inside jit.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from cuadmm_jax.ops.sparse import (
    EllTable,
    SparseA,
    _build_ell,
    _ell_matvec,
    aat_matvec,
    spmv_a,
    spmv_at,
)


def _hp_dtype():
    """Residual-accumulation dtype: f64 when x64 is enabled, else f32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


# Per-stage wall-clock of the last build_normal_solver call (diagnostics;
# surfaced through SDPSolver.init_breakdown).
LAST_BUILD_TIMINGS: dict = {}

# XLA:CPU emits kernels with 32-bit byte offsets: cholesky/trsm (or the
# dense A build) on a buffer > 2 GiB segfaults (observed at con_num=19988
# f64 = 3.2 GiB). Keep any single CPU buffer under that line.
CPU_MAX_BUFFER_BYTES = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class MemoryLimits:
    """Auto-mode memory ceilings of one device (see ``memory_limits``)."""

    packed_max_con: int  # largest con_num routed to the packed factor
    band_max_bytes: int  # largest f32 band factor
    dense_a_bytes: int  # largest dense A scattered on device for AA^T


# Headroom the ceilings leave: the packed factor leaves 5 GiB for solver
# state and the projection pool; the band factor, whose problems carry
# small pools, leaves 2 GiB; the transient dense A of the square factor
# build may take 3/8 of the device (it coexists with AA^T and its factor).
PACKED_HEADROOM_BYTES = 5 * 2**30
BAND_HEADROOM_BYTES = 2 * 2**30
DENSE_A_FRACTION = 3 / 8


def memory_limits(bytes_limit: int) -> MemoryLimits:
    """Ceilings for a device that lets the program allocate ``bytes_limit``
    bytes. The packed f32 triangle takes ~2*n_pad^2 bytes."""
    packed = max(bytes_limit - PACKED_HEADROOM_BYTES, 0)
    return MemoryLimits(
        packed_max_con=int(np.sqrt(packed / 2)),
        band_max_bytes=max(bytes_limit - BAND_HEADROOM_BYTES, 0),
        dense_a_bytes=int(bytes_limit * DENSE_A_FRACTION),
    )


def device_memory_limits(device=None) -> MemoryLimits:
    """``memory_limits`` of ``device`` (default: the first device) from its
    reported ``memory_stats()["bytes_limit"]``. A device that reports no
    limit is an error: the ceilings would be guesses."""
    device = jax.devices()[0] if device is None else device
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError(
            f"device {device} reports no memory_stats()['bytes_limit']; "
            "cannot size the normal-equation factor"
        )
    return memory_limits(int(stats["bytes_limit"]))


def _rcm_bandwidth(aat) -> tuple:
    """(bandwidth, permutation) of AA^T under reverse Cuthill-McKee.

    Host-side O(nnz) probe; the permutation is identity-skipped by the
    caller when RCM does not beat the natural ordering (already-banded
    problems like pendulum arrive in knot-point order)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    csr = aat.tocsr()
    coo = aat.tocoo()
    bw_nat = int(np.abs(coo.row - coo.col).max()) if coo.nnz else 0
    perm = np.asarray(reverse_cuthill_mckee(csr, symmetric_mode=True))
    pinv = np.empty_like(perm)
    pinv[perm] = np.arange(len(perm))
    bw_rcm = int(np.abs(pinv[coo.row] - pinv[coo.col]).max()) if coo.nnz else 0
    if bw_nat <= bw_rcm:
        return bw_nat, np.arange(aat.shape[0])
    return bw_rcm, perm


@dataclasses.dataclass
class NormalEqSolver:
    mode: str
    # precond/dense: lower Cholesky factor of AA^T + eps*I (device array).
    chol_l: Optional[jax.Array]
    # cg: preconditioner pieces (Jacobi diagonal or block-Jacobi inverses).
    inv_diag: Optional[jax.Array]
    bj_inv: Optional[jax.Array]  # (nb, bs, bs)
    # High-precision (f64 when available) sparse A for residuals/cg.
    sparse_a: Optional[SparseA]
    cg_tol: float
    cg_max_iter: int
    # cg: AA^T itself in bucketed-ELL form (built host-side from the same
    # sparse product as the preconditioner). One direct (con -> con)
    # matvec per CG step instead of composing A (A^T y) through the
    # pool-length intermediate -- at quasar-500 scale that skips a 4M-slot
    # f64 scatter+gather per step. None outside cg mode.
    aat_tbl: Optional[EllTable] = None
    # cg: FSAI preconditioner factor G ~ inv(chol(AA^T)) and its transpose
    # as matvec tables; application is z = G^T (G r) (ops/fsai.py). When
    # present it supersedes the Jacobi/block-Jacobi pieces.
    fsai_g: Optional[EllTable] = None
    fsai_gt: Optional[EllTable] = None
    # packed: block-triangular Cholesky factor in packed-tile storage with
    # inverted diagonal tiles, applied by forward/backward sweeps over
    # block rows (ops/tri_stream.py). Covers con_num past the square
    # dense factor.
    packed_tiles: Optional[jax.Array] = None
    packed_layout: Optional[tuple] = None
    # banded: block-band Cholesky factor under an RCM row permutation
    # (trajectory/chain SDPs have banded AA^T; see tri_stream's band
    # section). band_perm maps solver row -> permuted row; the apply is
    # y = perm^T . band_solve . perm.
    band_tiles: Optional[jax.Array] = None
    band_layout: Optional[tuple] = None
    band_perm: Optional[jax.Array] = None
    band_inv_perm: Optional[jax.Array] = None
    # sharded: column-sharded (nb, nb, B, B) factor grid on a device
    # mesh with the distributed Cholesky/solves of parallel/tri_shard.py
    # -- the multi-device normal-equation path for con_num past ANY
    # single-device factor budget.
    shard_grid: Optional[jax.Array] = None
    shard_mesh: Optional[object] = None
    shard_axis: str = "blocks"
    # split: AA^T is exactly block-diagonal under a row permutation -- a
    # coupled set of ``split_p`` rows (dense factor in chol_l/inv_l) plus
    # pure-diagonal rows (tail_inv_diag). ANY AA^T splits this way (a row
    # without off-diagonal entries couples to nothing); the mode engages
    # when the coupled set is small. split_p == 0 = fully diagonal AA^T
    # (ros_2000, rose13, cnhil10: the solve is an elementwise divide).
    # ``split_perm``/``split_inv_perm`` are None when the coupled rows
    # already form a prefix (QUASAR).
    split_p: int = 0
    tail_inv_diag: Optional[jax.Array] = None
    split_perm: Optional[jax.Array] = None
    split_inv_perm: Optional[jax.Array] = None
    # precond/dense: refinement applications per solve.
    applies: int = 2
    # host: callable rhs(np) -> y(np)
    host_solve: Optional[Callable] = None
    eps_used: float = 0.0
    # GPU path: explicit inverse of the *triangular* factor, applied as
    # two matvecs (see _apply_factor). None on CPU.
    inv_l: Optional[jax.Array] = None
    # Refinement accumulation dtype: f64 under x64 (the reference's
    # CHOLMOD bar); f32 for f32 state on the GPU, whose ~1e-7 relative
    # residual floor matches the state precision.
    refine_dtype: str = "float64"

    def _apply_factor(self, r: jax.Array) -> jax.Array:
        """Approximate P^{-1} r.

        CPU: backward-stable cho_solve (two TRSMs at factor precision).
        GPU: r -> inv(L)^T (inv(L) r), two dense matvecs. Inverting the
        *triangular* factor is stable enough for a preconditioner: error
        ~ cond(L)*eps32 = sqrt(cond(P))*eps32 ~ 3e-4 at cond(P)~1e7, and
        the refinement loop in ``solve`` contracts against the exact AA^T
        regardless. (A full explicit inverse of P is NOT: its error scales
        as cond(P)*eps32 ~ 1 -- the round-1 failure mode.)

        Packed/banded modes: a forward and a backward sweep over the
        block-triangular or block-band factor (ops/tri_stream.py).

        Split mode: AA^T is exactly block-diagonal with all off-diagonal
        coupling in a leading prefix (QUASAR: 5001 coupled rows, 751,500
        diagonal ones) -- the prefix goes through the dense inverted
        factor, the tail through a diagonal inverse. Exact up to factor
        precision."""
        if self.tail_inv_diag is not None:
            p = self.split_p
            rp = r if self.split_perm is None else r[self.split_perm]
            tail = rp[p:] * self.tail_inv_diag.astype(r.dtype)
            if p:
                y = jnp.concatenate([self._apply_prefix(rp[:p]), tail])
            else:
                y = tail
            return y if self.split_inv_perm is None else y[self.split_inv_perm]
        if self.packed_tiles is not None:
            from cuadmm_jax.ops.tri_stream import PackedLayout, packed_solve

            lay = PackedLayout(*self.packed_layout)
            return packed_solve(
                self.packed_tiles, r.astype(self.packed_tiles.dtype), lay
            ).astype(r.dtype)
        if self.band_tiles is not None:
            from cuadmm_jax.ops.tri_stream import BandLayout, band_solve

            lay = BandLayout(*self.band_layout)
            # band_perm is None when the natural ordering is already
            # banded (pendulum): skip two full-length gathers per apply.
            rp = r if self.band_perm is None else r[self.band_perm]
            y = band_solve(
                self.band_tiles, rp.astype(self.band_tiles.dtype), lay
            ).astype(r.dtype)
            return y if self.band_inv_perm is None else y[self.band_inv_perm]
        if self.shard_grid is not None:
            from cuadmm_jax.parallel.tri_shard import sharded_tri_solve

            n_pad = self.shard_grid.shape[0] * self.shard_grid.shape[2]
            rp = r.astype(self.shard_grid.dtype)
            if rp.shape[0] != n_pad:
                rp = jnp.pad(rp, (0, n_pad - rp.shape[0]))
            y = sharded_tri_solve(
                self.shard_grid, rp, self.shard_mesh, self.shard_axis
            )
            return y[: r.shape[0]].astype(r.dtype)
        return self._apply_prefix(r)

    def _apply_prefix(self, r: jax.Array) -> jax.Array:
        """Dense-factor application (the whole vector, or the coupled
        prefix in split mode)."""
        if self.inv_l is not None:
            # Two HIGHEST-precision matvecs: the f32 default may run TF32,
            # which keeps about three digits.
            hi = jax.lax.Precision.HIGHEST
            rp = r.astype(self.inv_l.dtype)
            t = jax.lax.dot_general(
                self.inv_l, rp, (((1,), (0,)), ((), ())), precision=hi
            )
            y = jax.lax.dot_general(
                self.inv_l, t, (((0,), (0,)), ((), ())), precision=hi
            )
            return y.astype(r.dtype)
        return jax.scipy.linalg.cho_solve(
            (self.chol_l, True), r.astype(self.chol_l.dtype)
        ).astype(r.dtype)

    def solve(self, rhs: jax.Array, warm: Optional[jax.Array] = None) -> jax.Array:
        if self.mode in ("precond", "dense", "packed", "banded", "sharded", "split"):
            hp = jnp.dtype(self.refine_dtype)
            rhs_hp = rhs.astype(hp)
            y = jnp.zeros_like(rhs_hp) if warm is None else warm.astype(hp)
            # Refinement against the exact AA^T via the COMPOSED
            # A (A^T y) product. A direct ELL table of AA^T is
            # cheaper per sweep but was reverted: its f32 rounding excites near-null directions of
            # AA^T that the regularized factor amplifies ~1/eps per
            # sweep, and warm-started solves accumulate it across
            # iterations into divergence. The composed product's
            # rounding stays essentially in range(A) (its final multiply
            # IS an A-product), which the factor does not amplify.
            op = self._op()
            for _ in range(self.applies):
                r = rhs_hp - op(y).astype(hp)
                y = y + self._apply_factor(r).astype(hp)
            return y.astype(rhs.dtype)
        if self.mode == "cg":
            # CG runs in the dtype its tables were built in: the
            # high-precision dtype (f64 under x64, every shipped entry
            # point) -- f32 CG was measured both numerically broken with
            # FSAI and not faster (gather-bound), see build_normal_solver.
            hp = self.aat_tbl.vals[0].dtype if self.aat_tbl is not None else _hp_dtype()
            y = _pcg(
                self._op(),
                rhs.astype(hp),
                self._precond(hp),
                jnp.zeros(rhs.shape, hp) if warm is None else warm.astype(hp),
                self.cg_tol,
                self.cg_max_iter,
            )
            return y.astype(rhs.dtype)
        if self.mode == "host":
            return jax.pure_callback(
                lambda r: np.asarray(
                    self.host_solve(np.asarray(r, dtype=np.float64))
                ).astype(r.dtype),
                jax.ShapeDtypeStruct(rhs.shape, rhs.dtype),
                rhs,
                vmap_method="sequential",
            )
        raise ValueError(self.mode)

    def _op(self):
        """The AA^T matvec: the explicit ELL table in cg mode, else the
        composed sparse product."""
        if self.aat_tbl is not None:
            tbl = self.aat_tbl
            return lambda v: _ell_matvec(tbl, v)
        sa = self.sparse_a
        return lambda v: _aat_matvec(sa, v)

    def _precond(self, hp):
        """CG preconditioner application z = M^{-1} r.

        FSAI when built (two sparse matvecs, ops/fsai.py); else Jacobi
        with the dense block-Jacobi prefix overriding the leading rows
        (see _block_jacobi_inv for why the prefix)."""
        if self.fsai_g is not None:
            g, gt = self.fsai_g, self.fsai_gt
            return lambda r: _ell_matvec(gt, _ell_matvec(g, r).astype(hp)).astype(hp)
        inv_diag, bj_inv = self.inv_diag, self.bj_inv

        def apply_m(r):
            # The dense apply runs in the factor's own f32 (a
            # preconditioner does not need hp accuracy; casting bj_inv up
            # would materialize an f64 copy every call).
            z = r * inv_diag.astype(hp)
            if bj_inv is not None:
                nd, bs = bj_inv.shape[0], bj_inv.shape[-1]
                head = jnp.pad(r, (0, max(0, nd * bs - r.shape[0])))[
                    : nd * bs
                ].reshape(nd, bs)
                zh = jnp.einsum(
                    "bij,bj->bi",
                    bj_inv,
                    head.astype(bj_inv.dtype),
                    precision=jax.lax.Precision.HIGHEST,
                ).reshape(-1)[: min(nd * bs, r.shape[0])].astype(hp)
                z = z.at[: zh.shape[0]].set(zh)
            return z

        return apply_m

    def residual_norm(self, rhs: jax.Array, y: jax.Array) -> jax.Array:
        """|| rhs - AA^T y || / || rhs || (diagnostics / regression tests).

        Prefers the high-precision sparse A (f64 when x64 is on) over the
        CG tables, which may be f32 -- diagnostics must not inherit the
        solve path's own rounding floor."""
        hp = _hp_dtype()
        if self.sparse_a is not None:
            op = lambda v: _aat_matvec(self.sparse_a, v)
        else:
            op = self._op()
        r = rhs.astype(hp) - op(y.astype(hp)).astype(hp)
        return jnp.linalg.norm(r) / jnp.linalg.norm(rhs.astype(hp))


jax.tree_util.register_dataclass(
    NormalEqSolver,
    data_fields=[
        "chol_l",
        "inv_diag",
        "bj_inv",
        "sparse_a",
        "inv_l",
        "aat_tbl",
        "fsai_g",
        "fsai_gt",
        "packed_tiles",
        "band_tiles",
        "band_perm",
        "band_inv_perm",
        "shard_grid",
        "tail_inv_diag",
        "split_perm",
        "split_inv_perm",
    ],
    meta_fields=[
        "mode",
        "cg_tol",
        "cg_max_iter",
        "applies",
        "host_solve",
        "eps_used",
        "refine_dtype",
        "packed_layout",
        "band_layout",
        "split_p",
        "shard_mesh",
        "shard_axis",
    ],
)


def _aat_matvec(sa: SparseA, v: jax.Array) -> jax.Array:
    return aat_matvec(sa, v)


def _pcg(op, rhs, apply_m, x0, tol, max_iter):
    """Preconditioned CG on AA^T, fixed-shape while_loop (jit-safe).

    ``apply_m`` is the preconditioner application (NormalEqSolver._precond:
    FSAI or Jacobi/block-Jacobi). Early exit on the relative residual
    (reference capability bar: cholesky_cpu.h exact solves; CG is the
    large-con_num stand-in)."""
    hp = rhs.dtype

    rhs_nsq = jnp.dot(rhs, rhs)

    def cond(carry):
        _, r, _, _, rz, it = carry
        return jnp.logical_and(it < max_iter, jnp.dot(r, r) > tol * tol * rhs_nsq)

    def body(carry):
        x, r, z, p, rz, it = carry
        ap = op(p).astype(hp)
        alpha = rz / jnp.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = apply_m(r)
        rz_new = jnp.dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return x, r, z, p, rz_new, it + 1

    r0 = rhs - op(x0).astype(hp)
    z0 = apply_m(r0)
    init = (x0, r0, z0, z0, jnp.dot(r0, z0), jnp.array(0, jnp.int32))
    x, *_ = jax.lax.while_loop(cond, body, init)
    return x


def build_aat_host(
    at_svec_idx: np.ndarray,
    at_con_idx: np.ndarray,
    vals: np.ndarray,
    con_num: int,
    vec_len: int,
) -> sp.csr_matrix:
    """Host-side sparse AA^T (con_num x con_num) from A^T triplets."""
    a = sp.csr_matrix(
        (vals, (at_con_idx, at_svec_idx)), shape=(con_num, vec_len)
    )
    return (a @ a.T).tocsr()


def _device_factorize(
    at_svec_idx, at_con_idx, vals, con_num, vec_len, dtype, eps: float,
    dense_a_build_limit: int,
):
    """Build AA^T + eps*scale*I and its Cholesky factor on device.

    Preferred path: scatter A dense on device (COO triplets are the only
    host->device transfer) and form AA^T with one matmul. If dense A
    would take more than ``dense_a_build_limit`` bytes, fall back to a
    host sparse AA^T product (cheap) and ship the dense AA^T once.
    ``eps`` escalates x10 until the factor is finite (the reference's
    CHOLMOD LDLt tolerates semidefinite AA^T at eps=1e-15,
    cholesky_cpu.h:50; plain Cholesky needs the diagonal safely positive).
    """
    itemsize = jnp.dtype(dtype).itemsize
    rows = jnp.asarray(np.asarray(at_con_idx, np.int32))
    cols = jnp.asarray(np.asarray(at_svec_idx, np.int32))
    v = jnp.asarray(np.asarray(vals, dtype=np.dtype(dtype)))

    # NB: the HIGHEST-precision context must wrap *tracing*, not just the
    # call: jnp.linalg.cholesky's blocked rank-k updates and the TRSMs pick
    # up the ambient matmul precision, which for f32 on the GPU may be
    # TF32 -- a reduced-precision factor of a cond~1e7 regularized AA^T is
    # garbage and silently poisons every subsequent solve.
    if con_num * vec_len * itemsize <= dense_a_build_limit:

        @jax.jit
        def fac(rows, cols, v, eps_arr):
            with jax.default_matmul_precision("highest"):
                a = jnp.zeros((con_num, vec_len), dtype).at[rows, cols].add(v)
                aat = jax.lax.dot_general(
                    a, a, (((1,), (1,)), ((), ())), precision="highest"
                )
                scale = jnp.maximum(jnp.trace(aat) / con_num, 1.0)
                aat = aat + (eps_arr * scale) * jnp.eye(con_num, dtype=dtype)
                l = jnp.linalg.cholesky(aat)
            return l, jnp.isfinite(l[-1, -1])

        make = lambda e: fac(rows, cols, v, jnp.asarray(e, dtype))
    else:
        aat_host = build_aat_host(at_svec_idx, at_con_idx, vals, con_num, vec_len)
        aat_dev = jnp.asarray(np.asarray(aat_host.todense(), dtype=np.dtype(dtype)))
        tr = float(max(aat_host.diagonal().sum() / con_num, 1.0))

        @jax.jit
        def fac2(aat, eps_arr):
            with jax.default_matmul_precision("highest"):
                aat = aat + (eps_arr * tr) * jnp.eye(con_num, dtype=dtype)
                l = jnp.linalg.cholesky(aat)
            return l, jnp.isfinite(l[-1, -1])

        make = lambda e: fac2(aat_dev, jnp.asarray(e, dtype))

    cur = float(eps)
    while True:
        l, ok = make(cur)
        if bool(ok):
            return l, cur
        cur *= 10.0
        if cur > 1e-1:
            raise RuntimeError("AA^T Cholesky failed even with jitter 1e-1")


def _tri_inv(l: jax.Array, block: int = 2048) -> jax.Array:
    """Explicit inverse of a lower-triangular Cholesky factor, HIGHEST
    precision. Stable enough for a refined preconditioner: error ~
    cond(L) * eps = sqrt(cond(P)) * eps.

    Blocked forward substitution: inv(L)[i,j] = -Dii (L[i,j:i] @ M[j:i,j]),
    diagonal blocks via small TRSMs. XLA's own solve_triangular against a
    full identity rhs can materialize many n^2 temporaries; this
    version's working set is two n^2 buffers plus one ``block``-wide
    panel."""
    n = l.shape[0]
    if n <= 2 * block:

        @jax.jit
        def inv_small(l):
            with jax.default_matmul_precision("highest"):
                eye = jnp.eye(n, dtype=l.dtype)
                return jax.scipy.linalg.solve_triangular(l, eye, lower=True)

        return inv_small(l)

    k = -(-n // block)
    npad = k * block
    hi = jax.lax.Precision.HIGHEST

    @jax.jit
    def inv(l):
        lp = jnp.zeros((npad, npad), l.dtype).at[:n, :n].set(l)
        pad_idx = jnp.arange(n, npad)
        lp = lp.at[pad_idx, pad_idx].set(1.0)  # keep padding invertible
        eye_b = jnp.eye(block, dtype=l.dtype)
        sl = lambda i, j: jax.lax.dynamic_slice(
            lp, (i * block, j * block), (block, block)
        )
        with jax.default_matmul_precision("highest"):
            D = [
                jax.scipy.linalg.solve_triangular(sl(i, i), eye_b, lower=True)
                for i in range(k)
            ]
        out = jnp.zeros((npad, npad), l.dtype)
        for j in range(k):
            cols = {j: D[j]}
            out = jax.lax.dynamic_update_slice(out, D[j], (j * block, j * block))
            for i in range(j + 1, k):
                acc = jnp.zeros((block, block), l.dtype)
                for t in range(j, i):
                    acc = acc + jax.lax.dot_general(
                        sl(i, t), cols[t], (((1,), (0,)), ((), ())), precision=hi
                    )
                cols[i] = -jax.lax.dot_general(
                    D[i], acc, (((1,), (0,)), ((), ())), precision=hi
                )
                out = jax.lax.dynamic_update_slice(
                    out, cols[i], (i * block, j * block)
                )
        return out[:n, :n]

    return inv(l)


def _calibrate_applies(
    neq: NormalEqSolver,
    con_num: int,
    max_applies: int = 6,
    target: Optional[float] = None,
):
    """Pick the refinement sweep count **on the device that will run it**.

    Runs the real solve path on a consistent probe rhs = (AA^T) v and takes
    the smallest sweep count whose measured relative residual beats a
    target. This is the on-device factor sanity check the round-2 bench
    lacked: a corrupted or precision-starved factor shows up here, at
    init, not as a NaN 60 s into the solve. Raises if even ``max_applies``
    sweeps cannot reach 1e-2 (the factor is unusable -- reference bar:
    CHOLMOD's exact f64 host solves, cholesky_cpu.h:62-155).

    ``target``: defaults to 1e-10 (f64 refinement) / 1e-5 (f32). The
    driver passes a stop_tol-aware value: ADMM only needs the solve
    residual well under the convergence tolerance, and every extra sweep
    costs a full factor read per iteration (pendulum N=80: applies 2 -> 1
    gave an identical errRp/errRd trajectory over 600 iterations).

    All ``max_applies`` sweeps run in one device program and the residual
    curve comes back in one host fetch.
    """
    hp = jnp.dtype(neq.refine_dtype)
    if target is None:
        target = 1e-10 if hp == jnp.float64 else 1e-5
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal(con_num), hp)

    # NB: the solver pytree must be an *argument*, never a closure constant:
    # jit embeds closed-over arrays in the program as constants, and a
    # ~GB factor baked into the HLO bloats compile time and memory.
    @jax.jit
    def probe(nq, v):
        rhs = _aat_matvec(nq.sparse_a, v)
        op = nq._op()

        def sweep(y, _):
            r = rhs - op(y).astype(hp)
            y = y + nq._apply_factor(r).astype(hp)
            res = jnp.linalg.norm(rhs - _aat_matvec(nq.sparse_a, y))
            return y, res

        y = jnp.zeros_like(rhs)
        resids = []
        for _ in range(max_applies):
            y, res = sweep(y, None)
            resids.append(res)
        return jnp.stack(resids) / jnp.linalg.norm(rhs)

    curve = np.asarray(jax.device_get(probe(neq, v)), np.float64)
    ok = np.isfinite(curve) & (curve < target)
    if ok.any():
        k = int(np.argmax(ok)) + 1
        return dataclasses.replace(neq, applies=k)
    best = int(np.nanargmin(curve)) if np.isfinite(curve).any() else max_applies - 1
    if not np.isfinite(curve[best]) or curve[best] > 1e-2:
        raise RuntimeError(
            f"normal-equation factor failed the on-device probe: relative "
            f"residual curve {curve} (eps_used={neq.eps_used:g}). The "
            "factorization is unusable on this backend; try "
            "normal_solver='cg' or a larger precond_eps."
        )
    return dataclasses.replace(neq, applies=best + 1)


def _block_jacobi_inv(
    aat: sp.csr_matrix, con_num: int, block: int, eps: float, dtype
) -> jax.Array:
    """Inverses of the dense diagonal blocks of AA^T (host, f64), stacked
    (nb, block, block) for a batched-matvec preconditioner application."""
    nb = (con_num + block - 1) // block
    aat_csc = aat.tocsc()
    # Only blocks with off-diagonal structure earn a dense inverse; the
    # rest are served by the Jacobi diagonal (exact there). Store the
    # dense blocks as a PREFIX: for structured problems (QUASAR: all
    # coupling sits in the first ~5k rows) this collapses the array from
    # (nb, block, block) to a handful of blocks -- the full array at
    # con_num=756501 was 5.8 GB and ran out of device memory.
    nd = 0
    subs = []
    for i in range(nb):
        s, e = i * block, min((i + 1) * block, con_num)
        sub = aat_csc[s:e, s:e]
        subs.append(sub)
        # Structural diagonality test (ADVICE r3: comparing nnz against the
        # row count misclassifies blocks where all-zero AA^T rows offset
        # off-diagonal entries; such blocks then fall to the Jacobi path
        # whose huge inverse entries poison the preconditioned residual).
        if sub.nnz > np.count_nonzero(sub.diagonal()):
            nd = i + 1
    if nd == 0:
        return None
    out = np.zeros((nd, block, block), dtype=np.float64)
    for i in range(nd):
        s, e = i * block, min((i + 1) * block, con_num)
        d = np.asarray(subs[i].todense())
        scale = max(np.trace(d) / max(e - s, 1), 1.0)
        d[np.diag_indices(e - s)] += eps * scale
        try:
            inv = np.linalg.inv(np.linalg.cholesky(d) @ np.linalg.cholesky(d).T)
        except np.linalg.LinAlgError:
            d[np.diag_indices(e - s)] += 1e-6 * scale
            inv = np.linalg.inv(d)
        out[i, : e - s, : e - s] = inv
        # Identity on padding keeps the preconditioner SPD.
        for j in range(e - s, block):
            out[i, j, j] = 1.0
    return jnp.asarray(out, dtype)


def build_normal_solver(
    at_svec_idx: np.ndarray,
    at_con_idx: np.ndarray,
    vals: np.ndarray,
    con_num: int,
    vec_len: int,
    sparse_a: SparseA,
    mode: str,
    dtype,
    eps: float = 1e-15,
    dense_chol_max: int = 32768,
    cg_tol: float = 0.0,
    cg_max_iter: int = 400,
    precond_eps: float = 1e-4,
    applies: int = 2,
    cg_block_jacobi: int = 2048,
    sparse_a_hp: Optional[SparseA] = None,
    cg_precond: str = "auto",
    fsai_cap: int = 64,
    fsai_pattern_power: int = 2,
    mesh=None,
    mesh_axis: str = "blocks",
    calibrate_target: Optional[float] = None,
) -> NormalEqSolver:
    """Factorize once at init (reference: src/solver.cu:91-96) and return a
    device-resident solver.

    ``sparse_a_hp`` is the high-precision (f64) sparse A used for residual
    refinement and CG; defaults to ``sparse_a`` (fine when dtype is f64).
    ``cg_tol`` <= 0 selects a dtype-aware default (64*eps of the
    high-precision dtype -- the round-1 default of 1e-12 was unreachable
    in f32 and burned cg_max_iter matvecs every solve).
    """
    on_accel = jax.default_backend() == "gpu"
    limits = device_memory_limits() if on_accel else None
    sa_hp = sparse_a_hp if sparse_a_hp is not None else sparse_a
    if mode == "inv":  # legacy alias from round 1
        mode = "precond"
    aat_cached = None
    band_probe = None  # (bandwidth, perm) from the auto-mode RCM probe
    if mode == "auto":
        # O(nnz) coupling probe, no AA^T product needed: an off-diagonal
        # AA^T entry requires two constraints sharing an svec column, so
        # the coupled-row set is every constraint touching a column with
        # multiplicity >= 2. ANY AA^T is block-diagonal under the
        # permutation [coupled rows, diagonal rows]; when the coupled set
        # fits a dense factor the solve is EXACT and tiny (ros_2000 /
        # rose13 / cnhil10: ZERO coupled rows -- a dense factor there is a
        # full n^2 read per apply for an elementwise divide; QUASAR: 5001
        # coupled of 756,501).
        col_mult = np.bincount(at_svec_idx, minlength=vec_len)
        shared = col_mult[at_svec_idx] >= 2
        n_coupled = len(np.unique(at_con_idx[shared]))
        split_fits_cpu = on_accel or n_coupled * n_coupled * 4 <= CPU_MAX_BUFFER_BYTES
        if n_coupled <= min(dense_chol_max, max(con_num // 2, 1024)) and split_fits_cpu:
            mode = "split"
        elif con_num <= dense_chol_max:
            # Regularized f32 factor + f64 refinement on the GPU (handles
            # the singular AA^T of moment SDPs); true f64 Cholesky on CPU.
            mode = "precond" if (on_accel or jnp.dtype(dtype) == jnp.float32) else "dense"
        elif on_accel:
            # Past the square-factor ceiling: packed triangle (half the
            # square bytes, ops/tri_stream.py) vs band factor under an RCM
            # permutation (trajectory SDPs have chain-banded AA^T --
            # pendulum N=80's 112k cons fit in a 1.4 GB band vs a 25 GB
            # packed triangle). Pick whichever reads fewer bytes per solve
            # and fits the device; CG is the last resort.
            aat_cached = build_aat_host(
                at_svec_idx, at_con_idx, vals, con_num, vec_len
            )
            band_probe = _rcm_bandwidth(aat_cached)
            bw = band_probe[0]
            from cuadmm_jax.ops import tri_stream as _ts

            blay = _ts.make_band_layout(con_num, bw)
            band_bytes = blay.T * blay.block * blay.block * 4
            packed_bytes = (
                _ts.make_layout(con_num).T * 1024 * 1024 * 4
                if con_num <= limits.packed_max_con
                else None
            )
            n_mesh = (
                int(np.prod(list(mesh.shape.values()))) if mesh is not None else 1
            )
            if packed_bytes is not None and packed_bytes <= band_bytes * 1.15:
                # Packed wins or is close (no permutation, fewer
                # programs); 15% slack avoids flapping on near-ties.
                mode = "packed"
            elif band_bytes <= limits.band_max_bytes:
                mode = "banded"
            elif packed_bytes is not None:
                mode = "packed"
            elif n_mesh > 1:
                # No single-device factor fits; a mesh is available --
                # distribute the square factor grid over it
                # (parallel/tri_shard.py).
                mode = "sharded"
            else:
                mode = "cg"
        else:
            mode = "cg"
        if not on_accel:
            if mode == "dense" and con_num * con_num * 8 > CPU_MAX_BUFFER_BYTES:
                mode = "precond"  # f32 factor is half the bytes
            if mode == "precond" and con_num * con_num * 4 > CPU_MAX_BUFFER_BYTES:
                mode = "cg"
    if cg_tol is None or cg_tol <= 0.0:
        # Key the default off the STATE dtype, not the refinement dtype:
        # with f32 state the rhs itself only carries ~1e-7 of signal, and
        # chasing 64*eps64 = 1.4e-14 burns cg_max_iter matvecs every solve.
        if jnp.dtype(dtype) == jnp.float32:
            # 2e-7: just above the f32 CG arithmetic floor, so the loop
            # exits on tolerance instead of burning cg_max_iter matvecs
            # chasing a residual f32 cannot represent.
            cg_tol = 2e-7
        else:
            cg_tol = 64.0 * float(jnp.finfo(_hp_dtype()).eps)

    import time as _time

    LAST_BUILD_TIMINGS.clear()
    _t = [_time.perf_counter()]

    def _mark(name):
        now = _time.perf_counter()
        LAST_BUILD_TIMINGS[name] = round(now - _t[0], 3)
        _t[0] = now

    if mode in ("precond", "dense"):
        if mode == "precond":
            fac_dtype = jnp.float32 if on_accel else jnp.dtype(dtype)
            if (
                not on_accel
                and con_num * con_num * jnp.dtype(fac_dtype).itemsize
                > CPU_MAX_BUFFER_BYTES
            ):
                # XLA:CPU kernels index with 32-bit byte offsets; an f64
                # factor over 2 GiB segfaults (observed at con_num=19988).
                # The f32 factor + f64 refinement handles it instead.
                fac_dtype = jnp.float32
            eps0 = max(precond_eps, 1e-12 if fac_dtype == jnp.float64 else 1e-5)
        else:
            fac_dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
            eps0 = max(eps, 1e-14 if fac_dtype == jnp.float64 else 1e-5)
        l, eps_used = _device_factorize(
            at_svec_idx, at_con_idx, vals, con_num, vec_len, fac_dtype, eps0,
            limits.dense_a_bytes if on_accel else CPU_MAX_BUFFER_BYTES,
        )
        jax.block_until_ready(l)
        _mark("factorize")
        inv_l = None
        refine = "float64" if jax.config.jax_enable_x64 else "float32"
        refine_sa = sa_hp
        if on_accel and fac_dtype == jnp.float32:
            inv_l = _tri_inv(l)
            jax.block_until_ready(inv_l)
            _mark("tri_inv")
            l = None  # the factor is no longer needed; free ~n^2 bytes
            if jnp.dtype(dtype) == jnp.float32:
                refine = "float32"
                refine_sa = sparse_a
        neq = NormalEqSolver(
            mode=mode,
            chol_l=l,
            inv_diag=None,
            bj_inv=None,
            sparse_a=refine_sa,
            cg_tol=cg_tol,
            cg_max_iter=cg_max_iter,
            applies=max(applies, 1),
            eps_used=eps_used,
            inv_l=inv_l,
            refine_dtype=refine,
        )
        if applies <= 0:
            neq = _calibrate_applies(neq, con_num, target=calibrate_target)
        _mark("calibrate")
        return neq

    if mode == "split":
        # Coupled-row set via the O(nnz) shared-column probe (see the
        # auto-mode comment); the permutation [S, S^c] makes AA^T exactly
        # block-diagonal: dense factor on S, elementwise inverse on S^c.
        col_mult = np.bincount(at_svec_idx, minlength=vec_len)
        shared = col_mult[at_svec_idx] >= 2
        S = np.unique(at_con_idx[shared])
        p = len(S)
        if p > dense_chol_max:
            raise ValueError(
                f"normal_solver='split': coupled set is {p} rows, past "
                f"dense_chol_max={dense_chol_max}"
            )
        diag = np.bincount(
            at_con_idx, weights=np.asarray(vals) ** 2, minlength=con_num
        )
        scale = max(float(diag.mean()), 1e-30)
        perm = np.concatenate([S, np.setdiff1d(np.arange(con_num), S)])
        identity = bool(np.array_equal(perm, np.arange(con_num)))
        fac_dtype = jnp.float32 if on_accel else (
            jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        )
        # Same XLA:CPU 2 GiB factor-buffer guard as the dense/precond
        # modes: an f64 p x p prefix factor past the 32-bit-offset line
        # segfaults; f32 halves the bytes (refinement sweeps against the
        # exact f64 AA^T restore accuracy, as in precond mode).
        if (
            not on_accel
            and fac_dtype == jnp.float64
            and p * p * 8 > CPU_MAX_BUFFER_BYTES
        ):
            fac_dtype = jnp.float32
        if not on_accel and p * p * 4 > CPU_MAX_BUFFER_BYTES:
            raise ValueError(
                f"normal_solver='split': {p}-row coupled prefix exceeds "
                "the XLA:CPU 2 GiB factor-buffer limit even in f32; use "
                "mode='cg'"
            )
        # f32 factors need precond_eps-level jitter; f64 factors only the
        # aat_eps floor (a 1e-4 jitter would cap refinement at 1e-8).
        cur = (
            max(precond_eps, 1e-5)
            if fac_dtype == jnp.float32
            else max(eps, 1e-12)
        )
        inv_l = None
        l = None
        if p:
            A_csr = sp.csr_matrix(
                (vals, (at_con_idx, at_svec_idx)), shape=(con_num, vec_len)
            )
            A_S = A_csr[S]
            sub = np.asarray((A_S @ A_S.T).todense())

            @jax.jit
            def fac_split(subd, eps_arr):
                with jax.default_matmul_precision("highest"):
                    lw = jnp.linalg.cholesky(
                        subd + eps_arr * jnp.eye(p, dtype=fac_dtype)
                    )
                return lw, jnp.isfinite(lw[-1, -1])

            sub_dev = jnp.asarray(sub.astype(np.dtype(fac_dtype)))
            while True:
                l, okf = fac_split(sub_dev, jnp.asarray(cur * scale, fac_dtype))
                if bool(okf):
                    break
                cur *= 10.0
                if cur > 1e-1:
                    raise RuntimeError(
                        "split-prefix Cholesky failed at jitter 1e-1"
                    )
            del sub_dev
            if on_accel and fac_dtype == jnp.float32:
                inv_l = _tri_inv(l)
                l = None
        _mark("split_factorize")
        td = diag[perm[p:]]
        td = np.where(td > 1e-12 * scale, td, scale)
        refine = "float64" if jax.config.jax_enable_x64 else "float32"
        refine_sa = sa_hp
        if on_accel and jnp.dtype(dtype) == jnp.float32:
            refine = "float32"
            refine_sa = sparse_a
        inv_perm = np.argsort(perm)
        neq = NormalEqSolver(
            mode="split",
            chol_l=l,
            inv_diag=None,
            bj_inv=None,
            sparse_a=refine_sa,
            cg_tol=cg_tol,
            cg_max_iter=cg_max_iter,
            applies=max(applies, 1),
            eps_used=cur,
            inv_l=inv_l,
            split_p=p,
            tail_inv_diag=jnp.asarray((1.0 / td).astype(np.dtype(refine))),
            split_perm=None if identity else jnp.asarray(perm.astype(np.int32)),
            split_inv_perm=None
            if identity
            else jnp.asarray(inv_perm.astype(np.int32)),
            refine_dtype=refine,
        )
        if applies <= 0:
            neq = _calibrate_applies(neq, con_num, target=calibrate_target)
        _mark("calibrate")
        return neq

    if mode == "packed":
        from cuadmm_jax.ops import tri_stream

        block = 1024 if con_num > 2048 else 256
        lay = tri_stream.make_layout(con_num, block)
        aat = (
            aat_cached
            if aat_cached is not None
            else build_aat_host(at_svec_idx, at_con_idx, vals, con_num, vec_len)
        )
        coo = aat.tocoo()
        diag_mean = float(aat.diagonal().mean())
        eps0 = max(precond_eps, 1e-5)
        fac_dtype = jnp.float32 if on_accel else (
            jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        )
        cur = eps0
        while True:
            tiles = tri_stream.scatter_packed_aat(
                coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data,
                lay, cur, diag_mean, fac_dtype,
            )
            tiles = tri_stream.packed_cholesky(tiles, lay)
            last_diag = tiles[tri_stream.tid(lay.nb - 1, lay.nb - 1), -1, -1]
            if bool(jnp.isfinite(last_diag)):
                break
            cur *= 10.0
            if cur > 1e-1:
                raise RuntimeError(
                    "packed AA^T Cholesky failed even with jitter 1e-1"
                )
        _mark("packed_factorize")
        refine = "float64" if jax.config.jax_enable_x64 else "float32"
        refine_sa = sa_hp
        if on_accel and jnp.dtype(dtype) == jnp.float32:
            refine = "float32"
            refine_sa = sparse_a
        neq = NormalEqSolver(
            mode="packed",
            chol_l=None,
            inv_diag=None,
            bj_inv=None,
            sparse_a=refine_sa,
            cg_tol=cg_tol,
            cg_max_iter=cg_max_iter,
            applies=max(applies, 1),
            eps_used=cur,
            packed_tiles=tiles,
            packed_layout=tuple(lay),
            refine_dtype=refine,
            # No direct AA^T refinement table -- see the banded
            # branch for the near-null noise-amplification measurement.
        )
        if applies <= 0:
            neq = _calibrate_applies(neq, con_num, target=calibrate_target)
        _mark("calibrate")
        return neq

    if mode == "banded":
        from cuadmm_jax.ops import tri_stream

        aat = (
            aat_cached
            if aat_cached is not None
            else build_aat_host(at_svec_idx, at_con_idx, vals, con_num, vec_len)
        )
        if band_probe is None:
            band_probe = _rcm_bandwidth(aat)
        bw, perm = band_probe
        pinv = np.empty_like(perm)
        pinv[perm] = np.arange(con_num)
        coo = aat.tocoo()
        lay = tri_stream.make_band_layout(con_num, bw)
        diag_mean = float(aat.diagonal().mean())
        fac_dtype = jnp.float32 if on_accel else (
            jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        )
        # Start the f32 jitter ladder at 1e-5, not precond_eps:
        # banded AA^T (diag-normalized chain structure) factors fine
        # at 1e-5, and the looser 1e-4 forces a second refinement
        # sweep per solve -- a full extra factor read per iteration.
        # Retries escalate x10 on
        # a non-finite factor as usual. f64 factors need only the
        # aat_eps floor (same rationale as split mode).
        cur = (
            max(min(precond_eps, 1e-5), 1e-7)
            if fac_dtype == jnp.float32
            else max(eps, 1e-12)
        )
        pr = pinv[coo.row]
        pc = pinv[coo.col]
        while True:
            tiles = tri_stream.scatter_band_aat(
                pr, pc, coo.data, lay, cur, diag_mean, fac_dtype
            )
            tiles = tri_stream.band_cholesky(tiles, lay)
            last_diag = tiles[
                tri_stream.tid_band(lay.nb - 1, lay.nb - 1, lay), -1, -1
            ]
            if bool(jnp.isfinite(last_diag)):
                break
            cur *= 10.0
            if cur > 1e-1:
                raise RuntimeError(
                    "band AA^T Cholesky failed even with jitter 1e-1"
                )
        _mark("band_factorize")
        LAST_BUILD_TIMINGS["band_bw"] = int(bw)
        LAST_BUILD_TIMINGS["band_layout"] = (
            f"nb={lay.nb} nbw={lay.nbw} B={lay.block} "
            f"bytes={lay.T * lay.block * lay.block * 4}"
        )
        refine = "float64" if jax.config.jax_enable_x64 else "float32"
        refine_sa = sa_hp
        if on_accel and jnp.dtype(dtype) == jnp.float32:
            refine = "float32"
            refine_sa = sparse_a
        identity = bool(np.array_equal(perm, np.arange(con_num)))
        neq = NormalEqSolver(
            mode="banded",
            chol_l=None,
            inv_diag=None,
            bj_inv=None,
            sparse_a=refine_sa,
            cg_tol=cg_tol,
            cg_max_iter=cg_max_iter,
            applies=max(applies, 1),
            eps_used=cur,
            band_tiles=tiles,
            band_layout=tuple(lay),
            band_perm=None if identity else jnp.asarray(perm, jnp.int32),
            band_inv_perm=None if identity else jnp.asarray(pinv, jnp.int32),
            refine_dtype=refine,
            # NO direct AA^T table for refinement (tried r5): the
            # composed A(A^T y) product's rounding stays essentially
            # in range(A), but an f32 ELL table of AA^T injects
            # ~1e-7 noise into near-null directions where the
            # regularized factor amplifies it by ~1/eps per sweep --
            # warm-started solves accumulate it across iterations and
            # pendulum N=80 diverged by iteration 3000 (errRp 82)
            # while the composed path tracks the reference exactly.
        )
        if applies <= 0:
            neq = _calibrate_applies(neq, con_num, target=calibrate_target)
        _mark("calibrate")
        return neq

    if mode == "sharded":
        if mesh is None:
            raise ValueError("normal_solver='sharded' requires a device mesh")
        from cuadmm_jax.parallel import tri_shard as _tsd

        aat = (
            aat_cached
            if aat_cached is not None
            else build_aat_host(at_svec_idx, at_con_idx, vals, con_num, vec_len)
        )
        n_mesh = int(np.prod(list(mesh.shape.values())))
        # Block size: big tiles amortize the per-step psum, but nb must be
        # a multiple of the axis size; small problems (tests/dryrun) get
        # proportionally small tiles.
        blk = 1024 if con_num >= 64 * 1024 else max(
            64, 1 << max(0, (con_num // (4 * n_mesh)).bit_length() - 1)
        )
        blk = min(blk, 1024)
        nb, n_pad = _tsd.make_grid_layout(con_num, mesh.shape[mesh_axis], blk)
        fac_dtype = np.float32 if on_accel else (
            np.float64 if jax.config.jax_enable_x64 else np.float32
        )
        diag_mean = float(aat.diagonal().mean())
        cur = (
            max(precond_eps, 1e-5)
            if fac_dtype == np.float32
            else max(eps, 1e-12)
        )
        while True:
            grid = _tsd.sharded_scatter_aat(
                aat, con_num, nb, blk, mesh, axis=mesh_axis,
                eps=cur, diag_mean=diag_mean, dtype=fac_dtype,
            )
            grid = _tsd.sharded_cholesky(grid, mesh, mesh_axis)
            probe_diag = jax.device_get(grid[nb - 1, nb - 1, -1, -1])
            if bool(np.isfinite(probe_diag)):
                break
            cur *= 10.0
            if cur > 1e-1:
                raise RuntimeError(
                    "sharded AA^T Cholesky failed even with jitter 1e-1"
                )
        _mark("sharded_factorize")
        LAST_BUILD_TIMINGS["sharded_layout"] = (
            f"nb={nb} B={blk} devices={n_mesh} "
            f"bytes_per_dev={nb * nb * blk * blk * 4 // n_mesh}"
        )
        refine = "float64" if jax.config.jax_enable_x64 else "float32"
        refine_sa = sa_hp
        if on_accel and jnp.dtype(dtype) == jnp.float32:
            refine = "float32"
            refine_sa = sparse_a
        neq = NormalEqSolver(
            mode="sharded",
            chol_l=None,
            inv_diag=None,
            bj_inv=None,
            sparse_a=refine_sa,
            cg_tol=cg_tol,
            cg_max_iter=cg_max_iter,
            applies=max(applies, 1),
            eps_used=cur,
            shard_grid=grid,
            shard_mesh=mesh,
            shard_axis=mesh_axis,
            refine_dtype=refine,
        )
        if applies <= 0:
            neq = _calibrate_applies(neq, con_num, target=calibrate_target)
        _mark("calibrate")
        return neq

    if mode == "cg":
        aat = (
            aat_cached
            if aat_cached is not None
            else build_aat_host(at_svec_idx, at_con_idx, vals, con_num, vec_len)
        )
        # CG arithmetic dtype: always the high-precision dtype. An f32 CG
        # was tried (r4) and is numerically broken with FSAI's ~1e8
        # dynamic range on singular moment-SDP AA^T (measured relative
        # residual 30 on PlanarHand N=1 vs 9e-8 in f64), and ELL matvecs
        # are gather-bound, which dtype does not change. Large-con_num
        # problems should use the packed or banded factor instead
        # (ops/tri_stream.py).
        cg_dtype = _hp_dtype()
        if cg_dtype == jnp.float32 and cg_precond == "auto":
            # Without x64, CG runs f32 -- and f32 FSAI is the measured-
            # broken combination above (relative residual ~30 from FSAI's
            # ~1e8 dynamic range). Auto mode drops to (block-)Jacobi;
            # an explicit cg_precond="fsai" still honors the request but
            # warns.
            cg_precond = "block_jacobi" if cg_block_jacobi else "jacobi"
            warnings.warn(
                "cg mode without jax_enable_x64 runs float32 CG; FSAI is "
                "numerically unreliable in f32 and was disabled (using "
                f"{cg_precond}). Enable x64 for the FSAI-preconditioned "
                "f64 CG path."
            )
        elif cg_dtype == jnp.float32 and cg_precond == "fsai":
            warnings.warn(
                "cg_precond='fsai' with float32 CG (x64 disabled): "
                "measured relative residual ~30 on singular moment-SDP "
                "AA^T; results may be unusable. Enable x64."
            )
        bj = None
        fsai_g = fsai_gt = None
        if cg_precond in ("auto", "fsai"):
            # FSAI: measured 3.5-5.6x fewer CG iterations than Jacobi /
            # block-Jacobi on PlanarHand N=1 (see ops/fsai.py docstring),
            # applied as two sparse matvecs -- the device-resident stand-in
            # for the reference's CHOLMOD triangular solves.
            from cuadmm_jax.ops.fsai import build_fsai, fsai_tables

            try:
                G = build_fsai(
                    aat,
                    eps_rel=max(eps, 1e-10),
                    pattern_power=fsai_pattern_power,
                    cap=fsai_cap,
                )
                _mark("fsai_build")
                LAST_BUILD_TIMINGS["fsai_nnz"] = int(G.nnz)
                fsai_g, fsai_gt = fsai_tables(G, cg_dtype)
            except Exception:
                if cg_precond == "fsai":
                    raise
                fsai_g = fsai_gt = None  # auto: fall through to block-Jacobi
        if (
            fsai_g is None
            and cg_precond != "jacobi"
            and cg_block_jacobi
            and con_num > cg_block_jacobi
        ):
            bj = _block_jacobi_inv(
                aat, con_num, cg_block_jacobi, max(eps, 1e-10), jnp.float32
            )
        # Jacobi diagonal always present: it serves every row past the
        # dense block-Jacobi prefix (see _pcg.apply_m). Zero AA^T rows
        # (all-zero constraint rows) get a problem-scaled unit entry, not a
        # 1/1e-30 = 1e30 spike that would poison the preconditioned
        # residual (ADVICE r3).
        diag = aat.diagonal()
        scale = max(float(diag.mean()), 1e-30)
        d = np.where(diag > 1e-12 * scale, diag, scale)
        inv_diag = jnp.asarray(1.0 / d, cg_dtype)
        # Explicit AA^T matvec table (see NormalEqSolver.aat_tbl).
        coo = aat.tocoo()
        aat_tbl = _build_ell(
            coo.row.astype(np.int64),
            coo.col.astype(np.int64),
            coo.data,
            con_num,
            con_num,
            cg_dtype,
        )
        return NormalEqSolver(
            mode="cg",
            chol_l=None,
            inv_diag=inv_diag,
            bj_inv=bj,
            sparse_a=sa_hp,
            cg_tol=cg_tol,
            cg_max_iter=cg_max_iter,
            aat_tbl=aat_tbl,
            fsai_g=fsai_g,
            fsai_gt=fsai_gt,
        )

    if mode == "host":
        try:
            jax.devices("cpu")
        except RuntimeError as e:
            raise RuntimeError(
                "normal_solver='host' runs its solves through jax.pure_callback, "
                "which needs the CPU platform enabled (e.g. JAX_PLATFORMS=cuda,cpu)"
            ) from e
        aat = build_aat_host(at_svec_idx, at_con_idx, vals, con_num, vec_len)
        aat = aat + max(eps, 1e-14) * sp.eye(con_num, format="csr")
        lu = spla.factorized(aat.tocsc())
        return NormalEqSolver(
            mode="host",
            chol_l=None,
            inv_diag=None,
            bj_inv=None,
            sparse_a=None,
            cg_tol=cg_tol,
            cg_max_iter=cg_max_iter,
            host_solve=lu,
        )

    raise ValueError(mode)
