"""Packed and banded block-triangular Cholesky: build + triangular sweeps.

The normal-equation solver for con_num past the dense-square factor
ceiling. The reference covers this range with CHOLMOD's sparse LDLt on
the host plus two PCIe round-trips per iteration (reference:
include/cuadmm/cholesky_cpu.h:62-155, src/solver.cu:487-500). Here the
factor stays on the device in dense-BLOCKED but PACKED storage:

- The lower-triangular factor lives as packed tiles (T, B, B) with T =
  nb(nb+1)/2, row-major over the block triangle -- HALF the memory of a
  square factor, zero index storage. Block row i is the contiguous run of
  tiles tid(i, 0..i).
- ``packed_cholesky``: right-looking blocked Cholesky entirely on device
  (HIGHEST precision); diagonal tiles are stored INVERTED so the sweeps
  never run a TRSM. Pair updates are chunked so transients stay small.
- ``packed_solve``: forward and backward sweeps as a loop over block
  rows. Each step reads that row's contiguous tiles once: one batched
  GEMV over tid(i, 0..i-1), then one GEMV by the inverted diagonal tile.
  The backward sweep is row-oriented too (acc[:i] -= L[i, :i]^T y_i), so
  it never gathers a strided column of the packed triangle.

Apply = P^{-1} r ~ solving L L^T y = r with the regularized factor; the
``precond``-style refinement in ops/chol.py (residuals through the exact
sparse A) recovers full accuracy, identical in role to the dense-square
path's refinement.

Every f32 dot passes ``precision=HIGHEST``: a TF32 product keeps about
three decimal digits, which the regularized factor of a cond~1e7 AA^T
cannot afford.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_HI = jax.lax.Precision.HIGHEST


class PackedLayout(NamedTuple):
    """Static description of a packed block-triangular matrix."""

    n: int  # logical dimension
    n_pad: int  # nb * block
    block: int
    nb: int  # number of block rows
    T: int  # nb*(nb+1)//2 tiles


def make_layout(n: int, block: int = 1024) -> PackedLayout:
    nb = -(-n // block)
    return PackedLayout(n=n, n_pad=nb * block, block=block, nb=nb, T=nb * (nb + 1) // 2)


def tid(i: int, j: int) -> int:
    """Packed tile id of block (i, j), i >= j (row-major lower triangle)."""
    return i * (i + 1) // 2 + j


def scatter_packed_aat(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    lay: PackedLayout,
    eps: float,
    diag_mean: float,
    dtype=jnp.float32,
) -> jax.Array:
    """Device packed tiles of AA^T + eps*scale*I from COO (host indices).

    Only lower-triangle entries are stored (r >= c). Padding rows get a
    unit diagonal so the Cholesky stays well-posed there.
    """
    keep = rows >= cols
    r, c, v = rows[keep], cols[keep], vals[keep]
    bi, ri = r // lay.block, r % lay.block
    bj, ci = c // lay.block, c % lay.block
    t = (bi * (bi + 1) // 2 + bj).astype(np.int64)

    # Regularized diagonal + identity padding, as extra COO entries.
    scale = max(float(diag_mean), 1.0)
    all_d = np.arange(lay.n_pad, dtype=np.int64)
    t_d = ((all_d // lay.block) * (all_d // lay.block + 1) // 2 + all_d // lay.block)
    rd = all_d % lay.block
    vd = np.full(lay.n_pad, eps * scale)
    vd[lay.n :] = 1.0  # unit diagonal on padding

    t = np.concatenate([t, t_d])
    ri = np.concatenate([ri, rd])
    ci = np.concatenate([ci, rd])
    v = np.concatenate([v, vd])

    # T + 1 tiles: the trailing tile is a scatter/gather SENTINEL for the
    # padded build steps (packed_cholesky) -- garbage lands there instead
    # of needing masks. The sweeps only read tiles [0, T).
    @functools.partial(jax.jit, static_argnames=("shape",))
    def scatter(t, ri, ci, v, shape):
        tiles = jnp.zeros(shape, dtype)
        return tiles.at[t, ri, ci].add(v)

    return scatter(
        jnp.asarray(t, jnp.int32),
        jnp.asarray(ri, jnp.int32),
        jnp.asarray(ci, jnp.int32),
        jnp.asarray(v, dtype),
        shape=(lay.T + 1, lay.block, lay.block),
    )


def _pair_lists(nb: int, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pi, pj, dst): for the rank-B update after column k, all pairs
    i >= j > k; pi/pj index the trailing column-k panel (i-k-1, j-k-1),
    dst is the packed tile id of (i, j)."""
    pi, pj, dst = [], [], []
    for i in range(k + 1, nb):
        for j in range(k + 1, i + 1):
            pi.append(i - k - 1)
            pj.append(j - k - 1)
            dst.append(tid(i, j))
    return (
        np.asarray(pi, np.int32),
        np.asarray(pj, np.int32),
        np.asarray(dst, np.int32),
    )


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


@functools.partial(jax.jit, donate_argnums=0, static_argnames=())
def _diag_panel_step(tiles, diag_id, col_ids):
    """One elimination step: invert the diagonal tile in place, scale the
    (padded) column panel by inv(L_kk)^T. Returns (tiles, panel).

    ``col_ids`` is padded with the sentinel tile id (T) -- padded lanes
    read/write the sentinel, no masks needed. Runs as its own jit with the
    tile array DONATED so the multi-GB buffer is updated in place across
    calls: a single monolithic build program has to keep its transients
    next to a second copy of the factor."""
    B = tiles.shape[-1]
    with jax.default_matmul_precision("highest"):
        dk = jax.lax.dynamic_index_in_dim(tiles, diag_id, 0, keepdims=False)
        # Diagonal tiles store only the lower triangle; rebuild the
        # symmetric block explicitly. (jnp.linalg.cholesky would
        # symmetrize as (A+A^T)/2, HALVING our off-diagonals.)
        dk = jnp.tril(dk) + jnp.tril(dk, -1).T
        lkk = jnp.linalg.cholesky(dk)
        ikk = jax.scipy.linalg.solve_triangular(
            lkk, jnp.eye(B, dtype=tiles.dtype), lower=True
        )
        tiles = jax.lax.dynamic_update_index_in_dim(tiles, ikk, diag_id, 0)
        # Panel extraction as a scan of dynamic slices, NOT tiles[col_ids]:
        # XLA's gather lowering can materialize a slice of the ENTIRE tile
        # array as a temporary. A scan of m_pad dynamic-slices reads only
        # the addressed tiles.
        _, panel = jax.lax.scan(
            lambda _, i: (
                None,
                jax.lax.dynamic_index_in_dim(tiles, i, 0, keepdims=False),
            ),
            None,
            col_ids,
        )
        panel = jax.lax.dot_general(
            panel, ikk, (((2,), (1,)), ((), ())), precision=_HI
        )
        tiles = tiles.at[col_ids].set(panel)
    return tiles, panel


@functools.partial(jax.jit, donate_argnums=0, static_argnames=())
def _pair_chunk_step(tiles, panel, pi, pj, dst):
    """Subtract one chunk of panel outer products L_ik L_jk^T from the
    trailing tiles. Padded (pi, pj, dst) point at the sentinel tile."""
    with jax.default_matmul_precision("highest"):
        li = panel[pi]
        ljt = panel[pj]
        upd = jax.lax.dot_general(
            li, ljt, (((2,), (2,)), ((0,), (0,))), precision=_HI
        )
        return tiles.at[dst].add(-upd)


def _pair_updates(tiles, panel, pi, pj, dst, sentinel: int, chunk: int = 64):
    """Apply the (pi, pj, dst) pair updates in fixed-size chunks; the
    padding of the last chunk points at the sentinel tile."""
    n_chunks = -(-len(dst) // chunk)
    total = n_chunks * chunk
    pi_p = np.zeros(total, np.int32)
    pj_p = np.zeros(total, np.int32)
    dst_p = np.full(total, sentinel, np.int32)
    pi_p[: len(pi)] = pi
    pj_p[: len(pj)] = pj
    dst_p[: len(dst)] = dst
    for s in range(0, total, chunk):
        sl = slice(s, s + chunk)
        tiles = _pair_chunk_step(
            tiles, panel, jnp.asarray(pi_p[sl]), jnp.asarray(pj_p[sl]),
            jnp.asarray(dst_p[sl]),
        )
    return tiles


def packed_cholesky(tiles: jax.Array, lay: PackedLayout, update_chunk: int = 64) -> jax.Array:
    """Blocked Cholesky of packed tiles, in place across many small jit
    calls; diagonal tiles come out INVERTED (inv(L_kk)) -- exactly what
    the sweeps consume.

    Right-looking: for each k, factor the diagonal tile, scale the column
    panel by inv(L_kk)^T (a batched matmul -- no TRSM), then subtract the
    panel outer products from the trailing triangle in chunks of
    ``update_chunk`` tiles. Every call donates the tile array, so peak
    memory is the packed factor plus ~3 chunk-sized transients; panel
    sizes and chunk ids are padded to powers of two (sentinel tile absorbs
    the padding) so only O(log nb) distinct programs compile. All matmuls
    run at HIGHEST precision: a reduced-precision update of a regularized
    AA^T factor is garbage (see ops/chol.py._device_factorize).
    """
    nb = lay.nb
    sentinel = lay.T
    for k in range(nb):
        m = nb - 1 - k
        m_pad = _pow2_at_least(max(m, 1))
        col = np.full(m_pad, sentinel, np.int32)
        col[:m] = [tid(i, k) for i in range(k + 1, nb)]
        tiles, panel = _diag_panel_step(
            tiles, np.int32(tid(k, k)), jnp.asarray(col)
        )
        if m:
            pi, pj, dst = _pair_lists(nb, k)
            tiles = _pair_updates(tiles, panel, pi, pj, dst, sentinel, update_chunk)
    return tiles


# ----------------------------------------------------------------------
# Triangular sweeps (plain XLA).
# ----------------------------------------------------------------------


def _row_mv(row, x):
    """sum_j row[j] @ x[j] for row (k, B, B), x (k, B): a batched GEMV
    over the row's tiles, then a sum over the k partial results."""
    return jnp.einsum("jab,jb->ja", row, x, precision=_HI).sum(0)


def _row_mv_t(row, y):
    """row[j]^T @ y for every tile j of row (k, B, B): (k, B)."""
    yb = jnp.broadcast_to(y, (row.shape[0], row.shape[1]))
    return jnp.einsum("jab,ja->jb", row, yb, precision=_HI)


def _diag_mv(dinv, v):
    return jnp.dot(dinv, v, precision=_HI)


def _diag_mv_t(dinv, v):
    return jnp.dot(v, dinv, precision=_HI)


def _pad_rows(r, lay, dtype):
    rp = r.astype(dtype)
    if lay.n_pad != r.shape[0]:
        rp = jnp.pad(rp, (0, lay.n_pad - r.shape[0]))
    return rp.reshape(lay.nb, lay.block)


@functools.partial(jax.jit, static_argnames=("lay",))
def packed_solve(tiles: jax.Array, r: jax.Array, lay: PackedLayout) -> jax.Array:
    """y = (L L^T)^{-1} r via a forward and a backward sweep over the
    packed factor, each a loop over block rows (unrolled: row i reads the
    i + 1 contiguous tiles tid(i, 0..i), a static slice)."""
    nb = lay.nb
    rb = _pad_rows(r, lay, tiles.dtype)

    # Forward: x_i = inv(L_ii) (r_i - sum_{j<i} L_ij x_j).
    x = jnp.zeros_like(rb)
    for i in range(nb):
        s = tid(i, 0)
        acc = rb[i]
        if i:
            acc = acc - _row_mv(tiles[s : s + i], x[:i])
        x = x.at[i].set(_diag_mv(tiles[s + i], acc))

    # Backward, row-oriented: y_i = inv(L_ii)^T acc_i, then every j < i
    # takes L_ij^T y_i out of its running residual.
    acc = x
    y = jnp.zeros_like(rb)
    for i in range(nb - 1, -1, -1):
        s = tid(i, 0)
        yi = _diag_mv_t(tiles[s + i], acc[i])
        y = y.at[i].set(yi)
        if i:
            acc = acc.at[:i].add(-_row_mv_t(tiles[s : s + i], yi))
    return y.reshape(lay.n_pad)[: r.shape[0]].astype(r.dtype)


# ----------------------------------------------------------------------
# Banded-blocked factor: trajectory/chain SDPs couple constraints only
# across adjacent knot points, so AA^T under an RCM ordering is BANDED
# (pendulum N=80: 112,028 constraints, scalar bandwidth 1,615). A banded
# factor stores nb*(nbw+1) tiles instead of the packed triangle's
# nb(nb+1)/2, and Cholesky produces no fill outside the band, so the same
# right-looking elimination steps (_diag_panel_step/_pair_chunk_step)
# apply verbatim. Every block row holds exactly nbw+1 tiles, so the
# sweeps are a lax.scan with static shapes.
# ----------------------------------------------------------------------


class BandLayout(NamedTuple):
    """Static description of a banded-blocked lower factor."""

    n: int  # logical dimension
    n_pad: int  # nb * block
    block: int
    nb: int  # number of block rows
    nbw: int  # block bandwidth: tile (i, j) may be nonzero iff i-j <= nbw
    T: int  # nb * (nbw + 1) allocated band slots (some top-left unused)


# Sweep-time model for the band block size: tile bytes at the H100's
# datasheet bandwidth (3.35 TB/s) plus an assumed fixed cost per scanned
# block row (a few kernel launches; not measured yet).
_MODEL_BYTES_PER_S = 3.35e12
_MODEL_ROW_STEP_S = 2e-5


def make_band_layout(n: int, bw: int, block: int = 0) -> BandLayout:
    """Layout for scalar bandwidth ``bw``; picks the block size in
    {256, 512, 1024} minimizing the sweep-time model above. Smaller tiles
    track the scalar band tighter (fewer bytes) but add scanned rows."""
    if block <= 0:
        best = None
        for B in (1024, 512, 256):
            nb = -(-n // B)
            nbw = min(nb - 1, (bw + B - 1) // B)
            T = nb * (nbw + 1)
            t_model = T * B * B * 4 / _MODEL_BYTES_PER_S + nb * _MODEL_ROW_STEP_S
            if best is None or t_model < best[0]:
                best = (t_model, B)
        block = best[1]
    nb = -(-n // block)
    nbw = min(nb - 1, (bw + block - 1) // block)
    return BandLayout(
        n=n, n_pad=nb * block, block=block, nb=nb, nbw=nbw, T=nb * (nbw + 1)
    )


def tid_band(i, j, lay: BandLayout):
    """Band slot of tile (i, j), i - nbw <= j <= i (row-major band)."""
    return i * (lay.nbw + 1) + (lay.nbw - (i - j))


def scatter_band_aat(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    lay: BandLayout,
    eps: float,
    diag_mean: float,
    dtype=jnp.float32,
) -> jax.Array:
    """Device band tiles of (permuted) AA^T + eps*scale*I from COO.

    ``rows``/``cols`` are indices AFTER the bandwidth-reducing permutation;
    entries outside the band are an error (the caller computed the
    bandwidth from this exact pattern). Padding rows get a unit diagonal.
    """
    keep = rows >= cols
    r, c, v = rows[keep], cols[keep], vals[keep]
    bi, bj = r // lay.block, c // lay.block
    if len(bi) and int((bi - bj).max()) > lay.nbw:
        raise ValueError("entry outside the declared band")
    t = (bi * (lay.nbw + 1) + (lay.nbw - (bi - bj))).astype(np.int64)
    ri, ci = r % lay.block, c % lay.block

    scale = max(float(diag_mean), 1.0)
    all_d = np.arange(lay.n_pad, dtype=np.int64)
    t_d = (all_d // lay.block) * (lay.nbw + 1) + lay.nbw
    rd = all_d % lay.block
    vd = np.full(lay.n_pad, eps * scale)
    vd[lay.n :] = 1.0

    t = np.concatenate([t, t_d])
    ri = np.concatenate([ri, rd])
    ci = np.concatenate([ci, rd])
    v = np.concatenate([v, vd])

    @functools.partial(jax.jit, static_argnames=("shape",))
    def scatter(t, ri, ci, v, shape):
        tiles = jnp.zeros(shape, dtype)
        return tiles.at[t, ri, ci].add(v)

    # T + 1: trailing sentinel tile for the padded elimination steps.
    return scatter(
        jnp.asarray(t, jnp.int32),
        jnp.asarray(ri, jnp.int32),
        jnp.asarray(ci, jnp.int32),
        jnp.asarray(v, dtype),
        shape=(lay.T + 1, lay.block, lay.block),
    )


def band_cholesky(tiles: jax.Array, lay: BandLayout) -> jax.Array:
    """Right-looking blocked Cholesky within the band; diagonal tiles come
    out INVERTED. Reuses the packed elimination steps -- banded Cholesky
    has no fill outside the band, so after eliminating column k only
    tiles (i, j) with k < j <= i <= k + nbw update, all in-band. The
    top-left slots of the first nbw rows are never written and stay
    zero, which the sweeps rely on."""
    nb, nbw = lay.nb, lay.nbw
    sentinel = lay.T
    for k in range(nb):
        m = min(nbw, nb - 1 - k)
        m_pad = _pow2_at_least(max(m, 1))
        col = np.full(m_pad, sentinel, np.int32)
        col[:m] = [tid_band(i, k, lay) for i in range(k + 1, k + m + 1)]
        tiles, panel = _diag_panel_step(
            tiles, np.int32(tid_band(k, k, lay)), jnp.asarray(col)
        )
        if m:
            pi, pj, dst = [], [], []
            for i in range(k + 1, k + m + 1):
                for j in range(k + 1, i + 1):
                    pi.append(i - k - 1)
                    pj.append(j - k - 1)
                    dst.append(tid_band(i, j, lay))
            # Chunked (64 tiles of transients per call): one chunk of all
            # nbw(nbw+1)/2 pairs can take GBs on top of a wide band.
            tiles = _pair_updates(tiles, panel, pi, pj, dst, sentinel)
    return tiles


@functools.partial(jax.jit, static_argnames=("lay",))
def band_solve(tiles: jax.Array, r: jax.Array, lay: BandLayout) -> jax.Array:
    """y = (L L^T)^{-1} r via a forward and a backward ``lax.scan`` over
    the block rows of the band factor.

    Row i's slots tid_band(i, i-nbw .. i) are contiguous, so the band is a
    (nb, nbw+1, B, B) view with the inverted diagonal tile last. The
    running vectors carry nbw leading zero rows: slot k of row i pairs
    with padded row i + k (block column i - nbw + k), which keeps every
    slice static-shaped at the top of the band, where the unused slots
    hold zeros."""
    B, nb, w = lay.block, lay.nb, lay.nbw
    rb = _pad_rows(r, lay, tiles.dtype)
    rows = tiles[: lay.T].reshape(nb, w + 1, B, B)
    idx = jnp.arange(nb)

    def fwd(x_pad, inp):
        row, ri, i = inp
        acc = ri
        if w:
            xw = jax.lax.dynamic_slice_in_dim(x_pad, i, w)
            acc = acc - _row_mv(row[:w], xw)
        xi = _diag_mv(row[w], acc)
        return jax.lax.dynamic_update_slice_in_dim(x_pad, xi[None], w + i, 0), None

    x_pad = jnp.zeros((w + nb, B), tiles.dtype)
    x_pad, _ = jax.lax.scan(fwd, x_pad, (rows, rb, idx))

    def bwd(acc_pad, inp):
        row, i = inp
        yi = _diag_mv_t(row[w], jax.lax.dynamic_index_in_dim(acc_pad, w + i, 0, False))
        if w:
            upd = jax.lax.dynamic_slice_in_dim(acc_pad, i, w) - _row_mv_t(row[:w], yi)
            acc_pad = jax.lax.dynamic_update_slice_in_dim(acc_pad, upd, i, 0)
        return acc_pad, yi

    _, y = jax.lax.scan(bwd, x_pad, (rows, idx), reverse=True)
    return y.reshape(lay.n_pad)[: r.shape[0]].astype(r.dtype)
