"""Block-structure analysis: size buckets and svec gather maps.

This is the replacement for the reference's block machinery
(analyze_blk, MatrixSizes, get_maps, vector_to_matrices/matrices_to_vector;
reference: src/utils/analyze_blk.cu:63-100, src/matrix_sizes.cu:22-168,
src/utils/get_maps.cu:80-135, src/kernels/vec_mat_conversion.cu:11-57).

Design differences from the reference:

- The reference splits blocks into "large" (per-matrix QR eig on CUDA
  streams) and "small" (batched Jacobi) pools with a calibrated crossover
  (src/matrix_sizes.cu:14-19). Here there are no streams; XLA batches
  everything. We instead group blocks into **buckets of equal padded size**
  so each bucket is one dense (count, n, n) tensor -- one batched eigh per
  bucket, large and batched alike.
- Both svec->matrices and matrices->svec are pure **gathers** with
  precomputed index/scale tables (gathers need no atomics, unlike
  scatters). The matrices->svec direction gathers through a flattened
  concatenation of all bucket tensors via one global inverse permutation.
- **Block-diagonal packing** (``pack_to``): many small PSD blocks are
  packed along the diagonal of a few pack_to x pack_to "super-matrices".
  Spectral functions respect block-diagonal structure
  (f(blkdiag(M1,M2)) = blkdiag(f(M1),f(M2))), so the PSD projection stays
  exact while eigh runs over a few larger shapes instead of thousands of
  tiny matrices (off by default).
- Free ('u') blocks -- WIP in the reference (README.md block table) -- are
  fully supported: their svec segment passes through the projection
  unchanged, which automatically yields S = 0 on the free cone.

svec convention (reference: src/kernels/vec_mat_conversion.cu:5): per block
the lower triangle traversed row-major; off-diagonal entries carry a
sqrt(2) factor in svec space.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

SQRT2 = np.sqrt(2.0)
SQRT2INV = 1.0 / SQRT2


def round_block_size(n: int, rounding: str, exact_above: int) -> int:
    """Padded bucket size for a PSD block of size n.

    1x1 blocks (LP cone entries) keep their own bucket: their projection is
    an elementwise max(x, 0), no eigendecomposition needed."""
    if n == 1 or rounding == "exact" or n > exact_above:
        return n
    p = 4
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class Bucket:
    """One batched pool of equally-padded PSD (super-)blocks.

    gather_idx/gather_scale implement svec -> dense blocks: given X_ext
    (X with a trailing 0 sentinel), ``mats = X_ext[gather_idx] * gather_scale``
    yields the (count, n, n) symmetric block tensor. With packing, each
    entry holds several real blocks along its diagonal.

    pool_pos/out_scale/svec_pos implement the reverse: the bucket's svec
    entries are ``mats.reshape(-1)[pool_pos] * out_scale`` and live at
    global svec indices ``svec_pos``.
    """

    n: int
    count: int
    sizes: np.ndarray  # (count,) total occupied diagonal extent per entry
    gather_idx: np.ndarray  # (count, n, n) int32
    gather_scale: np.ndarray  # (count, n, n) float64
    pool_pos: np.ndarray  # (tri_total,) int64
    out_scale: np.ndarray  # (tri_total,) float64
    svec_pos: np.ndarray  # (tri_total,) int64
    # Per diagonal position: ordinal of the real block occupying it
    # (packing lays several blocks along one super-matrix diagonal);
    # -1 on padding. Lets the projection norm-equalize each real block
    # (projection is positively homogeneous) so packmates with wildly
    # different norms keep *relative* accuracy in f32.
    diag_blkid: np.ndarray = None  # (count, n) int32
    n_groups: int = 0
    packed: bool = False


class BlockStructure:
    """Precomputed layout for a given blk list.

    Attributes:
      vec_len: total svec length.
      buckets: list of Bucket, ordered by padded size.
      free_pos: svec indices of free ('u') block entries.
      inv_perm: (vec_len,) int array such that, with
        ``all_vals = concat([bucket svec vals...] + [free vals])``,
        ``svec = all_vals[inv_perm]`` (cf. the reference's map_M1/map_M2
        tables, src/utils/get_maps.cu:80-135 -- ours compose to a single
        gather).
      psd_dim_total: sum of actual PSD block sizes (for diagnostics).
    """

    def __init__(
        self,
        blk: Sequence[Tuple[str, int]],
        rounding: str = "pow2",
        exact_above: int = 64,
        pack_to: int = 0,
    ):
        self.blk = list(blk)
        self.rounding = rounding
        self.exact_above = exact_above
        self.pack_to = pack_to

        # Pass 1: svec offsets per block; bucket membership. A bucket entry
        # is a *group* of blocks laid along one super-matrix diagonal
        # (singleton groups when not packing).
        bucket_groups: Dict[int, List[List[Tuple[int, int]]]] = {}
        packable: List[Tuple[int, int]] = []  # (offset, n)
        free_segments: List[Tuple[int, int]] = []  # (offset, n)
        offset = 0
        for t, n in self.blk:
            if n <= 0:
                raise ValueError(f"block size must be positive, got {n}")
            if t == "s":
                if pack_to and 1 < n <= pack_to // 2:
                    packable.append((offset, n))
                else:
                    n_pad = round_block_size(n, rounding, exact_above)
                    bucket_groups.setdefault(n_pad, []).append([(offset, n)])
                offset += n * (n + 1) // 2
            elif t == "u":
                free_segments.append((offset, n))
                offset += n
            else:
                raise ValueError(f"unknown block type {t!r}")
        self.vec_len = offset

        # First-fit-decreasing bin packing of small blocks into pack_to-wide
        # super-matrices (the analog of the reference's small-block pools,
        # src/matrix_sizes.cu:22-114, but diagonal-packed instead of
        # batch-stacked).
        if packable:
            packable.sort(key=lambda on: -on[1])
            bins: List[List[Tuple[int, int]]] = []
            remaining = np.empty(0, dtype=np.int64)
            for off, n in packable:
                fit = np.nonzero(remaining >= n)[0]
                if fit.size:
                    i = int(fit[0])
                    bins[i].append((off, n))
                    remaining[i] -= n
                else:
                    bins.append([(off, n)])
                    remaining = np.append(remaining, pack_to - n)
            bucket_groups.setdefault(pack_to, []).extend(bins)

        # Pass 2: build per-bucket gather tables.
        self.buckets: List[Bucket] = []
        for n_pad in sorted(bucket_groups):
            groups = bucket_groups[n_pad]
            count = len(groups)
            gidx = np.full((count, n_pad, n_pad), self.vec_len, dtype=np.int64)
            gscale = np.zeros((count, n_pad, n_pad), dtype=np.float64)
            pool_pos_parts: List[np.ndarray] = []
            out_scale_parts: List[np.ndarray] = []
            svec_pos_parts: List[np.ndarray] = []
            sizes = np.empty(count, dtype=np.int32)
            diag_blkid = np.full((count, n_pad), -1, dtype=np.int32)
            gofs = 0  # running block ordinal within the bucket
            for b, group in enumerate(groups):
                d = 0  # diagonal offset inside the super-matrix
                for off, n in group:
                    diag_blkid[b, d : d + n] = gofs
                    gofs += 1
                    d += n
            for b, group in enumerate(groups):
                d = 0  # diagonal offset inside the super-matrix
                for off, n in group:
                    rows, cols = np.tril_indices(n)  # row-major lower tri
                    tri = np.arange(len(rows)) + off  # global svec indices
                    r, c = rows + d, cols + d
                    # svec -> matrix: fill both (r,c) and (c,r).
                    gidx[b, r, c] = tri
                    gidx[b, c, r] = tri
                    sc = np.where(rows == cols, 1.0, SQRT2INV)
                    gscale[b, r, c] = sc
                    gscale[b, c, r] = sc
                    # matrix -> svec: gather the lower triangle back.
                    flat = b * n_pad * n_pad + r * n_pad + c
                    pool_pos_parts.append(flat)
                    out_scale_parts.append(np.where(rows == cols, 1.0, SQRT2))
                    svec_pos_parts.append(tri)
                    d += n
                sizes[b] = d
            self.buckets.append(
                Bucket(
                    n=n_pad,
                    count=count,
                    sizes=sizes,
                    gather_idx=gidx.astype(np.int32 if self.vec_len < 2**31 - 1 else np.int64),
                    gather_scale=gscale,
                    pool_pos=np.concatenate(pool_pos_parts) if pool_pos_parts else np.empty(0, np.int64),
                    out_scale=np.concatenate(out_scale_parts) if out_scale_parts else np.empty(0),
                    svec_pos=np.concatenate(svec_pos_parts) if svec_pos_parts else np.empty(0, np.int64),
                    diag_blkid=diag_blkid,
                    n_groups=gofs,
                    packed=gofs > count,
                )
            )

        # Free-block svec positions.
        if free_segments:
            self.free_pos = np.concatenate(
                [np.arange(off, off + n) for off, n in free_segments]
            )
        else:
            self.free_pos = np.empty(0, dtype=np.int64)

        # Global inverse permutation: svec index -> position in the
        # concatenation [bucket0 svec vals, bucket1 ..., free vals].
        order = np.concatenate(
            [bk.svec_pos for bk in self.buckets] + [self.free_pos]
        ).astype(np.int64)
        if len(order) != self.vec_len:
            raise AssertionError("svec maps do not cover the vector")
        inv = np.empty(self.vec_len, dtype=np.int64)
        inv[order] = np.arange(self.vec_len)
        self.inv_perm = inv.astype(np.int32 if self.vec_len < 2**31 - 1 else np.int64)

        self.psd_dim_total = int(sum(n for t, n in self.blk if t == "s"))
        self.max_block = max((n for t, n in self.blk if t == "s"), default=0)

        # ---- Pool layout ------------------------------------------------
        # The hot loop stores vec-space state in "pool" coordinates: the
        # flat concatenation of every bucket's (count, n, n) dense tensor
        # followed by the free entries. Off-diagonals hold x_svec/sqrt(2)
        # at BOTH (i,j) and (j,i), so Euclidean dots/norms agree exactly
        # with svec space and the per-iteration svec<->matrices gathers of
        # the reference (src/kernels/vec_mat_conversion.cu:11-57) vanish
        # from the iteration entirely -- the block tensors for eigh are
        # pure reshapes of pool segments.
        bases = []
        base = 0
        for bk in self.buckets:
            bases.append(base)
            base += bk.count * bk.n * bk.n
        self.bucket_base = np.asarray(bases, dtype=np.int64)
        self.free_base = base
        self.pool_len = base + len(self.free_pos)

        itype = np.int32 if self.pool_len < 2**31 - 1 else np.int64
        # svec index -> pool position of (r,c) [lower] and (c,r) [upper];
        # equal on the diagonal and for free entries.
        pool_lo = np.empty(self.vec_len, dtype=np.int64)
        pool_hi = np.empty(self.vec_len, dtype=np.int64)
        offdiag = np.zeros(self.vec_len, dtype=bool)
        for bi, bk in enumerate(self.buckets):
            n_pad = bk.n
            flat = bk.pool_pos  # b*n^2 + r*n + c within the bucket
            b_ix = flat // (n_pad * n_pad)
            rc = flat % (n_pad * n_pad)
            r, c = rc // n_pad, rc % n_pad
            flat_hi = b_ix * n_pad * n_pad + c * n_pad + r
            pool_lo[bk.svec_pos] = bases[bi] + flat
            pool_hi[bk.svec_pos] = bases[bi] + flat_hi
            offdiag[bk.svec_pos] = r != c
        if len(self.free_pos):
            fp = self.free_base + np.arange(len(self.free_pos))
            pool_lo[self.free_pos] = fp
            pool_hi[self.free_pos] = fp
        self.svec_pool_lo = pool_lo.astype(itype)
        self.svec_pool_hi = pool_hi.astype(itype)
        self.svec_offdiag = offdiag

    def describe(self) -> str:
        lines = [f"vec_len={self.vec_len}, {len(self.blk)} blocks, {len(self.buckets)} buckets"]
        for bk in self.buckets:
            distinct = sorted(set(int(s) for s in bk.sizes))
            lines.append(
                f"  bucket n={bk.n}: {bk.count} blocks (actual sizes {distinct})"
            )
        if len(self.free_pos):
            lines.append(f"  free entries: {len(self.free_pos)}")
        return "\n".join(lines)
