"""Sparse constraint-matrix operations.

Device replacement of the cuSPARSE wrappers (reference:
include/cuadmm/cusparse.h:16-132) and the A-normalization kernel
(reference: src/kernels/sparse_matrix_norm.cu:11-44).

Layout: **bucketed ELL**. XLA lowers COO segment-sums to scatters;
instead, rows are grouped into power-of-two-width
buckets, each stored as padded (rows, width) index/value tables. A matvec
is then, per bucket, a gather + elementwise multiply + lane reduction --
no scatter anywhere -- followed by one precomputed inverse-permutation
gather that places bucket outputs back in row order. Rows with wildly
different populations (moment SDPs have a few thousand-entry rows next to
thousands of singletons) cost only their own bucket's padding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class EllTable:
    """One direction (A or A^T) of the matvec in bucketed-ELL form.

    ``idx[b]``: (R_b, K_b) gather indices into the *extended* input vector
    (input with one trailing zero sentinel; padding slots point there).
    ``vals[b]``: matching values, zero-padded.

    Output placement, two interchangeable encodings:

    - ``out_perm``: (out_len,) gather from the concatenation of all bucket
      partial sums plus a trailing zero (empty rows point there). Right
      when most outputs are nonzero (A @ x: every constraint row).
    - ``out_pos``/``out_src``: compact sorted-unique scatter -- only the
      nonzero output slots are touched. Right when the output is mostly
      zero (A^T @ y into pool coordinates: ~50k nonzero slots in a ~1.4M
      pool; a full out_perm gather touches ~28x more slots than are
      nonzero).

    Exactly one of the two is non-None.
    """

    idx: Tuple[jax.Array, ...]
    vals: Tuple[jax.Array, ...]
    out_perm: jax.Array | None
    out_pos: jax.Array | None
    out_src: jax.Array | None
    in_len: int = dataclasses.field(metadata=dict(static=True))
    out_len: int = dataclasses.field(metadata=dict(static=True))


jax.tree_util.register_dataclass(
    EllTable,
    data_fields=["idx", "vals", "out_perm", "out_pos", "out_src"],
    meta_fields=["in_len", "out_len"],
)


@dataclasses.dataclass(frozen=True)
class SparseA:
    """The (con_num x vec_len) constraint matrix A, both directions.

    ``a_idx_compact``: when the A^T table uses the compact-scatter output
    encoding, these are the A-direction gather indices remapped from pool
    positions to A^T's compact partial-sum vector (sentinel = its length).
    The composed matvec A (A^T y) -- the normal-equation operator, run
    several times per iteration -- then never materializes the pool-length
    intermediate at all (see chol._aat_matvec).
    """

    a: EllTable  # A @ x
    at: EllTable  # A^T @ y
    con_num: int = dataclasses.field(metadata=dict(static=True))
    vec_len: int = dataclasses.field(metadata=dict(static=True))
    a_idx_compact: Optional[Tuple[jax.Array, ...]] = None


jax.tree_util.register_dataclass(
    SparseA,
    data_fields=["a", "at", "a_idx_compact"],
    meta_fields=["con_num", "vec_len"],
)


def _build_ell_host(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    out_len: int,
    in_len: int,
    min_bucket_rows: int = 256,
) -> dict:
    """Bucketed ELL from COO, all-host (numpy) result.

    Split from the upload so callers can (a) run index arithmetic on the
    host copies without device->host fetches and (b) upload values in
    several dtypes while sharing one set of index buffers."""
    counts = np.bincount(rows, minlength=out_len)
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    row_start = np.zeros(out_len + 1, dtype=np.int64)
    np.cumsum(counts, out=row_start[1:])

    nonempty = np.nonzero(counts)[0]
    ne_counts = counts[nonempty]
    # Power-of-two target widths; buckets with too few rows merge upward.
    widths = np.maximum(1, 2 ** np.ceil(np.log2(ne_counts)).astype(np.int64))
    uniq = np.sort(np.unique(widths))
    for i, w in enumerate(uniq):
        n_rows = int(np.sum(widths == w))
        # Merge thin buckets into the next width up (fewer ops), but only
        # while the padding stays cheap (<= 4x wider).
        if n_rows and n_rows < min_bucket_rows and i + 1 < len(uniq) and uniq[i + 1] <= 4 * w:
            widths[widths == w] = uniq[i + 1]

    idx_list, val_list, out_pos_list = [], [], []
    base = 0
    for w in sorted(set(int(x) for x in widths)):
        sel = nonempty[widths == w]
        if not len(sel):
            continue
        r = len(sel)
        k = int(w)
        gi = np.full((r, k), in_len, dtype=np.int64)
        gv = np.zeros((r, k), dtype=np.float64)
        cnt = counts[sel]
        total = int(cnt.sum())
        rowrep = np.repeat(np.arange(r), cnt)
        within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        src = np.repeat(row_start[sel], cnt) + within
        gi[rowrep, within] = cols_s[src]
        gv[rowrep, within] = vals_s[src]
        idx_list.append(gi)
        val_list.append(gv)
        out_pos_list.append((sel, base + np.arange(r)))
        base += r

    itype = np.int32 if max(in_len, out_len, base + 1) < 2**31 - 1 else np.int64
    kw = dict(out_perm=None, out_pos=None, out_src=None)
    if 4 * len(nonempty) < out_len:
        # Mostly-zero output: compact scatter (sorted unique positions).
        pos = np.concatenate([sel for sel, _ in out_pos_list]) if out_pos_list else np.zeros(0, np.int64)
        src = np.concatenate([p for _, p in out_pos_list]) if out_pos_list else np.zeros(0, np.int64)
        order2 = np.argsort(pos)
        kw["out_pos"] = pos[order2].astype(itype)
        kw["out_src"] = src[order2].astype(itype)
    else:
        out_perm = np.full(out_len, base, dtype=np.int64)  # sentinel = base
        for sel, pos in out_pos_list:
            out_perm[sel] = pos
        kw["out_perm"] = out_perm.astype(itype)
    return dict(
        idx=[g.astype(itype) for g in idx_list],
        vals=val_list,
        in_len=int(in_len),
        out_len=int(out_len),
        itype=itype,
        **kw,
    )


def _ell_upload(h: dict, dtype, idx_dev=None) -> EllTable:
    """Upload a host-built ELL table. Dtype conversions happen in numpy
    BEFORE upload: jnp.asarray with a differing dtype dispatches (and
    compiles) one convert op per array.
    ``idx_dev`` reuses already-uploaded index buffers (multi-dtype copies
    share them)."""
    np_dt = np.dtype(dtype)
    return EllTable(
        idx=idx_dev
        if idx_dev is not None
        else tuple(jnp.asarray(g) for g in h["idx"]),
        vals=tuple(jnp.asarray(v.astype(np_dt)) for v in h["vals"]),
        out_perm=None if h["out_perm"] is None else jnp.asarray(h["out_perm"]),
        out_pos=None if h["out_pos"] is None else jnp.asarray(h["out_pos"]),
        out_src=None if h["out_src"] is None else jnp.asarray(h["out_src"]),
        in_len=h["in_len"],
        out_len=h["out_len"],
    )


def _build_ell(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    out_len: int,
    in_len: int,
    dtype,
    min_bucket_rows: int = 256,
) -> EllTable:
    """Bucketed ELL from COO (rows -> output axis, cols -> input axis)."""
    return _ell_upload(
        _build_ell_host(rows, cols, vals, out_len, in_len, min_bucket_rows), dtype
    )


def build_sparse_a(
    at_svec_idx: np.ndarray,
    at_con_idx: np.ndarray,
    vals: np.ndarray,
    con_num: int,
    vec_len: int,
    dtype,
) -> SparseA:
    """Build both matvec directions from A^T COO triplets
    (svec_idx, con_idx, val)."""
    return SparseA(
        a=_build_ell(at_con_idx, at_svec_idx, vals, con_num, vec_len, dtype),
        at=_build_ell(at_svec_idx, at_con_idx, vals, vec_len, con_num, dtype),
        con_num=int(con_num),
        vec_len=int(vec_len),
    )


def build_sparse_a_pool(
    at_svec_idx: np.ndarray,
    at_con_idx: np.ndarray,
    vals: np.ndarray,
    con_num: int,
    structure,
    dtype,
) -> SparseA:
    """Both matvec directions with the vec side in **pool coordinates**
    (see ops/svec.py: dense block storage with off-diagonals at x/sqrt(2) in
    both mirrored positions).

    A @ x gathers each svec entry from its lower-triangle pool slot, with
    the value scaled by sqrt(2) off-diagonal (x_svec = sqrt(2) * P[lo]).
    A^T @ y writes each off-diagonal svec row to BOTH mirrored pool slots
    with the value scaled by 1/sqrt(2) ((A^T y)_pool = (A^T y)_svec/sqrt(2)).
    """
    lo = structure.svec_pool_lo[at_svec_idx]
    hi = structure.svec_pool_hi[at_svec_idx]
    off = structure.svec_offdiag[at_svec_idx]
    pool_len = int(structure.pool_len)

    a_cols = lo
    a_vals = np.where(off, vals * np.sqrt(2.0), vals)

    at_rows = np.concatenate([lo, hi[off]])
    at_cols = np.concatenate([at_con_idx, at_con_idx[off]])
    at_vals_lo = np.where(off, vals / np.sqrt(2.0), vals)
    at_vals = np.concatenate([at_vals_lo, vals[off] / np.sqrt(2.0)])

    a_h = _build_ell_host(at_con_idx, a_cols, a_vals, con_num, pool_len)
    at_h = _build_ell_host(at_rows, at_cols, at_vals, pool_len, con_num)
    a_idx_compact_h = None
    if at_h["out_pos"] is not None:
        # Remap A's pool-position gathers to A^T's compact partial-sum
        # vector: slot -> its cat index if A^T writes it, else the trailing
        # zero sentinel. Powers the pool-free composed matvec A (A^T y).
        # All-host arithmetic: no device->host fetches.
        out_pos = at_h["out_pos"]
        out_src = at_h["out_src"]
        n_cat = sum(v.shape[0] for v in at_h["vals"])
        itype = at_h["itype"]
        a_idx_compact_h = []
        for g in a_h["idx"]:
            p = np.searchsorted(out_pos, g)
            pc = np.minimum(p, len(out_pos) - 1) if len(out_pos) else p * 0
            hit = (p < len(out_pos)) & (out_pos[pc] == g) if len(out_pos) else np.zeros(g.shape, bool)
            a_idx_compact_h.append(np.where(hit, out_src[pc], n_cat).astype(itype))

    dtypes = dtype if isinstance(dtype, (tuple, list)) else (dtype,)
    out = []
    a_idx_dev = at_idx_dev = None
    compact_dev = None
    for dt in dtypes:
        a_tbl = _ell_upload(a_h, dt, idx_dev=a_idx_dev)
        at_tbl = _ell_upload(at_h, dt, idx_dev=at_idx_dev)
        a_idx_dev, at_idx_dev = a_tbl.idx, at_tbl.idx  # share index buffers
        if a_idx_compact_h is not None and compact_dev is None:
            compact_dev = tuple(jnp.asarray(g) for g in a_idx_compact_h)
        out.append(
            SparseA(
                a=a_tbl,
                at=at_tbl,
                con_num=int(con_num),
                vec_len=pool_len,
                a_idx_compact=compact_dev,
            )
        )
    return out[0] if not isinstance(dtype, (tuple, list)) else tuple(out)


def cast_sparse_a(sa: SparseA, dtype) -> SparseA:
    """Same index tables, values cast to ``dtype``.

    The cast runs on the HOST (numpy) and re-uploads: a device-side
    ``.astype`` per bucket compiles one trivial convert executable each."""
    cast_t = lambda t: dataclasses.replace(
        t,
        vals=tuple(jnp.asarray(np.asarray(v).astype(dtype)) for v in t.vals),
    )
    return dataclasses.replace(sa, a=cast_t(sa.a), at=cast_t(sa.at))


def _ell_matvec(t: EllTable, x: jax.Array) -> jax.Array:
    x_ext = jnp.concatenate([x, jnp.zeros((1,), x.dtype)])
    parts = [
        jnp.sum(v * x_ext[i], axis=1) for i, v in zip(t.idx, t.vals)
    ]
    if t.out_pos is not None:
        cat = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        return (
            jnp.zeros((t.out_len,), x.dtype)
            .at[t.out_pos]
            .set(cat[t.out_src], unique_indices=True, indices_are_sorted=True)
        )
    parts.append(jnp.zeros((1,), x.dtype))  # sentinel for empty rows
    cat = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    return cat[t.out_perm]


def spmv_a(sa: SparseA, x: jax.Array) -> jax.Array:
    """A @ x: (vec_len,) -> (con_num,)."""
    return _ell_matvec(sa.a, x)


def spmv_at(sa: SparseA, y: jax.Array) -> jax.Array:
    """A^T @ y: (con_num,) -> (vec_len,)."""
    return _ell_matvec(sa.at, y)


def aat_matvec(sa: SparseA, y: jax.Array) -> jax.Array:
    """(A A^T) y -- the normal-equation operator, composed compactly.

    With ``a_idx_compact`` the A-direction gathers read A^T's compact
    partial-sum vector (~nnz-sized) directly; the pool-length intermediate
    of spmv_a(spmv_at(y)) -- its zeros fill, scatter, and re-gather -- is
    skipped entirely. Falls back to the two-step composition otherwise.
    """
    if sa.a_idx_compact is None or sa.a.out_perm is None:
        return spmv_a(sa, spmv_at(sa, y))
    t_at, t_a = sa.at, sa.a
    y_ext = jnp.concatenate([y, jnp.zeros((1,), y.dtype)])
    parts = [jnp.sum(v * y_ext[i], axis=1) for i, v in zip(t_at.idx, t_at.vals)]
    parts.append(jnp.zeros((1,), y.dtype))  # sentinel for never-written slots
    cat = jnp.concatenate(parts)
    parts2 = [
        jnp.sum(v * cat[i2], axis=1)
        for i2, v in zip(sa.a_idx_compact, t_a.vals)
    ]
    parts2.append(jnp.zeros((1,), y.dtype))
    cat2 = parts2[0] if len(parts2) == 1 else jnp.concatenate(parts2)
    return cat2[t_a.out_perm]


def normalize_rows(
    at_svec_idx: np.ndarray, at_con_idx: np.ndarray, vals: np.ndarray, con_num: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-constraint 2-norms of A, clamped >= 1, and the normalized values.

    Reference: src/kernels/sparse_matrix_norm.cu:11-44 (norms of the CSC
    columns of A^T, i.e. rows of A).
    """
    sq = np.zeros(con_num, dtype=np.float64)
    np.add.at(sq, at_con_idx, vals * vals)
    norm = np.maximum(1.0, np.sqrt(sq))
    return norm, vals / norm[at_con_idx]
