"""Projection onto the product of PSD cones.

The performance core of the solver -- counterpart of the
reference's two-path eigendecomposition machinery (per-matrix Xsyevd on
CUDA streams for large blocks + DsyevjBatched for small ones, followed by
eigenvalue clamping, V*diag(w+), and a strided-batched GEMM; reference:
src/solver.cu:531-647, include/cuadmm/cusolver.h:18-171,
src/kernels/diagonal_batch.cu:11-62, include/cuadmm/cublas.h:18-35).

Here there are no streams to juggle: each size bucket is one batched
`eigh` call, and the reconstruction V diag(w+) V^T is a single einsum.
On the GPU, XLA lowers `eigh` to cuSOLVER (batched Jacobi for small
blocks, syevd for large ones) -- the reference's two paths, chosen per
bucket shape. Buckets can also route through the jnp batched Jacobi
(cuadmm_jax.ops.jacobi) or the matmul-only polynomial filter.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp

from cuadmm_jax.ops.svec import blocks_to_svec, svec_to_blocks

# eigh_fn signature: (count, n, n) -> (w (count, n), v (count, n, n)).
EighFn = Callable[[jax.Array], tuple]


def xla_eigh(mats: jax.Array):
    """Batched symmetric eigendecomposition via XLA (cuSOLVER on the GPU)."""
    return jnp.linalg.eigh(mats)


def reconstruct_clamped(
    w: jax.Array, v: jax.Array, eig_rank: Optional[int] = None
) -> jax.Array:
    """P = V diag(max(w, 0)) V^T, batched (one einsum).

    With ``eig_rank`` r, only the r largest eigenvalues survive -- a
    working version of the reference's low-rank projection experiment
    (get_eig_rank_mask, src/utils/get_eig_rank_mask.cu:16-38; its
    application is commented out at duo_solver.cu:843-855). eigh returns
    ascending eigenvalues, so top-r = the trailing r entries.
    """
    wc = jnp.maximum(w, 0.0)
    if eig_rank is not None and eig_rank < w.shape[-1]:
        wc = wc.at[..., : w.shape[-1] - eig_rank].set(0.0)
    return jnp.einsum(
        "bij,bj,bkj->bik", v, wc, v, preferred_element_type=v.dtype
    )


def psd_project(
    Xb: jax.Array,
    maps: Dict[str, Any],
    eigh_by_bucket: Optional[Dict[int, EighFn]] = None,
    mesh=None,
    eig_rank: Optional[int] = None,
    method: str = "eigh",
) -> jax.Array:
    """Project svec vector Xb onto the product cone.

    PSD buckets are eigendecomposed, eigenvalues clamped at zero, and the
    blocks reconstructed; free ('u') entries pass through unchanged, which
    downstream makes S vanish on the free cone automatically.

    ``eigh_by_bucket`` optionally overrides the eigh implementation per
    bucket index.

    With a ``mesh``, each bucket's batch axis is sharded across devices --
    the analog of the reference's moment-matrix partition across GPUs
    (reference: src/duo_solver.cu:269-295); XLA inserts the collectives
    around the eigh.
    """
    from cuadmm_jax.parallel.mesh import shard_blocks

    blocks = svec_to_blocks(Xb, maps)
    projected = []
    for i, bt in enumerate(blocks):
        if bt.shape[-1] == 1:
            # 1x1 blocks (LP cone): projection is elementwise clamping
            # (cf. the reference treating LP entries as size-1 syevj
            # batches, src/solver.cu:580-592 -- pure overhead there too).
            projected.append(jnp.maximum(bt, 0.0))
            continue
        meth = method.get(i, "eigh") if isinstance(method, dict) else method
        bt = shard_blocks(bt, mesh, inner_if_few=meth == "poly")
        if meth == "poly" and (eigh_by_bucket or {}).get(i) is None:
            # Matmul-only composite polynomial filter (ops/polyfilter.py):
            # no eigendecomposition; every FLOP is a matmul.
            from cuadmm_jax.ops.polyfilter import psd_project_poly

            proj = psd_project_poly(bt)
        else:
            fn = (eigh_by_bucket or {}).get(i)
            if fn is None:
                if meth == "jacobi":
                    # Batched cyclic Jacobi (ops/jacobi.py) -- the analog of
                    # cuSOLVER syevjBatched (cusolver.h:104-171).
                    from cuadmm_jax.ops.jacobi import jacobi_eigh_jnp

                    fn = jacobi_eigh_jnp
                else:
                    fn = xla_eigh
            w, v = fn(bt)
            proj = reconstruct_clamped(w, v, eig_rank)
        projected.append(shard_blocks(proj, mesh))
    return blocks_to_svec(projected, Xb, maps)


def psd_project_pool(
    P: jax.Array,
    maps: Dict[str, Any],
    eigh_by_bucket: Optional[Dict[int, EighFn]] = None,
    mesh=None,
    eig_rank: Optional[int] = None,
    method: str = "eigh",
) -> jax.Array:
    """Project a pool-coordinate vector onto the product cone.

    Pool layout (ops/svec.py) means each bucket's dense block tensor is a
    pure reshape of a pool segment -- no per-iteration svec gathers at all
    (the reference pays vector_to_matrices + matrices_to_vector every
    iteration, src/solver.cu:534,647). Each projected bucket is multiplied
    by its 0/1 padding mask so eigh round-off never leaks into padded
    (identically zero) pool positions. Free entries pass through unchanged.
    """
    from cuadmm_jax.parallel.mesh import shard_blocks

    parts = []
    for i, bm in enumerate(maps["buckets"]):
        count, n, base = bm["count"].value, bm["n"].value, bm["base"].value
        seg = P[base : base + count * n * n]
        if n == 1:
            parts.append(jnp.maximum(seg, 0.0))
            continue
        # ``method`` may be a per-bucket dict from the calibrated dispatch
        # (ops/dispatch.py; the analog of is_large_mat, src/matrix_sizes.cu:14-19).
        meth = method.get(i, "eigh") if isinstance(method, dict) else method
        inner = meth == "poly"  # matmul-only path partitions spatially
        bt = shard_blocks(seg.reshape(count, n, n), mesh, inner_if_few=inner)
        # Packed super-matrices: norm-equalize each real block along the
        # diagonal (projection is positively homogeneous), so small-norm
        # packmates keep *relative* accuracy instead of inheriting the
        # largest packmate's absolute error floor.
        packed = bool(bm.get("packed") and bm["packed"].value)
        if packed:
            gid = bm["diag_group"]  # (count, n), padding -> n_groups
            G = bm["n_groups"].value
            rowsq = jnp.sum(bt * bt, axis=-1).reshape(-1)
            sums = jax.ops.segment_sum(
                rowsq, gid.reshape(-1), num_segments=G + 1,
                indices_are_sorted=False,
            )
            norms = jnp.sqrt(sums)
            ok = norms > jnp.finfo(bt.dtype).tiny * 16
            s_blk = jnp.where(ok, 1.0 / jnp.where(ok, norms, 1.0), 1.0)
            s_row = s_blk[gid]  # (count, n): block-diag => row scale == block scale
            bt = bt * s_row[:, :, None]
        if meth == "poly" and (eigh_by_bucket or {}).get(i) is None:
            from cuadmm_jax.ops.polyfilter import psd_project_poly

            proj = psd_project_poly(bt)
        else:
            fn = (eigh_by_bucket or {}).get(i)
            if fn is None:
                if meth == "jacobi":
                    from cuadmm_jax.ops.jacobi import jacobi_eigh_jnp

                    fn = jacobi_eigh_jnp
                else:
                    fn = xla_eigh
            w, v = fn(bt)
            proj = reconstruct_clamped(w, v, eig_rank)
        if packed:
            u_blk = jnp.where(ok, norms, 1.0)
            proj = proj * u_blk[gid][:, :, None]
        proj = shard_blocks(proj * bm["pad_mask"], mesh, inner_if_few=inner)
        parts.append(proj.reshape(-1))
    if maps["free_pos"].shape[0]:
        fb = maps["free_base"].value
        parts.append(P[fb : fb + maps["free_pos"].shape[0]])
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts)
