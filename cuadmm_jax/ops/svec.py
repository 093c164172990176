"""svec <-> dense-block conversion as pure gathers.

Counterpart of the reference's vector_to_matrices /
matrices_to_vector CUDA kernels (reference:
src/kernels/vec_mat_conversion.cu:11-57). The reference scatters each svec
entry into both symmetric positions of pooled dense storage; we instead
precompute gather tables (structure.py) so both directions are gathers,
which XLA vectorizes well (no atomics / scatter serialization).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Static:
    """Static (non-traced) metadata carried inside the maps pytree; jit
    specializes on the value instead of tracing it."""

    value: Any


jax.tree_util.register_static(Static)


def device_maps(structure, dtype) -> Dict[str, Any]:
    """Move a BlockStructure's tables into a pytree of device arrays."""
    buckets = []
    for bi, bk in enumerate(structure.buckets):
        buckets.append(
            dict(
                gather_idx=jnp.asarray(bk.gather_idx),
                gather_scale=jnp.asarray(np.asarray(bk.gather_scale, dtype=dtype)),
                pool_pos=jnp.asarray(bk.pool_pos),
                out_scale=jnp.asarray(np.asarray(bk.out_scale, dtype=dtype)),
                # Pool layout: where this bucket's flattened tensor lives in
                # the pool vector, and the 0/1 padding mask that keeps eigh
                # round-off from leaking into padded positions.
                base=Static(int(structure.bucket_base[bi])),
                n=Static(int(bk.n)),
                count=Static(int(bk.count)),
                # Per-block norm equalization tables (packed buckets only):
                # projection is positively homogeneous, so scaling each real
                # block to unit Frobenius norm before the super-matrix
                # projection and back is exact, and keeps packmates with
                # wildly different norms relatively accurate in f32.
                packed=Static(bool(bk.packed)),
                n_groups=Static(int(bk.n_groups)),
                diag_group=jnp.asarray(
                    np.where(bk.diag_blkid >= 0, bk.diag_blkid, bk.n_groups),
                    jnp.int32,
                ),
                pad_mask=jnp.asarray(np.asarray(bk.gather_scale != 0.0, dtype=dtype)),
                pool_pos_global=jnp.asarray(
                    bk.pool_pos + structure.bucket_base[bi]
                ),
            )
        )
    return dict(
        buckets=buckets,
        free_pos=jnp.asarray(structure.free_pos),
        inv_perm=jnp.asarray(structure.inv_perm),
        free_base=Static(int(structure.free_base)),
        pool_len=Static(int(structure.pool_len)),
        vec_len=Static(int(structure.vec_len)),
    )


def svec_to_blocks(X: jax.Array, maps: Dict[str, Any]) -> List[jax.Array]:
    """Scatter svec X into per-bucket (count, n, n) symmetric tensors.

    Off-diagonal entries are scaled by 1/sqrt(2); padded entries are zero
    (the gather tables point padding at a trailing sentinel).
    """
    X_ext = jnp.concatenate([X, jnp.zeros((1,), X.dtype)])
    return [X_ext[bm["gather_idx"]] * bm["gather_scale"] for bm in maps["buckets"]]


def blocks_to_svec(
    block_tensors: Sequence[jax.Array], X: jax.Array, maps: Dict[str, Any]
) -> jax.Array:
    """Gather per-bucket tensors (plus free entries taken from X) back into
    svec form, restoring the sqrt(2) off-diagonal scale."""
    parts = [
        bt.reshape(-1)[bm["pool_pos"]] * bm["out_scale"]
        for bt, bm in zip(block_tensors, maps["buckets"])
    ]
    if maps["free_pos"].shape[0]:
        parts.append(X[maps["free_pos"]])
    all_vals = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    return all_vals[maps["inv_perm"]]


# ---------------------------------------------------------------------------
# Pool layout: the hot loop's representation. A "pool" vector is the flat
# concatenation of every bucket's (count, n, n) dense symmetric tensor plus
# the free entries; off-diagonals store x_svec/sqrt(2) at both mirrored
# positions, making pool-space dots and 2-norms equal svec-space ones. These
# two converters run only at solve boundaries (init / readout), never per
# iteration.
# ---------------------------------------------------------------------------


def pool_from_svec(X: jax.Array, maps: Dict[str, Any]) -> jax.Array:
    """svec -> pool coordinates (one boundary-time gather)."""
    X_ext = jnp.concatenate([X, jnp.zeros((1,), X.dtype)])
    parts = [
        (X_ext[bm["gather_idx"]] * bm["gather_scale"]).reshape(-1)
        for bm in maps["buckets"]
    ]
    if maps["free_pos"].shape[0]:
        parts.append(X[maps["free_pos"]])
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts)


def svec_from_pool(P: jax.Array, maps: Dict[str, Any]) -> jax.Array:
    """pool -> svec coordinates (one vec_len-sized gather)."""
    parts = [
        P[bm["pool_pos_global"]] * bm["out_scale"] for bm in maps["buckets"]
    ]
    if maps["free_pos"].shape[0]:
        fb = maps["free_base"].value
        parts.append(P[fb : fb + maps["free_pos"].shape[0]])
    all_vals = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    return all_vals[maps["inv_perm"]]
