"""Device-mesh utilities for multi-chip solves.

Replacement for the reference's multi-GPU machinery: cuADMM
ships moment-matrix slices GPU0 -> GPUi with cudaMemcpyPeerAsync from
persistent host threads woken by condition variables every iteration
(reference: src/duo_solver.cu:269-295, :487-577; src/utils/check_gpus.cu:15-45).

Here the same data parallelism over cone blocks is expressed as sharding
annotations on the bucket tensors inside one SPMD program: XLA inserts the
all-gathers/reduce-scatters (NCCL over NVLink on GPUs), and there is no
host control plane at all. Scalar reductions (residual norms, inner products) are jnp reductions
over sharded arrays -- XLA lowers them to psum collectives.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BLOCK_AXIS = "blocks"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh over the block-batch axis.

    The axis follows the algorithm alone: the cards of one host are
    joined all to all, so device order does not matter.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (BLOCK_AXIS,))


def shard_blocks(
    x: jax.Array, mesh: Optional[Mesh], inner_if_few: bool = False
) -> jax.Array:
    """Constrain a (count, n, n) bucket tensor to be sharded over its batch
    axis.

    When the bucket has fewer blocks than devices (the quasar-500 profile:
    ONE 2004x2004 moment block, reference examples/plato/logs/quasar-500.log)
    batch sharding is a no-op; with ``inner_if_few`` we instead shard the
    *row* axis of each block. That only pays off for projection methods
    that are pure matmuls (the polynomial filter): XLA's SPMD partitioner
    splits each GEMM spatially and joins the parts with reduce-scatters,
    for a block that is too big for one device's speed. For
    eigh-based projection XLA would just all-gather, so leave it alone.
    """
    if mesh is None or mesh.size <= 1:
        return x
    if x.shape[0] >= mesh.size:
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, P(BLOCK_AXIS, None, None))
        )
    if inner_if_few and x.shape[1] >= 2 * mesh.size:
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, P(None, BLOCK_AXIS, None))
        )
    return x


def shard_pool(x: jax.Array, mesh: Optional[Mesh]) -> jax.Array:
    """Constrain a flat pool-coordinate state vector to be sharded 1-D over
    the mesh, so the per-iteration vector algebra (X/S updates, residual
    norms) is distributed too, not just the projection. XLA lowers the
    norm/dot reductions over the sharded axis to psum collectives --
    the SPMD counterpart of the reference shipping every moment slice back
    to GPU0 before reducing on the host (src/duo_solver.cu:545-564)."""
    if mesh is None or mesh.size <= 1:
        return x
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, P(BLOCK_AXIS)))


def replicated(x: jax.Array, mesh: Optional[Mesh]) -> jax.Array:
    if mesh is None or mesh.size <= 1:
        return x
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, P()))
