"""Mesh-sharded block-triangular solves: the multi-device normal-equation
path for con_num past single-device packed storage.

Single-device coverage ends where the packed f32 factor (~2 n^2 bytes,
ops/tri_stream.py) no longer fits next to the solver state. Past that
(PlanarHand N=10: 484k constraints) the factor has to be distributed
over a mesh. This module implements the
sharded forward/backward substitution with the factor's block-COLUMNS
sharded across devices (the analog of the reference's multi-GPU moment
split, duo_solver.cu:269-295, but for the normal solve, which the
reference never distributes -- CHOLMOD is host-only there):

- forward (L x = r): at block-row i, every device reduces its local
  column contributions; one psum per row assembles the row residual; the
  diagonal owner applies inv(L_ii) and the result is psum-broadcast.
- backward (L^T y = t): right-looking -- once y_j is known, row j's
  tiles (spread over column owners) update the running residual in
  parallel; one psum per step merges the deltas.

Storage here is the full (nb, nb) tile grid sharded on the column axis
(zeros above the diagonal, diagonal tiles inverted) -- simple and
dryrun-friendly; a production deployment packs each device's column set
(halving memory) and uses reduce_scatter instead of full psums.
Correctness is checked on the virtual CPU mesh (tests/test_parallel.py)
and on four GPUs by ``chip_smoke.py --four``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def square_tiles_from_packed(tiles: np.ndarray, lay) -> np.ndarray:
    """(nb, nb, B, B) full tile grid from packed storage (host-side):
    zeros above the diagonal; diagonal tiles stay inverted."""
    from cuadmm_jax.ops.tri_stream import tid

    nb, B = lay.nb, lay.block
    out = np.zeros((nb, nb, B, B), tiles.dtype)
    for i in range(nb):
        for j in range(i + 1):
            out[i, j] = tiles[tid(i, j)]
    return out


def shard_factor(square_tiles: np.ndarray, mesh: Mesh, axis: str = "blocks"):
    """Place the (nb, nb, B, B) grid with block-columns sharded."""
    return jax.device_put(
        square_tiles, NamedSharding(mesh, P(None, axis, None, None))
    )


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def sharded_tri_solve(grid: jax.Array, r: jax.Array, mesh: Mesh, axis: str = "blocks"):
    """y = (L L^T)^{-1} r with the tile grid column-sharded over ``axis``.

    ``grid``: (nb, nb, B, B), lower tiles of L with inverted diagonals,
    sharded P(None, axis). ``r``: (nb*B,) replicated.
    """
    nb, _, B, _ = grid.shape
    D = mesh.shape[axis]
    ncl = nb // D  # local columns per device (nb must divide evenly)

    def body(local, rloc):
        # local: (nb, ncl, B, B); rloc: (nb, B) replicated
        me = jax.lax.axis_index(axis)
        jglob = me * ncl + jnp.arange(ncl)  # contiguous column slab

        hi = jax.lax.Precision.HIGHEST

        def fwd_row(x, i):
            # Local partial: sum_j<i L[i,j] @ x[j] over my columns.
            mask = (jglob < i).astype(local.dtype)  # (ncl,)
            xj = x[jnp.minimum(jglob, nb - 1)]  # (ncl, B)
            part = jnp.einsum(
                "cab,cb,c->a", local[i], xj, mask, precision=hi
            )
            tot = jax.lax.psum(part, axis)
            acc = rloc[i] - tot
            own = (i // ncl) == me
            il = jnp.where(own, i % ncl, 0)
            dinv = local[i, il]  # inv(L_ii) on the owner
            xi_local = jnp.where(
                own,
                jnp.einsum("ab,b->a", dinv, acc, precision=hi),
                jnp.zeros((B,), local.dtype),
            )
            xi = jax.lax.psum(xi_local, axis)
            return x.at[i].set(xi), None

        x0 = jnp.zeros((nb, B), local.dtype)
        x, _ = jax.lax.scan(fwd_row, x0, jnp.arange(nb))

        def bwd_step(carry, jrev):
            t, y = carry
            j = nb - 1 - jrev
            own = (j // ncl) == me
            jl = jnp.where(own, j % ncl, 0)
            dinv = local[j, jl]
            yj_local = jnp.where(
                own,
                jnp.einsum("ba,b->a", dinv, t[j], precision=hi),  # inv^T
                jnp.zeros((B,), local.dtype),
            )
            yj = jax.lax.psum(yj_local, axis)
            # Right-looking: t_i -= L[j, i]^T y_j for my columns i < j.
            mask = (jglob < j).astype(local.dtype)
            deltas = jnp.einsum(
                "cab,a,c->cb", local[j], yj, mask, precision=hi
            )  # (ncl, B): contribution to t at my columns
            full = jnp.zeros((nb, B), local.dtype).at[
                jnp.minimum(jglob, nb - 1)
            ].add(deltas * mask[:, None])
            t = t - jax.lax.psum(full, axis)
            return (t, y.at[j].set(yj)), None

        t0 = x
        y0 = jnp.zeros((nb, B), local.dtype)
        (tf, y), _ = jax.lax.scan(bwd_step, (t0, y0), jnp.arange(nb))
        return y

    rr = r.reshape(nb, B)
    y = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, axis, None, None), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )(grid, rr)
    return y.reshape(nb * B)


# ----------------------------------------------------------------------
# Sharded factorization + normal-solver integration (round 5).
#
# The round-4 module only SOLVED with a pre-sharded factor; the factor
# itself had to exist somewhere, which capped problems at single-device
# memory. This section adds the distributed right-looking blocked Cholesky
# (ScaLAPACK-style: the column owner factors/scales, one psum broadcasts
# the scaled panel, every device rank-updates its own column slab), so a
# mesh can factor AND solve systems no single chip could hold. The
# reference never distributes its normal solve at all (CHOLMOD is
# host-only, src/solver.cu:91-96; the duo solver only splits the moment
# eig, duo_solver.cu:269-295).
# ----------------------------------------------------------------------


def make_grid_layout(n: int, n_dev: int, block: int = 1024):
    """(nb, n_pad) with nb a multiple of the mesh axis size."""
    nb = -(-n // block)
    nb = -(-nb // n_dev) * n_dev
    return nb, nb * block


def sharded_scatter_aat(
    aat, n: int, nb: int, block: int, mesh: Mesh, axis: str = "blocks",
    eps: float = 1e-5, diag_mean: float = 1.0, dtype=np.float32,
):
    """Column-sharded (nb, nb, B, B) lower-triangular grid of
    AA^T + eps*scale*I, built one device slab at a time (host peak =
    one slab, not the whole grid). ``aat`` is the host scipy matrix."""
    import scipy.sparse as sp

    csc = sp.csc_matrix(aat)
    B = block
    n_pad = nb * B
    D = mesh.shape[axis]
    ncl = nb // D
    scale = max(float(diag_mean), 1.0)

    def cb(index):
        # index: global slice tuple for this shard; axis 1 is the
        # sharded block-column axis.
        j0 = index[1].start or 0
        c0, c1 = j0 * B, (j0 + ncl) * B
        w = c1 - c0
        slab = np.zeros((n_pad, w), dtype)
        cols = csc[:, c0:min(c1, n)]
        dslab = np.asarray(cols.todense(), dtype)
        slab[: dslab.shape[0], : dslab.shape[1]] = dslab
        # diagonal regularization + unit padding diagonal
        for c in range(c0, c1):
            if c < n:
                slab[c, c - c0] += eps * scale
            else:
                slab[c, c - c0] = 1.0
        # keep the lower triangle only (zero strictly-above-diagonal)
        rows = np.arange(n_pad)[:, None]
        colsg = np.arange(c0, c1)[None, :]
        slab[rows < colsg] = 0.0
        return np.ascontiguousarray(
            slab.reshape(nb, B, ncl, B).transpose(0, 2, 1, 3)
        )

    return jax.make_array_from_callback(
        (nb, nb, B, B),
        NamedSharding(mesh, P(None, axis, None, None)),
        cb,
    )


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def sharded_cholesky(grid: jax.Array, mesh: Mesh, axis: str = "blocks"):
    """Distributed right-looking blocked Cholesky of the column-sharded
    lower grid; diagonal tiles come out INVERTED (what sharded_tri_solve
    consumes). One psum broadcast of the scaled column panel per step;
    each device rank-updates only its own column slab."""
    nb, _, B, _ = grid.shape
    D = mesh.shape[axis]
    ncl = nb // D

    def body(local):  # (nb, ncl, B, B)
        me = jax.lax.axis_index(axis)
        jglob = me * ncl + jnp.arange(ncl)
        hi = jax.lax.Precision.HIGHEST
        eye = jnp.eye(B, dtype=local.dtype)
        rows = jnp.arange(nb)

        def step(loc, k):
            own = (k // ncl) == me
            kl = jnp.where(own, k % ncl, 0)
            colk = jnp.where(
                own,
                jax.lax.dynamic_index_in_dim(loc, kl, 1, keepdims=False),
                jnp.zeros((nb, B, B), loc.dtype),
            )
            colk = jax.lax.psum(colk, axis)  # (nb, B, B) current column k
            dkk = colk[k]
            dkk = jnp.tril(dkk) + jnp.tril(dkk, -1).T
            lkk = jnp.linalg.cholesky(dkk)
            ikk = jax.scipy.linalg.solve_triangular(lkk, eye, lower=True)
            rmask = (rows > k).astype(loc.dtype)[:, None, None]
            # L[i,k] = A[i,k] @ inv(L_kk)^T for i > k
            panel = jnp.einsum(
                "iab,cb->iac", colk * rmask, ikk, precision=hi
            )
            newcol = panel.at[k].set(ikk)
            loc = jnp.where(
                own,
                jax.lax.dynamic_update_index_in_dim(loc, newcol, kl, 1),
                loc,
            )
            # trailing update on my columns j > k, rows i >= j
            cmask = (jglob > k).astype(loc.dtype)
            imask = (rows[:, None] >= jglob[None, :]).astype(loc.dtype)
            lj = panel[jnp.minimum(jglob, nb - 1)]  # (ncl, B, B)
            upd = jnp.einsum("iab,jcb->ijac", panel, lj, precision=hi)
            loc = loc - upd * (cmask[None, :] * imask)[:, :, None, None]
            return loc, None

        loc, _ = jax.lax.scan(step, local, jnp.arange(nb))
        return loc

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, axis, None, None),),
        out_specs=P(None, axis, None, None),
        check_vma=False,
    )(grid)
