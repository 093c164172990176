"""Factorization-free PSD projection via composite polynomial filtering.

Pi(X) = (X + sign(X) X) / 2, with sign(X) approximated by a fixed
composition of odd degree-5 polynomials evaluated as batched matmuls --
every FLOP is a matmul, no eigendecomposition at all. This replaces
the reference's entire two-path eig machinery (per-matrix Xsyevd on CUDA
streams + DsyevjBatched; reference: src/solver.cu:531-647,
include/cuadmm/cusolver.h:18-171) for the projection step. The technique
follows the composite-filter idea of arXiv:2507.09165 (Polynomial
Filtering) / arXiv:2505.16932 (Polar Express); the coefficient schedules
below are our own, computed by per-step linear minimax programs
(benchmarks/sign_schedule_opt.py):

- inflation steps maximize the image lower bound of [l, u] subject to
  p([0, u]) in [0, 1.2];
- polish steps minimize max |p(y) - 1| over the current interval.

Accuracy (validated on a 1e-12..1 log grid): with spectrum scaled into
[-1, 1], eigenvalues of magnitude >= l0 get sign error < 3e-15 (f64
schedule, l0=1e-6) / < 3e-7 (f32 schedule, l0=1e-4); the resulting
projection error is bounded by ~l0/2 * scale -- comparable to the
reference's batched-Jacobi tolerance (1e-6, cusolver.h:112-114).

Cost per filter step: 3 batched (n, n) matmuls. The whole projection is
3*steps + 1 matmuls over the bucket's (count, n, n) tensor.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

# Schedules: tuples of (a, b, c) with p(y) = a y + b y^3 + c y^5.
# Spectrum is assumed scaled into [-1, 1] (see psd_project_poly).

# Contraction safety (a round-2 divergence): the original
# tables bounded each step's image by exactly 1.2 with p(1.2) = 1.2 attained
# at the edge -- a repelling fixed point with slope ~13.  A +1.8e-6
# eigenvalue overshoot from matmul round-off (an accumulation that rounds
# the boundary point *up*, where CPU FMA rounds it *down*)
# amplified ~13x per filter step: 13^8 * 1.8e-6 ~ 1e2 by step 8, 3.5e9 by
# step 9 -- the exact errRp_first ~ 9.3e8 signature.  The schedules below
# are regenerated with image bound U = 1.19 certified on the mu=1e-3
# -inflated interval [0, 1.2*(1+mu)], so the invariant interval is a strict
# contraction under per-step spectral overshoot; adversarially validated
# (per-step +1e-5 eigenvalue injection) to stay <= 1.19001 forever.

# l0 = 1e-4, 9 steps; f32-safe (sign err 1.2e-7 in f32 arithmetic).
SIGN_SCHEDULE_F32: Tuple[Tuple[float, float, float], ...] = (
    (5.06047547263284869, -14.99362338586087162, 11.10746479402847875),
    (4.25120419845484410, -8.88976190955811951, 4.64979926111216368),
    (4.24571098539345027, -8.85721646226934034, 4.62959100189469730),
    (4.22236221862099459, -8.71977786520939802, 4.54432714133642790),
    (4.12275283299936568, -8.14952734821208402, 4.19191420784630875),
    (3.72058281932766732, -6.10090498086843347, 2.94788819441030192),
    (2.30294699725781049, -2.07561612521402372, 0.74862622025722247),
    (1.87590301995105002, -1.25100299068303422, 0.37510031404681154),
    (0.00000000000000000, 2.49999430934171984, -1.49999430768382047),
)

# l0 = 1e-6, 13 steps; final sign error 2.2e-16 in f64.
SIGN_SCHEDULE_F64: Tuple[Tuple[float, float, float], ...] = (
    (5.06094475801049359, -14.99756667466204796, 11.11093279514654597),
    (4.25288216574223910, -8.89971842980909145, 4.65598243456068328),
    (4.25282998115375843, -8.89940878282711090, 4.65579013835168354),
    (4.25260782639308221, -8.89809058639797001, 4.65497151521643282),
    (4.25166151183467633, -8.89247545825870844, 4.65148442209067348),
    (4.24763473434524208, -8.86860530927969215, 4.63666207529563934),
    (4.23052068487935529, -8.76763876835256006, 4.57400543139323368),
    (4.15780256493974854, -8.34723344775049902, 4.31384066587466553),
    (3.85649202718224737, -6.74910730373869772, 3.33720851459665591),
    (2.92318240820907116, -3.11041421885981695, 1.23637796668017064),
    (1.68172025850201989, -0.89906693481348410, 0.21538884141076403),
    (1.88332354894469689, -1.26664670669541635, 0.38332315678453022),
    (1.87500000000000000, -1.25000000000000000, 0.37500000000000000),
)

_HI = jax.lax.Precision.HIGHEST


def _bmm(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.einsum(
        "...ij,...jk->...ik", a, b, precision=_HI, preferred_element_type=a.dtype
    )


def default_schedule(dtype) -> Tuple[Tuple[float, float, float], ...]:
    return (
        SIGN_SCHEDULE_F64 if jnp.dtype(dtype) == jnp.float64 else SIGN_SCHEDULE_F32
    )


def matrix_sign(
    mats: jax.Array,
    schedule: Optional[Sequence[Tuple[float, float, float]]] = None,
) -> jax.Array:
    """Approximate sign(X) for symmetric X with spectrum in [-1, 1].

    Each step evaluates p(Y) = Y (a I + b A + c A^2), A = Y^2 -- three
    batched matmuls. Symmetry is restored after every step (numerical
    drift otherwise compounds through the composition).
    """
    if schedule is None:
        schedule = default_schedule(mats.dtype)
    eye = jnp.eye(mats.shape[-1], dtype=mats.dtype)
    y = mats
    for a, b, c in schedule:
        a2 = _bmm(y, y)
        if c == 0.0:
            poly = a * eye + b * a2
        else:
            poly = a * eye + b * a2 + c * _bmm(a2, a2)
        y = _bmm(y, poly)
        y = 0.5 * (y + jnp.swapaxes(y, -1, -2))
    return y


def spectral_scale(mats: jax.Array) -> jax.Array:
    """Cheap per-matrix upper bound on the spectral norm: min of the
    Frobenius norm and the infinity norm (max absolute row sum); both
    dominate |lambda|_max for symmetric matrices."""
    ab = jnp.abs(mats)
    fro = jnp.sqrt(jnp.sum(mats * mats, axis=(-1, -2)))
    inf = jnp.max(jnp.sum(ab, axis=-1), axis=-1)
    s = jnp.minimum(fro, inf)
    return jnp.maximum(s, jnp.finfo(mats.dtype).tiny * 16)


def psd_project_poly(
    mats: jax.Array,
    schedule: Optional[Sequence[Tuple[float, float, float]]] = None,
) -> jax.Array:
    """Project a batch of symmetric matrices onto the PSD cone, matmul-only.

    Exact for block-diagonal inputs blockwise (spectral functions factor
    over diagonal blocks), so it composes with BlockStructure's diagonal
    packing. Zero padding rows/columns stay exactly zero: every filter
    polynomial is odd, so p(0) = 0.
    """
    s = spectral_scale(mats)[..., None, None]
    y0 = mats / s
    z = matrix_sign(y0, schedule)
    p = y0 + _bmm(z, y0)
    p = 0.5 * (p + jnp.swapaxes(p, -1, -2))  # symmetrize (z y0 drift)
    return 0.5 * s * p
