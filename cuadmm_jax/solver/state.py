"""Solver state pytree and solve parameters.

The reference keeps its iteration state as ~40 mutable device buffers on
the SDPSolver object (reference: include/cuadmm/solver.h:40-170). Here the
whole state is one immutable pytree so a full sGS-ADMM iteration is a pure
function jitted end-to-end, checkpointable, and shardable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp

from cuadmm_jax.ops.chol import NormalEqSolver
from cuadmm_jax.ops.sparse import SparseA


@dataclasses.dataclass
class SolverState:
    """Everything that evolves across iterations (scaled space).

    Scalar metrics (errRp/errRd/pobj/dobj/relgap) are in *original*
    (unscaled) units, exactly like the reference's info arrays
    (reference: src/solver.cu:771-779).
    """

    X: jax.Array
    y: jax.Array
    S: jax.Array
    SmC: jax.Array  # S - C cache (reference: solver.cu:671-674)
    Rp: jax.Array  # b - A X cache (reference: solver.cu:763-768)
    sig: jax.Array
    errRp: jax.Array
    errRd: jax.Array
    pobj: jax.Array
    dobj: jax.Array
    relgap: jax.Array
    maxfeas: jax.Array
    prim_win: jax.Array
    dual_win: jax.Array
    it: jax.Array  # completed iterations
    sig_stage_2: jax.Array  # halved at the ADMM switch (solver.cu:683)
    sigscale: jax.Array  # scaled by 1.23 at the switch (solver.cu:684)
    best_kkt: jax.Array
    X_best: jax.Array
    y_best: jax.Array
    S_best: jax.Array


jax.tree_util.register_dataclass(
    SolverState,
    data_fields=[f.name for f in dataclasses.fields(SolverState)],
    meta_fields=[],
)


@dataclasses.dataclass
class SolveParams:
    """Problem-constant device data threaded through the jitted step."""

    sparse_a: SparseA
    maps: Dict[str, Any]
    neq: NormalEqSolver
    b: jax.Array  # dense, scaled
    C: jax.Array  # dense, scaled
    normA: jax.Array
    bscale: jax.Array
    Cscale: jax.Array
    objscale: jax.Array
    norm_borg: jax.Array
    norm_Corg: jax.Array


jax.tree_util.register_dataclass(
    SolveParams,
    data_fields=[f.name for f in dataclasses.fields(SolveParams)],
    meta_fields=[],
)

# Info row layout (reference info arrays: include/cuadmm/solver.h:148-156).
INFO_FIELDS = ("pobj", "dobj", "errRp", "errRd", "relgap", "sig", "bscale", "Cscale")
