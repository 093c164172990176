"""SeDuMi-format importer.

Replaces the reference's MATLAB conversion chain sedumi -> SDPT3 -> TXT
(reference: examples/sedumi_to_txt.m:1-31, examples/utils/read_sedumi.m),
importing directly into a :class:`Problem`.

SeDuMi encodes ``min c'x s.t. Ax = b, x in K`` with x the concatenation of
cone sections in the fixed order [f (free), l (nonneg), q (second-order),
s (PSD, each block stored as a FULL n^2 column-major matrix)].

Mapping: 'f' -> one 'u' block; 'l' -> n 1x1 's' blocks; each 's' block ->
an 's' block with the full matrix symmetrized into svec ((M+M')/2, off-diag
* sqrt(2)). Second-order cones are not supported (same as the reference).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import scipy.sparse as sp

from cuadmm_jax.io.conewise import SQRT2
from cuadmm_jax.problem import Problem


def _as_int_list(x) -> List[int]:
    if x is None:
        return []
    arr = np.atleast_1d(np.asarray(x)).ravel()
    return [int(v) for v in arr if int(v) > 0] if arr.size else []


def _as_scalar(x) -> int:
    if x is None:
        return 0
    arr = np.atleast_1d(np.asarray(x)).ravel()
    return int(arr[0]) if arr.size else 0


def sedumi_to_problem(A, b, c, K, name: str = "sedumi") -> Problem:
    """Convert SeDuMi data (A or At, b, c, K struct/dict) to a Problem."""
    if hasattr(K, "_fieldnames"):  # scipy.io mat_struct
        get = lambda f: getattr(K, f, None) if f in K._fieldnames else None
    elif isinstance(K, dict):
        get = K.get
    else:
        raise TypeError("K must be a dict or scipy.io mat_struct")

    Kf = _as_scalar(get("f"))
    Kl = _as_scalar(get("l"))
    Kq = _as_int_list(get("q"))
    Kr = _as_int_list(get("r"))
    Ks = _as_int_list(get("s"))
    if Kq or Kr:
        raise NotImplementedError("second-order/rotated cones are not supported")

    A = sp.csc_matrix(A)
    # b/c may be stored sparse in MATLAB archives (e.g. plato/taha1a.mat).
    b = (
        np.asarray(b.todense()) if sp.issparse(b) else np.asarray(b, dtype=np.float64)
    ).astype(np.float64).ravel()
    c = (
        np.asarray(c.todense()) if sp.issparse(c) else np.asarray(c, dtype=np.float64)
    ).astype(np.float64).ravel()
    n_cols = Kf + Kl + sum(n * n for n in Ks)
    if A.shape[1] != n_cols:
        if A.shape[0] == n_cols:  # caller passed At
            A = A.T.tocsc()
        else:
            raise ValueError(
                f"A has {A.shape[1]} columns, expected {n_cols} from K"
            )
    con_num = A.shape[0]
    if len(b) != con_num:
        raise ValueError("b length does not match A rows")

    # Build the sedumi-column -> (svec-position, scale) maps.
    blk: List[Tuple[str, int]] = []
    col_pos = np.empty(n_cols, dtype=np.int64)
    col_scale = np.empty(n_cols, dtype=np.float64)
    cursor = 0
    svec_off = 0
    if Kf:
        blk.append(("u", Kf))
        col_pos[cursor : cursor + Kf] = svec_off + np.arange(Kf)
        col_scale[cursor : cursor + Kf] = 1.0
        cursor += Kf
        svec_off += Kf
    if Kl:
        blk.extend([("s", 1)] * Kl)
        col_pos[cursor : cursor + Kl] = svec_off + np.arange(Kl)
        col_scale[cursor : cursor + Kl] = 1.0
        cursor += Kl
        svec_off += Kl
    for n in Ks:
        blk.append(("s", n))
        idx = np.arange(n * n)
        i = idx % n  # row (column-major storage)
        j = idx // n
        k = np.maximum(i, j)
        l = np.minimum(i, j)
        col_pos[cursor : cursor + n * n] = svec_off + k * (k + 1) // 2 + l
        # Symmetrization: both (i,j) and (j,i) columns contribute half;
        # svec carries sqrt(2) off-diagonal.
        col_scale[cursor : cursor + n * n] = np.where(i == j, 1.0, SQRT2 / 2.0)
        cursor += n * n
        svec_off += n * (n + 1) // 2
    vec_len = svec_off

    # Map A (con x n_cols) -> At (vec_len x con) svec triplets, merging
    # symmetric duplicates.
    Acoo = A.tocoo()
    at = sp.csc_matrix(
        (Acoo.data * col_scale[Acoo.col], (col_pos[Acoo.col], Acoo.row)),
        shape=(vec_len, con_num),
    )
    at.sum_duplicates()
    at_coo = at.tocoo()

    c_vec = np.zeros(vec_len)
    np.add.at(c_vec, col_pos, c * col_scale)

    rows = at_coo.row.astype(np.int32)
    cols = at_coo.col.astype(np.int32)
    vals = at_coo.data
    order = np.lexsort((rows, cols))
    b_idx = np.nonzero(b)[0].astype(np.int32)
    C_idx = np.nonzero(c_vec)[0].astype(np.int32)
    return Problem(
        blk=blk,
        con_num=con_num,
        At_rows=rows[order],
        At_cols=cols[order],
        At_vals=vals[order],
        b_indices=b_idx,
        b_vals=b[b_idx],
        C_indices=C_idx,
        C_vals=c_vec[C_idx],
        name=name,
    )


def load_sedumi_mat(path: str, name: str = "") -> Problem:
    """Load a SeDuMi problem from a .mat file with fields A/At, b, c, K."""
    import scipy.io as sio

    m = sio.loadmat(path, squeeze_me=True, struct_as_record=False)
    A = m.get("A", m.get("At", None))
    if A is None:
        raise ValueError(f"{path}: no A or At field")
    if "A" not in m:
        A = A.T
    return sedumi_to_problem(
        A, m["b"], m["c"], m["K"], name=name or path.rsplit("/", 1)[-1]
    )
