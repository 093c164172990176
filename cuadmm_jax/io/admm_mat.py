"""Loader for cuADMM-layout ``.mat`` files ({At, b, C} in svec coordinates).

Several problems in the reference tree ship only a MATLAB archive whose
variables are *already* in the cuADMM svec layout produced by
``data_sdpt3_to_admmSDPcuda`` (reference: examples/sedumi_to_txt.m:42-50):
``At`` is (vec_len, con_num) sparse with off-diagonals scaled by sqrt(2),
``b`` (con_num, 1) and ``C`` (vec_len, 1). The TXT export of e.g.
``plato/TXT/1dc.1024`` is incomplete (no C.txt), so this importer loads the
archive directly (reference: examples/plato/MATLAB/1dc.1024.mat).

The block structure is not stored in these files; callers pass ``blk``, or
we infer a single PSD block when vec_len is a triangular number n(n+1)/2
(exact for the single-block plato exports).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import scipy.io as sio
import scipy.sparse as sp

from cuadmm_jax.problem import Problem


def _infer_single_block(vec_len: int) -> List[Tuple[str, int]]:
    # n(n+1)/2 = vec_len  =>  n = (-1 + sqrt(1 + 8 vec_len)) / 2
    n = int((math.isqrt(8 * vec_len + 1) - 1) // 2)
    if n * (n + 1) // 2 != vec_len:
        raise ValueError(
            f"vec_len {vec_len} is not a triangular number; pass blk explicitly"
        )
    return [("s", n)]


def load_admm_mat(
    path: str,
    blk: Optional[List[Tuple[str, int]]] = None,
    name: Optional[str] = None,
) -> Problem:
    """Load a cuADMM-layout .mat archive into a :class:`Problem`."""
    m = sio.loadmat(path)
    if not all(k in m for k in ("At", "b", "C")):
        raise ValueError(f"{path}: expected variables At, b, C")
    At = sp.coo_matrix(m["At"])
    b = np.asarray(
        m["b"].todense() if sp.issparse(m["b"]) else m["b"], np.float64
    ).ravel()
    C = sp.coo_matrix(m["C"]) if sp.issparse(m["C"]) else sp.coo_matrix(
        np.asarray(m["C"], np.float64)
    )
    vec_len, con_num = At.shape
    if b.shape[0] != con_num:
        raise ValueError(f"{path}: b length {b.shape[0]} != con_num {con_num}")
    if blk is None:
        blk = _infer_single_block(vec_len)
    C_col = sp.coo_matrix(C.reshape((vec_len, 1)))
    # Constraint-major (col, row) triplet order, matching the reference's
    # COO_to_CSC output (src/utils/io.cu:203-257).
    order = np.lexsort((At.row, At.col))
    b_idx = np.nonzero(b)[0]
    return Problem(
        blk=blk,
        con_num=con_num,
        At_rows=At.row[order].astype(np.int64),  # svec index
        At_cols=At.col[order].astype(np.int64),  # constraint index
        At_vals=np.asarray(At.data[order], np.float64),
        b_indices=b_idx.astype(np.int64),
        b_vals=b[b_idx],
        C_indices=C_col.row.astype(np.int64),
        C_vals=np.asarray(C_col.data, np.float64),
        name=name or path.rsplit("/", 1)[-1].replace(".mat", ""),
    )
