"""SDPA sparse-format (.dat-s) importer.

Replaces the reference's MATLAB sdpa_to_txt chain
(reference: examples/sdpa_to_txt.m, examples/utils/read_sdpa.m -- SDPT3's
reader). The SDPA file encodes

  (D): min c'x  s.t.  sum_j x_j F_j - F0 >= 0

and the SDPT3/cuADMM convention imports its conic standard form with all
data negated (read_sdpa.m:87 ``b = -b`` and the ``-sparse(...)`` matrix
assembly at read_sdpa.m:156-219):

  min <-F0, X>  s.t.  <F_j, X> = -c_j,  X >= 0.

Negative block sizes are diagonal (LP) blocks; each diagonal entry becomes
a 1x1 's' block, matching the reference TXT exports (e.g.
examples/plato/TXT/trto5/blk.txt).
"""

from __future__ import annotations

import gzip
from typing import List, Tuple

import numpy as np
import scipy.sparse as sp

from cuadmm_jax.io.conewise import SQRT2
from cuadmm_jax.problem import Problem


def _tokenize(path: str) -> List[str]:
    opener = gzip.open if path.endswith(".gz") else open
    lines = []
    with opener(path, "rt") as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith('"') or s.startswith("*"):
                continue
            # SDPA allows punctuation ({},();) as separators.
            for ch in "{}(),;":
                s = s.replace(ch, " ")
            lines.append(s)
    return lines


def load_sdpa(path: str, name: str = "") -> Problem:
    lines = _tokenize(path)
    toks: List[str] = []
    for s in lines:
        toks.extend(s.split())
    it = iter(toks)

    m = int(float(next(it)))
    nblocks = int(float(next(it)))
    sizes = [int(float(next(it))) for _ in range(nblocks)]
    cvec = np.array([float(next(it)) for _ in range(m)])

    # Remaining tokens: 5-tuples (matno, blkno, i, j, val).
    rest = np.array(list(it), dtype=np.float64)
    if rest.size % 5:
        raise ValueError(f"{path}: trailing entry count not divisible by 5")
    ent = rest.reshape(-1, 5)

    # Block layout: declared order; negative size n -> |n| 1x1 blocks.
    blk: List[Tuple[str, int]] = []
    blk_svec_off = []  # svec offset of each declared SDPA block
    blk_is_diag = []
    off = 0
    for n in sizes:
        blk_svec_off.append(off)
        if n >= 0:
            blk.append(("s", n))
            blk_is_diag.append(False)
            off += n * (n + 1) // 2
        else:
            blk.extend([("s", 1)] * (-n))
            blk_is_diag.append(True)
            off += -n
    vec_len = off
    blk_svec_off = np.asarray(blk_svec_off)

    matno = ent[:, 0].astype(int)
    blkno = ent[:, 1].astype(int) - 1
    ii = ent[:, 2].astype(int) - 1
    jj = ent[:, 3].astype(int) - 1
    vv = ent[:, 4]
    k = np.maximum(ii, jj)
    l = np.minimum(ii, jj)
    is_diag_blk = np.asarray(blk_is_diag)[blkno]
    pos = np.where(
        is_diag_blk,
        blk_svec_off[blkno] + k,  # diagonal block: entry (k,k)
        blk_svec_off[blkno] + k * (k + 1) // 2 + l,
    )
    if np.any(is_diag_blk & (k != l)):
        raise ValueError(f"{path}: off-diagonal entry in a diagonal block")
    # read_sdpa negates all matrices; off-diagonal entries carry sqrt(2).
    sv = np.where(k == l, -vv, -vv * SQRT2)

    cost = matno == 0
    C_vec = np.zeros(vec_len)
    np.add.at(C_vec, pos[cost], sv[cost])

    at = sp.csc_matrix(
        (sv[~cost], (pos[~cost], matno[~cost] - 1)), shape=(vec_len, m)
    )
    at.sum_duplicates()
    at_coo = at.tocoo()
    rows = at_coo.row.astype(np.int32)
    cols = at_coo.col.astype(np.int32)
    vals = at_coo.data
    order = np.lexsort((rows, cols))

    b = -cvec  # read_sdpa.m:87
    b_idx = np.nonzero(b)[0].astype(np.int32)
    C_idx = np.nonzero(C_vec)[0].astype(np.int32)
    return Problem(
        blk=blk,
        con_num=m,
        At_rows=rows[order],
        At_cols=cols[order],
        At_vals=vals[order],
        b_indices=b_idx,
        b_vals=b[b_idx],
        C_indices=C_idx,
        C_vals=C_vec[C_idx],
        name=name or path.rsplit("/", 1)[-1],
    )
