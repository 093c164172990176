"""Calibrated projection-method dispatch.

Analog of the reference's ``is_large_mat`` heuristic
(reference: src/matrix_sizes.cu:14-19), which was derived from an 820-point
committed sweep of single-QR-on-streams vs batched-Jacobi timings
(test/output/single_batched_comparison.txt +
plots/single_batched_comparison.ipynb). Here the two candidate methods are
XLA's batched ``eigh`` and the matmul-only polynomial sign filter
(ops/polyfilter.py); the committed sweep (benchmarks/eig_sweep.py ->
cuadmm_jax/data/eig_sweep_<backend>_<dtype>.jsonl) measures both per
(block size, batch count) point, and ``choose_methods`` picks the faster
method per bucket by nearest-neighbor lookup in log space.

If no calibration table exists for the current backend/dtype the caller
falls back to the uncalibrated default, ``eigh``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Tuple

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def load_sweep(backend: str, dtype_name: str) -> Optional[List[dict]]:
    path = os.path.join(_DATA_DIR, f"eig_sweep_{backend}_{dtype_name}.jsonl")
    if not os.path.exists(path):
        return None
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows or None


def _nearest(rows: List[dict], n: int, batch: int) -> dict:
    """Nearest sweep point in (log n, log batch) space."""
    ln, lb = math.log(max(n, 1)), math.log(max(batch, 1))

    def d(r):
        return (math.log(r["n"]) - ln) ** 2 + (math.log(max(r["batch"], 1)) - lb) ** 2

    return min(rows, key=d)


METHODS = ("eigh", "poly", "jacobi")


def choose_methods(
    buckets: List[Tuple[int, int]], backend: str, dtype_name: str
) -> Optional[Dict[int, str]]:
    """Per-bucket method ("eigh" | "poly" | "jacobi") from the committed
    sweep.

    ``buckets`` is [(n, count), ...] in bucket order (packed super-matrix
    size and batch count as they will actually be dispatched). Returns None
    when no calibration data is available.
    """
    rows = load_sweep(backend, dtype_name)
    if rows is None:
        return None
    out: Dict[int, str] = {}
    for i, (n, count) in enumerate(buckets):
        if n == 1:
            out[i] = "clamp"
            continue
        r = _nearest(rows, n, count)
        timed = {m: r[f"{m}_ms"] for m in METHODS if f"{m}_ms" in r}
        out[i] = min(timed, key=timed.get) if timed else "eigh"
    return out
