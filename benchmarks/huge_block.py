"""Huge-single-block profile: the quasar-500 shape (one 2004x2004 PSD
block; reference log: examples/plato/logs/quasar-500.log, 0.2460 s/iter).

The reference's quasar-500 TXT export is incomplete (plato/TXT/quasar-500
has no At.txt), so the real problem cannot be loaded; this harness instead
measures the profile that dominates that log -- the per-iteration
2004x2004 PSD projection -- and solves a synthetic single-huge-block SDP
end to end (certified construction, so convergence is self-checking).

Per point it reports:
  - eigh projection ms (XLA QDWH eigh + reconstruct)
  - poly projection ms (matmul-only sign filter; error bound documented in
    ops/polyfilter.py: eigenvalues >= 1e-4 * ||X||_2 get sign error
    < 1.2e-7 in f32, so projection error <= ~5e-5 * ||X||_2)
  - end-to-end iterations/s for the synthetic SDP

Usage: python benchmarks/huge_block.py [n] [con_num]
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from cuadmm_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np


def emit(**kw):
    print(json.dumps(kw), flush=True)


def timed(fn, x, reps=8):
    out = jax.block_until_ready(fn(x))
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = jax.block_until_ready(fn(x))
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def synth_problem(n, con_num, seed=0):
    """Certified single-block SDP: X* PSD rank n/2, S* = C - A^T y* PSD,
    complementary. Sparse A: each constraint touches a few random svec
    entries (quasar-like registration constraints are similarly sparse)."""
    from cuadmm_jax import Problem

    rng = np.random.default_rng(seed)
    vec_len = n * (n + 1) // 2
    nnz_per = 4
    rows = np.repeat(np.arange(con_num), nnz_per)
    cols = rng.integers(0, vec_len, con_num * nnz_per)
    vals = rng.standard_normal(con_num * nnz_per)
    # Dedup (row, col) pairs to keep the triplets well-formed.
    key = rows.astype(np.int64) * vec_len + cols
    _, keep = np.unique(key, return_index=True)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    k = n // 2
    X = (q[:, :k] * rng.uniform(0.5, 2.0, k)) @ q[:, :k].T
    S = (q[:, k:] * rng.uniform(0.5, 2.0, n - k)) @ q[:, k:].T
    iu = np.tril_indices(n)
    scale = np.where(iu[0] == iu[1], 1.0, np.sqrt(2.0))
    x_svec = X[iu] * scale
    s_svec = S[iu] * scale
    y_star = rng.standard_normal(con_num)

    import scipy.sparse as sp

    A = sp.csr_matrix((vals, (rows, cols)), shape=(con_num, vec_len))
    b = A @ x_svec
    C = s_svec + A.T @ y_star
    # Sort A^T triplets constraint-major (the order Problem documents).
    order = np.lexsort((cols, rows))
    return Problem(
        blk=[("s", n)],
        con_num=con_num,
        At_rows=cols[order].astype(np.int64),
        At_cols=rows[order].astype(np.int64),
        At_vals=vals[order],
        b_indices=np.arange(con_num, dtype=np.int64),
        b_vals=b,
        C_indices=np.arange(vec_len, dtype=np.int64),
        C_vals=C,
        name=f"huge{n}",
    ), float(C @ x_svec)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2004
    con_num = int(sys.argv[2]) if len(sys.argv) > 2 else 8192
    dtype = jnp.float32
    backend = jax.default_backend()
    emit(backend=backend, n=n, con_num=con_num)

    rng = np.random.default_rng(0)
    m = rng.standard_normal((1, n, n))
    m = jnp.asarray((m + m.transpose(0, 2, 1)) / 2, dtype)

    from cuadmm_jax.ops.polyfilter import psd_project_poly
    from cuadmm_jax.ops.projection import reconstruct_clamped, xla_eigh

    @jax.jit
    def proj_eigh(x):
        with jax.default_matmul_precision("highest"):
            w, v = xla_eigh(x)
            return reconstruct_clamped(w, v)

    @jax.jit
    def proj_poly(x):
        with jax.default_matmul_precision("highest"):
            return psd_project_poly(x)

    t_eigh = timed(proj_eigh, m)
    t_poly = timed(proj_poly, m)
    # Accuracy cross-check on the same input.
    pe = np.asarray(proj_eigh(m), np.float64)
    pp = np.asarray(proj_poly(m), np.float64)
    rel = float(np.linalg.norm(pp - pe) / np.linalg.norm(pe))
    emit(
        stage="projection",
        eigh_ms=1e3 * t_eigh,
        poly_ms=1e3 * t_poly,
        poly_vs_eigh_rel_err=rel,
        ref_s_per_iter=0.246,
    )

    # End-to-end synthetic single-huge-block solve.
    from cuadmm_jax import SDPSolver, SolverConfig

    prob, pobj_star = synth_problem(n, con_num)
    cfg = SolverConfig(
        verbose=False,
        check_every=50,
        projection="eigh",
        switch_admm=10**9,
    )
    solver = SDPSolver(prob, cfg)
    t0 = time.perf_counter()
    res = solver.solve(max_iter=100, stop_tol=0.0)  # warmup/compile
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solver.solve(max_iter=400, stop_tol=1e-4)
    dt = time.perf_counter() - t0
    emit(
        stage="end_to_end",
        iters=res.iterations,
        iters_per_sec=res.iterations / dt,
        s_per_iter=dt / max(res.iterations, 1),
        warmup_s=round(warm, 1),
        errRp=float(res.errRp),
        errRd=float(res.errRd),
        pobj=res.pobj,
        pobj_star=pobj_star,
        converged=bool(res.converged),
        vs_quasar500_ref=0.246 / (dt / max(res.iterations, 1)),
    )


if __name__ == "__main__":
    main()
