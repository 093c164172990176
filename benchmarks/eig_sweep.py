"""Eigh-method calibration sweep.

Counterpart of the reference's SingleBatchedComparison perf harness
(reference: test/single_batched_comparison.hpp:130-223 + the committed
820-row output test/output/single_batched_comparison.txt), which calibrated
the single-QR-on-streams vs batched-Jacobi crossover
(src/matrix_sizes.cu:14-19).

Here we sweep (block size, batch count) over the projection methods
available on this backend -- XLA batched eigh and the Newton-Schulz
polynomial projection -- and write one JSON line per point. The results
inform bucket rounding and any per-bucket method override.

Usage: python benchmarks/eig_sweep.py [--out eig_sweep.jsonl] [--dtype float32]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp


def poly_project(mats: jax.Array) -> jax.Array:
    """The production matmul-only projection (ops/polyfilter.py) -- this is
    what `projection="poly"` actually dispatches, so its timing is what the
    calibration table must record."""
    import os, sys as _s

    _s.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from cuadmm_jax.ops.polyfilter import psd_project_poly

    return psd_project_poly(mats)


def eigh_project(mats: jax.Array) -> jax.Array:
    w, v = jnp.linalg.eigh(mats)
    return jnp.einsum(
        "bij,bj,bkj->bik", v, jnp.maximum(w, 0), v, preferred_element_type=v.dtype
    )


def jacobi_project(mats: jax.Array) -> jax.Array:
    """The jnp batched cyclic-Jacobi path (ops/jacobi.py)."""
    import os, sys as _s

    _s.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from cuadmm_jax.ops.jacobi import jacobi_eigh_jnp

    w, v = jacobi_eigh_jnp(mats)
    return jnp.einsum(
        "bij,bj,bkj->bik", v, jnp.maximum(w, 0), v, preferred_element_type=v.dtype
    )


def timeit(f, x, k: int = 16) -> float:
    """Average seconds per op; loops inside jit to amortize dispatch.

    Every pass projects a *fresh* symmetric input (x scaled by a
    loop-dependent factor -- scaling preserves the spectrum shape), not the
    previous output: feeding near-PSD results back in would systematically
    distort eigh's convergence behaviour and flatter whichever method ran
    first.
    """

    @jax.jit
    def g(x):
        def body(i, acc):
            fresh = x * (1.0 + 1e-6 * i.astype(x.dtype))
            return acc + f(fresh).sum()

        return jax.lax.fori_loop(0, k, body, jnp.zeros((), x.dtype))

    float(g(x))  # compile
    t0 = time.perf_counter()
    float(g(x))
    return (time.perf_counter() - t0) / k


def default_out(dtype_name: str) -> str:
    """The exact path ops/dispatch.py loads for this backend/dtype."""
    backend = jax.default_backend()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(
        root, "cuadmm_jax", "data", f"eig_sweep_{backend}_{dtype_name}.jsonl"
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="default: the dispatch table path for this backend/dtype")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--sizes", default="2,4,8,16,32,64,128,256")
    ap.add_argument("--batches", default="1,8,64,512,4096")
    ap.add_argument("--max-elems", type=int, default=int(3e7))
    ap.add_argument("--skip-jacobi", action="store_true")
    args = ap.parse_args()

    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.dtype(args.dtype)
    key = jax.random.PRNGKey(0)
    out = args.out or default_out(args.dtype)
    os.makedirs(os.path.dirname(out), exist_ok=True)

    open(out, "w").close()
    n_rows = 0
    for n in map(int, args.sizes.split(",")):
        for b in map(int, args.batches.split(",")):
            if b * n * n > args.max_elems:
                continue
            m = jax.random.normal(key, (b, n, n), dtype=dtype)
            m = (m + m.transpose(0, 2, 1)) / 2
            row = {"n": n, "batch": b, "dtype": args.dtype}
            row["eigh_ms"] = timeit(eigh_project, m) * 1e3
            row["poly_ms"] = timeit(poly_project, m) * 1e3
            if not args.skip_jacobi and n <= 64:
                row["jacobi_ms"] = timeit(jacobi_project, m) * 1e3
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
            n_rows += 1
            print(json.dumps(row), flush=True)
    print(f"wrote {n_rows} rows to {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
