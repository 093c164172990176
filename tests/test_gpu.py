"""On-card checks: the solver's f32 device paths at full precision, the
packed and band sweeps as compiled for the GPU, and one end-to-end solve.

Each test skips without a GPU (the ``gpu`` fixture, tests/conftest.py).
Run on a card: ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def _aat(n, seed, band=None):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 3)
    if band is None:
        cols = rng.integers(0, 2 * n, size=len(rows))
        shape = (n, 2 * n)
    else:
        cols = np.clip(rows + rng.integers(-band, band + 1, size=len(rows)), 0, n - 1)
        shape = (n, n)
    A = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)), shape=shape)
    return (A @ A.T).tocsr()


def test_matmul_precision_canary(gpu):
    """HIGHEST-precision f32 GEMM must be f32-accurate (TF32 is ~1e-3); a
    regression here silently poisons the factor and the projection."""
    rng = np.random.default_rng(0)
    a64 = rng.standard_normal((512, 512))
    ref = a64 @ a64.T
    hi = jax.jit(lambda x: jnp.matmul(x, x.T, precision="highest"))(
        jnp.asarray(a64, jnp.float32)
    )
    rel = np.linalg.norm(np.asarray(hi, np.float64) - ref) / np.linalg.norm(ref)
    assert rel < 1e-6


def test_packed_sweep_on_gpu(gpu):
    """Packed f32 factor + sweeps on the card against a host f64 solve."""
    from cuadmm_jax.ops.tri_stream import (
        make_layout, packed_cholesky, packed_solve, scatter_packed_aat,
    )

    n = 2500
    aat = _aat(n, 1)
    dm = float(aat.diagonal().mean())
    lay = make_layout(n, 1024)
    coo = aat.tocoo()
    tiles = scatter_packed_aat(
        coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data,
        lay, 1e-2, dm, jnp.float32,
    )
    fac = packed_cholesky(tiles, lay)
    r = np.random.default_rng(0).standard_normal(n)
    y = np.asarray(packed_solve(fac, jnp.asarray(r, jnp.float32), lay), np.float64)
    ref = np.linalg.solve(aat.toarray() + 1e-2 * max(dm, 1.0) * np.eye(n), r)
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-4


def test_band_sweep_on_gpu(gpu):
    """Band f32 factor + scanned sweeps on the card against a host f64
    solve."""
    from cuadmm_jax.ops.tri_stream import (
        band_cholesky, band_solve, make_band_layout, scatter_band_aat,
    )

    n = 3000
    aat = _aat(n, 2, band=40)
    dm = float(aat.diagonal().mean())
    coo = aat.tocoo()
    lay = make_band_layout(n, int(np.abs(coo.row - coo.col).max()), block=256)
    tiles = scatter_band_aat(
        coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data,
        lay, 1e-2, dm, jnp.float32,
    )
    tiles = band_cholesky(tiles, lay)
    r = np.random.default_rng(1).standard_normal(n)
    y = np.asarray(band_solve(tiles, jnp.asarray(r, jnp.float32), lay), np.float64)
    ref = np.linalg.solve(aat.toarray() + 1e-2 * max(dm, 1.0) * np.eye(n), r)
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-4


@pytest.mark.parametrize("normal_solver", ["auto", "host"])
def test_certified_solve_on_gpu(gpu, normal_solver):
    """A certified sparse SDP through SDPSolver on the card; 'host' runs the
    normal solve through jax.pure_callback."""
    from cuadmm_jax import SDPSolver, SolverConfig
    from cuadmm_jax.models.random_sdp import random_certified_sdp_sparse

    rng = np.random.default_rng(0)
    blk = [("s", int(k)) for k in rng.integers(1, 14, 80)]
    prob, _, _, _, opt = random_certified_sdp_sparse(blk, 230, seed=1)
    cfg = SolverConfig(verbose=False, stop_tol=1e-4, normal_solver=normal_solver)
    res = SDPSolver(prob, cfg).solve(max_iter=20000)
    assert res.converged
    assert abs(float(prob.dense_C() @ res.X) - opt) / max(1.0, abs(opt)) < 1e-3
