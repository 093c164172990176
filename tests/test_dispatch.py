"""Calibrated projection dispatch (ops/dispatch.py) -- the analog of the
reference's is_large_mat heuristic derived from its committed sweep
(reference: src/matrix_sizes.cu:14-19, test/output/single_batched_comparison.txt)."""

import json
import os

import pytest

from cuadmm_jax.ops import dispatch


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    """Point the dispatch loader at a throwaway table directory (writing
    fixtures into the package source tree is neither parallel-safe nor
    crash-safe)."""
    monkeypatch.setattr(dispatch, "_DATA_DIR", str(tmp_path))
    return tmp_path


def _write_table(data_dir, backend, dtype, rows):
    path = os.path.join(data_dir, f"eig_sweep_{backend}_{dtype}.jsonl")
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return path


def test_choose_methods_nearest_neighbor(data_dir):
    rows = [
        {"n": 8, "batch": 64, "eigh_ms": 1.0, "poly_ms": 0.2},
        {"n": 128, "batch": 64, "eigh_ms": 5.0, "poly_ms": 9.0},
        {"n": 512, "batch": 1, "eigh_ms": 50.0, "poly_ms": 20.0},
    ]
    _write_table(data_dir, "faketpu", "float32", rows)
    out = dispatch.choose_methods(
        [(1, 100), (10, 50), (100, 80), (600, 1)], "faketpu", "float32"
    )
    assert out == {0: "clamp", 1: "poly", 2: "eigh", 3: "poly"}


def test_choose_methods_jacobi(data_dir):
    rows = [
        {"n": 4, "batch": 512, "eigh_ms": 3.0, "poly_ms": 1.0, "jacobi_ms": 0.5},
        {"n": 64, "batch": 8, "eigh_ms": 2.0, "poly_ms": 4.0},
    ]
    _write_table(data_dir, "faketpu", "float32", rows)
    out = dispatch.choose_methods([(4, 500), (64, 8)], "faketpu", "float32")
    assert out == {0: "jacobi", 1: "eigh"}


def test_choose_methods_missing_table(data_dir):
    assert dispatch.choose_methods([(8, 4)], "nosuchbackend", "float32") is None
