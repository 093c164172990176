"""IO readers/writers and COO round-trips.

Mirrors the reference's io_test.hpp (TXT fixtures, blk type parsing,
COO<->CSC round trips; reference: test/io_test.hpp:3-161).
"""

import numpy as np
import pytest

from cuadmm_jax.io import txt as txtio
from cuadmm_jax.problem import Problem


def test_dense_vector_roundtrip(tmp_path):
    v = np.array([1.5, -2.25, 0.0, 3e-8])
    f = str(tmp_path / "v.txt")
    txtio.write_dense_vector(f, v)
    out = txtio.read_dense_vector(f)
    np.testing.assert_allclose(out, v, rtol=1e-12)


def test_sparse_vector_roundtrip(tmp_path):
    idx = np.array([0, 3, 7], dtype=np.int32)
    vals = np.array([1.0, -2.5, 1e-3])
    f = str(tmp_path / "sv.txt")
    txtio.write_sparse_vector(f, idx, vals)
    i2, v2 = txtio.read_sparse_vector(f)
    np.testing.assert_array_equal(i2, idx)
    np.testing.assert_allclose(v2, vals)


def test_coo_matrix_roundtrip(tmp_path):
    rows = np.array([0, 2, 1], dtype=np.int32)
    cols = np.array([1, 0, 1], dtype=np.int32)
    vals = np.array([3.0, -1.0, 2.0])
    f = str(tmp_path / "m.txt")
    txtio.write_coo_matrix(f, rows, cols, vals)
    r2, c2, v2 = txtio.read_coo_matrix(f)
    np.testing.assert_array_equal(r2, rows)
    np.testing.assert_array_equal(c2, cols)
    np.testing.assert_allclose(v2, vals)


def test_coo_transpose_read(tmp_path):
    f = str(tmp_path / "m.txt")
    txtio.write_coo_matrix(f, [0, 1], [2, 3], [1.0, 2.0])
    r, c, v = txtio.read_coo_matrix(f, transpose=True)
    np.testing.assert_array_equal(r, [2, 3])
    np.testing.assert_array_equal(c, [0, 1])


def test_read_blk_types(tmp_path):
    """Typed and bare lines; malformed lines ignored
    (reference: test/io_test.hpp ReadBLKTypes on test/data/blk_types.txt)."""
    f = tmp_path / "blk.txt"
    f.write_text("s 3\n10\nu 5\n\nnot a line\ns 2\n")
    blk = txtio.read_blk(str(f))
    assert blk == [("s", 3), ("s", 10), ("u", 5), ("s", 2)]


def test_coo_sort_and_ptrs():
    rows = np.array([2, 0, 1, 0], dtype=np.int32)
    cols = np.array([1, 0, 1, 1], dtype=np.int32)
    vals = np.array([4.0, 1.0, 3.0, 2.0])
    r, c, v = txtio.coo_sort(rows, cols, vals, order="col-major")
    np.testing.assert_array_equal(c, [0, 1, 1, 1])
    np.testing.assert_array_equal(r, [0, 0, 1, 2])
    np.testing.assert_allclose(v, [1.0, 2.0, 3.0, 4.0])
    ptrs = txtio.coo_to_csc_ptrs(c, 3)
    np.testing.assert_array_equal(ptrs, [0, 1, 4, 4])


def test_problem_from_txt_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    blk = [("s", 3), ("s", 2)]
    vec_len = 6 + 3
    con = 4
    A = rng.standard_normal((con, vec_len))
    A[np.abs(A) < 0.7] = 0.0
    b = rng.standard_normal(con)
    C = rng.standard_normal(vec_len)
    prob = Problem.from_dense(blk, A, b, C, name="rt")
    d = str(tmp_path / "prob")
    prob.to_txt(d)
    prob2 = Problem.from_txt(d)
    assert prob2.blk == blk
    assert prob2.con_num == con
    assert prob2.vec_len == vec_len
    np.testing.assert_allclose(prob2.dense_b(), b)
    np.testing.assert_allclose(prob2.dense_C(), C)
    # Dense reconstruction of At matches.
    At = np.zeros((vec_len, con))
    At[prob2.At_rows, prob2.At_cols] = prob2.At_vals
    np.testing.assert_allclose(At, A.T, rtol=1e-12)


def test_warm_start_sig_txt(tmp_path):
    """sig.txt is read alongside X/y/S warm starts (reference:
    src/problem.cu:82, test/duo_solver_test.hpp:46)."""
    rng = np.random.default_rng(1)
    blk = [("s", 2)]
    vec_len, con = 3, 2
    A = rng.standard_normal((con, vec_len))
    prob = Problem.from_dense(blk, A, rng.standard_normal(con), rng.standard_normal(vec_len))
    d = str(tmp_path / "p")
    prob.to_txt(d)
    for name, n in [("X", vec_len), ("y", con), ("S", vec_len)]:
        np.savetxt(f"{d}/{name}.txt", rng.standard_normal(n))
    with open(f"{d}/sig.txt", "w") as f:
        f.write("42.5\n")
    p2 = Problem.from_txt(d, warm_start=True)
    assert p2.sig0 == 42.5
    assert p2.X0 is not None and len(p2.X0) == vec_len
    # Without sig.txt the field stays None.
    import os

    os.remove(f"{d}/sig.txt")
    p3 = Problem.from_txt(d, warm_start=True)
    assert p3.sig0 is None


def test_problem_reference_fixture():
    """Load a real reference problem directory end to end."""
    prob = Problem.from_txt("/root/reference/examples/dimacs/data/TXT/truss5")
    assert prob.con_num == 208
    assert prob.vec_len == 1816
    assert prob.mat_num == 34
    assert prob.At_nnz == 2823
    assert prob.validate() == []
