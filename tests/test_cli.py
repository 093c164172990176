"""CLI front end (reference: src/main.cu writes X_opt.txt)."""

import numpy as np
import pytest

from cuadmm_jax.cli import main
from cuadmm_jax.io import txt as txtio
from cuadmm_jax.models.random_sdp import random_certified_sdp


@pytest.fixture()
def prob_dir(tmp_path):
    prob, x_star, *_ = random_certified_sdp([("s", 5), ("s", 3)], con_num=8, seed=1)
    d = tmp_path / "prob"
    prob.to_txt(str(d))
    return str(d)


def test_cli_solve_writes_x_opt(prob_dir, capsys):
    rc = main(
        [
            "solve",
            prob_dir,
            "--max-iter",
            "5000",
            "--stop-tol",
            "1e-5",
            "--switch-admm",
            "1000000000",
            "--quiet",
        ]
    )
    assert rc == 0
    x = txtio.read_dense_vector(prob_dir + "/X_opt.txt")
    assert np.all(np.isfinite(x))


def test_cli_info(prob_dir, capsys):
    assert main(["info", prob_dir]) == 0
    out = capsys.readouterr().out
    assert "constraints: 8" in out
    assert "bucket" in out


def test_cli_nonconverged_exit_code(prob_dir):
    rc = main(
        ["solve", prob_dir, "--max-iter", "3", "--stop-tol", "1e-12", "--quiet"]
    )
    assert rc == 2
