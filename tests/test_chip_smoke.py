"""chip_smoke.py off the card: it rehearses every phase at toy sizes
(--tiny) and never reports a result without a GPU."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")
OK = '"ok": true'


def _run(args, devices=1, cwd=REPO, script=SCRIPT, timeout=600):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("PYTEST", "XLA_"))}
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.run(
        [sys.executable, script, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def _phases_ok(stdout, names):
    for name in names:
        assert f'"phase": "{name}", "stage": "done", "passed": true' in stdout, name


def test_refuses_without_gpu():
    p = _run([])
    assert p.returncode != 0
    assert OK not in p.stdout
    assert "no GPU" in p.stderr


def test_tiny_runs_every_phase_on_cpu():
    p = _run(["--tiny"])
    _phases_ok(p.stdout, "abcde")
    assert p.returncode != 0
    assert OK not in p.stdout


def test_tiny_four_device_paths_on_cpu():
    p = _run(["--tiny", "--four"], devices=4)
    _phases_ok(p.stdout, ["mesh", "sharded", "batch"])
    assert p.returncode != 0
    assert OK not in p.stdout


def test_script_alone_fails(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    p = _run(["--tiny"], cwd=tmp_path, script=str(tmp_path / "chip_smoke.py"))
    assert p.returncode != 0
    assert OK not in p.stdout
