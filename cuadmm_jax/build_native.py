"""Build the native C++ extension in-place.

Usage: ``python -m cuadmm_jax.build_native``. No setuptools ceremony --
one g++ invocation against the CPython + NumPy headers.
"""

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig


def build(verbose: bool = True) -> str:
    import numpy as np

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native")
    src = os.path.join(here, "txtio.cpp")
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = os.path.join(here, "txtio" + suffix)
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3",
        "-shared",
        "-fPIC",
        "-std=c++17",
        f"-I{sysconfig.get_paths()['include']}",
        f"-I{np.get_include()}",
        src,
        "-o",
        out,
    ]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    return out


if __name__ == "__main__":
    path = build()
    print(f"built {path}")
    # Smoke test -- load the fresh .so directly (the package may have been
    # imported before the build, caching the 'not built' state).
    import importlib.util

    spec = importlib.util.spec_from_file_location("txtio", path)
    txtio = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(txtio)

    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write("1 2 3.5\n-4e-2 17 0\n")
        name = f.name
    arr = txtio.read_floats(name)
    os.unlink(name)
    assert list(arr) == [1.0, 2.0, 3.5, -0.04, 17.0, 0.0], arr
    print("smoke test ok:", list(arr))
