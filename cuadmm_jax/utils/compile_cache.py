"""Where JAX's persistent compilation cache lives.

One rule for every entry point (chip_smoke.py, bench.py, the benchmark
scripts):

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX uses that directory and the
  program sets no other.
- otherwise, on the GPU: ``<repo>/.jax_cache``, a fixed path (the path is
  part of the cache key, so a directory that moves never hits).
- otherwise (CPU): off. XLA:CPU caches ahead-of-time machine code keyed
  without the full host feature set, and loading an entry written on a
  different machine can crash.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir(backend: str, environ: Mapping[str, str] = os.environ) -> Optional[str]:
    """The cache directory for ``backend`` under ``environ`` (None = off)."""
    if environ.get(ENV_VAR):
        return environ[ENV_VAR]
    if backend == "gpu":
        return REPO_CACHE_DIR
    return None


def enable_compile_cache() -> Optional[str]:
    """Point JAX at ``compile_cache_dir`` for the default backend; returns
    the directory, or None when the cache stays off. Call it before the
    first compilation."""
    import jax

    path = compile_cache_dir(jax.default_backend())
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return path
