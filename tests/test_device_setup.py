"""Device-facing set-up that the CPU can check: where the compile cache
goes, and the normal-solver memory ceilings derived from a device's
reported memory."""

import os

import jax
import pytest

from cuadmm_jax.ops import chol
from cuadmm_jax.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GiB = 2**30


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_cache_dir_from_env(backend):
    """A set JAX_COMPILATION_CACHE_DIR wins on every backend."""
    env = {cc.ENV_VAR: "/some/cache"}
    assert cc.compile_cache_dir(backend, env) == "/some/cache"


def test_cache_dir_default_gpu():
    """Without the variable the GPU cache sits at a fixed <repo>/.jax_cache."""
    path = cc.compile_cache_dir("gpu", {})
    assert path == os.path.join(REPO, ".jax_cache")
    assert cc.compile_cache_dir("gpu", {cc.ENV_VAR: ""}) == path


def test_cache_off_on_cpu():
    assert cc.compile_cache_dir("cpu", {}) is None


@pytest.mark.parametrize("env_dir", [None, "/tmp/elsewhere"])
def test_enable_compile_cache_sets_only_that_dir(monkeypatch, env_dir):
    """enable_compile_cache() points JAX at exactly the resolved directory
    (the config update is captured, not applied, so this process keeps
    its cache off)."""
    updates = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.__setitem__(k, v))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    if env_dir is None:
        monkeypatch.delenv(cc.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(cc.ENV_VAR, env_dir)
    path = cc.enable_compile_cache()
    want = env_dir or os.path.join(REPO, ".jax_cache")
    assert path == want
    assert updates["jax_compilation_cache_dir"] == want


def test_memory_limits_16gib():
    """A 16 GiB device: ~73k packed constraints, a 14 GiB band, a 6 GiB
    dense A."""
    lim = chol.memory_limits(16 * GiB)
    assert 70_000 <= lim.packed_max_con <= 80_000
    assert lim.band_max_bytes == 14 * GiB
    assert lim.dense_a_bytes == 6 * GiB


def test_memory_limits_80gb():
    """An 80 GB card (and the 3/4 of it a JAX process reserves) admits
    much larger packed factors; every ceiling grows with the device."""
    small = chol.memory_limits(16 * GiB)
    for nbytes in (80 * 10**9, 60 * 10**9):
        lim = chol.memory_limits(nbytes)
        assert lim.packed_max_con > 2 * small.packed_max_con
        # The packed f32 triangle (~2 n^2 bytes) leaves the stated headroom.
        assert 2 * lim.packed_max_con**2 <= nbytes - chol.PACKED_HEADROOM_BYTES
        assert lim.band_max_bytes == nbytes - chol.BAND_HEADROOM_BYTES
        assert lim.dense_a_bytes > small.dense_a_bytes


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_memory_limits_reads_bytes_limit():
    dev = _FakeDevice({"bytes_limit": 80 * 10**9, "bytes_in_use": 0})
    assert chol.device_memory_limits(dev) == chol.memory_limits(80 * 10**9)


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_device_memory_limits_without_stats_is_an_error(stats):
    with pytest.raises(RuntimeError, match="bytes_limit"):
        chol.device_memory_limits(_FakeDevice(stats))


def test_host_mode_needs_the_cpu_platform(monkeypatch):
    """normal_solver='host' says which platform is missing instead of
    failing inside its first pure_callback."""
    import numpy as np
    import jax.numpy as jnp

    from cuadmm_jax.ops import sparse as sparse_ops

    r = np.arange(4, dtype=np.int64)
    v = np.ones(4)
    sa = sparse_ops.build_sparse_a(r, r, v, 4, 4, jnp.float64)

    def no_cpu(backend=None):
        raise RuntimeError(f"Unknown backend {backend}")

    monkeypatch.setattr(jax, "devices", no_cpu)
    with pytest.raises(RuntimeError, match="JAX_PLATFORMS"):
        chol.build_normal_solver(r, r, v, 4, 4, sa, "host", jnp.float64)
