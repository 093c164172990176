"""Test configuration.

The suite runs on the CPU with 8 virtual devices (multi-device sharding is
exercised on that virtual mesh) and x64 enabled (the solver is float64 by
default, mirroring the reference's end-to-end double precision).

Tests marked ``gpu`` need a card; they skip elsewhere. Run them on a GPU
with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``: the platform
comes from ``JAX_PLATFORMS`` and defaults to the CPU.
"""

import os

# Must be set before the first jax import in this process.
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import pytest

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="session")
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (default backend is {jax.default_backend()})")
    return jax.devices()[0]
