"""Test harness: an 8-device virtual CPU mesh unless told otherwise.

Unit tests validate numerics and sharding on the host so they run anywhere.
Tests marked ``gpu`` need the card and skip elsewhere; on a GPU machine run
them with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from vloam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# Persistent XLA compile cache: the suite compiles many structurally identical
# programs (same configs across test files).
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided per test, never at import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (on the card: JAX_PLATFORMS=cuda python -m pytest tests -m gpu)")
    return jax.devices()[0]
