"""Test configuration: run on a virtual 8-device CPU mesh with x64 enabled.

Must set the environment before jax initializes its backends, hence the
top-of-module placement.  Tests that need a GPU carry the ``gpu`` marker
and skip here (see README, "Running on a GPU").
"""
import os

# CPU unless the caller names a platform (JAX_PLATFORMS=cuda for the
# ``gpu``-marked tests on a card)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_max_isa" not in flags:
    # Pin the compile target ISA so that persistent-cache entries written
    # by one process load correctly in another that detects another ISA.
    flags = (flags + " --xla_cpu_max_isa=AVX2").strip()
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

from stochqn_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided when the test
    runs, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
