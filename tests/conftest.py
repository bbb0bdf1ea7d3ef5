"""Test configuration: the suite runs on the CPU backend with 8 virtual
devices, so multi-device sharding tests run without accelerators.

Tests that need the GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them on any other backend.  Run them on
the card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise
    (decided at run time, never at import or collection)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX backend is {dev.platform!r})")
    return dev
