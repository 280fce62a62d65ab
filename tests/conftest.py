"""Test configuration: the CPU backend with a virtual 8-device mesh.

Multi-device sharding is validated on host-platform virtual devices.
Must run before the first `import jax` anywhere in the test session.
Tests marked `gpu` need a card: run them with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`; elsewhere the
`gpu_device` fixture skips them.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX backend is {dev.platform})")
    return dev
