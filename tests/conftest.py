"""Test configuration: CPU backend with a virtual 8-device mesh.

Multi-device tests assert shard-count invariance of physics results — the
analogue of the reference validating parallel correctness by identical
analytic errors under ``mpirun -np {1..8}`` (SURVEY.md §4).

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them here; ``chip_smoke.py`` runs their checks on the
card.
"""

import os

# Must run before jax initializes: the suite runs on the CPU backend with 8
# virtual devices.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped on the CPU test backend")


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU (this run's device: {d.platform})")
    return d
