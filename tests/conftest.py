"""Test configuration: run JAX on 8 virtual CPU devices with x64 enabled.

This is the fake-multi-device capability the reference lacks (it can only test
MPI paths under real mpirun, SURVEY.md §4): shard_map/ppermute/psum code paths
run for real on one host. Must run before any jax import in the tests.

Tests marked ``gpu`` need the card and take the ``gpu`` fixture, which skips
them here. On a machine with an NVIDIA GPU run them with
``HPCCG_TEST_PLATFORM=cuda python -m pytest -m gpu tests/`` — that setting
leaves JAX on the card instead of the virtual CPU devices.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_PLATFORM = os.environ.get("HPCCG_TEST_PLATFORM", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = _PLATFORM

import jax  # noqa: E402

jax.config.update("jax_platforms", _PLATFORM)
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """quick = everything not marked slow: `pytest -m quick` is the fast
    iteration tier."""
    for item in items:
        if item.get_closest_marker("slow") is None:
            item.add_marker(pytest.mark.quick)


@pytest.fixture
def gpu():
    """The first NVIDIA GPU, or a skip: decided at run time, never at
    import, so every test worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU; run on the card with "
            "HPCCG_TEST_PLATFORM=cuda python -m pytest -m gpu tests/"
        )
    return dev
