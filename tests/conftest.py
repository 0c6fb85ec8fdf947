"""Test configuration.

Tests run JAX on the CPU (JAX_PLATFORMS=cpu) with 8 virtual devices, so
the multi-device sharding path is exercised without accelerators.  The
GPU path is exercised by chip_smoke.py on the card.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REFERENCE_DATA = "/root/reference/tests/data"


@pytest.fixture
def reference_tests():
    """The tests/ directory of the upstream Muscato checkout whose data/
    is REFERENCE_DATA; the golden tests skip where that data is absent."""
    if not os.path.isdir(REFERENCE_DATA):
        pytest.skip(f"upstream Muscato test data not found at {REFERENCE_DATA}")
    return os.path.dirname(REFERENCE_DATA)
