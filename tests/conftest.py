"""Test harness configuration.

Distributed tests need >1 device; jax locks the device count at first
backend init, so tests that want N host devices live in files named
``test_dist_*.py`` and this conftest sets the XLA flag *before* jax is
imported — but only when such a file is being collected, so plain tests
keep seeing 1 device when run alone.

Running the whole suite at once therefore also uses 8 host devices; all
single-device tests are device-count-agnostic (they place arrays
explicitly or use jit defaults, which on CPU behaves identically).
"""
import os
import sys

# Must happen before any jax import anywhere in the test session.
if "jax" not in sys.modules:
    os.environ.setdefault(
        "XLA_FLAGS",
        (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip(),
    )

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself without one"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)
