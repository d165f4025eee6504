"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches
must see the real single CPU device; only launch/dryrun.py forces the
512-device placeholder topology (and does so before importing jax)."""

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")
