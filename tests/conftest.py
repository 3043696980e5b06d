"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests and benches see the
single real CPU device; multi-device behaviour is tested via subprocesses
(tests/test_distributed.py) and the dry-run launcher."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips on a host without one)")
