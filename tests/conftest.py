# NOTE: do NOT set XLA_FLAGS / device-count overrides here — smoke tests and
# benches must see the real single CPU device. Multi-device tests spawn
# subprocesses with their own XLA_FLAGS (see test_gossip_distributed.py).
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

# install the jax compat shims (repro/compat.py) before any test module does
# `from jax.sharding import AxisType` on an older jax
import repro  # noqa: E402,F401


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess / dry-run tests")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without them")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
