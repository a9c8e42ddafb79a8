# NOTE: deliberately no XLA_FLAGS here — smoke tests must see the real
# single CPU device (the 512-device override is exclusive to the dry-run
# entrypoint).  Multi-device integration tests run in a subprocess from
# test_system.py.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")


@pytest.fixture(scope="session")
def rng_key():
    import jax
    return jax.random.PRNGKey(0)
