"""Tests of the benchmark harness (``perfbench/``).  They import neither
JAX nor the JAX package.  Tests that need a CUDA card carry the ``cuda``
marker and ask for the ``cuda_device`` fixture, which decides at run time
whether a card exists; on the CPU they skip.

    python -m pytest perfbench/tests -q -p no:cacheprovider
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)
