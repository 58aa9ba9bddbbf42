"""Tests of the benchmark's harness, on the CPU unless marked `gpu`."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; the test skips itself when there is none "
        "(on the card: python -m pytest benchmark/tests -m gpu)")


@pytest.fixture
def card():
    """A CUDA device, or a skip where the machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
