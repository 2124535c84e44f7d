"""Tests of the benchmark harness. The CPU tests run the harness at a tiny
size with the program's plain kernels; tests marked ``card`` need a CUDA
card and run on the chip (``python3 -m pytest gpubench/tests -m card``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
