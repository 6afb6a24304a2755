"""The benchmark's tests: python3 -m pytest port_bench/tests -q runs them on
the CPU; the tests marked `card` need a CUDA device and skip without one
(python3 -m pytest port_bench/tests -m card -s runs them on the card)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs on the card")
    return torch.device("cuda")
