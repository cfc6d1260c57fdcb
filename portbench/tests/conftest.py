"""CPU tests of the benchmark: ``python -m pytest portbench/tests -q``.
Tests marked ``cuda`` need the card; the fixture ``cuda_device`` decides
whether one is there and skips otherwise."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    torch.set_num_threads(2)
