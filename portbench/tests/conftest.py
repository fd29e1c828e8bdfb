"""Test settings of the benchmark's own tests: the ``cuda`` marker for
tests that need a card (each decides inside a fixture, never at
import)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device; skipped without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")
