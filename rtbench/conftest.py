"""Tests of the benchmark harness. Tests that need a CUDA card take the
``card`` fixture, which skips them here; the decision is made when the
test runs, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
