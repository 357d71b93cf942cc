"""pytest settings of the benchmark's own tests (``bench/tests``):

  PYTHONPATH=src:. python -m pytest -q bench/tests

Tests marked ``card`` need a CUDA card; the ``card`` fixture looks for one
when the test runs and skips it where there is none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips where there is none)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
