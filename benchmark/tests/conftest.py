"""CPU tests of the benchmark harness: ``python -m pytest benchmark/tests``.
Tests marked ``chip`` need a CUDA card; the fixture ``cuda`` skips them
where there is none."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.dirname(BENCH), BENCH]


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card (skipped without one)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
