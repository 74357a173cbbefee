"""Test settings of the benchmark's own tests (``benchmark/test_bench_*.py``).

The harness's folder and the checkout's root go on ``sys.path``, as
``run.py`` puts them.  Tests that need a card carry the ``card`` marker and
decide inside the test, through the ``card`` fixture, whether one is
present: they skip here with a reason and run on a machine with a card
(``benchmark/README.md`` names the command)."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch.cuda.is_available() is false")
    return torch.device("cuda", 0)
