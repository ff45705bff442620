"""Tests of the benchmark harness (``python -m pytest port_bench/tests``).

They run on the CPU at tiny sizes.  Tests that need a card take the
``cuda_device`` fixture and carry the ``card`` marker; they skip where
there is no card, decided when the test runs."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: port_bench/README.md)")
    return torch.device("cuda")
