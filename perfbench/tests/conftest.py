"""The benchmark's own tests. Those that need the card carry the ``card``
marker and skip inside the ``card`` fixture where there is none; nothing
here decides at import time whether a card is present."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control is read on the card at the cell's own size")
    return torch.device("cuda")
