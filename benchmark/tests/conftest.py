"""The benchmark's CPU tests: run with `python -m pytest benchmark/tests`.

Tests marked `card` need a CUDA device; they decide inside the test
whether one is there and skip otherwise.  Run them on a machine with the
card by the same command."""

import sys
from pathlib import Path

import pytest
import torch

# one thread a test process: the suite runs in several workers at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:   # the checkout's root: `benchmark` and the program
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")
