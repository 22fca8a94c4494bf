"""Shared set-up of the benchmark's tests: the repository's root on the
path, few CPU threads, and the `card` fixture that skips a test without a
CUDA card (decided when the test runs, never at import)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
