"""The benchmark's own tests: the harness, the yardstick and the reference
on the CPU; the control and the faults on a CUDA card (marked ``card``)."""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))
torch.set_num_threads(1)


@pytest.fixture(scope="session")
def card():
    """Skips a test that needs a CUDA card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
