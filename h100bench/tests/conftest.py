"""Fixtures of the benchmark's own tests."""

import pytest
import torch


@pytest.fixture
def card():
    """The CUDA device, or a skip where this host has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
