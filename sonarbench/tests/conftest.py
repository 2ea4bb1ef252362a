"""Shared fixtures of the benchmark's tests: small cells on the CPU, and
the card where a test needs one (decided here, never at import)."""

import pytest
import torch

# a pool and a pass small enough for the CPU
POOL, PASS = 12, 8
SEED = (1 << 40) + 7


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu():
    return torch.device("cpu")
