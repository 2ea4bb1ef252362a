"""Device checks for code that must run on the card."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device, or RuntimeError when PyTorch sees none.

    Callers that measure or drive the card use this instead of falling back
    to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs only on a GPU"
        )
    return torch.device("cuda", 0)
