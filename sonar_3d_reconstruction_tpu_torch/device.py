"""Device checks for code that must run on the card, and host uploads."""

from __future__ import annotations

import numpy as np
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


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """``array`` as a tensor on ``device``.  A read-only array (a decoded
    message's buffer) is copied first: torch cannot wrap it."""
    array = np.asarray(array)
    if not array.flags.writeable:
        array = array.copy()
    return torch.as_tensor(array, device=device)
