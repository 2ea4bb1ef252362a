"""Log-odds Bayesian update math (adaptive free-space protection, clamping).

Port of ``sonar_3d_reconstruction_tpu.ops.logodds``.  The operation order is
the JAX package's exactly, and the CUDA binning kernel
(``csrc/bin_apply.cu``) repeats it, so the kernel and the plain torch chain
round alike.  Constants are made as tensors on the operand's device: on a
CUDA tensor, PyTorch turns a division by a host scalar into a multiply by
its reciprocal, which would round differently from the kernel's division.
They are filled in place (``torch.full``), not copied from the host, so
making one never waits for the device.
"""

from __future__ import annotations

import math

import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """p = 1 / (1 + exp(-log_odds))."""
    return 1.0 / (1.0 + torch.exp(-x))


def probability_to_log_odds(min_probability: float, cfg: MapperConfig) -> float:
    """Extraction threshold with the reference edge cases:
    >= 1.0 -> log_odds_max - 0.01, <= 0.0 -> log_odds_min."""
    if min_probability >= 1.0:
        return cfg.log_odds_max - 0.01
    if min_probability <= 0.0:
        return cfg.log_odds_min
    return math.log(min_probability / (1.0 - min_probability))


def finalize_voxel_updates(
    current: torch.Tensor,
    lo_sum: torch.Tensor,
    count: torch.Tensor,
    occupied: torch.Tensor,
    cfg: MapperConfig,
) -> torch.Tensor:
    """Apply one frame's averaged updates to per-voxel log-odds.

    ``current`` pre-frame log-odds, ``lo_sum`` the frame's summed candidate
    log-odds, ``count`` its candidate count (0 = untouched, passes through),
    ``occupied`` the occupied-priority flag.  avg = sum/count; occupied
    positive updates into voxels with p <= adaptive_threshold are scaled by
    (p/threshold)*max_ratio; the result is clamped to
    [log_odds_min, log_odds_max].
    """
    dtype, device = current.dtype, current.device

    def const(x):
        return torch.full((), x, dtype=dtype, device=device)

    touched = count > 0
    avg = lo_sum / torch.clamp(count, min=1).to(dtype)

    if cfg.adaptive_update:
        p = sigmoid(current)
        thr = const(cfg.adaptive_threshold)
        scale = torch.where(
            p <= thr,
            (p / thr) * const(cfg.adaptive_max_ratio),
            torch.ones_like(p),
        )
        use_adaptive = occupied & (avg > 0)
        update = torch.where(use_adaptive, avg * scale, avg)
    else:
        update = avg

    new = torch.clamp(current + update, cfg.log_odds_min, cfg.log_odds_max)
    return torch.where(touched, new, current)
