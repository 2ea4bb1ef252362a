"""The yardstick of the kernels' roofline shares: the card's published
peaks and the bytes each kernel must move.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
HBM at 3.35 TB/s, 67 TFLOP/s in float32 outside the tensor cores.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

I64 = 8


def k1_bytes(n_bricks: int, n_lanes: int, brick_volume: int = 64,
             value_bytes: int = 4) -> int:
    """Bytes one K1 call (the binning kernel, unique records) must move
    for a window of ``n_bricks`` bricks and ``n_lanes`` record lanes: its
    inputs read once (the lanes' keys and payloads, the bricks' record
    starts and value rows) and its outputs written once (the new rows and
    a touched byte a voxel).  A frozen copy of ``chip_smoke.k1_bytes``
    counted from a window's needs instead of its (padded) tensors."""
    rows = n_bricks * brick_volume
    inputs = 2 * I64 * n_lanes + I64 * (n_bricks + 1) + rows * value_bytes
    outputs = rows * (value_bytes + 1)
    return inputs + outputs


def k1_least_s(stats, window: int) -> float:
    """Least time K1 needs over a pass: each window's bytes (its
    ``batch_n_bricks`` and ``batch_n_lanes``, the same on every ping of
    the window) over the memory rate."""
    n = len(stats["batch_n_bricks"])
    starts = np.arange(0, n, window)
    total = sum(k1_bytes(int(stats["batch_n_bricks"][w]),
                         int(stats["batch_n_lanes"][w])) for w in starts)
    return total / HBM_BYTES_PER_S
