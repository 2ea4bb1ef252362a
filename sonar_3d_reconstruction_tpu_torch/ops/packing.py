"""Voxel-key packing (PyTorch port of ``sonar_3d_reconstruction_tpu.ops.packing``).

Every u32 word of the JAX package travels here in an int64 tensor holding
its unsigned value: CPU torch ``uint32`` lacks shifts, ``index_put_`` and
``min``, and in int32 the all-ones sentinel would be -1 and sort first
instead of last.  Results are masked to 32 bits wherever the u32 original
would have wrapped, so every packed word is bit-equal to the JAX one.

Two packings serve the brick backend:

* brick-major global codes (``pack_brick_keys``): 60 bits over two words,
  (bx, by, bz, offset) in lexicographic order with lo's low 4 bits zero;
  the stored brick identity has offset bits zero.
* box-relative compact keys (``pack_box_keys``): one word
  ``bx:ax | by:ay | bz:az | offc:o`` relative to a brick-aligned per-window
  box origin from the host gate ``compute_window_boxes``.  Valid keys are
  below 2^31, so ``EMPTY32`` is unreachable.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

AXIS_BITS = 20
U32 = 0xFFFFFFFF
EMPTY_HI = U32   # empty table slot / invalid candidate (sorts last)
EMPTY32 = U32    # invalid compact key

# box margin beyond max_range around the window's sensor positions
BOX_MARGIN_VOXELS = 2


def brick_layout(brick_bits: int):
    """(axis_bits, off_bits, lo_by_bits) field layout for a brick packing."""
    if not 1 <= brick_bits <= 3:
        raise ValueError(f"brick_bits must be 1..3, got {brick_bits}")
    a = AXIS_BITS - brick_bits        # bits per brick axis
    o = 3 * brick_bits                # offset bits
    lo_by = 28 - (o + a)              # low bits of by that land in lo
    return a, o, lo_by


def _offset_code(off: torch.Tensor, brick_bits: int) -> torch.Tensor:
    """(N, 3) in-brick offsets -> x_off << 2b | y_off << b | z_off."""
    off = off.to(torch.int64)
    return (
        (off[..., 0] << (2 * brick_bits))
        | (off[..., 1] << brick_bits)
        | off[..., 2]
    )


def pack_brick_keys(
    keys: torch.Tensor, brick_bits: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, 3) int voxel keys -> (hi, lo, in_range) with brick-major order.

    lo bits: [31 .. o+a+4] by low bits, [o+a+3 .. o+4] bz,
    [o+3 .. 4] offset, [3 .. 0] zero; hi carries bx and by's high bits.
    Out-of-range keys give a meaningless code; mask with ``in_range``.
    """
    a, o, lo_by = brick_layout(brick_bits)
    bias = 1 << (a - 1)
    keys = keys.to(torch.int64)
    bk = (keys >> brick_bits) + bias
    off = keys & ((1 << brick_bits) - 1)
    amax = (1 << a) - 1
    in_range = ((bk >= 0) & (bk <= amax)).all(dim=-1)
    # exclude the all-ones bx plane so hi == EMPTY_HI is unreachable
    in_range = in_range & (bk[..., 0] < amax)
    bx, by, bz = bk[..., 0], bk[..., 1], bk[..., 2]
    hi = ((bx << (o + 2 * a - 28)) | ((by & U32) >> lo_by)) & U32
    lo = (
        ((by & ((1 << lo_by) - 1)) << (o + a + 4))
        | (bz << (o + 4))
        | (_offset_code(off, brick_bits) << 4)
    ) & U32
    return hi, lo, in_range


def unpack_brick_keys(
    hi: torch.Tensor, lo: torch.Tensor, brick_bits: int
) -> torch.Tensor:
    """Inverse of pack_brick_keys -> (N, 3) int64 voxel keys (ignores the
    low 4 frame bits of lo)."""
    a, o, lo_by = brick_layout(brick_bits)
    bias = 1 << (a - 1)
    bx = hi >> (o + 2 * a - 28)
    by = ((hi & ((1 << (a - lo_by)) - 1)) << lo_by) | (
        (lo >> (o + a + 4)) & ((1 << lo_by) - 1)
    )
    bz = (lo >> (o + 4)) & ((1 << a) - 1)
    off = (lo >> 4) & ((1 << o) - 1)
    b = (1 << brick_bits) - 1
    offs = torch.stack(
        [off >> (2 * brick_bits), (off >> brick_bits) & b, off & b], dim=-1
    )
    bk = torch.stack([bx, by, bz], dim=-1) - bias
    return (bk << brick_bits) + offs


def pack_box_keys(
    keys: torch.Tensor,
    box_min: torch.Tensor,
    box_bits: Tuple[int, int, int],
    brick_bits: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 3) int voxel keys -> ((N,) box key as int64, (N,) in_box).

    ``box_min`` (3,) is the brick-aligned box-origin voxel key and
    ``box_bits`` the per-axis BRICK bits (ax, ay, az).  Out-of-box keys
    give a meaningless (but u32-exact) code; mask with ``in_box``.
    """
    ax, ay, az = box_bits
    o = 3 * brick_bits
    rel = keys.to(torch.int64) - box_min.to(torch.int64)
    bk = rel >> brick_bits
    off = rel & ((1 << brick_bits) - 1)
    in_box = (
        (bk >= 0).all(dim=-1)
        & (bk[..., 0] < 1 << ax)
        & (bk[..., 1] < 1 << ay)
        & (bk[..., 2] < 1 << az)
    )
    key = (
        (bk[..., 0] << (ay + az + o))
        | (bk[..., 1] << (az + o))
        | (bk[..., 2] << o)
        | _offset_code(off, brick_bits)
    ) & U32
    return key, in_box


def unpack_box_brick(
    brick_id: torch.Tensor,
    box_min: torch.Tensor,
    box_bits: Tuple[int, int, int],
    brick_bits: int,
) -> torch.Tensor:
    """(N,) box brick ids (box key >> 3*brick_bits) -> (N, 3) int64 global
    voxel keys of each brick's corner (brick-aligned)."""
    ax, ay, az = box_bits
    bx = brick_id >> (ay + az)
    by = (brick_id >> az) & ((1 << ay) - 1)
    bz = brick_id & ((1 << az) - 1)
    return box_min.to(torch.int64) + (
        torch.stack([bx, by, bz], dim=-1) << brick_bits
    )


def compute_window_boxes(
    positions,
    max_range: float,
    resolution: float,
    window: int,
    brick_bits: int,
    frame_bits: int,
):
    """Host gate: per-window box origins + static per-axis brick bits.

    ``positions`` (P, 3) float64 sensor origins (every candidate lies
    within ``max_range`` of its ping's origin).  Returns
    ``(box_mins (n_windows, 3) int32, (ax, ay, az))``, or None when the key
    width exceeds the u32 budget (V + max(1, frame_bits) > 31) or a box
    would leave the global packable range.
    """
    positions = np.asarray(positions, np.float64).reshape(-1, 3)
    P = len(positions)
    if P == 0:
        return None
    brick = 1 << brick_bits
    reach = float(max_range) + BOX_MARGIN_VOXELS * float(resolution)
    mins, extents = [], []
    for w in range(0, P, window):
        seg = positions[w : w + window]
        lo = np.floor((seg.min(axis=0) - reach) / resolution).astype(np.int64)
        hi = np.floor((seg.max(axis=0) + reach) / resolution).astype(np.int64)
        bm = (lo >> brick_bits) << brick_bits  # brick-align down (floors)
        mins.append(bm)
        extents.append(hi - bm + 1)
    mins = np.stack(mins)
    n_bricks = (np.stack(extents).max(axis=0) + brick - 1) // brick
    bits = tuple(int(max(1, np.ceil(np.log2(b)))) for b in n_bricks)
    V = sum(bits) + 3 * brick_bits
    if V + max(1, frame_bits) > 31:
        return None
    a = AXIS_BITS - brick_bits
    gmax = ((1 << (a - 1)) - 1) << brick_bits
    gmin = -(1 << (a - 1)) << brick_bits
    span = (np.array([1 << b for b in bits], np.int64) << brick_bits)
    if (mins < gmin).any() or (mins + span > gmax).any():
        return None
    return mins.astype(np.int32), bits


def mix2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche of a packed key (murmur3 finalizer over a simple
    combine), on int64 carriers of u32 words: every product is masked to
    32 bits before the next shift, so ``>>`` stays logical."""
    h = ((hi * 0x9E3779B1) & U32) ^ ((lo * 0x85EBCA6B) & U32)
    h = ((h ^ (h >> 16)) * 0x85EBCA6B) & U32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & U32
    return h ^ (h >> 16)
