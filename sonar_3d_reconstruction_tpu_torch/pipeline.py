"""Ping-sequence pipeline, brick backend (PyTorch port of the brick path of
``sonar_3d_reconstruction_tpu.pipeline``).

``map_ping_sequence`` maps a recorded sequence window by window: per ping,
records (ops/records.py); per window, one apply to the brick map
(grid/brick.py) through the binning kernel K1.  The host loop is eager;
each window syncs a few sizes (the largest frame's unique count, the
window's lanes and bricks, its failure flags) to size its tensors from the
actual counts.

``dense_mode="pallas"`` (the default) dedups each ping's candidates into
unique records; ``"pallas-raw"`` skips the per-ping dedup and hands every
candidate to K1's raw form, which sums them per slot: the same map and
per-ping unique stats, from more record lanes.

The map grows on demand: a window that would overflow a table bucket is
rejected whole, the table doubles (``rehash_bricks``) and the sequence
replays from that window.  Keys outside the packable range and voxels with
2^16+ emissions in one frame are fatal (ValueError), as growth cannot fix
them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.device import require_cuda
from sonar_3d_reconstruction_tpu_torch.geometry import batched_sonar_to_world
from sonar_3d_reconstruction_tpu_torch.grid.brick import (
    BrickGridState,
    apply_brick_records_compact,
    init_brick_grid,
    is_raw_mode,
    rehash_bricks,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
    FanTables,
    resolve_capped_tables,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import CompactRecords
from sonar_3d_reconstruction_tpu_torch.ops.packing import compute_window_boxes
from sonar_3d_reconstruction_tpu_torch.ops.records import FrameAux, frame_records

# per-ping stats and their host dtypes
STAT_DTYPES = {
    "num_occupied": np.int64,
    "num_free": np.int64,
    "num_candidates": np.int64,
    "overflowed": bool,
    "range_fail": bool,
    "pack_overflow": bool,
    "batch_n_bricks": np.int64,
    "batch_n_lanes": np.int64,
}

DEFAULT_BRICK_CAPACITY = 1 << 15
# table doublings one sequence may need before mapping gives up
MAX_GROW_RETRIES = 12


def _window_records(
    images: torch.Tensor,
    transforms: torch.Tensor,
    frames: range,
    box_min: np.ndarray,
    *,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype,
    box_bits: Tuple[int, int, int],
    brick_bits: int,
    dense_mode: str = "pallas",
) -> Tuple[CompactRecords, FrameAux]:
    """Records of a window's frames, stacked along a leading frame axis.

    Unique records are a prefix of their lanes and are cut to the widest
    frame's unique count (one sync).  Raw candidates sit wherever the
    candidate lattice put them, so they keep their full width: a cut would
    drop valid candidates."""
    raw = is_raw_mode(dense_mode)
    box_min_t = torch.as_tensor(box_min, device=images.device)
    outs = [
        frame_records(
            images[i], transforms[i], tables, cfg, box_min_t, box_bits,
            brick_bits, dtype=dtype, raw=raw,
        )
        for i in frames
    ]
    recs = CompactRecords(*(torch.stack(x) for x in zip(*(r for r, _ in outs))))
    auxs = FrameAux(*(torch.stack(x) for x in zip(*(a for _, a in outs))))
    if raw:
        return recs, auxs
    width = max(1, int(recs.n_unique.max()))
    return recs._replace(
        key=recs.key[:, :width], payload=recs.payload[:, :width]
    ), auxs


def scan_pings_brick(
    state: BrickGridState,
    images: torch.Tensor,
    transforms: torch.Tensor,
    start: int = 0,
    *,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype,
    window: int,
    boxes,
    dense_mode: str = "pallas",
) -> Tuple[BrickGridState, Dict[str, np.ndarray]]:
    """Apply pings [start, P) window by window; returns (state, per-ping
    stats (P,) on the host).

    ``boxes`` = (box_mins (n_windows, 3), box_bits) from
    ``compute_window_boxes`` over the partition ``range(0, P, window)``;
    ``start`` is a window boundary.  The scan stops at the first failed
    window: it and every later ping report ``overflowed`` and the returned
    state is poisoned, with nothing of the failed window applied.
    """
    P = images.shape[0]
    if start % window:
        raise ValueError(f"start {start} is not a multiple of window {window}")
    box_mins, box_bits = boxes
    stats = {k: np.zeros(P, dt) for k, dt in STAT_DTYPES.items()}
    for w0 in range(start, P, window):
        w1 = min(w0 + window, P)
        recs, auxs = _window_records(
            images, transforms, range(w0, w1), box_mins[w0 // window],
            tables=tables, cfg=cfg, dtype=dtype, box_bits=box_bits,
            brick_bits=state.brick_bits, dense_mode=dense_mode,
        )
        state, win = apply_brick_records_compact(
            state, recs, auxs, cfg, box_mins[w0 // window], box_bits,
            dense_mode=dense_mode,
        )
        for k, v in win.items():
            stats[k][w0:w1] = v.cpu().numpy()
        if stats["overflowed"][w0]:
            stats["overflowed"][w1:] = True
            break
    return state, stats


def map_ping_sequence(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: Optional[MapperConfig] = None,
    *,
    device=None,
    backend: str = "brick",
    state: Optional[BrickGridState] = None,
    dtype: torch.dtype = torch.float32,
    window: int = 1,
    dense_mode: str = "pallas",
) -> Tuple[BrickGridState, Dict[str, np.ndarray]]:
    """Map a whole recorded ping sequence on ``device``: the first CUDA
    device when it is None (RuntimeError where there is none; pass "cpu"
    to map on the CPU).

    ``images`` (P, range_bins, bearing_bins) polar intensity images;
    ``positions`` (P, 3) and ``quaternions`` (P, 4) xyzw odometry poses.
    ``state`` resumes an existing map (default: a fresh one of
    ``DEFAULT_BRICK_CAPACITY`` bricks on ``device``).  Only the brick
    backend over compact box keys is ported; a survey whose per-window
    extent needs wider keys raises ValueError.  ``dense_mode`` is
    ``"pallas"`` (per-ping dedup, unique records) or ``"pallas-raw"`` (raw
    candidates summed by the kernel); both give the same map.

    Returns (final state, per-ping stats: ``num_occupied`` / ``num_free``
    unique voxels by type, ``num_candidates`` valid emissions,
    ``overflowed`` and the failure causes, the window sizes).
    """
    cfg = cfg or MapperConfig()
    if backend != "brick":
        raise ValueError(f"backend {backend!r} is not ported; use 'brick'")
    is_raw_mode(dense_mode)
    # canonical form ("cuda" -> "cuda:0"), as tensors report their device
    device = (require_cuda() if device is None
              else torch.empty(0, device=device).device)
    if state is None:
        state = init_brick_grid(DEFAULT_BRICK_CAPACITY, dtype, device)
    if state.log_odds.device != device or state.log_odds.dtype != dtype:
        raise ValueError(
            f"state is {state.log_odds.dtype} on {state.log_odds.device}, "
            f"not {dtype} on {device}"
        )
    images = np.asarray(images)
    P, R, B = images.shape
    if P == 0:
        return state, {k: np.zeros(0, dt) for k, dt in STAT_DTYPES.items()}

    tables = resolve_capped_tables(images, cfg, R, B)
    T = batched_sonar_to_world(positions, quaternions, cfg)
    window = min(max(window, 1), P)
    boxes = compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, window,
        state.brick_bits, frame_bits=max(1, (window - 1).bit_length()),
    )
    if boxes is None:
        raise ValueError(
            "the survey's per-window extent does not fit 31-bit box keys; "
            "the wide two-word key path is not ported"
        )
    images_dev = torch.as_tensor(images, device=device)
    T_dev = torch.as_tensor(T, device=device).to(dtype)

    merged = {k: np.zeros(P, dt) for k, dt in STAT_DTYPES.items()}
    start = 0
    for _ in range(MAX_GROW_RETRIES):
        new_state, stats = scan_pings_brick(
            state, images_dev, T_dev, start, tables=tables, cfg=cfg,
            dtype=dtype, window=window, boxes=boxes, dense_mode=dense_mode,
        )
        over = stats["overflowed"]
        applied_hi = int(np.argmax(over)) if over.any() else P
        for k, v in stats.items():
            merged[k][start:applied_hi] = v[start:applied_hi]
        if applied_hi == P:
            return new_state, merged
        start = applied_hi
        if stats["range_fail"][start:].any():
            raise ValueError(
                f"frame >= {start}: voxel keys outside the packable range "
                "— check odometry frame offsets; growth cannot fix this"
            )
        if stats["pack_overflow"][start:].any():
            raise ValueError(
                f"frame >= {start}: a voxel received 2^16+ emissions in one "
                "frame (count packing width)"
            )
        state = rehash_bricks(new_state, new_state.capacity * 2)
    raise RuntimeError(
        f"brick growth did not converge after {MAX_GROW_RETRIES} retries"
    )
