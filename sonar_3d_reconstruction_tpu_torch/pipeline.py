"""Ping-sequence pipeline (PyTorch port of
``sonar_3d_reconstruction_tpu.pipeline``: the brick, hash and dense
backends).

``map_ping_sequence`` maps a recorded sequence window by window: per ping,
records (ops/records.py); per window, one apply to the map.  The host loop
is eager; each window syncs a few sizes (the largest frame's unique count,
the window's lanes and bricks or voxels, its failure flags) to size its
tensors from the actual counts.  On the brick backend ``records_batch``
computes the records of several pings in one set of tensor ops, and
``window_group`` computes several windows' records before their applies
(``scan_pings_brick``); neither changes the map.

Brick backend (grid/brick.py, through the binning kernel K1).  A sequence
whose every window fits compact box keys (``compute_window_boxes``) takes
them; otherwise every window takes two-word brick codes, as in the JAX
package.  ``dense_mode="pallas"`` (the default) dedups each ping's
candidates into unique records; ``"pallas-raw"`` skips the per-ping dedup
and hands every candidate to K1's raw form, which sums them per slot: the
same map and per-ping unique stats, from more record lanes.  Raw records
need box keys, so wide windows take unique records in either mode.

Hash backend (grid/hash.py): window 1 applies each ping with
``update_hash_grid``; a larger window applies its pings' voxel-code
records with ``apply_records_batched``.

Dense backend (grid/dense.py): each ping is one ``update_dense_grid``
into a bounded grid (default +-(max_range + 2 m), as in the JAX package),
written in place into a copy of the given state.  It never grows and has
no range failure: candidates outside the grid count into ``overflow``.
``window`` and ``dense_mode`` do not apply to it.

The brick and hash maps grow on demand: a window that would overflow a
table bucket is rejected whole, the table doubles (``rehash_bricks`` /
``rehash``) and the sequence replays from that window.  Keys outside the
packable range and, in the brick backend, voxels with 2^16+ emissions in
one frame are fatal (ValueError), as growth cannot fix them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.device import require_cuda, to_device
from sonar_3d_reconstruction_tpu_torch.geometry import batched_sonar_to_world
from sonar_3d_reconstruction_tpu_torch.grid import check_state_backend
from sonar_3d_reconstruction_tpu_torch.grid.brick import (
    BrickGridState,
    apply_brick_records_compact,
    apply_brick_records_wide,
    init_brick_grid,
    is_raw_mode,
    rehash_bricks,
)
from sonar_3d_reconstruction_tpu_torch.grid.dense import (
    DenseGridSpec,
    DenseGridState,
    copy_dense_grid,
    default_dense_spec,
    init_dense_grid,
    update_dense_grid_,
)
from sonar_3d_reconstruction_tpu_torch.grid.hash import (
    HashGridState,
    apply_records_batched,
    init_hash_grid,
    rehash,
    update_hash_grid,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
    FanTables,
    backproject_ping,
    tables_for_images,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import CompactRecords, UniqueRecords
from sonar_3d_reconstruction_tpu_torch.ops.packing import compute_window_boxes
from sonar_3d_reconstruction_tpu_torch.ops.records import (
    FrameAux,
    frame_records,
    stack_frame_records,
)

# per-ping stats of each backend and their host dtypes
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
HASH_STAT_DTYPES = {
    "num_occupied": np.int64,
    "num_free": np.int64,
    "num_candidates": np.int64,
    "overflowed": bool,
    "range_fail": bool,
    "batch_n_unique": np.int64,
}
DENSE_STAT_DTYPES = {
    "num_occupied": np.int64,
    "num_free": np.int64,
    "num_candidates": np.int64,
}

DEFAULT_BRICK_CAPACITY = 1 << 15
DEFAULT_HASH_CAPACITY = 1 << 20
# table doublings one sequence may need before mapping gives up
MAX_GROW_RETRIES = 12

_BACKENDS = ("brick", "hash", "dense")

MapState = Union[BrickGridState, HashGridState, DenseGridState]


def _window_records(
    images: torch.Tensor,
    transforms: torch.Tensor,
    frames: range,
    box_min: Optional[np.ndarray],
    *,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype,
    box_bits: Optional[Tuple[int, int, int]],
    brick_bits: int,
    raw: bool = False,
    records_batch: int = 1,
) -> List[Tuple[Union[CompactRecords, UniqueRecords], FrameAux]]:
    """Records of a window's ``frames`` in frame order, for
    ``stack_frame_records``: compact box keys with a box (raw candidates
    when ``raw``), two-word keys without one (brick codes when
    ``brick_bits`` > 0, voxel codes when it is 0).  One ``frame_records``
    call a frame when ``records_batch`` <= 1, else one a batch of up to
    ``records_batch`` frames (the last batch takes what is left)."""
    box_min_t = (None if box_min is None
                 else torch.as_tensor(box_min, device=images.device))
    kw = dict(dtype=dtype, raw=raw)
    if records_batch <= 1:
        return [frame_records(images[i], transforms[i], tables, cfg,
                              box_min_t, box_bits, brick_bits, **kw)
                for i in frames]
    return [
        frame_records(images[i:i + records_batch],
                      transforms[i:i + records_batch], tables, cfg,
                      box_min_t, box_bits, brick_bits, **kw)
        for i in range(frames.start, frames.stop, records_batch)
    ]


def _record_stats(stats, win, w0: int, w1: int) -> bool:
    """Copy one window's stats into the sequence's host arrays; whether it
    failed, in which case every later ping reports ``overflowed``."""
    for k, v in win.items():
        stats[k][w0:w1] = v.cpu().numpy()
    if stats["overflowed"][w0]:
        stats["overflowed"][w1:] = True
        return True
    return False


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
    records_batch: int = 1,
    window_group: int = 1,
) -> Tuple[BrickGridState, Dict[str, np.ndarray]]:
    """Apply pings [start, P) window by window; returns (state, per-ping
    stats (P,) on the host).

    ``boxes`` = (box_mins (n_windows, 3), box_bits) from
    ``compute_window_boxes`` over the partition ``range(0, P, window)``, or
    None for two-word brick codes in every window; ``start`` is a window
    boundary.  The scan stops at the first failed window: it and every
    later ping report ``overflowed`` and the returned state is poisoned,
    with nothing of the failed window applied.

    ``records_batch`` B > 1 computes a window's records B frames at a time
    (one set of tensor ops a batch instead of a frame, B times the records
    intermediates); B snaps to gcd(B, window), as in the JAX package, so a
    batch never spans two windows, and a short last window takes a smaller
    last batch.  1 computes them frame by frame, and so does 0 (the JAX
    package's full unroll: there is no program here to unroll).
    ``window_group`` G > 1 (box keys only, as in the JAX package) computes
    the records of G consecutive windows before applying them in order:
    one width sync a group instead of one a window, G windows of records
    held at once; each window keeps its own apply, and a failed window
    stops the scan before the group's later windows (whose records a
    growth replay computes again).  Neither changes the map or a stat.
    """
    P = images.shape[0]
    if start % window:
        raise ValueError(f"start {start} is not a multiple of window {window}")
    if records_batch < 0:
        raise ValueError(f"records_batch must be >= 0, got {records_batch}")
    if window_group < 1:
        raise ValueError(f"window_group must be >= 1, got {window_group}")
    records_batch = max(1, math.gcd(records_batch, window))
    group = 1 if boxes is None else window_group
    raw = is_raw_mode(dense_mode) and boxes is not None
    box_mins, box_bits = (None, None) if boxes is None else boxes
    stats = {k: np.zeros(P, dt) for k, dt in STAT_DTYPES.items()}
    wins = [(w0, min(w0 + window, P)) for w0 in range(start, P, window)]
    for g in range(0, len(wins), group):
        todo = wins[g:g + group]
        g0 = todo[0][0]
        # unique records are cut to the group's widest frame (one sync);
        # raw candidates keep their full width: a cut would drop some
        recs, auxs = stack_frame_records([
            out for w0, w1 in todo for out in _window_records(
                images, transforms, range(w0, w1),
                None if boxes is None else box_mins[w0 // window],
                tables=tables, cfg=cfg, dtype=dtype, box_bits=box_bits,
                brick_bits=state.brick_bits, raw=raw,
                records_batch=records_batch,
            )
        ], cut=not raw)
        for w0, w1 in todo:
            rec = type(recs)(*(x[w0 - g0:w1 - g0] for x in recs))
            aux = FrameAux(*(x[w0 - g0:w1 - g0] for x in auxs))
            if boxes is None:
                state, win = apply_brick_records_wide(state, rec, aux, cfg)
            else:
                state, win = apply_brick_records_compact(
                    state, rec, aux, cfg, box_mins[w0 // window], box_bits,
                    dense_mode=dense_mode,
                )
            if _record_stats(stats, win, w0, w1):
                return state, stats
    return state, stats


def scan_pings_hash(
    state: HashGridState,
    images: torch.Tensor,
    transforms: torch.Tensor,
    start: int = 0,
    *,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype,
    window: int,
) -> Tuple[HashGridState, Dict[str, np.ndarray]]:
    """Apply pings [start, P) to the hash map: one ``update_hash_grid`` a
    ping when ``window`` is 1, else one ``apply_records_batched`` a window
    of voxel-code records.  Returns and stops as ``scan_pings_brick``."""
    P = images.shape[0]
    if start % window:
        raise ValueError(f"start {start} is not a multiple of window {window}")
    stats = {k: np.zeros(P, dt) for k, dt in HASH_STAT_DTYPES.items()}
    for w0 in range(start, P, window):
        w1 = min(w0 + window, P)
        if window == 1:
            cand = backproject_ping(images[w0], transforms[w0], tables, cfg,
                                    dtype=dtype)
            state, win = update_hash_grid(state, cand, cfg)
        else:
            recs, auxs = stack_frame_records(_window_records(
                images, transforms, range(w0, w1), None, tables=tables,
                cfg=cfg, dtype=dtype, box_bits=None, brick_bits=0,
            ))
            state, win = apply_records_batched(state, recs, auxs, cfg)
        if _record_stats(stats, win, w0, w1):
            break
    return state, stats


def scan_pings_dense(
    state: DenseGridState,
    images: torch.Tensor,
    transforms: torch.Tensor,
    *,
    tables: FanTables,
    spec: DenseGridSpec,
    cfg: MapperConfig,
    dtype: torch.dtype,
) -> Tuple[DenseGridState, Dict[str, np.ndarray]]:
    """Apply every ping to a copy of the dense map ``state``, one
    ``update_dense_grid`` a ping; returns (state, per-ping stats (P,) on
    the host)."""
    state = copy_dense_grid(state)
    per_ping = []
    for image, T in zip(images, transforms):
        cand = backproject_ping(image, T, tables, cfg, dtype=dtype)
        state, stats = update_dense_grid_(state, cand, spec, cfg)
        per_ping.append(torch.stack([stats[k] for k in DENSE_STAT_DTYPES]))
    table = torch.stack(per_ping).cpu().numpy()
    return state, {k: table[:, i].astype(dt)
                   for i, (k, dt) in enumerate(DENSE_STAT_DTYPES.items())}


def map_ping_sequence(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: Optional[MapperConfig] = None,
    *,
    device=None,
    backend: str = "brick",
    state: Optional[MapState] = None,
    dtype: torch.dtype = torch.float32,
    window: int = 1,
    dense_mode: str = "pallas",
    tables: Optional[FanTables] = None,
    dense_spec: Optional[DenseGridSpec] = None,
    records_batch: int = 1,
    window_group: int = 1,
) -> Tuple[MapState, Dict[str, np.ndarray]]:
    """Map a whole recorded ping sequence on ``device``: the first CUDA
    device when it is None (RuntimeError where there is none; pass "cpu"
    to map on the CPU).

    ``images`` (P, range_bins, bearing_bins) polar intensity images;
    ``positions`` (P, 3) and ``quaternions`` (P, 4) xyzw odometry poses.
    ``backend`` is ``"brick"`` (the default), ``"hash"`` or ``"dense"``.
    ``state`` resumes an existing map of that backend (default: a fresh
    one of ``DEFAULT_BRICK_CAPACITY`` bricks, ``DEFAULT_HASH_CAPACITY``
    slots or ``dense_spec``'s cells on ``device``).  ``dense_spec`` (dense
    only) is the grid's geometry (default: +-(max_range + 2 m) at the
    voxel resolution).  ``dense_mode`` (brick only) is ``"pallas"`` (per-ping
    dedup, unique records) or ``"pallas-raw"`` (raw candidates summed by
    the kernel); both give the same map.  ``tables`` are the fan tables of
    the images' geometry (default: built with every lattice cap sized for
    these images); a caller that maps many short sequences of one geometry
    passes its own, so they are built once.  ``records_batch`` and
    ``window_group`` (brick only; ValueError on another backend unless 1)
    batch the records half as ``scan_pings_brick`` says; the map and the
    stats do not change.

    Returns (final state, per-ping stats: ``num_occupied`` / ``num_free``
    unique voxels by type, ``num_candidates`` valid emissions; on the
    brick and hash backends also ``overflowed`` and the failure causes and
    the window sizes).  The dense backend returns ``{}`` for no pings, as
    the JAX package does.
    """
    cfg = cfg or MapperConfig()
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use 'brick', "
                         f"'hash' or 'dense'")
    check_state_backend(state, backend)
    is_raw_mode(dense_mode)
    if backend != "brick" and (records_batch, window_group) != (1, 1):
        raise ValueError(
            f"records_batch and window_group batch the brick backend's "
            f"records; backend={backend!r} takes neither (got "
            f"{records_batch}, {window_group})"
        )
    # canonical form ("cuda" -> "cuda:0"), as tensors report their device
    device = (require_cuda() if device is None
              else torch.empty(0, device=device).device)
    if backend == "dense":
        dense_spec = dense_spec or default_dense_spec(cfg)
    if state is None:
        if backend == "brick":
            state = init_brick_grid(DEFAULT_BRICK_CAPACITY, dtype, device)
        elif backend == "hash":
            state = init_hash_grid(DEFAULT_HASH_CAPACITY, dtype, device)
        else:
            state = init_dense_grid(dense_spec, dtype, device)
    if state.log_odds.device != device or state.log_odds.dtype != dtype:
        raise ValueError(
            f"state is {state.log_odds.dtype} on {state.log_odds.device}, "
            f"not {dtype} on {device}"
        )
    if backend == "dense" and state.log_odds.shape[0] != dense_spec.num_cells:
        raise ValueError(
            f"dense state has {state.log_odds.shape[0]} cells, the spec "
            f"{dense_spec.num_cells}"
        )
    images = np.asarray(images)
    P, R, B = images.shape
    if P == 0:
        if backend == "dense":
            return state, {}
        stat_dtypes = STAT_DTYPES if backend == "brick" else HASH_STAT_DTYPES
        return state, {k: np.zeros(0, dt) for k, dt in stat_dtypes.items()}

    tables = tables_for_images(images, cfg, tables)
    T = batched_sonar_to_world(positions, quaternions, cfg)
    window = min(max(window, 1), P)
    images_dev = to_device(images, device)
    T_dev = torch.as_tensor(T, device=device).to(dtype)
    if backend == "dense":
        return scan_pings_dense(state, images_dev, T_dev, tables=tables,
                                spec=dense_spec, cfg=cfg, dtype=dtype)
    kw = dict(tables=tables, cfg=cfg, dtype=dtype, window=window)
    if backend == "brick":
        # box keys only if every window fits them, as in the JAX package
        kw.update(dense_mode=dense_mode, records_batch=records_batch,
                  window_group=window_group, boxes=compute_window_boxes(
            T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, window,
            state.brick_bits, frame_bits=max(1, (window - 1).bit_length()),
        ))
        scan, grow = scan_pings_brick, rehash_bricks
    else:
        scan, grow = scan_pings_hash, rehash

    stat_dtypes = STAT_DTYPES if backend == "brick" else HASH_STAT_DTYPES
    merged = {k: np.zeros(P, dt) for k, dt in stat_dtypes.items()}
    start = 0
    for _ in range(MAX_GROW_RETRIES):
        new_state, stats = scan(state, images_dev, T_dev, start, **kw)
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
        if backend == "brick" and stats["pack_overflow"][start:].any():
            raise ValueError(
                f"frame >= {start}: a voxel received 2^16+ emissions in one "
                "frame (count packing width)"
            )
        state = grow(new_state, new_state.capacity * 2)
    raise RuntimeError(
        f"{backend} growth did not converge after {MAX_GROW_RETRIES} retries"
    )
