"""Multi-host ping-stream split through precomputed frame records (PyTorch
port of ``sonar_3d_reconstruction_tpu.parallel.multihost``).

The adaptive log-odds update reads the pre-frame map
(3d_mapper.py:95-102), so maps merged from separate hosts would depend on
the merge order.  The exact split follows from the records half of the
update (ops/records.py):

  * a frame's unique-voxel records do not depend on the map, so any host
    computes the records of its slice of the bag with no communication
    (``records_for_segment``: backprojection, packing and the per-frame
    dedup, on that host's card);
  * only the apply must run in stream order, on the host that owns the
    map (``apply_record_segments``).

So every host computes its segment's records, ships them as flat host
arrays, and one host folds them in order.  The map equals
``pipeline.map_ping_sequence``'s voxel by voxel.  A brick map's table
slots may differ from it: the fold always takes two-word brick codes
(``grid.brick.apply_brick_records_wide``, through the binning kernel K1)
where the pipeline may take compact box keys.  A hash map folds with
``grid.hash.apply_records_batched``.

The module calls no collective; ``map_ping_sequence_multihost`` runs the
segments' producers one after another in one process.  Records carry each
frame's exact unique count (no budget), so the JAX wrapper's
``unique_overflow`` and ``batch_overflow`` branches (doubling a budget and
recomputing the records or replaying the fold) have no counterpart here:
the fold is count-sized (the fixed-width budgets are the single-map
pipeline's; ROADMAP queues the fold's).  A window that would
overflow a table bucket grows the table and replays; keys outside the
packable range and, on bricks, voxels with 2^16+ emissions in one frame
are fatal.
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.device import require_cuda, to_device
from sonar_3d_reconstruction_tpu_torch.geometry import batched_sonar_to_world
from sonar_3d_reconstruction_tpu_torch.grid.brick import (
    BrickGridState,
    apply_brick_records_wide,
    init_brick_grid,
    rehash_bricks,
)
from sonar_3d_reconstruction_tpu_torch.grid.hash import (
    HashGridState,
    apply_records_batched,
    init_hash_grid,
    rehash,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
    resolve_capped_tables,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import UniqueRecords
from sonar_3d_reconstruction_tpu_torch.ops.packing import EMPTY_HI, U32
from sonar_3d_reconstruction_tpu_torch.ops.records import (
    FrameAux,
    frame_records,
)
from sonar_3d_reconstruction_tpu_torch.pipeline import (
    MAX_GROW_RETRIES,
    check_state_backend,
)

SparseState = Union[BrickGridState, HashGridState]


class SegmentRecords(NamedTuple):
    """A bag segment's unique records on the host, flat: frame i's records
    are the ``n_unique[i]`` lanes after the earlier frames' lanes, in key
    order (two-word keys: brick codes for a brick map, voxel codes for a
    hash map)."""

    hi: np.ndarray        # (N,) uint32 key words
    lo: np.ndarray        # (N,) uint32
    count: np.ndarray     # (N,) int32 candidates in the voxel that frame
    n_occ: np.ndarray     # (N,) int32 occupied-type candidates
    n_unique: np.ndarray  # (P,) int64 records of each frame


def _empty_segment(dtype: torch.dtype) -> Tuple[SegmentRecords, FrameAux]:
    u32, i32 = np.zeros(0, np.uint32), np.zeros(0, np.int32)
    bounds = torch.empty((0, 3), dtype=dtype).numpy()
    return (
        SegmentRecords(u32, u32.copy(), i32, i32.copy(), np.zeros(0, np.int64)),
        FrameAux(cmin=bounds, cmax=bounds.copy(), range_fail=np.zeros(0, bool),
                 n_valid=np.zeros(0, np.int64)),
    )


def records_for_segment(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: MapperConfig,
    *,
    dtype: torch.dtype = torch.float32,
    brick_bits: int = 0,
    device=None,
) -> Tuple[SegmentRecords, FrameAux]:
    """Records of a contiguous bag segment (no map state), computed on
    ``device`` (the first CUDA device when None; RuntimeError where there
    is none) and returned as host NumPy ready to ship: (SegmentRecords,
    FrameAux with a leading frame axis).  ``brick_bits`` > 0 gives brick
    codes for a brick map of that brick size, 0 voxel codes for a hash
    map."""
    device = (require_cuda() if device is None
              else torch.empty(0, device=device).device)
    images = np.asarray(images)
    P = images.shape[0]
    if P == 0:
        return _empty_segment(dtype)
    tables = resolve_capped_tables(images, cfg, *images.shape[1:])
    T = batched_sonar_to_world(positions, quaternions, cfg)
    images_dev = to_device(images, device)
    T_dev = torch.as_tensor(T, device=device).to(dtype)
    lanes, auxs, n_unique = [], [], []
    for i in range(P):
        rec, aux = frame_records(images_dev[i], T_dev[i], tables, cfg, None,
                                 None, brick_bits, dtype=dtype)
        n = int(rec.n_unique)
        lanes.append(torch.stack([rec.hi[:n], rec.lo[:n], rec.count[:n],
                                  rec.n_occ[:n]]))
        auxs.append(aux)
        n_unique.append(n)
    # int64 -> int32 keeps the low 32 bits: the u32 words' bit patterns
    flat = torch.cat(lanes, dim=1).to(torch.int32).cpu().numpy()
    recs = SegmentRecords(
        hi=flat[0].view(np.uint32), lo=flat[1].view(np.uint32),
        count=flat[2], n_occ=flat[3], n_unique=np.asarray(n_unique, np.int64),
    )
    return recs, FrameAux(*(torch.stack(x).cpu().numpy() for x in zip(*auxs)))


def apply_record_segments(
    state: SparseState,
    segments: Iterable[Tuple[SegmentRecords, FrameAux]],
    cfg: MapperConfig,
    *,
    window: int = 8,
    start: int = 0,
) -> Tuple[SparseState, List[dict]]:
    """Fold record segments into the map in order, in windows of up to
    ``window`` frames that never span a segment boundary.

    ``segments`` are ordered by stream time and carry the key layout of
    ``state``'s backend (``records_for_segment(brick_bits=
    state.brick_bits)`` for a brick map, 0 for a hash map).  ``start``
    skips the first ``start`` frames across segments (the replay cursor);
    the windows after it start at its frame.  Returns (state, per-frame
    stats dicts of the frames it applied).  The fold stops at the first
    failed window: its frames are the last ones listed, with
    ``overflowed`` set, and the returned state is poisoned with nothing
    of that window applied.
    """
    if isinstance(state, BrickGridState):
        apply = apply_brick_records_wide
    elif isinstance(state, HashGridState):
        apply = apply_records_batched
    else:
        raise ValueError(f"cannot fold records into {type(state).__name__}; "
                         f"use a brick or hash map")
    device = state.log_odds.device
    all_stats: List[dict] = []
    skip = int(start)
    for recs, auxs in segments:
        P = len(recs.n_unique)
        first = min(skip, P)
        skip -= first
        if first == P:
            continue
        begin = np.concatenate([[0], np.cumsum(recs.n_unique)])
        base = int(begin[first])
        # the segment's lanes from frame ``first`` on, then one empty lane
        # that padded positions read
        lanes = np.stack([recs.hi[base:].view(np.int32),
                          recs.lo[base:].view(np.int32),
                          recs.count[base:], recs.n_occ[base:]])
        lanes = torch.as_tensor(lanes, device=device).to(torch.int64)
        lanes[:2] &= U32
        empty = torch.tensor([[EMPTY_HI], [EMPTY_HI], [0], [0]], device=device)
        lanes = torch.cat([lanes, empty], dim=1)
        pad = lanes.shape[1] - 1
        for f0 in range(first, P, window):
            f1 = min(f0 + window, P)
            n = torch.as_tensor(recs.n_unique[f0:f1], device=device)
            width = max(1, int(recs.n_unique[f0:f1].max()))
            col = torch.arange(width, device=device)
            start_lane = torch.as_tensor(begin[f0:f1] - base, device=device)
            idx = torch.where(col < n[:, None], start_lane[:, None] + col, pad)
            hi, lo, count, n_occ = lanes[:, idx]
            w_aux = FrameAux(*(torch.as_tensor(x[f0:f1], device=device)
                               for x in auxs))
            state, win = apply(state, UniqueRecords(hi, lo, count, n_occ, n),
                               w_aux, cfg)
            win = {k: v.cpu().numpy() for k, v in win.items()}
            all_stats.extend({k: v[i] for k, v in win.items()}
                             for i in range(f1 - f0))
            if win["overflowed"][0]:
                return state, all_stats
    return state, all_stats


def map_ping_sequence_multihost(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: Optional[MapperConfig] = None,
    *,
    n_hosts: int = 2,
    window: int = 8,
    backend: str = "brick",
    dtype: torch.dtype = torch.float32,
    initial_capacity: int = 1 << 20,
    state: Optional[SparseState] = None,
    device=None,
) -> Tuple[SparseState, List[dict]]:
    """Map a recorded ping sequence through the multi-host split on
    ``device`` (the first CUDA device when None; RuntimeError where there
    is none): cut the stream into ``n_hosts`` contiguous segments, compute
    each segment's records as its host would, fold them in stream order,
    and on a bucket overflow grow the table (``rehash_bricks`` /
    ``rehash``) and replay from the failed window's first frame.

    ``backend`` is ``"brick"`` (the default; a fresh map holds
    ``max(128, initial_capacity >> 4)`` bricks) or ``"hash"``
    (``initial_capacity`` slots); ``state`` resumes a map of that backend.
    The map equals ``pipeline.map_ping_sequence``'s with the same backend
    voxel by voxel.  Returns (state, per-frame stats dicts).
    """
    cfg = cfg or MapperConfig()
    if backend not in ("brick", "hash"):
        raise ValueError(f"backend {backend!r}: the multi-host fold takes "
                         f"'brick' or 'hash'")
    check_state_backend(state, backend)
    device = (require_cuda() if device is None
              else torch.empty(0, device=device).device)
    if state is None:
        state = (init_brick_grid(max(128, initial_capacity >> 4), dtype, device)
                 if backend == "brick"
                 else init_hash_grid(initial_capacity, dtype, device))
    if state.log_odds.device != device or state.log_odds.dtype != dtype:
        raise ValueError(
            f"state is {state.log_odds.dtype} on {state.log_odds.device}, "
            f"not {dtype} on {device}"
        )
    images = np.asarray(images)
    P = images.shape[0]
    if P == 0:
        return state, []
    brick_bits = state.brick_bits if backend == "brick" else 0
    bounds = np.linspace(0, P, n_hosts + 1).astype(int)
    segments = [
        records_for_segment(images[a:b], positions[a:b], quaternions[a:b],
                            cfg, dtype=dtype, brick_bits=brick_bits,
                            device=device)
        for a, b in zip(bounds[:-1], bounds[1:]) if b > a
    ]
    grow = rehash_bricks if backend == "brick" else rehash
    applied: List[dict] = [None] * P
    start = 0
    for _ in range(MAX_GROW_RETRIES):
        new_state, stats = apply_record_segments(
            state, segments, cfg, window=window, start=start
        )
        n_ok = next((i for i, s in enumerate(stats) if s["overflowed"]),
                    len(stats))
        applied[start:start + n_ok] = stats[:n_ok]
        if n_ok == len(stats):
            return new_state, applied
        start += n_ok
        failed = stats[n_ok:]
        if any(s["range_fail"] for s in failed):
            raise ValueError(
                f"frame >= {start}: voxel keys outside the packable range "
                "— check odometry frame offsets; growth cannot fix this"
            )
        if any(s.get("pack_overflow", False) for s in failed):
            raise ValueError(
                f"frame >= {start}: a voxel received 2^16+ emissions in one "
                "frame (count packing width)"
            )
        state = grow(new_state, new_state.capacity * 2)
    raise RuntimeError(
        f"multi-host growth did not converge after {MAX_GROW_RETRIES} retries"
    )
