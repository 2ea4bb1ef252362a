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
segments' producers one after another in one process.  Without budgets
the records carry each frame's exact unique count (``SegmentRecords``,
flat) and the fold sizes each window from its counts.  With the JAX
package's budgets the records are fixed-width ``(P, U)`` arrays
(``records_for_segment(unique_budget=)``, a frame with more records
reporting its overflow), and the fold runs every window at a fixed width
(``apply_record_segments(batch_budget=)``: the brick fold's brick budget,
the hash fold's batch budget) with no host read, its stats read once, a
failed window poisoning the map so that the later ones are no-ops.  The
wrapper then grows as the JAX one does: a unique overflow doubles the
unique budget and recomputes the records, a batch overflow doubles the
batch budget and replays the fold, anything else grows the table.  Keys
outside the packable range and, on bricks, voxels with 2^16+ emissions in
one frame are fatal.  Both give the same map.
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
    default_brick_budget,
    init_brick_grid,
    rehash_bricks,
)
from sonar_3d_reconstruction_tpu_torch.grid.hash import (
    HashGridState,
    apply_records_batched,
    default_unique_budget,
    init_hash_grid,
    rehash,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
    build_fan_tables,
    resolve_capped_tables,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import UniqueRecords
from sonar_3d_reconstruction_tpu_torch.ops.packing import EMPTY_HI, U32
from sonar_3d_reconstruction_tpu_torch.ops.records import (
    FrameAux,
    frame_records,
)
from sonar_3d_reconstruction_tpu_torch.pipeline import (
    BUDGET_STAT_DTYPES,
    HASH_BUDGET_STAT_DTYPES,
    MAX_GROW_RETRIES,
    _read_stats,
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


def default_segment_unique_budget(images: np.ndarray, cfg: MapperConfig) -> int:
    """The JAX fold's default unique budget of these (P, R, B) images: the
    default for the candidate lanes of their uncapped fan tables."""
    return default_unique_budget(
        build_fan_tables(cfg, *images.shape[1:]).candidates_per_ping(
            cfg.occupied_window))


def records_for_segment(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: MapperConfig,
    *,
    dtype: torch.dtype = torch.float32,
    brick_bits: int = 0,
    device=None,
    unique_budget: Optional[int] = None,
) -> Tuple[Union[SegmentRecords, UniqueRecords], FrameAux]:
    """Records of a contiguous bag segment (no map state), computed on
    ``device`` (the first CUDA device when None; RuntimeError where there
    is none) and returned as host NumPy ready to ship: (records, FrameAux
    with a leading frame axis).  ``brick_bits`` > 0 gives brick codes for
    a brick map of that brick size, 0 voxel codes for a hash map.

    Without ``unique_budget`` the records are ``SegmentRecords``, flat and
    count-sized (one host read a frame).  With it they are the JAX
    package's fixed-width form, read to the host once: ``UniqueRecords``
    of (P, U) NumPy arrays (uint32 key words, ``EMPTY_HI`` on unused
    lanes; int32 counts) and (P,) ``n_unique``, above U where the frame
    overflowed its budget."""
    device = (require_cuda() if device is None
              else torch.empty(0, device=device).device)
    images = np.asarray(images)
    P = images.shape[0]
    if P == 0:
        if unique_budget is None:
            return _empty_segment(dtype)
        u32 = np.full((0, unique_budget), EMPTY_HI, np.uint32)
        i32 = np.zeros((0, unique_budget), np.int32)
        return (UniqueRecords(u32, u32.copy(), i32, i32.copy(),
                              np.zeros(0, np.int64)),
                _empty_segment(dtype)[1])
    tables = resolve_capped_tables(images, cfg, *images.shape[1:])
    T = batched_sonar_to_world(positions, quaternions, cfg)
    images_dev = to_device(images, device)
    T_dev = torch.as_tensor(T, device=device).to(dtype)
    outs = [frame_records(images_dev[i], T_dev[i], tables, cfg, None, None,
                          brick_bits, dtype=dtype, unique_budget=unique_budget)
            for i in range(P)]
    aux = FrameAux(*(torch.stack(x).cpu().numpy()
                     for x in zip(*(a for _, a in outs))))
    if unique_budget is not None:
        # one copy of every lane; int64 -> int32 keeps the u32 bit patterns
        recs = [r for r, _ in outs]
        lanes = torch.stack([torch.stack(x) for x in zip(
            *(r[:4] for r in recs))]).to(torch.int32).cpu().numpy()
        n_unique = torch.stack([r.n_unique for r in recs]).cpu().numpy()
        return UniqueRecords(
            hi=lanes[0].view(np.uint32), lo=lanes[1].view(np.uint32),
            count=lanes[2], n_occ=lanes[3], n_unique=n_unique.astype(np.int64),
        ), aux
    lanes, n_unique = [], []
    for rec, _ in outs:
        n = int(rec.n_unique)
        lanes.append(torch.stack([rec.hi[:n], rec.lo[:n], rec.count[:n],
                                  rec.n_occ[:n]]))
        n_unique.append(n)
    # int64 -> int32 keeps the low 32 bits: the u32 words' bit patterns
    flat = torch.cat(lanes, dim=1).to(torch.int32).cpu().numpy()
    recs = SegmentRecords(
        hi=flat[0].view(np.uint32), lo=flat[1].view(np.uint32),
        count=flat[2], n_occ=flat[3], n_unique=np.asarray(n_unique, np.int64),
    )
    return recs, aux


def _fold_apply(state):
    if isinstance(state, BrickGridState):
        return apply_brick_records_wide
    if isinstance(state, HashGridState):
        return apply_records_batched
    raise ValueError(f"cannot fold records into {type(state).__name__}; "
                     f"use a brick or hash map")


def apply_record_segments(
    state: SparseState,
    segments: Iterable[Tuple[Union[SegmentRecords, UniqueRecords], FrameAux]],
    cfg: MapperConfig,
    *,
    window: int = 8,
    start: int = 0,
    batch_budget: Optional[int] = None,
) -> Tuple[SparseState, List[dict]]:
    """Fold record segments into the map in order, in windows of up to
    ``window`` frames that never span a segment boundary.

    ``segments`` are ordered by stream time and carry the key layout of
    ``state``'s backend (``records_for_segment(brick_bits=
    state.brick_bits)`` for a brick map, 0 for a hash map).  ``start``
    skips the first ``start`` frames across segments (the replay cursor);
    the windows after it start at its frame.  Returns (state, per-frame
    stats dicts).

    Count-sized segments (``SegmentRecords``) fold count-sized windows:
    the fold stops at the first failed window, whose frames are the last
    ones listed, with ``overflowed`` set, and the returned state is
    poisoned with nothing of that window applied.  Fixed-width segments
    (``records_for_segment(unique_budget=)``) fold every window at a
    fixed width with no host read (the brick fold's NB, the hash fold's
    distinct voxels: ``batch_budget``, default the JAX fold's:
    ``default_brick_budget(w, U)`` / ``min(w * U, 4 * U)``, w the
    segment's window) and list every frame, read in one copy at the end:
    a failed window poisons the map, so every later frame reports
    ``overflowed`` too (the JAX package's ``apply_record_segments``).
    """
    apply = _fold_apply(state)
    segments = list(segments)
    if any(isinstance(r, UniqueRecords) for r, _ in segments):
        return _fold_budgeted(state, segments, cfg, apply, window, start,
                              batch_budget)
    if batch_budget is not None:
        raise ValueError("batch_budget sizes a fold of fixed-width records: "
                         "make them with records_for_segment(unique_budget=)")
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


def _fold_budgeted(state, segments, cfg, apply, window, start, batch_budget):
    """``apply_record_segments`` over fixed-width segments (its
    docstring)."""
    device = state.log_odds.device
    brick = isinstance(state, BrickGridState)
    done, skip = [], int(start)
    for recs, auxs in segments:
        P = len(recs.n_unique)
        first = min(skip, P)
        skip -= first
        if first == P:
            continue
        u = recs.hi.shape[1]
        w = min(window, P - first)
        # one copy of the segment's lanes (u32 words back to int64)
        lanes = torch.as_tensor(np.stack([
            recs.hi[first:].view(np.int32), recs.lo[first:].view(np.int32),
            recs.count[first:], recs.n_occ[first:]]), device=device)
        lanes = lanes.to(torch.int64)
        lanes[:2] &= U32
        n_unique = torch.as_tensor(recs.n_unique[first:], device=device)
        aux = FrameAux(*(torch.as_tensor(x[first:], device=device)
                         for x in auxs))
        if brick:
            kw = dict(brick_budget=batch_budget or default_brick_budget(w, u))
        else:
            kw = dict(batch_budget=batch_budget or min(w * u, 4 * u))
        for f0 in range(0, P - first, w):
            f1 = min(f0 + w, P - first)
            rec = UniqueRecords(*(x[f0:f1] for x in lanes), n_unique[f0:f1])
            state, win = apply(state, rec,
                               FrameAux(*(x[f0:f1] for x in aux)), cfg, **kw)
            done.append(win)
    if not done:
        return state, []
    dtypes = BUDGET_STAT_DTYPES if brick else HASH_BUDGET_STAT_DTYPES
    n = sum(len(w["overflowed"]) for w in done)
    table = _read_stats(done, dtypes, n, 0)
    return state, [{k: v[i] for k, v in table.items()} for i in range(n)]


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
    unique_budget: Optional[int] = None,
    batch_budget: Optional[int] = None,
    max_grow_retries: int = MAX_GROW_RETRIES,
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

    ``unique_budget`` / ``batch_budget`` (either one; the other takes the
    JAX fold's default) run the fixed-width records and fold (module
    docstring), with the JAX wrapper's growth: a unique overflow doubles
    the unique budget, drops the batch budget to its default and
    recomputes every segment's records; a batch overflow doubles the
    batch budget (from the JAX default for the first segment's width and
    ``min(window, P)``) and replays the fold; anything else grows the
    table.  The stats are then the JAX fold's (``BUDGET_STAT_DTYPES`` /
    ``HASH_BUDGET_STAT_DTYPES``).  ``max_grow_retries`` bounds the folds
    (RuntimeError past it).
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
    budgeted = (unique_budget, batch_budget) != (None, None)
    if budgeted and unique_budget is None:
        unique_budget = default_segment_unique_budget(images, cfg)

    def compute_segments():
        return [
            records_for_segment(images[a:b], positions[a:b],
                                quaternions[a:b], cfg, dtype=dtype,
                                brick_bits=brick_bits, device=device,
                                unique_budget=unique_budget)
            for a, b in zip(bounds[:-1], bounds[1:]) if b > a
        ]

    segments = compute_segments()
    grow = rehash_bricks if backend == "brick" else rehash
    applied: List[dict] = [None] * P
    start = 0
    for _ in range(max_grow_retries):
        new_state, stats = apply_record_segments(
            state, segments, cfg, window=window, start=start,
            batch_budget=batch_budget,
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
        if budgeted and any(s["unique_overflow"] for s in failed):
            unique_budget *= 2
            batch_budget = None
            segments = compute_segments()
            state = new_state._replace(
                poisoned=torch.zeros_like(new_state.poisoned))
        elif budgeted and any(s["batch_overflow"] for s in failed):
            if batch_budget is None:
                u = segments[0][0].hi.shape[1]
                w = min(window, P)
                batch_budget = (default_brick_budget(w, u)
                                if backend == "brick" else min(w * u, 4 * u))
            batch_budget *= 2
            state = new_state._replace(
                poisoned=torch.zeros_like(new_state.poisoned))
        else:
            state = grow(new_state, new_state.capacity * 2)
    raise RuntimeError(
        f"multi-host growth did not converge after {max_grow_retries} retries"
    )
