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

Budgets (``map_ping_sequence(budgets=)``; utils/autotune.py makes a plan)
run the brick and hash windows at the JAX package's fixed widths instead
of the counts: a window reads nothing to the host, its stats stay on the
device, and the scan reads them once at its end.  An overflow is a device
flag with its cause; the host then grows the cause's budget (a stale
plan is first dropped whole for its ``safe_*`` budgets) or the table and
replays, as the JAX package does.  Budgets are shapes, never semantics:
the map and every per-ping stat equal the run without them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

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
    default_brick_budget,
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
    default_batch_budget,
    effective_unique_budget,
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
# the budgeted windows' per-ping stats: the JAX package's keys (its brick
# window; its hash window, and its per-ping hash step at window 1)
BUDGET_STAT_DTYPES = {
    "num_occupied": np.int64,
    "num_free": np.int64,
    "num_candidates": np.int64,
    "overflowed": bool,
    "unique_overflow": bool,
    "batch_overflow": bool,
    "insert_overflow": bool,
    "batch_n_unique": np.int64,
    "batch_n_bricks": np.int64,
    "batch_n_lanes": np.int64,
    "batch_n_need": np.int64,
    "pack_overflow": bool,
    "range_fail": bool,
}
HASH_BUDGET_STAT_DTYPES = {
    k: v for k, v in BUDGET_STAT_DTYPES.items()
    if k not in ("batch_n_bricks", "batch_n_lanes", "pack_overflow")
}
HASH_W1_BUDGET_STAT_DTYPES = {
    k: v for k, v in BUDGET_STAT_DTYPES.items()
    if k in ("num_occupied", "num_free", "num_candidates", "overflowed",
             "unique_overflow", "range_fail")
}
# a plan's tuned values beyond the unique / brick / batch budgets: a plan
# holding any of them is dropped whole at its first overflow
PLAN_EXTRAS = ("lane_budget", "insert_budget", "vox_budget",
               "dedup_lane_budget", "safe_unique_budget", "safe_brick_budget",
               "safe_batch_budget")

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
    unique_budget: Optional[int] = None,
    dedup_lane_budget: int = 0,
) -> List[Tuple[Union[CompactRecords, UniqueRecords], FrameAux]]:
    """Records of a window's ``frames`` in frame order, for
    ``stack_frame_records``: compact box keys with a box (raw candidates
    when ``raw``), two-word keys without one (brick codes when
    ``brick_bits`` > 0, voxel codes when it is 0), ``unique_budget`` lanes
    wide when it is given.  One ``frame_records`` call a frame when
    ``records_batch`` <= 1, else one a batch of up to ``records_batch``
    frames (the last batch takes what is left)."""
    box_min_t = (None if box_min is None
                 else torch.as_tensor(box_min, device=images.device))
    kw = dict(dtype=dtype, raw=raw, unique_budget=unique_budget,
              dedup_lane_budget=dedup_lane_budget)
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


def _read_stats(windows, dtypes, P: int, start: int) -> Dict[str, np.ndarray]:
    """The budgeted scans' per-window device stats (in frame order from
    ``start``) as host arrays (P,), in one read."""
    table = torch.cat([
        torch.stack([win[k].to(torch.int64) for k in dtypes])
        for win in windows
    ], dim=1).cpu().numpy()
    out = {k: np.zeros(P, dt) for k, dt in dtypes.items()}
    for i, k in enumerate(dtypes):
        out[k][start:] = table[i]
    return out


def _insert_budget(insert_budget, wi: int):
    """Window ``wi``'s insert budget: one for every window, or the JAX
    plans' per-window list ([cold, warm]: the last entry holds from there
    on)."""
    if isinstance(insert_budget, (list, tuple)):
        return insert_budget[min(wi, len(insert_budget) - 1)]
    return insert_budget


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
    unique_budget: Optional[int] = None,
    brick_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget=None,
    vox_budget: Optional[int] = None,
    dedup_lane_budget: int = 0,
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

    Any budget (``unique_budget``, ``brick_budget``, ``lane_budget``,
    ``insert_budget``: one int, or a list indexed by window, the last
    entry holding from there on; ``vox_budget``; ``dedup_lane_budget``)
    runs every window at the JAX package's fixed widths (defaults:
    ``effective_unique_budget`` and ``default_brick_budget``): no window
    reads anything to the host, a failed window poisons the state so that
    every later one is a no-op, and the stats (``BUDGET_STAT_DTYPES``) are
    read once, at the end.  ``records_batch`` and ``window_group``
    compose with budgets.
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
    if (unique_budget, brick_budget, lane_budget, insert_budget,
            vox_budget) != (None,) * 5 or dedup_lane_budget:
        return _scan_brick_budgeted(
            state, images, transforms, start, tables=tables, cfg=cfg,
            dtype=dtype, window=window, box_mins=box_mins, box_bits=box_bits,
            dense_mode=dense_mode, raw=raw, records_batch=records_batch,
            group=group, unique_budget=unique_budget,
            brick_budget=brick_budget, lane_budget=lane_budget,
            insert_budget=insert_budget, vox_budget=vox_budget,
            dedup_lane_budget=dedup_lane_budget,
        )
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


def _scan_brick_budgeted(
    state, images, transforms, start, *, tables, cfg, dtype, window,
    box_mins, box_bits, dense_mode, raw, records_batch, group, unique_budget,
    brick_budget, lane_budget, insert_budget, vox_budget, dedup_lane_budget,
):
    """``scan_pings_brick`` at fixed widths (its docstring): every window
    runs, the stats are read once."""
    P = images.shape[0]
    if unique_budget is None:
        unique_budget = effective_unique_budget(tables, cfg)
    if brick_budget is None:
        brick_budget = default_brick_budget(min(window, P), unique_budget)
    # every window's box origin in one copy to the device
    box_dev = (None if box_mins is None else
               torch.as_tensor(np.asarray(box_mins), device=images.device))
    budgets = dict(brick_budget=brick_budget, lane_budget=lane_budget,
                   vox_budget=vox_budget)
    wins = [(w0, min(w0 + window, P)) for w0 in range(start, P, window)]
    done = []
    for g in range(0, len(wins), group):
        todo = wins[g:g + group]
        g0 = todo[0][0]
        recs, auxs = stack_frame_records([
            out for w0, w1 in todo for out in _window_records(
                images, transforms, range(w0, w1),
                None if box_dev is None else box_dev[w0 // window],
                tables=tables, cfg=cfg, dtype=dtype, box_bits=box_bits,
                brick_bits=state.brick_bits, raw=raw,
                records_batch=records_batch, unique_budget=unique_budget,
                dedup_lane_budget=dedup_lane_budget,
            )
        ], cut=False)
        for w0, w1 in todo:
            rec = type(recs)(*(x[w0 - g0:w1 - g0] for x in recs))
            aux = FrameAux(*(x[w0 - g0:w1 - g0] for x in auxs))
            ib = _insert_budget(insert_budget, w0 // window)
            if box_dev is None:
                state, win = apply_brick_records_wide(
                    state, rec, aux, cfg, insert_budget=ib, **budgets)
            else:
                state, win = apply_brick_records_compact(
                    state, rec, aux, cfg, box_dev[w0 // window], box_bits,
                    dense_mode=dense_mode, insert_budget=ib, **budgets,
                )
            done.append(win)
    return state, _read_stats(done, BUDGET_STAT_DTYPES, P, start)


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
    unique_budget: Optional[int] = None,
    batch_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget=None,
    dedup_lane_budget: int = 0,
) -> Tuple[HashGridState, Dict[str, np.ndarray]]:
    """Apply pings [start, P) to the hash map: one ``update_hash_grid`` a
    ping when ``window`` is 1, else one ``apply_records_batched`` a window
    of voxel-code records.  Returns and stops as ``scan_pings_brick``.

    Any budget runs the JAX package's fixed widths (defaults:
    ``effective_unique_budget``, ``default_batch_budget``; window 1 takes
    only the unique budget), reads the stats once at the end
    (``HASH_BUDGET_STAT_DTYPES``, ``HASH_W1_BUDGET_STAT_DTYPES`` at window
    1) and lets a poisoned state turn later windows into no-ops, as
    ``scan_pings_brick`` does."""
    P = images.shape[0]
    if start % window:
        raise ValueError(f"start {start} is not a multiple of window {window}")
    if (unique_budget, batch_budget, lane_budget,
            insert_budget) != (None,) * 4 or dedup_lane_budget:
        return _scan_hash_budgeted(
            state, images, transforms, start, tables=tables, cfg=cfg,
            dtype=dtype, window=window, unique_budget=unique_budget,
            batch_budget=batch_budget, lane_budget=lane_budget,
            insert_budget=insert_budget, dedup_lane_budget=dedup_lane_budget,
        )
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


def _scan_hash_budgeted(
    state, images, transforms, start, *, tables, cfg, dtype, window,
    unique_budget, batch_budget, lane_budget, insert_budget,
    dedup_lane_budget,
):
    """``scan_pings_hash`` at fixed widths (its docstring)."""
    P = images.shape[0]
    if unique_budget is None:
        unique_budget = effective_unique_budget(tables, cfg)
    if batch_budget is None:
        batch_budget = default_batch_budget(min(window, P), unique_budget)
    done = []
    for w0 in range(start, P, window):
        w1 = min(w0 + window, P)
        if window == 1:
            cand = backproject_ping(images[w0], transforms[w0], tables, cfg,
                                    dtype=dtype)
            state, win = update_hash_grid(state, cand, cfg,
                                          unique_budget=unique_budget)
            win = {k: v[None] for k, v in win.items()}
        else:
            recs, auxs = stack_frame_records(_window_records(
                images, transforms, range(w0, w1), None, tables=tables,
                cfg=cfg, dtype=dtype, box_bits=None, brick_bits=0,
                unique_budget=unique_budget,
                dedup_lane_budget=dedup_lane_budget,
            ), cut=False)
            state, win = apply_records_batched(
                state, recs, auxs, cfg, batch_budget=batch_budget,
                lane_budget=lane_budget,
                insert_budget=_insert_budget(insert_budget, w0 // window),
            )
        done.append(win)
    dtypes = (HASH_W1_BUDGET_STAT_DTYPES if window == 1
              else HASH_BUDGET_STAT_DTYPES)
    return state, _read_stats(done, dtypes, P, start)


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
    dense_mode: Optional[str] = None,
    tables: Optional[FanTables] = None,
    dense_spec: Optional[DenseGridSpec] = None,
    records_batch: int = 1,
    window_group: int = 1,
    budgets: Optional[Dict[str, Any]] = None,
    effective: Optional[Dict[str, Any]] = None,
    initial_capacity: Optional[int] = None,
    max_grow_retries: int = MAX_GROW_RETRIES,
) -> Tuple[MapState, Dict[str, np.ndarray]]:
    """Map a whole recorded ping sequence on ``device``: the first CUDA
    device when it is None (RuntimeError where there is none; pass "cpu"
    to map on the CPU).

    ``images`` (P, range_bins, bearing_bins) polar intensity images;
    ``positions`` (P, 3) and ``quaternions`` (P, 4) xyzw odometry poses.
    ``backend`` is ``"brick"`` (the default), ``"hash"`` or ``"dense"``.
    ``state`` resumes an existing map of that backend (default: a fresh
    one of ``initial_capacity`` bricks or slots, by default
    ``DEFAULT_BRICK_CAPACITY`` / ``DEFAULT_HASH_CAPACITY``, or
    ``dense_spec``'s cells on ``device``).  ``dense_spec`` (dense only) is
    the grid's geometry (default: +-(max_range + 2 m) at the voxel
    resolution).  ``dense_mode`` (brick only) is a JAX ``dense_mode``
    spelling (``grid.brick.parse_dense_mode``; default: the plan's, else
    ``"pallas"``): unique records, or raw candidates summed by the kernel
    for a ``raw`` spelling; all give the same map.  ``tables`` are the fan
    tables of the images' geometry (default: built with every lattice cap
    sized for these images); a caller that maps many short sequences of
    one geometry passes its own, so they are built once.
    ``records_batch`` and ``window_group`` (brick only; ValueError on
    another backend unless 1) batch the records half as
    ``scan_pings_brick`` says; the map and the stats do not change.

    ``budgets`` (brick and hash) runs the fixed-width windows (module
    docstring): a plan from ``utils.autotune.tune_sequence`` or the CLI's
    ``tune`` (the JAX package's plans too; its ``backend`` and ``window``
    must match, ValueError otherwise, and its ``capacity`` sizes a fresh
    map), or a dict of only ``unique_budget`` / ``brick_budget`` /
    ``batch_budget`` (``{}``: the JAX package's defaults).  A plan with
    tuned extras (``PLAN_EXTRAS``) that proves stale is dropped whole and
    the run replays at its ``safe_*`` budgets; then, by cause, a unique
    overflow doubles the unique budget, a batch overflow the brick (hash:
    batch) budget, and any other overflow the table, as the JAX package
    grows.  ``effective`` (optional dict) receives what the run settled
    on: ``unique_budget``, ``brick_budget`` / ``batch_budget`` (None
    without budgets), ``capacity``, ``fan_cap``, ``window_cap``,
    ``free_cap`` and, brick only, ``box_bits``.  ``max_grow_retries``
    bounds the growths (RuntimeError past it).

    Returns (final state, per-ping stats: ``num_occupied`` / ``num_free``
    unique voxels by type, ``num_candidates`` valid emissions; on the
    brick and hash backends also ``overflowed`` and the failure causes and
    the window sizes, with budgets the JAX package's keys,
    ``BUDGET_STAT_DTYPES``).  The dense backend returns ``{}`` for no
    pings, as the JAX package does.
    """
    cfg = cfg or MapperConfig()
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use 'brick', "
                         f"'hash' or 'dense'")
    check_state_backend(state, backend)
    if budgets is not None:
        if backend == "dense":
            raise ValueError("budgets size the brick and hash windows; the "
                             "dense backend takes none")
        for key, want in (("backend", backend), ("window", window)):
            if budgets.get(key, want) != want:
                raise ValueError(f"budget plan was tuned for {key}="
                                 f"{budgets.get(key)!r}, not {want!r}")
    if dense_mode is None:
        dense_mode = (budgets or {}).get("dense_mode") or "pallas"
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
        capacity = initial_capacity
        if budgets is not None and budgets.get("capacity"):
            capacity = int(budgets["capacity"])
        if backend == "brick":
            state = init_brick_grid(capacity or DEFAULT_BRICK_CAPACITY,
                                    dtype, device)
        elif backend == "hash":
            state = init_hash_grid(capacity or DEFAULT_HASH_CAPACITY, dtype,
                                   device)
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
    boxes = None
    if backend == "brick":
        # box keys only if every window fits them, as in the JAX package
        boxes = compute_window_boxes(
            T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, window,
            state.brick_bits, frame_bits=max(1, (window - 1).bit_length()),
        )
        kw.update(dense_mode=dense_mode, records_batch=records_batch,
                  window_group=window_group, boxes=boxes)
        scan, grow = scan_pings_brick, rehash_bricks
    else:
        scan, grow = scan_pings_hash, rehash

    size_key = "brick_budget" if backend == "brick" else "batch_budget"
    grower = _Budgets(budgets, backend, tables, cfg, min(window, P))
    merged = None
    start = 0
    for _ in range(max_grow_retries):
        new_state, stats = scan(state, images_dev, T_dev, start, **kw,
                                **grower.scan_kwargs())
        if merged is None:
            merged = {k: np.zeros(P, v.dtype) for k, v in stats.items()}
        over = stats["overflowed"]
        applied_hi = int(np.argmax(over)) if over.any() else P
        for k, v in stats.items():
            merged[k][start:applied_hi] = v[start:applied_hi]
        if applied_hi == P:
            if effective is not None:
                effective.update(
                    unique_budget=grower.unique_budget,
                    capacity=new_state.capacity, fan_cap=tables.nvo_cap,
                    window_cap=tables.effective_window(cfg.occupied_window),
                    free_cap=tables.free_cap,
                )
                effective[size_key] = grower.size_budget()
                if backend == "brick":
                    effective["box_bits"] = None if boxes is None else boxes[1]
            return new_state, merged
        start = applied_hi
        tail = {k: v[start:] for k, v in stats.items()}
        if tail["range_fail"].any():
            raise ValueError(
                f"frame >= {start}: voxel keys outside the packable range "
                "— check odometry frame offsets; growth cannot fix this"
            )
        if backend == "brick" and tail["pack_overflow"].any():
            raise ValueError(
                f"frame >= {start}: a voxel received 2^16+ emissions in one "
                "frame (count packing width)"
            )
        if grower.grow(tail):
            state = new_state._replace(
                poisoned=torch.zeros_like(new_state.poisoned))
        else:
            state = grow(new_state, new_state.capacity * 2)
    raise RuntimeError(
        f"{backend} growth did not converge after {max_grow_retries} retries"
    )


class _Budgets:
    """The budgets a fixed-width run is at, and their growth by cause (the
    JAX package's ``map_ping_sequence``).  Without a plan (``budgets`` None)
    the run is count-sized and only the table grows."""

    def __init__(self, budgets, backend, tables, cfg, window):
        self.plan = budgets
        self.backend = backend
        self.window = window
        self.size_key = ("brick_budget" if backend == "brick"
                         else "batch_budget")
        self.unique_budget = self.size = None
        self.extras: Dict[str, Any] = {}
        self.plan_active = False
        if budgets is None:
            return
        self.unique_budget = (budgets.get("unique_budget")
                              or effective_unique_budget(tables, cfg))
        self.size = budgets.get(self.size_key)
        keys = ("lane_budget", "insert_budget", "dedup_lane_budget")
        if backend == "brick":
            keys += ("vox_budget",)
        self.extras = {k: budgets.get(k) for k in keys}
        self.extras["dedup_lane_budget"] = self.extras["dedup_lane_budget"] or 0
        self.plan_active = any(k in budgets for k in PLAN_EXTRAS)

    def scan_kwargs(self) -> Dict[str, Any]:
        if self.plan is None:
            return {}
        return dict(unique_budget=self.unique_budget,
                    **{self.size_key: self.size}, **self.extras)

    def size_budget(self) -> Optional[int]:
        """The brick (hash: batch) budget in effect."""
        if self.plan is None:
            return None
        if self.size is not None:
            return self.size
        default = (default_brick_budget if self.backend == "brick"
                   else default_batch_budget)
        return default(self.window, self.unique_budget)

    def grow(self, tail: Dict[str, np.ndarray]) -> bool:
        """Grow the budget that the failed tail's causes name; False when
        none does and the table must grow instead."""
        if self.plan is None:
            return False
        if self.plan_active:
            # a stale plan: drop every tuned value (they are sized
            # together) and replay at the safe pre-tuning budgets
            self.plan_active = False
            self.extras = {}
            self.unique_budget = int(self.plan.get("safe_unique_budget")
                                     or self.unique_budget * 2)
            self.size = self.plan.get("safe_" + self.size_key)
            return True
        if tail["unique_overflow"].any():
            self.unique_budget *= 2
            self.size = None
            return True
        if "batch_overflow" in tail and tail["batch_overflow"].any():
            self.size = self.size_budget() * 2
            return True
        return False
