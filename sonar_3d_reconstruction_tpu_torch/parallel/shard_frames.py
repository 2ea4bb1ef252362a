"""Frame-parallel sharded brick engine (PyTorch port of
``sonar_3d_reconstruction_tpu.parallel.shard_frames``): records sharded
over PINGS, exchanged to the shards that own their bricks.

Both halves of the map update scale with the mesh:

  * records: with ``F = ceil(window / S)``, source shard ``s`` computes
    the records of window frames ``s*F .. s*F+F-1`` on its device
    (backprojection, packing, each record's owner shard, and the
    owner-grouped dedup of ops/dedup.py, whose records come out contiguous
    per owner), with each frame's global bounds and valid count;
  * exchange: every (frame, owner) block of records is copied to
    ``mesh[owner]`` (compact box keys: key and payload; two-word keys: the
    60-bit brick code and ``count << 32 | n_occ``), and each owner lays
    its blocks out in window-frame order, so its records are those the
    single-card engine would apply, in the same order;
  * apply: every owner runs the single-card window apply
    (``grid.brick.apply_brick_records_compact`` / ``_wide``, through the
    binning kernel K1) on its own records for all of the window's frames;
  * commit: a window is all-or-nothing across shards.  If any shard's
    apply fails, no shard takes its result; the tables double and the
    window replays (parallel/shard_brick.run_grow_replay).

The JAX engine is single-controller (one process drives the mesh over
ICI collectives); so is this one: the ``all_to_all`` becomes the
per-block copies above and the ``psum`` / ``pmax`` / ``all_gather`` become
host reductions over the shards' results.  On one card,
``mesh = (cuda:0,) * S`` runs the whole engine; on S cards the same code
copies between them.

Each block is sized from its count, so the JAX engine's unique, exchange,
batch and insert budgets and their overflow branches have no
counterpart.  ``dense_mode="pallas-raw"`` runs the apply through K1's raw
form, as the JAX engine does: the records it receives are unique (the
source dedups them to exchange them), so the raw form's per-slot sums
are the unique aggregates and the map is the same.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.device import to_device
from sonar_3d_reconstruction_tpu_torch.geometry import batched_sonar_to_world
from sonar_3d_reconstruction_tpu_torch.grid.brick import (
    apply_brick_records_compact,
    apply_brick_records_wide,
    is_raw_mode,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
    FanTables,
    backproject_ping,
    resolve_capped_tables,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import (
    CompactRecords,
    UniqueRecords,
    dedup_frame_compact_grouped,
    dedup_frame_grouped,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import (
    EMPTY32,
    EMPTY64,
    EMPTY_HI,
    code_words,
    compute_window_boxes,
    key_code,
    pack_box_keys,
    pack_brick_keys,
)
from sonar_3d_reconstruction_tpu_torch.ops.records import FrameAux, frame_aux
from sonar_3d_reconstruction_tpu_torch.parallel.shard import make_mesh
from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (
    ShardedBrickState,
    init_sharded_brick_grid,
    owner_shard_brick,
    run_grow_replay,
)
from sonar_3d_reconstruction_tpu_torch.pipeline import STAT_DTYPES

# per-ping stats: the brick backend's (``num_occupied`` / ``num_free``
# summed over the owners, ``num_candidates`` from the source shard, the
# window sizes summed), the window sizes' largest shard, and the exchange:
# the largest block a frame sent to one owner and the bytes of its records
# moved to their owners (16 a record)
SHARDED_STAT_DTYPES = dict(
    STAT_DTYPES,
    batch_n_bricks_max=np.int64,
    batch_n_lanes_max=np.int64,
    xchg_n_max=np.int64,
    xchg_bytes=np.int64,
)
_RECORD_BYTES = 16  # two int64 words a record, in either key layout
DEFAULT_LOCAL_CAPACITY = 1 << 14  # bricks a shard of a fresh map, as in JAX


class _SourceFrame(NamedTuple):
    """One frame's records on its source device, ordered by owner."""

    lanes: Tuple[torch.Tensor, torch.Tensor]  # (N,) each: key / payload
                                              # or code / count-n_occ
    starts: torch.Tensor     # (S+1,) int64: owner d's records are
                             # lanes[starts[d]:starts[d+1]]
    aux: FrameAux
    pack_fail: torch.Tensor  # () bool


def _source_frame(
    image: torch.Tensor,
    T: torch.Tensor,
    box_min: Optional[torch.Tensor],
    *,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype,
    box_bits: Optional[Tuple[int, int, int]],
    brick_bits: int,
    n_shards: int,
) -> _SourceFrame:
    """One ping -> its owner-grouped unique records, on the image's device.

    The owner comes from the voxel's global brick code; with a box the
    records carry box keys and a candidate outside the box (or the
    packable range) reports through ``range_fail``, as in the JAX
    engine."""
    device = image.device
    cand = backproject_ping(image, T, tables, cfg, dtype=dtype)
    res = torch.full((), cfg.voxel_resolution, dtype=dtype, device=device)
    # a true division, as in the reference's floor(p / res) keying
    keys = torch.floor(cand["points"] / res).to(torch.int32)
    hi, lo, in_range = pack_brick_keys(keys, brick_bits)
    if box_min is not None:
        bkey, in_box = pack_box_keys(keys, box_min, box_bits, brick_bits)
        in_range = in_range & in_box
    valid = cand["valid"]
    range_fail = (valid & ~in_range).any()
    valid = valid & in_range
    owner = owner_shard_brick(hi, lo, brick_bits, n_shards)
    occ = cand["is_occupied"]
    if box_min is None:
        rec, group = dedup_frame_grouped(hi, lo, occ, valid, owner, n_shards,
                                         brick=True)
        lanes = (key_code(rec.hi, rec.lo, brick=True),
                 (rec.count << 32) | rec.n_occ)
        pack_fail = torch.zeros((), dtype=torch.bool, device=device)
    else:
        rec, group = dedup_frame_compact_grouped(
            bkey, occ, valid, owner, n_shards,
            sum(box_bits) + 3 * brick_bits)
        lanes = (rec.key, rec.payload)
        pack_fail = rec.pack_fail
    # records are sorted by owner, unused lanes (group S) last
    starts = torch.searchsorted(
        group, torch.arange(n_shards + 1, device=device))
    return _SourceFrame(lanes, starts, frame_aux(keys, valid, range_fail, res),
                        pack_fail)


def _owner_records(outs, counts, starts, d, device, compact, pack_fail):
    """Owner ``d``'s records for the window: each frame's block copied from
    its source into row f of a (B, widest block) layout on ``device``."""
    B = len(outs)
    width = max(1, int(counts[:, d].max()))
    fills = (EMPTY32, 0) if compact else (EMPTY64, 0)
    bufs = [torch.full((B, width), fill, dtype=torch.int64, device=device)
            for fill in fills]
    for f, out in enumerate(outs):
        n, a = int(counts[f, d]), int(starts[f, d])
        if n:
            for buf, lane in zip(bufs, out.lanes):
                buf[f, :n].copy_(lane[a:a + n])
    n_unique = torch.as_tensor(counts[:, d], device=device)
    if compact:
        return CompactRecords(bufs[0], bufs[1], n_unique,
                              torch.as_tensor(pack_fail, device=device))
    code, cnt = bufs
    valid = code != EMPTY64
    hi, lo = code_words(code, brick=True)
    return UniqueRecords(
        hi=torch.where(valid, hi, EMPTY_HI),
        lo=torch.where(valid, lo, EMPTY_HI),
        count=cnt >> 32,
        n_occ=cnt & 0xFFFFFFFF,
        n_unique=n_unique,
    )


def _poisoned(state: ShardedBrickState) -> ShardedBrickState:
    return ShardedBrickState(tuple(
        s._replace(poisoned=torch.ones_like(s.poisoned)) for s in state.shards
    ))


def _window(
    state: ShardedBrickState,
    frames: range,
    box_min,
    *,
    images_dev: Dict[torch.device, torch.Tensor],
    T_dev: Dict[torch.device, torch.Tensor],
    frames_per_source: int,
    box_bits,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype,
    dense_mode: str,
) -> Tuple[ShardedBrickState, Dict[str, np.ndarray]]:
    """Records, exchange, apply and commit of one window; returns (state,
    the window's per-frame host stats).  A failed window leaves every
    shard's table as it was, poisoned."""
    mesh = state.mesh
    S, B = len(mesh), len(frames)
    compact = box_min is not None
    src = [mesh[f // frames_per_source] for f in range(B)]
    box_on = {d: None if box_min is None
              else torch.as_tensor(box_min, device=d) for d in dict.fromkeys(mesh)}
    outs = [
        _source_frame(images_dev[dev][i], T_dev[dev][i], box_on[dev],
                      tables=tables, cfg=cfg, dtype=dtype, box_bits=box_bits,
                      brick_bits=state.brick_bits, n_shards=S)
        for dev, i in zip(src, frames)
    ]
    # one host read a source device: the block bounds and failure flags
    info: list = [None] * B
    for dev in dict.fromkeys(src):
        idx = [f for f in range(B) if src[f] == dev]
        rows = torch.stack([
            torch.cat([outs[f].starts, outs[f].aux.range_fail[None].long(),
                       outs[f].pack_fail[None].long()])
            for f in idx
        ]).cpu().numpy()
        for f, row in zip(idx, rows):
            info[f] = row
    info = np.stack(info)
    starts = info[:, :S]
    counts = np.diff(info[:, :S + 1], axis=1)
    range_fail, pack_fail = info[:, S + 1] != 0, info[:, S + 2] != 0

    stats = {k: np.zeros(B, dt) for k, dt in SHARDED_STAT_DTYPES.items()}
    stats["xchg_n_max"] = counts.max(axis=1)
    stats["xchg_bytes"] = counts.sum(axis=1) * _RECORD_BYTES
    stats["range_fail"] = range_fail
    stats["pack_overflow"][:] = pack_fail.any()
    if range_fail.any() or pack_fail.any():
        # fatal at the source: no shard applies anything
        stats["overflowed"][:] = True
        return _poisoned(state), stats

    aux_on = {
        d: FrameAux(*(torch.stack([x.to(d) for x in field])
                      for field in zip(*(o.aux for o in outs))))
        for d in dict.fromkeys(mesh)
    }
    results = []
    for d, shard in enumerate(state.shards):
        dev = mesh[d]
        recs = _owner_records(outs, counts, starts, d, dev, compact, pack_fail)
        if compact:
            new, win = apply_brick_records_compact(
                shard, recs, aux_on[dev], cfg, box_min, box_bits,
                dense_mode=dense_mode)
        else:
            new, win = apply_brick_records_wide(shard, recs, aux_on[dev], cfg)
        results.append((new, {k: v.cpu().numpy() for k, v in win.items()}))

    wins = [w for _, w in results]
    failed = any(w["overflowed"].any() for w in wins)
    stats["overflowed"][:] = failed
    for k in ("range_fail", "pack_overflow"):
        stats[k] = stats[k] | np.any([w[k] for w in wins], axis=0)
    for k in ("batch_n_bricks", "batch_n_lanes"):
        per = np.stack([w[k] for w in wins])
        stats[k], stats[k + "_max"] = per.sum(axis=0), per.max(axis=0)
    if failed:
        return _poisoned(state), stats
    for k in ("num_occupied", "num_free"):
        stats[k] = np.sum([w[k] for w in wins], axis=0)
    # every owner applied every frame's aux: the source's full-frame count
    stats["num_candidates"] = wins[0]["num_candidates"]
    return ShardedBrickState(tuple(new for new, _ in results)), stats


def _scan(
    state: ShardedBrickState, start: int, *, n_frames: int, window: int,
    boxes, **kw,
) -> Tuple[ShardedBrickState, Dict[str, np.ndarray]]:
    """Windows from frame ``start`` (a window boundary) to the end; stops
    at the first failed window, whose frames and every later one report
    ``overflowed``."""
    box_mins, box_bits = (None, None) if boxes is None else boxes
    stats = {k: np.zeros(n_frames, dt) for k, dt in SHARDED_STAT_DTYPES.items()}
    for w0 in range(start, n_frames, window):
        w1 = min(w0 + window, n_frames)
        box_min = None if boxes is None else box_mins[w0 // window]
        state, win = _window(state, range(w0, w1), box_min,
                             box_bits=box_bits, **kw)
        for k, v in win.items():
            stats[k][w0:w1] = v
        if win["overflowed"][0]:
            stats["overflowed"][w1:] = True
            break
    return state, stats


def map_ping_sequence_sharded_frames(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: Optional[MapperConfig] = None,
    *,
    mesh=None,
    state: Optional[ShardedBrickState] = None,
    dtype: torch.dtype = torch.float32,
    window: int = 8,
    tables: Optional[FanTables] = None,
    dense_mode: str = "pallas",
) -> Tuple[ShardedBrickState, Dict[str, np.ndarray]]:
    """Map a recorded ping sequence into a sharded brick map.

    ``mesh`` is a device list (parallel/shard.make_mesh; a device may
    repeat; None: every visible card, RuntimeError where there is none);
    ``state`` resumes a map, whose mesh it is (a ``mesh`` given with it
    must match); a fresh map holds ``DEFAULT_LOCAL_CAPACITY`` bricks a
    shard.  Windows of ``window`` pings take compact box keys when every
    window fits them with the owner folded into the dedup word
    (``compute_window_boxes`` with ``frame_bits = max(f_bits, 1 +
    gbits)``), two-word brick codes otherwise.  ``tables`` and ``dense_mode`` are as in
    ``pipeline.map_ping_sequence`` (``"pallas"`` / ``"pallas-raw"``).

    Returns (state, per-ping stats (P,) on the host: SHARDED_STAT_DTYPES).
    The map equals ``pipeline.map_ping_sequence(backend="brick")``'s voxel
    by voxel, and each shard holds exactly the bricks it owns.  A window
    that would overflow a bucket on any shard grows every shard and
    replays; keys outside the packable range and voxels with 2^16+
    emissions in one frame are fatal (ValueError).
    """
    cfg = cfg or MapperConfig()
    is_raw_mode(dense_mode)
    if state is None:
        state = init_sharded_brick_grid(make_mesh(mesh),
                                        DEFAULT_LOCAL_CAPACITY, dtype)
    elif mesh is not None and make_mesh(mesh) != state.mesh:
        raise ValueError(f"mesh {make_mesh(mesh)} is not the state's "
                         f"{state.mesh}")
    if state.dtype != dtype:
        raise ValueError(f"state is {state.dtype}, not {dtype}")
    mesh = state.mesh
    S = len(mesh)
    images = np.asarray(images)
    P, R, B = images.shape
    if P == 0:
        return state, {k: np.zeros(0, dt)
                       for k, dt in SHARDED_STAT_DTYPES.items()}
    if tables is None:
        tables = resolve_capped_tables(images, cfg, R, B)
    elif (tables.range_bins, tables.bearing_bins) != (R, B):
        raise ValueError(
            f"fan tables are for {tables.range_bins}x{tables.bearing_bins} "
            f"images, not {R}x{B}"
        )
    T = batched_sonar_to_world(positions, quaternions, cfg)
    window = min(max(window, 1), P)
    devices = dict.fromkeys(mesh)
    gbits = max(1, (max(S - 1, 1)).bit_length())
    f_bits = max(1, (window - 1).bit_length())
    boxes = compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, window,
        state.brick_bits, frame_bits=max(f_bits, 1 + gbits))
    scan = functools.partial(
        _scan, n_frames=P, window=window, boxes=boxes,
        images_dev={d: to_device(images, d) for d in devices},
        T_dev={d: torch.as_tensor(T, device=d).to(dtype) for d in devices},
        frames_per_source=-(-window // S), tables=tables, cfg=cfg,
        dtype=dtype, dense_mode=dense_mode,
    )
    return run_grow_replay(state=state, n_frames=P, scan=scan,
                           label="sharded frame-parallel")
