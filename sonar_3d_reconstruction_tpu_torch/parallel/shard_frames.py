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
    window replays (parallel/shard.run_grow_replay).

The JAX engine is single-controller (one process drives the mesh over
ICI collectives); so is this one: the ``all_to_all`` becomes the
per-block copies above and the ``psum`` / ``pmax`` / ``all_gather`` become
host reductions over the shards' results.  On one card,
``mesh = (cuda:0,) * S`` runs the whole engine; on S cards the same code
copies between them.

Count-sized, each block is sized from its count: one host read a source
device a window for the block bounds, one a shard for its apply, one for
the commit.  With the JAX engine's budgets (``unique_budget``,
``xchg_budget``, and the per-shard ``brick_budget``, ``lane_budget``,
``insert_budget`` and ``vox_budget``) a window reads nothing: each source
frame's records are ``unique_budget`` lanes, its (frame, owner) blocks
are fixed-width gathers of ``xchg_budget`` lanes from each owner's first
record, ``EMPTY`` past the block's count (so padded lanes sort last in
the owner's window sort), and a count above the width raises
``xchg_overflow``; a frame that overflowed either budget reaches every
owner with a count one past the width, which rejects the window there.
Every owner applies at its budgets up to its writes, the window commits
on every shard or on none by the device-side OR of their flags (and of
the source's count-packing flags), and the stats, the JAX engine's,
stay on the device until the scan's end (parallel/shard.py).  The host
loop grows in JAX's order: unique, exchange, insert, batch, then the
tables.  Both give the same map and per-ping stats.

``dense_mode="pallas-raw"`` runs the apply through K1's raw form, as the
JAX engine does: the records it receives are unique (the source dedups
them to exchange them), so the raw form's per-slot sums are the unique
aggregates and the map is the same.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.grid.brick import (
    apply_brick_records_compact,
    apply_brick_records_wide,
    default_brick_budget,
    is_raw_mode,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
    FanTables,
    backproject_ping,
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
from sonar_3d_reconstruction_tpu_torch.parallel import shard_brick
from sonar_3d_reconstruction_tpu_torch.parallel.shard import (
    MAX_GROW_RETRIES,
    Budgets,
    StatReduce,
    check_sharded_state,
    commit,
    commit_budgeted,
    host_stats,
    on_mesh,
    owner_shard_brick,
    poison,
    reduce_stats,
    run_grow_replay,
    scan_windows,
    sequence_inputs,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (
    REPLICATED_BUDGET_STAT_DTYPES,
    REPLICATED_STAT_DTYPES,
    WINDOW_SIZES,
    ShardedBrickState,
    init_sharded_brick_grid,
)

# per-ping stats: the replicated-records engine's (``num_occupied`` /
# ``num_free`` summed over the owners, ``num_candidates`` from the source
# shard, the window sizes summed and their largest shard), and the
# exchange: the largest block a frame sent to one owner and the bytes of
# its records moved to their owners (16 a record)
SHARDED_STAT_DTYPES = dict(
    REPLICATED_STAT_DTYPES, xchg_n_max=np.int64, xchg_bytes=np.int64)
_RECORD_BYTES = 16  # two int64 words a record, in either key layout
DEFAULT_LOCAL_CAPACITY = 1 << 14  # bricks a shard of a fresh map, as in JAX
# the budgeted windows' stats, the JAX engine's keys: the replicated
# engine's, the exchange's overflow flag, and the largest (frame, owner)
# block of the window's frames that fit their budgets
SHARDED_BUDGET_STAT_DTYPES = dict(
    REPLICATED_BUDGET_STAT_DTYPES, xchg_overflow=bool, xchg_n_max=np.int64)
# their reduce over the owners (the JAX engine's local_window): every
# owner holds every frame's aux, so num_candidates is the source's count
_FRAMES_REDUCE = StatReduce(
    sums=("num_occupied", "num_free") + WINDOW_SIZES,
    maxima=WINDOW_SIZES,
    ors=("batch_overflow", "insert_overflow", "pack_overflow"),
    first=("num_candidates", "overflowed", "range_fail"),
)


def default_xchg_budget(unique_budget: int, n_shards: int) -> int:
    """The JAX engine's per-(frame, owner) block budget: twice a frame's
    unique budget over the shards (the owner hash splits a frame's records
    near-uniformly), rounded up to 128 lanes, at least 1024."""
    per_shard = -(-2 * unique_budget // n_shards)
    return max(1024, -(-per_shard // 128) * 128)


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
    unique_budget: Optional[int] = None,
) -> Tuple[_SourceFrame, torch.Tensor, torch.Tensor]:
    """One ping -> (its owner-grouped unique records, (S,) int64 records
    of each owner, () bool unique overflow), on the image's device;
    ``unique_budget`` lanes wide when it is given.

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
                                         brick=True,
                                         unique_budget=unique_budget)
        lanes = (key_code(rec.hi, rec.lo, brick=True),
                 (rec.count << 32) | rec.n_occ)
        pack_fail = torch.zeros((), dtype=torch.bool, device=device)
    else:
        rec, group = dedup_frame_compact_grouped(
            bkey, occ, valid, owner, n_shards,
            sum(box_bits) + 3 * brick_bits, unique_budget=unique_budget)
        lanes = (rec.key, rec.payload)
        pack_fail = rec.pack_fail
    # records are sorted by owner, unused lanes (group S) last
    starts = torch.searchsorted(
        group, torch.arange(n_shards + 1, device=device))
    return (_SourceFrame(lanes, starts,
                         frame_aux(keys, valid, range_fail, res), pack_fail),
            starts[1:] - starts[:-1], rec.overflowed)


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
                      brick_bits=state.brick_bits, n_shards=S)[0]
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
        return poison(state), stats

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
        results.append((new, host_stats(win)))

    state = commit(state, results, stats, ("batch_n_bricks", "batch_n_lanes"))
    if not stats["overflowed"][0]:
        # every owner applied every frame's aux: the source's full-frame
        # count
        stats["num_candidates"] = results[0][1]["num_candidates"]
    return state, stats


def _blocks(out: _SourceFrame, n_rec: torch.Tensor, width: int, compact: bool):
    """One source frame's (frame, owner) blocks at a fixed width: each of
    its (N,) lane arrays as (S, width), owner d's row the gather of
    ``starts[d] + arange(width)``, its lanes past ``n_rec[d]`` the empty
    fill (``EMPTY32`` / ``EMPTY64`` keys, zero payloads)."""
    n = out.lanes[0].shape[0]
    lane = torch.arange(width, device=n_rec.device)
    idx = torch.clamp(out.starts[:-1, None] + lane, max=n - 1)
    keep = lane < n_rec[:, None]
    fills = (EMPTY32, 0) if compact else (EMPTY64, 0)
    return tuple(torch.where(keep, x[idx], fill)
                 for x, fill in zip(out.lanes, fills))


def _window_budgeted(
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
    budgets: "_FrameBudgets",
) -> Tuple[ShardedBrickState, Dict[str, torch.Tensor]]:
    """``_window`` at fixed widths, with no host read (module docstring):
    returns (state, the window's stats on ``mesh[0]``).  ``box_min`` is
    {device: (3,) box origin} or None (two-word codes)."""
    mesh = state.mesh
    S, B = len(mesh), len(frames)
    dev0 = mesh[0]
    compact = box_min is not None
    U, UX = budgets.unique(), budgets.xchg()
    # the source shards of the window's frames, in frame order: shard s
    # computes frames s*F .. s*F+F-1
    srcs = sorted({f // frames_per_source for f in range(B)})

    # records at the sources, a source's frames stacked: blocks (F, S, UX),
    # records a block (F, S) (UX + 1 where the frame overflowed), flags (F,)
    sent = {}
    for src in srcs:
        dev = mesh[src]
        fs = range(src * frames_per_source,
                   min(B, (src + 1) * frames_per_source))
        blocks, n_tx, xchg_n, flags, auxs = [], [], [], [], []
        for f in fs:
            out, n_rec, dedup_ovf = _source_frame(
                images_dev[dev][frames[f]], T_dev[dev][frames[f]],
                None if box_min is None else box_min[dev], tables=tables,
                cfg=cfg, dtype=dtype, box_bits=box_bits,
                brick_bits=state.brick_bits, n_shards=S, unique_budget=U)
            xchg_ovf = (n_rec > UX).any()
            bad = dedup_ovf | xchg_ovf
            blocks.append(_blocks(out, n_rec, UX, compact))
            n_tx.append(torch.where(bad, UX + 1, n_rec))
            # the exchange's sizing requirement: frames that fit only
            xchg_n.append(torch.where(bad, 0, n_rec).max())
            flags.append(torch.stack([dedup_ovf, xchg_ovf, out.pack_fail]))
            auxs.append(out.aux)
        sent[src] = (
            tuple(torch.stack(x) for x in zip(*blocks)), torch.stack(n_tx),
            torch.stack(xchg_n), torch.stack(flags),
            FrameAux(*(torch.stack(x) for x in zip(*auxs))),
        )

    # the frames' flags and aux in window order on every distinct device
    def gathered(pick, d):
        return torch.cat([pick(sent[src]).to(d) for src in srcs])

    flags = gathered(lambda x: x[3], dev0)          # (B, 3)
    aux_on = {d: FrameAux(*(gathered(lambda x, i=i: x[4][i], d)
                            for i in range(4)))
              for d in dict.fromkeys(mesh)}
    pack_fail_on = {d: gathered(lambda x: x[3][:, 2], d)
                    for d in dict.fromkeys(mesh)}

    pendings = []
    for d, shard in enumerate(state.shards):
        dev = mesh[d]
        lanes = [gathered(lambda x, j=j: x[0][j][:, d], dev)
                 for j in range(2)]                 # (B, UX) each
        n_unique = gathered(lambda x: x[1][:, d], dev)
        kw = budgets.apply_kw(frames.start)
        if compact:
            recs = CompactRecords(lanes[0], lanes[1], n_unique,
                                  pack_fail_on[dev])
            pendings.append(apply_brick_records_compact(
                shard, recs, aux_on[dev], cfg, box_min[dev], box_bits,
                dense_mode=dense_mode, commit=False, **kw))
        else:
            code, cnt = lanes
            valid = code != EMPTY64
            hi, lo = code_words(code, brick=True)
            recs = UniqueRecords(
                hi=torch.where(valid, hi, EMPTY_HI),
                lo=torch.where(valid, lo, EMPTY_HI),
                count=cnt >> 32, n_occ=cnt & 0xFFFFFFFF, n_unique=n_unique)
            kw.pop("vox_budget")
            pendings.append(apply_brick_records_wide(
                shard, recs, aux_on[dev], cfg, commit=False, **kw))

    # a count-packing failure at a source rejects the window everywhere
    # (the raw apply sums candidates unpacked and does not see it)
    pack_fail = flags[:, 2].any()
    state, wins = commit_budgeted(state, pendings, extra=pack_fail)
    stats = reduce_stats(wins, dev0, _FRAMES_REDUCE)
    xchg_n_max = gathered(lambda x: x[2], dev0).max()
    stats.update(
        pack_overflow=stats["pack_overflow"] | pack_fail,
        unique_overflow=flags[:, 0].any().expand(B),
        xchg_overflow=flags[:, 1].any().expand(B),
        xchg_n_max=xchg_n_max.expand(B),
    )
    return state, stats


class _FrameBudgets(Budgets):
    """The frame-parallel engine's budgets (JAX's
    ``map_ping_sequence_sharded_frames``), on ``n_shards`` shards."""

    KEYS = ("unique_budget", "xchg_budget", "brick_budget", "lane_budget",
            "insert_budget", "vox_budget")

    def __init__(self, tables, cfg, window, n_shards, **budgets):
        super().__init__(tables, cfg, window, **budgets)
        self.n_shards = n_shards

    def xchg(self) -> int:
        """The block width UX (default ``default_xchg_budget(U, S)``)."""
        return self.b["xchg_budget"] or default_xchg_budget(self.unique(),
                                                            self.n_shards)

    def apply_kw(self, w0: int) -> Dict[str, Any]:
        """The window at frame ``w0``'s per-owner apply budgets: NB
        (default ``default_brick_budget(window, UX * S) // S``), L, the
        insert budget and the row layout's voxel budget."""
        S = self.n_shards
        return dict(
            brick_budget=(self.b["brick_budget"] or default_brick_budget(
                self.window, self.xchg() * S) // S),
            lane_budget=self.b["lane_budget"], insert_budget=self.insert(w0),
            vox_budget=self.b["vox_budget"])

    def causes(self):
        """JAX's growth order after the fatal causes: unique (doubled; an
        exchange budget keeps what it grew to unless the new default is
        larger; the brick budget re-derives), exchange (doubled), insert
        (doubled), batch (bricks and the voxel budget doubled, a lane
        budget dropped to the full width)."""
        b = self.b

        def unique():
            self.grow_unique("brick_budget")
            if b["xchg_budget"] is not None:
                b["xchg_budget"] = max(b["xchg_budget"], default_xchg_budget(
                    b["unique_budget"], self.n_shards))

        def xchg():
            b["xchg_budget"] = 2 * self.xchg()

        def batch():
            b["brick_budget"] = 2 * self.apply_kw(0)["brick_budget"]
            if b["vox_budget"] is not None:
                b["vox_budget"] *= 2
            b["lane_budget"] = None

        return (("unique_overflow", unique), ("xchg_overflow", xchg),
                ("insert_overflow", self.grow_insert),
                ("batch_overflow", batch))


def _scan(
    state: ShardedBrickState, start: int, *, n_frames: int, window: int,
    boxes, budgets: _FrameBudgets, **kw,
) -> Tuple[ShardedBrickState, Dict[str, np.ndarray]]:
    """Windows from frame ``start`` (a window boundary) to the end.
    Count-sized, it stops at the first failed window, whose frames and
    every later one report ``overflowed``; budgeted, every window runs and
    the stats are read once."""
    box_mins, box_bits = (None, None) if boxes is None else boxes
    if budgets.budgeted:
        # every window's box origin in one copy to each device
        box_on = (None if boxes is None else
                  on_mesh(np.asarray(box_mins), state.mesh))

        def step(st, frames):
            wi = frames.start // window
            box_min = (None if box_on is None
                       else {d: b[wi] for d, b in box_on.items()})
            return _window_budgeted(st, frames, box_min, box_bits=box_bits,
                                    budgets=budgets, **kw)

        return scan_windows(state, start, n_frames=n_frames, window=window,
                            step=step, stat_dtypes=SHARDED_BUDGET_STAT_DTYPES,
                            budgeted=True)

    def step(st, frames):
        box_min = None if boxes is None else box_mins[frames.start // window]
        return _window(st, frames, box_min, box_bits=box_bits, **kw)

    return scan_windows(state, start, n_frames=n_frames, window=window,
                        step=step, stat_dtypes=SHARDED_STAT_DTYPES)


def map_ping_sequence_sharded_frames(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: Optional[MapperConfig] = None,
    *,
    mesh=None,
    local_capacity: int = DEFAULT_LOCAL_CAPACITY,
    state: Optional[ShardedBrickState] = None,
    dtype: torch.dtype = torch.float32,
    window: int = 8,
    tables: Optional[FanTables] = None,
    dense_mode: str = "pallas",
    unique_budget: Optional[int] = None,
    xchg_budget: Optional[int] = None,
    brick_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget=None,
    vox_budget: Optional[int] = None,
    max_grow_retries: int = MAX_GROW_RETRIES,
    effective: Optional[Dict[str, Any]] = None,
) -> Tuple[ShardedBrickState, Dict[str, np.ndarray]]:
    """Map a recorded ping sequence into a sharded brick map.

    ``mesh`` is a device list (parallel/shard.make_mesh; a device may
    repeat; None: every visible card, RuntimeError where there is none);
    ``state`` resumes a map, whose mesh it is (a ``mesh`` given with it
    must match); a fresh map holds ``local_capacity`` bricks a shard.
    Windows of ``window`` pings take compact box keys when every window
    fits them with the owner folded into the dedup word
    (``compute_window_boxes`` with ``frame_bits = max(f_bits, 1 +
    gbits)``), two-word brick codes otherwise.  ``tables`` and
    ``dense_mode`` are as in ``pipeline.map_ping_sequence`` (``"pallas"``
    / ``"pallas-raw"``, and the JAX spellings).

    Returns (state, per-ping stats (P,) on the host: SHARDED_STAT_DTYPES).
    The map equals ``pipeline.map_ping_sequence(backend="brick")``'s voxel
    by voxel, and each shard holds exactly the bricks it owns.  A window
    that would overflow a bucket on any shard grows every shard and
    replays; keys outside the packable range and voxels with 2^16+
    emissions in one frame are fatal (ValueError).

    Budgets (JAX's arguments: ``unique_budget`` record lanes a source
    frame, ``xchg_budget`` lanes a (frame, owner) block (default
    ``default_xchg_budget(U, S)``), and the PER-SHARD ``brick_budget``
    (default ``default_brick_budget(window, UX * S) // S``),
    ``lane_budget``, ``insert_budget`` (an int or a [cold, warm] list
    indexed by window) and ``vox_budget`` (the ``"row"`` spelling's
    distinct voxels)) run every window at fixed widths with no host read
    and one stats read a scan (module docstring; the stats are then the
    JAX engine's, ``SHARDED_BUDGET_STAT_DTYPES``, whose ``xchg_n_max`` is
    the window's largest block).  An overflow grows by JAX's cause order
    (``_FrameBudgets.causes``), then the tables.  The map and every
    shared stat equal the count-sized run's.  ``effective`` (a dict)
    receives the budgets the run settled on (None where none was given
    or grown), as JAX's does; ``max_grow_retries`` bounds the scans
    (RuntimeError past it).
    """
    cfg = cfg or MapperConfig()
    is_raw_mode(dense_mode)
    state = (init_sharded_brick_grid(mesh, local_capacity, dtype)
             if state is None else check_sharded_state(state, mesh, dtype))
    mesh = state.mesh
    S = len(mesh)
    images, tables, T = sequence_inputs(images, positions, quaternions, cfg,
                                        tables)
    P = len(images)
    window = min(max(window, 1), P)
    budgets = _FrameBudgets(tables, cfg, window, S,
                            unique_budget=unique_budget,
                            xchg_budget=xchg_budget, brick_budget=brick_budget,
                            lane_budget=lane_budget,
                            insert_budget=insert_budget, vox_budget=vox_budget)
    if P == 0:
        dtypes = (SHARDED_BUDGET_STAT_DTYPES if budgets.budgeted
                  else SHARDED_STAT_DTYPES)
        return state, {k: np.zeros(0, dt) for k, dt in dtypes.items()}
    gbits = max(1, (max(S - 1, 1)).bit_length())
    f_bits = max(1, (window - 1).bit_length())
    boxes = compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, window,
        state.brick_bits, frame_bits=max(f_bits, 1 + gbits))
    scan = functools.partial(
        _scan, n_frames=P, window=window, boxes=boxes, budgets=budgets,
        images_dev=on_mesh(images, mesh), T_dev=on_mesh(T, mesh, dtype),
        frames_per_source=-(-window // S), tables=tables, cfg=cfg,
        dtype=dtype, dense_mode=dense_mode,
    )
    out = run_grow_replay(
        state=state, n_frames=P, scan=scan,
        rehash=shard_brick.rehash_sharded_bricks,
        label="sharded frame-parallel",
        growable_causes=budgets.causes() if budgets.budgeted else (),
        max_grow_retries=max_grow_retries)
    if effective is not None:
        effective.update(budgets.effective())
    return out
