"""The device mesh, ownership and host loop of the sharded engines, and the
sharded hash engine (PyTorch port of
``sonar_3d_reconstruction_tpu.parallel.shard``).

Mesh.  The JAX package is single-controller: one Python process drives a
``jax.sharding.Mesh`` and holds every shard's state.  The port keeps that
design.  A mesh is a tuple of ``torch.device``s, shard ``s`` living on
``mesh[s]``, and a device may appear more than once (the counterpart of
XLA's virtual host devices): ``(cuda:0,) * 4`` runs four shards on one
card, ``(cuda:0, cuda:1, cuda:2, cuda:3)`` one shard a card, and
``("cpu",) * 4`` four shards on the CPU.

Ownership.  A voxel's owner shard is a hash of its packed code mod S,
bit-equal to the JAX package's (snapshots and the parity tests rely on
it): ``owner_shard`` for voxel codes (``mix2`` with the words swapped, so
the owner bits are independent of the in-shard bucket bits) and
``owner_shard_brick`` for brick codes (the offset bits masked, so a brick
stays on one shard).

Replicated records.  The sharded hash engine's window engine and the
replicated-records brick engine (parallel/shard_brick.py) share one
design, the body of the JAX engines' ``shard_map``: every shard computes
every frame's candidates on its own device, keeps the lanes it owns and
dedups them (``owned_frame_records``), then applies its records to its own
sub-table.  Ownership partitions the candidates before the dedup, so each
voxel's whole update chain runs on its owner and the sharded map equals
the single-card one voxel for voxel.  Both window engines re-derive the
candidates on every shard in both packages; on one card (``mesh =
(cuda:0,) * S``) their records half runs S times.

Owner blocks.  The hash engine's window-1 step computes each ping's
records once, as JAX's per-ping step does (it backprojects and packs once
and all-gathers the packed stream): ``frame_owner_blocks`` backprojects,
packs and dedups the ping on ``mesh[0]``'s device with its records
grouped by owner, and shard ``s`` takes its block, copied to ``mesh[s]``
where that is another device (the counterpart of the all-gather).  Each
block holds the records ``owned_frame_records`` gives that shard, in the
same order.

Commit.  A step (a ping or a window) is all-or-nothing across the shards:
every apply is out of place, and its result commits only when no shard
failed (the counterpart of JAX's ``psum`` ``fail_reduce``); otherwise every
shard keeps its table, poisoned, and the host loop (``run_grow_replay``)
grows and replays.

Count-sized and budgeted steps.  Without budgets a step is sized from its
counts: each shard reads its sizes and flags to the host, and the host
commits (``commit``, ``host_stats``).  With the JAX package's budgets
(``unique_budget``, ``batch_budget``, ``lane_budget``, ``insert_budget``;
the brick engines add theirs) every shard runs its step at those fixed
widths and stops before its writes (a ``grid.hash.PendingUpdate``); the
OR of every shard's failure flag is taken on the device
(``reduce_failed``) and each shard commits by it
(``commit_budgeted``), so a step commits on every shard or on none with
no host read.  The step's stats stay on the device, reduced over the
shards as the JAX engines' ``psum`` / ``pmax`` reduce them
(``reduce_stats``: global sums, per-shard maxima ``*_max``, causes
or-ed), and ``scan_windows`` reads them once a scan; a failed step
poisons every shard, so the later steps of the scan are no-ops.  The host
loop then grows the budget that JAX's cause order names, or the tables,
and replays.  Both give the same map and per-ping stats.

The hash engine.  ``ShardedHashState`` holds one ``grid.hash`` map a
shard.  ``sharded_ping_step`` and ``scan_pings_sharded`` apply one ping at
a time (``apply_frame_records``), ``window_scan_sharded`` a window of pings
at a time (``apply_records_batched``), and ``map_ping_sequence_sharded``
maps a recorded sequence with growth and replay.  They are plain functions
in place of the JAX package's jit factories (``make_sharded_ping_step``,
``make_scan_pings_sharded``, ``make_window_scan_sharded``): there is
nothing to compile.  With budgets the window-1 step still computes each
ping's records once, at full width on ``mesh[0]``, and cuts fixed-width
owner blocks of ``unique_budget`` lanes from them with JAX's per-shard
unique overflow.
"""

from __future__ import annotations

import functools
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.device import require_cuda, to_device
from sonar_3d_reconstruction_tpu_torch.geometry import batched_sonar_to_world
from sonar_3d_reconstruction_tpu_torch.grid.hash import (
    EMPTY,
    HashGridState,
    PendingUpdate,
    apply_frame_records,
    apply_records_batched,
    commit_update,
    default_batch_budget,
    effective_unique_budget,
    hash_state_to_numpy,
    init_hash_grid,
    prepare_frame_budgeted,
    rehash_once,
    touched_voxels_hash,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
    FanTables,
    backproject_ping,
    tables_for_images,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import (
    UniqueRecords,
    _budget_slice,
    dedup_frame,
    dedup_frame_grouped,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import (
    EMPTY_HI,
    U32,
    brick_layout,
    mix2,
    pack_brick_keys,
    pack_keys,
    unpack_keys,
)
from sonar_3d_reconstruction_tpu_torch.ops.records import (
    FrameAux,
    frame_aux,
    stack_frame_records,
)
from sonar_3d_reconstruction_tpu_torch.pipeline import (
    HASH_BUDGET_STAT_DTYPES,
    HASH_STAT_DTYPES,
    HASH_W1_BUDGET_STAT_DTYPES,
    MAX_GROW_RETRIES,
    _insert_budget,
    _read_stats,
)

Mesh = Tuple[torch.device, ...]

# per-ping stats of the sharded hash engine: the hash backend's
# (``num_occupied`` / ``num_free`` / ``num_candidates`` and the step's
# distinct voxels ``batch_n_unique`` summed over the shards) and the
# largest shard's distinct voxels
SHARDED_HASH_STAT_DTYPES = dict(HASH_STAT_DTYPES, batch_n_unique_max=np.int64)
# the budgeted steps' stats, the JAX engines' keys: the window engine's
# (the global sums and the per-shard maxima of the window sizes) and the
# per-ping step's
SHARDED_HASH_BUDGET_STAT_DTYPES = dict(
    HASH_BUDGET_STAT_DTYPES, batch_n_unique_max=np.int64,
    batch_n_need_max=np.int64)
SHARDED_HASH_W1_BUDGET_STAT_DTYPES = HASH_W1_BUDGET_STAT_DTYPES


def canonical_device(device) -> torch.device:
    """``device`` as tensors report it ("cuda" -> "cuda:0")."""
    return torch.empty(0, device=device).device


def make_mesh(devices: Optional[Iterable] = None) -> Mesh:
    """A 1D mesh: the given devices in order (repeats allowed), or every
    visible CUDA device when None (RuntimeError where there is none)."""
    if devices is None:
        require_cuda()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(canonical_device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def mesh_for(mesh=None, device=None) -> Mesh:
    """The mesh of a sharded map the caller sized by ``mesh`` or
    ``device``: ``mesh``; else one shard on ``device``; else every
    visible card."""
    return make_mesh(mesh if mesh is not None or device is None else [device])


# ---------------------------------------------------------------------------
# Ownership and the replicated-records step
# ---------------------------------------------------------------------------


def owner_shard(hi: torch.Tensor, lo: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Voxel codes (ops/packing.pack_keys) -> int64 owner shard:
    ``mix2(lo, hi) % S``, the words swapped so the owner bits are
    independent of the in-shard bucket bits (``mix2(hi, lo)``)."""
    return mix2(lo, hi) % n_shards


def owner_shard_brick(
    hi: torch.Tensor, lo: torch.Tensor, brick_bits: int, n_shards: int
) -> torch.Tensor:
    """Brick-major codes (ops/packing.pack_brick_keys) -> int64 owner shard
    of their BRICK: the offset and frame bits are masked, so every voxel of
    a brick lands on one shard.  ``mix2(brick_lo, hi) % S``."""
    _, o, _ = brick_layout(brick_bits)
    brick_lo = lo & (U32 ^ ((1 << (o + 4)) - 1))
    return mix2(brick_lo, hi) % n_shards


def _frame_candidates(
    image: torch.Tensor,
    T: torch.Tensor,
    n_shards: int,
    *,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype,
    brick_bits: int,
):
    """One ping's packed candidates on the image's device: (hi, lo,
    occupied flags, the valid in-range lanes, each lane's owner shard, the
    full frame's FrameAux).

    Keys are voxel codes (``brick_bits`` 0, the hash engine) or brick
    codes.  The bounds and the range check cover the full frame (every
    shard carries the same global bounds, the reference's
    3d_mapper.py:560)."""
    cand = backproject_ping(image, T, tables, cfg, dtype=dtype)
    res = torch.full((), cfg.voxel_resolution, dtype=dtype,
                     device=image.device)
    # a true division, as in the reference's floor(p / res) keying
    keys = torch.floor(cand["points"] / res).to(torch.int32)
    if brick_bits:
        hi, lo, in_range = pack_brick_keys(keys, brick_bits)
        owner = owner_shard_brick(hi, lo, brick_bits, n_shards)
    else:
        hi, lo, in_range = pack_keys(keys)
        owner = owner_shard(hi, lo, n_shards)
    valid = cand["valid"]
    range_fail = (valid & ~in_range).any()
    valid = valid & in_range
    return (hi, lo, cand["is_occupied"], valid, owner,
            frame_aux(keys, valid, range_fail, res))


def owned_frame_records(
    image: torch.Tensor,
    T: torch.Tensor,
    shard: int,
    n_shards: int,
    *,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype,
    brick_bits: int,
    unique_budget: Optional[int] = None,
) -> Tuple[UniqueRecords, FrameAux]:
    """One ping -> (the unique records of the voxels ``shard`` owns, the
    frame's FrameAux), on the image's device; ``unique_budget`` lanes wide
    when it is given (ops/dedup.py).

    Keys are voxel codes (``brick_bits`` 0) or brick codes; the aux is the
    full frame's (``_frame_candidates``) but for ``n_valid``, which counts
    the owned candidates."""
    hi, lo, occ, valid, owner, aux = _frame_candidates(
        image, T, n_shards, tables=tables, cfg=cfg, dtype=dtype,
        brick_bits=brick_bits)
    active = valid & (owner == shard)
    rec = dedup_frame(hi, lo, occ, active, brick=brick_bits > 0,
                      unique_budget=unique_budget)
    return rec, aux._replace(n_valid=active.sum())


class OwnerBlocks(NamedTuple):
    """One ping's unique records grouped by owner shard (voxel codes)."""

    rec: UniqueRecords     # (N,) in (owner, code) order, unused lanes last
    starts: torch.Tensor   # (S+1,) int64 first lane of each owner's block;
                           # starts[S] is the records' count
    counts: torch.Tensor   # (S,) int64 valid candidates each owner owns
    aux: FrameAux          # the full frame's (n_valid: every candidate)


def frame_owner_blocks(
    image: torch.Tensor,
    T: torch.Tensor,
    n_shards: int,
    *,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype,
) -> OwnerBlocks:
    """One ping -> its voxel-code records grouped by owner, on the image's
    device: one backprojection and one dedup for every shard.

    Shard ``s``'s block, lanes ``[starts[s], starts[s+1])``, holds the
    records ``owned_frame_records(..., shard=s)`` gives, in the same (code)
    order: the grouped dedup counts each voxel over its key segment, which
    lies within one owner, and then moves whole records by a stable sort
    on their owner."""
    device = image.device
    hi, lo, occ, valid, owner, aux = _frame_candidates(
        image, T, n_shards, tables=tables, cfg=cfg, dtype=dtype,
        brick_bits=0)
    rec, group = dedup_frame_grouped(hi, lo, occ, valid, owner, n_shards,
                                     brick=False)
    # records are sorted by owner, unused lanes (group S) last
    starts = torch.searchsorted(
        group, torch.arange(n_shards + 1, device=device))
    counts = torch.zeros(n_shards, dtype=torch.int64, device=device)
    counts.index_add_(0, owner, valid.to(torch.int64))
    return OwnerBlocks(rec, starts, counts, aux)


def owner_block(
    blocks: OwnerBlocks, shard: int, starts, device: torch.device
) -> Tuple[UniqueRecords, FrameAux]:
    """Shard ``shard``'s records of one ping (``frame_owner_blocks``) and
    the frame's aux with its owned ``n_valid``, on ``device`` (copied only
    where that is another device).  ``starts`` are ``blocks.starts`` on
    the host; an empty block is one ``EMPTY_HI`` lane."""
    a, b = starts[shard], starts[shard + 1]
    rec = blocks.rec
    if b > a:
        lanes = [x[a:b] for x in rec[:4]]
    else:
        src = rec.hi.device
        lanes = [torch.full((1,), EMPTY_HI, dtype=torch.int64, device=src)] * 2
        lanes += [torch.zeros(1, dtype=torch.int64, device=src)] * 2
    n_unique = blocks.starts[shard + 1] - blocks.starts[shard]
    aux = blocks.aux._replace(n_valid=blocks.counts[shard])
    return (UniqueRecords(*(x.to(device) for x in lanes),
                          n_unique.to(device)),
            FrameAux(*(x.to(device) for x in aux)))


def owner_block_budgeted(
    blocks: OwnerBlocks, shard: int, unique_budget: int, device: torch.device
) -> Tuple[UniqueRecords, FrameAux]:
    """``owner_block`` at a fixed width, with no host read: shard
    ``shard``'s records in ``unique_budget`` lanes (a gather from its
    block's start, ``EMPTY_HI`` past its count) and JAX's per-shard unique
    overflow, which the shard's own dedup would report: more records than
    lanes, or more owned candidates than the dedup's compaction slice
    (``n_unique`` then N + 1, N the frame's candidate lanes)."""
    rec = blocks.rec
    n = rec.hi.shape[0]
    a = blocks.starts[shard]
    n_rec = blocks.starts[shard + 1] - a
    lane = torch.arange(unique_budget, device=a.device)
    idx = torch.clamp(a + lane, max=n - 1)
    keep = lane < n_rec
    owned = blocks.counts[shard]
    n_unique = torch.where(owned > _budget_slice(n, unique_budget, 0), n + 1,
                           n_rec)
    lanes = (torch.where(keep, rec.hi[idx], EMPTY_HI),
             torch.where(keep, rec.lo[idx], EMPTY_HI),
             torch.where(keep, rec.count[idx], 0),
             torch.where(keep, rec.n_occ[idx], 0), n_unique)
    aux = blocks.aux._replace(n_valid=owned)
    return (UniqueRecords(*(x.to(device) for x in lanes)),
            FrameAux(*(x.to(device) for x in aux)))


def poison(state):
    """A sharded map (``shards`` of per-shard states) with every shard
    poisoned: the result of a failed step."""
    return type(state)(tuple(
        s._replace(poisoned=torch.ones_like(s.poisoned)) for s in state.shards
    ))


def host_stats(stats: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One shard's step stats (tensors of shape () or (B,), on one device)
    as (B,) host arrays, in one copy."""
    table = torch.stack(
        [v.reshape(-1).to(torch.int64) for v in stats.values()]
    ).cpu().numpy()
    return {k: row != 0 if v.dtype == torch.bool else row
            for (k, v), row in zip(stats.items(), table)}


def commit(state, results, stats: Dict[str, np.ndarray], sizes=()):
    """All-or-nothing commit of one step (a ping or a window) over the
    shards.

    ``results`` holds each shard's (applied state, ``host_stats``);
    ``stats`` the step's per-frame host arrays, which this fills:
    ``overflowed`` (any shard failed), ``range_fail`` / ``pack_overflow``
    or-ed over the shards, each key of ``sizes`` summed and its largest
    shard as ``<key>_max``, and, when the step commits, ``num_occupied`` /
    ``num_free`` / ``num_candidates`` summed.  Returns every shard's
    applied state, or, when any shard failed, every shard's state as it
    was, poisoned."""
    wins = [w for _, w in results]
    failed = any(w["overflowed"].any() for w in wins)
    stats["overflowed"][:] = failed
    for k in ("range_fail", "pack_overflow"):
        if k in stats:
            stats[k] = stats[k] | np.any([w[k] for w in wins], axis=0)
    for k in sizes:
        per = np.stack([w[k] for w in wins])
        stats[k], stats[k + "_max"] = per.sum(axis=0), per.max(axis=0)
    if failed:
        return poison(state)
    for k in ("num_occupied", "num_free", "num_candidates"):
        stats[k] = np.sum([w[k] for w in wins], axis=0)
    return type(state)(tuple(new for new, _ in results))


def unpoison(state):
    """A sharded map with ``poisoned`` cleared on every shard: the replay
    after a budget grew (the tables keep their capacity)."""
    return type(state)(tuple(
        s._replace(poisoned=torch.zeros_like(s.poisoned)) for s in state.shards
    ))


def reduce_failed(flags: List[torch.Tensor], mesh: Mesh) -> Dict[torch.device, torch.Tensor]:
    """{device: the OR of every shard's () bool failure flag}, one copy on
    each distinct device of the mesh, with no host read: the counterpart
    of the JAX engines' ``psum`` ``fail_reduce``.  On a repeated mesh every
    copy is the same tensor; a copy to another card does not wait for
    the host."""
    dev0 = mesh[0]
    failed = torch.stack([f.to(dev0) for f in flags]).any()
    return {d: failed.to(d, non_blocking=d.type == "cuda")
            for d in dict.fromkeys(mesh)}


def commit_budgeted(state, pendings: List[PendingUpdate], extra=None):
    """Commit every shard's budgeted step by the OR of all the shards'
    failure flags (and ``extra``, a () bool of failures found outside the
    applies), on the device: every shard applies or none does.  Returns
    (state, each shard's step stats, on its device)."""
    flags = [p.failed for p in pendings]
    if extra is not None:
        flags.append(extra)
    failed = reduce_failed(flags, state.mesh)
    out = [commit_update(p, failed[d]) for p, d in zip(pendings, state.mesh)]
    return type(state)(tuple(new for new, _ in out)), [w for _, w in out]


class StatReduce(NamedTuple):
    """How a budgeted step's per-shard stats reduce over the shards, as
    the JAX engines' collectives reduce them."""

    sums: Tuple[str, ...] = ()     # psum: the global value
    maxima: Tuple[str, ...] = ()   # pmax, as ``<key>_max``
    ors: Tuple[str, ...] = ()      # psum > 0 of a flag
    first: Tuple[str, ...] = ()    # equal on every shard: shard 0's


def reduce_stats(per_shard: List[Dict[str, torch.Tensor]], device,
                 spec: StatReduce) -> Dict[str, torch.Tensor]:
    """One step's per-shard stats (each a dict of (B,) or () tensors on
    its shard's device) reduced over the shards on ``device``, with no
    host read: the global sums, the per-shard maxima and the or-ed flags
    of ``spec``, as (B,) int64 tensors."""
    keys = list(per_shard[0])
    B = per_shard[0]["range_fail"].reshape(-1).shape[0]
    table = torch.stack([
        torch.stack([w[k].to(torch.int64).expand(B) for k in keys]).to(device)
        for w in per_shard
    ])
    row = {k: table[:, i] for i, k in enumerate(keys)}
    out = {k: row[k][0] for k in spec.first}
    out.update({k: row[k].sum(dim=0) for k in spec.sums})
    out.update({k + "_max": row[k].amax(dim=0) for k in spec.maxima})
    out.update({k: row[k].any(dim=0).to(torch.int64) for k in spec.ors})
    return out


# the JAX hash window engine's reduce (parallel/shard.py's local_window)
HASH_REDUCE = StatReduce(
    sums=("num_occupied", "num_free", "num_candidates", "batch_n_unique",
          "batch_n_need"),
    maxima=("batch_n_unique", "batch_n_need"),
    ors=("unique_overflow", "batch_overflow", "insert_overflow"),
    first=("overflowed", "range_fail"),
)
# the JAX per-ping step's (parallel/shard.py's _local_update)
HASH_W1_REDUCE = StatReduce(
    sums=("num_occupied", "num_free", "num_candidates"),
    ors=("unique_overflow",),
    first=("overflowed", "range_fail"),
)


def replicated_step(
    state,
    frames: range,
    *,
    apply: Callable,
    brick_bits: int,
    stat_dtypes: Dict[str, type],
    sizes: Tuple[str, ...],
    images_dev: Dict[torch.device, torch.Tensor],
    T_dev: Dict[torch.device, torch.Tensor],
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype,
):
    """One step of a replicated-records engine: each shard computes the
    records it owns of ``frames`` on its device and applies them with
    ``apply(shard state, stacked records, stacked aux, cfg)``; then the
    step commits on every shard or on none.  Returns (state, the step's
    per-frame host stats)."""
    mesh = state.mesh
    results = []
    for s, (shard, dev) in enumerate(zip(state.shards, mesh)):
        recs, auxs = stack_frame_records([
            owned_frame_records(images_dev[dev][i], T_dev[dev][i], s,
                                len(mesh), tables=tables, cfg=cfg,
                                dtype=dtype, brick_bits=brick_bits)
            for i in frames
        ])
        new, win = apply(shard, recs, auxs, cfg)
        results.append((new, host_stats(win)))
    stats = {k: np.zeros(len(frames), dt) for k, dt in stat_dtypes.items()}
    return commit(state, results, stats, sizes), stats


def replicated_step_budgeted(
    state,
    frames: range,
    *,
    apply: Callable,
    apply_kw: Callable[[int], Dict[str, Any]],
    brick_bits: int,
    unique_budget: int,
    reduce: StatReduce,
    images_dev: Dict[torch.device, torch.Tensor],
    T_dev: Dict[torch.device, torch.Tensor],
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype,
):
    """``replicated_step`` at fixed widths, with no host read: each shard's
    records are ``unique_budget`` lanes a frame, its apply runs with the
    budgets ``apply_kw(first frame)`` gives up to its writes, and the window
    commits on every shard or on none by the device-side OR of their
    flags.  Returns (state, the window's stats on ``mesh[0]``, reduced
    over the shards by ``reduce``)."""
    mesh = state.mesh
    kw = apply_kw(frames.start)
    pendings = []
    for s, (shard, dev) in enumerate(zip(state.shards, mesh)):
        recs, auxs = stack_frame_records([
            owned_frame_records(images_dev[dev][i], T_dev[dev][i], s,
                                len(mesh), tables=tables, cfg=cfg,
                                dtype=dtype, brick_bits=brick_bits,
                                unique_budget=unique_budget)
            for i in frames
        ], cut=False)
        pendings.append(apply(shard, recs, auxs, cfg, commit=False, **kw))
    state, wins = commit_budgeted(state, pendings)
    return state, reduce_stats(wins, mesh[0], reduce)


def scan_windows(
    state, start: int, *, n_frames: int, window: int, step: Callable,
    stat_dtypes: Dict[str, type], budgeted: bool = False,
):
    """Steps ``step(state, frames)`` over windows of ``window`` frames from
    frame ``start`` (a window boundary) to ``n_frames``; returns (state,
    per-frame host stats (n_frames,)).  Count-sized, it stops at the first
    failed window: its frames and every later one report ``overflowed``.
    ``budgeted`` steps return device stats and never read: every window
    runs (a failed one poisons every shard, so the later ones fail too),
    and the stats are read once, at the end."""
    if start % window:
        raise ValueError(f"start {start} is not a multiple of window {window}")
    if budgeted:
        done = []
        for w0 in range(start, n_frames, window):
            state, win = step(state, range(w0, min(w0 + window, n_frames)))
            done.append(win)
        return state, _read_stats(done, stat_dtypes, n_frames, start)
    stats = {k: np.zeros(n_frames, dt) for k, dt in stat_dtypes.items()}
    for w0 in range(start, n_frames, window):
        w1 = min(w0 + window, n_frames)
        state, win = step(state, range(w0, w1))
        for k, v in win.items():
            stats[k][w0:w1] = v
        if win["overflowed"][0]:
            stats["overflowed"][w1:] = True
            break
    return state, stats


def run_grow_replay(
    *,
    state,
    n_frames: int,
    scan: Callable,
    rehash: Callable,
    label: str,
    growable_causes: Tuple[Tuple[str, Callable[[], None]], ...] = (),
    max_grow_retries: int = MAX_GROW_RETRIES,
):
    """The sharded engines' host loop (JAX's ``shard_brick.run_grow_replay``):
    ``scan(state, start)`` maps frames [start, n_frames) and returns
    (state, per-frame host stats, frames from its first failed window on
    reporting ``overflowed``).  The stats of the applied frames are
    merged; on a failed window the cause is attributed in JAX's order: a
    key-range failure or, where the stats carry it, a count-packing
    overflow is fatal (ValueError); then the first of ``growable_causes``
    (``(stat key, grow)`` pairs, the engine's budgets in its order) whose
    flag any failed frame carries calls its ``grow()``, which changes the
    budgets the next ``scan`` reads, and the scan replays with
    ``poisoned`` cleared and no rehash; with none, it is bucket pressure:
    every shard doubles (``rehash(state, new_local_capacity)``) and the
    scan replays from that window.  RuntimeError after
    ``max_grow_retries`` scans."""
    merged: Optional[Dict[str, np.ndarray]] = None
    start = 0
    for _ in range(max_grow_retries):
        new_state, stats = scan(state, start)
        if merged is None:
            merged = {k: np.zeros(n_frames, v.dtype) for k, v in stats.items()}
        over = stats["overflowed"]
        applied_hi = int(np.argmax(over)) if over.any() else n_frames
        for k, v in stats.items():
            merged[k][start:applied_hi] = v[start:applied_hi]
        if applied_hi == n_frames:
            return new_state, merged
        start = applied_hi
        if stats["range_fail"][start:].any():
            raise ValueError(
                f"frame >= {start}: voxel keys outside the packable range "
                "— check odometry frame offsets; growth cannot fix this"
            )
        if "pack_overflow" in stats and stats["pack_overflow"][start:].any():
            raise ValueError(
                f"frame >= {start}: a voxel received 2^16+ emissions in one "
                "frame (count packing width)"
            )
        for key, grow in growable_causes:
            if key in stats and stats[key][start:].any():
                grow()
                state = unpoison(new_state)
                break
        else:
            state = rehash(new_state, new_state.local_capacity * 2)
    raise RuntimeError(
        f"{label} growth did not converge after {max_grow_retries} retries"
    )


def grow_insert(insert_budget):
    """An insert budget (an int or a per-window list) doubled, as the JAX
    engines grow it; None stays None."""
    if isinstance(insert_budget, (list, tuple)):
        return type(insert_budget)(2 * b for b in insert_budget)
    return None if insert_budget is None else 2 * insert_budget


def grow_shards(state, new_local_capacity: int, grow_once: Callable):
    """Every shard re-built at one capacity by ``grow_once(shard,
    capacity)`` (-> (state, () bool a bucket overflowed)), doubling it
    until every shard fits, with one host read an attempt.  Ownership
    depends only on the key, so no entry changes shard."""
    while True:
        grown = [grow_once(s, new_local_capacity) for s in state.shards]
        dev0 = state.mesh[0]
        if not bool(torch.stack([o.to(dev0) for _, o in grown]).any()):
            return type(state)(tuple(g for g, _ in grown))
        new_local_capacity *= 2


def check_sharded_state(state, mesh, dtype: torch.dtype):
    """``state``, a map a sharded engine resumes; ValueError unless it is
    on ``mesh`` (when given) and of ``dtype``."""
    if mesh is not None and make_mesh(mesh) != state.mesh:
        raise ValueError(f"mesh {make_mesh(mesh)} is not the state's "
                         f"{state.mesh}")
    if state.dtype != dtype:
        raise ValueError(f"state is {state.dtype}, not {dtype}")
    return state


def on_mesh(x, mesh: Mesh, dtype: Optional[torch.dtype] = None):
    """{device: ``x`` on it (in ``dtype``)}, one copy a distinct device of
    the mesh."""
    x = x if isinstance(x, torch.Tensor) else to_device(x, "cpu")
    return {d: x.to(device=d, dtype=dtype or x.dtype)
            for d in dict.fromkeys(mesh)}


def sequence_inputs(images, positions, quaternions, cfg: MapperConfig,
                    tables: Optional[FanTables]):
    """(images (P, R, B), fan tables, (P, 4, 4) sonar-to-world poses) of a
    recorded sequence, on the host."""
    images = np.asarray(images)
    return (images, tables_for_images(images, cfg, tables),
            batched_sonar_to_world(positions, quaternions, cfg))


# ---------------------------------------------------------------------------
# The sharded hash map
# ---------------------------------------------------------------------------


class ShardedHashState(NamedTuple):
    """A hash map split over a mesh: one HashGridState per shard, each on
    its mesh device, all of one capacity.  Shards hold disjoint voxels
    (each on its ``owner_shard``); the bounds are global and replicated
    (every shard applies every frame's bounds); ``used`` and ``poisoned``
    are per shard."""

    shards: Tuple[HashGridState, ...]

    @property
    def mesh(self) -> Mesh:
        return tuple(s.log_odds.device for s in self.shards)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def local_capacity(self) -> int:
        """Slots per shard."""
        return self.shards[0].capacity

    # as on every map, the stream sees table growth through ``capacity``
    capacity = local_capacity

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].log_odds.dtype

    @property
    def min_bounds(self) -> torch.Tensor:
        """(3,) global bounds, replicated: shard 0's copy."""
        return self.shards[0].min_bounds

    @property
    def max_bounds(self) -> torch.Tensor:
        return self.shards[0].max_bounds

    @property
    def used(self) -> torch.Tensor:
        """(S,) int64 occupied slots per shard, on the host."""
        return torch.stack([s.used.cpu() for s in self.shards])

    @property
    def poisoned(self) -> torch.Tensor:
        """(S,) bool, on the host."""
        return torch.stack([s.poisoned.cpu() for s in self.shards])

    @property
    def key_hi(self) -> torch.Tensor:
        """(S, C) hi words in slot order (EMPTY_HI: free), on the host."""
        return torch.stack([s.key_hi.cpu() for s in self.shards])

    @property
    def key_lo(self) -> torch.Tensor:
        return torch.stack([s.key_lo.cpu() for s in self.shards])

    @property
    def keys(self) -> torch.Tensor:
        """(S, C, 3) int32 voxel keys, empty slots ``EMPTY``, on the host."""
        hi, lo = self.key_hi, self.key_lo
        keys = unpack_keys(hi, lo).to(torch.int32)
        return torch.where((hi == EMPTY_HI)[..., None], EMPTY, keys)


def init_sharded_hash_grid(
    mesh=None,
    local_capacity: int = 1 << 17,
    dtype: torch.dtype = torch.float32,
) -> ShardedHashState:
    """An empty map of ``local_capacity`` (a power of two, at least 128)
    slots a shard, shard ``s`` on ``mesh[s]`` (a device list; None: every
    visible card)."""
    return ShardedHashState(tuple(
        init_hash_grid(local_capacity, dtype, d) for d in make_mesh(mesh)
    ))


def owner_block_step(
    state: ShardedHashState,
    frames: range,
    *,
    images: torch.Tensor,
    transforms: torch.Tensor,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype,
):
    """The hash engine's window-1 step: the ping's records once
    (``frame_owner_blocks``, on the device of ``images`` and
    ``transforms``: ``mesh[0]``), one host read of where its owner blocks
    lie, then each shard's ``apply_frame_records`` of its block and the
    all-or-nothing commit.  Returns (state, the ping's host stats)."""
    (i,) = frames
    blocks = frame_owner_blocks(images[i], transforms[i], state.n_shards,
                                tables=tables, cfg=cfg, dtype=dtype)
    starts = blocks.starts.tolist()
    results = []
    for s, (shard, dev) in enumerate(zip(state.shards, state.mesh)):
        rec, aux = owner_block(blocks, s, starts, dev)
        new, win = apply_frame_records(shard, rec, aux, cfg)
        results.append((new, host_stats(win)))
    stats = {k: np.zeros(1, dt) for k, dt in SHARDED_HASH_STAT_DTYPES.items()}
    return commit(state, results, stats, ("batch_n_unique",)), stats


def owner_block_step_budgeted(
    state: ShardedHashState,
    frames: range,
    *,
    images: torch.Tensor,
    transforms: torch.Tensor,
    unique_budget: int,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype,
):
    """``owner_block_step`` at fixed widths, with no host read: each
    shard's block is ``unique_budget`` lanes (``owner_block_budgeted``),
    its update (``grid.hash.prepare_frame_budgeted``) stops before its
    writes, and the ping commits on every shard or on none by the
    device-side OR of their flags (JAX's ``_local_update``).  Returns
    (state, the ping's stats on ``mesh[0]``)."""
    (i,) = frames
    blocks = frame_owner_blocks(images[i], transforms[i], state.n_shards,
                                tables=tables, cfg=cfg, dtype=dtype)
    pendings = []
    for s, (shard, dev) in enumerate(zip(state.shards, state.mesh)):
        rec, aux = owner_block_budgeted(blocks, s, unique_budget, dev)
        pendings.append(prepare_frame_budgeted(shard, rec, aux, cfg))
    state, wins = commit_budgeted(state, pendings)
    return state, reduce_stats(wins, state.mesh[0], HASH_W1_REDUCE)


class Budgets:
    """The budgets a sharded run is at (JAX's keyword arguments, None where
    not given), and their growth by cause.  ``budgeted``: any was given
    (the run is fixed-width from then on, whatever grows); none: the run
    is count-sized and only the tables grow.  Engines add their budgets'
    defaults (``apply_kw``) and growth order (``causes``)."""

    KEYS: Tuple[str, ...] = ()

    def __init__(self, tables, cfg, window: int, **budgets):
        self.tables, self.cfg, self.window = tables, cfg, window
        self.b = {k: budgets.get(k) for k in self.KEYS}
        self.budgeted = any(v is not None for v in self.b.values())

    def unique(self) -> int:
        """The unique budget (default: ``effective_unique_budget``)."""
        return (self.b["unique_budget"]
                or effective_unique_budget(self.tables, self.cfg))

    def insert(self, w0: int):
        """The window at frame ``w0``'s insert budget (a per-window list:
        its entry, the last from there on)."""
        return _insert_budget(self.b["insert_budget"], w0 // self.window)

    def grow_unique(self, *derived: str):
        """Double the unique budget; the ``derived`` budgets return to
        their defaults, which scale with it."""
        self.b["unique_budget"] = 2 * self.unique()
        self.b.update(dict.fromkeys(derived))

    def grow_insert(self):
        self.b["insert_budget"] = grow_insert(self.b["insert_budget"])

    def effective(self) -> Dict[str, Any]:
        """What the run settled on, as JAX's ``effective`` reports it."""
        return dict(self.b)


class _HashBudgets(Budgets):
    """The sharded hash engine's budgets (JAX's
    ``map_ping_sequence_sharded``)."""

    KEYS = ("unique_budget", "batch_budget", "lane_budget", "insert_budget")

    def apply_kw(self, w0: int) -> Dict[str, Any]:
        """The window at frame ``w0``'s per-shard apply budgets: the batch
        budget (default ``default_batch_budget(window, U)``), the lane and
        the insert budget."""
        return dict(
            batch_budget=(self.b["batch_budget"]
                          or default_batch_budget(self.window, self.unique())),
            lane_budget=self.b["lane_budget"], insert_budget=self.insert(w0))

    def causes(self):
        """JAX's growth order after the fatal causes: unique (the batch
        budget re-derives from it), insert, batch."""
        def batch():
            self.b["batch_budget"] = 2 * self.apply_kw(0)["batch_budget"]

        return (("unique_overflow", lambda: self.grow_unique("batch_budget")),
                ("insert_overflow", self.grow_insert),
                ("batch_overflow", batch))


def _hash_step(state, images, transforms, tables, cfg, dtype, window,
               budgets: Optional[_HashBudgets] = None):
    """The hash engine's ``step(state, frames)`` over these pings: at
    window 1 ``owner_block_step`` (each ping's records once, on
    ``mesh[0]``), else ``replicated_step`` with one
    ``apply_records_batched`` a window (every shard derives its records,
    as in JAX's window engine); their budgeted forms when ``budgets``
    holds any (which they read at each step, so a growth shows in the
    next scan)."""
    budgeted = budgets is not None and budgets.budgeted
    if window == 1:
        src = state.mesh[:1]
        kw = dict(images=on_mesh(images, src)[src[0]],
                  transforms=on_mesh(transforms, src, dtype)[src[0]],
                  tables=tables, cfg=cfg, dtype=dtype)
        if not budgeted:
            return functools.partial(owner_block_step, **kw)
        return lambda st, frames: owner_block_step_budgeted(
            st, frames, unique_budget=budgets.unique(), **kw)
    kw = dict(brick_bits=0, images_dev=on_mesh(images, state.mesh),
              T_dev=on_mesh(transforms, state.mesh, dtype),
              tables=tables, cfg=cfg, dtype=dtype)
    if not budgeted:
        return functools.partial(
            replicated_step, apply=apply_records_batched,
            stat_dtypes=SHARDED_HASH_STAT_DTYPES, sizes=("batch_n_unique",),
            **kw)
    return lambda st, frames: replicated_step_budgeted(
        st, frames, apply=apply_records_batched, apply_kw=budgets.apply_kw,
        unique_budget=budgets.unique(), reduce=HASH_REDUCE, **kw)


def _hash_dtypes(window: int, budgeted: bool) -> Dict[str, type]:
    if not budgeted:
        return SHARDED_HASH_STAT_DTYPES
    return (SHARDED_HASH_W1_BUDGET_STAT_DTYPES if window == 1
            else SHARDED_HASH_BUDGET_STAT_DTYPES)


def _scan_hash(state, images, transforms, mesh, tables, cfg, dtype, window,
               start, **budget_kw):
    state = check_sharded_state(state, mesh, dtype)
    budgets = _HashBudgets(tables, cfg, window, **budget_kw)
    step = _hash_step(state, images, transforms, tables, cfg, dtype, window,
                      budgets)
    return scan_windows(state, start, n_frames=len(images), window=window,
                        step=step,
                        stat_dtypes=_hash_dtypes(window, budgets.budgeted),
                        budgeted=budgets.budgeted)


def scan_pings_sharded(
    state: ShardedHashState,
    images,
    transforms,
    mesh,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype = torch.float32,
    start: int = 0,
    unique_budget: Optional[int] = None,
) -> Tuple[ShardedHashState, Dict[str, np.ndarray]]:
    """Apply pings [start, P) of ``images`` (P, R, B) with their
    ``transforms`` (P, 4, 4) sonar-to-world to the sharded map, one ping at
    a time.  ``mesh`` (None: the state's) must be the state's.  Returns
    (state, per-ping stats (P,) on the host: SHARDED_HASH_STAT_DTYPES;
    frames before ``start`` report zeros).  Stops at the first failed
    ping: it and every later one report ``overflowed``, and every shard of
    the returned state is as before it, poisoned.

    ``unique_budget`` (JAX's ``make_scan_pings_sharded``) runs every ping
    at that many record lanes a shard with no host read and reads the
    stats (``SHARDED_HASH_W1_BUDGET_STAT_DTYPES``) once, at the end; a
    failed ping poisons every shard and the later pings are no-ops."""
    return _scan_hash(state, images, transforms, mesh, tables, cfg, dtype,
                      1, start, unique_budget=unique_budget,
                      batch_budget=None, lane_budget=None,
                      insert_budget=None)


def window_scan_sharded(
    state: ShardedHashState,
    images,
    transforms,
    mesh,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype = torch.float32,
    window: int = 8,
    start: int = 0,
    unique_budget: Optional[int] = None,
    batch_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget=None,
) -> Tuple[ShardedHashState, Dict[str, np.ndarray]]:
    """``scan_pings_sharded`` a window of pings at a time: each shard
    applies its records of a window's frames with one
    ``apply_records_batched`` (each voxel's chain lives on its owner, so
    the sequential semantics hold), and a window commits on every shard or
    on none.  ``start`` is a window boundary.

    Any budget (JAX's ``make_window_scan_sharded``: ``unique_budget``
    lanes a frame, and the PER-SHARD ``batch_budget`` (default
    ``default_batch_budget(window, U)``), ``lane_budget`` and
    ``insert_budget``, an int or a [cold, warm] list indexed by window)
    runs every window at fixed widths with no host read and reads the
    stats (``SHARDED_HASH_BUDGET_STAT_DTYPES``: global sums and the
    per-shard maxima ``batch_n_unique_max`` / ``batch_n_need_max``) once,
    at the end."""
    return _scan_hash(state, images, transforms, mesh, tables, cfg, dtype,
                      window, start, unique_budget=unique_budget,
                      batch_budget=batch_budget, lane_budget=lane_budget,
                      insert_budget=insert_budget)


def sharded_ping_step(
    state: ShardedHashState,
    image,
    T,
    mesh,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype = torch.float32,
) -> Tuple[ShardedHashState, Dict[str, np.generic]]:
    """One ping (``image`` (R, B), ``T`` (4, 4) sonar-to-world) through the
    sharded map; returns (state, its stats as host scalars)."""
    image = image if isinstance(image, torch.Tensor) else np.asarray(image)
    T = T if isinstance(T, torch.Tensor) else np.asarray(T)
    state, stats = scan_pings_sharded(state, image[None], T[None], mesh,
                                      tables, cfg, dtype)
    return state, {k: v[0] for k, v in stats.items()}


def rehash_sharded(
    state: ShardedHashState, new_local_capacity: int
) -> ShardedHashState:
    """Grow every shard's table to ``new_local_capacity`` slots through
    ``grid.hash.rehash_once`` (entries re-inserted in slot order;
    ``poisoned`` cleared for replay); while a shard's buckets do not fit,
    every shard doubles further."""
    return grow_shards(state, new_local_capacity, rehash_once)


def map_ping_sequence_sharded(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: Optional[MapperConfig] = None,
    *,
    mesh=None,
    local_capacity: int = 1 << 17,
    state: Optional[ShardedHashState] = None,
    dtype: torch.dtype = torch.float32,
    window: int = 1,
    tables: Optional[FanTables] = None,
    unique_budget: Optional[int] = None,
    batch_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget=None,
    max_grow_retries: int = MAX_GROW_RETRIES,
    effective: Optional[Dict[str, Any]] = None,
) -> Tuple[ShardedHashState, Dict[str, np.ndarray]]:
    """Map a recorded ping sequence into a sharded hash map.

    ``mesh`` is a device list (``make_mesh``; a device may repeat; None:
    every visible card, RuntimeError where there is none); ``state``
    resumes a map, whose mesh and dtype it is (a ``mesh`` given with it
    must match; ValueError); a fresh map holds ``local_capacity`` slots a
    shard.  ``window`` 1 applies one ping at a time
    (``scan_pings_sharded``), a larger window a window at a time
    (``window_scan_sharded``).  ``tables`` are as in
    ``pipeline.map_ping_sequence``.

    Returns (state, per-ping stats (P,) on the host:
    SHARDED_HASH_STAT_DTYPES).  The map equals
    ``pipeline.map_ping_sequence(backend="hash")``'s voxel by voxel, and
    each shard holds exactly the voxels it owns.  A step that would
    overflow a bucket on any shard grows every shard and replays; keys
    outside the packable range are fatal (ValueError).

    Budgets (JAX's arguments: ``unique_budget``; at window > 1 also the
    per-shard ``batch_budget``, ``lane_budget`` and ``insert_budget``, an
    int or a [cold, warm] list) run every step at fixed widths with no
    host read and one stats read a scan (the stats are then the JAX
    engine's, ``SHARDED_HASH_BUDGET_STAT_DTYPES`` /
    ``SHARDED_HASH_W1_BUDGET_STAT_DTYPES``); an overflow grows by JAX's
    cause order: unique (doubled; the batch budget re-derives), insert
    (doubled), batch (doubled), then the tables.  The map and every
    shared stat equal the count-sized run's.  ``effective`` (a dict)
    receives the budgets the run settled on (None where none was given or
    grown); ``max_grow_retries`` bounds the scans (RuntimeError past it)."""
    cfg = cfg or MapperConfig()
    state = (init_sharded_hash_grid(mesh, local_capacity, dtype)
             if state is None else check_sharded_state(state, mesh, dtype))
    images, tables, T = sequence_inputs(images, positions, quaternions, cfg,
                                        tables)
    P = len(images)
    window = min(max(window, 1), P)
    budgets = _HashBudgets(tables, cfg, window, unique_budget=unique_budget,
                           batch_budget=batch_budget, lane_budget=lane_budget,
                           insert_budget=insert_budget)
    if P == 0:
        return state, {k: np.zeros(0, dt)
                       for k, dt in _hash_dtypes(1, budgets.budgeted).items()}
    scan = functools.partial(
        scan_windows, n_frames=P, window=window,
        step=_hash_step(state, images, T, tables, cfg, dtype, window,
                        budgets),
        stat_dtypes=_hash_dtypes(window, budgets.budgeted),
        budgeted=budgets.budgeted)
    out = run_grow_replay(
        state=state, n_frames=P, scan=scan, rehash=rehash_sharded,
        label="sharded hash",
        growable_causes=budgets.causes() if budgets.budgeted else (),
        max_grow_retries=max_grow_retries)
    if effective is not None:
        effective.update(budgets.effective())
    return out


# ---------------------------------------------------------------------------
# Reads
# ---------------------------------------------------------------------------


def gather_sharded_state(
    state: ShardedHashState,
) -> Tuple[np.ndarray, np.ndarray]:
    """Every slot of the map on the host: ((S*C, 3) int32 keys, empty
    slots ``EMPTY``, (S*C,) log-odds), shard-major, in slot order."""
    keys = state.keys.reshape(-1, 3).numpy()
    log_odds = torch.cat([s.log_odds.cpu() for s in state.shards]).numpy()
    return keys, log_odds


def touched_voxels_sharded(
    state: ShardedHashState,
) -> Tuple[np.ndarray, np.ndarray]:
    """((N, 3) int32 touched voxel keys, (N,) log-odds) of the whole map,
    shard by shard, each in slot order: the layout-free view that
    snapshots store."""
    parts = [touched_voxels_hash(s) for s in state.shards]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def sharded_bounds(state: ShardedHashState) -> Tuple[np.ndarray, np.ndarray]:
    """The global (min, max) updated-voxel-centre bounds (shard 0's copy;
    reference 3d_mapper.py:112-115)."""
    return state.min_bounds.cpu().numpy(), state.max_bounds.cpu().numpy()


def sharded_hash_state_to_numpy(state: ShardedHashState) -> Dict[str, np.ndarray]:
    """NumPy arrays in the JAX package's stacked ``(S, ...)`` layout and
    dtypes (``grid.hash.hash_state_to_numpy`` per shard)."""
    per = [hash_state_to_numpy(s) for s in state.shards]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}

