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
doubles every shard's table and replays.  The sharded windows are sized
from their counts (the fixed-width budgets are the single-map
pipeline's), so JAX's unique, batch and insert overflow branches have no
counterpart here: only bucket growth and the fatal key-range (and, on
bricks, count-packing) errors remain.

The hash engine.  ``ShardedHashState`` holds one ``grid.hash`` map a
shard.  ``sharded_ping_step`` and ``scan_pings_sharded`` apply one ping at
a time (``apply_frame_records``), ``window_scan_sharded`` a window of pings
at a time (``apply_records_batched``), and ``map_ping_sequence_sharded``
maps a recorded sequence with growth and replay.  They are plain functions
in place of the JAX package's jit factories (``make_sharded_ping_step``,
``make_scan_pings_sharded``, ``make_window_scan_sharded``): there is
nothing to compile.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.device import require_cuda, to_device
from sonar_3d_reconstruction_tpu_torch.geometry import batched_sonar_to_world
from sonar_3d_reconstruction_tpu_torch.grid.hash import (
    EMPTY,
    HashGridState,
    apply_frame_records,
    apply_records_batched,
    hash_state_to_numpy,
    init_hash_grid,
    rehash,
    touched_voxels_hash,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
    FanTables,
    backproject_ping,
    tables_for_images,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import (
    UniqueRecords,
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
    HASH_STAT_DTYPES,
    MAX_GROW_RETRIES,
)

Mesh = Tuple[torch.device, ...]

# per-ping stats of the sharded hash engine: the hash backend's
# (``num_occupied`` / ``num_free`` / ``num_candidates`` and the step's
# distinct voxels ``batch_n_unique`` summed over the shards) and the
# largest shard's distinct voxels
SHARDED_HASH_STAT_DTYPES = dict(HASH_STAT_DTYPES, batch_n_unique_max=np.int64)


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
) -> Tuple[UniqueRecords, FrameAux]:
    """One ping -> (the unique records of the voxels ``shard`` owns, the
    frame's FrameAux), on the image's device.

    Keys are voxel codes (``brick_bits`` 0) or brick codes; the aux is the
    full frame's (``_frame_candidates``) but for ``n_valid``, which counts
    the owned candidates."""
    hi, lo, occ, valid, owner, aux = _frame_candidates(
        image, T, n_shards, tables=tables, cfg=cfg, dtype=dtype,
        brick_bits=brick_bits)
    active = valid & (owner == shard)
    rec = dedup_frame(hi, lo, occ, active, brick=brick_bits > 0)
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


def scan_windows(
    state, start: int, *, n_frames: int, window: int, step: Callable,
    stat_dtypes: Dict[str, type],
):
    """Steps ``step(state, frames)`` over windows of ``window`` frames from
    frame ``start`` (a window boundary) to ``n_frames``; returns (state,
    per-frame host stats (n_frames,)).  Stops at the first failed window:
    its frames and every later one report ``overflowed``."""
    if start % window:
        raise ValueError(f"start {start} is not a multiple of window {window}")
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
):
    """The sharded engines' host loop: ``scan(state, start)`` maps frames
    [start, n_frames) and returns (state, per-frame host stats, frames
    from its first failed window on reporting ``overflowed``).  The stats
    of the applied frames are merged; on a failed window a key-range
    failure or, where the stats carry it, a count-packing overflow is
    fatal (ValueError), anything else is bucket pressure: every shard
    doubles (``rehash(state, new_local_capacity)``) and the scan replays
    from that window.

    The JAX loop's budget causes (unique, exchange, insert, batch) have no
    counterpart: the port sizes every window from its counts."""
    merged: Optional[Dict[str, np.ndarray]] = None
    start = 0
    for _ in range(MAX_GROW_RETRIES):
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
        state = rehash(new_state, new_state.local_capacity * 2)
    raise RuntimeError(
        f"{label} growth did not converge after {MAX_GROW_RETRIES} retries"
    )


def grow_shards(state, new_local_capacity: int, grow: Callable):
    """Every shard grown by ``grow(shard, capacity)`` (which doubles
    further until its buckets fit); a shard that needed more then sets
    every shard's capacity.  Ownership depends only on the key, so no
    entry changes shard."""
    grown = [grow(s, new_local_capacity) for s in state.shards]
    cap = max(g.capacity for g in grown)
    return type(state)(tuple(
        g if g.capacity == cap else grow(s, cap)
        for g, s in zip(grown, state.shards)
    ))


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

    # as on every map, table doublings are counted through ``capacity``
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


def _hash_step(state, images, transforms, tables, cfg, dtype, window):
    """The hash engine's ``step(state, frames)`` over these pings: at
    window 1 ``owner_block_step`` (each ping's records once, on
    ``mesh[0]``), else ``replicated_step`` with one
    ``apply_records_batched`` a window (every shard derives its records,
    as in JAX's window engine)."""
    if window == 1:
        src = state.mesh[:1]
        return functools.partial(
            owner_block_step,
            images=on_mesh(images, src)[src[0]],
            transforms=on_mesh(transforms, src, dtype)[src[0]],
            tables=tables, cfg=cfg, dtype=dtype,
        )
    return functools.partial(
        replicated_step,
        apply=apply_records_batched,
        brick_bits=0, stat_dtypes=SHARDED_HASH_STAT_DTYPES,
        sizes=("batch_n_unique",),
        images_dev=on_mesh(images, state.mesh),
        T_dev=on_mesh(transforms, state.mesh, dtype),
        tables=tables, cfg=cfg, dtype=dtype,
    )


def _scan_hash(state, images, transforms, mesh, tables, cfg, dtype, window,
               start):
    state = check_sharded_state(state, mesh, dtype)
    step = _hash_step(state, images, transforms, tables, cfg, dtype, window)
    return scan_windows(state, start, n_frames=len(images), window=window,
                        step=step, stat_dtypes=SHARDED_HASH_STAT_DTYPES)


def scan_pings_sharded(
    state: ShardedHashState,
    images,
    transforms,
    mesh,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype = torch.float32,
    start: int = 0,
) -> Tuple[ShardedHashState, Dict[str, np.ndarray]]:
    """Apply pings [start, P) of ``images`` (P, R, B) with their
    ``transforms`` (P, 4, 4) sonar-to-world to the sharded map, one ping at
    a time.  ``mesh`` (None: the state's) must be the state's.  Returns
    (state, per-ping stats (P,) on the host: SHARDED_HASH_STAT_DTYPES;
    frames before ``start`` report zeros).  Stops at the first failed
    ping: it and every later one report ``overflowed``, and every shard of
    the returned state is as before it, poisoned."""
    return _scan_hash(state, images, transforms, mesh, tables, cfg, dtype,
                      1, start)


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
) -> Tuple[ShardedHashState, Dict[str, np.ndarray]]:
    """``scan_pings_sharded`` a window of pings at a time: each shard
    applies its records of a window's frames with one
    ``apply_records_batched`` (each voxel's chain lives on its owner, so
    the sequential semantics hold), and a window commits on every shard or
    on none.  ``start`` is a window boundary."""
    return _scan_hash(state, images, transforms, mesh, tables, cfg, dtype,
                      window, start)


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
    ``grid.hash.rehash`` (entries re-inserted in slot order; ``poisoned``
    cleared for replay); a shard whose buckets do not fit doubles further,
    and then every shard takes that capacity."""
    return grow_shards(state, new_local_capacity, rehash)


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
    outside the packable range are fatal (ValueError)."""
    cfg = cfg or MapperConfig()
    state = (init_sharded_hash_grid(mesh, local_capacity, dtype)
             if state is None else check_sharded_state(state, mesh, dtype))
    images, tables, T = sequence_inputs(images, positions, quaternions, cfg,
                                        tables)
    P = len(images)
    if P == 0:
        return state, {k: np.zeros(0, dt)
                       for k, dt in SHARDED_HASH_STAT_DTYPES.items()}
    window = min(max(window, 1), P)
    scan = functools.partial(
        scan_windows, n_frames=P, window=window,
        step=_hash_step(state, images, T, tables, cfg, dtype, window),
        stat_dtypes=SHARDED_HASH_STAT_DTYPES)
    return run_grow_replay(state=state, n_frames=P, scan=scan,
                           rehash=rehash_sharded, label="sharded hash")


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

