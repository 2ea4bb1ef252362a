"""The sharded brick map's state, ownership, growth and reads (PyTorch port
of the state layer of ``sonar_3d_reconstruction_tpu.parallel.shard_brick``).

The brick table splits into S independent sub-tables, shard ``s`` on
``mesh[s]`` (parallel/shard.py; a device may repeat).  A voxel's owner is
a hash of its BRICK code mod S, so whole bricks stay on one shard: a
window's in-brick chain runs locally on the owner and the map equals the
single-card brick map voxel for voxel.  Shards hold disjoint bricks, so
every read distributes exactly: run it per shard and concatenate (point
log-odds: sum, since absent shards answer 0.0).

All shards keep one ``local_capacity`` and grow together.  The bounds are
global and replicated (every shard applies every frame's bounds); ``used``
and ``poisoned`` are per shard.

Not ported: the JAX module's replicated-records engine
(``make_window_scan_sharded_brick`` / ``map_ping_sequence_sharded_brick``),
which recomputes every frame's records on every shard and so scales only
the apply half.  The frame-parallel engine (parallel/shard_frames.py) that
every user surface drives shards both halves and uses this layer.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.grid.brick import (
    DEFAULT_BRICK_BITS,
    BrickGridState,
    brick_state_to_numpy,
    extract_classified_brick,
    extract_occupied_brick,
    init_brick_grid,
    query_log_odds_brick,
    rehash_bricks,
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import U32, brick_layout, mix2
from sonar_3d_reconstruction_tpu_torch.parallel.shard import Mesh, make_mesh
from sonar_3d_reconstruction_tpu_torch.pipeline import MAX_GROW_RETRIES


class ShardedBrickState(NamedTuple):
    """A brick map split over a mesh: one BrickGridState per shard, each on
    its mesh device, all of one capacity."""

    shards: Tuple[BrickGridState, ...]

    @property
    def mesh(self) -> Mesh:
        return tuple(s.log_odds.device for s in self.shards)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def local_capacity(self) -> int:
        """Brick slots per shard."""
        return self.shards[0].capacity

    # the stream counts table doublings through ``capacity`` on every map
    capacity = local_capacity

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].log_odds.dtype

    @property
    def brick_volume(self) -> int:
        return self.shards[0].brick_volume

    @property
    def brick_bits(self) -> int:
        return self.shards[0].brick_bits

    @property
    def min_bounds(self) -> torch.Tensor:
        """(3,) global bounds, replicated: shard 0's copy."""
        return self.shards[0].min_bounds

    @property
    def max_bounds(self) -> torch.Tensor:
        return self.shards[0].max_bounds

    @property
    def used(self) -> torch.Tensor:
        """(S,) int64 touched voxels per shard, on the host."""
        return torch.stack([s.used.cpu() for s in self.shards])

    @property
    def poisoned(self) -> torch.Tensor:
        """(S,) bool, on the host."""
        return torch.stack([s.poisoned.cpu() for s in self.shards])


def init_sharded_brick_grid(
    mesh,
    local_capacity: int = 1 << 14,
    dtype: torch.dtype = torch.float32,
    brick_bits: int = DEFAULT_BRICK_BITS,
) -> ShardedBrickState:
    """An empty map of ``local_capacity`` (a power of two) bricks a shard,
    shard ``s`` on ``mesh[s]`` (a device list; None: every visible card)."""
    if local_capacity <= 0 or local_capacity & (local_capacity - 1):
        raise ValueError(f"local_capacity {local_capacity} is not a power "
                         f"of two")
    return ShardedBrickState(tuple(
        init_brick_grid(local_capacity, dtype, d, brick_bits)
        for d in make_mesh(mesh)
    ))


def owner_shard_brick(
    hi: torch.Tensor, lo: torch.Tensor, brick_bits: int, n_shards: int
) -> torch.Tensor:
    """Brick-major codes (ops/packing.pack_brick_keys) -> int64 owner shard
    of their BRICK: the offset and frame bits are masked, so every voxel of
    a brick lands on one shard.  ``mix2(brick_lo, hi) % S``, bit-equal to
    the JAX package's, which snapshots and the parity tests rely on."""
    _, o, _ = brick_layout(brick_bits)
    brick_lo = lo & (U32 ^ ((1 << (o + 4)) - 1))
    return mix2(brick_lo, hi) % n_shards


def rehash_sharded_bricks(
    state: ShardedBrickState, new_local_capacity: int
) -> ShardedBrickState:
    """Grow every shard's table to ``new_local_capacity`` bricks (clears
    ``poisoned`` for replay) through ``grid.brick.rehash_bricks``.  A
    shard whose buckets do not fit doubles further, and then every shard
    takes that capacity.  Ownership depends only on the brick code, so no
    entry changes shard."""
    grown = [rehash_bricks(s, new_local_capacity) for s in state.shards]
    cap = max(g.capacity for g in grown)
    return ShardedBrickState(tuple(
        g if g.capacity == cap else rehash_bricks(s, cap)
        for g, s in zip(grown, state.shards)
    ))


def local_brick_states(state: ShardedBrickState) -> List[BrickGridState]:
    """Each shard's sub-table as a plain BrickGridState, on its device."""
    return list(state.shards)


def default_local_capacity(initial_capacity: int, n_shards: int) -> int:
    """Bricks a shard from a voxel-scale ``initial_capacity`` (the mappers'
    contract): ``initial_capacity >> 4`` bricks split over the shards,
    at least 128, rounded up to a power of two."""
    local = max(128, (initial_capacity >> 4) // n_shards)
    return 1 << (local - 1).bit_length()


def extract_occupied_sharded(
    state: ShardedBrickState, cfg: MapperConfig
) -> Tuple[np.ndarray, np.ndarray]:
    """Occupied (points, probabilities) of the map: each shard's
    ``extract_occupied_brick``, concatenated in shard order."""
    parts = [extract_occupied_brick(s, cfg) for s in state.shards]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def extract_classified_sharded(
    state: ShardedBrickState, cfg: MapperConfig
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Every touched voxel by class: each shard's
    ``extract_classified_brick``, concatenated in shard order."""
    parts = [extract_classified_brick(s, cfg) for s in state.shards]
    return {k: (np.concatenate([p[k][0] for p in parts]),
                np.concatenate([p[k][1] for p in parts]))
            for k in ("free", "occupied", "unknown")}


def gather_sharded_brick_state(
    state: ShardedBrickState,
) -> Tuple[np.ndarray, np.ndarray]:
    """((N, 3) int32 touched voxel keys, (N,) log-odds) of the whole map,
    shard by shard: the layout-free view that snapshots store."""
    parts = [touched_voxels_brick(s) for s in state.shards]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def sharded_brick_bounds(
    state: ShardedBrickState,
) -> Tuple[np.ndarray, np.ndarray]:
    """The global (min, max) updated-voxel-centre bounds (shard 0's copy)."""
    return state.min_bounds.cpu().numpy(), state.max_bounds.cpu().numpy()


def query_log_odds_sharded(
    state: ShardedBrickState, points, cfg: MapperConfig
) -> np.ndarray:
    """(N, 3) world points -> (N,) float64 log-odds, summed over the
    shards: a voxel lives on one shard and the others answer 0.0."""
    out = None
    for s in state.shards:
        v = query_log_odds_brick(s, points, cfg).astype(np.float64)
        out = v if out is None else out + v
    return out


def query_probability_sharded(
    state: ShardedBrickState, points, cfg: MapperConfig
) -> np.ndarray:
    """(N, 3) world points -> (N,) float64 occupancy probabilities; 0.5
    where a voxel was never updated."""
    return 1.0 / (1.0 + np.exp(-query_log_odds_sharded(state, points, cfg)))


def sharded_brick_state_to_numpy(state: ShardedBrickState) -> Dict[str, np.ndarray]:
    """NumPy arrays in the JAX package's stacked ``(S, ...)`` layout and
    dtypes (``grid.brick.brick_state_to_numpy`` per shard)."""
    per = [brick_state_to_numpy(s) for s in state.shards]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


def run_grow_replay(
    *,
    state: ShardedBrickState,
    n_frames: int,
    scan: Callable[[ShardedBrickState, int],
                   Tuple[ShardedBrickState, Dict[str, np.ndarray]]],
    label: str,
) -> Tuple[ShardedBrickState, Dict[str, np.ndarray]]:
    """The sharded engines' host loop: ``scan(state, start)`` maps frames
    [start, n_frames) and returns (state, per-frame host stats, frames
    from its first failed window on reporting ``overflowed``).  The stats
    of the applied frames are merged; on a failed window a key-range
    failure or a count-packing overflow is fatal (ValueError), anything
    else is bucket pressure: every shard doubles
    (``rehash_sharded_bricks``) and the scan replays from that window.

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
        if stats["pack_overflow"][start:].any():
            raise ValueError(
                f"frame >= {start}: a voxel received 2^16+ emissions in one "
                "frame (count packing width)"
            )
        state = rehash_sharded_bricks(new_state, new_state.local_capacity * 2)
    raise RuntimeError(
        f"{label} growth did not converge after {MAX_GROW_RETRIES} retries"
    )
