"""The sharded brick map: its state, ownership, growth and reads, and the
replicated-records engine (PyTorch port of
``sonar_3d_reconstruction_tpu.parallel.shard_brick``).

The brick table splits into S independent sub-tables, shard ``s`` on
``mesh[s]`` (parallel/shard.py; a device may repeat).  A voxel's owner is
a hash of its BRICK code mod S (``owner_shard_brick``), so whole bricks
stay on one shard: a window's in-brick chain runs locally on the owner and
the map equals the single-card brick map voxel for voxel.  Shards hold
disjoint bricks, so every read distributes exactly: run it per shard and
concatenate (point log-odds: sum, since absent shards answer 0.0).

All shards keep one ``local_capacity`` and grow together.  The bounds are
global and replicated (every shard applies every frame's bounds); ``used``
and ``poisoned`` are per shard.

Two engines write this map.  The frame-parallel engine
(parallel/shard_frames.py), which every user surface drives, computes
each frame's records once and moves them to their owners.  The
replicated-records engine here (``map_ping_sequence_sharded_brick``) is
the sharded hash engine's design on bricks (parallel/shard.py): every
shard computes every frame's records, keeps the bricks it owns, and
applies its window with ``grid.brick.apply_brick_records_wide``, through
the binning kernel K1 (the JAX engine applies with XLA there).  Only its
apply half scales with the shards.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.grid.brick import (
    DEFAULT_BRICK_BITS,
    BrickGridState,
    apply_brick_records_wide,
    brick_state_to_numpy,
    extract_classified_brick,
    extract_occupied_brick,
    init_brick_grid,
    query_log_odds_brick,
    rehash_bricks,
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import FanTables
from sonar_3d_reconstruction_tpu_torch.parallel.shard import (
    Mesh,
    check_sharded_state,
    grow_shards,
    make_mesh,
    on_mesh,
    replicated_step,
    run_grow_replay,
    scan_windows,
    sequence_inputs,
)
# where the JAX package defines it (parallel/shard.py holds both owners)
from sonar_3d_reconstruction_tpu_torch.parallel.shard import (  # noqa: F401
    owner_shard_brick,
)
from sonar_3d_reconstruction_tpu_torch.pipeline import STAT_DTYPES

# per-ping stats of the replicated-records engine: the brick backend's
# (``num_occupied`` / ``num_free`` / ``num_candidates`` and the window
# sizes summed over the shards) and the window sizes' largest shard
REPLICATED_STAT_DTYPES = dict(
    STAT_DTYPES, batch_n_bricks_max=np.int64, batch_n_lanes_max=np.int64)


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


def rehash_sharded_bricks(
    state: ShardedBrickState, new_local_capacity: int
) -> ShardedBrickState:
    """Grow every shard's table to ``new_local_capacity`` bricks (clears
    ``poisoned`` for replay) through ``grid.brick.rehash_bricks``.  A
    shard whose buckets do not fit doubles further, and then every shard
    takes that capacity.  Ownership depends only on the brick code, so no
    entry changes shard."""
    return grow_shards(state, new_local_capacity, rehash_bricks)


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


# ---------------------------------------------------------------------------
# The replicated-records engine
# ---------------------------------------------------------------------------


def _brick_step(state, images, transforms, tables, cfg, dtype):
    """The replicated-records engine's ``step(state, frames)`` (the JAX
    package's ``make_window_scan_sharded_brick``): each shard applies its
    records of a window's frames (two-word brick codes) with one
    ``apply_brick_records_wide`` (K1), and the window commits on every
    shard or on none."""
    return functools.partial(
        replicated_step, apply=apply_brick_records_wide,
        brick_bits=state.brick_bits, stat_dtypes=REPLICATED_STAT_DTYPES,
        sizes=("batch_n_bricks", "batch_n_lanes"),
        images_dev=on_mesh(images, state.mesh),
        T_dev=on_mesh(transforms, state.mesh, dtype),
        tables=tables, cfg=cfg, dtype=dtype,
    )


def map_ping_sequence_sharded_brick(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: Optional[MapperConfig] = None,
    *,
    mesh=None,
    local_capacity: int = 1 << 14,
    state: Optional[ShardedBrickState] = None,
    dtype: torch.dtype = torch.float32,
    window: int = 8,
    tables: Optional[FanTables] = None,
) -> Tuple[ShardedBrickState, Dict[str, np.ndarray]]:
    """Map a recorded ping sequence into a sharded brick map with the
    replicated-records engine.

    ``mesh``, ``state``, ``dtype`` and ``tables`` are as in
    ``parallel.shard_frames.map_ping_sequence_sharded_frames``; a fresh
    map holds ``local_capacity`` bricks a shard.  Every window takes
    two-word brick codes.  Returns (state, per-ping stats (P,) on the
    host: REPLICATED_STAT_DTYPES).  The map equals
    ``pipeline.map_ping_sequence(backend="brick")``'s voxel by voxel, each
    shard holding exactly the bricks it owns.  A window that would
    overflow a bucket on any shard grows every shard and replays; keys
    outside the packable range and voxels with 2^16+ emissions in one
    frame are fatal (ValueError)."""
    cfg = cfg or MapperConfig()
    state = (init_sharded_brick_grid(mesh, local_capacity, dtype)
             if state is None else check_sharded_state(state, mesh, dtype))
    images, tables, T = sequence_inputs(images, positions, quaternions, cfg,
                                        tables)
    P = len(images)
    if P == 0:
        return state, {k: np.zeros(0, dt)
                       for k, dt in REPLICATED_STAT_DTYPES.items()}
    window = min(max(window, 1), P)
    scan = functools.partial(
        scan_windows, n_frames=P, window=window,
        step=_brick_step(state, images, T, tables, cfg, dtype),
        stat_dtypes=REPLICATED_STAT_DTYPES)
    return run_grow_replay(state=state, n_frames=P, scan=scan,
                           rehash=rehash_sharded_bricks,
                           label="sharded brick")
