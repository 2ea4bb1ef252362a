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
apply half scales with the shards.  With the JAX engine's budgets
(``unique_budget``, the per-shard ``brick_budget`` / ``lane_budget`` /
``insert_budget``) every window runs at those widths on every shard with
no host read, commits on every shard or on none by the device-side OR of
their flags, and reports the JAX engine's stats, read once a scan
(parallel/shard.py).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.grid.brick import (
    DEFAULT_BRICK_BITS,
    BrickGridState,
    apply_brick_records_wide,
    brick_state_to_numpy,
    default_brick_budget,
    extract_classified_brick,
    extract_occupied_brick,
    init_brick_grid,
    query_log_odds_brick,
    rehash_bricks_once,
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import FanTables
from sonar_3d_reconstruction_tpu_torch.parallel.shard import (
    MAX_GROW_RETRIES,
    Budgets,
    Mesh,
    StatReduce,
    check_sharded_state,
    grow_shards,
    make_mesh,
    on_mesh,
    replicated_step,
    replicated_step_budgeted,
    run_grow_replay,
    scan_windows,
    sequence_inputs,
)
# where the JAX package defines it (parallel/shard.py holds both owners)
from sonar_3d_reconstruction_tpu_torch.parallel.shard import (  # noqa: F401
    owner_shard_brick,
)
from sonar_3d_reconstruction_tpu_torch.pipeline import (
    BUDGET_STAT_DTYPES,
    STAT_DTYPES,
)

# per-ping stats of the replicated-records engine: the brick backend's
# (``num_occupied`` / ``num_free`` / ``num_candidates`` and the window
# sizes summed over the shards) and the window sizes' largest shard
REPLICATED_STAT_DTYPES = dict(
    STAT_DTYPES, batch_n_bricks_max=np.int64, batch_n_lanes_max=np.int64)
# the window sizes a budgeted window reports, summed over the shards and
# as their largest shard (JAX's psum / pmax)
WINDOW_SIZES = ("batch_n_unique", "batch_n_bricks", "batch_n_lanes",
                "batch_n_need")
# the budgeted windows' stats: the JAX engine's keys
REPLICATED_BUDGET_STAT_DTYPES = dict(
    BUDGET_STAT_DTYPES, **{k + "_max": np.int64 for k in WINDOW_SIZES})
# and their reduce over the shards (JAX's make_window_scan_sharded_brick)
REPLICATED_REDUCE = StatReduce(
    sums=("num_occupied", "num_free", "num_candidates") + WINDOW_SIZES,
    maxima=WINDOW_SIZES,
    ors=("unique_overflow", "batch_overflow", "insert_overflow",
         "pack_overflow"),
    first=("overflowed", "range_fail"),
)


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

    # the stream sees table growth through ``capacity`` on every map
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
    ``poisoned`` for replay) through ``grid.brick.rehash_bricks_once``;
    while a shard's buckets do not fit, every shard doubles further.
    Ownership depends only on the brick code, so no entry changes
    shard."""
    return grow_shards(state, new_local_capacity, rehash_bricks_once)


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


class _BrickBudgets(Budgets):
    """The replicated-records brick engine's budgets (JAX's
    ``map_ping_sequence_sharded_brick``)."""

    KEYS = ("unique_budget", "brick_budget", "lane_budget", "insert_budget")

    def apply_kw(self, w0: int) -> Dict[str, Any]:
        """The window at frame ``w0``'s per-shard apply budgets: NB (default
        ``default_brick_budget(window, U)``), L and the insert budget."""
        return dict(
            brick_budget=(self.b["brick_budget"]
                          or default_brick_budget(self.window, self.unique())),
            lane_budget=self.b["lane_budget"], insert_budget=self.insert(w0))

    def causes(self):
        """JAX's growth order after the fatal causes: unique (the brick
        budget re-derives from it), insert, batch (bricks doubled; a lane
        budget drops to the full width, which always fits)."""
        def batch():
            self.b["brick_budget"] = 2 * self.apply_kw(0)["brick_budget"]
            self.b["lane_budget"] = None

        return (("unique_overflow", lambda: self.grow_unique("brick_budget")),
                ("insert_overflow", self.grow_insert),
                ("batch_overflow", batch))


def _brick_step(state, images, transforms, tables, cfg, dtype,
                budgets: Optional[_BrickBudgets] = None):
    """The replicated-records engine's ``step(state, frames)`` (the JAX
    package's ``make_window_scan_sharded_brick``): each shard applies its
    records of a window's frames (two-word brick codes) with one
    ``apply_brick_records_wide`` (K1), and the window commits on every
    shard or on none; budgeted when ``budgets`` holds any (read at each
    step)."""
    kw = dict(brick_bits=state.brick_bits,
              images_dev=on_mesh(images, state.mesh),
              T_dev=on_mesh(transforms, state.mesh, dtype),
              tables=tables, cfg=cfg, dtype=dtype)
    if budgets is None or not budgets.budgeted:
        return functools.partial(
            replicated_step, apply=apply_brick_records_wide,
            stat_dtypes=REPLICATED_STAT_DTYPES,
            sizes=("batch_n_bricks", "batch_n_lanes"), **kw)
    return lambda st, frames: replicated_step_budgeted(
        st, frames, apply=apply_brick_records_wide, apply_kw=budgets.apply_kw,
        unique_budget=budgets.unique(), reduce=REPLICATED_REDUCE, **kw)


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
    unique_budget: Optional[int] = None,
    brick_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget=None,
    max_grow_retries: int = MAX_GROW_RETRIES,
    effective: Optional[Dict[str, Any]] = None,
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
    frame are fatal (ValueError).

    Budgets (JAX's arguments: ``unique_budget`` record lanes a frame, and
    the PER-SHARD ``brick_budget`` (default ``default_brick_budget(window,
    U)``), ``lane_budget`` and ``insert_budget``, an int or a [cold,
    warm] list indexed by window) run every window at fixed widths through
    K1 with no host read and one stats read a scan
    (``REPLICATED_BUDGET_STAT_DTYPES``: global sums and per-shard maxima);
    an overflow grows by JAX's cause order: unique (doubled; the brick
    budget re-derives), insert (doubled), batch (bricks doubled, the lane
    budget dropped), then the tables.  The map and every shared stat
    equal the count-sized run's.  ``effective`` (a dict) receives the
    budgets the run settled on (None where none was given or grown), as
    JAX's does; ``max_grow_retries`` bounds the scans."""
    cfg = cfg or MapperConfig()
    state = (init_sharded_brick_grid(mesh, local_capacity, dtype)
             if state is None else check_sharded_state(state, mesh, dtype))
    images, tables, T = sequence_inputs(images, positions, quaternions, cfg,
                                        tables)
    P = len(images)
    window = min(max(window, 1), P)
    budgets = _BrickBudgets(tables, cfg, window, unique_budget=unique_budget,
                            brick_budget=brick_budget, lane_budget=lane_budget,
                            insert_budget=insert_budget)
    dtypes = (REPLICATED_BUDGET_STAT_DTYPES if budgets.budgeted
              else REPLICATED_STAT_DTYPES)
    if P == 0:
        return state, {k: np.zeros(0, dt) for k, dt in dtypes.items()}
    scan = functools.partial(
        scan_windows, n_frames=P, window=window,
        step=_brick_step(state, images, T, tables, cfg, dtype, budgets),
        stat_dtypes=dtypes, budgeted=budgets.budgeted)
    out = run_grow_replay(
        state=state, n_frames=P, scan=scan, rehash=rehash_sharded_bricks,
        label="sharded brick",
        growable_causes=budgets.causes() if budgets.budgeted else (),
        max_grow_retries=max_grow_retries)
    if effective is not None:
        effective.update(budgets.effective())
    return out
