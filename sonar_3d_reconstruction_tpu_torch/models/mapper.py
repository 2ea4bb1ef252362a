"""SonarMapper — the stateful reference-parity API (PyTorch port of
``sonar_3d_reconstruction_tpu.models.mapper``: brick, sharded brick, hash
and dense backends).

Same surface as the reference ``SonarTo3DMapper`` (scripts/3d_mapper.py:
197-650): ``process_sonar_image(polar_image, position, quaternion) ->
stats`` and ``get_point_cloud(include_free) -> dict``, with the same result
fields, over a brick, hash or dense map on one device (the first CUDA
device unless the caller names another) or a brick map sharded over a
mesh of devices.  The port's default backend is
``"brick"``; the JAX mapper's is ``"hash"``.

Brick: ``process_sonar_image`` and ``map_sequence`` go through
``pipeline.map_ping_sequence`` with the binning kernel K1: a ping is a
sequence of one, mapped with window 1 into this mapper's state, with
compact box keys or, past their reach, two-word brick codes.  (The JAX
mapper's per-ping step always takes two-word codes; the maps agree voxel
for voxel, their table slots may not.)  Capacity growth and replay happen
inside ``map_ping_sequence``, whose grown state this mapper keeps.

Hash: a ping likewise goes through ``map_ping_sequence(backend="hash",
window=1)``, one ``update_hash_grid`` as in the JAX mapper.  Before it the
table doubles once more than a quarter of its slots are used (the JAX
mapper's proactive growth); a bucket overflow doubles it again and replays
the ping.  ``map_sequence`` goes through the same call.

Sharded brick (``backend="brick-sharded"``, ``mesh=``): a ping and
``map_sequence`` go through the frame-parallel engine
(``parallel.map_ping_sequence_sharded_frames``), each shard's window
apply through K1; its grown state is kept.  The mesh is a device list
(repeats allowed): by default every visible card, or the one ``device``
given.  Reads run per shard and concatenate (point log-odds: summed), as
in the JAX mapper.

Dense: a ping goes through ``map_ping_sequence(backend="dense")`` into a
bounded grid (``dense_spec``, default +-(max_range + 2 m)), as the JAX
mapper's ``update_dense_grid`` step; no kernel runs on it, as in the JAX
package.  ``map_sequence`` refuses it, as the JAX mapper does.

Fan tables are built once per image geometry for the per-ping path
(exact, uncapped, as the JAX mapper builds them); ``map_sequence`` lets
``map_ping_sequence`` size its lattice caps for the batch.  The sharded
backend keeps the JAX mapper's sticky budgets: each call hands the
frame-parallel engine the budgets the last one settled on (its
``effective``), so a budget that grew once is not grown again; with
none the engine is count-sized.  The JAX mapper's sticky box-key bits
and its single-map unique / brick budgets exist to avoid XLA
recompiles; the port's single-map windows are sized from their counts,
so it keeps neither, and needs no ``compute_window_boxes(min_bits=)``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig, config_from_dict
from sonar_3d_reconstruction_tpu_torch.device import require_cuda, to_device
from sonar_3d_reconstruction_tpu_torch.geometry import batched_sonar_to_world
from sonar_3d_reconstruction_tpu_torch.grid import brick, dense
from sonar_3d_reconstruction_tpu_torch.grid import hash as hash_grid
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
    FanTables,
    build_fan_tables,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import unpack_keys
from sonar_3d_reconstruction_tpu_torch.ops.records import frame_records
from sonar_3d_reconstruction_tpu_torch.parallel import shard_brick
from sonar_3d_reconstruction_tpu_torch.parallel.shard import mesh_for
from sonar_3d_reconstruction_tpu_torch.parallel.shard_frames import (
    map_ping_sequence_sharded_frames,
)
from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

BACKENDS = ("brick", "brick-sharded", "hash", "dense")

# the hash table doubles before a ping once more than this share of its
# slots is used (the JAX mapper's bound: buckets of 128 at a mean fill of
# 32 practically never overflow)
_MAX_LOAD = 0.25

# each sparse backend's reads: (extract occupied, extract classified,
# log-odds query, probability query); the dense reads also take the spec
_READS = {
    "brick": (brick.extract_occupied_brick, brick.extract_classified_brick,
              brick.query_log_odds_brick, brick.query_probability_brick),
    "hash": (hash_grid.extract_occupied_hash, hash_grid.extract_classified_hash,
             hash_grid.query_log_odds, hash_grid.query_probability),
    "brick-sharded": (shard_brick.extract_occupied_sharded,
                      shard_brick.extract_classified_sharded,
                      shard_brick.query_log_odds_sharded,
                      shard_brick.query_probability_sharded),
}


def _dense_reads(spec: dense.DenseGridSpec):
    """The dense map's reads, called as ``_READS``'s are."""
    def log_odds(state, points, cfg):
        # the JAX mapper's dense form: through the float64 probability
        p = dense.query_probability_dense(state, points, spec, cfg)
        return np.log(p / (1.0 - p))

    return (
        lambda state, cfg: dense.extract_occupied(state, spec, cfg),
        lambda state, cfg: dense.extract_classified(state, spec, cfg),
        log_odds,
        lambda state, points, cfg: dense.query_probability_dense(
            state, points, spec, cfg),
    )


class SonarMapper:
    """Stateful sonar-to-3D mapper (reference SonarTo3DMapper parity,
    3d_mapper.py:197-650) over a brick, hash or dense map on ``device``:
    the first CUDA device when None (RuntimeError where there is none).
    ``backend="brick-sharded"`` shards the brick map over ``mesh`` (a
    device list; None: ``[device]`` when a device is given, else every
    visible card)."""

    def __init__(
        self,
        config: Optional[Any] = None,
        *,
        backend: str = "brick",
        dense_spec: Optional[dense.DenseGridSpec] = None,
        initial_capacity: int = 1 << 20,
        dtype: torch.dtype = torch.float32,
        track_update_counts: bool = False,
        device=None,
        mesh=None,
    ):
        if config is None:
            self.cfg = MapperConfig()
        elif isinstance(config, MapperConfig):
            self.cfg = config
        else:  # dict in library-level units (reference 3d_mapper.py:252-254)
            self.cfg = config_from_dict(config)
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.dtype = dtype
        self.mesh = None
        if backend == "brick-sharded":
            self.mesh = mesh_for(mesh, device)
            self.device = self.mesh[0]
        else:
            self.device = (require_cuda() if device is None
                           else torch.empty(0, device=device).device)
        self._read = _READS.get(backend)
        self.dense_spec = None
        # the sharded engine's budgets, carried from call to call (the JAX
        # mapper's sticky budgets; empty: count-sized)
        self._sharded_budgets: Dict[str, Any] = {}
        if backend == "brick-sharded":
            self.state = shard_brick.init_sharded_brick_grid(
                self.mesh,
                shard_brick.default_local_capacity(initial_capacity,
                                                   len(self.mesh)),
                dtype,
            )
        elif backend == "dense":
            self.dense_spec = dense_spec or dense.default_dense_spec(self.cfg)
            self.state = dense.init_dense_grid(self.dense_spec, dtype,
                                               self.device)
            self._read = _dense_reads(self.dense_spec)
        elif backend == "hash":
            self.state = hash_grid.init_hash_grid(
                initial_capacity, dtype, self.device
            )
        else:
            # brick capacity counts BRICKS (~1/30 of voxels on real
            # surveys); growth with replay is the safety net either way
            self.state = brick.init_brick_grid(
                max(128, initial_capacity >> 4), dtype, self.device
            )
        self._tables: Optional[FanTables] = None
        # optional per-voxel update-count histograms (reference debug stats,
        # 3d_mapper.py:306-308, 549-551): candidate EMISSIONS per voxel, the
        # count field of each frame's unique records.  frame_update_counts
        # covers the most recent frame only (cleared per frame, :525).
        self.track_update_counts = track_update_counts
        self.voxel_update_counts: Dict[Tuple[int, int, int], int] = {}
        self.frame_update_counts: Dict[Tuple[int, int, int], int] = {}
        self.frame_count = 0
        self.processed_frame_count = 0
        self.last_processing_time = 0.0
        self.total_processing_time = 0.0
        self._last_stats: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def _tables_for(self, shape: Tuple[int, int]) -> FanTables:
        if self._tables is None or (
            self._tables.range_bins, self._tables.bearing_bins
        ) != tuple(shape):
            self._tables = build_fan_tables(self.cfg, shape[0], shape[1])
        return self._tables

    def process_sonar_image(
        self, polar_image: np.ndarray, robot_position, robot_orientation
    ) -> Dict[str, Any]:
        """One ping -> map update.  Mirrors reference process_sonar_image
        (3d_mapper.py:485-595), stats dict fields included."""
        t0 = time.time()
        self.frame_count += 1
        self.processed_frame_count += 1
        images = np.asarray(polar_image)[None]
        positions = np.asarray(robot_position, np.float64)[None]
        quats = np.asarray(robot_orientation, np.float64)[None]
        tables = self._tables_for(images.shape[1:])
        if self.backend == "hash":
            # the JAX mapper's proactive growth; a bucket overflow still
            # doubles the table and replays the ping in map_ping_sequence
            while int(self.state.used) > _MAX_LOAD * self.state.capacity:
                self.state = hash_grid.rehash(self.state,
                                              2 * self.state.capacity)
        seq_stats = self._map(images, positions, quats, 1, tables)
        stats = {k: v[0] for k, v in seq_stats.items()}
        if self.track_update_counts:
            self._record_update_counts(images, positions, quats, tables)
        return self._finish_ping(stats, t0)

    def _map(self, images, positions, quaternions, window: int,
             tables: Optional[FanTables] = None) -> Dict[str, np.ndarray]:
        """Map pings into this mapper's state; per-ping stats."""
        if self.backend == "brick-sharded":
            effective: Dict[str, Any] = {}
            self.state, stats = map_ping_sequence_sharded_frames(
                images, positions, quaternions, self.cfg, state=self.state,
                dtype=self.dtype, window=window, tables=tables,
                effective=effective, **self._sharded_budgets,
            )
            # sticky: the next call starts at the budgets this one grew to
            self._sharded_budgets = {
                k: v for k, v in effective.items() if v is not None}
        else:
            self.state, stats = map_ping_sequence(
                images, positions, quaternions, self.cfg, device=self.device,
                backend=self.backend, state=self.state, dtype=self.dtype,
                window=window, tables=tables, dense_spec=self.dense_spec,
            )
        return stats

    def _finish_ping(self, stats, t0: float) -> Dict[str, Any]:
        """The reference-schema per-ping result (3d_mapper.py:587-595)."""
        out = {
            k: int(v)
            for k, v in stats.items()
            if not (k == "overflowed" or k.endswith(("_overflow", "_fail")))
        }
        self.last_processing_time = time.time() - t0
        self.total_processing_time += self.last_processing_time
        self._last_stats = out
        return {
            "frame_count": self.frame_count,
            "processed_count": self.processed_frame_count,
            "num_occupied": out["num_occupied"],
            "num_free": out["num_free"],
            "num_voxels": self.num_voxels,
            "processing_time": self.last_processing_time,
            "avg_processing_time": self.total_processing_time
            / max(1, self.processed_frame_count),
        }

    def map_sequence(
        self, images, positions, quaternions, window: int = 1
    ) -> Dict[str, np.ndarray]:
        """Batch API: map a recorded sequence into this mapper's state
        (``window`` pings per apply); returns per-ping stats arrays.  Brick,
        sharded brick and hash backends, as in the JAX mapper."""
        if self.backend == "dense":
            raise ValueError("map_sequence requires the hash or brick "
                             "backend (brick sharded or not)")
        t0 = time.time()
        images = np.asarray(images)
        n = images.shape[0]
        stats = self._map(images, positions, quaternions, max(1, window))
        if self.track_update_counts and n:
            self._record_update_counts(
                images, positions, quaternions, self._tables_for(images.shape[1:])
            )
        self.frame_count += n
        self.processed_frame_count += n
        dt = time.time() - t0
        self.last_processing_time = dt / max(1, n)
        self.total_processing_time += dt
        return stats

    # ------------------------------------------------------------------
    def _emission_counts(
        self, images, positions, quaternions, tables: FanTables
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Per ping: ((n, 3) voxel keys, (n,) candidate emissions) of its
        unique records, from the records recomputed alone (map-state
        independent) with two-word voxel codes, as the JAX mapper does."""
        T = batched_sonar_to_world(positions, quaternions, self.cfg)
        for image, T_i in zip(images, T):
            rec, _ = frame_records(
                to_device(image, self.device),
                torch.as_tensor(T_i, device=self.device).to(self.dtype),
                tables, self.cfg, None, None, 0, dtype=self.dtype,
            )
            n = int(rec.n_unique)
            voxel = unpack_keys(rec.hi[:n], rec.lo[:n])
            yield voxel.cpu().numpy(), rec.count[:n].cpu().numpy()

    def _record_update_counts(self, images, positions, quaternions, tables):
        """Debug path (reference voxel_update_counts / frame_update_counts,
        3d_mapper.py:306-308, 525, 549-551): count candidate EMISSIONS per
        voxel, per frame and over the run.  Recomputes each frame's unique
        records, so it roughly doubles the per-ping cost; opt-in like the
        reference's debug prints."""
        for keys, counts in self._emission_counts(
            images, positions, quaternions, tables
        ):
            self.frame_update_counts = {}  # reset per frame (reference :525)
            for k, c in zip(map(tuple, keys.tolist()), counts.tolist()):
                self.frame_update_counts[k] = c
                self.voxel_update_counts[k] = (
                    self.voxel_update_counts.get(k, 0) + c
                )

    def update_count_histogram(self) -> Dict[int, int]:
        """{emissions-per-voxel: number-of-voxels} (reference print :575-585)."""
        hist: Dict[int, int] = {}
        for c in self.voxel_update_counts.values():
            hist[c] = hist.get(c, 0) + 1
        return dict(sorted(hist.items()))

    def frame_update_stats(self) -> Dict[str, float]:
        """The reference's per-frame debug aggregates (3d_mapper.py:575-585):
        max/avg emissions per touched voxel in the LAST frame, the running
        max across all frames, and voxels with >10 emissions this frame.
        Empty when nothing was tracked (the reference's ``if`` guard, :575)."""
        if not self.frame_update_counts:
            return {}
        vals = self.frame_update_counts.values()
        return {
            "max_updates_frame": max(vals),
            "avg_updates_frame": sum(vals) / len(vals),
            "max_updates_total": max(self.voxel_update_counts.values()),
            "voxels_over_10_frame": sum(1 for v in vals if v > 10),
        }

    def format_frame_update_stats(self) -> str:
        """The reference's every-10-frames debug block (3d_mapper.py:579-585),
        one string instead of prints."""
        s = self.frame_update_stats()
        if not s:
            return ""
        return (
            f"[DEBUG] Frame {self.frame_count}:\n"
            f"  Max updates in frame: {s['max_updates_frame']}\n"
            f"  Avg updates in frame: {s['avg_updates_frame']:.1f}\n"
            f"  Max total updates: {s['max_updates_total']}\n"
            f"  Voxels with >10 updates in frame: {s['voxels_over_10_frame']}"
        )

    def format_update_histogram(self) -> str:
        hist = self.update_count_histogram()
        total = sum(hist.values())
        lines = [f"voxel update counts over {self.frame_count} frames "
                 f"({total} voxels):"]
        for c, n in hist.items():
            lines.append(f"  {c:4d} updates: {n} voxels")
        return "\n".join(lines)

    # ------------------------------------------------------------------
    @property
    def num_voxels(self) -> int:
        """Touched voxels in the map."""
        if self.backend == "dense":
            return int(self.state.touched.sum())
        return int(self.state.used.sum())  # per shard when sharded

    def get_point_cloud(self, include_free: bool = False) -> Dict[str, Any]:
        """Map extraction with the reference result schema
        (3d_mapper.py:597-642)."""
        cfg = self.cfg
        extract_occupied, extract_classified = self._read[:2]
        if include_free:
            cls = extract_classified(self.state, cfg)
            occupied, free, unknown = cls["occupied"], cls["free"], cls["unknown"]
            bounds = (self.state.min_bounds.cpu().numpy(),
                      self.state.max_bounds.cpu().numpy())
            return {
                "occupied": occupied,
                "free": free,
                "unknown": unknown,
                "num_voxels": self.num_voxels,
                "num_occupied": len(occupied[0]),
                "num_free": len(free[0]),
                "num_unknown": len(unknown[0]),
                "frame_count": self.frame_count,
                "processed_count": self.processed_frame_count,
                "bounds": {
                    "min": bounds[0] if cfg.dynamic_expansion else None,
                    "max": bounds[1] if cfg.dynamic_expansion else None,
                },
            }
        points, probs = extract_occupied(self.state, cfg)
        return {
            "points": points,
            "probabilities": probs,
            "num_voxels": self.num_voxels,
            "num_occupied": len(points),
            "frame_count": self.frame_count,
            "processed_count": self.processed_frame_count,
        }

    def query_probabilities(self, points) -> np.ndarray:
        """Batched point query: (N, 3) world coords -> (N,) occupancy
        probabilities; never-updated voxels answer 0.5 (the reference's
        per-point SimpleOctree.get_probability, 3d_mapper.py:122-126)."""
        return self._read[3](self.state, points, self.cfg)

    def get_probability(self, x: float, y: float, z: float) -> float:
        """Occupancy probability of the voxel containing (x, y, z)
        (reference SimpleOctree.get_probability, 3d_mapper.py:122-126)."""
        return float(self.query_probabilities([[x, y, z]])[0])

    def get_log_odds(self, x: float, y: float, z: float) -> float:
        """Log-odds of the voxel containing (x, y, z); 0.0 if never updated
        (reference SimpleOctree.get_log_odds, 3d_mapper.py:117-120)."""
        query_log_odds = self._read[2]
        return float(query_log_odds(self.state, [[x, y, z]], self.cfg)[0])

    def clear(self) -> None:
        """Alias of reset_map (reference SimpleOctree.clear,
        3d_mapper.py:190-194)."""
        self.reset_map()

    def reset_map(self) -> None:
        """Clear the map, keeping its grown capacity (reference reset_map,
        3d_mapper.py:644-650)."""
        if self.backend == "dense":
            self.state = dense.init_dense_grid(self.dense_spec, self.dtype,
                                               self.device)
        elif self.backend == "hash":
            self.state = hash_grid.init_hash_grid(
                self.state.capacity, self.dtype, self.device
            )
        elif self.backend == "brick-sharded":
            self.state = shard_brick.init_sharded_brick_grid(
                self.mesh, self.state.local_capacity, self.dtype,
                self.state.brick_bits,
            )
        else:
            self.state = brick.init_brick_grid(
                self.state.capacity, self.dtype, self.device,
                self.state.brick_bits,
            )
        self.frame_count = 0
        self.processed_frame_count = 0
        self.total_processing_time = 0.0
        self.voxel_update_counts.clear()
        self.frame_update_counts.clear()
