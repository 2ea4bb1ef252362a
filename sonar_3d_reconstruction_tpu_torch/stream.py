"""Streaming runtime: bag replay -> time sync -> chunked mapping (PyTorch
port of ``sonar_3d_reconstruction_tpu.stream``, brick, sharded brick and
hash backends).

The ROS-free equivalent of the reference node's ingest loop
(scripts/3d_mapper_node.py:191-357): pair the sonar-image and odometry
streams with the ±slop approximate time synchronizer, decode images, and
map the paired pings in chunks, each chunk one call of
``pipeline.map_ping_sequence`` into the stream's map (window by window;
the brick backend through the binning kernel K1; the sharded brick
backend through ``parallel.map_ping_sequence_sharded_frames``, K1 on every
shard).  A chunk is mapped as it is: eager PyTorch needs no padding to a
static chunk, and growth with replay happens inside the call.

A ``publish`` callback fires at the configured rate in STREAM TIME (the
reference publishes on a 10 Hz wall timer decoupled from ingest,
node:227-231); offline replay maps that to bag timestamps.  Each tick
extracts the occupied voxels of the whole map (``extract_occupied_brick``,
``extract_occupied_sharded`` or ``extract_occupied_hash``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig, StreamConfig
from sonar_3d_reconstruction_tpu_torch.device import require_cuda
from sonar_3d_reconstruction_tpu_torch.grid.brick import (
    extract_occupied_brick,
    init_brick_grid,
    is_raw_mode,
)
from sonar_3d_reconstruction_tpu_torch.grid.hash import (
    extract_occupied_hash,
    init_hash_grid,
)
from sonar_3d_reconstruction_tpu_torch.io.bag import ImageMsg, OdometryMsg
from sonar_3d_reconstruction_tpu_torch.io.image import decode_image
from sonar_3d_reconstruction_tpu_torch.io.pointcloud import serialize_pointcloud2
from sonar_3d_reconstruction_tpu_torch.io.timesync import ApproximateTimeSync
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
    FanTables,
    build_fan_tables,
    required_fan_cap,
    required_free_cap,
    required_window_cap,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard import mesh_for
from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (
    default_local_capacity,
    extract_occupied_sharded,
    init_sharded_brick_grid,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard_frames import (
    map_ping_sequence_sharded_frames,
)
from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

BACKENDS = ("brick", "brick-sharded", "hash")
_EXTRACT = {"brick": extract_occupied_brick,
            "brick-sharded": extract_occupied_sharded,
            "hash": extract_occupied_hash}

# the candidate-lattice caps the stream grows, and what each pings need
_CAP_NEEDS = {"fan": required_fan_cap, "window": required_window_cap,
              "free": required_free_cap}
# each backend's window-width budget besides the unique budget
_SIZE_KEY = {"brick": "brick_budget", "hash": "batch_budget"}


@dataclass
class StreamStats:
    """Counters mirroring the reference's periodic frame logs (node:345-357)
    plus the dropped/unsynced counter the reference lacks and real
    arrival->state-committed latencies.  The fields and ``summary()`` keys
    are the JAX stream's, so a reader of ``map-bag``'s JSON line works with
    either package.  Here ``grows`` counts table doublings (the sharded
    backend: chunks that grew its budgets or tables, as the JAX stream
    counts them); the ``*_cap_recompiles`` count fan-table rebuilds after
    a cap grew; the port keeps no sticky box-key bits, so
    ``box_bits_recompiles`` stays 0."""

    pings_in: int = 0
    poses_in: int = 0
    pairs: int = 0
    frames_mapped: int = 0
    decode_errors: int = 0
    dropped_unsynced: int = 0
    chunks: int = 0
    grows: int = 0
    fan_cap_recompiles: int = 0
    window_cap_recompiles: int = 0
    free_cap_recompiles: int = 0
    box_bits_recompiles: int = 0
    device_time: float = 0.0
    stamp_skew_sum: float = 0.0  # measured sonar<->odom stamp delta (node:352-357)
    # wall seconds from a ping's (decoded, paired) arrival to its frame being
    # COMMITTED in the device map; the chunk's last window copies its stats
    # to the host, which waits for the device, so the commit time is real
    latencies: List[float] = field(default_factory=list)

    def latency_percentiles(self) -> Dict[str, float]:
        if not self.latencies:
            return {"p50": 0.0, "p95": 0.0, "max": 0.0}
        arr = np.asarray(self.latencies)
        return {
            "p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)),
            "max": float(arr.max()),
        }

    def summary(self) -> Dict[str, Any]:
        d = {k: v for k, v in self.__dict__.items() if k != "latencies"}
        d["avg_stamp_skew"] = (
            self.stamp_skew_sum / self.pairs if self.pairs else 0.0
        )
        lat = self.latency_percentiles()
        d["latency_p50_s"] = lat["p50"]
        d["latency_p95_s"] = lat["p95"]
        d["latency_max_s"] = lat["max"]
        return d


class StreamingMapper:
    """Chunked streaming front end over a brick or hash map on ``device``:
    the first CUDA device when None (RuntimeError where there is none; pass
    "cpu" to map on the CPU), or a brick map sharded over ``mesh``
    (``backend="brick-sharded"``; a device list, None: ``[device]`` when a
    device is given, else every visible card).

    Feed pings/poses in any interleaving (``on_ping`` / ``on_pose``), or a
    whole bag (``run_bag``); ``finish()`` flushes the tail.  A ping waits
    until its chunk fills, so the worst-case ping->map latency is
    ``chunk_size / ping_rate`` plus the chunk's mapping time; the
    low-latency configuration is ``chunk_size == window == 1``.

    ``budgets`` (brick and hash; a plan from ``utils.autotune``, or the
    JAX package's) seeds the sizes the stream would otherwise find as it
    goes, as the JAX stream does: the table capacity, the unique budget,
    the brick (hash: batch) budget and the grow-only caps.  Its backend
    and window must match (ValueError otherwise).  Chunks then map at
    those fixed widths and grow them by cause; the plan's lane, insert
    and vox budgets stay offline-only.  The sharded backend takes no
    plan; it carries the frame-parallel engine's budgets from chunk to
    chunk as the JAX stream does (``_sharded_budgets``, empty:
    count-sized), and counts a chunk that changed them or grew the tables
    as one ``grows``.

    The fan, window and free caps that size the candidate lattice grow to
    the largest the pings seen so far need, never shrinking, so the
    memoised fan tables are rebuilt only when a cap grows.  ``backend`` is
    ``"brick"`` (the default; the JAX stream's is ``"hash"``),
    ``"brick-sharded"`` or ``"hash"``, and ``dense_mode`` (both brick
    backends) is ``"pallas"`` or ``"pallas-raw"``, as in
    ``map_ping_sequence``.  A chunk takes compact box keys when all of its
    windows fit them and two-word keys otherwise.  A chunk that fails (keys
    outside the packable range) raises; its frames are dropped and the map
    stays as it was before it.
    """

    def __init__(
        self,
        cfg: Optional[MapperConfig] = None,
        stream_cfg: Optional[StreamConfig] = None,
        *,
        chunk_size: int = 32,
        window: int = 8,
        initial_capacity: int = 1 << 20,
        dtype: torch.dtype = torch.float32,
        publish: Optional[Callable[[Dict], None]] = None,
        backend: str = "brick",
        dense_mode: str = "pallas",
        device=None,
        mesh=None,
        budgets: Optional[Dict[str, Any]] = None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        is_raw_mode(dense_mode)
        self.cfg = cfg or MapperConfig()
        self.stream_cfg = stream_cfg or StreamConfig()
        self.chunk_size = chunk_size
        self.window = max(1, min(window, chunk_size))
        # the fixed-width sizes the chunks map at (None: count-sized)
        self._budgets: Optional[Dict[str, Any]] = None
        # the sharded engine's budgets, carried from chunk to chunk (the
        # JAX stream's sticky budgets; empty: count-sized)
        self._sharded_budgets: Dict[str, Any] = {}
        self._caps = dict.fromkeys(_CAP_NEEDS, 0)
        if budgets is not None:
            if backend not in _SIZE_KEY:
                raise ValueError(f"budgets size the brick and hash windows, "
                                 f"not {backend!r}")
            for key, want in (("backend", backend), ("window", self.window)):
                if budgets.get(key, want) != want:
                    raise ValueError(f"budget plan was tuned for {key}="
                                     f"{budgets.get(key)!r}, not {want!r}")
            if budgets.get("capacity"):
                # plan capacity counts bricks for brick: undo the >> 4 below
                initial_capacity = int(budgets["capacity"])
                if backend == "brick":
                    initial_capacity <<= 4
            size_key = _SIZE_KEY[backend]
            self._budgets = {"unique_budget": budgets.get("unique_budget"),
                             size_key: budgets.get(size_key)}
            for name in _CAP_NEEDS:
                self._caps[name] = int(budgets.get(f"{name}_cap") or 0)
        self.dtype = dtype
        self.publish = publish
        self.backend = backend
        self.dense_mode = dense_mode
        self.mesh = None
        if backend == "brick-sharded":
            self.mesh = mesh_for(mesh, device)
            self.device = self.mesh[0]
            self.state = init_sharded_brick_grid(
                self.mesh,
                default_local_capacity(initial_capacity, len(self.mesh)),
                dtype,
            )
        else:
            self.device = (require_cuda() if device is None
                           else torch.empty(0, device=device).device)
        if backend == "hash":
            self.state = init_hash_grid(initial_capacity, dtype, self.device)
        elif backend == "brick":
            # capacity counts BRICKS (~1/30 of voxels on realistic surveys)
            self.state = init_brick_grid(
                max(128, initial_capacity >> 4), dtype, self.device
            )
        self.stats = StreamStats()
        self._tables: Optional[FanTables] = None
        self._chunk_images: List[np.ndarray] = []
        self._chunk_positions: List[np.ndarray] = []
        self._chunk_quats: List[np.ndarray] = []
        self._chunk_stamps: List[float] = []
        self._chunk_arrivals: List[float] = []
        self._next_publish_t: Optional[float] = None
        self._sync = ApproximateTimeSync(
            self._on_pair,
            queue_size=self.stream_cfg.sync_queue_size,
            slop=self.stream_cfg.sync_slop,
        )

    # -- ingestion ------------------------------------------------------
    def on_ping(self, image_msg: ImageMsg) -> None:
        self.stats.pings_in += 1
        self._sync.add_ping(image_msg, image_msg.stamp)
        self.stats.dropped_unsynced = self._sync.dropped

    def on_pose(self, odom_msg: OdometryMsg) -> None:
        self.stats.poses_in += 1
        self._sync.add_pose(odom_msg, odom_msg.stamp)
        self.stats.dropped_unsynced = self._sync.dropped

    def _on_pair(self, image_msg: ImageMsg, odom_msg: OdometryMsg) -> None:
        self.stats.pairs += 1
        self.stats.stamp_skew_sum += abs(image_msg.stamp - odom_msg.stamp)
        try:
            img = decode_image(
                image_msg.data,
                image_msg.height,
                image_msg.width,
                image_msg.encoding,
                image_msg.step,
                image_msg.is_bigendian,
            )
        except ValueError:
            # an unsupported encoding or a truncated payload drops the frame
            # and is counted (the reference drops and logs, node:313-316)
            self.stats.decode_errors += 1
            return
        if self._chunk_images and self._chunk_images[0].shape != img.shape:
            self._flush_chunk()  # geometry change: other fan tables
        self._chunk_images.append(img)
        self._chunk_positions.append(np.asarray(odom_msg.position))
        self._chunk_quats.append(np.asarray(odom_msg.orientation))
        self._chunk_stamps.append(image_msg.stamp)
        self._chunk_arrivals.append(time.perf_counter())
        if len(self._chunk_images) >= self.chunk_size:
            self._flush_chunk()

    # -- mapping --------------------------------------------------------
    def _resolve_tables(self, stacked: np.ndarray) -> FanTables:
        """Fan tables for this chunk's geometry and the grown caps."""
        R, B = stacked.shape[1:]
        for name, need in _CAP_NEEDS.items():
            want = need(stacked, self.cfg, R)
            if want > self._caps[name]:
                if self._caps[name]:  # a wider return arrived: other tables
                    counter = f"{name}_cap_recompiles"
                    setattr(self.stats, counter,
                            getattr(self.stats, counter) + 1)
                self._caps[name] = want
        # memoised: unchanged caps give back the same tables, whose device
        # copy is cached
        self._tables = build_fan_tables(
            self.cfg, R, B, fan_cap=self._caps["fan"],
            window_cap=self._caps["window"], free_cap=self._caps["free"],
        )
        return self._tables

    def _flush_chunk(self) -> None:
        n = len(self._chunk_images)
        if n == 0:
            return
        try:
            self._map_chunk(n)
        finally:
            # a failed chunk's frames are dropped with it; the map is the
            # one before it (every table update is out of place)
            for buf in (self._chunk_images, self._chunk_positions,
                        self._chunk_quats, self._chunk_stamps,
                        self._chunk_arrivals):
                buf.clear()

    def _map_chunk(self, n: int) -> None:
        images = np.stack(self._chunk_images)
        positions = np.stack(self._chunk_positions)
        quats = np.stack(self._chunk_quats)
        tables = self._resolve_tables(images)
        capacity = self.state.capacity
        t0 = time.perf_counter()
        kw = dict(state=self.state, dtype=self.dtype, window=self.window,
                  dense_mode=self.dense_mode, tables=tables)
        if self.backend == "brick-sharded":
            effective: Dict[str, Any] = {}
            self.state, _ = map_ping_sequence_sharded_frames(
                images, positions, quats, self.cfg, effective=effective,
                **self._sharded_budgets, **kw)
            # the budgets a chunk grew hold for the chunks after it; a
            # chunk that changed them or the tables counts one grow, as
            # in the JAX stream
            effective = {k: v for k, v in effective.items() if v is not None}
            if (effective != self._sharded_budgets
                    or self.state.capacity != capacity):
                self.stats.grows += 1
                self._sharded_budgets = effective
        else:
            effective: Dict[str, Any] = {}
            self.state, _ = map_ping_sequence(
                images, positions, quats, self.cfg, device=self.device,
                backend=self.backend, budgets=self._budgets,
                effective=effective, **kw)
            if self._budgets is not None:
                # sizes a chunk grew to hold for the chunks after it
                size_key = _SIZE_KEY[self.backend]
                self._budgets = {k: effective[k]
                                 for k in ("unique_budget", size_key)}
        # the call copied the last window's stats to the host, which
        # waited for the device: `done` is a commit time
        done = time.perf_counter()
        if self.backend != "brick-sharded":
            self.stats.grows += (
                (self.state.capacity // capacity).bit_length() - 1)
        self.stats.device_time += done - t0
        self.stats.frames_mapped += n
        self.stats.chunks += 1
        self.stats.latencies.extend(done - a for a in self._chunk_arrivals)
        if self.publish is not None:
            self._maybe_publish(self._chunk_stamps[-1])

    def _maybe_publish(self, now: float) -> None:
        if self.stream_cfg.publish_rate_hz <= 0:
            return  # rate 0 disables the publish timer (never divide by it)
        period = 1.0 / self.stream_cfg.publish_rate_hz
        if self._next_publish_t is None:
            self._next_publish_t = now
        if now >= self._next_publish_t:
            self.publish(self.pointcloud_msg(stamp=now))
            # skip ahead (offline chunks can cover many publish periods)
            self._next_publish_t = now + period

    # -- extraction -----------------------------------------------------
    def pointcloud_msg(self, stamp: float = 0.0) -> Dict:
        points, probs = _EXTRACT[self.backend](self.state, self.cfg)
        sec = int(stamp)
        nanosec = int(round((stamp - sec) * 1e9))
        if nanosec >= 1_000_000_000:  # rounding carry: nanosec must be < 1e9
            sec += 1
            nanosec -= 1_000_000_000
        return serialize_pointcloud2(
            points,
            probs,
            frame_id=self.stream_cfg.map_frame_id,
            stamp=(sec, nanosec),
        )

    # -- replay ---------------------------------------------------------
    def finish(self) -> StreamStats:
        self._sync.flush()
        self._flush_chunk()
        self.stats.dropped_unsynced = self._sync.dropped
        return self.stats

    def run_bag(self, bag_path: str) -> StreamStats:
        """Replay a rosbag2 recording (.db3 sqlite or .mcap, sniffed by
        magic) through the full streaming stack."""
        from sonar_3d_reconstruction_tpu_torch.io.mcap import open_bag

        sc = self.stream_cfg
        with open_bag(bag_path) as bag:
            for _topic, _bag_ts, msg in bag.messages(
                [sc.sonar_topic, sc.odometry_topic]
            ):
                if isinstance(msg, ImageMsg):
                    self.on_ping(msg)
                else:
                    self.on_pose(msg)
        return self.finish()
