"""Headline benchmark of the port: voxel log-odds updates/s through the
whole mapping pipeline on one CUDA device (port of the root ``bench.py``'s
capture path, knob for knob).

The survey is ``make_inputs``: 256 full-size pings (500 range bins x 512
bearings, the reference Oculus M750D geometry) at the library-default 5 cm
voxels, in windows of 16 on the brick backend (the binning kernel K1 in
every window; K1-raw under a ``raw`` dense mode) or the hash backend.  The
fan tables are sized with the survey's exact caps (``required_fan_cap``,
``required_window_cap``, ``required_free_cap``).  The metric counts the
valid candidate emissions applied to the map (the per-ping
``num_candidates``), the work items the reference performs one by one;
``vs_baseline`` is against 1e9 updates/s.

What is timed (``Capture``): the images and the ``batched_sonar_to_world``
poses are uploaded once and the window boxes computed once, before any
timed run; each timed run changes one pixel, starts from a fresh map of
the capture's capacity and runs ``pipeline.scan_pings_brick`` (hash:
``scan_pings_hash``) at fixed budgets.  Such a scan reads the device once,
at its end (the overflow flags with the per-ping counts), and that read,
queued behind every kernel of the run, ends the timed region.  The budgets
come from the committed ``bench_plan.json`` when its entry for this
configuration (``_plan_key``) exists, else from a warm-up run at the JAX
package's default budgets and ``utils.autotune``'s snug formulas
(``budget_plan``: ``"hit"`` or ``"discovered"``).  A plan that overflows is
rediscovered; snug budgets that overflow fall back to the warm-up's safe
ones; an overflow after that is an error.  ``BENCH_COUNT_SIZED=1`` times
the same device-resident scan count-sized instead (every window sized
from its counts, ~14 reads a window, the library's default), from a map
that a count-sized warm-up sized.

Run as ``python -m sonar_3d_reconstruction_tpu_torch bench [--device D]``
(or ``python -m sonar_3d_reconstruction_tpu_torch.bench``).  It runs on
the first CUDA device unless ``--device`` names another (``cpu`` for a
CPU run); without CUDA and without ``--device`` it fails.  It prints
exactly one JSON line on standard output whatever happens: the result, or
``{"metric": ..., "value": 0.0, "error": ..., "stage": ...}`` with exit
code 1 on a failure (a failure after the timed runs reports the timed
result with an ``error_note``), or the last complete result (or the error
line) with exit code 3 when ``BENCH_DEADLINE`` seconds pass.  Imports
that can fail happen inside ``main``, under that guard.

Environment (the root bench's knobs, with its defaults):
``BENCH_PINGS`` (256), ``BENCH_REPS`` (3 timed runs, the best reported),
``BENCH_WINDOW`` (16), ``BENCH_BACKEND`` (``brick`` or ``hash``),
``BENCH_DENSE_MODE`` (``pallas-tb16``, the root bench's spelling; any JAX
spelling: the ``raw`` ones run K1-raw, the others K1), ``BENCH_RECORDS_BATCH``
(1) and ``BENCH_WINDOW_GROUP`` (1) (brick only), ``BENCH_BRICK_CAPACITY``
(65536 bricks: the brick warm-up's table, part of the plan key),
``BENCH_CAPACITY`` (4194304 hash slots), ``BENCH_USE_PLAN`` (1),
``BENCH_WRITE_PLAN`` (0; 1 writes a discovered brick plan into
``bench_plan.json``), ``BENCH_TUNE_BUDGETS`` (1; 0 keeps the warm-up's
budgets), ``BENCH_BRICK_BUDGET`` / ``BENCH_UNIQUE_BUDGET`` (unset: the
brick warm-up's budgets, unique default 131072), ``BENCH_LATENCY`` (1:
also measure the ping-to-map latency), ``BENCH_LATENCY_CHUNK`` (1: the
stream's chunk and window), ``BENCH_LATENCY_PINGS`` (96),
``BENCH_LATENCY_MIN_REMAINING`` (300 s: the latency stage is skipped when
less of the deadline is left), ``BENCH_DEADLINE`` (1200 s).
``BENCH_BRICK_BUDGET``, ``BENCH_UNIQUE_BUDGET``, ``BENCH_TUNE_BUDGETS=0``
and ``BENCH_USE_PLAN`` other than 1 bypass the plan.  The port's own
knob: ``BENCH_COUNT_SIZED`` (0; 1 as above).
The root bench's compile-cache, platform and TPU-acquisition knobs have
no counterpart: eager PyTorch compiles nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

METRIC = "voxel_log_odds_updates_per_sec"
BASELINE_UPDATES_PER_SEC = 1e9
DEFAULT_WINDOW = 16
DEFAULT_DENSE_MODE = "pallas-tb16"
DEFAULT_RECORDS_BATCH = 1
DEFAULT_WINDOW_GROUP = 1
DEFAULT_BRICK_CAPACITY = 1 << 16
DEFAULT_HASH_CAPACITY = 1 << 22
DEFAULT_UNIQUE_BUDGET = 131072  # the explicit brick warm-up's
PLAN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "bench_plan.json")
# the budgets a scan takes, by backend (the payload reports each)
BUDGET_KEYS = {
    "brick": ("unique_budget", "brick_budget", "lane_budget",
              "insert_budget", "vox_budget", "dedup_lane_budget"),
    "hash": ("unique_budget", "batch_budget", "lane_budget",
             "insert_budget", "dedup_lane_budget"),
}


def make_inputs(cfg, n_pings, seed=0):
    """Synthetic survey: bright seabed returns over low noise, forward
    motion with a slow yaw (the root bench's survey, value for value)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    R, B = cfg.image_height, cfg.image_width
    images = rng.integers(0, 25, size=(n_pings, R, B)).astype(np.uint8)
    # a continuous bottom return band sweeping with ping index + speckle
    for i in range(n_pings):
        r0 = 150 + int(40 * np.sin(i / 7.0))
        images[i, r0 : r0 + 40, :] = rng.integers(
            80, 220, size=(40, B)
        ).astype(np.uint8)
    positions = np.stack(
        [0.08 * np.arange(n_pings), np.zeros(n_pings), np.zeros(n_pings)],
        axis=-1,
    )
    yaw = 0.02 * np.arange(n_pings)
    quats = np.stack(
        [np.zeros(n_pings), np.zeros(n_pings), np.sin(yaw / 2), np.cos(yaw / 2)],
        axis=-1,
    )
    return images, positions, quats


def survey_caps(images, cfg):
    """The survey's exact (fan, window, free) lattice caps."""
    from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
        required_fan_cap,
        required_free_cap,
        required_window_cap,
    )

    return tuple(need(images, cfg, cfg.image_height) for need in (
        required_fan_cap, required_window_cap, required_free_cap))


# ---------------------------------------------------------------------------
# Budget plan: committed snug budgets for a capture configuration, keyed by
# everything that determines them (the root bench's ``bench_plan.json``,
# read as data).  A stale plan costs a rediscovery, never correctness.
# ---------------------------------------------------------------------------

def _plan_key(cfg, n_pings, window, backend, dense_mode, caps, capacity,
              seed):
    """The key of a ``bench_plan.json`` entry: a copy of the root bench's
    ``_plan_key``."""
    import hashlib

    raw = json.dumps(
        {
            "backend": backend,
            "n_pings": n_pings,
            "window": window,
            "dense_mode": dense_mode,
            "seed": seed,
            "caps": list(caps),
            "capacity": capacity,
            "image": [cfg.image_height, cfg.image_width],
            "res": cfg.voxel_resolution,
            "range": [cfg.min_range, cfg.max_range],
            "fov": cfg.horizontal_fov,
            "thr": cfg.intensity_threshold,
        },
        sort_keys=True,
    )
    return hashlib.md5(raw.encode()).hexdigest()[:16]


def _load_plan(key, env: Mapping[str, str]) -> Optional[Dict[str, Any]]:
    """``PLAN_PATH``'s entry ``key``, or None: none there, no readable
    file, or a knob that bypasses the plan (``BENCH_USE_PLAN`` other than
    1, or an explicit experiment knob, which the discovery path consumes
    and the key does not hold)."""
    if env.get("BENCH_USE_PLAN", "1") != "1":
        return None
    if (env.get("BENCH_BRICK_BUDGET") or env.get("BENCH_UNIQUE_BUDGET")
            or env.get("BENCH_TUNE_BUDGETS", "1") != "1"):
        return None
    try:
        with open(PLAN_PATH) as f:
            return json.load(f).get(key)
    except (OSError, ValueError):
        return None


def _write_plan(key, budgets) -> None:
    """Set ``PLAN_PATH``'s entry ``key`` to ``budgets``, keeping the rest."""
    try:
        with open(PLAN_PATH) as f:
            plans = json.load(f)
    except (OSError, ValueError):
        plans = {}
    plans[key] = budgets
    with open(PLAN_PATH, "w") as f:
        json.dump(plans, f, indent=1, sort_keys=True)
        f.write("\n")


class _Run:
    """One bench run's reporting state: the stage, the last complete
    payload and whether the one line has been printed."""

    def __init__(self, deadline_s: float):
        self.t0 = time.monotonic()
        self.deadline_s = deadline_s
        self.stage = "start"
        self.partial = None
        self._emitted = False
        self._lock = threading.Lock()
        self._done = threading.Event()

    def remaining(self) -> float:
        """Seconds left of the deadline."""
        return self.deadline_s - (time.monotonic() - self.t0)

    def emit(self, payload) -> bool:
        """Print the single JSON line (the first caller wins)."""
        with self._lock:
            if self._emitted:
                return False
            self._emitted = True
        print(json.dumps(payload), flush=True)
        return True

    def error_payload(self, msg: str):
        return {
            "metric": METRIC,
            "value": 0.0,
            "unit": "updates/s",
            "vs_baseline": 0.0,
            "error": msg,
            "stage": self.stage,
            "elapsed_s": round(time.monotonic() - self.t0, 1),
        }

    def salvage(self, note_key: str, note: str):
        """The last complete payload with a note, else the error line."""
        if self.partial is None:
            return self.error_payload(note)
        payload = dict(self.partial)
        payload["detail"] = dict(payload["detail"], **{note_key: note})
        return payload

    def start_watchdog(self) -> None:
        """Until ``stop_watchdog``: at the deadline, print the salvage line
        and end the process with exit code 3."""

        def watch():
            if self._done.wait(max(self.remaining(), 0.0)):
                return
            self.emit(self.salvage(
                "deadline_note",
                f"total deadline {self.deadline_s:.0f}s expired at stage "
                f"{self.stage}"))
            sys.stdout.flush()
            os._exit(3)

        threading.Thread(target=watch, daemon=True).start()

    def stop_watchdog(self) -> None:
        self._done.set()


def _card(device) -> dict:
    """The device's name and, for a card, its power limit as nvidia-smi
    reports it (None where nvidia-smi cannot say)."""
    import torch

    if device.type != "cuda":
        return {"device_name": "cpu", "power_limit": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = None
    return {"device_name": torch.cuda.get_device_name(device),
            "power_limit": smi}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def k1_launches() -> Tuple[int, int]:
    """(K1, K1-raw) launches so far in this process."""
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply

    return bin_apply.launches, bin_apply.raw_launches


def _int_env(env: Mapping[str, str], name: str, default: int) -> int:
    return int(env.get(name, str(default)))


class BudgetOverflow(RuntimeError):
    """A timed scan overflowed its budgets or its table."""


class Capture:
    """The bench's capture configuration (the root bench's ``main_brick``
    and ``main_hash``): the survey, its tables and device-resident inputs,
    the budgets and the capacity the timed runs use.  ``warm`` settles the
    budgets (plan, discovery and the fallbacks) by running the first scan;
    ``run`` is one timed scan."""

    def __init__(self, run: _Run, device, env: Mapping[str, str]):
        import torch

        from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
        from sonar_3d_reconstruction_tpu_torch.geometry import (
            batched_sonar_to_world,
        )
        from sonar_3d_reconstruction_tpu_torch.grid.brick import (
            DEFAULT_BRICK_BITS,
            is_raw_mode,
        )
        from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
            build_fan_tables,
        )
        from sonar_3d_reconstruction_tpu_torch.ops.packing import (
            compute_window_boxes,
        )

        run.stage = "setup"
        self.run_state, self.device, self.env = run, device, env
        self.cfg = cfg = MapperConfig()  # 5 cm voxels, 130 deg FOV, 10 m
        self.n_pings = _int_env(env, "BENCH_PINGS", 256)
        self.reps = _int_env(env, "BENCH_REPS", 3)
        self.backend = env.get("BENCH_BACKEND", "brick")
        if self.backend not in BUDGET_KEYS:
            raise ValueError(f"BENCH_BACKEND must be brick or hash, not "
                             f"{self.backend!r}")
        self.brick = self.backend == "brick"
        self.dense_mode = env.get("BENCH_DENSE_MODE", DEFAULT_DENSE_MODE)
        is_raw_mode(self.dense_mode)
        self.records_batch = _int_env(env, "BENCH_RECORDS_BATCH",
                                      DEFAULT_RECORDS_BATCH)
        self.window_group = _int_env(env, "BENCH_WINDOW_GROUP",
                                     DEFAULT_WINDOW_GROUP)
        if not self.brick and (self.records_batch,
                               self.window_group) != (1, 1):
            raise ValueError(
                f"records_batch and window_group batch the brick backend's "
                f"records; the hash bench takes neither (got "
                f"{self.records_batch}, {self.window_group})")
        if self.n_pings < 1 or self.reps < 1:
            raise ValueError("BENCH_PINGS and BENCH_REPS must be positive")
        self.window = min(_int_env(env, "BENCH_WINDOW", DEFAULT_WINDOW),
                          self.n_pings)
        self.count_sized = env.get("BENCH_COUNT_SIZED", "0") == "1"
        self.init_capacity = (
            _int_env(env, "BENCH_BRICK_CAPACITY", DEFAULT_BRICK_CAPACITY)
            if self.brick
            else _int_env(env, "BENCH_CAPACITY", DEFAULT_HASH_CAPACITY))

        self.images, self.positions, self.quats = make_inputs(cfg,
                                                              self.n_pings)
        self.caps = survey_caps(self.images, cfg)
        fan_cap, window_cap, free_cap = self.caps
        self.tables = build_fan_tables(
            cfg, cfg.image_height, cfg.image_width, fan_cap=fan_cap,
            window_cap=window_cap, free_cap=free_cap)
        self.plan_key = (_plan_key(cfg, self.n_pings, self.window, "brick",
                                   self.dense_mode, self.caps,
                                   self.init_capacity, 0)
                         if self.brick else None)

        run.stage = "upload"
        T = batched_sonar_to_world(self.positions, self.quats, cfg)
        # a copy (never a view of the host array: each run writes a pixel)
        self.images_dev = torch.tensor(self.images, device=device)
        self.T_dev = torch.as_tensor(T, device=device).to(torch.float32)
        # compact box keys when every window fits them, as the pipeline
        self.boxes = (compute_window_boxes(
            T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, self.window,
            DEFAULT_BRICK_BITS,
            frame_bits=max(1, (self.window - 1).bit_length()),
        ) if self.brick else None)
        _sync(device)
        self.budgets: Optional[Dict[str, Any]] = None
        self.budget_plan: Optional[str] = None
        self.capacity = self.init_capacity

    # -- budgets -----------------------------------------------------------
    def _warmup(self, **kw):
        """One ``map_ping_sequence`` of the survey from a fresh table of
        the initial capacity (host inputs, as a user maps)."""
        import torch

        from sonar_3d_reconstruction_tpu_torch.pipeline import (
            map_ping_sequence,
        )

        if self.brick:
            kw.update(dense_mode=self.dense_mode,
                      records_batch=self.records_batch,
                      window_group=self.window_group)
        return map_ping_sequence(
            self.images, self.positions, self.quats, self.cfg,
            device=self.device, backend=self.backend, dtype=torch.float32,
            window=self.window, tables=self.tables,
            initial_capacity=self.init_capacity, **kw)

    def _discover(self) -> Dict[str, Any]:
        """Budgets from a warm-up run: the JAX package's default budgets
        (or, on brick, ``BENCH_BRICK_BUDGET`` / ``BENCH_UNIQUE_BUDGET``),
        then the snug formulas unless ``BENCH_TUNE_BUDGETS`` is 0; the
        warm-up's own are kept as the ``safe_*`` budgets."""
        import torch

        from sonar_3d_reconstruction_tpu_torch.grid.brick import (
            default_brick_budget,
            init_brick_grid,
        )
        from sonar_3d_reconstruction_tpu_torch.pipeline import (
            scan_pings_brick,
        )
        from sonar_3d_reconstruction_tpu_torch.utils.autotune import (
            snug_budgets_brick,
            snug_budgets_hash,
        )

        env = self.env
        self.run_state.stage = f"warmup-discover-{self.backend}"
        size_key = "brick_budget" if self.brick else "batch_budget"
        if self.brick and (env.get("BENCH_BRICK_BUDGET")
                           or env.get("BENCH_UNIQUE_BUDGET")):
            capacity = self.init_capacity
            unique_budget = _int_env(env, "BENCH_UNIQUE_BUDGET",
                                     DEFAULT_UNIQUE_BUDGET)
            size = int(env.get("BENCH_BRICK_BUDGET")
                       or default_brick_budget(self.window, unique_budget))
            _, stats = scan_pings_brick(
                init_brick_grid(capacity, torch.float32, self.device),
                self.images_dev, self.T_dev, **self._scan_kwargs(),
                unique_budget=unique_budget, brick_budget=size)
            if stats["overflowed"].any():
                raise BudgetOverflow("the explicit warm-up budgets "
                                     "overflowed")
        else:
            effective: Dict[str, Any] = {}
            _, stats = self._warmup(budgets={}, effective=effective)
            capacity = effective["capacity"]
            unique_budget = effective["unique_budget"]
            size = effective[size_key]
        budgets: Dict[str, Any] = {
            "capacity": capacity, "unique_budget": unique_budget,
            size_key: size, "lane_budget": None, "insert_budget": None,
            "dedup_lane_budget": 0, "safe_unique_budget": unique_budget,
            "safe_" + size_key: size}
        if self.brick:
            budgets["vox_budget"] = None
        if env.get("BENCH_TUNE_BUDGETS", "1") == "1":
            budgets.update(
                snug_budgets_brick(stats, self.window, unique_budget, size,
                                   self.dense_mode) if self.brick
                else snug_budgets_hash(stats, self.window, unique_budget,
                                       size))
        return budgets

    def warm(self) -> Dict[str, Any]:
        """Settle the budgets and the capacity, running the first scan
        (rep 0) through the root bench's fallbacks: a plan that overflows
        is rediscovered, snug budgets that overflow give way to the safe
        ones.  Returns the first scan's per-ping stats."""
        env = self.env
        if self.count_sized:
            self.run_state.stage = f"warmup-{self.backend}"
            st, _ = self._warmup()
            self.capacity = st.capacity
            del st
            self.run_state.stage = f"first-run-{self.backend}"
            return self.run(0)[1]
        plan = _load_plan(self.plan_key, env) if self.brick else None
        self.budgets = dict(plan) if plan else self._discover()
        self.budget_plan = "hit" if plan else "discovered"
        if self.brick and not plan and env.get("BENCH_WRITE_PLAN",
                                               "0") == "1":
            _write_plan(self.plan_key, self.budgets)
        self.capacity = self.budgets["capacity"]
        self.run_state.stage = f"first-run-{self.backend}"
        try:
            return self.run(0)[1]
        except BudgetOverflow:
            pass
        if plan:
            # a stale plan: rediscover from scratch
            self.budgets = self._discover()
            self.budget_plan = "discovered"
            self.capacity = self.budgets["capacity"]
            self.run_state.stage = f"first-run-{self.backend}"
            try:
                return self.run(0)[1]
            except BudgetOverflow:
                pass
        # the snug budgets are too tight: the warm-up's own
        size_key = "brick_budget" if self.brick else "batch_budget"
        self.budgets.update(
            unique_budget=self.budgets["safe_unique_budget"],
            lane_budget=None, insert_budget=None, dedup_lane_budget=0,
            **{size_key: self.budgets["safe_" + size_key]})
        if self.brick:
            self.budgets["vox_budget"] = None
        return self.run(0)[1]

    # -- the timed scan ------------------------------------------------------
    def _scan_kwargs(self) -> Dict[str, Any]:
        import torch

        kw = dict(tables=self.tables, cfg=self.cfg, dtype=torch.float32,
                  window=self.window)
        if self.brick:
            kw.update(boxes=self.boxes, dense_mode=self.dense_mode,
                      records_batch=self.records_batch,
                      window_group=self.window_group)
        return kw

    def run(self, rep: int):
        """One scan of the survey from a fresh map of ``capacity`` with
        pixel (0, 0, 0) set to ``rep % 251``; (state, per-ping stats).
        BudgetOverflow when a window overflowed."""
        import torch

        from sonar_3d_reconstruction_tpu_torch.grid.brick import (
            init_brick_grid,
        )
        from sonar_3d_reconstruction_tpu_torch.grid.hash import init_hash_grid
        from sonar_3d_reconstruction_tpu_torch.pipeline import (
            scan_pings_brick,
            scan_pings_hash,
        )

        # fill_ takes the value as a kernel argument: no host copy, no sync
        self.images_dev[0, 0, 0].fill_(rep % 251)
        budgets = ({} if self.budgets is None else
                   {k: self.budgets[k] for k in BUDGET_KEYS[self.backend]})
        init, scan = ((init_brick_grid, scan_pings_brick) if self.brick
                      else (init_hash_grid, scan_pings_hash))
        st, stats = scan(init(self.capacity, torch.float32, self.device),
                         self.images_dev, self.T_dev, **self._scan_kwargs(),
                         **budgets)
        if stats["overflowed"].any():
            raise BudgetOverflow(
                f"a {self.backend} scan overflowed at "
                f"{'count-sized windows' if self.budgets is None else budgets}"
                f" from a table of {self.capacity}")
        return st, stats

    def budget_detail(self) -> Dict[str, Any]:
        """The payload's budget fields (None each when count-sized), the
        table's capacity (bricks or slots) and the plan's key and use."""
        b = self.budgets or {}
        out = {k: b.get(k) for k in BUDGET_KEYS[self.backend]}
        if self.brick:
            if self.boxes is None:
                out["vox_budget"] = None
            out.update(capacity_bricks=self.capacity,
                       plan_key=self.plan_key)
        else:
            out["capacity"] = self.capacity
        out.update(fan_cap=self.tables.nvo_cap,
                   budget_plan=self.budget_plan)
        return out


def measure_stream_latency(cfg, images, positions, quats, device, env,
                           backend="brick", dense_mode=DEFAULT_DENSE_MODE,
                           capacity=DEFAULT_BRICK_CAPACITY):
    """p50/p95 arrival -> map-committed latency per ping through
    ``StreamingMapper`` at chunk = window = ``BENCH_LATENCY_CHUNK`` (1:
    the per-ping flush, the low-latency deployment), pings back to back,
    over the first ``BENCH_LATENCY_PINGS`` pings, from a table of the
    bench's ``capacity`` (bricks or slots); the second, warm pass, each
    ping one pixel apart from the first pass's, is reported."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.io.bag import ImageMsg, OdometryMsg
    from sonar_3d_reconstruction_tpu_torch.stream import StreamingMapper

    chunk = _int_env(env, "BENCH_LATENCY_CHUNK", 1)
    n = min(images.shape[0], _int_env(env, "BENCH_LATENCY_PINGS", 96))
    h, w = images.shape[1:]
    # the stream's brick capacity counts voxel-equivalents (>> 4 inside)
    stream_capacity = capacity << 4 if backend == "brick" else capacity
    for t0 in (1000.0, 2000.0):  # the second pass is warm
        sm = StreamingMapper(cfg, chunk_size=chunk, window=chunk,
                             initial_capacity=stream_capacity,
                             dtype=torch.float32, backend=backend,
                             dense_mode=dense_mode, device=device)
        for i in range(n):
            t = t0 + 0.5 * i
            img = images[i]
            if t0 > 1000.0:  # the warm pass's pings differ by a pixel
                img = img.copy()
                img[0, 0] ^= 1
            sm.on_ping(ImageMsg(t, "sonar_link", h, w, "mono8", False, w,
                                img.tobytes()))
            sm.on_pose(OdometryMsg(t, "camera_init", "body", positions[i],
                                   quats[i]))
        stats = sm.finish()
    if stats.frames_mapped != n:
        raise RuntimeError(f"the latency stream mapped {stats.frames_mapped} "
                           f"of {n} pings")
    lat = stats.latency_percentiles()
    return {
        "p50_ping_to_map_ms": 1e3 * lat["p50"],
        "p95_ping_to_map_ms": 1e3 * lat["p95"],
        "latency_chunk": chunk,
        "latency_pings": n,
    }


def run_bench(run: _Run, device, env: Mapping[str, str]) -> dict:
    """Settle the capture's budgets (``Capture.warm``), then ``BENCH_REPS``
    timed scans; returns the payload (the latency stage added when
    ``BENCH_LATENCY`` is 1 and enough of the deadline is left)."""
    import numpy as np
    import torch

    cap = Capture(run, device, env)
    stats = cap.warm()
    total_updates = int(stats["num_candidates"].sum())
    # the reference's update_voxel calls: one per unique voxel per frame
    total_unique = int((stats["num_occupied"] + stats["num_free"]).sum())

    run.stage = f"timed-{cap.backend}"
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    best = float("inf")
    for rep in range(1, cap.reps + 1):
        _sync(device)
        k1_before = k1_launches()
        t0 = time.perf_counter()
        st, _ = cap.run(rep)
        best = min(best, time.perf_counter() - t0)
        k1, k1_raw = (b - a for a, b in zip(k1_before, k1_launches()))
    peak = (torch.cuda.max_memory_allocated(device) / 1e6
            if device.type == "cuda" else None)

    # the map's allocated table against a dense float32 grid over the
    # survey's updated bounds
    cfg, n_pings = cap.cfg, cap.n_pings
    bmin = st.min_bounds.cpu().numpy().astype(np.float64)
    bmax = st.max_bounds.cpu().numpy().astype(np.float64)
    dims = np.maximum(1, np.round((bmax - bmin) / cfg.voxel_resolution)
                      .astype(np.int64) + 1)
    dense_bytes = int(dims.prod()) * 4
    sparse_bytes = sum(t.numel() * t.element_size() for t in (
        st.key_rows, st.log_odds) + ((st.touched,) if cap.brick else ()))
    del st
    boxes = cap.boxes is not None

    updates_per_sec = total_updates / best
    payload = {
        "metric": METRIC,
        "value": updates_per_sec,
        "unit": "updates/s",
        "vs_baseline": updates_per_sec / BASELINE_UPDATES_PER_SEC,
        "detail": dict(
            backend=cap.backend,
            pings_per_sec=n_pings / best,
            mean_ping_latency_ms=1e3 * best / n_pings,
            updates_per_ping=total_updates / n_pings,
            unique_voxel_updates_per_sec=total_unique / best,
            unique_voxel_updates_per_ping=total_unique / n_pings,
            candidates_per_ping=cap.tables.candidates_per_ping(
                cfg.occupied_window),
            n_pings=n_pings,
            reps=cap.reps,
            window=cap.window,
            # without box keys every window takes unique records (K1)
            dense_mode=(None if not cap.brick else cap.dense_mode if boxes
                        else "pallas"),
            records_batch=cap.records_batch,
            window_group=cap.window_group if boxes else 1,
            compact_boxes=boxes,
            count_sized=cap.count_sized,
            **cap.budget_detail(),
            k1_launches=k1,
            k1_raw_launches=k1_raw,
            device=str(device),
            **_card(device),
            peak_memory_mb=peak,
            memory_sparse_mb=sparse_bytes / 1e6,
            memory_dense_equiv_mb=dense_bytes / 1e6,
            memory_ratio_vs_dense=dense_bytes / max(1, sparse_bytes),
        ),
    }
    run.partial = payload

    if env.get("BENCH_LATENCY", "1") == "1":
        run.stage = f"latency-{cap.backend}"
        lat_min = float(env.get("BENCH_LATENCY_MIN_REMAINING", "300"))
        if run.remaining() < lat_min:
            payload["detail"]["latency_skipped"] = (
                f"deadline: {run.remaining():.0f}s left < {lat_min:.0f}s")
        else:
            payload["detail"].update(measure_stream_latency(
                cfg, cap.images, cap.positions, cap.quats, device, env,
                backend=cap.backend, dense_mode=cap.dense_mode,
                capacity=cap.capacity))
    return payload


def main(argv: Optional[List[str]] = None,
         env: Optional[Mapping[str, str]] = None) -> int:
    """Run the bench and print its one JSON line; 0 on success, 1 on a
    failure (3 from the deadline watchdog, which exits the process)."""
    parser = argparse.ArgumentParser(
        prog="sonar_3d_reconstruction_tpu_torch bench",
        description="headline benchmark (one JSON line)",
    )
    parser.add_argument(
        "--device", default=None, metavar="DEVICE",
        help="torch device to run on (default: the first CUDA device, "
        "required; 'cpu' runs on the CPU)",
    )
    args = parser.parse_args(argv)
    env = os.environ if env is None else env
    run = _Run(float(env.get("BENCH_DEADLINE", "1200")))
    run.start_watchdog()
    try:
        run.stage = "imports"
        import torch

        from sonar_3d_reconstruction_tpu_torch.device import require_cuda

        run.stage = "device"
        device = (require_cuda() if args.device is None
                  else torch.empty(0, device=args.device).device)
        run.emit(run_bench(run, device, env))
        return 0
    except Exception as e:  # noqa: BLE001 — the one line must print
        import traceback

        traceback.print_exc(file=sys.stderr)
        run.emit(run.salvage(
            "error_note", f"{type(e).__name__} at stage {run.stage}: {e}"))
        return 1
    finally:
        run.stop_watchdog()


if __name__ == "__main__":
    sys.exit(main())
