"""Headline benchmark of the port: voxel log-odds updates/s through the
whole mapping pipeline on one CUDA device (port of the root ``bench.py``).

The survey is ``make_inputs``: 256 full-size pings (500 range bins x 512
bearings, the reference Oculus M750D geometry) at the library-default 5 cm
voxels, mapped by ``pipeline.map_ping_sequence`` in windows of 16 on the
brick backend (the binning kernel K1 in every window) or the hash backend.
The metric counts the valid candidate emissions applied to the map (the
per-ping ``num_candidates``), the work items the reference performs one by
one; ``vs_baseline`` is against 1e9 updates/s.

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

Environment (the root bench's knobs where they mean the same):
``BENCH_PINGS`` (256), ``BENCH_REPS`` (3 timed runs, the best reported),
``BENCH_WINDOW`` (16), ``BENCH_BACKEND`` (``brick`` or ``hash``),
``BENCH_DENSE_MODE`` (``pallas`` or ``pallas-raw``; the JAX package's TPU
tile suffixes are refused), ``BENCH_RECORDS_BATCH`` (1) and
``BENCH_WINDOW_GROUP`` (1) (brick only: ``pipeline.scan_pings_brick``),
``BENCH_LATENCY`` (1: also measure the ping-to-map latency),
``BENCH_LATENCY_CHUNK`` (1: the stream's chunk and window),
``BENCH_LATENCY_PINGS`` (96), ``BENCH_DEADLINE`` (1200 s).  The root
bench's budget, plan, compile-cache and TPU-acquisition knobs have no
counterpart: the port keeps no static budgets and compiles nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from typing import List, Mapping, Optional

METRIC = "voxel_log_odds_updates_per_sec"
BASELINE_UPDATES_PER_SEC = 1e9
DEFAULT_WINDOW = 16
DEFAULT_DENSE_MODE = "pallas"
DEFAULT_RECORDS_BATCH = 1
DEFAULT_WINDOW_GROUP = 1


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
            left = self.deadline_s - (time.monotonic() - self.t0)
            if self._done.wait(max(left, 0.0)):
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


def _k1_launches() -> int:
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply

    return bin_apply.launches + bin_apply.raw_launches


def _int_env(env: Mapping[str, str], name: str, default: int) -> int:
    return int(env.get(name, str(default)))


def measure_stream_latency(cfg, images, positions, quats, device, env,
                           backend="brick", dense_mode="pallas"):
    """p50/p95 arrival -> map-committed latency per ping through
    ``StreamingMapper`` at chunk = window = ``BENCH_LATENCY_CHUNK`` (1:
    the per-ping flush, the low-latency deployment), pings back to back,
    over the first ``BENCH_LATENCY_PINGS`` pings; the second, warm pass is
    reported."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.io.bag import ImageMsg, OdometryMsg
    from sonar_3d_reconstruction_tpu_torch.stream import StreamingMapper

    chunk = _int_env(env, "BENCH_LATENCY_CHUNK", 1)
    n = min(images.shape[0], _int_env(env, "BENCH_LATENCY_PINGS", 96))
    h, w = images.shape[1:]
    for t0 in (1000.0, 2000.0):  # the second pass is warm
        sm = StreamingMapper(cfg, chunk_size=chunk, window=chunk,
                             dtype=torch.float32, backend=backend,
                             dense_mode=dense_mode, device=device)
        for i in range(n):
            t = t0 + 0.5 * i
            sm.on_ping(ImageMsg(t, "sonar_link", h, w, "mono8", False, w,
                                images[i].tobytes()))
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
    """Map the survey once to warm up and size the map, then ``BENCH_REPS``
    timed times from a fresh map of that size; returns the payload (the
    latency stage added when ``BENCH_LATENCY`` is 1)."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.geometry import (
        batched_sonar_to_world,
    )
    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        DEFAULT_BRICK_BITS,
        init_brick_grid,
    )
    from sonar_3d_reconstruction_tpu_torch.grid.hash import init_hash_grid
    from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
        tables_for_images,
    )
    from sonar_3d_reconstruction_tpu_torch.ops.packing import (
        compute_window_boxes,
    )
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    run.stage = "setup"
    cfg = MapperConfig()  # 5 cm voxels, 130 deg FOV, 10 m range
    n_pings = _int_env(env, "BENCH_PINGS", 256)
    reps = _int_env(env, "BENCH_REPS", 3)
    window = min(_int_env(env, "BENCH_WINDOW", DEFAULT_WINDOW), n_pings)
    backend = env.get("BENCH_BACKEND", "brick")
    if backend not in ("brick", "hash"):
        raise ValueError(f"BENCH_BACKEND must be brick or hash, not "
                         f"{backend!r}")
    brick = backend == "brick"
    dense_mode = env.get("BENCH_DENSE_MODE", DEFAULT_DENSE_MODE)
    records_batch = _int_env(env, "BENCH_RECORDS_BATCH", DEFAULT_RECORDS_BATCH)
    window_group = _int_env(env, "BENCH_WINDOW_GROUP", DEFAULT_WINDOW_GROUP)
    if n_pings < 1 or reps < 1:
        raise ValueError("BENCH_PINGS and BENCH_REPS must be positive")
    images, positions, quats = make_inputs(cfg, n_pings)
    tables = tables_for_images(images, cfg)
    # the hash backend refuses records batching other than 1
    kw = dict(device=device, backend=backend, dtype=torch.float32,
              window=window, tables=tables, records_batch=records_batch,
              window_group=window_group)
    if brick:
        kw.update(dense_mode=dense_mode)

    run.stage = f"warmup-{backend}"
    st, stats = map_ping_sequence(images, positions, quats, cfg, **kw)
    capacity = st.capacity
    total_updates = int(stats["num_candidates"].sum())
    # the reference's update_voxel calls: one per unique voxel per frame
    total_unique = int((stats["num_occupied"] + stats["num_free"]).sum())
    del st

    run.stage = f"timed-{backend}"
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    best = float("inf")
    for _ in range(reps):
        fresh = (init_brick_grid(capacity, torch.float32, device) if brick
                 else init_hash_grid(capacity, torch.float32, device))
        _sync(device)
        k1_before = _k1_launches()
        t0 = time.perf_counter()
        st, stats = map_ping_sequence(images, positions, quats, cfg,
                                      state=fresh, **kw)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
        k1 = _k1_launches() - k1_before
        if stats["overflowed"].any():
            raise RuntimeError("a timed run grew its map: the warm-up "
                               "capacity did not hold the survey")
    peak = (torch.cuda.max_memory_allocated(device) / 1e6
            if device.type == "cuda" else None)

    # the map's allocated table against a dense float32 grid over the
    # survey's updated bounds
    res = cfg.voxel_resolution
    bmin = st.min_bounds.cpu().numpy().astype(np.float64)
    bmax = st.max_bounds.cpu().numpy().astype(np.float64)
    dims = np.maximum(1, np.round((bmax - bmin) / res).astype(np.int64) + 1)
    dense_bytes = int(dims.prod()) * 4
    sparse_bytes = sum(t.numel() * t.element_size() for t in (
        st.key_rows, st.log_odds) + ((st.touched,) if brick else ()))
    T = batched_sonar_to_world(positions, quats, cfg)
    boxes = brick and (compute_window_boxes(
        T[:, :3, 3], cfg.max_range, res, window, DEFAULT_BRICK_BITS,
        frame_bits=max(1, (window - 1).bit_length()),
    ) is not None)

    updates_per_sec = total_updates / best
    payload = {
        "metric": METRIC,
        "value": updates_per_sec,
        "unit": "updates/s",
        "vs_baseline": updates_per_sec / BASELINE_UPDATES_PER_SEC,
        "detail": dict(
            backend=backend,
            pings_per_sec=n_pings / best,
            mean_ping_latency_ms=1e3 * best / n_pings,
            updates_per_ping=total_updates / n_pings,
            unique_voxel_updates_per_sec=total_unique / best,
            unique_voxel_updates_per_ping=total_unique / n_pings,
            candidates_per_ping=tables.candidates_per_ping(
                cfg.occupied_window),
            n_pings=n_pings,
            reps=reps,
            window=window,
            dense_mode=dense_mode if brick else None,
            records_batch=records_batch if brick else 1,
            window_group=window_group if boxes else 1,
            compact_boxes=boxes,
            capacity=capacity,
            k1_launches=k1,
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
        run.stage = f"latency-{backend}"
        payload = dict(payload, detail=dict(
            payload["detail"], **measure_stream_latency(
                cfg, images, positions, quats, device, env, backend=backend,
                dense_mode=dense_mode if brick else "pallas")))
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
