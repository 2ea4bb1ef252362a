"""Profiling and structured per-ping statistics (PyTorch port of
``sonar_3d_reconstruction_tpu.utils.profiling``).

The reference's observability is hand-rolled wall-clock deltas and per-voxel
update-count histograms printed every 10 frames (reference
scripts/3d_mapper.py:500, 569-585).  This module keeps the same stats-dict
fields for drop-in comparability and adds:

  * ``device_trace`` — a ``torch.profiler`` trace of the enclosed block
    (host ops and, where a card is visible, its kernels and copies),
    written as a Chrome trace that Perfetto opens;
  * ``timed`` — lightweight wall-clock section timer;
  * ``StatsAggregator`` — rolling per-ping stats with the reference's
    every-N-frames reporting cadence.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block over the CPU and, where PyTorch sees a
    CUDA device, the card; on exit the trace is written into ``log_dir``
    (created if needed) as ``<host>_<pid>.<time>.pt.trace.json``.  Yields the
    profiler, whose ``key_averages()`` sum the events by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


@contextlib.contextmanager
def timed(sink: Dict[str, float], key: str) -> Iterator[None]:
    """Accumulate the wall-clock time of the enclosed block into sink[key]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink[key] = sink.get(key, 0.0) + (time.perf_counter() - t0)


@dataclass
class PingStats:
    """One ping's stats — the reference process_sonar_image return fields
    (3d_mapper.py:587-595)."""

    frame_count: int
    num_occupied: int
    num_free: int
    num_voxels: int
    processing_time: float


@dataclass
class StatsAggregator:
    """Rolling aggregation with periodic reporting (reference logs every 10
    frames, node:345-357)."""

    report_every: int = 10
    report_fn: Optional[Callable[[str], None]] = None
    history: List[PingStats] = field(default_factory=list)
    total_time: float = 0.0

    def add(self, s: PingStats) -> None:
        self.history.append(s)
        self.total_time += s.processing_time
        if self.report_fn and s.frame_count % self.report_every == 0:
            self.report_fn(self.format_report(s))

    def format_report(self, s: PingStats) -> str:
        avg = self.total_time / max(1, len(self.history))
        return (
            f"frame {s.frame_count}: occupied={s.num_occupied} "
            f"free={s.num_free} voxels={s.num_voxels} "
            f"({s.processing_time * 1e3:.1f} ms, avg {avg * 1e3:.1f} ms, "
            f"{1.0 / avg if avg > 0 else 0.0:.1f} fps)"
        )

    def summary(self) -> Dict[str, float]:
        n = len(self.history)
        if n == 0:
            return {"frames": 0}
        return {
            "frames": n,
            "avg_processing_time": self.total_time / n,
            "fps": n / self.total_time if self.total_time > 0 else 0.0,
            "last_num_voxels": self.history[-1].num_voxels,
            "p50_processing_time": sorted(
                s.processing_time for s in self.history
            )[n // 2],
        }
