"""The device trace of one traced pass, and what the per-layer readers
(``sonarbench/metrics/<metric>.py``) and the result's ``breakdown`` read
from it.

``capture`` records the enclosed block with ``torch.profiler`` over the
host and the card, under a ``sonarbench.traced_pass`` annotation, and
writes a Chrome trace to a fixed path inside the checkout.  ``Trace``
loads it: the complete events, the annotated window, the device
intervals and the host's CUDA API calls.
"""

from __future__ import annotations

import bisect
import contextlib
import gzip
import json
from typing import Dict, Iterable, List, Optional, Tuple

ANNOTATION = "sonarbench.traced_pass"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SYNC_NAMES = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


@contextlib.contextmanager
def capture(path: str):
    """Profile the enclosed block (host and card) under the annotation and
    write its Chrome trace to ``path``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(ANNOTATION):
            yield
    prof.export_chrome_trace(path)


def union_us(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """A Chrome trace of one traced pass."""

    def __init__(self, path: str):
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            raw = json.load(f)
        events = raw["traceEvents"] if isinstance(raw, dict) else raw
        self.events = [e for e in events
                       if e.get("ph") == "X" and "dur" in e]
        marks = [e for e in self.events if e.get("name") == ANNOTATION
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise RuntimeError(f"the trace holds no {ANNOTATION} span")
        t0 = float(marks[0]["ts"])
        self.window = (t0, t0 + float(marks[0]["dur"]))

    def of(self, cats) -> List[dict]:
        return [e for e in self.events if e.get("cat") in cats]

    @staticmethod
    def span(e) -> Tuple[float, float]:
        ts = float(e["ts"])
        return ts, ts + float(e["dur"])

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy(self, cats=DEVICE_CATS) -> List[Tuple[float, float]]:
        """Disjoint device-busy intervals of ``cats`` inside the window."""
        w0, w1 = self.window
        clipped = ((max(s, w0), min(e, w1)) for s, e in map(self.span,
                                                            self.of(cats)))
        return union_us((s, e) for s, e in clipped if e > s)

    def busy_s(self, cats=DEVICE_CATS) -> float:
        return sum(e - s for s, e in self.busy(cats)) / 1e6

    def runtime_calls(self, word: str) -> int:
        """Host CUDA API calls whose name holds ``word``."""
        return sum(word in e.get("name", "")
                   for e in self.of(("cuda_runtime", "cuda_driver")))

    def launches(self) -> int:
        return self.runtime_calls("LaunchKernel")

    def host_waits(self) -> int:
        """Times the host waited for the device: synchronize calls, and
        blocking ``cudaMemcpy`` calls (a read through ``cudaMemcpyAsync``
        is followed by a stream synchronize, counted once)."""
        calls = self.of(("cuda_runtime", "cuda_driver"))
        return sum(e.get("name") in SYNC_NAMES or e.get("name") == "cudaMemcpy"
                   for e in calls)

    def kernel_us(self, word: str) -> float:
        """Device time of the kernels whose name holds ``word``."""
        return sum(float(e["dur"]) for e in self.of(("kernel",))
                   if word in e.get("name", ""))

    def kernels_complete(self) -> bool:
        """Whether every launch has its kernel event (the profiler drops
        kernel records when its buffers fill)."""
        return len(self.of(("kernel",))) >= self.launches()

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing: the innermost host event over
        the gap's middle, else ``after_<name>`` of the last one that began
        before it."""
        ops: Dict[str, float] = {}
        for e in self.of(DEVICE_CATS):
            ops[e["name"]] = ops.get(e["name"], 0.0) + float(e["dur"]) / 1e6
        host = sorted(map(self._span_named, self.of(HOST_CATS)))
        starts = [h[0] for h in host]
        gaps: Dict[str, float] = {}
        w0, w1 = self.window
        edges = [w0] + [x for iv in self.busy() for x in iv] + [w1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            label = self._host_at((a + b) / 2, host, starts)
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
        rank = lambda d: sorted(([k, v] for k, v in d.items()),
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}

    def _span_named(self, e):
        s, t = self.span(e)
        return s, t, e.get("name", "")

    @staticmethod
    def _host_at(mid, host, starts, look: int = 256) -> str:
        i = bisect.bisect_right(starts, mid)
        if i == 0:
            return "host_before_trace"
        for j in range(i - 1, max(-1, i - 1 - look), -1):
            s, t, name = host[j]
            if t >= mid and name != ANNOTATION:
                return name
        for j in range(i - 1, max(-1, i - 1 - look), -1):
            if host[j][2] != ANNOTATION:
                return "after_" + host[j][2]
        return "host_python"


def busy_share_pct(trace: Trace) -> Optional[float]:
    """Union of kernel intervals over the traced window, in percent; None
    where the trace holds fewer kernel events than launches."""
    if not trace.kernels_complete():
        return None
    return 100.0 * trace.busy_s(("kernel",)) / trace.window_s()
