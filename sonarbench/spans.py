"""The program's own spans in the trace of a traced pass, and the device
time charged to each.

While a profiler records, ``pipeline.map_ping_sequence`` opens
``record_function`` ranges named ``sonar3d.*`` (``upload``, ``scan``,
``window``, ``records``, ``apply``); they are ``user_annotation`` events
on the host thread that opened them, on the clock of the kernels and
copies.

A device operation (``trace.DEVICE_CATS``) is charged to the span that
launched it, never to one that it overlaps in time: its ``correlation``
id names the host CUDA call (``cuda_runtime`` / ``cuda_driver``) that
enqueued it, and the innermost ``sonar3d.*`` span on that call's thread
that holds the call's start is its span.  The host runs windows ahead of
the card, so an operation often runs while the host is in a later span.

``of`` gives None where the trace cannot say: it holds no launch (no
card), fewer kernel events than launches (the profiler dropped some), a
device operation of the traced pass with no host call of its
correlation, or no ``sonar3d.*`` span (a program without them).
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Tuple

from sonarbench import trace as tracing

PREFIX = "sonar3d."
CALL_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """The ``sonar3d.*`` spans of the traced pass and the owner of each
    of its device operations (build with ``of``)."""

    def __init__(self, tr: tracing.Trace, spans: List[dict],
                 owned: List[Tuple[dict, Optional[str]]]):
        self.trace = tr
        self.spans = spans
        # (device event, name of the span that launched it or None)
        self.owned = owned

    def named(self, name: str) -> List[dict]:
        return [e for e in self.spans if e["name"] == PREFIX + name]

    def device_us_by_span(self) -> Dict[Optional[str], float]:
        """Device time by the name of the span that launched it (None:
        launched outside every span)."""
        out: Dict[Optional[str], float] = {}
        for e, owner in self.owned:
            out[owner] = out.get(owner, 0.0) + float(e["dur"])
        return out

    def device_us(self, name: str) -> float:
        """Device time of the operations launched inside
        ``sonar3d.<name>``."""
        return self.device_us_by_span().get(PREFIX + name, 0.0)

    def host_us(self, name: str) -> float:
        """Host time summed over the ``sonar3d.<name>`` spans."""
        return sum(float(e["dur"]) for e in self.named(name))

    def idle_us_outside(self, name: str) -> float:
        """Time in the pass's window with no device operation running
        while the host is in no ``sonar3d.<name>`` span."""
        w0, w1 = self.trace.window
        covered = tracing.union_us(
            list(self.trace.busy())
            + [tracing.Trace.span(e) for e in self.named(name)])
        free, at = 0.0, w0
        for s, e in covered:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            free += max(0.0, s - at)
            at = max(at, e)
        return free + max(0.0, w1 - at)


def _in_window(e, w0, w1) -> bool:
    s, t = tracing.Trace.span(e)
    return s < w1 and t > w0


class _Innermost:
    """The innermost of properly nested spans of one thread that holds a
    time."""

    def __init__(self, spans: List[dict]):
        self.spans = sorted(spans, key=lambda e: (float(e["ts"]),
                                                  -float(e["dur"])))
        self.starts = [float(e["ts"]) for e in self.spans]
        # the latest end among the spans up to each index
        self.reach = []
        top = -math.inf
        for e in self.spans:
            top = max(top, tracing.Trace.span(e)[1])
            self.reach.append(top)

    def at(self, t: float) -> Optional[dict]:
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.reach[j] >= t:
            if tracing.Trace.span(self.spans[j])[1] >= t:
                return self.spans[j]
            j -= 1
        return None


def of(tr: tracing.Trace) -> Optional[Spans]:
    """The spans of ``tr``'s traced pass and the owner of each of its
    device operations; None where the trace cannot say (module
    docstring)."""
    if not tr.launches() or not tr.kernels_complete():
        return None
    w0, w1 = tr.window
    spans = [e for e in tr.of(("user_annotation",))
             if e.get("name", "").startswith(PREFIX)
             and w0 <= float(e["ts"]) <= w1]
    if not spans:
        return None
    threads: Dict[tuple, List[dict]] = {}
    for e in spans:
        threads.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    inner = {k: _Innermost(v) for k, v in threads.items()}
    calls = {e["args"]["correlation"]: e for e in tr.of(CALL_CATS)
             if "correlation" in e.get("args", {})}
    owned = []
    for d in tr.of(tracing.DEVICE_CATS):
        if not _in_window(d, w0, w1):
            continue
        call = calls.get(d.get("args", {}).get("correlation"))
        if call is None:
            return None
        finder = inner.get((call.get("pid"), call.get("tid")))
        owner = None if finder is None else finder.at(float(call["ts"]))
        owned.append((d, None if owner is None else owner["name"]))
    return Spans(tr, spans, owned)
