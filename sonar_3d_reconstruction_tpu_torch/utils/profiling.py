"""Profiling: a device trace of a block, and the program's own spans.

The reference's observability is hand-rolled wall-clock deltas printed
every 10 frames (reference scripts/3d_mapper.py:500, 569-585).  Here:

  * ``device_trace`` — a ``torch.profiler`` trace of the enclosed block
    (host ops and, where a card is visible, its kernels and copies),
    written as a Chrome trace that Perfetto opens;
  * ``span`` — a named range of the program (``sonar3d.*`` in
    ``pipeline.map_ping_sequence``) that lands in whatever
    ``torch.profiler`` trace is being recorded, beside the kernels and
    copies it launches, and costs one flag test when none is.
"""

from __future__ import annotations

import contextlib
from typing import ContextManager, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

# what ``span`` returns while no profiler runs: one object, never built
_NO_SPAN = contextlib.nullcontext()


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


def span(name: str) -> ContextManager:
    """A ``record_function(name)`` range while a ``torch.profiler`` profile
    is recording, else the shared null context.  In the trace the range
    is a ``user_annotation`` event on the calling thread, and every CUDA
    call made inside it (a launch, a copy, a set) falls within it, so a
    reader can charge each device operation to the span that launched it
    through the operation's ``correlation`` id."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN
