"""The port's ``utils/profiling`` against the JAX package's: the same
``PingStats`` give the same report lines and summary, ``timed``
accumulates, and ``device_trace`` writes a Chrome trace (here of the CPU:
no card)."""

import glob
import json
import os

import pytest

torch = pytest.importorskip("torch")

from sonar_3d_reconstruction_tpu.utils import profiling as j_profiling  # noqa: E402

from sonar_3d_reconstruction_tpu_torch.utils import (  # noqa: E402
    PingStats,
    StatsAggregator,
    device_trace,
    timed,
)

# (frame, occupied, free, voxels, seconds): frames 10 and 20 report
PINGS = [(i, 100 + 7 * i, 900 - 3 * i, 2000 + 50 * i, 0.004 + 0.0005 * (i % 5))
         for i in range(1, 24)]


@pytest.mark.parametrize("report_every", [1, 10])
def test_stats_aggregator_matches_jax(report_every):
    """Report lines (every ``report_every`` frames) and summaries equal the
    JAX package's on the same pings, empty and filled."""
    lines, j_lines = [], []
    agg = StatsAggregator(report_every=report_every, report_fn=lines.append)
    j_agg = j_profiling.StatsAggregator(report_every=report_every,
                                        report_fn=j_lines.append)
    assert agg.summary() == j_agg.summary() == {"frames": 0}
    for p in PINGS:
        agg.add(PingStats(*p))
        j_agg.add(j_profiling.PingStats(*p))
    assert lines == j_lines
    assert len(lines) == len(PINGS) // report_every
    assert agg.summary() == j_agg.summary()
    assert agg.format_report(agg.history[-1]) == j_agg.format_report(
        j_agg.history[-1])


def test_timed_accumulates():
    """Each block adds its wall time to its key, also when it raises."""
    sink = {}
    with timed(sink, "a"):
        pass
    first = sink["a"]
    with timed(sink, "a"):
        sum(range(10000))
    assert sink["a"] > first >= 0.0
    with pytest.raises(RuntimeError):
        with timed(sink, "b"):
            raise RuntimeError("boom")
    assert sink["b"] >= 0.0 and set(sink) == {"a", "b"}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU the trace holds the block's host ops; the file is a
    Chrome trace in the named directory, which is created."""
    log_dir = str(tmp_path / "trace")
    x = torch.arange(4096, dtype=torch.float64)
    with device_trace(log_dir) as prof:
        torch.cumsum(x, dim=0)
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::cumsum" for e in events)
    assert any(e.key == "aten::cumsum" for e in prof.key_averages())
