"""The program's spans and the benchmark's readers of them.

``utils.profiling.span`` is the shared null context with no profiler
running; under ``torch.profiler`` the brick path of ``map_ping_sequence``
opens one ``sonar3d.upload``, a ``sonar3d.scan`` a scan of its growth
loop, and a ``sonar3d.window`` a group of windows holding one
``sonar3d.records`` and an ``sonar3d.apply`` a window, in the count-sized
and the budgeted loop, and the maps and stats are bit-equal with the
profiler on and off.  The six readers of ``sonarbench/metrics/`` that read
the spans give their numbers on a hand-built trace, charge a device
operation to the span that launched it (by ``correlation``, not by time),
and give None where the trace cannot say; on a trace recorded on the card
every reader gives the number the run that recorded it printed.

The recorded trace (``tests/data/spans_trace.json.gz``, with
``spans_pass.json``): ``sonarbench.run.run_cell`` on
``m750d_5cm.survey_replay`` with its knobs at window = records_batch = 16,
``plan={}``, ``pool_pings=64``, ``pass_pings=32``, ``trace=True``, seed
3000000121, on an NVIDIA H100 80GB HBM3 at 700 W: the traced pass's trace
gzipped, and the pass's pings, window and printed metrics."""

import gzip
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sonar_3d_reconstruction_tpu_torch import pipeline  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    brick_state_to_numpy,
    init_brick_grid,
)
from sonar_3d_reconstruction_tpu_torch.utils import profiling  # noqa: E402
from sonarbench import run, trace  # noqa: E402

from test_shard_brick import make_seq  # noqa: E402
from torch_parity import port_cfg  # noqa: E402

SPAN_READERS = [
    "records.device_ms_per_ping.survey",
    "apply.device_ms_per_ping.survey",
    "upload.device_ms_per_pass.survey",
    "pipeline.host_ms_per_window.survey",
    "pipeline.idle_ms_outside_windows.survey",
    "pipeline.replays_per_pass.survey",
]
DATA = Path(__file__).parent / "data"
RECORDED = json.loads((DATA / "spans_pass.json").read_text())
P, WINDOW = 7, 3
# the run of each brick loop: count-sized, and at the JAX defaults' budgets
LOOPS = {"count_sized": {}, "budgeted": {"budgets": {}}}


def _map(cfg, images, positions, quats, **kw):
    kw.setdefault("window", WINDOW)
    return pipeline.map_ping_sequence(
        images, positions, quats, cfg, device="cpu", dtype=torch.float32,
        records_batch=kw["window"], **kw)


def _traced(tmp_path, fn):
    """``fn()`` under the benchmark's capture; (its result, the trace's
    ``sonar3d.*`` spans sorted by start)."""
    path = str(tmp_path / "trace.json")
    with trace.capture(path):
        out = fn()
    tr = trace.Trace(path)
    spans = sorted((e for e in tr.of(("user_annotation",))
                    if e["name"].startswith("sonar3d.")),
                   key=lambda e: (e["ts"], -e["dur"]))
    return out, spans


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_span_is_the_shared_null_context_with_no_profiler():
    assert profiling.span("sonar3d.a") is profiling.span("sonar3d.b")
    assert profiling.span("sonar3d.a") is profiling._NO_SPAN
    with profiling.span("sonar3d.a") as got:
        assert got is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        inside = profiling.span("sonar3d.a")
    assert inside is not profiling._NO_SPAN
    assert profiling.span("sonar3d.a") is profiling._NO_SPAN


@pytest.mark.parametrize("loop", list(LOOPS))
def test_brick_loop_spans_nest_a_window_each(small_cfg, tmp_path, loop):
    """One upload and one scan; ceil(P / window) windows inside the scan,
    each with one records and one apply inside it, records first."""
    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, P, seed=71)
    _, spans = _traced(tmp_path, lambda: _map(cfg, images, positions, quats,
                                              **LOOPS[loop]))
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    assert set(by) == {"sonar3d." + n for n in
                       ("upload", "scan", "window", "records", "apply")}
    (upload,), (scan,) = by["sonar3d.upload"], by["sonar3d.scan"]
    assert upload["ts"] + upload["dur"] <= scan["ts"]
    windows = by["sonar3d.window"]
    assert len(windows) == math.ceil(P / WINDOW)
    for w in windows:
        assert _inside(w, scan)
        recs = [e for e in by["sonar3d.records"] if _inside(e, w)]
        applies = [e for e in by["sonar3d.apply"] if _inside(e, w)]
        assert len(recs) == len(applies) == 1
        assert recs[0]["ts"] + recs[0]["dur"] <= applies[0]["ts"]
    assert len(by["sonar3d.records"]) == len(by["sonar3d.apply"]) == len(
        windows)


def test_window_group_opens_a_window_span_a_group(small_cfg, tmp_path):
    """At window_group 2 a window span holds one records and two applies."""
    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, 8, seed=72)
    _, spans = _traced(tmp_path, lambda: _map(
        cfg, images, positions, quats, window=2, window_group=2))
    windows = [e for e in spans if e["name"] == "sonar3d.window"]
    assert len(windows) == 2
    for w in windows:
        inner = [e["name"] for e in spans if _inside(e, w) and e is not w]
        assert inner == ["sonar3d.records", "sonar3d.apply", "sonar3d.apply"]


@pytest.mark.parametrize("loop", list(LOOPS))
def test_profiler_leaves_maps_and_stats_bit_equal(small_cfg, tmp_path, loop):
    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, P, seed=73)
    plain = _map(cfg, images, positions, quats, **LOOPS[loop])
    (state, stats), spans = _traced(
        tmp_path, lambda: _map(cfg, images, positions, quats, **LOOPS[loop]))
    assert spans
    assert stats.keys() == plain[1].keys()
    for k in stats:
        np.testing.assert_array_equal(stats[k], plain[1][k], err_msg=k)
    got, want = brick_state_to_numpy(state), brick_state_to_numpy(plain[0])
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_growth_shows_as_scans(small_cfg, tmp_path, monkeypatch):
    """A 128-brick table grows and replays from the failed window: one
    scan, then one more a growth, one after another."""
    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, 9, seed=63)
    grows = []
    real = pipeline.rehash_bricks

    def counted(*a, **kw):
        grows.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(pipeline, "rehash_bricks", counted)
    (state, _), spans = _traced(tmp_path, lambda: _map(
        cfg, images, positions, quats,
        state=init_brick_grid(128, torch.float32, "cpu")))
    scans = [e for e in spans if e["name"] == "sonar3d.scan"]
    assert grows and state.capacity == 128 << len(grows)
    assert len(scans) == 1 + len(grows)
    # the scans follow one another: no scan inside another
    for a, b in zip(scans, scans[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]


# -- the readers on a hand-built trace --------------------------------
#
# One pass of 4 pings at window 2 (2 windows), on host thread 1 (times in
# us): the upload [1, 5] copies for 10 us; the scan [6, 95] holds window
# 1 [7, 30] (records [8, 15] launches a kernel that runs 20-40, through
# the host's apply of window 1 and records of window 2; apply [16, 29]
# one of 5 us) and window 2 [31, 50] (records one of 5 us, apply one of
# 10 us), then the stats read, a copy of 1 us.  Thread 2 launches a
# kernel of 3 us at 9, inside thread 1's records span: it is no span's.
PINGS, KNOB_WINDOW = 4, 2
TOTALS = {
    "records.device_ms_per_ping.survey": (20 + 5) / 1e3 / PINGS,
    "apply.device_ms_per_ping.survey": (5 + 10) / 1e3 / PINGS,
    "upload.device_ms_per_pass.survey": 10 / 1e3,
    "pipeline.host_ms_per_window.survey": (23 + 19) / 1e3 / 2,
    # busy [2, 12] and [20, 64]; windows [7, 30] and [31, 50]: idle
    # outside them [0, 2] and [64, 100]
    "pipeline.idle_ms_outside_windows.survey": (2 + 36) / 1e3,
    "pipeline.replays_per_pass.survey": 0.0,
}


def _span(name, ts, end, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1,
            "tid": tid, "ts": ts, "dur": end - ts}


def _op(cat, name, ts, dur, corr, tid=1):
    """A host CUDA call (``cat`` a call category) or a device event."""
    on_card = cat in trace.DEVICE_CATS
    return {"ph": "X", "cat": cat, "name": name, "pid": 0 if on_card else 1,
            "tid": 7 if on_card else tid, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(t, corr, start, dur, tid=1):
    return [_op("cuda_runtime", "cudaLaunchKernel", t, 0.5, corr, tid),
            _op("kernel", f"k{corr}", start, dur, corr)]


def hand_built(extra_scans=0):
    events = [
        _span(trace.ANNOTATION, 0, 100),
        _span("sonar3d.upload", 1, 5),
        _op("cuda_runtime", "cudaMemcpyAsync", 2, 0.5, 1),
        _op("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 2, 10, 1),
        _span("sonar3d.scan", 6, 95),
        _span("sonar3d.window", 7, 30),
        _span("sonar3d.records", 8, 15),
        *_launch(9, 2, 20, 20),
        _span("sonar3d.apply", 16, 29),
        *_launch(17, 3, 40, 5),
        _span("sonar3d.window", 31, 50),
        _span("sonar3d.records", 32, 35),
        *_launch(33, 4, 45, 5),
        _span("sonar3d.apply", 36, 49),
        *_launch(37, 5, 50, 10),
        _op("cuda_driver", "cuMemcpyDtoHAsync", 60, 0.5, 6),
        _op("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 60, 1, 6),
        # another thread's launch, inside thread 1's first records span
        *_launch(9, 7, 61, 3, tid=2),
    ]
    for i in range(extra_scans):
        events.append(_span("sonar3d.scan", 96 + i, 96.5 + i))
    return events


def _reading(tmp_path, events, name="t.json.gz"):
    path = tmp_path / name
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return run.Reading(trace.Trace(str(path)), {"pings": PINGS, "stats": {}},
                       {"window": KNOB_WINDOW}, None)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_reader_on_a_hand_built_trace(tmp_path, name):
    value = run.metric_reader(name)(_reading(tmp_path, hand_built()))
    assert value == pytest.approx(TOTALS[name], rel=1e-12)


def test_device_time_goes_to_the_launching_span(tmp_path):
    """The kernel launched in window 1's records runs while the host is
    in window 1's apply and window 2's records: it is charged to records;
    the other thread's launch is no span's."""
    from sonarbench import spans

    s = spans.of(_reading(tmp_path, hand_built()).trace)
    owners = {e["name"]: owner for e, owner in s.owned}
    assert owners["k2"] == "sonar3d.records"
    assert owners["k3"] == "sonar3d.apply"
    assert owners["k7"] is None
    # the stats read after the last window: in the scan, in no window
    assert owners["Memcpy DtoH (Device -> Pinned)"] == "sonar3d.scan"
    assert s.device_us_by_span() == {
        "sonar3d.upload": 10.0, "sonar3d.records": 25.0,
        "sonar3d.apply": 15.0, "sonar3d.scan": 1.0, None: 3.0}


def test_replays_count_the_scans_after_the_first(tmp_path):
    value = run.metric_reader("pipeline.replays_per_pass.survey")(
        _reading(tmp_path, hand_built(extra_scans=2)))
    assert value == 2.0


def _dropped_kernel(events):
    # one more launch than kernel events: the profiler dropped a record
    return events + [_op("cuda_runtime", "cudaLaunchKernel", 38, 0.5, 8)]


def _unpartnered(events):
    # a device event whose host call the trace lacks
    return events + [_op("gpu_memset", "Memset (Device)", 62, 1, 99)]


def _no_spans(events):
    # the program without spans
    return [e for e in events if not e["name"].startswith("sonar3d.")]


def _no_card(events):
    # a CPU run: no CUDA call, no device event
    return [e for e in events if e["cat"] == "user_annotation"]


@pytest.mark.parametrize("fault", [_dropped_kernel, _unpartnered, _no_spans,
                                   _no_card])
@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_reader_is_none_where_the_trace_cannot_say(tmp_path, name,
                                                        fault):
    reading = _reading(tmp_path, fault(hand_built()))
    assert run.metric_reader(name)(reading) is None


# -- the readers on a trace recorded on the card -------------------------

@pytest.fixture(scope="module")
def recorded():
    tr = trace.Trace(str(DATA / "spans_trace.json.gz"))
    return run.Reading(tr, {"pings": RECORDED["pings"], "stats": {}},
                       {"window": RECORDED["window"]}, None)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_reader_gives_the_recorded_number(recorded, name):
    value = run.metric_reader(name)(recorded)
    assert value == pytest.approx(RECORDED["metrics"][name]["value"],
                                  rel=1e-12)


def test_recorded_pass_is_charged_to_its_spans(recorded):
    """Every device operation of the card's pass has its host call; the
    spans are one upload, one scan and two windows of one records and
    one apply; records, apply and upload launch nearly all device time."""
    from sonarbench import spans

    s = spans.of(recorded.trace)
    assert s is not None and len(s.owned) == len(
        [e for e in recorded.trace.of(trace.DEVICE_CATS)])
    counts = {n: len(s.named(n)) for n in
              ("upload", "scan", "window", "records", "apply")}
    assert counts == {"upload": 1, "scan": 1, "window": 2, "records": 2,
                      "apply": 2}
    by = s.device_us_by_span()
    main = sum(by.get("sonar3d." + n, 0.0)
               for n in ("records", "apply", "upload"))
    assert main >= 0.9 * sum(by.values())
