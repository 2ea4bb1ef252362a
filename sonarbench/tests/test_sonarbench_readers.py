"""Every per-layer reader on a trace recorded on the card (a 32-ping pass
of ``m750d_5cm.survey_replay`` at window 16, count-sized, NVIDIA H100
80GB HBM3): each gives the number the run that recorded it printed."""

import json
from pathlib import Path

import pytest

from sonarbench import roofline, run, trace

DATA = Path(__file__).parent / "data"
PER_LAYER = [m["name"] for m in json.load(open(run.ROOT / "BENCHMARK.json"))[
    "per_layer"]]


@pytest.fixture(scope="module")
def sample():
    recorded = json.load(open(DATA / "sample_pass.json"))
    tr = trace.Trace(DATA / "sample_trace.json.gz")
    reading = run.Reading(tr, recorded, {"window": recorded["window"]},
                          recorded["peak_bytes"])
    return recorded, tr, reading


@pytest.mark.parametrize("name", PER_LAYER)
def test_reader_gives_the_recorded_number(sample, name):
    recorded, _, reading = sample
    value = run.metric_reader(name)(reading)
    assert value is not None and value > 0
    assert value == pytest.approx(recorded["metrics"][name]["value"],
                                  rel=1e-12)


def test_shares_stay_under_100(sample):
    _, _, reading = sample
    for name in ("k1.roofline_pct.survey", "device.busy_pct.survey"):
        assert 0 < run.metric_reader(name)(reading) <= 100


def test_trace_window_and_breakdown(sample):
    recorded, tr, _ = sample
    assert tr.kernels_complete() and tr.launches() > 0
    assert tr.window_s() == pytest.approx(recorded["window_s"])
    assert tr.busy_s() == pytest.approx(recorded["busy_s"])
    assert 0 < tr.busy_s() <= tr.window_s()
    br = tr.breakdown()
    for key in ("device_ops", "idle_gaps"):
        assert 0 < len(br[key]) <= 10
        secs = [s for _, s in br[key]]
        assert secs == sorted(secs, reverse=True)
    # the idle gaps and the busy time tile the window
    gaps = tr.breakdown(top=10 ** 6)["idle_gaps"]
    assert sum(s for _, s in gaps) + tr.busy_s() == pytest.approx(
        tr.window_s(), rel=1e-6)


def test_host_waits_count_a_read_once():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.ANNOTATION,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 5, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 6, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpy",
         "ts": 8, "dur": 1},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 2, "dur": 3},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 4, "dur": 4},
    ]
    tr = trace.Trace.__new__(trace.Trace)
    tr.events, tr.window = events, (0.0, 100.0)
    assert tr.host_waits() == 2
    assert tr.busy(("kernel",)) == [(2.0, 8.0)]
    assert trace.busy_share_pct(tr) == pytest.approx(6.0)


def test_k1_bytes_are_chip_smokes():
    torch = pytest.importorskip("torch")
    import chip_smoke

    nb, lanes = 37, 1234
    args = (torch.zeros(lanes, dtype=torch.int64),
            torch.zeros(lanes, dtype=torch.int64),
            torch.zeros(nb + 1, dtype=torch.int64),
            torch.zeros(nb, 64, dtype=torch.float32))
    assert roofline.k1_bytes(nb, lanes) == chip_smoke.k1_bytes(
        args, False, 16)[0]
