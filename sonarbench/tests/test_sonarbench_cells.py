"""Every cell of BENCHMARK.json end to end at a small pool on the CPU:
the driver found by name, a window of one pass, the check against the
reference, and the result line's keys."""

import json

import pytest
import torch

from sonarbench import compare, run
from sonarbench.drivers import survey_leg
from sonarbench.tests.conftest import PASS, POOL, SEED

CELLS = [w["name"] for w in json.load(open(run.ROOT / "BENCHMARK.json"))[
    "workloads"]]


def small_run(name, trace=False, **kw):
    cell = run.Cell(name)
    # JAX's default budgets: the plan sizes a full pass
    kw.setdefault("plan", {})
    return cell, run.run_cell(cell, seed=SEED, seconds=0.0, trace=trace,
                              device=torch.device("cpu"),
                              pool_pings=POOL, pass_pings=PASS, **kw)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_small_on_the_cpu(name):
    cell, (res, lines) = small_run(name)
    assert res["correct"] is True
    assert res["attempted"] == PASS and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "survey_pings_per_s"} <= set(res["metrics"])
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(compare.NUMBERS)
    assert lines[-3:] == [
        f"check {k} = {res['checks'][k]['value']!r} "
        f"(limit {res['checks'][k]['limit']!r})" for k in compare.NUMBERS]


@pytest.mark.parametrize("name", CELLS)
def test_traced_cell_small_on_the_cpu(name):
    cell, (res, _) = small_run(name, trace=True)
    assert res["correct"] is True
    # no card: no kernel, so no reader finds its number
    assert res["metrics"] == {}
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = run.Cell(name)
    assert cell.knobs["window"] == cell.knobs["records_batch"]
    assert set(cell.knobs["limits"]) == set(compare.NUMBERS)
    assert cell.plan["window"] == cell.knobs["window"]
    assert cell.plan["backend"] == survey_leg.BACKEND == "brick"
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in cell.bench["per_layer"]}
    for m in cell.per_layer:
        assert callable(run.metric_reader(m["name"]))


def test_same_seed_same_passes():
    from sonarbench import generator

    spec = run.Cell(CELLS[0]).traffic
    a = generator.make_pool(spec, (500, 512), SEED, "cpu", POOL)
    b = generator.make_pool(spec, (500, 512), SEED, "cpu", POOL)
    assert (a == b).all()
    pa = generator.Passes(spec, a, SEED, PASS)
    pb = generator.Passes(spec, b, SEED, PASS)
    for _ in range(3):
        x, y = pa.next(), pb.next()
        assert (x.offset, x.heading) == (y.offset, y.heading)
    c = generator.make_pool(spec, (500, 512), SEED + 1, "cpu", POOL)
    assert not (a == c).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_cell_small_on_the_card(card, name):
    cell = run.Cell(name)
    res, _ = run.run_cell(cell, seed=SEED, seconds=0.0, trace=True,
                          device=card, plan={}, pool_pings=64, pass_pings=32)
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
