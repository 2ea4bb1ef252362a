"""The port's bench (``sonar_3d_reconstruction_tpu_torch.bench``, ``cli
bench``): its survey, plan key and caps against the root bench's, the
plan's bypass, writing, hit and rediscovery, its one JSON line on the CPU
for both backends (budgeted and count-sized), the error line on failures
and at the deadline, the bench's trace (``scripts/torch_profile_bench.py``)
and ``chip_smoke.py``'s imports.

The CPU runs are cut to a few full-size pings, one timed run; what they
print is checked for its fields and its counts (emissions equal the
pipeline's own count), not for any time.
"""

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sonar_3d_reconstruction_tpu_torch import bench, pipeline  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.config import MapperConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DETAIL_KEYS = {
    "pings_per_sec", "mean_ping_latency_ms", "updates_per_ping",
    "unique_voxel_updates_per_sec", "n_pings", "window", "dense_mode",
    "records_batch", "window_group", "compact_boxes", "device",
    "device_name", "power_limit", "peak_memory_mb", "memory_sparse_mb",
    "memory_dense_equiv_mb", "memory_ratio_vs_dense", "k1_launches",
    "k1_raw_launches", "count_sized", "fan_cap", "budget_plan",
}
BRICK_BUDGETS = ("unique_budget", "brick_budget", "lane_budget",
                 "insert_budget", "vox_budget", "dedup_lane_budget")
HASH_BUDGETS = ("unique_budget", "batch_budget", "lane_budget",
                "insert_budget", "dedup_lane_budget")
DEFAULT_KEY = "1438faf2624389f9"  # the root bench's default capture key
LATENCY_KEYS = {"p50_ping_to_map_ms", "p95_ping_to_map_ms"}
# two full-size pings, one timed run, one torch thread a process
CPU_ENV = {"BENCH_PINGS": "2", "BENCH_REPS": "1", "OMP_NUM_THREADS": "1"}


def _bench(*args, **env):
    """Run ``python -m sonar_3d_reconstruction_tpu_torch bench`` in a
    subprocess; (exit code, stdout lines, stderr)."""
    proc = subprocess.run(
        [sys.executable, "-m", "sonar_3d_reconstruction_tpu_torch", "bench",
         *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **CPU_ENV, **env),
    )
    return proc.returncode, proc.stdout.splitlines(), proc.stderr


def _root_bench():
    """The root bench.py, read here only to hold the port's copies to it
    (its top imports nothing but the standard library)."""
    sys.path.insert(0, ROOT)
    try:
        import bench as root_bench
    finally:
        sys.path.remove(ROOT)
    return root_bench


def _bench_with_plan_path(plan_path, *args, **env):
    """The bench in a subprocess whose ``bench.PLAN_PATH`` is
    ``plan_path``; (exit code, stdout lines, stderr)."""
    code = ("import sys\n"
            "from sonar_3d_reconstruction_tpu_torch import bench\n"
            f"bench.PLAN_PATH = {str(plan_path)!r}\n"
            f"sys.exit(bench.main({['--device', 'cpu', *args]!r}))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, **CPU_ENV, BENCH_LATENCY="0", **env),
    )
    return proc.returncode, proc.stdout.splitlines(), proc.stderr


@pytest.fixture(scope="module")
def two_ping_updates():
    """The pipeline's own emissions a ping over the bench's 2-ping survey."""
    images, positions, quats = bench.make_inputs(MapperConfig(), 2)
    _, stats = pipeline.map_ping_sequence(
        images, positions, quats, MapperConfig(), device="cpu", window=2)
    return stats["num_candidates"].sum() / 2


@pytest.mark.parametrize("n,seed", [(5, 0), (3, 7)])
def test_make_inputs_is_the_root_bench_survey(n, seed):
    """The port's copy of the survey equals the root bench's, array for
    array (the root bench is read here only to hold the copy to it)."""
    root_bench = _root_bench()
    from sonar_3d_reconstruction_tpu.config import MapperConfig as JConfig

    for got, want in zip(bench.make_inputs(MapperConfig(), n, seed),
                         root_bench.make_inputs(JConfig(), n, seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", [8, 16])
@pytest.mark.parametrize("dense_mode",
                         ["pallas-tb16", "pallas", "pallas-raw", "scalar"])
@pytest.mark.parametrize("backend", ["brick", "hash"])
def test_plan_key_is_the_root_bench_key(backend, dense_mode, window):
    from sonar_3d_reconstruction_tpu.config import MapperConfig as JConfig

    args = (256, window, backend, dense_mode, (10, 40, 189), 1 << 16, 0)
    assert (bench._plan_key(MapperConfig(), *args)
            == _root_bench()._plan_key(JConfig(), *args))


def test_survey_caps_and_default_plan_entry():
    """The 256-ping survey's caps are the JAX package's, (10, 40, 189);
    with the bench's defaults they key ``DEFAULT_KEY``, which
    ``bench_plan.json`` holds."""
    from sonar_3d_reconstruction_tpu.config import MapperConfig as JConfig
    from sonar_3d_reconstruction_tpu.ops import backproject as jbp

    cfg = MapperConfig()
    images, _, _ = bench.make_inputs(cfg, 256)
    caps = bench.survey_caps(images, cfg)
    want = tuple(need(images, JConfig(), 500) for need in (
        jbp.required_fan_cap, jbp.required_window_cap,
        jbp.required_free_cap))
    assert caps == want == (10, 40, 189)
    key = bench._plan_key(cfg, 256, bench.DEFAULT_WINDOW, "brick",
                          bench.DEFAULT_DENSE_MODE, caps,
                          bench.DEFAULT_BRICK_CAPACITY, 0)
    assert key == DEFAULT_KEY
    assert bench._load_plan(key, {})["brick_budget"] == 9216


def test_capture_tables_are_the_pipelines():
    """The capture's fan tables, built from the survey's caps, equal the
    ones ``map_ping_sequence`` builds for the same images."""
    from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
        tables_for_images,
    )

    cap = bench.Capture(bench._Run(60.0), torch.device("cpu"),
                        dict(CPU_ENV, BENCH_LATENCY="0"))
    want = tables_for_images(cap.images, cap.cfg)
    for field in dataclasses.fields(want):
        a, b = getattr(cap.tables, field.name), getattr(want, field.name)
        np.testing.assert_array_equal(a, b, err_msg=field.name)


@pytest.mark.parametrize("env,hit", [
    ({}, True),
    ({"BENCH_USE_PLAN": "0"}, False),
    ({"BENCH_BRICK_BUDGET": "4096"}, False),
    ({"BENCH_UNIQUE_BUDGET": "4096"}, False),
    ({"BENCH_TUNE_BUDGETS": "0"}, False),
])
def test_explicit_knobs_bypass_the_plan(env, hit):
    """Each explicit experiment knob is consumed by the discovery path and
    is not part of the key, so it bypasses the plan."""
    assert (bench._load_plan(DEFAULT_KEY, env) is not None) == hit


@pytest.fixture(scope="module")
def written_plan(tmp_path_factory):
    """A copy of bench_plan.json that a 2-ping run with BENCH_WRITE_PLAN=1
    wrote its discovered entry into; (path, that run's detail)."""
    path = tmp_path_factory.mktemp("plan") / "bench_plan.json"
    shutil.copy(os.path.join(ROOT, "bench_plan.json"), path)
    rc, out, err = _bench_with_plan_path(path, BENCH_WRITE_PLAN="1")
    assert rc == 0 and len(out) == 1, err[-2000:]
    return path, json.loads(out[0])["detail"]


def test_write_plan_writes_the_discovered_entry(written_plan,
                                                two_ping_updates):
    path, d = written_plan
    with open(os.path.join(ROOT, "bench_plan.json")) as f:
        committed = json.load(f)
    with open(path) as f:
        plans = json.load(f)
    assert d["budget_plan"] == "discovered" and d["plan_key"] not in committed
    assert {k: plans[k] for k in committed} == committed
    entry = plans[d["plan_key"]]
    assert {k: entry[k] for k in BRICK_BUDGETS} == {k: d[k]
                                                    for k in BRICK_BUDGETS}
    assert entry["capacity"] == d["capacity_bricks"]
    assert entry["safe_unique_budget"] >= entry["unique_budget"] > 0
    assert d["updates_per_ping"] == two_ping_updates


def test_written_plan_is_a_hit(written_plan, two_ping_updates):
    """A second run finds the entry: ``"hit"``, the same budgets."""
    path, first = written_plan
    rc, out, err = _bench_with_plan_path(path)
    assert rc == 0 and len(out) == 1, err[-2000:]
    d = json.loads(out[0])["detail"]
    assert d["budget_plan"] == "hit"
    assert {k: d[k] for k in BRICK_BUDGETS} == {k: first[k]
                                                for k in BRICK_BUDGETS}
    assert d["updates_per_ping"] == two_ping_updates


def test_stale_plan_rediscovers(written_plan, tmp_path, two_ping_updates):
    """An entry with a quarter of every budget overflows its first scan:
    the run rediscovers the budgets and reports ``"discovered"``."""
    src, first = written_plan
    with open(src) as f:
        plans = json.load(f)
    entry = plans[first["plan_key"]]
    for k in BRICK_BUDGETS:
        v = entry[k]
        if v:
            entry[k] = [x // 4 for x in v] if isinstance(v, list) else v // 4
    path = tmp_path / "bench_plan.json"
    with open(path, "w") as f:
        json.dump(plans, f)
    rc, out, err = _bench_with_plan_path(path)
    assert rc == 0 and len(out) == 1, err[-2000:]
    d = json.loads(out[0])["detail"]
    assert d["budget_plan"] == "discovered"
    assert {k: d[k] for k in BRICK_BUDGETS} == {k: first[k]
                                                for k in BRICK_BUDGETS}
    assert d["updates_per_ping"] == two_ping_updates


def test_bench_brick_on_the_cpu():
    """The brick path with batched records and the latency stage: one JSON
    line with the metric, the detail fields and the latency percentiles;
    the emissions it reports are the pipeline's own count."""
    rc, out, err = _bench("--device", "cpu", BENCH_RECORDS_BATCH="2",
                          BENCH_WINDOW_GROUP="2", BENCH_LATENCY_PINGS="2",
                          BENCH_DENSE_MODE="pallas-raw")
    assert rc == 0, err[-2000:]
    assert len(out) == 1
    got = json.loads(out[0])
    assert got["metric"] == "voxel_log_odds_updates_per_sec"
    assert got["unit"] == "updates/s" and got["value"] > 0
    assert got["vs_baseline"] == pytest.approx(got["value"] / 1e9)
    d = got["detail"]
    assert DETAIL_KEYS | LATENCY_KEYS <= d.keys()
    assert (d["device"], d["device_name"], d["peak_memory_mb"]) == (
        "cpu", "cpu", None)
    assert (d["n_pings"], d["window"], d["dense_mode"]) == (2, 2, "pallas-raw")
    assert (d["records_batch"], d["window_group"]) == (2, 2)
    assert d["compact_boxes"] and d["latency_chunk"] == 1
    # no plan for 2 pings: discovered from the raw warm-up
    assert d["budget_plan"] == "discovered" and not d["count_sized"]
    assert set(BRICK_BUDGETS) <= d.keys() and d["unique_budget"] > 0
    assert d["capacity_bricks"] == bench.DEFAULT_BRICK_CAPACITY
    # no kernel runs on the CPU: the wrapper counts launches only
    assert d["k1_launches"] == d["k1_raw_launches"] == 0
    images, positions, quats = bench.make_inputs(MapperConfig(), 2)
    _, stats = pipeline.map_ping_sequence(
        images, positions, quats, MapperConfig(), device="cpu", window=2)
    assert d["updates_per_ping"] == stats["num_candidates"].sum() / 2


def test_bench_hash_on_the_cpu(two_ping_updates):
    """The hash path discovers snug budgets from its warm-up (no plan) and
    reports them; the emissions are the pipeline's own count."""
    rc, out, err = _bench("--device", "cpu", BENCH_BACKEND="hash",
                          BENCH_LATENCY="0")
    assert rc == 0, err[-2000:]
    assert len(out) == 1
    d = json.loads(out[0])["detail"]
    assert d["backend"] == "hash" and not d["compact_boxes"]
    assert DETAIL_KEYS <= d.keys() and not LATENCY_KEYS & d.keys()
    assert d["budget_plan"] == "discovered" and not d["count_sized"]
    assert d["capacity"] == bench.DEFAULT_HASH_CAPACITY
    assert all(isinstance(d[k], int) and d[k] > 0 for k in HASH_BUDGETS
               if k != "insert_budget")
    assert len(d["insert_budget"]) == 2
    assert d["updates_per_ping"] == two_ping_updates


@pytest.mark.parametrize("backend", ["brick", "hash"])
def test_count_sized_bench_reports_no_budgets(backend, two_ping_updates):
    """``BENCH_COUNT_SIZED=1`` times the count-sized scan: no budget, no
    plan, the same emissions."""
    rc, out, err = _bench("--device", "cpu", BENCH_BACKEND=backend,
                          BENCH_COUNT_SIZED="1", BENCH_LATENCY="0")
    assert rc == 0 and len(out) == 1, err[-2000:]
    d = json.loads(out[0])["detail"]
    budgets = BRICK_BUDGETS if backend == "brick" else HASH_BUDGETS
    assert d["count_sized"] and d["budget_plan"] is None
    assert all(d[k] is None for k in budgets)
    assert d["updates_per_ping"] == two_ping_updates


@pytest.mark.parametrize("env,match", [
    # the JAX spellings ("pallas-tb16", the root bench's default) are
    # accepted; raw records on an XLA layout are not
    ({"BENCH_DENSE_MODE": "bfv-raw"}, "pallas-raw"),
    ({"BENCH_BACKEND": "hash", "BENCH_RECORDS_BATCH": "4"}, "records_batch"),
    ({"BENCH_BACKEND": "octree"}, "brick or hash"),
    ({"BENCH_PINGS": "0"}, "positive"),
])
def test_bench_failure_prints_the_error_line(capsys, env, match):
    """A failing run prints one parseable error line and returns 1."""
    assert bench.main(["--device", "cpu"], env=dict(CPU_ENV, **env)) == 1
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    got = json.loads(out[0])
    assert got["value"] == 0.0 and match in got["error"]
    assert got["metric"] == "voxel_log_odds_updates_per_sec" and got["stage"]


def test_bench_needs_the_card_unless_told():
    """With no CUDA device visible and no --device, the command prints the
    error line and exits 1: it never falls back to the CPU."""
    rc, out, _ = _bench(CUDA_VISIBLE_DEVICES="")
    assert rc == 1 and len(out) == 1
    got = json.loads(out[0])
    assert "CUDA is not available" in got["error"]
    assert got["stage"] == "device"


def test_bench_deadline_prints_a_line_and_exits_3():
    rc, out, _ = _bench("--device", "cpu", BENCH_DEADLINE="0.01")
    assert rc == 3 and len(out) == 1
    assert "deadline" in json.loads(out[0])["error"]


def test_profile_bench_script_on_the_cpu(tmp_path):
    """``scripts/torch_profile_bench.py --device cpu``: the capture's
    budgets and a trace in ``--out``; its last line is one JSON object, and
    with no kernel in a CPU trace the busy share is null with its note."""
    proc = subprocess.run(
        [sys.executable, os.path.join("scripts", "torch_profile_bench.py"),
         "--device", "cpu", "--out", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **CPU_ENV),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.splitlines()[-1])
    assert (got["device"], got["n_pings"], got["budget_plan"]) == (
        "cpu", 2, "discovered")
    assert got["wall_ms"] > 0 and got["traced_wall_ms"] > 0
    assert got["kernel_launches"] == got["kernels_recorded"] == 0
    assert got["busy_share"] is None and "no kernel" in got["busy_share_note"]
    assert os.path.exists(os.path.join(ROOT, got["trace"]))
    assert set(BRICK_BUDGETS) <= got.keys()


def _trace_module():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import torch_profile_bench
    finally:
        sys.path.pop(0)
    return torch_profile_bench


def _event(cat, name, ts, dur, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid}


@pytest.mark.parametrize("dropped", [False, True])
def test_trace_summary(dropped):
    """The trace reader: the busy time is the union of the kernel
    intervals (overlaps counted once), launches and syncs are the host's
    runtime calls, and a trace with fewer kernels than launches gives no
    busy share."""
    tp = _trace_module()
    events = [
        _event("cuda_runtime", "cudaLaunchKernel", 0, 1),
        _event("cuda_runtime", "cudaLaunchKernel", 1, 1),
        _event("cuda_runtime", "cudaLaunchKernel", 2, 1),
        _event("cuda_runtime", "cudaStreamSynchronize", 3, 20),
        _event("cuda_runtime", "cudaMemcpyAsync", 4, 1),
        _event("gpu_memcpy", "Memcpy DtoH", 20, 2),
        _event("kernel", "k_a", 5, 4),
        _event("kernel", "k_b", 7, 4, tid=8),   # overlaps k_a: 5-11 busy
    ]
    if not dropped:
        events.append(_event("kernel", "k_a", 15, 3))
    got = tp.summarize(events, wall_s=40e-6, traced_wall_s=80e-6,
                       n_pings=3, top=5)
    assert (got["kernel_launches"], got["syncs_per_run"]) == (3, 1)
    assert got["launches_per_ping"] == 1.0 and got["copy_ms"] == 2e-3
    if dropped:
        assert got["busy_share"] is None
        assert "dropped" in got["busy_share_note"]
        assert got["kernel_busy_ms"] == pytest.approx(6e-3)
    else:
        assert got["kernel_busy_ms"] == pytest.approx(9e-3)
        assert got["busy_share"] == pytest.approx(9 / 40)
        assert got["busy_share_traced"] == pytest.approx(9 / 80)
        assert [k["name"] for k in got["top_kernels"]] == ["k_a", "k_b"]
        assert got["top_kernels"][0]["launches"] == 2
    lines = tp.stream_lines(events)
    assert [(n, busy) for _, n, busy, _ in lines] == (
        [(1, 4.0), (1, 4.0)] if dropped else [(2, 7.0), (1, 4.0)])


def test_chip_smoke_imports_neither_jax_package_nor_root_bench():
    """chip_smoke.py imports nothing from the root bench.py, the JAX
    package or jax (names of JAX files in its strings are not imports)."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
    roots = {name.split(".")[0] for name in imported}
    assert "sonar_3d_reconstruction_tpu_torch" in roots
    assert not roots & {"bench", "sonar_3d_reconstruction_tpu", "jax",
                        "jaxlib"}, sorted(imported)
