"""The port's bench (``sonar_3d_reconstruction_tpu_torch.bench``, ``cli
bench``): its survey against the root bench's, its one JSON line on the
CPU for both backends, the error line on failures and at the deadline,
and ``chip_smoke.py``'s imports.

The CPU runs are cut to a few full-size pings, one timed run; what they
print is checked for its fields and its counts (emissions equal the
pipeline's own count), not for any time.
"""

import ast
import json
import os
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
}
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


@pytest.mark.parametrize("n,seed", [(5, 0), (3, 7)])
def test_make_inputs_is_the_root_bench_survey(n, seed):
    """The port's copy of the survey equals the root bench's, array for
    array (the root bench is read here only to hold the copy to it)."""
    sys.path.insert(0, ROOT)
    try:
        import bench as root_bench
    finally:
        sys.path.remove(ROOT)
    from sonar_3d_reconstruction_tpu.config import MapperConfig as JConfig

    for got, want in zip(bench.make_inputs(MapperConfig(), n, seed),
                         root_bench.make_inputs(JConfig(), n, seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


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
    # no kernel runs on the CPU: the wrapper counts launches only
    assert d["k1_launches"] == 0
    images, positions, quats = bench.make_inputs(MapperConfig(), 2)
    _, stats = pipeline.map_ping_sequence(
        images, positions, quats, MapperConfig(), device="cpu", window=2)
    assert d["updates_per_ping"] == stats["num_candidates"].sum() / 2


def test_bench_hash_on_the_cpu():
    rc, out, err = _bench("--device", "cpu", BENCH_BACKEND="hash",
                          BENCH_LATENCY="0")
    assert rc == 0, err[-2000:]
    assert len(out) == 1
    d = json.loads(out[0])["detail"]
    assert d["backend"] == "hash" and not d["compact_boxes"]
    assert DETAIL_KEYS <= d.keys() and not LATENCY_KEYS & d.keys()


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
