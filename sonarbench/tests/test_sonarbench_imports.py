"""A fresh interpreter that imports each harness module or per-layer
reader, and one that runs a small cell with and without its trace, load
neither JAX nor the JAX package nor the program's root-bench module; the
reference loads no module of the program; and a run that finds one of
them loaded when its result is ready prints no result."""

import json
import subprocess
import sys

import pytest

from sonarbench import run

MODULES = ["sonarbench.run", "sonarbench.generator", "sonarbench.compare",
           "sonarbench.trace", "sonarbench.roofline",
           "sonarbench.reference", "sonarbench.drivers.survey_leg",
           "sonarbench.readings", "sonarbench.make_plan",
           "sonarbench.faults"]

READERS = sorted(m["name"] for m in json.load(
    open(run.ROOT / "BENCHMARK.json"))["per_layer"])

CHECK = """
import json, sys
roots = {m.split(".")[0] for m in sys.modules}
print(json.dumps({"roots": sorted(roots), "mods": sorted(sys.modules)}))
"""


def fresh(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_harness_module_loads_no_jax(module):
    seen = fresh(f"import {module}\n" + CHECK)
    assert not set(seen["roots"]) & set(run.FORBIDDEN_ROOTS)
    assert not set(seen["mods"]) & set(run.FORBIDDEN_MODULES)


@pytest.mark.parametrize("name", READERS)
def test_metric_reader_loads_no_jax(name):
    seen = fresh("from sonarbench import run\n"
                 f"run.metric_reader({name!r})\n" + CHECK)
    assert not set(seen["roots"]) & set(run.FORBIDDEN_ROOTS)
    assert not set(seen["mods"]) & set(run.FORBIDDEN_MODULES)


def test_reference_loads_nothing_of_the_program():
    seen = fresh("import sonarbench.reference\n" + CHECK)
    assert not [m for m in seen["roots"]
                if m.startswith("sonar_3d_reconstruction_tpu")]


@pytest.mark.parametrize("trace", [False, True])
def test_small_run_loads_no_jax(trace):
    seen = fresh(
        "import torch\nfrom sonarbench import run\n"
        "cell = run.Cell('m750d_5cm.survey_replay')\n"
        f"run.run_cell(cell, seed=3, seconds=0.0, trace={trace},"
        " device=torch.device('cpu'), plan={}, pool_pings=8, pass_pings=4)\n"
        + CHECK)
    assert not set(seen["roots"]) & set(run.FORBIDDEN_ROOTS)
    assert not set(seen["mods"]) & set(run.FORBIDDEN_MODULES)


def test_forbidden_names_compare_whole_top_level_names():
    import sonar_3d_reconstruction_tpu_torch  # noqa: F401  the port

    assert "jaxish_for_test" not in sys.modules
    sys.modules["jaxish_for_test"] = sys
    try:
        found = run.forbidden_loaded()
        assert "jaxish_for_test" not in found
        assert "sonar_3d_reconstruction_tpu_torch" not in found
        sys.modules["jax.fake_for_test"] = sys
        assert "jax" in run.forbidden_loaded()
    finally:
        del sys.modules["jaxish_for_test"]
        sys.modules.pop("jax.fake_for_test", None)


def test_no_result_with_a_forbidden_module_loaded(monkeypatch, capsys):
    """``main`` reads ``sys.modules`` once the check and the readers have
    run: a module loaded by then means exit 4 and no result line."""
    import torch

    def run_cell(*a, **kw):
        sys.modules["jax.loaded_by_a_reader"] = sys
        return {"correct": True}, ["a check line"]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", run_cell)
    try:
        rc = run.main(["--workload", "m750d_5cm.survey_replay", "--seed",
                       "1", "--seconds", "1", "--trace", "1"])
    finally:
        sys.modules.pop("jax.loaded_by_a_reader", None)
    out = capsys.readouterr()
    assert rc == 4 and out.out == ""
    assert "jax" in out.err
