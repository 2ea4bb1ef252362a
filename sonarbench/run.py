"""Run one cell of the benchmark once.

    python3 -m sonarbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program.  Everything a cell
needs is found by name from ``BENCHMARK.json``: the configuration's file
(``configs/``), the traffic file (``traffic/<mix>.json``, whose ``kind``
names its driver, ``drivers/<kind>.py``), the cell's own file
(``cells/<cell>.json``: the entry's knobs and the correctness limits)
with its budget plan (``plans/<cell>.json``), and one reader a per-layer
metric (``metrics/<metric>.py``).

A run: set-up (imports, the CUDA context, the traffic driver's inputs, tables,
plan and warm pass; ``setup_s`` ends here), the measured window of
``--seconds``, then, with the window closed and its memory peak read, the
check of one pass of the window against the plain reference.  With
``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` the window's first pass is traced and the result carries
the per-layer metrics, the device's busy and window seconds and a
breakdown.  The last line on standard output is the result's JSON; the
last lines on standard error are each compared number beside its limit.

The run exits 3 with no result where PyTorch sees no CUDA card or fewer
than the cell asks for, and 4 with no result where ``jax``, ``jaxlib``,
``flax``, the JAX package or the program's root-bench module is loaded
when the result is ready: after the window, the check and the per-layer
readers.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_PATH = ROOT / "build" / "sonarbench" / "trace.json"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "sonar_3d_reconstruction_tpu")
FORBIDDEN_MODULES = ("sonar_3d_reconstruction_tpu_torch.bench",)


def forbidden_loaded() -> List[str]:
    """Loaded modules the benchmark must not load, by whole top-level
    name (and the program's root-bench module by its full name)."""
    roots = {name.split(".")[0] for name in list(sys.modules)}
    return (sorted(roots & set(FORBIDDEN_ROOTS))
            + [m for m in FORBIDDEN_MODULES if m in sys.modules])


class Cell:
    """One entry of ``workloads`` and everything found by its names."""

    def __init__(self, name: str, root: Path = ROOT):
        with open(root / "BENCHMARK.json") as f:
            self.bench = json.load(f)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; the benchmark has "
                             f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        conf = {c["name"]: c for c in self.bench["configs"]}[
            self.entry["config"]]
        self.config = _json(root / conf["file"])
        self.traffic = _json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.knobs = _json(HERE / "cells" / f"{name}.json")
        plan = self.knobs.get("plan")
        self.plan = None if plan is None else _json(
            HERE / "plans" / f"{plan}.json")["budgets"]
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in self.bench["per_layer"]
                          if name in m["workloads"]]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def driver_class(kind: str):
    module = importlib.import_module(f"sonarbench.drivers.{kind}")
    return module.DRIVER


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "sonarbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Reading:
    """What a per-layer reader reads: the trace of the traced pass, that
    pass's pings and per-ping stats, the cell's knobs and the window's
    device memory peak (None off the card)."""

    def __init__(self, trace, traced: Dict, knobs: Dict,
                 peak_bytes: Optional[int]):
        self.trace = trace
        self.pings = traced["pings"]
        self.stats = traced["stats"]
        self.knobs = knobs
        self.peak_bytes = peak_bytes


def card(device) -> Dict:
    """The card's name and power limit (nvidia-smi; None if it cannot
    say)."""
    import torch

    if device.type != "cuda":
        return {"kind": "cpu", "power_limit": None}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"kind": torch.cuda.get_device_name(device), "power_limit": limit}


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, **overrides):
    """One run of ``cell`` on ``device`` -> (result dict, check lines).
    ``overrides`` go to the driver (the tests' small pools)."""
    import torch

    from sonarbench import compare
    from sonarbench import trace as tracing

    on_card = device.type == "cuda"
    drv = driver_class(cell.traffic["kind"])(
        config=cell.config, traffic=cell.traffic, cell=cell.knobs,
        plan=overrides.pop("plan", cell.plan), seed=seed, device=device,
        **overrides)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    peak = 0
    if on_card:
        peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    trace_path = None
    if trace:
        TRACE_PATH.parent.mkdir(parents=True, exist_ok=True)
        trace_path = str(TRACE_PATH)
    win = drv.window(seconds, trace_path)
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else None
    peak = max(peak, window_peak or 0)
    kept = drv.read_kept()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    nums = drv.check(kept)
    check_s = time.perf_counter() - t_check
    limits = cell.knobs["limits"]
    correct = compare.verdict(nums, limits)

    info = card(device)
    result = {
        "correct": correct,
        "attempted": win["pings"],
        "failed": 0 if correct else len(kept[0].images),
        "metrics": {},
        "device": {"platform": "gpu" if on_card else device.type,
                   "kind": info["kind"], "count": cell.entry["chips"],
                   "memory_peak_bytes": peak,
                   "power_limit": info["power_limit"]},
    }
    units = {m["name"]: m["unit"]
             for m in cell.bench["end_to_end"] + cell.bench["per_layer"]}
    if not trace:
        values = dict(win["end_to_end"], setup_s=setup_s)
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    else:
        tr = tracing.Trace(trace_path)
        reading = Reading(tr, win["traced"], cell.knobs, window_peak)
        for m in cell.per_layer:
            value = metric_reader(m["name"])(reading)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": units[m["name"]]}
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s())
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": nums[k], "limit": limits.get(k)}
                        for k in compare.NUMBERS}
    walls = sorted(w for w, _ in win["pass_walls"])
    lines = [
        f"cell {cell.name} seed {seed}: {win['passes']} passes, "
        f"{win['pings']} pings in {win['wall_s']:.3f} s (a pass "
        f"{walls[0]:.3f} / {walls[len(walls) // 2]:.3f} / {walls[-1]:.3f} s "
        f"least / median / most), set-up {setup_s:.3f} s, check "
        f"{check_s:.3f} s, plan replays {drv.replays}, card {info['kind']} "
        f"at {info['power_limit']}",
        "passes (s at heading deg): " + " ".join(
            f"{w:.3f}@{math.degrees(h):.0f}" for w, h in win["pass_walls"]),
    ] + [f"check {k} = {nums[k]!r} (limit {limits.get(k)!r})"
         for k in compare.NUMBERS]
    return result, lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = Cell(args.workload)

    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"sonarbench: the cell needs {chips} CUDA card(s); PyTorch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, lines = run_cell(cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace),
                             device=torch.device("cuda", 0))
    # after the check and the per-layer readers, which run past the window
    found = forbidden_loaded()
    if found:
        print(f"sonarbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
