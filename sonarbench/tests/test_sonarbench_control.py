"""The control and the planted faults come out not correct, through a run
with the look for a card skipped, at a small size on the CPU; and a run
without a card, or without the program, prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from sonarbench import compare, faults, readings, run
from sonarbench.tests.conftest import PASS, POOL, SEED

CELLS = [w["name"] for w in json.load(open(run.ROOT / "BENCHMARK.json"))[
    "workloads"]]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_planted_fault_is_not_correct(name, fault):
    cell = run.Cell(name)
    with faults.planted(fault):
        res, _ = run.run_cell(cell, seed=SEED, seconds=0.0, trace=False,
                              device=torch.device("cpu"), plan={},
                              pool_pings=POOL, pass_pings=PASS)
    assert res["correct"] is False
    assert res["failed"] == PASS


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_is_not_correct(name):
    cell = run.Cell(name)
    drv = run.driver_class(cell.traffic["kind"])(
        config=cell.config, traffic=cell.traffic, cell=cell.knobs, plan={},
        seed=SEED, device=torch.device("cpu"), pool_pings=POOL,
        pass_pings=PASS)
    drv.setup()
    drv.window(0.0)
    nums = readings.control_numbers(drv, drv.read_kept(), torch.bfloat16)
    assert not compare.verdict(nums, cell.knobs["limits"])


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "sonarbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "sonarbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "-m", "sonarbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
