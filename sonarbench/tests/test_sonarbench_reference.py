"""The plain reference against the program at a small size on the CPU:
in float64 the program and the reference agree exactly (voxels, every
ping's stats, log-odds); the program's float32 pass is within the cell's
limits."""

import json

import numpy as np
import pytest
import torch

from sonarbench import compare, generator, reference, run
from sonarbench.tests.conftest import PASS, POOL, SEED

CONFIGS = [c["name"] for c in json.load(open(run.ROOT / "BENCHMARK.json"))[
    "configs"]]


def one_pass(name, seed=SEED):
    cell = run.Cell(f"{name}.survey_replay")
    m = cell.config["mapper"]
    pool = generator.make_pool(cell.traffic, (m["image_height"],
                                              m["image_width"]),
                               seed, "cpu", POOL)
    return cell, generator.Passes(cell.traffic, pool, seed, PASS).next()


def program(cell, p, dtype):
    from sonar_3d_reconstruction_tpu_torch.config import config_from_dict
    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        touched_voxels_brick,
    )
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    state, stats = map_ping_sequence(
        p.images, p.positions, p.quats,
        config_from_dict(cell.config["mapper"]), device="cpu", dtype=dtype,
        window=4, records_batch=4, budgets={})
    keys, lo = touched_voxels_brick(state)
    return stats, keys, lo


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_the_program_in_float64(name):
    cell, p = one_pass(name)
    stats, keys, lo = program(cell, p, torch.float64)
    ref = reference.map_pass(p.images, p.positions, p.quats,
                             cell.config["mapper"], "cpu", torch.float64,
                             block=3)
    for k in compare.STATS:
        np.testing.assert_array_equal(stats[k], ref[k])
    codes = reference.pack_keys(keys)
    order = torch.argsort(codes)
    assert torch.equal(codes[order], ref["codes"])
    gap = (torch.as_tensor(lo)[order] - ref["log_odds"]).abs().max()
    assert float(gap) <= 1e-9
    assert compare.numbers(stats, keys, lo, ref) == {
        "stats_gap": 0.0, "keys_gap_ppm": 0.0, "logodds_gap_ppm": 0.0}


@pytest.mark.parametrize("name", CONFIGS)
def test_float32_program_within_the_cells_limits(name):
    cell, p = one_pass(name)
    stats, keys, lo = program(cell, p, torch.float32)
    ref = reference.map_pass(p.images, p.positions, p.quats,
                             cell.config["mapper"], "cpu", torch.float64)
    assert compare.verdict(compare.numbers(stats, keys, lo, ref),
                           cell.knobs["limits"])


def test_pack_round_trip_and_range():
    keys = torch.tensor([[0, 0, 0], [-5, 7, -32768 + 1], [32767, -1, 3]])
    assert torch.equal(reference.unpack(reference.pack_keys(keys)), keys)
    with pytest.raises(ValueError):
        reference.pack_keys(torch.tensor([[1 << 15, 0, 0]]))


def test_pose_chain_is_the_reference_mappers():
    # mount pitched 90 deg, body yawed 90 deg: sonar +X (forward) points
    # down, body +X points along world +Y
    m = {"sonar_orientation": [0.0, np.pi / 2, 0.0],
         "sonar_position": [0.0, 0.0, -0.5]}
    q = np.array([[0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)]])
    T = reference.sonar_to_world(np.array([[1.0, 2.0, 3.0]]), q, m)[0]
    np.testing.assert_allclose(T @ [1, 0, 0, 1], [1, 2, 1.5, 1], atol=1e-12)
