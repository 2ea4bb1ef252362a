"""The port's golden oracle (``sonar_3d_reconstruction_tpu_torch.golden``)
against the JAX package's (``sonar_3d_reconstruction_tpu.golden``), and the
port's fuzz draws (``scripts/torch_fuzz_golden.py``) against
``scripts/fuzz_golden.py``'s.

Both oracles take the same pings (numpy seeds): the small test config, the
two production presets at test-size images, and fuzz trials.  Tolerance:
none.  The port's oracle is a copy, so its log-odds, per-ping stats and
emission counts, bounds, point cloud and classified cloud must be
bit-equal to the JAX oracle's.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

from sonar_3d_reconstruction_tpu.config import PRESETS as J_PRESETS
from sonar_3d_reconstruction_tpu.golden import GoldenMapper as JGoldenMapper

from sonar_3d_reconstruction_tpu_torch.config import PRESETS
from sonar_3d_reconstruction_tpu_torch.golden import GoldenMapper

from conftest import circular_trajectory, synthetic_ping
from torch_parity import port_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import fuzz_golden as j_fuzz  # noqa: E402
import torch_fuzz_golden as t_fuzz  # noqa: E402

# fuzz seeds held in both oracles and both drawers: JAX's pinned three and
# trials with the z filter on (0, 8, 11, 12, 31), the adaptive update off
# (11, 34), a 9.4 cm voxel (31) and a 32-bearing image (34)
FUZZ_SEEDS = [1002, 2016, 2048, 0, 8, 11, 12, 31, 34]


def preset_pass(name, n=4):
    """The JAX preset test's pass (tests/test_integration.py:167): a
    test-size image, straight at 4 m depth, shallow enough that the
    preset's z filter clips part of the fan."""
    cfg = J_PRESETS[name].replace(image_width=64, image_height=80)
    images = np.stack([synthetic_ping(80, 64, seed=700 + i) for i in range(n)])
    positions = np.stack([0.2 * np.arange(n), np.zeros(n), np.full(n, -4.0)],
                         axis=-1)
    return cfg, images, positions, np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))


def j_draw(seed):
    """scripts/fuzz_golden.run_trial(seed)'s trial: (JAX config, images,
    positions, quaternions), in its order of draws."""
    rng = np.random.default_rng(seed)
    cfg = j_fuzz.random_config(rng)
    n = int(rng.integers(2, 5))
    return (cfg, *j_fuzz.random_pings(cfg, n, rng))


def assert_clouds_equal(got, want):
    for k in ("num_voxels", "num_occupied"):
        assert got[k] == want[k], k
    for k in ("points", "probabilities"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def assert_oracles_agree(j_cfg, images, positions, quats):
    """The port's oracle and JAX's over the same pings, bit for bit."""
    j, t = JGoldenMapper(j_cfg), GoldenMapper(port_cfg(j_cfg))
    for ping in zip(images, positions, quats):
        assert t.process_ping(*ping) == j.process_ping(*ping)
        assert t.last_frame_counts == j.last_frame_counts
    assert t.map.log_odds == j.map.log_odds
    assert len(t.map.log_odds) > 0
    np.testing.assert_array_equal(t.map.min_bounds, j.map.min_bounds)
    np.testing.assert_array_equal(t.map.max_bounds, j.map.max_bounds)
    assert_clouds_equal(t.point_cloud(), j.point_cloud())
    got, want = t.point_cloud(include_free=True), j.point_cloud(include_free=True)
    assert got["num_voxels"] == want["num_voxels"]
    for k in ("occupied", "free", "unknown"):
        assert len(got[k]) == len(want[k]), k
        for (p, q), (wp, wq) in zip(got[k], want[k]):
            np.testing.assert_array_equal(p, wp)
            assert q == wq
    for a, b in zip(got["bounds"], want["bounds"]):
        np.testing.assert_array_equal(a, b)
    return t


def test_small_config(small_cfg):
    n = 6
    images = np.stack([synthetic_ping(100, 64, seed=40 + i) for i in range(n)])
    positions, quats = circular_trajectory(n, radius=0.6)
    assert_oracles_agree(small_cfg, images, positions, quats)


@pytest.mark.parametrize("name", ["kiro_tilt60", "kiro_tilt90"])
def test_production_presets(name):
    cfg, images, positions, quats = preset_pass(name)
    assert dataclasses.asdict(PRESETS[name]) == dataclasses.asdict(J_PRESETS[name])
    assert_oracles_agree(cfg, images, positions, quats)


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_trials(seed):
    """The port's oracle on a fuzz trial equals JAX's, and the port's
    ``golden_of`` (the fuzz's cached oracle) holds the same map."""
    g = assert_oracles_agree(*j_draw(seed))
    assert t_fuzz.golden_of(seed).log_odds == g.map.log_odds


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_draws_match_jax_script(seed):
    """``draw_trial(seed)`` is what scripts/fuzz_golden.run_trial(seed)
    draws: its config, ping count and pings, in its order of draws."""
    j_cfg, images, positions, quats = j_draw(seed)
    t = t_fuzz.draw_trial(seed)
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j_cfg)
    assert t.n == len(images)
    np.testing.assert_array_equal(t.images, images)
    np.testing.assert_array_equal(t.positions, positions)
    np.testing.assert_array_equal(t.quats, quats)
    # the two drawers also agree draw for draw past the trial
    r1, r2 = np.random.default_rng(seed + 1), np.random.default_rng(seed + 1)
    assert (dataclasses.asdict(t_fuzz.random_config(r1))
            == dataclasses.asdict(j_fuzz.random_config(r2)))
    for a, b in zip(t_fuzz.random_pings(t.cfg, 3, r1),
                    j_fuzz.random_pings(j_cfg, 3, r2)):
        np.testing.assert_array_equal(a, b)
