"""Long-horizon full-size float32 parity of the port (the port's
counterparts of tests/test_longhorizon.py:57 and :118), on the brick map.

Two effects can break float32 parity and are held apart, as in the JAX
tests: accumulation drift in the adaptive, clamped log-odds chain (the
1e-5 bar), and geometry flips, where float32 backprojection floors a
candidate lying within ~1 ulp of a voxel boundary into the neighbour
(discrete events, held to a rate).

Bars (the JAX tests'): probabilities within 1e-5 on every voxel of a map
of more than 500,000 voxels; the key-set symmetric difference and the
share of common voxels over 1e-5 each under 2e-3 of the common voxels,
and their 99.5th percentile within 1e-5.
"""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

from sonar_3d_reconstruction_tpu_torch.bench import make_inputs  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.config import MapperConfig  # noqa: E402

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "scripts")
)

import torch_fuzz_golden as fuzz  # noqa: E402

N_PINGS = 200


@pytest.mark.slow
def test_f32_accumulation_parity_200_fullsize_pings():
    """float32 records applied into a float32 and a float64 brick map stay
    within 1e-5 of each other over 200 full-size pings."""
    cfg = MapperConfig()  # full 500x512, 5 cm voxels
    images, positions, quats = make_inputs(cfg, N_PINGS, seed=1)
    got = fuzz.accumulation_drift(images, positions, quats, cfg, "cpu")
    assert got["voxels"] > fuzz.LONG_MIN_VOXELS
    assert got["max_diff"] <= fuzz.LONG_PROB_TOL, got


@pytest.mark.slow
def test_f32_geometry_flip_rate_is_rare():
    """Pure float32 against pure float64 geometry: flips stay rare and the
    bulk of the map meets the bar outright."""
    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, 64, seed=2)
    got = fuzz.geometry_flips(images, positions, quats, cfg, "cpu")
    common = max(1, got["common"])
    assert got["sym_diff"] / common < fuzz.FLIP_RATE, got
    assert got["over"] / common < fuzz.FLIP_RATE, got
    assert got["p995_diff"] <= fuzz.LONG_PROB_TOL, got
