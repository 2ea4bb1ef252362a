"""Seeded random-config golden parity of every engine of the port
(``scripts/torch_fuzz_golden.py``, the port's counterpart of
tests/test_fuzz_parity.py).

Each seed draws the trial scripts/fuzz_golden.py draws (a random
MapperConfig, 2-4 random pings on a random trajectory) and maps it on the
CPU in float64 through every engine of the port (``ENGINES``: the brick
pipeline in both dense modes at windows 1 and 2 and with batched records,
two-word brick codes, hash at windows 1 and 3, dense, ``SonarMapper``, the
three sharded engines at S = 4, the multi-host fold on brick and hash).
Tolerances: each engine's voxel set and per-ping ``num_occupied`` /
``num_free`` equal the port's golden oracle's; log-odds within 1e-9.
"""

import os
import sys

import pytest
import torch

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "scripts")
)

import torch_fuzz_golden as fuzz  # noqa: E402

import torch_parity  # noqa: E402,F401  (one torch thread a test process)

# JAX's three pinned seeds (tests/test_fuzz_parity.py) and six more: the z
# filter on (0, 8, 11, 12, 31), the adaptive update off (11, 34), a
# 9.4 cm voxel (31) and a 32-bearing image (34)
SEEDS = [1002, 2016, 2048, 0, 8, 11, 12, 31, 34]


@pytest.mark.parametrize("seed", SEEDS)
def test_every_engine_matches_golden(seed):
    r = fuzz.run_trial(seed, device="cpu", dtype=torch.float64)
    assert r.failure is None, r.message + "\n" + r.repro()
    assert set(r.engines) == set(fuzz.ENGINES)
    for label, e in r.engines.items():
        assert e.sym_diff == 0 and e.voxels == r.voxels > 0, label
        assert e.max_err <= fuzz.F64_TOL and e.stats_equal, label


def test_an_engine_that_raises_fails_the_trial_with_its_repro(monkeypatch):
    """An engine that raises (a dense grid the trial leaves, growth that
    does not converge, a fault of the port) ends the trial as a mismatch
    naming the seed, the engine and the config, like a numeric one."""
    def boom(t, device, dtype):
        raise RuntimeError("no room")

    monkeypatch.setattr(fuzz, "ENGINES", {"boom": boom})
    r = fuzz.run_trial(2016, device="cpu", dtype=torch.float64)
    assert r.failure == "boom: RuntimeError: no room"
    assert r.message == "MISMATCH[boom: RuntimeError: no room]"
    repro = r.repro()
    assert repro.startswith("repro: seed=2016 engine='boom' config=")
    assert '"voxel_resolution"' in repro
