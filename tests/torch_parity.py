"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig

# One intra-op thread per test process.  The suite runs in several worker
# processes at once (every worker imports this module while it collects),
# and torch's default of a thread per core in each of them oversubscribed
# the CPU: the port's tests ran about four times slower under xdist.
torch.set_num_threads(1)

DTYPES = [
    pytest.param(torch.float64, jnp.float64, id="f64"),
    pytest.param(torch.float32, jnp.float32, id="f32"),
]

# XLA:CPU evaluates exp with its own approximation, PyTorch (like NumPy)
# with libm/SLEEF: they differ by an ulp on ~15% of inputs.  Wherever the
# adaptive update reads sigmoid(v) that ulp reaches the result, so those
# comparisons take these bounds; everything without exp is bit-equal.
EXP_ULP_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}

BRICK_FIELDS = ("key_rows", "log_odds", "touched", "min_bounds", "max_bounds",
                "used", "poisoned")


def port_cfg(cfg) -> MapperConfig:
    """The port's MapperConfig with the same values as a JAX one."""
    return MapperConfig(**dataclasses.asdict(cfg))


def jax_brick_state_to_numpy(state):
    return {k: np.asarray(getattr(state, k)) for k in BRICK_FIELDS}


def assert_brick_states_match(got, want, dtype):
    """Port state (as numpy) vs JAX state (as numpy): every array equal,
    log-odds within EXP_ULP_TOL of the dtype."""
    assert got.keys() == want.keys()
    for k in BRICK_FIELDS:
        assert got[k].shape == want[k].shape, k
        if k == "log_odds":
            np.testing.assert_allclose(
                got[k], want[k], rtol=0, atol=EXP_ULP_TOL[dtype], err_msg=k
            )
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
