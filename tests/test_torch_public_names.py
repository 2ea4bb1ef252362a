"""The port's last public names against the JAX package's:
``grid.hash.occupied_key_mask`` on a mapped hash state,
``ops.dedup.running_max`` against ``jax.lax.cummax`` and
``grid.check_state_backend`` against the JAX package's refusals.

Inputs are numpy-seeded; every comparison is exact (slot masks, integer
running maxima, the same refusals with the same message).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu import grid as j_grid  # noqa: E402
from sonar_3d_reconstruction_tpu import pipeline as j_pipeline  # noqa: E402
from sonar_3d_reconstruction_tpu.grid import brick as j_brick  # noqa: E402
from sonar_3d_reconstruction_tpu.grid import dense as j_dense  # noqa: E402
from sonar_3d_reconstruction_tpu.grid import hash as j_hash  # noqa: E402

from sonar_3d_reconstruction_tpu_torch import grid, pipeline  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    init_brick_grid,
)
from sonar_3d_reconstruction_tpu_torch.grid.dense import (  # noqa: E402
    DenseGridSpec,
    init_dense_grid,
)
from sonar_3d_reconstruction_tpu_torch.grid.hash import (  # noqa: E402
    init_hash_grid,
    occupied_key_mask,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import running_max  # noqa: E402

from torch_parity import port_cfg  # noqa: E402
from test_torch_shard import SMALL_CFG, survey  # noqa: E402

CAPACITY = 1 << 14


def test_occupied_key_mask_matches_jax():
    """Four pings into a hash map of CAPACITY slots in both packages: the
    host masks of occupied slots are equal slot for slot."""
    pings = survey(4)
    st, _ = pipeline.map_ping_sequence(
        *pings, port_cfg(SMALL_CFG), device="cpu", backend="hash",
        dtype=torch.float64, window=1,
        state=init_hash_grid(CAPACITY, torch.float64, "cpu"))
    j_st, _ = j_pipeline.map_ping_sequence(
        *pings, SMALL_CFG, backend="hash", dtype=jnp.float64, window=1,
        initial_capacity=CAPACITY)
    got, want = occupied_key_mask(st), j_hash.occupied_key_mask(j_st)
    assert isinstance(got, np.ndarray) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert got.sum() == int(st.used) > 0


@pytest.mark.parametrize("n", [0, 1, 7, 4096])
def test_running_max_matches_lax_cummax(n):
    """int64 segment starts (-1 between them) and random int32 values:
    equal to ``jax.lax.cummax`` along axis 0, (n,) and (n, 3)."""
    rng = np.random.default_rng(50 + n)
    idx = np.arange(n)
    starts = np.where(rng.random(n) < 0.1, idx, -1).astype(np.int64)
    vals = rng.integers(-1000, 1000, size=(n, 3)).astype(np.int32)
    for x in (starts, vals):
        got = running_max(torch.as_tensor(x)).numpy()
        want = np.asarray(jax.lax.cummax(jnp.asarray(x), axis=0))
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(got, want)


def states():
    """One empty map of each single-card backend, in both packages."""
    spec = DenseGridSpec.for_world_bounds((-1, -1, -1), (1, 1, 1), 0.5)
    j_spec = j_dense.DenseGridSpec.for_world_bounds((-1, -1, -1), (1, 1, 1),
                                                    0.5)
    return {
        "brick": (init_brick_grid(128, torch.float32, "cpu"),
                  j_brick.init_brick_grid(128)),
        "hash": (init_hash_grid(128, torch.float32, "cpu"),
                 j_hash.init_hash_grid(128)),
        "dense": (init_dense_grid(spec, torch.float32, "cpu"),
                  j_dense.init_dense_grid(j_spec)),
    }


@pytest.mark.parametrize("backend", ["brick", "hash", "dense",
                                     "brick-sharded"])
def test_check_state_backend_refuses_as_jax(backend):
    """Each state against each backend: the port refuses exactly where JAX
    refuses, with the same message; None and backends with no single-card
    state type pass.  ``pipeline.check_state_backend`` is the same
    function."""
    assert pipeline.check_state_backend is grid.check_state_backend
    grid.check_state_backend(None, backend)
    j_grid.check_state_backend(None, backend)
    for kind, (st, j_st) in states().items():
        try:
            j_grid.check_state_backend(j_st, backend)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                grid.check_state_backend(st, backend)
            assert str(got.value) == str(e)
        else:
            grid.check_state_backend(st, backend)
            assert kind == backend or backend == "brick-sharded"
