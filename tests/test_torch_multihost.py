"""The port's multi-host record fold (``parallel/multihost.py``) against
its own ``map_ping_sequence`` and the JAX package's
``map_ping_sequence_multihost``, on the brick map (two-word brick codes
through K1's plain version) and the hash map.

Both packages take the same numpy-seeded pings (small geometry), split
at window boundaries and off them.  Tolerances: record lanes, per-frame
stats, voxel keys exactly; log-odds bit-equal within the port, within
EXP_ULP_TOL (tests/torch_parity.py: 1e-12 in float64) of the JAX
package.  Maps are compared voxel by voxel, never by table slot.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu.parallel.multihost import (  # noqa: E402
    map_ping_sequence_multihost as j_multihost,
)

from sonar_3d_reconstruction_tpu_torch import pipeline  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.geometry import (  # noqa: E402
    batched_sonar_to_world,
)
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    BrickGridState,
    brick_state_from_numpy,
    init_brick_grid,
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu_torch.grid.hash import (  # noqa: E402
    hash_state_from_numpy,
    init_hash_grid,
    touched_voxels_hash,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (  # noqa: E402
    resolve_capped_tables,
)
from sonar_3d_reconstruction_tpu_torch.ops.records import (  # noqa: E402
    frame_records,
)
from sonar_3d_reconstruction_tpu_torch.parallel import (  # noqa: E402
    apply_record_segments,
    map_ping_sequence_multihost,
    records_for_segment,
)

from conftest import circular_trajectory, synthetic_ping  # noqa: E402
from torch_parity import EXP_ULP_TOL, port_cfg  # noqa: E402

SMALL_CFG = MapperConfig(image_width=64, image_height=100, max_range=5.0,
                         min_range=0.5, voxel_resolution=0.1,
                         intensity_threshold=30)
N_PINGS = 7
STATS = ("num_occupied", "num_free", "num_candidates", "overflowed")
BACKENDS = ["brick", "hash"]


def survey(n=N_PINGS, seed=520):
    images = np.stack([synthetic_ping(100, 64, seed=seed + i)
                       for i in range(n)])
    positions, quats = circular_trajectory(n, radius=0.7)
    return images, positions, quats


def sorted_voxels(state):
    touched = (touched_voxels_brick if isinstance(state, BrickGridState)
               else touched_voxels_hash)
    keys, lo = touched(state)
    order = np.lexsort(keys.T)
    return keys[order], lo[order]


def assert_same_voxels(got, want, tol=0.0):
    (keys, lo), (w_keys, w_lo) = sorted_voxels(got), sorted_voxels(want)
    assert len(keys) > 0
    np.testing.assert_array_equal(keys, w_keys)
    np.testing.assert_allclose(lo, w_lo, rtol=0, atol=tol)
    if tol == 0.0:
        np.testing.assert_array_equal(lo, w_lo)


def port_multihost(backend, dtype=torch.float64, **kw):
    kw = {"n_hosts": 3, "window": 3, "initial_capacity": 1 << 16, **kw}
    return map_ping_sequence_multihost(
        *survey(), port_cfg(SMALL_CFG), backend=backend, dtype=dtype,
        device="cpu", **kw,
    )


@functools.lru_cache(maxsize=None)
def jax_multihost(backend):
    """The JAX fold of the survey in float64: (state as NumPy, stats)."""
    st, stats = j_multihost(*survey(), SMALL_CFG, n_hosts=3, window=3,
                            dtype=jnp.float64, initial_capacity=1 << 16,
                            backend=backend)
    return {k: np.asarray(v) for k, v in st._asdict().items()}, stats


@pytest.mark.parametrize("brick_bits", [2, 0], ids=["brick", "hash"])
def test_segment_records_equal_one_shot_frame_records(brick_bits):
    """Segments cut anywhere, an empty one included, hold each frame's
    frame_records lanes cut to its unique count, and its FrameAux."""
    cfg = port_cfg(SMALL_CFG)
    images, positions, quats = survey()
    tables = resolve_capped_tables(images, cfg, 100, 64)
    T = torch.as_tensor(batched_sonar_to_world(positions, quats, cfg))
    for a, b in [(0, 4), (4, 4), (4, 7)]:
        recs, aux = records_for_segment(
            images[a:b], positions[a:b], quats[a:b], cfg,
            dtype=torch.float64, brick_bits=brick_bits, device="cpu")
        assert len(recs.n_unique) == len(aux.n_valid) == b - a
        assert recs.hi.dtype == np.uint32 and recs.count.dtype == np.int32
        lane = 0
        for i, frame in enumerate(range(a, b)):
            rec, want = frame_records(torch.as_tensor(images[frame]),
                                      T[frame], tables, cfg, None, None,
                                      brick_bits, dtype=torch.float64)
            n = int(rec.n_unique)
            assert recs.n_unique[i] == n > 0
            for got, field in zip(recs[:4], rec[:4]):
                np.testing.assert_array_equal(got[lane:lane + n],
                                              field[:n].numpy())
            lane += n
            for got, field in zip(aux, want):
                np.testing.assert_array_equal(got[i], field.numpy())
        assert lane == len(recs.hi)


@pytest.mark.parametrize("backend", BACKENDS)
def test_multihost_equals_map_ping_sequence(backend):
    """The fold (3 segments, windows of 3 that stop at segment ends)
    equals map_ping_sequence in windows of 3, per-frame stats and every
    voxel's log-odds, in float32."""
    st, stats = port_multihost(backend, torch.float32)
    want, w_stats = pipeline.map_ping_sequence(
        *survey(), port_cfg(SMALL_CFG), device="cpu", backend=backend,
        dtype=torch.float32, window=3)
    assert len(stats) == N_PINGS
    for k in STATS:
        np.testing.assert_array_equal([s[k] for s in stats], w_stats[k],
                                      err_msg=k)
    assert_same_voxels(st, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_multihost_matches_jax(backend):
    """The port's fold against the JAX package's in float64: per-frame
    stats equal, voxels equal, log-odds within EXP_ULP_TOL."""
    j_state, j_stats = jax_multihost(backend)
    st, stats = port_multihost(backend)
    assert len(stats) == len(j_stats) == N_PINGS
    for k in STATS:
        assert [int(s[k]) for s in stats] == [int(s[k]) for s in j_stats], k
    from_numpy = (brick_state_from_numpy if backend == "brick"
                  else hash_state_from_numpy)
    assert_same_voxels(st, from_numpy(j_state, "cpu"),
                       EXP_ULP_TOL[torch.float64])
    np.testing.assert_array_equal(st.min_bounds, j_state["min_bounds"])
    np.testing.assert_array_equal(st.max_bounds, j_state["max_bounds"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_multihost_grows_and_replays(backend):
    """From a table too small for the survey, the wrapper grows and
    replays to the same map, and a resumed map continues it."""
    big, _ = port_multihost(backend)
    tiny, stats = port_multihost(backend, initial_capacity=1 << 7)
    assert tiny.capacity > (1 << 7 if backend == "hash" else 128)
    assert not bool(tiny.poisoned) and all(s is not None for s in stats)
    assert_same_voxels(tiny, big)
    images, positions, quats = survey()
    half, _ = map_ping_sequence_multihost(
        images[:4], positions[:4], quats[:4], port_cfg(SMALL_CFG),
        n_hosts=2, window=3, backend=backend, dtype=torch.float64,
        initial_capacity=1 << 7, device="cpu")
    rest, stats = map_ping_sequence_multihost(
        images[4:], positions[4:], quats[4:], port_cfg(SMALL_CFG),
        n_hosts=2, window=3, backend=backend, dtype=torch.float64,
        state=half, device="cpu")
    assert len(stats) == N_PINGS - 4
    assert_same_voxels(rest, big)


def test_multihost_refusals():
    """A resumed state of the other backend, the dense backend, a dense
    state in the fold, and keys outside the packable range are refused;
    no pings map nothing."""
    cfg = port_cfg(SMALL_CFG)
    images, positions, quats = survey(2)
    with pytest.raises(ValueError, match="does not match backend='hash'"):
        map_ping_sequence_multihost(
            images, positions, quats, cfg, backend="hash", device="cpu",
            state=init_brick_grid(256, torch.float32, "cpu"))
    with pytest.raises(ValueError, match="'brick' or 'hash'"):
        map_ping_sequence_multihost(images, positions, quats, cfg,
                                    backend="dense", device="cpu")
    from sonar_3d_reconstruction_tpu_torch.grid import dense

    grid = dense.init_dense_grid(dense.DenseGridSpec((0, 0, 0), (2, 2, 2),
                                                     0.1), torch.float32, "cpu")
    with pytest.raises(ValueError, match="DenseGridState"):
        apply_record_segments(grid, [], cfg)
    far = positions + np.array([1.0e5, 0.0, 0.0])
    for backend in BACKENDS:
        with pytest.raises(ValueError, match="packable range"):
            map_ping_sequence_multihost(images, far, quats, cfg,
                                        backend=backend, device="cpu")
    st = init_hash_grid(1 << 10, torch.float32, "cpu")
    got, stats = map_ping_sequence_multihost(
        images[:0], positions[:0], quats[:0], cfg, backend="hash",
        state=st, device="cpu")
    assert got is st and stats == []


# ---------------------------------------------------------------------------
# fixed-width records and the budgeted fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("brick_bits", [2, 0], ids=["brick", "hash"])
def test_fixed_width_records_match_jax(brick_bits):
    """``records_for_segment(unique_budget=1280)``: JAX's (P, U) records,
    lane for lane where a frame fits, ``n_unique`` (above U where a frame
    overflowed: some do at this width) and the aux."""
    from sonar_3d_reconstruction_tpu.parallel.multihost import (
        records_for_segment as j_records_for_segment,
    )

    images, positions, quats = survey()
    recs, aux = records_for_segment(
        images, positions, quats, port_cfg(SMALL_CFG), dtype=torch.float64,
        brick_bits=brick_bits, device="cpu", unique_budget=1280)
    j_recs, j_aux = j_records_for_segment(
        images, positions, quats, SMALL_CFG, unique_budget=1280,
        dtype=jnp.float64, brick_bits=brick_bits)
    assert recs.hi.shape == (N_PINGS, 1280) and recs.hi.dtype == np.uint32
    assert (recs.n_unique > 1280).any() and (recs.n_unique <= 1280).any()
    np.testing.assert_array_equal(recs.n_unique, np.asarray(j_recs.n_unique))
    ok = recs.n_unique <= 1280
    for got, want in zip(recs[:4], (j_recs.hi, j_recs.lo, j_recs.count,
                                    j_recs.n_occ)):
        np.testing.assert_array_equal(got[ok], np.asarray(want)[ok])
    for got, want in zip(aux, j_aux):
        np.testing.assert_array_equal(got, np.asarray(want))


@functools.lru_cache(maxsize=None)
def jax_budgeted_fold(backend):
    """The JAX fold of the survey from a unique budget of 1024, which
    overflows and doubles once: (state as NumPy, stats)."""
    st, stats = j_multihost(*survey(), SMALL_CFG, n_hosts=3, window=3,
                            dtype=jnp.float64, initial_capacity=1 << 16,
                            backend=backend, unique_budget=1024)
    return {k: np.asarray(v) for k, v in st._asdict().items()}, stats


@pytest.mark.parametrize("backend", BACKENDS)
def test_budgeted_fold_matches_jax(backend):
    """``map_ping_sequence_multihost(unique_budget=1024)``: the unique
    overflow recomputes the records at 2048 and replays; every per-frame
    stat (the JAX fold's keys) and every state array equal JAX's,
    log-odds within 1e-12."""
    want, j_stats = jax_budgeted_fold(backend)
    st, stats = port_multihost(backend, unique_budget=1024)
    assert len(stats) == len(j_stats) == N_PINGS
    for got, exp in zip(stats, j_stats):
        assert got.keys() == exp.keys()
        for k in exp:
            assert got[k] == np.asarray(exp[k]), k
    for k, v in want.items():
        got = getattr(st, k).numpy()
        if k == "log_odds":
            np.testing.assert_allclose(got, v, rtol=0,
                                       atol=EXP_ULP_TOL[torch.float64])
        else:
            np.testing.assert_array_equal(got.astype(v.dtype), v, k)


@pytest.mark.parametrize("budgets", [dict(unique_budget=8),
                                     dict(batch_budget=16)],
                         ids=["unique", "batch"])
def test_budget_growth_replays_to_the_count_sized_map(budgets):
    """JAX's test_multihost_unique_budget_growth_replay and
    _batch_budget_growth_replay: a unique budget of 8 (the records
    overflow and are recomputed) or a batch budget of 16 (the fold
    replays) grows by cause to the count-sized map, every frame
    applied."""
    images, positions, quats = survey()
    cfg = port_cfg(SMALL_CFG)
    if "unique_budget" in budgets:
        recs, _ = records_for_segment(images[:1], positions[:1], quats[:1],
                                      cfg, dtype=torch.float64, device="cpu",
                                      unique_budget=8)
        assert int(recs.n_unique[0]) > 8
    big, _ = port_multihost("hash")
    grown, stats = port_multihost("hash", **budgets)
    assert all(s is not None and not s["overflowed"] for s in stats)
    assert_same_voxels(grown, big)
