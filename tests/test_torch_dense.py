"""The port's dense backend against the JAX package's: the grid
(``update_dense_grid``, extraction, classification, point queries, the
NumPy state views), ``map_ping_sequence(backend="dense")`` and
``SonarMapper(backend="dense")``, and within the port against the brick
map.

Both packages take the same numpy-seeded pings (small geometry), into a
grid of +-3 m at 0.1 m (61^3 cells; the survey reaches past it, so
``overflow`` counts) or the default +-(max_range + 2 m).  Tolerances:
per-ping stats, ``touched``, bounds, ``overflow``, extracted points and
classified point sets exactly; log-odds within EXP_ULP_TOL
(tests/torch_parity.py: 1e-12 in float64, 1e-5 in float32; the port forms
each cell's sum from integer counts, JAX sums candidates in order, and on
this survey no log-odds differs in either dtype); probabilities within the
same bars.  Within the port the dense map equals the brick map bit for
bit on every in-grid voxel.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu.grid import dense as j_dense  # noqa: E402
from sonar_3d_reconstruction_tpu.models import (  # noqa: E402
    SonarMapper as JaxMapper,
)
from sonar_3d_reconstruction_tpu.pipeline import (  # noqa: E402
    map_ping_sequence as j_map_ping_sequence,
)

from sonar_3d_reconstruction_tpu_torch import pipeline  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid import dense  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu_torch.grid.hash import (  # noqa: E402
    init_hash_grid,
)
from sonar_3d_reconstruction_tpu_torch.io import checkpoint  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.models import SonarMapper  # noqa: E402

from conftest import circular_trajectory, synthetic_ping  # noqa: E402
from torch_parity import DTYPES, EXP_ULP_TOL, port_cfg  # noqa: E402

SMALL_CFG = MapperConfig(image_width=64, image_height=100, max_range=5.0,
                         min_range=0.5, voxel_resolution=0.1,
                         intensity_threshold=30)
N_PINGS = 6
J_SPEC = j_dense.DenseGridSpec.for_world_bounds((-3.0,) * 3, (3.0,) * 3, 0.1)
SPEC = dense.DenseGridSpec(J_SPEC.origin_key, J_SPEC.shape, J_SPEC.resolution)
STATS = ("num_occupied", "num_free", "num_candidates")
TIMES = ("processing_time", "avg_processing_time")


def survey(n=N_PINGS, seed=900):
    images = np.stack([synthetic_ping(100, 64, seed=seed + i)
                       for i in range(n)])
    positions, quats = circular_trajectory(n, radius=0.8)
    return images, positions, quats


@functools.lru_cache(maxsize=None)
def jax_seq(j_dtype, n=N_PINGS):
    """The JAX dense map of the survey's first n pings: (state, state as
    NumPy, stats)."""
    st, stats = j_map_ping_sequence(
        *(x[:n] for x in survey()), SMALL_CFG, backend="dense",
        dense_spec=J_SPEC, dtype=j_dtype,
    )
    return (st, {k: np.asarray(getattr(st, k)) for k in st._fields},
            {k: np.asarray(v) for k, v in stats.items()})


def port_seq(t_dtype, n=N_PINGS, spec=SPEC, state=None, start=0):
    return pipeline.map_ping_sequence(
        *(x[start:n] for x in survey()), port_cfg(SMALL_CFG), device="cpu",
        backend="dense", dense_spec=spec, dtype=t_dtype, state=state,
    )


def assert_dense_states_match(got, want, dtype):
    """Port state (as NumPy) vs JAX state (as NumPy): every array equal,
    log-odds within EXP_ULP_TOL.  Returns the log-odds not bit-equal."""
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        if k == "log_odds":
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=EXP_ULP_TOL[dtype], err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return int((got["log_odds"] != want["log_odds"]).sum())


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_dense_sequence_matches_jax(t_dtype, j_dtype):
    """map_ping_sequence(backend="dense"): per-ping stats, touched cells,
    bounds and overflow equal to the JAX package's, log-odds within
    EXP_ULP_TOL."""
    _, want, j_stats = jax_seq(j_dtype)
    st, stats = port_seq(t_dtype)
    assert isinstance(st, dense.DenseGridState)
    assert set(stats) == set(j_stats) == set(STATS)
    for k in STATS:
        np.testing.assert_array_equal(stats[k], j_stats[k], err_msg=k)
    assert (stats["num_occupied"] > 0).any() and int(st.overflow) > 0
    assert assert_dense_states_match(dense.dense_state_to_numpy(st), want,
                                     t_dtype) == 0


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_dense_reads_match_jax(t_dtype, j_dtype):
    """Extraction (points in cell order), classification and point queries
    (touched centres, cell corners, untouched cells, points outside the
    grid) as the JAX package computes them."""
    j_st, _, _ = jax_seq(j_dtype)
    st, _ = port_seq(t_dtype)
    tol = EXP_ULP_TOL[t_dtype]
    pts, probs = dense.extract_occupied(st, SPEC, SMALL_CFG)
    j_pts, j_probs = j_dense.extract_occupied(j_st, J_SPEC, SMALL_CFG)
    assert len(pts) > 0
    np.testing.assert_array_equal(pts, j_pts)
    np.testing.assert_allclose(probs, j_probs, rtol=0, atol=tol)
    got = dense.extract_classified(st, SPEC, SMALL_CFG)
    want = j_dense.extract_classified(j_st, J_SPEC, SMALL_CFG)
    assert got.keys() == want.keys()
    for k in want:
        assert len(got[k][0]) > 0, k
        np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=k)
        np.testing.assert_allclose(got[k][1], want[k][1], rtol=0, atol=tol)
    rng = np.random.default_rng(5)
    queries = np.concatenate([
        pts, pts - 0.05, rng.uniform(-4.0, 4.0, (500, 3)),
        [[100.0, 0.0, 0.0], [-3.2, 0.0, 0.0], [0.0, 0.0, 2.95]],
    ])
    q = dense.query_probability_dense(st, queries, SPEC, SMALL_CFG)
    j_q = j_dense.query_probability_dense(j_st, queries, J_SPEC, SMALL_CFG)
    np.testing.assert_allclose(q, j_q, rtol=0, atol=tol)
    assert (q == 0.5).any() and q[len(pts) * 2 + 500] == 0.5


def test_update_dense_grid_leaves_its_input():
    """update_dense_grid ping by ping equals map_ping_sequence and never
    writes into the state it was given."""
    from sonar_3d_reconstruction_tpu_torch.geometry import (
        batched_sonar_to_world,
    )
    from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
        backproject_ping,
        build_fan_tables,
    )

    cfg = port_cfg(SMALL_CFG)
    images, positions, quats = (x[:3] for x in survey())
    tables = build_fan_tables(cfg, 100, 64)
    T = torch.as_tensor(batched_sonar_to_world(positions, quats, cfg))
    state = dense.init_dense_grid(SPEC, torch.float64, "cpu")
    for image, T_i in zip(images, T):
        before = dense.dense_state_to_numpy(state)
        cand = backproject_ping(torch.as_tensor(image), T_i, tables, cfg,
                                dtype=torch.float64)
        new, stats = dense.update_dense_grid(state, cand, SPEC, cfg)
        np.testing.assert_equal(dense.dense_state_to_numpy(state), before)
        state = new
    want, _ = port_seq(torch.float64, n=3)
    np.testing.assert_equal(dense.dense_state_to_numpy(state),
                            dense.dense_state_to_numpy(want))


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_dense_resumes_from_a_jax_state(t_dtype, j_dtype):
    """The NumPy views round-trip a JAX dense state, and mapping the rest
    of the survey from the JAX map of its first pings matches the JAX map
    of the whole survey."""
    _, half, _ = jax_seq(j_dtype, 3)
    st = dense.dense_state_from_numpy(half, "cpu")
    np.testing.assert_equal(dense.dense_state_to_numpy(st), half)
    assert st.log_odds.dtype == t_dtype and st.overflow.dtype == torch.int64
    st, stats = port_seq(t_dtype, state=st, start=3)
    assert len(stats["num_free"]) == N_PINGS - 3
    _, whole, _ = jax_seq(j_dtype)
    assert_dense_states_match(dense.dense_state_to_numpy(st), whole, t_dtype)


def test_no_pings_return_a_dense_state():
    """P == 0 returns the given state or a fresh grid of the spec (the
    default spec when none is given) and no stats, as in JAX."""
    images, positions, quats = survey(1)
    cfg = port_cfg(SMALL_CFG)
    st, stats = pipeline.map_ping_sequence(
        images[:0], positions[:0], quats[:0], cfg, device="cpu",
        backend="dense",
    )
    default = dense.default_dense_spec(cfg)
    j_default = j_dense.DenseGridSpec.for_world_bounds((-7.0,) * 3, (7.0,) * 3,
                                                      0.1)
    assert stats == {} and default.shape == j_default.shape == (141,) * 3
    assert st.log_odds.shape == (default.num_cells,) and not st.touched.any()
    given = dense.init_dense_grid(SPEC, torch.float32, "cpu")
    st, stats = port_seq(torch.float32, n=0, state=given)
    assert st is given and stats == {}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_dense_map_equals_the_brick_map(dtype):
    """In-grid voxels of the dense map equal the brick map's bit for bit;
    with a grid that holds every candidate, per-ping stats and the voxel
    set are equal too."""
    cfg = port_cfg(SMALL_CFG)
    b_st, b_stats = pipeline.map_ping_sequence(
        *survey(), cfg, device="cpu", dtype=dtype, window=3)
    b_keys, b_lo = touched_voxels_brick(b_st)
    for spec in (SPEC, dense.default_dense_spec(cfg)):
        st, stats = port_seq(dtype, spec=spec)
        in_grid, lin = dense.linearize_keys(b_keys.astype(np.int64), spec)
        touched = st.touched.numpy()
        assert touched.sum() == in_grid.sum() > 0
        assert touched[lin[in_grid]].all()
        np.testing.assert_array_equal(st.log_odds.numpy()[lin[in_grid]],
                                      b_lo[in_grid])
    assert in_grid.all() and int(st.overflow) == 0
    for k in STATS:
        np.testing.assert_array_equal(stats[k], b_stats[k], err_msg=k)
    np.testing.assert_array_equal(st.min_bounds, b_st.min_bounds)
    np.testing.assert_array_equal(st.max_bounds, b_st.max_bounds)


def test_dense_refusals():
    """A spec past 2^31 - 1 cells, a state of another spec or backend,
    map_sequence and save_map on a dense map are refused."""
    big = dense.DenseGridSpec((0, 0, 0), (1291, 1291, 1289), 0.05)
    assert big.num_cells > 2**31 - 1
    with pytest.raises(ValueError, match="exceeds"):
        dense.init_dense_grid(big, torch.float32, "cpu")
    with pytest.raises(ValueError, match="cells, the spec"):
        port_seq(torch.float32, n=1,
                 state=dense.init_dense_grid(SPEC, torch.float32, "cpu"),
                 spec=dense.DenseGridSpec((0, 0, 0), (8, 8, 8), 0.1))
    with pytest.raises(ValueError, match="does not match backend='dense'"):
        port_seq(torch.float32, n=1, state=init_hash_grid(
            1 << 10, torch.float32, "cpu"))
    m = SonarMapper(port_cfg(SMALL_CFG), backend="dense", dense_spec=SPEC,
                    device="cpu")
    with pytest.raises(ValueError, match="hash or brick"):
        m.map_sequence(*survey(1))
    with pytest.raises(ValueError, match="DenseGridState"):
        checkpoint.save_map("unused.npz", m.state, m.cfg)


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_dense_mapper_matches_jax(t_dtype, j_dtype):
    """SonarMapper(backend="dense") ping by ping (default spec): stats
    dicts, num_voxels, clouds with and without free space, bounds, queries,
    log-odds, update-count histograms and reset_map as the JAX mapper."""
    cfg = SMALL_CFG
    jm = JaxMapper(cfg, backend="dense", dtype=j_dtype,
                   track_update_counts=True)
    tm = SonarMapper(port_cfg(cfg), backend="dense", dtype=t_dtype,
                     device="cpu", track_update_counts=True)
    assert tm.dense_spec == dense.DenseGridSpec(*(
        getattr(jm.dense_spec, f) for f in ("origin_key", "shape",
                                            "resolution")))
    tol = EXP_ULP_TOL[t_dtype]
    for img, p, q in zip(*survey(3, seed=930)):
        got, want = (m.process_sonar_image(img, p, q) for m in (tm, jm))
        assert ({k: v for k, v in got.items() if k not in TIMES}
                == {k: v for k, v in want.items() if k not in TIMES})
    assert tm.num_voxels == jm.num_voxels > 0
    cloud, j_cloud = tm.get_point_cloud(), jm.get_point_cloud()
    np.testing.assert_array_equal(cloud["points"], j_cloud["points"])
    np.testing.assert_allclose(cloud["probabilities"],
                               j_cloud["probabilities"], rtol=0, atol=tol)
    full, j_full = (m.get_point_cloud(include_free=True) for m in (tm, jm))
    for k in ("num_voxels", "num_occupied", "num_free", "num_unknown",
              "frame_count"):
        assert full[k] == j_full[k], k
    for k in ("occupied", "free", "unknown"):
        np.testing.assert_array_equal(full[k][0], j_full[k][0])
    for k in ("min", "max"):
        np.testing.assert_array_equal(full["bounds"][k], j_full["bounds"][k])
    pts = np.concatenate([cloud["points"][:50], [[0.0, 0.0, 50.0]]])
    np.testing.assert_allclose(tm.query_probabilities(pts),
                               jm.query_probabilities(pts), rtol=0, atol=tol)
    for x in (cloud["points"][0], full["free"][0][0], [0.0, 0.0, 50.0]):
        assert abs(tm.get_probability(*x) - jm.get_probability(*x)) <= tol
        assert abs(tm.get_log_odds(*x) - jm.get_log_odds(*x)) <= tol
    assert tm.get_log_odds(0.0, 0.0, 50.0) == 0.0
    assert tm.update_count_histogram() == jm.update_count_histogram()
    tm.reset_map()
    jm.reset_map()
    assert tm.num_voxels == 0 and tm.frame_count == 0
    got = tm.process_sonar_image(*(x[0] for x in survey(1, seed=950)))
    want = jm.process_sonar_image(*(x[0] for x in survey(1, seed=950)))
    assert got["num_voxels"] == want["num_voxels"] > 0
