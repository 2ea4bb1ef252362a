"""The port's ``SonarMapper`` and config module against the JAX package's,
on the brick backend.

Both mappers take the same pings (numpy seeds, small geometry).  The JAX
mapper's per-ping step runs the wide-key path and the port's the compact
box-key path through K1's plain version, so maps are compared voxel by
voxel (sorted keys), never by table slot.

Tolerances: per-ping stats, voxel keys, classified voxel sets, point
clouds' points and update-count histograms exactly; log-odds and
probabilities within EXP_ULP_TOL (tests/torch_parity.py: 1e-12 in float64,
1e-5 in float32).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sonar_3d_reconstruction_tpu import config as j_config  # noqa: E402
from sonar_3d_reconstruction_tpu.grid.brick import (  # noqa: E402
    touched_voxels_brick as j_touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu.models import (  # noqa: E402
    SonarMapper as JaxMapper,
)

from sonar_3d_reconstruction_tpu_torch import config as t_config  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu_torch.models import SonarMapper  # noqa: E402

from conftest import circular_trajectory, synthetic_ping  # noqa: E402
from torch_parity import DTYPES, EXP_ULP_TOL, port_cfg  # noqa: E402

TIMES = ("processing_time", "avg_processing_time")


def mappers(cfg, t_dtype, j_dtype, **kw):
    """(JAX brick mapper, port mapper on the CPU) with the same options."""
    return (
        JaxMapper(cfg, backend="brick", initial_capacity=1 << 13,
                  dtype=j_dtype, **kw),
        SonarMapper(port_cfg(cfg), initial_capacity=1 << 13, dtype=t_dtype,
                    device="cpu", **kw),
    )


def without_times(stats):
    return {k: v for k, v in stats.items() if k not in TIMES}


def assert_same_voxels(t_state, j_state, t_dtype):
    keys, lo = touched_voxels_brick(t_state)
    j_keys, j_lo = j_touched_voxels_brick(j_state)
    order, j_order = np.lexsort(keys.T), np.lexsort(j_keys.T)
    np.testing.assert_array_equal(keys[order], j_keys[j_order])
    assert lo.dtype == j_lo.dtype
    np.testing.assert_allclose(lo[order], j_lo[j_order], rtol=0,
                               atol=EXP_ULP_TOL[t_dtype])
    return keys


def assert_same_cloud(got, want, tol):
    """Points exactly (in extraction order), probabilities within tol."""
    pts, probs = got
    j_pts, j_probs = want
    np.testing.assert_array_equal(pts, j_pts)
    np.testing.assert_allclose(probs, j_probs, rtol=0, atol=tol)


def survey(cfg, n, seed, width=None):
    images = np.stack([
        synthetic_ping(cfg.image_height, width or cfg.image_width,
                       seed=seed + i)
        for i in range(n)
    ])
    positions, quats = circular_trajectory(n)
    return images, positions, quats


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_per_ping_mapping_matches_jax(small_cfg, t_dtype, j_dtype):
    """Per-ping stats dicts, touched voxels, point clouds with and without
    free space, bounds, queries and log-odds, and update-count histograms
    over 4 pings, the last at another image width (fan tables rebuilt)."""
    cfg = small_cfg
    jm, tm = mappers(cfg, t_dtype, j_dtype, track_update_counts=True)
    images, positions, quats = survey(cfg, 3, seed=400)
    pings = list(zip(images, positions, quats))
    pings.append((synthetic_ping(cfg.image_height, 48, seed=89),
                  [0.3, -0.2, 0.1], [0.0, 0.0, 0.0, 1.0]))
    for img, p, q in pings:
        got, want = tm.process_sonar_image(img, p, q), jm.process_sonar_image(img, p, q)
        assert without_times(got) == without_times(want)
        assert set(got) == set(want)
        for k in ("num_occupied", "num_free", "num_candidates",
                  "batch_n_bricks", "batch_n_lanes"):
            assert tm._last_stats[k] == jm._last_stats[k], k
        assert tm.frame_update_counts == jm.frame_update_counts
    assert tm._tables.bearing_bins == 48
    assert tm.num_voxels == jm.num_voxels > 0
    keys = assert_same_voxels(tm.state, jm.state, t_dtype)
    tol = EXP_ULP_TOL[t_dtype]

    got, want = tm.get_point_cloud(), jm.get_point_cloud()
    assert got.keys() == want.keys()
    for k in ("num_voxels", "num_occupied", "frame_count", "processed_count"):
        assert got[k] == want[k], k
    assert got["num_occupied"] > 0
    assert_same_cloud((got["points"], got["probabilities"]),
                      (want["points"], want["probabilities"]), tol)

    got, want = tm.get_point_cloud(True), jm.get_point_cloud(True)
    assert got.keys() == want.keys()
    for k in ("num_voxels", "num_occupied", "num_free", "num_unknown",
              "frame_count", "processed_count"):
        assert got[k] == want[k], k
    assert got["num_free"] > 0 and got["num_unknown"] > 0
    for k in ("occupied", "free", "unknown"):
        assert_same_cloud(got[k], want[k], tol)
    for k in ("min", "max"):
        np.testing.assert_array_equal(got["bounds"][k], want["bounds"][k])

    # voxel centres, every voxel's corner cells (cell boundaries), and
    # points far from the map (0.5)
    res = cfg.voxel_resolution
    rng = np.random.default_rng(5)
    pts = np.concatenate([
        (keys + 0.5) * res,
        keys * res,
        rng.uniform(-40.0, 40.0, size=(200, 3)),
    ])
    np.testing.assert_allclose(tm.query_probabilities(pts),
                               jm.query_probabilities(pts), rtol=0, atol=tol)
    assert tm.get_probability(99.0, 99.0, 99.0) == 0.5
    for x, y, z in pts[:: max(1, len(pts) // 20)]:
        assert abs(tm.get_log_odds(x, y, z) - jm.get_log_odds(x, y, z)) <= tol
        assert abs(tm.get_probability(x, y, z)
                   - jm.get_probability(x, y, z)) <= tol

    assert tm.voxel_update_counts == jm.voxel_update_counts
    assert tm.update_count_histogram() == jm.update_count_histogram()
    assert tm.frame_update_stats() == jm.frame_update_stats()
    assert tm.format_frame_update_stats() == jm.format_frame_update_stats()
    assert tm.format_update_histogram() == jm.format_update_histogram()


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_map_sequence_matches_jax(small_cfg, t_dtype, j_dtype):
    """map_sequence in windows of 3 over 7 pings: per-ping stats, voxels,
    update counts and the frame counters."""
    cfg = small_cfg
    jm, tm = mappers(cfg, t_dtype, j_dtype, track_update_counts=True)
    images, positions, quats = survey(cfg, 7, seed=600)
    got = tm.map_sequence(images, positions, quats, window=3)
    want = jm.map_sequence(images, positions, quats, window=3)
    for k in ("num_occupied", "num_free", "num_candidates", "overflowed"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert tm.frame_count == jm.frame_count == 7
    assert tm.num_voxels == jm.num_voxels
    assert_same_voxels(tm.state, jm.state, t_dtype)
    assert tm.voxel_update_counts == jm.voxel_update_counts
    assert tm.frame_update_counts == jm.frame_update_counts


def test_map_sequence_equals_per_ping(small_cfg):
    """Windows of 4 and single pings give the same map bit for bit."""
    cfg = port_cfg(small_cfg)
    images, positions, quats = survey(small_cfg, 5, seed=610)
    a = SonarMapper(cfg, dtype=torch.float64, device="cpu")
    a.map_sequence(images, positions, quats, window=4)
    b = SonarMapper(cfg, dtype=torch.float64, device="cpu")
    for x in zip(images, positions, quats):
        b.process_sonar_image(*x)
    for u, v in zip(touched_voxels_brick(a.state), touched_voxels_brick(b.state)):
        np.testing.assert_array_equal(u, v)


def test_growth_from_a_tiny_capacity(small_cfg):
    """A one-bucket brick table grows inside map_ping_sequence and the
    mapper keeps the grown state: same voxels and stats as a large one."""
    cfg = port_cfg(small_cfg)
    images, positions, quats = survey(small_cfg, 3, seed=77)
    tiny = SonarMapper(cfg, initial_capacity=1, dtype=torch.float64,
                       device="cpu")
    big = SonarMapper(cfg, dtype=torch.float64, device="cpu")
    assert tiny.state.capacity == 128
    for x in zip(images, positions, quats):
        assert (without_times(tiny.process_sonar_image(*x))
                == without_times(big.process_sonar_image(*x)))
    assert tiny.state.capacity > 128 and not bool(tiny.state.poisoned)
    for u, v in zip(touched_voxels_brick(tiny.state),
                    touched_voxels_brick(big.state)):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_reset_map_matches_jax(small_cfg, t_dtype, j_dtype):
    """reset_map (and its alias clear) empties the map and the counters,
    keeps the grown capacity, and mapping after it matches JAX again."""
    cfg = small_cfg
    jm, tm = mappers(cfg, t_dtype, j_dtype, track_update_counts=True)
    images, positions, quats = survey(cfg, 2, seed=99)
    for m in (jm, tm):
        m.process_sonar_image(images[0], positions[0], quats[0])
    cap = tm.state.capacity
    tm.reset_map()
    jm.reset_map()
    assert tm.num_voxels == 0 and tm.frame_count == 0
    assert tm.processed_frame_count == 0 and tm.total_processing_time == 0
    assert tm.update_count_histogram() == {} and tm.frame_update_stats() == {}
    assert tm.state.capacity == cap
    assert tm.get_probability(0.5, 0.5, 0.5) == 0.5
    got = tm.process_sonar_image(images[1], positions[1], quats[1])
    want = jm.process_sonar_image(images[1], positions[1], quats[1])
    assert without_times(got) == without_times(want)
    assert_same_voxels(tm.state, jm.state, t_dtype)
    tm.clear()
    assert tm.num_voxels == 0 and tm.get_point_cloud()["num_occupied"] == 0


def test_dict_config_like_jax(small_cfg):
    """A plain library-level config dict (reference 3d_mapper.py:203-254)
    builds the same config in both packages; unknown keys are ignored."""
    d = {"voxel_resolution": 0.1, "min_probability": 0.6,
         "intensity_threshold": 30, "sonar_position": [0, 0, -0.2],
         "not_a_field": 1}
    m = SonarMapper(d, initial_capacity=1 << 12, device="cpu")
    assert m.cfg.voxel_resolution == 0.1
    assert m.cfg.horizontal_fov == 130.0  # default kept
    assert m.cfg == port_cfg(JaxMapper(d, backend="brick").cfg)
    assert m.state.capacity == 256


def test_config_module_matches_jax(tmp_path):
    """StreamConfig, to_dict, config_from_dict, load_config (YAML with the
    reference schema, overrides in node-level degrees) and the presets."""
    assert ([(f.name, f.default) for f in dataclasses.fields(t_config.StreamConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(j_config.StreamConfig)])
    assert t_config.PRESETS.keys() == j_config.PRESETS.keys()
    for k, v in t_config.PRESETS.items():
        assert dataclasses.asdict(v) == dataclasses.asdict(j_config.PRESETS[k]), k
        assert v.to_dict() == j_config.PRESETS[k].to_dict()
        assert t_config.config_from_dict(v.to_dict()) == v
    yml = tmp_path / "m.yaml"
    yml.write_text(
        "sonar_3d_mapper:\n  ros__parameters:\n    voxel_resolution: 0.2\n"
        "    sonar_orientation: {roll: 0.0, pitch: 45.0, yaw: 10.0}\n"
        "    sync_slop: 0.05\n    sonar_topic: /s\n"
    )
    over = {"max_range": 7.5, "sonar_position": {"x": 1.0, "y": 0.0, "z": -1}}
    got = t_config.load_config(str(yml), over)
    want = j_config.load_config(str(yml), over)
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    assert got[1].sync_slop == 0.05 and got[0].max_range == 7.5
    with pytest.raises(ValueError, match="3 elements"):
        t_config.config_from_dict({"sonar_position": [1, 2]})


@pytest.mark.parametrize("backend,refusal", [
    ("brick-sharded", None), ("octree", "unknown backend"),
])
def test_other_backends_are_refused(backend, refusal):
    """A name no package knows is refused; the sharded backend maps (on
    the one device given: one shard).  Dense maps:
    tests/test_torch_dense.py."""
    if refusal is None:
        m = SonarMapper(backend=backend, device="cpu")
        assert m.mesh == (torch.device("cpu"),) and m.device.type == "cpu"
        img = synthetic_ping(500, 512, seed=1)
        assert m.process_sonar_image(img, [0, 0, 0], [0, 0, 0, 1])[
            "num_voxels"] == m.num_voxels > 0
        return
    with pytest.raises(ValueError, match=refusal):
        SonarMapper(backend=backend, device="cpu")


def test_sharded_mapper_matches_jax(small_cfg):
    """backend="brick-sharded" over four shards against the JAX mapper on
    four virtual devices, float64: per-ping stats, then map_sequence in
    windows of 3; each shard's voxels, the point clouds (classified too)
    in extraction order, bounds, point queries summed over the shards,
    and reset_map."""
    import jax

    from sonar_3d_reconstruction_tpu.parallel.shard import (
        make_mesh as j_make_mesh,
    )
    from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
        local_brick_states as j_local_brick_states,
    )
    from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (
        local_brick_states,
    )

    cfg = small_cfg
    jm = JaxMapper(cfg, backend="brick-sharded", initial_capacity=1 << 16,
                   dtype=jax.numpy.float64,
                   mesh=j_make_mesh(jax.devices()[:4]))
    tm = SonarMapper(port_cfg(cfg), backend="brick-sharded",
                     initial_capacity=1 << 16, dtype=torch.float64,
                     mesh=["cpu"] * 4)
    assert tm.state.local_capacity == jm.state.local_capacity
    images, positions, quats = survey(cfg, 8, seed=620)
    for x in zip(images[:2], positions[:2], quats[:2]):
        assert (without_times(tm.process_sonar_image(*x))
                == without_times(jm.process_sonar_image(*x)))
    got = tm.map_sequence(images[2:], positions[2:], quats[2:], window=3)
    want = jm.map_sequence(images[2:], positions[2:], quats[2:], window=3)
    for k in ("num_occupied", "num_free", "num_candidates", "overflowed"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert tm.frame_count == jm.frame_count == 8
    assert tm.num_voxels == jm.num_voxels
    for t_s, j_s in zip(local_brick_states(tm.state),
                        j_local_brick_states(jm.state)):
        assert_same_voxels(t_s, j_s, torch.float64)
    tol = EXP_ULP_TOL[torch.float64]
    t_cloud, j_cloud = tm.get_point_cloud(), jm.get_point_cloud()
    assert_same_cloud((t_cloud["points"], t_cloud["probabilities"]),
                      (j_cloud["points"], j_cloud["probabilities"]), tol)
    t_cls = tm.get_point_cloud(include_free=True)
    j_cls = jm.get_point_cloud(include_free=True)
    for k in ("occupied", "free", "unknown"):
        assert_same_cloud(t_cls[k], j_cls[k], tol)
    for k in ("min", "max"):
        np.testing.assert_array_equal(t_cls["bounds"][k],
                                      np.asarray(j_cls["bounds"][k]))
    pts = np.concatenate([t_cloud["points"][::7], [[50.0, 50.0, 50.0]]])
    np.testing.assert_allclose(tm.query_probabilities(pts),
                               jm.query_probabilities(pts), rtol=0, atol=tol)
    x, y, z = pts[0]
    assert abs(tm.get_log_odds(x, y, z) - jm.get_log_odds(x, y, z)) <= tol
    assert tm.get_probability(50.0, 50.0, 50.0) == 0.5
    cap = tm.state.local_capacity
    tm.reset_map()
    assert tm.num_voxels == 0 and tm.frame_count == 0
    assert tm.state.local_capacity == cap and len(tm.state.shards) == 4


def test_hash_backend_maps_like_the_brick_backend(small_cfg):
    """backend="hash" (the JAX mapper's default) maps: per-ping stats,
    touched voxels and log-odds equal the brick mapper's, in float64
    (against the JAX hash mapper: tests/test_torch_hash.py)."""
    from sonar_3d_reconstruction_tpu_torch.grid.hash import touched_voxels_hash

    cfg = port_cfg(small_cfg)
    images, positions, quats = survey(small_cfg, 3, seed=78)
    h = SonarMapper(cfg, backend="hash", dtype=torch.float64, device="cpu")
    b = SonarMapper(cfg, dtype=torch.float64, device="cpu")
    assert h.backend == "hash" and b.backend == "brick"
    for x in zip(images, positions, quats):
        assert (without_times(h.process_sonar_image(*x))
                == without_times(b.process_sonar_image(*x)))
    keys, lo = touched_voxels_hash(h.state)
    b_keys, b_lo = touched_voxels_brick(b.state)
    order, b_order = np.lexsort(keys.T), np.lexsort(b_keys.T)
    np.testing.assert_array_equal(keys[order], b_keys[b_order])
    np.testing.assert_array_equal(lo[order], b_lo[b_order])


def test_mapper_runs_on_the_card_unless_told():
    """With no device the map lives on the first CUDA device; without one
    that is a RuntimeError, never a quiet fall back to the CPU."""
    assert SonarMapper(device="cpu").state.log_odds.device.type == "cpu"
    if torch.cuda.is_available():
        m = SonarMapper()
        assert m.state.log_odds.device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SonarMapper()


def test_sharded_mapper_starts_at_its_grown_budgets(small_cfg, monkeypatch):
    """The sharded mapper hands each call the budgets the last one settled
    on, as the JAX mapper's sticky ``_sharded_budgets`` do: seeded with a
    128-lane exchange budget, its first ``map_sequence`` grows it to the
    JAX mapper's sticky budgets (and voxels); the second call starts at
    them and grows nothing."""
    import jax

    from sonar_3d_reconstruction_tpu.parallel.shard import (
        make_mesh as j_make_mesh,
    )
    from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
        local_brick_states as j_local_brick_states,
    )
    from sonar_3d_reconstruction_tpu_torch.models import mapper as mapper_mod
    from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (
        local_brick_states,
    )

    cfg = small_cfg
    jm = JaxMapper(cfg, backend="brick-sharded", initial_capacity=1 << 16,
                   dtype=jax.numpy.float64,
                   mesh=j_make_mesh(jax.devices()[:4]))
    tm = SonarMapper(port_cfg(cfg), backend="brick-sharded",
                     initial_capacity=1 << 16, dtype=torch.float64,
                     mesh=["cpu"] * 4)
    assert tm._sharded_budgets == {}
    jm._sharded_budgets = {"xchg_budget": 128}
    tm._sharded_budgets = {"xchg_budget": 128}
    images, positions, quats = survey(cfg, 8, seed=630)
    halves = [(images[a:b], positions[a:b], quats[a:b])
              for a, b in ((0, 4), (4, 8))]
    tm.map_sequence(*halves[0], window=4)
    jm.map_sequence(*halves[0], window=4)
    sticky = {k: v for k, v in jm._sharded_budgets.items()
              if k != "box_min_bits"}
    assert tm._sharded_budgets == sticky
    assert sticky["xchg_budget"] > 128
    calls = []
    engine = mapper_mod.map_ping_sequence_sharded_frames

    def recording(*args, **kw):
        calls.append(dict(kw))
        return engine(*args, **kw)

    monkeypatch.setattr(mapper_mod, "map_ping_sequence_sharded_frames",
                        recording)
    tm.map_sequence(*halves[1], window=4)
    jm.map_sequence(*halves[1], window=4)
    assert calls[0]["xchg_budget"] == sticky["xchg_budget"]
    assert tm._sharded_budgets == sticky
    for t_s, j_s in zip(local_brick_states(tm.state),
                        j_local_brick_states(jm.state)):
        assert_same_voxels(t_s, j_s, torch.float64)
