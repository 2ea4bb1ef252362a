"""The port's brick main path end to end: ``map_ping_sequence`` vs the JAX
package's ``scan_pings_brick(dense_mode="pallas-tb16", boxes=...)`` and vs
the golden oracle, growth with replay, the fatal range error, and a run
with JAX blocked from import.  The raw-candidate path
(``dense_mode="pallas-raw"``) against the JAX package's raw scan and
against the port's own dedup path.

Tolerances: map state and integer stats bit-equal except log-odds within
EXP_ULP_TOL (tests/torch_parity.py); occupancy probabilities within 1e-5
of the golden float64 oracle in float32 and float64.
"""

import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.golden import GoldenMapper  # noqa: E402
from sonar_3d_reconstruction_tpu.grid.brick import (  # noqa: E402
    init_brick_grid as j_init_brick_grid,
)
from sonar_3d_reconstruction_tpu.ops.backproject import (  # noqa: E402
    resolve_capped_tables as j_resolve_capped_tables,
)
from sonar_3d_reconstruction_tpu.ops.packing import (  # noqa: E402
    compute_window_boxes as j_compute_window_boxes,
)
from sonar_3d_reconstruction_tpu.pipeline import (  # noqa: E402
    batched_sonar_to_world as j_batched_sonar_to_world,
    scan_pings_brick as j_scan_pings_brick,
)

from sonar_3d_reconstruction_tpu_torch import pipeline  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    _unpack_touched,
    brick_state_to_numpy,
    extract_occupied_brick,
    init_brick_grid,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (  # noqa: E402
    resolve_capped_tables,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import (  # noqa: E402
    EMPTY_HI,
    unpack_brick_keys,
)
from sonar_3d_reconstruction_tpu_torch.ops.records import frame_records  # noqa: E402

from test_shard_brick import make_seq  # noqa: E402
from torch_parity import (  # noqa: E402
    DTYPES,
    assert_brick_states_match,
    jax_brick_state_to_numpy,
    port_cfg,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROB_TOL = 1e-5
STATS = ("num_occupied", "num_free", "num_candidates", "overflowed",
         "batch_n_bricks", "batch_n_lanes")


def port_state_to_dict(state):
    """{(kx, ky, kz): log_odds} over the touched voxels of a port state."""
    occ = state.key_hi != EMPTY_HI
    base = unpack_brick_keys(state.key_hi[occ], state.key_lo[occ], 2).numpy()
    rows = state.log_odds[occ].numpy()
    bits = _unpack_touched(state.touched[occ], 64).numpy()
    off = np.arange(64)
    offs = np.stack([off >> 4, (off >> 2) & 3, off & 3], axis=-1)
    return {
        tuple(base[i] + offs[v]): float(rows[i, v])
        for i, v in zip(*np.nonzero(bits))
    }


@functools.lru_cache(maxsize=None)
def golden(cfg, n, seed):
    images, positions, quats = make_seq(cfg, n, seed=seed)
    g = GoldenMapper(cfg)
    stats = [g.process_ping(*x) for x in zip(images, positions, quats)]
    return g, stats


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_slice_matches_jax_scan(small_cfg, t_dtype, j_dtype):
    """12 pings in windows of 4 (one growth-free pass): same map state and
    per-ping stats as the JAX engine with the Pallas binning kernel."""
    cfg, window = small_cfg, 4
    images, positions, quats = make_seq(cfg, 12, seed=61)
    T = j_batched_sonar_to_world(positions, quats, cfg)
    boxes = j_compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, window, 2,
        frame_bits=max(1, (window - 1).bit_length()),
    )
    want_st, want = j_scan_pings_brick(
        j_init_brick_grid(1 << 15, j_dtype), jnp.asarray(images),
        jnp.asarray(T, j_dtype),
        tables=j_resolve_capped_tables(images, cfg, 100, 64), cfg=cfg,
        dtype=j_dtype, window=window, brick_budget=2048, boxes=boxes,
        dense_mode="pallas-tb16",
    )
    assert not np.asarray(want["overflowed"]).any()
    got_st, got = pipeline.map_ping_sequence(
        images, positions, quats, port_cfg(cfg), device="cpu", dtype=t_dtype,
        window=window,
    )
    for k in STATS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert (got["num_candidates"] > 0).all()
    assert_brick_states_match(
        brick_state_to_numpy(got_st), jax_brick_state_to_numpy(want_st), t_dtype
    )


@pytest.mark.parametrize(
    "t_dtype", [torch.float64, torch.float32], ids=["f64", "f32"]
)
def test_slice_matches_golden(small_cfg, t_dtype):
    """Same voxels as the golden oracle, probabilities within 1e-5, and the
    reference's per-frame unique stats."""
    cfg = small_cfg
    images, positions, quats = make_seq(cfg, 8, seed=62)
    g, g_stats = golden(cfg, 8, 62)
    st, stats = pipeline.map_ping_sequence(
        images, positions, quats, port_cfg(cfg), device="cpu", dtype=t_dtype,
        window=3,
    )
    np.testing.assert_array_equal(
        stats["num_occupied"], [s["num_occupied"] for s in g_stats]
    )
    np.testing.assert_array_equal(
        stats["num_free"], [s["num_free"] for s in g_stats]
    )
    got = port_state_to_dict(st)
    assert got.keys() == g.map.log_odds.keys()
    for key, lo in g.map.log_odds.items():
        p_gold = 1.0 / (1.0 + np.exp(-lo))
        p_got = 1.0 / (1.0 + np.exp(-got[key]))
        assert abs(p_got - p_gold) < PROB_TOL, (key, p_got, p_gold)
    pts, probs = extract_occupied_brick(st, port_cfg(cfg))
    occ = g.point_cloud()
    assert len(pts) == occ["num_occupied"] > 0
    order = np.lexsort(occ["points"].T[::-1])
    got_order = np.lexsort(pts.T[::-1])
    np.testing.assert_allclose(pts[got_order], occ["points"][order], atol=1e-9)
    np.testing.assert_allclose(
        probs[got_order], occ["probabilities"][order], atol=PROB_TOL
    )


def test_growth_replays_to_the_same_map(small_cfg):
    """A one-bucket table overflows, grows and replays the failed window;
    the map equals a run that never had to grow."""
    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, 9, seed=63)
    grown, g_stats = pipeline.map_ping_sequence(
        images, positions, quats, cfg, device="cpu", dtype=torch.float64,
        window=3, state=init_brick_grid(128, torch.float64, "cpu"),
    )
    big, b_stats = pipeline.map_ping_sequence(
        images, positions, quats, cfg, device="cpu", dtype=torch.float64,
        window=3,
    )
    assert grown.capacity > 128
    for k in STATS:
        np.testing.assert_array_equal(g_stats[k], b_stats[k], err_msg=k)
    assert not bool(grown.poisoned) and int(grown.used) == int(big.used)
    for a, b in zip(extract_occupied_brick(grown, cfg),
                    extract_occupied_brick(big, cfg)):
        np.testing.assert_array_equal(a, b)
    assert port_state_to_dict(grown) == port_state_to_dict(big)


def test_keys_outside_the_box_are_fatal(small_cfg, monkeypatch):
    """range_fail cannot be grown away: map_ping_sequence raises."""
    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, 4, seed=64)
    real = pipeline.compute_window_boxes

    def tiny_boxes(*args, **kw):
        mins, _ = real(*args, **kw)
        return mins, (1, 1, 1)

    monkeypatch.setattr(pipeline, "compute_window_boxes", tiny_boxes)
    with pytest.raises(ValueError, match="packable range"):
        pipeline.map_ping_sequence(
            images, positions, quats, cfg, device="cpu", window=2,
        )


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_raw_slice_matches_jax_scan(small_cfg, t_dtype, j_dtype):
    """6 pings in windows of 4 (a half-empty tail window) in raw mode: same
    map state and per-ping stats as the JAX engine's raw scan
    (``dense_mode="pallas-raw"``, the Pallas kernel's stats_out form);
    both count candidate lanes in ``batch_n_lanes``."""
    cfg, window = small_cfg, 4
    images, positions, quats = make_seq(cfg, 6, seed=57)
    T = j_batched_sonar_to_world(positions, quats, cfg)
    boxes = j_compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, window, 2,
        frame_bits=max(1, (window - 1).bit_length()),
    )
    want_st, want = j_scan_pings_brick(
        j_init_brick_grid(1 << 15, j_dtype), jnp.asarray(images),
        jnp.asarray(T, j_dtype),
        tables=j_resolve_capped_tables(images, cfg, 100, 64), cfg=cfg,
        dtype=j_dtype, window=window, brick_budget=2048, boxes=boxes,
        dense_mode="pallas-raw",
    )
    assert not np.asarray(want["overflowed"]).any()
    got_st, got = pipeline.map_ping_sequence(
        images, positions, quats, port_cfg(cfg), device="cpu", dtype=t_dtype,
        window=window, dense_mode="pallas-raw",
    )
    for k in STATS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert_brick_states_match(
        brick_state_to_numpy(got_st), jax_brick_state_to_numpy(want_st), t_dtype
    )


@pytest.mark.parametrize(
    "t_dtype", [torch.float64, torch.float32], ids=["f64", "f32"]
)
def test_raw_path_equals_dedup_path(small_cfg, t_dtype):
    """Raw and dedup mode give the same map bit for bit and the same
    per-ping stats, through a growth and replay from a one-bucket table;
    only ``batch_n_lanes`` differs (candidate vs record lanes)."""
    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, 9, seed=66)
    out = {
        mode: pipeline.map_ping_sequence(
            images, positions, quats, cfg, device="cpu", dtype=t_dtype,
            window=4, dense_mode=mode,
            state=init_brick_grid(128, t_dtype, "cpu"),
        )
        for mode in ("pallas", "pallas-raw")
    }
    (d_st, d_stats), (r_st, r_stats) = out["pallas"], out["pallas-raw"]
    assert r_st.capacity == d_st.capacity > 128
    np.testing.assert_equal(brick_state_to_numpy(r_st), brick_state_to_numpy(d_st))
    for k in pipeline.STAT_DTYPES:
        if k != "batch_n_lanes":
            np.testing.assert_array_equal(r_stats[k], d_stats[k], err_msg=k)
    assert (r_stats["batch_n_lanes"] > d_stats["batch_n_lanes"]).all()


def test_raw_mode_keeps_candidates_past_the_unique_count():
    """Raw records sit where the candidate lattice put them, not in a
    prefix: cutting them to their valid count, as unique records are cut,
    would drop the valid candidates that lie past it (here the far-range
    returns and the free space before them)."""
    cfg = MapperConfig(image_width=32, image_height=60, max_range=5.0,
                       voxel_resolution=0.1, intensity_threshold=30)
    images = np.zeros((2, 60, 32), np.uint8)
    images[:, 52:56, 10:20] = 200   # far range bins only
    positions = np.stack([0.1 * np.arange(2), np.zeros(2), np.zeros(2)], -1)
    quats = np.tile([0.0, 0.0, 0.0, 1.0], (2, 1))
    out = {
        mode: pipeline.map_ping_sequence(
            images, positions, quats, cfg, device="cpu", dtype=torch.float64,
            window=2, dense_mode=mode,
        )
        for mode in ("pallas", "pallas-raw")
    }
    (d_st, d_stats), (r_st, r_stats) = out["pallas"], out["pallas-raw"]
    # the trap is armed: valid raw lanes lie beyond the frame's valid count
    T = pipeline.batched_sonar_to_world(positions, quats, cfg)
    box_mins, box_bits = pipeline.compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, 2, 2, frame_bits=1
    )
    rec, _ = frame_records(
        torch.as_tensor(images[0]), torch.as_tensor(T[0]),
        resolve_capped_tables(images, cfg, 60, 32), cfg,
        torch.as_tensor(box_mins[0]), box_bits, 2, dtype=torch.float64,
        raw=True,
    )
    lanes = np.flatnonzero(rec.valid.numpy())
    assert (lanes >= int(rec.n_unique)).sum() > 0
    assert (d_stats["num_candidates"] > 0).all()
    for k in ("num_candidates", "num_occupied", "num_free"):
        np.testing.assert_array_equal(r_stats[k], d_stats[k], err_msg=k)
    np.testing.assert_equal(brick_state_to_numpy(r_st), brick_state_to_numpy(d_st))


@pytest.mark.parametrize("mode", [
    pytest.param("bfv-raw", id="bfv"),
    pytest.param("pallas-tb16-tb8", id="pallas-tb16"),
])
def test_map_ping_sequence_rejects_other_dense_modes(small_cfg, mode):
    """The JAX package's spellings are accepted (test_torch_budgets.py);
    a spelling it does not parse, such as raw records on an XLA layout or
    a repeated tile suffix, is refused, not ignored."""
    images, positions, quats = make_seq(small_cfg, 2, seed=65)
    with pytest.raises(ValueError, match="pallas-raw"):
        pipeline.map_ping_sequence(
            images, positions, quats, port_cfg(small_cfg), device="cpu",
            dense_mode=mode,
        )


def test_map_ping_sequence_rejects_what_it_does_not_map(small_cfg):
    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, 2, seed=65)
    for backend in ("brick-sharded", "octree"):
        with pytest.raises(ValueError, match="unknown backend"):
            pipeline.map_ping_sequence(images, positions, quats, cfg,
                                       device="cpu", backend=backend)
    with pytest.raises(ValueError, match="does not match backend='hash'"):
        pipeline.map_ping_sequence(
            images, positions, quats, cfg, device="cpu", backend="hash",
            state=init_brick_grid(256, torch.float32, "cpu"),
        )
    with pytest.raises(ValueError, match="float64"):
        pipeline.map_ping_sequence(
            images, positions, quats, cfg, device="cpu", dtype=torch.float32,
            state=init_brick_grid(256, torch.float64, "cpu"),
        )
    st, stats = pipeline.map_ping_sequence(
        images[:0], positions[:0], quats[:0], cfg, device="cpu"
    )
    assert int(st.used) == 0 and all(len(v) == 0 for v in stats.values())


def test_map_ping_sequence_takes_the_callers_tables(small_cfg):
    """Exact (uncapped) fan tables given by the caller map the same as the
    capped tables built by default; tables of another geometry are
    refused."""
    from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
        build_fan_tables,
    )

    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, 4, seed=67)
    exact = build_fan_tables(cfg, 100, 64)
    assert exact is not resolve_capped_tables(images, cfg, 100, 64)
    given, g_stats = pipeline.map_ping_sequence(
        images, positions, quats, cfg, device="cpu", dtype=torch.float64,
        window=2, tables=exact,
    )
    default, d_stats = pipeline.map_ping_sequence(
        images, positions, quats, cfg, device="cpu", dtype=torch.float64,
        window=2,
    )
    for k in pipeline.STAT_DTYPES:
        np.testing.assert_array_equal(g_stats[k], d_stats[k], err_msg=k)
    np.testing.assert_equal(brick_state_to_numpy(given),
                            brick_state_to_numpy(default))
    with pytest.raises(ValueError, match="100x48"):
        pipeline.map_ping_sequence(
            images, positions, quats, cfg, device="cpu",
            tables=build_fan_tables(cfg, 100, 48),
        )


def test_map_ping_sequence_runs_on_the_card_unless_told(small_cfg):
    """With no device the map is made on the first CUDA device; without one
    that is a RuntimeError, never a quiet fall back to the CPU."""
    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, 2, seed=66)
    on_cpu, stats = pipeline.map_ping_sequence(
        images, positions, quats, cfg, device="cpu", window=2
    )
    assert on_cpu.log_odds.device.type == "cpu"
    assert (stats["num_candidates"] > 0).all()
    if torch.cuda.is_available():
        st, _ = pipeline.map_ping_sequence(images, positions, quats, cfg,
                                           window=2)
        assert st.log_odds.device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pipeline.map_ping_sequence(images, positions, quats, cfg, window=2)


def test_port_runs_with_jax_blocked():
    """The port and its CPU path import neither jax, the JAX package nor
    the root bench.py: the main path (with batched records too, and a
    budget plan from utils.autotune), the
    bench's survey and one bench run, the hash backend (pipeline, snapshot, mapper), wide
    keys, the dense backend (pipeline, mapper), the multi-host fold, the
    sharded brick engine (engine, with budgets, snapshot, mapper), every module of the port (the stream, the node and the debug
    overlay included), a stream over the same pings, the CLI's
    selftest, the port's golden oracle over the same pings, and one
    trial of the port's golden fuzz (scripts/torch_fuzz_golden.py)
    through every engine, and the bench's trace
    (scripts/torch_profile_bench.py)."""
    code = textwrap.dedent("""
        import sys
        for name in list(sys.modules):
            if name.split(".")[0] in ("jax", "jaxlib"):
                del sys.modules[name]
        for name in ("jax", "jaxlib", "sonar_3d_reconstruction_tpu",
                     "bench"):
            sys.modules[name] = None
        import numpy as np, torch
        from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
        from sonar_3d_reconstruction_tpu_torch.grid.brick import (
            extract_occupied_brick)
        from sonar_3d_reconstruction_tpu_torch.pipeline import (
            map_ping_sequence)
        cfg = MapperConfig(image_width=32, image_height=60, max_range=5.0,
                           voxel_resolution=0.1, intensity_threshold=30)
        rng = np.random.default_rng(0)
        images = rng.integers(0, 20, size=(3, 60, 32)).astype(np.uint8)
        images[:, 30:36, :] = 150
        pos = np.stack([0.1 * np.arange(3), np.zeros(3), np.zeros(3)], -1)
        q = np.tile([0.0, 0.0, 0.0, 1.0], (3, 1))
        st, stats = map_ping_sequence(images, pos, q, cfg, device="cpu",
                                      window=2)
        pts, probs = extract_occupied_brick(st, cfg)
        assert stats["num_candidates"].min() > 0 and len(pts) > 0
        r_st, r_stats = map_ping_sequence(images, pos, q, cfg, device="cpu",
                                          window=2, dense_mode="pallas-raw")
        assert torch.equal(r_st.log_odds, st.log_odds)
        assert (r_stats["num_occupied"] == stats["num_occupied"]).all()
        b_st, b_stats = map_ping_sequence(images, pos, q, cfg, device="cpu",
                                          window=2, records_batch=4,
                                          window_group=2)
        assert torch.equal(b_st.log_odds, st.log_odds)
        assert (b_stats["num_free"] == stats["num_free"]).all()
        from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
        survey = make_inputs(MapperConfig(), 2)
        assert survey[0].shape == (2, 500, 512)
        import os, tempfile
        from sonar_3d_reconstruction_tpu_torch.grid.hash import (
            extract_occupied_hash, touched_voxels_hash)
        from sonar_3d_reconstruction_tpu_torch.io.checkpoint import (
            load_map, save_map)
        h_st, h_stats = map_ping_sequence(images, pos, q, cfg, device="cpu",
                                          window=2, backend="hash")
        h_pts, _ = extract_occupied_hash(h_st, cfg)
        assert (h_stats["num_occupied"] == stats["num_occupied"]).all()
        assert sorted(map(tuple, h_pts)) == sorted(map(tuple, pts))
        snap = os.path.join(tempfile.mkdtemp(), "h.npz")
        save_map(snap, h_st, cfg)
        l_st, _ = load_map(snap, device="cpu")
        assert int(l_st.used) == int(h_st.used)
        far = pos.copy()
        far[2] = [3000.0, 3000.0, 0.0]  # a window too wide for box keys
        w_st, w_stats = map_ping_sequence(images, far, q, cfg, device="cpu",
                                          window=3)
        wh_st, _ = map_ping_sequence(images, far, q, cfg, device="cpu",
                                     window=3, backend="hash")
        assert int(w_st.used) == int(wh_st.used) > int(st.used)
        from sonar_3d_reconstruction_tpu_torch.models import SonarMapper
        hm = SonarMapper(cfg, backend="hash", device="cpu")
        for i in range(3):
            hm.process_sonar_image(images[i], pos[i], q[i])
        assert hm.num_voxels == int(h_st.used)
        d_st, d_stats = map_ping_sequence(images, pos, q, cfg, device="cpu",
                                          backend="dense")
        assert (d_stats["num_occupied"] == stats["num_occupied"]).all()
        dm = SonarMapper(cfg, backend="dense", device="cpu")
        dm.process_sonar_image(images[0], pos[0], q[0])
        assert 0 < dm.num_voxels <= int(d_st.touched.sum())
        from sonar_3d_reconstruction_tpu_torch.parallel import (
            map_ping_sequence_multihost)
        m_st, _ = map_ping_sequence_multihost(images, pos, q, cfg, n_hosts=2,
                                              window=2, device="cpu")
        assert int(m_st.used) == int(st.used)
        from sonar_3d_reconstruction_tpu_torch.io.checkpoint import (
            load_map_sharded_brick)
        from sonar_3d_reconstruction_tpu_torch.parallel import (
            map_ping_sequence_sharded_frames)
        s_st, s_stats = map_ping_sequence_sharded_frames(
            images, pos, q, cfg, mesh=["cpu"] * 3, window=2)
        assert int(s_st.used.sum()) == int(st.used)
        assert (s_stats["num_occupied"] == stats["num_occupied"]).all()
        b_eff = {}
        bs_st, bs_stats = map_ping_sequence_sharded_frames(
            images, pos, q, cfg, mesh=["cpu"] * 3, window=2,
            unique_budget=256, xchg_budget=64, effective=b_eff)
        assert int(bs_st.used.sum()) == int(st.used)
        assert (bs_stats["num_free"] == stats["num_free"]).all()
        assert b_eff["unique_budget"] >= 256
        save_map(snap, s_st, cfg)
        l_st, _ = load_map_sharded_brick(snap, mesh=["cpu"] * 2)
        assert int(l_st.used.sum()) == int(st.used)
        sm = SonarMapper(cfg, backend="brick-sharded", mesh=["cpu"] * 2)
        sm.map_sequence(images, pos, q, window=2)
        assert sm.num_voxels == int(st.used)
        import runpy
        from sonar_3d_reconstruction_tpu_torch import cli, config
        from sonar_3d_reconstruction_tpu_torch.io import (
            bag, checkpoint, debugviz, image, mcap, native, pointcloud,
            timesync)
        from sonar_3d_reconstruction_tpu_torch.models import SonarMapper
        from sonar_3d_reconstruction_tpu_torch import node, stream
        assert config.PRESETS and SonarMapper and image and pointcloud
        assert timesync and mcap and native and bag and checkpoint and cli
        assert debugviz and node._NODE_PARAM_DEFAULTS and stream
        sm = stream.StreamingMapper(cfg, chunk_size=2, window=2,
                                    device="cpu")
        for i in range(3):
            sm.on_ping(bag.ImageMsg(1.0 + i, "sonar_link", 60, 32, "mono8",
                                    False, 32, images[i].tobytes()))
            sm.on_pose(bag.OdometryMsg(1.0 + i, "map", "base", pos[i], q[i]))
        sm.finish()
        assert sm.stats.frames_mapped == 3
        s_pts, s_probs = extract_occupied_brick(sm.state, cfg)
        assert np.array_equal(s_pts, pts) and np.array_equal(s_probs, probs)
        from sonar_3d_reconstruction_tpu_torch.utils.autotune import (
            tune_sequence)
        plan = tune_sequence(images, pos, q, cfg, window=2, device="cpu")
        t_st, t_stats = map_ping_sequence(images, pos, q, cfg, device="cpu",
                                          window=2, budgets=plan)
        t_pts, _ = extract_occupied_brick(t_st, cfg)
        assert np.array_equal(t_pts, pts)
        assert (t_stats["num_free"] == stats["num_free"]).all()
        sys.argv = ["sonar3d", "selftest", "--device", "cpu"]
        try:
            runpy.run_module("sonar_3d_reconstruction_tpu_torch",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        os.environ.update(BENCH_PINGS="1", BENCH_REPS="1", BENCH_LATENCY="0")
        assert cli.main(["bench", "--device", "cpu"]) == 0
        from sonar_3d_reconstruction_tpu_torch.golden import GoldenMapper
        from sonar_3d_reconstruction_tpu_torch.grid.brick import (
            touched_voxels_brick)
        g = GoldenMapper(cfg)
        for i in range(3):
            g.process_ping(images[i], pos[i], q[i])
        g_pts = g.point_cloud()["points"]
        assert len(g_pts) == len(pts) > 0
        assert set(g.map.log_odds) == set(
            map(tuple, touched_voxels_brick(st)[0].tolist()))
        sys.path.insert(0, "scripts")
        import torch_fuzz_golden
        trial = torch_fuzz_golden.run_trial(
            2016, device="cpu", dtype=torch.float64)
        assert trial.failure is None, trial.message
        assert len(trial.engines) == len(torch_fuzz_golden.ENGINES)
        import torch_profile_bench
        assert torch_profile_bench.main(
            ["--device", "cpu", "--out", tempfile.mkdtemp()]) == 0
        loaded = [m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "sonar_3d_reconstruction_tpu", "bench")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("ok", len(pts))
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "final map: 5710 occupied of 84325 voxels on cpu" in proc.stdout
    assert proc.stdout.splitlines()[-1].startswith("ok")
