"""The port's streaming runtime against the JAX package's brick stream
(the hash stream against the JAX one: tests/test_torch_hash.py).

Both streams replay the same bags (numpy seeds, small geometry).  Maps are
compared voxel by voxel in extraction order (slots may differ); the pairing
counters (pairs, frames, chunks, decode errors, unsynced drops, mean stamp
skew, one latency per mapped frame) exactly.

Tolerances: voxel keys and published points exactly; log-odds within
EXP_ULP_TOL (tests/torch_parity.py: 1e-12 in float64, 1e-5 in float32);
published float32 probabilities of float64 maps within 1e-6.  Within the
port, the raw mode's map is bit-equal to the dedup mode's and a windowed
stream's to a per-ping one's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu.config import StreamConfig as JStreamConfig  # noqa: E402
from sonar_3d_reconstruction_tpu.grid.brick import (  # noqa: E402
    touched_voxels_brick as j_touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu.io.bag import write_synthetic_bag  # noqa: E402
from sonar_3d_reconstruction_tpu.stream import (  # noqa: E402
    StreamingMapper as JaxStream,
)

from sonar_3d_reconstruction_tpu_torch import pipeline  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.config import StreamConfig  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    brick_state_to_numpy,
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu_torch.io.bag import ImageMsg, OdometryMsg  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.io.pointcloud import (  # noqa: E402
    parse_pointcloud2,
)
from sonar_3d_reconstruction_tpu_torch.stream import StreamingMapper  # noqa: E402

from conftest import circular_trajectory, synthetic_ping  # noqa: E402
from torch_parity import EXP_ULP_TOL, port_cfg  # noqa: E402

# the module fixture's config: conftest's small_cfg, which is per test
SMALL_CFG = MapperConfig(image_width=64, image_height=100, max_range=5.0,
                         min_range=0.5, voxel_resolution=0.1,
                         intensity_threshold=30)
COUNTERS = ("pairs", "frames_mapped", "chunks", "decode_errors",
            "dropped_unsynced")


def make_bag(path, cfg, n, seed, **kw):
    images = np.stack([
        synthetic_ping(cfg.image_height, cfg.image_width, seed=seed + i)
        for i in range(n)
    ])
    positions, quats = circular_trajectory(n, radius=0.8)
    write_synthetic_bag(str(path), images, positions, quats, **kw)
    return str(path), images, positions, quats


def stream(cfg, path=None, rate=0.0, dtype=torch.float64, **kw):
    """A port stream on the CPU over ``path`` (when given); returns
    (mapper, published messages)."""
    published = []
    sm = StreamingMapper(
        port_cfg(cfg), StreamConfig(publish_rate_hz=rate), dtype=dtype,
        publish=published.append, device="cpu", **kw,
    )
    if path is not None:
        sm.run_bag(path)
    return sm, published


def jax_stream(cfg, path, rate=0.0, dtype=jnp.float64, **kw):
    published = []
    sm = JaxStream(cfg, JStreamConfig(publish_rate_hz=rate), dtype=dtype,
                   backend="brick", publish=published.append, **kw)
    sm.run_bag(path)
    return sm, published


def assert_same_counters(got, want):
    g, w = got.summary(), want.summary()
    for k in COUNTERS:
        assert g[k] == w[k], k
    assert g["avg_stamp_skew"] == pytest.approx(w["avg_stamp_skew"], abs=1e-12)
    assert len(got.latencies) == len(want.latencies) == g["frames_mapped"]


def assert_same_voxels(t_state, j_state, tol):
    keys, lo = touched_voxels_brick(t_state)
    j_keys, j_lo = j_touched_voxels_brick(j_state)
    np.testing.assert_array_equal(keys, j_keys)
    np.testing.assert_allclose(lo, j_lo, rtol=0, atol=tol)


def assert_states_equal(a, b):
    np.testing.assert_equal(brick_state_to_numpy(a), brick_state_to_numpy(b))


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    """An 8-ping bag at 2 Hz and the JAX brick stream's run over it: chunk
    3, window 3, float64, publishing at 2 Hz of stream time.

    Every xdist worker that takes a test of this module runs this fixture,
    so the JAX stream compiles one set of programs: a table that never
    grows (8,192 bricks) and the worst-case lattice caps, which map
    exactly as the grown caps do.  Growth and cap growth are the port's to
    show (the tests below start it from 8 and 16 bricks); the JAX run is
    the map they are held to."""
    cfg = SMALL_CFG
    path, images, positions, quats = make_bag(
        tmp_path_factory.mktemp("stream") / "survey.db3", cfg, 8,
        seed=100, rate_hz=2.0,
    )
    j_sm, j_pub = jax_stream(cfg, path, rate=2.0, chunk_size=3,
                             window=3, initial_capacity=1 << 17,
                             fan_cap=None, window_cap=None, free_cap=None)
    return dict(path=path, images=images, positions=positions, quats=quats,
                jax=j_sm, jax_published=j_pub)


def test_stream_matches_jax_stream_and_direct_pipeline(survey, small_cfg):
    """Bag replay, the brick stream, growth and the publish callback: the
    same counters, voxels and published clouds as the JAX stream, and the
    same map as the port's direct pipeline."""
    sm, published = stream(small_cfg, survey["path"], rate=2.0, chunk_size=3,
                           window=3, initial_capacity=1 << 8)
    assert_same_counters(sm.stats, survey["jax"].stats)
    assert sm.stats.chunks == 3  # 3 + 3 + 2
    assert sm.stats.grows > 0  # 16 bricks to start with
    assert sm.state.log_odds.device.type == "cpu"
    assert_same_voxels(sm.state, survey["jax"].state, EXP_ULP_TOL[torch.float64])
    direct, _ = pipeline.map_ping_sequence(
        survey["images"], survey["positions"], survey["quats"],
        port_cfg(small_cfg), device="cpu", dtype=torch.float64, window=3,
    )
    np.testing.assert_equal(touched_voxels_brick(sm.state),
                            touched_voxels_brick(direct))

    j_published = survey["jax_published"]
    assert len(published) == len(j_published) >= 2
    for msg, j_msg in zip(published, j_published):
        assert msg["header"] == j_msg["header"]
        pts, probs = parse_pointcloud2(msg)
        j_pts, j_probs = parse_pointcloud2(j_msg)
        assert len(pts) > 0
        np.testing.assert_array_equal(pts, j_pts)
        np.testing.assert_allclose(probs, j_probs, rtol=0, atol=1e-6)
        assert (probs > small_cfg.min_probability).all() and (probs <= 1).all()


def test_stream_growth_from_tiny_capacity(survey, small_cfg):
    """An 8-brick table doubles as often as it must, and the map equals the
    JAX stream's."""
    sm, _ = stream(small_cfg, survey["path"], chunk_size=5,
                   initial_capacity=1 << 7)
    assert sm.stats.grows >= 1
    assert sm.state.capacity == 128 << sm.stats.grows
    assert_same_voxels(sm.state, survey["jax"].state, EXP_ULP_TOL[torch.float64])


def test_stream_window_engine_matches_per_ping(survey, small_cfg):
    """Windows of 3 give the map of window 1 bit for bit, under growth."""
    runs = [stream(small_cfg, survey["path"], chunk_size=3, window=w,
                   initial_capacity=1 << 7)[0] for w in (1, 3)]
    assert runs[1].stats.grows > 0
    assert [r.stats.frames_mapped for r in runs] == [8, 8]
    np.testing.assert_equal(touched_voxels_brick(runs[0].state),
                            touched_voxels_brick(runs[1].state))


def test_raw_mode_stream_equals_dedup_stream(survey, small_cfg):
    """dense_mode="pallas-raw" (raw candidates summed by K1's raw form)
    gives the dedup stream's state bit for bit."""
    dedup, raw = (stream(small_cfg, survey["path"], chunk_size=3, window=3,
                         dense_mode=m)[0] for m in ("pallas", "pallas-raw"))
    assert raw.dense_mode == "pallas-raw"
    assert_states_equal(dedup.state, raw.state)


def test_stream_chunk_one_matches_jax_stream(survey, small_cfg):
    """The low-latency configuration, chunk = window = 1: one chunk a ping,
    the JAX stream's counters and map."""
    sm, _ = stream(small_cfg, survey["path"], chunk_size=1, window=1)
    j_sm, _ = jax_stream(small_cfg, survey["path"], chunk_size=1, window=1)
    assert sm.stats.chunks == sm.stats.frames_mapped == 8
    assert_same_counters(sm.stats, j_sm.stats)
    assert_same_voxels(sm.state, j_sm.state, EXP_ULP_TOL[torch.float64])


def test_stream_jittered_odometry_matches_jax(tmp_path, small_cfg):
    """Odometry stamps 80 ms off the pings (within the 0.1 s slop) pair
    every ping, as in the JAX stream; float32 maps agree."""
    path, *_ = make_bag(tmp_path / "jitter.db3", small_cfg, 6, seed=300,
                        odom_jitter=0.08)
    sm, _ = stream(small_cfg, path, chunk_size=4, dtype=torch.float32)
    j_sm, _ = jax_stream(small_cfg, path, chunk_size=4, dtype=jnp.float32)
    assert sm.stats.pairs == 6
    assert 0 < sm.stats.summary()["avg_stamp_skew"] <= 0.08 + 1e-9
    assert_same_counters(sm.stats, j_sm.stats)
    assert_same_voxels(sm.state, j_sm.state, EXP_ULP_TOL[torch.float32])


def test_stream_caps_grow_only_like_jax(tmp_path, small_cfg):
    """The free-lattice depth follows the deepest first hit seen so far,
    growing only (a table rebuild each time, counted as in the JAX
    stream), and the map equals the JAX stream's."""
    R, B = small_cfg.image_height, small_cfg.image_width
    rng = np.random.default_rng(8)
    n = 6
    images = np.zeros((n, R, B), np.uint8)
    for i in range(n):  # later pings return deeper
        r0 = 20 + 8 * i
        images[i, r0:r0 + 6, :] = rng.integers(90, 200, size=(6, B))
    positions, quats = circular_trajectory(n, radius=0.8)
    path = str(tmp_path / "deep.db3")
    write_synthetic_bag(path, images, positions, quats)
    sm, _ = stream(small_cfg, path, chunk_size=2, window=2)
    j_sm, _ = jax_stream(small_cfg, path, chunk_size=2, window=2)
    assert sm._caps["free"] == j_sm._free_cap == 20 + 8 * (n - 1)
    assert sm._tables.free_cap == j_sm._tables.free_cap
    assert sm._tables.nvo_cap == j_sm._tables.nvo_cap
    for k in ("fan_cap_recompiles", "window_cap_recompiles",
              "free_cap_recompiles"):
        assert getattr(sm.stats, k) == getattr(j_sm.stats, k), k
    assert sm.stats.free_cap_recompiles >= 1
    assert sm.stats.box_bits_recompiles == 0
    assert_same_voxels(sm.state, j_sm.state, EXP_ULP_TOL[torch.float64])


def _pair(sm, img, pos, t, encoding="mono8"):
    h, w = img.shape
    sm.on_ping(ImageMsg(t, "sonar_link", h, w, encoding, False, w,
                        img.tobytes()))
    sm.on_pose(OdometryMsg(t, "camera_init", "body", np.asarray(pos),
                           np.array([0.0, 0.0, 0.0, 1.0])))


def test_stream_recovers_after_failed_chunk(small_cfg):
    """A chunk that raises (a pose outside the packable key range) drops
    its frames and leaves the map as it was; the next pair maps."""
    img = synthetic_ping(small_cfg.image_height, small_cfg.image_width,
                         seed=11)
    sm, _ = stream(small_cfg, chunk_size=1, window=1,
                   initial_capacity=1 << 12)
    _pair(sm, img, [0.0, 0.0, 0.0], 1000.0)
    before = brick_state_to_numpy(sm.state)
    with pytest.raises(ValueError, match="packable range"):
        _pair(sm, img, [1.0e7, 0.0, 0.0], 1001.0)
    np.testing.assert_equal(brick_state_to_numpy(sm.state), before)
    assert not sm._chunk_images
    _pair(sm, img, [0.1, 0.0, 0.0], 1002.0)
    stats = sm.finish()
    assert stats.frames_mapped == 2 and stats.chunks == 2
    assert int(sm.state.used) > int(before["used"])


def test_stream_maps_surveys_too_wide_for_box_keys(small_cfg):
    """A chunk whose window spans more than the compact box keys hold maps
    through two-word brick codes: the JAX stream's voxels, and the port's
    direct pipeline's."""
    cfg = port_cfg(small_cfg)
    img = synthetic_ping(cfg.image_height, cfg.image_width, seed=12)
    images = np.stack([img, img])
    positions = np.array([[0.0, 0.0, 0.0], [3000.0, 3000.0, 0.0]])
    quats = np.tile([0.0, 0.0, 0.0, 1.0], (2, 1))
    T = pipeline.batched_sonar_to_world(positions, quats, cfg)
    assert pipeline.compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, 2, 2, frame_bits=1
    ) is None
    direct, _ = pipeline.map_ping_sequence(images, positions, quats, cfg,
                                           device="cpu", window=2,
                                           dtype=torch.float64)
    sm, _ = stream(small_cfg, chunk_size=2, window=2)
    j_sm = JaxStream(small_cfg, JStreamConfig(publish_rate_hz=0.0),
                     dtype=jnp.float64, backend="brick", chunk_size=2,
                     window=2)
    for t, pos in zip((1000.0, 1001.0), positions):
        _pair(sm, img, pos, t)
        _pair(j_sm, img, pos, t)
    sm.finish()
    j_sm.finish()
    assert sm.stats.frames_mapped == j_sm.stats.frames_mapped == 2
    assert_same_voxels(sm.state, j_sm.state, EXP_ULP_TOL[torch.float64])
    np.testing.assert_equal(touched_voxels_brick(sm.state),
                            touched_voxels_brick(direct))


def test_stream_drops_undecodable_frames(small_cfg):
    img = synthetic_ping(small_cfg.image_height, small_cfg.image_width,
                         seed=13)
    sm, _ = stream(small_cfg, chunk_size=1)
    _pair(sm, img, [0.0, 0.0, 0.0], 1000.0, encoding="rgb8")
    _pair(sm, img, [0.1, 0.0, 0.0], 1001.0)
    stats = sm.finish()
    assert (stats.pairs, stats.decode_errors, stats.frames_mapped) == (2, 1, 1)


def test_stream_publish_rate_zero_disables_timer(small_cfg):
    img = synthetic_ping(small_cfg.image_height, small_cfg.image_width,
                         seed=12)
    sm, published = stream(small_cfg, rate=0.0, chunk_size=1)
    _pair(sm, img, [0.0, 0.0, 0.0], 1000.0)
    sm.finish()
    assert sm.stats.frames_mapped == 1 and published == []


def test_pointcloud_msg_nanosec_carry(small_cfg):
    """Rounding 0.9999999996 s of fraction carries into sec, never giving
    nanosec == 1e9 (invalid builtin_interfaces/Time)."""
    sm, _ = stream(small_cfg, chunk_size=1, initial_capacity=1 << 10)
    msg = sm.pointcloud_msg(stamp=123.9999999996)
    assert msg["header"]["stamp"] == {"sec": 124, "nanosec": 0}
    assert msg["width"] == 0


def test_stream_reuses_fan_tables_while_caps_hold(small_cfg):
    """Chunks whose returns need no wider caps map with the very same fan
    tables (no rebuild, no upload); a deeper return grows the free cap once
    and brings new tables."""
    R, B = small_cfg.image_height, small_cfg.image_width
    rng = np.random.default_rng(9)
    shallow = np.zeros((R, B), np.uint8)
    shallow[30:36] = rng.integers(90, 200, size=(6, B))
    deep = np.zeros((R, B), np.uint8)
    deep[60:66] = rng.integers(90, 200, size=(6, B))
    sm, _ = stream(small_cfg, chunk_size=1, window=1)
    _pair(sm, shallow, [0.0, 0.0, 0.0], 1000.0)
    first = sm._tables
    _pair(sm, shallow, [0.1, 0.0, 0.0], 1001.0)
    assert sm._tables is first
    _pair(sm, deep, [0.2, 0.0, 0.0], 1002.0)
    assert sm._tables is not first
    assert sm._caps["free"] == 60
    assert sm.stats.free_cap_recompiles == 1
    _pair(sm, shallow, [0.3, 0.0, 0.0], 1003.0)
    assert sm._caps["free"] == 60  # caps never shrink
    assert sm.stats.free_cap_recompiles == 1


@pytest.mark.parametrize("backend,refusal", [
    ("brick-sharded", None), ("octree", "unknown backend"),
])
def test_unported_backends_are_refused(small_cfg, backend, refusal):
    """A name no package knows is refused; the sharded backend streams (on
    the one device given: one shard; against the JAX stream:
    test_sharded_stream_matches_jax_stream)."""
    if refusal is None:
        sm = StreamingMapper(port_cfg(small_cfg), backend=backend,
                             device="cpu")
        assert sm.mesh == (torch.device("cpu"),) and sm.state.n_shards == 1
        return
    with pytest.raises(ValueError, match=refusal):
        StreamingMapper(port_cfg(small_cfg), backend=backend, device="cpu")


def test_sharded_stream_matches_jax_stream(survey, small_cfg, monkeypatch):
    """backend="brick-sharded" over four shards, chunks and windows of 3,
    from 8 bricks a shard: the JAX sharded stream's counters, each shard's
    voxels and the published clouds (JAX: four virtual devices); the same
    map as the single-card stream; each chunk that grew the tables counted
    as one grow, as the JAX stream counts them."""
    import jax

    from sonar_3d_reconstruction_tpu_torch import stream as stream_mod

    from sonar_3d_reconstruction_tpu.parallel.shard import (
        make_mesh as j_make_mesh,
    )
    from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
        local_brick_states as j_local_brick_states,
    )
    from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (
        gather_sharded_brick_state,
        local_brick_states,
    )

    grown_chunks = []
    engine = stream_mod.map_ping_sequence_sharded_frames

    def counting(*args, state, **kw):
        out = engine(*args, state=state, **kw)
        grown_chunks.append(out[0].local_capacity != state.local_capacity)
        return out

    monkeypatch.setattr(stream_mod, "map_ping_sequence_sharded_frames",
                        counting)
    published = []
    sm = StreamingMapper(
        port_cfg(small_cfg), StreamConfig(publish_rate_hz=2.0),
        dtype=torch.float64, publish=published.append, chunk_size=3,
        window=3, initial_capacity=1 << 9, backend="brick-sharded",
        mesh=["cpu"] * 4)
    assert sm.state.local_capacity == 128
    sm.run_bag(survey["path"])
    j_published = []
    j_sm = JaxStream(SMALL_CFG, JStreamConfig(publish_rate_hz=2.0),
                     dtype=jnp.float64, backend="brick-sharded",
                     publish=j_published.append, chunk_size=3, window=3,
                     initial_capacity=1 << 20,
                     mesh=j_make_mesh(jax.devices()[:4]))
    j_sm.run_bag(survey["path"])
    assert_same_counters(sm.stats, j_sm.stats)
    assert sm.stats.grows == sum(grown_chunks)
    assert sm.stats.grows > 0 and sm.state.local_capacity > 128
    for t_s, j_s in zip(local_brick_states(sm.state),
                        j_local_brick_states(j_sm.state)):
        assert_same_voxels(t_s, j_s, EXP_ULP_TOL[torch.float64])
    assert len(published) == len(j_published) >= 2
    for msg, j_msg in zip(published, j_published):
        pts, probs = parse_pointcloud2(msg)
        j_pts, j_probs = parse_pointcloud2(j_msg)
        assert len(pts) > 0
        np.testing.assert_array_equal(pts, j_pts)
        np.testing.assert_allclose(probs, j_probs, rtol=0, atol=1e-6)
    single, _ = stream(small_cfg, survey["path"], chunk_size=3, window=3)
    keys, lo = gather_sharded_brick_state(sm.state)
    want = touched_voxels_brick(single.state)
    order, w_order = np.lexsort(keys.T), np.lexsort(want[0].T)
    np.testing.assert_array_equal(keys[order], want[0][w_order])
    np.testing.assert_array_equal(lo[order], want[1][w_order])


def test_hash_stream_equals_hash_pipeline(survey, small_cfg):
    """backend="hash": the bag in chunks of 3 (windows of 3) from a
    one-bucket table gives the map of the hash pipeline over the same
    pings, voxel for voxel, and publishes it."""
    from sonar_3d_reconstruction_tpu_torch.grid.hash import (
        extract_occupied_hash,
        touched_voxels_hash,
    )

    sm, published = stream(small_cfg, survey["path"], rate=2.0, chunk_size=3,
                           window=3, backend="hash", initial_capacity=128)
    assert sm.stats.grows > 0 and sm.stats.frames_mapped == 8
    direct, _ = pipeline.map_ping_sequence(
        survey["images"], survey["positions"], survey["quats"],
        port_cfg(small_cfg), device="cpu", dtype=torch.float64, window=3,
        backend="hash",
    )
    got, want = touched_voxels_hash(sm.state), touched_voxels_hash(direct)
    order, w_order = np.lexsort(got[0].T), np.lexsort(want[0].T)
    np.testing.assert_array_equal(got[0][order], want[0][w_order])
    np.testing.assert_array_equal(got[1][order], want[1][w_order])
    assert len(published) >= 2
    pts, _ = parse_pointcloud2(sm.pointcloud_msg())
    want_pts, _ = extract_occupied_hash(direct, port_cfg(small_cfg))
    assert len(pts) > 0
    np.testing.assert_array_equal(np.sort(pts, axis=0),
                                  np.sort(want_pts.astype(np.float32), axis=0))


def test_stream_needs_the_card_unless_told(small_cfg):
    """With no device the stream maps on the first CUDA device; without
    one that is a RuntimeError, never a quiet fall back to the CPU."""
    if torch.cuda.is_available():
        sm = StreamingMapper(port_cfg(small_cfg))
        assert sm.state.log_odds.device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StreamingMapper(port_cfg(small_cfg))


def test_sharded_stream_carries_budgets_and_counts_grows_as_jax(survey):
    """The sharded stream seeded with a 128-lane exchange budget (the JAX
    stream's sticky ``_sharded_budgets``): the chunk that grows it counts
    one grow, later chunks start at the grown budgets; ``grows``, the
    sticky budgets and each shard's voxels equal the JAX stream's."""
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

    sm = StreamingMapper(port_cfg(SMALL_CFG), dtype=torch.float64,
                         chunk_size=3, window=3, initial_capacity=1 << 17,
                         backend="brick-sharded", mesh=["cpu"] * 4)
    j_sm = JaxStream(SMALL_CFG, JStreamConfig(), dtype=jnp.float64,
                     backend="brick-sharded", chunk_size=3, window=3,
                     initial_capacity=1 << 17,
                     mesh=j_make_mesh(jax.devices()[:4]))
    sm._sharded_budgets = {"xchg_budget": 128}
    j_sm._sharded_budgets = {"xchg_budget": 128}
    sm.run_bag(survey["path"])
    j_sm.run_bag(survey["path"])
    assert sm.stats.grows == j_sm.stats.grows >= 1
    assert sm.stats.chunks == j_sm.stats.chunks > sm.stats.grows
    assert sm._sharded_budgets == {
        k: v for k, v in j_sm._sharded_budgets.items() if k != "box_min_bits"}
    assert sm._sharded_budgets["xchg_budget"] > 128
    for t_s, j_s in zip(local_brick_states(sm.state),
                        j_local_brick_states(j_sm.state)):
        assert_same_voxels(t_s, j_s, EXP_ULP_TOL[torch.float64])
