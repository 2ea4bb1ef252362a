"""The port's hash backend against the JAX package's: the per-ping update
(``update_hash_grid``) and the window engine (``apply_records_batched``)
through ``map_ping_sequence(backend="hash")``, growth (``rehash``), the
reads (extraction in slot order, classified extraction, snapshots' voxel
view, point queries), snapshots across packages (``save_map`` /
``load_map``), and the hash mapper, stream, CLI and node.

Both packages take the same numpy-seeded inputs (small geometry).
Tolerances: key rows, slots, ``used``, bounds, per-ping stats, extracted
points and voxel keys bit-equal wherever both packages end at the same
capacity; log-odds within EXP_ULP_TOL (tests/torch_parity.py: 1e-12 in
float64, 1e-5 in float32), probabilities computed on the host from equal
log-odds exactly, float32 cloud intensities within 1e-5.  Within the port,
the window engine and growth give the per-ping map bit for bit.
"""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu import cli as j_cli  # noqa: E402
from sonar_3d_reconstruction_tpu.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu.config import StreamConfig as JStreamConfig  # noqa: E402
from sonar_3d_reconstruction_tpu.grid import hash as j_hash  # noqa: E402
from sonar_3d_reconstruction_tpu.io import checkpoint as j_checkpoint  # noqa: E402
from sonar_3d_reconstruction_tpu.io.bag import write_synthetic_bag  # noqa: E402
from sonar_3d_reconstruction_tpu.models import (  # noqa: E402
    SonarMapper as JaxMapper,
)
from sonar_3d_reconstruction_tpu.pipeline import (  # noqa: E402
    map_ping_sequence as j_map_ping_sequence,
)
from sonar_3d_reconstruction_tpu.stream import (  # noqa: E402
    StreamingMapper as JaxStream,
)

from sonar_3d_reconstruction_tpu_torch import cli, pipeline  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.config import StreamConfig  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid.hash import (  # noqa: E402
    _exact_gt_threshold,
    extract_classified_hash,
    extract_occupied_hash,
    hash_state_from_numpy,
    hash_state_to_numpy,
    init_hash_grid,
    keys_to_world,
    query_log_odds,
    query_probability,
    rehash,
    touched_voxels_hash,
)
from sonar_3d_reconstruction_tpu_torch.io import checkpoint  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.io.pointcloud import (  # noqa: E402
    parse_pointcloud2,
)
from sonar_3d_reconstruction_tpu_torch.models import SonarMapper  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.stream import StreamingMapper  # noqa: E402

from conftest import circular_trajectory, synthetic_ping  # noqa: E402
from torch_parity import DTYPES, EXP_ULP_TOL, port_cfg  # noqa: E402

SMALL_CFG = MapperConfig(image_width=64, image_height=100, max_range=5.0,
                         min_range=0.5, voxel_resolution=0.1,
                         intensity_threshold=30)
N_PINGS = 6
# slots of both packages' tables: the survey never grows them, so one JAX
# program set maps it
CAPACITY = 1 << 14
STATS = ("num_occupied", "num_free", "num_candidates", "overflowed")
HASH_FIELDS = ("key_rows", "log_odds", "min_bounds", "max_bounds", "used",
               "poisoned")
TIMES = ("processing_time", "avg_processing_time")


def survey(n=N_PINGS, seed=700):
    images = np.stack([synthetic_ping(100, 64, seed=seed + i)
                       for i in range(n)])
    positions, quats = circular_trajectory(n, radius=0.8)
    return images, positions, quats


@functools.lru_cache(maxsize=None)
def jax_seq(window, j_dtype):
    """The JAX hash map of the survey: (state, state as numpy, stats)."""
    st, stats = j_map_ping_sequence(
        *survey(), SMALL_CFG, backend="hash", dtype=j_dtype, window=window,
        initial_capacity=CAPACITY,
    )
    assert st.capacity == CAPACITY
    return (st, {k: np.asarray(getattr(st, k)) for k in HASH_FIELDS},
            {k: np.asarray(v) for k, v in stats.items()})


def port_seq(window, t_dtype, capacity=CAPACITY):
    return pipeline.map_ping_sequence(
        *survey(), port_cfg(SMALL_CFG), device="cpu", backend="hash",
        dtype=t_dtype, window=window,
        state=init_hash_grid(capacity, t_dtype, "cpu"),
    )


def assert_hash_states_match(got, want, dtype):
    """Port state (as numpy) vs JAX state (as numpy): every array equal,
    log-odds within EXP_ULP_TOL of the dtype."""
    for k in HASH_FIELDS:
        assert got[k].shape == want[k].shape, k
        if k == "log_odds":
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=EXP_ULP_TOL[dtype], err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def sorted_voxels(state):
    keys, lo = touched_voxels_hash(state)
    order = np.lexsort(keys.T)
    return keys[order], lo[order]


@pytest.mark.parametrize("window", [1, 3], ids=["update_hash_grid",
                                                "apply_records_batched"])
@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_hash_sequence_matches_jax(window, t_dtype, j_dtype):
    """map_ping_sequence(backend="hash") per ping (window 1) and in windows
    of 3: per-ping stats and the whole state as the JAX package's, slots
    included, and the occupied cloud in the same slot order."""
    j_st, want_st, want = jax_seq(window, j_dtype)
    got_st, got = port_seq(window, t_dtype)
    for k in STATS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["num_candidates"] > 0).all()
    assert_hash_states_match(hash_state_to_numpy(got_st), want_st, t_dtype)
    cfg = port_cfg(SMALL_CFG)
    pts, probs = extract_occupied_hash(got_st, cfg)
    j_pts, j_probs = j_hash.extract_occupied_hash(j_st, SMALL_CFG)
    assert len(pts) > 0
    np.testing.assert_array_equal(pts, j_pts)
    np.testing.assert_allclose(probs, j_probs, rtol=0, atol=EXP_ULP_TOL[t_dtype])


def test_window_engine_equals_per_ping():
    """Windows of 3 (rank-stepped chains) give the per-ping map bit for
    bit, and the same per-ping stats."""
    w1, s1 = port_seq(1, torch.float64)
    w3, s3 = port_seq(3, torch.float64)
    for k in STATS:
        np.testing.assert_array_equal(s1[k], s3[k], err_msg=k)
    np.testing.assert_equal(sorted_voxels(w1), sorted_voxels(w3))
    assert (s3["batch_n_unique"] >= s3["num_occupied"] + s3["num_free"]).all()


@pytest.mark.parametrize("window", [1, 3])
def test_growth_from_a_one_bucket_table(window):
    """From 128 slots the table overflows, grows by rehash and replays; the
    voxels, log-odds and stats equal the run that never grew."""
    grown, g_stats = port_seq(window, torch.float64, capacity=128)
    big, b_stats = port_seq(window, torch.float64)
    assert grown.capacity > 128 and not bool(grown.poisoned)
    assert int(grown.used) == int(big.used)
    for k in STATS:
        np.testing.assert_array_equal(g_stats[k], b_stats[k], err_msg=k)
    np.testing.assert_equal(sorted_voxels(grown), sorted_voxels(big))


def test_rehash_matches_jax():
    """rehash re-inserts every key in slot order: the JAX package's table
    and values, slot for slot, into a larger table and into one too small
    (doubling until every bucket fits)."""
    j_st = jax_seq(3, jnp.float64)[0]
    state = hash_state_from_numpy(
        {k: np.asarray(getattr(j_st, k)) for k in HASH_FIELDS}, "cpu")
    for capacity in (1 << 15, 128):
        got = hash_state_to_numpy(rehash(state, capacity))
        want = j_hash.rehash(j_st, new_capacity=capacity)
        assert got["key_rows"].shape[0] * 128 >= capacity
        for k in HASH_FIELDS:
            np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)),
                                          err_msg=k)


@pytest.mark.parametrize("j_dtype", [jnp.float64, jnp.float32],
                         ids=["f64", "f32"])
def test_reads_of_a_jax_state_match_jax(j_dtype):
    """The JAX state loaded into the port reads as in the JAX package:
    occupied and classified clouds in slot order, the snapshot's voxel
    view, and point queries (voxel centres, cell corners, far and
    unpackable points)."""
    j_st = jax_seq(3, j_dtype)[0]
    state = hash_state_from_numpy(
        {k: np.asarray(getattr(j_st, k)) for k in HASH_FIELDS}, "cpu")
    cfg = port_cfg(SMALL_CFG)
    for got, want in zip(extract_occupied_hash(state, cfg),
                         j_hash.extract_occupied_hash(j_st, SMALL_CFG)):
        np.testing.assert_array_equal(got, want)
    cls = extract_classified_hash(state, cfg)
    j_cls = j_hash.extract_classified_hash(j_st, SMALL_CFG)
    assert len(cls["free"][0]) > 0 and len(cls["unknown"][0]) > 0
    for name in ("free", "occupied", "unknown"):
        for got, want in zip(cls[name], j_cls[name]):
            np.testing.assert_array_equal(got, want, err_msg=name)
    keys, lo = touched_voxels_hash(state)
    j_keys, j_lo = j_hash.touched_voxels_hash(j_st)
    np.testing.assert_array_equal(keys, j_keys)
    np.testing.assert_array_equal(lo, j_lo)
    res = cfg.voxel_resolution
    rng = np.random.default_rng(3)
    pts = np.concatenate([
        keys_to_world(keys, res), keys * res,
        rng.uniform(-30.0, 30.0, size=(300, 3)), [[1e9, 0.0, 0.0]],
    ])
    np.testing.assert_array_equal(keys_to_world(keys, res),
                                  j_hash.keys_to_world(keys, res))
    np.testing.assert_array_equal(query_log_odds(state, pts, cfg),
                                  j_hash.query_log_odds(j_st, pts, SMALL_CFG))
    p = query_probability(state, pts, cfg)
    np.testing.assert_array_equal(p, j_hash.query_probability(j_st, pts,
                                                              SMALL_CFG))
    assert p[-1] == 0.5 and (p[:len(keys)] != 0.5).any()


def test_exact_threshold_cut_matches_jax():
    """The float32 cut of a float64 threshold: the largest float32 at or
    below it, as the JAX package computes it; float64 keeps it."""
    rng = np.random.default_rng(4)
    for thr in list(rng.normal(size=200) * 5) + [0.0, np.log(0.3 / 0.7)]:
        for t_dtype, j_dtype in ((torch.float32, jnp.float32),
                                 (torch.float64, jnp.float64)):
            got = _exact_gt_threshold(float(thr), t_dtype)
            want = float(j_hash._exact_gt_threshold(float(thr), j_dtype))
            assert got == want, (thr, t_dtype)
            assert got <= thr


def test_snapshots_across_packages(tmp_path):
    """A JAX hash map's snapshot loads into the port's hash grid slot for
    slot as into the JAX one; the port's snapshot of its own hash map
    loads into the JAX package's; a float64 snapshot stays float64; and
    without a device load_map needs the card."""
    j_st = jax_seq(3, jnp.float64)[0]
    j_path = str(tmp_path / "jax.npz")
    j_checkpoint.save_map(j_path, j_st, SMALL_CFG)
    got, cfg = checkpoint.load_map(j_path, device="cpu")
    want, j_cfg = j_checkpoint.load_map(j_path)
    assert got.log_odds.dtype == torch.float64
    assert cfg == port_cfg(j_cfg)
    for k in HASH_FIELDS:
        np.testing.assert_array_equal(hash_state_to_numpy(got)[k],
                                      np.asarray(getattr(want, k)), err_msg=k)

    port_st, _ = port_seq(3, torch.float64)
    t_path = str(tmp_path / "port.npz")
    checkpoint.save_map(t_path, port_st, port_cfg(SMALL_CFG))
    back, _ = j_checkpoint.load_map(t_path)
    mine, _ = checkpoint.load_map(t_path, device="cpu", dtype=torch.float64)
    np.testing.assert_equal(hash_state_to_numpy(mine),
                            {k: np.asarray(getattr(back, k))
                             for k in HASH_FIELDS})
    np.testing.assert_equal(sorted_voxels(mine), sorted_voxels(port_st))
    brick_st, _ = checkpoint.load_map_brick(t_path, device="cpu")
    assert int(brick_st.used) == int(port_st.used)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            checkpoint.load_map(t_path)


def test_hash_state_numpy_round_trip():
    port_st, _ = port_seq(3, torch.float64)
    d = hash_state_to_numpy(port_st)
    assert d["key_rows"].dtype == np.uint32 and d["used"].dtype == np.int32
    np.testing.assert_equal(hash_state_to_numpy(hash_state_from_numpy(d, "cpu")),
                            d)


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_hash_mapper_matches_jax(t_dtype, j_dtype):
    """SonarMapper(backend="hash") against the JAX hash mapper over 4
    pings (the last at another image width): per-ping stats, the table
    grown at the same load (slot for slot), both clouds in slot order,
    queries, update counts, and reset_map."""
    cfg = SMALL_CFG
    kw = dict(initial_capacity=1 << 13, track_update_counts=True)
    jm = JaxMapper(cfg, backend="hash", dtype=j_dtype, **kw)
    tm = SonarMapper(port_cfg(cfg), backend="hash", dtype=t_dtype,
                     device="cpu", **kw)
    images, positions, quats = survey(3, seed=720)
    pings = list(zip(images, positions, quats))
    pings.append((synthetic_ping(100, 48, seed=89), [0.3, -0.2, 0.1],
                  [0.0, 0.0, 0.0, 1.0]))
    for x in pings:
        got, want = tm.process_sonar_image(*x), jm.process_sonar_image(*x)
        assert ({k: v for k, v in got.items() if k not in TIMES}
                == {k: v for k, v in want.items() if k not in TIMES})
        assert tm.frame_update_counts == jm.frame_update_counts
    assert tm.state.capacity == jm.state.capacity > 1 << 13
    assert_hash_states_match(
        hash_state_to_numpy(tm.state),
        {k: np.asarray(getattr(jm.state, k)) for k in HASH_FIELDS}, t_dtype)
    tol = EXP_ULP_TOL[t_dtype]
    got, want = tm.get_point_cloud(), jm.get_point_cloud()
    assert got["num_occupied"] == want["num_occupied"] > 0
    np.testing.assert_array_equal(got["points"], want["points"])
    np.testing.assert_allclose(got["probabilities"], want["probabilities"],
                               rtol=0, atol=tol)
    got, want = tm.get_point_cloud(True), jm.get_point_cloud(True)
    for k in ("num_voxels", "num_occupied", "num_free", "num_unknown"):
        assert got[k] == want[k], k
    for k in ("occupied", "free", "unknown"):
        np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=k)
    for k in ("min", "max"):
        np.testing.assert_array_equal(got["bounds"][k], want["bounds"][k])
    keys = touched_voxels_hash(tm.state)[0]
    pts = np.concatenate([(keys + 0.5) * 0.1, keys * 0.1, [[99.0, 0, 0]]])
    np.testing.assert_allclose(tm.query_probabilities(pts),
                               jm.query_probabilities(pts), rtol=0, atol=tol)
    assert abs(tm.get_log_odds(*pts[0]) - jm.get_log_odds(*pts[0])) <= tol
    assert tm.voxel_update_counts == jm.voxel_update_counts
    cap = tm.state.capacity
    tm.reset_map()
    jm.reset_map()
    assert tm.num_voxels == 0 and tm.state.capacity == cap
    got, want = (m.process_sonar_image(*pings[0]) for m in (tm, jm))
    assert got["num_voxels"] == want["num_voxels"] > 0


def test_hash_mapper_map_sequence_matches_jax_pipeline():
    """map_sequence in windows of 3 on a fresh hash mapper: the JAX hash
    pipeline's table and stats."""
    j_st, want_st, want = jax_seq(3, jnp.float64)
    tm = SonarMapper(port_cfg(SMALL_CFG), backend="hash",
                     initial_capacity=CAPACITY, dtype=torch.float64,
                     device="cpu")
    got = tm.map_sequence(*survey(), window=3)
    for k in STATS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tm.frame_count == N_PINGS
    assert_hash_states_match(hash_state_to_numpy(tm.state), want_st,
                             torch.float64)


def _bag(path, n=7, seed=740, rate_hz=2.0):
    images, positions, quats = survey(n, seed)
    write_synthetic_bag(str(path), images, positions, quats, rate_hz=rate_hz)
    return str(path)


def test_hash_stream_matches_jax_stream(tmp_path):
    """StreamingMapper(backend="hash"), chunk 3, window 3, publishing at
    2 Hz of stream time: the JAX hash stream's counters, table (slot for
    slot) and published clouds (points in slot order)."""
    path = _bag(tmp_path / "s.db3")
    published, j_published = [], []
    sm = StreamingMapper(port_cfg(SMALL_CFG), StreamConfig(publish_rate_hz=2.0),
                         chunk_size=3, window=3, initial_capacity=CAPACITY,
                         dtype=torch.float64, backend="hash",
                         publish=published.append, device="cpu")
    sm.run_bag(path)
    j_sm = JaxStream(SMALL_CFG, JStreamConfig(publish_rate_hz=2.0),
                     chunk_size=3, window=3, initial_capacity=CAPACITY,
                     dtype=jnp.float64, backend="hash",
                     publish=j_published.append)
    j_sm.run_bag(path)
    for k in ("pairs", "frames_mapped", "chunks", "decode_errors",
              "dropped_unsynced"):
        assert getattr(sm.stats, k) == getattr(j_sm.stats, k), k
    assert sm.stats.chunks == 3
    assert_hash_states_match(
        hash_state_to_numpy(sm.state),
        {k: np.asarray(getattr(j_sm.state, k)) for k in HASH_FIELDS},
        torch.float64)
    assert len(published) == len(j_published) >= 2
    for msg, j_msg in zip(published, j_published):
        assert msg["header"] == j_msg["header"]
        pts, probs = parse_pointcloud2(msg)
        j_pts, j_probs = parse_pointcloud2(j_msg)
        np.testing.assert_array_equal(pts, j_pts)
        np.testing.assert_allclose(probs, j_probs, rtol=0, atol=1e-6)


def _run(capsys, main, *argv):
    assert main(list(argv)) == 0, argv
    return json.loads(capsys.readouterr().out.splitlines()[-1])


def test_map_bag_hash_matches_jax_cli(tmp_path, capsys):
    """map-bag --backend hash, offline and streaming, against the JAX CLI:
    pairs, chunks, publishes and voxels equal; saved clouds equal point
    for point (float32 intensities within 1e-5); the snapshot answers
    queries from a hash grid."""
    path = _bag(tmp_path / "c.db3")
    common = ["--param", "max_range=5.0", "--param", "voxel_resolution=0.1",
              "--param", "image_width=64", "--param", "image_height=100",
              "--param", "intensity_threshold=30", "--param",
              "publish_rate_hz=1.0", "--backend", "hash", "--window", "3"]
    clouds = {}
    for mode, extra in (("offline", ["--offline"]),
                        ("stream", ["--chunk", "3", "--publish"])):
        t_pc2, j_pc2 = tmp_path / f"t_{mode}.pc2", tmp_path / f"j_{mode}.pc2"
        got = _run(capsys, cli.main, "map-bag", path, *common, *extra,
                   "--device", "cpu", "--save-cloud", str(t_pc2),
                   "--save-map", str(tmp_path / f"{mode}.npz"))
        want = _run(capsys, j_cli.main, "map-bag", path, *common, *extra,
                    "--save-cloud", str(j_pc2))
        assert got["pairs"] == want["pairs"] == 7
        for k in {"num_voxels", "chunks", "publishes",
                  "last_publish_points"} & want.keys():
            assert got[k] == want[k], (mode, k)
        assert got["bin_apply_launches"] == 0
        xyzi, j_xyzi = (np.fromfile(p, "<f4").reshape(-1, 4)
                        for p in (t_pc2, j_pc2))
        assert len(xyzi) > 0
        np.testing.assert_array_equal(xyzi[:, :3], j_xyzi[:, :3])
        np.testing.assert_allclose(xyzi[:, 3], j_xyzi[:, 3], rtol=0, atol=1e-5)
        clouds[mode] = xyzi
    np.testing.assert_array_equal(clouds["offline"], clouds["stream"])
    state, _ = checkpoint.load_map(str(tmp_path / "offline.npz"), device="cpu")
    x, y, z, p = clouds["offline"][0]
    q = query_probability(state, [[x, y, z]], port_cfg(SMALL_CFG))
    assert abs(q[0] - p) < 1e-6


def test_node_hash_matches_jax_node():
    """The node with map_backend "hash": the JAX node's published cloud,
    point for point."""
    import importlib

    import fake_rclpy
    from test_torch_node import _deliver, _make_node, _pubs_by_topic

    displaced = fake_rclpy.install()
    try:
        msgs = {}
        for name, mod in (("jax", fake_rclpy.reload_node()),
                          ("port", importlib.reload(
                              importlib.import_module(
                                  "sonar_3d_reconstruction_tpu_torch.node")))):
            node = _make_node(mod, map_backend="hash")
            assert node.mapper.backend == "hash"
            for i in range(4):
                _deliver(node, synthetic_ping(32, 24, seed=30 + i),
                         (0.1 * i, 0.05 * i, 0.0), 85.0 + i, odom_delay=0.01)
            node.timers[0].fire()
            msgs[name] = _pubs_by_topic(node)["/sonar_3d_map"].published[0]
    finally:
        fake_rclpy.Node.parameter_overrides = {}
        fake_rclpy.uninstall(displaced)
        fake_rclpy.reload_node()
        importlib.reload(importlib.import_module(
            "sonar_3d_reconstruction_tpu_torch.node"))
    got, want = (np.frombuffer(msgs[k].data, np.float32).reshape(-1, 4)
                 for k in ("port", "jax"))
    assert len(got) > 0 and msgs["port"].width == msgs["jax"].width
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=0, atol=1e-5)


def test_hash_keys_out_of_range_are_fatal():
    """Keys past the packable range cannot be grown away: the pipeline and
    the mapper raise ValueError, and the mapper keeps its map."""
    images, positions, quats = survey(2)
    far = positions + [1.0e7, 0.0, 0.0]
    with pytest.raises(ValueError, match="packable range"):
        pipeline.map_ping_sequence(images, far, quats, port_cfg(SMALL_CFG),
                                   device="cpu", backend="hash", window=2)
    m = SonarMapper(port_cfg(SMALL_CFG), backend="hash", device="cpu")
    m.process_sonar_image(images[0], positions[0], quats[0])
    used = m.num_voxels
    with pytest.raises(ValueError, match="packable range"):
        m.process_sonar_image(images[1], far[1], quats[1])
    assert m.num_voxels == used > 0 and not bool(m.state.poisoned)


def test_hash_map_needs_the_card_unless_told():
    """With no device the hash map is made on the first CUDA device;
    without one that is a RuntimeError, never a quiet fall back."""
    images, positions, quats = survey(1)
    if torch.cuda.is_available():
        st, _ = pipeline.map_ping_sequence(images, positions, quats,
                                           port_cfg(SMALL_CFG), backend="hash")
        assert st.log_odds.device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pipeline.map_ping_sequence(images, positions, quats,
                                       port_cfg(SMALL_CFG), backend="hash")
