"""The port's ROS2 node through the fake-rclpy shim (tests/fake_rclpy.py),
on the CPU through its ``device`` parameter, and its published cloud
against the JAX node's on the same pairs.

Ingest goes through the shim's ApproximateTimeSynchronizer, which runs the
real pairing algorithm.  Tolerances: published points exactly, published
float32 probabilities within 1e-5 of the JAX node's (the port's float32
bar) and within 1e-6 of the node's own mapper.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

import fake_rclpy  # noqa: E402
from conftest import synthetic_ping  # noqa: E402

# small geometry, as tests/test_node_runtime.py; the map on the CPU
_OVERRIDES = {
    "image_width": 24,
    "image_height": 32,
    "voxel_resolution": 0.1,
    "intensity_threshold": 30,
    "min_probability": 0.6,
    "max_range": 5.0,
    "min_range": 0.5,
    "z_filter_enabled": False,
    "device": "cpu",
}


def _reload_port_node():
    import sonar_3d_reconstruction_tpu_torch.node as node_mod

    return importlib.reload(node_mod)


@pytest.fixture
def node_env():
    """Install the shim, reload the port's node against it, restore
    afterwards."""
    displaced = fake_rclpy.install()
    node_mod = _reload_port_node()
    assert node_mod._ROS2, "shim not picked up by node reload"
    try:
        yield node_mod
    finally:
        fake_rclpy.Node.parameter_overrides = {}
        fake_rclpy.uninstall(displaced)
        importlib.reload(node_mod)


def _make_node(node_mod, **extra):
    fake_rclpy.Node.parameter_overrides = {**_OVERRIDES, **extra}
    return node_mod.SonarMapperNode()


def _image_msg(img: np.ndarray, stamp: float) -> fake_rclpy.Image:
    h, w = img.shape
    return fake_rclpy.Image(
        header=fake_rclpy.Header(
            fake_rclpy.Stamp(int(stamp), int((stamp % 1.0) * 1e9)), "sonar_link"
        ),
        height=h, width=w, encoding="mono8", is_bigendian=False, step=w,
        data=img.tobytes(),
    )


def _odom_msg(position, stamp: float) -> fake_rclpy.Odometry:
    msg = fake_rclpy.Odometry(position=position)
    msg.header.stamp = fake_rclpy.Stamp(int(stamp), int((stamp % 1.0) * 1e9))
    return msg


def _pubs_by_topic(node):
    return {p.topic: p for p in node.publishers}


def _deliver(node, img, position, t, odom_delay=0.0):
    sonar_sub, odom_sub = node._sync.subscribers
    sonar_sub.deliver(_image_msg(img, t))
    odom_sub.deliver(_odom_msg(position, t + odom_delay))


def test_ingest_through_synchronizer_and_publish(node_env):
    """Paired Image+Odometry arrivals map frames on the CPU; the publish
    timer emits a PointCloud2 whose XYZI payload is the mapper's
    extraction."""
    node = _make_node(node_env)
    assert node.mapper.state.log_odds.device.type == "cpu"
    for i in range(3):
        # arrivals 30 ms apart, within the 0.1 s slop: every pair fires
        _deliver(node, synthetic_ping(32, 24, seed=10 + i), (0.1 * i, 0, 0),
                 50.0 + i, odom_delay=0.03)
    assert node.mapper.frame_count == 3

    assert len(node.timers) == 1
    assert node.timers[0].period_sec == pytest.approx(0.1)
    node.timers[0].fire()

    pc_pub = _pubs_by_topic(node)["/sonar_3d_map"]
    assert len(pc_pub.published) == 1
    msg = pc_pub.published[0]
    cloud = node.mapper.get_point_cloud()
    n_pts = len(cloud["points"])
    assert n_pts > 0
    assert msg.width == n_pts and msg.height == 1
    assert msg.point_step == 16 and msg.row_step == 16 * n_pts
    assert [f.name for f in msg.fields] == ["x", "y", "z", "intensity"]
    assert msg.header.frame_id == "map"
    xyzi = np.frombuffer(msg.data, np.float32).reshape(-1, 4)
    np.testing.assert_array_equal(xyzi[:, :3],
                                  cloud["points"].astype(np.float32))
    np.testing.assert_allclose(xyzi[:, 3], cloud["probabilities"], rtol=0,
                               atol=1e-6)
    assert (xyzi[:, 3] > 0.6).all()


def test_map_backend_brick_default_and_hash_accepted(node_env):
    """map_backend defaults to the brick map; "hash", "dense" and
    "brick-sharded" (one shard on the node's device) map the same pair to
    the same occupied voxels; another name is refused."""
    clouds = []
    for extra in ({}, {"map_backend": "hash"}, {"map_backend": "dense"},
                  {"map_backend": "brick-sharded"}):
        node = _make_node(node_env, **extra)
        assert node.mapper.backend == extra.get("map_backend", "brick")
        _deliver(node, synthetic_ping(32, 24, seed=77), (0, 0, 0), 60.0, 0.02)
        assert node.mapper.frame_count == 1
        clouds.append(node.mapper.get_point_cloud()["points"])
    assert len(clouds[0]) > 0
    for cloud in clouds[1:]:
        np.testing.assert_array_equal(np.sort(clouds[0], axis=0),
                                      np.sort(cloud, axis=0))
    with pytest.raises(ValueError, match="unknown backend"):
        _make_node(node_env, map_backend="octree")


def test_node_needs_the_card_unless_told(node_env):
    """Without the device parameter the node maps on the first CUDA device;
    where there is none, construction raises."""
    import torch

    if torch.cuda.is_available():
        node = _make_node(node_env, device="")
        assert node.mapper.device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _make_node(node_env, device="")


def test_unsynced_messages_never_map(node_env):
    """Stamps farther apart than the slop never pair."""
    node = _make_node(node_env)
    img = synthetic_ping(32, 24, seed=3)
    _deliver(node, img, (0, 0, 0), 10.0, odom_delay=0.2)
    _deliver(node, img, (0, 0, 0), 11.0, odom_delay=0.10001)
    assert node.mapper.frame_count == 0


def test_decode_failure_drops_frame_and_logs(node_env):
    """An undecodable image is dropped with an error log; mapping continues
    with the next good pair (reference node:313-316)."""
    node = _make_node(node_env)
    sonar_sub, odom_sub = node._sync.subscribers
    bad = _image_msg(synthetic_ping(32, 24, seed=4), 20.0)
    bad.encoding = "rgb8"
    sonar_sub.deliver(bad)
    odom_sub.deliver(_odom_msg((0.0, 0.0, 0.0), 20.0))
    assert node.mapper.frame_count == 0
    assert any(lvl == "error" and "decode" in msg
               for lvl, msg in node.get_logger().records)
    _deliver(node, synthetic_ping(32, 24, seed=5), (0, 0, 0), 21.0)
    assert node.mapper.frame_count == 1


def test_mono16_ingest_matches_mono8(node_env):
    """mono16 of v*256 maps exactly like mono8 v (reference node:308-310)."""
    node8, node16 = _make_node(node_env), _make_node(node_env)
    img = synthetic_ping(32, 24, seed=6)
    _deliver(node8, img, (0, 0, 0), 30.0)
    s16, o16 = node16._sync.subscribers
    s16.deliver(fake_rclpy.Image(
        header=fake_rclpy.Header(fake_rclpy.Stamp(30, 0), "sonar_link"),
        height=32, width=24, encoding="mono16", is_bigendian=False,
        step=48, data=(img.astype(np.uint16) * 256).tobytes(),
    ))
    o16.deliver(_odom_msg((0.0, 0.0, 0.0), 30.0))
    c8, c16 = (n.mapper.get_point_cloud() for n in (node8, node16))
    assert len(c8["points"]) > 0
    np.testing.assert_array_equal(c8["points"], c16["points"])


def test_marker_path_publishes_classified_cubes(node_env):
    """show_free_space=True publishes the three CUBE_LIST markers:
    occupied red a=0.8, free blue a=0.3, unknown yellow a=0.5, cube scale =
    voxel_resolution, one Point per voxel centre."""
    node = _make_node(node_env, show_free_space=True)
    _deliver(node, synthetic_ping(32, 24, seed=7), (0, 0, 0), 40.0)
    node.timers[0].fire()

    arr = _pubs_by_topic(node)["/sonar_3d_map_markers"].published
    assert len(arr) == 1
    by_ns = {m.ns.replace("sonar_3d_map_", ""): m for m in arr[0].markers}
    assert set(by_ns) == {"occupied", "free", "unknown"}
    res = node.mapper.cfg.voxel_resolution
    for m in arr[0].markers:
        assert (m.scale.x, m.scale.y, m.scale.z) == (res, res, res)
        assert m.type == 6
    occ, free = by_ns["occupied"], by_ns["free"]
    assert (occ.color.r, occ.color.a) == (1.0, 0.8)
    assert (free.color.b, free.color.a) == (1.0, 0.3)
    assert by_ns["unknown"].color.a == 0.5
    cloud = node.mapper.get_point_cloud(include_free=True)
    for name in ("occupied", "free", "unknown"):
        pts = cloud[name][0]
        got = np.array([[p.x, p.y, p.z] for p in by_ns[name].points])
        np.testing.assert_array_equal(got.reshape(-1, 3), pts)
    assert len(occ.points) > 0 and len(free.points) > 0
    # the PointCloud2 publish still happened, with the occupied voxels
    msg = _pubs_by_topic(node)["/sonar_3d_map"].published[0]
    assert msg.width == len(occ.points)


def test_static_tf_broadcast(node_env):
    """publish_tf=True broadcasts base->sonar once with the RPY-derived
    quaternion (reference node:359-391)."""
    from sonar_3d_reconstruction_tpu_torch.geometry import quaternion_from_rpy

    node = _make_node(node_env, **{
        "publish_tf": True,
        "sonar_orientation.pitch": 90.0,
        "sonar_position.z": -0.5,
    })
    bc = node.static_tf_broadcasters[0]
    assert len(bc.sent) == 1
    t = bc.sent[0]
    assert t.header.frame_id == "base_link"
    assert t.child_frame_id == "sonar_link"
    assert t.transform.translation.z == -0.5
    q = quaternion_from_rpy(np.array([0.0, np.pi / 2, 0.0]))
    np.testing.assert_allclose(
        [t.transform.rotation.x, t.transform.rotation.y,
         t.transform.rotation.z, t.transform.rotation.w],
        q, atol=1e-12,
    )
    node2 = _make_node(node_env, publish_tf=False)
    assert not getattr(node2, "static_tf_broadcasters", [])


def test_periodic_stats_log(node_env):
    """Every 10th frame logs voxel count and sonar<->odom stamp skew."""
    node = _make_node(node_env)
    for i in range(10):
        _deliver(node, synthetic_ping(32, 24, seed=i), (0.05 * i, 0, 0),
                 60.0 + i, odom_delay=0.04)
    infos = [m for lvl, m in node.get_logger().records if lvl == "info"]
    assert any("frame 10" in m and "skew 40 ms" in m for m in infos)
    assert any("map on cpu" in m for m in infos)


def test_opencv_visualization_wiring(node_env):
    """show_opencv_visualization makes the threshold overlay of every
    synchronized frame before mapping; off (the default) leaves it cold."""
    from sonar_3d_reconstruction_tpu_torch.io.debugviz import threshold_overlay

    node = _make_node(node_env, show_opencv_visualization=True)
    img = synthetic_ping(32, 24, seed=77)
    _deliver(node, img, (0, 0, 0), 90.0, 0.02)
    assert node.mapper.frame_count == 1
    np.testing.assert_array_equal(node.last_debug_overlay,
                                  threshold_overlay(img, node.mapper.cfg))
    assert node.last_debug_overlay.shape == (32, 24, 3)

    off = _make_node(node_env)
    assert off.show_opencv_visualization is False
    _deliver(off, img, (0, 0, 0), 91.0, 0.02)
    assert not hasattr(off, "last_debug_overlay")


def test_main_spin_and_shutdown_stats(node_env):
    """main() spins, then logs final map stats and shuts down."""
    import rclpy  # the shim

    def drive(node):
        _deliver(node, synthetic_ping(32, 24, seed=9), (0, 0, 0), 70.0)
        rclpy._state["node"] = node
        raise KeyboardInterrupt  # operator Ctrl-C

    rclpy._state["hook"] = drive
    fake_rclpy.Node.parameter_overrides = dict(_OVERRIDES)
    node_env.main([])
    assert rclpy._state["initialized"] and rclpy._state["shutdown"]
    node = rclpy._state["node"]
    assert node.destroyed
    assert any("final map" in m and "over 1 frames" in m
               for _, m in node.get_logger().records)


def _published_by_both_nodes(backend):
    """The published cloud messages of the JAX node and the port's node,
    each fed the same pairs with ``map_backend`` = backend."""
    displaced = fake_rclpy.install()
    try:
        msgs = {}
        for name, mod in (("jax", fake_rclpy.reload_node()),
                          ("port", _reload_port_node())):
            node = _make_node(mod, map_backend=backend)
            for i in range(4):
                _deliver(node, synthetic_ping(32, 24, seed=20 + i),
                         (0.1 * i, 0.05 * i, 0.0), 80.0 + i, odom_delay=0.01)
            node.timers[0].fire()
            msgs[name] = _pubs_by_topic(node)["/sonar_3d_map"].published[0]
    finally:
        fake_rclpy.Node.parameter_overrides = {}
        fake_rclpy.uninstall(displaced)
        fake_rclpy.reload_node()
        _reload_port_node()
    return msgs


def _assert_same_cloud(msgs):
    got, want = (np.frombuffer(msgs[k].data, np.float32).reshape(-1, 4)
                 for k in ("port", "jax"))
    assert len(got) > 0 and msgs["port"].width == msgs["jax"].width
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=0, atol=1e-5)


def test_published_cloud_matches_jax_node():
    """The same pairs through the JAX node (brick backend) and the port's
    node give the same published points and probabilities."""
    _assert_same_cloud(_published_by_both_nodes("brick"))


def test_dense_node_cloud_matches_jax_node():
    """map_backend "dense" maps through the port's dense mapper (the
    default grid of +-(max_range + 2 m)): the published points equal the
    JAX dense node's in cell order, probabilities within 1e-5."""
    _assert_same_cloud(_published_by_both_nodes("dense"))


def test_sharded_node_cloud_matches_jax_node():
    """map_backend "brick-sharded": the port's node (one shard on its CPU
    device) publishes the JAX sharded node's points (eight virtual
    devices), in another shard order, probabilities within 1e-5."""
    msgs = _published_by_both_nodes("brick-sharded")
    for name in msgs:
        xyzi = np.frombuffer(msgs[name].data, np.float32).reshape(-1, 4)
        msgs[name] = xyzi[np.lexsort(xyzi[:, :3].T)]
    assert len(msgs["port"]) > 0
    np.testing.assert_array_equal(msgs["port"][:, :3], msgs["jax"][:, :3])
    np.testing.assert_allclose(msgs["port"][:, 3], msgs["jax"][:, 3], rtol=0,
                               atol=1e-5)


def test_node_module_imports_without_ros2():
    import sonar_3d_reconstruction_tpu_torch.node as node

    assert node._ROS2 is False  # this environment has no ROS2


def test_node_instantiation_requires_ros2():
    from sonar_3d_reconstruction_tpu_torch.node import SonarMapperNode

    with pytest.raises(ImportError, match="rclpy"):
        SonarMapperNode()


def test_node_param_surface_covers_reference_names():
    """The reference node's parameter names (scripts/3d_mapper_node.py:
    53-107), orientation in degrees, plus the port's backend and device."""
    from sonar_3d_reconstruction_tpu import node as j_node
    from sonar_3d_reconstruction_tpu_torch.node import _NODE_PARAM_DEFAULTS as P

    for name in (
        "horizontal_fov", "vertical_aperture", "max_range", "min_range",
        "intensity_threshold", "sonar_position.x", "sonar_orientation.pitch",
        "voxel_resolution", "min_probability", "adaptive_update",
        "adaptive_threshold", "adaptive_max_ratio", "log_odds_occupied",
        "log_odds_free", "log_odds_min", "log_odds_max", "show_free_space",
        "sonar_frame_id", "base_frame_id", "map_frame_id", "publish_tf",
        "sonar_topic", "odometry_topic", "pointcloud_topic", "marker_topic",
    ):
        assert name in P, name
    assert P["sonar_orientation.pitch"] == 90.0
    assert (P["map_backend"], P["device"]) == ("brick", "")
    want = {k: v for k, v in j_node._NODE_PARAM_DEFAULTS.items()
            if k != "map_backend"}
    assert {k: v for k, v in P.items()
            if k not in ("map_backend", "device")} == want
