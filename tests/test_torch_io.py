"""The port's copies of the JAX package's host I/O (``io/bag.py``,
``io/mcap.py``, ``io/timesync.py``, ``io/pointcloud.py``, ``io/image.py``,
``io/native.py``) against the originals.

Tolerance: none.  Decoded images, poses, stamps, pairs and serialized
bytes are compared bit for bit.
"""

import os

import numpy as np
import pytest

from sonar_3d_reconstruction_tpu.io import bag as j_bag
from sonar_3d_reconstruction_tpu.io import image as j_image
from sonar_3d_reconstruction_tpu.io import pointcloud as j_pointcloud
from sonar_3d_reconstruction_tpu.io import timesync as j_timesync

from sonar_3d_reconstruction_tpu_torch.io import bag as t_bag
from sonar_3d_reconstruction_tpu_torch.io import image as t_image
from sonar_3d_reconstruction_tpu_torch.io import native as t_native
from sonar_3d_reconstruction_tpu_torch.io import pointcloud as t_pointcloud
from sonar_3d_reconstruction_tpu_torch.io import timesync as t_timesync

from tests.fixtures.make_external_fixtures import IMAGE_TOPIC, ODOM_TOPIC

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native_lib():
    """The port's native library, built.  The JAX package's stays as its
    own tests leave it: its Python paths are the reference here, and its
    tests hold its native paths to them."""
    t_native.build()
    assert t_native.available()


def assert_sequences_equal(got, want):
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("name", ["external_survey.db3", "external_survey.mcap"])
def test_load_bag_sequence_matches_jax(name, use_native, request):
    """Foreign-written bags (big-endian odometry CDR, padded mono16 rows,
    a zstd chunk with its schemas inside) decode and pair bit-equal, by
    the port's Python and native paths, to the JAX package's Python path."""
    if use_native:
        request.getfixturevalue("native_lib")
    path = os.path.join(FIXTURES, name)
    kw = dict(sonar_topic=IMAGE_TOPIC, odometry_topic=ODOM_TOPIC)
    got = t_bag.load_bag_sequence(path, use_native=use_native, **kw)
    assert len(got[0]) > 0
    assert_sequences_equal(
        got, j_bag.load_bag_sequence(path, use_native=False, **kw))


@pytest.mark.parametrize("ext", [".db3", ".mcap"])
def test_bags_written_by_either_package_read_in_the_other(tmp_path, ext,
                                                         native_lib):
    """Each package's writer, the other package's reader: the same
    sequence (the port writes mcap in zstd chunks where its native codec
    has them)."""
    rng = np.random.default_rng(4)
    n = 5
    images = rng.integers(0, 255, size=(n, 30, 24)).astype(np.uint8)
    positions = rng.normal(size=(n, 3))
    quats = rng.normal(size=(n, 4))
    paths = {}
    for name, mod in (("port", t_bag), ("jax", j_bag)):
        paths[name] = str(tmp_path / f"{name}{ext}")
        mod.write_synthetic_bag(paths[name], images, positions, quats,
                                rate_hz=5.0, odom_jitter=0.02)
    got = t_bag.load_bag_sequence(paths["jax"], use_native=False)
    want = j_bag.load_bag_sequence(paths["port"], use_native=False)
    assert_sequences_equal(got, want)
    np.testing.assert_array_equal(got[0], images)
    with t_bag.BagReader(paths["jax"]) if ext == ".db3" else _mcap(paths["jax"]) as r:
        msgs = list(r.messages())
    assert len(msgs) == 2 * n


def _mcap(path):
    from sonar_3d_reconstruction_tpu_torch.io.mcap import McapReader

    return McapReader(path)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_time_sync_pairs_match_jax(seed):
    """Random streams with jitter, gaps and repeated stamps pair the same,
    offline (pair_streams) and live (ApproximateTimeSync)."""
    rng = np.random.default_rng(seed)
    pings = np.round(np.cumsum(rng.uniform(0.0, 0.2, size=80)), 2)
    poses = np.round(np.sort(rng.uniform(0, pings[-1], size=120)), 2)
    for slop in (0.05, 0.1):
        assert (t_timesync.pair_streams(pings, poses, slop)
                == j_timesync.pair_streams(pings, poses, slop))
    got, want = [], []
    syncs = (t_timesync.ApproximateTimeSync(lambda a, b: got.append((a, b)), 5),
             j_timesync.ApproximateTimeSync(lambda a, b: want.append((a, b)), 5))
    events = [(t, 0, i) for i, t in enumerate(pings)] + [
        (t, 1, i) for i, t in enumerate(poses)]
    for k in rng.permutation(len(events)):
        t, kind, i = events[k]
        for s in syncs:
            (s.add_ping if kind == 0 else s.add_pose)(i, t)
    assert got == want and len(got) > 0
    assert syncs[0].dropped == syncs[1].dropped


def test_pointcloud_bytes_match_jax():
    rng = np.random.default_rng(6)
    pts, probs = rng.normal(size=(257, 3)) * 40, rng.uniform(size=257)
    for n in (0, 1, 257):
        got = t_pointcloud.serialize_pointcloud2(pts[:n], probs[:n], "map", (3, 4))
        want = j_pointcloud.serialize_pointcloud2(pts[:n], probs[:n], "map", (3, 4))
        assert got == want
        for a, b in zip(t_pointcloud.parse_pointcloud2(got),
                        j_pointcloud.parse_pointcloud2(want)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("encoding,itemsize,big", [
    ("mono8", 1, False), ("mono16", 2, False), ("16UC1", 2, True)])
def test_image_decode_matches_jax(encoding, itemsize, big):
    rng = np.random.default_rng(8)
    h, w, pad = 7, 9, 3
    data = rng.integers(0, 256, size=h * (w * itemsize + pad)).astype(np.uint8)
    step = w * itemsize + pad
    got = t_image.decode_image(data.tobytes(), h, w, encoding, step, big)
    want = j_image.decode_image(data.tobytes(), h, w, encoding, step, big)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    with pytest.raises(t_image.UnsupportedEncoding):
        t_image.decode_image(data.tobytes(), h, w, "rgb8")


def test_native_library_builds_outside_the_source_tree(native_lib):
    """The port builds native/sonar3d_io.cpp into build/native/, and its
    batch decoders and XYZI packing agree with the Python paths."""
    lib = t_native.build()
    assert lib == os.path.join(ROOT, "build", "native", "libsonar3d_io.so")
    rng = np.random.default_rng(9)
    msgs = [t_bag.OdometryMsg(1.7e9 + 0.5 * i, "odom", "base",
                              rng.normal(size=3), rng.normal(size=4))
            for i in range(6)]
    stamps, pos, q = t_native.odometry_decode_batch(
        [t_bag.encode_odometry_msg(m) for m in msgs])
    np.testing.assert_array_equal(pos, np.stack([m.position for m in msgs]))
    np.testing.assert_array_equal(q, np.stack([m.orientation for m in msgs]))
    pts, probs = rng.normal(size=(33, 3)), rng.uniform(size=33)
    assert (t_native.pack_xyzi(pts, probs)
            == t_pointcloud.serialize_pointcloud2(pts, probs)["data"])
