"""The port's counterparts of tests/test_integration.py, held to the port's
golden oracle (``sonar_3d_reconstruction_tpu_torch.golden``): a 100-ping
replay, its golden prefix, the z filter end to end, a mono16 bag through
the stream, float32 against golden, and both production presets.

Tolerances: float64 voxel sets and per-ping stats equal to golden's,
log-odds within 1e-9; float32 voxel sets equal, probabilities within
1e-5 (the BASELINE bar).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sonar_3d_reconstruction_tpu_torch.config import PRESETS  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.golden import GoldenMapper  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    brick_state_to_numpy,
    init_brick_grid,
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu_torch.grid.hash import (  # noqa: E402
    HashGridState,
    touched_voxels_hash,
)
from sonar_3d_reconstruction_tpu_torch.models import SonarMapper  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.pipeline import (  # noqa: E402
    map_ping_sequence,
)

from conftest import circular_trajectory, synthetic_ping  # noqa: E402
from torch_parity import port_cfg  # noqa: E402

F64_TOL = 1e-9
PROB_TOL = 1e-5


def voxels(state):
    """{(kx, ky, kz): log-odds} of a brick or hash map's touched voxels."""
    keys, lo = (touched_voxels_hash if isinstance(state, HashGridState)
                else touched_voxels_brick)(state)
    return dict(zip(map(tuple, keys.tolist()), lo.astype(np.float64).tolist()))


def golden(cfg, images, positions, quats):
    """(oracle, per-ping stats) after the pings."""
    g = GoldenMapper(cfg)
    return g, [g.process_ping(*x) for x in zip(images, positions, quats)]


def assert_matches_golden(got, g, g_stats=None, stats=None, tol=F64_TOL):
    """A port map's voxels (and per-ping stats) against golden's."""
    assert got.keys() == g.map.log_odds.keys()
    worst = max(abs(got[k] - v) for k, v in g.map.log_odds.items())
    assert worst <= tol, worst
    if stats is not None:
        for k in ("num_occupied", "num_free"):
            np.testing.assert_array_equal(stats[k], [s[k] for s in g_stats],
                                          err_msg=k)


def downward_survey(cfg, n, seed=0):
    """BASELINE config 2 shape: down-looking sonar, straight-line pass."""
    images = np.stack([synthetic_ping(cfg.image_height, cfg.image_width,
                                      seed=seed + i) for i in range(n)])
    positions = np.stack([0.1 * np.arange(n), np.zeros(n), np.full(n, 2.0)],
                         axis=-1)
    return images, positions, np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))


@pytest.fixture
def down_cfg(small_cfg):
    return port_cfg(small_cfg).replace(sonar_orientation=(0.0, 1.5708, 0.0))


def test_hundred_ping_sequence_deterministic(down_cfg):
    """100 pings: every ping emits, a replay into a table of the first
    run's size is bit-identical, and the map is golden's."""
    images, positions, quats = downward_survey(down_cfg, 100, seed=900)
    st1, stats1 = map_ping_sequence(images, positions, quats, down_cfg,
                                    device="cpu", dtype=torch.float64)
    assert not stats1["overflowed"].any()
    assert (stats1["num_candidates"] > 0).all()
    st2, stats2 = map_ping_sequence(
        images, positions, quats, down_cfg, device="cpu", dtype=torch.float64,
        state=init_brick_grid(st1.capacity, torch.float64, "cpu"))
    np.testing.assert_equal(brick_state_to_numpy(st2), brick_state_to_numpy(st1))
    for k, v in stats1.items():
        np.testing.assert_array_equal(stats2[k], v, err_msg=k)
    assert_matches_golden(voxels(st1), *golden(down_cfg, images, positions,
                                               quats), stats1)


@pytest.mark.parametrize("backend", ["brick", "hash"])
def test_hundred_ping_prefix_matches_golden(down_cfg, backend):
    """The first 6 pings of the 100-ping scenario against the oracle."""
    images, positions, quats = downward_survey(down_cfg, 6, seed=900)
    st, stats = map_ping_sequence(images, positions, quats, down_cfg,
                                  device="cpu", dtype=torch.float64,
                                  backend=backend)
    assert_matches_golden(voxels(st), *golden(down_cfg, images, positions,
                                              quats), stats)


def test_z_filter_end_to_end(small_cfg):
    """The z filter drops candidates below the plane in the mapper path
    (reference 3d_mapper.py:443-444, 478-479), as golden does."""
    cfg = port_cfg(small_cfg).replace(z_filter_enabled=True, z_filter_min=-0.8)
    m = SonarMapper(cfg, initial_capacity=1 << 13, dtype=torch.float64,
                    device="cpu")
    img = synthetic_ping(cfg.image_height, cfg.image_width, seed=42)
    s = m.process_sonar_image(img, [0, 0, 0], [0, 0, 0, 1])
    g, g_stats = golden(cfg, img[None], [[0, 0, 0]], [[0, 0, 0, 1]])
    assert s["num_voxels"] == g_stats[0]["num_voxels"]
    assert (s["num_occupied"], s["num_free"]) == (
        g_stats[0]["num_occupied"], g_stats[0]["num_free"])
    assert_matches_golden(voxels(m.state), g)
    pts = m.get_point_cloud()["points"]
    # voxel CENTRES of points at z >= z_min can sit half a cell below
    assert (pts[:, 2] >= cfg.z_filter_min - cfg.voxel_resolution).all()
    # the filter clipped part of the fan: unfiltered, the map reaches below
    unfiltered, _ = golden(cfg.replace(z_filter_enabled=False), img[None],
                           [[0, 0, 0]], [[0, 0, 0, 1]])
    floor = np.floor(cfg.z_filter_min / cfg.voxel_resolution) - 1
    assert any(k[2] < floor for k in unfiltered.map.log_odds)
    assert not any(k[2] < floor for k in g.map.log_odds)


def test_mono16_bag_end_to_end(tmp_path, small_cfg):
    """A mono16 recording streams through decode (/256) to the map of the
    equivalent mono8 pings, which is golden's."""
    from sonar_3d_reconstruction_tpu_torch.io.bag import (
        IMAGE_TYPE,
        ODOMETRY_TYPE,
        BagWriter,
        ImageMsg,
        OdometryMsg,
    )
    from sonar_3d_reconstruction_tpu_torch.stream import StreamingMapper

    cfg, n = port_cfg(small_cfg), 4
    images8 = np.stack([synthetic_ping(cfg.image_height, cfg.image_width,
                                       seed=70 + i) for i in range(n)])
    positions = np.cumsum(np.full((n, 3), 0.1), axis=0)
    quats = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    path16 = str(tmp_path / "m16.db3")
    with BagWriter(path16) as w:
        w.add_topic("/sensor/sonar/oculus/m750d/image", IMAGE_TYPE)
        w.add_topic("/fast_lio/odometry", ODOMETRY_TYPE)
        for i in range(n):
            t = 1000.0 + i
            img16 = (images8[i].astype(np.uint16) * 256 + 128).astype("<u2")
            w.write("/sensor/sonar/oculus/m750d/image", t, ImageMsg(
                t, "sonar_link", cfg.image_height, cfg.image_width, "mono16",
                False, cfg.image_width * 2, img16.tobytes()))
            w.write("/fast_lio/odometry", t, OdometryMsg(
                t, "camera_init", "body", positions[i], quats[i]))

    sm = StreamingMapper(cfg, chunk_size=4, initial_capacity=1 << 13,
                         dtype=torch.float64, device="cpu")
    stats = sm.run_bag(path16)
    assert stats.pairs == n and stats.decode_errors == 0
    direct, _ = map_ping_sequence(images8, positions, quats, cfg,
                                  device="cpu", dtype=torch.float64)
    assert voxels(sm.state) == voxels(direct)
    assert_matches_golden(voxels(sm.state),
                          golden(cfg, images8, positions, quats)[0])


@pytest.mark.parametrize("backend", ["brick", "hash"])
def test_float32_parity_vs_golden_1e5(small_cfg, backend):
    """The BASELINE bar: float32 occupancy probabilities within 1e-5 of
    the float64 oracle over a multi-ping sequence, with no voxel set
    difference on this survey."""
    cfg, n = port_cfg(small_cfg), 8
    images = np.stack([synthetic_ping(cfg.image_height, cfg.image_width,
                                      seed=1000 + i) for i in range(n)])
    positions, quats = circular_trajectory(n, radius=0.6)
    st, stats = map_ping_sequence(images, positions, quats, cfg, device="cpu",
                                  dtype=torch.float32, backend=backend)
    assert not stats["overflowed"].any()
    got = voxels(st)
    gold = golden(cfg, images, positions, quats)[0].map.log_odds
    assert got.keys() == gold.keys()
    worst = max(abs(1 / (1 + np.exp(-got[k])) - 1 / (1 + np.exp(-v)))
                for k, v in gold.items())
    assert worst < PROB_TOL, f"worst probability deviation {worst}"


@pytest.mark.parametrize("name", ["kiro_tilt60", "kiro_tilt90"])
def test_production_preset_matches_golden(name):
    """Exact float64 golden parity on a production preset (70 deg FOV,
    60 or 90 deg down-tilt, 0.15 m voxels, min_range 1.0, z filter at
    -6.3 / -6.5 m, adaptive 0.5 / 0.3, log-odds clamped to [-10, 7]) at
    test-size image geometry, on a pass shallow enough that the z filter
    clips part of the fan."""
    cfg = PRESETS[name].replace(image_width=64, image_height=80)
    n = 4
    images = np.stack([synthetic_ping(80, 64, seed=700 + i) for i in range(n)])
    positions = np.stack([0.2 * np.arange(n), np.zeros(n), np.full(n, -4.0)],
                         axis=-1)
    quats = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    st, stats = map_ping_sequence(images, positions, quats, cfg, device="cpu",
                                  dtype=torch.float64)
    g, g_stats = golden(cfg, images, positions, quats)
    got = voxels(st)
    assert_matches_golden(got, g, g_stats, stats)
    assert len(got) > 50  # the scenario populated a map
    assert max(got.values()) <= cfg.log_odds_max + 1e-12
    # the z filter clipped part of the fan: the same pass unfiltered emits
    # more candidates and maps voxels below the plane
    _, open_stats = map_ping_sequence(
        images, positions, quats, cfg.replace(z_filter_enabled=False),
        device="cpu", dtype=torch.float64)
    assert (open_stats["num_candidates"] > stats["num_candidates"]).all()
    floor = np.floor(cfg.z_filter_min / cfg.voxel_resolution) - 1
    assert not any(k[2] < floor for k in got)
