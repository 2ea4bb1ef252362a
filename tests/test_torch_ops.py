"""PyTorch port vs the JAX package: config, geometry, log-odds math,
backprojection, key packing, per-frame dedup and frame records.

Inputs are made from numpy seeds and fed to both.  Tolerances: float64
bit-equal, except where exp enters (``EXP_ULP_TOL``); float32 bit-equal
where the arithmetic is the same IEEE operations, ``EXP_ULP_TOL`` where
exp enters and ``F32_POINT_TOL`` on world points, whose cos/sin come from
different libraries (XLA:CPU vs PyTorch).  Integer outputs (keys, records,
counts) are always equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu import config as j_config  # noqa: E402
from sonar_3d_reconstruction_tpu import geometry as j_geometry  # noqa: E402
from sonar_3d_reconstruction_tpu.ops import backproject as j_bp  # noqa: E402
from sonar_3d_reconstruction_tpu.ops import dedup as j_dedup  # noqa: E402
from sonar_3d_reconstruction_tpu.ops import logodds as j_logodds  # noqa: E402
from sonar_3d_reconstruction_tpu.ops import packing as j_packing  # noqa: E402
from sonar_3d_reconstruction_tpu.ops import records as j_records  # noqa: E402
from sonar_3d_reconstruction_tpu.pipeline import (  # noqa: E402
    batched_sonar_to_world as j_batched_sonar_to_world,
)

from sonar_3d_reconstruction_tpu_torch import geometry  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.ops import backproject as bp  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.ops import dedup, logodds, packing  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.ops.records import frame_records  # noqa: E402

from conftest import circular_trajectory, synthetic_ping  # noqa: E402
from torch_parity import DTYPES, EXP_ULP_TOL, port_cfg  # noqa: E402

# float32 world points: one ulp of XLA:CPU vs PyTorch cos/sin, scaled by
# ranges up to 10 m, stays far below this; float64 is compared exactly
F32_POINT_TOL = 1e-5


def pose(cfg, seed):
    rng = np.random.default_rng(seed)
    pos = rng.normal(scale=0.5, size=3)
    yaw = rng.uniform(0, 2 * np.pi)
    q = np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
    return j_geometry.pose_matrix_from_quaternion(pos, q) @ (
        j_geometry.pose_matrix_from_rpy(
            np.asarray(cfg.sonar_position), np.asarray(cfg.sonar_orientation)
        )
    )


def test_config_matches_jax():
    """The port's MapperConfig has the JAX package's fields and defaults."""
    j_fields = dataclasses.fields(j_config.MapperConfig)
    t_fields = dataclasses.fields(MapperConfig)
    assert [(f.name, f.default) for f in t_fields] == [
        (f.name, f.default) for f in j_fields
    ]
    for preset in j_config.PRESETS.values():
        t = port_cfg(preset)
        for prop in ("horizontal_fov_rad", "vertical_aperture_rad",
                     "half_aperture_rad"):
            assert getattr(t, prop) == getattr(preset, prop)


def test_geometry_host_poses_match():
    rng = np.random.default_rng(1)
    cfg = j_config.MapperConfig()
    n = 9
    positions = rng.normal(size=(n, 3))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_array_equal(
        geometry.batched_sonar_to_world(positions, q, port_cfg(cfg)),
        j_batched_sonar_to_world(positions, q, cfg),
    )
    rpy = rng.normal(size=3)
    np.testing.assert_array_equal(
        geometry.pose_matrix_from_rpy(positions[0], rpy),
        j_geometry.pose_matrix_from_rpy(positions[0], rpy),
    )
    np.testing.assert_array_equal(
        geometry.pose_matrix_from_quaternion(positions[0], q[0]),
        j_geometry.pose_matrix_from_quaternion(positions[0], q[0]),
    )
    np.testing.assert_array_equal(
        geometry.quaternion_from_rpy(rpy), j_geometry.quaternion_from_rpy(rpy)
    )


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
@pytest.mark.parametrize("adaptive", [True, False])
def test_finalize_voxel_updates_matches(t_dtype, j_dtype, adaptive):
    """finalize_voxel_updates and sigmoid vs the JAX functions, over voxels
    near the adaptive threshold, the clamp bounds and untouched (count 0)
    lanes: bit-equal without the adaptive update, within EXP_ULP_TOL with
    it."""
    rng = np.random.default_rng(2)
    n = 4096
    cfg = j_config.MapperConfig(adaptive_update=adaptive)
    current = np.concatenate([
        rng.normal(scale=4.0, size=n - 6), [0.0, -10.0, 10.0, 9.9, -9.9, 1e-3]
    ])
    count = rng.integers(0, 6, size=n)
    n_occ = np.minimum(rng.integers(0, 4, size=n), count)
    lo_sum = n_occ * cfg.log_odds_occupied + (count - n_occ) * cfg.log_odds_free
    np_dt = np.dtype(j_dtype)
    args = [current.astype(np_dt), lo_sum.astype(np_dt), count.astype(np_dt)]
    got = logodds.finalize_voxel_updates(
        *[torch.as_tensor(a) for a in args], torch.as_tensor(n_occ > 0),
        port_cfg(cfg),
    ).numpy()
    want = np.asarray(j_logodds.finalize_voxel_updates(
        *[jnp.asarray(a) for a in args], jnp.asarray(n_occ > 0), cfg
    ))
    tol = EXP_ULP_TOL[t_dtype] if adaptive else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert (got != current.astype(np_dt)).sum() > n // 2
    np.testing.assert_allclose(
        logodds.sigmoid(torch.as_tensor(args[0])).numpy(),
        np.asarray(j_logodds.sigmoid(jnp.asarray(args[0]))),
        rtol=0, atol=EXP_ULP_TOL[t_dtype],
    )
    for p in (0.0, 0.3, 0.6, 1.0):
        assert logodds.probability_to_log_odds(p, port_cfg(cfg)) == (
            j_logodds.probability_to_log_odds(p, cfg)
        )


def test_fan_tables_and_caps_match(small_cfg):
    """Host tables and cap gates are the same NumPy float64 values."""
    images = np.stack([synthetic_ping(100, 64, seed=s) for s in range(3)])
    cfg, t = small_cfg, port_cfg(small_cfg)
    for name in ("required_fan_cap", "required_free_cap", "required_window_cap"):
        assert getattr(bp, name)(images, t, 100) == getattr(j_bp, name)(
            images, cfg, 100
        )
    got = bp.resolve_capped_tables(images, t, 100, 64)
    want = j_bp.resolve_capped_tables(images, cfg, 100, 64)
    for f in dataclasses.fields(j_bp.FanTables):
        np.testing.assert_array_equal(
            getattr(got, f.name), getattr(want, f.name), err_msg=f.name
        )
    assert got.candidates_per_ping(50) == want.candidates_per_ping(50)


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
@pytest.mark.parametrize("seed", [3, 4])
def test_backproject_ping_matches(small_cfg, t_dtype, j_dtype, seed):
    cfg = small_cfg.replace(z_filter_enabled=True, z_filter_min=-1.0) if (
        seed == 4
    ) else small_cfg
    img = synthetic_ping(100, 64, seed=seed, density=0.05)
    T = pose(cfg, seed)
    tables = j_bp.build_fan_tables(cfg, 100, 64)
    want = j_bp.backproject_ping(
        jnp.asarray(img), jnp.asarray(T, j_dtype), tables, cfg, dtype=j_dtype
    )
    got = bp.backproject_ping(
        torch.as_tensor(img), torch.as_tensor(T).to(t_dtype),
        bp.build_fan_tables(port_cfg(cfg), 100, 64), port_cfg(cfg),
        dtype=t_dtype,
    )
    for k in ("valid", "is_occupied", "log_odds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    assert got["valid"].any() and got["is_occupied"][got["valid"]].any()
    pts, want_pts = got["points"].numpy(), np.asarray(want["points"])
    if t_dtype == torch.float64:
        np.testing.assert_array_equal(pts, want_pts)
    else:
        np.testing.assert_allclose(pts, want_pts, rtol=0, atol=F32_POINT_TOL)


def test_packing_matches():
    """Brick and box key packing, their inverses, the box gate and mix2 on
    random keys, out-of-range keys included (u32-exact garbage)."""
    rng = np.random.default_rng(5)
    keys = rng.integers(-3000, 3000, size=(4000, 3)).astype(np.int32)
    keys[:10] = rng.integers(-(1 << 19), 1 << 19, size=(10, 3))
    tk = torch.as_tensor(keys)
    for bb in (1, 2, 3):
        hi, lo, ok = packing.pack_brick_keys(tk, bb)
        jhi, jlo, jok = j_packing.pack_brick_keys(jnp.asarray(keys), bb)
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(
            packing.unpack_brick_keys(hi, lo, bb).numpy(),
            np.asarray(j_packing.unpack_brick_keys(jhi, jlo, bb)),
        )

    box_min = np.array([-2048, -1024, -512], np.int32)
    box_bits = (8, 9, 7)
    key, in_box = packing.pack_box_keys(tk, torch.as_tensor(box_min), box_bits, 2)
    jkey, jin = j_packing.pack_box_keys(
        jnp.asarray(keys), jnp.asarray(box_min), box_bits, 2
    )
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    np.testing.assert_array_equal(in_box.numpy(), np.asarray(jin))
    assert in_box.any() and not in_box.all()
    bid = key[in_box] >> 6
    np.testing.assert_array_equal(
        packing.unpack_box_brick(bid, torch.as_tensor(box_min), box_bits, 2).numpy(),
        np.asarray(j_packing.unpack_box_brick(
            jnp.asarray(bid.numpy().astype(np.uint32)), jnp.asarray(box_min),
            box_bits, 2,
        )),
    )

    positions = np.cumsum(rng.normal(scale=0.3, size=(37, 3)), axis=0)
    for window in (1, 4, 16):
        got = packing.compute_window_boxes(positions, 10.0, 0.05, window, 2,
                                           max(1, (window - 1).bit_length()))
        want = j_packing.compute_window_boxes(
            positions, 10.0, 0.05, window, 2, max(1, (window - 1).bit_length())
        )
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert packing.compute_window_boxes(positions * 1e4, 10.0, 0.05, 4, 2, 2) is None

    words = rng.integers(0, 1 << 32, size=(2, 5000), dtype=np.uint64)
    words[:, :4] = [[0, 0xFFFFFFFF, 1, 0xFFFFFFFF], [0, 0xFFFFFFFF, 0xFFFFFFFF, 1]]
    got = packing.mix2(*torch.as_tensor(words.astype(np.int64))).numpy()
    want = np.asarray(j_packing.mix2(*jnp.asarray(words.astype(np.uint32))))
    np.testing.assert_array_equal(got, want)


def _dedup_pair(key, occ, valid):
    n = key.shape[0]
    got = dedup.dedup_frame_compact(
        torch.as_tensor(key.astype(np.int64)), torch.as_tensor(occ),
        torch.as_tensor(valid),
    )
    want = j_dedup.dedup_frame_compact(
        jnp.asarray(key.astype(np.uint32)), jnp.asarray(occ),
        jnp.asarray(valid), unique_budget=n, lane_budget=n,
    )
    return got, want


@pytest.mark.parametrize("seed,n,n_vox", [(6, 5000, 300), (7, 3000, 3000),
                                          (8, 1, 1), (9, 2000, 40)])
def test_dedup_frame_compact_matches(seed, n, n_vox):
    """Records bit-equal to the JAX function's valid prefix (the port keeps
    the full candidate width; the JAX one is given budgets that fit)."""
    rng = np.random.default_rng(seed)
    vox = rng.choice(1 << 29, size=n_vox, replace=False)
    key = vox[rng.integers(0, n_vox, size=n)]
    occ = rng.random(n) < 0.3
    valid = rng.random(n) < 0.9
    got, want = _dedup_pair(key, occ, valid)
    u = int(want.n_unique)
    assert int(got.n_unique) == u
    np.testing.assert_array_equal(got.key.numpy()[:u], np.asarray(want.key)[:u])
    np.testing.assert_array_equal(
        got.payload.numpy()[:u], np.asarray(want.payload)[:u]
    )
    assert (got.key.numpy()[u:] == packing.EMPTY32).all()
    assert (got.payload.numpy()[u:] == 0).all()
    assert not bool(got.pack_fail) and not bool(want.pack_fail)


def test_dedup_pack_fail_matches():
    """A voxel with 2^16 candidates in one frame reports pack_fail."""
    n = (1 << 16) + 50
    key = np.full(n, 12345)
    key[-50:] = np.arange(50)
    got, want = _dedup_pair(key, np.zeros(n, bool), np.ones(n, bool))
    assert bool(got.pack_fail) and bool(want.pack_fail)
    assert int(got.n_unique) == int(want.n_unique) == 51


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_frame_records_matches(small_cfg, t_dtype, j_dtype):
    """Box-key records and the frame reductions of one ping."""
    cfg = small_cfg
    n = 3
    images = np.stack([synthetic_ping(100, 64, seed=30 + i) for i in range(n)])
    positions, quats = circular_trajectory(n, radius=0.8)
    T = j_batched_sonar_to_world(positions, quats, cfg)
    boxes = j_packing.compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, n, 2, 2
    )
    box_min, box_bits = boxes[0][0], boxes[1]
    tables = j_bp.build_fan_tables(cfg, 100, 64)
    for i in range(n):
        jrec, jaux = j_records.frame_records(
            jnp.asarray(images[i]), jnp.asarray(T[i], j_dtype), tables, cfg,
            unique_budget=4096, dtype=j_dtype, brick_bits=2,
            box_min=jnp.asarray(box_min), box_bits=box_bits,
        )
        rec, aux = frame_records(
            torch.as_tensor(images[i]), torch.as_tensor(T[i]).to(t_dtype),
            bp.build_fan_tables(port_cfg(cfg), 100, 64), port_cfg(cfg),
            torch.as_tensor(box_min), box_bits, 2, dtype=t_dtype,
        )
        u = int(jrec.n_unique)
        assert u > 0 and int(rec.n_unique) == u
        np.testing.assert_array_equal(rec.key.numpy()[:u], np.asarray(jrec.key)[:u])
        np.testing.assert_array_equal(
            rec.payload.numpy()[:u], np.asarray(jrec.payload)[:u]
        )
        for k in ("cmin", "cmax", "range_fail", "n_valid"):
            np.testing.assert_array_equal(
                getattr(aux, k).numpy(), np.asarray(getattr(jaux, k)), k
            )


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_raw_frame_records_match(small_cfg, t_dtype, j_dtype):
    """Raw candidate records (no dedup) lane for lane; the valid lanes are
    not a prefix, so nothing downstream may cut them to n_unique."""
    cfg = small_cfg
    images = np.stack([synthetic_ping(100, 64, seed=35)])
    positions, quats = circular_trajectory(1, radius=0.8)
    T = j_batched_sonar_to_world(positions, quats, cfg)
    box_min, box_bits = j_packing.compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, 1, 2, 1
    )
    box_min = box_min[0]
    jrec, jaux = j_records.frame_records(
        jnp.asarray(images[0]), jnp.asarray(T[0], j_dtype),
        j_bp.build_fan_tables(cfg, 100, 64), cfg, unique_budget=4096,
        dtype=j_dtype, brick_bits=2, box_min=jnp.asarray(box_min),
        box_bits=box_bits, raw=True,
    )
    rec, aux = frame_records(
        torch.as_tensor(images[0]), torch.as_tensor(T[0]).to(t_dtype),
        bp.build_fan_tables(port_cfg(cfg), 100, 64), port_cfg(cfg),
        torch.as_tensor(box_min), box_bits, 2, dtype=t_dtype, raw=True,
    )
    np.testing.assert_array_equal(rec.key.numpy(), np.asarray(jrec.key))
    np.testing.assert_array_equal(rec.payload.numpy(), np.asarray(jrec.payload))
    assert int(rec.n_unique) == int(jrec.n_unique) == int(aux.n_valid) > 0
    assert not bool(rec.pack_fail) and not bool(jrec.pack_fail)
    valid = rec.valid.numpy()
    assert np.flatnonzero(valid).max() >= int(rec.n_unique)
    for k in ("cmin", "cmax", "range_fail", "n_valid"):
        np.testing.assert_array_equal(
            getattr(aux, k).numpy(), np.asarray(getattr(jaux, k)), k
        )
