"""The port's wide two-word key path against the JAX package's: voxel and
brick codes (``pack_keys``, ``key_code``), the per-frame dedup over them
(``dedup_frame``), ``frame_records`` without a box, and the brick window
apply of a survey too wide for compact box keys (``map_ping_sequence``,
the mapper), which the JAX package maps with two-word keys too.

Both packages take the same numpy-seeded inputs.  Tolerances: keys,
records, per-ping stats, key rows, touched bits and bounds bit-equal;
log-odds within EXP_ULP_TOL (tests/torch_parity.py: 1e-12 in float64,
1e-5 in float32).  Within the port, raw mode and growth give the dedup
run's map bit for bit.
"""

import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu.grid.brick import (  # noqa: E402
    init_brick_grid as j_init_brick_grid,
)
from sonar_3d_reconstruction_tpu.ops import packing as j_packing  # noqa: E402
from sonar_3d_reconstruction_tpu.ops.backproject import (  # noqa: E402
    build_fan_tables as j_build_fan_tables,
)
from sonar_3d_reconstruction_tpu.ops.dedup import (  # noqa: E402
    dedup_frame as j_dedup_frame,
)
from sonar_3d_reconstruction_tpu.ops.records import (  # noqa: E402
    frame_records as j_frame_records,
)
from sonar_3d_reconstruction_tpu.pipeline import (  # noqa: E402
    batched_sonar_to_world as j_batched_sonar_to_world,
    map_ping_sequence as j_map_ping_sequence,
)

from sonar_3d_reconstruction_tpu_torch import pipeline  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid import brick  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    brick_state_to_numpy,
    init_brick_grid,
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu_torch.models import SonarMapper  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (  # noqa: E402
    build_fan_tables,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import dedup_frame  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.ops.packing import (  # noqa: E402
    EMPTY64,
    EMPTY_HI,
    code_words,
    key_code,
    pack_brick_keys,
    pack_keys,
    unpack_keys,
)
from sonar_3d_reconstruction_tpu_torch.ops.records import frame_records  # noqa: E402

from conftest import circular_trajectory, synthetic_ping  # noqa: E402
from torch_parity import (  # noqa: E402
    DTYPES,
    EXP_ULP_TOL,
    assert_brick_states_match,
    jax_brick_state_to_numpy,
    port_cfg,
)

# 60 m of range at 0.1 m voxels: even one ping's box needs 34 key bits, so
# every window of this survey takes two-word keys
WIDE_CFG = MapperConfig(image_width=64, image_height=100, max_range=60.0,
                        min_range=0.5, voxel_resolution=0.1,
                        intensity_threshold=30)
N_PINGS, WINDOW = 5, 3
# bricks of both packages' tables: the survey never grows them, so one
# JAX program set maps it
CAPACITY = 1 << 16
STATS = ("num_occupied", "num_free", "num_candidates", "overflowed",
         "batch_n_bricks", "batch_n_lanes")
BIAS = 1 << 19


# In float32, XLA:CPU and torch can floor a candidate on a voxel boundary
# into neighbouring voxels (ROADMAP §3): here one candidate of ping 1, of
# 90,834 in the survey, lands one voxel apart in x.  The float32 map is
# held to the pings whose records agree bit for bit.
F32_PINGS = (0, 2, 3, 4)


def wide_survey(pings=tuple(range(N_PINGS))):
    images = np.stack([synthetic_ping(100, 64, seed=900 + i)
                       for i in range(N_PINGS)])
    positions, quats = circular_trajectory(N_PINGS, radius=0.8)
    pings = list(pings)
    return images[pings], positions[pings], quats[pings]


def survey_of(dtype):
    return wide_survey(F32_PINGS if dtype in (torch.float32, jnp.float32)
                       else range(N_PINGS))


@functools.lru_cache(maxsize=None)
def jax_wide(j_dtype):
    """The JAX brick map of the survey in windows of 3: (state as numpy,
    per-ping stats)."""
    st, stats = j_map_ping_sequence(
        *survey_of(j_dtype), WIDE_CFG, backend="brick", dtype=j_dtype,
        window=WINDOW, state=j_init_brick_grid(CAPACITY, j_dtype),
    )
    return jax_brick_state_to_numpy(st), {k: np.asarray(v)
                                          for k, v in stats.items()}


def port_wide(t_dtype, **kw):
    kw.setdefault("state", init_brick_grid(CAPACITY, t_dtype, "cpu"))
    return pipeline.map_ping_sequence(
        *survey_of(t_dtype), port_cfg(WIDE_CFG), device="cpu", dtype=t_dtype,
        window=WINDOW, **kw,
    )


def edge_keys(rng, n_random):
    """Voxel keys at and around the packable range's edges on every axis
    (including the carved-out last x plane), then random in-range keys."""
    axis = [-BIAS - 1, -BIAS, -BIAS + 1, -1, 0, 1, BIAS - 2, BIAS - 1, BIAS]
    edges = np.array(list(itertools.product(axis, axis, axis)), np.int32)
    rand = rng.integers(-BIAS, BIAS - 1, size=(n_random, 3)).astype(np.int32)
    return np.concatenate([edges, rand])


def test_pack_keys_matches_jax():
    """Voxel codes bit-equal to the JAX package's, out-of-range codes and
    the x carve-out included; unpack_keys inverts them."""
    keys = edge_keys(np.random.default_rng(0), 2000)
    hi, lo, ok = pack_keys(torch.as_tensor(keys))
    j_hi, j_lo, j_ok = j_packing.pack_keys(jnp.asarray(keys))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(j_hi, np.int64))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(j_lo, np.int64))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    inside = np.abs(keys + 0.5).max(axis=1) < BIAS
    want_ok = inside & (keys[:, 0] < BIAS - 1)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    assert (hi.numpy()[want_ok] != EMPTY_HI).all()
    assert (lo.numpy() >> 28 == 0)[want_ok].all()
    back = unpack_keys(hi[ok], lo[ok]).numpy()
    np.testing.assert_array_equal(back, keys[want_ok])
    np.testing.assert_array_equal(
        back, np.asarray(j_packing.unpack_keys(j_hi[j_ok], j_lo[j_ok])))


@pytest.mark.parametrize("brick_bits", [0, 1, 2, 3])
def test_key_code_keeps_word_order(brick_bits):
    """The 60-bit code of valid keys (voxel codes, brick codes of every
    brick size) sorts as (hi, lo), stays below EMPTY64, and code_words
    gives the words back; the range edges included."""
    keys = edge_keys(np.random.default_rng(brick_bits), 3000)
    t = torch.as_tensor(keys)
    hi, lo, ok = (pack_brick_keys(t, brick_bits) if brick_bits
                  else pack_keys(t))
    hi, lo = hi[ok], lo[ok]
    code = key_code(hi, lo, brick=brick_bits > 0)
    assert int(code.min()) >= 0 and int(code.max()) < 1 << 60 < EMPTY64
    order = np.lexsort((lo.numpy(), hi.numpy()))
    np.testing.assert_array_equal(torch.argsort(code, stable=True).numpy(),
                                  order)
    w_hi, w_lo = code_words(code, brick=brick_bits > 0)
    assert torch.equal(w_hi, hi) and torch.equal(w_lo, lo)


@pytest.mark.parametrize("brick_bits", [0, 2])
def test_dedup_frame_matches_jax(brick_bits):
    """Unique records, their count and n_occ, and n_unique bit-equal to the
    JAX dedup at an unlimited budget; lanes past n_unique are empty."""
    rng = np.random.default_rng(10 + brick_bits)
    n = 6000
    keys = rng.integers(-12, 12, size=(n, 3)).astype(np.int32)
    keys[:9] = [[BIAS - 5, -BIAS, BIAS - 1]] * 9   # range corner voxels
    keys[9:20] = [[-BIAS, BIAS - 1, -BIAS]] * 11
    occ = rng.random(n) < 0.3
    valid = rng.random(n) < 0.8
    t = torch.as_tensor(keys)
    hi, lo, _ = pack_brick_keys(t, brick_bits) if brick_bits else pack_keys(t)
    got = dedup_frame(hi, lo, torch.as_tensor(occ), torch.as_tensor(valid),
                      brick=brick_bits > 0)
    j_hi, j_lo, _ = (j_packing.pack_brick_keys(jnp.asarray(keys), brick_bits)
                     if brick_bits else j_packing.pack_keys(jnp.asarray(keys)))
    want = j_dedup_frame(j_hi, j_lo, jnp.asarray(occ), jnp.asarray(valid),
                         unique_budget=n)
    u = int(want.n_unique)
    assert int(got.n_unique) == u > 100
    for name in ("hi", "lo", "count", "n_occ"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy()[:u],
            np.asarray(getattr(want, name), np.int64)[:u], err_msg=name)
    assert (got.hi[u:] == EMPTY_HI).all() and (got.count[u:] == 0).all()
    assert int(got.count.sum()) == int(valid.sum())
    assert int(got.n_occ.sum()) == int((valid & occ).sum())


@pytest.mark.parametrize("brick_bits", [0, 2])
def test_frame_records_without_a_box_match_jax(brick_bits):
    """One wide ping's records (voxel or brick codes) and its reductions
    bit-equal to the JAX package's frame_records, float64."""
    cfg = WIDE_CFG
    images, positions, quats = wide_survey()
    T = j_batched_sonar_to_world(positions, quats, cfg)[1]
    rec, aux = frame_records(
        torch.as_tensor(images[1]), torch.as_tensor(T),
        build_fan_tables(port_cfg(cfg), 100, 64), port_cfg(cfg), None, None,
        brick_bits, dtype=torch.float64,
    )
    tables = j_build_fan_tables(cfg, 100, 64)
    fn = jax.jit(j_frame_records, static_argnames=(
        "tables", "cfg", "unique_budget", "dtype", "brick_bits"))
    j_rec, j_aux = fn(jnp.asarray(images[1]), jnp.asarray(T), tables=tables,
                      cfg=cfg, unique_budget=tables.candidates_per_ping(
                          cfg.occupied_window),
                      dtype=jnp.float64, brick_bits=brick_bits)
    u = int(j_rec.n_unique)
    assert int(rec.n_unique) == u > 0
    for name in ("hi", "lo", "count", "n_occ"):
        np.testing.assert_array_equal(
            getattr(rec, name).numpy()[:u],
            np.asarray(getattr(j_rec, name), np.int64)[:u], err_msg=name)
    for name in ("cmin", "cmax", "range_fail", "n_valid"):
        np.testing.assert_array_equal(getattr(aux, name).numpy(),
                                      np.asarray(getattr(j_aux, name)),
                                      err_msg=name)


def test_the_survey_needs_wide_keys():
    """Neither the windows of 3 nor a single ping fit compact box keys."""
    cfg = port_cfg(WIDE_CFG)
    T = pipeline.batched_sonar_to_world(*wide_survey()[1:], cfg)
    for window in (1, WINDOW):
        assert pipeline.compute_window_boxes(
            T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, window, 2,
            frame_bits=max(1, (window - 1).bit_length()),
        ) is None


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_wide_map_matches_jax(t_dtype, j_dtype):
    """map_ping_sequence(backend="brick") maps the wide survey (it raised
    ValueError before the wide path): per-ping stats and the whole map
    state as the JAX package's two-word brick engine, slots included
    (float32 over F32_PINGS)."""
    want_st, want = jax_wide(j_dtype)
    got_st, got = port_wide(t_dtype)
    for k in STATS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["num_candidates"] > 0).all()
    assert_brick_states_match(brick_state_to_numpy(got_st), want_st, t_dtype)


def test_wide_raw_mode_takes_unique_records():
    """dense_mode="pallas-raw" on a wide survey takes unique records, as
    the JAX package ignores the mode there: the dedup run's state and
    stats, lanes included."""
    d_st, d_stats = port_wide(torch.float64)
    r_st, r_stats = port_wide(torch.float64, dense_mode="pallas-raw")
    np.testing.assert_equal(brick_state_to_numpy(r_st),
                            brick_state_to_numpy(d_st))
    for k in pipeline.STAT_DTYPES:
        np.testing.assert_array_equal(r_stats[k], d_stats[k], err_msg=k)


def test_wide_growth_replays_to_the_same_map():
    """From a one-bucket table the wide windows overflow, grow and replay;
    the voxels and stats equal the run that never grew."""
    grown, g_stats = port_wide(
        torch.float64, state=init_brick_grid(128, torch.float64, "cpu"))
    big, b_stats = port_wide(torch.float64)
    assert grown.capacity > 128 and not bool(grown.poisoned)
    for k in STATS:
        np.testing.assert_array_equal(g_stats[k], b_stats[k], err_msg=k)
    np.testing.assert_equal(touched_voxels_brick(grown),
                            touched_voxels_brick(big))


def test_wide_records_reach_k1_sorted_by_brick_frame_offset(monkeypatch):
    """K1 gets each wide window's records strictly ascending by (brick
    rank, frame, offset), unique per slot, with each lane's brick given by
    ``starts``; its result is the plain version's."""
    calls = []
    real = brick.bin_apply

    def spy(s_flat, s_pay, starts, rows_cur, **kw):
        calls.append((s_flat, starts, kw))
        return real(s_flat, s_pay, starts, rows_cur, **kw)

    monkeypatch.setattr(brick, "bin_apply", spy)
    port_wide(torch.float64)
    assert len(calls) == -(-N_PINGS // WINDOW)
    for s_flat, starts, kw in calls:
        assert (s_flat[1:] > s_flat[:-1]).all()
        lane = torch.arange(s_flat.shape[0])
        owner = torch.searchsorted(starts, lane, right=True) - 1
        assert torch.equal(s_flat >> (kw["f_bits"] + kw["o"]), owner)
        assert int(starts[0]) == 0 and int(starts[-1]) == s_flat.shape[0]


def test_wide_mapper_matches_the_jax_map():
    """SonarMapper (brick) maps each wide ping through two-word codes: its
    per-ping stats equal the JAX engine's, and its voxels the JAX map's."""
    want_st, want = jax_wide(jnp.float64)
    images, positions, quats = wide_survey()
    m = SonarMapper(port_cfg(WIDE_CFG), dtype=torch.float64, device="cpu")
    for i, x in enumerate(zip(images, positions, quats)):
        stats = m.process_sonar_image(*x)
        assert stats["num_occupied"] == want["num_occupied"][i]
        assert stats["num_free"] == want["num_free"][i]
        assert m._last_stats["num_candidates"] == want["num_candidates"][i]
    assert m.num_voxels == int(want_st["used"])
    keys, lo = touched_voxels_brick(m.state)
    j_state = brick.brick_state_from_numpy(want_st, "cpu")
    j_keys, j_lo = touched_voxels_brick(j_state)
    np.testing.assert_array_equal(keys, j_keys)
    np.testing.assert_allclose(lo, j_lo, rtol=0, atol=EXP_ULP_TOL[torch.float64])


def test_wide_keys_out_of_the_packable_range_are_fatal():
    """A pose 60 km out puts keys past the ±2^19 cells of two-word codes:
    map_ping_sequence raises, as growth cannot help."""
    images, positions, quats = wide_survey()
    positions = positions + [6.0e4, 0.0, 0.0]
    with pytest.raises(ValueError, match="packable range"):
        pipeline.map_ping_sequence(images[:2], positions[:2], quats[:2],
                                   port_cfg(WIDE_CFG), device="cpu", window=2)
