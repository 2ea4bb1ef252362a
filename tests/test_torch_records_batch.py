"""The window engine's batched records half: ``frame_records_batch``,
``frame_records`` / ``backproject_ping`` / the dedups over a leading frame
axis, and ``scan_pings_brick(records_batch=, window_group=)`` through
``map_ping_sequence``, against the JAX package and against the port's own
per-frame path.

Tolerances: every batched result is bit-equal to the per-frame one (the
same ops, element for element, in float32 and float64); against the JAX
package, keys, records, counts and stats are equal, FrameAux bounds exact
in float64 and within 1e-5 in float32, log-odds within EXP_ULP_TOL
(tests/torch_parity.py).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.grid.brick import (  # noqa: E402
    init_brick_grid as j_init_brick_grid,
)
from sonar_3d_reconstruction_tpu.ops import records as j_records  # noqa: E402
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
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    brick_state_to_numpy,
    init_brick_grid,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (  # noqa: E402
    resolve_capped_tables,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import (  # noqa: E402
    dedup_frame,
    dedup_frame_compact,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import (  # noqa: E402
    compute_window_boxes,
)
from sonar_3d_reconstruction_tpu_torch.ops.records import (  # noqa: E402
    frame_records,
    frame_records_batch,
)

from test_shard_brick import make_seq  # noqa: E402
from test_torch_pipeline import port_state_to_dict  # noqa: E402
from torch_parity import (  # noqa: E402
    DTYPES,
    assert_brick_states_match,
    port_cfg,
)

AUX_F32_TOL = 1e-5
STATS = ("num_occupied", "num_free", "num_candidates", "overflowed",
         "batch_n_bricks", "batch_n_lanes")
# (records_batch, window_group) against (1, 1), 9 pings in windows of 4:
# 4 = a whole window a batch; 2 = two batches a window; 3 snaps to
# gcd(3, 4) = 1; 0 = the JAX package's full unroll (frame by frame here);
# window groups of 2 (a pair and a single tail window), 3 (all three) and
# 8 (clamped), one with batches too
SETTINGS = [(4, 1), (2, 1), (3, 1), (0, 1), (1, 2), (1, 3), (1, 8), (4, 3)]
JAX_MODES = {"pallas": "pallas-tb16", "pallas-raw": "pallas-raw"}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want, what):
    """Two records or FrameAux tuples, field for field, bit for bit."""
    for k, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (what, k)


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_frame_records_batch_matches_jax(small_cfg, t_dtype, j_dtype):
    """Four pings, one of them masked off: per frame the same unique
    voxel-code records and counts as the JAX batch, FrameAux exact in
    float64 and within 1e-5 in float32."""
    cfg = small_cfg
    images, positions, quats = make_seq(cfg, 4, seed=81)
    T = j_batched_sonar_to_world(positions, quats, cfg)
    frame_on = np.array([True, False, True, True])
    tables = j_resolve_capped_tables(images, cfg, 100, 64)
    jrec, jaux = j_records.frame_records_batch(
        jnp.asarray(images), jnp.asarray(T, j_dtype), jnp.asarray(frame_on),
        tables, cfg, tables.candidates_per_ping(cfg.occupied_window), j_dtype,
    )
    rec, aux = frame_records_batch(
        torch.as_tensor(images), torch.as_tensor(T).to(t_dtype),
        torch.as_tensor(frame_on),
        resolve_capped_tables(images, port_cfg(cfg), 100, 64), port_cfg(cfg),
        t_dtype,
    )
    n_unique = rec.n_unique.numpy()
    np.testing.assert_array_equal(n_unique, np.asarray(jrec.n_unique))
    assert n_unique[1] == 0 and (n_unique[frame_on] > 0).all()
    for i, u in enumerate(n_unique):
        for k in ("hi", "lo", "count", "n_occ"):
            np.testing.assert_array_equal(
                _np(getattr(rec, k))[i, :u], _np(getattr(jrec, k))[i, :u],
                err_msg=f"frame {i} {k}")
        assert (_np(rec.count)[i, u:] == 0).all()
    for k in ("range_fail", "n_valid"):
        np.testing.assert_array_equal(_np(getattr(aux, k)),
                                      _np(getattr(jaux, k)), err_msg=k)
    tol = 0.0 if t_dtype == torch.float64 else AUX_F32_TOL
    for k in ("cmin", "cmax"):
        np.testing.assert_allclose(_np(getattr(aux, k)), _np(getattr(jaux, k)),
                                   rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize(
    "t_dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize(
    "kind", ["compact", "compact-box-per-frame", "raw", "brick-codes",
             "voxel-codes"])
def test_batched_records_equal_per_frame_records(small_cfg, kind, t_dtype):
    """Five pings with one masked off, as one batch: every field of the
    records and the FrameAux of each frame is bit-equal to ``frame_records``
    of that ping alone, for compact box keys (one box, or each frame its
    own window's box, broadcast (F, 1, 3)), raw candidates, two-word brick
    codes and voxel codes."""
    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, 5, seed=82)
    T = pipeline.batched_sonar_to_world(positions, quats, cfg)
    tables = resolve_capped_tables(images, cfg, 100, 64)
    frame_on = torch.tensor([True, True, False, True, True])
    per_frame_box = kind == "compact-box-per-frame"
    box_min = box_bits = None
    brick_bits = 0 if kind == "voxel-codes" else 2
    if kind not in ("brick-codes", "voxel-codes"):
        mins, box_bits = compute_window_boxes(
            T[:, :3, 3], cfg.max_range, cfg.voxel_resolution,
            1 if per_frame_box else 5, 2, frame_bits=3)
        box_min = torch.as_tensor(mins[:, None] if per_frame_box else mins[0])
    images_t = torch.as_tensor(images)
    T_t = torch.as_tensor(T).to(t_dtype)
    kw = dict(dtype=t_dtype, raw=kind == "raw")
    rec, aux = frame_records(images_t, T_t, tables, cfg, box_min, box_bits,
                             brick_bits, frame_on=frame_on, **kw)
    assert int(rec.n_unique[2]) == 0 and (rec.n_unique[frame_on] > 0).all()
    for i in range(5):
        one_rec, one_aux = frame_records(
            images_t[i], T_t[i], tables, cfg,
            None if box_min is None else box_min[i, 0] if per_frame_box
            else box_min, box_bits, brick_bits, frame_on=frame_on[i], **kw)
        _assert_same(type(rec)(*(x[i] for x in rec)), one_rec, (kind, i))
        _assert_same(type(aux)(*(x[i] for x in aux)), one_aux, (kind, i))


def test_dedup_rows_stay_inside_their_frame():
    """(3, N) rows against each row alone, bit for bit: row 0 holds a voxel
    of 2^16+ candidates (pack_fail), row 1 starts with that voxel below
    the packing width (no pack_fail: the distance test must not reach
    across the frame boundary), row 2 is random; the same rows through
    the two-word dedup."""
    n = (1 << 16) + 50
    rng = np.random.default_rng(83)
    key = rng.integers(0, 1 << 29, size=(3, n))
    key[0, :-50] = 12345
    key[1, : 1 << 15] = 12345
    occ = torch.as_tensor(rng.random((3, n)) < 0.3)
    valid = torch.as_tensor(rng.random((3, n)) < 0.95)
    valid[0] = True
    key = torch.as_tensor(key)
    rows = dedup_frame_compact(key, occ, valid)
    np.testing.assert_array_equal(rows.pack_fail.numpy(), [True, False, False])
    for i in range(3):
        _assert_same(type(rows)(*(x[i] for x in rows)),
                     dedup_frame_compact(key[i], occ[i], valid[i]), i)

    hi, lo = key >> 12, key & 0xFFF
    rows = dedup_frame(hi[:, :5000], lo[:, :5000], occ[:, :5000],
                       valid[:, :5000], brick=False)
    for i in range(3):
        _assert_same(type(rows)(*(x[i] for x in rows)),
                     dedup_frame(hi[i, :5000], lo[i, :5000], occ[i, :5000],
                                 valid[i, :5000], brick=False), i)



@functools.lru_cache(maxsize=None)
def jax_scan(cfg, j_dtype, mode):
    """The JAX package's scan of the test survey (9 pings, windows of 4),
    once per process for each (dtype, mode)."""
    images, positions, quats = make_seq(cfg, 9, seed=84)
    T = j_batched_sonar_to_world(positions, quats, cfg)
    boxes = j_compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, 4, 2, frame_bits=2)
    st, stats = j_scan_pings_brick(
        j_init_brick_grid(1 << 15, j_dtype), jnp.asarray(images),
        jnp.asarray(T, j_dtype),
        tables=j_resolve_capped_tables(images, cfg, 100, 64), cfg=cfg,
        dtype=j_dtype, window=4, brick_budget=2048, boxes=boxes,
        dense_mode=JAX_MODES[mode],
    )
    return ({k: np.asarray(getattr(st, k)) for k in (
        "key_rows", "log_odds", "touched", "min_bounds", "max_bounds", "used",
        "poisoned")}, {k: np.asarray(v) for k, v in stats.items()})


@pytest.mark.parametrize("mode", ["pallas", "pallas-raw"])
@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_records_batch_and_window_group_match(small_cfg, t_dtype, j_dtype,
                                              mode):
    """The survey at every (records_batch, window_group) of SETTINGS: map
    state and per-ping stats bit-equal to the (1, 1) run, which matches the
    JAX package's scan (stats exact, log-odds voxel by voxel within
    EXP_ULP_TOL); the JAX tests this mirrors are
    tests/test_brick_grid.py's records_batch and window_group tests."""
    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, 9, seed=84)

    def run(records_batch, window_group):
        return pipeline.map_ping_sequence(
            images, positions, quats, cfg, device="cpu", dtype=t_dtype,
            window=4, dense_mode=mode, records_batch=records_batch,
            window_group=window_group,
        )

    ref_st, ref = run(1, 1)
    want_st, want = jax_scan(small_cfg, j_dtype, mode)
    assert not want["overflowed"].any()
    for k in STATS:
        np.testing.assert_array_equal(ref[k], want[k], err_msg=k)
    ref_np = brick_state_to_numpy(ref_st)
    assert_brick_states_match(ref_np, want_st, t_dtype)
    for rb, wg in SETTINGS:
        st, stats = run(rb, wg)
        for k in pipeline.STAT_DTYPES:
            np.testing.assert_array_equal(stats[k], ref[k],
                                          err_msg=f"{rb}:{wg}:{k}")
        np.testing.assert_equal(brick_state_to_numpy(st), ref_np)


@pytest.mark.parametrize("mode", ["pallas", "pallas-raw"])
def test_wide_keys_take_records_batches(small_cfg, mode):
    """A survey too wide for box keys (two-word brick codes in every
    window, unique records in both modes) at every setting of SETTINGS:
    batched records give the per-frame map bit for bit; window_group has
    nothing to group there (box keys only, as in the JAX package)."""
    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, 9, seed=85)
    positions = positions.copy()
    positions[5] = [3000.0, 3000.0, 0.0]

    def run(records_batch, window_group):
        return pipeline.map_ping_sequence(
            images, positions, quats, cfg, device="cpu", dtype=torch.float64,
            window=4, dense_mode=mode, records_batch=records_batch,
            window_group=window_group,
        )

    ref_st, ref = run(1, 1)
    assert (ref["num_candidates"] > 0).all()
    for rb, wg in SETTINGS:
        st, stats = run(rb, wg)
        for k in pipeline.STAT_DTYPES:
            np.testing.assert_array_equal(stats[k], ref[k],
                                          err_msg=f"{rb}:{wg}:{k}")
        np.testing.assert_equal(brick_state_to_numpy(st),
                                brick_state_to_numpy(ref_st))


@pytest.mark.parametrize("mode", ["pallas", "pallas-raw"])
def test_growth_replay_with_batched_records(small_cfg, mode):
    """A one-bucket table grows and replays from the failed window with
    records_batch 3 and window_group 2: the same map and stats as a
    per-frame run that never had to grow."""
    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, 9, seed=86)
    kw = dict(device="cpu", dtype=torch.float64, window=3, dense_mode=mode)
    grown, g_stats = pipeline.map_ping_sequence(
        images, positions, quats, cfg, records_batch=3, window_group=2,
        state=init_brick_grid(128, torch.float64, "cpu"), **kw)
    big, b_stats = pipeline.map_ping_sequence(images, positions, quats, cfg,
                                              **kw)
    assert grown.capacity > 128 and not bool(grown.poisoned)
    for k in STATS:
        np.testing.assert_array_equal(g_stats[k], b_stats[k], err_msg=k)
    # slots differ after growth: compare the maps voxel by voxel
    assert port_state_to_dict(grown) == port_state_to_dict(big)
    assert int(grown.used) == int(big.used)


def test_failed_window_stops_its_group(small_cfg, monkeypatch):
    """A window that fails in the middle of a group stops the scan there:
    the group's later windows are not applied, and the stats and the
    poisoned state equal the per-window scan's."""
    cfg = port_cfg(small_cfg)
    images, positions, quats = make_seq(small_cfg, 12, seed=87)
    real = pipeline.apply_brick_records_compact
    calls = []

    def fail_second(state, *args, **kw):
        calls.append(1)
        new, stats = real(state, *args, **kw)
        if len(calls) == 2:
            stats["overflowed"] = torch.ones_like(stats["overflowed"])
            return state._replace(poisoned=torch.ones_like(state.poisoned)), stats
        return new, stats

    monkeypatch.setattr(pipeline, "apply_brick_records_compact", fail_second)
    T = pipeline.batched_sonar_to_world(positions, quats, cfg)
    boxes = compute_window_boxes(T[:, :3, 3], cfg.max_range,
                                 cfg.voxel_resolution, 4, 2, frame_bits=2)
    out = {}
    for wg in (1, 3):
        calls.clear()
        out[wg] = pipeline.scan_pings_brick(
            init_brick_grid(1 << 12, torch.float64, "cpu"),
            torch.as_tensor(images), torch.as_tensor(T), 0,
            tables=resolve_capped_tables(images, cfg, 100, 64), cfg=cfg,
            dtype=torch.float64, window=4, boxes=boxes, window_group=wg)
        assert len(calls) == 2, wg
    (st1, s1), (st3, s3) = out[1], out[3]
    np.testing.assert_array_equal(s1["overflowed"], [False] * 4 + [True] * 8)
    for k in pipeline.STAT_DTYPES:
        np.testing.assert_array_equal(s3[k], s1[k], err_msg=k)
    assert bool(st3.poisoned)
    np.testing.assert_equal(brick_state_to_numpy(st3), brick_state_to_numpy(st1))


@pytest.mark.parametrize("records_batch,window_group", [(2, 1), (1, 2), (0, 1)])
@pytest.mark.parametrize("backend", ["hash", "dense"])
def test_other_backends_refuse_records_batching(small_cfg, backend,
                                                records_batch, window_group):
    """JAX's hash and dense scans take neither argument: anything but 1 is
    a ValueError, not silently ignored."""
    images, positions, quats = make_seq(small_cfg, 2, seed=88)
    with pytest.raises(ValueError, match="records_batch and window_group"):
        pipeline.map_ping_sequence(
            images, positions, quats, port_cfg(small_cfg), device="cpu",
            backend=backend, records_batch=records_batch,
            window_group=window_group)


@pytest.mark.parametrize("records_batch,window_group,match", [
    (-1, 1, "records_batch must be >= 0"),
    (1, 0, "window_group must be >= 1"),
])
def test_brick_refuses_negative_batching(small_cfg, records_batch,
                                         window_group, match):
    images, positions, quats = make_seq(small_cfg, 2, seed=88)
    with pytest.raises(ValueError, match=match):
        pipeline.map_ping_sequence(
            images, positions, quats, port_cfg(small_cfg), device="cpu",
            records_batch=records_batch, window_group=window_group)
