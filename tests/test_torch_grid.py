"""Port's bucket table ops and brick window apply vs the JAX package.

The bucket ops must produce the identical slot layout (stable insert
order); one window of ``apply_brick_records_compact`` from a non-empty
map, carried across with ``brick_state_from_numpy``, must match the JAX
apply in ``dense_mode="pallas-tb16"``; growth (``rehash_bricks``) and
extraction must match exactly.  Log-odds compare within EXP_ULP_TOL
(tests/torch_parity.py), everything else bit for bit.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.grid import brick as j_brick  # noqa: E402
from sonar_3d_reconstruction_tpu.grid import hash as j_hash  # noqa: E402
from sonar_3d_reconstruction_tpu.ops import records as j_records  # noqa: E402
from sonar_3d_reconstruction_tpu.ops.backproject import (  # noqa: E402
    resolve_capped_tables as j_resolve_capped_tables,
)
from sonar_3d_reconstruction_tpu.ops.packing import (  # noqa: E402
    compute_window_boxes as j_compute_window_boxes,
)
from sonar_3d_reconstruction_tpu.pipeline import (  # noqa: E402
    batched_sonar_to_world as j_batched_sonar_to_world,
    map_ping_sequence as j_map_ping_sequence,
)

from sonar_3d_reconstruction_tpu_torch.grid import brick, hash as t_hash  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.ops.dedup import CompactRecords  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.ops.records import FrameAux  # noqa: E402

from test_shard_brick import make_seq  # noqa: E402
from torch_parity import (  # noqa: E402
    DTYPES,
    assert_brick_states_match,
    jax_brick_state_to_numpy,
    port_cfg,
)


def _filled_table(capacity, n_keys, seed):
    """A JAX key table holding n_keys random brick codes, and the codes."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 31, size=n_keys).astype(np.uint32)
    lo = (rng.integers(0, 1 << 27, size=n_keys) << 4).astype(np.uint32)
    rows = j_hash.empty_key_rows(capacity)
    bucket, found, _, fill = j_hash.bucket_lookup(rows, hi, lo)
    plan = j_hash.plan_insert(rows, hi, lo, ~found, bucket, fill)
    assert not bool(plan.overflowed)
    return j_hash.commit_insert(rows, plan), hi, lo


@pytest.mark.parametrize("capacity,n_old,n_new", [
    pytest.param(1 << 12, 1500, 900, id="fits"),
    pytest.param(256, 100, 300, id="bucket-overflow"),
])
def test_bucket_ops_match(capacity, n_old, n_new):
    """Lookup, insert plan and commit give the JAX package's exact slot
    layout, including a plan whose buckets overflow."""
    rows, old_hi, old_lo = _filled_table(capacity, n_old, seed=11)
    rng = np.random.default_rng(12)
    new_hi = rng.integers(0, 1 << 31, size=n_new).astype(np.uint32)
    new_lo = (rng.integers(0, 1 << 27, size=n_new) << 4).astype(np.uint32)
    # queries: half already present, half new (distinct)
    q_hi = np.concatenate([old_hi[: n_old // 2], new_hi])
    q_lo = np.concatenate([old_lo[: n_old // 2], new_lo])

    jb, jf, jslot, jfill = j_hash.bucket_lookup(rows, q_hi, q_lo)
    t_rows = torch.as_tensor(np.asarray(rows).astype(np.int64))
    t_q = [torch.as_tensor(x.astype(np.int64)) for x in (q_hi, q_lo)]
    tb, tf, tslot, tfill = t_hash.bucket_lookup(t_rows, *t_q)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tf.numpy()[: n_old // 2].all()
    np.testing.assert_array_equal(tslot.numpy()[tf.numpy()], np.asarray(jslot)[np.asarray(jf)])
    np.testing.assert_array_equal(tfill.numpy(), np.asarray(jfill))

    jplan = j_hash.plan_insert(rows, q_hi, q_lo, ~jf, jb, jfill)
    tplan = t_hash.plan_insert(t_rows, *t_q, ~tf, tb, tfill)
    for k in ("s_hi", "s_lo", "s_bkt", "pos_c", "fits", "slots",
              "overflowed"):
        np.testing.assert_array_equal(
            getattr(tplan, k).numpy(), np.asarray(getattr(jplan, k)), err_msg=k
        )
    assert bool(tplan.overflowed) == (capacity == 256)
    np.testing.assert_array_equal(
        t_hash.commit_insert(t_rows, tplan).numpy(),
        np.asarray(j_hash.commit_insert(rows, jplan)),
    )


@functools.lru_cache(maxsize=None)
def _jax_window_inputs(cfg, dtype, n_first=4, window=4, seed=41, raw=False):
    """A non-empty JAX map after n_first pings, and the box-key records of
    the next window (raw candidates if ``raw``), as the JAX package
    computes them (cached: the tests below share them)."""
    images, positions, quats = make_seq(cfg, n_first + window, seed=seed)
    tables = j_resolve_capped_tables(images, cfg, 100, 64)
    T = j_batched_sonar_to_world(positions, quats, cfg)
    boxes = j_compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, window, 2,
        frame_bits=max(1, (window - 1).bit_length()),
    )
    st, _ = j_map_ping_sequence(
        images[:n_first], positions[:n_first], quats[:n_first], cfg,
        backend="brick", dtype=dtype, window=window,
    )
    box_min = boxes[0][n_first // window]
    outs = [
        j_records.frame_records(
            jnp.asarray(images[i]), jnp.asarray(T[i], dtype), tables, cfg,
            unique_budget=4096, dtype=dtype, brick_bits=2,
            box_min=jnp.asarray(box_min), box_bits=boxes[1], raw=raw,
        )
        for i in range(n_first, n_first + window)
    ]
    recs = j_records.CompactRecords(*(jnp.stack(x) for x in zip(*(r for r, _ in outs))))
    auxs = j_records.FrameAux(*(jnp.stack(x) for x in zip(*(a for _, a in outs))))
    return st, recs, auxs, box_min, boxes[1]


def _port_records(recs, auxs):
    return (
        CompactRecords(
            key=torch.as_tensor(np.array(recs.key).astype(np.int64)),
            payload=torch.as_tensor(np.array(recs.payload).astype(np.int64)),
            n_unique=torch.as_tensor(np.array(recs.n_unique).astype(np.int64)),
            pack_fail=torch.as_tensor(np.array(recs.pack_fail)),
        ),
        FrameAux(*(torch.as_tensor(np.array(x)) for x in auxs)),
    )


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_window_apply_matches_pallas_tb16(small_cfg, t_dtype, j_dtype):
    """One window applied to a map that already holds 4 pings."""
    cfg = small_cfg
    st, recs, auxs, box_min, box_bits = _jax_window_inputs(cfg, j_dtype)
    assert int(st.used) > 0
    want_st, want = j_brick.apply_brick_records_compact(
        st, recs, auxs, cfg, jnp.asarray(box_min), box_bits,
        brick_budget=2048, dense_mode="pallas-tb16",
    )
    start = brick.brick_state_from_numpy(jax_brick_state_to_numpy(st), "cpu")
    got_st, got = brick.apply_brick_records_compact(
        start, *_port_records(recs, auxs), port_cfg(cfg), box_min, box_bits
    )
    assert_brick_states_match(
        brick.brick_state_to_numpy(got_st), jax_brick_state_to_numpy(want_st),
        t_dtype,
    )
    for k in ("num_occupied", "num_free", "num_candidates", "overflowed",
              "range_fail", "pack_overflow", "batch_n_bricks", "batch_n_lanes"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    # the apply is out of place: the state it was given is unchanged
    assert_brick_states_match(
        brick.brick_state_to_numpy(start), jax_brick_state_to_numpy(st), t_dtype
    )


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_window_apply_matches_pallas_raw(small_cfg, t_dtype, j_dtype):
    """One window of raw candidates applied to a map that already holds 4
    pings: the JAX apply in ``dense_mode="pallas-raw"`` (the Pallas
    kernel's stats_out form), with the per-frame unique stats from K1."""
    cfg = small_cfg
    st, recs, auxs, box_min, box_bits = _jax_window_inputs(cfg, j_dtype, raw=True)
    want_st, want = j_brick.apply_brick_records_compact(
        st, recs, auxs, cfg, jnp.asarray(box_min), box_bits,
        brick_budget=2048, dense_mode="pallas-raw",
    )
    start = brick.brick_state_from_numpy(jax_brick_state_to_numpy(st), "cpu")
    got_st, got = brick.apply_brick_records_compact(
        start, *_port_records(recs, auxs), port_cfg(cfg), box_min, box_bits,
        dense_mode="pallas-raw",
    )
    assert_brick_states_match(
        brick.brick_state_to_numpy(got_st), jax_brick_state_to_numpy(want_st),
        t_dtype,
    )
    for k in ("num_occupied", "num_free", "num_candidates", "overflowed",
              "range_fail", "pack_overflow", "batch_n_bricks", "batch_n_lanes"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    # raw lanes count candidates, and the unique stats are far fewer
    assert (got["batch_n_lanes"].numpy() == int(recs.valid.sum())).all()
    uniques = (got["num_occupied"] + got["num_free"]).numpy()
    assert (uniques < np.asarray(auxs.n_valid)).all()


@pytest.mark.parametrize("mode", ["bfv", "pallas-tb16", "pallas-raw-tb16", "raw"])
def test_window_apply_rejects_other_dense_modes(small_cfg, mode):
    st, recs, auxs, box_min, box_bits = _jax_window_inputs(small_cfg, jnp.float64)
    start = brick.brick_state_from_numpy(jax_brick_state_to_numpy(st), "cpu")
    with pytest.raises(ValueError, match="pallas-raw"):
        brick.apply_brick_records_compact(
            start, *_port_records(recs, auxs), port_cfg(small_cfg), box_min,
            box_bits, dense_mode=mode,
        )


def test_failed_window_leaves_the_map_untouched(small_cfg):
    """A window whose records report pack_fail (or range_fail) is rejected
    whole: same tables, state poisoned, overflowed per frame."""
    cfg = small_cfg
    st, recs, auxs, box_min, box_bits = _jax_window_inputs(cfg, jnp.float64)
    start = brick.brick_state_from_numpy(jax_brick_state_to_numpy(st), "cpu")
    t_recs, t_auxs = _port_records(recs, auxs)
    for cause, r, a in (
        ("pack_overflow", t_recs._replace(pack_fail=torch.tensor([0, 1, 0, 0]).bool()), t_auxs),
        ("range_fail", t_recs, t_auxs._replace(range_fail=torch.tensor([0, 0, 1, 0]).bool())),
    ):
        got_st, stats = brick.apply_brick_records_compact(
            start, r, a, port_cfg(cfg), box_min, box_bits
        )
        assert stats["overflowed"].all() and stats[cause].any()
        assert (stats["num_candidates"] == 0).all()
        want = brick.brick_state_to_numpy(start)
        got = brick.brick_state_to_numpy(got_st)
        assert got.pop("poisoned") and not want.pop("poisoned")
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], k)


def test_rehash_and_extraction_match(small_cfg):
    """rehash_bricks lays the grown table out as the JAX package does, and
    extraction returns the same voxels in the same order."""
    cfg = small_cfg
    st = _jax_window_inputs(cfg, jnp.float64)[0]
    d = jax_brick_state_to_numpy(st)
    t_st = brick.brick_state_from_numpy(d, "cpu")
    np.testing.assert_equal(brick.brick_state_to_numpy(t_st), d)

    for new_cap in (1 << 13, 128):
        want = j_brick.rehash_bricks(st, new_cap)
        got = brick.rehash_bricks(t_st, new_cap)
        assert got.capacity == want.capacity
        np.testing.assert_equal(
            brick.brick_state_to_numpy(got), jax_brick_state_to_numpy(want)
        )
    assert got.capacity > 128  # 128 slots cannot hold the map: it doubled

    pts, probs = brick.extract_occupied_brick(got, port_cfg(cfg))
    want_pts, want_probs = j_brick.extract_occupied_brick(st, cfg)
    assert len(pts) > 0
    np.testing.assert_array_equal(pts, want_pts)
    np.testing.assert_array_equal(probs, want_probs)
