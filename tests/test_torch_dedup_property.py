"""Randomized property tests of the port's sort dedups, key packings and
bucket insert against straightforward NumPy references (the port's
counterparts of tests/test_dedup_property.py), plus batched rows: a
(B, N) batch of frames dedups row by row, and no record crosses a row.

Tolerance: none; every aggregate, key and slot is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sonar_3d_reconstruction_tpu_torch.grid.hash import (  # noqa: E402
    BUCKET_SLOTS,
    bucket_lookup,
    init_hash_grid,
    insert_unique,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import (  # noqa: E402
    dedup_frame,
    dedup_frame_compact,
    dedup_frame_compact_grouped,
    dedup_frame_grouped,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import (  # noqa: E402
    EMPTY_HI,
    pack_box_keys,
    pack_keys,
    unpack_box_brick,
    unpack_keys,
)

import torch_parity  # noqa: E402,F401  (one torch thread a test process)

BRICK_BITS = 2
BOX_BITS = (4, 4, 4)
BOX_MIN = np.asarray([-16, -16, -16], np.int64)  # brick-aligned
ROWS = pytest.mark.parametrize("rows", [1, 4], ids=["one_row", "rows4"])


def naive_dedup(keys, occ, valid):
    agg = {}
    for k, o, v in zip(map(tuple, keys), occ, valid):
        if not v:
            continue
        c, no = agg.get(k, (0, 0))
        agg[k] = (c + 1, no + int(o))
    return agg


def random_frames(rng, rows):
    """(rows, n, 3) int32 keys over a small spread (so voxels repeat within
    and across rows), occupied flags and emission masks."""
    n = int(rng.integers(10, 3000))
    spread = int(rng.integers(2, 12))
    keys = rng.integers(-spread, spread, (rows, n, 3)).astype(np.int32)
    return keys, rng.random((rows, n)) < 0.4, rng.random((rows, n)) < 0.8


def box_voxels(rkey, box_min):
    """Compact box keys -> (N, 3) global voxel keys (brick corner + the
    offset in the brick)."""
    o = 3 * BRICK_BITS
    corner = unpack_box_brick(torch.as_tensor(rkey >> o), torch.as_tensor(box_min),
                              BOX_BITS, BRICK_BITS).numpy()
    offc = rkey & ((1 << o) - 1)
    b = 1 << BRICK_BITS
    offs = np.stack([offc >> (2 * BRICK_BITS), (offc >> BRICK_BITS) & (b - 1),
                     offc & (b - 1)], axis=-1)
    return corner + offs


def compact_row(rec, r, box_min):
    """Row ``r`` of CompactRecords -> ({voxel: (count, n_occ)}, record
    keys in lane order)."""
    rkey = rec.key[r].numpy()
    pay = rec.payload[r].numpy()
    valid = rec.valid[r].numpy()
    uk = box_voxels(rkey[valid], box_min)
    got = dict(zip(map(tuple, uk.tolist()),
                   zip((pay[valid] >> 16).tolist(), (pay[valid] & 0xFFFF).tolist())))
    return got, rkey[valid]


@ROWS
def test_dedup_frame_random_property(rows):
    rng = np.random.default_rng(7)
    for trial in range(8):
        keys, occ, valid = random_frames(rng, rows)
        hi, lo, _ = pack_keys(torch.as_tensor(keys))
        rec = dedup_frame(hi, lo, torch.as_tensor(occ), torch.as_tensor(valid),
                          False)
        for r in range(rows):
            expect = naive_dedup(keys[r], occ[r], valid[r])
            assert int(rec.n_unique[r]) == len(expect), (trial, r)
            v = rec.valid[r].numpy()
            # valid records are a prefix, in ascending key order
            assert v[:len(expect)].all() and not v[len(expect):].any()
            uk = unpack_keys(rec.hi[r][v], rec.lo[r][v]).numpy()
            got = dict(zip(map(tuple, uk.tolist()),
                           zip(rec.count[r][v].tolist(), rec.n_occ[r][v].tolist())))
            assert got == expect, (trial, r)


def test_bucket_insert_random_property():
    """Random unique key sets: every key inserted exactly once, findable,
    distinct slots, bucket prefix-fill invariant maintained."""
    rng = np.random.default_rng(11)
    ran = 0
    for trial in range(6):
        capacity = 1 << int(rng.integers(7, 13))
        n = int(rng.integers(1, max(2, capacity // 8)))
        keys = rng.choice(10000, size=n, replace=False)
        keys = np.stack([keys % 21 - 10, (keys // 21) % 23 - 11,
                         keys // (21 * 23)], axis=-1).astype(np.int32)
        hi, lo, _ = pack_keys(torch.as_tensor(keys))
        state = init_hash_grid(capacity, torch.float32, "cpu")
        bucket, found, _, fill = bucket_lookup(state.key_rows, hi, lo)
        assert not bool(found.any())
        key_rows, slots, ovf, n_ins = insert_unique(
            state.key_rows, hi, lo, torch.ones(n, dtype=torch.bool), bucket,
            fill)
        if bool(ovf):
            continue  # legitimately full bucket at high load
        ran += 1
        slots = slots.numpy()
        assert int(n_ins) == n
        assert len(set(slots.tolist())) == n
        # findable afterwards at the same slots
        _, found2, found_slot2, _ = bucket_lookup(key_rows, hi, lo)
        assert bool(found2.all())
        np.testing.assert_array_equal(found_slot2.numpy(), slots)
        # prefix-fill invariant: within each bucket, occupied slots form a
        # prefix
        occupied = key_rows[:, :BUCKET_SLOTS].numpy() != EMPTY_HI
        for r in occupied:
            k = int(r.sum())
            assert r[:k].all() and not r[k:].any()
    assert ran >= 4, "too many trials skipped on overflow"


def test_incremental_inserts_preserve_invariants():
    """Multiple insert waves (as happens across frames) keep lookup exact."""
    rng = np.random.default_rng(13)
    key_rows = init_hash_grid(1 << 10, torch.float32, "cpu").key_rows
    all_keys = {}
    for wave in range(5):
        keys = rng.integers(-40, 40, (40, 3)).astype(np.int32)
        hi, lo, _ = pack_keys(torch.as_tensor(keys))
        bucket, found, found_slot, fill = bucket_lookup(key_rows, hi, lo)
        # previously inserted keys are found at their original slots
        for i, k in enumerate(map(tuple, keys.tolist())):
            if k in all_keys:
                assert bool(found[i]), (wave, k)
                assert int(found_slot[i]) == all_keys[k]
        # dedup within the wave (insert_unique takes distinct keys)
        seen, need = set(), []
        for k in map(tuple, keys.tolist()):
            fresh = k not in all_keys and k not in seen
            need.append(fresh)
            seen.add(k)
        key_rows, slots, ovf, _ = insert_unique(
            key_rows, hi, lo, torch.as_tensor(need), bucket, fill)
        assert not bool(ovf)
        for i, k in enumerate(map(tuple, keys.tolist())):
            if need[i]:
                all_keys[k] = int(slots[i])


@ROWS
def test_dedup_frame_compact_random_property(rows):
    """dedup_frame_compact over box-relative keys gives the naive dict's
    aggregates, row by row."""
    rng = np.random.default_rng(11)
    for trial in range(8):
        keys, occ, valid = random_frames(rng, rows)
        bkey, in_box = pack_box_keys(torch.as_tensor(keys),
                                     torch.as_tensor(BOX_MIN), BOX_BITS,
                                     BRICK_BITS)
        assert bool(in_box.all()), "spread exceeds the test box"
        rec = dedup_frame_compact(bkey, torch.as_tensor(occ),
                                  torch.as_tensor(valid))
        assert not bool(rec.pack_fail.any())
        for r in range(rows):
            expect = naive_dedup(keys[r], occ[r], valid[r])
            assert int(rec.n_unique[r]) == len(expect), (trial, r)
            got, rkey = compact_row(rec, r, BOX_MIN)
            assert (np.diff(rkey) > 0).all()
            assert got == expect, (trial, r)


def test_pack_box_keys_bounds_and_order():
    """in_box gating is exact at the box faces, the packing is a bijection
    over the box, and a batch with a box per frame packs each frame
    against its own box."""
    box_bits = (2, 3, 2)  # 4 x 8 x 4 bricks = 16 x 32 x 16 voxels
    box_min = np.asarray([-8, 4, 0], np.int64)
    size = np.asarray([16, 32, 16])
    lo, hi = box_min, box_min + size - 1
    probes = np.array([
        lo, hi, lo - 1, hi + 1,
        [lo[0], lo[1], hi[2] + 1],
        [hi[0] + 1, lo[1], lo[2]],
        [lo[0], hi[1] + 1, lo[2]],
    ], np.int32)
    key, in_box = pack_box_keys(torch.as_tensor(probes), torch.as_tensor(box_min),
                                box_bits, BRICK_BITS)
    assert in_box.tolist() == [True, True, False, False, False, False, False]
    grid = np.stack(np.meshgrid(
        np.arange(size[0]) + box_min[0], np.arange(size[1]) + box_min[1],
        np.arange(size[2]) + box_min[2], indexing="ij",
    ), -1).reshape(-1, 3).astype(np.int32)
    k, ib = pack_box_keys(torch.as_tensor(grid), torch.as_tensor(box_min),
                          box_bits, BRICK_BITS)
    assert bool(ib.all())
    assert len(np.unique(k.numpy())) == len(grid)
    # (F, 1, 3) boxes: frame f's keys pack against box f only
    shifts = np.asarray([[0, 0, 0], [16, 0, -8], [-4, 32, 4]], np.int64)
    boxes = box_min + shifts
    batch = np.stack([grid + s for s in shifts]).astype(np.int32)
    kb, ibb = pack_box_keys(torch.as_tensor(batch),
                            torch.as_tensor(boxes[:, None]), box_bits,
                            BRICK_BITS)
    assert bool(ibb.all())
    for f in range(len(shifts)):
        np.testing.assert_array_equal(kb[f].numpy(), k.numpy())
    _, out = pack_box_keys(torch.as_tensor(batch[::-1].copy()),
                           torch.as_tensor(boxes[:, None]), box_bits,
                           BRICK_BITS)
    assert not bool(out[0].all()) and not bool(out[2].all())


def test_dedup_frame_compact_grouped_random_property():
    """dedup_frame_compact_grouped: the naive dict's aggregates, records
    contiguous per group with the right group, in (group, key) order."""
    rng = np.random.default_rng(29)
    key_bits = sum(BOX_BITS) + 3 * BRICK_BITS
    for trial in range(8):
        keys, occ, valid = random_frames(rng, 1)
        keys, occ, valid = keys[0], occ[0], valid[0]
        G = int(rng.integers(2, 9))
        bkey, in_box = pack_box_keys(torch.as_tensor(keys),
                                     torch.as_tensor(BOX_MIN), BOX_BITS,
                                     BRICK_BITS)
        assert bool(in_box.all())
        group = torch.as_tensor(
            (bkey.numpy().astype(np.uint64) * 2654435761 % G).astype(np.int64))
        rec, rec_group = dedup_frame_compact_grouped(
            bkey, torch.as_tensor(occ), torch.as_tensor(valid), group, G,
            key_bits)
        expect = naive_dedup(keys, occ, valid)
        assert int(rec.n_unique) == len(expect), trial
        assert not bool(rec.pack_fail)
        v = rec.valid.numpy()
        rkey, rgroup = rec.key.numpy(), rec_group.numpy()
        assert (rgroup[~v] == G).all()
        assert (rgroup[v] == rkey[v].astype(np.uint64) * 2654435761 % G).all()
        order = list(zip(rgroup[v].tolist(), rkey[v].tolist()))
        assert order == sorted(set(order)), trial  # per-group contiguity
        pay = rec.payload.numpy()[v]
        got = dict(zip(map(tuple, box_voxels(rkey[v], BOX_MIN).tolist()),
                       zip((pay >> 16).tolist(), (pay & 0xFFFF).tolist())))
        assert got == expect, trial


@pytest.mark.parametrize("rows", [1, 3], ids=["one_row", "rows3"])
def test_dedup_frame_compact_pack_fail_detection(rows):
    """A voxel with 2^16+ candidates in one frame asserts pack_fail (its
    count cannot ride the 16-bit payload field); 2^16 - 1 candidates do
    not, and their count comes through exactly: the mod-2^16
    adjacent-difference boundary.  In a batch each row reports its own
    flag, and a voxel spread over rows counts per row."""
    n = 70000
    key = torch.full((rows, n), 5, dtype=torch.int64)
    occ = (torch.arange(n) % 3 == 0).expand(rows, n)

    def dedup(n_valid):
        valid = torch.stack([torch.arange(n) < c for c in n_valid])
        return dedup_frame_compact(key, occ, valid)

    fail, fine, edge = 0x10000 + 4464, 0xFFFF, 0x10000
    cases = {1: [[fail], [fine], [edge]],
             3: [[fail, fine, edge], [fine, 0, fine], [edge, fine, 1]]}[rows]
    for n_valid in cases:
        rec = dedup(n_valid)
        for r, c in enumerate(n_valid):
            assert bool(rec.pack_fail[r]) == (c > 0xFFFF), (n_valid, r)
            assert int(rec.n_unique[r]) == (c > 0), (n_valid, r)
            if 0 < c <= 0xFFFF:
                assert int(rec.payload[r, 0]) >> 16 == c
                assert int(rec.n_occ[r, 0]) == int(occ[r, :c].sum())


def test_dedup_frame_grouped_random_property():
    """dedup_frame_grouped: the naive dict's aggregates, records contiguous
    per group and key-sorted within, the right group on each."""
    rng = np.random.default_rng(23)
    for trial in range(8):
        keys, occ, valid = random_frames(rng, 1)
        keys, occ, valid = keys[0], occ[0], valid[0]
        G = int(rng.integers(2, 9))
        hi, lo, _ = pack_keys(torch.as_tensor(keys))
        # the group is a pure function of the key
        group = (hi * 2654435761 + lo) % G
        rec, rec_group = dedup_frame_grouped(
            hi, lo, torch.as_tensor(occ), torch.as_tensor(valid), group, G,
            False)
        expect = naive_dedup(keys, occ, valid)
        assert int(rec.n_unique) == len(expect), trial
        v = rec.valid.numpy()
        rgroup = rec_group.numpy()
        assert (rgroup[~v] == G).all()
        rhi, rlo = rec.hi.numpy()[v], rec.lo.numpy()[v]
        assert (rgroup[v] == (rhi * 2654435761 + rlo) % G).all()
        order = list(zip(rgroup[v].tolist(), rhi.tolist(), rlo.tolist()))
        assert order == sorted(set(order)), trial
        uk = unpack_keys(rec.hi[torch.as_tensor(v)],
                         rec.lo[torch.as_tensor(v)]).numpy()
        got = dict(zip(map(tuple, uk.tolist()),
                       zip(rec.count.numpy()[v].tolist(),
                           rec.n_occ.numpy()[v].tolist())))
        assert got == expect, trial


def test_batched_rows_never_share_a_record():
    """The same voxels in every row of a batch: each row counts its own
    candidates, in both dedups, bit-equal to the row alone."""
    rng = np.random.default_rng(31)
    keys1, occ1, valid1 = random_frames(rng, 1)
    rows = 5
    keys = np.repeat(keys1, rows, axis=0)
    occ = np.stack([np.roll(occ1[0], r) for r in range(rows)])
    valid = np.stack([valid1[0] & (np.arange(keys.shape[1]) % (r + 1) == 0)
                      for r in range(rows)])
    bkey, _ = pack_box_keys(torch.as_tensor(keys), torch.as_tensor(BOX_MIN),
                            BOX_BITS, BRICK_BITS)
    hi, lo, _ = pack_keys(torch.as_tensor(keys))
    batch_c = dedup_frame_compact(bkey, torch.as_tensor(occ),
                                  torch.as_tensor(valid))
    batch_w = dedup_frame(hi, lo, torch.as_tensor(occ), torch.as_tensor(valid),
                          False)
    for r in range(rows):
        alone_c = dedup_frame_compact(bkey[r], torch.as_tensor(occ[r]),
                                      torch.as_tensor(valid[r]))
        alone_w = dedup_frame(hi[r], lo[r], torch.as_tensor(occ[r]),
                              torch.as_tensor(valid[r]), False)
        for got, want in ((batch_c, alone_c), (batch_w, alone_w)):
            for a, b in zip(got, want):
                assert torch.equal(a[r], b), r
        assert compact_row(batch_c, r, BOX_MIN)[0] == naive_dedup(
            keys[r], occ[r], valid[r])
