"""K1 (kernels/bin_apply.py) vs the JAX package's Pallas binning kernel.

On the CPU the wrappers run the plain PyTorch versions
(``bin_apply_reference`` for unique records, ``bin_apply_raw_reference``
for raw candidates); they are fuzzed against ``pallas_bin_apply`` (without
and with ``stats_out``) in interpret mode over empty bricks, single-record
bricks, saturated bricks, large counts, duplicate records and ranges that
cross the Pallas tile and chunk edges.  New rows agree within EXP_ULP_TOL
(XLA's exp vs libm, tests/torch_parity.py; bit-equal without the adaptive
update), touched masks and per-frame counts exactly.  The CUDA kernel
itself is held against the plain versions on the card (``-m cuda``, and
chip_smoke.py).

The rules the kernel's design rests on are held against the plain
versions bit for bit: a frame chain that steps only the frames that
received a record (per voxel, or the OR over groups of 32 voxels) is the
full chain; a record's brick within a tile of TB bricks is its position
against the tile's starts, and the plain versions called tile by tile
give the whole window's result; a raw stream summed by runs of equal
slots gives the raw form's result.  The tiles and run-summed streams are
also inputs of the ``cuda`` tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.config import MapperConfig as JaxMapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu.pallas.bin_kernel import pallas_bin_apply  # noqa: E402

from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply as k1  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.ops.logodds import (  # noqa: E402
    finalize_voxel_updates,
)

from torch_parity import DTYPES, EXP_ULP_TOL, port_cfg  # noqa: E402

B, VOL, O, F_BITS = 8, 64, 6, 3


def random_window(seed, nb, n, max_count=40, dup=False, hot=None):
    """Records sorted by (brick, frame, offset), unique per slot unless
    ``dup`` (raw candidates may repeat a slot); brick ``hot`` draws about
    half of them."""
    rng = np.random.default_rng(seed)
    if hot is None:
        combos = np.sort(rng.choice(nb * B * VOL, size=n, replace=dup))
    else:
        w = np.ones(nb)
        w[hot] = nb
        combos = (rng.choice(nb, size=n, p=w / w.sum()) * B * VOL
                  + rng.integers(0, B * VOL, size=n))
        combos = np.sort(combos if dup else np.unique(combos))
    brick = combos // (B * VOL)
    frame = (combos // VOL) % B
    off = combos % VOL
    key = (brick << (O + F_BITS)) | (frame << O) | off
    cnt = rng.integers(1, max_count, size=key.size)
    occ = np.minimum(rng.integers(0, 50, size=key.size), cnt)
    starts = np.searchsorted(brick, np.arange(nb + 1))
    rows = rng.normal(scale=4.0, size=(nb, VOL))
    return key, (cnt << 16) | occ, starts, rows


CASES = [
    pytest.param(1, 16, 300, 40, id="random"),
    pytest.param(2, 5, 2000, 0xFFFF, id="dense-large-counts"),
    pytest.param(3, 32, 1, 40, id="one-record"),
    pytest.param(4, 16, 0, 40, id="empty-window"),
    pytest.param(5, 40, 5 * B * VOL, 40, id="saturated-bricks"),
    # the kernel's tiles take TB = 2 bricks: a ragged last tile, NB < TB
    pytest.param(8, 7, 500, 40, id="odd-bricks"),
    pytest.param(9, 1, 200, 40, id="one-brick"),
]


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
@pytest.mark.parametrize("seed,nb,n,max_count", CASES)
@pytest.mark.parametrize("adaptive", [True, False])
def test_reference_matches_pallas(t_dtype, j_dtype, seed, nb, n, max_count,
                                  adaptive):
    key, pay, starts, rows = random_window(seed, nb, n, max_count)
    cfg = JaxMapperConfig(adaptive_update=adaptive)
    np_dt = np.dtype(j_dtype)
    want_v, want_upd = pallas_bin_apply(
        jnp.asarray(key.astype(np.uint32)), jnp.asarray(pay.astype(np.uint32)),
        jnp.asarray(starts.astype(np.int32)), jnp.asarray(rows.astype(np_dt)),
        B=B, vol=VOL, f_bits=F_BITS, o=O, cfg=cfg, TB=3, CHUNK=256,
        interpret=True,
    )
    got_v, got_upd = k1.bin_apply_reference(
        torch.as_tensor(key), torch.as_tensor(pay), torch.as_tensor(starts),
        torch.as_tensor(rows.astype(np_dt)), B=B, vol=VOL, f_bits=F_BITS, o=O,
        cfg=port_cfg(cfg),
    )
    np.testing.assert_array_equal(got_upd.numpy(), np.asarray(want_upd))
    voxels = np.unique((key >> (O + F_BITS)) * VOL + (key & (VOL - 1)))
    assert int(got_upd.sum()) == voxels.size
    tol = EXP_ULP_TOL[t_dtype] if adaptive else 0.0
    np.testing.assert_allclose(
        got_v.numpy(), np.asarray(want_v), rtol=0, atol=tol
    )


def test_wrapper_on_cpu_runs_the_plain_version():
    """CPU tensors take the plain version; no kernel launch is counted."""
    key, pay, starts, rows = random_window(6, 12, 500)
    args = [torch.as_tensor(a) for a in (key, pay, starts, rows)]
    kw = dict(B=B, vol=VOL, f_bits=F_BITS, o=O, cfg=port_cfg(JaxMapperConfig()))
    before = k1.launches
    v, upd = k1.bin_apply(*args, **kw)
    v_ref, upd_ref = k1.bin_apply_reference(*args, **kw)
    assert k1.launches == before
    assert torch.equal(v, v_ref) and torch.equal(upd, upd_ref)


RAW_CASES = [
    pytest.param(11, 12, 800, 40, id="duplicates"),
    pytest.param(12, 3, 6000, 40, id="hot-bricks"),
    pytest.param(13, 4, 3000, 0xFFFF, id="duplicates-large-counts"),
    pytest.param(14, 32, 1, 40, id="one-record"),
    pytest.param(15, 16, 0, 40, id="empty-window"),
    pytest.param(18, 7, 2000, 40, id="odd-bricks"),
    pytest.param(19, 1, 900, 40, id="one-brick"),
]


def _jax_raw(key, pay, starts, rows, cfg, j_dtype):
    out = pallas_bin_apply(
        jnp.asarray(key.astype(np.uint32)), jnp.asarray(pay.astype(np.uint32)),
        jnp.asarray(starts.astype(np.int32)),
        jnp.asarray(rows.astype(np.dtype(j_dtype))),
        B=B, vol=VOL, f_bits=F_BITS, o=O, cfg=cfg, TB=3, CHUNK=256,
        interpret=True, stats_out=True,
    )
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
@pytest.mark.parametrize("seed,nb,n,max_count", RAW_CASES)
@pytest.mark.parametrize("adaptive", [True, False])
def test_raw_reference_matches_pallas_stats_out(t_dtype, j_dtype, seed, nb, n,
                                                max_count, adaptive):
    """Raw candidates summed per slot: rows, touched mask and both
    per-frame unique counts as the Pallas kernel's stats_out form."""
    key, pay, starts, rows = random_window(seed, nb, n, max_count, dup=True)
    cfg = JaxMapperConfig(adaptive_update=adaptive)
    want_v, want_upd, want_occ, want_free = _jax_raw(
        key, pay, starts, rows, cfg, j_dtype
    )
    got_v, got_upd, got_occ, got_free = k1.bin_apply_raw_reference(
        torch.as_tensor(key), torch.as_tensor(pay), torch.as_tensor(starts),
        torch.as_tensor(rows.astype(np.dtype(j_dtype))), B=B, vol=VOL,
        f_bits=F_BITS, o=O, cfg=port_cfg(cfg),
    )
    np.testing.assert_array_equal(got_upd.numpy(), want_upd)
    np.testing.assert_array_equal(got_occ.numpy(), want_occ)
    np.testing.assert_array_equal(got_free.numpy(), want_free)
    # every distinct slot is one unique voxel of its frame, by type
    assert int(got_occ.sum() + got_free.sum()) == np.unique(key).size
    tol = EXP_ULP_TOL[t_dtype] if adaptive else 0.0
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=0, atol=tol)


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
@pytest.mark.parametrize("raw", [False, True], ids=["unique", "raw"])
def test_reference_matches_pallas_with_a_hot_brick(t_dtype, j_dtype, raw):
    """A brick with about half of the window's records, inside a tile of
    light ones, in both forms."""
    # unique records fill at most B * VOL = 512 slots of the hot brick
    key, pay, starts, rows = random_window(20, 11, 3000 if raw else 1200,
                                           dup=raw, hot=5)
    cfg = JaxMapperConfig()
    if raw:
        want = _jax_raw(key, pay, starts, rows, cfg, j_dtype)
        got = k1.bin_apply_raw_reference(
            torch.as_tensor(key), torch.as_tensor(pay), torch.as_tensor(starts),
            torch.as_tensor(rows.astype(np.dtype(j_dtype))), B=B, vol=VOL,
            f_bits=F_BITS, o=O, cfg=port_cfg(cfg),
        )
    else:
        want = pallas_bin_apply(
            jnp.asarray(key.astype(np.uint32)),
            jnp.asarray(pay.astype(np.uint32)),
            jnp.asarray(starts.astype(np.int32)),
            jnp.asarray(rows.astype(np.dtype(j_dtype))),
            B=B, vol=VOL, f_bits=F_BITS, o=O, cfg=cfg, TB=3, CHUNK=256,
            interpret=True,
        )
        got = k1.bin_apply_reference(
            torch.as_tensor(key), torch.as_tensor(pay), torch.as_tensor(starts),
            torch.as_tensor(rows.astype(np.dtype(j_dtype))), B=B, vol=VOL,
            f_bits=F_BITS, o=O, cfg=port_cfg(cfg),
        )
    per_brick = np.diff(starts)
    assert per_brick[5] > 4 * np.median(per_brick)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=EXP_ULP_TOL[t_dtype])


@pytest.mark.parametrize("t_dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_raw_reference_sums_like_dedup(t_dtype):
    """Splitting every unique record into candidates of count 1 gives the
    unique-record result bit for bit, and the per-frame counts are the
    unique records by type."""
    key, pay, starts, rows = random_window(16, 10, 900, max_count=6)
    cnt, occ = pay >> 16, pay & 0xFFFF
    raw_key = np.repeat(key, cnt)
    # each record's first n_occ candidates are occupied
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    raw_occ = (np.arange(raw_key.size) - first) < np.repeat(occ, cnt)
    raw_pay = (1 << 16) | raw_occ.astype(np.int64)
    brick = raw_key >> (O + F_BITS)
    raw_starts = np.searchsorted(brick, np.arange(10 + 1))
    kw = dict(B=B, vol=VOL, f_bits=F_BITS, o=O, cfg=port_cfg(JaxMapperConfig()))
    r = torch.as_tensor(rows).to(t_dtype)
    v, upd = k1.bin_apply_reference(
        *(torch.as_tensor(a) for a in (key, pay, starts)), r, **kw
    )
    rv, rupd, occ_u, free_u = k1.bin_apply_raw_reference(
        *(torch.as_tensor(a) for a in (raw_key, raw_pay, raw_starts)), r, **kw
    )
    assert torch.equal(v, rv) and torch.equal(upd, rupd)
    frame = (key >> O) & (B - 1)
    np.testing.assert_array_equal(
        occ_u.numpy(), np.bincount(frame[occ > 0], minlength=B)
    )
    np.testing.assert_array_equal(
        free_u.numpy(), np.bincount(frame[occ == 0], minlength=B)
    )


def test_raw_wrapper_on_cpu_runs_the_plain_version():
    key, pay, starts, rows = random_window(17, 12, 1500, dup=True)
    args = [torch.as_tensor(a) for a in (key, pay, starts, rows)]
    kw = dict(B=B, vol=VOL, f_bits=F_BITS, o=O, cfg=port_cfg(JaxMapperConfig()))
    before = k1.raw_launches, k1.launches
    got = k1.bin_apply_raw(*args, **kw)
    want = k1.bin_apply_raw_reference(*args, **kw)
    assert (k1.raw_launches, k1.launches) == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _tables(key, pay, starts, nb):
    """(count, n_occ) int64 tables (NB, B, VOL) summed per slot, and the
    slots that received a record, whatever its payload."""
    didx, dump = k1._dense_index(torch.as_tensor(key), torch.as_tensor(starts),
                                 nb, B, VOL, F_BITS, O)
    pay = torch.as_tensor(pay)

    def summed(x):
        out = torch.zeros(dump + 1, dtype=torch.int64)
        return out.index_add_(0, didx, x)[:dump].reshape(nb, B, VOL)

    received = summed(torch.ones_like(pay)) > 0
    return summed(pay >> 16), summed(pay & 0xFFFF), received


def _skipping_chain(cnt, occ, steps, rows, cfg):
    """The frame chain of ``_frame_chain``, but a voxel steps frame f only
    where ``steps`` (NB, B, VOL) says so; elsewhere it keeps its value and
    adds nothing to the touched mask or the counts."""
    nb, n_frames, vol = cnt.shape
    dtype = rows.dtype
    occ_l = torch.full((), cfg.log_odds_occupied, dtype=dtype)
    free_l = torch.full((), cfg.log_odds_free, dtype=dtype)
    v = rows
    upd = torch.zeros((nb, vol), dtype=torch.bool)
    occ_u = torch.zeros(n_frames, dtype=torch.int64)
    free_u = torch.zeros(n_frames, dtype=torch.int64)
    for f in range(n_frames):
        s = steps[:, f, :]
        c = cnt[:, f, :].to(dtype)
        q = occ[:, f, :].to(dtype)
        hit = (cnt[:, f, :] != 0) & s
        is_occ = (occ[:, f, :] != 0) & s
        upd = upd | hit
        occ_u[f] = is_occ.sum()
        free_u[f] = (hit & ~is_occ).sum()
        stepped = finalize_voxel_updates(v, q * occ_l + (c - q) * free_l, c,
                                         q > 0, cfg)
        v = torch.where(s, stepped, v)
    return v, upd, occ_u, free_u


@pytest.mark.parametrize("t_dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("group", [1, 32], ids=["per-voxel", "per-warp"])
def test_chain_over_received_frames_is_the_full_chain(t_dtype, adaptive,
                                                      group):
    """Stepping each voxel only through the frames that received a record,
    per voxel or as the OR over groups of 32 voxels, gives the full chain's
    rows, touched mask and per-frame counts bit for bit, with raw records
    of count 0 and n_occ > 0 among them."""
    nb = 24
    key, pay, starts, rows = random_window(21, nb, 600, max_count=6,
                                           dup=True)
    rng = np.random.default_rng(21)
    zero_count = rng.random(key.size) < 0.1
    pay = np.where(zero_count, rng.integers(1, 4, key.size), pay)
    cfg = port_cfg(JaxMapperConfig(adaptive_update=adaptive))
    cnt, occ, received = _tables(key, pay, starts, nb)
    assert ((cnt == 0) & (occ > 0)).any()
    steps = (received.permute(0, 2, 1).reshape(-1, group, B).any(dim=1)
             .repeat_interleave(group, dim=0).reshape(nb, VOL, B)
             .permute(0, 2, 1))
    r = torch.as_tensor(rows).to(t_dtype)
    want = k1._frame_chain(cnt, occ, r, cfg)
    got = _skipping_chain(cnt, occ, steps, r, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert float(steps.float().mean()) < 1.0
    # a mask of the slots with a count alone misses the n_occ > 0 slots of
    # count 0 in the occupied counts: the mask must come from the records
    by_count = _skipping_chain(cnt, occ, cnt != 0, r, cfg)
    assert not torch.equal(by_count[2], want[2])


TILE_CASES = [
    pytest.param([0, 5, 5, 9, 9, 9, 14, 20], id="empty-bricks"),
    pytest.param([0, 3, 7, 7, 12, 12, 30, 31, 40], id="ragged-last-tile"),
    pytest.param([0, 11], id="one-brick"),
    pytest.param([3, 8, 8, 15, 21], id="range-not-at-zero"),
]


def window_with_starts(seed, starts, extra=3):
    """Unique records whose bricks own the lane ranges ``starts`` gives,
    plus ``extra`` lanes past the last range (and any before the first)
    that belong to no brick.  Keys carry box ids, not ranks."""
    rng = np.random.default_rng(seed)
    starts = np.asarray(starts)
    nb = starts.size - 1
    n_lanes = starts[-1] + extra
    brick_of = np.searchsorted(starts, np.arange(n_lanes), side="right") - 1
    slot = np.zeros(n_lanes, dtype=np.int64)
    for i in range(nb):
        r0, r1 = starts[i], starts[i + 1]
        slot[r0:r1] = np.sort(rng.choice(B * VOL, size=r1 - r0, replace=False))
    box = 100 + 7 * np.clip(brick_of, 0, nb)
    key = (box << (O + F_BITS)) | slot
    cnt = rng.integers(1, 40, size=n_lanes)
    occ = np.minimum(rng.integers(0, 50, size=n_lanes), cnt)
    rows = rng.normal(scale=4.0, size=(nb, VOL))
    return key, (cnt << 16) | occ, starts, rows


def split_into_tiles(starts, tb):
    """(first brick, starts of the tile) for each tile of ``tb`` bricks."""
    nb = starts.numel() - 1
    return [(j * tb, starts[j * tb:min((j + 1) * tb, nb) + 1])
            for j in range(-(-nb // tb))]


@pytest.mark.parametrize("starts", TILE_CASES)
@pytest.mark.parametrize("tb", [1, 2, 3, 4, 8])
def test_tile_rank_of_a_record_is_its_brick(starts, tb):
    """The kernel's split of a window into tiles of TB bricks.  A tile
    reads the pairs (2p, 2p+1) that hold its range [starts[j*TB],
    starts[min((j+1)*TB, NB)]); a record's brick is the tile's first brick
    plus the number of the tile's later starts it has reached.  Each lane
    the plain version bins lands in one tile, in the brick the plain
    version gives it; and both plain versions, called on one tile's starts
    and rows over the whole record arrays (a range past lane 0, lanes past
    its end), give that tile's part of the whole window's result."""
    key, pay, starts_np, rows = window_with_starts(23, starts)
    s_flat, s_pay, starts = (torch.as_tensor(a) for a in (key, pay, starts_np))
    nb = starts.numel() - 1
    didx, dump = k1._dense_index(s_flat, starts, nb, B, VOL, F_BITS, O)
    kept = torch.nonzero(didx != dump).flatten()
    seen = []
    for first, st in split_into_tiles(starts, tb):
        nt = st.numel() - 1
        r0, r1 = int(st[0]), int(st[nt])
        lanes = torch.arange(2 * (r0 // 2), 2 * ((r1 + 1) // 2))
        lanes = lanes[(lanes >= r0) & (lanes < r1)]
        rank = (lanes[:, None] >= st[1:nt][None, :]).sum(dim=1)
        seen.append(torch.stack([lanes, first + rank], dim=1))
    seen = torch.cat(seen)
    assert torch.equal(seen[:, 0], kept)
    assert torch.equal(seen[:, 1], didx[kept] // (B * VOL))

    kw = dict(B=B, vol=VOL, f_bits=F_BITS, o=O, cfg=port_cfg(JaxMapperConfig()))
    r = torch.as_tensor(rows)
    whole = k1.bin_apply_reference(s_flat, s_pay, starts, r, **kw)
    whole_raw = k1.bin_apply_raw_reference(s_flat, s_pay, starts, r, **kw)
    counts = torch.zeros((2, B), dtype=torch.int64)
    for first, st in split_into_tiles(starts, tb):
        part = slice(first, first + st.numel() - 1)
        got = k1.bin_apply_reference(s_flat, s_pay, st, r[part], **kw)
        assert all(torch.equal(a, b[part]) for a, b in zip(got, whole))
        got = k1.bin_apply_raw_reference(s_flat, s_pay, st, r[part], **kw)
        assert all(torch.equal(a, b[part]) for a, b in zip(got[:2], whole_raw))
        counts += torch.stack(got[2:])
    assert torch.equal(counts, torch.stack(whole_raw[2:]))


def sum_runs(key, pay, starts, run_width):
    """The raw records with each run of equal keys within aligned groups
    of ``run_width`` adjacent lanes (a thread's records in the kernel)
    replaced by one record holding the run's count and n_occ sums, and the
    starts of the shorter stream."""
    key, pay, starts = (torch.as_tensor(a) for a in (key, pay, starts))
    lane = torch.arange(key.numel())
    head = torch.ones_like(key, dtype=torch.bool)
    head[1:] = (key[1:] != key[:-1]) | (lane[1:] % run_width == 0)
    run = torch.cumsum(head, 0) - 1
    n_runs = int(run[-1]) + 1 if key.numel() else 0

    def summed(x):
        return torch.zeros(n_runs, dtype=torch.int64).index_add_(0, run, x)

    cnt, occ = summed(pay >> 16), summed(pay & 0xFFFF)
    assert int(occ.max()) <= 0xFFFF
    return (key[head].numpy(), ((cnt << 16) | occ).numpy(),
            torch.searchsorted(lane[head], starts).numpy())


@pytest.mark.parametrize("run_width", [2, 32, 64],
                         ids=["pairs", "warp", "two-warps"])
def test_raw_sums_by_runs_are_index_add(run_width):
    """Summing count and n_occ over runs of equal slots within aligned
    groups of ``run_width`` adjacent records, one record per run, leaves
    the raw form's result as it was: the plain version sums the shorter
    stream with ``index_add_`` to the same rows, touched mask and
    per-frame counts, bit for bit, in float32 and float64."""
    key, pay, starts, rows = random_window(22, 6, 8000, dup=True)
    s_key, s_pay, s_starts = sum_runs(key, pay, starts, run_width)
    assert s_key.size < key.size and np.unique(s_key).size < s_key.size
    kw = dict(B=B, vol=VOL, f_bits=F_BITS, o=O, cfg=port_cfg(JaxMapperConfig()))
    for dtype in (torch.float32, torch.float64):
        r = torch.as_tensor(rows).to(dtype)
        want = k1.bin_apply_raw_reference(
            *(torch.as_tensor(a) for a in (key, pay, starts)), r, **kw)
        got = k1.bin_apply_raw_reference(
            *(torch.as_tensor(a) for a in (s_key, s_pay, s_starts)), r, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


BAD_INPUTS = ["key_dtype", "rows_dtype", "starts_len", "vol", "frames",
              "devices"]


def _call_with_bad_input(wrapper, bad):
    key, pay, starts, rows = random_window(7, 4, 100)
    args = dict(s_flat=torch.as_tensor(key), s_pay=torch.as_tensor(pay),
                starts=torch.as_tensor(starts), rows_cur=torch.as_tensor(rows))
    kw = dict(B=B, vol=VOL, f_bits=F_BITS, o=O, cfg=port_cfg(JaxMapperConfig()))
    if bad == "key_dtype":
        args["s_flat"] = args["s_flat"].to(torch.int32)
    elif bad == "rows_dtype":
        args["rows_cur"] = args["rows_cur"].to(torch.float16)
    elif bad == "starts_len":
        args["starts"] = args["starts"][:-1]
    elif bad == "vol":
        kw["o"] = 5
    elif bad == "frames":
        kw["B"] = 9
    else:
        args["starts"] = args["starts"].to("meta")
    with pytest.raises((TypeError, ValueError)):
        wrapper(**args, **kw)


@pytest.mark.parametrize("bad", BAD_INPUTS)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _call_with_bad_input(k1.bin_apply, bad)


@pytest.mark.parametrize("bad", BAD_INPUTS)
def test_raw_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _call_with_bad_input(k1.bin_apply_raw, bad)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent fallback."""
    import torch.utils.cpp_extension as cpp_extension

    from sonar_3d_reconstruction_tpu_torch.kernels import build

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k1.build()
    assert not (tmp_path / "kernels").exists()


@pytest.mark.cuda
@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_cuda_kernel_matches_plain_version(t_dtype, j_dtype):
    """The CUDA kernel is bit-equal to the plain version on the card and
    counts its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = port_cfg(JaxMapperConfig())
    windows = [random_window(*c.values) for c in CASES]
    windows.append(random_window(20, 11, 1200, hot=5))
    # each tile of a window as the kernel's only input: ranges past lane 0
    # with lanes past their end, ragged and empty bricks
    for c in TILE_CASES:
        key, pay, starts, rows = window_with_starts(23, c.values[0])
        for first, st in split_into_tiles(torch.as_tensor(starts), 3):
            windows.append((key, pay, st.numpy(),
                            rows[first:first + st.numel() - 1]))
    for key, pay, starts, rows in windows:
        args = [torch.as_tensor(a, device="cuda") for a in (key, pay, starts)]
        args.append(torch.as_tensor(rows, device="cuda").to(t_dtype))
        kw = dict(B=B, vol=VOL, f_bits=F_BITS, o=O, cfg=cfg)
        before = k1.launches
        v, upd = k1.bin_apply(*args, **kw)
        torch.cuda.synchronize()
        assert k1.launches == before + 1
        v_ref, upd_ref = k1.bin_apply_reference(*args, **kw)
        assert torch.equal(v, v_ref) and torch.equal(upd, upd_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_cuda_raw_kernel_matches_plain_version(t_dtype, j_dtype):
    """The raw-candidate kernel is bit-equal to its plain version on the
    card, per-frame counts included, and counts its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = port_cfg(JaxMapperConfig())
    windows = [random_window(*c.values, dup=True) for c in RAW_CASES]
    windows.append(random_window(20, 11, 3000, dup=True, hot=5))
    # long runs of one slot, and the same records summed by runs (fewer,
    # larger records that still repeat slots)
    key, pay, starts, rows = random_window(22, 6, 8000, dup=True)
    windows.append((key, pay, starts, rows))
    for run_width in (2, 64):
        windows.append(sum_runs(key, pay, starts, run_width) + (rows,))
    for c in TILE_CASES:
        key, pay, starts, rows = window_with_starts(23, c.values[0])
        for first, st in split_into_tiles(torch.as_tensor(starts), 3):
            windows.append((key, pay, st.numpy(),
                            rows[first:first + st.numel() - 1]))
    for key, pay, starts, rows in windows:
        args = [torch.as_tensor(a, device="cuda") for a in (key, pay, starts)]
        args.append(torch.as_tensor(rows, device="cuda").to(t_dtype))
        kw = dict(B=B, vol=VOL, f_bits=F_BITS, o=O, cfg=cfg)
        before = k1.raw_launches
        got = k1.bin_apply_raw(*args, **kw)
        torch.cuda.synchronize()
        assert k1.raw_launches == before + 1
        want = k1.bin_apply_raw_reference(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
