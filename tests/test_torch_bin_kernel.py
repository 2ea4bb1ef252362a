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
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.config import MapperConfig as JaxMapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu.pallas.bin_kernel import pallas_bin_apply  # noqa: E402

from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply as k1  # noqa: E402

from torch_parity import DTYPES, EXP_ULP_TOL, port_cfg  # noqa: E402

B, VOL, O, F_BITS = 8, 64, 6, 3


def random_window(seed, nb, n, max_count=40, dup=False):
    """Records sorted by (brick, frame, offset), unique per slot unless
    ``dup`` (raw candidates may repeat a slot)."""
    rng = np.random.default_rng(seed)
    combos = np.sort(rng.choice(nb * B * VOL, size=n, replace=dup))
    brick = combos // (B * VOL)
    frame = (combos // VOL) % B
    off = combos % VOL
    key = (brick << (O + F_BITS)) | (frame << O) | off
    cnt = rng.integers(1, max_count, size=n)
    occ = np.minimum(rng.integers(0, 50, size=n), cnt)
    starts = np.searchsorted(brick, np.arange(nb + 1))
    rows = rng.normal(scale=4.0, size=(nb, VOL))
    return key, (cnt << 16) | occ, starts, rows


CASES = [
    pytest.param(1, 16, 300, 40, id="random"),
    pytest.param(2, 5, 2000, 0xFFFF, id="dense-large-counts"),
    pytest.param(3, 32, 1, 40, id="one-record"),
    pytest.param(4, 16, 0, 40, id="empty-window"),
    pytest.param(5, 40, 5 * B * VOL, 40, id="saturated-bricks"),
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
    for seed, nb, n, max_count in [c.values for c in CASES]:
        key, pay, starts, rows = random_window(seed, nb, n, max_count)
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
    for seed, nb, n, max_count in [c.values for c in RAW_CASES]:
        key, pay, starts, rows = random_window(seed, nb, n, max_count, dup=True)
        args = [torch.as_tensor(a, device="cuda") for a in (key, pay, starts)]
        args.append(torch.as_tensor(rows, device="cuda").to(t_dtype))
        kw = dict(B=B, vol=VOL, f_bits=F_BITS, o=O, cfg=cfg)
        before = k1.raw_launches
        got = k1.bin_apply_raw(*args, **kw)
        torch.cuda.synchronize()
        assert k1.raw_launches == before + 1
        want = k1.bin_apply_raw_reference(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
