"""K1 (kernels/bin_apply.py) vs the JAX package's Pallas binning kernel.

On the CPU the wrapper runs ``bin_apply_reference``, the plain PyTorch
version; it is fuzzed against ``pallas_bin_apply`` in interpret mode over
empty bricks, single-record bricks, saturated bricks, large counts and
ranges that cross the Pallas tile and chunk edges.  New rows agree within
EXP_ULP_TOL (XLA's exp vs libm, tests/torch_parity.py; bit-equal without
the adaptive update), touched masks exactly.  The CUDA kernel itself is
held against the plain version on the card (``-m cuda``, and
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


def random_window(seed, nb, n, max_count=40):
    """Records sorted by (brick, frame, offset), unique per slot."""
    rng = np.random.default_rng(seed)
    combos = np.sort(rng.choice(nb * B * VOL, size=n, replace=False))
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


@pytest.mark.parametrize("bad", ["key_dtype", "rows_dtype", "starts_len",
                                 "vol", "frames", "devices"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
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
        k1.bin_apply(**args, **kw)


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
