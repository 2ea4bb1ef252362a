"""K1: fused record binning + per-frame chain evaluation of one window.

``bin_apply`` replaces ``sonar_3d_reconstruction_tpu.pallas.bin_kernel.
pallas_bin_apply`` (non-stats form).  On CUDA tensors it launches the
hand-written kernel ``csrc/bin_apply.cu`` (built at first use, bound with
ctypes) and raises if that cannot be done; on CPU tensors it runs
``bin_apply_reference``, the plain PyTorch version the kernel is held
against.  ``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.kernels.build import build_shared_library
from sonar_3d_reconstruction_tpu_torch.ops.logodds import finalize_voxel_updates

SOURCE = "bin_apply.cu"

# kernel launches since import (or since a caller reset it)
launches = 0

_SMEM_LIMIT = 48 * 1024  # static shared-memory limit without opt-in
_MAX_THREADS = 1024


def _check(s_flat, s_pay, starts, rows_cur, B, vol, f_bits, o) -> None:
    if s_flat.dtype != torch.int64 or s_pay.dtype != torch.int64:
        raise TypeError("s_flat and s_pay must be int64 (u32 values)")
    if starts.dtype != torch.int64:
        raise TypeError("starts must be int64")
    if rows_cur.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rows_cur must be float32 or float64, not {rows_cur.dtype}")
    if s_flat.dim() != 1 or s_pay.shape != s_flat.shape:
        raise ValueError("s_flat and s_pay must be 1-D of equal length")
    nb = rows_cur.shape[0]
    if rows_cur.dim() != 2 or rows_cur.shape[1] != vol:
        raise ValueError(f"rows_cur must be (NB, {vol}), got {tuple(rows_cur.shape)}")
    if starts.shape != (nb + 1,):
        raise ValueError(f"starts must be ({nb + 1},), got {tuple(starts.shape)}")
    if vol != 1 << o:
        raise ValueError(f"vol {vol} != 2**o with o={o}")
    if not 1 <= B <= 1 << f_bits:
        raise ValueError(f"B={B} frames do not fit f_bits={f_bits}")


def bin_apply_reference(
    s_flat: torch.Tensor,
    s_pay: torch.Tensor,
    starts: torch.Tensor,
    rows_cur: torch.Tensor,
    *,
    B: int,
    vol: int,
    f_bits: int,
    o: int,
    cfg: MapperConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same inputs and outputs.

    Brick of each record lane by ``searchsorted(starts)``, one scatter into
    a (NB, B, vol) payload buffer, then B masked passes of
    ``finalize_voxel_updates`` (the JAX package's bfv chain evaluation).
    Returns (new rows (NB, vol), touched-this-window (NB, vol) bool).
    """
    _check(s_flat, s_pay, starts, rows_cur, B, vol, f_bits, o)
    nb = rows_cur.shape[0]
    dtype, device = rows_cur.dtype, rows_cur.device
    lane = torch.arange(s_flat.shape[0], device=device)
    brick = torch.searchsorted(starts, lane, right=True) - 1
    frame = (s_flat >> o) & ((1 << f_bits) - 1)
    off = s_flat & ((1 << o) - 1)
    # lanes outside [starts[0], starts[NB]) belong to no brick; like the
    # kernel, a frame field >= B is dropped
    keep = (lane >= starts[0]) & (lane < starts[nb]) & (frame < B)
    dump = nb * B * vol
    didx = torch.where(keep, brick * (B * vol) + frame * vol + off, dump)
    dense = torch.zeros(dump + 1, dtype=torch.int64, device=device)
    dense[didx] = s_pay
    dense = dense[:dump].reshape(nb, B, vol)

    occ_l = torch.full((), cfg.log_odds_occupied, dtype=dtype, device=device)
    free_l = torch.full((), cfg.log_odds_free, dtype=dtype, device=device)
    v = rows_cur
    upd = torch.zeros((nb, vol), dtype=torch.bool, device=device)
    for f in range(B):
        d = dense[:, f, :]
        cnt = (d >> 16).to(dtype)
        occ = (d & 0xFFFF).to(dtype)
        lo_sum = occ * occ_l + (cnt - occ) * free_l
        upd = upd | (d != 0)
        v = finalize_voxel_updates(v, lo_sum, cnt, occ > 0, cfg)
    return v, upd


@functools.cache
def _library() -> Tuple[ctypes.CDLL, str]:
    path, log = build_shared_library(SOURCE)
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, real in (("bin_apply_f32", ctypes.c_float),
                       ("bin_apply_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = (
            [ptr] * 6 + [i32] * 5 + [real, real, i32, real, real, real, real]
            + [ptr]
        )
        fn.restype = i32
    return lib, log


def build() -> str:
    """Build (or find) the kernel library; returns the compiler output."""
    return _library()[1]


def bin_apply(
    s_flat: torch.Tensor,
    s_pay: torch.Tensor,
    starts: torch.Tensor,
    rows_cur: torch.Tensor,
    *,
    B: int,
    vol: int,
    f_bits: int,
    o: int,
    cfg: MapperConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bin one window's sorted records and run the frame chain per brick.

    ``s_flat`` (L,) (brick, frame, offset)-sorted flat keys and ``s_pay``
    (L,) payloads ``count << 16 | n_occ`` (u32 values in int64), records
    unique per (brick, frame, offset); ``starts`` (NB+1,) int64 record-range
    starts of the compacted bricks; ``rows_cur`` (NB, vol) their current
    value rows.  Returns (new rows, touched-this-window mask).
    """
    global launches
    tensors = (s_flat, s_pay, starts, rows_cur)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return bin_apply_reference(
            s_flat, s_pay, starts, rows_cur, B=B, vol=vol, f_bits=f_bits, o=o,
            cfg=cfg,
        )
    if device.type != "cuda":
        raise ValueError(f"bin_apply runs on CPU or CUDA tensors, not {device}")
    _check(s_flat, s_pay, starts, rows_cur, B, vol, f_bits, o)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bin_apply needs contiguous inputs")
    if vol > _MAX_THREADS or B * vol * 4 > _SMEM_LIMIT:
        raise ValueError(f"B={B}, vol={vol} exceed the kernel's block limits")

    nb = rows_cur.shape[0]
    v_out = torch.empty_like(rows_cur)
    upd = torch.empty(rows_cur.shape, dtype=torch.bool, device=device)
    if nb == 0:
        return v_out, upd
    lib, _ = _library()
    fn = lib.bin_apply_f32 if rows_cur.dtype == torch.float32 else lib.bin_apply_f64
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            s_flat.data_ptr(), s_pay.data_ptr(), starts.data_ptr(),
            rows_cur.data_ptr(), v_out.data_ptr(), upd.data_ptr(),
            nb, B, vol, f_bits, o,
            cfg.log_odds_occupied, cfg.log_odds_free, int(cfg.adaptive_update),
            cfg.adaptive_threshold, cfg.adaptive_max_ratio,
            cfg.log_odds_min, cfg.log_odds_max, stream,
        )
    if err != 0:
        raise RuntimeError(f"bin_apply kernel launch failed: CUDA error {err}")
    launches += 1
    return v_out, upd
