"""K1: fused record binning + per-frame chain evaluation of one window.

``bin_apply`` replaces ``sonar_3d_reconstruction_tpu.pallas.bin_kernel.
pallas_bin_apply`` for unique records (non-stats form); ``bin_apply_raw``
replaces its ``stats_out=True`` form, which takes raw candidates, sums
them per (brick, frame, offset) slot and also returns per-frame unique
voxel counts.  On CUDA tensors each wrapper launches its form of the
hand-written kernel ``csrc/bin_apply.cu`` (built at first use, bound with
ctypes) and raises if that cannot be done; on CPU tensors it runs its
plain PyTorch version (``bin_apply_reference`` /
``bin_apply_raw_reference``), which the kernel is held against.
``launches`` and ``raw_launches`` count kernel launches of each form and
nothing else.  The kernel gives each block a tile of consecutive bricks
(``tile_bricks``); its design and measured bounds are in the source.
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

# kernel launches since import (or since a caller reset them)
launches = 0
raw_launches = 0

# threads a block aims at: a tile is TILE_THREADS // vol consecutive bricks
TILE_THREADS = 128
_MAX_THREADS = 512         # the kernel's __launch_bounds__
_SMEM_DEFAULT = 48 * 1024  # dynamic shared memory without opt-in
_SMEM_LIMIT = 227 * 1024   # Hopper's per-block opt-in maximum


def _smem_bytes(raw: bool, tb: int, B: int, vol: int) -> int:
    """Shared memory of one block of ``tb`` bricks, as the kernel lays it
    out (csrc/bin_apply.cu, ``smem_bytes``): the tile's starts, the frame
    masks and the tables."""
    table = tb * B * vol
    words = -(-B // 32) * tb * vol + (2 * table + 2 * B if raw else table)
    return ((tb + 1) * 8 + 15) // 16 * 16 + 4 * words


def tile_bricks(raw: bool, B: int, vol: int) -> int:
    """Bricks per block: ``TILE_THREADS // vol``, halved while the tile's
    tables need more than the default 48 KB of shared memory."""
    tb = max(1, min(TILE_THREADS, _MAX_THREADS) // vol)
    while tb > 1 and _smem_bytes(raw, tb, B, vol) > _SMEM_DEFAULT:
        tb //= 2
    return tb


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


def _dense_index(s_flat, starts, nb, B, vol, f_bits, o):
    """Flat (brick, frame, offset) slot of every record lane in a
    (NB*B*vol + 1,) buffer whose last entry is a dump for lanes outside
    [starts[0], starts[NB]) and, like the kernel, frame fields >= B."""
    lane = torch.arange(s_flat.shape[0], device=s_flat.device)
    brick = torch.searchsorted(starts, lane, right=True) - 1
    frame = (s_flat >> o) & ((1 << f_bits) - 1)
    off = s_flat & ((1 << o) - 1)
    keep = (lane >= starts[0]) & (lane < starts[nb]) & (frame < B)
    dump = nb * B * vol
    return torch.where(keep, brick * (B * vol) + frame * vol + off, dump), dump


def _frame_chain(cnt, occ, rows_cur, cfg):
    """B masked passes of ``finalize_voxel_updates`` (the JAX package's bfv
    chain evaluation) over (NB, B, vol) int64 count and n_occ tables.
    Returns (new rows, touched-this-window mask, per-frame unique occupied
    (B,), per-frame unique free (B,))."""
    nb, B, vol = cnt.shape
    dtype, device = rows_cur.dtype, rows_cur.device
    occ_l = torch.full((), cfg.log_odds_occupied, dtype=dtype, device=device)
    free_l = torch.full((), cfg.log_odds_free, dtype=dtype, device=device)
    v = rows_cur
    upd = torch.zeros((nb, vol), dtype=torch.bool, device=device)
    occ_u = torch.zeros(B, dtype=torch.int64, device=device)
    free_u = torch.zeros(B, dtype=torch.int64, device=device)
    for f in range(B):
        c = cnt[:, f, :].to(dtype)
        q = occ[:, f, :].to(dtype)
        lo_sum = q * occ_l + (c - q) * free_l
        hit = cnt[:, f, :] != 0
        is_occ = occ[:, f, :] != 0
        upd = upd | hit
        occ_u[f] = is_occ.sum()
        free_u[f] = (hit & ~is_occ).sum()
        v = finalize_voxel_updates(v, lo_sum, c, q > 0, cfg)
    return v, upd, occ_u, free_u


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
    """Plain PyTorch version of the unique-record kernel: the same inputs
    and outputs.

    Brick of each record lane by ``searchsorted(starts)``, one scatter into
    a (NB, B, vol) payload buffer, then the frame chain.  Returns (new rows
    (NB, vol), touched-this-window (NB, vol) bool).
    """
    _check(s_flat, s_pay, starts, rows_cur, B, vol, f_bits, o)
    nb = rows_cur.shape[0]
    didx, dump = _dense_index(s_flat, starts, nb, B, vol, f_bits, o)
    dense = torch.zeros(dump + 1, dtype=torch.int64, device=rows_cur.device)
    dense[didx] = s_pay
    dense = dense[:dump].reshape(nb, B, vol)
    v, upd, _, _ = _frame_chain(dense >> 16, dense & 0xFFFF, rows_cur, cfg)
    return v, upd


def bin_apply_raw_reference(
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the raw-candidate kernel.

    Records may repeat a (brick, frame, offset) slot: count and n_occ are
    summed per slot with ``index_add_`` into two separate int64 tables
    (never the packed payload, whose n_occ sum would carry into the count
    field), then the frame chain runs.  Returns (new rows (NB, vol),
    touched-this-window (NB, vol) bool, per-frame unique occupied voxels
    (B,) int64, per-frame unique free voxels (B,) int64).
    """
    _check(s_flat, s_pay, starts, rows_cur, B, vol, f_bits, o)
    nb = rows_cur.shape[0]
    didx, dump = _dense_index(s_flat, starts, nb, B, vol, f_bits, o)

    def summed(x):
        out = torch.zeros(dump + 1, dtype=torch.int64, device=rows_cur.device)
        return out.index_add_(0, didx, x)[:dump].reshape(nb, B, vol)

    return _frame_chain(summed(s_pay >> 16), summed(s_pay & 0xFFFF), rows_cur, cfg)


@functools.cache
def _library() -> Tuple[ctypes.CDLL, str]:
    path, log = build_shared_library(SOURCE)
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, real, n_ptr in (("bin_apply_f32", ctypes.c_float, 6),
                              ("bin_apply_f64", ctypes.c_double, 6),
                              ("bin_apply_raw_f32", ctypes.c_float, 8),
                              ("bin_apply_raw_f64", ctypes.c_double, 8)):
        fn = getattr(lib, name)
        fn.argtypes = (
            [ptr] * n_ptr + [ctypes.c_longlong] + [i32] * 6
            + [real, real, i32, real, real, real, real] + [ptr]
        )
        fn.restype = i32
    return lib, log


def build() -> str:
    """Build (or find) the kernel library; returns the compiler output."""
    return _library()[1]


def _cuda_inputs(s_flat, s_pay, starts, rows_cur, B, vol, f_bits, o,
                 raw: bool):
    """Device of the inputs, validated for the kernel; None for CPU."""
    tensors = (s_flat, s_pay, starts, rows_cur)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise ValueError(f"bin_apply runs on CPU or CUDA tensors, not {device}")
    _check(s_flat, s_pay, starts, rows_cur, B, vol, f_bits, o)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bin_apply needs contiguous inputs")
    if vol > _MAX_THREADS or _smem_bytes(raw, 1, B, vol) > _SMEM_LIMIT:
        raise ValueError(f"B={B}, vol={vol} exceed the kernel's block limits")
    return device


def _launch(name, device, tensors, nb, B, vol, f_bits, o, cfg) -> None:
    """Launch entry point ``name`` of the library on the current stream
    with the tensors' pointers, the record count, the tile, the shape and
    the chain constants."""
    lib, _ = _library()
    tb = tile_bricks(name.startswith("bin_apply_raw"), B, vol)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(
            *(t.data_ptr() for t in tensors), tensors[0].shape[0], nb, tb, B,
            vol, f_bits, o, cfg.log_odds_occupied, cfg.log_odds_free,
            int(cfg.adaptive_update), cfg.adaptive_threshold,
            cfg.adaptive_max_ratio, cfg.log_odds_min, cfg.log_odds_max, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


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
    device = _cuda_inputs(s_flat, s_pay, starts, rows_cur, B, vol, f_bits, o,
                          raw=False)
    if device is None:
        return bin_apply_reference(
            s_flat, s_pay, starts, rows_cur, B=B, vol=vol, f_bits=f_bits, o=o,
            cfg=cfg,
        )
    nb = rows_cur.shape[0]
    v_out = torch.empty_like(rows_cur)
    upd = torch.empty(rows_cur.shape, dtype=torch.bool, device=device)
    if nb == 0:
        return v_out, upd
    suffix = "f32" if rows_cur.dtype == torch.float32 else "f64"
    _launch(f"bin_apply_{suffix}", device,
            (s_flat, s_pay, starts, rows_cur, v_out, upd),
            nb, B, vol, f_bits, o, cfg)
    launches += 1
    return v_out, upd


def bin_apply_raw(
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``bin_apply`` over raw candidates, with per-frame unique counts.

    Inputs as for ``bin_apply``, except that records may repeat a slot:
    their counts and n_occ are summed per slot (each sum must stay below
    2^32; it is exact in the chain below 2^24).  Returns (new rows,
    touched-this-window mask, per-frame occupied voxels (B,) int64,
    per-frame free voxels (B,) int64), the voxels with n_occ > 0 and those
    with count != 0 and n_occ == 0, summed over the bricks.
    """
    global raw_launches
    device = _cuda_inputs(s_flat, s_pay, starts, rows_cur, B, vol, f_bits, o,
                          raw=True)
    if device is None:
        return bin_apply_raw_reference(
            s_flat, s_pay, starts, rows_cur, B=B, vol=vol, f_bits=f_bits, o=o,
            cfg=cfg,
        )
    nb = rows_cur.shape[0]
    v_out = torch.empty_like(rows_cur)
    upd = torch.empty(rows_cur.shape, dtype=torch.bool, device=device)
    # the kernel adds its per-brick counts into these
    counts = torch.zeros((2, B), dtype=torch.int64, device=device)
    if nb == 0:
        return v_out, upd, counts[0], counts[1]
    suffix = "f32" if rows_cur.dtype == torch.float32 else "f64"
    _launch(f"bin_apply_raw_{suffix}", device,
            (s_flat, s_pay, starts, rows_cur, v_out, upd, counts[0], counts[1]),
            nb, B, vol, f_bits, o, cfg)
    raw_launches += 1
    return v_out, upd, counts[0], counts[1]
