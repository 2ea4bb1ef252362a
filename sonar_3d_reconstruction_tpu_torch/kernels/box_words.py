"""The per-frame dedup's sort words of a batch of pings, in one kernel:
box keys, or brick codes where the window has no box.

``box_words`` launches the hand-written kernel ``csrc/box_words.cu``
(built at first use, bound with ctypes) on CUDA tensors and raises on
any other.  It computes what ``ops.records.sort_words_plain`` computes
with PyTorch ops (backprojection, voxel keying, box packing, validity and
the frame's bounds), which is its plain version: ``ops.records.sort_words``
takes the kernel on the card and the plain version elsewhere, and the
tests hold the two bit for bit.  ``launches`` counts kernel launches and
nothing else.  The design and the bound are in the source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.kernels.build import build_shared_library
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
    FanTables,
    _device_tables,
    _fan_trig,
)

SOURCE = "box_words.cu"

# kernel launches since import (or since a caller reset them)
launches = 0

RAYS_PER_BLOCK = 16       # the kernel's kRays
_SMEM_DEFAULT = 48 * 1024  # the kernel's hit words live in the default share
_MAX_FRAMES = 65535       # the grid's frame axis

# pixel kinds the kernel reads (csrc/box_words.cu, ``pixel``)
_IMAGE_KINDS = {torch.uint8: 0, torch.float32: 1, torch.float64: 2}

# the kernel's (F, 9) int64 reduction fields: key minima, key maxima, valid
# packed lanes, range failure, finished blocks
_RED_INIT = (2**31 - 1,) * 3 + (-2**31,) * 3 + (0, 0, 0)

_TABLES = ("ray_indices", "cos_b", "sin_b", "free_idx", "free_r",
           "free_cos_v", "free_sin_v", "free_mask", "occ_nv")


@functools.cache
def _library() -> Tuple[ctypes.CDLL, str]:
    path, log = build_shared_library(SOURCE)
    lib = ctypes.CDLL(str(path))
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("box_words_f32", "box_words_f64"):
        fn = getattr(lib, name)
        fn.argtypes = (
            [ptr, i32, ptr, ptr, ptr, i32, ctypes.POINTER(ptr)]
            + [ptr] * 6 + [i32] * 8 + [f64] * 5 + [i32, f64] + [i32] * 5
            + [ptr]
        )
        fn.restype = i32
    return lib, log


def build() -> str:
    """Build (or find) the kernel library; returns the compiler output."""
    return _library()[1]


def image_operand(images: torch.Tensor, threshold: float):
    """(images as the kernel reads them, their pixel kind, the threshold as
    a float) such that ``pixel > threshold`` compared in double is
    ``images > threshold`` as torch compares it: in the dtype of
    ``torch.result_type``, with the threshold rounded to it.  A pixel dtype
    the kernel does not read is converted to the float it is compared in
    (float32 where that is a 16-bit float: exact)."""
    cmp = torch.result_type(images, threshold)
    thr = float(torch.tensor(threshold, dtype=cmp))
    if images.dtype not in _IMAGE_KINDS:
        images = images.to(torch.float64 if cmp == torch.float64
                           else torch.float32)
    return images.contiguous(), _IMAGE_KINDS[images.dtype], thr


@functools.lru_cache(maxsize=16)
def _red_init(frames: int, device: torch.device) -> torch.Tensor:
    return torch.tensor([_RED_INIT] * frames, dtype=torch.int64,
                        device=device)


def box_words(
    images: torch.Tensor,
    transforms: torch.Tensor,
    tables: FanTables,
    cfg: MapperConfig,
    box_min: Optional[torch.Tensor],
    box_bits: Optional[Tuple[int, int, int]],
    brick_bits: int,
    dtype: torch.dtype,
    frame_on: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Sort words and bounds of F pings on the card: ``images`` (F, R, Bw),
    ``transforms`` (F, 4, 4), ``frame_on`` None or a bool () / (F,); box
    keys against ``box_min`` ((3,) or (F, 1, 3) brick-aligned box origins)
    with ``box_bits`` (ax, ay, az) brick bits, or brick codes of
    ``brick_bits`` (1-3) where ``box_min`` is None.  Returns (skey (F, N)
    int64, cmin (F, 3), cmax (F, 3), range_fail (F,) bool, n_valid (F,)
    int64), each bit-equal to ``ops.records.sort_words_plain``'s; floats in
    ``dtype`` (float32 or float64)."""
    global launches
    device = images.device
    if device.type != "cuda":
        raise ValueError(f"box_words runs on CUDA tensors, not {device}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"box_words computes in float32 or float64, not {dtype}")
    F, R, Bw = images.shape
    if (R, Bw) != (tables.range_bins, tables.bearing_bins):
        raise ValueError(f"image shape {(R, Bw)} != tables "
                         f"{(tables.range_bins, tables.bearing_bins)}")
    if F > _MAX_FRAMES:
        raise ValueError(f"{F} frames exceed the kernel's {_MAX_FRAMES}")
    if RAYS_PER_BLOCK * (R // 32 + 1) * 4 > _SMEM_DEFAULT:
        raise ValueError(f"{R} range bins exceed the kernel's hit words")
    transforms = transforms.to(device=device, dtype=dtype).reshape(F, 4, 4)
    transforms = transforms.contiguous()
    if not 1 <= brick_bits <= 3:
        raise ValueError(f"brick_bits must be 1..3, got {brick_bits}")
    box, box_stride = None, 0
    if box_min is not None:
        box = box_min.to(device=device, dtype=torch.int64).reshape(-1, 3)
        if box.shape[0] not in (1, F):
            raise ValueError(f"box_min {tuple(box_min.shape)} is not (3,) "
                             f"or ({F}, 1, 3)")
        box = box.contiguous()
        box_stride = 0 if box.shape[0] == 1 else 3
    on = None
    if frame_on is not None:
        on = torch.as_tensor(frame_on, device=device).to(torch.bool)
        on = on.expand(F).contiguous()
    pixels, kind, thr = image_operand(images, cfg.intensity_threshold)

    tab = _device_tables(tables, device, dtype)
    cos_t, sin_t, _ = _fan_trig(tables, device, dtype, cfg.half_aperture_rad)
    L = int(tables.free_idx.shape[0])
    W = tables.effective_window(cfg.occupied_window)
    S = 2 * tables.nvo_cap + 1
    N = tables.n_rays * (L + W * S)

    skey = torch.empty((F, N), dtype=torch.int64, device=device)
    cmin = torch.empty((F, 3), dtype=dtype, device=device)
    cmax = torch.empty((F, 3), dtype=dtype, device=device)
    range_fail = torch.empty(F, dtype=torch.bool, device=device)
    n_valid = torch.empty(F, dtype=torch.int64, device=device)
    if F == 0:
        return skey, cmin, cmax, range_fail, n_valid
    red = _red_init(F, device).clone()
    ptrs = (ctypes.c_void_p * 11)(
        *(tab[k].data_ptr() for k in _TABLES), cos_t.data_ptr(),
        sin_t.data_ptr())
    lib, _ = _library()
    name = "box_words_f32" if dtype == torch.float32 else "box_words_f64"
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(
            pixels.data_ptr(), kind, transforms.data_ptr(),
            None if on is None else on.data_ptr(),
            None if box is None else box.data_ptr(), box_stride, ptrs,
            skey.data_ptr(), red.data_ptr(), cmin.data_ptr(),
            cmax.data_ptr(), range_fail.data_ptr(), n_valid.data_ptr(),
            F, R, Bw, tables.n_rays, L, W, S, tables.nvo_cap, thr,
            cfg.voxel_resolution, cfg.max_range / R, cfg.min_range,
            cfg.max_range, int(cfg.z_filter_enabled), cfg.z_filter_min,
            *(box_bits or (0, 0, 0)), brick_bits, int(box is None), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches += 1
    return skey, cmin, cmax, range_fail, n_valid
