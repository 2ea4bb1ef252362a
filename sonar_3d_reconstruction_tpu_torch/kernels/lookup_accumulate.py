"""K2: bucketed key-table find-or-insert + value accumulate.

``lookup_accumulate`` replaces ``sonar_3d_reconstruction_tpu.pallas.
table_kernel.pallas_lookup_accumulate``.  On CUDA tensors it launches the
hand-written kernel ``csrc/lookup_accumulate.cu`` (built at first use,
bound with ctypes) and raises if that cannot be done; on CPU tensors it
runs ``lookup_accumulate_reference``, the plain PyTorch version the kernel
is held against (the port of the JAX package's ``xla_lookup_accumulate``,
built on ``grid/hash.py``'s bucket ops).  The plain version needs
distinct keys; ``lookup_accumulate_sequential``, the TPU kernel's loop run
record by record on the host, is the oracle for batches with repeated
keys.  ``launches`` counts kernel launches and nothing else.

Like the JAX package, the table kernel has no product path: it is driven
on its own (``chip_smoke.py``), as ``scripts/profile_pallas.py`` drives
the TPU kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.grid.hash import (
    BUCKET_SLOTS,
    bucket_lookup,
    commit_insert,
    plan_insert,
)
from sonar_3d_reconstruction_tpu_torch.kernels.build import build_shared_library
from sonar_3d_reconstruction_tpu_torch.ops.packing import EMPTY_HI, mix2

SOURCE = "lookup_accumulate.cu"

# kernel launches since import (or since a caller reset it)
launches = 0


def _check(khi, klo, upd, key_rows, values) -> None:
    if khi.dtype != torch.int64 or klo.dtype != torch.int64:
        raise TypeError("khi and klo must be int64 (u32 values)")
    if key_rows.dtype != torch.int64:
        raise TypeError("key_rows must be int64 (u32 values)")
    if upd.dtype != torch.float32 or values.dtype != torch.float32:
        raise TypeError("upd and values must be float32")
    if khi.dim() != 1 or klo.shape != khi.shape or upd.shape != khi.shape:
        raise ValueError("khi, klo and upd must be 1-D of equal length")
    nb = key_rows.shape[0]
    if nb < 1 or nb & (nb - 1):
        raise ValueError(f"the bucket count {nb} is not a power of two")
    if key_rows.shape != (nb, 2 * BUCKET_SLOTS):
        raise ValueError(f"key_rows must be (NB, {2 * BUCKET_SLOTS})")
    if values.shape != (nb, BUCKET_SLOTS):
        raise ValueError(f"values must be ({nb}, {BUCKET_SLOTS})")


def lookup_accumulate_reference(
    khi: torch.Tensor,
    klo: torch.Tensor,
    upd: torch.Tensor,
    key_rows: torch.Tensor,
    values: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: one bucket lookup, an insert plan for the
    keys not found, one value scatter.

    Needs the active keys to be mutually distinct (the engine's dedup
    guarantees it).  Keys that do not fit their bucket are dropped, as the
    kernel drops them (``plan_insert`` would report the overflow; here it
    is not read).  Returns (new key rows, new values).
    """
    _check(khi, klo, upd, key_rows, values)
    capacity = key_rows.shape[0] * BUCKET_SLOTS
    active = khi != EMPTY_HI
    bucket, found, found_slot, fill = bucket_lookup(key_rows, khi, klo)
    plan = plan_insert(key_rows, khi, klo, active & ~found, bucket, fill)
    new_rows = commit_insert(key_rows, plan)
    # inactive and dropped lanes go to the dump slot `capacity`, cut off
    slots = torch.where(active, torch.where(found, found_slot, plan.slots),
                        capacity)
    flat = torch.cat([values.reshape(-1), values.new_zeros(1)])
    flat[slots] = flat[torch.clamp(slots, max=capacity - 1)] + upd
    return new_rows, flat[:capacity].reshape(values.shape)


def lookup_accumulate_sequential(
    khi: torch.Tensor,
    klo: torch.Tensor,
    upd: torch.Tensor,
    key_rows: torch.Tensor,
    values: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's loop on the host, one record at a time (NumPy).

    Slow; it is the oracle for batches with duplicate keys, which the
    plain version does not take.  Returns new (key_rows, values) on the
    inputs' device."""
    _check(khi, klo, upd, key_rows, values)
    rows = key_rows.cpu().numpy().copy()
    vals = values.cpu().numpy().copy()
    bucket = (mix2(khi, klo) & (rows.shape[0] - 1)).cpu().numpy()
    for h, lo, u, b in zip(khi.cpu().numpy(), klo.cpu().numpy(),
                           upd.cpu().numpy(), bucket):
        if h == EMPTY_HI:
            continue
        row_hi, row_lo = rows[b, :BUCKET_SLOTS], rows[b, BUCKET_SLOTS:]
        match = np.flatnonzero((row_hi == h) & (row_lo == lo))
        if match.size:
            slot = match[0]
        else:
            slot = BUCKET_SLOTS - int((row_hi == EMPTY_HI).sum())
            if slot == BUCKET_SLOTS:
                continue  # full bucket: dropped
            row_hi[slot], row_lo[slot] = h, lo
        vals[b, slot] += u  # float32 += float32
    device = key_rows.device
    return torch.as_tensor(rows, device=device), torch.as_tensor(vals, device=device)


def group_by_bucket(
    khi: torch.Tensor, klo: torch.Tensor, nb: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Active records grouped by bucket, in record order within a bucket.

    Returns (order (U,) record indices sorted by bucket, inactive records
    last; seg (NB+1,) where bucket b's records are order[seg[b]:seg[b+1]]).
    The sort is stable: the kernel's per-bucket walk relies on it.
    """
    bucket = torch.where(khi != EMPTY_HI, mix2(khi, klo) & (nb - 1), nb)
    s_bkt, order = torch.sort(bucket, stable=True)
    seg = torch.searchsorted(
        s_bkt, torch.arange(nb + 1, device=khi.device, dtype=s_bkt.dtype)
    )
    return order, seg


@functools.cache
def _library() -> Tuple[ctypes.CDLL, str]:
    path, log = build_shared_library(SOURCE)
    lib = ctypes.CDLL(str(path))
    ptr = ctypes.c_void_p
    lib.lookup_accumulate.argtypes = [ptr] * 9 + [ctypes.c_int, ptr]
    lib.lookup_accumulate.restype = ctypes.c_int
    return lib, log


def build() -> str:
    """Build (or find) the kernel library; returns the compiler output."""
    return _library()[1]


def lookup_accumulate(
    khi: torch.Tensor,
    klo: torch.Tensor,
    upd: torch.Tensor,
    key_rows: torch.Tensor,
    values: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Find-or-insert every record's key and add its update to the slot.

    ``khi``/``klo`` (U,) key words (u32 values in int64; ``khi`` =
    EMPTY_HI marks an inactive lane), ``upd`` (U,) float32, ``key_rows``
    (NB, 256) the bucketed key table (grid/hash.py layout, NB a power of
    two), ``values`` (NB, 128) float32.  Records apply in order: a key
    already present (also from an earlier record of the same call) takes
    the update; a new key is inserted at its bucket's fill count; a record
    whose bucket is full is dropped.  Returns new (key_rows, values); the
    inputs are not modified.

    On CPU tensors this runs the plain version, which needs distinct
    active keys; for distinct keys both give the same tables bit for bit.
    """
    global launches
    tensors = (khi, klo, upd, key_rows, values)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return lookup_accumulate_reference(khi, klo, upd, key_rows, values)
    if device.type != "cuda":
        raise ValueError(
            f"lookup_accumulate runs on CPU or CUDA tensors, not {device}"
        )
    _check(khi, klo, upd, key_rows, values)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lookup_accumulate needs contiguous inputs")

    nb = key_rows.shape[0]
    order, seg = group_by_bucket(khi, klo, nb)
    rows_out = torch.empty_like(key_rows)
    vals_out = torch.empty_like(values)
    lib, _ = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.lookup_accumulate(
            khi.data_ptr(), klo.data_ptr(), upd.data_ptr(), order.data_ptr(),
            seg.data_ptr(), key_rows.data_ptr(), values.data_ptr(),
            rows_out.data_ptr(), vals_out.data_ptr(), nb, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lookup_accumulate kernel launch failed: CUDA error {err}"
        )
    launches += 1
    return rows_out, vals_out
