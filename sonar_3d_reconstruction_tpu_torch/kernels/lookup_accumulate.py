"""K2: bucketed key-table find-or-insert + value accumulate.

``lookup_accumulate`` replaces ``sonar_3d_reconstruction_tpu.pallas.
table_kernel.pallas_lookup_accumulate``.  On CUDA tensors it launches the
hand-written kernels of ``csrc/lookup_accumulate.cu`` (built at first use,
bound with ctypes) and raises if that cannot be done.  One call does what
``group_records`` (bucket pass, allocation of segments, scatter of packed
records, sort of long segments) and ``apply_grouped`` (the table kernel)
do apart.  On CPU tensors each of these runs its plain PyTorch version.

Plain versions: ``lookup_accumulate_plain`` follows the kernel's rule and
takes repeated keys; ``lookup_accumulate_reference`` (the port of the JAX
package's ``xla_lookup_accumulate``, built on ``grid/hash.py``'s bucket
ops) needs distinct keys; ``lookup_accumulate_sequential``, the TPU
kernel's loop run record by record on the host, is the oracle for both.
``bucket_pass_reference`` and ``group_records_reference`` are the plain
versions of the grouping kernels, and ``group_by_bucket``, a stable sort
of the bucket pass's ids, is the grouping's yardstick
(``scripts/torch_k2_bench.py``).  ``launches`` counts calls that launched
the table kernel and nothing else.

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
from sonar_3d_reconstruction_tpu_torch.ops.dedup import running_max
from sonar_3d_reconstruction_tpu_torch.ops.packing import EMPTY_HI, U32, mix2

SOURCE = "lookup_accumulate.cu"
# the longest bucket segment the table kernel puts in record order itself
# (csrc kWarpRecords); longer ones are sorted by their own kernel
WARP_RECORDS = 64

# calls that launched the table kernel since import (or since a caller
# reset it)
launches = 0


def _check_records(khi, klo, upd) -> None:
    if khi.dtype != torch.int64 or klo.dtype != torch.int64:
        raise TypeError("khi and klo must be int64 (u32 values)")
    if upd.dtype != torch.float32:
        raise TypeError("upd must be float32")
    if khi.dim() != 1 or klo.shape != khi.shape or upd.shape != khi.shape:
        raise ValueError("khi, klo and upd must be 1-D of equal length")
    if khi.shape[0] >= 1 << 31:
        raise ValueError("at most 2^31 - 1 records per call")


def _check(khi, klo, upd, key_rows, values) -> None:
    _check_records(khi, klo, upd)
    if key_rows.dtype != torch.int64:
        raise TypeError("key_rows must be int64 (u32 values)")
    if values.dtype != torch.float32:
        raise TypeError("values must be float32")
    nb = key_rows.shape[0]
    if nb < 1 or nb & (nb - 1):
        raise ValueError(f"the bucket count {nb} is not a power of two")
    if key_rows.shape != (nb, 2 * BUCKET_SLOTS):
        raise ValueError(f"key_rows must be (NB, {2 * BUCKET_SLOTS})")
    if values.shape != (nb, BUCKET_SLOTS):
        raise ValueError(f"values must be ({nb}, {BUCKET_SLOTS})")


def _device_of(*tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"K2 runs on CPU or CUDA tensors, not {device}")
    return device


def _check_for_kernel(*tensors, aligned=()) -> None:
    if not all(t.is_contiguous() for t in tensors + aligned):
        raise ValueError("the K2 kernels need contiguous inputs")
    # the table kernel moves rows and records with 16-byte loads and stores
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError("the K2 kernels need 16-byte aligned tables")


def _buffer(u: int, nb: int, device: torch.device) -> torch.Tensor:
    """The grouping's int32 buffer: the packed records (2U rows of 4 words:
    the records, then the long-segment sort's scratch), then seg (NB, 2)
    and the grouping's other scratch (2 NB + 2 words)."""
    return torch.empty(8 * u + 4 * nb + 2, dtype=torch.int32, device=device)


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


def lookup_accumulate_plain(
    khi: torch.Tensor,
    klo: torch.Tensor,
    upd: torch.Tensor,
    key_rows: torch.Tensor,
    values: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the table kernel's rule; takes repeated
    keys.

    A key already in the table keeps its slot.  Of the keys not in it, the
    first record of each is an insert: ranked by record order within its
    bucket, it goes to fill + rank, or drops at >= 128; the key's later
    records take its slot (or drop with it).  Then each slot adds its
    records' updates one at a time in record order, one float32 addition
    each, in as many rounds as a slot has records.  Returns (new key rows,
    new values); for distinct keys the same tables as
    ``lookup_accumulate_reference``, bit for bit.
    """
    _check(khi, klo, upd, key_rows, values)
    u = khi.shape[0]
    device = khi.device
    capacity = key_rows.shape[0] * BUCKET_SLOTS
    idx = torch.arange(u, device=device)
    active = khi != EMPTY_HI
    bucket, found, found_slot, fill = bucket_lookup(key_rows, khi, klo)
    new = active & ~found
    _, key_of = torch.unique((khi << 32) | klo, return_inverse=True)
    # each key's first record among those not found (u: none)
    first = torch.full((u,), u, dtype=torch.int64, device=device).scatter_reduce(
        0, key_of, torch.where(new, idx, u), "amin")[key_of]
    plan = plan_insert(key_rows, khi, klo, new & (first == idx), bucket, fill)
    new_rows = commit_insert(key_rows, plan)
    inserted = plan.slots[torch.clamp(first, max=max(u - 1, 0))]
    slots = torch.where(active, torch.where(found, found_slot, inserted),
                        capacity)
    # the records that add, by slot and in record order within a slot, and
    # each one's turn among its slot's records
    take = slots < capacity
    s_slot, order = torch.sort(slots[take], stable=True)
    s_upd = upd[take][order]
    pos = torch.arange(s_slot.numel(), device=device)
    starts = torch.ones_like(s_slot, dtype=torch.bool)
    starts[1:] = s_slot[1:] != s_slot[:-1]
    turn = pos - running_max(torch.where(starts, pos, -1))
    flat = values.reshape(-1).clone()
    for q in range(int(turn.max()) + 1 if turn.numel() else 0):
        sel = turn == q
        flat[s_slot[sel]] = flat[s_slot[sel]] + s_upd[sel]
    return new_rows, flat.reshape(values.shape)


def lookup_accumulate_sequential(
    khi: torch.Tensor,
    klo: torch.Tensor,
    upd: torch.Tensor,
    key_rows: torch.Tensor,
    values: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's loop on the host, one record at a time (NumPy).

    Slow; it is the oracle for batches with duplicate keys, which
    ``lookup_accumulate_reference`` does not take.  Returns new
    (key_rows, values) on the inputs' device."""
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


def bucket_pass_reference(
    khi: torch.Tensor, klo: torch.Tensor, nb: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the bucket pass: (counts (NB,) int32, the active
    records of each bucket; ids (U,) int32, each record's bucket, NB for
    an inactive one)."""
    ids = torch.where(khi != EMPTY_HI, mix2(khi, klo) & (nb - 1), nb)
    counts = torch.bincount(ids, minlength=nb + 1)[:nb]
    return counts.to(torch.int32), ids.to(torch.int32)


def bucket_pass(
    khi: torch.Tensor, klo: torch.Tensor, nb: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bucket pass (counts, ids) as ``bucket_pass_reference`` gives
    them: its kernel on CUDA tensors, its plain version on CPU ones."""
    device = _device_of(khi, klo)
    if device.type == "cpu":
        return bucket_pass_reference(khi, klo, nb)
    _check_for_kernel(khi, klo)
    i32 = dict(dtype=torch.int32, device=device)
    counts, ids = torch.empty(nb + 2, **i32), torch.empty(khi.shape[0], **i32)
    with torch.cuda.device(device):
        _launch("k2_bucket_pass", device, khi, klo, khi.shape[0], nb, counts,
                ids)
    return counts[:nb], ids


def group_by_bucket(
    khi: torch.Tensor, klo: torch.Tensor, nb: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Active records grouped by bucket, in record order within a bucket,
    by a stable sort of the bucket pass's int32 ids.

    Returns (order (U,) record indices sorted by bucket, inactive records
    last; seg (NB+1,) int32, bucket b's records are order[seg[b]:seg[b+1]]).
    """
    _, ids = bucket_pass(khi, klo, nb)
    s_bkt, order = torch.sort(ids, stable=True)
    seg = torch.searchsorted(
        s_bkt, torch.arange(nb + 1, device=khi.device, dtype=s_bkt.dtype),
        out_int32=True,
    )
    return order, seg


def pack_records(
    khi: torch.Tensor, klo: torch.Tensor, upd: torch.Tensor,
    order: torch.Tensor,
) -> torch.Tensor:
    """(len(order), 4) int32 packed records (hi, lo, upd bits, record
    index) of the records ``order`` names, in that order."""
    words = (khi[order], klo[order], upd.view(torch.int32)[order].long(),
             order)
    return torch.stack(words, dim=1).to(torch.int32)


def unpack_records(
    packed: torch.Tensor, seg: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The grouped records (khi, klo, upd) back in record order."""
    rec = packed[: int(seg[:, 1].sum())]
    rec = rec[torch.argsort(rec[:, 3])]
    words = rec[:, :2].long() & U32
    return words[:, 0], words[:, 1], rec[:, 2].contiguous().view(torch.float32)


def group_records_reference(
    khi: torch.Tensor, klo: torch.Tensor, upd: torch.Tensor, nb: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the grouping kernels (bucket pass, allocation,
    scatter, long-segment sort): (packed (U, 4) int32 records (hi, lo, upd
    bits, record index); seg (NB, 2) int32, each bucket's (start, count)).
    Bucket b's active records are packed[start:start + count], in record
    order; the segments fill rows [0, active records) and the rows after
    them are unspecified.  Here the segments lie in bucket order and the
    inactive records follow."""
    counts, ids = bucket_pass_reference(khi, klo, nb)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    u = khi.shape[0]
    # (bucket, record index) pairs are distinct
    order = torch.argsort(ids.long() * u + torch.arange(u, device=khi.device))
    return pack_records(khi, klo, upd, order), torch.stack([starts, counts], 1)


def group_records(
    khi: torch.Tensor, klo: torch.Tensor, upd: torch.Tensor, nb: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The active records grouped by bucket, (packed, seg) as
    ``group_records_reference`` describes them.  On CUDA tensors the
    segments lie in no particular order, and one of at most WARP_RECORDS
    records holds its records in scatter order (the table kernel orders
    them); longer ones are in record order.  Four kernel launches there:
    bucket pass, allocation, scatter and long-segment sort."""
    _check_records(khi, klo, upd)
    device = _device_of(khi, klo, upd)
    if device.type == "cpu":
        return group_records_reference(khi, klo, upd, nb)
    _check_for_kernel(khi, klo, upd)
    u = khi.shape[0]
    buf = _buffer(u, nb, device)
    with torch.cuda.device(device):
        _launch("k2_group", device, khi, klo, upd, u, nb,
                buf.data_ptr() + 32 * u, buf, _sort_blocks(device))
    return buf[:4 * u].view(u, 4), buf[8 * u:8 * u + 2 * nb].view(nb, 2)


def apply_grouped(
    packed: torch.Tensor,
    seg: torch.Tensor,
    key_rows: torch.Tensor,
    values: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table kernel on records grouped as ``group_records`` groups
    them (a segment longer than WARP_RECORDS in record order): new
    (key_rows, values).  Its plain version, on CPU tensors, unpacks the
    records and runs ``lookup_accumulate_plain``."""
    global launches
    device = _device_of(packed, seg, key_rows, values)
    if device.type == "cpu":
        return lookup_accumulate_plain(*unpack_records(packed, seg), key_rows,
                                       values)
    nb = key_rows.shape[0]
    if seg.dtype != torch.int32 or seg.shape != (nb, 2):
        raise ValueError(f"seg must be ({nb}, 2) int32")
    if packed.dtype != torch.int32 or packed.dim() != 2 or packed.shape[1] != 4:
        raise ValueError("packed must be (U, 4) int32")
    _check_for_kernel(aligned=(packed, seg, key_rows, values))
    rows_out = torch.empty_like(key_rows)
    vals_out = torch.empty_like(values)
    with torch.cuda.device(device):
        _launch("lookup_accumulate", device, packed, seg, key_rows, values,
                rows_out, vals_out, nb)
    launches += 1
    return rows_out, vals_out


def _bind(path) -> ctypes.CDLL:
    """The library at ``path`` with its entry points' C signatures."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (
        ("k2_bucket_pass", [ptr, ptr, i64, i32, ptr, ptr]),
        ("k2_group", [ptr, ptr, ptr, i64, i32, ptr, ptr, i32]),
        ("lookup_accumulate", [ptr] * 6 + [i32]),
        ("k2_lookup_accumulate", [ptr, ptr, ptr, i64] + [ptr] * 4
         + [i32, ptr, i32]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args + [ptr]
        fn.restype = i32
    return lib


@functools.cache
def _library() -> Tuple[ctypes.CDLL, str]:
    path, log = build_shared_library(SOURCE)
    return _bind(path), log


@functools.cache
def _sort_blocks(device: torch.device) -> int:
    """Blocks of the long-segment sort: one per SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def build() -> str:
    """Build (or find) the kernel library; returns the compiler output."""
    return _library()[1]


def _launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` of the library on the device's current
    stream; tensors pass as their pointers, None as a null pointer."""
    lib, _ = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


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

    On CPU tensors this runs ``lookup_accumulate_plain``; both give the
    same tables bit for bit, repeated keys included.
    """
    global launches
    device = _device_of(khi, klo, upd, key_rows, values)
    _check(khi, klo, upd, key_rows, values)
    if device.type == "cpu":
        return lookup_accumulate_plain(khi, klo, upd, key_rows, values)
    # group_records and apply_grouped in one call of the library
    _check_for_kernel(khi, klo, upd, aligned=(key_rows, values))
    u, nb = khi.shape[0], key_rows.shape[0]
    buf = _buffer(u, nb, device)
    rows_out = torch.empty_like(key_rows)
    vals_out = torch.empty_like(values)
    with torch.cuda.device(device):
        _launch("k2_lookup_accumulate", device, khi, klo, upd, u, key_rows,
                values, rows_out, vals_out, nb, buf, _sort_blocks(device))
    launches += 1
    return rows_out, vals_out
