"""Sort-based per-frame voxel dedup (PyTorch port of
``sonar_3d_reconstruction_tpu.ops.dedup``: ``dedup_frame_compact`` over
compact box keys, ``dedup_frame`` over two-word keys).

A frame's candidates collapse into one record per distinct voxel:

  1. the occupied bit is folded into the sort key (``key << 1 | occ``;
     invalid lanes take ``EMPTY32`` and sort last), one sort;
  2. segment ends by neighbour compare on the voxel; the lane index and
     the occupied cumsum ride along as mod-2^16 residues packed in one
     word;
  3. a second sort compacts the segment ends to the front, and each
     record's (count, n_occ) falls out as the adjacent difference of the
     residues, packed as the payload ``count << 16 | n_occ``.

The residue differences are exact because every representable count is
below 2^16; the one case that is not (a voxel with 2^16+ candidates in one
frame) shows as an equal-voxel pair 65535 lanes apart and is reported
through ``pack_fail``.

Two-word keys (``dedup_frame``) sort one int64 instead: the key's 60-bit
code (ops/packing.key_code) with the occupied bit below it, and the
record's (count, n_occ) come from the lane index and the occupied cumsum
of its segment end, exactly, with no packing width to overflow.

The JAX functions truncate records to a static unique budget.  Here the
output keeps the full candidate width (valid records first, empty lanes
after), so there is no budget and no overflow; the window engine slices it
to the window's largest ``n_unique``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sonar_3d_reconstruction_tpu_torch.ops.packing import (
    EMPTY32,
    EMPTY64,
    EMPTY_HI,
    code_words,
    key_code,
)


class UniqueRecords(NamedTuple):
    """Per-frame unique-voxel records with two-word keys, in ascending key
    order.  Along a leading frame axis when stacked for a window."""

    hi: torch.Tensor        # (U,) int64 key word (EMPTY_HI = unused lane)
    lo: torch.Tensor        # (U,) int64 (EMPTY_HI on unused lanes)
    count: torch.Tensor     # (U,) int64 candidates in the voxel this frame
    n_occ: torch.Tensor     # (U,) int64 occupied-type candidates
    n_unique: torch.Tensor  # () int64 valid records (a prefix of the lanes)

    @property
    def valid(self) -> torch.Tensor:
        return self.hi != EMPTY_HI


def dedup_frame(
    hi: torch.Tensor,
    lo: torch.Tensor,
    occ: torch.Tensor,
    valid: torch.Tensor,
    brick: bool,
) -> UniqueRecords:
    """(N,) two-word keys (brick codes when ``brick``, else voxel codes),
    occupied flags and emission mask -> UniqueRecords of width N.

    One sort of ``code << 1 | occ`` (61 bits; invalid lanes EMPTY64, last)
    groups each voxel's candidates; a second compacts the segment ends, in
    key order, whose lane indices and occupied cumsums give each record's
    count and n_occ as adjacent differences."""
    n = hi.shape[0]
    device = hi.device
    code = key_code(hi, lo, brick)
    skey = torch.where(valid, (code << 1) | occ.to(torch.int64), EMPTY64)
    skey = torch.sort(skey).values

    vox = skey >> 1
    # invalid lanes sort past every record, so their sentinel's low bit
    # only reaches cumsum lanes beyond the last record
    csum_occ = torch.cumsum(skey & 1, dim=0)
    first = torch.ones(1, dtype=torch.bool, device=device)
    new_seg = torch.cat([first, vox[1:] != vox[:-1]])
    is_end = torch.cat([new_seg[1:], first])
    rec = is_end & (skey != EMPTY64)
    n_unique = rec.sum()

    # records are distinct voxels, so the unstable sort fixes their order,
    # which is their end lanes' order; the sentinel tail is masked below
    c_vox, end = torch.sort(torch.where(rec, vox, EMPTY64 >> 1))
    c_csum = csum_occ[end]
    prev_end = torch.cat([end.new_full((1,), -1), end[:-1]])
    prev_csum = torch.cat([c_csum.new_zeros(1), c_csum[:-1]])

    valid_u = torch.arange(n, device=device) < n_unique
    c_hi, c_lo = code_words(c_vox, brick)
    return UniqueRecords(
        hi=torch.where(valid_u, c_hi, EMPTY_HI),
        lo=torch.where(valid_u, c_lo, EMPTY_HI),
        count=torch.where(valid_u, end - prev_end, 0),
        n_occ=torch.where(valid_u, c_csum - prev_csum, 0),
        n_unique=n_unique,
    )


class CompactRecords(NamedTuple):
    """Per-frame unique-voxel records with box-relative keys.

    Along a leading frame axis when stacked for a window."""

    key: torch.Tensor        # (U,) int64 box key (EMPTY32 = unused lane)
    payload: torch.Tensor    # (U,) int64 count << 16 | n_occ (0 on unused)
    n_unique: torch.Tensor   # () int64 valid records (a prefix of the
                             # lanes, except for raw records)
    pack_fail: torch.Tensor  # () bool: some voxel got 2^16+ candidates

    @property
    def valid(self) -> torch.Tensor:
        return self.key != EMPTY32

    @property
    def n_occ(self) -> torch.Tensor:
        return self.payload & 0xFFFF


def dedup_frame_compact(
    key: torch.Tensor, occ: torch.Tensor, valid: torch.Tensor
) -> CompactRecords:
    """(N,) box keys (< 2^30), occupied flags and emission mask ->
    CompactRecords of width N, records in ascending key order."""
    n = key.shape[0]
    device = key.device
    skey = torch.where(valid, (key << 1) | occ.to(torch.int64), EMPTY32)
    skey = torch.sort(skey).values

    vox = skey >> 1
    # invalid lanes sort past every record, so their sentinel's low bit
    # only reaches cumsum lanes beyond the last record
    csum_occ = torch.cumsum(skey & 1, dim=0)
    lane = torch.arange(n, device=device)
    track = ((lane & 0xFFFF) << 16) | (csum_occ & 0xFFFF)

    first = torch.ones(1, dtype=torch.bool, device=device)
    new_seg = torch.cat([first, vox[1:] != vox[:-1]])
    is_end = torch.cat([new_seg[1:], first])
    seg_valid = skey != EMPTY32
    rec = is_end & seg_valid
    n_unique = rec.sum()

    # a voxel segment of 2^16+ candidates <=> an equal valid voxel pair at
    # distance 65535 in sorted order (compare vox: the occ bit can split a
    # voxel across two skey values)
    if n > 0xFFFF:
        pack_fail = (
            (vox[0xFFFF:] == vox[:-0xFFFF]) & seg_valid[0xFFFF:]
        ).any()
    else:
        pack_fail = torch.zeros((), dtype=torch.bool, device=device)

    # records are distinct voxels, so the unstable sort fixes their order;
    # the EMPTY32 tail is masked below
    c_key, order = torch.sort(torch.where(rec, vox, EMPTY32))
    c_track = track[order]

    idx16 = c_track >> 16
    csum16 = c_track & 0xFFFF
    # record i's segment spans (end[i-1], end[i]]; record 0's virtual
    # predecessor is lane -1 (0xFFFF mod 2^16) with cumsum 0
    prev_idx = torch.cat([idx16.new_full((1,), 0xFFFF), idx16[:-1]])
    prev_csum = torch.cat([csum16.new_zeros(1), csum16[:-1]])
    c_count = (idx16 - prev_idx) & 0xFFFF
    c_occ = (csum16 - prev_csum) & 0xFFFF

    valid_u = lane < n_unique
    return CompactRecords(
        key=torch.where(valid_u, c_key, EMPTY32),
        payload=torch.where(valid_u, (c_count << 16) | c_occ, 0),
        n_unique=n_unique,
        pack_fail=pack_fail,
    )
