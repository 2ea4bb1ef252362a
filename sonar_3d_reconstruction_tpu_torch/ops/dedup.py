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

The grouped forms (``dedup_frame_grouped``, ``dedup_frame_compact_grouped``)
order records by (group, key) instead of key, so each group's records are
contiguous: the shape the frame-parallel exchange cuts into per-owner
blocks (parallel/shard_frames.py).  The group must be a pure function of
the voxel key (the brick's owner shard), so equal voxels stay in one
segment.

The JAX functions truncate records to a static unique budget.  Here the
output keeps the full candidate width (valid records first, empty lanes
after), so there is no budget and no overflow; the window engine slices it
to the window's largest ``n_unique``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

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


def running_max(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running maximum along dim 0: the segment rebase and rank
    primitive of the bucket insert and the window sorts."""
    return torch.cummax(x, dim=0).values


def _dedup_codes(code: torch.Tensor, occ: torch.Tensor, valid: torch.Tensor):
    """The two-word dedup on (N,) 60-bit codes: (record codes in ascending
    order, count, n_occ, valid lanes, n_unique, the sort's lane
    permutation, each record's segment-end lane in sorted order), each of
    width N (unused lanes after the records hold garbage the caller masks
    with the valid lanes).  ``perm[end]`` is each record's input lane."""
    n = code.shape[0]
    device = code.device
    skey = torch.where(valid, (code << 1) | occ.to(torch.int64), EMPTY64)
    skey, perm = torch.sort(skey)

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
    return (c_vox, end - prev_end, c_csum - prev_csum, valid_u, n_unique,
            perm, end)


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
    c_vox, count, n_occ, valid_u, n_unique, _, _ = _dedup_codes(
        key_code(hi, lo, brick), occ, valid)
    c_hi, c_lo = code_words(c_vox, brick)
    return UniqueRecords(
        hi=torch.where(valid_u, c_hi, EMPTY_HI),
        lo=torch.where(valid_u, c_lo, EMPTY_HI),
        count=torch.where(valid_u, count, 0),
        n_occ=torch.where(valid_u, n_occ, 0),
        n_unique=n_unique,
    )


def dedup_frame_grouped(
    hi: torch.Tensor,
    lo: torch.Tensor,
    occ: torch.Tensor,
    valid: torch.Tensor,
    group: torch.Tensor,
    n_groups: int,
    brick: bool,
) -> Tuple[UniqueRecords, torch.Tensor]:
    """``dedup_frame`` with records ordered by (group, key): returns
    (records, (N,) int64 group of each record, ``n_groups`` on unused
    lanes), every group's records contiguous.

    ``group`` (N,) must be a pure function of the key.  Counts come from
    the key-ordered records, as in ``dedup_frame``; a stable sort on the
    record groups then moves whole records, so (group, key) order costs
    no change to the count arithmetic."""
    c_vox, count, n_occ, valid_u, n_unique, perm, end = _dedup_codes(
        key_code(hi, lo, brick), occ, valid)
    rec_group = torch.where(valid_u, group.to(torch.int64)[perm[end]],
                            n_groups)
    rec_group, order = torch.sort(rec_group, stable=True)
    c_hi, c_lo = code_words(c_vox[order], brick)
    return UniqueRecords(
        hi=torch.where(valid_u, c_hi, EMPTY_HI),
        lo=torch.where(valid_u, c_lo, EMPTY_HI),
        count=torch.where(valid_u, count[order], 0),
        n_occ=torch.where(valid_u, n_occ[order], 0),
        n_unique=n_unique,
    ), rec_group


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


def dedup_frame_compact_grouped(
    key: torch.Tensor,
    occ: torch.Tensor,
    valid: torch.Tensor,
    group: torch.Tensor,
    n_groups: int,
    key_bits: int,
) -> Tuple[CompactRecords, torch.Tensor]:
    """``dedup_frame_compact`` with records ordered by (group, key): returns
    (records, (N,) int64 group of each record, ``n_groups`` on unused
    lanes), every group's records contiguous.

    The group folds into the sort word above the key: ``comb = group <<
    key_bits | key`` is itself a compact key (the group is a pure function
    of the key, so comb segments are key segments) and its order is (group,
    key), so this is ``dedup_frame_compact`` on ``comb`` with the two split
    back out.  ``key`` must be below 2^key_bits, and ``ceil(log2
    n_groups) + key_bits + 1 <= 31`` (ValueError otherwise), the compact
    dedup's own key width on comb."""
    gbits = max(1, (max(n_groups - 1, 1)).bit_length())
    if gbits + key_bits + 1 > 31:
        raise ValueError(f"{n_groups} groups and {key_bits} key bits exceed "
                         f"the compact dedup's 30-bit key")
    comb = (group.to(torch.int64) << key_bits) | key
    rec = dedup_frame_compact(comb, occ, valid)
    valid_u = rec.valid
    return rec._replace(
        key=torch.where(valid_u, rec.key & ((1 << key_bits) - 1), EMPTY32),
    ), torch.where(valid_u, rec.key >> key_bits, n_groups)
