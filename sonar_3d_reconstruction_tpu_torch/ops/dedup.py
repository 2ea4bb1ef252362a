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

``dedup_frame`` and ``dedup_frame_compact`` take (..., N) rows: a (B, N)
batch of frames dedups row by row (every sort along the last axis, every
scan and neighbour compare inside a row), each frame bit-equal to its row
alone.  On the H100 one (16, N) sort along the last axis costs as much as
one flat sort with the frame folded above the key and under half of 16
row sorts (PERF.md), so the batch sorts its rows in place.

Without a budget the output keeps the full candidate width (valid records
first, empty lanes after), so nothing overflows; the count-sized window
engine slices it to the window's largest ``n_unique``.  With a
``unique_budget`` U every function returns exactly U lanes, as the JAX
package's do, and reads nothing to the host: the compaction takes only the
records whose segment ends within the first ``lane_budget`` sorted lanes
(default ``min(N, 2U)``, at least U), and a frame whose valid candidates
exceed that slice reports ``n_unique = N + 1``.  A frame with more than U
records sets ``overflowed`` on the device and its window is rejected;
its lanes still hold what the JAX package's hold, codes included, since
a window counts them (the grouped forms' lanes then differ from the JAX
package's, and their counts are not the JAX package's garbage).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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

    @property
    def overflowed(self) -> torch.Tensor:
        """More records than lanes: the frame's unique budget overflowed."""
        return self.n_unique > self.hi.shape[-1]


def running_max(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running maximum along dim 0: the segment rebase and rank
    primitive of the bucket insert and the window sorts."""
    return torch.cummax(x, dim=0).values


def _first_lane(x: torch.Tensor, value) -> torch.Tensor:
    """A (..., 1) column of ``value`` in ``x``'s dtype, to prepend along
    the last axis."""
    return torch.full(x.shape[:-1] + (1,), value, dtype=x.dtype,
                      device=x.device)


def _budget_slice(n: int, unique_budget: int, lane_budget: int) -> int:
    """The compaction slice of a budgeted dedup over N candidate lanes:
    ``lane_budget`` (``min(N, 2U)`` when 0), at least U, at most N."""
    if lane_budget <= 0:
        lane_budget = min(n, 2 * unique_budget)
    return min(n, max(lane_budget, unique_budget))


def _in_slice(rec, seg_valid, n_unique, unique_budget, lane_budget):
    """(records inside the compaction slice, n_unique with a slice
    overflow reported as N + 1); unchanged without a budget."""
    if unique_budget is None:
        return rec, n_unique
    n = rec.shape[-1]
    lb = _budget_slice(n, unique_budget, lane_budget)
    rec = rec & (torch.arange(n, device=rec.device) < lb)
    return rec, torch.where(seg_valid.sum(dim=-1) > lb, n + 1, n_unique)


def _fit(x: torch.Tensor, width: Optional[int], fill) -> torch.Tensor:
    """(..., N) lanes cut or padded with ``fill`` to ``width`` (None: as
    they are)."""
    n = x.shape[-1]
    if width is None or width == n:
        return x
    if width < n:
        return x[..., :width]
    pad = torch.full(x.shape[:-1] + (width - n,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=-1)


def _segment_ends(vox: torch.Tensor) -> torch.Tensor:
    """Lanes whose sorted voxel differs from the next lane's (the last lane
    of each row always ends a segment): compares within rows only."""
    differs = vox[..., 1:] != vox[..., :-1]
    return torch.cat([differs, _first_lane(differs, True)], dim=-1)


def code_sort_words(
    code: torch.Tensor, occ: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """The two-word dedup's (..., N) sort words: ``code << 1 | occ`` (61
    bits) on valid lanes, ``EMPTY64`` (which sorts last) on the others."""
    return torch.where(valid, (code << 1) | occ.to(torch.int64), EMPTY64)


def _dedup_codes(skey: torch.Tensor, unique_budget: Optional[int],
                 lane_budget: int):
    """The two-word dedup on (..., N) sort words (``code_sort_words``), row
    by row: (record codes in ascending order, count, n_occ, record lanes,
    n_unique, the sort's lane permutation, each record's segment-end lane
    in sorted order), each of width N (unused lanes after the records hold
    garbage the caller masks with the record lanes).  ``perm[end]`` is
    each record's input lane."""
    skey, perm = torch.sort(skey, dim=-1)

    vox = skey >> 1
    # invalid lanes sort past every record, so their sentinel's low bit
    # only reaches cumsum lanes beyond the last record
    csum_occ = torch.cumsum(skey & 1, dim=-1)
    seg_valid = skey != EMPTY64
    rec = _segment_ends(vox) & seg_valid
    rec, n_unique = _in_slice(rec, seg_valid, rec.sum(dim=-1), unique_budget,
                              lane_budget)

    if unique_budget is None:
        # records are distinct voxels, so the unstable sort fixes their
        # order, which is their end lanes' order; the sentinel tail is
        # masked below
        c_vox, end = torch.sort(torch.where(rec, vox, EMPTY64 >> 1), dim=-1)
        valid_u = c_vox != EMPTY64 >> 1
    else:
        # the JAX package's compaction: the slice's lanes by (not a record,
        # code), so an overflowed frame (n_unique = N + 1, every lane
        # live) carries the slice's other valid codes after its records,
        # as its window counts them there
        n = vox.shape[-1]
        lane = torch.arange(n, device=vox.device)
        lb = _budget_slice(n, unique_budget, lane_budget)
        sel = torch.where(lane < lb, ((~rec).to(torch.int64) << 61) | vox,
                          EMPTY64)
        c_key, end = torch.sort(sel, dim=-1)
        c_vox = c_key & ((1 << 61) - 1)
        valid_u = (lane < n_unique[..., None]) & (c_key < (1 << 62) - 1)
    c_csum = torch.gather(csum_occ, -1, end)
    prev_end = torch.cat([_first_lane(end, -1), end[..., :-1]], dim=-1)
    prev_csum = torch.cat([_first_lane(c_csum, 0), c_csum[..., :-1]], dim=-1)
    return (c_vox, end - prev_end, c_csum - prev_csum, valid_u, n_unique,
            perm, end)


def _unique_records(c_vox, count, n_occ, valid_u, n_unique, brick,
                    width) -> UniqueRecords:
    c_hi, c_lo = code_words(c_vox, brick)
    return UniqueRecords(
        hi=_fit(torch.where(valid_u, c_hi, EMPTY_HI), width, EMPTY_HI),
        lo=_fit(torch.where(valid_u, c_lo, EMPTY_HI), width, EMPTY_HI),
        count=_fit(torch.where(valid_u, count, 0), width, 0),
        n_occ=_fit(torch.where(valid_u, n_occ, 0), width, 0),
        n_unique=n_unique,
    )


def dedup_frame(
    hi: torch.Tensor,
    lo: torch.Tensor,
    occ: torch.Tensor,
    valid: torch.Tensor,
    brick: bool,
    unique_budget: Optional[int] = None,
    lane_budget: int = 0,
) -> UniqueRecords:
    """(..., N) two-word keys (brick codes when ``brick``, else voxel
    codes), occupied flags and emission mask -> UniqueRecords of width N
    (``unique_budget`` when given; module docstring), row by row (a (B, N)
    batch gives each frame's records bit for bit as its (N,) row alone).

    One sort of ``code << 1 | occ`` (61 bits; invalid lanes EMPTY64, last)
    groups each voxel's candidates; a second compacts the segment ends, in
    key order, whose lane indices and occupied cumsums give each record's
    count and n_occ as adjacent differences."""
    return dedup_code_words(
        code_sort_words(key_code(hi, lo, brick), occ, valid), brick,
        unique_budget, lane_budget)


def dedup_code_words(
    skey: torch.Tensor,
    brick: bool,
    unique_budget: Optional[int] = None,
    lane_budget: int = 0,
) -> UniqueRecords:
    """``dedup_frame`` from its (..., N) sort words (``code_sort_words``,
    or the same words from the records kernel, kernels/box_words.py), row
    by row."""
    c_vox, count, n_occ, valid_u, n_unique, _, _ = _dedup_codes(
        skey, unique_budget, lane_budget)
    return _unique_records(c_vox, count, n_occ, valid_u, n_unique, brick,
                           unique_budget)


def dedup_frame_grouped(
    hi: torch.Tensor,
    lo: torch.Tensor,
    occ: torch.Tensor,
    valid: torch.Tensor,
    group: torch.Tensor,
    n_groups: int,
    brick: bool,
    unique_budget: Optional[int] = None,
    lane_budget: int = 0,
) -> Tuple[UniqueRecords, torch.Tensor]:
    """``dedup_frame`` with records ordered by (group, key): returns
    (records, (N,) int64 group of each record, ``n_groups`` on unused
    lanes), every group's records contiguous; both ``unique_budget``
    lanes wide when it is given.

    ``group`` (N,) must be a pure function of the key.  Counts come from
    the key-ordered records, as in ``dedup_frame``; a stable sort on the
    record groups then moves whole records, so (group, key) order costs
    no change to the count arithmetic."""
    c_vox, count, n_occ, valid_u, n_unique, perm, end = _dedup_codes(
        code_sort_words(key_code(hi, lo, brick), occ, valid), unique_budget,
        lane_budget)
    rec_group = torch.where(valid_u, group.to(torch.int64)[perm[end]],
                            n_groups)
    rec_group, order = torch.sort(rec_group, stable=True)
    return _unique_records(
        c_vox[order], count[order], n_occ[order], valid_u, n_unique, brick,
        unique_budget,
    ), _fit(rec_group, unique_budget, n_groups)


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
    def count(self) -> torch.Tensor:
        return self.payload >> 16

    @property
    def n_occ(self) -> torch.Tensor:
        return self.payload & 0xFFFF

    @property
    def overflowed(self) -> torch.Tensor:
        """More records than lanes: the frame's unique budget overflowed."""
        return self.n_unique > self.key.shape[-1]


def dedup_frame_compact(
    key: torch.Tensor,
    occ: torch.Tensor,
    valid: torch.Tensor,
    unique_budget: Optional[int] = None,
    lane_budget: int = 0,
) -> CompactRecords:
    """(..., N) box keys (< 2^30), occupied flags and emission mask ->
    CompactRecords of width N (``unique_budget`` when given; module
    docstring), records in ascending key order, row by row: a (B, N) batch
    gives each frame's records, ``n_unique`` and ``pack_fail`` bit for bit
    as its (N,) row alone (the residue arithmetic and the pack_fail
    distance test stay inside a row)."""
    return dedup_compact_words(compact_sort_words(key, occ, valid),
                               unique_budget, lane_budget)


def compact_sort_words(
    key: torch.Tensor, occ: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """The compact dedup's (..., N) sort words: ``key << 1 | occ`` on valid
    lanes, ``EMPTY32`` (which sorts last) on the others."""
    return torch.where(valid, (key << 1) | occ.to(torch.int64), EMPTY32)


def dedup_compact_words(
    skey: torch.Tensor,
    unique_budget: Optional[int] = None,
    lane_budget: int = 0,
) -> CompactRecords:
    """``dedup_frame_compact`` from its (..., N) sort words
    (``compact_sort_words``, or the same words from the records kernel,
    kernels/box_words.py), row by row."""
    n = skey.shape[-1]
    skey = torch.sort(skey, dim=-1).values

    vox = skey >> 1
    # invalid lanes sort past every record, so their sentinel's low bit
    # only reaches cumsum lanes beyond the last record
    csum_occ = torch.cumsum(skey & 1, dim=-1)
    lane = torch.arange(n, device=skey.device)
    track = ((lane & 0xFFFF) << 16) | (csum_occ & 0xFFFF)

    seg_valid = skey != EMPTY32
    rec = _segment_ends(vox) & seg_valid
    rec, n_unique = _in_slice(rec, seg_valid, rec.sum(dim=-1), unique_budget,
                              lane_budget)

    # a voxel segment of 2^16+ candidates <=> an equal valid voxel pair at
    # distance 65535 in sorted order (compare vox: the occ bit can split a
    # voxel across two skey values)
    if n > 0xFFFF:
        pack_fail = (
            (vox[..., 0xFFFF:] == vox[..., :-0xFFFF]) & seg_valid[..., 0xFFFF:]
        ).any(dim=-1)
    else:
        pack_fail = torch.zeros(skey.shape[:-1], dtype=torch.bool,
                                device=skey.device)

    # records are distinct voxels, so the unstable sort fixes their order;
    # the EMPTY32 tail is masked below
    c_key, order = torch.sort(torch.where(rec, vox, EMPTY32), dim=-1)
    c_track = torch.gather(track, -1, order)

    idx16 = c_track >> 16
    csum16 = c_track & 0xFFFF
    # record i's segment spans (end[i-1], end[i]]; record 0's virtual
    # predecessor is lane -1 (0xFFFF mod 2^16) with cumsum 0
    prev_idx = torch.cat([_first_lane(idx16, 0xFFFF), idx16[..., :-1]], dim=-1)
    prev_csum = torch.cat([_first_lane(csum16, 0), csum16[..., :-1]], dim=-1)
    c_count = (idx16 - prev_idx) & 0xFFFF
    c_occ = (csum16 - prev_csum) & 0xFFFF

    valid_u = c_key != EMPTY32
    return CompactRecords(
        key=_fit(c_key, unique_budget, EMPTY32),
        payload=_fit(torch.where(valid_u, (c_count << 16) | c_occ, 0),
                     unique_budget, 0),
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
    unique_budget: Optional[int] = None,
    lane_budget: int = 0,
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
    rec = dedup_frame_compact(comb, occ, valid, unique_budget, lane_budget)
    valid_u = rec.valid
    return rec._replace(
        key=torch.where(valid_u, rec.key & ((1 << key_bits) - 1), EMPTY32),
    ), torch.where(valid_u, rec.key >> key_bits, n_groups)
