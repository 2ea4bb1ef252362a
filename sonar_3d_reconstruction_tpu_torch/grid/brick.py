"""Brick grid — sparse hash of dense voxel bricks (PyTorch port of
``sonar_3d_reconstruction_tpu.grid.brick``: the compact box-key window
apply and the wide two-word one).

The hash table (grid/hash.py) is keyed by 4x4x4 voxel bricks and each
entry holds a dense (brick_volume,) log-odds row, so one row gather or
scatter moves a whole brick.  A window of B frames applies at once:

  1. per-frame unique records (ops/dedup.py) are flattened with the frame
     index folded between brick and offset, and one sort orders the
     window's lanes (brick, frame, offset);
  2. the distinct bricks are compacted with the start of each brick's
     record range, translated from box ids to global brick codes, looked
     up and inserted in the table;
  3. the binning kernel K1 (kernels/bin_apply.py) bins each brick's
     records and runs the reference's sequential per-frame adaptive update
     over the brick's value row;
  4. rows, touched bits, bounds and stats are written back.

``dense_mode`` picks the records the window takes: ``"pallas"`` (the
default) takes per-frame unique records; ``"pallas-raw"`` takes raw
candidates (``frame_records(raw=True)``), which K1's raw form sums per
(brick, frame, offset) slot into the same aggregates, so both modes give
the same map.  In raw mode the per-frame unique-voxel stats come from the
kernel and ``batch_n_lanes`` counts candidate lanes.  Every spelling of
the JAX package is accepted (``parse_dense_mode``): its XLA layouts
``"scalar"``, ``"bfv"`` and ``"row"`` are bit-identical to ``"pallas"``
there, so here they all run K1 on unique records, and a spelling with
``raw`` runs K1's raw form; the ``-tbN`` / ``-cN`` suffixes that size the
TPU kernel's tiles are checked and recorded, while K1's tile comes from
``kernels.bin_apply.tile_bricks`` (shared memory).

A window too wide for compact keys takes two-word brick codes
(``apply_brick_records_wide``, unique records only): step 1 ranks the
window's distinct bricks in code order, and the (rank, frame, offset) key
then feeds the same steps 2-4 and K1.

A ``touched`` bitmask per brick keeps the reference's touched-voxel
semantics: a never-updated voxel (p = 0.5, not reported) differs from an
updated voxel whose log-odds is 0.0.

Without budgets a window is sized from its actual counts, which it reads
to the host (a few reads a window), and a failed window (a bucket would
overflow, or the fatal key-range and count-packing errors) is skipped on
the host, leaving the table untouched and the state poisoned.  With the
JAX package's budgets (``brick_budget``, ``lane_budget``,
``insert_budget``, ``vox_budget``) a window runs at those fixed widths and
reads nothing: padded bricks carry ``EMPTY_HI`` keys and empty K1 ranges,
every overflow is a device flag under the JAX package's stat names
(``unique_overflow``, ``batch_overflow``, ``insert_overflow``), and a
failed window drops its writes on the device and poisons the state, so
later windows are no-ops until the host reads the flags, grows the right
budget or the table, and replays.  Both give the same map.  A budgeted
window may stop before its writes (``commit=False``) and hand back a
``grid.hash.PendingUpdate``, which ``grid.hash.commit_update`` writes or
drops by a flag: the sharded engines commit every shard's window by the
OR of all their flags.  Table updates are out of place: each window
returns new tensors and never writes into the state it was given.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.grid.hash import (
    BUCKET_SLOTS,
    PendingUpdate,
    _fresh_plan,
    bucket_lookup,
    commit_insert,
    commit_update,
    empty_key_rows,
    plan_fresh_insert,
    plan_insert,
)
from sonar_3d_reconstruction_tpu_torch.kernels.bin_apply import (
    bin_apply,
    bin_apply_raw,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import (
    CompactRecords,
    UniqueRecords,
)
from sonar_3d_reconstruction_tpu_torch.ops.logodds import probability_to_log_odds
from sonar_3d_reconstruction_tpu_torch.ops.packing import (
    EMPTY32,
    EMPTY64,
    EMPTY_HI,
    U32,
    code_words,
    key_code,
    pack_brick_keys,
    unpack_box_brick,
    unpack_brick_keys,
)
from sonar_3d_reconstruction_tpu_torch.ops.records import FrameAux

DEFAULT_BRICK_BITS = 2  # 4x4x4 = 64 voxels per brick

_BRICK_BITS_BY_VOLUME = {8: 1, 64: 2, 512: 3}

# the JAX package's window apply modes: three XLA layouts and the Pallas
# kernel (K1 here), unique records, or raw candidates summed by K1
DENSE_MODES = ("scalar", "bfv", "row", "pallas", "pallas-raw")


class DenseMode(NamedTuple):
    """A parsed ``dense_mode`` spelling."""

    layout: str              # "scalar", "bfv", "row" or "pallas"
    raw: bool                # raw candidates (K1's raw form)
    tile: Optional[int]      # the TPU kernel's -tbN (recorded, unused)
    chunk: Optional[int]     # the TPU kernel's -cN (recorded, unused)


def parse_dense_mode(dense_mode: str) -> DenseMode:
    """Parse a JAX ``dense_mode`` spelling: one of ``DENSE_MODES``, where
    the ``"pallas"`` forms may carry the JAX package's ``-raw``, ``-tbN``
    and ``-cN`` parts in any order (N a positive int), as its window
    apply parses them.  ValueError on any other string."""
    layout, *parts = str(dense_mode).split("-")
    raw, tile, chunk, ok = False, None, None, layout in DENSE_MODES

    def count(text):
        return int(text) if text.isdigit() and int(text) > 0 else None

    for part in parts:
        if layout != "pallas":
            ok = False
        elif part == "raw" and not raw:
            raw = True
        elif part.startswith("tb") and tile is None and count(part[2:]):
            tile = count(part[2:])
        elif part.startswith("c") and chunk is None and count(part[1:]):
            chunk = count(part[1:])
        else:
            ok = False
    if not ok:
        raise ValueError(
            f"dense_mode {dense_mode!r} is not accepted; use one of "
            f"{DENSE_MODES} (the pallas forms may add -tbN / -cN)"
        )
    return DenseMode(layout, raw, tile, chunk)


def is_raw_mode(dense_mode: str) -> bool:
    """Whether ``dense_mode`` takes raw candidates (K1's raw form); raises
    ValueError on a spelling the JAX package does not accept."""
    return parse_dense_mode(dense_mode).raw


def default_brick_budget(window: int, unique_budget: int) -> int:
    """The JAX package's default distinct-brick budget of a window: at
    least 4 voxels a brick, the window factor capped at 8, at least
    8192."""
    return max(8192, (min(window, 8) * unique_budget) // 6)


class BrickGridState(NamedTuple):
    """Map state.  u32 words are held in int64 (ops/packing.py)."""

    key_rows: torch.Tensor    # (Cb/128, 256) brick codes (offset bits zero)
    log_odds: torch.Tensor    # (Cb, brick_volume) dtype
    touched: torch.Tensor     # (Cb, ceil(volume/32)) voxel bitmask words
    min_bounds: torch.Tensor  # (3,)
    max_bounds: torch.Tensor  # (3,)
    used: torch.Tensor        # () int64 touched VOXEL count
    poisoned: torch.Tensor    # () bool: a window failed

    @property
    def capacity(self) -> int:
        """Brick capacity (slots in the key table)."""
        return self.key_rows.shape[0] * BUCKET_SLOTS

    @property
    def brick_volume(self) -> int:
        return self.log_odds.shape[1]

    @property
    def brick_bits(self) -> int:
        return _BRICK_BITS_BY_VOLUME[self.brick_volume]

    @property
    def key_hi(self) -> torch.Tensor:
        return self.key_rows[:, :BUCKET_SLOTS].reshape(-1)

    @property
    def key_lo(self) -> torch.Tensor:
        return self.key_rows[:, BUCKET_SLOTS:].reshape(-1)


def init_brick_grid(
    capacity: int,
    dtype: torch.dtype,
    device,
    brick_bits: int = DEFAULT_BRICK_BITS,
) -> BrickGridState:
    vol = 1 << (3 * brick_bits)
    words = max(1, vol // 32)
    inf = float("inf")
    return BrickGridState(
        key_rows=empty_key_rows(capacity, device),
        log_odds=torch.zeros((capacity, vol), dtype=dtype, device=device),
        touched=torch.zeros((capacity, words), dtype=torch.int64, device=device),
        min_bounds=torch.full((3,), inf, dtype=dtype, device=device),
        max_bounds=torch.full((3,), -inf, dtype=dtype, device=device),
        used=torch.zeros((), dtype=torch.int64, device=device),
        poisoned=torch.zeros((), dtype=torch.bool, device=device),
    )


def _pack_touched(mask: torch.Tensor) -> torch.Tensor:
    """(N, volume) bool -> (N, words) bitmask (bit v%32 of word v/32)."""
    n, vol = mask.shape
    words = max(1, vol // 32)
    per = min(32, vol)
    m = mask.reshape(n, words, per).to(torch.int64)
    weights = 1 << torch.arange(per, device=mask.device)
    return (m * weights).sum(dim=2)


def _unpack_touched(touched: torch.Tensor, vol: int) -> torch.Tensor:
    """(N, words) bitmask -> (N, volume) bool."""
    n, words = touched.shape
    per = min(32, vol)
    bits = (touched[:, :, None] >> torch.arange(per, device=touched.device)) & 1
    return bits.to(torch.bool).reshape(n, words * per)[:, :vol]


def apply_brick_records_compact(
    state: BrickGridState,
    recs: CompactRecords,   # stacked over B frames: key/payload (B, U)
    auxs: FrameAux,         # stacked over B frames
    cfg: MapperConfig,
    box_min,                # (3,) brick-aligned box-origin voxel key
    box_bits: Tuple[int, int, int],
    dense_mode: str = "pallas",
    brick_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget: Optional[int] = None,
    vox_budget: Optional[int] = None,
    commit: bool = True,
) -> Tuple[BrickGridState, Dict[str, torch.Tensor]]:
    """Apply one window of B frames of box-key records to the brick map.

    ``recs`` are unique records, or raw candidates when ``dense_mode`` is
    a raw spelling.  Returns (new state, per-frame stats of shape (B,)):
    ``num_occupied`` and ``num_free`` (unique voxels by type),
    ``num_candidates`` (valid emissions), ``overflowed``, ``range_fail``,
    ``pack_overflow``, and the window's ``batch_n_bricks`` /
    ``batch_n_lanes`` (record lanes; candidate lanes in raw mode) sizes.

    Any of the budgets runs the fixed-width window (module docstring):
    ``brick_budget`` NB rows (default ``default_brick_budget(B, U)``),
    ``lane_budget`` L record lanes (default all B * U), ``insert_budget``
    new bricks (default NB), and ``vox_budget`` distinct voxels, which only
    the JAX package's ``"row"`` layout bounds (default L).  ``box_min`` may
    then be a (3,) device tensor, so nothing is read to the host.  The
    stats gain ``unique_overflow``, ``batch_overflow``, ``insert_overflow``,
    ``batch_n_unique`` and ``batch_n_need``, as in the JAX package.
    ``commit=False`` (budgets only) returns the window's
    ``grid.hash.PendingUpdate`` instead, for ``grid.hash.commit_update``.
    """
    mode = parse_dense_mode(dense_mode)
    raw = mode.raw
    B, U = recs.key.shape
    bb = state.brick_bits
    o = 3 * bb
    f_bits = max(1, (B - 1).bit_length())
    if sum(box_bits) + o + f_bits > 31:
        raise ValueError(f"box bits {box_bits} + {B} frames exceed 31 key bits")
    device = state.log_odds.device
    box_min = (box_min if isinstance(box_min, torch.Tensor)
               else torch.as_tensor(np.asarray(box_min))).to(device)
    budgeted = (brick_budget, lane_budget, insert_budget,
                vox_budget) != (None,) * 4
    _check_commit(budgeted, commit)

    # (brick, FRAME, offset) flat key: the frame field sits between brick
    # and offset, so one sort groups each brick's records by frame
    key = recs.key.reshape(-1)
    frame = torch.arange(B, device=device).repeat_interleave(U)
    flat = torch.where(
        key != EMPTY32,
        ((key >> o) << (o + f_bits)) | (frame << o) | (key & ((1 << o) - 1)),
        EMPTY32,
    )
    # unique records have one key per (voxel, frame), raw candidates may
    # repeat it; either way the unstable order among equal keys does not
    # matter: K1 sums raw records in integers, and EMPTY32 lanes carry
    # payload 0
    s_flat, order = torch.sort(flat)
    s_pay = recs.payload.reshape(-1)[order]
    seg_valid = s_flat != EMPTY32
    brick_id = s_flat >> (f_bits + o)
    new_brick = torch.cat([
        torch.ones(1, dtype=torch.bool, device=device),
        brick_id[1:] != brick_id[:-1],
    ])
    # raw candidates carry count 1 each and are summed unpacked: no packing
    # width to overflow
    pack_overflow = (torch.zeros((), dtype=torch.bool, device=device) if raw
                     else recs.pack_fail.any())
    if budgeted:
        nb = brick_budget or default_brick_budget(B, U)
        lb = min(B * U, max(lane_budget or B * U, 1))
        n_lanes = seg_valid.sum()
        n_bricks = (new_brick & seg_valid).sum()
        is_start = (new_brick & seg_valid)[:lb]
        starts, c_bid, valid_b = _compact_starts(
            is_start, brick_id[:lb], n_bricks, torch.clamp(n_lanes, max=lb),
            nb, EMPTY32,
        )
        corner = unpack_box_brick(torch.where(valid_b, c_bid, 0), box_min,
                                  box_bits, bb)
        g_hi, g_lo, g_ok = pack_brick_keys(corner, bb)
        auxs = auxs._replace(
            range_fail=auxs.range_fail | (valid_b & ~g_ok).any())
        pending = _prepare_window_budgeted(
            state, cfg, torch.where(valid_b, g_hi, EMPTY_HI),
            torch.where(valid_b, g_lo, EMPTY_HI), valid_b, s_flat[:lb],
            s_pay[:lb], starts, B=B, f_bits=f_bits, o=o, raw=raw,
            pack_overflow=pack_overflow,
            frame_overflow=(recs.n_unique > U).any(),
            lanes_overflow=n_lanes > lb, brick_overflow=n_bricks > nb,
            rec_valid=recs.valid, rec_n_occ=recs.n_occ, auxs=auxs,
            n_lanes=n_lanes, n_bricks=n_bricks, insert_budget=insert_budget,
            vox_cap=(min(lb, max(vox_budget or lb, 1))
                     if mode.layout == "row" else None),
        )
        return commit_update(pending) if commit else pending
    n_lanes, n_bricks = torch.stack(
        [seg_valid.sum(), (new_brick & seg_valid).sum()]
    ).tolist()

    # valid lanes are a sorted prefix; brick i's records are
    # [starts[i], starts[i+1])
    s_flat, s_pay = s_flat[:n_lanes], s_pay[:n_lanes]
    first = torch.nonzero(new_brick[:n_lanes]).squeeze(1)
    starts = torch.cat([first, first.new_full((1,), n_lanes)])

    # compacted box brick ids -> global brick codes; the host gate keeps
    # every box inside the packable range, so a failure here is an engine
    # fault reported as range_fail
    corner = unpack_box_brick(brick_id[first], box_min, box_bits, bb)
    c_hi, c_lo, g_ok = pack_brick_keys(corner, bb)
    auxs = auxs._replace(range_fail=auxs.range_fail | (~g_ok).any())
    return _apply_window_tail(
        state, cfg, c_hi, c_lo, s_flat, s_pay, starts,
        B=B, f_bits=f_bits, o=o, raw=raw, pack_overflow=pack_overflow,
        rec_valid=recs.valid, rec_n_occ=recs.n_occ, auxs=auxs,
        n_lanes=n_lanes, n_bricks=n_bricks,
    )


def _check_commit(budgeted: bool, commit: bool) -> None:
    if not (budgeted or commit):
        raise ValueError("commit=False needs a budget: a count-sized window "
                         "commits as it goes")


def _compact_starts(is_start, brick_id, n_bricks, n_val, nb, empty):
    """The fixed-width brick list of a budgeted window: (starts (NB+1,),
    brick ids (NB,), valid rows (NB,)).  ``is_start`` marks the first lane
    of each brick in the sorted lane prefix, ``brick_id`` each lane's
    brick; the starts move to the front in lane order by a cumsum scatter
    (no host read), and the rows past the window's bricks get empty
    ranges at ``n_val``, the valid lanes inside the prefix."""
    device = is_start.device
    lane = torch.arange(is_start.shape[0], device=device)
    rank = torch.cumsum(is_start, dim=0) - 1
    tgt = torch.where(is_start & (rank < nb), rank, nb)
    pos = torch.zeros(nb + 1, dtype=torch.int64, device=device)
    pos[tgt] = lane
    bid = torch.full((nb + 1,), empty, dtype=torch.int64, device=device)
    bid[tgt] = brick_id
    bid = bid[:nb]
    valid_b = (torch.arange(nb, device=device) < n_bricks) & (bid != empty)
    starts = torch.cat([torch.where(valid_b, pos[:nb], n_val), n_val[None]])
    return starts, bid, valid_b


def apply_brick_records_wide(
    state: BrickGridState,
    recs: UniqueRecords,    # stacked over B frames: (B, U), brick codes
    auxs: FrameAux,         # stacked over B frames
    cfg: MapperConfig,
    brick_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget: Optional[int] = None,
    vox_budget: Optional[int] = None,
    commit: bool = True,
) -> Tuple[BrickGridState, Dict[str, torch.Tensor]]:
    """Apply one window of B frames of two-word unique records (brick
    codes, ``frame_records`` without a box) to the brick map: the path of
    a window too wide for compact keys.  Same stats, budgets, failure
    contract, ``commit`` and map as ``apply_brick_records_compact``
    (``vox_budget`` is accepted and bounds nothing: the JAX package's wide
    window has no row layout).

    The records reach K1 in its documented (brick, frame, offset) order:
    each lane takes its brick's rank among the window's distinct bricks in
    code order (the order of the JAX package's compaction, so new bricks
    take the same slots), and one sort of ``rank << (f_bits + o) | frame
    << o | offset`` orders the lanes.  K1 reads only the frame and offset
    fields of a key's low word, and the brick of a lane from ``starts``.
    Count-sized, ``torch.unique`` ranks the bricks (it reads their count to
    the host); with budgets a sort, a cumsum and a scatter do, with no
    read, and the first NB distinct bricks fill the brick rows.
    """
    B, U = recs.hi.shape
    bb = state.brick_bits
    o = 3 * bb
    f_bits = max(1, (B - 1).bit_length())
    device = state.log_odds.device
    budgeted = (brick_budget, lane_budget, insert_budget,
                vox_budget) != (None,) * 4
    _check_commit(budgeted, commit)

    valid = recs.valid.reshape(-1)
    code = key_code(recs.hi.reshape(-1), recs.lo.reshape(-1), brick=True)
    bcode = torch.where(valid, code >> o, EMPTY64)
    if budgeted:
        nb = brick_budget or default_brick_budget(B, U)
        uniq, rank, n_bricks = _rank_bricks(bcode, nb)
    else:
        uniq, rank = torch.unique(bcode, return_inverse=True)
    frame = torch.arange(B, device=device).repeat_interleave(U)
    # invalid lanes share the sentinel's rank, the last one
    flat = (rank << (f_bits + o)) | (frame << o) | (code & ((1 << o) - 1))
    s_flat, order = torch.sort(flat)
    count = recs.count.reshape(-1)
    payload = torch.where(valid, (count << 16) | recs.n_occ.reshape(-1), 0)
    if budgeted:
        lb = min(B * U, max(lane_budget or B * U, 1))
        n_lanes = valid.sum()
        n_val = torch.clamp(n_lanes, max=lb)
        valid_b = torch.arange(nb, device=device) < n_bricks
        starts = torch.minimum(torch.searchsorted(
            s_flat[:lb] >> (f_bits + o), torch.arange(nb + 1, device=device)
        ), n_val)
        c_hi, c_lo = code_words(uniq << o, brick=True)
        # the payload packs count in 16 bits: a voxel with 2^16+ candidates
        # in one frame is fatal, except in a frame that overflowed its
        # unique budget (its lanes mean nothing), as in the JAX package
        frame_ok = (recs.n_unique <= U).repeat_interleave(U)
        # the window's distinct voxels over every valid lane, as the JAX
        # package's two-word window counts them (exact under a brick
        # overflow too, where the rows' touched bits miss some)
        vox = torch.sort(torch.where(valid, code, EMPTY64)).values
        n_unique = (torch.cat([vox[:1] != EMPTY64, vox[1:] != vox[:-1]])
                    & (vox != EMPTY64)).sum()
        pending = _prepare_window_budgeted(
            state, cfg, torch.where(valid_b, c_hi, EMPTY_HI),
            torch.where(valid_b, c_lo, EMPTY_HI), valid_b, s_flat[:lb],
            payload[order[:lb]], starts, B=B, f_bits=f_bits, o=o, raw=False,
            pack_overflow=(frame_ok & valid & (count > 0xFFFF)).any(),
            frame_overflow=(recs.n_unique > U).any(),
            lanes_overflow=n_lanes > lb, brick_overflow=n_bricks > nb,
            rec_valid=recs.valid, rec_n_occ=recs.n_occ, auxs=auxs,
            n_lanes=n_lanes, n_bricks=n_bricks, insert_budget=insert_budget,
            vox_cap=None, n_unique=n_unique,
        )
        return commit_update(pending) if commit else pending
    # the payload packs count in 16 bits: a voxel with 2^16+ candidates in
    # one frame is fatal, as in the JAX package
    pack_overflow = (valid & (count > 0xFFFF)).any()
    n_lanes, n_bricks = torch.stack(
        [valid.sum(), (uniq != EMPTY64).sum()]
    ).tolist()

    # valid lanes are a sorted prefix; brick i's records are
    # [starts[i], starts[i+1])
    s_flat = s_flat[:n_lanes]
    s_pay = payload[order[:n_lanes]]
    starts = torch.searchsorted(
        s_flat >> (f_bits + o), torch.arange(n_bricks + 1, device=device)
    )
    c_hi, c_lo = code_words(uniq[:n_bricks] << o, brick=True)
    return _apply_window_tail(
        state, cfg, c_hi, c_lo, s_flat, s_pay, starts,
        B=B, f_bits=f_bits, o=o, raw=False, pack_overflow=pack_overflow,
        rec_valid=recs.valid, rec_n_occ=recs.n_occ, auxs=auxs,
        n_lanes=n_lanes, n_bricks=n_bricks,
    )


def _rank_bricks(bcode: torch.Tensor, nb: int):
    """``torch.unique(bcode, return_inverse=True)`` with no host read, for a
    budgeted window: ((NB,) the first NB distinct brick codes in ascending
    order, ``EMPTY64`` past them, (N,) each lane's rank among the distinct
    codes, the sentinel ``EMPTY64`` (invalid lanes) ranked last, () the
    valid distinct bricks)."""
    n = bcode.shape[0]
    device = bcode.device
    s_code, order = torch.sort(bcode)
    new = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                     s_code[1:] != s_code[:-1]])
    s_rank = torch.cumsum(new, dim=0) - 1
    rank = torch.empty(n, dtype=torch.int64, device=device)
    rank[order] = s_rank
    first = new & (s_code != EMPTY64)
    uniq = torch.full((nb + 1,), EMPTY64, dtype=torch.int64, device=device)
    uniq[torch.where(first & (s_rank < nb), s_rank, nb)] = s_code
    return uniq[:nb], rank, first.sum()


def _apply_window_tail(
    state: BrickGridState,
    cfg: MapperConfig,
    c_hi, c_lo, s_flat, s_pay, starts,
    *,
    B, f_bits, o, raw, pack_overflow, rec_valid, rec_n_occ, auxs, n_lanes,
    n_bricks,
) -> Tuple[BrickGridState, Dict[str, torch.Tensor]]:
    """Table lookup/insert at the window's bricks, K1, commit and stats."""
    vol = state.brick_volume
    dtype, device = state.log_odds.dtype, state.log_odds.device

    bucket, found, found_slot, fill = bucket_lookup(state.key_rows, c_hi, c_lo)
    plan = plan_insert(state.key_rows, c_hi, c_lo, ~found, bucket, fill)
    flags = torch.stack([
        plan.overflowed, auxs.range_fail.any(), pack_overflow, state.poisoned
    ]).tolist()
    failed = any(flags)

    def per_frame(x):
        return torch.full((B,), x, device=device)

    stats = {
        "range_fail": auxs.range_fail,
        "pack_overflow": per_frame(flags[2]),
        "overflowed": per_frame(failed),
        "batch_n_bricks": per_frame(n_bricks),
        "batch_n_lanes": per_frame(n_lanes),
    }
    if failed:
        zero = per_frame(0)
        stats.update(num_occupied=zero, num_free=zero, num_candidates=zero)
        return state._replace(poisoned=torch.ones_like(state.poisoned)), stats

    key_rows = commit_insert(state.key_rows, plan)
    slots = torch.where(found, found_slot, plan.slots)
    # new bricks' rows read 0, the reference's never-seen log-odds (rows
    # are never removed, so a free slot still holds zeros)
    rows_cur = state.log_odds[slots]
    touched_cur = state.touched[slots]

    kw = dict(B=B, vol=vol, f_bits=f_bits, o=o, cfg=cfg)
    if raw:
        # the records count candidates: the per-frame unique-voxel stats
        # come from the kernel
        v, upd, num_occupied, num_free = bin_apply_raw(
            s_flat, s_pay, starts, rows_cur, **kw
        )
    else:
        v, upd = bin_apply(s_flat, s_pay, starts, rows_cur, **kw)
        rec_occ = rec_valid & (rec_n_occ > 0)
        num_occupied = rec_occ.sum(dim=1)
        num_free = (rec_valid & ~rec_occ).sum(dim=1)
    n_new = (upd & ~_unpack_touched(touched_cur, vol)).sum()
    new_state = BrickGridState(
        key_rows=key_rows,
        log_odds=state.log_odds.index_copy(0, slots, v),
        touched=state.touched.index_copy(
            0, slots, touched_cur | _pack_touched(upd)
        ),
        min_bounds=torch.minimum(state.min_bounds, auxs.cmin.amin(dim=0).to(dtype)),
        max_bounds=torch.maximum(state.max_bounds, auxs.cmax.amax(dim=0).to(dtype)),
        used=state.used + n_new,
        poisoned=state.poisoned,
    )
    stats.update(
        num_occupied=num_occupied,
        num_free=num_free,
        num_candidates=auxs.n_valid,
    )
    return new_state, stats


def _prepare_window_budgeted(
    state: BrickGridState,
    cfg: MapperConfig,
    c_hi, c_lo, valid_b, s_flat, s_pay, starts,
    *,
    B, f_bits, o, raw, pack_overflow, frame_overflow, lanes_overflow,
    brick_overflow, rec_valid, rec_n_occ, auxs, n_lanes, n_bricks,
    insert_budget, vox_cap, n_unique=None,
) -> PendingUpdate:
    """``_apply_window_tail`` at fixed widths with no host read, up to its
    writes: table ops at the NB brick rows (padded rows, ``valid_b``
    false, are neither inserted nor written), K1 over the L record lanes,
    and the failure flag of every cause, as in the JAX package; the commit
    (``grid.hash.commit_update``) turns a failure into dropped writes.
    ``vox_cap`` bounds the window's distinct voxels (the JAX ``"row"``
    layout's budget; None: unbounded).  ``n_unique``, the window's
    distinct voxels, defaults to the rows' touched bits, as the JAX
    package's box-key window counts them (short under a brick
    overflow)."""
    vol = state.brick_volume
    cap = state.capacity

    bucket, found, found_slot, fill = bucket_lookup(state.key_rows, c_hi, c_lo)
    plan = plan_insert(state.key_rows, c_hi, c_lo, valid_b & ~found, bucket,
                       fill, budget=insert_budget)
    slots = torch.where(valid_b, torch.where(found, found_slot, plan.slots),
                        cap)
    # padded and unplaced rows read the last slot; their K1 ranges are
    # empty or the window fails, and their writes are dropped
    slots_c = torch.clamp(slots, max=cap - 1)
    rows_cur = state.log_odds[slots_c]
    touched_cur = state.touched[slots_c]

    kw = dict(B=B, vol=vol, f_bits=f_bits, o=o, cfg=cfg)
    if raw:
        v, upd, num_occupied, num_free = bin_apply_raw(
            s_flat, s_pay, starts, rows_cur, **kw
        )
    else:
        v, upd = bin_apply(s_flat, s_pay, starts, rows_cur, **kw)
        rec_occ = rec_valid & (rec_n_occ > 0)
        num_occupied = rec_occ.sum(dim=1)
        num_free = (rec_valid & ~rec_occ).sum(dim=1)
    upd = upd & valid_b[:, None]
    if n_unique is None:
        n_unique = upd.sum()
    batch_overflow = brick_overflow | lanes_overflow
    if vox_cap is not None:
        batch_overflow = batch_overflow | (n_unique > vox_cap)
    failed = (batch_overflow | plan.overflowed | auxs.range_fail.any()
              | frame_overflow | pack_overflow | state.poisoned)

    def per_frame(x):
        return x.expand(B)

    return PendingUpdate(
        state=state, plan=plan, slots=slots, values=v,
        touched=touched_cur | _pack_touched(upd),
        n_new=(upd & ~_unpack_touched(touched_cur, vol)).sum(), auxs=auxs,
        failed=failed,
        stats={
            "num_occupied": num_occupied,
            "num_free": num_free,
            "num_candidates": auxs.n_valid,
            "overflowed": per_frame(failed),
            "unique_overflow": per_frame(frame_overflow),
            "batch_overflow": per_frame(batch_overflow),
            "insert_overflow": per_frame(plan.budget_overflow),
            "batch_n_unique": per_frame(n_unique),
            "batch_n_bricks": per_frame(n_bricks),
            "batch_n_lanes": per_frame(n_lanes),
            "batch_n_need": per_frame(plan.n_need),
            "pack_overflow": per_frame(pack_overflow),
            "range_fail": auxs.range_fail,
        },
    )


def rehash_bricks_once(
    state: BrickGridState, new_capacity: int
) -> Tuple[BrickGridState, torch.Tensor]:
    """The table re-built at ``new_capacity`` bricks (``poisoned``
    cleared), with no read: (state, () bool a bucket overflowed, in which
    case the state is not the map).  Existing keys are re-inserted in slot
    order, as the JAX package does."""
    hi, lo = state.key_hi, state.key_lo
    fresh, plan = _fresh_plan(new_capacity, hi, lo, hi != EMPTY_HI)
    # empty old slots map to the dump row new_capacity, cut off below
    slots = plan.slots

    def moved(rows: torch.Tensor) -> torch.Tensor:
        out = rows.new_zeros((new_capacity + 1, rows.shape[1]))
        out[slots] = rows
        return out[:new_capacity]

    return BrickGridState(
        key_rows=commit_insert(fresh, plan),
        log_odds=moved(state.log_odds),
        touched=moved(state.touched),
        min_bounds=state.min_bounds,
        max_bounds=state.max_bounds,
        used=state.used,
        poisoned=torch.zeros_like(state.poisoned),
    ), plan.overflowed


def rehash_bricks(state: BrickGridState, new_capacity: int) -> BrickGridState:
    """Grow the table (clears ``poisoned`` for replay), doubling again until
    every existing bucket fits (``rehash_bricks_once``)."""
    while True:
        grown, overflowed = rehash_bricks_once(state, new_capacity)
        if not bool(overflowed):
            return grown
        new_capacity *= 2


def _brick_voxel_keys(
    hi: np.ndarray, lo: np.ndarray, vol: int, brick_bits: int
) -> np.ndarray:
    """(N,) brick codes -> (N, vol, 3) int64 voxel keys, offset order."""
    base = unpack_brick_keys(
        torch.as_tensor(hi), torch.as_tensor(lo), brick_bits
    ).numpy()
    off = np.arange(vol, dtype=np.int64)
    b = 1 << brick_bits
    offs = np.stack(
        [off >> (2 * brick_bits), (off >> brick_bits) & (b - 1), off & (b - 1)],
        axis=-1,
    )
    return base[:, None, :] + offs[None, :, :]


def _brick_voxel_points(
    hi: np.ndarray, lo: np.ndarray, vol: int, brick_bits: int,
    resolution: float,
) -> np.ndarray:
    """(N,) brick codes -> (N, vol, 3) float64 voxel centers."""
    keys = _brick_voxel_keys(hi, lo, vol, brick_bits)
    return (keys.astype(np.float64) + 0.5) * resolution


def _pull_bricks(state: BrickGridState, sel: torch.Tensor):
    """Host (hi, lo, rows, touched (N, vol) bool) of the occupied bricks
    where ``sel`` holds, bricks in ascending (hi, lo) code order (the JAX
    package's canonical extraction order); rows keep the state's dtype."""
    vol = state.brick_volume
    idx = torch.nonzero(sel & (state.key_hi != EMPTY_HI)).squeeze(1)
    hi = state.key_hi[idx].cpu().numpy()
    lo = state.key_lo[idx].cpu().numpy()
    order = np.lexsort((lo, hi))
    rows = state.log_odds[idx].cpu().numpy()[order]
    touched = _unpack_touched(state.touched[idx], vol).cpu().numpy()[order]
    return hi[order], lo[order], rows, touched


def extract_occupied_brick(
    state: BrickGridState, cfg: MapperConfig
) -> Tuple[np.ndarray, np.ndarray]:
    """Touched voxels above ``cfg.min_probability`` -> (points (N, 3),
    probabilities (N,)), float64 on the host, bricks in ascending
    (hi, lo) code order and voxels in offset order within a brick."""
    thr = probability_to_log_odds(cfg.min_probability, cfg)
    vol = state.brick_volume
    dtype = state.log_odds.dtype
    # conservative device prefilter one ulp low; exact float64 test on host
    t = torch.nextafter(
        torch.tensor(thr, dtype=dtype), torch.tensor(-float("inf"), dtype=dtype)
    ).to(state.log_odds.device)
    tbits = _unpack_touched(state.touched, vol)
    hi, lo, rows, touched = _pull_bricks(
        state, (tbits & (state.log_odds > t)).any(dim=1)
    )
    if len(hi) == 0:
        return np.empty((0, 3)), np.empty((0,))
    rows = rows.astype(np.float64)
    mask = touched & (rows > thr)
    points = _brick_voxel_points(hi, lo, vol, state.brick_bits,
                                 cfg.voxel_resolution)[mask]
    probs = 1.0 / (1.0 + np.exp(-rows[mask]))
    return points.reshape(-1, 3), probs


def extract_classified_brick(
    state: BrickGridState, cfg: MapperConfig
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Every touched voxel by class, as the reference classifies them:
    ``{"free" | "occupied" | "unknown": (points (N, 3), probabilities
    (N,))}``, float64 on the host, in extraction order.  Free is below
    p = 0.3, occupied above ``cfg.min_probability``, unknown between."""
    vol = state.brick_volume
    everything = torch.ones_like(state.key_hi, dtype=torch.bool)
    hi, lo, rows, touched = _pull_bricks(state, everything)
    if len(hi) == 0:
        return {k: (np.empty((0, 3)), np.empty((0,)))
                for k in ("free", "occupied", "unknown")}
    free_thr = np.log(0.3 / 0.7)
    occ_thr = np.log(cfg.min_probability / (1.0 - cfg.min_probability))
    lo_v = rows.astype(np.float64)
    points = _brick_voxel_points(hi, lo, vol, state.brick_bits,
                                 cfg.voxel_resolution)
    free_m = touched & (lo_v < free_thr)
    occ_m = touched & ~free_m & (lo_v > occ_thr)
    unk_m = touched & ~free_m & ~occ_m
    return {
        name: (points[m].reshape(-1, 3), 1.0 / (1.0 + np.exp(-lo_v[m])))
        for name, m in (("free", free_m), ("occupied", occ_m),
                        ("unknown", unk_m))
    }


def touched_voxels_brick(state: BrickGridState) -> Tuple[np.ndarray, np.ndarray]:
    """((N, 3) int32 voxel keys, (N,) log-odds in the state's dtype) of
    every touched voxel, in extraction order: the layout-independent view
    that map snapshots store (io/checkpoint.py)."""
    everything = torch.ones_like(state.key_hi, dtype=torch.bool)
    hi, lo, rows, touched = _pull_bricks(state, everything)
    keys = _brick_voxel_keys(hi, lo, state.brick_volume, state.brick_bits)
    return keys[touched].astype(np.int32).reshape(-1, 3), rows[touched]


def load_voxels_brick(
    keys: np.ndarray,
    log_odds: np.ndarray,
    device,
    capacity: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    brick_bits: int = DEFAULT_BRICK_BITS,
) -> BrickGridState:
    """A state on ``device`` holding the given voxels (the snapshot restore
    path; bounds are left empty for the caller to set).  ``keys`` (N, 3)
    must be distinct.  Bricks are inserted in the order of their first
    voxel, and the capacity, unless given, is the least power of two from
    1024 up that holds four slots per brick."""
    keys = np.asarray(keys, np.int32).reshape(-1, 3)
    n = len(keys)
    o = 3 * brick_bits
    vol = 1 << o
    hi, lo, in_range = pack_brick_keys(torch.as_tensor(keys), brick_bits)
    if not bool(in_range.all()):
        raise ValueError("voxel keys outside the packable range")
    b_lo = lo & (U32 ^ ((1 << (o + 4)) - 1))
    offset = ((lo >> 4) & ((1 << o) - 1)).to(device)
    # one insert per distinct brick, in the order of its first voxel
    codes = (hi.numpy() << 32) | b_lo.numpy()
    _, first, inverse = np.unique(codes, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    b_hi = hi[first[order]].to(device)
    b_code = b_lo[first[order]].to(device)
    if capacity is None:
        capacity = 1 << 10
        while capacity < 4 * max(1, len(first)):
            capacity *= 2
    key_rows, plan = plan_fresh_insert(
        capacity, b_hi, b_code, torch.ones_like(b_hi, dtype=torch.bool)
    )
    capacity = key_rows.shape[0] * BUCKET_SLOTS
    slot = plan.slots[torch.as_tensor(rank[inverse.reshape(-1)], device=device)]
    state = init_brick_grid(capacity, dtype, device, brick_bits)
    flat = slot * vol + offset
    log = state.log_odds.reshape(-1).index_put(
        (flat,), torch.as_tensor(np.asarray(log_odds), device=device).to(dtype)
    )
    mask = torch.zeros(capacity * vol, dtype=torch.bool, device=device)
    mask[flat] = True
    return state._replace(
        key_rows=commit_insert(key_rows, plan),
        log_odds=log.reshape(capacity, vol),
        touched=_pack_touched(mask.reshape(capacity, vol)),
        used=torch.tensor(n, dtype=torch.int64, device=device),
    )


def query_log_odds_brick(
    state: BrickGridState, points, cfg: MapperConfig
) -> np.ndarray:
    """(N, 3) world points -> (N,) log-odds of their voxels on the host, in
    the state's dtype; 0.0 where a voxel was never updated.  Points are
    keyed in float64 on the host (the reference's world_to_key), then
    looked up on the state's device."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    keys = np.clip(
        np.floor(pts / cfg.voxel_resolution), -(2**30), 2**30
    ).astype(np.int32)
    device = state.log_odds.device
    bb = state.brick_bits
    o = 3 * bb
    hi, lo, in_range = pack_brick_keys(
        torch.as_tensor(keys, device=device), bb
    )
    b_lo = lo & (U32 ^ ((1 << (o + 4)) - 1))
    offset = (lo >> 4) & ((1 << o) - 1)
    _, found, found_slot, _ = bucket_lookup(state.key_rows, hi, b_lo)
    slot = torch.clamp(found_slot, max=state.capacity - 1)
    vals = state.log_odds[slot, offset]
    bit = (state.touched[slot, offset // 32] >> (offset % 32)) & 1
    hit = found & in_range & (bit == 1)
    return torch.where(hit, vals, torch.zeros_like(vals)).cpu().numpy()


def query_probability_brick(
    state: BrickGridState, points, cfg: MapperConfig
) -> np.ndarray:
    """(N, 3) world points -> (N,) float64 occupancy probabilities; 0.5
    where a voxel was never updated."""
    lo = query_log_odds_brick(state, points, cfg).astype(np.float64)
    return 1.0 / (1.0 + np.exp(-lo))


_STATE_FIELDS = BrickGridState._fields


def brick_state_from_numpy(d, device) -> BrickGridState:
    """A state from NumPy arrays named like the fields (``key_rows`` and
    ``touched`` as uint32, as the JAX package's ``BrickGridState`` holds
    them)."""
    def t(name, dtype=None):
        return torch.as_tensor(np.array(d[name], dtype=dtype), device=device)

    return BrickGridState(
        key_rows=t("key_rows", np.int64),
        log_odds=t("log_odds"),
        touched=t("touched", np.int64),
        min_bounds=t("min_bounds"),
        max_bounds=t("max_bounds"),
        used=t("used", np.int64),
        poisoned=t("poisoned", bool),
    )


def brick_state_to_numpy(state: BrickGridState) -> Dict[str, np.ndarray]:
    """NumPy arrays named like the fields, in the JAX package's dtypes
    (uint32 key and touched words, int32 ``used``)."""
    out = {name: getattr(state, name).cpu().numpy() for name in _STATE_FIELDS}
    for name in ("key_rows", "touched"):
        if (out[name] > U32).any() or (out[name] < 0).any():
            raise ValueError(f"{name} holds a value outside u32")
        out[name] = out[name].astype(np.uint32)
    out["used"] = out["used"].astype(np.int32)
    return out
