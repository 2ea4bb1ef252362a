"""Hashed sparse voxel grid (PyTorch port of
``sonar_3d_reconstruction_tpu.grid.hash``): the bucketed key table that
both backends share, and the hash backend's per-voxel map over it.

Table layout: capacity C slots = C/128 buckets of 128 slots, keys stored
interleaved as one (C/128, 256) array — row r holds bucket r's 128 hi words
then its 128 lo words, u32 values in int64 (ops/packing.py).  Buckets fill
left to right and entries are never removed, so a bucket's occupancy is a
prefix and its first empty slot is its fill count.

  * lookup is one 256-wide row gather plus compares;
  * insert is collision-free by construction: new keys are sorted by
    bucket with a STABLE sort, ranked within equal buckets, and written at
    slot = bucket*128 + fill + rank.  Stability makes the slot order within
    a bucket follow record order, as the JAX package's ``lax.sort`` does,
    so both packages lay the table out identically.

The hash backend keys the table by voxel codes (``pack_keys``) and keeps
one log-odds value per slot.  A ping (``update_hash_grid``) or a window of
pings (``apply_records_batched``) applies its per-frame unique records
(ops/dedup.dedup_frame) with the reference's averaged adaptive update.
Without budgets every record width comes from the counts (a few host
reads an update).  An update fails all-or-nothing, returning its input
state with ``poisoned`` set, when a bucket would overflow (the host grows
the table with ``rehash`` and replays) or on keys outside the packable
range (fatal).  Updates are out of place: each returns new tensors and
never writes into the state it was given.

With budgets (``update_hash_grid(unique_budget=)``,
``apply_records_batched(batch_budget=, lane_budget=, insert_budget=)``;
the defaults below are the JAX package's) an update runs at those fixed
widths and reads nothing to the host: every overflow is a device flag
under the JAX package's stat names (``unique_overflow``,
``batch_overflow``, ``insert_overflow``), and a failed update drops its
writes on the device and poisons the state, so later updates are no-ops
until the host reads the flags, grows the right budget or the table, and
replays.

A budgeted update runs in two halves: the first computes its writes and
its local failure flag (``PendingUpdate``: ``prepare_frame_budgeted``,
``apply_records_batched(commit=False)``), the second
(``commit_update``) writes them or drops them all by a flag.  A single
map commits by its own flag; the sharded engines (parallel/shard.py)
commit every shard by the OR of all the shards' flags, reduced on the
device (the JAX package's ``fail_reduce``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.ops.dedup import (
    UniqueRecords,
    dedup_frame,
    running_max,
)
from sonar_3d_reconstruction_tpu_torch.ops.logodds import (
    finalize_voxel_updates,
    probability_to_log_odds,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import (
    EMPTY64,
    EMPTY_HI,
    U32,
    code_words,
    key_code,
    mix2,
    pack_keys,
    unpack_keys,
)

# Slots per bucket (one row gather resolves a whole bucket).
BUCKET_SLOTS = 128
# An empty slot's unpacked key (the sharded map's ``keys`` view).
EMPTY = 0x7FFFFFFF

# Largest default unique budget of one frame (doubled on overflow).
DEFAULT_UNIQUE_BUDGET = 1 << 17


def default_unique_budget(n_candidates: int) -> int:
    """The JAX package's default unique budget of a ping with
    ``n_candidates`` candidate lanes: the power of two at or above it,
    between 16 and ``DEFAULT_UNIQUE_BUDGET``."""
    budget = 1 << max(
        3, min(n_candidates - 1, DEFAULT_UNIQUE_BUDGET - 1)
    ).bit_length()
    return min(budget, DEFAULT_UNIQUE_BUDGET)


def default_batch_budget(window: int, unique_budget: int) -> int:
    """The JAX package's default distinct-voxel budget of a window:
    consecutive pings overlap, so three frames' budgets cover a window."""
    return min(window * unique_budget, 3 * unique_budget)


def effective_unique_budget(tables, cfg: MapperConfig) -> int:
    """The unique budget an engine runs with when none was given: the
    default for the tables' candidate lanes a ping."""
    return default_unique_budget(
        tables.candidates_per_ping(cfg.occupied_window)
    )


def empty_key_rows(capacity: int, device) -> torch.Tensor:
    if capacity & (capacity - 1) or capacity < BUCKET_SLOTS:
        raise ValueError(
            f"capacity must be a power of two >= {BUCKET_SLOTS}, got {capacity}"
        )
    return torch.full(
        (capacity // BUCKET_SLOTS, 2 * BUCKET_SLOTS), EMPTY_HI,
        dtype=torch.int64, device=device,
    )


def bucket_lookup(key_rows: torch.Tensor, u_hi: torch.Tensor, u_lo: torch.Tensor):
    """Resolve keys against the table in one 256-wide bucket-row gather.

    Returns (bucket (U,), found (U,), found_slot (U,), fill (U,)), where
    ``fill`` is the bucket's entry count (its first empty position).
    """
    n_buckets = key_rows.shape[0]
    bucket = mix2(u_hi, u_lo) & (n_buckets - 1)
    rows = key_rows[bucket]
    rows_hi = rows[:, :BUCKET_SLOTS]
    rows_lo = rows[:, BUCKET_SLOTS:]
    eq = (rows_hi == u_hi[:, None]) & (rows_lo == u_lo[:, None])
    found = eq.any(dim=1)
    # argmax returns the FIRST maximum; bool is not accepted, uint8 is
    found_slot = bucket * BUCKET_SLOTS + torch.argmax(eq.to(torch.uint8), dim=1)
    fill = (rows_hi != EMPTY_HI).sum(dim=1)
    return bucket, found, found_slot, fill


class InsertPlan(NamedTuple):
    """Collision-free insert plan (see ``plan_insert``)."""

    s_hi: torch.Tensor       # (U,) key words in bucket-sorted order
    s_lo: torch.Tensor
    s_bkt: torch.Tensor      # (U,) bucket (U32 = inactive lane)
    pos_c: torch.Tensor      # (U,) in-bucket position (clamped)
    fits: torch.Tensor       # (U,) bool key is active and fits its bucket
    slots: torch.Tensor      # (U,) slots in RECORD order (capacity = none)
    overflowed: torch.Tensor  # () bool a bucket would exceed BUCKET_SLOTS,
    #                            or the insert budget was exceeded
    n_need: torch.Tensor      # () int64 keys that needed an insert
    budget_overflow: torch.Tensor  # () bool n_need exceeded the budget


def plan_insert(
    key_rows: torch.Tensor,
    u_hi: torch.Tensor,
    u_lo: torch.Tensor,
    need: torch.Tensor,
    bucket: torch.Tensor,
    fill: torch.Tensor,
    budget: Optional[int] = None,
) -> InsertPlan:
    """Plan a collision-free insert of mutually distinct new keys.

    Keys flagged by ``need`` (distinct and absent from the table) are
    sorted by bucket and ranked within equal buckets; key i's slot is
    bucket*128 + fill + rank.  Nothing is written here: the caller commits
    with ``commit_insert``, unless the plan overflowed or it aborts.

    ``budget`` (the JAX package's insert budget) keeps only the first
    ``budget`` lanes of the bucket order, where the needed keys come
    first: more needed keys than that set ``budget_overflow`` (and
    ``overflowed``).
    """
    u = u_hi.shape[0]
    ib = u if budget is None else min(int(budget), u)
    device = u_hi.device
    capacity = key_rows.shape[0] * BUCKET_SLOTS
    idx = torch.arange(ib, device=device)

    ins_key = torch.where(need, bucket, U32)
    s_bkt, s_orig = torch.sort(ins_key, stable=True)
    s_bkt, s_orig = s_bkt[:ib], s_orig[:ib]
    s_hi, s_lo, s_fill = u_hi[s_orig], u_lo[s_orig], fill[s_orig]
    new_b = torch.cat([
        torch.ones(1, dtype=torch.bool, device=device), s_bkt[1:] != s_bkt[:-1]
    ])[:ib]
    start = running_max(torch.where(new_b, idx, -1))
    rank = idx - start
    active = s_bkt != U32
    pos = s_fill + rank
    fits = active & (pos < BUCKET_SLOTS)
    n_need = need.sum()
    budget_overflow = n_need > ib
    overflowed = (active & ~fits).any() | budget_overflow
    pos_c = torch.clamp(pos, max=BUCKET_SLOTS - 1)
    slot = s_bkt * BUCKET_SLOTS + pos_c
    # slots back in record order; lanes that do not fit write the dump
    # lane u, cut off below
    slots = torch.full((u + 1,), capacity, dtype=torch.int64, device=device)
    slots[torch.where(fits, s_orig, u)] = slot
    return InsertPlan(
        s_hi=s_hi, s_lo=s_lo, s_bkt=s_bkt, pos_c=pos_c, fits=fits,
        slots=slots[:u], overflowed=overflowed, n_need=n_need,
        budget_overflow=budget_overflow,
    )


def commit_insert(
    key_rows: torch.Tensor, plan: InsertPlan, abort=None
) -> torch.Tensor:
    """A new table with the planned keys written (both words in one
    scatter into the interleaved rows); lanes that do not fit write a dump
    word past the end, which is cut off.  ``abort`` (a () bool tensor)
    sends every write to the dump, so the table comes back unchanged with
    no host read."""
    n_buckets = key_rows.shape[0]
    flat_n = n_buckets * 2 * BUCKET_SLOTS
    base = plan.s_bkt * (2 * BUCKET_SLOTS) + plan.pos_c
    write = plan.fits if abort is None else plan.fits & ~abort
    tgt_hi = torch.where(write, base, flat_n)
    tgt_lo = torch.where(write, base + BUCKET_SLOTS, flat_n)
    flat = torch.cat([key_rows.reshape(-1), key_rows.new_empty(1)])
    flat[torch.cat([tgt_hi, tgt_lo])] = torch.cat([plan.s_hi, plan.s_lo])
    return flat[:flat_n].reshape(n_buckets, 2 * BUCKET_SLOTS)


def insert_unique(key_rows, u_hi, u_lo, need, bucket, fill):
    """plan_insert + commit_insert in one call (keys that fit are written
    even when other buckets overflow; callers reject the update as a whole
    on ``overflowed``).  Returns (key_rows, slots, overflowed,
    n_inserted)."""
    plan = plan_insert(key_rows, u_hi, u_lo, need, bucket, fill)
    return (commit_insert(key_rows, plan), plan.slots, plan.overflowed,
            plan.fits.sum())


# ---------------------------------------------------------------------------
# The hash backend's map
# ---------------------------------------------------------------------------


class HashGridState(NamedTuple):
    """Map state.  u32 words are held in int64 (ops/packing.py)."""

    key_rows: torch.Tensor    # (C/128, 256) voxel codes
    log_odds: torch.Tensor    # (C,) dtype
    min_bounds: torch.Tensor  # (3,)
    max_bounds: torch.Tensor  # (3,)
    used: torch.Tensor        # () int64 occupied slot count
    poisoned: torch.Tensor    # () bool: an update failed

    @property
    def capacity(self) -> int:
        return self.key_rows.shape[0] * BUCKET_SLOTS

    @property
    def key_hi(self) -> torch.Tensor:
        """(C,) flat hi words in slot order; EMPTY_HI = free slot."""
        return self.key_rows[:, :BUCKET_SLOTS].reshape(-1)

    @property
    def key_lo(self) -> torch.Tensor:
        return self.key_rows[:, BUCKET_SLOTS:].reshape(-1)


def init_hash_grid(
    capacity: int, dtype: torch.dtype, device
) -> HashGridState:
    inf = float("inf")
    return HashGridState(
        key_rows=empty_key_rows(capacity, device),
        log_odds=torch.zeros((capacity,), dtype=dtype, device=device),
        min_bounds=torch.full((3,), inf, dtype=dtype, device=device),
        max_bounds=torch.full((3,), -inf, dtype=dtype, device=device),
        used=torch.zeros((), dtype=torch.int64, device=device),
        poisoned=torch.zeros((), dtype=torch.bool, device=device),
    )


def voxel_keys(points: torch.Tensor, resolution: float) -> torch.Tensor:
    """floor(world / resolution) int32 keys (reference 3d_mapper.py:63-66),
    a true division in the points' dtype."""
    res = torch.full((), resolution, dtype=points.dtype, device=points.device)
    return torch.floor(points / res).to(torch.int32)


def chain_terms(count: torch.Tensor, n_occ: torch.Tensor, dtype, cfg):
    """(lo_sum, count, occupied) of records in ``dtype``: the frame's summed
    candidate log-odds n_occ * L_occ + (count - n_occ) * L_free, as the JAX
    package and K1 compute it."""
    device = count.device
    occ_l = torch.full((), cfg.log_odds_occupied, dtype=dtype, device=device)
    free_l = torch.full((), cfg.log_odds_free, dtype=dtype, device=device)
    c, q = count.to(dtype), n_occ.to(dtype)
    return q * occ_l + (c - q) * free_l, c, n_occ > 0


def _failed(state: HashGridState, range_fail: torch.Tensor):
    """(the input state with ``poisoned`` set, the stats of its failed
    frames: shaped like ``range_fail``, () for one ping or (B,))."""
    zero = torch.zeros_like(range_fail, dtype=torch.int64)
    return state._replace(poisoned=torch.ones_like(state.poisoned)), {
        "num_occupied": zero, "num_free": zero, "num_candidates": zero,
        "overflowed": torch.ones_like(range_fail), "range_fail": range_fail,
        "batch_n_unique": zero,
    }


def apply_unique_records(
    state: HashGridState, rec: UniqueRecords, cfg: MapperConfig
) -> Tuple[HashGridState, Dict[str, torch.Tensor], torch.Tensor]:
    """Look up and insert one frame's unique records and apply the averaged
    adaptive log-odds update.  Returns (applied state, partial stats, the
    bucket overflow flag); the caller handles failure and bounds.  Invalid
    lanes write a dump slot past the end, cut off."""
    capacity = state.capacity
    dtype = state.log_odds.dtype
    valid = rec.valid
    bucket, found, found_slot, fill = bucket_lookup(state.key_rows, rec.hi, rec.lo)
    key_rows, new_slots, overflowed, n_inserted = insert_unique(
        state.key_rows, rec.hi, rec.lo, valid & ~found, bucket, fill
    )
    slots = torch.where(valid, torch.where(found, found_slot, new_slots),
                        capacity)
    lo_sum, count, occupied = chain_terms(rec.count, rec.n_occ, dtype, cfg)
    cur = state.log_odds[torch.clamp(slots, max=capacity - 1)]
    new_val = finalize_voxel_updates(cur, lo_sum, count, occupied, cfg)
    log_odds = torch.cat([state.log_odds, state.log_odds.new_zeros(1)])
    log_odds[slots] = new_val
    applied = state._replace(
        key_rows=key_rows, log_odds=log_odds[:capacity],
        used=state.used + n_inserted,
    )
    stats = {
        "num_occupied": (valid & occupied).sum(),
        "num_free": (valid & ~occupied).sum(),
    }
    return applied, stats, overflowed


def apply_frame_records(
    state: HashGridState,
    rec: UniqueRecords,
    aux,  # ops.records.FrameAux
    cfg: MapperConfig,
) -> Tuple[HashGridState, Dict[str, torch.Tensor]]:
    """One frame's records (voxel codes) -> map state transition, the
    sequential half of ``update_hash_grid``.  The records are cut to their
    unique count first (one sync with the failure flags known so far); a
    failed frame returns the input state with ``poisoned`` set."""
    device = state.log_odds.device
    n, range_fail, poisoned = torch.stack(
        [rec.n_unique, aux.range_fail, state.poisoned]
    ).tolist()
    if range_fail or poisoned:
        return _failed(state, aux.range_fail)
    rec = UniqueRecords(rec.hi[:n], rec.lo[:n], rec.count[:n], rec.n_occ[:n],
                        rec.n_unique)
    applied, stats, overflowed = apply_unique_records(state, rec, cfg)
    if bool(overflowed):
        return _failed(state, aux.range_fail)
    dtype = state.log_odds.dtype
    applied = applied._replace(
        min_bounds=torch.minimum(state.min_bounds, aux.cmin.to(dtype)),
        max_bounds=torch.maximum(state.max_bounds, aux.cmax.to(dtype)),
    )
    stats.update(
        num_candidates=aux.n_valid,
        overflowed=torch.zeros((), dtype=torch.bool, device=device),
        range_fail=aux.range_fail,
        batch_n_unique=rec.n_unique,
    )
    return applied, stats


def _write_dropping(values: torch.Tensor, slots: torch.Tensor,
                    new: torch.Tensor) -> torch.Tensor:
    """``values`` with ``new`` written at ``slots`` (along dim 0), out of
    place; slots at or past the end (the capacity) are dropped."""
    cap = values.shape[0]
    out = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    out[torch.clamp(slots, max=cap)] = new
    return out[:cap]


def _commit_failed(state, failed, n_new, auxs, dtype):
    """The all-or-nothing fields of a budgeted update: bounds widened and
    ``used`` grown only where nothing ``failed``; ``poisoned`` set where
    it did."""
    cmin, cmax = auxs.cmin.to(dtype), auxs.cmax.to(dtype)
    if cmin.dim() > 1:
        cmin, cmax = cmin.amin(dim=0), cmax.amax(dim=0)
    return dict(
        min_bounds=torch.where(failed, state.min_bounds,
                               torch.minimum(state.min_bounds, cmin)),
        max_bounds=torch.where(failed, state.max_bounds,
                               torch.maximum(state.max_bounds, cmax)),
        used=state.used + torch.where(failed, 0, n_new),
        poisoned=state.poisoned | failed,
    )


class PendingUpdate(NamedTuple):
    """The first half of a budgeted update: its writes, not yet made, and
    its local failure flag.  ``commit_update`` makes them or drops them."""

    state: Any               # the map state the update read (hash or brick)
    plan: InsertPlan         # new keys to insert
    slots: torch.Tensor      # (N,) slots (brick: rows) to write; capacity:
                             # none
    values: torch.Tensor     # (N,) values (brick: (N, vol) rows) at slots
    touched: Optional[torch.Tensor]  # (N, words) touched words (brick)
    n_new: torch.Tensor      # () int64 growth of ``used``
    auxs: Any                # ops.records.FrameAux (one frame or stacked)
    failed: torch.Tensor     # () bool local failure flag
    stats: Dict[str, torch.Tensor]  # the stats before a failure zeroes them


# the stats a failed update reports as zero
_ZEROED_ON_FAILURE = ("num_occupied", "num_free", "num_candidates")


def commit_update(
    pending: PendingUpdate, failed: Optional[torch.Tensor] = None
) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """The second half of a budgeted update: (new state, stats).  Every
    write is made unless ``failed`` (a () bool on the state's device;
    default the update's own flag), which turns each into a dropped write
    and poisons the state, all on the device.  ``failed`` must cover the
    update's own flag: a sharded engine passes the OR of its shards'."""
    failed = pending.failed if failed is None else failed
    state = pending.state
    dtype = state.log_odds.dtype
    w_slots = torch.where(failed, state.capacity, pending.slots)
    fields = dict(
        key_rows=commit_insert(state.key_rows, pending.plan, abort=failed),
        log_odds=_write_dropping(state.log_odds, w_slots, pending.values),
        **_commit_failed(state, failed, pending.n_new, pending.auxs, dtype),
    )
    if pending.touched is not None:
        fields["touched"] = _write_dropping(state.touched, w_slots,
                                           pending.touched)
    stats = dict(pending.stats)
    for k in _ZEROED_ON_FAILURE:
        stats[k] = torch.where(failed, 0, stats[k])
    stats["overflowed"] = failed.expand(stats["range_fail"].shape)
    return type(state)(**fields), stats


def prepare_frame_budgeted(
    state: HashGridState, rec: UniqueRecords, aux, cfg: MapperConfig
) -> PendingUpdate:
    """The first half of one frame's budgeted update over its records
    (``update_hash_grid(unique_budget=)``), on the device only: a
    unique-budget or bucket overflow, a key out of range or a poisoned
    state sets the failure flag.  Stats as ``update_hash_grid`` with a
    budget reports them."""
    capacity = state.capacity
    dtype = state.log_odds.dtype
    valid = rec.valid
    bucket, found, found_slot, fill = bucket_lookup(state.key_rows, rec.hi, rec.lo)
    plan = plan_insert(state.key_rows, rec.hi, rec.lo, valid & ~found,
                       bucket, fill)
    failed = rec.overflowed | plan.overflowed | aux.range_fail | state.poisoned
    slots = torch.where(valid, torch.where(found, found_slot, plan.slots),
                        capacity)
    lo_sum, count, occupied = chain_terms(rec.count, rec.n_occ, dtype, cfg)
    cur = state.log_odds[torch.clamp(slots, max=capacity - 1)]
    new_val = finalize_voxel_updates(cur, lo_sum, count, occupied, cfg)
    return PendingUpdate(
        state=state, plan=plan, slots=slots, values=new_val, touched=None,
        n_new=plan.fits.sum(), auxs=aux, failed=failed,
        stats={
            "num_occupied": (valid & occupied).sum(),
            "num_free": (valid & ~occupied).sum(),
            "num_candidates": aux.n_valid,
            "overflowed": failed,
            "unique_overflow": rec.overflowed,
            "range_fail": aux.range_fail,
        },
    )


def update_hash_grid(
    state: HashGridState,
    candidates: Dict[str, torch.Tensor],
    cfg: MapperConfig,
    unique_budget: Optional[int] = None,
) -> Tuple[HashGridState, Dict[str, torch.Tensor]]:
    """Apply one ping's candidate emissions (``backproject_ping``'s dict)
    to the hash map.  Returns (state, stats: ``num_occupied`` /
    ``num_free`` unique voxels by type, ``num_candidates`` valid emissions,
    ``overflowed``, ``range_fail``, ``batch_n_unique``).  A frame that
    would overflow a bucket, has keys out of the packable range, or meets
    a poisoned state returns the input state with ``poisoned`` set.

    With ``unique_budget`` the frame's records are that many lanes wide
    and nothing is read to the host (module docstring); the stats are then
    the JAX package's: ``unique_overflow`` in place of
    ``batch_n_unique``."""
    from sonar_3d_reconstruction_tpu_torch.ops.records import FrameAux

    dtype = state.log_odds.dtype
    pts = candidates["points"]
    keys = voxel_keys(pts, cfg.voxel_resolution)
    hi, lo, in_range = pack_keys(keys)
    valid = candidates["valid"]
    range_fail = (valid & ~in_range).any()
    valid = valid & in_range
    rec = dedup_frame(hi, lo, candidates["is_occupied"], valid, brick=False,
                      unique_budget=unique_budget)
    # bounds over updated voxel centres (reference 3d_mapper.py:112-115),
    # reduced over int keys: k -> (k + 0.5) * res is exact and monotone
    res = torch.full((), cfg.voxel_resolution, dtype=dtype, device=pts.device)
    imax = torch.iinfo(torch.int32).max
    kmin = torch.where(valid[:, None], keys, imax).amin(dim=0)
    kmax = torch.where(valid[:, None], keys, -imax).amax(dim=0)
    n_valid = valid.sum()
    inf = torch.full((), float("inf"), dtype=dtype, device=pts.device)
    aux = FrameAux(
        cmin=torch.where(n_valid > 0, (kmin.to(dtype) + 0.5) * res, inf),
        cmax=torch.where(n_valid > 0, (kmax.to(dtype) + 0.5) * res, -inf),
        range_fail=range_fail,
        n_valid=n_valid,
    )
    if unique_budget is not None:
        return commit_update(prepare_frame_budgeted(state, rec, aux, cfg))
    return apply_frame_records(state, rec, aux, cfg)


def apply_records_batched(
    state: HashGridState,
    recs: UniqueRecords,   # stacked over B frames: (B, U), voxel codes
    auxs,                  # ops.records.FrameAux stacked over B frames
    cfg: MapperConfig,
    batch_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget: Optional[int] = None,
    commit: bool = True,
) -> Tuple[HashGridState, Dict[str, torch.Tensor]]:
    """Apply a window of B frames with one set of table operations.

    All B*U record lanes sort by voxel with a STABLE sort: the lanes are
    frame-major, so a voxel's records stay in frame order.  Each voxel's
    update chain (its records, at most B, in consecutive lanes) is then
    evaluated with rank-stepped elementwise passes of
    ``finalize_voxel_updates`` — the reference's sequential per-frame
    update — and only each voxel's final value is written to the table.
    The passes stop at the window's longest chain.

    Returns (state, per-frame stats of shape (B,): ``num_occupied``,
    ``num_free``, ``num_candidates``, ``overflowed``, ``range_fail``, and
    the window's distinct voxels ``batch_n_unique``).  All-or-nothing: a
    bucket overflow, a key out of range or a poisoned state returns the
    input state with ``poisoned`` set and every frame ``overflowed``.

    Any of ``batch_budget`` (distinct voxels; default
    ``default_batch_budget(B, U)``), ``lane_budget`` (record lanes;
    default twice that) or ``insert_budget`` (new keys) runs the JAX
    package's fixed-width window instead (``_prepare_batched_budgeted``):
    the same map, nothing read to the host, and the JAX package's stats.
    ``commit=False`` (budgets only) returns its ``PendingUpdate`` instead,
    for ``commit_update``.
    """
    if (batch_budget, lane_budget, insert_budget) != (None, None, None):
        pending = _prepare_batched_budgeted(state, recs, auxs, cfg,
                                            batch_budget, lane_budget,
                                            insert_budget)
        return commit_update(pending) if commit else pending
    if not commit:
        raise ValueError("commit=False needs a budget: a count-sized window "
                         "commits as it goes")
    B, U = recs.hi.shape
    n = B * U
    dtype, device = state.log_odds.dtype, state.log_odds.device
    rec_valid = recs.valid
    code = torch.where(rec_valid.reshape(-1),
                       key_code(recs.hi.reshape(-1), recs.lo.reshape(-1),
                                brick=False), EMPTY64)
    s_code, order = torch.sort(code, stable=True)
    idx = torch.arange(n, device=device)
    new_seg = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                         s_code[1:] != s_code[:-1]])
    seg_valid = s_code != EMPTY64
    rank = idx - running_max(torch.where(new_seg, idx, -1))
    n_unique, n_lanes, max_rank, range_fail, poisoned = torch.stack([
        (new_seg & seg_valid).sum(), seg_valid.sum(),
        torch.where(seg_valid, rank, 0).max(), auxs.range_fail.any(),
        state.poisoned,
    ]).tolist()
    if range_fail or poisoned:
        return _failed(state, auxs.range_fail)

    # valid lanes are a sorted prefix; each distinct voxel's segment starts
    # at the first lane of its segment id
    L = n_lanes
    s_code, order, rank = s_code[:L], order[:L], rank[:L]
    seg_id = torch.cumsum(new_seg[:L].to(torch.int64), dim=0) - 1
    c_pos = torch.searchsorted(seg_id, torch.arange(n_unique, device=device))
    c_hi, c_lo = code_words(s_code[c_pos], brick=False)
    bucket, found, found_slot, fill = bucket_lookup(state.key_rows, c_hi, c_lo)
    plan = plan_insert(state.key_rows, c_hi, c_lo, ~found, bucket, fill)
    if bool(plan.overflowed):
        return _failed(state, auxs.range_fail)
    slots = torch.where(found, found_slot, plan.slots)

    # the pre-window value is needed only at each segment's first lane: a
    # rank-s lane's value comes from its left neighbour at pass s
    cur = state.log_odds.new_zeros(L)
    cur[c_pos] = state.log_odds[slots]
    lo_sum, count, occupied = chain_terms(
        recs.count.reshape(-1)[order], recs.n_occ.reshape(-1)[order], dtype,
        cfg,
    )
    v = finalize_voxel_updates(cur, lo_sum, count, occupied, cfg)
    for s in range(1, max_rank + 1):
        v_s = finalize_voxel_updates(torch.cat([v[:1], v[:-1]]), lo_sum,
                                     count, occupied, cfg)
        v = torch.where(rank == s, v_s, v)
    # a voxel's final value sits at its segment's last lane
    end_pos = torch.cat([c_pos[1:], c_pos.new_full((1,), L)])[:n_unique] - 1

    rec_occ = rec_valid & (recs.n_occ > 0)
    new_state = HashGridState(
        key_rows=commit_insert(state.key_rows, plan),
        log_odds=state.log_odds.index_copy(0, slots, v[end_pos]),
        min_bounds=torch.minimum(state.min_bounds, auxs.cmin.amin(dim=0).to(dtype)),
        max_bounds=torch.maximum(state.max_bounds, auxs.cmax.amax(dim=0).to(dtype)),
        used=state.used + plan.fits.sum(),
        poisoned=state.poisoned,
    )
    stats = {
        "num_occupied": rec_occ.sum(dim=1),
        "num_free": (rec_valid & ~rec_occ).sum(dim=1),
        "num_candidates": auxs.n_valid,
        "overflowed": torch.zeros(B, dtype=torch.bool, device=device),
        "range_fail": auxs.range_fail,
        "batch_n_unique": torch.full((B,), n_unique, device=device),
    }
    return new_state, stats


def _prepare_batched_budgeted(
    state: HashGridState, recs: UniqueRecords, auxs, cfg: MapperConfig,
    batch_budget: Optional[int], lane_budget: Optional[int],
    insert_budget: Optional[int],
) -> PendingUpdate:
    """The first half of ``apply_records_batched`` at the JAX package's
    fixed widths: the sort runs over all B*U lanes, the chain over the
    first Lb, and the table ops over ``batch_budget`` compacted voxels; the
    chain takes all B - 1 rank passes.  A batch, lane, insert, unique or
    bucket overflow, a key out of range or a poisoned state sets the
    failure flag, all on the device."""
    B, U = recs.hi.shape
    n = B * U
    capacity = state.capacity
    dtype, device = state.log_odds.dtype, state.log_odds.device
    ub = batch_budget or default_batch_budget(B, U)
    lb = min(n, max(lane_budget or 2 * ub, ub))
    rec_valid = recs.valid
    code = torch.where(rec_valid.reshape(-1),
                       key_code(recs.hi.reshape(-1), recs.lo.reshape(-1),
                                brick=False), EMPTY64)
    s_code, order = torch.sort(code, stable=True)
    idx = torch.arange(n, device=device)
    new_seg = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                         s_code[1:] != s_code[:-1]])
    seg_valid = s_code != EMPTY64
    rank = idx - running_max(torch.where(new_seg, idx, -1))
    rec_start = new_seg & seg_valid
    n_unique = rec_start.sum()
    n_lanes = seg_valid.sum()
    batch_overflow = n_unique > ub
    lanes_overflow = n_lanes > lb

    # each distinct voxel's first lane in the Lb prefix, compacted to ub
    # lanes in key order (lane Lb where there is none)
    start_l = rec_start[:lb]
    r = torch.cumsum(start_l, dim=0) - 1
    c_pos = torch.full((ub + 1,), lb, dtype=torch.int64, device=device)
    c_pos[torch.where(start_l & (r < ub), r, ub)] = idx[:lb]
    c_pos = c_pos[:ub]
    lane = torch.arange(ub, device=device)
    valid_u = lane < n_unique
    c_hi, c_lo = code_words(s_code[torch.clamp(c_pos, max=lb - 1)],
                            brick=False)
    c_hi = torch.where(valid_u, c_hi, EMPTY_HI)
    c_lo = torch.where(valid_u, c_lo, EMPTY_HI)
    bucket, found, found_slot, fill = bucket_lookup(state.key_rows, c_hi, c_lo)
    plan = plan_insert(state.key_rows, c_hi, c_lo, valid_u & ~found, bucket,
                       fill, budget=insert_budget)
    frame_overflow = (recs.n_unique > U).any()
    failed = (batch_overflow | lanes_overflow | plan.overflowed
              | auxs.range_fail.any() | frame_overflow | state.poisoned)
    slots = torch.where(valid_u, torch.where(found, found_slot, plan.slots),
                        capacity)

    # the pre-window value seeds each voxel's first lane; a rank-s lane's
    # value comes from its left neighbour at pass s
    cur = _write_dropping(
        state.log_odds.new_zeros(lb), torch.where(valid_u, c_pos, lb),
        state.log_odds[torch.clamp(slots, max=capacity - 1)])
    lo_sum, count, occupied = chain_terms(
        recs.count.reshape(-1)[order[:lb]], recs.n_occ.reshape(-1)[order[:lb]],
        dtype, cfg,
    )
    rank_l = rank[:lb]
    v = finalize_voxel_updates(cur, lo_sum, count, occupied, cfg)
    for s in range(1, B):
        v_s = finalize_voxel_updates(torch.cat([v[:1], v[:-1]]), lo_sum,
                                     count, occupied, cfg)
        v = torch.where(rank_l == s, v_s, v)
    # a voxel's final value sits at its segment's last lane
    next_start = torch.cat([c_pos[1:], c_pos.new_full((1,), lb)])
    end_pos = torch.where(lane + 1 < n_unique, next_start - 1, n_lanes - 1)
    new_unique = torch.where(valid_u, v[torch.clamp(end_pos, 0, lb - 1)], 0)
    rec_occ = rec_valid & (recs.n_occ > 0)

    def per_frame(x):
        return x.expand(B)

    return PendingUpdate(
        state=state, plan=plan, slots=slots, values=new_unique, touched=None,
        n_new=plan.fits.sum(), auxs=auxs, failed=failed,
        stats={
            "num_occupied": rec_occ.sum(dim=1),
            "num_free": (rec_valid & ~rec_occ).sum(dim=1),
            "num_candidates": auxs.n_valid,
            "overflowed": per_frame(failed),
            "unique_overflow": per_frame(frame_overflow),
            "batch_overflow": per_frame(batch_overflow | lanes_overflow),
            "insert_overflow": per_frame(plan.budget_overflow),
            "batch_n_unique": per_frame(n_unique),
            "batch_n_need": per_frame(plan.n_need),
            "range_fail": auxs.range_fail,
        },
    )


def _fresh_plan(capacity: int, hi, lo, need) -> Tuple[torch.Tensor, InsertPlan]:
    """(empty key rows of ``capacity`` slots, plan inserting the distinct
    keys ``need`` flags), with no read: the plan's ``overflowed`` says
    whether a bucket overflowed.  An empty table finds nothing and every
    bucket's fill is 0, so no bucket rows are gathered."""
    fresh = empty_key_rows(capacity, hi.device)
    bucket = mix2(hi, lo) & (fresh.shape[0] - 1)
    return fresh, plan_insert(fresh, hi, lo, need, bucket,
                              torch.zeros_like(bucket))


def plan_fresh_insert(capacity: int, hi, lo, need) -> Tuple[torch.Tensor, InsertPlan]:
    """``_fresh_plan``, doubling the table until no bucket overflows."""
    while True:
        fresh, plan = _fresh_plan(capacity, hi, lo, need)
        if not bool(plan.overflowed):
            return fresh, plan
        capacity *= 2


def rehash_once(
    state: HashGridState, new_capacity: int
) -> Tuple[HashGridState, torch.Tensor]:
    """The table re-built at ``new_capacity`` slots (``poisoned``
    cleared), with no read: (state, () bool a bucket overflowed, in which
    case the state is not the map and a larger capacity is needed).
    Existing keys are re-inserted in slot order, as the JAX package
    does."""
    hi, lo = state.key_hi, state.key_lo
    fresh, plan = _fresh_plan(new_capacity, hi, lo, hi != EMPTY_HI)
    # empty old slots map to the dump slot new_capacity, cut off below
    log_odds = state.log_odds.new_zeros(new_capacity + 1)
    log_odds[plan.slots] = state.log_odds
    return HashGridState(
        key_rows=commit_insert(fresh, plan),
        log_odds=log_odds[:new_capacity],
        min_bounds=state.min_bounds,
        max_bounds=state.max_bounds,
        used=plan.fits.sum(),
        poisoned=torch.zeros_like(state.poisoned),
    ), plan.overflowed


def rehash(state: HashGridState, new_capacity: int) -> HashGridState:
    """Grow the table (clears ``poisoned`` for replay), doubling again until
    every existing bucket fits (``rehash_once``)."""
    while True:
        grown, overflowed = rehash_once(state, new_capacity)
        if not bool(overflowed):
            return grown
        new_capacity *= 2


def load_voxels_hash(
    keys: np.ndarray,
    log_odds: np.ndarray,
    device,
    capacity: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
) -> HashGridState:
    """A state on ``device`` holding the given voxels (the snapshot restore
    path; bounds are left empty for the caller to set).  ``keys`` (N, 3)
    must be distinct; they are inserted in the given order, and the
    capacity, unless given, is the least power of two from 1024 up that
    keeps the load at or under 0.25; a bucket overflow doubles it."""
    keys = np.asarray(keys, np.int32).reshape(-1, 3)
    n = len(keys)
    hi, lo, in_range = pack_keys(torch.as_tensor(keys, device=device))
    if not bool(in_range.all()):
        raise ValueError("voxel keys outside the packable range")
    if capacity is None:
        capacity = 1 << 10
        while capacity < 4 * max(1, n):
            capacity *= 2
    key_rows, plan = plan_fresh_insert(
        capacity, hi, lo, torch.ones(n, dtype=torch.bool, device=device)
    )
    state = init_hash_grid(key_rows.shape[0] * BUCKET_SLOTS, dtype, device)
    values = torch.as_tensor(np.asarray(log_odds), device=device).to(dtype)
    return state._replace(
        key_rows=commit_insert(key_rows, plan),
        log_odds=state.log_odds.index_copy(0, plan.slots, values),
        used=torch.tensor(n, dtype=torch.int64, device=device),
    )


# ---------------------------------------------------------------------------
# Reads: extraction, snapshots and point queries
# ---------------------------------------------------------------------------


def occupied_key_mask(state: HashGridState) -> np.ndarray:
    """(C,) host bool mask of the slots that hold a key, in slot order."""
    return (state.key_hi != EMPTY_HI).cpu().numpy()


def _exact_gt_threshold(thr: float, dtype: torch.dtype) -> float:
    """A cut t such that ``x > t`` in ``dtype`` equals the host's float64
    ``float64(x) > thr`` for every representable x: the largest float32
    value at or below thr (float32 values are exact in float64)."""
    if dtype == torch.float64:
        return thr
    t32 = np.float32(thr)
    if np.float64(t32) > thr:
        t32 = np.nextafter(t32, np.float32(-np.inf))
    return float(t32)


def _pull_by_class(state: HashGridState, class_key: torch.Tensor, n_classes: int):
    """Host (hi, lo, values) of the slots of classes 0..n_classes-1, class
    by class and in slot order within a class (one stable sort on the
    card, as the JAX package's ``_compact_by_class``), and each class's
    count."""
    counts = torch.bincount(class_key, minlength=n_classes + 1)[:n_classes]
    counts = counts.tolist()
    order = torch.sort(class_key, stable=True).indices[:sum(counts)]
    return (state.key_hi[order].cpu(), state.key_lo[order].cpu(),
            state.log_odds[order].cpu().numpy(), counts)


def _centres(hi: torch.Tensor, lo: torch.Tensor, resolution: float) -> np.ndarray:
    return (unpack_keys(hi, lo).numpy().astype(np.float64) + 0.5) * resolution


def extract_occupied_hash(
    state: HashGridState, cfg: MapperConfig
) -> Tuple[np.ndarray, np.ndarray]:
    """Voxels above ``cfg.min_probability`` -> (points (N, 3), probabilities
    (N,)), float64 on the host, in slot order."""
    thr = probability_to_log_odds(cfg.min_probability, cfg)
    t = _exact_gt_threshold(thr, state.log_odds.dtype)
    occ = (state.key_hi != EMPTY_HI) & (state.log_odds > t)
    hi, lo, val, _ = _pull_by_class(state, (~occ).to(torch.int64), 1)
    probs = 1.0 / (1.0 + np.exp(-val.astype(np.float64)))
    return _centres(hi, lo, cfg.voxel_resolution).reshape(-1, 3), probs


def extract_classified_hash(
    state: HashGridState, cfg: MapperConfig
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Every voxel by class, as the reference classifies them (free below
    p = 0.3 first, then occupied above ``cfg.min_probability``, else
    unknown): ``{"free" | "occupied" | "unknown": (points (N, 3),
    probabilities (N,))}``, float64 on the host, each in slot order."""
    free_thr = np.log(0.3 / 0.7)
    occ_thr = np.log(cfg.min_probability / (1.0 - cfg.min_probability))
    dtype = state.log_odds.dtype
    v = state.log_odds
    touched = state.key_hi != EMPTY_HI
    # x < free_thr == not (x > the largest value below free_thr)
    free_m = touched & ~(v > _exact_gt_threshold(
        float(np.nextafter(free_thr, -np.inf)), dtype))
    occ_m = touched & ~free_m & (v > _exact_gt_threshold(occ_thr, dtype))
    unk_m = touched & ~free_m & ~occ_m
    class_key = torch.where(
        free_m, 0, torch.where(occ_m, 1, torch.where(unk_m, 2, 3))
    )
    hi, lo, val, counts = _pull_by_class(state, class_key, 3)
    out, start = {}, 0
    for name, n in zip(("free", "occupied", "unknown"), counts):
        sl = slice(start, start + n)
        probs = 1.0 / (1.0 + np.exp(-val[sl].astype(np.float64)))
        out[name] = (_centres(hi[sl], lo[sl], cfg.voxel_resolution)
                     .reshape(-1, 3), probs)
        start += n
    return out


def touched_voxels_hash(state: HashGridState) -> Tuple[np.ndarray, np.ndarray]:
    """((N, 3) int32 voxel keys, (N,) log-odds in the state's dtype) of
    every touched voxel, in slot order: the layout-independent view that
    map snapshots store (io/checkpoint.py)."""
    empty = (state.key_hi == EMPTY_HI).to(torch.int64)
    hi, lo, val, _ = _pull_by_class(state, empty, 1)
    return unpack_keys(hi, lo).numpy().astype(np.int32).reshape(-1, 3), val


def query_log_odds(state: HashGridState, points, cfg: MapperConfig) -> np.ndarray:
    """(N, 3) world points -> (N,) log-odds of their voxels on the host, in
    the state's dtype; 0.0 where a voxel was never updated.  Points are
    keyed in float64 on the host (the reference's world_to_key), then
    looked up on the state's device."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    keys = np.clip(
        np.floor(pts / cfg.voxel_resolution), -(2**30), 2**30
    ).astype(np.int32)
    hi, lo, in_range = pack_keys(torch.as_tensor(keys, device=state.log_odds.device))
    _, found, found_slot, _ = bucket_lookup(state.key_rows, hi, lo)
    vals = state.log_odds[torch.clamp(found_slot, max=state.capacity - 1)]
    hit = found & in_range
    return torch.where(hit, vals, torch.zeros_like(vals)).cpu().numpy()


def query_probability(state: HashGridState, points, cfg: MapperConfig) -> np.ndarray:
    """(N, 3) world points -> (N,) float64 occupancy probabilities; 0.5
    where a voxel was never updated."""
    lo = query_log_odds(state, points, cfg).astype(np.float64)
    return 1.0 / (1.0 + np.exp(-lo))


def keys_to_world(keys, resolution: float) -> np.ndarray:
    """Voxel keys -> voxel centre coordinates (reference key_to_world,
    3d_mapper.py:68-81: (key + 0.5) * resolution)."""
    return (np.asarray(keys, np.float64) + 0.5) * resolution


_STATE_FIELDS = HashGridState._fields


def hash_state_from_numpy(d, device) -> HashGridState:
    """A state from NumPy arrays named like the fields (``key_rows`` as
    uint32, as the JAX package's ``HashGridState`` holds them)."""
    def t(name, dtype=None):
        return torch.as_tensor(np.array(d[name], dtype=dtype), device=device)

    return HashGridState(
        key_rows=t("key_rows", np.int64),
        log_odds=t("log_odds"),
        min_bounds=t("min_bounds"),
        max_bounds=t("max_bounds"),
        used=t("used", np.int64),
        poisoned=t("poisoned", bool),
    )


def hash_state_to_numpy(state: HashGridState) -> Dict[str, np.ndarray]:
    """NumPy arrays named like the fields, in the JAX package's dtypes
    (uint32 key words, int32 ``used``)."""
    out = {name: getattr(state, name).cpu().numpy() for name in _STATE_FIELDS}
    rows = out["key_rows"]
    if (rows > U32).any() or (rows < 0).any():
        raise ValueError("key_rows holds a value outside u32")
    out["key_rows"] = rows.astype(np.uint32)
    out["used"] = out["used"].astype(np.int32)
    return out
