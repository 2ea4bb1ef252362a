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
There are no budgets: every record width comes from the counts.  An update
fails all-or-nothing, returning its input state with ``poisoned`` set,
when a bucket would overflow (the host grows the table with ``rehash`` and
replays) or on keys outside the packable range (fatal).  Updates are out
of place: each returns new tensors and never writes into the state it was
given.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

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
    overflowed: torch.Tensor  # () bool a bucket would exceed BUCKET_SLOTS


def plan_insert(
    key_rows: torch.Tensor,
    u_hi: torch.Tensor,
    u_lo: torch.Tensor,
    need: torch.Tensor,
    bucket: torch.Tensor,
    fill: torch.Tensor,
) -> InsertPlan:
    """Plan a collision-free insert of mutually distinct new keys.

    Keys flagged by ``need`` (distinct and absent from the table) are
    sorted by bucket and ranked within equal buckets; key i's slot is
    bucket*128 + fill + rank.  Nothing is written here: the caller commits
    with ``commit_insert`` only when the plan did not overflow.
    """
    u = u_hi.shape[0]
    device = u_hi.device
    capacity = key_rows.shape[0] * BUCKET_SLOTS
    idx = torch.arange(u, device=device)

    ins_key = torch.where(need, bucket, U32)
    s_bkt, s_orig = torch.sort(ins_key, stable=True)
    s_hi, s_lo, s_fill = u_hi[s_orig], u_lo[s_orig], fill[s_orig]
    new_b = torch.cat([
        torch.ones(1, dtype=torch.bool, device=device), s_bkt[1:] != s_bkt[:-1]
    ])
    start = running_max(torch.where(new_b, idx, -1))
    rank = idx - start
    active = s_bkt != U32
    pos = s_fill + rank
    fits = active & (pos < BUCKET_SLOTS)
    overflowed = (active & ~fits).any()
    pos_c = torch.clamp(pos, max=BUCKET_SLOTS - 1)
    slot = s_bkt * BUCKET_SLOTS + pos_c
    # slots back in record order; lanes that do not fit write the dump
    # lane u, cut off below
    slots = torch.full((u + 1,), capacity, dtype=torch.int64, device=device)
    slots[torch.where(fits, s_orig, u)] = slot
    return InsertPlan(
        s_hi=s_hi, s_lo=s_lo, s_bkt=s_bkt, pos_c=pos_c, fits=fits,
        slots=slots[:u], overflowed=overflowed,
    )


def commit_insert(key_rows: torch.Tensor, plan: InsertPlan) -> torch.Tensor:
    """A new table with the planned keys written (both words in one
    scatter into the interleaved rows); lanes that do not fit write a dump
    word past the end, which is cut off."""
    n_buckets = key_rows.shape[0]
    flat_n = n_buckets * 2 * BUCKET_SLOTS
    base = plan.s_bkt * (2 * BUCKET_SLOTS) + plan.pos_c
    tgt_hi = torch.where(plan.fits, base, flat_n)
    tgt_lo = torch.where(plan.fits, base + BUCKET_SLOTS, flat_n)
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


def update_hash_grid(
    state: HashGridState,
    candidates: Dict[str, torch.Tensor],
    cfg: MapperConfig,
) -> Tuple[HashGridState, Dict[str, torch.Tensor]]:
    """Apply one ping's candidate emissions (``backproject_ping``'s dict)
    to the hash map.  Returns (state, stats: ``num_occupied`` /
    ``num_free`` unique voxels by type, ``num_candidates`` valid emissions,
    ``overflowed``, ``range_fail``, ``batch_n_unique``).  A frame that
    would overflow a bucket, has keys out of the packable range, or meets
    a poisoned state returns the input state with ``poisoned`` set."""
    from sonar_3d_reconstruction_tpu_torch.ops.records import FrameAux

    dtype = state.log_odds.dtype
    pts = candidates["points"]
    keys = voxel_keys(pts, cfg.voxel_resolution)
    hi, lo, in_range = pack_keys(keys)
    valid = candidates["valid"]
    range_fail = (valid & ~in_range).any()
    valid = valid & in_range
    rec = dedup_frame(hi, lo, candidates["is_occupied"], valid, brick=False)
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
    return apply_frame_records(state, rec, aux, cfg)


def apply_records_batched(
    state: HashGridState,
    recs: UniqueRecords,   # stacked over B frames: (B, U), voxel codes
    auxs,                  # ops.records.FrameAux stacked over B frames
    cfg: MapperConfig,
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
    """
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


def plan_fresh_insert(capacity: int, hi, lo, need) -> Tuple[torch.Tensor, InsertPlan]:
    """(empty key rows, plan) inserting the distinct keys ``need`` flags
    into an empty table of ``capacity`` slots, doubling it until no bucket
    overflows.  An empty table finds nothing and every bucket's fill is 0,
    so no bucket rows are gathered."""
    while True:
        fresh = empty_key_rows(capacity, hi.device)
        bucket = mix2(hi, lo) & (fresh.shape[0] - 1)
        plan = plan_insert(fresh, hi, lo, need, bucket, torch.zeros_like(bucket))
        if not bool(plan.overflowed):
            return fresh, plan
        capacity *= 2


def rehash(state: HashGridState, new_capacity: int) -> HashGridState:
    """Grow the table (clears ``poisoned`` for replay), doubling again until
    every existing bucket fits.  Existing keys are re-inserted in slot
    order, as the JAX package does."""
    hi, lo = state.key_hi, state.key_lo
    fresh, plan = plan_fresh_insert(new_capacity, hi, lo, hi != EMPTY_HI)
    new_capacity = fresh.shape[0] * BUCKET_SLOTS
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
    )


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
