"""Bucketed key table operations (PyTorch port of the bucket ops of
``sonar_3d_reconstruction_tpu.grid.hash``).

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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sonar_3d_reconstruction_tpu_torch.ops.packing import EMPTY_HI, U32, mix2

# Slots per bucket (one row gather resolves a whole bucket).
BUCKET_SLOTS = 128


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
    start = torch.cummax(torch.where(new_b, idx, -1), dim=0).values
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

