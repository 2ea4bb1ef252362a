"""Brick grid — sparse hash of dense voxel bricks (PyTorch port of
``sonar_3d_reconstruction_tpu.grid.brick``, compact box-key window apply).

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
kernel and ``batch_n_lanes`` counts candidate lanes.

A ``touched`` bitmask per brick keeps the reference's touched-voxel
semantics: a never-updated voxel (p = 0.5, not reported) differs from an
updated voxel whose log-odds is 0.0.

Window sizes come from the actual counts (eager PyTorch has no static
shapes), so the JAX package's lane, brick, insert and unique budgets and
their overflows do not exist here.  A window fails all-or-nothing, leaving
the table untouched and the state poisoned, when a bucket would overflow
(the host grows the table and replays) or on the fatal key-range and
count-packing errors.  Table updates are out of place: each window returns
new tensors and never writes into the state it was given.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.grid.hash import (
    BUCKET_SLOTS,
    bucket_lookup,
    commit_insert,
    empty_key_rows,
    plan_insert,
)
from sonar_3d_reconstruction_tpu_torch.kernels.bin_apply import (
    bin_apply,
    bin_apply_raw,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import CompactRecords
from sonar_3d_reconstruction_tpu_torch.ops.logodds import probability_to_log_odds
from sonar_3d_reconstruction_tpu_torch.ops.packing import (
    EMPTY32,
    EMPTY_HI,
    U32,
    pack_brick_keys,
    unpack_box_brick,
    unpack_brick_keys,
)
from sonar_3d_reconstruction_tpu_torch.ops.records import FrameAux

DEFAULT_BRICK_BITS = 2  # 4x4x4 = 64 voxels per brick

_BRICK_BITS_BY_VOLUME = {8: 1, 64: 2, 512: 3}

# window apply modes: unique records, or raw candidates summed by K1
DENSE_MODES = ("pallas", "pallas-raw")


def is_raw_mode(dense_mode: str) -> bool:
    """Whether ``dense_mode`` takes raw candidates; raises ValueError on a
    mode the port does not accept (the JAX package's tile-size suffixes
    such as ``-tb16`` size TPU tiles and mean nothing here)."""
    if dense_mode not in DENSE_MODES:
        raise ValueError(
            f"dense_mode {dense_mode!r} is not accepted; use one of "
            f"{DENSE_MODES}"
        )
    return dense_mode == "pallas-raw"


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
) -> Tuple[BrickGridState, Dict[str, torch.Tensor]]:
    """Apply one window of B frames of box-key records to the brick map.

    ``recs`` are unique records, or raw candidates when ``dense_mode`` is
    ``"pallas-raw"``.  Returns (new state, per-frame stats of shape (B,)):
    ``num_occupied`` and ``num_free`` (unique voxels by type),
    ``num_candidates`` (valid emissions), ``overflowed``, ``range_fail``,
    ``pack_overflow``, and the window's ``batch_n_bricks`` /
    ``batch_n_lanes`` (record lanes; candidate lanes in raw mode) sizes.
    """
    raw = is_raw_mode(dense_mode)
    B, U = recs.key.shape
    bb = state.brick_bits
    o = 3 * bb
    f_bits = max(1, (B - 1).bit_length())
    if sum(box_bits) + o + f_bits > 31:
        raise ValueError(f"box bits {box_bits} + {B} frames exceed 31 key bits")
    device = state.log_odds.device
    box_min = torch.as_tensor(np.asarray(box_min), device=device)

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
        B=B, f_bits=f_bits, o=o, raw=raw, recs=recs, auxs=auxs,
        n_lanes=n_lanes, n_bricks=n_bricks,
    )


def _apply_window_tail(
    state: BrickGridState,
    cfg: MapperConfig,
    c_hi, c_lo, s_flat, s_pay, starts,
    *,
    B, f_bits, o, raw, recs, auxs, n_lanes, n_bricks,
) -> Tuple[BrickGridState, Dict[str, torch.Tensor]]:
    """Table lookup/insert at the window's bricks, K1, commit and stats."""
    vol = state.brick_volume
    dtype, device = state.log_odds.dtype, state.log_odds.device
    # raw candidates carry count 1 each and are summed unpacked: no packing
    # width to overflow
    pack_overflow = (torch.zeros((), dtype=torch.bool, device=device) if raw
                     else recs.pack_fail.any())

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
        rec_occ = recs.valid & (recs.n_occ > 0)
        num_occupied = rec_occ.sum(dim=1)
        num_free = (recs.valid & ~rec_occ).sum(dim=1)
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


def rehash_bricks(state: BrickGridState, new_capacity: int) -> BrickGridState:
    """Grow the table (clears ``poisoned`` for replay), doubling again until
    every existing bucket fits.  Existing keys are re-inserted in slot
    order, as the JAX package does."""
    device = state.key_rows.device
    hi, lo = state.key_hi, state.key_lo
    occupied = hi != EMPTY_HI
    while True:
        fresh = empty_key_rows(new_capacity, device)
        bucket, _, _, fill = bucket_lookup(fresh, hi, lo)
        plan = plan_insert(fresh, hi, lo, occupied, bucket, fill)
        if not bool(plan.overflowed):
            break
        new_capacity *= 2
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
    )


def _brick_voxel_points(
    hi: np.ndarray, lo: np.ndarray, vol: int, brick_bits: int,
    resolution: float,
) -> np.ndarray:
    """(N,) brick codes -> (N, vol, 3) float64 voxel centers."""
    base = unpack_brick_keys(
        torch.as_tensor(hi), torch.as_tensor(lo), brick_bits
    ).numpy()
    off = np.arange(vol, dtype=np.int64)
    b = 1 << brick_bits
    offs = np.stack(
        [off >> (2 * brick_bits), (off >> brick_bits) & (b - 1), off & (b - 1)],
        axis=-1,
    )
    keys = base[:, None, :] + offs[None, :, :]
    return (keys.astype(np.float64) + 0.5) * resolution


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
    sel = (tbits & (state.log_odds > t)).any(dim=1) & (state.key_hi != EMPTY_HI)
    idx = torch.nonzero(sel).squeeze(1)
    if idx.numel() == 0:
        return np.empty((0, 3)), np.empty((0,))
    hi = state.key_hi[idx].cpu().numpy()
    lo = state.key_lo[idx].cpu().numpy()
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    rows = state.log_odds[idx].cpu().numpy()[order].astype(np.float64)
    touched = _unpack_touched(state.touched[idx].cpu(), vol).numpy()[order]
    mask = touched & (rows > thr)
    points = _brick_voxel_points(hi, lo, vol, state.brick_bits,
                                 cfg.voxel_resolution)[mask]
    probs = 1.0 / (1.0 + np.exp(-rows[mask]))
    return points.reshape(-1, 3), probs


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
