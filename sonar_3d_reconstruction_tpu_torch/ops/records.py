"""Frame records: the state-independent half of the map update (PyTorch port
of ``sonar_3d_reconstruction_tpu.ops.records``).

A frame's contribution to the map is its unique-voxel records plus a few
reductions (bounds, range check).  They need only the ping and its pose,
not the map, so the sequential dependency of the adaptive update lives
entirely in the window apply.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
    FanTables,
    backproject_ping,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import (
    CompactRecords,
    UniqueRecords,
    dedup_frame,
    dedup_frame_compact,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import (
    EMPTY32,
    pack_box_keys,
    pack_brick_keys,
    pack_keys,
)


class FrameAux(NamedTuple):
    """Per-frame reductions that accompany the unique records."""

    cmin: torch.Tensor        # (3,) min updated-voxel center (inf if none)
    cmax: torch.Tensor        # (3,) max updated-voxel center (-inf if none)
    range_fail: torch.Tensor  # () bool: a valid key fell outside the box
    n_valid: torch.Tensor     # () int64 valid candidate emissions


def frame_records(
    image: torch.Tensor,
    T_sonar_to_world: torch.Tensor,
    tables: FanTables,
    cfg: MapperConfig,
    box_min: Optional[torch.Tensor],
    box_bits: Optional[Tuple[int, int, int]],
    brick_bits: int,
    dtype: torch.dtype = torch.float32,
    raw: bool = False,
) -> Tuple[Union[CompactRecords, UniqueRecords], FrameAux]:
    """One ping -> (records, FrameAux).

    With a box (``box_min``, ``box_bits``) the records are CompactRecords
    with box-relative keys, and a candidate outside the box reports through
    ``range_fail`` (the host gate ``compute_window_boxes`` makes that
    impossible for its boxes).  Without one (``box_min=None``) they are
    UniqueRecords with two-word keys: brick codes when ``brick_bits`` > 0,
    voxel codes (the hash backend's) when it is 0; a candidate outside the
    packable range reports through ``range_fail``.

    ``raw=True`` (box keys only) skips the per-frame dedup: every valid
    candidate is its own record with payload ``1 << 16 | occ``, in the
    lane the candidate lattice gave it (valid records are NOT a prefix),
    and ``n_unique`` is the valid count.  Only the raw window apply
    (``bin_apply_raw``, which sums records per slot) may consume them.
    """
    if raw and box_min is None:
        raise ValueError("raw records need box keys")
    cand = backproject_ping(image, T_sonar_to_world, tables, cfg, dtype=dtype)
    device = image.device
    res = torch.full((), cfg.voxel_resolution, dtype=dtype, device=device)

    # a true division, as in the reference's floor(p / res) keying
    keys = torch.floor(cand["points"] / res).to(torch.int32)
    if box_min is not None:
        bkey, in_range = pack_box_keys(keys, box_min, box_bits, brick_bits)
    elif brick_bits:
        hi, lo, in_range = pack_brick_keys(keys, brick_bits)
    else:
        hi, lo, in_range = pack_keys(keys)
    valid = cand["valid"]
    range_fail = (valid & ~in_range).any()
    valid = valid & in_range
    if box_min is None:
        rec = dedup_frame(hi, lo, cand["is_occupied"], valid, brick_bits > 0)
    elif raw:
        occ = cand["is_occupied"].to(torch.int64)
        rec = CompactRecords(
            key=torch.where(valid, bkey, EMPTY32),
            payload=torch.where(valid, (1 << 16) | occ, 0),
            n_unique=valid.sum(),
            pack_fail=torch.zeros((), dtype=torch.bool, device=device),
        )
    else:
        rec = dedup_frame_compact(bkey, cand["is_occupied"], valid)

    return rec, frame_aux(keys, valid, range_fail, res)


def frame_aux(
    keys: torch.Tensor,
    valid: torch.Tensor,
    range_fail: torch.Tensor,
    res: torch.Tensor,
) -> FrameAux:
    """A frame's FrameAux from its (N, 3) int32 voxel keys, the mask of its
    valid (in-range) emissions and the voxel size ``res``, a 0-d tensor of
    the map's dtype on the keys' device."""
    dtype, device = res.dtype, keys.device
    # bounds reduce over int keys: k -> (k + 0.5) * res is exact and
    # monotone, so min/max commute with it
    imax = torch.iinfo(torch.int32).max
    kmin = torch.where(valid[:, None], keys, imax).amin(dim=0)
    kmax = torch.where(valid[:, None], keys, -imax).amax(dim=0)
    n_valid = valid.sum()
    any_valid = n_valid > 0
    inf = torch.full((), float("inf"), dtype=dtype, device=device)

    def center(k):
        return (k.to(dtype) + 0.5) * res

    return FrameAux(
        cmin=torch.where(any_valid, center(kmin), inf),
        cmax=torch.where(any_valid, center(kmax), -inf),
        range_fail=range_fail,
        n_valid=n_valid,
    )
