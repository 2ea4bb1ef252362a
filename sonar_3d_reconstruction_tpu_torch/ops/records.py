"""Frame records: the state-independent half of the map update (PyTorch port
of ``sonar_3d_reconstruction_tpu.ops.records``, compact box-key path).

A frame's contribution to the map is its unique-voxel records plus a few
reductions (bounds, range check).  They need only the ping and its pose,
not the map, so the sequential dependency of the adaptive update lives
entirely in the window apply.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
    FanTables,
    backproject_ping,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import (
    CompactRecords,
    dedup_frame_compact,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import EMPTY32, pack_box_keys


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
    box_min: torch.Tensor,
    box_bits: Tuple[int, int, int],
    brick_bits: int,
    dtype: torch.dtype = torch.float32,
    raw: bool = False,
) -> Tuple[CompactRecords, FrameAux]:
    """One ping -> (CompactRecords, FrameAux) with box-relative keys.

    A candidate outside the box reports through ``range_fail`` (the host
    gate ``compute_window_boxes`` makes that impossible for its boxes).

    ``raw=True`` skips the per-frame dedup: every valid candidate is its
    own record with payload ``1 << 16 | occ``, in the lane the candidate
    lattice gave it (valid records are NOT a prefix), and ``n_unique`` is
    the valid count.  Only the raw window apply (``bin_apply_raw``, which
    sums records per slot) may consume them.
    """
    cand = backproject_ping(image, T_sonar_to_world, tables, cfg, dtype=dtype)
    device = image.device
    res = torch.full((), cfg.voxel_resolution, dtype=dtype, device=device)

    # a true division, as in the reference's floor(p / res) keying
    keys = torch.floor(cand["points"] / res).to(torch.int32)
    bkey, in_range = pack_box_keys(keys, box_min, box_bits, brick_bits)
    valid = cand["valid"]
    range_fail = (valid & ~in_range).any()
    valid = valid & in_range
    if raw:
        occ = cand["is_occupied"].to(torch.int64)
        rec = CompactRecords(
            key=torch.where(valid, bkey, EMPTY32),
            payload=torch.where(valid, (1 << 16) | occ, 0),
            n_unique=valid.sum(),
            pack_fail=torch.zeros((), dtype=torch.bool, device=device),
        )
    else:
        rec = dedup_frame_compact(bkey, cand["is_occupied"], valid)

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

    aux = FrameAux(
        cmin=torch.where(any_valid, center(kmin), inf),
        cmax=torch.where(any_valid, center(kmax), -inf),
        range_fail=range_fail,
        n_valid=n_valid,
    )
    return rec, aux
