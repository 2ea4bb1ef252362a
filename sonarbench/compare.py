"""The comparison that decides ``correct``: what the timed pass produced
against the plain reference (``sonarbench.reference``) of the same pass.

Three numbers, each held to its limit in the cell's file
(``sonarbench/cells/<cell>.json``, ``limits``):

* ``stats_gap``: the largest gap, in counts, between the program's and the
  reference's ``num_candidates``, ``num_occupied`` or ``num_free`` of any
  ping of the pass;
* ``keys_gap_ppm``: the voxels in one map and not the other, per million
  voxels of the reference's map;
* ``logodds_gap_ppm``: the voxels of both maps whose log-odds differ by
  more than ``LOGODDS_TOL``, per million voxels of both.

A float32 program differs from the float64 reference where a point lies
within rounding of a voxel face: the point lands in the neighbouring
voxel, which moves a ping's unique counts and that voxel's mean update.
``LOGODDS_TOL`` is float32's rounding over a voxel's chain of updates
(each within half an ulp of 10, about 5e-7, over at most some hundred
updates) with room; a voxel moved by a misplaced point differs by far
more.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sonarbench import reference

LOGODDS_TOL = 1e-3
STATS = ("num_candidates", "num_occupied", "num_free")
NUMBERS = ("stats_gap", "keys_gap_ppm", "logodds_gap_ppm")


def numbers(prog_stats: Dict[str, np.ndarray], prog_keys: np.ndarray,
            prog_log_odds: np.ndarray, ref: Dict) -> Dict[str, float]:
    """The three numbers of one pass (module docstring)."""
    gap = max(int(np.abs(np.asarray(prog_stats[k], np.int64)
                         - np.asarray(ref[k], np.int64)).max())
              for k in STATS)
    device = ref["codes"].device
    codes = reference.pack_keys(prog_keys).to(device)
    order = torch.argsort(codes)
    codes = codes[order]
    lo = torch.as_tensor(np.asarray(prog_log_odds)).to(device)[order]
    ref_codes = ref["codes"]
    pos = torch.searchsorted(ref_codes, codes).clamp(max=len(ref_codes) - 1)
    common = ref_codes[pos] == codes if len(ref_codes) else \
        torch.zeros_like(codes, dtype=torch.bool)
    n_common = int(common.sum())
    n_ref = len(ref_codes)
    only = (len(codes) - n_common) + (n_ref - n_common)
    diff = (lo[common].to(torch.float64)
            - ref["log_odds"][pos[common]].to(torch.float64)).abs()
    bad = int((diff > LOGODDS_TOL).sum())
    return {
        "stats_gap": float(gap),
        "keys_gap_ppm": 1e6 * only / max(n_ref, 1),
        "logodds_gap_ppm": 1e6 * bad / max(n_common, 1),
    }


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Whether every number is within its limit (a number with no
    reading, or with no limit, fails)."""
    return all(k in nums and k in limits and nums[k] <= limits[k]
               for k in NUMBERS)
