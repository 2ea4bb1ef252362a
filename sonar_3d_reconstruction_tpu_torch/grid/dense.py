"""Dense bounded voxel grid (PyTorch port of
``sonar_3d_reconstruction_tpu.grid.dense``).

A bounded axis-aligned grid of per-voxel log-odds, one flat cell per
voxel, updated per ping with the reference's per-frame dedup/average
semantics (scripts/3d_mapper.py:523-567).  A ping's update:

  1. key its valid candidates (floor(world / resolution)) and linearize
     them into the grid; a candidate outside it counts into ``overflow``;
  2. collapse the in-grid candidates into the frame's distinct cells with
     integer per-cell ``count`` and ``n_occ``, and form each cell's summed
     log-odds ``n_occ * L_occ + (count - n_occ) * L_free`` as the brick
     and hash backends do;
  3. apply ``finalize_voxel_updates`` at those cells and mark them
     touched.

The JAX package sums the candidates' float log-odds with scatter-adds in
candidate order and counts the frame's distinct cells by a rounded float
sum of 1/count.  Integer aggregates make the port's map the same in any
order on any device, bit for bit in float64 between the card and the CPU,
and equal to the brick map on every in-grid voxel; against the JAX sums
the log-odds differ in the last bits.  The distinct-cell stats are exact
counts.  No per-frame accumulator spans the grid: the frame's cells come
from one sort of its candidates' cell indices.

Cell indices are int64; a spec of more than 2^31 - 1 cells (past the JAX
package's int32 index) raises ValueError.  Extraction selects cells on
the device (``nonzero`` keeps ascending flat order, as ``np.nonzero``
does) and computes points and probabilities on the host in float64, as
the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.grid.hash import chain_terms
from sonar_3d_reconstruction_tpu_torch.ops.logodds import (
    finalize_voxel_updates,
    probability_to_log_odds,
)

MAX_CELLS = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class DenseGridSpec:
    """Static grid geometry.  ``origin_key`` is the integer voxel key
    (floor(world / resolution)) of grid cell (0, 0, 0)."""

    origin_key: Tuple[int, int, int]
    shape: Tuple[int, int, int]
    resolution: float

    @property
    def num_cells(self) -> int:
        x, y, z = self.shape
        return x * y * z

    @staticmethod
    def for_world_bounds(
        lo: Tuple[float, float, float],
        hi: Tuple[float, float, float],
        resolution: float,
    ) -> "DenseGridSpec":
        ok = tuple(int(math.floor(v / resolution)) for v in lo)
        hk = tuple(int(math.floor(v / resolution)) for v in hi)
        shape = tuple(h - o + 1 for o, h in zip(ok, hk))
        return DenseGridSpec(origin_key=ok, shape=shape, resolution=resolution)


def default_dense_spec(cfg: MapperConfig) -> DenseGridSpec:
    """The JAX package's default grid: +-(max_range + 2 m) around the
    origin in every axis."""
    reach = cfg.max_range + 2.0
    return DenseGridSpec.for_world_bounds(
        (-reach,) * 3, (reach,) * 3, cfg.voxel_resolution
    )


class DenseGridState(NamedTuple):
    """Map state."""

    log_odds: torch.Tensor    # (num_cells,) flattened
    touched: torch.Tensor     # (num_cells,) bool: the voxel was updated
    min_bounds: torch.Tensor  # (3,) running min over updated voxel centres
    max_bounds: torch.Tensor  # (3,)
    overflow: torch.Tensor    # () int64 count of candidates outside the grid


def init_dense_grid(
    spec: DenseGridSpec, dtype: torch.dtype, device
) -> DenseGridState:
    n = spec.num_cells
    if n > MAX_CELLS:
        raise ValueError(
            f"dense grid of {n} cells exceeds {MAX_CELLS} (the int32 cell "
            f"index of the JAX package); use a smaller spec"
        )
    inf = float("inf")
    return DenseGridState(
        log_odds=torch.zeros((n,), dtype=dtype, device=device),
        touched=torch.zeros((n,), dtype=torch.bool, device=device),
        min_bounds=torch.full((3,), inf, dtype=dtype, device=device),
        max_bounds=torch.full((3,), -inf, dtype=dtype, device=device),
        overflow=torch.zeros((), dtype=torch.int64, device=device),
    )


def voxel_keys(points: torch.Tensor, resolution: float) -> torch.Tensor:
    """floor(world / resolution) int64 keys (reference 3d_mapper.py:63-66),
    a true division in the points' dtype."""
    res = torch.full((), resolution, dtype=points.dtype, device=points.device)
    return torch.floor(points / res).to(torch.int64)


def linearize_keys(keys, spec: DenseGridSpec):
    """Integer voxel keys (torch or NumPy) -> (in-bounds mask, int64 linear
    cell index): the grid's one key -> cell mapping, shared by the update
    and the point queries."""
    if isinstance(keys, np.ndarray):
        idx3 = keys.astype(np.int64) - np.asarray(spec.origin_key, np.int64)
        shape = np.asarray(spec.shape, np.int64)
    else:
        idx3 = keys.to(torch.int64) - torch.tensor(
            spec.origin_key, dtype=torch.int64, device=keys.device)
        shape = torch.tensor(spec.shape, dtype=torch.int64, device=keys.device)
    in_bounds = (idx3 >= 0).all(-1) & (idx3 < shape).all(-1)
    lin = (idx3[..., 0] * spec.shape[1] + idx3[..., 1]) * spec.shape[2] \
        + idx3[..., 2]
    return in_bounds, lin


def update_dense_grid_(
    state: DenseGridState,
    candidates: Dict[str, torch.Tensor],
    spec: DenseGridSpec,
    cfg: MapperConfig,
) -> Tuple[DenseGridState, Dict[str, torch.Tensor]]:
    """``update_dense_grid`` writing ``state``'s log-odds and touched
    tensors in place (the returned state shares them)."""
    dtype = state.log_odds.dtype
    pts = candidates["points"]
    keys = voxel_keys(pts, spec.resolution)
    in_bounds, lin = linearize_keys(keys, spec)
    valid = candidates["valid"]
    ok = valid & in_bounds

    # the frame's distinct cells, with integer aggregates
    sel = torch.nonzero(ok).squeeze(1)
    cells, inverse, count = torch.unique(
        lin[sel], return_inverse=True, return_counts=True
    )
    n_occ = torch.zeros_like(count).index_add_(
        0, inverse, candidates["is_occupied"][sel].to(torch.int64)
    )
    lo_sum, c, occupied = chain_terms(count, n_occ, dtype, cfg)
    state.log_odds[cells] = finalize_voxel_updates(
        state.log_odds[cells], lo_sum, c, occupied, cfg
    )
    state.touched[cells] = True

    # bounds over updated voxel centres (reference 3d_mapper.py:112-115),
    # reduced over int keys: k -> (k + 0.5) * res is exact and monotone
    res = torch.full((), spec.resolution, dtype=dtype, device=pts.device)
    imax = torch.iinfo(torch.int64).max
    kmin = torch.where(ok[:, None], keys, imax).amin(dim=0)
    kmax = torch.where(ok[:, None], keys, -imax).amax(dim=0)
    n_ok = ok.sum()
    inf = torch.full((), float("inf"), dtype=dtype, device=pts.device)
    cmin = torch.where(n_ok > 0, (kmin.to(dtype) + 0.5) * res, inf)
    cmax = torch.where(n_ok > 0, (kmax.to(dtype) + 0.5) * res, -inf)
    new_state = state._replace(
        min_bounds=torch.minimum(state.min_bounds, cmin),
        max_bounds=torch.maximum(state.max_bounds, cmax),
        overflow=state.overflow + (valid & ~in_bounds).sum(),
    )
    stats = {
        "num_occupied": occupied.sum(),
        "num_free": (~occupied).sum(),
        "num_candidates": n_ok,
    }
    return new_state, stats


def copy_dense_grid(state: DenseGridState) -> DenseGridState:
    """A state that shares no tensor with ``state``."""
    return DenseGridState(*(t.clone() for t in state))


def update_dense_grid(
    state: DenseGridState,
    candidates: Dict[str, torch.Tensor],
    spec: DenseGridSpec,
    cfg: MapperConfig,
) -> Tuple[DenseGridState, Dict[str, torch.Tensor]]:
    """Apply one ping's candidate emissions (``backproject_ping``'s dict)
    to the map; ``state`` is left as it was.

    Returns (new state, stats mirroring the reference process_sonar_image
    return, 3d_mapper.py:587-595): ``num_occupied`` / ``num_free`` count
    the distinct in-grid voxels updated this frame by type,
    ``num_candidates`` the in-grid valid emissions.
    """
    return update_dense_grid_(copy_dense_grid(state), candidates, spec, cfg)


# ---------------------------------------------------------------------------
# Reads: cells selected on the device, points and probabilities on the host
# ---------------------------------------------------------------------------

def _points_and_probs(flat, vals, spec: DenseGridSpec):
    """Host (points (N, 3), probabilities (N,)) float64 of flat cell
    indices and their log-odds."""
    keys = np.stack(np.unravel_index(flat, spec.shape), axis=-1) + np.asarray(
        spec.origin_key
    )
    points = (keys.astype(np.float64) + 0.5) * spec.resolution
    probs = 1.0 / (1.0 + np.exp(-vals.astype(np.float64)))
    return points, probs


def extract_occupied(
    state: DenseGridState, spec: DenseGridSpec, cfg: MapperConfig
) -> Tuple[np.ndarray, np.ndarray]:
    """(points (N, 3), probabilities (N,)) of touched voxels with log-odds
    strictly above the min_probability threshold (reference
    3d_mapper.py:127-153), in ascending cell order."""
    lo = state.log_odds
    # the threshold in the grid's dtype, as the JAX package's NumPy
    # comparison of its log-odds with a Python float makes it
    thr = torch.tensor(probability_to_log_odds(cfg.min_probability, cfg),
                       dtype=lo.dtype, device=lo.device)
    flat = torch.nonzero(state.touched & (lo > thr)).squeeze(1)
    return _points_and_probs(flat.cpu().numpy(), lo[flat].cpu().numpy(), spec)


def extract_classified(
    state: DenseGridState, spec: DenseGridSpec, cfg: MapperConfig
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Three-way free / unknown / occupied split of the touched voxels
    (reference 3d_mapper.py:155-188), each in ascending cell order."""
    flat = torch.nonzero(state.touched).squeeze(1)
    vals = state.log_odds[flat].cpu().numpy()
    flat = flat.cpu().numpy()
    lo = vals.astype(np.float64)
    free_thr = np.log(0.3 / 0.7)
    occ_thr = np.log(cfg.min_probability / (1.0 - cfg.min_probability))
    # if/elif classification (reference 3d_mapper.py:169-176): exclusive
    # even when min_probability < 0.3 puts occ_thr below free_thr
    free_m = lo < free_thr
    occ_m = ~free_m & (lo > occ_thr)
    masks = {"free": free_m, "occupied": occ_m, "unknown": ~free_m & ~occ_m}
    return {name: _points_and_probs(flat[m], vals[m], spec)
            for name, m in masks.items()}


def query_probability_dense(
    state: DenseGridState, points, spec: DenseGridSpec, cfg
) -> np.ndarray:
    """(N, 3) world points -> (N,) float64 occupancy probabilities;
    untouched and out-of-grid voxels answer 0.5 (reference
    SimpleOctree.get_probability, 3d_mapper.py:122-126).  Points are keyed
    in float64 on the host and their cells gathered on the device."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    keys = np.floor(pts / spec.resolution).astype(np.int64)
    in_b, lin = linearize_keys(keys, spec)
    idx = torch.as_tensor(np.where(in_b, lin, 0), device=state.log_odds.device)
    lo = state.log_odds[idx].cpu().numpy().astype(np.float64)
    touched = state.touched[idx].cpu().numpy()
    lo = np.where(in_b & touched, lo, 0.0)
    return 1.0 / (1.0 + np.exp(-lo))


_STATE_FIELDS = DenseGridState._fields


def dense_state_from_numpy(d, device) -> DenseGridState:
    """A state from NumPy arrays named like the fields (the JAX package's
    ``DenseGridState`` as NumPy)."""
    def t(name, dtype=None):
        return torch.as_tensor(np.array(d[name], dtype=dtype), device=device)

    return DenseGridState(
        log_odds=t("log_odds"),
        touched=t("touched", bool),
        min_bounds=t("min_bounds"),
        max_bounds=t("max_bounds"),
        overflow=t("overflow", np.int64),
    )


def dense_state_to_numpy(state: DenseGridState) -> Dict[str, np.ndarray]:
    """NumPy arrays named like the fields, in the JAX package's dtypes
    (int32 ``overflow``)."""
    out = {name: getattr(state, name).cpu().numpy() for name in _STATE_FIELDS}
    out["overflow"] = out["overflow"].astype(np.int32)
    return out
