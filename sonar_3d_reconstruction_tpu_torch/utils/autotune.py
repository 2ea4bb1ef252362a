"""Deployment budget plans (PyTorch port of
``sonar_3d_reconstruction_tpu.utils.autotune``).

A plan gives the fixed-width windows (pipeline.py, grid/brick.py,
grid/hash.py) budgets measured on the survey itself:

    plan = tune_sequence(images, positions, quats, cfg, device="cuda")
    state, stats = map_ping_sequence(..., budgets=plan)
    # or: python -m sonar_3d_reconstruction_tpu_torch tune BAG --out plan.json
    #     python -m sonar_3d_reconstruction_tpu_torch map-bag BAG --budgets plan.json

One warm-up run at the JAX package's default budgets (with its growth)
measures the per-ping and per-window counts, and the snug formulas below,
the JAX package's, add their margins.  The counts are the same on every
device and in both packages, so a plan tuned by either package, on any
device, drives either.  A stale plan costs a replay, never correctness:
every overflow is detected with its cause and the run grows and replays.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _round_up(x, m=8192):
    return int(-(-x // m) * m)


def _window_need(stats: Dict[str, np.ndarray], window: int) -> np.ndarray:
    """The largest ``batch_n_need`` of each window."""
    need = np.asarray(stats["batch_n_need"]).astype(np.int64)
    pad = (-len(need)) % window
    return np.pad(need, (0, pad)).reshape(-1, window).max(axis=1)


def snug_budgets_hash(
    stats: Dict[str, np.ndarray], window: int, unique_budget: int,
    batch_budget: int,
) -> Dict[str, Any]:
    """Snug budgets for the hash backend from a warm-up run's stats:
    1.25x uniques (rounded up to 8192), 1.1x valid candidates for the
    dedup slice, 1.15x batch and insert, with a [cold, warm] insert pair
    (a fresh map's first window inserts nearly everything)."""
    out: Dict[str, Any] = {
        "unique_budget": unique_budget,
        "batch_budget": batch_budget,
        "lane_budget": None,
        "insert_budget": None,
        "dedup_lane_budget": 0,
        "safe_unique_budget": unique_budget,
        "safe_batch_budget": batch_budget,
    }
    per_frame = (np.asarray(stats["num_occupied"])
                 + np.asarray(stats["num_free"])).astype(np.int64)
    max_frame = int(per_frame.max())
    max_valid = int(np.asarray(stats["num_candidates"]).max())
    snug_u = min(_round_up(1.25 * max_frame), unique_budget)
    out["dedup_lane_budget"] = max(_round_up(1.1 * max_valid), snug_u)
    snug_b = batch_budget
    if "batch_n_unique" in stats:
        max_batch = int(np.asarray(stats["batch_n_unique"]).max())
        snug_b = min(_round_up(1.15 * max_batch), batch_budget)
        pad = (-len(per_frame)) % window
        win_lanes = np.pad(per_frame, (0, pad)).reshape(-1, window).sum(axis=1)
        out["lane_budget"] = max(_round_up(1.1 * int(win_lanes.max())), snug_b)
    if "batch_n_need" in stats:
        win_need = _window_need(stats, window)
        cold = min(_round_up(1.15 * int(win_need[0])), snug_b)
        warm = min(_round_up(1.15 * int(win_need[1:].max())), cold) \
            if len(win_need) > 1 else cold
        out["insert_budget"] = [cold, warm]
    out["unique_budget"] = snug_u
    out["batch_budget"] = snug_b
    return out


def snug_budgets_brick(
    stats: Dict[str, np.ndarray], window: int, unique_budget: int,
    brick_budget: int, dense_mode: str = "scalar",
) -> Dict[str, Any]:
    """Snug budgets for the brick backend from a warm-up run's stats:
    1.1x uniques and 1.05x valid candidates (rounded up to 4096), 1.15x
    bricks (to 1024), 1.1x lanes (to 8192), a [cold, warm] insert pair,
    and, for the JAX ``"row"`` layout, 1.1x the window's distinct voxels
    as ``vox_budget``."""
    out: Dict[str, Any] = {
        "unique_budget": unique_budget,
        "brick_budget": brick_budget,
        "lane_budget": None,
        "insert_budget": None,
        "vox_budget": None,
        "dedup_lane_budget": 0,
        "safe_unique_budget": unique_budget,
        "safe_brick_budget": brick_budget,
    }
    max_frame = int(
        (np.asarray(stats["num_occupied"])
         + np.asarray(stats["num_free"])).max()
    )
    max_valid = int(np.asarray(stats["num_candidates"]).max())
    snug_u = min(_round_up(1.1 * max_frame, 4096), unique_budget)
    out["dedup_lane_budget"] = max(_round_up(1.05 * max_valid, 4096), snug_u)
    out["brick_budget"] = min(
        _round_up(1.15 * int(np.asarray(stats["batch_n_bricks"]).max()), 1024),
        brick_budget,
    )
    out["lane_budget"] = _round_up(
        1.1 * int(np.asarray(stats["batch_n_lanes"]).max())
    )
    win_need = _window_need(stats, window)
    cold = _round_up(1.15 * int(win_need[0]), 1024)
    warm = min(_round_up(1.15 * int(win_need[1:].max()), 1024), cold) \
        if len(win_need) > 1 else cold
    out["insert_budget"] = [cold, warm]
    out["unique_budget"] = snug_u
    if dense_mode == "row":
        out["vox_budget"] = _round_up(
            1.1 * int(np.asarray(stats["batch_n_unique"]).max()), 4096
        )
    return out


def tune_sequence(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg=None,
    *,
    backend: str = "brick",
    window: int = 8,
    dense_mode: str = "pallas",
    dtype: torch.dtype = torch.float32,
    initial_capacity: Optional[int] = None,
    device=None,
) -> Dict[str, Any]:
    """One warm-up mapping run on ``device`` -> a deployment budget plan
    (a JSON-able dict with the JAX package's keys): the snug budgets, the
    ``safe_*`` budgets the warm-up settled on, and the ``backend``,
    ``window``, ``dense_mode`` (as given; it names the layout the plan
    budgets for, and only ``"row"`` adds a budget), ``capacity`` and the
    fan-table caps it was tuned at.

    The warm-up maps at the JAX package's default budgets with its growth,
    on unique records (its ``"bfv"`` layout; K1 here), from a fresh map of
    ``initial_capacity`` (default: ``1 << 16`` bricks, or ``1 << 20``
    hash slots, the JAX package's).  ``device`` as in
    ``map_ping_sequence`` (None: the first CUDA device)."""
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.grid.brick import parse_dense_mode
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    parse_dense_mode(dense_mode)
    if backend not in ("brick", "hash"):
        raise ValueError(f"plans are for the brick and hash backends, not "
                         f"{backend!r}")
    cfg = cfg or MapperConfig()
    if initial_capacity is None:
        initial_capacity = 1 << 16 if backend == "brick" else 1 << 20
    effective: Dict[str, Any] = {}
    _, stats = map_ping_sequence(
        images, positions, quaternions, cfg, device=device, backend=backend,
        dtype=dtype, window=window, dense_mode="pallas", budgets={},
        effective=effective, initial_capacity=initial_capacity,
    )
    if backend == "brick":
        budgets = snug_budgets_brick(
            stats, window, effective["unique_budget"],
            effective["brick_budget"], dense_mode,
        )
    else:
        budgets = snug_budgets_hash(
            stats, window, effective["unique_budget"],
            effective["batch_budget"],
        )
    budgets.update(
        backend=backend,
        window=window,
        dense_mode=dense_mode,
        capacity=int(effective["capacity"]),
        fan_cap=int(effective["fan_cap"]),
        window_cap=int(effective["window_cap"]),
        free_cap=int(effective["free_cap"]),
    )
    return budgets
