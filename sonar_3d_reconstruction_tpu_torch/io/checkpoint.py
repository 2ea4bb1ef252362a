"""Map snapshot / restore for brick maps (PyTorch port of the brick half of
``sonar_3d_reconstruction_tpu.io.checkpoint``).

A snapshot is one ``.npz`` in the JAX package's ``sonar3d-map-v1`` format:
the touched voxels as UNPACKED (N, 3) int32 keys with their log-odds in
the map's dtype (a float64 map stays float64), the bounds, and the config
as JSON.  The format does not depend on the table layout, so a snapshot
saved by either package loads into the other, into a brick or a hash grid.

Only brick maps are ported: ``load_map`` (into a hash grid) waits for the
hash backend (ROADMAP item 16), and the sharded loaders for multi-GPU
(item 18).
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig, config_from_dict
from sonar_3d_reconstruction_tpu_torch.device import require_cuda
from sonar_3d_reconstruction_tpu_torch.grid.brick import (
    DEFAULT_BRICK_BITS,
    BrickGridState,
    load_voxels_brick,
    touched_voxels_brick,
)

_FORMAT = "sonar3d-map-v1"


def save_map(path: str, state: BrickGridState, cfg: MapperConfig) -> None:
    """Snapshot a brick map's touched voxels, bounds and config to ``path``."""
    keys, log_odds = touched_voxels_brick(state)
    np.savez_compressed(
        path,
        format=np.asarray(_FORMAT),
        keys=keys,
        log_odds=log_odds,
        min_bounds=state.min_bounds.cpu().numpy(),
        max_bounds=state.max_bounds.cpu().numpy(),
        config=np.asarray(json.dumps(cfg.to_dict())),
    )


def load_map_brick(
    path: str,
    capacity: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    brick_bits: Optional[int] = None,
    device=None,
) -> Tuple[BrickGridState, MapperConfig]:
    """Restore a snapshot into a fresh brick grid on ``device`` (the first
    CUDA device when None; RuntimeError where there is none).  ``dtype``
    defaults to the snapshot's value dtype; ``capacity`` (bricks) is sized
    from the voxels unless given.  Returns (state, config)."""
    device = (require_cuda() if device is None
              else torch.empty(0, device=device).device)
    with np.load(path, allow_pickle=False) as z:
        if str(z["format"]) != _FORMAT:
            raise ValueError(f"unknown snapshot format in {path}")
        keys = z["keys"]
        log_odds = z["log_odds"]
        min_bounds = z["min_bounds"]
        max_bounds = z["max_bounds"]
        cfg = config_from_dict(json.loads(str(z["config"])))
    if dtype is None:
        dtype = torch.from_numpy(log_odds[:0]).dtype
    state = load_voxels_brick(
        keys, log_odds, device, capacity=capacity, dtype=dtype,
        brick_bits=brick_bits or DEFAULT_BRICK_BITS,
    )
    return (
        state._replace(
            min_bounds=torch.as_tensor(min_bounds, device=device).to(dtype),
            max_bounds=torch.as_tensor(max_bounds, device=device).to(dtype),
        ),
        cfg,
    )
