"""Map snapshot / restore (PyTorch port of
``sonar_3d_reconstruction_tpu.io.checkpoint`` for brick and hash maps).

A snapshot is one ``.npz`` in the JAX package's ``sonar3d-map-v1`` format:
the touched voxels as UNPACKED (N, 3) int32 keys with their log-odds in
the map's dtype (a float64 map stays float64), the bounds, and the config
as JSON.  The format does not depend on the table layout, so a snapshot
saved by either package, from either backend, loads into the other, into
a brick grid (``load_map_brick``) or a hash grid (``load_map``).  A dense
map has no snapshot, as in the JAX package.  The sharded loaders wait for
multi-GPU (ROADMAP item 18).
"""

from __future__ import annotations

import json
from typing import Optional, Tuple, Union

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
from sonar_3d_reconstruction_tpu_torch.grid.hash import (
    HashGridState,
    load_voxels_hash,
    touched_voxels_hash,
)

_FORMAT = "sonar3d-map-v1"


def save_map(
    path: str, state: Union[BrickGridState, HashGridState], cfg: MapperConfig
) -> None:
    """Snapshot a brick or hash map's touched voxels, bounds and config to
    ``path``; ValueError for any other map."""
    if not isinstance(state, (BrickGridState, HashGridState)):
        raise ValueError(
            f"save_map takes a brick or hash map, not {type(state).__name__} "
            f"(the dense backend has no snapshot, as in the JAX package)"
        )
    touched = (touched_voxels_brick if isinstance(state, BrickGridState)
               else touched_voxels_hash)
    keys, log_odds = touched(state)
    np.savez_compressed(
        path,
        format=np.asarray(_FORMAT),
        keys=keys,
        log_odds=log_odds,
        min_bounds=state.min_bounds.cpu().numpy(),
        max_bounds=state.max_bounds.cpu().numpy(),
        config=np.asarray(json.dumps(cfg.to_dict())),
    )


def _read(path: str):
    """(keys, log_odds, min_bounds, max_bounds, config) of a snapshot."""
    with np.load(path, allow_pickle=False) as z:
        if str(z["format"]) != _FORMAT:
            raise ValueError(f"unknown snapshot format in {path}")
        return (z["keys"], z["log_odds"], z["min_bounds"], z["max_bounds"],
                config_from_dict(json.loads(str(z["config"]))))


def _with_bounds(state, min_bounds, max_bounds):
    device, dtype = state.log_odds.device, state.log_odds.dtype
    return state._replace(
        min_bounds=torch.as_tensor(min_bounds, device=device).to(dtype),
        max_bounds=torch.as_tensor(max_bounds, device=device).to(dtype),
    )


def load_map(
    path: str,
    capacity: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> Tuple[HashGridState, MapperConfig]:
    """Restore a snapshot into a fresh hash grid on ``device`` (the first
    CUDA device when None; RuntimeError where there is none).  ``dtype``
    defaults to the snapshot's value dtype; ``capacity`` (slots) is sized
    to keep the load at or under 0.25 unless given.  Returns (state,
    config)."""
    device = (require_cuda() if device is None
              else torch.empty(0, device=device).device)
    keys, log_odds, min_bounds, max_bounds, cfg = _read(path)
    if dtype is None:
        dtype = torch.from_numpy(log_odds[:0]).dtype
    state = load_voxels_hash(keys, log_odds, device, capacity=capacity,
                             dtype=dtype)
    return _with_bounds(state, min_bounds, max_bounds), cfg


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
    keys, log_odds, min_bounds, max_bounds, cfg = _read(path)
    if dtype is None:
        dtype = torch.from_numpy(log_odds[:0]).dtype
    state = load_voxels_brick(
        keys, log_odds, device, capacity=capacity, dtype=dtype,
        brick_bits=brick_bits or DEFAULT_BRICK_BITS,
    )
    return _with_bounds(state, min_bounds, max_bounds), cfg
