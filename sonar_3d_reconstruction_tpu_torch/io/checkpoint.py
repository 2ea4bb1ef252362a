"""Map snapshot / restore (PyTorch port of
``sonar_3d_reconstruction_tpu.io.checkpoint`` for brick, sharded brick,
hash and sharded hash maps).

A snapshot is one ``.npz`` in the JAX package's ``sonar3d-map-v1`` format:
the touched voxels as UNPACKED (N, 3) int32 keys with their log-odds in
the map's dtype (a float64 map stays float64), the bounds, and the config
as JSON.  The format does not depend on the table layout, so a snapshot
saved by either package, from either backend, loads into the other, into
a brick grid (``load_map_brick``), a sharded brick grid
(``load_map_sharded_brick``) or a hash grid (``load_map``).  A sharded hash
map saves its shards' voxels together and restores through any of them,
as in the JAX package, which has no sharded hash loader either.  A dense
map has no snapshot, as in the JAX package.
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
from sonar_3d_reconstruction_tpu_torch.ops.packing import pack_brick_keys
from sonar_3d_reconstruction_tpu_torch.parallel.shard import (
    ShardedHashState,
    make_mesh,
    touched_voxels_sharded,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (
    ShardedBrickState,
    gather_sharded_brick_state,
    owner_shard_brick,
)

_FORMAT = "sonar3d-map-v1"


def save_map(
    path: str,
    state: Union[BrickGridState, ShardedBrickState, HashGridState,
                 ShardedHashState],
    cfg: MapperConfig,
) -> None:
    """Snapshot a brick, sharded brick, hash or sharded hash map's touched
    voxels, bounds and config to ``path``; ValueError for any other map.
    Shards hold disjoint voxels, so a sharded map's are concatenated."""
    touched = {BrickGridState: touched_voxels_brick,
               ShardedBrickState: gather_sharded_brick_state,
               HashGridState: touched_voxels_hash,
               ShardedHashState: touched_voxels_sharded}.get(type(state))
    if touched is None:
        raise ValueError(
            f"save_map takes a brick, sharded brick, hash or sharded hash "
            f"map, not {type(state).__name__} (the dense backend has no "
            f"snapshot, as in the JAX package)"
        )
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


def load_map_sharded_brick(
    path: str,
    mesh=None,
    local_capacity: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    brick_bits: Optional[int] = None,
) -> Tuple[ShardedBrickState, MapperConfig]:
    """Restore a snapshot into a fresh sharded brick grid over ``mesh`` (a
    device list, repeats allowed; None: every visible card, RuntimeError
    where there is none): each voxel goes to its brick's owner shard
    (``owner_shard_brick``), so a map saved from any backend of either
    package resumes sharded mapping.  Every shard takes the capacity the
    fullest one needs (``load_voxels_brick``'s sizing), at least
    ``local_capacity`` (a power of two).  ``dtype`` defaults to the
    snapshot's value dtype.  Returns (state, config)."""
    mesh = make_mesh(mesh)
    keys, log_odds, min_bounds, max_bounds, cfg = _read(path)
    if dtype is None:
        dtype = torch.from_numpy(log_odds[:0]).dtype
    if local_capacity and local_capacity & (local_capacity - 1):
        raise ValueError(f"local_capacity {local_capacity} is not a power "
                         f"of two")
    bb = brick_bits or DEFAULT_BRICK_BITS
    keys = np.asarray(keys, np.int32).reshape(-1, 3)
    hi, lo, in_range = pack_brick_keys(torch.as_tensor(keys), bb)
    if not bool(in_range.all()):
        raise ValueError("voxel keys outside the packable range")
    owner = owner_shard_brick(hi, lo, bb, len(mesh)).numpy()
    per = [np.flatnonzero(owner == s) for s in range(len(mesh))]

    def load(s, capacity=None):
        return load_voxels_brick(keys[per[s]], log_odds[per[s]], mesh[s],
                                 capacity=capacity, dtype=dtype, brick_bits=bb)

    shards = [load(s) for s in range(len(mesh))]
    cap = max([x.capacity for x in shards] + [local_capacity or 0])
    shards = [x if x.capacity == cap else load(s, cap)
              for s, x in enumerate(shards)]
    return ShardedBrickState(tuple(
        _with_bounds(x, min_bounds, max_bounds) for x in shards)), cfg
