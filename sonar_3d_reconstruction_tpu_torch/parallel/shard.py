"""The device mesh of the sharded engines (PyTorch port of
``make_mesh`` in ``sonar_3d_reconstruction_tpu.parallel.shard``).

The JAX package is single-controller: one Python process drives a
``jax.sharding.Mesh`` and holds every shard's state.  The port keeps that
design.  A mesh is a tuple of ``torch.device``s, shard ``s`` living on
``mesh[s]``, and a device may appear more than once (the counterpart of
XLA's virtual host devices): ``(cuda:0,) * 4`` runs four shards on one
card, ``(cuda:0, cuda:1, cuda:2, cuda:3)`` one shard a card, and
``("cpu",) * 4`` four shards on the CPU.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from sonar_3d_reconstruction_tpu_torch.device import require_cuda

Mesh = Tuple[torch.device, ...]


def canonical_device(device) -> torch.device:
    """``device`` as tensors report it ("cuda" -> "cuda:0")."""
    return torch.empty(0, device=device).device


def make_mesh(devices: Optional[Iterable] = None) -> Mesh:
    """A 1D mesh: the given devices in order (repeats allowed), or every
    visible CUDA device when None (RuntimeError where there is none)."""
    if devices is None:
        require_cuda()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(canonical_device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def mesh_for(mesh=None, device=None) -> Mesh:
    """The mesh of a sharded map the caller sized by ``mesh`` or
    ``device``: ``mesh``; else one shard on ``device``; else every
    visible card."""
    return make_mesh(mesh if mesh is not None or device is None else [device])
