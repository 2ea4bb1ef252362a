"""Plain PyTorch reference of one survey pass: the reference mapper's
semantics (``scripts/3d_mapper.py`` of luckkim123/sonar_3d_reconstruction:
SimpleOctree + SonarTo3DMapper), vectorised.

It imports no module of the program and neither JAX nor the JAX package,
and takes nothing the program made: it reads the configuration's file (a
plain dict), the pass's images and poses, and works out the poses, the
fans, the per-ping accumulation and the map again.  The arithmetic is
the golden oracle's, lane for lane:

* rays every ``max(1, bearings // max_rays)`` columns at
  ``linspace(-fov/2, fov/2, bearings)``; first hit is the first bin
  strictly above the threshold;
* free emissions every ``free_sampling_step`` bins before the first hit,
  ``max(1, int(r tan(ap/2) / (4 res)))`` fan steps each side; occupied
  emissions at the above-threshold bins of the ``occupied_window`` bins
  from the first hit, ``max(2, int(r tan(ap/2) / (1.5 res)))`` steps; no
  emission below ``min_range`` or above ``max_range``; the z filter drops
  world points below ``z_filter_min``;
* sonar frame ``(r cos v cos b, -r cos v sin b, r sin v)``, world =
  ``T_base_to_world @ T_sonar_to_base`` with ZYX roll-pitch-yaw and xyzw
  quaternions; keys ``floor(p / res)``;
* per ping, each voxel takes the mean of its emissions' log-odds and is
  occupied when any emission is; the mean of ``q`` occupied and ``c - q``
  free emissions is taken as ``(q l_occ + (c - q) l_free) / c`` (the
  oracle sums the same values one by one);
* the map folds each voxel's per-ping updates in ping order: an occupied
  update above 0 into a voxel at ``p <= adaptive_threshold`` is scaled by
  ``p / adaptive_threshold * adaptive_max_ratio``, and the sum is clamped.

The fold is vectorised over voxels: the records of a pass are sorted by
voxel (stable, so ping order holds within a voxel), and step ``k`` applies
the ``k``-th update of every voxel that has one.

``dtype`` is the precision of the point and log-odds arithmetic: float64
is the reference; a lower one (bfloat16) is the control of
``sonarbench.readings``.  The fan's integer counts and the angle tables
are exact float64 host values in every precision, as in the oracle.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

# voxel keys pack into 16 bits an axis, the ping of a block above them
KEY_BITS = 16
KEY_OFF = 1 << (KEY_BITS - 1)
KEY_MASK = (1 << KEY_BITS) - 1


def rotation_rpy(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """3x3 rotation from roll, pitch, yaw radians, ZYX (yaw pitch roll)."""
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


def sonar_to_world(positions: np.ndarray, quats: np.ndarray,
                   mapper: Dict) -> np.ndarray:
    """(P, 4, 4) float64 ``T_base_to_world @ T_sonar_to_base``."""
    q = np.asarray(quats, np.float64)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    P = len(q)
    T = np.zeros((P, 4, 4))
    T[:, 0] = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                        2 * (x * z + w * y), positions[:, 0]], -1)
    T[:, 1] = np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - w * x), positions[:, 1]], -1)
    T[:, 2] = np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                        1 - 2 * (x * x + y * y), positions[:, 2]], -1)
    T[:, 3, 3] = 1.0
    mount = np.eye(4)
    mount[:3, :3] = rotation_rpy(*mapper["sonar_orientation"])
    mount[:3, 3] = mapper["sonar_position"]
    return T @ mount


class Fans:
    """Exact float64 host tables of one configuration and image shape:
    the ray bearings, and for each of the free and occupied emissions the
    fan count and vertical-angle trig of every range bin."""

    def __init__(self, mapper: Dict, R: int, B: int):
        m = mapper
        half_fov = math.radians(m["horizontal_fov"]) / 2.0
        half_ap = math.radians(m["vertical_aperture"]) / 2.0
        res = m["voxel_resolution"]
        bearings = np.linspace(-half_fov, half_fov, B)
        cols = np.arange(0, B, max(1, B // m["max_rays"]))
        cols = cols[np.abs(bearings[cols]) <= half_fov]
        self.cols = cols
        self.cos_b = np.cos(bearings[cols])
        self.sin_b = np.sin(bearings[cols])
        rres = m["max_range"] / R
        self.r = np.array([i * rres for i in range(R)])
        in_range = (self.r >= m["min_range"]) & (self.r <= m["max_range"])
        spread = [i * rres * math.tan(half_ap) for i in range(R)]
        nv_free = np.array([max(1, int(s / (res * 4))) for s in spread])
        nv_occ = np.array([max(2, int(s / (res * 1.5))) for s in spread])
        self.free_bins = np.arange(0, R, m["free_sampling_step"])
        self.free_ok = in_range[self.free_bins]
        self.free = self._fan(nv_free[self.free_bins], half_ap)
        self.occ_ok = in_range
        self.occ = self._fan(nv_occ, half_ap)

    @staticmethod
    def _fan(nv: np.ndarray, half_ap: float):
        """(cos v, sin v, step valid) of each bin's fan, (n, 2 nv_max + 1)."""
        top = int(nv.max())
        steps = np.arange(-top, top + 1, dtype=np.float64)
        vang = steps[None, :] / np.maximum(1, nv)[:, None] * half_ap
        return np.cos(vang), np.sin(vang), np.abs(steps)[None, :] <= nv[:, None]


def _t(a, device, dtype=None):
    t = torch.as_tensor(np.asarray(a), device=device)
    return t if dtype is None else t.to(dtype)


def _pack(keys: torch.Tensor) -> torch.Tensor:
    """(..., 3) int64 voxel keys -> int64 codes of 16 bits an axis."""
    if keys.numel() and int(keys.abs().max()) >= KEY_OFF:
        raise ValueError("a voxel key is outside the reference's 16-bit range")
    k = keys + KEY_OFF
    return (k[..., 0] << (2 * KEY_BITS)) | (k[..., 1] << KEY_BITS) | k[..., 2]


def unpack(codes: torch.Tensor) -> torch.Tensor:
    """int64 codes -> (N, 3) int64 voxel keys."""
    return torch.stack([(codes >> (2 * KEY_BITS)) & KEY_MASK,
                        (codes >> KEY_BITS) & KEY_MASK,
                        codes & KEY_MASK], -1) - KEY_OFF


def pack_keys(keys) -> torch.Tensor:
    """(N, 3) integer voxel keys (any integer array) -> int64 codes."""
    return _pack(torch.as_tensor(np.asarray(keys)).to(torch.int64))


def _emissions(img, T, fans, m, dtype):
    """Valid emissions of a block of pings: (ping in block, world key
    code, occupied) of every emission, in one flat list."""
    device = img.device
    F = img.shape[0]
    thr = m["intensity_threshold"]
    prof = img[:, :, _t(fans.cols, device)].transpose(1, 2)  # (F, n, R)
    R = prof.shape[-1]
    hits = prof > thr
    first = torch.where(hits.any(-1), hits.to(torch.uint8).argmax(-1), R)
    cos_b = _t(fans.cos_b, device, dtype)[None, :, None, None]
    sin_b = _t(fans.sin_b, device, dtype)[None, :, None, None]
    Td = T.to(dtype)

    def world(r, cos_v, sin_v):
        rc = r * cos_v
        x, y, z = rc * cos_b, -(rc * sin_b), r * sin_v
        return [Td[:, i, 0, None, None, None] * x
                + Td[:, i, 1, None, None, None] * y
                + Td[:, i, 2, None, None, None] * z
                + Td[:, i, 3, None, None, None] for i in range(3)]

    r_all = _t(fans.r, device, dtype)
    # free: (F, n, bins, steps)
    fb = _t(fans.free_bins, device)
    fc, fs, fv = (_t(a, device) for a in fans.free)
    ok = ((fb[None, None, :] < first[..., None])
          & _t(fans.free_ok, device)[None, None, :])
    fr = r_all[fb][None, None, :, None]
    free = world(fr, fc.to(dtype)[None, None], fs.to(dtype)[None, None])
    free_ok = ok[..., None] & fv[None, None]
    # occupied: bins first .. first + window - 1 above the threshold
    W = min(m["occupied_window"], R)
    ob = first[..., None] + torch.arange(W, device=device)     # (F, n, W)
    inside = ob < R
    obc = torch.clamp(ob, max=R - 1)
    ok = (inside & torch.gather(hits, -1, obc)
          & _t(fans.occ_ok, device)[obc])
    oc, os_, ov = (_t(a, device)[obc] for a in fans.occ)
    occ = world(r_all[obc][..., None], oc.to(dtype), os_.to(dtype))
    occ_ok = ok[..., None] & ov

    out = []
    for pts, valid, is_occ in ((free, free_ok, False), (occ, occ_ok, True)):
        if m["z_filter_enabled"]:
            valid = valid & (pts[2] >= m["z_filter_min"])
        res = torch.full((), m["voxel_resolution"], dtype=dtype, device=device)
        keys = torch.stack([torch.floor(p[valid] / res) for p in pts], -1)
        ping = torch.arange(F, device=device).view(F, 1, 1, 1).expand(
            valid.shape)[valid]
        out.append((ping, _pack(keys.to(torch.int64)),
                    torch.full_like(ping, int(is_occ), dtype=torch.bool)))
    return tuple(torch.cat(parts) for parts in zip(*out))


def frame_records(img, T, fans, m, dtype):
    """Per-ping voxel records of a block of pings: (ping in block, code,
    mean update, occupied) in (ping, code) order, and the block's
    (num_candidates, num_occupied, num_free) per ping."""
    F = img.shape[0]
    ping, code, occ = _emissions(img, T, fans, m, dtype)
    n_cand = torch.bincount(ping, minlength=F)
    comp = (ping << (3 * KEY_BITS)) | code
    uniq, inv, cnt = torch.unique(comp, return_inverse=True,
                                  return_counts=True)
    q = torch.zeros_like(cnt).scatter_add_(0, inv, occ.to(torch.int64))
    c_d, q_d = cnt.to(dtype), q.to(dtype)
    total = (q_d * torch.full((), m["log_odds_occupied"], dtype=dtype,
                              device=q.device)
             + (c_d - q_d) * torch.full((), m["log_odds_free"], dtype=dtype,
                                        device=q.device))
    u_ping = uniq >> (3 * KEY_BITS)
    is_occ = q > 0
    n_occ = torch.bincount(u_ping[is_occ], minlength=F)
    n_free = torch.bincount(u_ping[~is_occ], minlength=F)
    recs = (u_ping, uniq & ((1 << (3 * KEY_BITS)) - 1), total / c_d, is_occ)
    return recs, torch.stack([n_cand, n_occ, n_free], -1)


def fold(codes, upd, is_occ, m, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The map after every record, records in ping order: (distinct codes
    ascending, final log-odds)."""
    device = codes.device
    order = torch.sort(codes, stable=True).indices
    codes, upd, is_occ = codes[order], upd[order], is_occ[order]
    new = torch.ones_like(codes, dtype=torch.bool)
    new[1:] = codes[1:] != codes[:-1]
    seg = torch.cumsum(new, 0) - 1
    starts = torch.nonzero(new).squeeze(1)
    rank = torch.arange(len(codes), device=device) - starts[seg]
    by_rank = torch.sort(rank, stable=True).indices
    counts = torch.bincount(rank).tolist()
    cur = torch.zeros(len(starts), dtype=dtype, device=device)
    thr = m["adaptive_threshold"]
    ratio = m["adaptive_max_ratio"]
    lo_min, lo_max = m["log_odds_min"], m["log_odds_max"]
    at = 0
    for n in counts:
        idx = by_rank[at:at + n]
        at += n
        s, u = seg[idx], upd[idx]
        if m["adaptive_update"]:
            p = torch.sigmoid(cur[s])
            scale = is_occ[idx] & (u > 0) & (p <= thr)
            u = torch.where(scale, u * (p / thr) * ratio, u)
        cur[s] = torch.clamp(cur[s] + u, lo_min, lo_max)
    return codes[starts], cur


def map_pass(images: np.ndarray, positions: np.ndarray, quats: np.ndarray,
             mapper: Dict, device, dtype=torch.float64,
             block: int = 16) -> Dict[str, torch.Tensor]:
    """One pass from a fresh map: per-ping ``num_candidates``,
    ``num_occupied``, ``num_free`` (host int64) and the map's distinct
    voxel ``codes`` (ascending) with their ``log_odds`` (on ``device``).
    ``block`` pings are backprojected at a time."""
    P, R, B = images.shape
    fans = Fans(mapper, R, B)
    T = torch.as_tensor(sonar_to_world(positions, quats, mapper),
                        device=device)
    recs, stats = [], []
    for p0 in range(0, P, block):
        img = torch.as_tensor(np.ascontiguousarray(images[p0:p0 + block]),
                              device=device)
        (ping, code, upd, occ), st = frame_records(
            img, T[p0:p0 + block], fans, mapper, dtype)
        recs.append((code, upd, occ))
        stats.append(st)
    codes, upd, occ = (torch.cat(x) for x in zip(*recs))
    del recs
    codes, log_odds = fold(codes, upd, occ, mapper, dtype)
    st = torch.cat(stats).cpu().numpy()
    return dict(num_candidates=st[:, 0], num_occupied=st[:, 1],
                num_free=st[:, 2], codes=codes, log_odds=log_odds)
