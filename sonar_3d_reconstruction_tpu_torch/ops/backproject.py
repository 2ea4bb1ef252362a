"""Fixed-shape tensorised sonar-ping backprojection (PyTorch port).

Port of ``sonar_3d_reconstruction_tpu.ops.backproject``.  The host tables
(``FanTables``, ``build_fan_tables`` and the ``required_*_cap`` gates) are
the JAX package's NumPy float64 code, repeated so the port never imports
JAX: the truncated fan counts ``max(1, int(spread/(res*4)))`` and
``max(2, int(spread/(res*1.5)))`` must stay host-exact, since a float32
device recompute can flip nv by one at a truncation boundary and move a
whole fan.  ``backproject_ping`` is the device half, op for op the JAX
function's order of arithmetic.

Emission order along the flattened candidate axis is (ray, free-then-
occupied bins, fan step); per-frame accumulation commutes, so the order
does not reach the map.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig


@dataclasses.dataclass(frozen=True, eq=False)
class FanTables:
    """Host-precomputed constant tables for one (config, image geometry).

    Arrays are float64 / int NumPy.  ``eq=False`` keeps identity hashing so
    one instance per geometry can key the device-table cache.
    """

    range_bins: int
    bearing_bins: int

    # Selected ray columns and their bearing trig (n_rays,)
    ray_indices: np.ndarray
    cos_b: np.ndarray
    sin_b: np.ndarray

    # Free-space candidates as a flat lattice: each free bin contributes
    # exactly its 2*nv(r)+1 fan lanes.
    free_idx: np.ndarray        # (L,) int32 absolute bin index per lane
    free_r: np.ndarray          # (L,) range in meters per lane
    free_cos_v: np.ndarray      # (L,) fan vertical-angle cosines
    free_sin_v: np.ndarray      # (L,)
    free_mask: np.ndarray       # (L,) bool: range >= min_range

    # Occupied per-bin fan count, float64-truncated; entry R is the
    # sentinel for windows that run past the image.
    occ_nv: np.ndarray          # (R+1,) int32, exact, never capped
    nvo_max: int                # fan half-width sized at max_range
    # Allocated occupied fan half-width; a smaller cap than nvo_max relies
    # on the host gate ``required_fan_cap``.
    nvo_cap: int

    # Allocated free-lattice depth (0 = all range bins); host gate
    # ``required_free_cap``.
    free_cap: int = 0

    # Allocated occupied-window depth (0 = the config's occupied_window);
    # host gate ``required_window_cap``.
    win_cap: int = 0

    @property
    def n_rays(self) -> int:
        return int(self.ray_indices.shape[0])

    def effective_window(self, occupied_window: int) -> int:
        w = min(occupied_window, self.range_bins)
        if self.win_cap > 0:
            w = min(w, self.win_cap)
        return max(w, 1)

    def candidates_per_ping(self, occupied_window: int = 50) -> int:
        f = self.free_idx.shape[0]
        w = self.effective_window(occupied_window)
        return self.n_rays * (f + w * (2 * self.nvo_cap + 1))


def _fan_row(
    r: float, half_ap: float, res: float, divisor: float, nv_floor: int, v_max: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One bin's vertical-fan trig row + step-validity mask (float64).

    nv = max(nv_floor, int(r*tan(half_ap) / (res*divisor)))
    vertical_angle(step) = step / max(1, nv) * half_ap
    """
    spread = r * math.tan(half_ap)
    nv = max(nv_floor, int(spread / (res * divisor)))
    steps = np.arange(-v_max, v_max + 1, dtype=np.float64)
    vang = (steps / max(1, nv)) * half_ap
    mask = np.abs(steps) <= nv
    return np.cos(vang), np.sin(vang), mask


@functools.lru_cache(maxsize=64)
def build_fan_tables(
    cfg: MapperConfig,
    range_bins: int,
    bearing_bins: int,
    fan_cap: int = 0,
    window_cap: int = 0,
    free_cap: int = 0,
) -> FanTables:
    """Precompute all static tables for this config + image geometry.

    ``fan_cap`` / ``window_cap`` / ``free_cap`` (0 = worst case) cap the
    occupied fan half-width, the occupied window depth and the free-lattice
    depth; callers size them with the ``required_*_cap`` host gates.
    Memoised so every caller with the same inputs shares one instance.
    """
    half_ap = cfg.half_aperture_rad
    res = cfg.voxel_resolution
    rres = cfg.max_range / range_bins

    half_fov = cfg.horizontal_fov_rad / 2.0
    bearings = np.linspace(-half_fov, half_fov, bearing_bins)
    step = max(1, bearing_bins // cfg.max_rays)
    sel = np.arange(0, bearing_bins, step)
    sel = sel[np.abs(bearings[sel]) <= half_fov]

    max_spread = cfg.max_range * math.tan(half_ap)
    nvf_max = max(1, int(max_spread / (res * 4.0)))
    nvo_max = max(2, int(max_spread / (res * 1.5)))

    free_depth = range_bins if free_cap <= 0 else max(
        1, min(free_cap, range_bins)
    )
    free_bins = np.arange(0, free_depth, cfg.free_sampling_step, dtype=np.int32)
    lane_idx, lane_r, lane_cos, lane_sin, lane_mask = [], [], [], [], []
    for b in free_bins:
        r = float(b) * rres
        c, s, m = _fan_row(r, half_ap, res, 4.0, 1, nvf_max)
        k = int(m.sum())
        lane_idx.append(np.full(k, b, np.int32))
        lane_r.append(np.full(k, r, np.float64))
        lane_cos.append(c[m])
        lane_sin.append(s[m])
        lane_mask.append(np.full(k, r >= cfg.min_range, bool))

    occ_r_f64 = np.arange(range_bins + 1, dtype=np.float64) * rres
    occ_nv = np.maximum(
        2, (occ_r_f64 * math.tan(half_ap) / (res * 1.5)).astype(np.int64)
    ).astype(np.int32)

    nvo_cap = nvo_max if fan_cap <= 0 else max(2, min(fan_cap, nvo_max))
    win_cap = 0 if window_cap <= 0 else max(1, min(window_cap, range_bins))

    return FanTables(
        range_bins=range_bins,
        bearing_bins=bearing_bins,
        ray_indices=sel.astype(np.int32),
        cos_b=np.cos(bearings[sel]),
        sin_b=np.sin(bearings[sel]),
        free_idx=np.concatenate(lane_idx),
        free_r=np.concatenate(lane_r),
        free_cos_v=np.concatenate(lane_cos),
        free_sin_v=np.concatenate(lane_sin),
        free_mask=np.concatenate(lane_mask),
        occ_nv=occ_nv,
        nvo_max=nvo_max,
        nvo_cap=nvo_cap,
        free_cap=0 if free_depth == range_bins else free_depth,
        win_cap=win_cap,
    )


def required_fan_cap(
    images: np.ndarray, cfg: MapperConfig, range_bins: int
) -> int:
    """Exact host-side occupied-fan half-width for these images: the
    deepest above-threshold bin over every ping and column bounds it."""
    images = np.asarray(images)
    hits = images > cfg.intensity_threshold
    any_hit_per_bin = hits.any(axis=tuple(
        i for i in range(hits.ndim) if i != hits.ndim - 2
    ))
    if not any_hit_per_bin.any():
        return 2
    deepest = int(np.max(np.nonzero(any_hit_per_bin)[0]))
    rres = cfg.max_range / range_bins
    r = deepest * rres
    return max(2, int(r * math.tan(cfg.half_aperture_rad)
                      / (cfg.voxel_resolution * 1.5)))


def required_free_cap(
    images: np.ndarray, cfg: MapperConfig, range_bins: int
) -> int:
    """Exact host-side free-lattice depth for these images: a free bin
    emits only before its column's first hit, so the deepest first hit
    bounds the live bins (a column with no hit forces the full depth)."""
    images = np.asarray(images)
    if images.ndim == 2:
        images = images[None]
    hits = images > cfg.intensity_threshold  # (P, R, B)
    cols_hit = hits.any(axis=-2)             # (P, B)
    if not cols_hit.all():
        return range_bins
    first = np.argmax(hits, axis=-2)
    return max(1, int(first.max()))


def required_window_cap(
    images: np.ndarray, cfg: MapperConfig, range_bins: int
) -> int:
    """Exact host-side occupied-window depth for these images: the deepest
    above-threshold offset past any column's first hit bounds it."""
    images = np.asarray(images)
    if images.ndim == 2:
        images = images[None]
    W = min(cfg.occupied_window, range_bins)
    hits = images > cfg.intensity_threshold  # (P, R, B)
    if not hits.any():
        return 1
    bins = np.arange(range_bins, dtype=np.int64)[:, None]
    deepest = 0
    for h in hits:  # per ping: keeps the (R, B) offset temp small
        cols = h.any(axis=0)
        if not cols.any():
            continue
        first = np.where(cols, np.argmax(h, axis=0), range_bins)
        off = bins - first[None, :]
        off_ok = h & (off >= 0) & (off < W)
        if off_ok.any():
            deepest = max(deepest, int(off[off_ok].max()))
    return max(1, deepest + 1)


def resolve_capped_tables(
    images: np.ndarray,
    cfg: MapperConfig,
    range_bins: int,
    bearing_bins: int,
    fan_cap="auto",
    window_cap="auto",
    free_cap="auto",
) -> FanTables:
    """Tables for these images, each lattice cap as the JAX package
    resolves it: ``"auto"`` (the default) sizes it exactly for THESE
    images (identical emissions, smaller lattice), an int pins it (a
    plan's ``fan_cap`` / ``window_cap`` / ``free_cap``), and None or 0
    keeps the config's worst case."""
    P = len(images)
    if fan_cap == "auto":
        fan_cap = required_fan_cap(images, cfg, range_bins) if P else 0
    if window_cap == "auto":
        window_cap = required_window_cap(images, cfg, range_bins) if P else 0
    if free_cap == "auto":
        free_cap = required_free_cap(images, cfg, range_bins) if P else 0
    return build_fan_tables(
        cfg, range_bins, bearing_bins, fan_cap=int(fan_cap or 0),
        window_cap=int(window_cap or 0), free_cap=int(free_cap or 0),
    )


def tables_for_images(
    images: np.ndarray, cfg: MapperConfig, tables: Optional[FanTables] = None
) -> FanTables:
    """The fan tables of a (P, range_bins, bearing_bins) image stack: the
    caller's ``tables`` (ValueError when they are for another image
    shape), else tables with every cap sized for these images."""
    _, R, B = images.shape
    if tables is None:
        return resolve_capped_tables(images, cfg, R, B)
    if (tables.range_bins, tables.bearing_bins) != (R, B):
        raise ValueError(
            f"fan tables are for {tables.range_bins}x{tables.bearing_bins} "
            f"images, not {R}x{B}"
        )
    return tables


@functools.lru_cache(maxsize=16)
def _device_tables(
    tables: FanTables, device: torch.device, dtype: torch.dtype
) -> Dict[str, torch.Tensor]:
    """The tables as device tensors, copied once per (tables, device, dtype)
    instead of once per ping."""

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return {
        "ray_indices": i(tables.ray_indices),
        "cos_b": f(tables.cos_b),
        "sin_b": f(tables.sin_b),
        "free_idx": i(tables.free_idx),
        "free_r": f(tables.free_r),
        "free_cos_v": f(tables.free_cos_v),
        "free_sin_v": f(tables.free_sin_v),
        "free_mask": torch.as_tensor(tables.free_mask, device=device),
        "occ_nv": i(tables.occ_nv),
    }


@functools.lru_cache(maxsize=16)
def _fan_trig(
    tables: FanTables, device: torch.device, dtype: torch.dtype,
    half_aperture: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The occupied fan's vertical trig for every fan count the tables
    hold: ((nv_max + 1, S) cos and sin of ``step / max(nv, 1) *
    half_aperture`` at row nv, (S,) steps -nvo_cap..nvo_cap), computed once
    per (tables, device, dtype) with the same ops a per-candidate
    evaluation takes, so a candidate's lookup is bit-equal to evaluating it.

    ``occ_nv`` is exact and never capped, so its largest entry bounds every
    fan count a ping can gather whatever the tables' caps.  The table is
    small enough for one thread: a ping's first multi-threaded CPU cos in a
    process returned some chunks at lower precision."""
    nv = torch.clamp(torch.arange(int(tables.occ_nv.max()) + 1, device=device),
                     min=1)[:, None]
    steps = torch.arange(-tables.nvo_cap, tables.nvo_cap + 1, device=device)
    vang = (steps[None, :].to(dtype) / nv.to(dtype)
            * torch.full((), half_aperture, dtype=dtype, device=device))
    return torch.cos(vang), torch.sin(vang), steps


def _local_points(r, cos_v, sin_v, cos_b, sin_b):
    """Sonar-frame coordinates (+X fwd, +Y right with the reference's
    negated y, +Z down), multiplied in the reference's order
    ``r * cos(v) * cos(b)``."""
    rcv = r * cos_v
    x = rcv * cos_b
    y = -(rcv * sin_b)
    z = r * sin_v
    return x, y, z


def _to_world(x, y, z, T):
    """Explicit affine transform, term by term like the JAX function, with
    ``T`` (F, 4, 4) broadcast over the points' leading frame axis."""

    def t(i, j):
        return T[:, i, j].reshape((-1,) + (1,) * (x.dim() - 1))

    wx = t(0, 0) * x + t(0, 1) * y + t(0, 2) * z + t(0, 3)
    wy = t(1, 0) * x + t(1, 1) * y + t(1, 2) * z + t(1, 3)
    wz = t(2, 0) * x + t(2, 1) * y + t(2, 2) * z + t(2, 3)
    return torch.stack([wx, wy, wz], dim=-1)


def backproject_ping(
    polar_image: torch.Tensor,
    T_sonar_to_world: torch.Tensor,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """One ping, or a batch of pings, -> flattened candidate emissions
    (static shape).

    ``polar_image`` (range_bins, bearing_bins), rows range and columns
    bearing, with ``T_sonar_to_world`` (4, 4); or (F, range_bins,
    bearing_bins) with (F, 4, 4) for F pings at once.  Both on the device
    the work runs on.  Returns points (N, 3), log_odds (N,), is_occupied
    (N,) bool and valid (N,) bool over N = n_rays*(L_free + W*VO)
    candidates, each with a leading (F,) axis for a batch.  A batch runs
    the single ping's ops element for element, so each of its frames is
    bit-equal to that ping backprojected alone.
    """
    batched = polar_image.dim() == 3
    images = polar_image if batched else polar_image[None]
    R, B = tables.range_bins, tables.bearing_bins
    if tuple(images.shape[1:]) != (R, B):
        raise ValueError(
            f"image shape {tuple(polar_image.shape)} != tables {(R, B)}"
        )
    device = images.device
    tab = _device_tables(tables, device, dtype)
    W = tables.effective_window(cfg.occupied_window)
    F = images.shape[0]

    def const(x):
        return torch.full((), x, dtype=dtype, device=device)

    cos_b = tab["cos_b"][:, None, None]
    sin_b = tab["sin_b"][:, None, None]

    # (F, n_rays, R) intensity profiles, strict > hit mask; first hit or R
    # (argmax returns the first maximum)
    profiles = images[:, :, tab["ray_indices"]].transpose(1, 2)
    hits = profiles > cfg.intensity_threshold
    any_hit = hits.any(dim=-1)
    first_hit = torch.where(
        any_hit, torch.argmax(hits.to(torch.uint8), dim=-1), R
    )

    T = T_sonar_to_world.to(device=device, dtype=dtype).reshape(F, 4, 4)

    # ---- free-space candidates: (F, n_rays, L) flat lattice
    fx, fy, fz = _local_points(
        tab["free_r"][None, None, :],
        tab["free_cos_v"][None, None],
        tab["free_sin_v"][None, None],
        cos_b[None, :, :, 0],
        sin_b[None, :, :, 0],
    )
    free_world = _to_world(fx, fy, fz, T)
    free_valid = (
        (tab["free_idx"] < first_hit[..., None]) & tab["free_mask"]
    )

    # ---- occupied candidates: window bins first_hit + w.  One
    # (F, n_rays, W) gather of where(hit, occ_nv[bin], 0) serves both the
    # intensity gate and the exact fan count (0 = not a hit, column R =
    # past the image).
    w_off = torch.arange(W, device=device)
    occ_bin = torch.clamp(first_hit[..., None] + w_off, max=R)
    hit_pad = torch.cat(
        [hits, torch.zeros(hits.shape[:-1] + (1,), dtype=torch.bool,
                           device=device)],
        dim=-1,
    )
    hit_nv_tab = torch.where(hit_pad, tab["occ_nv"], 0)
    hit_nv = torch.gather(hit_nv_tab, -1, occ_bin)
    bin_hit = hit_nv > 0
    occ_r = occ_bin.to(dtype)[..., None] * const(cfg.max_range / R)
    # max(, 1) only guards the masked not-hit lanes' division
    nv = torch.clamp(hit_nv, min=1)
    cos_t, sin_t, steps = _fan_trig(tables, device, dtype,
                                    cfg.half_aperture_rad)
    occ_cos_v = cos_t[nv]
    occ_sin_v = sin_t[nv]
    step_ok = steps.abs() <= nv[..., None]
    range_ok = (
        (occ_r >= const(cfg.min_range))
        & (occ_r <= const(cfg.max_range))
        & (occ_bin < R)[..., None]
    )
    ox, oy, oz = _local_points(occ_r, occ_cos_v, occ_sin_v, cos_b, sin_b)
    occ_world = _to_world(ox, oy, oz, T)
    occ_valid = bin_hit[..., None] & step_ok & range_ok

    if cfg.z_filter_enabled:
        zmin = const(cfg.z_filter_min)
        free_valid = free_valid & (free_world[..., 2] >= zmin)
        occ_valid = occ_valid & (occ_world[..., 2] >= zmin)

    n_free = free_valid[0].numel()
    n_occ = occ_valid[0].numel()
    points = torch.cat(
        [free_world.reshape(F, n_free, 3), occ_world.reshape(F, n_occ, 3)],
        dim=1,
    )
    valid = torch.cat(
        [free_valid.reshape(F, n_free), occ_valid.reshape(F, n_occ)], dim=1
    )
    is_occ = torch.cat([
        torch.zeros(n_free, dtype=torch.bool, device=device),
        torch.ones(n_occ, dtype=torch.bool, device=device),
    ]).expand(F, -1)
    log_odds = torch.where(
        is_occ, const(cfg.log_odds_occupied), const(cfg.log_odds_free)
    )
    out = {
        "points": points,
        "log_odds": log_odds,
        "is_occupied": is_occ,
        "valid": valid,
    }
    return out if batched else {k: v[0] for k, v in out.items()}
