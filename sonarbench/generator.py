"""The survey generator: one general reader of a traffic file's
parameters (``sonarbench/traffic/<mix>.json``).

A traffic file of kind ``survey_leg`` describes:

* ``images``: the synthetic returns of the root bench's survey (noise in
  ``noise`` [lo, hi], a ``band.rows``-bin bright band of values in
  ``band.values`` [lo, hi] whose first bin is
  ``band.start + int(band.sweep * sin(i / band.period))`` at pool ping
  ``i``), ``pool_pings`` of them, drawn on the device by a
  ``torch.Generator`` seeded from the run's seed and copied once to host
  memory;
* ``legs``: each pass maps ``pass_pings`` consecutive pool pings from an
  offset drawn from the seed, on a straight leg from the origin at
  ``step_m`` a ping, at depth ``depth_m``, level.  The headings step by
  the golden fraction of a quarter turn from one drawn from the seed:
  the brick grid repeats every quarter turn, so any run of passes meets
  the grid at evenly spread angles whatever the seed, and the work a
  window holds does not hang on which headings the seed drew.

Every draw is a function of the seed alone, so the same seed gives the
same pool and the same passes in the same order.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch


class Pass(NamedTuple):
    images: np.ndarray      # (P, R, B) uint8, a view into the pool
    positions: np.ndarray   # (P, 3) float64
    quats: np.ndarray       # (P, 4) float64 xyzw
    offset: int
    heading: float


def band_starts(spec: Dict, n: int) -> np.ndarray:
    """First bin of the bright band at pool pings 0..n-1."""
    band = spec["band"]
    i = np.arange(n)
    return band["start"] + (band["sweep"] * np.sin(i / band["period"])).astype(
        np.int64)


def make_pool(spec: Dict, shape, seed: int, device,
              pool_pings: int = None, keep_on_device: bool = False):
    """(pool_pings, R, B) uint8 images drawn on ``device``: host numpy,
    or the device tensor when ``keep_on_device``."""
    n = pool_pings or spec["pool_pings"]
    R, B = shape
    band = spec["band"]
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))
    lo, hi = spec["noise"]
    imgs = torch.randint(lo, hi + 1, (n, R, B), generator=g, device=device,
                         dtype=torch.uint8)
    vlo, vhi = band["values"]
    vals = torch.randint(vlo, vhi + 1, (n, band["rows"], B), generator=g,
                         device=device, dtype=torch.uint8)
    rows = (torch.as_tensor(band_starts(spec, n), device=device)[:, None]
            + torch.arange(band["rows"], device=device))
    imgs[torch.arange(n, device=device)[:, None], rows] = vals
    del vals
    return imgs if keep_on_device else imgs.cpu().numpy()


GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0


class Passes:
    """The passes of a run: pass ``k`` of seed ``seed`` is always the same
    offset and heading (k = 0 is the warm pass)."""

    def __init__(self, spec: Dict, pool: np.ndarray, seed: int,
                 pass_pings: int = None):
        self.spec = spec
        self.pool = pool
        self.n = pass_pings or spec["pass_pings"]
        if self.n > len(pool):
            raise ValueError(f"a pass of {self.n} pings needs a pool that "
                             f"large, not {len(pool)}")
        self.rng = np.random.default_rng([seed % (1 << 64), 1])
        self.heading = float(self.rng.uniform(0.0, 2.0 * math.pi))

    def next(self) -> Pass:
        offset = int(self.rng.integers(0, len(self.pool) - self.n + 1))
        heading = self.heading
        self.heading = (heading + GOLDEN * math.pi / 2.0) % (2.0 * math.pi)
        return leg(self.spec, self.pool, offset, heading, self.n)


def leg(spec: Dict, pool: np.ndarray, offset: int, heading: float,
        n: int) -> Pass:
    """``n`` pool pings from ``offset`` on a straight leg at ``heading``."""
    s = spec["step_m"] * np.arange(n)
    positions = np.stack([s * math.cos(heading), s * math.sin(heading),
                          np.full(n, spec["depth_m"])], -1)
    quats = np.zeros((n, 4))
    quats[:, 2] = math.sin(heading / 2.0)
    quats[:, 3] = math.cos(heading / 2.0)
    return Pass(pool[offset:offset + n], positions, quats, offset, heading)
