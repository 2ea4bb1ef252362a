"""Driver of ``survey_leg`` traffic: offline replay of survey legs through
the program's ``pipeline.map_ping_sequence``.

Set-up draws the image pool from the seed on the device and copies it to
host memory, builds the fan tables once with the program's own gates
(``ops.backproject.tables_for_images``) over the pool pings that bound
each lattice cap, reads the cell's budget plan and maps one warm pass.
Each pass of the window is one call of the library entry
``map_ping_sequence``: host numpy images and poses (their upload is
inside the call), the brick backend at the plan's budgets, the cell's
``window`` and ``records_batch``, the pool's tables, and a fresh map of
the plan's capacity.  ``map-bag --offline --budgets`` makes the same call
at the plan's window but with ``records_batch=1``, and
``SonarMapper.map_sequence`` passes neither budgets nor
``records_batch``: a cell with ``records_batch`` above 1 measures the
batched library call, which neither of them reaches.  The call returns
after its one read of the per-ping stats, behind every kernel of the
pass.

One pass of the window, drawn from the seed by reservoir sampling, keeps
its map; after the window it is read out (``grid.brick.
touched_voxels_brick``) and freed, and ``check`` holds it and the pass's
stats to the reference of the same inputs.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from sonarbench import compare, generator, reference, trace

# the one map backend the check reads out and the faults are planted in
BACKEND = "brick"


def _bounding_pings(pool_dev: torch.Tensor, thr: float, window: int,
                    chunk: int = 256) -> np.ndarray:
    """Pool pings that attain the largest of each quantity the program's
    lattice gates take a maximum of: the deepest above-threshold bin, the
    latest first hit (or a column with none) and the deepest hit inside
    the occupied window past a column's first hit."""
    n, R, _ = pool_dev.shape
    deepest, first_max, win_max = [], [], []
    bins = torch.arange(R, device=pool_dev.device, dtype=torch.int16)[:, None]
    for c0 in range(0, n, chunk):
        hits = pool_dev[c0:c0 + chunk] > thr                  # (c, R, B)
        any_bin = hits.any(2)
        deepest.append(torch.where(any_bin, bins[:, 0], -1).amax(1))
        cols = hits.any(1)
        first = torch.where(cols, hits.to(torch.uint8).argmax(1), R)
        # a column with no hit forces the full free lattice: rank it first
        first_max.append(torch.where(cols.all(1), first.amax(1), 2 * R))
        off = bins[None] - first[:, None, :].to(torch.int16)   # (c, R, B)
        ok = hits & (off >= 0) & (off < window)
        win_max.append(torch.where(ok, off, -1).amax((1, 2)))
    picks = {int(torch.cat(x).argmax()) for x in (deepest, first_max, win_max)}
    return np.array(sorted(picks))


class SurveyLeg:
    """One run's set-up, window and check (see the module docstring)."""

    def __init__(self, *, config: Dict, traffic: Dict, cell: Dict,
                 plan: Optional[Dict], seed: int, device,
                 pool_pings: Optional[int] = None,
                 pass_pings: Optional[int] = None):
        from sonar_3d_reconstruction_tpu_torch import pipeline
        from sonar_3d_reconstruction_tpu_torch.config import config_from_dict

        self.pipeline = pipeline
        self.config = config
        self.mapper = config["mapper"]
        self.cfg = config_from_dict(self.mapper)
        self.traffic = traffic
        self.cell = cell
        self.plan = plan
        self.seed = seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.pool_pings = pool_pings or traffic["pool_pings"]
        self.pass_pings = pass_pings or traffic["pass_pings"]
        self.kept = None
        self.replays = 0

    # -- set-up -------------------------------------------------------
    def setup(self) -> None:
        from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
            tables_for_images,
        )

        m = self.mapper
        shape = (m["image_height"], m["image_width"])
        pool_dev = generator.make_pool(self.traffic, shape, self.seed,
                                       self.device, self.pool_pings,
                                       keep_on_device=True)
        picks = _bounding_pings(pool_dev, m["intensity_threshold"],
                                m["occupied_window"])
        self.pool = pool_dev.cpu().numpy()
        del pool_dev
        self.tables = tables_for_images(self.pool[picks], self.cfg)
        self.passes = generator.Passes(self.traffic, self.pool, self.seed,
                                       self.pass_pings)
        self.keep_rng = np.random.default_rng([self.seed % (1 << 64), 2])
        self.map_pass(self.passes.next())        # the warm pass
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the timed path -----------------------------------------------
    def map_pass(self, p: generator.Pass):
        """One pass through the program; (state, per-ping stats)."""
        effective: Dict = {}
        state, stats = self.pipeline.map_ping_sequence(
            p.images, p.positions, p.quats, self.cfg, device=self.device,
            backend=BACKEND, state=None, dtype=self.dtype,
            window=self.cell["window"],
            records_batch=self.cell["records_batch"], tables=self.tables,
            budgets=None if self.plan is None else dict(self.plan),
            effective=effective,
        )
        if self.plan is not None and any(
                effective.get(k) != self.plan[k]
                for k in ("capacity", "unique_budget", "brick_budget")
                if k in self.plan):
            self.replays += 1
        return state, stats

    def window(self, seconds: float, trace_path: Optional[str] = None) -> Dict:
        """Passes back to back until ``seconds`` have passed; the first is
        traced when ``trace_path`` is given.  Every pass counts: the window
        closes when the last one returns."""
        n_passes = pings = 0
        traced = None
        walls = []
        t0 = time.perf_counter()
        while True:
            t_pass = time.perf_counter()
            p = self.passes.next()
            if trace_path and traced is None:
                with trace.capture(trace_path):
                    state, stats = self.map_pass(p)
                traced = dict(pings=len(p.images), stats=stats)
            else:
                state, stats = self.map_pass(p)
            walls.append((time.perf_counter() - t_pass, p.heading))
            n_passes += 1
            pings += len(p.images)
            if self.keep_rng.random() * n_passes < 1.0:
                self.kept = (p, state, stats)
            del state
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        wall = time.perf_counter() - t0
        return dict(wall_s=wall, passes=n_passes, pings=pings,
                    traced=traced, pass_walls=walls,
                    end_to_end={"survey_pings_per_s": pings / wall})

    # -- the check ----------------------------------------------------
    def read_kept(self):
        """The kept pass's map to the host; frees its state."""
        from sonar_3d_reconstruction_tpu_torch.grid.brick import (
            touched_voxels_brick,
        )

        p, state, stats = self.kept
        keys, log_odds = touched_voxels_brick(state)
        self.kept = (p, None, stats)
        del state
        return p, stats, keys, log_odds

    def check(self, kept, ref_dtype=torch.float64) -> Dict[str, float]:
        """The comparison's numbers for the kept pass (``read_kept``)."""
        p, stats, keys, log_odds = kept
        ref = reference.map_pass(p.images, p.positions, p.quats, self.mapper,
                                 self.device, ref_dtype)
        return compare.numbers(stats, keys, log_odds, ref)


DRIVER = SurveyLeg
