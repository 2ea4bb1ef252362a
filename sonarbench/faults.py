"""Faults planted under the timed path, to show that the comparison
catches them (``sonarbench.readings`` at the cell's size, the tests at a
small one).  Never used by a run.

* ``unchanged``: a pass returns its map as it started (fresh and empty),
  with the stats it computed;
* ``half_batch``: a pass maps only every other ping (half of each
  window), and each left-out ping reports its mapped neighbour's stats;
* ``altered``: the first K1 call of each pass adds 0.5 to every value it
  writes (an answer altered where it is produced).

A pass on one card has no exchange between cards to leave out.
"""

from __future__ import annotations

import contextlib

import numpy as np

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def planted(name: str):
    """Plant fault ``name`` in the program for the enclosed block."""
    from sonar_3d_reconstruction_tpu_torch import pipeline
    from sonar_3d_reconstruction_tpu_torch.grid import brick

    real_map = pipeline.map_ping_sequence
    real_k1 = brick.bin_apply

    def unchanged(images, positions, quats, cfg=None, **kw):
        state, stats = real_map(images, positions, quats, cfg, **kw)
        fresh = brick.init_brick_grid(state.capacity, state.log_odds.dtype,
                                      state.log_odds.device)
        return fresh, stats

    def half_batch(images, positions, quats, cfg=None, **kw):
        images = np.asarray(images)
        state, half = real_map(images[::2], positions[::2], quats[::2], cfg,
                               **kw)
        n = len(images)
        return state, {k: np.repeat(v, 2)[:n] for k, v in half.items()}

    calls = {"n": 0}

    def altered_map(*a, **kw):
        calls["n"] = 0
        return real_map(*a, **kw)

    def altered_k1(*a, **kw):
        v, upd = real_k1(*a, **kw)
        calls["n"] += 1
        return (v + 0.5 if calls["n"] == 1 else v), upd

    patches = {
        "unchanged": [(pipeline, "map_ping_sequence", unchanged)],
        "half_batch": [(pipeline, "map_ping_sequence", half_batch)],
        "altered": [(pipeline, "map_ping_sequence", altered_map),
                    (brick, "bin_apply", altered_k1)],
    }[name]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    try:
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
