"""The sharded hash engine's window-1 step (``parallel/shard.py``):
each ping's records are computed once (``frame_owner_blocks``) and cut
into per-owner blocks, where the window engine computes every shard's
records on that shard (``owned_frame_records``).

Pings are numpy-seeded (100x64, 5 m at 0.1 m voxels, as in
tests/test_torch_shard_hash.py).  Tolerance: every block equals the
per-shard records bit for bit (keys, counts, sizes, aux); the engine's
maps against JAX stay in tests/test_torch_shard_hash.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sonar_3d_reconstruction_tpu_torch.geometry import (  # noqa: E402
    batched_sonar_to_world,
)
from sonar_3d_reconstruction_tpu_torch.grid.hash import (  # noqa: E402
    touched_voxels_hash,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (  # noqa: E402
    build_fan_tables,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import EMPTY_HI  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.parallel import shard  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.parallel.shard import (  # noqa: E402
    frame_owner_blocks,
    init_sharded_hash_grid,
    map_ping_sequence_sharded,
    owned_frame_records,
    owner_block,
    scan_pings_sharded,
)

from torch_parity import port_cfg  # noqa: E402
from test_torch_shard import SMALL_CFG, by_key, survey  # noqa: E402
from test_torch_shard_hash import CAPACITY, STATS, mesh  # noqa: E402

N_PINGS = 5
DTYPES = {"f64": torch.float64, "f32": torch.float32}


def counted_backprojections(monkeypatch):
    """Counts the engine's ``backproject_ping`` calls in the list it
    returns."""
    calls = []
    real = shard.backproject_ping

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(shard, "backproject_ping", counted)
    return calls


@pytest.mark.parametrize("n_shards", [2, 4])
def test_window1_backprojects_each_ping_once(monkeypatch, n_shards):
    """Window 1 backprojects a ping once whatever S; a window engine
    (window 4) still backprojects each ping on every shard, as JAX's
    window engine does.  Both maps hold the same voxels on each shard."""
    calls = counted_backprojections(monkeypatch)
    pings = survey(N_PINGS)
    cfg = port_cfg(SMALL_CFG)
    w1, w1_stats = map_ping_sequence_sharded(
        *pings, cfg, mesh=mesh(n_shards), local_capacity=CAPACITY,
        dtype=torch.float64, window=1)
    assert len(calls) == N_PINGS
    calls.clear()
    w4, _ = map_ping_sequence_sharded(
        *pings, cfg, mesh=mesh(n_shards), local_capacity=CAPACITY,
        dtype=torch.float64, window=4)
    assert len(calls) == n_shards * N_PINGS
    assert w1_stats["num_candidates"].min() > 0
    for a, b in zip(w1.shards, w4.shards):
        keys, lo = by_key(*touched_voxels_hash(a))
        w_keys, w_lo = by_key(*touched_voxels_hash(b))
        np.testing.assert_array_equal(keys, w_keys)
        np.testing.assert_allclose(lo, w_lo, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("n_shards", range(1, 9))
def test_owner_blocks_equal_owned_frame_records(n_shards, dtype):
    """Each shard's block of ``frame_owner_blocks`` is
    ``owned_frame_records(..., shard=s)`` record by record: hi, lo, count,
    n_occ in the same order, n_unique, the owned n_valid and the frame's
    bounds and range flag.  A ping whose every candidate lies below the
    z filter's floor gives every shard an empty block of one EMPTY_HI
    lane."""
    cfg = port_cfg(SMALL_CFG)
    # the floor above every candidate: no valid lane
    floor_cfg = dataclasses.replace(cfg, z_filter_enabled=True,
                                    z_filter_min=100.0)
    t_dtype = DTYPES[dtype]
    images, positions, quats = survey(3)
    T = torch.as_tensor(batched_sonar_to_world(positions, quats, cfg),
                        dtype=t_dtype)
    tables = build_fan_tables(cfg, 100, 64)
    pings = [(image, T[i], cfg)
             for i, image in enumerate(torch.as_tensor(images))]
    pings.append(pings[0][:2] + (floor_cfg,))
    for image, T_i, c in pings:
        kw = dict(tables=tables, cfg=c, dtype=t_dtype)
        blocks = frame_owner_blocks(image, T_i, n_shards, **kw)
        starts = blocks.starts.tolist()
        assert starts[0] == 0 and starts == sorted(starts)
        assert int(blocks.counts.sum()) == int(blocks.aux.n_valid)
        assert (starts[-1] == 0) == (c is floor_cfg)
        for s in range(n_shards):
            got, g_aux = owner_block(blocks, s, starts, torch.device("cpu"))
            want, w_aux = owned_frame_records(
                image, T_i, s, n_shards, brick_bits=0, **kw)
            n = int(want.n_unique)
            assert int(got.n_unique) == n == starts[s + 1] - starts[s]
            for g, w in zip(got[:4], want[:4]):
                assert torch.equal(g[:n], w[:n])
            assert got.hi.shape[0] == max(n, 1)
            if n == 0:
                assert int(got.hi[0]) == int(got.lo[0]) == EMPTY_HI
            for g, w in zip(g_aux, w_aux):
                assert g.dtype == w.dtype and torch.equal(g, w)


def test_one_shard_failure_rejects_the_ping_on_every_shard(monkeypatch):
    """S = 3, window 1: shard 1's apply of ping 2 fails; no shard commits
    it.  Every shard is the map of pings 0-1, poisoned, and pings 2 on
    report ``overflowed`` and zeros."""
    cfg = port_cfg(SMALL_CFG)
    images, positions, quats = survey(4)
    T = batched_sonar_to_world(positions, quats, cfg)
    tables = build_fan_tables(cfg, 100, 64)
    real = shard.apply_frame_records
    calls = []

    def flaky(sub, *args, **kw):
        new, win = real(sub, *args, **kw)
        calls.append(1)
        if len(calls) == 3 * 2 + 2:  # ping 2, shard 1
            new = sub._replace(poisoned=torch.ones_like(sub.poisoned))
            win = dict(win, overflowed=torch.ones_like(win["overflowed"]))
        return new, win

    def scan(imgs, Ts):
        st = init_sharded_hash_grid(mesh(3), CAPACITY, torch.float64)
        return scan_pings_sharded(st, imgs, Ts, None, tables, cfg,
                                  torch.float64)

    before, _ = scan(images[:2], T[:2])
    monkeypatch.setattr(shard, "apply_frame_records", flaky)
    failed, stats = scan(images, T)
    assert len(calls) == 3 * 3  # ping 3 never ran
    assert failed.poisoned.all()
    for a, b in zip(failed.shards, before.shards):
        assert torch.equal(a.key_rows, b.key_rows)
        assert torch.equal(a.log_odds, b.log_odds)
        assert torch.equal(a.min_bounds, b.min_bounds)
    assert not stats["overflowed"][:2].any() and stats["overflowed"][2:].all()
    for k in STATS:
        if k not in ("overflowed", "range_fail"):
            assert not stats[k][2:].any(), k
