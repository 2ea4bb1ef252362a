"""The port's sharded brick engines (``parallel/shard.py``,
``parallel/shard_brick.py``, ``parallel/shard_frames.py``: the
frame-parallel and the replicated-records engine) and the grouped dedups
against the JAX package's on its 8 virtual CPU devices.

Both packages take the same numpy-seeded pings (100x64, 5 m at 0.1 m
voxels unless a test says otherwise).  The port's mesh repeats the CPU:
``("cpu",) * S``.  Tolerances: owners, records, integer per-ping stats
and each shard's voxel keys bit-equal; float64 log-odds within
EXP_ULP_TOL (tests/torch_parity.py: 1e-12), float32 within 1e-5 in
probability.  Within the port, the sharded map equals the single-card
brick map bit for bit.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu.grid.brick import (  # noqa: E402
    touched_voxels_brick as j_touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu.ops import dedup as j_dedup  # noqa: E402
from sonar_3d_reconstruction_tpu.ops.packing import (  # noqa: E402
    pack_brick_keys as j_pack_brick_keys,
)
from sonar_3d_reconstruction_tpu.parallel.shard import (  # noqa: E402
    make_mesh as j_make_mesh,
)
from sonar_3d_reconstruction_tpu.parallel.shard_brick import (  # noqa: E402
    local_brick_states as j_local_brick_states,
    map_ping_sequence_sharded_brick as j_sharded_brick,
    owner_shard_brick as j_owner_shard_brick,
)
from sonar_3d_reconstruction_tpu.parallel.shard_frames import (  # noqa: E402
    map_ping_sequence_sharded_frames as j_sharded_frames,
)

from sonar_3d_reconstruction_tpu_torch import pipeline  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import (  # noqa: E402
    dedup_frame_compact_grouped,
    dedup_frame_grouped,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import (  # noqa: E402
    pack_brick_keys,
)
from sonar_3d_reconstruction_tpu_torch.parallel import (  # noqa: E402
    shard_brick,
    shard_frames,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard import make_mesh  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (  # noqa: E402
    ShardedBrickState,
    default_local_capacity,
    gather_sharded_brick_state,
    init_sharded_brick_grid,
    local_brick_states,
    map_ping_sequence_sharded_brick,
    owner_shard_brick,
    rehash_sharded_bricks,
    sharded_brick_bounds,
    sharded_brick_state_to_numpy,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard_frames import (  # noqa: E402
    map_ping_sequence_sharded_frames,
)

from conftest import circular_trajectory, synthetic_ping  # noqa: E402
from torch_parity import EXP_ULP_TOL, port_cfg  # noqa: E402

SMALL_CFG = MapperConfig(image_width=64, image_height=100, max_range=5.0,
                         min_range=0.5, voxel_resolution=0.1,
                         intensity_threshold=30)
# 60 m of range at 0.1 m voxels: one ping's box alone is too wide for box
# keys, so every window takes two-word brick codes
WIDE_CFG = MapperConfig(image_width=64, image_height=100, max_range=60.0,
                        min_range=0.5, voxel_resolution=0.1,
                        intensity_threshold=30)
N_PINGS, WINDOW = 9, 4  # two full windows and a partial one
# bricks a shard: the surveys never grow them, so each JAX run is one
# program set (growth: test_forced_growth_replays_all_or_nothing)
CAPACITY = 1 << 12
STATS = ("num_occupied", "num_free", "num_candidates", "overflowed")
DTYPES = {"f64": (torch.float64, jnp.float64),
          "f32": (torch.float32, jnp.float32)}


def survey(n=N_PINGS, seed=940, radius=0.8):
    images = np.stack([synthetic_ping(100, 64, seed=seed + i)
                       for i in range(n)])
    positions, quats = circular_trajectory(n, radius=radius)
    return images, positions, quats


def by_key(keys, lo):
    order = np.lexsort(keys.T)
    return keys[order], lo[order]


def port_shards(state):
    """Each shard's (keys, log-odds), sorted by key."""
    return [by_key(*touched_voxels_brick(s)) for s in local_brick_states(state)]


@functools.lru_cache(maxsize=None)
def jax_sharded(n_shards, dtype, cfg=SMALL_CFG, n=N_PINGS, window=WINDOW):
    """The JAX frame-parallel map of ``survey(n)`` on the first
    ``n_shards`` virtual devices: (each shard's sorted (keys, log-odds),
    per-ping stats)."""
    state, stats = j_sharded_frames(
        *survey(n), cfg, mesh=j_make_mesh(jax.devices()[:n_shards]),
        dtype=DTYPES[dtype][1], window=window, local_capacity=CAPACITY)
    shards = [by_key(*j_touched_voxels_brick(s))
              for s in j_local_brick_states(state)]
    return shards, {k: np.asarray(v) for k, v in stats.items()}


@functools.lru_cache(maxsize=None)
def jax_replicated(n_shards, window=WINDOW):
    """JAX's replicated-records brick map of ``survey()`` (float64) on the
    first ``n_shards`` virtual devices: (each shard's sorted (keys,
    log-odds), per-ping stats)."""
    state, stats = j_sharded_brick(
        *survey(), SMALL_CFG, mesh=j_make_mesh(jax.devices()[:n_shards]),
        dtype=jnp.float64, window=window, local_capacity=CAPACITY)
    shards = [by_key(*j_touched_voxels_brick(s))
              for s in j_local_brick_states(state)]
    return shards, {k: np.asarray(v) for k, v in stats.items()}


def port_replicated(n_shards, capacity=CAPACITY, **kw):
    """The port's replicated-records map of ``survey()`` (float64, windows
    of WINDOW) on ``("cpu",) * n_shards``."""
    return map_ping_sequence_sharded_brick(
        *survey(), port_cfg(SMALL_CFG), mesh=["cpu"] * n_shards,
        local_capacity=capacity, dtype=torch.float64, window=WINDOW, **kw)


def port_sharded(n_shards, dtype, cfg=SMALL_CFG, n=N_PINGS, window=WINDOW,
                 capacity=CAPACITY, pings=None, **kw):
    """The port's map of ``pings`` (default ``survey(n)``) from an empty
    map of ``capacity`` bricks a shard on ``("cpu",) * n_shards``."""
    t_dtype = DTYPES[dtype][0]
    state = init_sharded_brick_grid(["cpu"] * n_shards, capacity, t_dtype)
    return map_ping_sequence_sharded_frames(
        *(pings or survey(n)), port_cfg(cfg), state=state, dtype=t_dtype,
        window=window, **kw)


def scattered_survey():
    """``survey()`` with every other window-mate 70 m away on one axis:
    no window fits box keys, so every window takes two-word codes."""
    images, positions, quats = survey()
    hops = np.array([[0, 0, 0], [70, 0, 0], [0, 70, 0], [0, 0, 70]], float)
    return images, positions + hops[np.arange(N_PINGS) % 4], quats


def assert_shards_match(got, want, dtype):
    """Per shard: keys equal, log-odds within the dtype's bar (float32:
    1e-5 in probability)."""
    assert len(got) == len(want)
    for (keys, lo), (w_keys, w_lo) in zip(got, want):
        assert len(keys) > 0
        np.testing.assert_array_equal(keys, w_keys)
        if dtype == "f64":
            np.testing.assert_allclose(lo, w_lo, rtol=0,
                                       atol=EXP_ULP_TOL[torch.float64])
        else:
            p, w_p = (1 / (1 + np.exp(-x.astype(np.float64)))
                      for x in (lo, w_lo))
            np.testing.assert_allclose(p, w_p, rtol=0, atol=1e-5)


def test_make_mesh_matches_jax():
    """A mesh is the devices given, in order, repeats kept (JAX's virtual
    devices are distinct; the port repeats one); with none and no card it
    raises."""
    j_mesh = j_make_mesh(jax.devices()[:4])
    mesh = make_mesh(["cpu"] * 4)
    assert len(mesh) == j_mesh.devices.size == 4
    assert mesh == (torch.device("cpu"),) * 4
    assert make_mesh([torch.device("cpu"), "cpu"]) == mesh[:2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
    with pytest.raises(ValueError, match="at least one"):
        make_mesh([])


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_owner_shard_brick_matches_jax(n_shards):
    """Owners of random voxel keys bit-equal to JAX's; every voxel of a
    brick lands on its brick's owner."""
    rng = np.random.default_rng(3 + n_shards)
    bricks = rng.integers(-4000, 4000, size=(3000, 3)).astype(np.int32) * 4
    offs = rng.integers(0, 4, size=(3000, 3)).astype(np.int32)
    hi, lo, _ = pack_brick_keys(torch.as_tensor(bricks + offs), 2)
    got = owner_shard_brick(hi, lo, 2, n_shards).numpy()
    j_hi, j_lo, _ = j_pack_brick_keys(jnp.asarray(bricks + offs), 2)
    np.testing.assert_array_equal(
        got, np.asarray(j_owner_shard_brick(j_hi, j_lo, 2, n_shards)))
    c_hi, c_lo, _ = pack_brick_keys(torch.as_tensor(bricks), 2)
    np.testing.assert_array_equal(
        got, owner_shard_brick(c_hi, c_lo, 2, n_shards).numpy())
    assert got.min() >= 0 and got.max() < n_shards
    if n_shards > 1:
        assert np.bincount(got).max() < 2 * len(got) / n_shards


@pytest.mark.parametrize("form", ["wide", "compact"])
def test_grouped_dedups_match_jax(form):
    """Both grouped dedups give JAX's records record by record: (group,
    key) order, counts, occupied counts, groups, n_unique (and the
    compact form's pack flag)."""
    rng = np.random.default_rng(11)
    n, S = 5000, 4
    voxels = rng.integers(-300, 300, size=(700, 3)).astype(np.int32)
    keys = voxels[rng.integers(0, len(voxels), size=n)]
    occ = rng.random(n) < 0.3
    valid = rng.random(n) < 0.9
    if form == "wide":
        hi, lo, _ = pack_brick_keys(torch.as_tensor(keys), 2)
        group = owner_shard_brick(hi, lo, 2, S)
        rec, rg = dedup_frame_grouped(hi, lo, torch.as_tensor(occ),
                                      torch.as_tensor(valid), group, S,
                                      brick=True)
        j_rec, j_rg = j_dedup.dedup_frame_grouped(
            jnp.asarray(hi.numpy(), jnp.uint32),
            jnp.asarray(lo.numpy(), jnp.uint32), jnp.asarray(occ),
            jnp.asarray(valid), jnp.asarray(group.numpy(), jnp.int32), S, n)
        fields = ("hi", "lo", "count", "n_occ")
    else:
        key_bits = 24
        # distinct voxels may share a key: the dedup sees only keys
        key = torch.as_tensor(((keys[:, 0].astype(np.int64) + 300) * 600
                               + keys[:, 1] + 300) * 4 + (keys[:, 2] & 3))
        group = (key >> 6) % S
        rec, rg = dedup_frame_compact_grouped(
            key, torch.as_tensor(occ), torch.as_tensor(valid), group, S,
            key_bits)
        j_rec, j_rg = j_dedup.dedup_frame_compact_grouped(
            jnp.asarray(key.numpy(), jnp.uint32), jnp.asarray(occ),
            jnp.asarray(valid), jnp.asarray(group.numpy(), jnp.int32), S,
            key_bits, n)
        fields = ("key", "payload")
        assert bool(rec.pack_fail) == bool(j_rec.pack_fail) is False
    u = int(rec.n_unique)
    assert u == int(j_rec.n_unique) > 100
    for f in fields:
        np.testing.assert_array_equal(getattr(rec, f)[:u].numpy(),
                                      np.asarray(getattr(j_rec, f))[:u], f)
    np.testing.assert_array_equal(rg[:u].numpy(), np.asarray(j_rg)[:u])
    assert (rg[u:] == S).all() and (np.diff(rg[:u].numpy()) >= 0).all()


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_sharded_frames_match_jax(n_shards, dtype):
    """S = 2 and 4, compact box keys, a partial last window: each shard
    holds JAX's voxels, per-ping stats equal."""
    state, stats = port_sharded(n_shards, dtype)
    want, w_stats = jax_sharded(n_shards, dtype)
    assert_shards_match(port_shards(state), want, dtype)
    for k in STATS:
        np.testing.assert_array_equal(stats[k], w_stats[k], k)
    assert state.local_capacity == CAPACITY and len(state.shards) == n_shards


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("use_boxes", [True, False], ids=["box", "wide"])
def test_sharded_frames_equal_single_card_map(n_shards, use_boxes):
    """The sharded map (box keys, or two-word codes for poses too far
    apart for them; both dense modes) is the single-card brick map bit for
    bit: voxels, log-odds, bounds, per-ping stats; every voxel on its
    brick's owner."""
    pings = survey() if use_boxes else scattered_survey()
    single, s_stats = pipeline.map_ping_sequence(
        *pings, port_cfg(SMALL_CFG), device="cpu", dtype=torch.float64,
        window=WINDOW)
    want = by_key(*touched_voxels_brick(single))
    for mode in ("pallas", "pallas-raw"):
        state, stats = port_sharded(n_shards, "f64", pings=pings,
                                    dense_mode=mode)
        keys, lo = by_key(*gather_sharded_brick_state(state))
        np.testing.assert_array_equal(keys, want[0])
        np.testing.assert_array_equal(lo, want[1])
        for k in STATS + ("range_fail", "pack_overflow"):
            np.testing.assert_array_equal(stats[k], s_stats[k], k)
        bmin, bmax = sharded_brick_bounds(state)
        np.testing.assert_array_equal(bmin, single.min_bounds.numpy())
        np.testing.assert_array_equal(bmax, single.max_bounds.numpy())
        assert int(state.used.sum()) == len(keys) == int(single.used)
        for s, (k, _) in enumerate(port_shards(state)):
            hi, lo_w, _ = pack_brick_keys(torch.as_tensor(k), 2)
            assert (owner_shard_brick(hi, lo_w, 2, n_shards) == s).all()
        # every record reached exactly one owner: 16 bytes a record
        assert (stats["xchg_bytes"] == 16 * (stats["num_occupied"]
                                             + stats["num_free"])).all()
        assert (stats["xchg_n_max"] > 0).all()
        assert (stats["batch_n_bricks_max"] <= stats["batch_n_bricks"]).all()


def test_more_shards_than_window_frames_match_jax():
    """Eight shards, windows of 4 over 7 pings: half the sources idle, and
    the last window is partial; each shard holds JAX's voxels."""
    state, stats = port_sharded(8, "f64", n=7)
    want, w_stats = jax_sharded(8, "f64", n=7)
    assert_shards_match(port_shards(state), want, "f64")
    for k in STATS:
        np.testing.assert_array_equal(stats[k], w_stats[k], k)


def test_wide_path_at_60_m_matches_jax():
    """At 60 m no window fits box keys: the two-word path's shards hold
    JAX's voxels (float64, 3 pings, windows of 2, S = 4)."""
    state, stats = port_sharded(4, "f64", cfg=WIDE_CFG, n=3, window=2)
    want, w_stats = jax_sharded(4, "f64", cfg=WIDE_CFG, n=3, window=2)
    assert_shards_match(port_shards(state), want, "f64")
    for k in STATS:
        np.testing.assert_array_equal(stats[k], w_stats[k], k)


def test_forced_growth_replays_all_or_nothing(monkeypatch):
    """From 128 bricks a shard the map grows (every shard to one capacity)
    and equals the single-card map.  A window that fails on one shard
    commits on none: every table is the one before it, all poisoned."""
    single, _ = pipeline.map_ping_sequence(
        *survey(), port_cfg(SMALL_CFG), device="cpu", dtype=torch.float64,
        window=WINDOW)
    state, stats = port_sharded(4, "f64", capacity=128)
    assert state.local_capacity > 128 and not stats["overflowed"].any()
    assert {s.capacity for s in state.shards} == {state.local_capacity}
    keys, lo = by_key(*gather_sharded_brick_state(state))
    want = by_key(*touched_voxels_brick(single))
    np.testing.assert_array_equal(keys, want[0])
    np.testing.assert_array_equal(lo, want[1])

    # shard 2's apply fails once: no shard commits that window
    real = shard_frames.apply_brick_records_compact
    calls = []

    def flaky(shard, *args, **kw):
        new, win = real(shard, *args, **kw)
        calls.append(len(calls))
        if len(calls) == 3:
            win = dict(win, overflowed=torch.ones_like(win["overflowed"]))
            new = shard._replace(poisoned=torch.ones_like(shard.poisoned))
        return new, win

    monkeypatch.setattr(shard_frames, "apply_brick_records_compact", flaky)
    images, positions, quats = survey()
    before = init_sharded_brick_grid(["cpu"] * 4, CAPACITY, torch.float64)
    rehashes = []

    def counted(st, cap):
        rehashes.append(st)
        return rehash_sharded_bricks(st, cap)

    monkeypatch.setattr(shard_brick, "rehash_sharded_bricks", counted)
    state, stats = map_ping_sequence_sharded_frames(
        images, positions, quats, port_cfg(SMALL_CFG), state=before,
        dtype=torch.float64, window=WINDOW)
    (failed,) = rehashes
    assert all(bool(p) for p in failed.poisoned)
    for s, b in zip(failed.shards, before.shards):
        assert torch.equal(s.key_rows, b.key_rows)
        assert torch.equal(s.log_odds, b.log_odds)
    keys, lo = by_key(*gather_sharded_brick_state(state))
    np.testing.assert_array_equal(keys, want[0])
    np.testing.assert_array_equal(lo, want[1])
    assert not stats["overflowed"].any()


def test_range_fail_raises():
    """A pose 60 km out puts keys past the packable range: fatal."""
    images, positions, quats = survey(4)
    positions = positions + [6.0e4, 0.0, 0.0]
    with pytest.raises(ValueError, match="packable range"):
        map_ping_sequence_sharded_frames(
            images, positions, quats, port_cfg(SMALL_CFG), mesh=["cpu"] * 2,
            dtype=torch.float64, window=2)


def test_state_layer_views_and_growth():
    """The stacked numpy views hold each shard's arrays in JAX's layout;
    growth keeps every voxel on its shard; default capacities follow the
    JAX rule."""
    state, _ = port_sharded(2, "f64")
    assert isinstance(state, ShardedBrickState) and state.n_shards == 2
    d = sharded_brick_state_to_numpy(state)
    assert d["key_rows"].shape[0] == 2 and d["key_rows"].dtype == np.uint32
    assert d["used"].dtype == np.int32
    np.testing.assert_array_equal(d["used"], state.used.numpy())
    np.testing.assert_array_equal(d["log_odds"][1],
                                  state.shards[1].log_odds.numpy())
    grown = rehash_sharded_bricks(state, 4 * CAPACITY)
    assert grown.local_capacity == 4 * CAPACITY
    for a, b in zip(port_shards(grown), port_shards(state)):
        np.testing.assert_array_equal(a[0], b[0])
    assert default_local_capacity(1 << 20, 4) == 1 << 14
    assert default_local_capacity(1 << 10, 8) == 128
    with pytest.raises(ValueError, match="power of two"):
        init_sharded_brick_grid(["cpu"], 100)
    with pytest.raises(ValueError, match="not the state's"):
        map_ping_sequence_sharded_frames(
            *survey(2), port_cfg(SMALL_CFG), mesh=["cpu"] * 3, state=state,
            dtype=torch.float64)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_replicated_brick_engine_matches_jax(n_shards):
    """The replicated-records engine at S = 2 and 4, float64, windows of 4
    with a partial last one: each shard holds JAX's voxels, per-ping stats
    equal."""
    state, stats = port_replicated(n_shards)
    want, w_stats = jax_replicated(n_shards)
    assert_shards_match(port_shards(state), want, "f64")
    for k in STATS + ("range_fail", "pack_overflow"):
        np.testing.assert_array_equal(stats[k], w_stats[k], k)
    assert state.local_capacity == CAPACITY and state.n_shards == n_shards


def test_replicated_brick_engine_equals_frame_parallel_and_brick_maps():
    """S = 3: the replicated-records map is the frame-parallel engine's
    shard for shard and the single-card brick map voxel for voxel,
    log-odds bit-equal, with its bounds and per-ping stats."""
    single, s_stats = pipeline.map_ping_sequence(
        *survey(), port_cfg(SMALL_CFG), device="cpu", dtype=torch.float64,
        window=WINDOW)
    state, stats = port_replicated(3)
    frames, _ = port_sharded(3, "f64")
    for got, want in zip(port_shards(state), port_shards(frames)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    keys, lo = by_key(*gather_sharded_brick_state(state))
    want = by_key(*touched_voxels_brick(single))
    np.testing.assert_array_equal(keys, want[0])
    np.testing.assert_array_equal(lo, want[1])
    for k in STATS + ("range_fail", "pack_overflow"):
        np.testing.assert_array_equal(stats[k], s_stats[k], k)
    bmin, bmax = sharded_brick_bounds(state)
    np.testing.assert_array_equal(bmin, single.min_bounds.numpy())
    np.testing.assert_array_equal(bmax, single.max_bounds.numpy())
    assert int(state.used.sum()) == len(keys)
    assert (stats["batch_n_lanes_max"] <= stats["batch_n_lanes"]).all()
    assert (stats["batch_n_bricks_max"] > 0).all()


def test_replicated_growth_replays_all_or_nothing(monkeypatch):
    """From 128 bricks a shard the replicated-records map grows (every
    shard to one capacity) and equals the big-table map.  A window that
    fails on one shard commits on none: every table is the one before
    it, all poisoned."""
    big, _ = port_replicated(4)
    state, stats = port_replicated(4, capacity=128)
    assert state.local_capacity > 128 and not stats["overflowed"].any()
    assert {s.capacity for s in state.shards} == {state.local_capacity}
    for got, want in zip(port_shards(state), port_shards(big)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])

    real = shard_brick.apply_brick_records_wide
    calls = []

    def flaky(sub, *args, **kw):
        new, win = real(sub, *args, **kw)
        calls.append(len(calls))
        if len(calls) == 4 + 2:  # window 1, shard 1
            win = dict(win, overflowed=torch.ones_like(win["overflowed"]))
            new = sub._replace(poisoned=torch.ones_like(sub.poisoned))
        return new, win

    monkeypatch.setattr(shard_brick, "apply_brick_records_wide", flaky)
    rehashes = []

    def counted(st, cap):
        rehashes.append(st)
        return rehash_sharded_bricks(st, cap)

    monkeypatch.setattr(shard_brick, "rehash_sharded_bricks", counted)
    state, stats = port_replicated(4)
    (failed,) = rehashes
    assert all(bool(p) for p in failed.poisoned)
    assert state.local_capacity == 2 * CAPACITY
    first, _ = map_ping_sequence_sharded_brick(
        *(x[:WINDOW] for x in survey()), port_cfg(SMALL_CFG),
        mesh=["cpu"] * 4,
        local_capacity=CAPACITY, dtype=torch.float64, window=WINDOW)
    for a, b in zip(failed.shards, first.shards):
        assert torch.equal(a.key_rows, b.key_rows)
        assert torch.equal(a.log_odds, b.log_odds)
    for got, want in zip(port_shards(state), port_shards(big)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert not stats["overflowed"].any()


def test_replicated_engine_refusals():
    """Keys out of range are fatal; without a card a mesh of None raises
    (no CPU fallback); a resumed map on another mesh is a ValueError."""
    images, positions, quats = survey(4)
    with pytest.raises(ValueError, match="packable range"):
        map_ping_sequence_sharded_brick(
            images, positions + [6.0e4, 0.0, 0.0], quats,
            port_cfg(SMALL_CFG), mesh=["cpu"] * 2, dtype=torch.float64,
            window=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            map_ping_sequence_sharded_brick(images, positions, quats,
                                            port_cfg(SMALL_CFG))
    state = init_sharded_brick_grid(["cpu"] * 2, CAPACITY, torch.float64)
    with pytest.raises(ValueError, match="not the state's"):
        map_ping_sequence_sharded_brick(
            images, positions, quats, port_cfg(SMALL_CFG),
            mesh=["cpu"] * 3, state=state, dtype=torch.float64)
