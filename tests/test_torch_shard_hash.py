"""The port's sharded hash engine (``parallel/shard.py``) against the JAX
package's on its 8 virtual CPU devices, and against the port's
single-card hash map.

Both packages take the same numpy-seeded pings (100x64, 5 m at 0.1 m
voxels).  The port's mesh repeats the CPU: ``("cpu",) * S``.  Tolerances:
owners, keys, slots, ``key_rows``, ``used``, bounds and per-ping stats
bit-equal; float64 log-odds within EXP_ULP_TOL (tests/torch_parity.py:
1e-12), float32 within 1e-5 in probability.  Within the port, the
sharded map equals the single-card hash map bit for bit.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.io.checkpoint import (  # noqa: E402
    save_map as j_save_map,
)
from sonar_3d_reconstruction_tpu.ops.backproject import (  # noqa: E402
    build_fan_tables as j_build_fan_tables,
)
from sonar_3d_reconstruction_tpu.parallel import shard as j_shard  # noqa: E402
from sonar_3d_reconstruction_tpu.pipeline import (  # noqa: E402
    batched_sonar_to_world as j_batched_sonar_to_world,
)

from sonar_3d_reconstruction_tpu_torch import pipeline  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.geometry import (  # noqa: E402
    batched_sonar_to_world,
)
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu_torch.grid.hash import (  # noqa: E402
    EMPTY,
    hash_state_from_numpy,
    touched_voxels_hash,
)
from sonar_3d_reconstruction_tpu_torch.io.checkpoint import (  # noqa: E402
    load_map,
    load_map_brick,
    load_map_sharded_brick,
    save_map,
)
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (  # noqa: E402
    build_fan_tables,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import pack_keys  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.parallel import shard  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.parallel.shard import (  # noqa: E402
    ShardedHashState,
    gather_sharded_state,
    init_sharded_hash_grid,
    map_ping_sequence_sharded,
    owner_shard,
    rehash_sharded,
    scan_pings_sharded,
    sharded_bounds,
    sharded_hash_state_to_numpy,
    sharded_ping_step,
    touched_voxels_sharded,
    window_scan_sharded,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (  # noqa: E402
    gather_sharded_brick_state,
)

from conftest import synthetic_ping  # noqa: E402
from torch_parity import EXP_ULP_TOL, port_cfg  # noqa: E402
from test_torch_shard import SMALL_CFG, by_key, survey  # noqa: E402

N_PINGS, WINDOW = 9, 8  # a full window and a partial one
# slots a shard: the surveys never grow it at S >= 2
CAPACITY = 1 << 14
# slots a shard of the growth test: two doublings at S = 4
GROW_CAPACITY = 1 << 10
STATS = ("num_occupied", "num_free", "num_candidates", "overflowed",
         "range_fail")
DTYPES = {"f64": (torch.float64, jnp.float64),
          "f32": (torch.float32, jnp.float32)}
FIELDS = ("key_rows", "log_odds", "min_bounds", "max_bounds", "used",
          "poisoned")


def j_mesh(n_shards):
    return j_shard.make_mesh(jax.devices()[:n_shards])


def mesh(n_shards):
    return ("cpu",) * n_shards


def j_state_to_numpy(state):
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


@functools.lru_cache(maxsize=None)
def jax_scan(n_shards, dtype):
    """JAX's ``scan_pings_sharded`` (window 1) over ``survey()`` from an
    empty map of CAPACITY slots a shard: (state, per-ping stats)."""
    images, positions, quats = survey(N_PINGS)
    T = j_batched_sonar_to_world(positions, quats, SMALL_CFG)
    tables = j_build_fan_tables(SMALL_CFG, 100, 64)
    jd = DTYPES[dtype][1]
    st = j_shard.init_sharded_hash_grid(j_mesh(n_shards), CAPACITY, jd)
    st, stats = j_shard.scan_pings_sharded(
        st, jnp.asarray(images), jnp.asarray(T, jd), j_mesh(n_shards),
        tables, SMALL_CFG, dtype=jd)
    return st, {k: np.asarray(v) for k, v in stats.items()}


@functools.lru_cache(maxsize=None)
def jax_map(n_shards, dtype, window, capacity=CAPACITY):
    """JAX's ``map_ping_sequence_sharded`` over ``survey()``: (state,
    per-ping stats)."""
    st, stats = j_shard.map_ping_sequence_sharded(
        *survey(N_PINGS), SMALL_CFG, mesh=j_mesh(n_shards),
        local_capacity=capacity, dtype=DTYPES[dtype][1], window=window)
    return st, {k: np.asarray(v) for k, v in stats.items()}


def port_scan(n_shards, dtype, **kw):
    images, positions, quats = survey(N_PINGS)
    t_dtype = DTYPES[dtype][0]
    st = init_sharded_hash_grid(mesh(n_shards), CAPACITY, t_dtype)
    return scan_pings_sharded(
        st, images, batched_sonar_to_world(positions, quats,
                                           port_cfg(SMALL_CFG)),
        mesh(n_shards), build_fan_tables(port_cfg(SMALL_CFG), 100, 64),
        port_cfg(SMALL_CFG), t_dtype, **kw)


def assert_slots_match(got, want, dtype):
    """Stacked numpy states: every array equal slot for slot, log-odds
    within the dtype's bar (float32: 1e-5 in probability)."""
    for k in FIELDS:
        assert got[k].shape == want[k].shape, k
        if k != "log_odds":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif dtype == "f64":
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=EXP_ULP_TOL[torch.float64])
        else:
            p, w_p = (1 / (1 + np.exp(-x.astype(np.float64)))
                      for x in (got[k], want[k]))
            np.testing.assert_allclose(p, w_p, rtol=0, atol=1e-5)


def assert_on_owners(state):
    """Every touched voxel lies on its owner shard."""
    for s, sub in enumerate(state.shards):
        keys, _ = touched_voxels_hash(sub)
        assert len(keys)
        hi, lo, _ = pack_keys(torch.as_tensor(keys))
        assert (owner_shard(hi, lo, state.n_shards) == s).all()


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_owner_shard_matches_jax(n_shards):
    """Owners of random u32 word pairs bit-equal to JAX's."""
    rng = np.random.default_rng(20 + n_shards)
    hi = rng.integers(0, 1 << 32, size=5000, dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, size=5000, dtype=np.uint64)
    got = owner_shard(torch.as_tensor(hi.astype(np.int64)),
                      torch.as_tensor(lo.astype(np.int64)), n_shards).numpy()
    want = j_shard.owner_shard(jnp.asarray(hi, jnp.uint32),
                               jnp.asarray(lo, jnp.uint32), n_shards)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.min() >= 0 and got.max() < n_shards
    if n_shards > 1:
        assert np.bincount(got).max() < 2 * len(got) / n_shards


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_scan_pings_sharded_matches_jax(n_shards, dtype):
    """Window 1, one ping at a time: every shard's table slot for slot,
    the slot-order reads and the per-ping stats equal JAX's."""
    st, stats = port_scan(n_shards, dtype)
    j_st, j_stats = jax_scan(n_shards, dtype)
    assert isinstance(st, ShardedHashState) and st.n_shards == n_shards
    assert_slots_match(sharded_hash_state_to_numpy(st),
                       j_state_to_numpy(j_st), dtype)
    for k in STATS:
        np.testing.assert_array_equal(stats[k], j_stats[k], k)
    keys, lo = gather_sharded_state(st)
    j_keys, j_lo = j_shard.gather_sharded_state(j_st)
    np.testing.assert_array_equal(keys, j_keys)
    assert keys.shape == (n_shards * CAPACITY, 3)
    assert (keys[:, 0] == EMPTY).sum() == n_shards * CAPACITY - st.used.sum()
    for got, want in zip(sharded_bounds(st), j_shard.sharded_bounds(j_st)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_window_engine_matches_jax(dtype):
    """map_ping_sequence_sharded(window=8), S = 4: a full window and a
    partial one, every shard slot for slot and the per-ping stats equal
    JAX's window engine."""
    st, stats = map_ping_sequence_sharded(
        *survey(N_PINGS), port_cfg(SMALL_CFG), mesh=mesh(4),
        local_capacity=CAPACITY, dtype=DTYPES[dtype][0], window=WINDOW)
    j_st, j_stats = jax_map(4, dtype, WINDOW)
    assert_slots_match(sharded_hash_state_to_numpy(st),
                       j_state_to_numpy(j_st), dtype)
    for k in STATS + ("batch_n_unique", "batch_n_unique_max"):
        np.testing.assert_array_equal(stats[k], j_stats[k], k)


@pytest.mark.parametrize("window", [1, 4])
def test_sharded_map_equals_single_card_hash_map(window):
    """S = 3, float64: the sharded map is the single-card hash map voxel
    for voxel, log-odds bit-equal, with its bounds and per-ping stats;
    every voxel on its owner shard; the shards' distinct voxels sum to the
    single card's."""
    pings = survey(N_PINGS)
    single, s_stats = pipeline.map_ping_sequence(
        *pings, port_cfg(SMALL_CFG), device="cpu", backend="hash",
        dtype=torch.float64, window=window)
    st, stats = map_ping_sequence_sharded(
        *pings, port_cfg(SMALL_CFG), mesh=mesh(3), dtype=torch.float64,
        window=window, local_capacity=CAPACITY)
    keys, lo = by_key(*touched_voxels_sharded(st))
    want = by_key(*touched_voxels_hash(single))
    np.testing.assert_array_equal(keys, want[0])
    np.testing.assert_array_equal(lo, want[1])
    for k in STATS + ("batch_n_unique",):
        np.testing.assert_array_equal(stats[k], s_stats[k], k)
    for got, w in zip(sharded_bounds(st), (single.min_bounds,
                                           single.max_bounds)):
        np.testing.assert_array_equal(got, w.numpy())
    assert int(st.used.sum()) == len(keys) == int(single.used)
    assert (stats["batch_n_unique_max"] <= stats["batch_n_unique"]).all()
    assert_on_owners(st)


def test_forced_growth_replays_to_jax_map(monkeypatch):
    """From GROW_CAPACITY slots a shard at S = 4 the map grows, every
    shard to one capacity, and ends at JAX's grown map slot for slot.  A
    ping that fails on one shard commits on none: every table is the one
    before it, all poisoned, and growth replays it."""
    st, stats = map_ping_sequence_sharded(
        *survey(N_PINGS), port_cfg(SMALL_CFG), mesh=mesh(4),
        local_capacity=GROW_CAPACITY, dtype=torch.float64)
    j_st, j_stats = jax_map(4, "f64", 1, GROW_CAPACITY)
    assert st.local_capacity > GROW_CAPACITY
    assert {s.capacity for s in st.shards} == {st.local_capacity}
    assert_slots_match(sharded_hash_state_to_numpy(st),
                       j_state_to_numpy(j_st), "f64")
    for k in STATS:
        np.testing.assert_array_equal(stats[k], j_stats[k], k)

    # shard 2's apply of the third call fails once: no shard commits
    real = shard.apply_frame_records
    calls = []

    def flaky(sub, *args, **kw):
        new, win = real(sub, *args, **kw)
        calls.append(len(calls))
        if len(calls) == 4 + 3:  # ping 1, shard 2
            new = sub._replace(poisoned=torch.ones_like(sub.poisoned))
            win = dict(win, overflowed=torch.ones_like(win["overflowed"]))
        return new, win

    monkeypatch.setattr(shard, "apply_frame_records", flaky)
    rehashes = []

    def counted(state, cap):
        rehashes.append(state)
        return rehash_sharded(state, cap)

    monkeypatch.setattr(shard, "rehash_sharded", counted)
    before = init_sharded_hash_grid(mesh(4), CAPACITY, torch.float64)
    grown, g_stats = map_ping_sequence_sharded(
        *survey(N_PINGS), port_cfg(SMALL_CFG), state=before,
        dtype=torch.float64)
    (failed,) = rehashes
    assert failed.poisoned.all()
    after_ping0, _ = map_ping_sequence_sharded(
        *(x[:1] for x in survey(N_PINGS)), port_cfg(SMALL_CFG),
        state=init_sharded_hash_grid(mesh(4), CAPACITY, torch.float64),
        dtype=torch.float64)
    for a, b in zip(failed.shards, after_ping0.shards):
        assert torch.equal(a.key_rows, b.key_rows)
        assert torch.equal(a.log_odds, b.log_odds)
    assert grown.local_capacity == 2 * CAPACITY
    keys, lo = by_key(*touched_voxels_sharded(grown))
    want = by_key(*touched_voxels_sharded(st))
    np.testing.assert_array_equal(keys, want[0])
    np.testing.assert_array_equal(lo, want[1])
    for k in STATS:
        np.testing.assert_array_equal(g_stats[k], stats[k], k)


def test_bucket_overflow_rejects_ping_on_every_shard():
    """One ping into 128 slots a shard overflows a bucket: the ping is
    rejected on every shard (all poisoned, every slot empty, zeros and
    ``overflowed`` in its stats), as in JAX's atomic test."""
    images = synthetic_ping(100, 64, seed=70)
    T = batched_sonar_to_world(np.zeros((1, 3)),
                               np.array([[0.0, 0.0, 0.0, 1.0]]),
                               port_cfg(SMALL_CFG))[0]
    st = init_sharded_hash_grid(mesh(8), 128, torch.float64)
    st, stats = sharded_ping_step(
        st, images, T, None, build_fan_tables(port_cfg(SMALL_CFG), 100, 64),
        port_cfg(SMALL_CFG), torch.float64)
    assert bool(stats["overflowed"]) and stats["num_occupied"] == 0
    assert stats["num_candidates"] == stats["num_free"] == 0
    assert st.poisoned.all() and (st.keys == EMPTY).all()


@pytest.mark.parametrize("window", [1, 2])
def test_start_skips_frames(window):
    """Frames before ``start`` are no-ops that report zeros: the map
    equals the scan of the later frames alone, shard for shard."""
    images, positions, quats = survey(4)
    cfg = port_cfg(SMALL_CFG)
    T = batched_sonar_to_world(positions, quats, cfg)
    tables = build_fan_tables(cfg, 100, 64)
    scan = scan_pings_sharded if window == 1 else functools.partial(
        window_scan_sharded, window=window)

    def run(imgs, Ts, start):
        st = init_sharded_hash_grid(mesh(2), CAPACITY, torch.float64)
        return scan(st, imgs, Ts, None, tables, cfg, torch.float64,
                    start=start)

    skip, stats = run(images, T, 2)
    tail, t_stats = run(images[2:], T[2:], 0)
    for a, b in zip(skip.shards, tail.shards):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for k in STATS:
        assert not stats[k][:2].any()
        np.testing.assert_array_equal(stats[k][2:], t_stats[k], k)
    if window > 1:
        with pytest.raises(ValueError, match="multiple of window"):
            run(images, T, 1)


def test_keys_out_of_range_raise():
    """A pose 60 km out puts keys past the packable range: fatal in both
    step forms."""
    images, positions, quats = survey(3)
    for window in (1, 2):
        with pytest.raises(ValueError, match="packable range"):
            map_ping_sequence_sharded(
                images, positions + [6.0e4, 0.0, 0.0], quats,
                port_cfg(SMALL_CFG), mesh=mesh(2), dtype=torch.float64,
                window=window)


def test_rehash_sharded_matches_jax():
    """JAX's window-1 map at S = 2 loaded into the port and grown by both
    packages to 4x the slots: slot for slot equal, poison cleared."""
    j_st, _ = jax_scan(2, "f64")
    j_np = j_state_to_numpy(j_st)
    st = ShardedHashState(tuple(
        hash_state_from_numpy({k: v[s] for k, v in j_np.items()}, "cpu")
        for s in range(2)))
    st = shard.poison(st)
    grown = rehash_sharded(st, 4 * CAPACITY)
    j_grown = j_shard.rehash_sharded(j_st, j_mesh(2), 4 * CAPACITY)
    assert grown.local_capacity == 4 * CAPACITY
    assert not grown.poisoned.any()
    assert_slots_match(sharded_hash_state_to_numpy(grown),
                       j_state_to_numpy(j_grown), "f64")


def test_save_map_of_sharded_hash_map(tmp_path):
    """``save_map`` of a sharded hash map holds the single-card hash map's
    snapshot content and JAX's ``save_map`` of its sharded map's; it
    restores through ``load_map``, ``load_map_brick`` and
    ``load_map_sharded_brick``."""
    cfg = port_cfg(SMALL_CFG)
    pings = survey(N_PINGS)
    st, _ = map_ping_sequence_sharded(
        *pings, cfg, mesh=mesh(4), dtype=torch.float64, window=WINDOW,
        local_capacity=CAPACITY)
    single, _ = pipeline.map_ping_sequence(
        *pings, cfg, device="cpu", backend="hash", dtype=torch.float64,
        window=WINDOW)
    j_st, _ = jax_map(4, "f64", WINDOW)
    paths = {name: str(tmp_path / f"{name}.npz")
             for name in ("sharded", "single", "jax")}
    save_map(paths["sharded"], st, cfg)
    save_map(paths["single"], single, cfg)
    j_save_map(paths["jax"], j_st, SMALL_CFG)
    snaps = {}
    for name, path in paths.items():
        with np.load(path) as z:
            snaps[name] = (by_key(z["keys"], z["log_odds"]),
                           z["min_bounds"], z["max_bounds"])
    (keys, lo), bmin, bmax = snaps["sharded"]
    assert lo.dtype == np.float64 and len(keys) == int(st.used.sum())
    for name in ("single", "jax"):
        (w_keys, w_lo), w_min, w_max = snaps[name]
        np.testing.assert_array_equal(keys, w_keys)
        np.testing.assert_allclose(lo, w_lo, rtol=0,
                                   atol=EXP_ULP_TOL[torch.float64])
        np.testing.assert_array_equal(bmin, w_min)
        np.testing.assert_array_equal(bmax, w_max)
    np.testing.assert_array_equal(lo, snaps["single"][0][1])
    restored = [load_map(paths["sharded"], device="cpu")[0],
                load_map_brick(paths["sharded"], device="cpu")[0],
                load_map_sharded_brick(paths["sharded"], mesh=mesh(2))[0]]
    for state, read in zip(restored, (touched_voxels_hash,
                                      touched_voxels_brick,
                                      gather_sharded_brick_state)):
        r_keys, r_lo = by_key(*read(state))
        np.testing.assert_array_equal(r_keys, keys)
        np.testing.assert_array_equal(r_lo, lo)


def test_no_card_no_mesh_and_mismatches_raise():
    """Without a card a mesh of None raises (no CPU fallback); a resumed
    map on another mesh or of another dtype is a ValueError."""
    pings = survey(2)
    cfg = port_cfg(SMALL_CFG)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            map_ping_sequence_sharded(*pings, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_sharded_hash_grid()
    st = init_sharded_hash_grid(mesh(2), CAPACITY, torch.float64)
    with pytest.raises(ValueError, match="not the state's"):
        map_ping_sequence_sharded(*pings, cfg, mesh=mesh(3), state=st,
                                  dtype=torch.float64)
    with pytest.raises(ValueError, match="not torch.float32"):
        map_ping_sequence_sharded(*pings, cfg, state=st)
    with pytest.raises(ValueError, match="power of two"):
        init_sharded_hash_grid(mesh(2), 100)
    empty, stats = map_ping_sequence_sharded(
        pings[0][:0], pings[1][:0], pings[2][:0], cfg, state=st,
        dtype=torch.float64)
    assert empty is st and all(len(v) == 0 for v in stats.values())
    assert set(stats) == set(shard.SHARDED_HASH_STAT_DTYPES)
