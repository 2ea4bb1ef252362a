"""The budgets of the port's sharded engines (``parallel/shard.py``,
``shard_brick.py``, ``shard_frames.py``) against the JAX package's on its
virtual CPU devices, and against the port's own count-sized runs.

Both packages take the same numpy-seeded pings (``test_torch_shard``'s
survey: 9 pings of 100x64, 5 m at 0.1 m voxels, windows of 4) in float64.
The port's mesh repeats the CPU: ``("cpu",) * 4``.  Tolerances: every
integer per-ping stat (the causes, ``*_max`` and ``xchg_n_max``
included), each scan's stats, each shard's voxel keys, and ``effective``
bit-equal to JAX's; log-odds within EXP_ULP_TOL (1e-12).  Within the
port, a budgeted run's map and every stat it shares with the count-sized
run are bit-equal to that run's.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.grid.brick import (  # noqa: E402
    touched_voxels_brick as j_touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu.grid.hash import (  # noqa: E402
    touched_voxels_hash as j_touched_voxels_hash,
)
from sonar_3d_reconstruction_tpu.parallel import shard as j_shard  # noqa: E402
from sonar_3d_reconstruction_tpu.parallel import (  # noqa: E402
    shard_brick as j_shard_brick,
)
from sonar_3d_reconstruction_tpu.parallel import (  # noqa: E402
    shard_frames as j_shard_frames,
)

from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu_torch.grid.hash import (  # noqa: E402
    EMPTY,
    touched_voxels_hash,
)
from sonar_3d_reconstruction_tpu_torch.parallel import (  # noqa: E402
    shard,
    shard_brick,
    shard_frames,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard import (  # noqa: E402
    StatReduce,
    commit_budgeted,
    init_sharded_hash_grid,
    map_ping_sequence_sharded,
    reduce_failed,
    reduce_stats,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (  # noqa: E402
    init_sharded_brick_grid,
    map_ping_sequence_sharded_brick,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard_frames import (  # noqa: E402
    default_xchg_budget,
    map_ping_sequence_sharded_frames,
)
from sonar_3d_reconstruction_tpu_torch.pipeline import (  # noqa: E402
    map_ping_sequence,
)

from test_torch_budgets import ReadCounter  # noqa: E402
from test_torch_shard import (  # noqa: E402
    SMALL_CFG,
    by_key,
    scattered_survey,
    survey,
)
from torch_parity import EXP_ULP_TOL, port_cfg  # noqa: E402

S = 4
WINDOW = 4
CAPACITY = 1 << 10      # bricks a shard (hash: slots / 4): grows at S = 4
BRICK_CAPACITY = 1 << 12  # bricks a shard that no survey run grows

# per engine: (the JAX run's growth budgets, the JAX map function and its
# factory of scans).  Each set overflows at least one budget of the
# engine, so the runs replay by cause.
GROWTH = {
    "frames": dict(xchg_budget=128, lane_budget=300, insert_budget=[256, 64]),
    "brick": dict(unique_budget=1024, brick_budget=256, insert_budget=64),
    "hash": dict(unique_budget=1024, batch_budget=1024,
                 insert_budget=[512, 128]),
    "hash-w1": dict(unique_budget=256),
}


def _frames(mesh, **kw):
    return map_ping_sequence_sharded_frames(*survey(), port_cfg(SMALL_CFG),
                                            mesh=mesh, **kw)


def _brick(mesh, **kw):
    return map_ping_sequence_sharded_brick(*survey(), port_cfg(SMALL_CFG),
                                           mesh=mesh, **kw)


def _hash(mesh, window=WINDOW, **kw):
    kw.setdefault("local_capacity", 4 * kw.pop("local_capacity", CAPACITY))
    return map_ping_sequence_sharded(*survey(), port_cfg(SMALL_CFG),
                                     mesh=mesh, window=window, **kw)


PORT = {
    "frames": _frames,
    "brick": _brick,
    "hash": _hash,
    "hash-w1": functools.partial(_hash, window=1),
}
# the module whose scan_windows each engine calls, and the JAX factory of
# its scans
SCAN_MODULE = {"frames": shard_frames, "brick": shard_brick, "hash": shard,
               "hash-w1": shard}
J_FACTORY = {
    "frames": (j_shard_frames, "make_window_scan_sharded_frames"),
    "brick": (j_shard_brick, "make_window_scan_sharded_brick"),
    "hash": (j_shard, "make_window_scan_sharded"),
    "hash-w1": (j_shard, "make_scan_pings_sharded"),
}


def _jax_map(engine, budgets, effective):
    images, positions, quats = survey()
    mesh = j_shard.make_mesh(jax.devices()[:S])
    kw = dict(mesh=mesh, dtype=jnp.float64, local_capacity=CAPACITY)
    if engine == "frames":
        return j_shard_frames.map_ping_sequence_sharded_frames(
            images, positions, quats, SMALL_CFG, window=WINDOW,
            effective=effective, **kw, **budgets)
    if engine == "brick":
        return j_shard_brick.map_ping_sequence_sharded_brick(
            images, positions, quats, SMALL_CFG, window=WINDOW,
            effective=effective, **kw, **budgets)
    kw["local_capacity"] *= 4
    return j_shard.map_ping_sequence_sharded(
        images, positions, quats, SMALL_CFG,
        window=1 if engine == "hash-w1" else WINDOW, **kw, **budgets)


@functools.lru_cache(maxsize=None)
def jax_growth(engine):
    """JAX's map of the survey under ``GROWTH[engine]``: (each shard's
    sorted (keys, log-odds), per-ping stats, every scan's stats,
    ``effective`` without its box bits)."""
    module, name = J_FACTORY[engine]
    factory, scans, effective = getattr(module, name), [], {}

    def recording(*args, **kw):
        scan = factory(*args, **kw)

        def wrapped(*s_args, **s_kw):
            st, stats = scan(*s_args, **s_kw)
            scans.append({k: np.asarray(v) for k, v in stats.items()})
            return st, stats
        return wrapped

    budgets = {k: tuple(v) if isinstance(v, list) else v
               for k, v in GROWTH[engine].items()}
    setattr(module, name, recording)
    try:
        st, stats = _jax_map(engine, budgets, effective)
    finally:
        setattr(module, name, factory)
    effective.pop("box_min_bits", None)
    if engine.startswith("hash"):
        shards = [by_key(*j_touched_voxels_hash(j_shard_hash_local(st, s)))
                  for s in range(S)]
    else:
        shards = [by_key(*j_touched_voxels_brick(x))
                  for x in j_shard_brick.local_brick_states(st)]
    return (shards, {k: np.asarray(v) for k, v in stats.items()}, scans,
            effective)


def j_shard_hash_local(state, s):
    """Shard ``s`` of a JAX sharded hash map as a plain HashGridState."""
    from sonar_3d_reconstruction_tpu.grid.hash import HashGridState

    return HashGridState(
        key_rows=state.key_rows[s], log_odds=state.log_odds[s],
        min_bounds=state.min_bounds[s], max_bounds=state.max_bounds[s],
        used=state.used[s], poisoned=state.poisoned[s])


def port_shards(state):
    touched = (touched_voxels_hash if isinstance(state, shard.ShardedHashState)
               else touched_voxels_brick)
    return [by_key(*touched(s)) for s in state.shards]


def port_with_scans(engine, monkeypatch, **kw):
    """The port's run of ``engine`` with its scans' stats: (state, stats,
    every scan's stats)."""
    module, scans = SCAN_MODULE[engine], []
    scan_windows = module.scan_windows

    def recording(*args, **s_kw):
        st, stats = scan_windows(*args, **s_kw)
        scans.append(stats)
        return st, stats

    monkeypatch.setattr(module, "scan_windows", recording)
    st, stats = PORT[engine](("cpu",) * S, **kw)
    monkeypatch.setattr(module, "scan_windows", scan_windows)
    return st, stats, scans


def assert_stats_equal(got, want, what=""):
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      f"{what} {k}")


def assert_same_state(a, b):
    for x, y in zip(a.shards, b.shards):
        for k in x._fields:
            assert torch.equal(getattr(x, k), getattr(y, k)), k


# ---------------------------------------------------------------------------
# each engine against the JAX engine, under budgets that grow
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", list(GROWTH))
def test_budgeted_engine_matches_jax(engine, monkeypatch):
    """Each engine under GROWTH's budgets: every scan's per-ping stats
    (causes, window sizes and maxima) equal JAX's scan for scan, then the
    merged stats, each shard's voxels and ``effective`` (the brick
    engines; JAX's hash engine reports none)."""
    j_shards, j_stats, j_scans, j_eff = jax_growth(engine)
    effective = {}
    kw = dict(local_capacity=CAPACITY, dtype=torch.float64,
              **GROWTH[engine])
    if engine in ("frames", "brick"):
        kw.update(window=WINDOW, effective=effective)
    st, stats, scans = port_with_scans(engine, monkeypatch, **kw)
    assert len(scans) == len(j_scans) >= 2
    for i, (got, want) in enumerate(zip(scans, j_scans)):
        assert_stats_equal(got, want, f"scan {i}")
    assert_stats_equal(stats, j_stats, "merged")
    assert not stats["overflowed"].any()
    for (keys, lo), (w_keys, w_lo) in zip(port_shards(st), j_shards):
        assert len(keys) > 0
        np.testing.assert_array_equal(keys, w_keys)
        np.testing.assert_allclose(lo, w_lo, rtol=0,
                                   atol=EXP_ULP_TOL[torch.float64])
    if engine in ("frames", "brick"):
        got = {k: tuple(v) if isinstance(v, list) else v
               for k, v in effective.items()}
        assert got == j_eff


def test_budgeted_raw_frames_match_jax_dedup_run(monkeypatch):
    """The frame-parallel engine in ``"pallas-raw"`` under GROWTH's
    budgets: JAX's (dedup-mode) scans, stats and voxels, as the raw
    mode's are the dedup mode's."""
    j_shards, j_stats, j_scans, _ = jax_growth("frames")
    st, stats, scans = port_with_scans(
        "frames", monkeypatch, local_capacity=CAPACITY, dtype=torch.float64,
        window=WINDOW, dense_mode="pallas-raw", **GROWTH["frames"])
    assert len(scans) == len(j_scans)
    for got, want in zip(scans, j_scans):
        assert_stats_equal(got, want)
    assert_stats_equal(stats, j_stats)
    for (keys, lo), (w_keys, w_lo) in zip(port_shards(st), j_shards):
        np.testing.assert_array_equal(keys, w_keys)
        np.testing.assert_allclose(lo, w_lo, rtol=0,
                                   atol=EXP_ULP_TOL[torch.float64])


# ---------------------------------------------------------------------------
# budgeted == count-sized, bit for bit
# ---------------------------------------------------------------------------


def _fold(backend, **kw):
    from sonar_3d_reconstruction_tpu_torch.parallel.multihost import (
        map_ping_sequence_multihost,
    )

    st, stats = map_ping_sequence_multihost(
        *survey(), port_cfg(SMALL_CFG), n_hosts=3, window=WINDOW,
        backend=backend, dtype=torch.float64, device="cpu",
        initial_capacity=1 << 12, **kw)
    return st, {k: np.asarray([s[k] for s in stats]) for k in stats[0]}


SNUG = {
    # per-shard budgets around the survey's needs (no growth)
    "frames box": (lambda **kw: _frames(("cpu",) * S, window=WINDOW, **kw),
                   dict(unique_budget=2048, xchg_budget=512,
                        brick_budget=512, lane_budget=2048,
                        insert_budget=[512, 256])),
    "frames raw": (lambda **kw: _frames(("cpu",) * S, window=WINDOW,
                                        dense_mode="pallas-raw", **kw),
                   dict(unique_budget=2048, xchg_budget=512)),
    "frames wide": (lambda **kw: map_ping_sequence_sharded_frames(
        *scattered_survey(), port_cfg(SMALL_CFG), mesh=("cpu",) * S,
        window=WINDOW, **kw), dict(unique_budget=2048, brick_budget=512)),
    "brick": (lambda **kw: _brick(("cpu",) * S, window=WINDOW, **kw),
              dict(unique_budget=2048, brick_budget=512, lane_budget=2048)),
    "hash": (lambda **kw: _hash(("cpu",) * S, **kw),
             dict(unique_budget=2048, batch_budget=2048,
                  insert_budget=[2048, 1536])),
    "hash-w1": (lambda **kw: _hash(("cpu",) * S, window=1, **kw),
                dict(unique_budget=1024)),
    "fold brick": (lambda **kw: _fold("brick", **kw),
                   dict(unique_budget=2048, batch_budget=2048)),
    "fold hash": (lambda **kw: _fold("hash", **kw),
                  dict(unique_budget=2048, batch_budget=8192)),
}


@pytest.mark.parametrize("case", list(SNUG))
def test_budgeted_equals_count_sized(case):
    """A budgeted run (no growth) gives the count-sized run's map, every
    array bit for bit, and every per-ping stat the two share; the frame
    engine's ``xchg_n_max`` is the window's largest block."""
    run, budgets = SNUG[case]
    kw = {} if case.startswith("fold") else dict(
        local_capacity=BRICK_CAPACITY, dtype=torch.float64)
    want, w_stats = run(**kw)
    got, stats = run(**kw, **budgets)
    assert not stats["overflowed"].any()
    if case.startswith("fold"):
        for k in want._fields:
            assert torch.equal(getattr(got, k), getattr(want, k)), k
    else:
        assert_same_state(got, want)
    shared = [k for k in w_stats if k in stats and k != "xchg_n_max"]
    assert len(shared) >= 4
    for k in shared:
        np.testing.assert_array_equal(stats[k], w_stats[k], k)
    if "xchg_n_max" in stats:
        per_window = np.maximum.reduceat(w_stats["xchg_n_max"],
                                         np.arange(0, 9, WINDOW))
        np.testing.assert_array_equal(
            stats["xchg_n_max"], np.repeat(per_window, [4, 4, 1]))


# ---------------------------------------------------------------------------
# the JAX package's budget tests, ported
# ---------------------------------------------------------------------------


def test_window_engine_snug_budgets_and_undersized_insert_budget():
    """JAX's test_sharded_window_engine_snug_budgets: snug lane / insert
    budgets from the run's own counts give the count-sized map; an insert
    budget of 0 rejects the window on EVERY shard (all ``overflowed``,
    ``insert_overflow`` named, every shard poisoned, no key written)."""
    from sonar_3d_reconstruction_tpu_torch.geometry import (
        batched_sonar_to_world,
    )
    from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
        build_fan_tables,
    )

    cfg = port_cfg(SMALL_CFG)
    images, positions, quats = survey(6, seed=300)
    T = batched_sonar_to_world(positions, quats, cfg)
    tables = build_fan_tables(cfg, 100, 64)

    def run(**kw):
        # a shard's records fit 1024 lanes a frame: narrow table ops
        st = init_sharded_hash_grid(("cpu",) * S, 1 << 13, torch.float64)
        return shard.window_scan_sharded(
            st, images, T, None, tables, cfg, torch.float64, window=3,
            unique_budget=1024, **kw)

    st0, stats0 = run()
    assert not stats0["overflowed"].any()
    need = int(stats0["batch_n_need"].max())
    lanes = int((stats0["num_occupied"] + stats0["num_free"])
                .reshape(-1, 3).sum(axis=1).max())
    st1, stats1 = run(lane_budget=lanes + 8, insert_budget=need + 8)
    assert not stats1["overflowed"].any()
    assert_same_state(st1, st0)
    st2, stats2 = run(insert_budget=0)
    assert stats2["overflowed"].all() and stats2["insert_overflow"].any()
    assert st2.poisoned.all()
    assert (st2.keys == EMPTY).all()


def test_xchg_budget_growth_then_snug_budget():
    """JAX's test_sharded_frames_xchg_budget_growth: an exchange budget of
    8 overflows, grows and replays to the single-card map; the reported
    ``xchg_n_max`` then sizes a budget that runs without growth."""
    images, positions, quats = survey(8, seed=960)
    cfg = port_cfg(SMALL_CFG)
    single, _ = map_ping_sequence(images, positions, quats, cfg,
                                  device="cpu", dtype=torch.float64,
                                  window=4)
    want = by_key(*touched_voxels_brick(single))

    def run(xchg):
        eff = {}
        st, stats = map_ping_sequence_sharded_frames(
            images, positions, quats, cfg, mesh=("cpu",) * S,
            dtype=torch.float64, window=4, local_capacity=1 << 10,
            xchg_budget=xchg, effective=eff)
        return st, stats, eff

    st, stats, eff = run(8)
    need = int(stats["xchg_n_max"].max())
    assert need > 8 and eff["xchg_budget"] >= need
    st2, stats2, eff2 = run(need)
    assert not stats2["xchg_overflow"].any()
    assert eff2["xchg_budget"] == need
    for state in (st, st2):
        got = by_key(*shard_brick.gather_sharded_brick_state(state))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("unique_budget,n_shards",
                         [(96000, 8), (512, 8), (94208, 4), (4096, 2)])
def test_default_xchg_budget_matches_jax(unique_budget, n_shards):
    """JAX's test_default_xchg_budget_scales_inversely_with_shards: the
    port's default is JAX's (at least twice a shard's share, at least
    1024, a multiple of 128)."""
    got = default_xchg_budget(unique_budget, n_shards)
    assert got == j_shard_frames.default_xchg_budget(unique_budget, n_shards)
    assert got >= max(1024, 2 * unique_budget // n_shards) and got % 128 == 0


# ---------------------------------------------------------------------------
# the device-side commit and reduce
# ---------------------------------------------------------------------------


def test_commit_is_all_or_nothing_across_shards():
    """One shard's failure flag rejects the step on every shard: each
    shard's table stays as it was, poisoned, and its stats read the
    failure; with no flag set every shard writes."""
    from sonar_3d_reconstruction_tpu_torch.grid.hash import (
        prepare_frame_budgeted,
    )
    from sonar_3d_reconstruction_tpu_torch.ops.dedup import UniqueRecords
    from sonar_3d_reconstruction_tpu_torch.ops.packing import pack_keys
    from sonar_3d_reconstruction_tpu_torch.ops.records import FrameAux

    cfg = port_cfg(SMALL_CFG)
    state = init_sharded_hash_grid(("cpu",) * S, 1 << 10, torch.float64)
    rng = np.random.default_rng(7)

    def pending(shard_state, bad):
        keys = torch.as_tensor(rng.integers(-50, 50, size=(16, 3)),
                               dtype=torch.int32)
        hi, lo, _ = pack_keys(keys)
        rec = UniqueRecords(hi, lo, torch.ones(16, dtype=torch.int64),
                            torch.ones(16, dtype=torch.int64),
                            torch.tensor(17 if bad else 16))
        aux = FrameAux(torch.zeros(3, dtype=torch.float64),
                       torch.ones(3, dtype=torch.float64),
                       torch.tensor(False), torch.tensor(16))
        return prepare_frame_budgeted(shard_state, rec, aux, cfg)

    for bad_shard in (None, 2):
        pendings = [pending(s, i == bad_shard)
                    for i, s in enumerate(state.shards)]
        new, wins = commit_budgeted(state, pendings)
        failed = bad_shard is not None
        assert bool(new.poisoned.all()) == failed
        for old, got, win in zip(state.shards, new.shards, wins):
            assert bool(win["overflowed"]) == failed
            assert torch.equal(got.key_rows, old.key_rows) == failed
            assert int(win["num_occupied"]) == (0 if failed else 16)
    cpu = torch.device("cpu")
    assert reduce_failed([torch.tensor(False), torch.tensor(True)],
                         (cpu, cpu))[cpu].item()


def test_reduce_stats_sums_maxima_and_flags():
    """The stats reduce over shards: sums, per-shard maxima as ``_max``,
    or-ed flags and shard 0's copy, as the JAX engines' psum / pmax."""
    per = [{"a": torch.tensor([1, 2]), "f": torch.tensor([False, True]),
            "range_fail": torch.tensor([False, False])},
           {"a": torch.tensor([5, 0]), "f": torch.tensor([False, False]),
            "range_fail": torch.tensor([False, False])}]
    out = reduce_stats(per, torch.device("cpu"),
                       StatReduce(sums=("a",), maxima=("a",), ors=("f",),
                                  first=("range_fail",)))
    assert out["a"].tolist() == [6, 2] and out["a_max"].tolist() == [5, 2]
    assert out["f"].tolist() == [0, 1] and out["range_fail"].tolist() == [0, 0]


# ---------------------------------------------------------------------------
# host reads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["frames box", "frames wide", "brick",
                                  "hash", "hash-w1"])
def test_budgeted_scan_reads_once(case, monkeypatch):
    """A budgeted run that needs no growth reads one value set to the host
    in all (its stats, once a scan): nothing a window, a shard or a
    commit; the count-sized run reads at every window."""
    run, budgets = SNUG[case]
    kw = dict(local_capacity=BRICK_CAPACITY, dtype=torch.float64)
    counter = ReadCounter(monkeypatch)
    _, stats = run(**kw, **budgets)
    assert counter.n == 1 and not stats["overflowed"].any()
    counter.n = 0
    run(**kw)
    assert counter.n >= 3
    monkeypatch.undo()


def test_budgeted_growth_reads_once_a_scan_and_a_growth(monkeypatch):
    """The frame engine under GROWTH's budgets from a small table: one
    read a scan plus one a table growth, however many windows and
    shards."""
    scans, grows = [0], [0]
    scan_windows = shard_frames.scan_windows
    rehash = shard_brick.rehash_sharded_bricks

    def counting_scan(*args, **kw):
        scans[0] += 1
        return scan_windows(*args, **kw)

    def counting_grow(*args, **kw):
        grows[0] += 1
        return rehash(*args, **kw)

    monkeypatch.setattr(shard_frames, "scan_windows", counting_scan)
    monkeypatch.setattr(shard_brick, "rehash_sharded_bricks", counting_grow)
    counter = ReadCounter(monkeypatch)
    _, stats = _frames(("cpu",) * S, window=WINDOW, local_capacity=128,
                       dtype=torch.float64, **GROWTH["frames"])
    assert grows[0] >= 1 and scans[0] >= 3
    assert counter.n <= scans[0] + grows[0]
    assert not stats["overflowed"].any()


def test_budgeted_fold_reads_once(monkeypatch):
    """A fold of fixed-width segments reads its stats once."""
    from sonar_3d_reconstruction_tpu_torch.grid.brick import init_brick_grid
    from sonar_3d_reconstruction_tpu_torch.parallel.multihost import (
        apply_record_segments,
        records_for_segment,
    )

    images, positions, quats = survey()
    cfg = port_cfg(SMALL_CFG)
    segments = [records_for_segment(images[a:b], positions[a:b],
                                    quats[a:b], cfg, dtype=torch.float64,
                                    brick_bits=2, device="cpu",
                                    unique_budget=2048)
                for a, b in ((0, 5), (5, 9))]
    state = init_brick_grid(1 << 12, torch.float64, "cpu")
    counter = ReadCounter(monkeypatch)
    _, stats = apply_record_segments(state, segments, cfg, window=WINDOW)
    assert counter.n == 1 and len(stats) == 9
    assert not any(s["overflowed"] for s in stats)


def test_commit_false_needs_a_budget():
    """A count-sized window commits as it goes: ``commit=False`` without a
    budget is refused (ValueError), on both maps."""
    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        apply_brick_records_wide,
    )
    from sonar_3d_reconstruction_tpu_torch.grid.hash import (
        apply_records_batched,
    )

    brick = init_sharded_brick_grid(("cpu",), 128, torch.float64).shards[0]
    table = init_sharded_hash_grid(("cpu",), 128, torch.float64).shards[0]
    with pytest.raises(ValueError, match="commit=False"):
        apply_brick_records_wide(brick, _empty_records(), None, None,
                                 commit=False)
    with pytest.raises(ValueError, match="commit=False"):
        apply_records_batched(table, _empty_records(), None, None,
                              commit=False)


def _empty_records():
    from sonar_3d_reconstruction_tpu_torch.ops.dedup import UniqueRecords

    z = torch.zeros((1, 1), dtype=torch.int64)
    return UniqueRecords(z, z, z, z, torch.zeros(1, dtype=torch.int64))
