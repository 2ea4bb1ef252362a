"""The port's fixed-width (budgeted) windows against its count-sized ones
and the JAX package's: the budgeted dedups, ``plan_insert(budget=)``,
``resolve_capped_tables`` caps, ``scan_pings_brick`` / ``scan_pings_hash``
with budgets through ``map_ping_sequence(budgets=)`` (tuned, stale, every
``dense_mode`` spelling), the host reads of a budgeted scan, and the
plain K1 / K1-raw on a padded window.

Survey: ``tests/test_autotune.py``'s small setup (64x48 images, 10 pings,
window 4, float64).  Tolerances: records, counts, keys, flags and stats
are equal; log-odds of the port are bit-equal between its runs and within
EXP_ULP_TOL (tests/torch_parity.py) of the JAX package's.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu.grid import hash as j_hash  # noqa: E402
from sonar_3d_reconstruction_tpu.grid.brick import (  # noqa: E402
    init_brick_grid as j_init_brick_grid,
)
from sonar_3d_reconstruction_tpu.ops import backproject as j_bp  # noqa: E402
from sonar_3d_reconstruction_tpu.ops import dedup as j_dedup  # noqa: E402
from sonar_3d_reconstruction_tpu.ops.packing import (  # noqa: E402
    compute_window_boxes as j_compute_window_boxes,
)
from sonar_3d_reconstruction_tpu.pipeline import (  # noqa: E402
    batched_sonar_to_world as j_batched_sonar_to_world,
    map_ping_sequence as j_map_ping_sequence,
    scan_pings_brick as j_scan_pings_brick,
    scan_pings_hash as j_scan_pings_hash,
)
from sonar_3d_reconstruction_tpu.utils import autotune as j_autotune  # noqa: E402

from sonar_3d_reconstruction_tpu_torch import pipeline  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid import brick  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid import hash as t_hash  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.kernels.bin_apply import (  # noqa: E402
    bin_apply,
    bin_apply_raw,
)
from sonar_3d_reconstruction_tpu_torch.ops import backproject as bp  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.ops import dedup  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.ops.packing import (  # noqa: E402
    EMPTY32,
    compute_window_boxes,
)

from test_autotune import _survey  # noqa: E402
from torch_parity import EXP_ULP_TOL, port_cfg  # noqa: E402

CFG = MapperConfig(
    image_height=64, image_width=48, max_range=5.0, min_range=0.5,
    voxel_resolution=0.1, intensity_threshold=50,
)
WINDOW = 4
CAUSES = ("overflowed", "unique_overflow", "batch_overflow",
          "insert_overflow")
BRICK_FIELDS = ("key_rows", "log_odds", "touched", "min_bounds",
                "max_bounds", "used", "poisoned")
HASH_FIELDS = ("key_rows", "log_odds", "min_bounds", "max_bounds", "used",
               "poisoned")
# JAX raw mode runs the Pallas kernel in interpret mode on the CPU
JAX_MODE = {"pallas": "bfv", "pallas-raw": "pallas-raw"}


@functools.lru_cache(maxsize=None)
def survey():
    return _survey(CFG)


@functools.lru_cache(maxsize=None)
def jax_plan(backend):
    return j_autotune.tune_sequence(*survey(), CFG, backend=backend,
                                    window=WINDOW, dtype=jnp.float64)


def fields_of(backend):
    return BRICK_FIELDS if backend == "brick" else HASH_FIELDS


def to_numpy(state, backend):
    return (brick.brick_state_to_numpy if backend == "brick"
            else t_hash.hash_state_to_numpy)(state)


def frozen(plan):
    """A plan as a hashable tuple of its items (lists as tuples)."""
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in plan.items()))


@functools.lru_cache(maxsize=None)
def jax_run(backend, plan_items, mode="bfv"):
    """The JAX package's map with a plan (``frozen``)."""
    plan = dict(plan_items, dense_mode=mode)
    st, stats = j_map_ping_sequence(
        *survey(), CFG, backend=backend, window=WINDOW, dtype=jnp.float64,
        budgets=plan,
    )
    return ({k: np.asarray(getattr(st, k)) for k in fields_of(backend)},
            {k: np.asarray(v) for k, v in stats.items()})


def port_run(backend, budgets=None, **kw):
    return pipeline.map_ping_sequence(
        *survey(), port_cfg(CFG), device="cpu", backend=backend,
        window=WINDOW, dtype=torch.float64, budgets=budgets, **kw,
    )


def assert_matches_jax(got, want):
    for k, v in want.items():
        if k == "log_odds":
            np.testing.assert_allclose(got[k], v, rtol=0,
                                       atol=EXP_ULP_TOL[torch.float64])
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def assert_same_state(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# budgeted dedups and inserts
# ---------------------------------------------------------------------------

# (unique budget, lane budget): fits, a unique overflow, a slice overflow,
# a budget wider than the lattice
DEDUP_CASES = [(512, 0), (64, 0), (512, 300), (4096, 0)]


def _candidates(seed, n=2048):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 400, n).astype(np.uint32)
    occ = rng.random(n) < 0.3
    valid = rng.random(n) < 0.8
    return key, occ, valid


@pytest.mark.parametrize("unique_budget,lane_budget", DEDUP_CASES)
def test_budgeted_compact_dedup_matches_jax(unique_budget, lane_budget):
    """Records of U lanes, n_unique (N + 1 on a slice overflow), the
    overflow flag and pack_fail equal the JAX package's, lane for lane."""
    for seed in range(3):
        key, occ, valid = _candidates(seed)
        want = j_dedup.dedup_frame_compact(
            jnp.asarray(key), jnp.asarray(occ), jnp.asarray(valid),
            unique_budget, lane_budget)
        got = dedup.dedup_frame_compact(
            torch.as_tensor(key.astype(np.int64)), torch.as_tensor(occ),
            torch.as_tensor(valid), unique_budget, lane_budget)
        assert got.key.shape == (unique_budget,)
        assert int(got.n_unique) == int(want.n_unique)
        assert bool(got.overflowed) == bool(want.overflowed)
        np.testing.assert_array_equal(got.key.numpy(), np.asarray(want.key))
        live = np.asarray(want.key) != EMPTY32
        np.testing.assert_array_equal(got.payload.numpy()[live],
                                      np.asarray(want.payload)[live])


@pytest.mark.parametrize("unique_budget,lane_budget", DEDUP_CASES)
def test_budgeted_two_word_dedup_matches_jax(unique_budget, lane_budget):
    from sonar_3d_reconstruction_tpu.ops.packing import pack_keys as j_pack
    from sonar_3d_reconstruction_tpu_torch.ops.packing import pack_keys

    rng = np.random.default_rng(5)
    keys = rng.integers(-6, 6, (2048, 3)).astype(np.int32)
    occ = rng.random(2048) < 0.3
    valid = rng.random(2048) < 0.8
    hi, lo, _ = j_pack(jnp.asarray(keys))
    want = j_dedup.dedup_frame(hi, lo, jnp.asarray(occ), jnp.asarray(valid),
                               unique_budget, lane_budget)
    t_hi, t_lo, _ = pack_keys(torch.as_tensor(keys))
    got = dedup.dedup_frame(t_hi, t_lo, torch.as_tensor(occ),
                            torch.as_tensor(valid), False, unique_budget,
                            lane_budget)
    assert int(got.n_unique) == int(want.n_unique)
    assert bool(got.overflowed) == bool(want.overflowed)
    # every lane's code, the slice's extra codes of an overflowed frame too
    for k in ("hi", "lo"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)
    records = min(int(want.n_unique), unique_budget)
    if not bool(want.overflowed):
        for k in ("count", "n_occ"):
            np.testing.assert_array_equal(
                getattr(got, k).numpy()[:records],
                np.asarray(getattr(want, k))[:records], k)


def test_budgeted_dedup_without_overflow_is_the_count_sized_prefix():
    """A budget that fits gives the unbudgeted records cut to U lanes, for
    every form, grouped ones too."""
    key, occ, valid = _candidates(9)
    k, o, v = (torch.as_tensor(key.astype(np.int64)), torch.as_tensor(occ),
               torch.as_tensor(valid))
    full = dedup.dedup_frame_compact(k, o, v)
    cut = dedup.dedup_frame_compact(k, o, v, 512, 2048)
    assert not bool(cut.overflowed)
    for a, b in zip(full[:2], cut[:2]):
        assert torch.equal(a[:512], b)
    group = k % 3
    g_full, g_rg = dedup.dedup_frame_compact_grouped(k, o, v, group, 3, 9)
    g_cut, g_rg_cut = dedup.dedup_frame_compact_grouped(k, o, v, group, 3, 9,
                                                        512, 2048)
    assert torch.equal(g_full.key[:512], g_cut.key)
    assert torch.equal(g_rg[:512], g_rg_cut)
    hi, lo = k >> 5, k & 31
    w_full, w_rg = dedup.dedup_frame_grouped(hi, lo, o, v, group, 3, False)
    w_cut, w_rg_cut = dedup.dedup_frame_grouped(hi, lo, o, v, group, 3, False,
                                                512, 2048)
    assert torch.equal(w_full.hi[:512], w_cut.hi)
    assert torch.equal(w_rg[:512], w_rg_cut)


@pytest.mark.parametrize("budget", [None, 64, 200])
def test_plan_insert_budget_matches_jax(budget):
    """n_need, budget_overflow, overflowed and the record-order slots of a
    budgeted insert plan, and the table an aborted commit leaves."""
    rng = np.random.default_rng(3)
    n = 300
    hi = rng.integers(0, 1 << 20, n).astype(np.uint32)
    lo = rng.integers(0, 1 << 30, n).astype(np.uint32)
    need = rng.random(n) < 0.5
    j_rows = j_hash.empty_key_rows(1024)
    bucket, _, _, fill = j_hash.bucket_lookup(j_rows, jnp.asarray(hi),
                                              jnp.asarray(lo))
    want = j_hash.plan_insert(j_rows, jnp.asarray(hi), jnp.asarray(lo),
                              jnp.asarray(need), bucket, fill, budget=budget)
    t_rows = t_hash.empty_key_rows(1024, "cpu")
    th, tl = torch.as_tensor(hi.astype(np.int64)), torch.as_tensor(
        lo.astype(np.int64))
    t_bucket, _, _, t_fill = t_hash.bucket_lookup(t_rows, th, tl)
    got = t_hash.plan_insert(t_rows, th, tl, torch.as_tensor(need), t_bucket,
                             t_fill, budget=budget)
    for k in ("n_need", "budget_overflow", "overflowed"):
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    np.testing.assert_array_equal(got.slots.numpy(), np.asarray(want.slots))
    aborted = t_hash.commit_insert(t_rows, got, abort=torch.tensor(True))
    assert torch.equal(aborted, t_rows)
    committed = t_hash.commit_insert(t_rows, got, abort=torch.tensor(False))
    np.testing.assert_array_equal(
        committed.numpy(), np.asarray(j_hash.commit_insert(j_rows, want)))


@pytest.mark.parametrize("caps", [("auto", "auto", "auto"), (3, 5, 20),
                                  (None, 0, None), ("auto", None, 12)])
def test_resolve_capped_tables_caps_match_jax(caps):
    images = survey()[0]
    got = bp.resolve_capped_tables(images, port_cfg(CFG), 64, 48, *caps)
    want = j_bp.resolve_capped_tables(images, CFG, 64, 48, *caps)
    assert (got.nvo_cap, got.win_cap, got.free_cap) == (
        want.nvo_cap, want.win_cap, want.free_cap)
    assert got.candidates_per_ping(CFG.occupied_window) == \
        want.candidates_per_ping(CFG.occupied_window)


# ---------------------------------------------------------------------------
# tuned runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,mode", [("brick", "pallas"),
                                          ("brick", "pallas-raw"),
                                          ("hash", "pallas")])
def test_tuned_run_is_bit_equal(backend, mode):
    """With the JAX plan the port's map and every per-ping stat equal its
    run without a plan at the plan's capacity, bit for bit; and the JAX
    run with the same plan, every one of its stats (the overflow keys and
    batch_n_need included)."""
    plan = jax_plan(backend)
    kw = {"dense_mode": mode} if backend == "brick" else {}
    plain_st, plain = port_run(backend, initial_capacity=plan["capacity"],
                               **kw)
    st, stats = port_run(backend, dict(plan), **kw)
    assert_same_state(st, plain_st)
    for k in set(plain) & set(stats):
        np.testing.assert_array_equal(stats[k], plain[k], err_msg=k)
    want_st, want = jax_run(backend, frozen(plan),
                            JAX_MODE[mode])
    assert set(stats) == set(want)
    for k in want:
        np.testing.assert_array_equal(stats[k], want[k], err_msg=k)
    assert_matches_jax(to_numpy(st, backend), want_st)
    assert not stats["overflowed"].any()
    assert (stats["batch_n_need"] > 0).any()


def _stale(plan, which):
    """The plan with budgets cut to a quarter: every one, or the
    apply-side ones only (bricks / batch, lanes, inserts)."""
    out = dict(plan)
    for k, v in plan.items():
        if not k.endswith("budget") or k.startswith("safe") or v is None:
            continue
        if which == "apply" and k in ("unique_budget", "dedup_lane_budget"):
            continue
        out[k] = ([max(1, x // 4) for x in v] if isinstance(v, list)
                  else max(1, v // 4))
    return out


def _one_scan(backend, budgets, jax_side):
    """One scan of the survey at ``budgets`` from a fresh map of the
    plan's capacity, in either package: its per-ping stats."""
    images, positions, quats = survey()
    T = j_batched_sonar_to_world(positions, quats, CFG)
    extras = {k: budgets.get(k) for k in ("unique_budget", "lane_budget",
                                          "insert_budget")}
    extras["dedup_lane_budget"] = budgets["dedup_lane_budget"]
    if backend == "brick":
        extras.update(brick_budget=budgets["brick_budget"],
                      vox_budget=budgets["vox_budget"])
    else:
        extras["batch_budget"] = budgets["batch_budget"]
    cap = budgets["capacity"]
    if jax_side:
        tables = j_bp.resolve_capped_tables(images, CFG, 64, 48)
        kw = dict(tables=tables, cfg=CFG, dtype=jnp.float64, window=WINDOW,
                  **extras)
        if backend == "brick":
            boxes = j_compute_window_boxes(
                T[:, :3, 3], CFG.max_range, CFG.voxel_resolution, WINDOW, 2,
                frame_bits=2)
            _, stats = j_scan_pings_brick(
                j_init_brick_grid(cap, jnp.float64), jnp.asarray(images),
                jnp.asarray(T), boxes=boxes, dense_mode="bfv", **kw)
        else:
            _, stats = j_scan_pings_hash(
                j_hash.init_hash_grid(cap, jnp.float64), jnp.asarray(images),
                jnp.asarray(T), **kw)
        return {k: np.asarray(v) for k, v in stats.items()}
    cfg = port_cfg(CFG)
    kw = dict(tables=bp.resolve_capped_tables(images, cfg, 64, 48), cfg=cfg,
              dtype=torch.float64, window=WINDOW, **extras)
    args = (torch.as_tensor(images), torch.as_tensor(T))
    if backend == "brick":
        boxes = compute_window_boxes(T[:, :3, 3], cfg.max_range,
                                     cfg.voxel_resolution, WINDOW, 2,
                                     frame_bits=2)
        return pipeline.scan_pings_brick(
            brick.init_brick_grid(cap, torch.float64, "cpu"), *args,
            boxes=boxes, **kw)[1]
    return pipeline.scan_pings_hash(
        t_hash.init_hash_grid(cap, torch.float64, "cpu"), *args, **kw)[1]


@pytest.mark.parametrize("which", ["every", "apply"])
@pytest.mark.parametrize("backend", ["brick", "hash"])
def test_stale_plan_replays_with_jax_causes(backend, which):
    """A plan with its budgets cut to a quarter: one scan reports the
    JAX package's overflow causes frame for frame, and map_ping_sequence
    replays to the map (and stats) of the run without a plan, and of the
    JAX run with the same stale plan."""
    stale = _stale(jax_plan(backend), which)
    got = _one_scan(backend, stale, jax_side=False)
    want = _one_scan(backend, stale, jax_side=True)
    for k in CAUSES:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["overflowed"].any()
    st, stats = port_run(backend, stale)
    plain_st, plain = port_run(backend, initial_capacity=stale["capacity"])
    assert_same_state(st, plain_st)
    for k in set(plain) & set(stats):
        np.testing.assert_array_equal(stats[k], plain[k], err_msg=k)
    want_st, want_stats = jax_run(backend, frozen(stale))
    for k in want_stats:
        np.testing.assert_array_equal(stats[k], want_stats[k], err_msg=k)
    assert_matches_jax(to_numpy(st, backend), want_st)


@pytest.mark.parametrize("backend", ["brick", "hash"])
def test_effective_reports_what_jax_reports(backend):
    effective, j_effective = {}, {}
    port_run(backend, {}, effective=effective)
    j_map_ping_sequence(*survey(), CFG, backend=backend, window=WINDOW,
                        dtype=jnp.float64, effective=j_effective)
    assert effective == j_effective


def test_plan_for_another_backend_or_window_is_refused():
    plan = jax_plan("brick")
    with pytest.raises(ValueError, match="backend"):
        port_run("hash", plan)
    with pytest.raises(ValueError, match="window"):
        pipeline.map_ping_sequence(
            *survey(), port_cfg(CFG), device="cpu", window=2, budgets=plan)
    with pytest.raises(ValueError, match="dense"):
        pipeline.map_ping_sequence(
            *survey(), port_cfg(CFG), device="cpu", backend="dense",
            budgets={})


@pytest.mark.parametrize("records_batch,window_group", [(2, 1), (4, 2),
                                                         (1, 3)])
def test_budgets_compose_with_batched_records(records_batch, window_group):
    plan = dict(jax_plan("brick"))
    plain_st, plain = port_run("brick", initial_capacity=plan["capacity"])
    st, stats = port_run("brick", plan, records_batch=records_batch,
                         window_group=window_group)
    assert_same_state(st, plain_st)
    for k in plain:
        np.testing.assert_array_equal(stats[k], plain[k], err_msg=k)


def test_wide_window_with_budgets_matches_jax():
    """A survey too wide for box keys (60 m range) takes two-word brick
    codes: the tuned map equals the untuned one and the JAX tuned map."""
    cfg = MapperConfig(image_height=64, image_width=48, max_range=60.0,
                       min_range=0.5, voxel_resolution=0.1,
                       intensity_threshold=50)
    images, positions, quats = _survey(cfg, n=5)
    plan = j_autotune.tune_sequence(images, positions, quats, cfg,
                                    backend="brick", window=2,
                                    dtype=jnp.float64)
    kw = dict(device="cpu", window=2, dtype=torch.float64)
    t_cfg = port_cfg(cfg)
    plain_st, plain = pipeline.map_ping_sequence(
        images, positions, quats, t_cfg, initial_capacity=plan["capacity"],
        **kw)
    effective = {}
    st, stats = pipeline.map_ping_sequence(images, positions, quats, t_cfg,
                                           budgets=plan, effective=effective,
                                           **kw)
    assert effective["box_bits"] is None
    assert_same_state(st, plain_st)
    j_st, j_stats = j_map_ping_sequence(images, positions, quats, cfg,
                                        backend="brick", window=2,
                                        dtype=jnp.float64, budgets=plan)
    for k in j_stats:
        np.testing.assert_array_equal(stats[k], np.asarray(j_stats[k]), k)
    assert_matches_jax(brick.brick_state_to_numpy(st),
                       {k: np.asarray(getattr(j_st, k)) for k in BRICK_FIELDS})


# ---------------------------------------------------------------------------
# host reads
# ---------------------------------------------------------------------------


class ReadCounter:
    """Counts the calls that read a tensor's values to the host."""

    NAMES = ("tolist", "item", "cpu", "nonzero", "__bool__", "__int__")

    def __init__(self, monkeypatch):
        self.n = 0
        for name in self.NAMES:
            monkeypatch.setattr(torch.Tensor, name,
                                self._wrap(getattr(torch.Tensor, name)))
        monkeypatch.setattr(torch, "nonzero", self._wrap(torch.nonzero))

    def _wrap(self, fn):
        def counted(*args, **kwargs):
            self.n += 1
            return fn(*args, **kwargs)
        return counted


@pytest.mark.parametrize("window_group", [1, 2])
def test_budgeted_scan_reads_once(monkeypatch, window_group):
    """A budgeted 4-window scan_pings_brick (windows 3, 3, 3, 1) reads one
    value set to the host, at its end; the same scan count-sized reads at
    every window."""
    images, positions, quats = survey()
    cfg = port_cfg(CFG)
    T = torch.as_tensor(j_batched_sonar_to_world(positions, quats, CFG))
    boxes = compute_window_boxes(T[:, :3, 3].numpy(), cfg.max_range,
                                 cfg.voxel_resolution, 3, 2, frame_bits=2)
    kw = dict(tables=bp.resolve_capped_tables(images, cfg, 64, 48), cfg=cfg,
              dtype=torch.float64, window=3, boxes=boxes,
              window_group=window_group)
    imgs = torch.as_tensor(images)
    budgets = dict(unique_budget=2048, brick_budget=8192)
    state = brick.init_brick_grid(1 << 16, torch.float64, "cpu")
    counter = ReadCounter(monkeypatch)
    st, stats = pipeline.scan_pings_brick(state, imgs, T, **budgets, **kw)
    assert counter.n == 1
    assert not stats["overflowed"].any()
    counter.n = 0
    plain_st, _ = pipeline.scan_pings_brick(state, imgs, T, **kw)
    assert counter.n >= 4
    monkeypatch.undo()
    assert_same_state(st, plain_st)


def test_budgeted_growth_reads_once_a_scan_and_a_growth(monkeypatch):
    """map_ping_sequence at the default budgets from a 128-brick table:
    one read a scan plus one a table growth."""
    calls = {"scan": 0, "grow": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(pipeline, "scan_pings_brick",
                        counting("scan", pipeline.scan_pings_brick))
    monkeypatch.setattr(pipeline, "rehash_bricks",
                        counting("grow", pipeline.rehash_bricks))
    images, positions, quats = survey()
    cfg = port_cfg(CFG)
    tables = bp.resolve_capped_tables(images, cfg, 64, 48)
    counter = ReadCounter(monkeypatch)
    st, stats = pipeline.map_ping_sequence(
        images, positions, quats, cfg, device="cpu", window=WINDOW,
        dtype=torch.float64, budgets={}, initial_capacity=128, tables=tables)
    assert calls["grow"] >= 1
    assert counter.n <= calls["scan"] + calls["grow"]
    assert not stats["overflowed"].any()


# ---------------------------------------------------------------------------
# K1 on a padded window, and the dense_mode spellings
# ---------------------------------------------------------------------------


def _window(seed, nb, B=4, vol=64):
    """A (brick, frame, offset)-sorted unique window of nb bricks."""
    rng = np.random.default_rng(seed)
    f_bits, o = 2, 6
    keys = np.unique(rng.integers(0, nb << (f_bits + o), 3 * nb))
    pay = (rng.integers(1, 5, len(keys)) << 16) | rng.integers(0, 3, len(keys))
    brick_of = keys >> (f_bits + o)
    starts = np.searchsorted(brick_of, np.arange(nb + 1))
    rows = rng.normal(0.0, 1.0, (nb, vol))
    return (torch.as_tensor(keys), torch.as_tensor(pay),
            torch.as_tensor(starts), torch.as_tensor(rows),
            dict(B=B, vol=vol, f_bits=f_bits, o=o, cfg=port_cfg(CFG)))


@pytest.mark.parametrize("raw", [False, True], ids=["K1", "K1-raw"])
def test_plain_k1_on_a_padded_window(raw):
    """The budgeted window's shape: extra empty bricks (ranges at the
    valid lane count) and EMPTY32 lanes with payload 0 past the valid
    prefix.  The real bricks' rows and touched masks, and the per-frame
    counts, equal the unpadded window's; padded rows pass through
    untouched."""
    fn = bin_apply_raw if raw else bin_apply
    for seed in range(3):
        s_flat, s_pay, starts, rows, kw = _window(seed, nb=20)
        n = len(s_flat)
        pad_lanes, pad_bricks = 37, 11
        p_flat = torch.cat([s_flat, torch.full((pad_lanes,), EMPTY32)])
        p_pay = torch.cat([s_pay, torch.zeros(pad_lanes, dtype=torch.int64)])
        p_starts = torch.cat([starts, torch.full((pad_bricks,), n)])
        p_rows = torch.cat([rows, torch.randn(pad_bricks, 64,
                                              dtype=torch.float64)])
        want = fn(s_flat, s_pay, starts, rows, **kw)
        got = fn(p_flat, p_pay, p_starts, p_rows, **kw)
        assert torch.equal(got[0][:20], want[0])
        assert torch.equal(got[1][:20], want[1])
        assert torch.equal(got[0][20:], p_rows[20:])
        assert not got[1][20:].any()
        for a, b in zip(got[2:], want[2:]):
            assert torch.equal(a, b)


GOOD_MODES = ["scalar", "bfv", "row", "pallas", "pallas-tb16",
              "pallas-tb8-c512", "pallas-c1024-tb4", "pallas-raw",
              "pallas-raw-tb16", "pallas-tb16-raw", "pallas-c512-raw-tb8"]
BAD_MODES = ["", "PALLAS", "dense", "raw", "bfv-raw", "scalar-tb16",
             "row-c512", "pallas-tb0", "pallas-tb", "pallas-c-1",
             "pallas-raw-raw", "pallas-tb8-tb16", "pallas-foo",
             "pallas--raw"]


@functools.lru_cache(maxsize=None)
def _mode_map(mode):
    st, stats = port_run("brick", dense_mode=mode)
    return st, stats


@pytest.mark.parametrize("mode", GOOD_MODES)
def test_every_jax_dense_mode_spelling_maps(mode):
    """Each JAX spelling runs K1 (raw spellings K1-raw): the map and the
    stats of "pallas" (raw: "pallas-raw", whose map is the same)."""
    raw = "raw" in mode.split("-")
    assert brick.is_raw_mode(mode) == raw
    want_st, want = _mode_map("pallas-raw" if raw else "pallas")
    st, stats = _mode_map(mode)
    assert_same_state(st, want_st)
    assert_same_state(st, _mode_map("pallas")[0])
    for k in want:
        np.testing.assert_array_equal(stats[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode", BAD_MODES)
def test_other_dense_mode_spellings_are_refused(mode):
    with pytest.raises(ValueError, match="pallas-raw"):
        brick.parse_dense_mode(mode)


def test_parse_dense_mode_records_the_suffixes():
    assert brick.parse_dense_mode("pallas-c512-raw-tb8") == \
        brick.DenseMode("pallas", True, 8, 512)
    assert brick.parse_dense_mode("row") == \
        brick.DenseMode("row", False, None, None)


def test_plan_dense_mode_is_the_default():
    """A plan's dense_mode picks the window's records unless the caller
    names one: a raw plan maps with raw lanes."""
    plan = dict(jax_plan("brick"), dense_mode="pallas-raw-tb16")
    _, stats = port_run("brick", plan)
    _, raw = _mode_map("pallas-raw")
    np.testing.assert_array_equal(stats["batch_n_lanes"],
                                  raw["batch_n_lanes"])
    _, named = port_run("brick", plan, dense_mode="bfv")
    np.testing.assert_array_equal(named["batch_n_lanes"],
                                  _mode_map("pallas")[1]["batch_n_lanes"])
