"""The port's deployment budget plans (``utils/autotune``, the CLI's
``tune`` and ``map-bag --budgets``, ``StreamingMapper(budgets=)``)
against the JAX package's.

The survey is ``tests/test_autotune.py``'s small setup (64x48 images, 10
pings, window 4, float64), one JAX warm-up per plan shared by the module.
Tolerances: plans, per-ping stats, keys and counts are equal; log-odds
against the JAX package within EXP_ULP_TOL (tests/torch_parity.py), and
bit-equal between two runs of the port.
"""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu import cli as j_cli  # noqa: E402
from sonar_3d_reconstruction_tpu.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu.io.bag import write_synthetic_bag  # noqa: E402
from sonar_3d_reconstruction_tpu.pipeline import (  # noqa: E402
    map_ping_sequence as j_map_ping_sequence,
)
from sonar_3d_reconstruction_tpu.stream import (  # noqa: E402
    StreamingMapper as JaxStream,
)
from sonar_3d_reconstruction_tpu.utils import autotune as j_autotune  # noqa: E402

from sonar_3d_reconstruction_tpu_torch import cli  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    brick_state_to_numpy,
    extract_occupied_brick,
)
from sonar_3d_reconstruction_tpu_torch.grid.hash import (  # noqa: E402
    hash_state_to_numpy,
)
from sonar_3d_reconstruction_tpu_torch.io.bag import (  # noqa: E402
    ImageMsg,
    OdometryMsg,
)
from sonar_3d_reconstruction_tpu_torch.io.checkpoint import (  # noqa: E402
    load_map_brick,
)
from sonar_3d_reconstruction_tpu_torch.pipeline import (  # noqa: E402
    map_ping_sequence,
)
from sonar_3d_reconstruction_tpu_torch.stream import StreamingMapper  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.utils import autotune  # noqa: E402

from test_autotune import _survey  # noqa: E402
from torch_parity import EXP_ULP_TOL, port_cfg  # noqa: E402

CFG = MapperConfig(
    image_height=64, image_width=48, max_range=5.0, min_range=0.5,
    voxel_resolution=0.1, intensity_threshold=50,
)
WINDOW = 4
BRICK_FIELDS = ("key_rows", "log_odds", "touched", "min_bounds",
                "max_bounds", "used", "poisoned")
HASH_FIELDS = ("key_rows", "log_odds", "min_bounds", "max_bounds", "used",
               "poisoned")
# (backend, dense_mode, initial capacity): the JAX defaults, the "row"
# layout (its vox budget), and tables small enough that the warm-up grows
TUNE_CASES = [
    pytest.param("brick", "bfv", None, id="brick-bfv"),
    pytest.param("brick", "row", None, id="brick-row"),
    pytest.param("brick", "bfv", 128, id="brick-bfv-grows"),
    pytest.param("hash", "bfv", None, id="hash"),
    pytest.param("hash", "bfv", 256, id="hash-grows"),
]


@functools.lru_cache(maxsize=None)
def survey():
    return _survey(CFG)


@functools.lru_cache(maxsize=None)
def jax_plan(backend, dense_mode="bfv", initial_capacity=None, window=WINDOW):
    return j_autotune.tune_sequence(
        *survey(), CFG, backend=backend, window=window,
        dense_mode=dense_mode, dtype=jnp.float64,
        initial_capacity=initial_capacity,
    )


@functools.lru_cache(maxsize=None)
def jax_map(backend, plan_key):
    """JAX map_ping_sequence with the JAX plan of ``plan_key`` (a
    jax_plan argument tuple; None: no plan) -> (state arrays, stats)."""
    plan = None if plan_key is None else jax_plan(*plan_key)
    st, stats = j_map_ping_sequence(
        *survey(), CFG, backend=backend, window=WINDOW, dtype=jnp.float64,
        budgets=plan,
    )
    fields = BRICK_FIELDS if backend == "brick" else HASH_FIELDS
    return ({k: np.asarray(getattr(st, k)) for k in fields},
            {k: np.asarray(v) for k, v in stats.items()})


def port_tune(backend, dense_mode, initial_capacity=None, window=WINDOW):
    return autotune.tune_sequence(
        *survey(), port_cfg(CFG), backend=backend, window=window,
        dense_mode=dense_mode, dtype=torch.float64,
        initial_capacity=initial_capacity, device="cpu",
    )


def state_arrays(state, backend):
    return (brick_state_to_numpy if backend == "brick"
            else hash_state_to_numpy)(state)


def assert_states_match(got, want):
    """Port vs JAX state arrays: equal, log-odds within EXP_ULP_TOL."""
    assert got.keys() >= want.keys()
    for k in want:
        if k == "log_odds":
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=EXP_ULP_TOL[torch.float64])
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("backend,dense_mode,initial_capacity", TUNE_CASES)
def test_tune_sequence_matches_jax(backend, dense_mode, initial_capacity):
    """Every key of the plan, budgets, safe budgets, capacity and caps,
    equals the JAX package's; a warm-up from a small table grows to the
    same capacity."""
    want = jax_plan(backend, dense_mode, initial_capacity)
    got = port_tune(backend, dense_mode, initial_capacity)
    assert got == want
    if initial_capacity is not None:
        assert got["capacity"] > initial_capacity


def test_tune_sequence_at_window_1_matches_jax():
    """A hash plan at window 1 (the per-ping engine: no batch, lane or
    insert measurements) and a brick plan at window 1."""
    for backend in ("hash", "brick"):
        assert port_tune(backend, "bfv", window=1) == \
            jax_plan(backend, "bfv", None, 1)


@pytest.mark.parametrize("backend", ["brick", "hash"])
def test_jax_plan_drives_the_port(backend):
    """A plan written by the JAX package's tune_sequence, through the
    port's map_ping_sequence(budgets=): the JAX map with that plan, every
    per-ping stat of the JAX run (its keys) equal."""
    plan_key = (backend, "bfv", None)
    want_st, want_stats = jax_map(backend, plan_key)
    st, stats = map_ping_sequence(
        *survey(), port_cfg(CFG), device="cpu", backend=backend,
        window=WINDOW, dtype=torch.float64,
        budgets=json.loads(json.dumps(jax_plan(*plan_key))),
    )
    assert set(stats) == set(want_stats)
    for k, v in want_stats.items():
        np.testing.assert_array_equal(stats[k], v, err_msg=k)
    assert_states_match(state_arrays(st, backend), want_st)


@pytest.mark.parametrize("backend", ["brick", "hash"])
def test_port_plan_drives_jax(backend):
    """The other way round: the port's plan (as JSON) through the JAX
    package's map_ping_sequence gives the JAX map without a plan."""
    plan = json.loads(json.dumps(port_tune(backend, "bfv")))
    st, stats = j_map_ping_sequence(
        *survey(), CFG, backend=backend, window=WINDOW, dtype=jnp.float64,
        budgets=plan,
    )
    want_st, want_stats = jax_map(backend, None)
    assert not np.asarray(stats["overflowed"]).any()
    for k in ("num_occupied", "num_free", "num_candidates"):
        np.testing.assert_array_equal(np.asarray(stats[k]), want_stats[k])
    # the plan's capacity sizes the map: compare voxels, not slots
    assert int(np.asarray(st.used)) == int(want_st["used"])


@pytest.mark.parametrize("backend", ["brick", "hash"])
def test_snug_formulas_match_jax(backend):
    """The copied formulas on random measured stats (10 seeds, windows 1,
    3 and 4, every dense mode for brick) give the JAX package's budgets."""
    rng = np.random.default_rng(11)
    for seed in range(10):
        P = int(rng.integers(3, 20))
        stats = {k: rng.integers(0, 50_000, P) for k in (
            "num_occupied", "num_free", "num_candidates", "batch_n_unique",
            "batch_n_bricks", "batch_n_lanes", "batch_n_need")}
        for window in (1, 3, 4):
            if backend == "brick":
                for mode in ("scalar", "bfv", "row", "pallas"):
                    assert autotune.snug_budgets_brick(
                        stats, window, 131072, 174762, mode
                    ) == j_autotune.snug_budgets_brick(
                        stats, window, 131072, 174762, mode), (seed, mode)
            else:
                w1 = {k: stats[k] for k in ("num_occupied", "num_free",
                                            "num_candidates")}
                for s in (stats, w1):
                    assert autotune.snug_budgets_hash(
                        s, window, 65536, 196608
                    ) == j_autotune.snug_budgets_hash(
                        s, window, 65536, 196608), seed


def _feed(sm, images, positions, quats):
    h, w = images.shape[1:]
    for i in range(images.shape[0]):
        t = 1000.0 + 0.5 * i
        sm.on_ping(ImageMsg(t, "sonar_link", h, w, "mono8", False, w,
                            images[i].tobytes()))
        sm.on_pose(OdometryMsg(t, "camera_init", "body", positions[i],
                               quats[i]))
    return sm.finish()


@pytest.mark.parametrize("backend", ["brick", "hash"])
def test_stream_with_a_plan_matches_jax_stream(backend):
    """StreamingMapper(budgets=) with the JAX plan, chunk = window = 4:
    the JAX stream's map with the same plan (its capacity seeded the same
    way), no table growth and no cap rebuild; the map also equals the
    port's stream without a plan (as voxels: the capacities differ)."""
    from sonar_3d_reconstruction_tpu.io.bag import (
        ImageMsg as JImageMsg,
        OdometryMsg as JOdometryMsg,
    )

    plan = jax_plan(backend, "bfv", None)
    images, positions, quats = survey()
    sm = StreamingMapper(port_cfg(CFG), chunk_size=4, window=4,
                         dtype=torch.float64, backend=backend, budgets=plan,
                         device="cpu")
    stats = _feed(sm, images, positions, quats)
    j_sm = JaxStream(CFG, chunk_size=4, window=4, dtype=jnp.float64,
                     backend=backend, budgets=plan)
    h, w = images.shape[1:]
    for i in range(images.shape[0]):
        t = 1000.0 + 0.5 * i
        j_sm.on_ping(JImageMsg(t, "sonar_link", h, w, "mono8", False, w,
                               images[i].tobytes()))
        j_sm.on_pose(JOdometryMsg(t, "camera_init", "body", positions[i],
                                  quats[i]))
    j_sm.finish()
    s = stats.summary()
    assert s["grows"] == 0 and s["frames_mapped"] == 10
    for k in ("fan", "window", "free"):
        assert s[f"{k}_cap_recompiles"] == 0
    fields = BRICK_FIELDS if backend == "brick" else HASH_FIELDS
    assert_states_match(state_arrays(sm.state, backend),
                        {k: np.asarray(getattr(j_sm.state, k))
                         for k in fields})
    if backend == "brick":
        plain = StreamingMapper(port_cfg(CFG), chunk_size=4, window=4,
                                dtype=torch.float64, device="cpu")
        _feed(plain, images, positions, quats)
        pts, probs = extract_occupied_brick(sm.state, port_cfg(CFG))
        p_pts, p_probs = extract_occupied_brick(plain.state, port_cfg(CFG))
        np.testing.assert_array_equal(pts, p_pts)
        np.testing.assert_array_equal(probs, p_probs)


def test_stream_refuses_a_plan_for_another_window_or_backend():
    plan = jax_plan("brick", "bfv", None)
    with pytest.raises(ValueError, match="window"):
        StreamingMapper(port_cfg(CFG), chunk_size=8, window=8, budgets=plan,
                        device="cpu")
    with pytest.raises(ValueError, match="backend"):
        StreamingMapper(port_cfg(CFG), chunk_size=4, window=4, budgets=plan,
                        backend="hash", device="cpu")
    with pytest.raises(ValueError, match="brick and hash"):
        StreamingMapper(port_cfg(CFG), chunk_size=4, window=4, budgets={},
                        backend="brick-sharded", mesh=["cpu"])


def _run(capsys, main, *argv):
    assert main(list(argv)) == 0, argv
    return json.loads(capsys.readouterr().out.splitlines()[-1])


def test_cli_tune_and_map_bag_budgets_round_trip(tmp_path, capsys):
    """make-bag -> tune --device cpu --out -> map-bag --offline --budgets
    and the streaming map-bag --budgets, no --backend / --window given:
    the plan equals the JAX CLI's plan of the same bag, and each map
    equals the JAX CLI's map of the bag with that plan (saved snapshots,
    voxel for voxel)."""
    bag = str(tmp_path / "survey.db3")
    write_synthetic_bag(bag, *survey(), rate_hz=2.0)
    params = ["--param", "image_height=64", "--param", "image_width=48",
              "--param", "max_range=5.0", "--param", "min_range=0.5",
              "--param", "voxel_resolution=0.1",
              "--param", "intensity_threshold=50"]
    plan_path, j_plan_path = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    assert cli.main(["tune", bag, *params, "--window", "4", "--dense-mode",
                     "bfv", "--out", plan_path, "--device", "cpu"]) == 0
    assert j_cli.main(["tune", bag, *params, "--window", "4",
                       "--out", j_plan_path]) == 0
    with open(plan_path) as f, open(j_plan_path) as g:
        plan = json.load(f)
        assert plan == json.load(g)
    assert plan["backend"] == "brick" and plan["window"] == 4
    j_snap = str(tmp_path / "j.npz")
    _run(capsys, j_cli.main, "map-bag", bag, *params, "--offline",
         "--budgets", plan_path, "--save-map", j_snap)
    want, _ = load_map_brick(j_snap, device="cpu")
    want_pts, want_probs = extract_occupied_brick(want, port_cfg(CFG))
    for mode in (["--offline"], ["--chunk", "2"]):
        snap = str(tmp_path / "t.npz")
        got = _run(capsys, cli.main, "map-bag", bag, *params, *mode,
                   "--budgets", plan_path, "--save-map", snap,
                   "--device", "cpu")
        assert got.get("pairs", got.get("frames_mapped")) == 10
        state, _ = load_map_brick(snap, device="cpu")
        pts, probs = extract_occupied_brick(state, port_cfg(CFG))
        np.testing.assert_array_equal(pts, want_pts)
        np.testing.assert_allclose(probs, want_probs, rtol=0, atol=1e-6)
    with pytest.raises(SystemExit, match="tuned for backend"):
        cli.main(["map-bag", bag, *params, "--offline", "--backend", "hash",
                  "--budgets", plan_path, "--device", "cpu"])
    with pytest.raises(SystemExit, match="tuned for window"):
        cli.main(["map-bag", bag, *params, "--window", "2",
                  "--budgets", plan_path, "--device", "cpu"])
    # brick-sharded warns and maps without the plan, as the JAX CLI does
    got = _run(capsys, cli.main, "map-bag", bag, *params, "--offline",
               "--backend", "brick-sharded", "--shards", "2",
               "--budgets", plan_path, "--device", "cpu")
    assert got["pairs"] == 10


def test_cli_tune_refuses_an_unknown_dense_mode(tmp_path, capsys):
    with pytest.raises(SystemExit):
        cli.main(["tune", str(tmp_path / "x.db3"), "--dense-mode",
                  "bfv-raw", "--device", "cpu"])
    assert "not accepted" in capsys.readouterr().err
