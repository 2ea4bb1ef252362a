"""Map snapshots across both packages: the port's ``save_map`` /
``load_map_brick`` against the JAX package's, on one ``sonar3d-map-v1``
npz format.

Tolerances: snapshot keys, bounds, configs and restored voxel keys
exactly; log-odds exactly after a round trip (no arithmetic), and within
EXP_ULP_TOL (tests/torch_parity.py) between maps the two packages mapped.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.grid.brick import (  # noqa: E402
    touched_voxels_brick as j_touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu.grid.hash import (  # noqa: E402
    touched_voxels_hash as j_touched_voxels_hash,
)
from sonar_3d_reconstruction_tpu.io import checkpoint as j_checkpoint  # noqa: E402
from sonar_3d_reconstruction_tpu.models import (  # noqa: E402
    SonarMapper as JaxMapper,
)

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    init_brick_grid,
    load_voxels_brick,
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu_torch.io.checkpoint import (  # noqa: E402
    load_map_brick,
    save_map,
)
from sonar_3d_reconstruction_tpu_torch.models import SonarMapper  # noqa: E402

from conftest import circular_trajectory, synthetic_ping  # noqa: E402
from torch_parity import DTYPES, EXP_ULP_TOL, port_cfg  # noqa: E402


def sorted_voxels(keys, lo):
    order = np.lexsort(np.asarray(keys).T)
    return np.asarray(keys)[order], np.asarray(lo)[order]


def map_both(cfg, t_dtype, j_dtype, n=3, seed=300):
    """The same pings through both packages' mappers."""
    jm = JaxMapper(cfg, backend="brick", initial_capacity=1 << 13,
                   dtype=j_dtype)
    tm = SonarMapper(port_cfg(cfg), initial_capacity=1 << 13, dtype=t_dtype,
                     device="cpu")
    positions, quats = circular_trajectory(n)
    for i in range(n):
        img = synthetic_ping(cfg.image_height, cfg.image_width, seed=seed + i)
        jm.process_sonar_image(img, positions[i], quats[i])
        tm.process_sonar_image(img, positions[i], quats[i])
    return jm, tm


def read_npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_snapshots_match_jax(small_cfg, t_dtype, j_dtype, tmp_path):
    """Equal maps give the same snapshot from either package: same arrays,
    dtypes and config; the port's loads into the JAX brick and hash
    grids and the JAX one into the port's, with every voxel kept."""
    jm, tm = map_both(small_cfg, t_dtype, j_dtype)
    t_path, j_path = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    save_map(t_path, tm.state, tm.cfg)
    j_checkpoint.save_map(j_path, jm.state, jm.cfg)
    got, want = read_npz(t_path), read_npz(j_path)
    assert got.keys() == want.keys()
    for k in ("format", "keys", "min_bounds", "max_bounds"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert json.loads(str(got["config"])) == json.loads(str(want["config"]))
    assert got["log_odds"].dtype == want["log_odds"].dtype
    np.testing.assert_allclose(got["log_odds"], want["log_odds"], rtol=0,
                               atol=EXP_ULP_TOL[t_dtype])

    saved = sorted_voxels(got["keys"], got["log_odds"])
    j_brick, j_cfg = j_checkpoint.load_map_brick(t_path)
    j_hash, _ = j_checkpoint.load_map(t_path)
    assert port_cfg(j_cfg) == tm.cfg
    for state, dump in ((j_brick, j_touched_voxels_brick),
                        (j_hash, j_touched_voxels_hash)):
        keys, lo = sorted_voxels(*dump(state))
        np.testing.assert_array_equal(keys, saved[0])
        np.testing.assert_array_equal(lo, saved[1])
        assert lo.dtype == saved[1].dtype

    state, cfg = load_map_brick(j_path, device="cpu")
    assert cfg == tm.cfg and state.log_odds.dtype == t_dtype
    keys, lo = sorted_voxels(*touched_voxels_brick(state))
    want_keys, want_lo = sorted_voxels(want["keys"], want["log_odds"])
    np.testing.assert_array_equal(keys, want_keys)
    np.testing.assert_array_equal(lo, want_lo)
    assert int(state.used) == len(keys) == jm.num_voxels
    np.testing.assert_array_equal(state.min_bounds.numpy(), want["min_bounds"])
    np.testing.assert_array_equal(state.max_bounds.numpy(), want["max_bounds"])


@pytest.mark.parametrize("t_dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_round_trip_resumes_mapping(small_cfg, t_dtype, tmp_path):
    """A restored map keeps its dtype, voxels, bounds and answers, and
    mapping on from it equals mapping on from the original."""
    cfg = port_cfg(small_cfg)
    m = SonarMapper(cfg, dtype=t_dtype, device="cpu")
    positions, quats = circular_trajectory(3)
    imgs = [synthetic_ping(cfg.image_height, cfg.image_width, seed=310 + i)
            for i in range(3)]
    for i in range(2):
        m.process_sonar_image(imgs[i], positions[i], quats[i])
    path = str(tmp_path / "m.npz")
    save_map(path, m.state, cfg)
    state, got_cfg = load_map_brick(path, device="cpu")
    assert got_cfg == cfg and state.log_odds.dtype == t_dtype
    for a, b in zip(touched_voxels_brick(state), touched_voxels_brick(m.state)):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(state.min_bounds, m.state.min_bounds)
    assert torch.equal(state.max_bounds, m.state.max_bounds)
    keys = touched_voxels_brick(m.state)[0]
    pts = (keys + 0.5) * cfg.voxel_resolution
    r = SonarMapper(cfg, dtype=t_dtype, device="cpu")
    r.state = state
    np.testing.assert_array_equal(r.query_probabilities(pts),
                                  m.query_probabilities(pts))
    for x in (m, r):
        x.process_sonar_image(imgs[2], positions[2], quats[2])
    for a, b in zip(touched_voxels_brick(r.state), touched_voxels_brick(m.state)):
        np.testing.assert_array_equal(a, b)
    as32, _ = load_map_brick(path, dtype=torch.float32, device="cpu")
    assert as32.log_odds.dtype == torch.float32


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES)
def test_empty_map_round_trips(t_dtype, j_dtype, tmp_path):
    """An empty map saves zero voxels in its own dtype; both packages load
    it back empty, in that dtype."""
    cfg = MapperConfig()
    path = str(tmp_path / "e.npz")
    save_map(path, init_brick_grid(256, t_dtype, "cpu"), cfg)
    z = read_npz(path)
    assert z["keys"].shape == (0, 3) and z["keys"].dtype == np.int32
    assert z["log_odds"].shape == (0,)
    assert z["log_odds"].dtype == np.dtype(jnp.dtype(j_dtype).name)
    state, _ = load_map_brick(path, device="cpu")
    assert int(state.used) == 0 and state.log_odds.dtype == t_dtype
    j_state, _ = j_checkpoint.load_map_brick(path)
    assert int(j_state.used) == 0 and j_state.log_odds.dtype == j_dtype


def test_load_voxels_brick_sizes_and_checks():
    """Capacity from the brick count (four slots a brick, 1024 at least),
    an explicit capacity kept, and keys beyond the packable range refused."""
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(-300, 300, size=(3000, 3)), axis=0)
    lo = rng.normal(size=len(keys))
    st = load_voxels_brick(keys, lo, "cpu", dtype=torch.float64)
    n_bricks = len(np.unique(keys >> 2, axis=0))
    assert st.capacity >= 4 * n_bricks > st.capacity // 2
    got = sorted_voxels(*touched_voxels_brick(st))
    want = sorted_voxels(keys, lo)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert load_voxels_brick(keys[:5], lo[:5], "cpu", capacity=1 << 14).capacity == 1 << 14
    with pytest.raises(ValueError, match="packable range"):
        load_voxels_brick([[1 << 21, 0, 0]], [1.0], "cpu")


def test_load_map_brick_runs_on_the_card_unless_told(tmp_path):
    path = str(tmp_path / "c.npz")
    save_map(path, init_brick_grid(128, torch.float32, "cpu"), MapperConfig())
    if torch.cuda.is_available():
        state, _ = load_map_brick(path)
        assert state.log_odds.device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_map_brick(path)


def test_sharded_snapshots_cross_packages(small_cfg, tmp_path):
    """Sharded brick maps (four shards, float64) across both packages: a
    snapshot of either package's sharded map loads into the other's with
    every voxel on the same shard; the two snapshots hold the same voxels
    in the same order; the port's loads into two shards, each voxel on
    its brick's owner, and into a plain brick grid."""
    import jax

    from sonar_3d_reconstruction_tpu.parallel.shard import (
        make_mesh as j_make_mesh,
    )
    from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
        local_brick_states as j_local_brick_states,
    )
    from sonar_3d_reconstruction_tpu_torch.io.checkpoint import (
        load_map_sharded_brick,
    )
    from sonar_3d_reconstruction_tpu_torch.ops.packing import pack_brick_keys
    from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (
        ShardedBrickState,
        local_brick_states,
        owner_shard_brick,
    )

    j_mesh = j_make_mesh(jax.devices()[:4])
    jm = JaxMapper(small_cfg, backend="brick-sharded", dtype=jnp.float64,
                   initial_capacity=1 << 16, mesh=j_mesh)
    tm = SonarMapper(port_cfg(small_cfg), backend="brick-sharded",
                     dtype=torch.float64, initial_capacity=1 << 16,
                     mesh=["cpu"] * 4)
    positions, quats = circular_trajectory(4)
    images = np.stack([synthetic_ping(100, 64, seed=330 + i)
                       for i in range(4)])
    jm.map_sequence(images, positions, quats, window=2)
    tm.map_sequence(images, positions, quats, window=2)
    t_path, j_path = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    save_map(t_path, tm.state, tm.cfg)
    j_checkpoint.save_map(j_path, jm.state, jm.cfg)
    got, want = read_npz(t_path), read_npz(j_path)
    for k in ("keys", "min_bounds", "max_bounds"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["log_odds"], want["log_odds"], rtol=0,
                               atol=EXP_ULP_TOL[torch.float64])

    def shards(states, dump):
        return [sorted_voxels(*dump(s)) for s in states]

    port_map = shards(local_brick_states(tm.state), touched_voxels_brick)
    jax_map = shards(j_local_brick_states(jm.state), j_touched_voxels_brick)
    # JAX sharded snapshot -> port sharded map: JAX's shards exactly
    state, cfg = load_map_sharded_brick(j_path, mesh=["cpu"] * 4)
    assert isinstance(state, ShardedBrickState) and cfg == tm.cfg
    assert state.dtype == torch.float64
    for (k, v), (w_k, w_v) in zip(
            shards(local_brick_states(state), touched_voxels_brick), jax_map):
        np.testing.assert_array_equal(k, w_k)
        np.testing.assert_array_equal(v, w_v)
    np.testing.assert_array_equal(state.min_bounds.numpy(), want["min_bounds"])
    # port sharded snapshot -> JAX sharded map: the port's shards exactly
    j_state, _ = j_checkpoint.load_map_sharded_brick(
        t_path, mesh=j_mesh, dtype=jnp.float64)
    for (k, v), (w_k, w_v) in zip(
            shards(j_local_brick_states(j_state), j_touched_voxels_brick),
            port_map):
        np.testing.assert_array_equal(k, w_k)
        np.testing.assert_array_equal(v, w_v)
    # any mesh size: each voxel on its brick's owner; a plain brick grid
    two, _ = load_map_sharded_brick(t_path, mesh=["cpu"] * 2,
                                    local_capacity=1 << 12)
    assert {s.capacity for s in two.shards} == {1 << 12}
    for s, (k, _) in enumerate(shards(local_brick_states(two),
                                      touched_voxels_brick)):
        hi, lo, _ = pack_brick_keys(torch.as_tensor(k), 2)
        assert len(k) and (owner_shard_brick(hi, lo, 2, 2) == s).all()
    assert sum(len(k) for k, _ in shards(two.shards, touched_voxels_brick)) \
        == tm.num_voxels
    brick, _ = load_map_brick(t_path, device="cpu")
    assert int(brick.used) == tm.num_voxels
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_map_sharded_brick(t_path)
