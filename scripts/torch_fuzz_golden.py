"""Randomized-config golden-parity fuzz of the PyTorch port: every engine of
the port against the port's own float64 oracle
(``sonar_3d_reconstruction_tpu_torch.golden``).

Each trial draws a random MapperConfig (geometry, mount pose, thresholds,
log-odds parameters, z filter, adaptive update), a random short trajectory
and random sparse pings -- ``random_config`` and ``random_pings`` are
copies of ``scripts/fuzz_golden.py``'s, draw for draw, so a seed names the
same trial in both packages -- and maps it through every engine of the
port (``ENGINES``): the brick pipeline in both dense modes, batched
records, the two-word (wide) brick codes, the hash and dense backends,
``SonarMapper``, the three sharded engines on a mesh of the run's device
repeated SHARDS times, and the multi-host fold.  In float64 each engine
must hold golden's voxel set, its log-odds within F64_TOL and its per-ping
``num_occupied`` / ``num_free``.  In float32 the brick engines
(``BRICK_ENGINES``) are held to probabilities within F32_PROB_TOL on the
voxels both maps hold; the voxels only one map holds (float32 key flips
at voxel boundaries) are counted, and their share of the common voxels
over a run must stay under FLIP_RATE.

Usage: python scripts/torch_fuzz_golden.py [N_TRIALS] [BASE_SEED]
           [--device D] [--dtype float64|float32]

``--device`` defaults to the first CUDA device.  Prints one line per
trial; on the first mismatch prints a repro line (seed, engine, config
dict) and exits nonzero.  The module imports no jax and nothing of the
JAX package; ``chip_smoke.py`` and the port's tests import it.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
from typing import Callable, Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.device import require_cuda  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.geometry import (  # noqa: E402
    batched_sonar_to_world,
)
from sonar_3d_reconstruction_tpu_torch.golden import GoldenMapper  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    BrickGridState,
    init_brick_grid,
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu_torch.grid.dense import (  # noqa: E402
    DenseGridSpec,
    DenseGridState,
    default_dense_spec,
)
from sonar_3d_reconstruction_tpu_torch.grid.hash import (  # noqa: E402
    HashGridState,
    init_hash_grid,
    touched_voxels_hash,
)
from sonar_3d_reconstruction_tpu_torch.models import SonarMapper  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (  # noqa: E402
    tables_for_images,
)
from sonar_3d_reconstruction_tpu_torch.parallel import (  # noqa: E402
    ShardedBrickState,
    ShardedHashState,
    gather_sharded_brick_state,
    map_ping_sequence_multihost,
    map_ping_sequence_sharded,
    map_ping_sequence_sharded_brick,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard import (  # noqa: E402
    touched_voxels_sharded,
)
from sonar_3d_reconstruction_tpu_torch.pipeline import (  # noqa: E402
    MAX_GROW_RETRIES,
    map_ping_sequence,
    scan_pings_brick,
)

F64_TOL = 1e-9        # |log-odds - golden's| in float64
F32_PROB_TOL = 1e-5   # |probability - golden's| in float32, common voxels
FLIP_RATE = 2e-3      # float32: voxels one map holds / common voxels
SHARDS = 4            # the sharded engines' mesh: the device SHARDS times


# ---------------------------------------------------------------------------
# The trial (draw for draw as scripts/fuzz_golden.py)
# ---------------------------------------------------------------------------


def random_config(rng: np.random.Generator) -> MapperConfig:
    h = int(rng.integers(40, 140))
    w = int(rng.integers(32, 100))
    min_range = float(rng.uniform(0.1, 1.0))
    return MapperConfig(
        image_height=h,
        image_width=w,
        horizontal_fov=float(rng.uniform(60.0, 150.0)),
        vertical_aperture=float(rng.uniform(6.0, 30.0)),
        max_range=float(rng.uniform(3.0, 8.0)),
        min_range=min_range,
        intensity_threshold=float(rng.uniform(10.0, 120.0)),
        voxel_resolution=float(rng.uniform(0.08, 0.35)),
        sonar_position=tuple(rng.uniform(-1.0, 1.0, 3).round(3)),
        sonar_orientation=tuple(rng.uniform(-1.6, 1.6, 3).round(3)),
        z_filter_enabled=bool(rng.random() < 0.3),
        z_filter_min=float(rng.uniform(-2.0, 0.0)),
        adaptive_update=bool(rng.random() < 0.7),
        adaptive_threshold=float(rng.uniform(0.3, 0.7)),
        adaptive_max_ratio=float(rng.uniform(0.1, 0.5)),
        log_odds_occupied=float(rng.uniform(0.5, 3.0)),
        log_odds_free=float(rng.uniform(-3.0, -0.5)),
        log_odds_min=float(rng.uniform(-12.0, -6.0)),
        log_odds_max=float(rng.uniform(6.0, 12.0)),
        free_sampling_step=int(rng.integers(4, 21)),
        occupied_window=int(rng.integers(10, 61)),
        max_rays=int(rng.integers(32, 257)),
    )


def random_pings(cfg: MapperConfig, n: int, rng: np.random.Generator):
    images = rng.integers(
        0, 25, size=(n, cfg.image_height, cfg.image_width)
    ).astype(np.uint8)
    for i in range(n):  # a few bright blobs per ping
        for _ in range(int(rng.integers(1, 4))):
            r0 = int(rng.integers(0, cfg.image_height - 6))
            b0 = int(rng.integers(0, cfg.image_width - 5))
            images[i, r0 : r0 + int(rng.integers(2, 6)),
                   b0 : b0 + int(rng.integers(2, 5))] = int(
                rng.integers(60, 230)
            )
    positions = rng.normal(0.0, 0.5, size=(n, 3))
    q = rng.normal(0.0, 1.0, size=(n, 4))
    quats = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return images, positions, quats


@dataclasses.dataclass(frozen=True)
class Trial:
    seed: int
    cfg: MapperConfig
    images: np.ndarray
    positions: np.ndarray
    quats: np.ndarray

    @property
    def n(self) -> int:
        return len(self.images)


def draw_trial(seed: int) -> Trial:
    """The trial ``scripts/fuzz_golden.run_trial(seed)`` maps: its config,
    its ping count (2-4) and its pings, in its order of draws."""
    rng = np.random.default_rng(seed)
    cfg = random_config(rng)
    n = int(rng.integers(2, 5))
    return Trial(seed, cfg, *random_pings(cfg, n, rng))


@dataclasses.dataclass(frozen=True)
class Golden:
    log_odds: Dict[Tuple[int, int, int], float]
    num_occupied: np.ndarray
    num_free: np.ndarray


@functools.lru_cache(maxsize=64)
def golden_of(seed: int) -> Golden:
    """The port's float64 oracle over trial ``seed`` (computed once)."""
    t = draw_trial(seed)
    g = GoldenMapper(t.cfg)
    stats = [g.process_ping(*x) for x in zip(t.images, t.positions, t.quats)]
    return Golden(dict(g.map.log_odds),
                  np.asarray([s["num_occupied"] for s in stats]),
                  np.asarray([s["num_free"] for s in stats]))


# ---------------------------------------------------------------------------
# State -> {voxel key: log-odds}, one decoder a state type
# ---------------------------------------------------------------------------


def _as_dict(keys: np.ndarray, log_odds) -> Dict[Tuple[int, int, int], float]:
    lo = np.asarray(log_odds, np.float64).tolist()
    return dict(zip(map(tuple, np.asarray(keys).tolist()), lo))


def brick_to_dict(state: BrickGridState):
    return _as_dict(*touched_voxels_brick(state))


def hash_to_dict(state: HashGridState):
    return _as_dict(*touched_voxels_hash(state))


def dense_to_dict(state: DenseGridState, spec: DenseGridSpec):
    flat = state.touched.nonzero().squeeze(1)
    keys = (np.stack(np.unravel_index(flat.cpu().numpy(), spec.shape), -1)
            + np.asarray(spec.origin_key))
    return _as_dict(keys, state.log_odds[flat].cpu().numpy())


def sharded_brick_to_dict(state: ShardedBrickState):
    return _as_dict(*gather_sharded_brick_state(state))


def sharded_hash_to_dict(state: ShardedHashState):
    return _as_dict(*touched_voxels_sharded(state))


# ---------------------------------------------------------------------------
# The engines: (trial, device, dtype) -> (voxels, per-ping occupied, free)
# ---------------------------------------------------------------------------

Run = Tuple[Dict[Tuple[int, int, int], float], np.ndarray, np.ndarray]
Engine = Callable[[Trial, torch.device, torch.dtype], Run]


def _seq(stats) -> Tuple[np.ndarray, np.ndarray]:
    return np.asarray(stats["num_occupied"]), np.asarray(stats["num_free"])


def _brick_engine(window: int, dense_mode: str, records_batch: int = 1,
                  window_group: int = 1) -> Engine:
    def run(t, device, dtype):
        st, stats = map_ping_sequence(
            t.images, t.positions, t.quats, t.cfg, device=device,
            dtype=dtype, window=window, dense_mode=dense_mode,
            records_batch=records_batch, window_group=window_group,
            state=init_brick_grid(1 << 8, dtype, device),
        )
        return (brick_to_dict(st), *_seq(stats))
    return run


def _wide_engine(window: int) -> Engine:
    """``scan_pings_brick`` with no boxes: every window takes two-word
    brick codes (``apply_brick_records_wide``); a run that overflows the
    table starts again on an empty map of twice its capacity."""
    def run(t, device, dtype):
        tables = tables_for_images(t.images, t.cfg, None)
        T = torch.as_tensor(
            batched_sonar_to_world(t.positions, t.quats, t.cfg),
            device=device).to(dtype)
        images = torch.as_tensor(t.images, device=device)
        state = init_brick_grid(1 << 8, dtype, device)
        for _ in range(MAX_GROW_RETRIES):
            st, stats = scan_pings_brick(
                state, images, T, tables=tables, cfg=t.cfg, dtype=dtype,
                window=window, boxes=None)
            if not stats["overflowed"].any():
                return (brick_to_dict(st), *_seq(stats))
            if stats["range_fail"].any() or stats["pack_overflow"].any():
                raise ValueError("wide brick codes: range or pack failure")
            state = init_brick_grid(2 * state.capacity, dtype, device)
        raise RuntimeError("wide brick growth did not converge")
    return run


def _hash_engine(window: int) -> Engine:
    def run(t, device, dtype):
        st, stats = map_ping_sequence(
            t.images, t.positions, t.quats, t.cfg, device=device,
            dtype=dtype, backend="hash", window=window,
            state=init_hash_grid(1 << 12, dtype, device),
        )
        return (hash_to_dict(st), *_seq(stats))
    return run


def _dense_engine(t, device, dtype):
    """The mapper's default grid, +-(max_range + 2 m) around the origin.
    A candidate outside it would be dropped (``overflow``) with its whole
    voxel, and the map would no longer be golden's: such a trial fails
    here, naming the cause (no seed of the pinned lists leaves the grid)."""
    spec = default_dense_spec(t.cfg)
    st, stats = map_ping_sequence(
        t.images, t.positions, t.quats, t.cfg, device=device, dtype=dtype,
        backend="dense", dense_spec=spec)
    if int(st.overflow):
        raise AssertionError(f"dense: {int(st.overflow)} candidates leave "
                             f"the default grid {spec.shape}")
    return (dense_to_dict(st, spec), *_seq(stats))


def _mapper_engine(t, device, dtype):
    m = SonarMapper(t.cfg, device=device, dtype=dtype,
                    initial_capacity=1 << 12)
    per = [m.process_sonar_image(*x)
           for x in zip(t.images, t.positions, t.quats)]
    return (brick_to_dict(m.state),
            np.asarray([s["num_occupied"] for s in per]),
            np.asarray([s["num_free"] for s in per]))


def _mesh(device):
    return (device,) * SHARDS


def _brick_sharded_engine(t, device, dtype):
    m = SonarMapper(t.cfg, backend="brick-sharded", mesh=_mesh(device),
                    dtype=dtype, initial_capacity=1 << 12)
    stats = m.map_sequence(t.images, t.positions, t.quats, window=t.n)
    return (sharded_brick_to_dict(m.state), *_seq(stats))


def _sharded_hash_engine(window: int) -> Engine:
    def run(t, device, dtype):
        st, stats = map_ping_sequence_sharded(
            t.images, t.positions, t.quats, t.cfg, mesh=_mesh(device),
            dtype=dtype, window=window, local_capacity=1 << 10)
        return (sharded_hash_to_dict(st), *_seq(stats))
    return run


def _sharded_brick_engine(t, device, dtype):
    st, stats = map_ping_sequence_sharded_brick(
        t.images, t.positions, t.quats, t.cfg, mesh=_mesh(device),
        dtype=dtype, window=t.n, local_capacity=1 << 7)
    return (sharded_brick_to_dict(st), *_seq(stats))


def _multihost_engine(backend: str) -> Engine:
    def run(t, device, dtype):
        st, per = map_ping_sequence_multihost(
            t.images, t.positions, t.quats, t.cfg, n_hosts=2, window=2,
            backend=backend, dtype=dtype, initial_capacity=1 << 12,
            device=device)
        to_dict = brick_to_dict if backend == "brick" else hash_to_dict
        return (to_dict(st), np.asarray([s["num_occupied"] for s in per]),
                np.asarray([s["num_free"] for s in per]))
    return run


# the brick engines: K1 (or K1-raw) applies their windows
BRICK_ENGINES: Dict[str, Engine] = {
    f"brick {mode} w{w}": _brick_engine(w, mode)
    for mode in ("pallas", "pallas-raw") for w in (1, 2)
}
BRICK_ENGINES.update({
    f"brick {mode} w2 rb2 wg2": _brick_engine(2, mode, 2, 2)
    for mode in ("pallas", "pallas-raw")
})
BRICK_ENGINES["brick wide w2"] = _wide_engine(2)

ENGINES: Dict[str, Engine] = dict(BRICK_ENGINES)
ENGINES.update({
    "hash w1": _hash_engine(1),
    "hash w3": _hash_engine(3),
    "dense": _dense_engine,
    "SonarMapper.process_sonar_image": _mapper_engine,
    f"brick-sharded S={SHARDS}": _brick_sharded_engine,
    f"sharded hash w1 S={SHARDS}": _sharded_hash_engine(1),
    f"sharded hash w2 S={SHARDS}": _sharded_hash_engine(2),
    f"sharded brick S={SHARDS}": _sharded_brick_engine,
    "multihost brick": _multihost_engine("brick"),
    "multihost hash": _multihost_engine("hash"),
})


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EngineResult:
    voxels: int
    common: int        # voxels both maps hold
    sym_diff: int      # voxels only one map holds
    max_err: float     # float64: |log-odds|; float32: |probability|
    stats_equal: bool


@dataclasses.dataclass
class TrialResult:
    seed: int
    cfg: MapperConfig
    n: int
    voxels: int
    engines: Dict[str, EngineResult]
    failure: Optional[str] = None   # "<engine>: <what>" on a mismatch

    @property
    def message(self) -> str:
        if self.failure:
            return f"MISMATCH[{self.failure}]"
        return f"ok n={self.n} voxels={self.voxels} engines={len(self.engines)}"

    def repro(self) -> str:
        engine = self.failure.split(":")[0] if self.failure else None
        return (f"repro: seed={self.seed} engine={engine!r} "
                f"config={json.dumps(self.cfg.to_dict(), default=float)}")


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def compare(got: Run, want: Golden, dtype: torch.dtype) -> Tuple[EngineResult, Optional[str]]:
    """An engine's run against golden: (facts, what failed or None)."""
    voxels, occ, free = got
    common = voxels.keys() & want.log_odds.keys()
    sym = len(voxels) + len(want.log_odds) - 2 * len(common)
    keys = list(common)
    a = np.asarray([voxels[k] for k in keys], np.float64)
    b = np.asarray([want.log_odds[k] for k in keys], np.float64)
    stats_equal = (np.array_equal(occ, want.num_occupied)
                   and np.array_equal(free, want.num_free))
    if dtype == torch.float64:
        err = float(np.abs(a - b).max()) if keys else 0.0
        res = EngineResult(len(voxels), len(common), sym, err, stats_equal)
        if sym:
            extra = sorted(voxels.keys() - want.log_odds.keys())[:3]
            missing = sorted(want.log_odds.keys() - voxels.keys())[:3]
            return res, (f"keys: +{len(voxels) - len(common)} "
                         f"-{len(want.log_odds) - len(common)} "
                         f"extra={extra} missing={missing}")
        if err > F64_TOL:
            return res, f"log-odds err {err:.3e} > {F64_TOL}"
        if not stats_equal:
            return res, (f"per-ping stats occupied {occ.tolist()} free "
                         f"{free.tolist()} against golden's "
                         f"{want.num_occupied.tolist()} "
                         f"{want.num_free.tolist()}")
        return res, None
    err = float(np.abs(_sigmoid(a) - _sigmoid(b)).max()) if keys else 0.0
    res = EngineResult(len(voxels), len(common), sym, err, stats_equal)
    if not common:
        return res, "no voxel in common with golden"
    if err > F32_PROB_TOL:
        return res, f"probability err {err:.3e} > {F32_PROB_TOL}"
    return res, None


def run_trial(seed: int, *, device, dtype: torch.dtype) -> TrialResult:
    """Map trial ``seed`` on ``device`` through every engine in float64
    (``ENGINES``), or the brick engines in float32 (``BRICK_ENGINES``),
    and hold each against the port's golden; stops at the first engine
    that fails, an engine that raises included."""
    device = torch.empty(0, device=device).device
    engines = ENGINES if dtype == torch.float64 else BRICK_ENGINES
    t = draw_trial(seed)
    want = golden_of(seed)
    out = TrialResult(seed, t.cfg, t.n, len(want.log_odds), {})
    for label, engine in engines.items():
        try:
            res, failure = compare(engine(t, device, dtype), want, dtype)
        except Exception as e:  # noqa: BLE001 - reported with the repro line
            out.failure = f"{label}: {type(e).__name__}: {e}"
            break
        out.engines[label] = res
        if failure:
            out.failure = f"{label}: {failure}"
            break
    return out


def flip_rate(results: List[TrialResult]) -> Tuple[int, int]:
    """(voxels one map holds, common voxels) summed over trials and
    engines."""
    sym = sum(e.sym_diff for r in results for e in r.engines.values())
    common = sum(e.common for r in results for e in r.engines.values())
    return sym, common


# ---------------------------------------------------------------------------
# Long horizon: float32 against float64 over hundreds of full-size pings
# ---------------------------------------------------------------------------

LONG_PROB_TOL = 1e-5    # the BASELINE bar on probabilities
LONG_MIN_VOXELS = 500_000
LONG_CAPACITY = 1 << 17  # bricks: 200 survey pings never grow it
LONG_WINDOW = 8          # pings a window in both long-horizon checks


def _probabilities(lo: torch.Tensor) -> np.ndarray:
    return _sigmoid(lo.cpu().numpy().astype(np.float64))


def accumulation_drift(images, positions, quats, cfg: MapperConfig,
                       device) -> Dict[str, float]:
    """float32 accumulation against float64 (tests/test_longhorizon.py:57
    in the port): each window's records, computed once in float32 by the
    batched records (``frame_records`` over the window's frames, the form
    ``frame_records_batch`` wraps, with the window's box keys), are
    applied into a float32 and a float64 brick map.  The records are
    integer and dtype-free, so both maps take the same bricks in the same
    slots and differ only in the arithmetic of the adaptive, clamped
    update chain.  Returns the touched voxels and the largest and 99th
    percentile |probability difference| over them; raises where the two
    maps' bricks differ or a window fails."""
    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        _unpack_touched,
        apply_brick_records_compact,
    )
    from sonar_3d_reconstruction_tpu_torch.ops.packing import (
        compute_window_boxes,
    )
    from sonar_3d_reconstruction_tpu_torch.ops.records import (
        frame_records,
        stack_frame_records,
    )

    device = torch.empty(0, device=device).device
    tables = tables_for_images(images, cfg, None)
    T = batched_sonar_to_world(positions, quats, cfg)
    T32 = torch.as_tensor(T, device=device).to(torch.float32)
    images_dev = torch.as_tensor(np.asarray(images), device=device)
    states = {dt: init_brick_grid(LONG_CAPACITY, dt, device)
              for dt in (torch.float32, torch.float64)}
    bb = states[torch.float32].brick_bits
    window = LONG_WINDOW
    box_mins, box_bits = compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, window, bb,
        frame_bits=max(1, (window - 1).bit_length()))
    for w0 in range(0, len(images), window):
        w1 = min(w0 + window, len(images))
        box_min = box_mins[w0 // window]
        recs, auxs = stack_frame_records([frame_records(
            images_dev[w0:w1], T32[w0:w1], tables, cfg,
            torch.as_tensor(box_min, device=device), box_bits, bb,
            dtype=torch.float32)])
        for dt, st in states.items():
            st, stats = apply_brick_records_compact(
                st, recs, auxs, cfg, box_min, box_bits)
            if bool(stats["overflowed"].any()):
                raise RuntimeError(f"window {w0}: the {dt} map overflowed "
                                   f"{LONG_CAPACITY} bricks")
            states[dt] = st
    s32, s64 = states[torch.float32], states[torch.float64]
    if not (torch.equal(s32.key_rows, s64.key_rows)
            and torch.equal(s32.touched, s64.touched)):
        raise AssertionError("the float32 and float64 maps of the same "
                             "records hold different bricks")
    touched = _unpack_touched(s32.touched, s32.brick_volume)
    diff = np.abs(_probabilities(s32.log_odds[touched])
                  - _probabilities(s64.log_odds[touched]))
    return dict(voxels=int(touched.sum()), max_diff=float(diff.max()),
                p99_diff=float(np.percentile(diff, 99)))


def _key_codes(keys: np.ndarray) -> np.ndarray:
    k = keys.astype(np.int64) + (1 << 20)
    return (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]


def geometry_flips(images, positions, quats, cfg: MapperConfig,
                   device) -> Dict[str, float]:
    """Pure float32 against pure float64 (tests/test_longhorizon.py:118 in
    the port): the pings mapped twice through the brick pipeline, geometry
    and map each in its dtype.  A candidate within ~1 ulp of a voxel
    boundary can floor into the neighbour in float32, moving a whole
    update.  Returns the voxels both maps hold, those only one holds, the
    common voxels whose probabilities differ by more than LONG_PROB_TOL
    and the 99.5th percentile of that difference."""
    out = {}
    for dt in (torch.float32, torch.float64):
        st, _ = map_ping_sequence(
            images, positions, quats, cfg, device=device, dtype=dt,
            window=LONG_WINDOW,
            state=init_brick_grid(LONG_CAPACITY, dt, device))
        keys, lo = touched_voxels_brick(st)
        out[dt] = (_key_codes(keys), lo.astype(np.float64))
    (k32, lo32), (k64, lo64) = out[torch.float32], out[torch.float64]
    common, i32, i64 = np.intersect1d(k32, k64, assume_unique=True,
                                      return_indices=True)
    diff = np.abs(_sigmoid(lo32[i32]) - _sigmoid(lo64[i64]))
    return dict(voxels_f32=len(k32), voxels_f64=len(k64),
                common=len(common),
                sym_diff=len(k32) + len(k64) - 2 * len(common),
                over=int((diff > LONG_PROB_TOL).sum()),
                p995_diff=float(np.percentile(diff, 99.5)),
                max_diff=float(diff.max()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_trials", nargs="?", type=int, default=20)
    ap.add_argument("base_seed", nargs="?", type=int, default=1000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    ap.add_argument("--dtype", choices=("float64", "float32"),
                    default="float64")
    args = ap.parse_args(argv)
    device = require_cuda() if args.device is None else args.device
    dtype = getattr(torch, args.dtype)
    results = []
    for seed in range(args.base_seed, args.base_seed + args.n_trials):
        r = run_trial(seed, device=device, dtype=dtype)
        results.append(r)
        print(f"seed {seed}: {r.message}", flush=True)
        if r.failure:
            print("  " + r.repro(), flush=True)
            return 1
    sym, common = flip_rate(results)
    rate = sym / max(1, common)
    print(f"done: {args.n_trials} trials on {torch.empty(0, device=device).device}"
          f" in {args.dtype}, 0 failures; voxels only one map holds "
          f"{sym} of {common} common ({rate:.2e})", flush=True)
    if rate >= FLIP_RATE:
        print(f"  flip rate {rate:.2e} >= {FLIP_RATE}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
