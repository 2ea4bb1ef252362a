"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its own line; any failure raises and exits non-zero):

1. build: the CUDA kernels (``csrc/*.cu``) are compiled into
   ``build/kernels/`` at first use, one nvcc per source, all started
   together, and the card's name and power limit are printed as
   ``nvidia-smi`` reports them.
2. main path, full size: the bench survey (``bench.make_inputs``, 256
   pings of 500x512 at the library-default 5 cm voxels) through
   ``pipeline.map_ping_sequence(backend="brick", window=16)`` in float32,
   once cold and once warm; the warm run's K1 launch count must be
   non-zero, no window may overflow, every ping must emit, and the map
   must hold occupied voxels with finite probabilities.  The cold run
   keeps the inputs of its widest window's K1 call (the script wraps
   ``grid.brick.bin_apply``) for phase 3, on the host until then; the warm
   run maps the same windows, and its wall and peak memory carry no such
   copies.
2b. raw path, full size: the same survey with ``dense_mode="pallas-raw"``
   (no per-ping dedup; K1's raw form sums the candidates), cold and warm;
   its raw K1 launch count must be non-zero, and its final map state and
   per-ping stats must equal phase 2's exactly.  Its widest window's
   ``bin_apply_raw`` inputs are kept likewise.
3. kernels: each kernel against its plain PyTorch version on the card, on
   the shapes its path gives it and on edge cases; they must agree
   exactly.  K1 and K1-raw in float32 and float64 on random windows
   (K1-raw with duplicate records: empty window, one brick, a brick whose
   range spans many blocks, large counts; both: NB not a multiple of the
   tile's TB bricks, NB < TB, a hot brick inside a tile of light ones, a
   brick range that starts past the first record and ends before the
   last), at their path's largest window shape, and on the real widest
   window captured in phase 2 / 2b.  K2 (``lookup_accumulate``), driven on
   its own: a chain of 16 dependent calls (the first inserts, the rest
   find and accumulate) at two sizes against the distinct-key plain
   version, with the grouping kernels (``group_records``) against theirs;
   a hot bucket (K2_HOT records of a few keys in one bucket of a
   full-size batch) against the plain version of the kernel's rule and,
   on that bucket, the host-side sequential loop; a full-size batch of
   repeated keys against the plain version and, on a cut, the sequential
   loop; small repeated-key tables, down to one bucket that receives
   every record, against the sequential loop.  K1's
   time is its device time per launch (torch.profiler, which must record
   the launches); K2's is per wrapper call in the chain, with its table
   kernel's device time, each of its kernels' device time and its
   launches per call (profiler) beside it; plain versions are timed with
   CUDA events.
4. cross-check: a small survey mapped on the GPU (kernels) and on the CPU
   (plain versions), in both dense modes, must give equal per-ping stats,
   the same occupied voxels, and probabilities within 1e-5.

The line before the last is a JSON object describing each kernel, with
the bytes each call must move and its bound at the card's published
memory rate (HBM_BYTES_PER_S; for K1 also with u32 records, for K2 with
u32 key words); the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
no CUDA device is visible.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

F32_PROB_TOL = 1e-5   # probability bar of the float32 cross-check
KERNEL_TOL = 0.0      # kernel vs plain version: bit-equal
STATE_FIELDS = ("key_rows", "log_odds", "touched", "min_bounds", "max_bounds",
                "used", "poisoned")
PING_STATS = ("num_occupied", "num_free", "num_candidates", "overflowed")
K2_CHAIN = 16         # dependent calls per K2 run, as scripts/profile_pallas.py
# K2 (records, table slots): scripts/profile_pallas.py's own size, and one
# bench window of unique voxels (16 x 55,077) into 2^22 slots
K2_SIZES = [(131072, 1 << 19), (16 * 55077, 1 << 22)]
K2_HOT = (20000, 400)       # hot-bucket records and their distinct keys
K2_HOT_BUCKET = 7
K2_REPEATED_KEYS = 300000   # distinct keys of the full-size repeated batch
K2_SEQUENTIAL_CUT = 20000   # its records that the host loop checks
# (buckets, records, distinct keys) of small repeated-key tables
K2_SMALL_TABLES = [(64, 3000, 1000), (4, 20000, 3000), (1, 20000, 400)]
# H100 SXM published memory rate (NVIDIA's data sheet).  K1 and K2 are
# bound by their bytes: K1's float work is a few operations per voxel-frame
# it steps (at most NB * B * vol of them) and K2's a sum per record, which
# at the card's 67 TFLOP/s float32 peak take a fraction of the bytes' time.
HBM_BYTES_PER_S = 3.35e12
PROFILE_TRIES = 5     # profiler runs before a kernel with no record fails


def _synthetic_window(rng, nb, n_records, B, vol, o, f_bits, dup=False,
                      max_count=60, hot=None):
    """Sorted (brick, frame, offset) records, unique per slot unless
    ``dup``, with their brick range starts, as numpy arrays.  ``hot``
    names a brick that draws about half of the records."""
    import numpy as np

    if hot is None:
        combos = np.sort(rng.choice(nb * B * vol, size=n_records, replace=dup))
    else:
        w = np.ones(nb)
        w[hot] = nb
        brick = rng.choice(nb, size=n_records, p=w / w.sum())
        combos = brick * B * vol + rng.integers(0, B * vol, size=n_records)
        combos = np.sort(combos if dup else np.unique(combos))
    brick = combos // (B * vol)
    frame = (combos // vol) % B
    off = combos % vol
    key = (brick << (o + f_bits)) | (frame << o) | off
    cnt = rng.integers(1, max_count, size=key.size)
    occ = np.minimum(rng.integers(0, 40, size=key.size), cnt)
    starts = np.searchsorted(brick, np.arange(nb + 1))
    rows = rng.normal(scale=4.0, size=(nb, vol))
    return key, (cnt << 16) | occ, starts, rows


def _time_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _device_ms(fn, kernel_name, reps=20, flush=None):
    """Device time per launch of the kernels named ``kernel_name`` while
    ``fn`` runs ``reps`` times, from torch.profiler, with ``flush`` (a
    tensor larger than L2) rewritten before each call when given.  The
    profiler now and then records no launch in a run: it profiles again,
    and raises after PROFILE_TRIES runs without one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush.add_(1)
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for e in prof.key_averages():
            if kernel_name in e.key:
                total += (getattr(e, "device_time_total", None)
                          or e.cuda_time_total)
                count += e.count
        if count:
            return total / count / 1e3
    raise RuntimeError(f"torch.profiler recorded no {kernel_name} launch in "
                       f"{PROFILE_TRIES} runs")


def _profile_calls(fn, reps=10):
    """({kernel name: (device ms, launches) per call}, kernel launches per
    call as the host issued them (``cudaLaunchKernel`` events)) of ``fn``,
    from torch.profiler over ``reps`` calls.  The profiler now and then
    drops kernel records: it profiles again until it has one kernel for
    each launch, and raises after PROFILE_TRIES runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels, launches, launched = {}, 0, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                t, n = kernels.get(e.name, (0.0, 0))
                kernels[e.name] = (t + e.time_range.elapsed_us() / 1e3 / reps,
                                   n + 1 / reps)
                launched += not e.name.startswith(("Memset", "Memcpy"))
            elif "LaunchKernel" in e.name:
                launches += 1
        if launches and launched == launches:
            return kernels, launches / reps
    raise RuntimeError(f"torch.profiler recorded another number of kernels "
                       f"than of launches in {PROFILE_TRIES} runs")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound_ms(nbytes):
    """Least ms to move ``nbytes`` at the card's published memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def k1_bytes(args, raw, B):
    """Bytes a K1 call on ``args`` (s_flat, s_pay, starts, rows) must move:
    its inputs read once, its outputs (new rows, touched bytes and, raw,
    two (B,) int64 counts) written once.  Also the same with the records
    as the u32 values they carry, the TPU kernel's record streams, in place
    of the port's int64 (half of each record's 16 bytes are zero words)."""
    s_flat, _, _, rows = args
    out = rows.numel() * (rows.element_size() + 1) + (16 * B if raw else 0)
    nbytes = _nbytes(*args) + out
    return nbytes, nbytes - 8 * s_flat.shape[0]


def k2_bytes(khi, klo, upd, key_rows, values):
    """Bytes a K2 call must move: its records and both tables read once,
    both tables written once.  Also the same with every key word as the
    u32 it carries (records and key rows), as the TPU kernel holds them,
    in place of the port's int64."""
    tables = _nbytes(key_rows, values)
    nbytes = _nbytes(khi, klo, upd) + 2 * tables
    return nbytes, nbytes - 4 * (khi.numel() + klo.numel() + 2 * key_rows.numel())


@contextlib.contextmanager
def keep_widest_k1_call(raw):
    """While open, ``grid.brick``'s K1 wrapper of the form ``raw`` also
    keeps copies of the inputs of its call with the most record lanes in
    the dict it yields (``L``: the lanes, ``args``: the inputs)."""
    from sonar_3d_reconstruction_tpu_torch.grid import brick

    name = "bin_apply_raw" if raw else "bin_apply"
    kept = {}
    fn = getattr(brick, name)

    def wrapped(s_flat, s_pay, starts, rows_cur, **kw):
        if s_flat.shape[0] > kept.get("L", -1):
            kept.update(L=s_flat.shape[0], args=tuple(
                t.clone() for t in (s_flat, s_pay, starts, rows_cur)))
        return fn(s_flat, s_pay, starts, rows_cur, **kw)

    setattr(brick, name, wrapped)
    try:
        yield kept
    finally:
        setattr(brick, name, fn)


def _reset_counts():
    from sonar_3d_reconstruction_tpu_torch.kernels import (
        bin_apply,
        lookup_accumulate,
    )

    bin_apply.launches = bin_apply.raw_launches = 0
    lookup_accumulate.launches = 0


def phase_build():
    from sonar_3d_reconstruction_tpu_torch.device import require_cuda
    from sonar_3d_reconstruction_tpu_torch.kernels import (
        bin_apply,
        lookup_accumulate,
    )

    dev = require_cuda()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        logs = list(pool.map(lambda m: m.build(),
                             (bin_apply, lookup_accumulate)))
    ptxas = [ln.strip() for log in logs for ln in log.splitlines()
             if "ptxas info" in ln or "spill" in ln]
    print(f"phase 1 build: bin_apply and lookup_accumulate built in "
          f"{time.perf_counter() - t0:.1f} s"
          + "".join(f"\n  {ln}" for ln in ptxas), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return dev


def phase_main_path(dev, dense_mode):
    """Map the bench survey twice in ``dense_mode``; returns (the warm
    run's K1 launches of that mode, its largest window's shape, the inputs
    of the widest window's K1 call (kept in the cold run), the final
    state, the per-ping stats)."""
    import numpy as np
    import torch

    from bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        extract_occupied_brick,
    )
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    raw = dense_mode == "pallas-raw"
    cfg = MapperConfig()
    n_pings, window = 256, 16
    images, positions, quats = make_inputs(cfg, n_pings)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, stats = map_ping_sequence(
            images, positions, quats, cfg, device=dev, backend="brick",
            window=window, dtype=torch.float32, dense_mode=dense_mode,
        )
        torch.cuda.synchronize()
        return st, stats, time.perf_counter() - t0

    name = "bin_apply_raw" if raw else "bin_apply"
    with keep_widest_k1_call(raw) as kept:
        _, _, cold_s = run()
    # on the host until phase 3, out of the warm run's peak memory
    kept["args"] = tuple(t.cpu() for t in kept["args"])
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    st, stats, wall = run()
    launches, other = bin_apply.launches, bin_apply.raw_launches
    if raw:
        launches, other = other, launches
    peak = torch.cuda.max_memory_allocated(dev)

    if launches == 0:
        raise AssertionError(f"the {dense_mode} path never launched {name}")
    if other != 0:
        raise AssertionError(f"the {dense_mode} path launched the other K1 form")
    if stats["overflowed"].any():
        raise AssertionError(f"a window overflowed on the {dense_mode} path")
    for k in ("num_candidates", "num_occupied", "num_free"):
        if not (stats[k] > 0).all():
            raise AssertionError(f"a ping has zero {k}")
    if bool(st.poisoned) or int(st.used) <= 0:
        raise AssertionError("map state poisoned or empty")
    points, probs = extract_occupied_brick(st, cfg)
    if len(points) == 0 or points.shape[1:] != (3,):
        raise AssertionError(f"no occupied voxels extracted: {points.shape}")
    if not (np.isfinite(points).all() and np.isfinite(probs).all()
            and (probs > cfg.min_probability).all() and (probs <= 1).all()):
        raise AssertionError("extracted voxels not finite or below threshold")
    emissions = int(stats["num_candidates"].sum())
    widest = int(np.argmax(stats["batch_n_lanes"]))
    shape = {
        "n_bricks": int(stats["batch_n_bricks"].max()),
        "n_lanes": int(stats["batch_n_lanes"][
            int(np.argmax(stats["batch_n_bricks"]))
        ]),
        "B": window,
    }
    print(
        f"phase {'2b raw' if raw else '2 main'} path ({dense_mode}): "
        f"{n_pings} pings of {images.shape[1]}x{images.shape[2]}, window "
        f"{window}, float32: wall {wall:.3f} s (cold run {cold_s:.3f} s), "
        f"{n_pings / wall:.1f} pings/s, {emissions / wall / 1e6:.2f} M "
        f"emissions/s ({emissions} emissions), {len(points)} occupied "
        f"voxels, capacity {st.capacity} bricks, peak memory "
        f"{peak / 2**20:.1f} MiB, {name} launches {launches}; windows "
        f"{int(stats['batch_n_lanes'].min())}-"
        f"{int(stats['batch_n_lanes'].max())} lanes, widest NB="
        f"{int(stats['batch_n_bricks'][widest])} L="
        f"{int(stats['batch_n_lanes'][widest])}",
        flush=True,
    )
    if kept.get("L") != int(stats["batch_n_lanes"].max()):
        raise AssertionError("the cold run's widest K1 call was not the "
                             "warm run's widest window")
    return launches, shape, kept["args"], st, stats


def check_raw_equals_dedup(dedup, raw):
    """Phase 2b's map state and per-ping stats against phase 2's."""
    import torch

    (d_st, d_stats), (r_st, r_stats) = dedup, raw
    for k in STATE_FIELDS:
        a, b = getattr(d_st, k), getattr(r_st, k)
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"raw and dedup paths differ in state {k}")
    for k in PING_STATS:
        if not (d_stats[k] == r_stats[k]).all():
            raise AssertionError(f"raw and dedup paths differ in per-ping {k}")
    print(
        f"phase 2b check: raw-path state ({', '.join(STATE_FIELDS)}) "
        f"bit-equal to the dedup path's and per-ping "
        f"{', '.join(PING_STATS)} equal; lanes per window "
        f"{r_stats['batch_n_lanes'].mean():.0f} raw vs "
        f"{d_stats['batch_n_lanes'].mean():.0f} dedup on average",
        flush=True,
    )


def _k1_form(dev, shape, real, raw):
    """One K1 form against its plain version on random windows, at the
    path's largest window shape and on the path's real widest window
    ``real``; returns a dict of the kernel's JSON fields."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply as k1

    kernel, plain = ((k1.bin_apply_raw, k1.bin_apply_raw_reference) if raw
                     else (k1.bin_apply, k1.bin_apply_reference))
    cfg = MapperConfig()
    vol, o = 64, 6
    rng = np.random.default_rng(1 if raw else 0)
    B = shape["B"]
    f_bits = max(1, (B - 1).bit_length())
    tb = k1.tile_bricks(raw, B, vol)
    # (NB, records, largest count, hot brick): random, empty window, one
    # brick, a brick whose range spans many blocks, many empty bricks,
    # large counts, NB not a multiple of TB, NB < TB, a hot brick inside a
    # tile of light ones, and the path's shape
    if raw:
        cases = [(64, 30000, 60, None), (16, 0, 60, None), (1, 700, 60, None),
                 (1, 50000, 60, None), (500, 40, 60, None),
                 (4, 3000, 0xFFFF, None)]
    else:
        cases = [(64, 3000, 60, None), (16, 0, 60, None), (1, 700, 60, None),
                 (3, 3 * B * vol, 60, None), (500, 40, 60, None)]
    cases += [(5 * tb + 1, 4000, 60, None), (max(1, tb - 1), 500, 60, None),
              (4 * tb + 3, 20000 if raw else 8000, 60, 2 * tb + 1),
              (shape["n_bricks"], shape["n_lanes"], 2 if raw else 60, None)]
    kw = dict(B=B, vol=vol, f_bits=f_bits, o=o, cfg=cfg)
    windows = []
    for nb, n, max_count, hot in cases:
        key, pay, starts, rows = _synthetic_window(
            rng, nb, n, B, vol, o, f_bits, dup=raw, max_count=max_count,
            hot=hot,
        )
        windows.append(tuple(torch.as_tensor(x, device=dev)
                             for x in (key, pay, starts))
                       + (torch.as_tensor(rows, device=dev),))
    # bricks 3..60 of the first window over all of its records: a range
    # that starts past lane 0 and ends before the last lane, as one tile's
    s_flat, s_pay, starts, rows = windows[0]
    windows.insert(-1, (s_flat, s_pay, starts[3:62], rows[3:61]))
    windows.append(tuple(t.to(dev) for t in real))
    max_err = 0.0
    for dtype in (torch.float32, torch.float64):
        for w, (s_flat, s_pay, starts, rows) in enumerate(windows):
            args = (s_flat, s_pay, starts, rows.to(dtype))
            got = kernel(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((got[0].double() - want[0].double()).abs().max())
            same = all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
            if err > KERNEL_TOL or not same:
                label = "the real widest window" if w == len(windows) - 1 else (
                    f"NB={rows.shape[0]}, L={s_flat.shape[0]}")
                raise AssertionError(
                    f"{kernel.__name__} != plain ({dtype}, {label}): max "
                    f"|diff| {err}, touched and counts equal {same}"
                )
            max_err = max(max_err, err)

    def f32(w):
        return w[:3] + (w[3].float(),)

    synthetic, real = f32(windows[-2]), f32(windows[-1])
    ms = _device_ms(lambda: kernel(*real, **kw), "bin_apply_kernel")
    synthetic_ms = _device_ms(lambda: kernel(*synthetic, **kw),
                              "bin_apply_kernel")
    plain_ms = _time_ms(lambda: plain(*real, **kw))
    nbytes, nbytes_u32 = k1_bytes(real, raw, B)
    bound_ms, bound_u32_ms = _bound_ms(nbytes), _bound_ms(nbytes_u32)
    n_rows, n_lanes = real[3].shape[0], real[0].shape[0]
    print(
        f"phase 3 kernels: {kernel.__name__} == plain in float32 and float64 "
        f"over {len(windows)} windows each"
        f"{' with duplicate records' if raw else ''} (max |diff| {max_err}, "
        f"tolerance {KERNEL_TOL}), the real widest window included; TB={tb} "
        f"bricks per block; float32 device time per launch: real widest "
        f"window (NB={n_rows}, L={n_lanes}) {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms), synthetic largest window (NB="
        f"{shape['n_bricks']}, L={shape['n_lanes']}, B={B}) "
        f"{synthetic_ms:.4f} ms; bound {bound_ms:.4f} ms ({nbytes} bytes), "
        f"{bound_ms / ms:.1%} of it; with u32 records {bound_u32_ms:.4f} ms "
        f"({nbytes_u32} bytes), {bound_u32_ms / ms:.1%} of it",
        flush=True,
    )
    return dict(max_abs_err=max_err, ms=ms,
                ms_of="device time per launch (torch.profiler)",
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                bytes=nbytes, share_of_bound=bound_ms / ms,
                bound_u32_records_ms=bound_u32_ms,
                share_of_u32_bound=bound_u32_ms / ms,
                synthetic_ms=synthetic_ms, tile_bricks=tb)


def _distinct_keys(rng, u):
    """(khi, klo) numpy int64 arrays of u distinct 48-bit keys."""
    import numpy as np

    pool = np.unique(rng.integers(0, 1 << 48, size=2 * u, dtype=np.int64))
    ks = rng.permutation(pool)[:u]
    if ks.size != u:
        raise AssertionError("not enough distinct keys drawn")
    return ks >> 32, ks & 0xFFFFFFFF


def _k2_tables(cap, dev):
    """An empty K2 table of ``cap`` slots: (key rows, values)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.grid.hash import empty_key_rows

    return (empty_key_rows(cap, dev),
            torch.zeros((cap // 128, 128), dtype=torch.float32, device=dev))


def _k2_call_facts(k2, khi, klo, upd, rows, vals):
    """One K2 call on these inputs: the table kernel's device time, each
    K2 kernel's device time and the kernel launches per call (profiler),
    the bytes and bounds, its share of them, and the bucket segments'
    lengths."""
    def call():
        return k2.lookup_accumulate(khi, klo, upd, rows, vals)

    kernel_ms = _device_ms(call, "lookup_accumulate_kernel")
    kernels, launches = _profile_calls(call)
    by_kernel = {}
    for name, (t, _) in kernels.items():
        short = next((w.split("(")[0] for w in name.split("::")
                      if w.startswith(("k2_", "lookup_accumulate_kernel"))),
                     "other" if "Memset" not in name else "memset")
        by_kernel[short] = by_kernel.get(short, 0.0) + t
    nbytes, nbytes_u32 = k2_bytes(khi, klo, upd, rows, vals)
    _, seg = k2.group_records(khi, klo, upd, rows.shape[0])
    lengths = seg[:, 1]
    return dict(
        kernel_ms=kernel_ms,
        kernel_ms_of="table kernel device time per launch (torch.profiler)",
        launches_per_call=launches, device_ms_by_kernel=by_kernel,
        bound_ms=_bound_ms(nbytes), bound_by="bytes", bytes=nbytes,
        kernel_share_of_bound=_bound_ms(nbytes) / kernel_ms,
        bound_u32_keys_ms=_bound_ms(nbytes_u32), bytes_u32_keys=nbytes_u32,
        kernel_share_of_u32_bound=_bound_ms(nbytes_u32) / kernel_ms,
        segment_max=int(lengths.max()),
        segment_mean=float(lengths.float().mean()),
    )


def _k2_same(got, want):
    import torch

    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _keys_in_bucket(rng, dev, nb, bucket, n):
    """(khi, klo) int64 tensors on ``dev`` of n distinct 48-bit keys whose
    bucket among nb is ``bucket``, drawn on the card from a seed taken
    from ``rng``."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.kernels import lookup_accumulate as k2

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    pool = torch.randint(0, 1 << 48, (3 * n * nb // 2,), generator=gen,
                         device=dev)
    _, ids = k2.bucket_pass_reference(pool >> 32, pool & 0xFFFFFFFF, nb)
    ks = torch.unique(pool[ids == bucket])[:n]
    if ks.numel() != n:
        raise AssertionError(f"only {ks.numel()} keys drawn in bucket {bucket}")
    return ks >> 32, ks & 0xFFFFFFFF


def k2_hot_batch(rng, dev, u, nb):
    """(khi, klo, upd) on ``dev``: K2_HOT records drawn from a few keys of
    bucket K2_HOT_BUCKET, mixed at random among about u minus that many
    records of distinct keys in the other buckets of nb."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.kernels import lookup_accumulate as k2

    n_hot, n_keys = K2_HOT
    hot_hi, hot_lo = _keys_in_bucket(rng, dev, nb, K2_HOT_BUCKET, n_keys)
    pick = torch.as_tensor(rng.integers(0, n_keys, size=n_hot), device=dev)
    o_hi, o_lo = (torch.as_tensor(x, device=dev)
                  for x in _distinct_keys(rng, u - n_hot))
    _, o_ids = k2.bucket_pass_reference(o_hi, o_lo, nb)
    other = o_ids != K2_HOT_BUCKET
    lanes = torch.as_tensor(rng.permutation(n_hot + int(other.sum())),
                            device=dev)
    khi = torch.cat([hot_hi[pick], o_hi[other]])[lanes]
    klo = torch.cat([hot_lo[pick], o_lo[other]])[lanes]
    upd = torch.as_tensor(rng.normal(size=khi.numel()).astype(np.float32),
                          device=dev)
    return khi, klo, upd


def phase_k2(dev):
    """Drive K2 on its own (it has no product path, as in the JAX package):
    chains of dependent calls at the profile script's size and at a
    hash-backend window's size; a hot bucket inside a full-size batch; a
    full-size batch of repeated keys; small repeated-key tables.
    Returns a dict of the kernel's JSON fields at the larger size, the
    other cases' under their own keys."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.kernels import lookup_accumulate as k2

    rng = np.random.default_rng(2)
    launches, max_err, lines, sizes = 0, 0.0, [], []
    for u, cap in K2_SIZES:
        khi, klo = (torch.as_tensor(x, device=dev)
                    for x in _distinct_keys(rng, u))
        upd = torch.as_tensor(rng.normal(size=u).astype(np.float32), device=dev)
        rows0, vals0 = _k2_tables(cap, dev)

        def chain(fn):
            rows, vals = rows0, vals0
            for _ in range(K2_CHAIN):
                rows, vals = fn(khi, klo, upd, rows, vals)
            return rows, vals

        k2.launches = 0
        got = chain(k2.lookup_accumulate)
        torch.cuda.synchronize()
        launches += k2.launches
        if k2.launches != K2_CHAIN:
            raise AssertionError(f"K2 chain launched {k2.launches} times")
        want = chain(k2.lookup_accumulate_reference)
        torch.cuda.synchronize()
        err = float((got[1] - want[1]).abs().max())
        if not (torch.equal(got[0], want[0]) and err <= KERNEL_TOL):
            raise AssertionError(
                f"lookup_accumulate != plain (U={u}, slots={cap}): keys "
                f"equal {torch.equal(got[0], want[0])}, max |diff| {err}"
            )
        n_keys = int((got[0][:, :128] != 0xFFFFFFFF).sum())
        if n_keys != u:
            raise AssertionError(f"{n_keys} keys in the table, not {u}")
        max_err = max(max_err, err)
        # the grouping kernels: the plain grouping's segment lengths and
        # records, in record order once unpacked
        nb = cap // 128
        packed, seg = k2.group_records(khi, klo, upd, nb)
        plain_groups = k2.group_records_reference(khi, klo, upd, nb)
        if not (torch.equal(seg[:, 1], plain_groups[1][:, 1]) and all(
                torch.equal(a, b) for a, b in zip(
                    k2.unpack_records(packed, seg),
                    k2.unpack_records(*plain_groups)))):
            raise AssertionError(f"group_records != plain at U={u}")
        ms = _time_ms(lambda: chain(k2.lookup_accumulate), reps=3) / K2_CHAIN
        plain_ms = _time_ms(
            lambda: chain(k2.lookup_accumulate_reference), reps=3
        ) / K2_CHAIN
        facts = _k2_call_facts(k2, khi, klo, upd, *got)
        sizes.append(dict(
            facts, records=u, slots=cap, ms=ms,
            ms_of="wrapper call in a chain of 16 (CUDA events)",
            plain_ms=plain_ms, share_of_bound=facts["bound_ms"] / ms,
            share_of_u32_bound=facts["bound_u32_keys_ms"] / ms,
        ))
        fill = (got[0][:, :128] != 0xFFFFFFFF).sum(dim=1)
        lines.append(
            f"U={u} into {cap} slots (fullest bucket {int(fill.max())} of "
            f"128; segments of {facts['segment_mean']:.1f} records on "
            f"average, {facts['segment_max']} at most): wrapper {ms:.4f} ms, "
            f"table kernel alone {facts['kernel_ms']:.4f} ms, "
            f"{facts['launches_per_call']:g} kernel launches and "
            f"{sum(facts['device_ms_by_kernel'].values()):.4f} ms of device "
            f"time per call, plain {plain_ms:.4f} ms; bound "
            f"{facts['bound_ms']:.4f} ms ({facts['bytes']} bytes; wrapper "
            f"{facts['bound_ms'] / ms:.1%}, kernel "
            f"{facts['kernel_share_of_bound']:.1%} of it), with u32 keys "
            f"{facts['bound_u32_keys_ms']:.4f} ms ({facts['bytes_u32_keys']} "
            f"bytes)"
        )

    u, cap = K2_SIZES[-1]
    nb = cap // 128
    # a hot bucket: K2_HOT records of few keys in one bucket, among
    # distinct keys in the others; 128 keys insert, their repeats
    # accumulate, the rest drop
    n_hot, n_hot_keys = K2_HOT
    khi, klo, upd = k2_hot_batch(rng, dev, u, nb)
    n_batch = khi.numel()
    _, ids = k2.bucket_pass_reference(khi, klo, nb)
    hot = ids == K2_HOT_BUCKET
    tables = _k2_tables(cap, dev)
    got = want = seq = tables
    for _ in range(2):
        got = k2.lookup_accumulate(khi, klo, upd, *got)
        want = k2.lookup_accumulate_plain(khi, klo, upd, *want)
        seq = k2.lookup_accumulate_sequential(khi[hot], klo[hot], upd[hot],
                                              *seq)
    if not _k2_same(got, want):
        raise AssertionError("lookup_accumulate != plain with a hot bucket")
    b = K2_HOT_BUCKET
    if not (torch.equal(got[0][b], seq[0][b])
            and torch.equal(got[1][b], seq[1][b])):
        raise AssertionError("the hot bucket != the host's sequential loop")
    if int((got[0][b, :128] != 0xFFFFFFFF).sum()) != 128:
        raise AssertionError("the hot bucket is not full")
    hot_facts = _k2_call_facts(k2, khi, klo, upd, *got)
    hot_facts["ms"] = _time_ms(lambda: k2.lookup_accumulate(khi, klo, upd,
                                                            *got))
    hot_facts["ms_of"] = "wrapper call (CUDA events)"

    # repeated keys at full size, against the plain version; the host loop
    # takes a cut
    keys = np.stack(_distinct_keys(rng, K2_REPEATED_KEYS), -1)[
        rng.integers(0, K2_REPEATED_KEYS, size=u)]
    khi, klo = (torch.as_tensor(keys[:, i].copy(), device=dev) for i in (0, 1))
    upd = torch.as_tensor(rng.normal(size=u).astype(np.float32), device=dev)
    got = want = tables
    for _ in range(2):
        got = k2.lookup_accumulate(khi, klo, upd, *got)
        want = k2.lookup_accumulate_plain(khi, klo, upd, *want)
    if not _k2_same(got, want):
        raise AssertionError("lookup_accumulate != plain on repeated keys")
    cut = slice(0, K2_SEQUENTIAL_CUT)
    got_cut = k2.lookup_accumulate(khi[cut], klo[cut], upd[cut], *tables)
    if not _k2_same(got_cut, k2.lookup_accumulate_sequential(
            khi[cut], klo[cut], upd[cut], *tables)):
        raise AssertionError("lookup_accumulate != the sequential loop on "
                             "repeated keys")
    rep_facts = _k2_call_facts(k2, khi, klo, upd, *got)
    rep_facts["ms"] = _time_ms(lambda: k2.lookup_accumulate(khi, klo, upd,
                                                            *got))
    rep_facts["ms_of"] = "wrapper call (CUDA events)"

    # repeated keys in one call: a later record finds the earlier one's
    # slot; small tables, down to one bucket that receives every record
    for nb, n, n_keys in K2_SMALL_TABLES:
        ks = np.stack(_distinct_keys(rng, n_keys), -1)[
            rng.integers(0, n_keys, n)]
        khi, klo = (torch.as_tensor(ks[:, i].copy(), device=dev)
                    for i in (0, 1))
        upd = torch.as_tensor(rng.normal(size=n).astype(np.float32),
                              device=dev)
        got = want = _k2_tables(nb * 128, dev)
        for _ in range(2):
            got = k2.lookup_accumulate(khi, klo, upd, *got)
            want = k2.lookup_accumulate_sequential(khi, klo, upd, *want)
        if not _k2_same(got, want):
            raise AssertionError(f"lookup_accumulate != the sequential loop "
                                 f"on {n} records of {n_keys} keys into "
                                 f"{nb} buckets")
    print(
        f"phase 3 kernels: lookup_accumulate == plain over chains of "
        f"{K2_CHAIN} dependent calls (max |diff| {max_err}, tolerance "
        f"{KERNEL_TOL}; {launches} table-kernel launches), group_records == "
        f"plain; "
        + "; ".join(lines)
        + f"; a hot bucket of {n_hot} records over {n_hot_keys} keys in a "
        f"batch of {n_batch} records "
        f"into {cap} slots == plain (2 calls) and its row == the host's "
        f"sequential loop: wrapper {hot_facts['ms']:.4f} ms, table kernel "
        f"{hot_facts['kernel_ms']:.4f} ms; {u} records over "
        f"{K2_REPEATED_KEYS} keys == plain (2 calls), its first "
        f"{K2_SEQUENTIAL_CUT} == the sequential loop: wrapper "
        f"{rep_facts['ms']:.4f} ms, table kernel {rep_facts['kernel_ms']:.4f}"
        f" ms; 2 calls each of "
        + ", ".join(f"{n} records of {k} keys into {nb} buckets"
                    for nb, n, k in K2_SMALL_TABLES)
        + " == the sequential loop",
        flush=True,
    )
    return dict(sizes[-1], max_abs_err=max_err, chain_launches=launches,
                smaller_size=sizes[0], hot_bucket=hot_facts,
                repeated_keys=rep_facts)


def phase_cross_check(dev):
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        extract_occupied_brick,
    )
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    cfg = MapperConfig(
        image_width=64, image_height=100, max_range=5.0, min_range=0.5,
        voxel_resolution=0.1, intensity_threshold=30,
    )
    n = 12
    rng = np.random.default_rng(7)
    images = rng.integers(0, 20, size=(n, 100, 64)).astype(np.uint8)
    for img in images:
        for _ in range(3):
            r0, b0 = rng.integers(0, 90), rng.integers(0, 56)
            img[r0:r0 + rng.integers(2, 10), b0:b0 + rng.integers(2, 8)] = (
                rng.integers(80, 220)
            )
    ts = np.linspace(0, 2 * np.pi, n, endpoint=False)
    positions = np.stack([0.8 * np.cos(ts), 0.8 * np.sin(ts), 0 * ts], -1)
    yaw = ts + np.pi / 2
    quats = np.stack([0 * ts, 0 * ts, np.sin(yaw / 2), np.cos(yaw / 2)], -1)

    for mode in ("pallas", "pallas-raw"):
        out = {}
        for name, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
            st, stats = map_ping_sequence(
                images, positions, quats, cfg, device=device, window=4,
                dtype=torch.float32, dense_mode=mode,
            )
            out[name] = (stats, *extract_occupied_brick(st, cfg))
        (g_stats, g_pts, g_pr), (c_stats, c_pts, c_pr) = out["gpu"], out["cpu"]
        for k in PING_STATS:
            if not np.array_equal(g_stats[k], c_stats[k]):
                raise AssertionError(f"GPU and CPU per-ping {k} differ ({mode})")
        g = {tuple(p): q for p, q in zip(g_pts.round(6), g_pr)}
        c = {tuple(p): q for p, q in zip(c_pts.round(6), c_pr)}
        if g.keys() != c.keys() or not g:
            raise AssertionError(
                f"occupied voxel sets differ ({mode}): {len(g)} on GPU, "
                f"{len(c)} on CPU"
            )
        diff = max(abs(g[k] - c[k]) for k in g)
        if diff > F32_PROB_TOL:
            raise AssertionError(f"probabilities differ by {diff} ({mode})")
        print(
            f"phase 4 cross-check ({mode}): {n} pings at 100x64, float32, GPU "
            f"kernel vs CPU plain: per-ping stats equal, {len(g)} occupied "
            f"voxels equal, max probability diff {diff:.3g} (tolerance "
            f"{F32_PROB_TOL})",
            flush=True,
        )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    dev = phase_build()
    k1_launches, k1_shape, k1_real, *dedup = phase_main_path(dev, "pallas")
    raw_launches, raw_shape, raw_real, *raw = phase_main_path(
        dev, "pallas-raw")
    check_raw_equals_dedup(dedup, raw)
    del dedup, raw
    k1 = _k1_form(dev, k1_shape, k1_real, raw=False)
    k1_raw = _k1_form(dev, raw_shape, raw_real, raw=True)
    del k1_real, raw_real
    k2 = phase_k2(dev)
    phase_cross_check(dev)

    bin_src = "sonar_3d_reconstruction_tpu_torch/csrc/bin_apply.cu"
    bin_tpu = "sonar_3d_reconstruction_tpu/pallas/bin_kernel.py:61"
    # launches: the warm main-path run's (K2 has no product path; the
    # launches of its chains are listed apart)
    rows = [
        ("bin_apply", bin_src, bin_tpu, k1_launches, k1),
        ("bin_apply_raw", bin_src, bin_tpu, raw_launches, k1_raw),
        ("lookup_accumulate",
         "sonar_3d_reconstruction_tpu_torch/csrc/lookup_accumulate.cu",
         "sonar_3d_reconstruction_tpu/pallas/table_kernel.py:51", 0, k2),
    ]
    print(json.dumps({"kernels": [dict(
        name=name,
        route="cuda",
        source=source,
        replaces=replaces,
        launches=launches,
        library_ms=None,  # no single PyTorch call computes the function
        **fields,
    ) for name, source, replaces, launches, fields in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
