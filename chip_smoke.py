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
   find and accumulate) at two sizes, and a duplicate-key batch against
   the host-side sequential loop.  K1's time is its device time per launch
   (torch.profiler, which must record the launches); K2's is per wrapper
   call in the chain, and its kernel's device time beside it; plain
   versions are timed with CUDA events.
4. cross-check: a small survey mapped on the GPU (kernels) and on the CPU
   (plain versions), in both dense modes, must give equal per-ping stats,
   the same occupied voxels, and probabilities within 1e-5.

The line before the last is a JSON object describing each kernel, with
the bytes each call must move and its bound at the card's published
memory rate (HBM_BYTES_PER_S; for K1 also with u32 records); the last
line is
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


def phase_k2(dev):
    """Drive K2 on its own (it has no product path, as in the JAX package):
    chains of dependent calls at the profile script's size and at a
    hash-backend window's size, then a duplicate-key batch.  Returns a
    dict of the kernel's JSON fields at the larger size."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.grid.hash import empty_key_rows
    from sonar_3d_reconstruction_tpu_torch.kernels import lookup_accumulate as k2

    rng = np.random.default_rng(2)
    launches, max_err, lines, timed = 0, 0.0, [], None
    for u, cap in K2_SIZES:
        khi, klo = (torch.as_tensor(x, device=dev)
                    for x in _distinct_keys(rng, u))
        upd = torch.as_tensor(rng.normal(size=u).astype(np.float32), device=dev)
        rows0 = empty_key_rows(cap, dev)
        vals0 = torch.zeros((cap // 128, 128), dtype=torch.float32, device=dev)

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
        ms = _time_ms(lambda: chain(k2.lookup_accumulate), reps=3) / K2_CHAIN
        plain_ms = _time_ms(
            lambda: chain(k2.lookup_accumulate_reference), reps=3
        ) / K2_CHAIN
        kernel_ms = _device_ms(
            lambda: k2.lookup_accumulate(khi, klo, upd, *got),
            "lookup_accumulate_kernel",
        )
        # one call reads its records and both tables and writes the tables
        nbytes = _nbytes(khi, klo, upd, rows0, vals0, *got)
        bound_ms = _bound_ms(nbytes)
        timed = dict(ms=ms, ms_of="wrapper call in a chain (CUDA events)",
                     plain_ms=plain_ms, kernel_ms=kernel_ms,
                     bound_ms=bound_ms, bound_by="bytes", bytes=nbytes,
                     share_of_bound=bound_ms / ms)
        fill = (got[0][:, :128] != 0xFFFFFFFF).sum(dim=1)
        lines.append(
            f"U={u} into {cap} slots (fullest bucket {int(fill.max())} of "
            f"128): wrapper {ms:.4f} ms, kernel alone {kernel_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms per call; bound {bound_ms:.4f} ms "
            f"({nbytes} bytes)"
        )

    # repeated keys in one call: a later record finds the earlier one's slot
    ks = np.stack(_distinct_keys(rng, 1000), -1)[rng.integers(0, 1000, 3000)]
    khi, klo = (torch.as_tensor(ks[:, i].copy(), device=dev) for i in (0, 1))
    upd = torch.as_tensor(rng.normal(size=3000).astype(np.float32), device=dev)
    rows = empty_key_rows(64 * 128, dev)
    vals = torch.zeros((64, 128), dtype=torch.float32, device=dev)
    got = want = (rows, vals)
    for _ in range(2):
        got = k2.lookup_accumulate(khi, klo, upd, *got)
        want = k2.lookup_accumulate_sequential(khi, klo, upd, *want)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("lookup_accumulate != the sequential loop on "
                             "duplicate keys")
    print(
        f"phase 3 kernels: lookup_accumulate == plain over chains of "
        f"{K2_CHAIN} dependent calls (max |diff| {max_err}, tolerance "
        f"{KERNEL_TOL}; {launches} kernel launches); "
        + "; ".join(lines)
        + "; 2 calls of 3000 records over 1000 repeated keys == the host's "
        "sequential loop",
        flush=True,
    )
    return dict(timed, max_abs_err=max_err, chain_launches=launches)


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
