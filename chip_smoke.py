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
   must hold occupied voxels with finite probabilities.
2b. raw path, full size: the same survey with ``dense_mode="pallas-raw"``
   (no per-ping dedup; K1's raw form sums the candidates), cold and warm;
   its raw K1 launch count must be non-zero, and its final map state and
   per-ping stats must equal phase 2's exactly.
3. kernels: each kernel against its plain PyTorch version on the card, on
   the shapes its path gives it and on edge cases; they must agree
   exactly.  K1 and K1-raw in float32 and float64 on random windows
   (K1-raw with duplicate records: empty window, one brick, a brick whose
   range spans many blocks, large counts) and at their path's largest
   window.  K2 (``lookup_accumulate``), driven on its own: a chain of 16
   dependent calls (the first inserts, the rest find and accumulate) at
   two sizes, and a duplicate-key batch against the host-side sequential
   loop.  Kernel and plain version are timed with CUDA events.
4. cross-check: a small survey mapped on the GPU (kernels) and on the CPU
   (plain versions), in both dense modes, must give equal per-ping stats,
   the same occupied voxels, and probabilities within 1e-5.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero without a
result when no CUDA device is visible.
"""

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


def _synthetic_window(rng, nb, n_records, B, vol, o, f_bits, dup=False,
                      max_count=60):
    """Sorted (brick, frame, offset) records, unique per slot unless
    ``dup``, with their brick range starts, as numpy arrays."""
    import numpy as np

    combos = np.sort(rng.choice(nb * B * vol, size=n_records, replace=dup))
    brick = combos // (B * vol)
    frame = (combos // vol) % B
    off = combos % vol
    key = (brick << (o + f_bits)) | (frame << o) | off
    cnt = rng.integers(1, max_count, size=n_records)
    occ = np.minimum(rng.integers(0, 40, size=n_records), cnt)
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
             if "ptxas info" in ln]
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
    run's K1 launches of that mode, its largest window's shape, the final
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

    _, _, cold_s = run()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    st, stats, wall = run()
    launches, other = bin_apply.launches, bin_apply.raw_launches
    if raw:
        launches, other = other, launches
    peak = torch.cuda.max_memory_allocated(dev)

    name = "bin_apply_raw" if raw else "bin_apply"
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
    return launches, shape, st, stats


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


def _k1_form(dev, shape, raw):
    """One K1 form against its plain version on random windows and at the
    path's largest window; returns (max |diff|, kernel ms, plain ms)."""
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
    # (NB, records, largest count): random, empty window, one brick, a
    # brick whose range spans many blocks, many empty bricks, large counts,
    # and the path's shape
    if raw:
        cases = [(64, 30000, 60), (16, 0, 60), (1, 700, 60),
                 (1, 50000, 60), (500, 40, 60), (4, 3000, 0xFFFF),
                 (shape["n_bricks"], shape["n_lanes"], 2)]
    else:
        cases = [(64, 3000, 60), (16, 0, 60), (1, 700, 60),
                 (3, 3 * B * vol, 60), (500, 40, 60),
                 (shape["n_bricks"], shape["n_lanes"], 60)]
    max_err = 0.0
    timed = None
    for dtype in (torch.float32, torch.float64):
        for nb, n, max_count in cases:
            key, pay, starts, rows = _synthetic_window(
                rng, nb, n, B, vol, o, f_bits, dup=raw, max_count=max_count
            )
            args = [
                torch.as_tensor(key, device=dev),
                torch.as_tensor(pay, device=dev),
                torch.as_tensor(starts, device=dev),
                torch.as_tensor(rows, device=dev).to(dtype),
            ]
            kw = dict(B=B, vol=vol, f_bits=f_bits, o=o, cfg=cfg)
            got = kernel(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((got[0].double() - want[0].double()).abs().max())
            same = all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
            if err > KERNEL_TOL or not same:
                raise AssertionError(
                    f"{kernel.__name__} != plain ({dtype}, NB={nb}, L={n}): "
                    f"max |diff| {err}, touched and counts equal {same}"
                )
            max_err = max(max_err, err)
            if dtype == torch.float32 and (nb, n, max_count) == cases[-1]:
                timed = (
                    _time_ms(lambda: kernel(*args, **kw)),
                    _time_ms(lambda: plain(*args, **kw)),
                )
    ms, plain_ms = timed
    print(
        f"phase 3 kernels: {kernel.__name__} == plain in float32 and float64 "
        f"over {len(cases)} windows each"
        f"{' with duplicate records' if raw else ''} (max |diff| {max_err}, "
        f"tolerance {KERNEL_TOL}); at the path's largest window (NB="
        f"{shape['n_bricks']}, L={shape['n_lanes']}, B={B}, float32): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
        flush=True,
    )
    return max_err, ms, plain_ms


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
    hash-backend window's size, then a duplicate-key batch.  Returns
    (launches of the chain runs, max |diff|, kernel ms, plain ms) at the
    larger size."""
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
        timed = (ms, plain_ms)
        fill = (got[0][:, :128] != 0xFFFFFFFF).sum(dim=1)
        lines.append(
            f"U={u} into {cap} slots (fullest bucket {int(fill.max())} of "
            f"128): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call"
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
    return launches, max_err, *timed


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
    k1_launches, k1_shape, *dedup = phase_main_path(dev, "pallas")
    raw_launches, raw_shape, *raw = phase_main_path(dev, "pallas-raw")
    check_raw_equals_dedup(dedup, raw)
    del dedup, raw
    k1 = _k1_form(dev, k1_shape, raw=False)
    k1_raw = _k1_form(dev, raw_shape, raw=True)
    k2_launches, *k2 = phase_k2(dev)
    phase_cross_check(dev)

    bin_src = "sonar_3d_reconstruction_tpu_torch/csrc/bin_apply.cu"
    bin_tpu = "sonar_3d_reconstruction_tpu/pallas/bin_kernel.py:61"
    rows = [
        ("bin_apply", bin_src, bin_tpu, k1_launches, k1),
        ("bin_apply_raw", bin_src, bin_tpu, raw_launches, k1_raw),
        ("lookup_accumulate",
         "sonar_3d_reconstruction_tpu_torch/csrc/lookup_accumulate.cu",
         "sonar_3d_reconstruction_tpu/pallas/table_kernel.py:51",
         k2_launches, k2),
    ]
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    } for name, source, replaces, launches, (err, ms, plain_ms) in rows]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
