"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its own line; any failure raises and exits non-zero):

1. build: the CUDA kernels of the main path are compiled from ``csrc/``
   into ``build/kernels/`` (first use), and the card's name and power
   limit are printed as ``nvidia-smi`` reports them.
2. main path, full size: the bench survey (``bench.make_inputs``, 256
   pings of 500x512 at the library-default 5 cm voxels) through
   ``pipeline.map_ping_sequence(backend="brick", window=16)`` in float32,
   once cold and once warm; the warm run's kernel launch counts must be
   non-zero, no window may overflow, every ping must emit, and the map
   must hold occupied voxels with finite probabilities.
3. kernels: each kernel against its plain PyTorch version on the card, in
   float32 and float64, on random windows, edge cases (empty bricks, one
   brick, ranges longer than a block) and one window at the main path's
   largest window shape; they must agree exactly.  Both are timed at that
   shape with CUDA events.
4. cross-check: a small survey mapped on the GPU (kernel) and on the CPU
   (plain version) must give equal per-ping stats, the same occupied
   voxels, and probabilities within 1e-5.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero without a
result when no CUDA device is visible.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

F32_PROB_TOL = 1e-5   # probability bar of the float32 cross-check
KERNEL_TOL = 0.0      # kernel vs plain version: bit-equal


def _synthetic_window(rng, nb, n_records, B, vol, o, f_bits):
    """Sorted (brick, frame, offset) records, unique per slot, with their
    brick range starts, as numpy arrays."""
    import numpy as np

    combos = np.sort(rng.choice(nb * B * vol, size=n_records, replace=False))
    brick = combos // (B * vol)
    frame = (combos // vol) % B
    off = combos % vol
    key = (brick << (o + f_bits)) | (frame << o) | off
    cnt = rng.integers(1, 60, size=n_records)
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


def phase_build():
    from sonar_3d_reconstruction_tpu_torch.device import require_cuda
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply

    dev = require_cuda()
    t0 = time.perf_counter()
    log = bin_apply.build()
    ptxas = [ln.strip() for ln in log.splitlines() if "ptxas info" in ln]
    print(f"phase 1 build: bin_apply built in {time.perf_counter() - t0:.1f} s"
          + "".join(f"\n  {ln}" for ln in ptxas), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return dev


def phase_main_path(dev):
    import numpy as np
    import torch

    from bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        extract_occupied_brick,
    )
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    cfg = MapperConfig()
    n_pings, window = 256, 16
    images, positions, quats = make_inputs(cfg, n_pings)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, stats = map_ping_sequence(
            images, positions, quats, cfg, device=dev, backend="brick",
            window=window, dtype=torch.float32,
        )
        torch.cuda.synchronize()
        return st, stats, time.perf_counter() - t0

    _, _, cold_s = run()
    torch.cuda.reset_peak_memory_stats(dev)
    bin_apply.launches = 0
    st, stats, wall = run()
    launches = bin_apply.launches
    peak = torch.cuda.max_memory_allocated(dev)

    if launches == 0:
        raise AssertionError("the main path never launched bin_apply")
    if stats["overflowed"].any():
        raise AssertionError("a window overflowed on the main path")
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
    print(
        f"phase 2 main path: {n_pings} pings of {images.shape[1]}x"
        f"{images.shape[2]}, window {window}, float32: wall {wall:.3f} s "
        f"(cold run {cold_s:.3f} s), {n_pings / wall:.1f} pings/s, "
        f"{emissions / wall / 1e6:.2f} M emissions/s ({emissions} emissions), "
        f"{len(points)} occupied voxels, capacity {st.capacity} bricks, "
        f"peak memory {peak / 2**20:.1f} MiB, bin_apply launches {launches}",
        flush=True,
    )
    shape = {
        "n_bricks": int(stats["batch_n_bricks"].max()),
        "n_lanes": int(stats["batch_n_lanes"][
            int(np.argmax(stats["batch_n_bricks"]))
        ]),
        "B": window,
    }
    return launches, shape


def phase_kernels(dev, shape):
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.kernels.bin_apply import (
        bin_apply,
        bin_apply_reference,
    )

    cfg = MapperConfig()
    vol, o = 64, 6
    rng = np.random.default_rng(0)
    B = shape["B"]
    f_bits = max(1, (B - 1).bit_length())
    # (NB, records): random, empty window, one brick, a brick whose range
    # spans many blocks, many empty bricks, and the main path's shape
    cases = [(64, 3000), (16, 0), (1, 700), (3, 3 * B * vol),
             (500, 40), (shape["n_bricks"], shape["n_lanes"])]
    max_err = 0.0
    timed = None
    for dtype in (torch.float32, torch.float64):
        for nb, n in cases:
            key, pay, starts, rows = _synthetic_window(
                rng, nb, n, B, vol, o, f_bits
            )
            args = [
                torch.as_tensor(key, device=dev),
                torch.as_tensor(pay, device=dev),
                torch.as_tensor(starts, device=dev),
                torch.as_tensor(rows, device=dev).to(dtype),
            ]
            kw = dict(B=B, vol=vol, f_bits=f_bits, o=o, cfg=cfg)
            v, upd = bin_apply(*args, **kw)
            v_ref, upd_ref = bin_apply_reference(*args, **kw)
            torch.cuda.synchronize()
            err = float((v.double() - v_ref.double()).abs().max())
            if err > KERNEL_TOL or not torch.equal(upd, upd_ref):
                raise AssertionError(
                    f"bin_apply != plain ({dtype}, NB={nb}, L={n}): "
                    f"max |diff| {err}, touched equal {torch.equal(upd, upd_ref)}"
                )
            max_err = max(max_err, err)
            if dtype == torch.float32 and (nb, n) == cases[-1]:
                timed = (
                    _time_ms(lambda: bin_apply(*args, **kw)),
                    _time_ms(lambda: bin_apply_reference(*args, **kw)),
                )
    ms, plain_ms = timed
    print(
        f"phase 3 kernels: bin_apply == plain in float32 and float64 over "
        f"{len(cases)} windows each (max |diff| {max_err}, tolerance "
        f"{KERNEL_TOL}); at the main path's largest window (NB="
        f"{shape['n_bricks']}, L={shape['n_lanes']}, B={B}, float32): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
        flush=True,
    )
    return max_err, ms, plain_ms


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

    out = {}
    for name, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
        st, stats = map_ping_sequence(
            images, positions, quats, cfg, device=device, window=4,
            dtype=torch.float32,
        )
        out[name] = (stats, *extract_occupied_brick(st, cfg))
    (g_stats, g_pts, g_pr), (c_stats, c_pts, c_pr) = out["gpu"], out["cpu"]
    for k in ("num_occupied", "num_free", "num_candidates", "overflowed"):
        if not np.array_equal(g_stats[k], c_stats[k]):
            raise AssertionError(f"GPU and CPU per-ping {k} differ")
    g = {tuple(p): q for p, q in zip(g_pts.round(6), g_pr)}
    c = {tuple(p): q for p, q in zip(c_pts.round(6), c_pr)}
    if g.keys() != c.keys() or not g:
        raise AssertionError(
            f"occupied voxel sets differ: {len(g)} on GPU, {len(c)} on CPU"
        )
    diff = max(abs(g[k] - c[k]) for k in g)
    if diff > F32_PROB_TOL:
        raise AssertionError(f"probabilities differ by {diff}")
    print(
        f"phase 4 cross-check: {n} pings at 100x64, float32, GPU kernel vs "
        f"CPU plain: per-ping stats equal, {len(g)} occupied voxels equal, "
        f"max probability diff {diff:.3g} (tolerance {F32_PROB_TOL})",
        flush=True,
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    dev = phase_build()
    launches, shape = phase_main_path(dev)
    max_err, ms, plain_ms = phase_kernels(dev, shape)
    phase_cross_check(dev)
    print(json.dumps({"kernels": [{
        "name": "bin_apply",
        "route": "cuda",
        "source": "sonar_3d_reconstruction_tpu_torch/csrc/bin_apply.cu",
        "replaces": "sonar_3d_reconstruction_tpu/pallas/bin_kernel.py:61",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
