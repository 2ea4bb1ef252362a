"""Time the port's binning kernel K1 (csrc/bin_apply.cu) against other
builds of it, on synthetic and on real windows, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_k1_bench.py [--variant NAME=PATH ...]
        [--e2e PAIRS] [--out FILE]

Every build is timed in the same process, in turns, on the same inputs:
  * ``new``: the package's kernel, with the wrapper's tile (TB), and the
    same kernel at other tiles (``tb1`` .. ``tb8``);
  * ``--variant NAME=PATH``: another source with the package's C
    interface (an edited copy of csrc/bin_apply.cu), built the same way.
Inputs: the synthetic window of each form at the main path's largest
shape (``chip_smoke._synthetic_window``, records spread evenly), and the
real widest window of each dense mode, captured from a run of the
256-ping bench survey (``pipeline.map_ping_sequence``, window 16,
float32) as chip_smoke.py captures it.  Each build is checked bit-equal
to the plain version on every input before it is timed.  Times are
CUDA-event means over back-to-back calls of the wrapper (its host time:
"warm"), and profiler device times per launch with inputs warm in L2 and
after a 128 MiB write that evicts L2 ("cold"), medians over rounds.  The
script also counts the warp-frames the real windows step through (frames
in which some voxel of a 32-voxel warp holds a record) and gives each
call's bytes and memory bound (``chip_smoke.k1_bytes``), with int64 and
with u32 records.  With ``--e2e N`` it maps the survey in both dense
modes N times with each K1 build in turn (``new`` and the first
``--variant``), alternating which goes first.  Results go to stdout and,
as JSON, to ``--out`` when given.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    _bound_ms,
    _device_ms,
    _synthetic_window,
    _time_ms,
    k1_bytes,
    keep_widest_k1_call,
)
from sonar_3d_reconstruction_tpu_torch.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply as k1  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.kernels.build import (  # noqa: E402
    build_shared_library,
)

VOL, O, B = 64, 6, 16
F_BITS = max(1, (B - 1).bit_length())
# the largest window shapes of the bench survey's two dense modes
SYNTHETIC = {False: (7564, 1103100, 60), True: (7564, 3277824, 2)}
KERNEL = "bin_apply_kernel"  # the kernel's name in profiler records
NAMES = ("bin_apply_f32", "bin_apply_f64", "bin_apply_raw_f32",
         "bin_apply_raw_f64")


def _bind(path):
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in NAMES:
        real = ctypes.c_double if name.endswith("f64") else ctypes.c_float
        n_ptr = 8 if "raw" in name else 6
        fn = getattr(lib, name)
        fn.argtypes = ([ptr] * n_ptr + [ctypes.c_longlong] + [i32] * 6
                       + [real, real, i32, real, real, real, real] + [ptr])
        fn.restype = i32
    return lib


def _launcher(lib, tb=None):
    """A replacement for ``k1._launch`` that calls ``lib``, with the
    wrapper's tile unless ``tb`` says."""

    def launch(name, device, tensors, nb, B_, vol, f_bits, o, cfg):
        t = tb or k1.tile_bricks(name.startswith("bin_apply_raw"), B_, vol)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(
            *(x.data_ptr() for x in tensors), tensors[0].shape[0], nb, t, B_,
            vol, f_bits, o, cfg.log_odds_occupied, cfg.log_odds_free,
            int(cfg.adaptive_update), cfg.adaptive_threshold,
            cfg.adaptive_max_ratio, cfg.log_odds_min, cfg.log_odds_max, stream,
        )
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")

    return launch


def build_all(variants):
    """{name: (launch function, ptxas lines)} for every build."""
    path, log = build_shared_library(k1.SOURCE)
    lib = _bind(path)
    out = {"new": (_launcher(lib), log or "(already built)")}
    for tb in (1, 2, 4, 8):
        out[f"tb{tb}"] = (_launcher(lib, tb=tb), "")
    for spec in variants:
        name, src = spec.split("=", 1)
        p, log = build_shared_library(os.path.abspath(src))
        out[name] = (_launcher(_bind(p)), log)
    return out


def capture_real_windows(dev):
    """The widest window (most record lanes) of each dense mode on the
    bench survey: {raw: (s_flat, s_pay, starts, rows)}."""
    from bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, 256)
    widest = {}
    for raw, mode in ((False, "pallas"), (True, "pallas-raw")):
        with keep_widest_k1_call(raw) as kept:
            map_ping_sequence(images, positions, quats, cfg, device=dev,
                              window=16, dtype=torch.float32, dense_mode=mode)
        widest[raw] = kept["args"]
    torch.cuda.synchronize()
    return widest


def synthetic_window(dev, raw):
    nb, n, max_count = SYNTHETIC[raw]
    rng = np.random.default_rng(1 if raw else 0)
    key, pay, starts, rows = _synthetic_window(
        rng, nb, n, B, VOL, O, F_BITS, dup=raw, max_count=max_count
    )
    return tuple(torch.as_tensor(x, device=dev) for x in (key, pay, starts)) + (
        torch.as_tensor(rows, device=dev).float(),)


def window_facts(args, raw):
    """Bytes the call must move, its bound, and the warp-frame fill."""
    s_flat, s_pay, starts, rows = args
    nb = rows.shape[0]
    nbytes, nbytes_u32 = k1_bytes(args, raw, B)
    lane = torch.arange(s_flat.shape[0], device=s_flat.device)
    brick_of = torch.searchsorted(starts, lane, right=True) - 1
    frame = (s_flat >> O) & ((1 << F_BITS) - 1)
    warp = (s_flat & (VOL - 1)) >> 5
    wf = torch.unique((brick_of * B + frame) * (VOL // 32) + warp).numel()
    voxel_frames = torch.unique((brick_of * VOL + (s_flat & (VOL - 1))) * B
                                + frame)
    vf = voxel_frames.numel()
    # frames each voxel steps through if every lane walked its own frames:
    # a warp takes as many steps as its busiest lane
    per_voxel = torch.bincount(voxel_frames // B, minlength=nb * VOL)
    lane_max = per_voxel.reshape(-1, 32).amax(dim=1).sum().item()
    # and with each tile's voxels sorted by their number of frames first
    tvol = k1.tile_bricks(raw, B, VOL) * VOL
    tiles = torch.nn.functional.pad(per_voxel, (0, -per_voxel.numel() % tvol))
    sorted_max = (tiles.reshape(-1, tvol).sort(dim=1).values.reshape(-1, 32)
                  .amax(dim=1).sum().item())
    return {
        "NB": nb, "L": int(s_flat.shape[0]), "bytes": int(nbytes),
        "bound_ms": _bound_ms(nbytes), "bytes_u32_records": int(nbytes_u32),
        "bound_u32_records_ms": _bound_ms(nbytes_u32),
        "warp_frame_fill": wf / (nb * B * VOL // 32),
        "voxel_frame_fill": vf / (nb * B * VOL),
        "lane_max_fill": lane_max / (nb * B * VOL // 32),
        "sorted_max_fill": sorted_max / (nb * B * VOL // 32),
    }


def time_builds(builds, inputs, rounds=3):
    """{input name: {build: {warm_ms, device_ms, cold_device_ms}}}, every
    build checked against the plain version first; builds alternate in
    order."""
    cfg = MapperConfig()
    kw = dict(B=B, vol=VOL, f_bits=F_BITS, o=O, cfg=cfg)
    flush = torch.zeros(32 << 20, dtype=torch.float32, device="cuda")
    orig = k1._launch
    results = {}
    try:
        for in_name, (raw, args) in inputs.items():
            fn = k1.bin_apply_raw if raw else k1.bin_apply
            plain = k1.bin_apply_raw_reference if raw else k1.bin_apply_reference
            for dtype in (torch.float32, torch.float64):
                a = args[:3] + (args[3].to(dtype),)
                w = plain(*a, **kw)
                for b_name, (launch, _) in builds.items():
                    k1._launch = launch
                    got = fn(*a, **kw)
                    torch.cuda.synchronize()
                    if not all(torch.equal(x, y) for x, y in zip(got, w)):
                        raise AssertionError(
                            f"{b_name} != plain on {in_name} ({dtype})")
            samples = {b: {"warm": [], "device": [], "cold": []} for b in builds}
            order = list(builds)
            for r in range(rounds):
                for b_name in (order if r % 2 == 0 else order[::-1]):
                    k1._launch = builds[b_name][0]
                    samples[b_name]["warm"].append(
                        _time_ms(lambda: fn(*args, **kw), reps=50))
                    samples[b_name]["device"].append(
                        _device_ms(lambda: fn(*args, **kw), KERNEL))
                    samples[b_name]["cold"].append(
                        _device_ms(lambda: fn(*args, **kw), KERNEL,
                                   flush=flush))
            results[in_name] = {
                b: {f"{k}_ms" if k != "cold" else "cold_device_ms":
                    statistics.median(v) for k, v in s.items()}
                for b, s in samples.items()
            }
            for b_name, t in results[in_name].items():
                print(f"{in_name:16s} {b_name:10s} warm {t['warm_ms']:.4f} ms"
                      f"  device {t['device_ms']:.4f} ms  cold device "
                      f"{t['cold_device_ms']:.4f} ms", flush=True)
    finally:
        k1._launch = orig
    return results


def e2e(dev, launches, pairs):
    """Walls of the 256-ping survey in both modes, K1 builds in turns."""
    from bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, 256)
    orig = k1._launch
    walls = {m: {b: [] for b in launches} for m in ("pallas", "pallas-raw")}
    try:
        for mode in walls:
            for b_name in launches:  # one warm-up run each
                k1._launch = launches[b_name]
                map_ping_sequence(images, positions, quats, cfg, device=dev,
                                  window=16, dtype=torch.float32,
                                  dense_mode=mode)
            names = list(launches)
            for i in range(pairs):
                for b_name in (names if i % 2 == 0 else names[::-1]):
                    k1._launch = launches[b_name]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    map_ping_sequence(images, positions, quats, cfg,
                                      device=dev, window=16,
                                      dtype=torch.float32, dense_mode=mode)
                    torch.cuda.synchronize()
                    walls[mode][b_name].append(time.perf_counter() - t0)
    finally:
        k1._launch = orig
    return walls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--e2e", type=int, default=0)
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_bench: no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    builds = build_all(args.variant)
    for name, (_, log) in builds.items():
        for ln in log.splitlines():
            if "Used" in ln or "spill" in ln or "Compiling" in ln:
                print(f"[{name}] {ln.strip()}")
    real = capture_real_windows(dev)
    inputs = {
        "synthetic-dedup": (False, synthetic_window(dev, False)),
        "real-dedup": (False, real[False]),
        "synthetic-raw": (True, synthetic_window(dev, True)),
        "real-raw": (True, real[True]),
        # no records: each build's fixed cost per brick
        "empty-dedup": (False, (real[False][0][:0], real[False][1][:0],
                                torch.zeros_like(real[False][2]),
                                real[False][3])),
    }
    facts = {n: window_facts(a, raw) for n, (raw, a) in inputs.items()}
    for n, f in facts.items():
        print(f"{n}: {json.dumps(f)}", flush=True)
    times = time_builds(builds, inputs)
    result = {"device": smi, "tile_threads": k1.TILE_THREADS,
              "windows": facts, "times": times}
    if args.e2e:
        launches = {"new": builds["new"][0]}
        if args.variant:
            other = args.variant[0].split("=", 1)[0]
            launches[other] = builds[other][0]
        walls = e2e(dev, launches, args.e2e)
        result["e2e_walls_s"] = walls
        for mode, per in walls.items():
            for b_name, w in per.items():
                q = statistics.quantiles(w, n=4)
                print(f"e2e {mode:10s} {b_name:8s} median "
                      f"{statistics.median(w):.4f} s (q1-q3 {q[0]:.4f}-"
                      f"{q[2]:.4f}) over {len(w)} runs", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
