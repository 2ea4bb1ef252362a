"""Device trace of the port's bench step (PyTorch port of
``scripts/profile_trace_brick.py`` with ``profile_trace.py``'s top-ops and
line-occupancy readers).

Builds the bench's exact capture configuration through
``sonar_3d_reconstruction_tpu_torch.bench.Capture`` (the plan or its
discovery, ``BENCH_DENSE_MODE``, ``BENCH_RECORDS_BATCH`` and every other
``BENCH_*`` knob the bench reads), settles its budgets with the first
scan, times ``BENCH_REPS`` scans untraced, then profiles one more scan
under ``utils.profiling.device_trace`` and reads the Chrome trace that it
wrote.  It prints, on earlier lines, the top device kernels by total time,
each CUDA stream's kernel count, busy time and span, and then one JSON
line last:

- ``kernel_launches`` (``cudaLaunchKernel`` events), ``launches_per_ping``
  and ``syncs_per_run`` (``cudaStreamSynchronize`` events);
- ``busy_share``: the union of the kernel intervals over the untraced
  scan's wall (the best of the timed scans), and ``busy_share_traced``
  over the traced scan's own wall.  Where the trace holds fewer kernel
  events than launches, the profiler dropped kernels: both are null and
  ``busy_share_note`` says so;
- the top kernels, the card's name and power limit, the capture's budgets
  and the K1 and K1-raw launches of the traced scan.

Usage (from the root of a checkout; one process a trace, as the profiler
records fewer kernels the longer a process profiles):

    python3 scripts/torch_profile_bench.py [--device cpu] [--out DIR] [--top N]
    BENCH_RECORDS_BATCH=16 python3 scripts/torch_profile_bench.py

The trace goes to ``--out`` (default ``build/bench_trace``).  On a CPU
run (``--device cpu``, e.g. with ``BENCH_PINGS=2``) the trace holds no
kernel and the busy share is null.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def read_events(path: str) -> List[dict]:
    """The complete ("X") events of a Chrome trace file."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def top_kernels(events: List[dict], top: int) -> List[Tuple[str, float, int]]:
    """(kernel name, total us, launches) of the ``top`` kernels by total
    device time."""
    total: Dict[str, List[float]] = {}
    for e in events:
        if e.get("cat") == "kernel":
            t = total.setdefault(e["name"], [0.0, 0])
            t[0] += float(e["dur"])
            t[1] += 1
    ranked = sorted(total.items(), key=lambda kv: -kv[1][0])[:top]
    return [(name, us, int(n)) for name, (us, n) in ranked]


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def stream_lines(events: List[dict]) -> List[Tuple[str, int, float, float]]:
    """Per CUDA stream: (name, kernels, busy us (their union), span us
    (first start to last end)), the counterpart of the TPU trace's line
    occupancy."""
    by_line: Dict[str, List[Tuple[float, float]]] = {}
    for e in events:
        if e.get("cat") == "kernel":
            line = f"device {e.get('pid')} stream {e.get('tid')}"
            ts = float(e["ts"])
            by_line.setdefault(line, []).append((ts, ts + float(e["dur"])))
    return [(line, len(iv), union_us(iv),
             max(b for _, b in iv) - min(a for a, _ in iv))
            for line, iv in sorted(by_line.items())]


def launch_counts(events: List[dict]) -> Tuple[int, int, int]:
    """(kernel events, kernel launches, stream synchronisations): the
    launches and syncs are the CUDA API calls the host made."""
    kernels = launches = syncs = 0
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "kernel":
            kernels += 1
        elif cat in ("cuda_runtime", "cuda_driver"):
            launches += "LaunchKernel" in name
            syncs += "StreamSynchronize" in name
    return kernels, launches, syncs


def summarize(events: List[dict], wall_s: float, traced_wall_s: float,
              n_pings: int, top: int) -> dict:
    """The trace's figures for the JSON line (times in ms)."""
    kernels, launches, syncs = launch_counts(events)
    busy_us = union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in events if e.get("cat") == "kernel")
    copy_us = sum(float(e["dur"]) for e in events
                  if e.get("cat") in ("gpu_memcpy", "gpu_memset"))
    out = dict(
        kernels_recorded=kernels,
        kernel_launches=launches,
        launches_per_ping=launches / n_pings,
        syncs_per_run=syncs,
        kernel_busy_ms=busy_us / 1e3,
        copy_ms=copy_us / 1e3,
        busy_share=None,
        busy_share_traced=None,
        busy_share_note=None,
        top_kernels=[dict(name=name, ms=us / 1e3, launches=n)
                     for name, us, n in top_kernels(events, top)],
    )
    if not launches:
        out["busy_share_note"] = "the trace holds no kernel launch"
    elif kernels < launches:
        out["busy_share_note"] = (
            f"the profiler dropped kernel records: {kernels} kernel events "
            f"against {launches} launches")
    else:
        out["busy_share"] = busy_us / 1e6 / wall_s
        out["busy_share_traced"] = busy_us / 1e6 / traced_wall_s
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA "
                        "device, required; 'cpu' runs on the CPU)")
    parser.add_argument("--out", default=os.path.join(ROOT, "build",
                                                      "bench_trace"),
                        help="directory the trace is written into")
    parser.add_argument("--top", type=int, default=15,
                        help="kernels listed by total device time")
    args = parser.parse_args(argv)

    import torch

    from sonar_3d_reconstruction_tpu_torch import bench
    from sonar_3d_reconstruction_tpu_torch.device import require_cuda
    from sonar_3d_reconstruction_tpu_torch.utils.profiling import device_trace

    device = (require_cuda() if args.device is None
              else torch.empty(0, device=args.device).device)
    run = bench._Run(float("inf"))
    cap = bench.Capture(run, device, os.environ)
    cap.warm()
    print(f"capture: {cap.n_pings} pings, window {cap.window}, "
          f"{cap.backend}, dense_mode {cap.dense_mode}, records_batch "
          f"{cap.records_batch}, budgets {cap.budget_plan or 'count-sized'}"
          f" ({cap.budget_detail()})", flush=True)

    def timed(rep):
        bench._sync(device)
        t0 = time.perf_counter()
        cap.run(rep)
        return time.perf_counter() - t0

    wall_s = min(timed(rep) for rep in range(1, cap.reps + 1))
    os.makedirs(args.out, exist_ok=True)
    before = set(os.listdir(args.out))
    k1_before = bench.k1_launches()
    bench._sync(device)
    with device_trace(args.out):
        traced_wall_s = timed(cap.reps + 1)
    k1, k1_raw = (b - a for a, b in zip(k1_before, bench.k1_launches()))
    written = sorted(f for f in set(os.listdir(args.out)) - before
                     if f.endswith(".json"))
    if not written:
        raise RuntimeError(f"device_trace wrote no trace into {args.out}")
    path = os.path.join(args.out, written[-1])
    events = read_events(path)
    facts = summarize(events, wall_s, traced_wall_s, cap.n_pings, args.top)

    print(f"untraced scan {wall_s * 1e3:.1f} ms (best of {cap.reps}), "
          f"traced scan {traced_wall_s * 1e3:.1f} ms; trace {path}",
          flush=True)
    print("top device kernels by total time:", flush=True)
    for k in facts["top_kernels"]:
        print(f"  {k['ms']:10.3f} ms  {k['launches']:7d}x  {k['name'][:100]}",
              flush=True)
    print("CUDA streams:", flush=True)
    for line, n, busy, span in stream_lines(events):
        print(f"  {line:28s} kernels={n:7d} busy={busy / 1e3:9.3f} ms "
              f"span={span / 1e3:9.3f} ms "
              f"occ={100.0 * busy / span if span else 0.0:5.1f}%", flush=True)
    share = facts["busy_share"]
    print(f"{facts['kernels_recorded']} kernel events, "
          f"{facts['kernel_launches']} launches "
          f"({facts['launches_per_ping']:.1f} a ping), "
          f"{facts['syncs_per_run']} stream syncs a run; kernels busy "
          f"{facts['kernel_busy_ms']:.3f} ms, copies "
          f"{facts['copy_ms']:.3f} ms; busy share "
          + (f"{100 * share:.1f} % of the untraced wall, "
             f"{100 * facts['busy_share_traced']:.1f} % of the traced"
             if share is not None else f"null ({facts['busy_share_note']})"),
          flush=True)
    print(json.dumps(dict(
        device=str(device),
        **bench._card(device),
        n_pings=cap.n_pings,
        window=cap.window,
        backend=cap.backend,
        dense_mode=cap.dense_mode if cap.brick else None,
        records_batch=cap.records_batch,
        count_sized=cap.count_sized,
        **cap.budget_detail(),
        wall_ms=wall_s * 1e3,
        traced_wall_ms=traced_wall_s * 1e3,
        k1_launches=k1,
        k1_raw_launches=k1_raw,
        **facts,
        trace=os.path.relpath(path, ROOT),
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
