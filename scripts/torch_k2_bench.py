"""Time the port's table kernel K2 (kernels/lookup_accumulate.py,
csrc/lookup_accumulate.cu) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_k2_bench.py [--variant NAME=PATH ...] [--out FILE]

Builds, timed in turns on the same inputs:
  * ``new``: ``lookup_accumulate`` (grouping kernels + table kernel);
  * ``sort``: the grouping's yardstick, the bucket pass's int32 ids
    grouped by a stable ``torch.sort`` (``group_by_bucket``), packed by
    torch gathers (``pack_records``), then the same table kernel
    (``apply_grouped``);
  * ``--variant NAME=PATH``: another source with the package's C
    interface (an edited copy of csrc/lookup_accumulate.cu), built the
    same way and called through the package's wrapper.
At chip_smoke.py's two K2 sizes (U records of distinct keys into a table
of C slots) and on its hot-bucket batch it times:
  * the wrapper per call in a chain of 16 dependent calls from an empty
    table (CUDA events; the chain's first call inserts every key, the rest
    find them);
  * the table kernel's device time per launch on a call that finds every
    key (torch.profiler);
  * one call's device time by kernel name and its kernel launches
    (``cudaLaunchKernel`` events), from the profiler over 10 calls;
  * the wrapper's host time per call: 100 calls without a synchronise,
    on the host's clock.
Each call's bytes and memory bound are given with the port's int64 key
words and with u32 key words (in the records and the key rows).  Results
go to stdout and, as JSON, to ``--out`` when given.
"""

import argparse
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
    K2_CHAIN,
    K2_SIZES,
    _bound_ms,
    _device_ms,
    _distinct_keys,
    _k2_tables,
    _profile_calls,
    _time_ms,
    k2_bytes,
    k2_hot_batch,
)
from sonar_3d_reconstruction_tpu_torch.kernels import lookup_accumulate as k2  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.kernels.build import (  # noqa: E402
    build_shared_library,
)

TABLE_KERNEL = "lookup_accumulate_kernel"  # the table kernel's profiler name


def make_inputs(dev):
    """{name: (khi, klo, upd, empty rows, zero values, plain version)}:
    chip_smoke.phase_k2's two sizes of distinct keys, drawn as it draws
    them, and its hot-bucket batch at the larger size."""
    rng = np.random.default_rng(2)
    out = {}
    for u, cap in K2_SIZES:
        khi, klo = (torch.as_tensor(x, device=dev)
                    for x in _distinct_keys(rng, u))
        upd = torch.as_tensor(rng.normal(size=u).astype(np.float32), device=dev)
        out[f"U={u},C={cap}"] = (khi, klo, upd, *_k2_tables(cap, dev),
                                 k2.lookup_accumulate_reference)
    u, cap = K2_SIZES[-1]
    out[f"hot bucket,C={cap}"] = (*k2_hot_batch(rng, dev, u, cap // 128),
                                  *_k2_tables(cap, dev),
                                  k2.lookup_accumulate_plain)
    return out


def sort_grouped(khi, klo, upd, rows, vals):
    """The yardstick: stable torch.sort grouping, then the table kernel."""
    order, off = k2.group_by_bucket(khi, klo, rows.shape[0])
    seg = torch.stack([off[:-1], off.diff()], 1)
    return k2.apply_grouped(k2.pack_records(khi, klo, upd, order), seg, rows,
                            vals)


def variant_build(path):
    """The package's wrapper calling the library built from ``path``."""
    lib = (k2._bind(build_shared_library(os.path.abspath(path))[0]), "")

    def call(*args):
        orig = k2._library
        k2._library = lambda: lib
        try:
            return k2.lookup_accumulate(*args)
        finally:
            k2._library = orig

    return call


def host_ms(fn, calls=100):
    """Host time per call of ``fn``, without waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e3


def chain(fn, khi, klo, upd, rows, vals):
    for _ in range(K2_CHAIN):
        rows, vals = fn(khi, klo, upd, rows, vals)
    return rows, vals


def time_builds(builds, inputs, rounds=3):
    """{case: {build: times}}; each build is checked bit-equal to the
    plain version over a chain first, and builds alternate in order."""
    results = {}
    for case, (khi, klo, upd, rows0, vals0, plain) in inputs.items():
        want = chain(plain, khi, klo, upd, rows0, vals0)
        for name, fn in builds.items():
            got = chain(fn, khi, klo, upd, rows0, vals0)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name} != plain at {case}")
        samples = {b: {"wrapper": [], "kernel": []} for b in builds}
        order = list(builds)
        for r in range(rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                fn = builds[name]
                samples[name]["wrapper"].append(_time_ms(
                    lambda: chain(fn, khi, klo, upd, rows0, vals0), reps=3)
                    / K2_CHAIN)
                samples[name]["kernel"].append(_device_ms(
                    lambda: fn(khi, klo, upd, *want), TABLE_KERNEL))
        nbytes, nbytes_u32 = k2_bytes(khi, klo, upd, rows0, vals0)
        per = {}
        for name, fn in builds.items():
            kernels, launches = _profile_calls(
                lambda: fn(khi, klo, upd, *want))
            host = host_ms(lambda: fn(khi, klo, upd, *want))
            wrapper = statistics.median(samples[name]["wrapper"])
            kernel = statistics.median(samples[name]["kernel"])
            per[name] = {
                "wrapper_ms": wrapper, "kernel_ms": kernel, "host_ms": host,
                "launches_per_call": launches,
                "device_ms_per_call": sum(t for t, _ in kernels.values()),
                "kernels": kernels,
                "wrapper_share_of_bound": _bound_ms(nbytes) / wrapper,
                "kernel_share_of_bound": _bound_ms(nbytes) / kernel,
            }
            print(f"{case} {name:10s} wrapper {wrapper:.4f} ms, table "
                  f"kernel {kernel:.4f} ms, device "
                  f"{per[name]['device_ms_per_call']:.4f} ms and "
                  f"{launches:g} launches per call, host {host:.4f} ms",
                  flush=True)
            for kname, (t, n) in sorted(kernels.items(), key=lambda x: -x[1][0]):
                print(f"    {t:.4f} ms  {n:g}x  {kname[:150]}", flush=True)
        results[case] = {
            "bytes": nbytes, "bytes_u32_keys": nbytes_u32,
            "bound_ms": _bound_ms(nbytes),
            "bound_u32_keys_ms": _bound_ms(nbytes_u32),
            "builds": per,
        }
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_bench: no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(k2.build(), flush=True)
    builds = {"new": k2.lookup_accumulate}
    for spec in args.variant:
        name, path = spec.split("=", 1)
        builds[name] = variant_build(path)
    builds["sort"] = sort_grouped
    result = {"device": smi, "sizes": time_builds(builds, make_inputs(dev))}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
