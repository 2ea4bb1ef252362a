"""The readings that a cell's correctness limits are set from, in one
process on the card (not part of a run):

    python3 -m sonarbench.readings --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...]

* the program: for each seed, the cell's set-up and a window of one
  pass, its map and stats held to the float64 reference, as a run does;
* the control: for each control seed, the reference computed in bfloat16
  (the precision below the configuration's float32) in the program's
  place, on the same pass;
* the faults (``sonarbench.faults``): for each fault seed, the program
  with each fault planted.

One JSON line a reading, then the largest reading of each number over the
program's seeds and the smallest over the control's and each fault's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from sonarbench import compare, faults, reference, run


def _program(cell, seed, device, fault=None):
    import contextlib

    drv = run.driver_class(cell.traffic["kind"])(
        config=cell.config, traffic=cell.traffic, cell=cell.knobs,
        plan=cell.plan, seed=seed, device=device)
    plant = faults.planted(fault) if fault else contextlib.nullcontext()
    with plant:
        drv.setup()
        drv.window(0.0)
    kept = drv.read_kept()
    return drv, kept


def control_numbers(drv, kept, dtype):
    """The reference computed in ``dtype`` in the program's place, held to
    the float64 reference, on the kept pass."""
    import torch

    p = kept[0]
    low = reference.map_pass(p.images, p.positions, p.quats, drv.mapper,
                             drv.device, dtype)
    stats = {k: low[k] for k in compare.STATS}
    keys = reference.unpack(low["codes"]).cpu().numpy()
    lo = low["log_odds"].to(torch.float64).cpu().numpy()
    del low
    ref = reference.map_pass(p.images, p.positions, p.quats, drv.mapper,
                             drv.device, torch.float64)
    return compare.numbers(stats, keys, lo, ref)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)

    import torch

    cell = run.Cell(args.workload)
    device = torch.device("cuda", 0)
    worst = {}

    def report(kind, seed, nums, t0):
        line = dict(kind=kind, seed=seed, seconds=time.perf_counter() - t0,
                    **nums)
        print(json.dumps(line), flush=True)
        agg = max if kind == "program" else min
        for k in compare.NUMBERS:
            key = (kind, k)
            worst[key] = nums[k] if key not in worst else agg(worst[key],
                                                               nums[k])

    for seed in args.seeds:
        t0 = time.perf_counter()
        drv, kept = _program(cell, seed, device)
        report("program", seed, drv.check(kept), t0)
        del drv, kept
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        drv, kept = _program(cell, seed, device)
        nums = control_numbers(drv, kept, torch.bfloat16)
        report("control_bfloat16", seed, nums, t0)
        del drv, kept
        torch.cuda.empty_cache()
    for seed in args.fault_seeds:
        for fault in faults.FAULTS:
            t0 = time.perf_counter()
            drv, kept = _program(cell, seed, device, fault)
            report("fault_" + fault, seed, drv.check(kept), t0)
            del drv, kept
            torch.cuda.empty_cache()
    print(json.dumps({f"{kind}.{k}": v for (kind, k), v in sorted(
        worst.items())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
