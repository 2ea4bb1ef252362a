"""Make a cell's budget plan (``sonarbench/plans/<cell>.json``) with the
program's ``utils.autotune.tune_sequence``.

    python3 -m sonarbench.make_plan --workload <cell> --seed <n>

The cell's image pool (its traffic file, drawn from ``--seed``) is mapped
as straight legs at each heading of ``HEADINGS`` at the cell's window, one
``tune_sequence`` a leg, and the plan takes each budget's largest value
over the legs (an insert budget list entry by entry), so that a leg at any
heading fits it: the brick grid looks the same every 90 degrees and in a
mirror, so 0 to 45 degrees cover every heading.  It writes the plan with
the command, seed, window, headings and card that made it.  The benchmark's
runs only read plans; this script is not part of a run.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from sonarbench import generator, run
from sonarbench.drivers import survey_leg

HEADINGS = (0.0, math.pi / 8, math.pi / 4)


def merge(plans):
    """Each key's largest value over ``plans`` (lists entry by entry);
    keys whose values agree stay as they are."""
    out = dict(plans[0])
    for p in plans[1:]:
        for k, v in p.items():
            a = out.get(k)
            if isinstance(v, list):
                out[k] = [max(x, y) for x, y in zip(a, v)]
            elif isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and a is not None:
                out[k] = max(a, v)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--window", type=int, default=None,
                        help="default: the cell's window")
    parser.add_argument("--out", default=None,
                        help="default: sonarbench/plans/<cell>.json")
    args = parser.parse_args(argv)

    import torch

    from sonar_3d_reconstruction_tpu_torch.config import config_from_dict
    from sonar_3d_reconstruction_tpu_torch.utils.autotune import tune_sequence

    cell = run.Cell(args.workload)
    device = torch.device("cuda", 0)
    window = args.window or cell.knobs["window"]
    m = cell.config["mapper"]
    cfg = config_from_dict(m)
    pool = generator.make_pool(cell.traffic,
                               (m["image_height"], m["image_width"]),
                               args.seed, device)
    plans = []
    for heading in HEADINGS:
        leg = generator.leg(cell.traffic, pool, 0, heading, len(pool))
        t0 = time.perf_counter()
        plans.append(tune_sequence(
            leg.images, leg.positions, leg.quats, cfg,
            backend=survey_leg.BACKEND, window=window,
            dense_mode="pallas", dtype=getattr(torch, cell.config["dtype"]),
            device=device))
        print(f"heading {heading:.4f}: {json.dumps(plans[-1])} "
              f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr)
    plan = merge(plans)
    doc = {
        "made_by": {
            "command": "python3 -m sonarbench.make_plan " + " ".join(
                argv if argv is not None else sys.argv[1:]),
            "seed": args.seed,
            "window": window,
            "pool_pings": len(pool),
            "headings_rad": list(HEADINGS),
            "card": run.card(device)["kind"],
            "per_heading": plans,
        },
        "budgets": plan,
    }
    out = args.out or str(run.HERE / "plans" / f"{args.workload}.json")
    with open(out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(doc["budgets"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
