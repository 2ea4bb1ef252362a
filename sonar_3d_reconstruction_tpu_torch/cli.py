"""Command-line interface of the PyTorch port (port of
``sonar_3d_reconstruction_tpu.cli``).

  python -m sonar_3d_reconstruction_tpu_torch selftest [--device D]
      The reference library self-test scenario (scripts/3d_mapper.py:653-683):
      synthetic two-rectangle 500x512 image, 3 frames stepping x by 0.1 m.

  python -m sonar_3d_reconstruction_tpu_torch make-bag OUT.db3 [--pings N]
      Write a synthetic KIRO-style recording (.db3, or .mcap by extension).
      NumPy only: it makes no tensors and takes no device.

  python -m sonar_3d_reconstruction_tpu_torch map-bag BAG [--chunk C]
      [--publish] [--config YAML] [--param K=V] [--window W]
      [--backend brick|brick-sharded|hash] [--shards N]
      [--save-map OUT.npz] [--save-cloud OUT.pc2] [--budgets PLAN.json]
      [--device D]
      Replay the bag through the streaming runtime (stream.StreamingMapper,
      brick backend unless --backend says otherwise): pings are paired
      with odometry as they arrive and
      mapped in chunks of C, windows of W; --publish attaches a counting
      publish sink at the config's publish_rate_hz (stream time).  Prints
      one JSON line: the stream's summary (counters, latency p50/p95/max),
      wall time, pings/s, the publish counts, the map's voxels, the device
      and the binning and records kernels' launches.

  python -m sonar_3d_reconstruction_tpu_torch map-bag BAG --offline [...]
      Decode and pair the whole bag, then map it in windows of W pings
      (pipeline.map_ping_sequence, or the frame-parallel engine for
      brick-sharded); prints one JSON line (pairs, voxels, load and map
      seconds, pings/s, realtime factor, the device and the binning and
      records kernels' launches).

  python -m sonar_3d_reconstruction_tpu_torch tune BAG [--out PLAN.json]
      [--config YAML] [--param K=V] [--backend brick|hash] [--window W]
      [--dense-mode MODE] [--device D]
      Map the bag once at the default budgets and write a deployment
      budget plan (utils/autotune.tune_sequence; stdout without --out).
      ``map-bag --budgets PLAN.json`` (streaming or --offline) then maps
      at its fixed widths, taking the plan's backend and window unless
      --backend / --window say otherwise (a plan the other way round is an
      error).  Plans of this package and the JAX package's are the same
      JSON, and either package reads either's.  --budgets warns and is
      ignored with --backend brick-sharded.

  python -m sonar_3d_reconstruction_tpu_torch query MAP.npz X,Y,Z [...]
      [--device D]
      Occupancy probability at world points from a saved snapshot
      (reference SimpleOctree.get_probability: never-updated voxels 0.5).

  python -m sonar_3d_reconstruction_tpu_torch bench [--device D]
      The headline benchmark (``sonar_3d_reconstruction_tpu_torch.bench``:
      the 256-ping survey at 5 cm, window 16; BENCH_* environment knobs):
      prints exactly one JSON line, an error line on a failure (exit 1).

Commands that map or query run on ``--device``: the first CUDA device by
default, which they require (exit code 1 without one); ``--device cpu``
runs them on the CPU.  ``--backend brick-sharded`` shards the brick map
over ``--shards N`` copies of that device (N shards on one device), by
default one shard per visible card (one shard on an explicit
``--device``).  Config layering: --param overrides > --config YAML >
library defaults.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np


def _parse_overrides(pairs: List[str]) -> Dict:
    out: Dict = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"--param expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def _device(args: argparse.Namespace):
    """The command's device: ``--device``, else the first CUDA device
    (SystemExit without one)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.device import require_cuda

    if args.device is not None:
        return torch.empty(0, device=args.device).device
    try:
        return require_cuda()
    except RuntimeError as e:
        raise SystemExit(f"{e}; pass --device cpu to run on the CPU") from e


def _mesh(args: argparse.Namespace, device):
    """The sharded backend's mesh: ``--shards`` copies of ``device``, or
    one shard per visible card (the one ``--device`` when given)."""
    from sonar_3d_reconstruction_tpu_torch.parallel.shard import make_mesh

    if args.shards is not None:
        if args.shards < 1:
            raise SystemExit(f"--shards must be at least 1, got {args.shards}")
        return make_mesh([device] * args.shards)
    return make_mesh(None if args.device is None else [device])


def cmd_selftest(args: argparse.Namespace) -> int:
    from sonar_3d_reconstruction_tpu_torch.models import SonarMapper

    mapper = SonarMapper(
        {
            "voxel_resolution": 0.1,
            "min_probability": 0.6,
            "intensity_threshold": 30,
        },
        device=_device(args),
    )
    for stats in selftest_pings(mapper):
        print(
            f"frame {stats['frame_count']}: occupied={stats['num_occupied']} "
            f"free={stats['num_free']} voxels={stats['num_voxels']} "
            f"({stats['processing_time'] * 1e3:.1f} ms)"
        )
    cloud = mapper.get_point_cloud()
    print(
        f"final map: {cloud['num_occupied']} occupied of "
        f"{cloud['num_voxels']} voxels on {mapper.device}"
    )
    return 0


def selftest_pings(mapper):
    """Feed ``mapper`` the reference self-test's three pings (500x512
    image with two bright rectangles, x stepping 0.1 m, identity
    orientation); yields each ping's stats."""
    img = np.zeros((500, 512), np.uint8)
    img[100:150, 200:300] = 100   # bright regions (reference :667-669)
    img[300:350, 100:150] = 150
    for i in range(3):
        yield mapper.process_sonar_image(
            img, [i * 0.1, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]
        )


def _plan(args: argparse.Namespace) -> Optional[Dict]:
    """The ``--budgets`` plan, with ``args.backend`` and ``args.window``
    taken from it where the flags were not given (brick and 8 without a
    plan); SystemExit when a flag contradicts it."""
    plan = None
    if args.budgets:
        with open(args.budgets) as f:
            plan = json.load(f)
    if args.backend is None:
        args.backend = plan.get("backend", "brick") if plan else "brick"
    if args.window is None:
        args.window = plan.get("window", 8) if plan else 8
    if plan is None:
        return None
    if args.backend == "brick-sharded":
        print("warning: --budgets applies to the brick and hash backends "
              "only; ignoring it", file=sys.stderr)
        return None
    for key in ("backend", "window"):
        if plan.get(key, getattr(args, key)) != getattr(args, key):
            raise SystemExit(
                f"--budgets plan was tuned for {key}={plan.get(key)!r} but "
                f"map-bag is running --{key} {getattr(args, key)}; omit "
                f"--{key} to take the plan's"
            )
    return plan


def cmd_map_bag(args: argparse.Namespace) -> int:
    from sonar_3d_reconstruction_tpu_torch.config import load_config

    device = _device(args)
    cfg, stream_cfg = load_config(args.config, _parse_overrides(args.param))
    plan = _plan(args)
    if args.offline:
        return _map_bag_offline(args, device, cfg, stream_cfg, plan)
    if plan is not None and plan.get("window") is not None:
        # the stream clamps its window to the chunk: a plan tuned for
        # window W needs chunks of at least W
        args.chunk = max(args.chunk, int(plan["window"]))
    import torch

    from sonar_3d_reconstruction_tpu_torch.kernels import (
        bin_apply,
        box_words,
    )
    from sonar_3d_reconstruction_tpu_torch.stream import StreamingMapper

    published = {"n": 0, "points": 0, "bytes": 0}
    pub_cb = None
    if args.publish:
        def pub_cb(msg):
            published["n"] += 1
            published["points"] = msg["width"]
            published["bytes"] += len(msg["data"])

    mesh = _mesh(args, device) if args.backend == "brick-sharded" else None
    mapper = StreamingMapper(
        cfg, stream_cfg, chunk_size=args.chunk, window=args.window,
        dtype=torch.float32, publish=pub_cb, backend=args.backend,
        device=device, mesh=mesh, budgets=plan,
    )
    k1_before, words_before = bin_apply.launches, box_words.launches
    t0 = time.perf_counter()
    stats = mapper.run_bag(args.bag)
    wall = time.perf_counter() - t0
    s = stats.summary()
    s["wall_time"] = wall
    s["pings_per_sec"] = stats.frames_mapped / wall if wall else 0.0
    if pub_cb is not None:
        s["publishes"] = published["n"]
        s["last_publish_points"] = published["points"]
        s["publish_bytes"] = published["bytes"]
    s["num_voxels"] = int(mapper.state.used.sum())
    s["device"] = str(device)
    if mesh is not None:
        s["shards"] = len(mesh)
    # the binning and records kernels' launches (0 on the CPU, which runs
    # their plain versions)
    s["bin_apply_launches"] = bin_apply.launches - k1_before
    s["box_words_launches"] = box_words.launches - words_before
    print(json.dumps(s))
    if args.save_map:
        from sonar_3d_reconstruction_tpu_torch.io.checkpoint import save_map

        save_map(args.save_map, mapper.state, cfg)
    if args.save_cloud:
        with open(args.save_cloud, "wb") as f:
            f.write(mapper.pointcloud_msg()["data"])
    return 0


def _map_bag_offline(args, device, cfg, stream_cfg, plan=None) -> int:
    """Batch path: decode and pair the whole bag, then map it in windows
    (pipeline.map_ping_sequence, at the plan's budgets when there is
    one)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.io.bag import load_bag_sequence
    from sonar_3d_reconstruction_tpu_torch.kernels import (
        bin_apply,
        box_words,
    )
    from sonar_3d_reconstruction_tpu_torch.parallel.shard_frames import (
        map_ping_sequence_sharded_frames,
    )
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    t0 = time.perf_counter()
    images, positions, quats, stamps = load_bag_sequence(
        args.bag,
        sonar_topic=stream_cfg.sonar_topic,
        odometry_topic=stream_cfg.odometry_topic,
        slop=stream_cfg.sync_slop,
    )
    t_load = time.perf_counter() - t0
    mesh = _mesh(args, device) if args.backend == "brick-sharded" else None
    t0 = time.perf_counter()
    k1_before, words_before = bin_apply.launches, box_words.launches
    if mesh is not None:
        state, _ = map_ping_sequence_sharded_frames(
            images, positions, quats, cfg, mesh=mesh, dtype=torch.float32,
            window=args.window,
        )
    else:
        state, _ = map_ping_sequence(
            images, positions, quats, cfg, device=device,
            dtype=torch.float32, window=args.window, backend=args.backend,
            budgets=plan,
        )
    num_voxels = int(state.used.sum())  # waits for the device
    t_map = time.perf_counter() - t0
    n = len(images)
    span = float(stamps[-1] - stamps[0]) if n > 1 else 0.0
    shards = {} if mesh is None else {"shards": len(mesh)}
    print(
        json.dumps(
            {
                **shards,
                "pairs": n,
                "num_voxels": num_voxels,
                "load_time": t_load,
                "map_time": t_map,
                "pings_per_sec": n / t_map if t_map else 0.0,
                "realtime_factor": span / t_map if t_map else 0.0,
                "device": str(device),
                # the binning and records kernels' launches (0 on the
                # CPU, which runs their plain versions)
                "bin_apply_launches": bin_apply.launches - k1_before,
                "box_words_launches": box_words.launches - words_before,
            }
        )
    )
    if args.save_map:
        from sonar_3d_reconstruction_tpu_torch.io.checkpoint import save_map

        save_map(args.save_map, state, cfg)
    if args.save_cloud:
        from sonar_3d_reconstruction_tpu_torch.grid.brick import (
            extract_occupied_brick,
        )
        from sonar_3d_reconstruction_tpu_torch.grid.hash import (
            extract_occupied_hash,
        )
        from sonar_3d_reconstruction_tpu_torch.io.pointcloud import (
            serialize_pointcloud2,
        )
        from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (
            extract_occupied_sharded,
        )

        extract = {"brick": extract_occupied_brick,
                   "brick-sharded": extract_occupied_sharded,
                   "hash": extract_occupied_hash}[args.backend]
        pts, probs = extract(state, cfg)
        with open(args.save_cloud, "wb") as f:
            f.write(serialize_pointcloud2(pts, probs)["data"])
    return 0


def cmd_make_bag(args: argparse.Namespace) -> int:
    from sonar_3d_reconstruction_tpu_torch.io.bag import write_synthetic_bag

    rng = np.random.default_rng(args.seed)
    n, R, B = args.pings, args.range_bins, args.bearing_bins
    images = rng.integers(0, 25, size=(n, R, B)).astype(np.uint8)
    for i in range(n):
        r0 = int(R * 0.3) + int(R * 0.08 * np.sin(i / 7.0))
        images[i, r0 : r0 + int(R * 0.08), :] = rng.integers(
            80, 220, size=(int(R * 0.08), B)
        ).astype(np.uint8)
    positions = np.stack(
        [0.08 * np.arange(n), np.zeros(n), np.zeros(n)], axis=-1
    )
    yaw = 0.02 * np.arange(n)
    quats = np.stack(
        [np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], axis=-1
    )
    write_synthetic_bag(args.out, images, positions, quats, rate_hz=args.rate)
    print(f"synthetic bag: {n} pings ({R}x{B}) -> {args.out}")
    return 0


def cmd_tune(args: argparse.Namespace) -> int:
    """Map the bag once -> a deployment budget plan (JSON), for
    ``map-bag --budgets``."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.config import load_config
    from sonar_3d_reconstruction_tpu_torch.io.bag import load_bag_sequence
    from sonar_3d_reconstruction_tpu_torch.utils.autotune import tune_sequence

    device = _device(args)
    cfg, stream_cfg = load_config(args.config, _parse_overrides(args.param))
    images, positions, quats, _ = load_bag_sequence(
        args.bag,
        sonar_topic=stream_cfg.sonar_topic,
        odometry_topic=stream_cfg.odometry_topic,
        slop=stream_cfg.sync_slop,
    )
    plan = tune_sequence(
        images, positions, quats, cfg, backend=args.backend,
        window=args.window, dense_mode=args.dense_mode, dtype=torch.float32,
        device=device,
    )
    text = json.dumps(plan, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"budget plan ({len(images)} pings) -> {args.out}",
              file=sys.stderr)
    else:
        print(text)
    return 0


def _dense_mode(text: str) -> str:
    """argparse type of ``--dense-mode``: a JAX dense_mode spelling."""
    from sonar_3d_reconstruction_tpu_torch.grid.brick import parse_dense_mode

    try:
        parse_dense_mode(text)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from e
    return text


def cmd_query(args: argparse.Namespace) -> int:
    """Point-query a saved map snapshot (reference SimpleOctree
    get_probability semantics: never-updated voxels answer p=0.5)."""
    rows = []
    for p in args.points:
        parts = p.split(",")
        if len(parts) != 3:
            print(f"point {p!r}: expected X,Y,Z", file=sys.stderr)
            return 2
        try:
            rows.append([float(v) for v in parts])
        except ValueError:
            print(f"point {p!r}: coordinates must be numbers", file=sys.stderr)
            return 2
    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        query_probability_brick,
    )
    from sonar_3d_reconstruction_tpu_torch.io.checkpoint import load_map_brick

    state, cfg = load_map_brick(args.map, device=_device(args))
    pts = np.asarray(rows, np.float64)
    probs = query_probability_brick(state, pts, cfg)
    for p, pr in zip(pts, probs):
        print(json.dumps({"point": list(p), "probability": float(pr)}))
    return 0


def cmd_bench(args: argparse.Namespace) -> int:
    from sonar_3d_reconstruction_tpu_torch import bench

    return bench.main([] if args.device is None else ["--device", args.device])


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", default=None, metavar="DEVICE",
        help="torch device to run on (default: the first CUDA device, "
        "required; 'cpu' runs on the CPU)",
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="sonar_3d_reconstruction_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("selftest", help="reference __main__ scenario")
    _add_device(p)

    p = sub.add_parser("map-bag", help="rosbag2 / mcap replay -> map")
    p.add_argument("bag")
    p.add_argument("--config", default=None, help="reference-schema YAML")
    p.add_argument(
        "--param", action="append", default=[], metavar="KEY=VALUE",
        help="config override (highest priority), repeatable",
    )
    p.add_argument(
        "--backend", choices=("brick", "brick-sharded", "hash"),
        default=None,
        help="map backend: the brick table (the default, or the --budgets "
        "plan's backend), the brick table sharded over a mesh of devices, "
        "or the per-voxel hash",
    )
    p.add_argument(
        "--shards", type=int, default=None, metavar="N",
        help="brick-sharded: N shards, all on --device (default: one shard "
        "per visible card, or one on an explicit --device)",
    )
    p.add_argument(
        "--offline", action="store_true",
        help="batch path: decode the whole bag, then map it (fastest; no "
        "streaming publish)",
    )
    p.add_argument(
        "--chunk", type=int, default=32,
        help="streaming path: pings per mapped chunk",
    )
    p.add_argument(
        "--window", type=int, default=None,
        help="pings per window of the batched apply (both paths); 1 = "
        "per-ping.  Default: 8, or the --budgets plan's window",
    )
    p.add_argument(
        "--budgets", default=None, metavar="PLAN.json",
        help="deployment budget plan from `tune` (either package's): map "
        "at its fixed widths; a stale plan replays safely",
    )
    p.add_argument(
        "--publish", action="store_true",
        help="streaming path: attach a counting publish sink at the "
        "config's publish_rate_hz (the reference node's 10 Hz tick, "
        "node:227-231); the summary then reports publishes / "
        "last_publish_points / publish_bytes",
    )
    p.add_argument("--save-map", default=None, metavar="OUT.npz")
    p.add_argument("--save-cloud", default=None, metavar="OUT.pc2")
    _add_device(p)

    p = sub.add_parser(
        "tune", help="map a bag once -> deployment budget plan (JSON)"
    )
    p.add_argument("bag")
    p.add_argument("--config", default=None, help="reference-schema YAML")
    p.add_argument(
        "--param", action="append", default=[], metavar="KEY=VALUE",
        help="config override (highest priority), repeatable",
    )
    p.add_argument("--backend", choices=("brick", "hash"), default="brick")
    p.add_argument("--window", type=int, default=8)
    p.add_argument(
        "--dense-mode", type=_dense_mode, default="pallas",
        help="brick window layout the plan is for (a JAX dense_mode "
        "spelling; \"row\" adds a vox budget)",
    )
    p.add_argument("--out", default=None, metavar="PLAN.json")
    _add_device(p)

    p = sub.add_parser(
        "query", help="occupancy probability at world points from a saved map"
    )
    p.add_argument("map", help=".npz snapshot from map-bag --save-map")
    p.add_argument(
        "points", nargs="+", metavar="X,Y,Z", help="query points (repeatable)"
    )
    _add_device(p)

    p = sub.add_parser("make-bag", help="generate a synthetic recording")
    p.add_argument("out")
    p.add_argument("--pings", type=int, default=60)
    p.add_argument("--range-bins", type=int, default=500)
    p.add_argument("--bearing-bins", type=int, default=512)
    p.add_argument("--rate", type=float, default=2.0)
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("bench", help="headline benchmark (one JSON line)")
    _add_device(p)

    args = parser.parse_args(argv)
    return {
        "bench": cmd_bench,
        "selftest": cmd_selftest,
        "map-bag": cmd_map_bag,
        "make-bag": cmd_make_bag,
        "query": cmd_query,
        "tune": cmd_tune,
    }[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
