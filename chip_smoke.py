"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its own line; any failure raises and exits non-zero):

1. build: the CUDA kernels (``csrc/*.cu``) are compiled into
   ``build/kernels/`` at first use, one nvcc per source, all started
   together, and the card's name and power limit are printed as
   ``nvidia-smi`` reports them.
2. main path, full size: the bench survey (the port's
   ``sonar_3d_reconstruction_tpu_torch.bench.make_inputs``, 256
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
5. entry points, on the card (each step prints its wall time with the
   card's name and power limit):
   a. the reference selftest scenario (500x512, 0.1 m voxels, 3 pings)
      through ``SonarMapper.process_sonar_image`` on the card and on the
      CPU: equal per-ping stats, equal occupied voxels, probabilities
      within 1e-5; then ENTRY_PINGS bench pings through
      ``process_sonar_image`` at the library defaults, timed one by one;
   b. ``SonarMapper.map_sequence`` over phase 2's survey (window 16) from
      a fresh mapper: its touched voxels and log-odds equal phase 2's
      final map exactly;
   c. reads and snapshots of that map: ``get_point_cloud(include_free=
      True)``; ``query_probabilities`` at QUERY_POINTS points (touched
      voxel centres, voxel corners, untouched points) against the same
      answers computed on the host; ``save_map`` -> ``load_map_brick`` on
      the card, bit-equal to the mapper's voxels;
   d. the CLI in subprocesses: ``make-bag`` (CLI_PINGS pings of 500x512),
      ``map-bag --offline --window 16 --save-map --save-cloud`` (its
      voxel count equal to an in-process ``map_ping_sequence`` over the
      same decoded bag) and ``query``; every exit code checked.
   K1 launches are counted on each of these paths (the counts set to 0
   just before a path and read just after; the CLI reports its own) and
   must be non-zero.
6. the streaming runtime, the streaming CLI and the node, on the card:
   a. phase 2's survey as ImageMsg/OdometryMsg pairs (stamps 1000 + 0.1 i)
      through ``StreamingMapper(chunk_size=16, window=16)`` in both dense
      modes: touched voxels and log-odds equal phase 2's map exactly;
   b. ping-to-map latency: chunk = window = 1 over the first
      LATENCY_PINGS pings back to back, twice; the warm pass's arrival ->
      commit p50 / p95 / max per frame; its map against the same pings
      mapped on the CPU (plain versions): voxel sets equal, log-odds
      within F32_LOG_ODDS_TOL;
   c. publish at 1 Hz of stream time: ms and bytes per tick; a final
      tick byte-equal to the cloud computed on the host from phase 2's
      map;
   d. F64_PINGS pings in float64 on the card and on the CPU: per-ping
      stats and voxel sets equal, log-odds within F64_TOL;
   e. ``map-bag --chunk 16 --window 16 --publish --save-map`` in a
      subprocess on step 5d's bag: its voxel count equals ``--offline``'s;
   f. the ROS2 node under a minimal stub of the ROS modules
      (``ros_stub``): NODE_PINGS pairs, one publish tick whose cloud equals
      the mapper's extraction, one marker tick; the map lies on the card,
      and its voxels are held against a CPU ``SonarMapper`` fed the same
      pings as in step b.
   Each path's K1 (or K1-raw) launches are counted as in phase 5.
7. the hash backend and the wide key path, on the card:
   a. phase 2's survey through ``map_ping_sequence(backend="hash",
      window=16)`` twice (wall, pings/s, peak memory and rehash calls of
      the second): per-ping stats equal to phase 2's, its voxels too, log-odds
      within F32_LOG_ODDS_TOL (the count not bit-equal printed); then the
      first HASH_W1_PINGS pings one by one (``update_hash_grid``) against
      the brick map of the same pings;
   b. the first WIDE_PINGS of those pings at max_range WIDE_RANGE, where
      no window fits compact box keys, through the brick backend (two-word
      brick codes, K1; its launches counted as in phase 5) and the hash
      backend (its rehash calls counted): stats and
      voxels equal; K1 against its plain version on the widest wide
      window; WIDE_F64_PINGS pings in float64 on the card and the CPU,
      voxels equal and log-odds within F64_TOL;
   c. ENTRY_PINGS ``SonarMapper(backend="hash").process_sonar_image``
      pings timed one by one; ``save_map`` -> ``load_map`` of 7a's map on
      the card (voxels and log-odds bit-equal); ``map-bag --offline
      --backend hash`` on step 5d's bag (voxels equal to the brick run's);
   d. the survey through ``StreamingMapper(backend="hash")`` at chunk 16
      (voxels and log-odds equal to 7a's map), and the node with
      ``map_backend: "hash"`` (as 6f, against a CPU hash mapper).
8. the dense backend and the multi-host record fold, on the card:
   a. phase 2's survey through ``map_ping_sequence(backend="dense")`` in
      the default grid (+-(max_range + 2 m), 481^3 cells) in float32,
      cold, warm (wall, pings/s, peak memory, state bytes, overflow) and
      warm again: its touched cells equal phase 2's brick voxels inside
      the grid, every log-odds bit-equal, and the two warm runs bit-equal;
   b. DENSE_F64_PINGS pings in float64 into a +-DENSE_F64_REACH m grid on
      the card and the CPU: stats and every state array bit-equal;
   c. ``SonarMapper(backend="dense")`` on the selftest scenario, card
      against CPU (stats and occupied voxels equal, probabilities within
      1e-5); ENTRY_PINGS bench pings through ``process_sonar_image``,
      timed one by one; the node with ``map_backend: "dense"`` (as 6f);
   d. the survey through ``parallel.map_ping_sequence_multihost`` in
      MULTIHOST_HOSTS segments, window 16, on the brick map (two-word
      brick codes, K1 counted as in phase 5) against phase 2's map and on
      the hash map against 7a's: per-ping stats, voxels and log-odds
      equal; the records' and the fold's seconds, the bytes shipped to
      the host and the rehash calls apart.
   The dense backend launches no kernel (its K1 count, 0, is shown).
9. the frame-parallel sharded brick engine on the card, its mesh the card
   repeated (``(cuda:0,) * S``):
   a. phase 2's survey through ``parallel.map_ping_sequence_sharded_frames``
      (window 16, float32, compact box keys) at each S of SHARDS (the
      last cold, then warm): per-ping stats, voxels and log-odds equal
      phase 2's; voxels per shard, K1 launches, rehash calls, the largest
      (frame, owner) block, the record bytes moved to their owners, wall,
      pings/s, peak memory;
   b. 7b's WIDE_PINGS pings at WIDE_RANGE at SHARDED_S shards (two-word
      codes): voxels and log-odds equal 7b's brick map; K1 against its
      plain version on the widest shard window;
   c. ``SonarMapper(backend="brick-sharded")`` at SHARDED_S shards:
      ENTRY_PINGS pings timed one by one; ``map_sequence`` of the survey
      (voxels, the classified cloud and point queries against phase 2's
      map); ``save_map`` -> ``load_map_sharded_brick`` (every voxel on its
      shard) and -> ``load_map_brick``; ``map-bag --offline --backend
      brick-sharded --shards SHARDED_S`` on step 5d's bag (its snapshot
      equal to 5d's);
   d. the survey through ``StreamingMapper(backend="brick-sharded")`` at
      chunk 16 (map equal to phase 2's), and the node with
      ``map_backend: "brick-sharded"`` (as 6f, against a CPU mapper of as
      many shards);
   e. F64_PINGS pings in float64 at SHARDED_S shards, card vs CPU: stats
      and every array of every shard bit-equal; the occupied fan's trig
      lookup against direct cos/sin on the card.
   Each path's K1 launches are counted as in phase 5.
10. the sharded hash engine and the replicated-records brick engine on
   the card, their mesh the card repeated SHARDED_S times (in the window
   engines every shard computes every frame's records, so on one card
   their records half runs SHARDED_S times; the hash engine's window-1
   step computes each ping's records once):
   a. phase 2's survey through ``parallel.map_ping_sequence_sharded``
      (the sharded hash engine) at window 16, and its first HASH_W1_PINGS
      pings at window 1: per-ping stats, voxels and log-odds equal 7a's
      runs of the same pings, every voxel on its owner shard; wall,
      pings/s, rehash calls, voxels per shard, peak memory, the applies'
      seconds against the rest of the wall (the records half) and the
      ``backproject_ping`` calls; the window-1 wall beside 7a's window 1
      in the same call;
   b. ``save_map`` of that map: its snapshot's voxels, log-odds and
      bounds equal 7a's snapshot (step 7c's file); ``load_map`` of it;
   c. the survey through ``parallel.map_ping_sequence_sharded_brick``
      (the replicated-records brick engine, two-word codes, K1) at window
      16: stats, voxels and log-odds equal phase 2's; K1 against its
      plain version on the widest shard window; K1 launches counted as in
      phase 5;
   d. F64_PINGS pings in float64 through both engines, card vs CPU:
      per-ping stats and every array of every shard bit-equal;
   e. ``utils.profiling.device_trace`` around one sharded hash window:
      the Chrome trace it writes names CUDA kernels.

11. the rest of the port's surface on the card:
   a. OWNER_BLOCK_PINGS float64 pings through
      ``parallel.map_ping_sequence_sharded`` on the mixed mesh (card,
      CPU, card, CPU) against the CPU mesh, at window 1 (each ping's owner
      blocks made on the card and copied to the CPU shards) and at window
      OWNER_BLOCK_PINGS: per-ping stats and every array of every shard
      bit-equal; ``backproject_ping`` called once a ping at window 1 and
      SHARDED_S times a ping at the window; no growth;
   b. phase 2's survey through ``parallel.map_ping_sequence_sharded_
      frames(dense_mode="pallas-raw")`` at SHARDED_S shards, window 16:
      per-ping stats, voxels and log-odds equal phase 2's; K1-raw launches
      counted (one a shard a window, no K1); K1-raw against its plain
      version on the widest shard window in float32 and float64, timed
      against its bound;
   c. ``geometry.compose_pose_chain(pose_matrices_from_quaternions(...),
      T_mount)`` in float64 for the survey's poses on the card: within
      POSE_TOL of the host's ``batched_sonar_to_world``, and bit-equal
      (with ``rotations_from_quaternions``) to the CPU's.
12. the batched records half on the card (``records_batch``,
   ``window_group``): phase 2's survey (window 16, float32, the tables
   built once) in both dense modes at every records_batch of
   RECORDS_BATCHES and window_group of WINDOW_GROUPS: map state and every
   per-ping stat equal phase 2's (2b's for the raw mode) bit for bit; K1
   (or K1-raw) launches and peak memory of one run, kernel launches a
   ping and stream syncs a run of a profiled run (torch.profiler's
   ``cudaLaunchKernel`` and ``cudaStreamSynchronize`` events), and the
   median wall of BATCH_RUNS runs in alternating order; the dedup's first
   sort over one window's (16, N) words as one 2-D sort (the port's
   form), 16 row sorts and one flat sort with the frame folded above the
   word, device ms each;
   BATCH_F64_PINGS float64 pings at records_batch 16 and window_group 4
   in windows of 16 and of 4, card against CPU (stats and every state
   array bit-equal); ``python -m sonar_3d_reconstruction_tpu_torch bench``
   in subprocesses (BENCH_RUNS), each JSON line parsed and printed: at
   its defaults it hits ``bench_plan.json``'s entry of the survey's key
   (budgets equal to the entry, 16 K1 launches, 175,438 updates a ping),
   with ``BENCH_DENSE_MODE=pallas-raw`` it discovers its budgets (16
   K1-raw launches), and ``BENCH_COUNT_SIZED=1`` counts the same updates
   and unique updates; ``scripts/torch_profile_bench.py`` at each
   records_batch of TRACE_BATCHES (top kernels, launches a ping, syncs a
   run, busy share), its lines printed.
13. the port held to its golden oracle (``sonar_3d_reconstruction_tpu_
   torch.golden``, pure NumPy on the host) on the card, through
   ``scripts/torch_fuzz_golden.py``:
   a. GOLDEN_SEEDS fuzz trials (random configs and pings, drawn as
      ``scripts/fuzz_golden.py`` draws them) through every engine of the
      port in float64 (voxel sets and per-ping num_occupied / num_free
      equal to golden's, log-odds within 1e-9) and the brick engines in
      float32 (probabilities within 1e-5 on the common voxels; the voxels
      one map holds under 2e-3 of the common ones over the phase); K1 and
      K1-raw against their plain versions on each trial's widest window
      in float32 and float64;
   b. each production preset of PRESET_NAMES at 500x512 (from its YAML
      through ``load_config`` where PyYAML is installed, else from
      ``config.PRESETS``; the route is printed) on a pass at
      PRESET_DEPTH: its first PRESET_GOLDEN_PINGS pings against golden
      (float64 exact, float32 as in 13a) and the share of candidates the
      z filter drops (must be > 0); the PRESET_PINGS-ping survey at each
      records_batch of PRESET_BATCHES (maps and stats bit-equal; walls, K1
      launches, peak memory); the node under ``ros_stub()`` fed the
      preset's parameters and the survey's pings (map equal to the
      survey's);
   c. LONG_PINGS full-size pings: float32 records applied into a float32
      and a float64 brick map (probabilities within 1e-5 on every voxel,
      more than 500,000 voxels), and pure float32 against pure float64
      maps (voxels one map holds and common voxels over 1e-5 each under
      2e-3 of the common voxels, the 99.5th percentile within 1e-5).
   Any mismatch prints its repro line and fails the run.
14. the deployment budget plans of the single map: the survey tuned on
   the card (the plan held to ``bench_plan.json``), mapped with and
   without plans in both dense modes at records_batch 1 and 16 (maps
   and stats equal, syncs, launches, walls, K1 / K1-raw on the padded
   window), stale plans that replay, ``tune`` and ``map-bag --budgets``.
15. the sharded engines' and the multi-host fold's budgets, the card
   repeated as the mesh: (a) the survey through the frame-parallel engine
   at S = 2 and 4 (dedup) and S = 4 (raw), count-sized and with snug
   budgets from that run's stats (``_snug_unique`` and JAX's margins):
   maps and stats bit-equal (voxels = phase 2's), syncs a run, launches
   a ping, median wall of SB_RUNS alternating runs, peak memory, K1 /
   K1-raw against plain on the widest shard window count-sized and
   padded; (b) the replicated-records brick engine and the sharded hash
   engine (window 16, and window 1 with a unique budget), each map equal
   to the single-map pipeline's; (c) the fold of SB_HOSTS segments, brick
   and hash; (d) a quarter of each snug budget and SB_XCHG lanes a block
   at S = 4: the causes each scan names and the count-sized map, and
   SB_F64_PINGS float64 pings with budgets, card against CPU.
16. the records kernel (``kernels/box_words``, ``csrc/box_words.cu``) at
   the benchmark cell's batch (BOX_WORDS_FRAMES bench pings, the cell's
   lattice caps BOX_WORDS_CAPS: N = 233,728 lanes a ping), in both its
   forms (brick codes, which the cell's windows take, and box keys) and
   in float32 and float64: sort words and FrameAux bit-equal to the plain
   chain (``ops.records.sort_words_plain``), its device time a call
   (profiler) against its bytes' bound (the rays' columns of the images,
   the words, the tables and poses) and the plain chain's (CUDA events).
   Its launches join the kernels line: ``launches`` the warm main-path
   run's (phase 2 fails without one), ``launches_by_path`` phase 2's and
   2b's warm runs and each later phase's, with what the CLI's map-bag
   subprocesses report (the bench's subprocesses report none).

The line before the last is a JSON object describing each kernel, with
the bytes each call must move and its bound at the card's published
memory rate (HBM_BYTES_PER_S; for K1 also with u32 records, for K2 with
u32 key words); the last line is
``{"ok": true, "device": {...}}``.  Each kernel's entry also names the
paths that launched it (``paths``, ``launches_by_path``).  Exits non-zero
without a result when no CUDA device is visible.
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
SPIN_CYCLES = 200_000_000  # ~0.1 s of device spin ahead of event-timed calls
ENTRY_PINGS = 32      # bench pings timed one by one through the mapper
QUERY_POINTS = 100000  # point queries of the survey map
CLI_PINGS = 64        # pings of the CLI's synthetic bag
SELFTEST_CFG = {"voxel_resolution": 0.1, "min_probability": 0.6,
                "intensity_threshold": 30}


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


def _device_ms(fn, kernel_name, reps=20):
    """Device time per launch of the kernels named ``kernel_name`` while
    ``fn`` runs ``reps`` times, from torch.profiler.  The profiler records
    fewer kernels than were launched, more so the longer the process has
    profiled, and late in the script it may record none: it profiles
    again, and after PROFILE_TRIES runs without one it times the calls
    with CUDA events instead (``_event_ms``) and says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
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
    ms = _event_ms(fn, reps)
    print(f"  torch.profiler recorded no {kernel_name} launch in "
          f"{PROFILE_TRIES} runs: timed with CUDA events instead, "
          f"{ms:.4f} ms", flush=True)
    return ms


def _event_ms(fn, reps=20):
    """Device ms of one call of ``fn``: two CUDA events around ``reps``
    calls queued behind a spin kernel, so that the device runs them back
    to back and not at the host's pace.  Unlike the profiler's time it
    holds the gaps between the launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    the dict it yields (``L``: the lanes, ``args``: the inputs, ``kw``:
    the keyword arguments)."""
    from sonar_3d_reconstruction_tpu_torch.grid import brick

    name = "bin_apply_raw" if raw else "bin_apply"
    kept = {}
    fn = getattr(brick, name)

    def wrapped(s_flat, s_pay, starts, rows_cur, **kw):
        if s_flat.shape[0] > kept.get("L", -1):
            kept.update(L=s_flat.shape[0], kw=dict(kw), args=tuple(
                t.clone() for t in (s_flat, s_pay, starts, rows_cur)))
        return fn(s_flat, s_pay, starts, rows_cur, **kw)

    setattr(brick, name, wrapped)
    try:
        yield kept
    finally:
        setattr(brick, name, fn)


@contextlib.contextmanager
def count_rehashes():
    """While open, ``map_ping_sequence``'s hash growth also counts its
    calls (each one rehash and one replay, however many doublings it
    takes) in the dict it yields (``n``)."""
    from sonar_3d_reconstruction_tpu_torch import pipeline

    count = {"n": 0}
    fn = pipeline.rehash

    def wrapped(*args, **kw):
        count["n"] += 1
        return fn(*args, **kw)

    pipeline.rehash = wrapped
    try:
        yield count
    finally:
        pipeline.rehash = fn


# records-kernel launches that ``_reset_counts`` took off its count, plus
# those the CLI's subprocesses reported (``_words_launched``)
_WORDS_SET_ASIDE = {"n": 0}


def _reset_counts():
    from sonar_3d_reconstruction_tpu_torch.kernels import (
        bin_apply,
        box_words,
        lookup_accumulate,
    )

    bin_apply.launches = bin_apply.raw_launches = 0
    lookup_accumulate.launches = 0
    _WORDS_SET_ASIDE["n"] += box_words.launches
    box_words.launches = 0


def _words_launched():
    """Records-kernel (box_words) launches since the start, in this process
    and in the CLI's subprocesses (``_cli``)."""
    from sonar_3d_reconstruction_tpu_torch.kernels import box_words

    return _WORDS_SET_ASIDE["n"] + box_words.launches


def phase_build():
    from sonar_3d_reconstruction_tpu_torch.device import require_cuda
    from sonar_3d_reconstruction_tpu_torch.kernels import (
        bin_apply,
        box_words,
        lookup_accumulate,
    )

    dev = require_cuda()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        logs = list(pool.map(lambda m: m.build(),
                             (bin_apply, lookup_accumulate, box_words)))
    ptxas = [ln.strip() for log in logs for ln in log.splitlines()
             if "ptxas info" in ln or "spill" in ln]
    print(f"phase 1 build: bin_apply, lookup_accumulate and box_words "
          f"built in {time.perf_counter() - t0:.1f} s"
          + "".join(f"\n  {ln}" for ln in ptxas), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return dev, smi


def phase_main_path(dev, dense_mode):
    """Map the bench survey twice in ``dense_mode``; returns (the warm
    run's K1 launches of that mode, its records-kernel launches, its
    largest window's shape, the inputs of the widest window's K1 call
    (kept in the cold run), the final state, the per-ping stats)."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        extract_occupied_brick,
    )
    from sonar_3d_reconstruction_tpu_torch.kernels import (
        bin_apply,
        box_words,
    )
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
    words = box_words.launches
    peak = torch.cuda.max_memory_allocated(dev)

    if launches == 0:
        raise AssertionError(f"the {dense_mode} path never launched {name}")
    if words == 0:
        raise AssertionError(f"the {dense_mode} path never launched the "
                             f"records kernel (box_words)")
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
        f"{peak / 2**20:.1f} MiB, {name} launches {launches}, box_words "
        f"launches {words}; windows "
        f"{int(stats['batch_n_lanes'].min())}-"
        f"{int(stats['batch_n_lanes'].max())} lanes, widest NB="
        f"{int(stats['batch_n_bricks'][widest])} L="
        f"{int(stats['batch_n_lanes'][widest])}",
        flush=True,
    )
    if kept.get("L") != int(stats["batch_n_lanes"].max()):
        raise AssertionError("the cold run's widest K1 call was not the "
                             "warm run's widest window")
    return launches, words, shape, kept["args"], st, stats


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


def _wall(fn):
    """(fn(), host seconds around it, ending in a device sync)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _k1_launches_of(fn, raw=False, what=None):
    """(fn(), launches of the K1 form ``raw`` while it ran): the counts set
    to 0 just before and read just after; fails when it was not
    launched."""
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply

    _reset_counts()
    out = fn()
    n = bin_apply.raw_launches if raw else bin_apply.launches
    if n == 0:
        raise AssertionError(f"{what or fn.__name__} never launched "
                             f"{'bin_apply_raw' if raw else 'bin_apply'}")
    return out, n


def _without_times(stats):
    return {k: v for k, v in stats.items()
            if k not in ("processing_time", "avg_processing_time")}


def _entry_selftest(dev, smi):
    """Step a: the selftest scenario on the card and the CPU, then the
    per-ping time at the library defaults.  Returns (K1 launches of the
    card's mapper, ms per ping)."""
    import numpy as np

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.cli import selftest_pings
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.models import SonarMapper

    out = {}
    for name, device in (("gpu", dev), ("cpu", "cpu")):
        m = SonarMapper(SELFTEST_CFG, device=device)

        def selftest():
            return [_without_times(s) for s in selftest_pings(m)]

        if name == "gpu":
            (stats, launches), wall = _wall(lambda: _k1_launches_of(selftest))
        else:
            stats = selftest()
        pts, probs = (m.get_point_cloud()[k] for k in ("points",
                                                        "probabilities"))
        out[name] = (stats, {tuple(p): q for p, q in zip(pts.round(6), probs)})
    (g_stats, g), (c_stats, c) = out["gpu"], out["cpu"]
    if g_stats != c_stats:
        raise AssertionError(f"selftest stats differ: {g_stats} vs {c_stats}")
    if g.keys() != c.keys() or not g:
        raise AssertionError(f"selftest occupied sets differ: {len(g)} vs "
                             f"{len(c)}")
    diff = max(abs(g[k] - c[k]) for k in g)
    if diff > F32_PROB_TOL:
        raise AssertionError(f"selftest probabilities differ by {diff}")

    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, ENTRY_PINGS)
    m = SonarMapper(cfg, device=dev)
    ms = []
    for x in zip(images, positions, quats):
        _, t = _wall(lambda: m.process_sonar_image(*x))
        ms.append(t * 1e3)
    warm = np.asarray(ms[1:])
    print(
        f"phase 5a selftest: 3 pings of 500x512 through "
        f"SonarMapper.process_sonar_image on the card and the CPU: per-ping "
        f"stats equal ({g_stats[-1]['num_occupied']} occupied, "
        f"{g_stats[-1]['num_free']} free in the last), {len(g)} occupied "
        f"voxels equal, max probability diff {diff:.3g} (tolerance "
        f"{F32_PROB_TOL}); card wall {wall:.3f} s, {launches} bin_apply "
        f"launches; then {ENTRY_PINGS} bench pings at the library defaults: "
        f"first {ms[0]:.1f} ms, then median {np.median(warm):.2f} ms, mean "
        f"{warm.mean():.2f} ms, max {warm.max():.2f} ms per ping, "
        f"{m.num_voxels} voxels [{smi}]",
        flush=True,
    )
    return launches, float(np.median(warm))


def _query_points(keys, res, rng):
    """QUERY_POINTS world points: touched voxel centres, voxel lower
    corners (cell boundaries) and untouched voxel centres, in thirds."""
    import numpy as np

    n = QUERY_POINTS // 3
    touched = keys[rng.integers(0, len(keys), size=n)].astype(np.float64)
    corners = keys[rng.integers(0, len(keys), size=n)].astype(np.float64)
    far = keys[rng.integers(0, len(keys), size=QUERY_POINTS - 2 * n)]
    far = far + rng.integers(-40, 40, size=far.shape) + [0, 0, 400]
    return np.concatenate([(touched + 0.5) * res, corners * res,
                           (far + 0.5) * res])


def _host_probabilities(pts, keys, log_odds, res):
    """The answers of a query on the host: float64 keys of the points,
    looked up among the touched voxels (0.5 where none)."""
    import numpy as np

    def code(k):
        k = k.astype(np.int64) + (1 << 20)
        return (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]

    q = np.floor(pts / res).astype(np.int64)
    codes = code(keys)
    order = np.argsort(codes)
    pos = np.clip(np.searchsorted(codes[order], code(q)), 0, len(codes) - 1)
    hit = codes[order][pos] == code(q)
    lo = np.where(hit, log_odds[order][pos], 0).astype(np.float64)
    return 1.0 / (1.0 + np.exp(-lo)), hit


def _entry_sequence_and_reads(dev, smi, main_voxels):
    """Steps b and c.  Returns (K1 launches of map_sequence, timings)."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        brick_state_to_numpy,
        touched_voxels_brick,
    )
    from sonar_3d_reconstruction_tpu_torch.io.checkpoint import (
        load_map_brick,
        save_map,
    )
    from sonar_3d_reconstruction_tpu_torch.models import SonarMapper

    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, 256)
    m = SonarMapper(cfg, device=dev)

    def map_sequence():
        return m.map_sequence(images, positions, quats, window=16)

    (stats, launches), seq_s = _wall(lambda: _k1_launches_of(map_sequence))
    if stats["overflowed"].any():
        raise AssertionError("a map_sequence window overflowed")
    keys, log_odds = touched_voxels_brick(m.state)
    if not (np.array_equal(keys, main_voxels[0])
            and np.array_equal(log_odds, main_voxels[1])):
        raise AssertionError("map_sequence's voxels differ from phase 2's map")
    print(
        f"phase 5b map_sequence: 256 pings, window 16, fresh SonarMapper: "
        f"{len(keys)} touched voxels and their log-odds equal phase 2's map "
        f"(tolerance 0); wall {seq_s:.3f} s, {launches} bin_apply launches "
        f"[{smi}]",
        flush=True,
    )

    cloud, cloud_s = _wall(lambda: m.get_point_cloud(include_free=True))
    n_cls = cloud["num_occupied"] + cloud["num_free"] + cloud["num_unknown"]
    if n_cls != m.num_voxels or cloud["num_occupied"] == 0 or not all(
            np.isfinite(cloud[k][0]).all() and np.isfinite(cloud[k][1]).all()
            for k in ("occupied", "free", "unknown")):
        raise AssertionError(f"classified cloud of {n_cls} voxels, map has "
                             f"{m.num_voxels}, or not finite")
    rng = np.random.default_rng(5)
    pts = _query_points(keys, cfg.voxel_resolution, rng)
    want, hit = _host_probabilities(pts, keys, log_odds, cfg.voxel_resolution)
    far = slice(2 * (QUERY_POINTS // 3), None)
    if hit[far].any():
        raise AssertionError("an untouched query point lies in a touched voxel")
    got, query_s = _wall(lambda: m.query_probabilities(pts))
    if not np.array_equal(got, want) or not (got[far] == 0.5).all():
        raise AssertionError(f"query_probabilities differ from the host's: "
                             f"max |diff| {np.abs(got - want).max()}")

    path = os.path.join(ROOT, "build", "chip_smoke", "survey.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _, save_s = _wall(lambda: save_map(path, m.state, cfg))
    (state, _), load_s = _wall(lambda: load_map_brick(path, device=dev))
    if state.log_odds.device != dev:
        raise AssertionError(f"the snapshot loaded on {state.log_odds.device}")
    l_keys, l_lo = touched_voxels_brick(state)
    if not (np.array_equal(l_keys, keys) and np.array_equal(l_lo, log_odds)
            and torch.equal(state.min_bounds, m.state.min_bounds)
            and torch.equal(state.max_bounds, m.state.max_bounds)):
        raise AssertionError("the loaded snapshot differs from the map")
    print(
        f"phase 5c reads: get_point_cloud(include_free=True) "
        f"{cloud['num_occupied']} occupied, {cloud['num_free']} free, "
        f"{cloud['num_unknown']} unknown in {cloud_s:.3f} s; "
        f"query_probabilities at {len(pts)} points (touched centres, voxel "
        f"corners, {int((~hit).sum())} untouched at 0.5) equal to the host's "
        f"answers, {query_s * 1e3:.1f} ms; save_map {save_s:.3f} s "
        f"({os.path.getsize(path)} bytes), load_map_brick on the card "
        f"{load_s:.3f} s, {len(l_keys)} voxels bit-equal [{smi}]",
        flush=True,
    )
    return launches, dict(map_sequence_s=seq_s, point_cloud_s=cloud_s,
                          query_ms=query_s * 1e3, save_map_s=save_s,
                          load_map_brick_s=load_s, voxels=len(keys))


def _cli(*argv):
    """Run the port's CLI in a subprocess; (stdout, seconds).  A non-zero
    exit fails the phase."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sonar_3d_reconstruction_tpu_torch", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise AssertionError(f"CLI {argv[0]} exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    try:
        summary = json.loads(proc.stdout.splitlines()[-1])
    except (IndexError, ValueError):
        summary = None
    if isinstance(summary, dict):  # map-bag's summary
        _WORDS_SET_ASIDE["n"] += summary.get("box_words_launches", 0)
    return proc.stdout, time.perf_counter() - t0


def _entry_cli(dev, smi):
    """Step d.  Returns (K1 launches the CLI's map-bag reported, its
    summary)."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.io.bag import load_bag_sequence
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    bag, snap, pc2 = (os.path.join(work, f) for f in
                      ("cli.db3", "cli.npz", "cli.pc2"))
    for f in (bag, snap, pc2):
        if os.path.exists(f):
            os.unlink(f)
    _, make_s = _cli("make-bag", bag, "--pings", str(CLI_PINGS))
    out, map_s = _cli("map-bag", bag, "--offline", "--window", "16",
                      "--save-map", snap, "--save-cloud", pc2)
    summary = json.loads(out.splitlines()[-1])
    images, positions, quats, _ = load_bag_sequence(bag)
    (st, _), warm_s = _wall(lambda: map_ping_sequence(
        images, positions, quats, MapperConfig(), device=dev,
        dtype=torch.float32, window=16))
    if (summary["pairs"] != CLI_PINGS or summary["num_voxels"] != int(st.used)
            or summary["device"] != str(dev)
            or summary["bin_apply_launches"] == 0):
        raise AssertionError(f"map-bag summary {summary} against "
                             f"{int(st.used)} voxels in-process on {dev}")
    xyzi = np.fromfile(pc2, "<f4").reshape(-1, 4)
    x, y, z, p = (float(v) for v in xyzi[len(xyzi) // 2])
    out, query_s = _cli("query", snap, "--", f"{x},{y},{z}",
                        "1000.0,1000.0,1000.0")
    rows = [json.loads(ln) for ln in out.splitlines()]
    if abs(rows[0]["probability"] - p) > 1e-6 or rows[1]["probability"] != 0.5:
        raise AssertionError(f"query answered {rows}, cloud says {p} and 0.5")
    print(
        f"phase 5d CLI: make-bag {CLI_PINGS} pings of 500x512 {make_s:.1f} s; "
        f"map-bag --offline --window 16: {summary['num_voxels']} voxels "
        f"(equal in-process, where the same map takes {warm_s:.3f} s warm), "
        f"{len(xyzi)} cloud points, load "
        f"{summary['load_time']:.3f} s, map {summary['map_time']:.3f} s, "
        f"{summary['pings_per_sec']:.1f} pings/s, realtime factor "
        f"{summary['realtime_factor']:.1f}, {summary['bin_apply_launches']} "
        f"bin_apply launches, process {map_s:.1f} s; query {query_s:.1f} s "
        f"(p={rows[0]['probability']:.6f} at a cloud point, 0.5 far off); "
        f"every exit code 0 [{smi}]",
        flush=True,
    )
    return summary["bin_apply_launches"], dict(
        {k: summary[k] for k in ("map_time", "load_time", "pings_per_sec",
                                 "realtime_factor", "num_voxels")},
        make_bag_s=make_s, map_bag_process_s=map_s, query_process_s=query_s,
        in_process_warm_map_s=warm_s)


def phase_entry_points(dev, smi, main_voxels):
    """Phase 5.  Returns ({path: K1 launches}, measured entry-point
    numbers)."""
    t0 = time.perf_counter()
    ping_launches, ping_ms = _entry_selftest(dev, smi)
    seq_launches, reads = _entry_sequence_and_reads(dev, smi, main_voxels)
    cli_launches, cli = _entry_cli(dev, smi)
    print(f"phase 5 entry points: {time.perf_counter() - t0:.1f} s [{smi}]",
          flush=True)
    return (
        {"mapper.process_sonar_image": ping_launches,
         "mapper.map_sequence": seq_launches, "cli map-bag": cli_launches},
        dict(reads, process_sonar_image_ms=ping_ms, cli_map_bag=cli),
    )


STREAM_PINGS = 256    # phase 6a / 6c: phase 2's survey through the stream
LATENCY_PINGS = 96    # phase 6b: chunk = window = 1, as bench.py measures it
F64_PINGS = 16        # phase 6d: float64 on the card and the CPU
F64_TOL = 1e-12       # log-odds bar of 6d (CUDA's exp is not the CPU's)
F32_LOG_ODDS_TOL = 1e-5  # log-odds bar of float32 maps, card vs CPU (6b, 6f)
NODE_PINGS = 16       # phase 6f: pairs delivered to the node
NODE_PHASE = {"brick": "6f", "hash": "7d", "dense": "8c",
              "brick-sharded": "9d"}


def _survey_msgs(n, inputs=None):
    """The first n pings of phase 2's survey (of ``inputs``, (images,
    positions, quats), when given) as (ImageMsg, OdometryMsg) pairs
    stamped 1000.0 + 0.1 i."""
    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.io.bag import ImageMsg, OdometryMsg

    images, positions, quats = inputs or make_inputs(MapperConfig(), n)
    h, w = images.shape[1:]
    return [(ImageMsg(1000.0 + 0.1 * i, "sonar_link", h, w, "mono8", False, w,
                      images[i].tobytes()),
             OdometryMsg(1000.0 + 0.1 * i, "camera_init", "body", positions[i],
                         quats[i]))
            for i in range(n)]


def _msg_arrays(msgs):
    """(images, positions, quats) of (ImageMsg, OdometryMsg) pairs."""
    import numpy as np

    return (np.stack([np.frombuffer(i.data, np.uint8).reshape(i.height,
                                                              i.width)
                      for i, _ in msgs]),
            np.stack([o.position for _, o in msgs]),
            np.stack([o.orientation for _, o in msgs]))


def _stream(msgs, device, stream_cfg=None, **kw):
    """A StreamingMapper at the library defaults fed ``msgs`` back to back
    and finished."""
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.stream import StreamingMapper

    sm = StreamingMapper(MapperConfig(), stream_cfg, device=device, **kw)
    for img, odom in msgs:
        sm.on_ping(img)
        sm.on_pose(odom)
    sm.finish()
    return sm


@contextlib.contextmanager
def keep_stream_stats():
    """While open, the stream's chunk engine also keeps each chunk's
    per-ping stats in the list it yields."""
    from sonar_3d_reconstruction_tpu_torch import stream

    kept = []
    fn = stream.map_ping_sequence

    def wrapped(*args, **kw):
        state, stats = fn(*args, **kw)
        kept.append(stats)
        return state, stats

    stream.map_ping_sequence = wrapped
    try:
        yield kept
    finally:
        stream.map_ping_sequence = fn


def _short(summary):
    return {k: (round(v, 6) if isinstance(v, float) else v)
            for k, v in summary.items()}


def _stream_main(dev, smi, msgs, main_voxels):
    """6a: the survey through the stream in both dense modes; returns
    ({path: launches}, facts)."""
    import numpy as np

    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        brick_state_to_numpy,
        touched_voxels_brick,
    )

    launches, facts = {}, {}
    for mode, path in (("pallas", "stream (chunk 16)"),
                       ("pallas-raw", "stream (pallas-raw)")):
        raw = mode == "pallas-raw"
        (sm, n), wall = _wall(lambda: _k1_launches_of(
            lambda: _stream(msgs, dev, chunk_size=16, window=16,
                            dense_mode=mode), raw=raw, what=path))
        keys, log_odds = touched_voxels_brick(sm.state)
        if not (np.array_equal(keys, main_voxels[0])
                and np.array_equal(log_odds, main_voxels[1])):
            raise AssertionError(f"{path}: the stream's map differs from "
                                 f"phase 2's")
        if (sm.stats.frames_mapped != len(msgs)
                or sm.stats.chunks != -(-len(msgs) // 16)):
            raise AssertionError(f"{path}: {sm.stats.summary()}")
        launches[path] = n
        facts[mode] = dict(wall_s=wall, pings_per_sec=len(msgs) / wall,
                           summary=sm.stats.summary())
        print(
            f"phase 6a stream ({mode}): {len(msgs)} pings of 500x512 as "
            f"ImageMsg/OdometryMsg pairs, chunk 16, window 16, float32: "
            f"{len(keys)} touched voxels and their log-odds equal phase 2's "
            f"map (tolerance 0); wall {wall:.3f} s, {len(msgs) / wall:.1f} "
            f"pings/s, {'bin_apply_raw' if raw else 'bin_apply'} launches "
            f"{n}; summary {json.dumps(_short(sm.stats.summary()))} [{smi}]",
            flush=True,
        )
    return launches, facts


def _stream_latency(dev, smi, msgs, ping_ms):
    """6b: chunk = window = 1 over the first LATENCY_PINGS pings, twice;
    the warm pass's map against the same pings mapped on the CPU.  Returns
    (launches of the warm pass, its latency facts)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    msgs = msgs[:LATENCY_PINGS]
    for _ in range(2):  # the second, warm pass is the one reported
        (sm, n), wall = _wall(lambda: _k1_launches_of(
            lambda: _stream(msgs, dev, chunk_size=1, window=1),
            what="stream (chunk 1)"))
    s = sm.stats.summary()
    if sm.stats.frames_mapped != len(msgs) or len(sm.stats.latencies) != len(msgs):
        raise AssertionError(f"stream (chunk 1): {s}")
    t0 = time.perf_counter()
    cpu, _ = map_ping_sequence(*_msg_arrays(msgs), MapperConfig(),
                               device="cpu", dtype=torch.float32, window=16)
    cpu_s = time.perf_counter() - t0
    voxels, diff, n_diff = _same_voxels(_touched(sm.state), _touched(cpu),
                                        F32_LOG_ODDS_TOL, "stream (chunk 1)")
    lat = dict(p50_ms=s["latency_p50_s"] * 1e3, p95_ms=s["latency_p95_s"] * 1e3,
               max_ms=s["latency_max_s"] * 1e3, wall_s=wall,
               pings_per_sec=len(msgs) / wall, voxels=voxels,
               max_abs_diff_vs_cpu=diff, cpu_wall_s=cpu_s)
    print(
        f"phase 6b ping-to-map latency: {len(msgs)} pings back to back, "
        f"chunk = window = 1, float32, warm pass: p50 {lat['p50_ms']:.2f} ms, "
        f"p95 {lat['p95_ms']:.2f} ms, max {lat['max_ms']:.2f} ms (arrival to "
        f"commit, per frame); {lat['pings_per_sec']:.1f} pings/s, {n} "
        f"bin_apply launches; process_sonar_image median {ping_ms:.2f} ms "
        f"(phase 5a); {voxels} voxels equal to the same pings mapped on the "
        f"CPU (window 16, {cpu_s:.1f} s), log-odds max |diff| {diff:.3g} "
        f"(tolerance {F32_LOG_ODDS_TOL}), {voxels - n_diff} bit-equal [{smi}]",
        flush=True,
    )
    return n, lat


def _stream_publish(dev, smi, msgs, main_voxels):
    """6c: publish at 1 Hz of stream time; a final tick byte-equal to the
    cloud computed on the host from phase 2's map (the stream maps the same
    survey).  Returns facts."""
    import numpy as np

    from sonar_3d_reconstruction_tpu_torch.config import (
        MapperConfig,
        StreamConfig,
    )
    from sonar_3d_reconstruction_tpu_torch.io.pointcloud import (
        serialize_pointcloud2,
    )
    from sonar_3d_reconstruction_tpu_torch.ops.logodds import (
        probability_to_log_odds,
    )
    from sonar_3d_reconstruction_tpu_torch.stream import StreamingMapper

    cfg, sent, ticks = MapperConfig(), [], []
    sm = StreamingMapper(cfg, StreamConfig(publish_rate_hz=1.0), chunk_size=16,
                         window=16, publish=sent.append, device=dev)
    extract = sm.pointcloud_msg

    def tick(stamp=0.0):
        t0 = time.perf_counter()
        msg = extract(stamp=stamp)
        ticks.append(time.perf_counter() - t0)
        return msg

    sm.pointcloud_msg = tick
    t0 = time.perf_counter()
    for img, odom in msgs:
        sm.on_ping(img)
        sm.on_pose(odom)
    sm.finish()
    wall = time.perf_counter() - t0
    last = sm.pointcloud_msg(stamp=2000.0)  # a final tick
    keys, log_odds = main_voxels
    lo = log_odds.astype(np.float64)
    occ = lo > probability_to_log_odds(cfg.min_probability, cfg)
    want = serialize_pointcloud2(
        (keys[occ].astype(np.float64) + 0.5) * cfg.voxel_resolution,
        1.0 / (1.0 + np.exp(-lo[occ])), frame_id=last["header"]["frame_id"],
        stamp=(2000, 0))
    if last != want or len(sent) < 3:
        raise AssertionError(f"the final tick differs from phase 2's occupied "
                             f"voxels ({last['width']} vs {want['width']} "
                             f"points), or {len(sent)} messages")
    widths = [m["width"] for m in sent + [last]]
    facts = dict(ticks=len(ticks), median_tick_ms=float(np.median(ticks)) * 1e3,
                 max_tick_ms=float(np.max(ticks)) * 1e3, wall_s=wall,
                 bytes_per_tick_mean=16 * float(np.mean(widths)),
                 bytes_last_tick=16 * widths[-1])
    print(
        f"phase 6c publish: {len(msgs)} pings, chunk 16, 1 Hz of stream "
        f"time: {len(sent)} messages and a final tick, equal to phase 2's "
        f"{last['width']} occupied voxels; median "
        f"{facts['median_tick_ms']:.1f} ms per tick (max "
        f"{facts['max_tick_ms']:.1f}); {facts['bytes_per_tick_mean']:.0f} "
        f"bytes per tick on average, {facts['bytes_last_tick']} in the last; "
        f"run wall {wall:.3f} s [{smi}]",
        flush=True,
    )
    return facts


def _stream_float64(dev, smi, msgs):
    """6d: F64_PINGS pings in float64, chunk 8, on the card and the CPU:
    per-ping stats equal, voxel sets equal, log-odds within F64_TOL."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        brick_state_to_numpy,
        touched_voxels_brick,
    )

    out = {}
    for name, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
        with keep_stream_stats() as kept:
            sm, wall = _wall(lambda: _stream(
                msgs[:F64_PINGS], device, chunk_size=8, window=8,
                dtype=torch.float64))
        stats = {k: np.concatenate([c[k] for c in kept]) for k in kept[0]}
        out[name] = (stats, touched_voxels_brick(sm.state), wall)
    (g_stats, (g_keys, g_lo), g_wall), (c_stats, (c_keys, c_lo), c_wall) = (
        out["gpu"], out["cpu"])
    for k in g_stats:
        if not np.array_equal(g_stats[k], c_stats[k]):
            raise AssertionError(f"float64 per-ping {k} differs, card vs CPU")
    if not np.array_equal(g_keys, c_keys) or g_lo.dtype != np.float64:
        raise AssertionError(f"float64 voxel sets differ: {len(g_keys)} on "
                             f"the card, {len(c_keys)} on the CPU")
    diff = float(np.abs(g_lo - c_lo).max())
    if diff > F64_TOL:
        raise AssertionError(f"float64 log-odds differ by {diff}")
    n_exact = int((g_lo == c_lo).sum())
    print(
        f"phase 6d float64: {F64_PINGS} pings of 500x512, chunk 8, window 8, "
        f"on the card and the CPU: per-ping {', '.join(g_stats)} equal, "
        f"{len(g_keys)} voxels equal, log-odds max |diff| {diff:.3g} "
        f"(tolerance {F64_TOL}), {n_exact} bit-equal; walls {g_wall:.3f} s "
        f"card, {c_wall:.3f} s CPU [{smi}]",
        flush=True,
    )
    return dict(voxels=len(g_keys), max_abs_diff=diff, bit_equal=n_exact,
                card_wall_s=g_wall, cpu_wall_s=c_wall)


def _stream_cli(dev, smi, offline_voxels):
    """6e: map-bag without --offline on phase 5d's bag in a fresh process;
    returns (its K1 launches, its summary)."""
    work = os.path.join(ROOT, "build", "chip_smoke")
    bag, snap = (os.path.join(work, f) for f in ("cli.db3", "stream.npz"))
    out, proc_s = _cli("map-bag", bag, "--chunk", "16", "--window", "16",
                       "--publish", "--save-map", snap)
    s = json.loads(out.splitlines()[-1])
    if (s["num_voxels"] != offline_voxels or s["device"] != str(dev)
            or s["bin_apply_launches"] == 0 or s["frames_mapped"] != CLI_PINGS
            or s["publishes"] == 0 or not os.path.exists(snap)):
        raise AssertionError(f"streaming map-bag summary {s} against "
                             f"{offline_voxels} voxels offline on {dev}")
    print(
        f"phase 6e streaming CLI: map-bag --chunk 16 --window 16 --publish "
        f"--save-map on the {CLI_PINGS}-ping bag: {s['num_voxels']} voxels "
        f"(equal to map-bag --offline), {s['pings_per_sec']:.1f} pings/s "
        f"(wall {s['wall_time']:.3f} s), latency p50 "
        f"{s['latency_p50_s'] * 1e3:.1f} ms p95 {s['latency_p95_s'] * 1e3:.1f}"
        f" ms, {s['publishes']} publishes ({s['publish_bytes']} bytes), "
        f"{s['bin_apply_launches']} bin_apply launches, device {s['device']}, "
        f"process {proc_s:.1f} s [{smi}]",
        flush=True,
    )
    return s["bin_apply_launches"], dict(
        {k: s[k] for k in ("wall_time", "pings_per_sec", "latency_p50_s",
                           "latency_p95_s", "publishes", "publish_bytes",
                           "num_voxels")}, process_s=proc_s)


def ros_stub():
    """Minimal rclpy / ROS message modules for the node: parameters with
    overrides (``Node.overrides``), recording publishers, timers to fire by
    hand, a fixed clock, and a two-topic synchronizer over the port's
    ApproximateTimeSync.  Returns the modules to put in sys.modules."""
    import types

    from sonar_3d_reconstruction_tpu_torch.io.timesync import (
        ApproximateTimeSync,
    )

    def bag(**kw):
        return types.SimpleNamespace(**kw)

    def stamp(sec=0, nanosec=0):
        return bag(sec=sec, nanosec=nanosec)

    class Msg:
        def __init__(self, **kw):
            self.header = bag(stamp=stamp(), frame_id="")
            self.__dict__.update(kw)

    class Marker(Msg):
        def __init__(self):
            super().__init__(scale=bag(), color=bag(), points=[])

    class Publisher:
        def __init__(self, topic):
            self.topic, self.published = topic, []

        def publish(self, msg):
            self.published.append(msg)

    class Logger:
        def __init__(self):
            self.records = []

        def info(self, m):
            self.records.append(("info", m))

        def error(self, m):
            self.records.append(("error", m))

    class Node:
        overrides = {}

        def __init__(self, name):
            self.params, self.publishers, self.timers = {}, [], []
            self.logger = Logger()

        def declare_parameter(self, name, default):
            self.params[name] = bag(value=self.overrides.get(name, default))

        def get_parameter(self, name):
            return self.params[name]

        def create_publisher(self, _type, topic, _depth):
            self.publishers.append(Publisher(topic))
            return self.publishers[-1]

        def create_timer(self, period, callback):
            self.timers.append(bag(period=period, fire=callback))

        def get_logger(self):
            return self.logger

        def get_clock(self):
            return bag(now=lambda: bag(to_msg=lambda: stamp(100, 0)))

        def destroy_node(self):
            pass

    class Subscriber:
        def __init__(self, _node, _type, topic, qos_profile=None):
            self.topic = topic

        def deliver(self, msg):
            t = msg.header.stamp.sec + 1e-9 * msg.header.stamp.nanosec
            self.add(msg, t)

    class Synchronizer:
        def __init__(self, subs, queue_size=10, slop=0.1):
            self.subscribers = subs
            self.sync = ApproximateTimeSync(lambda a, b: self.cb(a, b),
                                            queue_size=queue_size, slop=slop)
            subs[0].add, subs[1].add = self.sync.add_ping, self.sync.add_pose

        def registerCallback(self, cb):
            self.cb = cb

    class Broadcaster:
        def __init__(self, node):
            self.sent = []

        def sendTransform(self, t):
            self.sent.append(t)

    def mod(name, **attrs):
        m = types.ModuleType(name)
        m.__dict__.update(attrs)
        return m

    msg = dict(Image=Msg, PointCloud2=Msg, PointField=bag, Odometry=Msg,
               Point=bag, TransformStamped=lambda: Msg(
                   child_frame_id="", transform=bag(translation=bag(),
                                                    rotation=bag())),
               Marker=Marker, MarkerArray=lambda: bag(markers=[]))
    policy = bag(BEST_EFFORT=1, KEEP_LAST=1)
    return {
        "rclpy": mod("rclpy", init=lambda args=None: None,
                     spin=lambda node: None, shutdown=lambda: None),
        "rclpy.node": mod("rclpy.node", Node=Node),
        "rclpy.qos": mod("rclpy.qos", QoSProfile=bag, ReliabilityPolicy=policy,
                         HistoryPolicy=policy),
        "sensor_msgs": mod("sensor_msgs"),
        "sensor_msgs.msg": mod("sensor_msgs.msg", **msg),
        "nav_msgs": mod("nav_msgs"),
        "nav_msgs.msg": mod("nav_msgs.msg", **msg),
        "geometry_msgs": mod("geometry_msgs"),
        "geometry_msgs.msg": mod("geometry_msgs.msg", **msg),
        "visualization_msgs": mod("visualization_msgs"),
        "visualization_msgs.msg": mod("visualization_msgs.msg", **msg),
        "tf2_ros": mod("tf2_ros", StaticTransformBroadcaster=Broadcaster),
        "message_filters": mod("message_filters", Subscriber=Subscriber,
                               ApproximateTimeSynchronizer=Synchronizer),
    }


def _ros_pair(img, odom):
    """An (ImageMsg, OdometryMsg) pair as the ROS stub's messages."""
    import types

    def header(t):
        return types.SimpleNamespace(stamp=types.SimpleNamespace(
            sec=int(t), nanosec=int(round((t % 1.0) * 1e9))))
    i = types.SimpleNamespace(
        header=header(img.stamp), height=img.height, width=img.width,
        encoding=img.encoding, is_bigendian=img.is_bigendian,
        step=img.step, data=img.data)
    p, q = odom.position, odom.orientation
    o = types.SimpleNamespace(
        header=header(odom.stamp), pose=types.SimpleNamespace(
            pose=types.SimpleNamespace(
                position=types.SimpleNamespace(x=p[0], y=p[1], z=p[2]),
                orientation=types.SimpleNamespace(
                    x=q[0], y=q[1], z=q[2], w=q[3]))))
    return i, o


@contextlib.contextmanager
def stub_node(overrides):
    """While open, the port's SonarMapperNode built under ros_stub() with
    the parameters ``overrides`` (the reference defaults elsewhere);
    afterwards sys.modules and the node module are as they were."""
    import importlib

    import sonar_3d_reconstruction_tpu_torch.node as node_mod

    stub = ros_stub()
    saved = {name: sys.modules.get(name) for name in stub}
    sys.modules.update(stub)
    try:
        importlib.reload(node_mod)
        if not node_mod._ROS2:
            raise AssertionError("the node did not take the ROS stub")
        stub["rclpy.node"].Node.overrides = dict(overrides)
        yield node_mod.SonarMapperNode()
    finally:
        for name, m in saved.items():
            if m is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = m
        importlib.reload(node_mod)


def _deliver(node, pairs):
    """Deliver ROS stub message pairs to the node's synchronizer; returns
    the frames its mapper has mapped."""
    sonar_sub, odom_sub = node._sync.subscribers
    for i, o in pairs:
        sonar_sub.deliver(i)
        odom_sub.deliver(o)
    return node.mapper.frame_count


def _node(dev, smi, msgs, backend="brick"):
    """6f (7d with ``backend="hash"``, 8c with "dense"): the port's node
    under ros_stub() with that ``map_backend``: NODE_PINGS full-size
    pairs, the publish timer once with the cloud and once with the
    markers; its map against a CPU SonarMapper of the backend fed the same
    pings.  Returns (its K1 launches, None on the hash and dense maps,
    which launch no kernel; facts).  With "brick-sharded" (9d) the CPU
    mapper has as many shards as the node's mesh."""
    from sonar_3d_reconstruction_tpu_torch.models import SonarMapper
    from sonar_3d_reconstruction_tpu_torch.io.pointcloud import (
        serialize_pointcloud2,
    )

    # the reference defaults but for the map backend
    with stub_node({"map_backend": backend}) as node:
        pairs = [_ros_pair(*m) for m in msgs[:NODE_PINGS]]

        def deliver():
            return _deliver(node, pairs)

        if backend in ("hash", "dense"):
            (frames, n), wall = _wall(lambda: (deliver(), None))
        else:
            (frames, n), wall = _wall(lambda: _k1_launches_of(deliver,
                                                              what="node"))
        if (frames != NODE_PINGS or node.mapper.device != dev
                or node.mapper.backend != backend):
            raise AssertionError(f"node mapped {frames} frames on "
                                 f"{node.mapper.device}")
        mesh = node.mapper.mesh
        cpu = SonarMapper(node.mapper.cfg, backend=backend, device="cpu",
                          mesh=None if mesh is None else ["cpu"] * len(mesh))
        for x in zip(*_msg_arrays(msgs[:NODE_PINGS])):
            cpu.process_sonar_image(*x)
        voxels, diff, n_diff = _same_voxels(
            _touched(node.mapper.state, node.mapper.dense_spec),
            _touched(cpu.state, cpu.dense_spec), F32_LOG_ODDS_TOL, "node")
        pubs = {p.topic: p for p in node.publishers}
        _, tick_s = _wall(node.timers[0].fire)
        msg = pubs["/sonar_3d_map"].published[-1]
        cloud = node.mapper.get_point_cloud()
        want = serialize_pointcloud2(cloud["points"], cloud["probabilities"])
        if msg.data != want["data"] or msg.width == 0:
            raise AssertionError("the node's PointCloud2 differs from its "
                                 "mapper's extraction")
        node.show_free_space = True
        _, marker_s = _wall(node.timers[0].fire)
        markers = pubs["/sonar_3d_map_markers"].published[-1].markers
        cls = node.mapper.get_point_cloud(include_free=True)
        counts = {m.ns: len(m.points) for m in markers}
        if counts != {f"sonar_3d_map_{k}": len(cls[k][0])
                      for k in ("occupied", "free", "unknown")}:
            raise AssertionError(f"marker counts {counts}")
    print(
        f"phase {NODE_PHASE[backend]} node: {NODE_PINGS} "
        f"pairs of 500x512 through the ROS stub's synchronizer into "
        f"SonarMapperNode at the reference defaults, map_backend {backend!r},"
        f" map on {node.mapper.device}"
        + ("" if mesh is None else f" ({len(mesh)} shards)")
        + f": {n or 0} bin_apply "
        f"launches, {wall:.3f} s; {voxels} voxels equal to a CPU "
        f"SonarMapper fed the same pings, log-odds max |diff| {diff:.3g} "
        f"(tolerance "
        f"{F32_LOG_ODDS_TOL}), {voxels - n_diff} bit-equal; publish tick "
        f"{tick_s * 1e3:.1f} ms, "
        f"{msg.width} points equal to the mapper's extraction; marker tick "
        f"{marker_s * 1e3:.1f} ms ({counts}) [{smi}]",
        flush=True,
    )
    return n, dict(ingest_s=wall, publish_tick_ms=tick_s * 1e3,
                   marker_tick_ms=marker_s * 1e3, points=msg.width,
                   voxels=voxels, max_abs_diff_vs_cpu=diff)


def phase_stream(dev, smi, main_voxels, ping_ms, offline_voxels):
    """Phase 6: the streaming runtime, the streaming CLI and the node.
    Returns ({kernel: {path: launches}}, measured numbers)."""
    t0 = time.perf_counter()
    msgs = _survey_msgs(STREAM_PINGS)
    launches, main = _stream_main(dev, smi, msgs, main_voxels)
    launches["stream (chunk 1)"], latency = _stream_latency(dev, smi, msgs,
                                                             ping_ms)
    publish = _stream_publish(dev, smi, msgs, main_voxels)
    f64 = _stream_float64(dev, smi, msgs)
    launches["cli map-bag (stream)"], cli = _stream_cli(dev, smi,
                                                        offline_voxels)
    launches["node"], node = _node(dev, smi, msgs)
    print(f"phase 6 stream and node: {time.perf_counter() - t0:.1f} s "
          f"[{smi}]", flush=True)
    raw = {"stream (pallas-raw)": launches.pop("stream (pallas-raw)")}
    return {"bin_apply": launches, "bin_apply_raw": raw}, dict(
        stream=main, latency_chunk1=latency, publish=publish, float64=f64,
        cli_map_bag_stream=cli, node=node)


HASH_W1_PINGS = 32    # phase 7a: window 1 (update_hash_grid per ping)
WIDE_RANGE = 30.0     # phase 7b: m; the survey's windows then need wide keys
# phase 7b prefixes of the survey, cut for time (the widths stay): the
# map at 30 m (10.7M voxels at 64 pings) is checked on the host, and the
# float64 run on the CPU takes ~0.8 s a ping
WIDE_PINGS = 64
WIDE_F64_PINGS = 8


def _by_key(voxels):
    """(keys, log-odds) sorted by key (the two backends list their voxels
    in different orders)."""
    import numpy as np

    keys, lo = voxels
    order = np.lexsort(keys.T)
    return keys[order], lo[order]


def _touched(state, spec=None):
    """(keys, log-odds) of a brick, sharded brick, hash, sharded hash or
    dense map's touched voxels, sorted by key (a dense map's keys come from
    its ``spec``)."""
    import numpy as np

    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        BrickGridState,
        touched_voxels_brick,
    )
    from sonar_3d_reconstruction_tpu_torch.grid.dense import DenseGridState
    from sonar_3d_reconstruction_tpu_torch.grid.hash import touched_voxels_hash
    from sonar_3d_reconstruction_tpu_torch.parallel.shard import (
        ShardedHashState,
        touched_voxels_sharded,
    )
    from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (
        ShardedBrickState,
        gather_sharded_brick_state,
    )

    if isinstance(state, ShardedBrickState):
        return _by_key(gather_sharded_brick_state(state))
    if isinstance(state, ShardedHashState):
        return _by_key(touched_voxels_sharded(state))
    if isinstance(state, DenseGridState):
        flat = state.touched.nonzero().squeeze(1)
        keys = np.stack(np.unravel_index(flat.cpu().numpy(), spec.shape),
                        axis=-1) + np.asarray(spec.origin_key)
        return _by_key((keys, state.log_odds[flat].cpu().numpy()))
    return _by_key((touched_voxels_brick if isinstance(state, BrickGridState)
                    else touched_voxels_hash)(state))


def _same_voxels(got, want, tol, what):
    """Two (keys, log-odds) views, sorted by key, hold the same voxels with
    log-odds within ``tol``; returns (voxels, max |diff|, log-odds not
    bit-equal)."""
    import numpy as np

    (keys, lo), (w_keys, w_lo) = got, want
    if len(keys) == 0 or not np.array_equal(keys, w_keys):
        raise AssertionError(f"{what}: {len(keys)} voxels against "
                             f"{len(w_keys)}, or the sets differ")
    diff = np.abs(lo.astype(np.float64) - w_lo.astype(np.float64))
    if diff.max() > tol:
        raise AssertionError(f"{what}: {int((diff > tol).sum())} log-odds "
                             f"differ, by up to {diff.max()}")
    return len(keys), float(diff.max()), int((lo != w_lo).sum())


def _same_stats(got, want, what, keys=PING_STATS):
    """Per-ping stats equal; else the phase fails naming the first
    differing pings."""
    import numpy as np

    for k in keys:
        bad = np.flatnonzero(np.asarray(got[k]) != np.asarray(want[k]))
        if len(bad):
            raise AssertionError(
                f"{what}: per-ping {k} differs at {len(bad)} pings, first "
                f"{bad[:5].tolist()}: {np.asarray(got[k])[bad[:5]].tolist()}"
                f" against {np.asarray(want[k])[bad[:5]].tolist()}")


def _hash_main(dev, smi, main_voxels, main_stats):
    """7a: the survey through the hash backend in windows of 16 (twice; the
    second run is reported) and its first HASH_W1_PINGS pings one by one,
    against the brick maps of the same pings.  Returns (the hash map,
    facts, the per-ping stats of both runs, the window-1 map's voxels and
    its wall for phase 10)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.pipeline import (
        DEFAULT_HASH_CAPACITY,
        map_ping_sequence,
    )

    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, 256)

    def run(n, window, backend="hash"):
        return map_ping_sequence(images[:n], positions[:n], quats[:n], cfg,
                                 device=dev, backend=backend, window=window,
                                 dtype=torch.float32)

    _, cold = _wall(lambda: run(256, 16))
    torch.cuda.reset_peak_memory_stats(dev)
    with count_rehashes() as grown:
        (st, stats), wall = _wall(lambda: run(256, 16))
    peak = torch.cuda.max_memory_allocated(dev)
    rehashes = grown["n"]
    _same_stats(stats, main_stats, "hash window 16 vs phase 2")
    voxels, diff, n_diff = _same_voxels(_touched(st), _by_key(main_voxels),
                                        F32_LOG_ODDS_TOL,
                                        "hash window 16 vs phase 2")
    (w1, w1_stats), w1_s = _wall(lambda: run(HASH_W1_PINGS, 1))
    b1, b1_stats = run(HASH_W1_PINGS, 16, backend="brick")
    _same_stats(w1_stats, b1_stats, "hash window 1 vs brick")
    w1_voxels, w1_diff, w1_n_diff = _same_voxels(
        _touched(w1), _touched(b1), F32_LOG_ODDS_TOL, "hash window 1 vs brick")
    facts = dict(wall_s=wall, cold_wall_s=cold, pings_per_sec=256 / wall,
                 peak_mib=peak / 2**20, rehashes=rehashes,
                 capacity=st.capacity, voxels=voxels, max_abs_diff=diff,
                 not_bit_equal=n_diff, window1_s=w1_s,
                 window1_pings_per_sec=HASH_W1_PINGS / w1_s,
                 window1_not_bit_equal=w1_n_diff)
    print(
        f"phase 7a hash: 256 pings of 500x512, window 16, float32, through "
        f"map_ping_sequence(backend=\"hash\"): per-ping "
        f"{', '.join(PING_STATS)} and {voxels} voxels equal phase 2's brick "
        f"map, log-odds max |diff| {diff:.3g} (tolerance {F32_LOG_ODDS_TOL}),"
        f" {n_diff} not bit-equal; wall {wall:.3f} s (cold run {cold:.3f} "
        f"s), {256 / wall:.1f} pings/s, peak memory {peak / 2**20:.1f} MiB, "
        f"{rehashes} rehashes (with replay) from {DEFAULT_HASH_CAPACITY} to "
        f"{st.capacity} slots.  Window 1 "
        f"(update_hash_grid a ping) over {HASH_W1_PINGS} pings: {w1_s:.3f} s, "
        f"{HASH_W1_PINGS / w1_s:.1f} pings/s, {w1_voxels} voxels equal the "
        f"brick map of those pings, max |diff| {w1_diff:.3g}, {w1_n_diff} "
        f"not bit-equal [{smi}]",
        flush=True,
    )
    return st, facts, dict(stats=stats, w1_stats=w1_stats,
                           w1_voxels=_touched(w1), w1_s=w1_s)


def _wide_keys(dev, smi):
    """7b: the survey's first WIDE_PINGS pings at WIDE_RANGE, where no
    window fits box keys, through the brick backend (two-word codes, K1)
    and the hash backend; K1 on the
    widest wide window against its plain version; WIDE_F64_PINGS pings in
    float64 on the card and the CPU.  Returns (K1 launches of the wide
    path, facts, the brick map's voxels sorted by key)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.geometry import (
        batched_sonar_to_world,
    )
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply as k1
    from sonar_3d_reconstruction_tpu_torch.ops.packing import (
        compute_window_boxes,
    )
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    cfg = MapperConfig(max_range=WIDE_RANGE)
    images, positions, quats = make_inputs(MapperConfig(), WIDE_PINGS)
    T = batched_sonar_to_world(positions, quats, cfg)
    if compute_window_boxes(T[:, :3, 3], cfg.max_range, cfg.voxel_resolution,
                            16, 2, frame_bits=4) is not None:
        raise AssertionError("the wide survey fits box keys")

    def run(backend, device=dev, n=WIDE_PINGS, window=16,
            dtype=torch.float32):
        return map_ping_sequence(images[:n], positions[:n], quats[:n], cfg,
                                 device=device, backend=backend,
                                 window=window, dtype=dtype)

    with keep_widest_k1_call(raw=False) as kept:
        ((b_st, b_stats), launches), b_wall = _wall(lambda: _k1_launches_of(
            lambda: run("brick"), what="wide keys (brick)"))
    with count_rehashes() as grown:
        (h_st, h_stats), h_wall = _wall(lambda: run("hash"))
    _same_stats(b_stats, h_stats, "wide brick vs hash")
    voxels, diff, n_diff = _same_voxels(_touched(b_st), _touched(h_st),
                                        F32_LOG_ODDS_TOL, "wide brick vs hash")

    args, kw = kept["args"], kept["kw"]
    _widest_equals_plain(kept, False, "7b the widest wide window")
    k1_ms = _device_ms(lambda: k1.bin_apply(*args, **kw), "bin_apply_kernel")
    k1_bound_ms = _bound_ms(k1_bytes(args, False, 16)[0])
    nb, lanes = args[3].shape[0], args[0].shape[0]

    out = {}
    for name, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
        (st, stats), s = _wall(lambda: run("brick", device, WIDE_F64_PINGS, 8,
                                           torch.float64))
        out[name] = (stats, _touched(st), s)
    (g_stats, g_vox, g_s), (c_stats, c_vox, c_s) = out["gpu"], out["cpu"]
    _same_stats(g_stats, c_stats, "wide float64 card vs CPU")
    f64_voxels, f64_diff, f64_n_diff = _same_voxels(
        g_vox, c_vox, F64_TOL, "wide float64 card vs CPU")
    facts = dict(brick_wall_s=b_wall, hash_wall_s=h_wall,
                 brick_capacity=b_st.capacity, hash_capacity=h_st.capacity,
                 hash_rehashes=grown["n"], voxels=voxels, max_abs_diff=diff, not_bit_equal=n_diff,
                 k1_launches=launches, k1_widest_ms=k1_ms,
                 k1_widest_bound_ms=k1_bound_ms, k1_widest_nb=nb,
                 k1_widest_lanes=lanes, f64_voxels=f64_voxels,
                 f64_max_abs_diff=f64_diff, f64_not_bit_equal=f64_n_diff,
                 f64_card_s=g_s, f64_cpu_s=c_s)
    print(
        f"phase 7b wide keys: {WIDE_PINGS} pings of 500x512 at max_range "
        f"{WIDE_RANGE} m (no window fits box keys), window 16, float32: "
        f"brick (two-word codes) {b_wall:.3f} s, {launches} bin_apply "
        f"launches, {b_st.capacity} bricks; hash {h_wall:.3f} s, "
        f"{h_st.capacity} slots after {grown['n']} rehashes; per-ping stats and {voxels} voxels equal, "
        f"log-odds max |diff| {diff:.3g}, {n_diff} not bit-equal.  "
        f"bin_apply == plain in float32 and float64 on the widest wide window"
        f" (NB={nb}, L={lanes}), {k1_ms:.4f} ms device time, bound "
        f"{k1_bound_ms:.4f} ms ({k1_bound_ms / k1_ms:.1%} of it).  "
        f"{WIDE_F64_PINGS} pings in float64, window 8, card vs CPU: stats "
        f"and {f64_voxels} voxels equal, max |diff| {f64_diff:.3g} "
        f"(tolerance {F64_TOL}), {f64_n_diff} not bit-equal; card "
        f"{g_s:.3f} s, CPU {c_s:.3f} s [{smi}]",
        flush=True,
    )
    return launches, facts, _touched(b_st)


def _hash_entry_points(dev, smi, hash_state, brick_cli_voxels):
    """7c: ENTRY_PINGS process_sonar_image pings of SonarMapper(backend=
    "hash"), save_map -> load_map of 7a's map on the card, and map-bag
    --offline --backend hash on phase 5d's bag.  Returns facts."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.io.checkpoint import (
        load_map,
        save_map,
    )
    from sonar_3d_reconstruction_tpu_torch.models import SonarMapper

    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, ENTRY_PINGS)
    m = SonarMapper(cfg, backend="hash", device=dev)
    ms = []
    for x in zip(images, positions, quats):
        _, t = _wall(lambda: m.process_sonar_image(*x))
        ms.append(t * 1e3)
    warm = np.asarray(ms[1:])

    path = os.path.join(ROOT, "build", "chip_smoke", "hash.npz")
    _, save_s = _wall(lambda: save_map(path, hash_state, cfg))
    (state, _), load_s = _wall(lambda: load_map(path, device=dev))
    if state.log_odds.device != dev:
        raise AssertionError(f"the snapshot loaded on {state.log_odds.device}")
    voxels, _, n_diff = _same_voxels(_touched(state), _touched(hash_state), 0.0,
                                     "load_map vs the saved map")
    if not (torch.equal(state.min_bounds, hash_state.min_bounds)
            and torch.equal(state.max_bounds, hash_state.max_bounds)):
        raise AssertionError("load_map's bounds differ from the saved map's")

    bag = os.path.join(ROOT, "build", "chip_smoke", "cli.db3")
    out, proc_s = _cli("map-bag", bag, "--offline", "--window", "16",
                       "--backend", "hash")
    s = json.loads(out.splitlines()[-1])
    if s["num_voxels"] != brick_cli_voxels or s["device"] != str(dev):
        raise AssertionError(f"map-bag --backend hash summary {s} against "
                             f"{brick_cli_voxels} brick voxels")
    facts = dict(process_sonar_image_ms=float(np.median(warm)),
                 first_ping_ms=ms[0], mapper_capacity=m.state.capacity,
                 save_map_s=save_s, load_map_s=load_s, voxels=voxels,
                 cli_map_time_s=s["map_time"],
                 cli_pings_per_sec=s["pings_per_sec"], cli_process_s=proc_s)
    print(
        f"phase 7c hash entry points: {ENTRY_PINGS} bench pings through "
        f"SonarMapper(backend=\"hash\").process_sonar_image: first "
        f"{ms[0]:.1f} ms, then median {np.median(warm):.2f} ms, max "
        f"{warm.max():.2f} ms per ping, {m.state.capacity} slots; save_map "
        f"{save_s:.3f} s, load_map on the card {load_s:.3f} s, {voxels} "
        f"voxels and log-odds bit-equal ({n_diff} differ); map-bag --offline "
        f"--backend hash: {s['num_voxels']} voxels, equal to the brick run's,"
        f" map {s['map_time']:.3f} s, {s['pings_per_sec']:.1f} pings/s, "
        f"process {proc_s:.1f} s [{smi}]",
        flush=True,
    )
    return facts


def _hash_stream_and_node(dev, smi, hash_state):
    """7d: the survey through StreamingMapper(backend="hash") at chunk 16,
    against 7a's map; the node with map_backend "hash" for NODE_PINGS
    pairs, against a CPU hash mapper.  Returns facts."""
    msgs = _survey_msgs(STREAM_PINGS)
    sm, wall = _wall(lambda: _stream(msgs, dev, chunk_size=16, window=16,
                                     backend="hash"))
    voxels, _, _ = _same_voxels(_touched(sm.state), _touched(hash_state), 0.0,
                                "hash stream vs 7a's map")
    if sm.stats.frames_mapped != len(msgs):
        raise AssertionError(f"hash stream: {sm.stats.summary()}")
    _, node = _node(dev, smi, msgs, backend="hash")
    print(
        f"phase 7d hash stream: {len(msgs)} pings as message pairs, chunk "
        f"16, window 16: {voxels} voxels and log-odds equal 7a's map "
        f"(tolerance 0); wall {wall:.3f} s, {len(msgs) / wall:.1f} pings/s, "
        f"latency p50 {sm.stats.summary()['latency_p50_s'] * 1e3:.1f} ms "
        f"[{smi}]",
        flush=True,
    )
    return dict(stream_wall_s=wall, stream_pings_per_sec=len(msgs) / wall,
                node=node)


def phase_hash_and_wide(dev, smi, main_voxels, main_stats, brick_cli_voxels):
    """Phase 7: the hash backend and the wide key path.  Returns ({path: K1
    launches}, measured numbers, 7a's voxels and 7b's brick voxels, sorted
    by key, and 7a's runs for phase 10)."""
    t0 = time.perf_counter()
    hash_state, main, hash_runs = _hash_main(dev, smi, main_voxels,
                                             main_stats)
    wide_launches, wide, wide_voxels = _wide_keys(dev, smi)
    entry = _hash_entry_points(dev, smi, hash_state, brick_cli_voxels)
    stream = _hash_stream_and_node(dev, smi, hash_state)
    print(f"phase 7 hash and wide keys: {time.perf_counter() - t0:.1f} s "
          f"[{smi}]", flush=True)
    return {"map_ping_sequence (wide keys)": wide_launches}, dict(
        hash=main, wide_keys=wide, hash_entry_points=entry,
        hash_stream=stream), _touched(hash_state), wide_voxels, hash_runs


DENSE_F64_PINGS = 8   # phase 8b: float64 pings, card vs CPU
# phase 8b's grid: +-DENSE_F64_REACH m at 5 cm, 241^3 cells (107 MiB of
# float64 log-odds, 13 MiB of touched flags): it holds the first pings'
# returns (3-4 m below the sonar) and keeps the CPU side to seconds
DENSE_F64_REACH = 6.0
MULTIHOST_HOSTS = 4   # phase 8d: segments of the survey, window 16


@contextlib.contextmanager
def probe_multihost():
    """While open, ``map_ping_sequence_multihost``'s halves are timed and
    counted in the dict it yields: ``records_s`` (every segment's records
    on the card, shipped to the host), ``fold_s`` (every fold attempt),
    ``shipped_bytes`` (the host arrays of the segments) and ``rehashes``
    (table growth calls, with replay)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.parallel import multihost

    probe = dict(records_s=0.0, fold_s=0.0, shipped_bytes=0, rehashes=0)
    saved = {name: getattr(multihost, name) for name in (
        "records_for_segment", "apply_record_segments", "rehash",
        "rehash_bricks")}

    def timed(name, key):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[name](*args, **kw)
            torch.cuda.synchronize()
            probe[key] += time.perf_counter() - t0
            if name == "records_for_segment":
                probe["shipped_bytes"] += sum(x.nbytes for part in out
                                              for x in part)
            return out
        return wrapped

    def counted(name):
        def wrapped(*args, **kw):
            probe["rehashes"] += 1
            return saved[name](*args, **kw)
        return wrapped

    multihost.records_for_segment = timed("records_for_segment", "records_s")
    multihost.apply_record_segments = timed("apply_record_segments", "fold_s")
    multihost.rehash = counted("rehash")
    multihost.rehash_bricks = counted("rehash_bricks")
    try:
        yield probe
    finally:
        for name, fn in saved.items():
            setattr(multihost, name, fn)


def _dense_main(dev, smi, main_voxels, main_stats):
    """8a: the survey through map_ping_sequence(backend="dense") in the
    default grid, cold, warm and warm again: its touched cells and their
    log-odds against phase 2's brick map inside the grid, the two warm
    runs bit-equal.  Returns (K1 launches of the warm run, facts)."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.grid.dense import (
        default_dense_spec,
        linearize_keys,
    )
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    cfg = MapperConfig()
    spec = default_dense_spec(cfg)
    images, positions, quats = make_inputs(cfg, 256)

    def run():
        return map_ping_sequence(images, positions, quats, cfg, device=dev,
                                 backend="dense", dtype=torch.float32)

    _, cold = _wall(run)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    (st, stats), wall = _wall(run)
    launches = bin_apply.launches + bin_apply.raw_launches
    peak = torch.cuda.max_memory_allocated(dev)
    (again, _), again_s = _wall(run)
    if not all(torch.equal(a, b) for a, b in zip(st, again)):
        raise AssertionError("two dense runs of the survey differ")
    del again

    keys, lo = _by_key(main_voxels)
    in_grid, lin = linearize_keys(keys.astype(np.int64), spec)
    cells = st.touched.nonzero().squeeze(1).cpu().numpy()
    if not np.array_equal(cells, np.sort(lin[in_grid])):
        raise AssertionError(f"dense map: {len(cells)} touched cells against "
                             f"{int(in_grid.sum())} brick voxels in the grid")
    got = st.log_odds[torch.as_tensor(lin[in_grid], device=dev)].cpu().numpy()
    n_diff = int((got != lo[in_grid]).sum())
    if n_diff:
        raise AssertionError(f"dense map: {n_diff} log-odds differ from the "
                             f"brick map's")
    overflow = int(st.overflow)
    if overflow == 0:
        for k in ("num_occupied", "num_free", "num_candidates"):
            if not np.array_equal(stats[k], main_stats[k]):
                raise AssertionError(f"dense vs phase 2: per-ping {k} differs")
    state_bytes = st.log_odds.nbytes + st.touched.nbytes
    facts = dict(wall_s=wall, cold_wall_s=cold, second_warm_s=again_s,
                 pings_per_sec=256 / wall, peak_mib=peak / 2**20,
                 cells=spec.num_cells, state_bytes=state_bytes,
                 overflow=overflow, voxels=len(cells),
                 brick_voxels_outside=int((~in_grid).sum()),
                 not_bit_equal=n_diff, k1_launches=launches)
    print(
        f"phase 8a dense: 256 pings of 500x512, float32, through "
        f"map_ping_sequence(backend=\"dense\") into the default grid "
        f"{spec.shape} = {spec.num_cells} cells ({state_bytes / 2**20:.1f} "
        f"MiB of state): wall {wall:.3f} s (cold run {cold:.3f} s, again "
        f"{again_s:.3f} s), {256 / wall:.1f} pings/s, peak memory "
        f"{peak / 2**20:.1f} MiB, overflow {overflow}, {launches} K1 launches;"
        f" {len(cells)} touched cells equal phase 2's brick voxels inside the"
        f" grid ({int((~in_grid).sum())} outside), {n_diff} log-odds not "
        f"bit-equal; per-ping stats "
        f"{'equal phase 2' if overflow == 0 else 'not compared (overflow)'}; "
        f"a second warm run bit-equal [{smi}]",
        flush=True,
    )
    return launches, facts


def _dense_float64(dev, smi):
    """8b: DENSE_F64_PINGS survey pings in float64 into a +-DENSE_F64_REACH
    m grid on the card and the CPU: stats and every state array equal."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.grid.dense import (
        DenseGridSpec,
        dense_state_to_numpy,
    )
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    cfg = MapperConfig()
    spec = DenseGridSpec.for_world_bounds((-DENSE_F64_REACH,) * 3,
                                          (DENSE_F64_REACH,) * 3,
                                          cfg.voxel_resolution)
    images, positions, quats = make_inputs(cfg, DENSE_F64_PINGS)
    out = {}
    for name, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
        (st, stats), s = _wall(lambda: map_ping_sequence(
            images, positions, quats, cfg, device=device, backend="dense",
            dtype=torch.float64, dense_spec=spec))
        out[name] = (dense_state_to_numpy(st), stats, s)
    (g, g_stats, g_s), (c, c_stats, c_s) = out["gpu"], out["cpu"]
    for k in g_stats:
        if not np.array_equal(g_stats[k], c_stats[k]):
            raise AssertionError(f"dense float64 card vs CPU: {k} differs")
    for k in g:
        if not np.array_equal(g[k], c[k]):
            raise AssertionError(f"dense float64 card vs CPU: {k} differs")
    nbytes = sum(x.nbytes for x in g.values())
    facts = dict(cells=spec.num_cells, state_bytes=nbytes,
                 voxels=int(g["touched"].sum()), overflow=int(g["overflow"]),
                 card_s=g_s, cpu_s=c_s)
    print(
        f"phase 8b dense float64: {DENSE_F64_PINGS} pings of 500x512 into "
        f"+-{DENSE_F64_REACH} m at {cfg.voxel_resolution} m, {spec.shape} = "
        f"{spec.num_cells} cells ({nbytes / 2**20:.1f} MiB of state): card "
        f"and CPU bit-equal (stats, log-odds, touched, bounds, overflow "
        f"{facts['overflow']}), {facts['voxels']} voxels; card {g_s:.3f} s, "
        f"CPU {c_s:.3f} s [{smi}]",
        flush=True,
    )
    return facts


def _dense_entry_points(dev, smi):
    """8c: the selftest through SonarMapper(backend="dense") on the card
    and the CPU, ENTRY_PINGS bench pings timed one by one, and the node
    with map_backend "dense".  Returns facts."""
    import numpy as np

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.cli import selftest_pings
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.models import SonarMapper

    out = {}
    for name, device in (("gpu", dev), ("cpu", "cpu")):
        m = SonarMapper(SELFTEST_CFG, backend="dense", device=device)
        stats = [_without_times(s) for s in selftest_pings(m)]
        pts, probs = (m.get_point_cloud()[k] for k in ("points",
                                                        "probabilities"))
        out[name] = (stats, pts, probs)
    (g_stats, g_pts, g_probs), (c_stats, c_pts, c_probs) = (out["gpu"],
                                                            out["cpu"])
    if g_stats != c_stats:
        raise AssertionError(f"dense selftest stats differ: {g_stats} vs "
                             f"{c_stats}")
    if len(g_pts) == 0 or not np.array_equal(g_pts, c_pts):
        raise AssertionError("dense selftest occupied voxels differ")
    diff = float(np.abs(g_probs - c_probs).max())
    if diff > F32_PROB_TOL:
        raise AssertionError(f"dense selftest probabilities differ by {diff}")

    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, ENTRY_PINGS)
    m = SonarMapper(cfg, backend="dense", device=dev)
    ms = []
    for x in zip(images, positions, quats):
        _, t = _wall(lambda: m.process_sonar_image(*x))
        ms.append(t * 1e3)
    warm = np.asarray(ms[1:])
    print(
        f"phase 8c dense entry points: the selftest through "
        f"SonarMapper(backend=\"dense\") on the card and the CPU: per-ping "
        f"stats equal, {len(g_pts)} occupied voxels equal, max probability "
        f"diff {diff:.3g} (tolerance {F32_PROB_TOL}); {ENTRY_PINGS} bench "
        f"pings through process_sonar_image: first {ms[0]:.1f} ms, then "
        f"median {np.median(warm):.2f} ms, max {warm.max():.2f} ms per ping, "
        f"{m.num_voxels} voxels [{smi}]",
        flush=True,
    )
    _, node = _node(dev, smi, _survey_msgs(NODE_PINGS), backend="dense")
    return dict(selftest_max_prob_diff=diff,
                process_sonar_image_ms=float(np.median(warm)),
                first_ping_ms=ms[0], node=node)


def _multihost(dev, smi, main_voxels, main_stats, hash_voxels):
    """8d: the survey through map_ping_sequence_multihost in
    MULTIHOST_HOSTS segments, window 16, on the brick map (K1 counted)
    against phase 2's map and on the hash map against 7a's.  Returns (K1
    launches of the brick fold, facts)."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.parallel import (
        map_ping_sequence_multihost,
    )

    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, 256)

    def run(backend):
        return map_ping_sequence_multihost(
            images, positions, quats, cfg, n_hosts=MULTIHOST_HOSTS,
            window=16, backend=backend, dtype=torch.float32, device=dev)

    facts, launches = {}, 0
    for backend, want in (("brick", _by_key(main_voxels)),
                          ("hash", hash_voxels)):
        with probe_multihost() as probe:
            if backend == "brick":
                ((st, stats), launches), wall = _wall(lambda: _k1_launches_of(
                    lambda: run("brick"), what="multi-host brick fold"))
            else:
                (st, stats), wall = _wall(lambda: run("hash"))
        voxels, _, _ = _same_voxels(_touched(st), want, 0.0,
                                    f"multi-host {backend} fold")
        for k in PING_STATS:
            if not np.array_equal([s[k] for s in stats], main_stats[k]):
                raise AssertionError(f"multi-host {backend}: per-ping {k} "
                                     f"differs from phase 2's")
        facts[backend] = dict(wall_s=wall, pings_per_sec=256 / wall,
                              capacity=st.capacity, voxels=voxels, **probe)
        print(
            f"phase 8d multi-host {backend}: 256 pings of 500x512 in "
            f"{MULTIHOST_HOSTS} segments, window 16, float32: wall "
            f"{wall:.3f} s ({256 / wall:.1f} pings/s), records "
            f"{probe['records_s']:.3f} s, fold {probe['fold_s']:.3f} s, "
            f"{probe['shipped_bytes'] / 2**20:.1f} MiB shipped to the host, "
            f"{probe['rehashes']} rehash calls, capacity {st.capacity}"
            + (f", {launches} bin_apply launches" if backend == "brick"
               else "")
            + f"; per-ping stats and {voxels} voxels equal "
            f"{'phase 2' if backend == 'brick' else '7a'}'s map, log-odds "
            f"bit-equal [{smi}]",
            flush=True,
        )
    return launches, facts


def phase_dense_and_multihost(dev, smi, main_voxels, main_stats, hash_voxels):
    """Phase 8: the dense backend and the multi-host record fold.  Returns
    ({path: K1 launches}, measured numbers)."""
    t0 = time.perf_counter()
    dense_launches, main = _dense_main(dev, smi, main_voxels, main_stats)
    f64 = _dense_float64(dev, smi)
    entry = _dense_entry_points(dev, smi)
    fold_launches, fold = _multihost(dev, smi, main_voxels, main_stats,
                                     hash_voxels)
    print(f"phase 8 dense and multi-host: {time.perf_counter() - t0:.1f} s "
          f"[{smi}]", flush=True)
    return {"map_ping_sequence (dense)": dense_launches,
            "map_ping_sequence_multihost (brick)": fold_launches}, dict(
        dense=main, dense_float64=f64, dense_entry_points=entry,
        multihost=fold)


# phase 9: the frame-parallel sharded brick engine on one card, its mesh
# the card repeated.  Phase 9 maps phase 2's survey at full size; nothing
# was cut for time
SHARDS = (2, 4)       # 9a: shards of the survey's two runs
SHARDED_S = 4         # 9b-9e: shards of the other paths


@contextlib.contextmanager
def count_sharded_rehashes():
    """While open, the sharded engine's growth also counts its calls
    (every shard doubles in one call) in the dict it yields (``n``)."""
    from sonar_3d_reconstruction_tpu_torch.parallel import shard_brick

    count = {"n": 0}
    fn = shard_brick.rehash_sharded_bricks

    def wrapped(*args, **kw):
        count["n"] += 1
        return fn(*args, **kw)

    shard_brick.rehash_sharded_bricks = wrapped
    try:
        yield count
    finally:
        shard_brick.rehash_sharded_bricks = fn


def _fits_sharded_boxes(positions, quats, cfg, n_shards, window=16):
    """Whether the sharded engine maps these poses with compact box keys
    (its gate: frame bits widened to hold the owner above the key)."""
    from sonar_3d_reconstruction_tpu_torch.geometry import (
        batched_sonar_to_world,
    )
    from sonar_3d_reconstruction_tpu_torch.ops.packing import (
        compute_window_boxes,
    )

    T = batched_sonar_to_world(positions, quats, cfg)
    gbits = max(1, (max(n_shards - 1, 1)).bit_length())
    return compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, window, 2,
        frame_bits=max((window - 1).bit_length(), 1 + gbits)) is not None


def _sharded_main(dev, smi, main_voxels, main_stats):
    """9a: phase 2's survey through map_ping_sequence_sharded_frames,
    window 16, on (card,) * S for S in SHARDS (the last S twice, the
    second run reported): per-ping stats and every voxel's log-odds equal
    phase 2's.  Returns ({path: K1 launches}, facts)."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.parallel import (
        map_ping_sequence_sharded_frames,
    )

    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, 256)
    want = _by_key(main_voxels)
    launches, facts = {}, {}
    for S in SHARDS:
        if not _fits_sharded_boxes(positions, quats, cfg, S):
            raise AssertionError(f"the survey does not fit box keys at S={S}")
        path = f"map_ping_sequence_sharded_frames (S={S})"

        def run():
            return map_ping_sequence_sharded_frames(
                images, positions, quats, cfg, mesh=(dev,) * S, window=16,
                dtype=torch.float32)

        cold_s = None
        if S == SHARDS[-1]:
            _, cold_s = _wall(run)
        torch.cuda.reset_peak_memory_stats(dev)
        with count_sharded_rehashes() as grown:
            ((st, stats), n), wall = _wall(lambda: _k1_launches_of(
                run, what=path))
        peak = torch.cuda.max_memory_allocated(dev)
        _same_stats(stats, main_stats, path)
        voxels, _, _ = _same_voxels(_touched(st), want, 0.0, path)
        per_shard = [int(x.used) for x in st.shards]
        launches[path] = n
        facts[f"S{S}"] = dict(
            wall_s=wall, cold_s=cold_s, pings_per_sec=256 / wall,
            k1_launches=n, rehash_calls=grown["n"],
            local_capacity=st.local_capacity, voxels_per_shard=per_shard,
            xchg_n_max=int(stats["xchg_n_max"].max()),
            xchg_bytes=int(stats["xchg_bytes"].sum()),
            batch_n_lanes_max=int(stats["batch_n_lanes_max"].max()),
            peak_mib=peak / 2**20)
        print(
            f"phase 9a sharded frames, S={S} on {dev} x {S}: 256 pings of "
            f"500x512, window 16, float32, compact box keys: per-ping stats "
            f"and {voxels} voxels equal phase 2's map, log-odds bit-equal; "
            f"voxels per shard {per_shard}; wall {wall:.3f} s"
            + ("" if cold_s is None else f" (cold run {cold_s:.3f} s)")
            + f", {256 / wall:.1f} pings/s, peak memory {peak / 2**20:.1f} "
            f"MiB, {n} bin_apply launches, {grown['n']} rehash calls, "
            f"{st.local_capacity} bricks a shard; largest (frame, owner) "
            f"block {facts[f'S{S}']['xchg_n_max']} records, "
            f"{facts[f'S{S}']['xchg_bytes']} bytes of records moved to "
            f"their owners; largest shard window "
            f"{facts[f'S{S}']['batch_n_lanes_max']} lanes [{smi}]",
            flush=True,
        )
    return launches, facts


def _sharded_wide(dev, smi, wide_voxels):
    """9b: phase 7b's WIDE_PINGS pings at WIDE_RANGE through the sharded
    engine at SHARDED_S shards (two-word brick codes, K1): voxels and
    log-odds equal 7b's brick map; K1 against its plain version on the
    widest shard window of the run.  Returns (K1 launches, facts)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply as k1
    from sonar_3d_reconstruction_tpu_torch.parallel import (
        map_ping_sequence_sharded_frames,
    )

    cfg = MapperConfig(max_range=WIDE_RANGE)
    images, positions, quats = make_inputs(MapperConfig(), WIDE_PINGS)
    if _fits_sharded_boxes(positions, quats, cfg, SHARDED_S):
        raise AssertionError("the wide survey fits box keys")
    what = f"sharded frames, wide keys (S={SHARDED_S})"
    with keep_widest_k1_call(raw=False) as kept:
        ((st, stats), launches), wall = _wall(lambda: _k1_launches_of(
            lambda: map_ping_sequence_sharded_frames(
                images, positions, quats, cfg, mesh=(dev,) * SHARDED_S,
                window=16, dtype=torch.float32), what=what))
    voxels, _, _ = _same_voxels(_touched(st), wide_voxels, 0.0, what)
    args, kw = kept["args"], kept["kw"]
    _widest_equals_plain(kept, False, f"9b {what}")
    k1_ms = _device_ms(lambda: k1.bin_apply(*args, **kw), "bin_apply_kernel")
    bound_ms = _bound_ms(k1_bytes(args, False, 16)[0])
    nb, lanes = args[3].shape[0], args[0].shape[0]
    print(
        f"phase 9b {what}: {WIDE_PINGS} pings of 500x512 at max_range "
        f"{WIDE_RANGE} m, window 16, float32: {voxels} voxels and log-odds "
        f"equal 7b's brick map (tolerance 0); wall {wall:.3f} s, {launches} "
        f"bin_apply launches, {st.local_capacity} bricks a shard, largest "
        f"block {int(stats['xchg_n_max'].max())} records; bin_apply == plain "
        f"in float32 and float64 on the widest shard window (NB={nb}, "
        f"L={lanes}), {k1_ms:.4f} ms device time, bound {bound_ms:.4f} ms "
        f"({bound_ms / k1_ms:.1%} of it) [{smi}]",
        flush=True,
    )
    return launches, dict(wall_s=wall, k1_launches=launches, voxels=voxels,
                          k1_widest_ms=k1_ms, k1_widest_bound_ms=bound_ms,
                          k1_widest_nb=nb, k1_widest_lanes=lanes)


def _sharded_entry_points(dev, smi, main_voxels, brick_cli_voxels):
    """9c: SonarMapper(backend="brick-sharded") on (card,) * SHARDED_S:
    ENTRY_PINGS pings timed one by one; map_sequence of the survey, its
    voxels, classified cloud and point queries against phase 2's map;
    save_map -> load_map_sharded_brick and -> load_map_brick; map-bag
    --offline --backend brick-sharded --shards SHARDED_S on phase 5d's
    bag.  Returns ({path: K1 launches}, facts)."""
    import numpy as np

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        brick_state_to_numpy,
        touched_voxels_brick,
    )
    from sonar_3d_reconstruction_tpu_torch.io.checkpoint import (
        load_map_brick,
        load_map_sharded_brick,
        save_map,
    )
    from sonar_3d_reconstruction_tpu_torch.models import SonarMapper

    cfg = MapperConfig()
    mesh = (dev,) * SHARDED_S
    images, positions, quats = make_inputs(cfg, 256)
    m = SonarMapper(cfg, backend="brick-sharded", mesh=mesh)
    ms = []

    def per_ping():
        for x in zip(images[:ENTRY_PINGS], positions[:ENTRY_PINGS],
                     quats[:ENTRY_PINGS]):
            _, t = _wall(lambda: m.process_sonar_image(*x))
            ms.append(t * 1e3)

    _, ping_launches = _k1_launches_of(
        per_ping, what="mapper.process_sonar_image (brick-sharded)")
    warm = np.asarray(ms[1:])

    m = SonarMapper(cfg, backend="brick-sharded", mesh=mesh)
    (stats, seq_launches), seq_s = _wall(lambda: _k1_launches_of(
        lambda: m.map_sequence(images, positions, quats, window=16),
        what="mapper.map_sequence (brick-sharded)"))
    keys, lo = _by_key(main_voxels)
    voxels, _, _ = _same_voxels(_touched(m.state), (keys, lo), 0.0,
                                "sharded map_sequence vs phase 2")
    cloud, cloud_s = _wall(lambda: m.get_point_cloud(include_free=True))
    lo64 = lo.astype(np.float64)
    free = lo64 < np.log(0.3 / 0.7)
    occ = ~free & (lo64 > np.log(cfg.min_probability
                                 / (1.0 - cfg.min_probability)))
    for name, mask in (("free", free), ("occupied", occ),
                       ("unknown", ~free & ~occ)):
        pts, probs = cloud[name]
        want_pts = (keys[mask].astype(np.float64) + 0.5) * cfg.voxel_resolution
        order, w_order = np.lexsort(pts.T), np.lexsort(want_pts.T)
        if not (np.array_equal(pts[order], want_pts[w_order]) and np.array_equal(
                probs[order], (1.0 / (1.0 + np.exp(-lo64[mask])))[w_order])):
            raise AssertionError(f"sharded classified {name} cloud differs "
                                 f"from phase 2's map")
    pts = _query_points(keys, cfg.voxel_resolution, np.random.default_rng(9))
    want, _ = _host_probabilities(pts, keys, lo, cfg.voxel_resolution)
    got, query_s = _wall(lambda: m.query_probabilities(pts))
    if not np.array_equal(got, want):
        raise AssertionError(f"sharded query_probabilities differ from the "
                             f"host's: max |diff| {np.abs(got - want).max()}")

    work = os.path.join(ROOT, "build", "chip_smoke")
    path = os.path.join(work, "sharded.npz")
    _, save_s = _wall(lambda: save_map(path, m.state, cfg))
    (sh, _), load_sh_s = _wall(lambda: load_map_sharded_brick(path, mesh=mesh))
    for a, b in zip(sh.shards, m.state.shards):
        if not all(np.array_equal(u, v) for u, v in zip(
                _by_key(touched_voxels_brick(a)),
                _by_key(touched_voxels_brick(b)))):
            raise AssertionError("load_map_sharded_brick put a voxel on "
                                 "another shard or changed it")
    (st, _), load_s = _wall(lambda: load_map_brick(path, device=dev))
    _same_voxels(_touched(st), (keys, lo), 0.0, "load_map_brick of the "
                 "sharded snapshot")

    bag, snap = (os.path.join(work, f) for f in ("cli.db3", "sharded_cli.npz"))
    if os.path.exists(snap):
        os.unlink(snap)
    out, proc_s = _cli("map-bag", bag, "--offline", "--window", "16",
                       "--backend", "brick-sharded", "--shards",
                       str(SHARDED_S), "--save-map", snap)
    summary = json.loads(out.splitlines()[-1])
    if (summary["num_voxels"] != brick_cli_voxels
            or summary["shards"] != SHARDED_S or summary["device"] != str(dev)
            or summary["bin_apply_launches"] == 0):
        raise AssertionError(f"map-bag --backend brick-sharded summary "
                             f"{summary} against {brick_cli_voxels} brick "
                             f"voxels")
    snaps = []
    for f in (snap, os.path.join(work, "cli.npz")):
        with np.load(f) as z:
            snaps.append(_by_key((z["keys"], z["log_odds"])))
    _same_voxels(snaps[0], snaps[1], 0.0, "map-bag brick-sharded vs brick")
    print(
        f"phase 9c sharded entry points, SonarMapper(backend=\"brick-"
        f"sharded\") on {dev} x {SHARDED_S}: {ENTRY_PINGS} bench pings "
        f"through process_sonar_image: first {ms[0]:.1f} ms, then median "
        f"{np.median(warm):.2f} ms, max {warm.max():.2f} ms per ping, "
        f"{ping_launches} bin_apply launches; map_sequence of 256 pings, "
        f"window 16: {voxels} voxels and log-odds equal phase 2's map, "
        f"{seq_s:.3f} s, {seq_launches} bin_apply launches; classified cloud"
        f" ({cloud['num_occupied']} occupied, {cloud['num_free']} free, "
        f"{cloud['num_unknown']} unknown) equal to phase 2's map's, "
        f"{cloud_s:.3f} s; {len(pts)} point queries equal to the host's, "
        f"{query_s * 1e3:.1f} ms; save_map {save_s:.3f} s, "
        f"load_map_sharded_brick {load_sh_s:.3f} s (every voxel on its "
        f"shard, bit-equal), load_map_brick {load_s:.3f} s (bit-equal); "
        f"map-bag --offline --backend brick-sharded --shards {SHARDED_S}: "
        f"{summary['num_voxels']} voxels and log-odds equal the brick run's "
        f"snapshot, map {summary['map_time']:.3f} s, "
        f"{summary['pings_per_sec']:.1f} pings/s, "
        f"{summary['bin_apply_launches']} bin_apply launches, process "
        f"{proc_s:.1f} s [{smi}]",
        flush=True,
    )
    return ({"mapper.process_sonar_image (brick-sharded)": ping_launches,
             "mapper.map_sequence (brick-sharded)": seq_launches,
             "cli map-bag (brick-sharded)": summary["bin_apply_launches"]},
            dict(process_sonar_image_ms=float(np.median(warm)),
                 first_ping_ms=ms[0], map_sequence_s=seq_s,
                 point_cloud_s=cloud_s, query_ms=query_s * 1e3,
                 save_map_s=save_s, load_map_sharded_brick_s=load_sh_s,
                 load_map_brick_s=load_s, cli_map_time_s=summary["map_time"],
                 cli_pings_per_sec=summary["pings_per_sec"],
                 cli_process_s=proc_s))


def _sharded_stream_and_node(dev, smi, main_voxels):
    """9d: the survey through StreamingMapper(backend="brick-sharded") at
    chunk 16 on (card,) * SHARDED_S, against phase 2's map; the node with
    map_backend "brick-sharded" (every visible card a shard), against a
    CPU mapper of as many shards.  Returns ({path: K1 launches}, facts)."""
    msgs = _survey_msgs(STREAM_PINGS)
    what = "stream (brick-sharded)"
    (sm, n), wall = _wall(lambda: _k1_launches_of(
        lambda: _stream(msgs, dev, chunk_size=16, window=16,
                        backend="brick-sharded", mesh=(dev,) * SHARDED_S),
        what=what))
    voxels, _, _ = _same_voxels(_touched(sm.state), _by_key(main_voxels), 0.0,
                                "sharded stream vs phase 2's map")
    if sm.stats.frames_mapped != len(msgs):
        raise AssertionError(f"sharded stream: {sm.stats.summary()}")
    node_launches, node = _node(dev, smi, msgs, backend="brick-sharded")
    lat = sm.stats.summary()["latency_p50_s"] * 1e3
    print(
        f"phase 9d {what}: {len(msgs)} pings as message pairs, chunk 16, "
        f"window 16, {SHARDED_S} shards on {dev}: {voxels} voxels and "
        f"log-odds equal phase 2's map (tolerance 0); wall {wall:.3f} s, "
        f"{len(msgs) / wall:.1f} pings/s, latency p50 {lat:.1f} ms, {n} "
        f"bin_apply launches, {sm.stats.grows} chunks that grew the tables "
        f"[{smi}]",
        flush=True,
    )
    return ({what: n, "node (brick-sharded)": node_launches},
            dict(stream_wall_s=wall, stream_pings_per_sec=len(msgs) / wall,
                 stream_latency_p50_ms=lat, node=node))


def _sharded_float64(dev, smi):
    """9e: F64_PINGS pings in float64 at SHARDED_S shards, window 8, on the
    card and the CPU: per-ping stats and every array of every shard
    bit-equal.  Also the occupied fan's trig lookup (ops/backproject.
    _fan_trig) against direct evaluation on the card, every fan count.
    Returns facts."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
        _fan_trig,
        build_fan_tables,
    )
    from sonar_3d_reconstruction_tpu_torch.parallel import (
        map_ping_sequence_sharded_frames,
    )
    from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (
        sharded_brick_state_to_numpy,
    )

    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, F64_PINGS)
    out = {}
    for name, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
        (st, stats), secs = _wall(lambda: map_ping_sequence_sharded_frames(
            images, positions, quats, cfg, mesh=(device,) * SHARDED_S,
            window=8, dtype=torch.float64))
        out[name] = (stats, sharded_brick_state_to_numpy(st), secs)
    (g_stats, g, g_s), (c_stats, c, c_s) = out["gpu"], out["cpu"]
    for k in g_stats:
        if not np.array_equal(g_stats[k], c_stats[k]):
            raise AssertionError(f"sharded float64: per-ping {k} differs")
    for k in g:
        if g[k].shape != c[k].shape or not np.array_equal(g[k], c[k]):
            raise AssertionError(f"sharded float64: shard arrays {k} differ")

    tables = build_fan_tables(cfg, 500, 512)
    for dtype in (torch.float32, torch.float64):
        cos_t, sin_t, steps = _fan_trig(tables, dev, dtype,
                                        cfg.half_aperture_rad)
        nv = torch.arange(1, cos_t.shape[0], device=dev).repeat(4096)[:, None]
        vang = (steps[None, :].to(dtype) / nv.to(dtype) * torch.full(
            (), cfg.half_aperture_rad, dtype=dtype, device=dev))
        if not (torch.equal(torch.cos(vang), cos_t[nv[:, 0]])
                and torch.equal(torch.sin(vang), sin_t[nv[:, 0]])):
            raise AssertionError(f"the fan trig lookup differs from direct "
                                 f"evaluation on the card ({dtype})")
    n_vox = int(g["used"].sum())
    print(
        f"phase 9e sharded float64: {F64_PINGS} pings of 500x512, window 8, "
        f"{SHARDED_S} shards, card vs CPU: per-ping stats and every array "
        f"of every shard bit-equal ({n_vox} voxels, per shard "
        f"{g['used'].tolist()}); card {g_s:.3f} s, CPU {c_s:.3f} s; the "
        f"fan trig lookup equals direct cos/sin on the card for every fan "
        f"count ({cos_t.shape[0] - 1}) in float32 and float64 [{smi}]",
        flush=True,
    )
    return dict(voxels=n_vox, card_s=g_s, cpu_s=c_s)


def phase_sharded(dev, smi, main_voxels, main_stats, wide_voxels,
                  brick_cli_voxels):
    """Phase 9: the frame-parallel sharded brick engine on one card.
    Returns ({path: K1 launches}, measured numbers)."""
    t0 = time.perf_counter()
    launches, main = _sharded_main(dev, smi, main_voxels, main_stats)
    launches[f"sharded frames, wide keys (S={SHARDED_S})"], wide = (
        _sharded_wide(dev, smi, wide_voxels))
    entry_launches, entry = _sharded_entry_points(dev, smi, main_voxels,
                                                  brick_cli_voxels)
    stream_launches, stream = _sharded_stream_and_node(dev, smi, main_voxels)
    f64 = _sharded_float64(dev, smi)
    print(f"phase 9 sharded brick engine: {time.perf_counter() - t0:.1f} s "
          f"[{smi}]", flush=True)
    return {**launches, **entry_launches, **stream_launches}, dict(
        sharded=main, sharded_wide=wide, sharded_entry_points=entry,
        sharded_stream=stream, sharded_float64=f64)


# phase 10: the replicated-records engines (the sharded hash engine and the
# replicated-records sharded brick engine) on one card, their mesh the card
# repeated SHARDED_S times.  Each shard computes every frame's candidates,
# so on one card the records half runs SHARDED_S times.  Nothing was cut
# for time: 10a / 10c map phase 2's whole survey.


@contextlib.contextmanager
def probe_replicated():
    """While open, the sharded hash and replicated-records engines' applies
    are timed and their growth calls and backprojections counted, in the
    dict it yields: ``apply_s`` (every shard's apply, a sync before and
    after; the records before it end in a sync already, and the stats
    after it in one), ``rehashes`` (each call grows every shard, with
    replay) and ``backprojections`` (``backproject_ping`` calls of
    ``parallel/shard.py``: one a ping at window 1, one a shard a ping in
    the window engines)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.parallel import shard, shard_brick

    probe = dict(apply_s=0.0, rehashes=0, backprojections=0)
    names = [(shard, "apply_frame_records"), (shard, "apply_records_batched"),
             (shard_brick, "apply_brick_records_wide"),
             (shard, "rehash_sharded"), (shard_brick, "rehash_sharded_bricks"),
             (shard, "backproject_ping")]
    saved = {(m, n): getattr(m, n) for m, n in names}

    def timed(fn):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            probe["apply_s"] += time.perf_counter() - t0
            return out
        return wrapped

    def counted(fn, key):
        def wrapped(*args, **kw):
            probe[key] += 1
            return fn(*args, **kw)
        return wrapped

    for (m, n), fn in saved.items():
        setattr(m, n, counted(fn, "rehashes") if n.startswith("rehash")
                else counted(fn, "backprojections") if n == "backproject_ping"
                else timed(fn))
    try:
        yield probe
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)


def _check_owners(state, what):
    """Every shard's touched voxels are ones it owns (hash: voxel codes,
    brick: brick codes); returns the voxels per shard."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        brick_state_to_numpy,
        touched_voxels_brick,
    )
    from sonar_3d_reconstruction_tpu_torch.grid.hash import touched_voxels_hash
    from sonar_3d_reconstruction_tpu_torch.ops.packing import (
        pack_brick_keys,
        pack_keys,
    )
    from sonar_3d_reconstruction_tpu_torch.parallel.shard import (
        ShardedHashState,
        owner_shard,
        owner_shard_brick,
    )

    per = []
    for s, sub in enumerate(state.shards):
        dev = sub.log_odds.device
        if isinstance(state, ShardedHashState):
            keys, _ = touched_voxels_hash(sub)
            hi, lo, _ = pack_keys(torch.as_tensor(keys, device=dev))
            owner = owner_shard(hi, lo, state.n_shards)
        else:
            keys, _ = touched_voxels_brick(sub)
            hi, lo, _ = pack_brick_keys(torch.as_tensor(keys, device=dev), 2)
            owner = owner_shard_brick(hi, lo, 2, state.n_shards)
        if not bool((owner == s).all()):
            raise AssertionError(f"{what}: shard {s} holds "
                                 f"{int((owner != s).sum())} voxels it does "
                                 f"not own")
        per.append(len(keys))
    return per


def _replicated_hash(dev, smi, hash_voxels, hash_runs):
    """10a: phase 2's survey through parallel.map_ping_sequence_sharded at
    window 16 on (card,) * SHARDED_S, and its first HASH_W1_PINGS pings
    at window 1: per-ping stats, voxels and log-odds equal 7a's runs of
    the same pings; every voxel on its owner shard.  10b: save_map of the
    map -> load_map, against 7a's snapshot (phase 7c's file).  Returns
    facts."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.io.checkpoint import (
        load_map,
        save_map,
    )
    from sonar_3d_reconstruction_tpu_torch.parallel import (
        map_ping_sequence_sharded,
    )

    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, 256)
    mesh = (dev,) * SHARDED_S

    def run(n, window):
        return map_ping_sequence_sharded(
            images[:n], positions[:n], quats[:n], cfg, mesh=mesh,
            window=window, dtype=torch.float32)

    what = f"sharded hash (S={SHARDED_S}), window 16"
    torch.cuda.reset_peak_memory_stats(dev)
    with probe_replicated() as probe:
        (st, stats), wall = _wall(lambda: run(256, 16))
    peak = torch.cuda.max_memory_allocated(dev)
    _same_stats(stats, hash_runs["stats"], f"{what} vs 7a")
    voxels = _same_voxels(_touched(st), hash_voxels, 0.0, f"{what} vs 7a")[0]
    per_shard = _check_owners(st, what)
    w1_what = f"sharded hash (S={SHARDED_S}), window 1"
    with probe_replicated() as w1_probe:
        (w1, w1_stats), w1_s = _wall(lambda: run(HASH_W1_PINGS, 1))
    _same_stats(w1_stats, hash_runs["w1_stats"], f"{w1_what} vs 7a")
    w1_voxels = _same_voxels(_touched(w1), hash_runs["w1_voxels"], 0.0,
                             f"{w1_what} vs 7a")[0]
    _check_owners(w1, w1_what)
    rest = wall - probe["apply_s"]
    w1_7a = hash_runs["w1_s"]
    w1_bp = w1_probe["backprojections"] / HASH_W1_PINGS
    print(
        f"phase 10a sharded hash, S={SHARDED_S} on {dev} x {SHARDED_S}: 256 "
        f"pings of 500x512, window 16, float32, through "
        f"map_ping_sequence_sharded: per-ping stats and {voxels} voxels "
        f"equal 7a's map, log-odds bit-equal; voxels per shard {per_shard} "
        f"(each on its owner); wall {wall:.3f} s, {256 / wall:.1f} pings/s, "
        f"peak memory {peak / 2**20:.1f} MiB, {probe['rehashes']} rehash "
        f"calls ({st.local_capacity} slots a shard); applies "
        f"{probe['apply_s']:.3f} s, the rest (records of every frame on each "
        f"of the {SHARDED_S} shards, commit) {rest:.3f} s = "
        f"{rest / wall:.1%} of the wall; {probe['backprojections']} "
        f"backproject_ping calls ({probe['backprojections'] / len(images):.2f} a "
        f"ping, replays included).  Window 1 over {HASH_W1_PINGS} pings "
        f"(each ping's records once, owner blocks): {w1_s:.3f} s, "
        f"{HASH_W1_PINGS / w1_s:.1f} pings/s, {w1_s / w1_7a:.2f}x 7a's "
        f"window 1 in this call ({w1_7a:.3f} s; with every shard deriving "
        f"its records, two earlier runs on an H100 80GB HBM3 at 700 W: "
        f"1.007 / 0.957 s against 7a's 0.308 / 0.327 s); "
        f"{w1_voxels} voxels and stats equal 7a's window-1 run, applies "
        f"{w1_probe['apply_s']:.3f} s, the rest "
        f"{w1_s - w1_probe['apply_s']:.3f} s; {w1_probe['backprojections']} "
        f"backproject_ping calls ({w1_bp:.2f} a ping, with the replays of "
        f"{w1_probe['rehashes']} rehash calls) [{smi}]",
        flush=True,
    )

    work = os.path.join(ROOT, "build", "chip_smoke")
    path = os.path.join(work, "sharded_hash.npz")
    _, save_s = _wall(lambda: save_map(path, st, cfg))
    snaps = []
    for f in (path, os.path.join(work, "hash.npz")):
        with np.load(f) as z:
            snaps.append((_by_key((z["keys"], z["log_odds"])),
                          z["min_bounds"], z["max_bounds"]))
    _same_voxels(snaps[0][0], snaps[1][0], 0.0,
                 "sharded hash snapshot vs 7a's snapshot")
    if not all(np.array_equal(a, b) for a, b in zip(snaps[0][1:],
                                                     snaps[1][1:])):
        raise AssertionError("the sharded hash snapshot's bounds differ "
                             "from 7a's")
    (loaded, _), load_s = _wall(lambda: load_map(path, device=dev))
    _same_voxels(_touched(loaded), hash_voxels, 0.0,
                 "load_map of the sharded hash snapshot vs 7a")
    print(
        f"phase 10b sharded hash snapshot: save_map {save_s:.3f} s; its "
        f"{voxels} voxels, log-odds and bounds equal 7a's snapshot (phase "
        f"7c); load_map on the card {load_s:.3f} s, bit-equal [{smi}]",
        flush=True,
    )
    return dict(wall_s=wall, pings_per_sec=256 / wall, peak_mib=peak / 2**20,
                rehash_calls=probe["rehashes"],
                local_capacity=st.local_capacity, voxels_per_shard=per_shard,
                apply_s=probe["apply_s"], records_and_commit_s=rest,
                backprojections=probe["backprojections"],
                window1_s=w1_s, window1_pings_per_sec=HASH_W1_PINGS / w1_s,
                window1_apply_s=w1_probe["apply_s"],
                window1_backprojections=w1_probe["backprojections"],
                hash_window1_s=w1_7a, window1_over_hash=w1_s / w1_7a,
                save_map_s=save_s, load_map_s=load_s)


def _replicated_brick(dev, smi, main_voxels, main_stats):
    """10c: phase 2's survey through parallel.map_ping_sequence_sharded_
    brick (window 16) on (card,) * SHARDED_S: per-ping stats, voxels and
    log-odds equal phase 2's; K1 against its plain version on the widest
    shard window.  Returns (K1 launches, facts)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply as k1
    from sonar_3d_reconstruction_tpu_torch.parallel import (
        map_ping_sequence_sharded_brick,
    )

    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, 256)
    what = f"map_ping_sequence_sharded_brick (S={SHARDED_S})"
    torch.cuda.reset_peak_memory_stats(dev)
    with keep_widest_k1_call(raw=False) as kept, probe_replicated() as probe:
        ((st, stats), launches), wall = _wall(lambda: _k1_launches_of(
            lambda: map_ping_sequence_sharded_brick(
                images, positions, quats, cfg, mesh=(dev,) * SHARDED_S,
                window=16, dtype=torch.float32), what=what))
    peak = torch.cuda.max_memory_allocated(dev)
    _same_stats(stats, main_stats, f"{what} vs phase 2")
    voxels = _same_voxels(_touched(st), _by_key(main_voxels), 0.0,
                          f"{what} vs phase 2")[0]
    per_shard = _check_owners(st, what)
    args, kw = kept["args"], kept["kw"]
    _widest_equals_plain(kept, False, f"10c {what}")
    k1_ms = _device_ms(lambda: k1.bin_apply(*args, **kw), "bin_apply_kernel")
    bound_ms = _bound_ms(k1_bytes(args, False, 16)[0])
    nb, lanes = args[3].shape[0], args[0].shape[0]
    rest = wall - probe["apply_s"]
    print(
        f"phase 10c {what} on {dev} x {SHARDED_S}: 256 pings of 500x512, "
        f"window 16, float32, two-word brick codes: per-ping stats and "
        f"{voxels} voxels equal phase 2's map, log-odds bit-equal; voxels "
        f"per shard {per_shard}; wall {wall:.3f} s, {256 / wall:.1f} "
        f"pings/s, peak memory {peak / 2**20:.1f} MiB, {launches} bin_apply "
        f"launches, {probe['rehashes']} rehash calls ({st.local_capacity} "
        f"bricks a shard); applies {probe['apply_s']:.3f} s, the rest "
        f"(records of every frame on each of the {SHARDED_S} shards, commit) "
        f"{rest:.3f} s = {rest / wall:.1%} of the wall; bin_apply == plain "
        f"in float32 and float64 on the widest shard window (NB={nb}, "
        f"L={lanes}), {k1_ms:.4f} ms device time, bound {bound_ms:.4f} ms "
        f"({bound_ms / k1_ms:.1%} of it) [{smi}]",
        flush=True,
    )
    return launches, dict(
        wall_s=wall, pings_per_sec=256 / wall, peak_mib=peak / 2**20,
        k1_launches=launches, rehash_calls=probe["rehashes"],
        local_capacity=st.local_capacity, voxels_per_shard=per_shard,
        apply_s=probe["apply_s"], records_and_commit_s=rest,
        k1_widest_ms=k1_ms, k1_widest_bound_ms=bound_ms, k1_widest_nb=nb,
        k1_widest_lanes=lanes)


def _replicated_float64(dev, smi):
    """10d: F64_PINGS pings in float64 through both replicated-records
    engines at SHARDED_S shards, window 8, on the card and the CPU:
    per-ping stats and every array of every shard bit-equal.  Returns
    facts."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.parallel import (
        map_ping_sequence_sharded,
        map_ping_sequence_sharded_brick,
    )
    from sonar_3d_reconstruction_tpu_torch.parallel.shard import (
        sharded_hash_state_to_numpy,
    )
    from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (
        sharded_brick_state_to_numpy,
    )

    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, F64_PINGS)
    facts = {}
    for name, engine, to_numpy in (
            ("hash", map_ping_sequence_sharded, sharded_hash_state_to_numpy),
            ("brick", map_ping_sequence_sharded_brick,
             sharded_brick_state_to_numpy)):
        out = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            (st, stats), secs = _wall(lambda: engine(
                images, positions, quats, cfg, mesh=(device,) * SHARDED_S,
                window=8, dtype=torch.float64))
            out[where] = (stats, to_numpy(st), secs)
        (g_stats, g, g_s), (c_stats, c, c_s) = out["card"], out["cpu"]
        what = f"replicated {name} float64, card vs CPU"
        _same_stats(g_stats, c_stats, what, keys=list(g_stats))
        for k in g:
            if g[k].shape != c[k].shape or not np.array_equal(g[k], c[k]):
                n = (g[k] != c[k]).sum() if g[k].shape == c[k].shape else -1
                print(f"{what}: shard arrays {k} differ ({n} entries)",
                      flush=True)
                raise AssertionError(f"{what}: shard arrays {k} differ")
        facts[name] = dict(voxels=int(g["used"].sum()),
                           per_shard=g["used"].tolist(), card_s=g_s,
                           cpu_s=c_s)
    print(
        f"phase 10d replicated float64: {F64_PINGS} pings of 500x512, window "
        f"8, {SHARDED_S} shards, card vs CPU, per-ping stats and every array "
        f"of every shard bit-equal: sharded hash ({facts['hash']['voxels']} "
        f"voxels, per shard {facts['hash']['per_shard']}; card "
        f"{facts['hash']['card_s']:.3f} s, CPU {facts['hash']['cpu_s']:.3f} "
        f"s) and replicated brick ({facts['brick']['voxels']} voxels; card "
        f"{facts['brick']['card_s']:.3f} s, CPU {facts['brick']['cpu_s']:.3f}"
        f" s) [{smi}]",
        flush=True,
    )
    return facts


def _trace_kernels(path):
    """The CUDA kernel events of a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"]


def _replicated_trace(dev, smi):
    """10e: utils.profiling.device_trace around one sharded hash window
    (16 pings, window 16) on (card,) * SHARDED_S: the trace file exists
    and names CUDA kernels (the profiler is asked again when a trace holds
    none, PROFILE_TRIES times); their summed time against the traced
    call's wall.  Returns facts."""
    import glob
    import shutil

    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.parallel import (
        map_ping_sequence_sharded,
    )
    from sonar_3d_reconstruction_tpu_torch.utils import device_trace

    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, 16)
    log_dir = os.path.join(ROOT, "build", "chip_smoke", "trace")
    for attempt in range(1, PROFILE_TRIES + 1):
        shutil.rmtree(log_dir, ignore_errors=True)
        with device_trace(log_dir):
            _, traced_s = _wall(lambda: map_ping_sequence_sharded(
                images, positions, quats, cfg, mesh=(dev,) * SHARDED_S,
                local_capacity=1 << 20, window=16, dtype=torch.float32))
        paths = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        if len(paths) != 1:
            raise AssertionError(f"device_trace wrote {paths}")
        kernels = _trace_kernels(paths[0])
        if kernels:
            break
    else:
        raise AssertionError(f"device_trace recorded no CUDA kernel in "
                             f"{PROFILE_TRIES} runs")
    names = {e["name"] for e in kernels}
    busy_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
    size = os.path.getsize(paths[0])
    print(
        f"phase 10e device_trace around one sharded hash window (16 pings, "
        f"S={SHARDED_S}): {os.path.relpath(paths[0], ROOT)}, {size} bytes, "
        f"{len(kernels)} CUDA kernel events of {len(names)} kernels, "
        f"{busy_ms:.3f} ms of kernel time = {busy_ms / 1e3 / traced_s:.1%} "
        f"of the traced call's wall {traced_s:.3f} s (under the profiler), "
        f"attempt {attempt} [{smi}]",
        flush=True,
    )
    return dict(trace_bytes=size, kernel_events=len(kernels),
                kernel_names=len(names), kernel_ms=busy_ms,
                traced_wall_s=traced_s, attempts=attempt)


def phase_replicated(dev, smi, main_voxels, main_stats, hash_voxels,
                     hash_runs):
    """Phase 10: the replicated-records engines on one card.  Returns
    ({path: K1 launches}, measured numbers)."""
    t0 = time.perf_counter()
    hash_facts = _replicated_hash(dev, smi, hash_voxels, hash_runs)
    launches, brick = _replicated_brick(dev, smi, main_voxels, main_stats)
    f64 = _replicated_float64(dev, smi)
    trace = _replicated_trace(dev, smi)
    print(f"phase 10 replicated-records engines: "
          f"{time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    return ({f"map_ping_sequence_sharded_brick (S={SHARDED_S})": launches},
            dict(sharded_hash=hash_facts, replicated_brick=brick,
                 replicated_float64=f64, sharded_trace=trace))


# phase 11: the sharded hash engine's window-1 step across devices, K1-raw
# through the frame-parallel engine, and the batched pose functions on the
# card.  11b maps phase 2's whole survey; 11a's pings are cut to
# OWNER_BLOCK_PINGS because its reference runs in float64 on the CPU.
OWNER_BLOCK_PINGS = 16
OWNER_BLOCK_CAPACITY = 1 << 18   # slots a shard: 11a never grows
POSE_TOL = 1e-12      # 11c: the torch pose chain against the host's


def _owner_blocks_across_devices(dev, smi, inputs):
    """11a: OWNER_BLOCK_PINGS float64 pings through map_ping_sequence_sharded
    on the mixed mesh (card, CPU) * (SHARDED_S / 2) against the same pings
    on (CPU,) * SHARDED_S, at window 1 (each ping's records once on the
    card, the CPU shards' blocks copied to them) and at window
    OWNER_BLOCK_PINGS (every shard derives its own): per-ping stats and
    every array of every shard bit-equal, no growth, backproject_ping
    calls 1 a ping at window 1 and SHARDED_S at the window.  Returns
    facts."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.parallel import (
        map_ping_sequence_sharded,
    )
    from sonar_3d_reconstruction_tpu_torch.parallel.shard import (
        sharded_hash_state_to_numpy,
    )

    cfg = MapperConfig()
    images, positions, quats = (x[:OWNER_BLOCK_PINGS] for x in inputs)
    cpu = torch.device("cpu")
    meshes = {"mixed": (dev, cpu) * (SHARDED_S // 2), "cpu": (cpu,) * SHARDED_S}
    facts = {}
    for window, per_ping in ((1, 1), (OWNER_BLOCK_PINGS, SHARDED_S)):
        out = {}
        for name, mesh in meshes.items():
            with probe_replicated() as probe:
                (st, stats), secs = _wall(lambda: map_ping_sequence_sharded(
                    images, positions, quats, cfg, mesh=mesh,
                    local_capacity=OWNER_BLOCK_CAPACITY, window=window,
                    dtype=torch.float64))
            what = f"11a window {window} on the {name} mesh"
            if probe["rehashes"] or st.mesh != mesh:
                raise AssertionError(f"{what}: {probe['rehashes']} rehash "
                                     f"calls, shards on {st.mesh}")
            if probe["backprojections"] != per_ping * OWNER_BLOCK_PINGS:
                raise AssertionError(
                    f"{what}: {probe['backprojections']} backproject_ping "
                    f"calls, not {per_ping} a ping")
            out[name] = (stats, sharded_hash_state_to_numpy(st), secs)
        (m_stats, m, m_s), (c_stats, c, c_s) = out["mixed"], out["cpu"]
        what = f"11a window {window}, mixed mesh vs CPU mesh"
        _same_stats(m_stats, c_stats, what, keys=list(c_stats))
        for k in c:
            if m[k].shape != c[k].shape or not np.array_equal(m[k], c[k]):
                raise AssertionError(f"{what}: shard arrays {k} differ")
        facts[f"window{window}"] = dict(
            mixed_s=m_s, cpu_s=c_s, voxels=int(c["used"].sum()),
            per_shard=c["used"].tolist(), backprojections_per_ping=per_ping)
    w1, wn = facts["window1"], facts[f"window{OWNER_BLOCK_PINGS}"]
    print(
        f"phase 11a sharded hash across devices: {OWNER_BLOCK_PINGS} pings "
        f"of 500x512, float64, S={SHARDED_S}, mesh {meshes['mixed']} against "
        f"(cpu,) * {SHARDED_S}: per-ping stats and every array of every "
        f"shard bit-equal at window 1 (owner blocks made on {dev}, copied to "
        f"the CPU shards; {w1['voxels']} voxels, per shard "
        f"{w1['per_shard']}; mixed {w1['mixed_s']:.3f} s, CPU "
        f"{w1['cpu_s']:.3f} s) and at window {OWNER_BLOCK_PINGS} (mixed "
        f"{wn['mixed_s']:.3f} s, CPU {wn['cpu_s']:.3f} s); backproject_ping "
        f"calls a ping: 1 at window 1, {SHARDED_S} at window "
        f"{OWNER_BLOCK_PINGS}; no rehash [{smi}]",
        flush=True,
    )
    return facts


def _sharded_raw(dev, smi, inputs, main_voxels, main_stats):
    """11b: phase 2's survey through map_ping_sequence_sharded_frames with
    dense_mode="pallas-raw" on (card,) * SHARDED_S, window 16, float32:
    per-ping stats and log-odds equal phase 2's; K1-raw launches counted
    (the counts set to 0 just before, read just after; one a shard a
    window) and no K1; K1-raw against its plain version on the widest
    shard window in float32 and float64, timed against its bound.
    Returns (K1-raw launches, facts)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply as k1
    from sonar_3d_reconstruction_tpu_torch.parallel import (
        map_ping_sequence_sharded_frames,
    )

    cfg = MapperConfig()
    images, positions, quats = inputs
    what = f"map_ping_sequence_sharded_frames pallas-raw (S={SHARDED_S})"
    with keep_widest_k1_call(raw=True) as kept, \
            count_sharded_rehashes() as grown:
        _reset_counts()
        (st, stats), wall = _wall(lambda: map_ping_sequence_sharded_frames(
            images, positions, quats, cfg, mesh=(dev,) * SHARDED_S,
            window=16, dtype=torch.float32, dense_mode="pallas-raw"))
        launches, other = k1.raw_launches, k1.launches
    want_launches = len(images) // 16 * SHARDED_S
    if other or launches == 0 or (not grown["n"]
                                  and launches != want_launches):
        raise AssertionError(f"{what}: {launches} bin_apply_raw launches "
                             f"(expected {want_launches}), {other} "
                             f"bin_apply, {grown['n']} rehash calls")
    _same_stats(stats, main_stats, f"{what} vs phase 2")
    voxels = _same_voxels(_touched(st), _by_key(main_voxels), 0.0,
                          f"{what} vs phase 2")[0]
    args, kw = kept["args"], kept["kw"]
    _widest_equals_plain(kept, True, f"11b {what}")
    ms = _device_ms(lambda: k1.bin_apply_raw(*args, **kw), "bin_apply_kernel")
    plain_ms = _time_ms(lambda: k1.bin_apply_raw_reference(*args, **kw))
    nbytes = k1_bytes(args, True, kw["B"])[0]
    bound_ms = _bound_ms(nbytes)
    nb, lanes = args[3].shape[0], args[0].shape[0]
    print(
        f"phase 11b {what} on {dev} x {SHARDED_S}: {len(images)} pings of "
        f"500x512, window 16, float32, compact box keys: per-ping stats and "
        f"{voxels} voxels equal phase 2's map, log-odds bit-equal; wall "
        f"{wall:.3f} s, {len(images) / wall:.1f} pings/s, {launches} "
        f"bin_apply_raw launches (expected {want_launches}: one a shard a "
        f"window), 0 bin_apply, {grown['n']} rehash calls; bin_apply_raw == "
        f"plain in float32 and float64 on the widest shard window, bit-equal "
        f"(NB={nb}, L={lanes}), "
        f"{ms:.4f} ms device time (plain {plain_ms:.4f} ms), bound "
        f"{bound_ms:.4f} ms ({nbytes} bytes, {bound_ms / ms:.1%} of it) "
        f"[{smi}]",
        flush=True,
    )
    return launches, dict(
        wall_s=wall, pings_per_sec=len(images) / wall, launches=launches,
        rehash_calls=grown["n"], voxels=voxels,
        widest_ms=ms, widest_plain_ms=plain_ms, widest_bound_ms=bound_ms,
        widest_bytes=nbytes, widest_nb=nb, widest_lanes=lanes)


def _poses_on_card(dev, smi, inputs):
    """11c: geometry.compose_pose_chain(pose_matrices_from_quaternions(
    positions, quaternions), T_mount) in float64 for the survey's poses on
    the card: within POSE_TOL of the host's batched_sonar_to_world, and
    bit-equal to the same functions on the CPU.  Returns facts."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.geometry import (
        batched_sonar_to_world,
        compose_pose_chain,
        pose_matrices_from_quaternions,
        pose_matrix_from_rpy,
        rotations_from_quaternions,
    )

    cfg = MapperConfig()
    _, positions, quats = inputs
    T_mount = pose_matrix_from_rpy(np.asarray(cfg.sonar_position, np.float64),
                                   np.asarray(cfg.sonar_orientation,
                                              np.float64))
    out = []
    for d in (dev, torch.device("cpu")):
        def f64(x):
            return torch.as_tensor(x, dtype=torch.float64, device=d)

        (T, R), secs = _wall(lambda: (
            compose_pose_chain(pose_matrices_from_quaternions(
                f64(positions), f64(quats)), f64(T_mount)),
            rotations_from_quaternions(f64(quats))))
        if T.device != d or T.dtype != torch.float64:
            raise AssertionError(f"11c: the chain came back on {T.device}, "
                                 f"{T.dtype}")
        out.append((T.cpu().numpy(), R.cpu().numpy(), secs))
    (g, g_r, g_s), (c, c_r, _) = out
    err = float(np.abs(g - batched_sonar_to_world(positions, quats,
                                                  cfg)).max())
    if err > POSE_TOL:
        raise AssertionError(f"11c: the card's pose chain is {err} off the "
                             f"host's (tolerance {POSE_TOL})")
    if not (np.array_equal(g, c) and np.array_equal(g_r, c_r)):
        raise AssertionError("11c: the pose functions differ between the "
                             "card and the CPU")
    print(
        f"phase 11c pose functions on {dev}: {len(positions)} survey poses "
        f"in float64, compose_pose_chain(pose_matrices_from_quaternions(...),"
        f" T_mount) within {err:.3g} of batched_sonar_to_world (tolerance "
        f"{POSE_TOL}); poses and rotations bit-equal to the CPU's; "
        f"{g_s * 1e3:.3f} ms on the card [{smi}]",
        flush=True,
    )
    return dict(poses=len(positions), max_abs_err=err, card_ms=g_s * 1e3)


def phase_owner_blocks_raw_poses(dev, smi, main_voxels, main_stats):
    """Phase 11: 11a the sharded hash engine's window-1 step across
    devices, 11b K1-raw through the frame-parallel engine, 11c the pose
    functions on the card.  Returns ({path: K1-raw launches}, measured
    numbers)."""
    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig

    t0 = time.perf_counter()
    inputs = make_inputs(MapperConfig(), 256)
    owner_blocks = _owner_blocks_across_devices(dev, smi, inputs)
    launches, raw = _sharded_raw(dev, smi, inputs, main_voxels, main_stats)
    poses = _poses_on_card(dev, smi, inputs)
    print(f"phase 11 owner blocks, sharded raw path, poses: "
          f"{time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    return ({f"map_ping_sequence_sharded_frames pallas-raw "
             f"(S={SHARDED_S})": launches},
            dict(owner_blocks=owner_blocks, sharded_raw=raw, poses=poses))


BATCH_PINGS = 256     # phase 12: phase 2's survey
RECORDS_BATCHES = (1, 4, 16)   # phase 12: records_batch settings
WINDOW_GROUPS = (1, 4)         # phase 12: window_group settings
BATCH_RUNS = 3        # phase 12: alternating timed runs of each setting
BATCH_F64_PINGS = 16  # phase 12: float64 pings card vs CPU
SORT_REPS = 20        # phase 12: sorts timed a form


def _launches_and_syncs(fn):
    """(fn(), kernel launches, stream synchronisations) of one call, as
    the host issued them (``cudaLaunchKernel`` and
    ``cudaStreamSynchronize`` events of torch.profiler, CUDA runtime
    only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
    # the raw event list: key_averages() parses every event in Python,
    # seconds for a run's ~60,000 launches
    raw = getattr(prof.profiler, "kineto_results", None)
    try:
        names = [e.name() for e in raw.events()]
    except AttributeError:
        names = [e.key for e in prof.key_averages() for _ in range(e.count)]
    launches = sum("LaunchKernel" in n for n in names)
    syncs = sum("StreamSynchronize" in n for n in names)
    if not launches:
        raise AssertionError("torch.profiler recorded no kernel launch")
    return out, launches, syncs


def _sort_forms(dev, images, positions, quats, cfg, tables):
    """Device ms of the dedup's first sort over one window's (16, N)
    compact sort words in three forms: one 2-D ``torch.sort(dim=-1)`` (the
    port's), 16 row sorts, and one flat sort of the 16 N lanes with the
    frame folded above the 32-bit word; every form's values equal."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.geometry import (
        batched_sonar_to_world,
    )
    from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
        backproject_ping,
    )
    from sonar_3d_reconstruction_tpu_torch.ops.packing import (
        EMPTY32,
        compute_window_boxes,
        pack_box_keys,
    )

    T = batched_sonar_to_world(positions[:16], quats[:16], cfg)
    mins, bits = compute_window_boxes(T[:, :3, 3], cfg.max_range,
                                      cfg.voxel_resolution, 16, 2, 4)
    cand = backproject_ping(torch.as_tensor(images[:16], device=dev),
                            torch.as_tensor(T, device=dev).float(), tables,
                            cfg)
    res = torch.full((), cfg.voxel_resolution, device=dev)
    keys = torch.floor(cand["points"] / res).to(torch.int32)
    key, ok = pack_box_keys(keys, torch.as_tensor(mins[0], device=dev), bits, 2)
    x = torch.where(cand["valid"] & ok,
                    (key << 1) | cand["is_occupied"].to(torch.int64), EMPTY32)
    row = torch.arange(x.shape[0], device=dev)[:, None]

    def folded():
        s, idx = torch.sort(((row << 32) | x).reshape(-1))
        return (s.reshape(x.shape) & 0xFFFFFFFF,
                idx.reshape(x.shape) - row * x.shape[1])

    forms = {
        "2-D sort(dim=-1)": lambda: torch.sort(x, dim=-1),
        "16 row sorts": lambda: [torch.sort(r) for r in x],
        "folded flat sort": folded,
    }
    want = torch.sort(x, dim=-1).values
    for name, fn in forms.items():
        got = fn()
        got = torch.stack([v for v, _ in got]) if isinstance(got, list) else got[0]
        if not torch.equal(got, want):
            raise AssertionError(f"sort form {name} gives other values")
    ms = {name: _time_ms(fn, reps=SORT_REPS) for name, fn in forms.items()}
    ms["16 row sorts, values only"] = _time_ms(
        lambda: [torch.sort(r).values for r in x], reps=SORT_REPS)
    return tuple(x.shape), ms


def _batch_float64(dev, smi, images, positions, quats, cfg):
    """BATCH_F64_PINGS float64 pings at records_batch 16 and window_group 4
    in windows of 16 and of 4, card against CPU: stats and every state
    array bit-equal.  Returns facts."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        brick_state_to_numpy,
    )
    from sonar_3d_reconstruction_tpu_torch.pipeline import (
        STAT_DTYPES,
        map_ping_sequence,
    )

    n = BATCH_F64_PINGS
    facts = {}
    for window in (16, 4):
        out = []
        for d in (dev, torch.device("cpu")):
            (st, stats), wall = _wall(lambda: map_ping_sequence(
                images[:n], positions[:n], quats[:n], cfg, device=d,
                dtype=torch.float64, window=window, records_batch=16,
                window_group=4))
            out.append((brick_state_to_numpy(st), stats, wall))
        (g_st, g_stats, g_s), (c_st, c_stats, c_s) = out
        _same_stats(g_stats, c_stats, f"12 float64 window {window}",
                    keys=tuple(STAT_DTYPES))
        for k in STATE_FIELDS:
            if not (g_st[k].shape == c_st[k].shape
                    and (g_st[k] == c_st[k]).all()):
                raise AssertionError(f"12 float64 window {window}: state {k} "
                                     f"differs card vs CPU")
        facts[f"window_{window}"] = dict(card_s=g_s, cpu_s=c_s,
                                         used=int(g_st["used"]))
        print(f"phase 12 float64: {n} pings, records_batch 16, window_group "
              f"4, window {window}: card {g_s:.3f} s, CPU {c_s:.3f} s; stats "
              f"and every state array bit-equal ({int(g_st['used'])} voxels) "
              f"[{smi}]", flush=True)
    return facts


# phase 12: the bench command's runs (label, environment beside the
# defaults) and the records batches its trace script runs at
BENCH_RUNS = (("plan", {}),
              ("pallas-raw", {"BENCH_DENSE_MODE": "pallas-raw",
                              "BENCH_LATENCY": "0"}),
              ("count-sized", {"BENCH_COUNT_SIZED": "1",
                               "BENCH_LATENCY": "0"}))
TRACE_BATCHES = (1, 16)
# the budgets a bench_plan.json entry gives the bench's brick scan
BENCH_BUDGETS = ("unique_budget", "brick_budget", "lane_budget",
                 "insert_budget", "vox_budget", "dedup_lane_budget")


def _last_json(argv, env, what, timeout=600):
    """Run ``argv`` from the checkout's root with ``env`` beside this
    process's environment: exit 0 and a JSON object on the last line of
    its output, parsed and returned with the lines and the seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=dict(os.environ, **env))
    lines = proc.stdout.splitlines()
    try:
        got = json.loads(lines[-1])
    except (IndexError, ValueError):
        got = None
    if proc.returncode != 0 or not isinstance(got, dict) or "error" in got:
        raise AssertionError(f"{what} exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    return got, lines, time.perf_counter() - t0


def _bench_cli(smi, images, cfg):
    """``python -m sonar_3d_reconstruction_tpu_torch bench`` in one
    subprocess for each run of BENCH_RUNS, and
    ``scripts/torch_profile_bench.py`` at each records_batch of
    TRACE_BATCHES: the default run hits the committed plan of the survey's
    key (budgets equal to the entry, 16 K1 launches), the raw run
    discovers its budgets (16 K1-raw launches), the count-sized run counts
    the same updates, each trace hits the plan; each JSON line printed.
    Returns ({K1 form: {path: launches}}, facts)."""
    from sonar_3d_reconstruction_tpu_torch.bench import (
        PLAN_PATH,
        _plan_key,
        survey_caps,
    )

    key = _plan_key(cfg, len(images), 16, "brick", "pallas-tb16",
                    survey_caps(images, cfg), 1 << 16, 0)
    with open(PLAN_PATH) as f:
        plan = json.load(f)[key]
    facts, launches = {}, {"bin_apply": {}, "bin_apply_raw": {}}
    for label, env in BENCH_RUNS:
        got, lines, secs = _last_json(
            [sys.executable, "-m", "sonar_3d_reconstruction_tpu_torch",
             "bench"], env, f"bench ({label})")
        if len(lines) != 1 or got["value"] <= 0:
            raise AssertionError(f"bench ({label}): {lines}")
        d = got["detail"]
        print(f"phase 12 bench, {label} ({secs:.1f} s in a subprocess"
              f"{', ' if env else ''}"
              + " ".join(f"{k}={v}" for k, v in env.items())
              + f") [{smi}]:", flush=True)
        print(lines[0], flush=True)
        facts[label] = dict(got, process_s=secs)
        raw = d["dense_mode"] == "pallas-raw"
        n, other = ((d["k1_raw_launches"], d["k1_launches"]) if raw
                    else (d["k1_launches"], d["k1_raw_launches"]))
        if n != len(images) // 16 or other:
            raise AssertionError(f"bench ({label}): {n} launches of its K1 "
                                 f"form, {other} of the other")
        launches["bin_apply_raw" if raw else "bin_apply"][
            f"bench {label}"] = n
    want = facts["plan"]["detail"]
    differ = {k: (want[k], plan[k]) for k in BENCH_BUDGETS
              if want[k] != plan[k]}
    if (want["budget_plan"] != "hit" or want["plan_key"] != key or differ
            or want["capacity_bricks"] != plan["capacity"]
            or want["dense_mode"] != "pallas-tb16"
            or want["updates_per_ping"] != 175438.0):
        raise AssertionError(f"bench at its defaults: plan {key} "
                             f"{want['budget_plan']}, budgets differ {differ}"
                             f": {want}")
    if facts["pallas-raw"]["detail"]["budget_plan"] != "discovered":
        raise AssertionError("bench pallas-raw: no plan should match")
    for label in ("pallas-raw", "count-sized"):
        d = facts[label]["detail"]
        for k in ("updates_per_ping", "unique_voxel_updates_per_ping"):
            if d[k] != want[k]:
                raise AssertionError(f"bench {label}: {k} {d[k]} against "
                                     f"{want[k]} with the plan")
    for rb in TRACE_BATCHES:
        got, lines, secs = _last_json(
            [sys.executable, os.path.join("scripts", "torch_profile_bench.py"),
             "--out", os.path.join("build", "chip_smoke", f"trace_rb{rb}")],
            {"BENCH_RECORDS_BATCH": str(rb)}, f"trace rb={rb}")
        if (got["k1_launches"] != len(images) // 16
                or got["budget_plan"] != "hit"):
            raise AssertionError(f"trace rb={rb}: {got['k1_launches']} K1 "
                                 f"launches, plan {got['budget_plan']}")
        print(f"phase 12 bench trace, records_batch {rb} ({secs:.1f} s in a "
              f"subprocess) [{smi}]:", flush=True)
        for line in lines:
            print(line, flush=True)
        facts[f"trace_rb{rb}"] = dict(got, process_s=secs)
        launches["bin_apply"][f"bench trace rb={rb}"] = got["k1_launches"]
    return launches, facts


def phase_records_batch(dev, smi, main_np, main_stats, raw_stats):
    """Phase 12: the survey at each records_batch x window_group in both
    dense modes (map and per-ping stats equal phase 2's / 2b's bit for
    bit), timed in BATCH_RUNS alternating rounds, with launches a ping,
    syncs a run, peak memory and K1 launches; the dedup sort's three
    forms; float64 card vs CPU; the bench command.  Returns ({K1 form:
    {path: launches}}, facts)."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        brick_state_to_numpy,
    )
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply
    from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
        tables_for_images,
    )
    from sonar_3d_reconstruction_tpu_torch.pipeline import (
        STAT_DTYPES,
        map_ping_sequence,
    )
    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs

    t_phase = time.perf_counter()
    cfg = MapperConfig()
    n_pings, window = BATCH_PINGS, 16
    images, positions, quats = make_inputs(cfg, n_pings)
    tables = tables_for_images(images, cfg)
    settings = [(mode, rb, wg) for mode in ("pallas", "pallas-raw")
                for rb in RECORDS_BATCHES for wg in WINDOW_GROUPS]

    def run(mode, rb, wg):
        return map_ping_sequence(
            images, positions, quats, cfg, device=dev, window=window,
            dtype=torch.float32, dense_mode=mode, records_batch=rb,
            window_group=wg, tables=tables)

    def name(mode, rb, wg):
        return f"map_ping_sequence {mode} rb={rb} wg={wg}"

    facts, launches = {}, {"bin_apply": {}, "bin_apply_raw": {}}
    for s in settings:
        mode, rb, wg = s
        raw = mode == "pallas-raw"
        torch.cuda.reset_peak_memory_stats(dev)
        (st, stats), n = _k1_launches_of(lambda: run(*s), raw=raw,
                                         what=name(*s))
        other = bin_apply.launches if raw else bin_apply.raw_launches
        peak = torch.cuda.max_memory_allocated(dev)
        if other:
            raise AssertionError(f"{name(*s)} launched the other K1 form")
        _same_stats(stats, raw_stats if raw else main_stats, name(*s),
                    keys=tuple(STAT_DTYPES))
        got = brick_state_to_numpy(st)
        for k in STATE_FIELDS:
            if not (got[k].shape == main_np[k].shape
                    and (got[k] == main_np[k]).all()):
                raise AssertionError(f"{name(*s)}: state {k} differs from "
                                     f"phase 2's")
        launches["bin_apply_raw" if raw else "bin_apply"][name(*s)] = n
        facts[name(*s)] = dict(k1_launches=n, peak_mib=peak / 2**20)
    del st
    t_step = time.perf_counter()
    for s in settings:
        _, n_launch, n_sync = _launches_and_syncs(lambda: run(*s))
        facts[name(*s)].update(launches_per_ping=n_launch / n_pings,
                               syncs_per_run=n_sync)
    profile_s = time.perf_counter() - t_step
    t_step = time.perf_counter()
    walls = {s: [] for s in settings}
    for r in range(BATCH_RUNS):
        for s in (settings if r % 2 == 0 else settings[::-1]):
            walls[s].append(_wall(lambda: run(*s))[1])
    walls_s = time.perf_counter() - t_step
    for s in settings:
        q1, med, q3 = np.percentile(walls[s], [25, 50, 75])
        f = facts[name(*s)]
        f.update(wall_s=med, wall_q1_s=q1, wall_q3_s=q3,
                 pings_per_sec=n_pings / med)
        print(f"phase 12 {s[0]} records_batch {s[1]} window_group {s[2]}: "
              f"wall {med:.3f} s (q1-q3 {q1:.3f}-{q3:.3f}, {BATCH_RUNS} "
              f"alternating runs), {f['pings_per_sec']:.1f} pings/s; "
              f"{f['launches_per_ping']:.1f} kernel launches a ping, "
              f"{f['syncs_per_run']} stream syncs a run; peak memory "
              f"{f['peak_mib']:.1f} MiB; "
              f"{'bin_apply_raw' if s[0] == 'pallas-raw' else 'bin_apply'} "
              f"launches {f['k1_launches']}; map and per-ping stats == phase "
              f"{'2b' if s[0] == 'pallas-raw' else '2'}'s [{smi}]",
              flush=True)
    shape, sort_ms = _sort_forms(dev, images, positions, quats, cfg, tables)
    facts["sort_forms"] = dict(shape=shape, ms=sort_ms)
    print(f"phase 12 dedup sort of one window's {shape} compact words "
          f"(int64), device ms a call (CUDA events, {SORT_REPS} calls): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sort_ms.items())
          + f" [{smi}]", flush=True)
    facts["float64"] = _batch_float64(dev, smi, images, positions, quats, cfg)
    bench_launches, facts["bench"] = _bench_cli(smi, images, cfg)
    for form, by_path in bench_launches.items():
        launches[form].update(by_path)
    facts["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 12 records batches and window groups: "
          f"{facts['phase_s']:.1f} s (profiled runs {profile_s:.1f} s, "
          f"timed runs {walls_s:.1f} s)", flush=True)
    return launches, facts


GOLDEN_SEEDS = tuple(range(45)) + (1002, 2016, 2048)   # 13a: fuzz trials
PRESET_NAMES = ("kiro_tilt60", "kiro_tilt90")          # 13b
PRESET_PINGS = 256    # 13b: the survey's pings under each preset
PRESET_GOLDEN_PINGS = 4   # 13b: the pass's first pings held to golden
PRESET_DEPTH = -3.0   # 13b: m; shallow enough that the z filter clips
PRESET_BATCHES = (1, 16)  # 13b: records_batch settings, maps bit-equal
LONG_PINGS = 200      # 13c: full-size pings of the long horizon


def _fuzz():
    """scripts/torch_fuzz_golden.py, the port's golden fuzz and its
    decoders and long-horizon checks."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_fuzz_golden

    return torch_fuzz_golden


def _widest_equals_plain(kept, raw, what):
    """The kept widest call of K1 (``raw``: K1-raw) against its plain
    version in float32 and float64 on the card: every output bit-equal."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply as k1

    kernel, plain = ((k1.bin_apply_raw, k1.bin_apply_raw_reference) if raw
                     else (k1.bin_apply, k1.bin_apply_reference))
    if "args" not in kept:
        raise AssertionError(f"{what}: no {kernel.__name__} call")
    args, kw = kept["args"], kept["kw"]
    for dtype in (torch.float32, torch.float64):
        a = args[:3] + (args[3].to(dtype),)
        got, want = kernel(*a, **kw), plain(*a, **kw)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            err = float((got[0].double() - want[0].double()).abs().max())
            raise AssertionError(
                f"{what}: {kernel.__name__} != plain on its widest window "
                f"({dtype}, NB={args[3].shape[0]}, L={args[0].shape[0]}): "
                f"max |diff| {err}")


def _held(result, what):
    """A fuzz TrialResult that failed raises with its repro line."""
    if result.failure:
        print(f"  {what}: {result.message}\n  {result.repro()}", flush=True)
        raise AssertionError(f"{what}: {result.message}; {result.repro()}")


def _golden_fuzz(dev, smi, fuzz):
    """13a: each trial of GOLDEN_SEEDS through every engine of the port in
    float64 and the brick engines in float32, held to the port's golden on
    the host; K1 and K1-raw against their plain versions on each trial's
    widest window.  Returns ({K1 form: launches}, facts)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply as k1

    t0 = time.perf_counter()
    launches = {"bin_apply": 0, "bin_apply_raw": 0}
    f32, golden_s = [], 0.0
    for seed in GOLDEN_SEEDS:
        t_g = time.perf_counter()
        fuzz.golden_of(seed)
        golden_s += time.perf_counter() - t_g
        with keep_widest_k1_call(False) as kept, \
                keep_widest_k1_call(True) as kept_raw:
            _reset_counts()
            r64 = fuzz.run_trial(seed, device=dev, dtype=torch.float64)
            _held(r64, f"13a seed {seed} float64")
            r32 = fuzz.run_trial(seed, device=dev, dtype=torch.float32)
            _held(r32, f"13a seed {seed} float32")
            launches["bin_apply"] += k1.launches
            launches["bin_apply_raw"] += k1.raw_launches
        f32.append(r32)
        for raw, k in ((False, kept), (True, kept_raw)):
            _widest_equals_plain(k, raw, f"13a seed {seed}")
    if not all(launches.values()):
        raise AssertionError(f"13a launched {launches}")
    sym, common = fuzz.flip_rate(f32)
    rate = sym / max(1, common)
    if rate >= fuzz.FLIP_RATE:
        raise AssertionError(f"13a float32 flip rate {rate:.3g} >= "
                             f"{fuzz.FLIP_RATE}")
    worst32 = max(e.max_err for r in f32 for e in r.engines.values())
    wall = time.perf_counter() - t0
    print(
        f"phase 13a golden fuzz on {dev}: {len(GOLDEN_SEEDS)} seeds (configs "
        f"and pings drawn as scripts/fuzz_golden.py draws them), "
        f"{len(fuzz.ENGINES)} engines each in float64: voxel sets and "
        f"per-ping num_occupied / num_free equal to the port's golden on the "
        f"host, log-odds within {fuzz.F64_TOL}; {len(fuzz.BRICK_ENGINES)} "
        f"brick engines in float32: probabilities within {worst32:.3g} "
        f"(bar {fuzz.F32_PROB_TOL}) on the common voxels, {sym} voxels one "
        f"map holds of {common} common ({rate:.3g}, bar {fuzz.FLIP_RATE}); "
        f"bin_apply / bin_apply_raw == plain on each trial's widest window "
        f"in float32 and float64, bit-equal; launches "
        f"{launches}; {wall:.1f} s (golden {golden_s:.1f} s) [{smi}]",
        flush=True,
    )
    return launches, dict(seeds=len(GOLDEN_SEEDS), engines=len(fuzz.ENGINES),
                          f32_max_prob_err=worst32, f32_sym_diff=sym,
                          f32_common=common, f32_flip_rate=rate,
                          wall_s=wall, golden_s=golden_s)


def _preset_config(name):
    """(config, node parameters, route) of a production preset: loaded
    from config/<name>.yaml through ``load_config``, as the launch file
    loads it, where PyYAML is installed (and held equal to
    ``config.PRESETS``), else ``config.PRESETS``; the node parameters are
    the config's in the node's names and units (degrees)."""
    import importlib.util
    import math

    from sonar_3d_reconstruction_tpu_torch.config import PRESETS, load_config

    cfg, route = PRESETS[name], "config.PRESETS (PyYAML is not installed)"
    if importlib.util.find_spec("yaml") is not None:
        path = os.path.join(ROOT, "config", f"{name}.yaml")
        loaded, _ = load_config(path)
        if loaded != cfg:
            raise AssertionError(f"{path} loads another config than "
                                 f"PRESETS[{name!r}]")
        route = f"config/{name}.yaml through load_config"
    params = {k: v for k, v in cfg.to_dict().items()
              if k not in ("sonar_position", "sonar_orientation")}
    for axis, v in zip("xyz", cfg.sonar_position):
        params[f"sonar_position.{axis}"] = v
    for axis, v in zip(("roll", "pitch", "yaw"), cfg.sonar_orientation):
        params[f"sonar_orientation.{axis}"] = round(math.degrees(v), 9)
    return cfg, params, route


def _preset_golden(dev, cfg, fuzz, inputs):
    """13b: the pass's first PRESET_GOLDEN_PINGS pings on the card against
    golden on the host (float64 exact, float32 at the fuzz's bars) and the
    share of candidates the z filter drops.  Returns facts."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.golden import GoldenMapper
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    n = PRESET_GOLDEN_PINGS
    images, positions, quats = (x[:n] for x in inputs)
    t0 = time.perf_counter()
    g = GoldenMapper(cfg)
    g_stats = [g.process_ping(*x) for x in zip(images, positions, quats)]
    golden_s = time.perf_counter() - t0
    want = fuzz.Golden(dict(g.map.log_odds),
                       np.asarray([s["num_occupied"] for s in g_stats]),
                       np.asarray([s["num_free"] for s in g_stats]))
    facts = dict(golden_s=golden_s, voxels=len(want.log_odds))
    for dtype in (torch.float64, torch.float32):
        st, stats = map_ping_sequence(images, positions, quats, cfg,
                                      device=dev, dtype=dtype, window=n)
        res, failure = fuzz.compare(
            (fuzz.brick_to_dict(st), stats["num_occupied"],
             stats["num_free"]), want, dtype)
        if failure or res.sym_diff / max(1, res.common) >= fuzz.FLIP_RATE:
            raise AssertionError(f"13b {cfg} {dtype}: {failure or res}")
        facts[str(dtype).split(".")[1]] = dict(
            max_err=res.max_err, sym_diff=res.sym_diff,
            stats_equal=res.stats_equal)
        if dtype == torch.float64:
            filtered = stats["num_candidates"].sum()
    _, open_stats = map_ping_sequence(
        images, positions, quats, cfg.replace(z_filter_enabled=False),
        device=dev, dtype=torch.float64, window=n)
    facts["z_drop_share"] = float(
        1.0 - filtered / open_stats["num_candidates"].sum())
    if not facts["z_drop_share"] > 0:
        raise AssertionError("13b: the z filter dropped no candidate")
    return facts


def _preset_survey(dev, smi, fuzz, name):
    """13b for one preset: the golden pass (``_preset_golden``), the
    PRESET_PINGS-ping survey at each records_batch of PRESET_BATCHES
    (window 16, float32; maps and stats bit-equal; walls of the second of
    two alternating runs, K1 launches, peak memory), and the node under
    ros_stub() fed the preset's parameters and the survey's pings (its map
    equal to the survey's).  Returns ({path: K1 launches}, facts)."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        brick_state_to_numpy,
    )
    from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
        tables_for_images,
    )
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    cfg, params, route = _preset_config(name)
    images, positions, quats = make_inputs(cfg, PRESET_PINGS)
    positions[:, 2] = PRESET_DEPTH
    inputs = (images, positions, quats)
    facts = dict(route=route, golden=_preset_golden(dev, cfg, fuzz, inputs))
    tables = tables_for_images(images, cfg, None)
    runs, launches = {}, {}
    for rb in PRESET_BATCHES * 2:
        torch.cuda.reset_peak_memory_stats(dev)
        ((st, stats), n), wall = _wall(lambda: _k1_launches_of(
            lambda: map_ping_sequence(
                images, positions, quats, cfg, device=dev, window=16,
                dtype=torch.float32, tables=tables, records_batch=rb),
            what=f"13b {name} records_batch {rb}"))
        runs[rb] = (st, stats, wall, n,
                    torch.cuda.max_memory_allocated(dev) / 2**20)
    (st1, stats1, *_), (st16, stats16, *_) = (runs[rb] for rb in PRESET_BATCHES)
    for k, v in stats1.items():
        if not np.array_equal(stats16[k], v):
            raise AssertionError(f"13b {name}: per-ping {k} differ between "
                                 f"records_batch {PRESET_BATCHES}")
    s1, s16 = brick_state_to_numpy(st1), brick_state_to_numpy(st16)
    if any(not np.array_equal(s1[k], s16[k]) for k in s1):
        raise AssertionError(f"13b {name}: maps differ between "
                             f"records_batch {PRESET_BATCHES}")
    for rb, (_, stats, wall, n, peak) in runs.items():
        launches[f"13b {name} survey records_batch {rb}"] = n
        facts[f"records_batch_{rb}"] = dict(wall_s=wall, launches=n,
                                            peak_mib=peak)
    pairs = [_ros_pair(*m)
             for m in _survey_msgs(PRESET_PINGS, inputs)]
    torch.cuda.reset_peak_memory_stats(dev)
    with stub_node(dict(params, device=str(dev))) as node:
        if node.mapper.cfg != cfg:
            raise AssertionError(f"13b {name}: the node's config is not the "
                                 f"preset's")
        (frames, n), wall = _wall(lambda: _k1_launches_of(
            lambda: _deliver(node, pairs), what=f"13b {name} node"))
        if frames != PRESET_PINGS or node.mapper.device != dev:
            raise AssertionError(f"13b {name}: the node mapped {frames} "
                                 f"frames on {node.mapper.device}")
        voxels = _same_voxels(_touched(node.mapper.state), _touched(st1),
                              0.0, f"13b {name} node vs survey")[0]
    launches[f"13b {name} node"] = n
    facts["node"] = dict(wall_s=wall, launches=n, voxels=voxels,
                         peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20)
    g, r = facts["golden"], facts[f"records_batch_{PRESET_BATCHES[0]}"]
    r16 = facts[f"records_batch_{PRESET_BATCHES[1]}"]
    print(
        f"phase 13b {name} ({route}), 500x512, {cfg.voxel_resolution} m "
        f"voxels, pass at {PRESET_DEPTH} m: first {PRESET_GOLDEN_PINGS} pings "
        f"against golden on the host ({g['voxels']} voxels, golden "
        f"{g['golden_s']:.1f} s): float64 exact (max |diff| "
        f"{g['float64']['max_err']:.3g}, stats equal), float32 probabilities "
        f"within {g['float32']['max_err']:.3g} ({g['float32']['sym_diff']} "
        f"voxels one map holds); the z filter drops "
        f"{g['z_drop_share']:.1%} of the candidates; {PRESET_PINGS}-ping "
        f"survey, window 16, float32: records_batch {PRESET_BATCHES[0]} "
        f"{r['wall_s']:.3f} s ({r['launches']} bin_apply, peak "
        f"{r['peak_mib']:.1f} MiB), {PRESET_BATCHES[1]} {r16['wall_s']:.3f} s "
        f"({r16['launches']}, {r16['peak_mib']:.1f} MiB), maps and stats "
        f"bit-equal; node fed the preset's parameters: {PRESET_PINGS} pairs "
        f"in {wall:.3f} s ({n} bin_apply, peak "
        f"{facts['node']['peak_mib']:.1f} MiB), {voxels} voxels equal to the "
        f"survey's [{smi}]",
        flush=True,
    )
    return launches, facts


def _long_horizon(dev, smi, fuzz):
    """13c: LONG_PINGS full-size survey pings: float32 records applied
    into a float32 and a float64 brick map (1e-5 on every voxel, more than
    LONG_MIN_VOXELS voxels), and pure float32 against pure float64 (flip
    rate and over-bar share under FLIP_RATE, 99.5th percentile within
    1e-5).  Returns ({path: K1 launches}, facts)."""
    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig

    cfg = MapperConfig()
    drift_in = make_inputs(cfg, LONG_PINGS, seed=1)
    flip_in = make_inputs(cfg, LONG_PINGS, seed=2)
    (drift, n_drift), drift_s = _wall(lambda: _k1_launches_of(
        lambda: fuzz.accumulation_drift(*drift_in, cfg, dev),
        what="13c accumulation"))
    (flips, n_flips), flips_s = _wall(lambda: _k1_launches_of(
        lambda: fuzz.geometry_flips(*flip_in, cfg, dev), what="13c flips"))
    common = max(1, flips["common"])
    if (drift["voxels"] <= fuzz.LONG_MIN_VOXELS
            or drift["max_diff"] > fuzz.LONG_PROB_TOL
            or flips["sym_diff"] / common >= fuzz.FLIP_RATE
            or flips["over"] / common >= fuzz.FLIP_RATE
            or flips["p995_diff"] > fuzz.LONG_PROB_TOL):
        raise AssertionError(f"13c long horizon: {drift} {flips}")
    print(
        f"phase 13c long horizon on {dev}, {LONG_PINGS} pings of 500x512: "
        f"float32 records into float32 and float64 brick maps, "
        f"{drift['voxels']} voxels, probabilities within "
        f"{drift['max_diff']:.3g} (p99 {drift['p99_diff']:.3g}, bar "
        f"{fuzz.LONG_PROB_TOL}), {n_drift} bin_apply, {drift_s:.2f} s; pure "
        f"float32 against float64: {flips['common']} common voxels, "
        f"{flips['sym_diff']} one map holds ({flips['sym_diff'] / common:.3g}"
        f"), {flips['over']} over the bar ({flips['over'] / common:.3g}; "
        f"bar {fuzz.FLIP_RATE}), p99.5 {flips['p995_diff']:.3g}, {n_flips} "
        f"bin_apply, {flips_s:.2f} s [{smi}]",
        flush=True,
    )
    return ({"13c accumulation (f32 records, 2 maps)": n_drift,
             "13c float32 vs float64 maps": n_flips},
            dict(accumulation=dict(drift, wall_s=drift_s),
                 flips=dict(flips, wall_s=flips_s)))


def phase_golden(dev, smi):
    """Phase 13: the port held to its golden oracle on the card (13a the
    fuzz, 13b the production presets, 13c the long horizon).  Returns
    ({K1 form: {path: launches}}, facts)."""
    t0 = time.perf_counter()
    fuzz = _fuzz()
    fuzz_launches, facts = _golden_fuzz(dev, smi, fuzz)
    launches = {"bin_apply": {"13a golden fuzz": fuzz_launches["bin_apply"]},
                "bin_apply_raw": {
                    "13a golden fuzz": fuzz_launches["bin_apply_raw"]}}
    facts = dict(fuzz=facts)
    for name in PRESET_NAMES:
        n, facts[name] = _preset_survey(dev, smi, fuzz, name)
        launches["bin_apply"].update(n)
    n, facts["long_horizon"] = _long_horizon(dev, smi, fuzz)
    launches["bin_apply"].update(n)
    facts["phase_s"] = time.perf_counter() - t0
    print(f"phase 13 golden oracle on the card: {facts['phase_s']:.1f} s",
          flush=True)
    return launches, facts


PLAN_PINGS = 256       # phase 14: phase 2's survey
PLAN_WINDOW = 16
PLAN_BATCHES = (1, 16)  # 14b: records_batch settings
PLAN_RUNS = 3          # 14b: alternating timed runs of each setting
# 14a: the fields of a bench_plan.json entry, all held to the card's plan
PLAN_FIELDS = ("capacity", "unique_budget", "brick_budget", "lane_budget",
               "insert_budget", "vox_budget", "dedup_lane_budget",
               "safe_unique_budget", "safe_brick_budget")


def bench_plan_entry(cfg, images):
    """``bench_plan.json``'s entry for the JAX bench's default capture key
    of these images before its Pallas default: brick, ``"scalar"``, window
    PLAN_WINDOW, the survey's caps, capacity 1 << 16, seed 0 (the key
    from the port bench's copy of the root bench's ``_plan_key``)."""
    from sonar_3d_reconstruction_tpu_torch.bench import (
        PLAN_PATH,
        _plan_key,
        survey_caps,
    )

    key = _plan_key(cfg, len(images), PLAN_WINDOW, "brick", "scalar",
                    survey_caps(images, cfg), 1 << 16, 0)
    with open(PLAN_PATH) as f:
        return key, json.load(f)[key]


@contextlib.contextmanager
def keep_k1_call(raw, index):
    """While open, ``grid.brick``'s K1 wrapper of the form ``raw`` keeps
    copies of the inputs of its call number ``index`` (from 0) in the
    dict it yields (``args``, ``kw``)."""
    from sonar_3d_reconstruction_tpu_torch.grid import brick

    name = "bin_apply_raw" if raw else "bin_apply"
    kept, calls = {}, [0]
    fn = getattr(brick, name)

    def wrapped(s_flat, s_pay, starts, rows_cur, **kw):
        if calls[0] == index:
            kept.update(kw=dict(kw), args=tuple(
                t.clone() for t in (s_flat, s_pay, starts, rows_cur)))
        calls[0] += 1
        return fn(s_flat, s_pay, starts, rows_cur, **kw)

    setattr(brick, name, wrapped)
    try:
        yield kept
    finally:
        setattr(brick, name, fn)


@contextlib.contextmanager
def keep_scan_stats():
    """While open, ``map_ping_sequence``'s brick scans also append their
    per-ping stats (host arrays) to the list it yields, one a scan."""
    from sonar_3d_reconstruction_tpu_torch import pipeline

    scans = []
    fn = pipeline.scan_pings_brick

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        scans.append(out[1])
        return out

    pipeline.scan_pings_brick = wrapped
    try:
        yield scans
    finally:
        pipeline.scan_pings_brick = fn


def _causes(stats):
    """{cause: pings that report it} of one scan's stats."""
    return {k: int(stats[k].sum()) for k in (
        "overflowed", "unique_overflow", "xchg_overflow", "batch_overflow",
        "insert_overflow") if k in stats}


def _tune_on_card(dev, smi, cfg, images, positions, quats, tables):
    """14a.  Returns (the tuned plan, a raw plan, K1 launches, facts)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence
    from sonar_3d_reconstruction_tpu_torch.utils.autotune import (
        snug_budgets_brick,
        tune_sequence,
    )

    _reset_counts()
    plan, tune_s = _wall(lambda: tune_sequence(
        images, positions, quats, cfg, backend="brick", window=PLAN_WINDOW,
        dense_mode="scalar", dtype=torch.float32, device=dev))
    launches = bin_apply.launches
    key, want = bench_plan_entry(cfg, images)
    differ = {k: (plan.get(k), want.get(k)) for k in PLAN_FIELDS
              if plan.get(k) != want.get(k)}
    if differ or launches == 0:
        raise AssertionError(f"14a: the card's plan differs from "
                             f"bench_plan.json[{key}] in {differ} "
                             f"({launches} K1 launches)")
    # the raw window's plan: the snug formulas on a raw warm-up at the
    # default budgets (tune_sequence warms up on unique records, as the
    # JAX package's does, so its lane budget is too small for raw lanes)
    eff = {}
    (_, warm), raw_s = _wall(lambda: map_ping_sequence(
        images, positions, quats, cfg, device=dev, window=PLAN_WINDOW,
        dtype=torch.float32, dense_mode="pallas-raw", budgets={},
        effective=eff, initial_capacity=plan["capacity"], tables=tables))
    raw_plan = dict(snug_budgets_brick(warm, PLAN_WINDOW,
                                       eff["unique_budget"],
                                       eff["brick_budget"]),
                    backend="brick", window=PLAN_WINDOW,
                    dense_mode="pallas-raw", capacity=eff["capacity"])
    print(f"phase 14a tune: {PLAN_PINGS} pings, window {PLAN_WINDOW}, "
          f"float32, on the card in {tune_s:.3f} s ({launches} bin_apply "
          f"launches): plan == bench_plan.json[{key}] on "
          f"{', '.join(PLAN_FIELDS)} ("
          + ", ".join(f"{k}={plan[k]}" for k in PLAN_FIELDS)
          + f"); raw plan from a raw warm-up in {raw_s:.3f} s: brick "
          f"{raw_plan['brick_budget']}, lanes {raw_plan['lane_budget']}, "
          f"inserts {raw_plan['insert_budget']} [{smi}]", flush=True)
    return plan, raw_plan, launches, dict(
        tune_s=tune_s, plan={k: plan[k] for k in PLAN_FIELDS},
        bench_plan_key=key, raw_plan={k: raw_plan[k] for k in PLAN_FIELDS},
        raw_warmup_s=raw_s)


def _padded_k1(dev, smi, run, stats):
    """14b: K1 and K1-raw on the widest count-sized window and on the same
    window of the budgeted run (padded bricks and EMPTY32 lanes): the
    kernel bit-equal to its plain version on both, device time each."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply as k1

    out = {}
    for mode, raw in (("pallas", False), ("pallas-raw", True)):
        kernel, plain = ((k1.bin_apply_raw, k1.bin_apply_raw_reference)
                         if raw else (k1.bin_apply, k1.bin_apply_reference))
        w = int(np.argmax(stats[mode]["batch_n_lanes"])) // PLAN_WINDOW
        windows = {}
        for budgeted in (False, True):
            with keep_k1_call(raw, w) as kept:
                run(mode, 16, budgeted)
            windows[budgeted] = kept
        facts = {}
        for budgeted, kept in windows.items():
            args, kw = kept["args"], kept["kw"]
            got, want = kernel(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"14b: {kernel.__name__} != plain on "
                                     f"window {w} (budgets {budgeted})")
            nbytes, _ = k1_bytes(args, raw, kw["B"])
            ms = _device_ms(lambda: kernel(*args, **kw), "bin_apply_kernel")
            facts["budgeted" if budgeted else "count_sized"] = dict(
                NB=args[3].shape[0], L=args[0].shape[0], ms=ms,
                bound_ms=_bound_ms(nbytes),
                plain_ms=_time_ms(lambda: plain(*args, **kw), reps=3))
        c, b = facts["count_sized"], facts["budgeted"]
        print(f"phase 14b {kernel.__name__} == plain (tolerance "
              f"{KERNEL_TOL}) on window {w}: count-sized NB={c['NB']} "
              f"L={c['L']} {c['ms']:.4f} ms (bound {c['bound_ms']:.4f}), "
              f"budgeted NB={b['NB']} L={b['L']} {b['ms']:.4f} ms (bound "
              f"{b['bound_ms']:.4f}): padding costs "
              f"{b['ms'] - c['ms']:+.4f} ms a launch [{smi}]", flush=True)
        out[kernel.__name__] = facts
    return out


def _plan_runs(dev, smi, survey, plans, main_voxels, main_stats, raw_stats):
    """14b.  ``survey``: (cfg, images, positions, quats, fan tables).
    Returns ({K1 form: {path: launches}}, facts, run)."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        touched_voxels_brick,
    )
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply
    from sonar_3d_reconstruction_tpu_torch.pipeline import (
        STAT_DTYPES,
        map_ping_sequence,
    )

    cfg, images, positions, quats, tables = survey
    settings = [(mode, rb, budgeted) for mode in ("pallas", "pallas-raw")
                for rb in PLAN_BATCHES for budgeted in (False, True)]

    def run(mode, rb, budgeted):
        # both from a map of the plan's capacity: no growth in either
        kw = (dict(budgets=plans[mode]) if budgeted
              else dict(initial_capacity=plans[mode]["capacity"]))
        return map_ping_sequence(
            images, positions, quats, cfg, device=dev, window=PLAN_WINDOW,
            dtype=torch.float32, dense_mode=mode, records_batch=rb,
            tables=tables, **kw)

    def name(mode, rb, budgeted):
        return (f"map_ping_sequence {mode} rb={rb} "
                f"{'budgets' if budgeted else 'count-sized'}")

    facts, launches = {}, {"bin_apply": {}, "bin_apply_raw": {}}
    reference, stats_of = None, {}
    for s in settings:
        mode, rb, budgeted = s
        raw = mode == "pallas-raw"
        torch.cuda.reset_peak_memory_stats(dev)
        (st, stats), n = _k1_launches_of(lambda: run(*s), raw=raw,
                                         what=name(*s))
        other = bin_apply.launches if raw else bin_apply.raw_launches
        peak = torch.cuda.max_memory_allocated(dev)
        if other or (budgeted and n != PLAN_PINGS // PLAN_WINDOW):
            raise AssertionError(f"{name(*s)}: {n} launches of its K1 form, "
                                 f"{other} of the other")
        _same_stats(stats, raw_stats if raw else main_stats, name(*s),
                    keys=tuple(STAT_DTYPES))
        if budgeted and (stats["overflowed"].any()
                         or not (stats["batch_n_need"] > 0).any()):
            raise AssertionError(f"{name(*s)}: a window overflowed")
        if reference is None:
            keys, log_odds = touched_voxels_brick(st)
            if not (np.array_equal(keys, main_voxels[0])
                    and np.array_equal(log_odds, main_voxels[1])):
                raise AssertionError(f"{name(*s)}: voxels differ from "
                                     f"phase 2's")
            reference = st
        for k in STATE_FIELDS:
            if not torch.equal(getattr(st, k), getattr(reference, k)):
                raise AssertionError(f"{name(*s)}: state {k} differs")
        stats_of.setdefault(mode, stats)
        launches["bin_apply_raw" if raw else "bin_apply"][f"14b {name(*s)}"] = n
        facts[name(*s)] = dict(k1_launches=n, peak_mib=peak / 2**20)
    del st, reference
    for s in settings:
        _, n_launch, n_sync = _launches_and_syncs(lambda: run(*s))
        facts[name(*s)].update(launches_per_ping=n_launch / PLAN_PINGS,
                               syncs_per_run=n_sync)
    walls = {s: [] for s in settings}
    for r in range(PLAN_RUNS):
        for s in (settings if r % 2 == 0 else settings[::-1]):
            walls[s].append(_wall(lambda: run(*s))[1])
    for s in settings:
        q1, med, q3 = np.percentile(walls[s], [25, 50, 75])
        f = facts[name(*s)]
        f.update(wall_s=med, wall_q1_s=q1, wall_q3_s=q3)
        print(f"phase 14b {name(*s)}: wall {med:.3f} s (q1-q3 {q1:.3f}-"
              f"{q3:.3f}, {PLAN_RUNS} alternating runs); "
              f"{f['launches_per_ping']:.1f} kernel launches a ping, "
              f"{f['syncs_per_run']} stream syncs a run; peak memory "
              f"{f['peak_mib']:.1f} MiB; "
              f"{'bin_apply_raw' if s[0] == 'pallas-raw' else 'bin_apply'} "
              f"launches {f['k1_launches']}; voxels == phase 2's, stats == "
              f"phase {'2b' if s[0] == 'pallas-raw' else '2'}'s [{smi}]",
              flush=True)
    facts["k1_windows"] = _padded_k1(dev, smi, run, stats_of)
    return launches, facts, run


def _stale_plans(dev, smi, survey, run, plans):
    """14c: the tuned plan with every budget cut to a quarter (unique
    records) and the unique-record plan on raw lanes: each replays to the
    map of the count-sized run; the scans' causes.  Returns facts."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    plan = plans["pallas"]
    quarter = dict(plan)
    for k, v in plan.items():
        if k.endswith("budget") and not k.startswith("safe") and v:
            quarter[k] = ([max(1, x // 4) for x in v] if isinstance(v, list)
                          else max(1, v // 4))
    (want, _), _ = _wall(lambda: run("pallas", 16, False))
    facts = {}
    for label, stale, mode in (("quarter", quarter, "pallas"),
                               ("unique-record plan, raw lanes", plan,
                                "pallas-raw")):
        with keep_scan_stats() as scans:
            (st, stats), wall = _wall(lambda: map_ping_sequence(
                *survey[1:4], survey[0], device=dev, window=PLAN_WINDOW,
                dtype=torch.float32, dense_mode=mode, records_batch=16,
                tables=survey[4], budgets=stale))
        same = all(torch.equal(getattr(st, k), getattr(want, k))
                   for k in STATE_FIELDS)
        if not same or stats["overflowed"].any() or len(scans) < 2:
            raise AssertionError(f"14c {label}: map equal {same}, "
                                 f"{len(scans)} scans")
        causes = [_causes(x) for x in scans]
        facts[label] = dict(scans=len(scans), causes=causes, wall_s=wall)
        print(f"phase 14c stale plan ({label}): {len(scans)} scans in "
              f"{wall:.3f} s, pings reporting each cause by scan {causes}; "
              f"map bit-equal to the count-sized run [{smi}]", flush=True)
    return facts


def _plan_cli(smi, cli_voxels):
    """14d: ``tune`` and ``map-bag --budgets`` (offline and streaming) in
    subprocesses on phase 5d's bag; each map's voxels equal 5d's."""
    work = os.path.join(ROOT, "build", "chip_smoke")
    bag, plan_path = (os.path.join(work, f) for f in ("cli.db3", "plan.json"))
    if os.path.exists(plan_path):
        os.unlink(plan_path)
    _, tune_s = _cli("tune", bag, "--window", "16", "--out", plan_path)
    with open(plan_path) as f:
        plan = json.load(f)
    if plan["backend"] != "brick" or plan["window"] != 16:
        raise AssertionError(f"14d: tune wrote {plan}")
    facts = dict(tune_process_s=tune_s, plan=plan)
    for label, extra in (("offline", ["--offline"]),
                         ("streaming", ["--chunk", "16"])):
        out, secs = _cli("map-bag", bag, *extra, "--budgets", plan_path)
        summary = json.loads(out.splitlines()[-1])
        if (summary["num_voxels"] != cli_voxels
                or summary["bin_apply_launches"] == 0):
            raise AssertionError(f"14d map-bag {label} --budgets: {summary}, "
                                 f"phase 5d's map {cli_voxels} voxels")
        facts[label] = dict(process_s=secs, num_voxels=summary["num_voxels"],
                            bin_apply_launches=summary["bin_apply_launches"])
    print(f"phase 14d CLI: tune --window 16 on 5d's bag {tune_s:.1f} s "
          f"(unique {plan['unique_budget']}, brick {plan['brick_budget']}, "
          f"capacity {plan['capacity']}); map-bag --budgets --offline "
          f"{facts['offline']['process_s']:.1f} s and streaming "
          f"{facts['streaming']['process_s']:.1f} s, each {cli_voxels} "
          f"voxels as 5d's, bin_apply launches "
          f"{facts['offline']['bin_apply_launches']} / "
          f"{facts['streaming']['bin_apply_launches']}; every exit code 0 "
          f"[{smi}]", flush=True)
    return facts


def phase_budgets(dev, smi, main_voxels, main_stats, raw_stats, cli_voxels):
    """Phase 14: the deployment budget plans on the card (14a tune the
    survey and hold the plan to bench_plan.json, 14b map with plans in
    both dense modes at records_batch 1 and 16, 14c stale plans, 14d the
    CLI).  Returns ({K1 form: {path: launches}}, facts)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
        tables_for_images,
    )

    t0 = time.perf_counter()
    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, PLAN_PINGS)
    tables = tables_for_images(images, cfg)
    survey = (cfg, images, positions, quats, tables)
    plan, raw_plan, tune_launches, facts = _tune_on_card(dev, smi, *survey)
    plans = {"pallas": plan, "pallas-raw": raw_plan}
    launches, facts["runs"], run = _plan_runs(
        dev, smi, survey, plans, main_voxels, main_stats, raw_stats)
    launches["bin_apply"]["14a tune_sequence"] = tune_launches
    facts["stale"] = _stale_plans(dev, smi, survey, run, plans)
    facts["cli"] = _plan_cli(smi, cli_voxels)
    torch.cuda.synchronize()
    facts["phase_s"] = time.perf_counter() - t0
    print(f"phase 14 budget plans on the card: {facts['phase_s']:.1f} s",
          flush=True)
    return launches, facts


SB_PINGS = 256            # 15a, 15c: phase 2's survey
SB_SETTINGS = ((2, "pallas"), (4, "pallas"), (4, "pallas-raw"))  # 15a
SB_S = 4                  # 15b-15d: shards
SB_CAPACITY = 1 << 16     # bricks (hash: slots / 4) a shard: no run grows
SB_RUNS = 3               # 15a: alternating timed runs of each run
SB_SHORT_RUNS = 3         # 15b, 15c: alternating timed runs
SB_REPL_PINGS = 64        # 15b, 15d: the survey's first pings
SB_W1_PINGS = 32          # 15b: the sharded hash engine at window 1
SB_HOSTS = 4              # 15c: segments of the fold
SB_F64_PINGS = 16         # 15d: float64 pings, card against CPU
SB_XCHG = 1024            # 15d: the undersized exchange budget at S = 4


def _ru(x, m):
    return int(-(-int(x) // m) * m)


def _snug_unique(stats):
    """A snug unique budget from a count-sized run's per-ping stats: 1.1x
    the widest frame's records, and a dedup slice (2U) over 1.05x its
    valid candidates, to 4096 (the JAX package's snug margins)."""
    import numpy as np

    u = int((np.asarray(stats["num_occupied"])
             + np.asarray(stats["num_free"])).max())
    valid = int(np.asarray(stats["num_candidates"]).max())
    return _ru(max(1.1 * u, 1.05 * valid / 2), 4096)


def _window_lanes(stats, window):
    """The largest window's summed per-frame records (every shard's)."""
    import numpy as np

    per = (np.asarray(stats["num_occupied"])
           + np.asarray(stats["num_free"])).astype(np.int64)
    return int(np.pad(per, (0, (-len(per)) % window))
               .reshape(-1, window).sum(axis=1).max())


def _quarter(budgets):
    return {k: max(1, v // 4) for k, v in budgets.items()}


def _fold_arrays(stats):
    """The fold's per-frame stats dicts as arrays."""
    import numpy as np

    return {k: np.asarray([x[k] for x in stats]) for k in stats[0]}


@contextlib.contextmanager
def keep_sharded_scans():
    """While open, every scan of the sharded engines (``scan_windows``)
    and every fold of the multi-host wrapper (``apply_record_segments``)
    also appends its per-ping host stats to the list it yields."""
    from sonar_3d_reconstruction_tpu_torch.parallel import (
        multihost,
        shard,
        shard_brick,
        shard_frames,
    )

    scans = []
    saved = [(m, "scan_windows") for m in (shard, shard_brick, shard_frames)]
    saved.append((multihost, "apply_record_segments"))
    fns = {key: getattr(*key) for key in saved}

    def wrap(fn, fold):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            scans.append(_fold_arrays(out[1]) if fold else out[1])
            return out
        return wrapped

    for (m, name), fn in fns.items():
        setattr(m, name, wrap(fn, m is multihost))
    try:
        yield scans
    finally:
        for (m, name), fn in fns.items():
            setattr(m, name, fn)


def _same_sharded(a, b, what):
    """Two sharded maps equal array for array on every shard."""
    import torch

    for s, (x, y) in enumerate(zip(a.shards, b.shards)):
        for k in x._fields:
            if not torch.equal(getattr(x, k), getattr(y, k)):
                raise AssertionError(f"{what}: shard {s} {k} differs")


def _same_shared_stats(got, want, what, skip=()):
    """Every per-ping stat the two runs share, bit for bit."""
    _same_stats(got, want, what, keys=tuple(
        k for k in want if k in got and k not in skip))


def _budget_pair(dev, smi, what, run, size, runs, n_pings, raw=None):
    """``run(budgets)`` count-sized (None) and with ``size(count-sized
    stats)``'s budgets: K1 (``raw`` True: K1-raw; None: no kernel) launches
    and peak memory of one run each, launches a ping and syncs a run of a
    profiled run each, and the median wall of ``runs`` runs in
    alternating order.  Returns (count-sized (state, stats), budgeted
    (state, stats), the budgets, facts)."""
    import numpy as np
    import torch

    out, facts, budgets = {}, {}, None
    for label in ("count-sized", "budgets"):
        if label == "budgets":
            budgets = size(out["count-sized"][1])
        torch.cuda.reset_peak_memory_stats(dev)
        if raw is None:
            res, n = run(budgets), 0
        else:
            res, n = _k1_launches_of(lambda: run(budgets), raw=raw,
                                     what=f"{what} {label}")
        facts[label] = dict(k1_launches=n, peak_mib=(
            torch.cuda.max_memory_allocated(dev) / 2**20))
        out[label] = res
    for label, b in (("count-sized", None), ("budgets", budgets)):
        _, n_launch, n_sync = _launches_and_syncs(lambda: run(b))
        facts[label].update(launches_per_ping=n_launch / n_pings,
                            syncs_per_run=n_sync)
    walls = {"count-sized": [], "budgets": []}
    for r in range(runs):
        order = [("count-sized", None), ("budgets", budgets)]
        for label, b in (order if r % 2 == 0 else order[::-1]):
            walls[label].append(_wall(lambda: run(b))[1])
    for label, f in facts.items():
        q1, med, q3 = np.percentile(walls[label], [25, 50, 75])
        f.update(wall_s=med, wall_q1_s=q1, wall_q3_s=q3)
    c, b = facts["count-sized"], facts["budgets"]
    print(f"phase 15 {what}: count-sized / budgets wall {c['wall_s']:.3f} "
          f"/ {b['wall_s']:.3f} s (median of {runs} alternating runs), "
          f"syncs a run {c['syncs_per_run']} / {b['syncs_per_run']}, "
          f"launches a ping {c['launches_per_ping']:.1f} / "
          f"{b['launches_per_ping']:.1f}, peak {c['peak_mib']:.1f} / "
          f"{b['peak_mib']:.1f} MiB"
          + ("" if raw is None else
             f", {'bin_apply_raw' if raw else 'bin_apply'} launches "
             f"{c['k1_launches']} / {b['k1_launches']}")
          + f"; budgets {budgets} [{smi}]", flush=True)
    return out["count-sized"], out["budgets"], budgets, facts


def _sb_k1(dev, smi, run, budgets, raw, what):
    """K1 (``raw``: K1-raw) on the widest shard window of the count-sized
    run and on the same window of the budgeted run (padded to the
    budgets): bit-equal to its plain version in float32 and float64,
    device time, bound and plain time each.  Returns facts."""
    import numpy as np

    from sonar_3d_reconstruction_tpu_torch.grid import brick
    from sonar_3d_reconstruction_tpu_torch.kernels import bin_apply as k1

    name = "bin_apply_raw" if raw else "bin_apply"
    kernel, plain = ((k1.bin_apply_raw, k1.bin_apply_raw_reference) if raw
                     else (k1.bin_apply, k1.bin_apply_reference))
    fn, lanes = getattr(brick, name), []

    def counted(s_flat, *args, **kw):
        lanes.append(s_flat.shape[0])
        return fn(s_flat, *args, **kw)

    setattr(brick, name, counted)
    try:
        run(None)
    finally:
        setattr(brick, name, fn)
    index = int(np.argmax(lanes))
    facts = {}
    for label, b in (("count_sized", None), ("budgeted", budgets)):
        with keep_k1_call(raw, index) as kept:
            run(b)
        _widest_equals_plain(kept, raw, f"15 {what} {label}")
        args, kw = kept["args"], kept["kw"]
        ms = _device_ms(lambda: kernel(*args, **kw), "bin_apply_kernel")
        facts[label] = dict(
            NB=args[3].shape[0], L=args[0].shape[0], ms=ms,
            bound_ms=_bound_ms(k1_bytes(args, raw, kw["B"])[0]),
            plain_ms=_time_ms(lambda: plain(*args, **kw), reps=3))
    c, b = facts["count_sized"], facts["budgeted"]
    print(f"phase 15 {what}: {name} == plain (tolerance {KERNEL_TOL}, "
          f"float32 and float64) on the widest shard window (call "
          f"{index}): count-sized NB={c['NB']} L={c['L']} {c['ms']:.4f} ms "
          f"(bound {c['bound_ms']:.4f} ms, {c['bound_ms'] / c['ms']:.1%}; "
          f"plain {c['plain_ms']:.3f} ms), padded NB={b['NB']} L={b['L']} "
          f"{b['ms']:.4f} ms (bound {b['bound_ms']:.4f} ms, "
          f"{b['bound_ms'] / b['ms']:.1%}; plain {b['plain_ms']:.3f} ms) "
          f"[{smi}]", flush=True)
    return facts


def _sb_frames(dev, smi, survey, main_voxels, main_stats, raw_stats):
    """15a: the frame-parallel engine, count-sized and with snug budgets,
    at each (S, mode) of SB_SETTINGS.  Returns (launches, facts, the
    snug budgets at S = SB_S in dedup mode)."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.parallel import (
        map_ping_sequence_sharded_frames,
    )

    cfg, images, positions, quats, tables = survey
    want = _by_key(main_voxels)
    launches = {"bin_apply": {}, "bin_apply_raw": {}}
    facts, snug_s4 = {}, None
    for S, mode in SB_SETTINGS:
        raw = mode == "pallas-raw"
        what = f"15a map_ping_sequence_sharded_frames {mode} (S={S})"

        def run(budgets, S=S, mode=mode):
            return map_ping_sequence_sharded_frames(
                images, positions, quats, cfg, mesh=(dev,) * S, window=16,
                dtype=torch.float32, dense_mode=mode, tables=tables,
                local_capacity=SB_CAPACITY, **(budgets or {}))

        def size(stats):
            return dict(
                unique_budget=_snug_unique(stats),
                xchg_budget=_ru(1.1 * stats["xchg_n_max"].max(), 128),
                brick_budget=_ru(1.15 * stats["batch_n_bricks_max"].max(),
                                 1024),
                lane_budget=_ru(1.1 * stats["batch_n_lanes_max"].max(), 8192))

        (cs, cs_stats), (bd, bd_stats), budgets, f = _budget_pair(
            dev, smi, what, run, size, SB_RUNS, SB_PINGS, raw=raw)
        _same_stats(cs_stats, raw_stats if raw else main_stats, what)
        _same_voxels(_touched(cs), want, 0.0, what)
        _same_sharded(bd, cs, f"{what}: budgets vs count-sized")
        _same_shared_stats(bd_stats, cs_stats, what, skip=("xchg_n_max",))
        per_window = cs_stats["xchg_n_max"].reshape(-1, 16).max(axis=1)
        if (bd_stats["overflowed"].any() or cs.local_capacity != SB_CAPACITY
                or not np.array_equal(bd_stats["xchg_n_max"],
                                      np.repeat(per_window, 16))):
            raise AssertionError(f"{what}: a budgeted window overflowed, a "
                                 f"table grew, or xchg_n_max is not the "
                                 f"windows' largest block")
        for label in ("count-sized", "budgets"):
            n = f[label]["k1_launches"]
            if n != S * SB_PINGS // 16:
                raise AssertionError(f"{what} {label}: {n} K1 launches")
            launches["bin_apply_raw" if raw else "bin_apply"][
                f"{what[4:]} {label}"] = n
        if S == SB_S:
            f["k1_window"] = _sb_k1(dev, smi, run, budgets, raw, what)
            if not raw:
                snug_s4 = budgets
        f["budgets"] = budgets
        facts[f"S{S} {mode}"] = f
        print(f"phase {what}: voxels == phase 2's, stats == phase "
              f"{'2b' if raw else '2'}'s; budgeted map and every shared "
              f"stat bit-equal to count-sized, xchg_n_max the window's "
              f"largest block [{smi}]", flush=True)
    return launches, facts, snug_s4


def _sb_replicated(dev, smi, survey):
    """15b: the replicated-records brick engine and the sharded hash
    engine (window 16, SB_REPL_PINGS pings; window 1, SB_W1_PINGS pings),
    count-sized and with snug budgets, each map against the single-map
    pipeline's.  Returns (launches, facts, the snug budgets)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.parallel import (
        map_ping_sequence_sharded,
        map_ping_sequence_sharded_brick,
    )
    from sonar_3d_reconstruction_tpu_torch.pipeline import map_ping_sequence

    cfg, images, positions, quats, _ = survey
    mesh = (dev,) * SB_S
    launches, facts, snug = {"bin_apply": {}}, {}, {}

    def pings(n):
        return images[:n], positions[:n], quats[:n]

    engines = [
        ("brick", SB_REPL_PINGS, 16, lambda b, n: map_ping_sequence_sharded_brick(
            *pings(n), cfg, mesh=mesh, window=16, dtype=torch.float32,
            local_capacity=SB_CAPACITY, **(b or {})),
         lambda st: dict(
             unique_budget=_snug_unique(st),
             brick_budget=_ru(1.15 * st["batch_n_bricks_max"].max(), 1024),
             lane_budget=_ru(1.1 * st["batch_n_lanes_max"].max(), 8192))),
        ("hash", SB_REPL_PINGS, 16, lambda b, n: map_ping_sequence_sharded(
            *pings(n), cfg, mesh=mesh, window=16, dtype=torch.float32,
            local_capacity=4 * SB_CAPACITY, **(b or {})),
         lambda st: dict(
             unique_budget=_snug_unique(st),
             batch_budget=_ru(1.15 * st["batch_n_unique_max"].max(), 8192),
             lane_budget=_ru(1.1 * _window_lanes(st, 16), 8192))),
        ("hash w1", SB_W1_PINGS, 1, lambda b, n: map_ping_sequence_sharded(
            *pings(n), cfg, mesh=mesh, window=1, dtype=torch.float32,
            local_capacity=4 * SB_CAPACITY, **(b or {})),
         lambda st: dict(unique_budget=_snug_unique(st))),
    ]
    for name, n, window, run, size in engines:
        what = (f"15b map_ping_sequence_sharded"
                f"{'_brick' if name == 'brick' else ''} window {window} "
                f"(S={SB_S}, {n} pings)")
        single, _ = map_ping_sequence(
            *pings(n), cfg, device=dev, backend=name.split()[0],
            window=window, dtype=torch.float32)
        (cs, cs_stats), (bd, bd_stats), budgets, f = _budget_pair(
            dev, smi, what, lambda b: run(b, n), size, SB_SHORT_RUNS, n,
            raw=False if name == "brick" else None)
        _same_voxels(_touched(cs), _touched(single), 0.0, what)
        _same_sharded(bd, cs, f"{what}: budgets vs count-sized")
        _same_shared_stats(bd_stats, cs_stats, what)
        if bd_stats["overflowed"].any():
            raise AssertionError(f"{what}: a budgeted step overflowed")
        if name == "brick":
            for label in ("count-sized", "budgets"):
                launches["bin_apply"][f"{what[4:]} {label}"] = (
                    f[label]["k1_launches"])
        f["budgets"] = budgets
        facts[name] = f
        snug[name] = budgets
        print(f"phase {what}: voxels == the single-map pipeline's; "
              f"budgeted map and every shared stat bit-equal to "
              f"count-sized [{smi}]", flush=True)
    return launches, facts, snug


def _sb_fold(dev, smi, survey):
    """15c: the multi-host fold (SB_HOSTS segments, window 16) on the
    brick and the hash map, count-sized and with snug budgets.  Returns
    (launches, facts, the snug budgets)."""
    import numpy as np
    import torch

    from sonar_3d_reconstruction_tpu_torch.parallel import (
        map_ping_sequence_multihost,
    )

    cfg, images, positions, quats, _ = survey
    launches, facts, snug = {"bin_apply": {}}, {}, {}
    for backend in ("brick", "hash"):
        what = (f"15c map_ping_sequence_multihost ({backend}, {SB_HOSTS} "
                f"segments)")

        def run(budgets, backend=backend):
            st, stats = map_ping_sequence_multihost(
                images, positions, quats, cfg, n_hosts=SB_HOSTS, window=16,
                backend=backend, dtype=torch.float32, device=dev,
                **(budgets or {}))
            return st, _fold_arrays(stats)

        def size(stats, backend=backend):
            if backend == "brick":
                batch = _ru(1.15 * stats["batch_n_bricks"].max(), 1024)
            else:
                # the hash fold's lane slice is twice its batch budget
                batch = max(_ru(1.15 * stats["batch_n_unique"].max(), 8192),
                            _ru(0.55 * _window_lanes(stats, 16), 8192))
            return dict(unique_budget=_snug_unique(stats),
                        batch_budget=batch)

        (cs, cs_stats), (bd, bd_stats), budgets, f = _budget_pair(
            dev, smi, what, run, size, SB_SHORT_RUNS, SB_PINGS,
            raw=False if backend == "brick" else None)
        for k in cs._fields:
            if not torch.equal(getattr(bd, k), getattr(cs, k)):
                raise AssertionError(f"{what}: budgeted state {k} differs")
        _same_shared_stats(bd_stats, cs_stats, what)
        if bd_stats["overflowed"].any() or not np.array_equal(
                cs_stats["num_candidates"], bd_stats["num_candidates"]):
            raise AssertionError(f"{what}: a budgeted window overflowed")
        if backend == "brick":
            for label in ("count-sized", "budgets"):
                launches["bin_apply"][f"{what[4:]} {label}"] = (
                    f[label]["k1_launches"])
        f["budgets"] = budgets
        facts[backend] = f
        snug[backend] = budgets
        print(f"phase {what}: budgeted map and every shared stat bit-equal "
              f"to count-sized [{smi}]", flush=True)
    return launches, facts, snug


def _sb_undersized(dev, smi, survey, snug_frames, snug_repl, snug_fold):
    """15d: a quarter of each snug budget (and SB_XCHG lanes a block at S
    = SB_S; the window-1 hash engine a quarter of a shard's share of its
    unique budget) on SB_REPL_PINGS pings through every engine: the causes
    each scan names, and the map of the count-sized run; SB_F64_PINGS
    float64 pings at the snug budgets, card against CPU.  Returns
    facts."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.parallel import (
        map_ping_sequence_multihost,
        map_ping_sequence_sharded,
        map_ping_sequence_sharded_brick,
        map_ping_sequence_sharded_frames,
    )

    cfg, images, positions, quats, _ = survey
    n = SB_REPL_PINGS
    pings = (images[:n], positions[:n], quats[:n])
    mesh = (dev,) * SB_S
    sharded = dict(mesh=mesh, dtype=torch.float32)
    runs = [
        ("frames quarter", lambda b: map_ping_sequence_sharded_frames(
            *pings, cfg, window=16, **sharded, **b), _quarter(snug_frames)),
        (f"frames xchg {SB_XCHG}", lambda b: map_ping_sequence_sharded_frames(
            *pings, cfg, window=16, **sharded, **b),
         dict(xchg_budget=SB_XCHG)),
        ("replicated brick quarter", lambda b: map_ping_sequence_sharded_brick(
            *pings, cfg, window=16, **sharded, **b),
         _quarter(snug_repl["brick"])),
        ("hash window 16 quarter", lambda b: map_ping_sequence_sharded(
            *pings, cfg, window=16, **sharded, **b),
         _quarter(snug_repl["hash"])),
        # the frame's snug unique budget, which each shard's dedup takes,
        # is about S times a shard's records: a quarter of a shard's share
        ("hash window 1 quarter share", lambda b: map_ping_sequence_sharded(
            images[:SB_W1_PINGS], positions[:SB_W1_PINGS],
            quats[:SB_W1_PINGS], cfg, window=1, **sharded, **b),
         {"unique_budget": max(1, snug_repl["hash w1"]["unique_budget"]
                               // (4 * SB_S))}),
    ]
    for backend in ("brick", "hash"):
        runs.append((f"fold {backend} quarter",
                     lambda b, backend=backend: map_ping_sequence_multihost(
                         *pings, cfg, n_hosts=SB_HOSTS, window=16,
                         backend=backend, dtype=torch.float32, device=dev,
                         **b),
                     _quarter(snug_fold[backend])))
    facts = {}
    for label, run, budgets in runs:
        (want, _), _ = _wall(lambda: run({}))
        with keep_sharded_scans() as scans:
            (st, stats), wall = _wall(lambda: run(budgets))
        if isinstance(stats, list):
            stats = _fold_arrays(stats)
        causes = [_causes(x) for x in scans]
        _same_voxels(_touched(st), _touched(want), 0.0, f"15d {label}")
        if stats["overflowed"].any() or len(scans) < 2:
            raise AssertionError(f"15d {label}: {len(scans)} scans, "
                                 f"overflow left {stats['overflowed'].any()}")
        facts[label] = dict(budgets=budgets, scans=len(scans), causes=causes,
                            wall_s=wall)
        print(f"phase 15d {label}: budgets {budgets}; {len(scans)} scans in "
              f"{wall:.3f} s, pings reporting each cause by scan {causes}; "
              f"voxels and log-odds equal the count-sized run's [{smi}]",
              flush=True)

    # float64 on the card and the CPU at the snug budgets (one scan: the
    # CPU maps the full-size pings of every shard): every shard array and
    # stat equal
    m = SB_F64_PINGS
    b = snug_frames
    out = {}
    for where, mesh64 in (("card", mesh), ("cpu", ("cpu",) * SB_S)):
        (out[where]), secs = _wall(lambda: map_ping_sequence_sharded_frames(
            images[:m], positions[:m], quats[:m], cfg, window=16,
            mesh=mesh64, dtype=torch.float64, **b))
        facts[f"float64 {where}_s"] = secs
    (gpu, g_stats), (cpu, c_stats) = out["card"], out["cpu"]
    for s, (x, y) in enumerate(zip(gpu.shards, cpu.shards)):
        for k in x._fields:
            if not torch.equal(getattr(x, k).cpu(), getattr(y, k)):
                raise AssertionError(f"15d float64: shard {s} {k} differs "
                                     f"between the card and the CPU")
    _same_shared_stats(g_stats, c_stats, "15d float64 card vs CPU")
    print(f"phase 15d float64: {m} pings, frame-parallel engine at S={SB_S} "
          f"with budgets {b}: every shard array and per-ping stat "
          f"bit-equal card vs CPU (card {facts['float64 card_s']:.3f} s, "
          f"CPU {facts['float64 cpu_s']:.3f} s) [{smi}]", flush=True)
    return facts


def phase_sharded_budgets(dev, smi, main_voxels, main_stats, raw_stats):
    """Phase 15: the sharded engines' and the multi-host fold's budgets on
    the card, the card repeated as the mesh (15a the frame-parallel
    engine, 15b the replicated-records engines, 15c the fold, 15d
    undersized budgets).  Returns ({K1 form: {path: launches}}, facts)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
        tables_for_images,
    )

    t0 = time.perf_counter()
    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, SB_PINGS)
    survey = (cfg, images, positions, quats, tables_for_images(images, cfg))
    launches, facts = {"bin_apply": {}, "bin_apply_raw": {}}, {}
    parts_s = {}
    t = time.perf_counter()
    part, facts["frames"], snug_frames = _sb_frames(
        dev, smi, survey, main_voxels, main_stats, raw_stats)
    for k in launches:
        launches[k].update(part.get(k, {}))
    parts_s["15a"], t = time.perf_counter() - t, time.perf_counter()
    part, facts["replicated"], snug_repl = _sb_replicated(dev, smi, survey)
    launches["bin_apply"].update(part["bin_apply"])
    parts_s["15b"], t = time.perf_counter() - t, time.perf_counter()
    part, facts["fold"], snug_fold = _sb_fold(dev, smi, survey)
    launches["bin_apply"].update(part["bin_apply"])
    parts_s["15c"], t = time.perf_counter() - t, time.perf_counter()
    facts["undersized"] = _sb_undersized(dev, smi, survey, snug_frames,
                                         snug_repl, snug_fold)
    parts_s["15d"] = time.perf_counter() - t
    torch.cuda.synchronize()
    facts["phase_s"] = time.perf_counter() - t0
    facts["parts_s"] = parts_s
    print(f"phase 15 sharded budgets on the card: {facts['phase_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in parts_s.items()) + ")",
          flush=True)
    return launches, facts


BOX_WORDS_FRAMES = 64   # phase 16: the cell's batch (window = records_batch)
BOX_WORDS_CAPS = dict(fan_cap=10, window_cap=40, free_cap=189)  # its plan's
BOX_WORDS_REPS = 20     # phase 16: kernel calls a profile
PLAIN_REPS = 5          # phase 16: plain-chain calls timed


def box_words_bytes(images, T, tables, cfg, skey, dtype):
    """Bytes a records-kernel call must move: the rays' columns of the
    images read once, the (F, N) words and the (F, 3) bounds written once,
    the poses and the fan tables read once."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
        _device_tables,
        _fan_trig,
    )

    F, R, _ = images.shape
    tab = _device_tables(tables, images.device, dtype)
    trig = _fan_trig(tables, images.device, dtype, cfg.half_aperture_rad)[:2]
    size = torch.empty((), dtype=dtype).element_size()
    return (F * R * tables.n_rays * images.element_size() + _nbytes(skey)
            + _nbytes(T, *tab.values(), *trig) + F * (2 * 3 * size + 9))


def phase_box_words(dev, smi):
    """Phase 16: the records kernel at the benchmark cell's batch, against
    the plain chain.  Returns ({path: launches}, facts)."""
    import torch

    from sonar_3d_reconstruction_tpu_torch.bench import make_inputs
    from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
    from sonar_3d_reconstruction_tpu_torch.geometry import (
        batched_sonar_to_world,
    )
    from sonar_3d_reconstruction_tpu_torch.grid.brick import DEFAULT_BRICK_BITS
    from sonar_3d_reconstruction_tpu_torch.kernels import box_words as kw
    from sonar_3d_reconstruction_tpu_torch.ops import records
    from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
        build_fan_tables,
    )
    from sonar_3d_reconstruction_tpu_torch.ops.packing import (
        compute_window_boxes,
    )

    t0 = time.perf_counter()
    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, BOX_WORDS_FRAMES, seed=16)
    tables = build_fan_tables(cfg, *images.shape[1:], **BOX_WORDS_CAPS)
    box_min, box_bits = compute_window_boxes(
        positions, cfg.max_range, cfg.voxel_resolution, BOX_WORDS_FRAMES,
        DEFAULT_BRICK_BITS, frame_bits=1)
    img = torch.as_tensor(images, device=dev)
    before = kw.launches
    facts = {}
    for dtype in (torch.float32, torch.float64):
        T = torch.as_tensor(batched_sonar_to_world(positions, quats, cfg),
                            device=dev).to(dtype)
        for form, box in (("brick codes", None),
                          ("box keys", torch.as_tensor(box_min[0],
                                                       device=dev))):
            args = (img, T, tables, cfg, box, None if box is None else
                    box_bits, DEFAULT_BRICK_BITS, dtype)
            skey, aux = records.sort_words(*args)
            want, want_aux = records.sort_words_plain(*args)
            torch.cuda.synchronize()
            for name, a, b in zip(("skey",) + aux._fields,
                                  (skey,) + tuple(aux),
                                  (want,) + tuple(want_aux)):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"phase 16: box_words {form} {dtype} {name} "
                        f"differs from the plain chain")
            ms = _device_ms(lambda: kw.box_words(*args), "box_words_kernel",
                            reps=BOX_WORDS_REPS)
            plain_ms = _time_ms(lambda: records.sort_words_plain(*args),
                                reps=PLAIN_REPS)
            nbytes = box_words_bytes(img, T, tables, cfg, skey, dtype)
            facts[f"{form} {str(dtype)[6:]}"] = dict(
                F=BOX_WORDS_FRAMES, N=skey.shape[1], ms=ms,
                bytes=nbytes, bound_ms=_bound_ms(nbytes),
                share_of_bound=_bound_ms(nbytes) / ms, plain_ms=plain_ms,
                valid_lanes=int(aux.n_valid.sum()))
            del skey, aux, want, want_aux
    launches = kw.launches - before
    print(f"phase 16 records kernel: box_words == plain chain at F = "
          f"{BOX_WORDS_FRAMES}, N = "
          f"{facts['brick codes float32']['N']:,}, both forms, float32 and "
          f"float64; device ms a call (bound, share, plain ms): "
          + "; ".join(f"{k} {v['ms']:.4f} ({v['bound_ms']:.4f}, "
                      f"{v['share_of_bound']:.1%}, {v['plain_ms']:.3f})"
                      for k, v in facts.items())
          + f" ({time.perf_counter() - t0:.1f} s, {smi})", flush=True)
    return {"phase 16 (the cell's batch)": launches}, facts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from sonar_3d_reconstruction_tpu_torch.grid.brick import (
        brick_state_to_numpy,
        touched_voxels_brick,
    )

    dev, smi = phase_build()
    # the records kernel's launches, each path's: the main paths' warm
    # runs, then every later phase's (its subprocesses' CLI runs included)
    words_by_path = {}

    def counted(path, phase, *args):
        before = _words_launched()
        out = phase(*args)
        words_by_path[path] = _words_launched() - before
        return out

    k1_launches, words_main, k1_shape, k1_real, *dedup = phase_main_path(
        dev, "pallas")
    raw_launches, words_raw, raw_shape, raw_real, *raw = phase_main_path(
        dev, "pallas-raw")
    words_by_path.update({"main": words_main, "main (pallas-raw)": words_raw})
    check_raw_equals_dedup(dedup, raw)
    main_voxels = touched_voxels_brick(dedup[0])
    main_stats, raw_stats = dedup[1], raw[1]
    main_np = brick_state_to_numpy(dedup[0])
    del dedup, raw
    k1 = _k1_form(dev, k1_shape, k1_real, raw=False)
    k1_raw = _k1_form(dev, raw_shape, raw_real, raw=True)
    del k1_real, raw_real
    k2 = phase_k2(dev)
    counted("phase 4 cross-check", phase_cross_check, dev)
    entry_launches, entry = counted(
        "phase 5 entry points", phase_entry_points, dev, smi, main_voxels)
    stream_launches, stream = counted(
        "phase 6 stream, CLI and node", phase_stream,
        dev, smi, main_voxels, entry["process_sonar_image_ms"],
        entry["cli_map_bag"]["num_voxels"])
    (wide_launches, hash_wide, hash_voxels, wide_voxels,
     hash_runs) = counted(
        "phase 7 hash and wide keys", phase_hash_and_wide,
        dev, smi, main_voxels, main_stats, entry["cli_map_bag"]["num_voxels"])
    late_launches, dense_fold = counted(
        "phase 8 dense and multi-host fold", phase_dense_and_multihost,
        dev, smi, main_voxels, main_stats, hash_voxels)
    sharded_launches, sharded = counted(
        "phase 9 sharded", phase_sharded, dev, smi, main_voxels, main_stats,
        wide_voxels, entry["cli_map_bag"]["num_voxels"])
    del wide_voxels
    replicated_launches, replicated = counted(
        "phase 10 replicated", phase_replicated, dev, smi, main_voxels,
        main_stats, hash_voxels, hash_runs)
    del hash_voxels, hash_runs
    raw_sharded_launches, late_checks = counted(
        "phase 11 owner blocks, raw, poses", phase_owner_blocks_raw_poses,
        dev, smi, main_voxels, main_stats)
    batch_launches, batched = counted(
        "phase 12 records_batch", phase_records_batch,
        dev, smi, main_np, main_stats, raw_stats)
    golden_launches, golden = counted(
        "phase 13 golden", phase_golden, dev, smi)
    budget_launches, budgets = counted(
        "phase 14 budgets", phase_budgets, dev, smi, main_voxels, main_stats,
        raw_stats, entry["cli_map_bag"]["num_voxels"])
    shard_budget_launches, shard_budgets = counted(
        "phase 15 sharded budgets", phase_sharded_budgets,
        dev, smi, main_voxels, main_stats, raw_stats)
    words_phase, words = phase_box_words(dev, smi)
    words_by_path.update(words_phase)

    bin_src = "sonar_3d_reconstruction_tpu_torch/csrc/bin_apply.cu"
    bin_tpu = "sonar_3d_reconstruction_tpu/pallas/bin_kernel.py:61"
    # launches: the warm main-path run's (K2 has no product path; the
    # launches of its chains are listed apart); by_path: each path's own
    rows = [
        ("bin_apply", bin_src, bin_tpu, k1_launches,
         dict(main=k1_launches, **entry_launches,
              **stream_launches["bin_apply"], **wide_launches,
              **late_launches, **sharded_launches, **replicated_launches,
              **batch_launches["bin_apply"], **golden_launches["bin_apply"],
              **budget_launches["bin_apply"],
              **shard_budget_launches["bin_apply"]),
         dict(k1, entry_points=entry, stream=stream, **hash_wide,
              **dense_fold, **sharded, **replicated,
              owner_blocks=late_checks["owner_blocks"],
              poses=late_checks["poses"], records_batch=batched,
              golden=golden, budgets=budgets,
              sharded_budgets=shard_budgets)),
        ("bin_apply_raw", bin_src, bin_tpu, raw_launches,
         {"main (pallas-raw)": raw_launches,
          **stream_launches["bin_apply_raw"], **raw_sharded_launches,
          **batch_launches["bin_apply_raw"],
          **golden_launches["bin_apply_raw"],
          **budget_launches["bin_apply_raw"],
          **shard_budget_launches["bin_apply_raw"]},
         dict(k1_raw, sharded_raw=late_checks["sharded_raw"],
              budgets_k1_windows=budgets["runs"]["k1_windows"][
                  "bin_apply_raw"],
              sharded_budgets_k1_window=shard_budgets["frames"][
                  f"S{SB_S} pallas-raw"]["k1_window"])),
        ("lookup_accumulate",
         "sonar_3d_reconstruction_tpu_torch/csrc/lookup_accumulate.cu",
         "sonar_3d_reconstruction_tpu/pallas/table_kernel.py:51", 0, {}, k2),
        # launches: the warm main-path run's; by_path: each path's
        ("box_words", "sonar_3d_reconstruction_tpu_torch/csrc/box_words.cu",
         None, words_main, words_by_path, words),
    ]
    print(json.dumps({"kernels": [dict(
        name=name,
        route="cuda",
        source=source,
        replaces=replaces,
        launches=launches,
        paths=[p for p, n in by_path.items() if n],
        launches_by_path=by_path,
        library_ms=None,  # no single PyTorch call computes the function
        **fields,
    ) for name, source, replaces, launches, by_path, fields in rows]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
