"""The records kernel (kernels/box_words.py, csrc/box_words.cu) and the sort
words it emits.

On the CPU ``frame_records`` takes the plain PyTorch chain
(``ops.records.sort_words_plain``): its box-key records are held to that
chain's ops written out here (backprojection, floor keying,
``pack_box_keys``, the compact dedup), in both the deduped and the raw
branch; ``dedup_compact_words`` is held to records counted independently;
and the wrapper's pixel operand is held to torch's own comparison.

On the card (``-m cuda``; this file imports no JAX, so it runs there with
``python -m pytest --noconftest -m cuda tests/test_torch_box_words.py``)
the kernel's sort words and every FrameAux field are bit-equal to the
plain chain on the same device, at the benchmark cell's tables (500 x 512
pings, ``fan_cap`` 10, ``window_cap`` 40, ``free_cap`` 189), and a short
``map_ping_sequence`` gives bit-equal states and stats with the kernel and
with the plain chain forced.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sonar_3d_reconstruction_tpu_torch import pipeline  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.bench import make_inputs  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.geometry import (  # noqa: E402
    batched_sonar_to_world,
)
from sonar_3d_reconstruction_tpu_torch.grid.brick import (  # noqa: E402
    DEFAULT_BRICK_BITS,
    brick_state_to_numpy,
)
from sonar_3d_reconstruction_tpu_torch.kernels import box_words as kw  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.ops import records  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (  # noqa: E402
    backproject_ping,
    build_fan_tables,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import (  # noqa: E402
    dedup_frame,
    dedup_frame_compact,
    dedup_compact_words,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import (  # noqa: E402
    EMPTY32,
    compute_window_boxes,
    pack_box_keys,
    pack_brick_keys,
)

BB = DEFAULT_BRICK_BITS
CELL_CAPS = dict(fan_cap=10, window_cap=40, free_cap=189)
# a small geometry for the CPU: the bench survey's band needs 190+ bins
SMALL = MapperConfig(image_height=240, image_width=64, max_range=5.0,
                     voxel_resolution=0.1)


def _case(frames, dtype, device, *, seed=0, cfg=None, box="window",
          small=False, caps=CELL_CAPS):
    """(images, transforms, tables, cfg, box_min, box_bits) of ``frames``
    bench pings on ``device``: one box for them all (``box="window"``), one
    a frame (``"frame"``, (F, 1, 3)) or none (``"none"``: brick codes);
    ``small`` cuts the box's bits so that valid keys fall outside it
    (``range_fail``)."""
    cfg = cfg or MapperConfig()
    images, positions, quats = make_inputs(cfg, frames, seed=seed)
    R, B = images.shape[1:]
    tables = build_fan_tables(cfg, R, B, **caps)
    T = torch.as_tensor(batched_sonar_to_world(positions, quats, cfg),
                        device=device).to(dtype)
    images = torch.as_tensor(images, device=device)
    if box == "none":
        return images, T, tables, cfg, None, None
    # one frame bit: the cell's 64-ping windows need six, which no box of
    # theirs fits (they take brick codes)
    mins, bits = compute_window_boxes(
        positions, cfg.max_range, cfg.voxel_resolution,
        1 if box == "frame" else frames, BB, frame_bits=1)
    if small:
        bits = tuple(max(1, b - 3) for b in bits)
    box_min = torch.as_tensor(mins, device=device)
    box_min = box_min[:, None, :] if box == "frame" else box_min[0]
    return images, T, tables, cfg, box_min, bits


def _old_chain(images, T, tables, cfg, box_min, bits, dtype, raw):
    """The records as ``frame_records`` built them before the sort words:
    backprojection, floor keying, ``pack_box_keys`` then the compact dedup
    or the raw records, or without a box ``pack_brick_keys`` then the
    two-word dedup."""
    cand = backproject_ping(images, T, tables, cfg, dtype=dtype)
    res = torch.full((), cfg.voxel_resolution, dtype=dtype)
    keys = torch.floor(cand["points"] / res).to(torch.int32)
    if box_min is None:
        hi, lo, in_range = pack_brick_keys(keys, BB)
        valid = cand["valid"] & in_range
        return dedup_frame(hi, lo, cand["is_occupied"], valid, True)
    bkey, in_range = pack_box_keys(keys, box_min, bits, BB)
    valid = cand["valid"] & in_range
    occ = cand["is_occupied"]
    if not raw:
        return dedup_frame_compact(bkey, occ, valid)
    return (torch.where(valid, bkey, EMPTY32),
            torch.where(valid, (1 << 16) | occ.to(torch.int64), 0),
            valid.sum(dim=-1))


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("box", ["window", "frame", "none"])
def test_cpu_frame_records_take_the_plain_chain(raw, box, monkeypatch):
    """On the CPU the box-key and brick-code records come from the plain
    chain (the kernel wrapper is never called) and equal the records of
    the chain's ops written out, in both branches of box keys and with a
    box per frame; raw records need a box."""
    def refuse(*a, **k):
        raise AssertionError("the kernel wrapper ran on the CPU")

    monkeypatch.setattr(kw, "box_words", refuse)
    dtype = torch.float64
    images, T, tables, cfg, box_min, bits = _case(
        3, dtype, "cpu", cfg=SMALL, caps={}, box=box)
    if raw and box_min is None:
        with pytest.raises(ValueError, match="raw records need box keys"):
            records.frame_records(images, T, tables, cfg, None, None, BB,
                                  dtype=dtype, raw=True)
        return
    rec, aux = records.frame_records(images, T, tables, cfg, box_min, bits,
                                     BB, dtype=dtype, raw=raw)
    want = _old_chain(images, T, tables, cfg, box_min, bits, dtype, raw)
    if raw:
        assert torch.equal(rec.key, want[0])
        assert torch.equal(rec.payload, want[1])
        assert torch.equal(rec.n_unique, want[2])
        assert not rec.pack_fail.any()
    else:
        for got, exp in zip(rec, want):
            assert torch.equal(got, exp)
    assert int(aux.n_valid.sum()) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("budget", [None, 150])
def test_dedup_compact_words_counts_each_voxel(seed, budget):
    """``dedup_compact_words`` gives each row's distinct voxels in ascending
    order with their candidate and occupied counts, as counted here with
    ``torch.unique``; rows of a batch dedup alone."""
    rng = np.random.default_rng(seed)
    F, N = 3, 300
    key = torch.as_tensor(rng.integers(0, 50, size=(F, N)))
    occ = torch.as_tensor(rng.random((F, N)) < 0.3)
    valid = torch.as_tensor(rng.random((F, N)) < 0.8)
    skey = torch.where(valid, (key << 1) | occ.to(torch.int64), EMPTY32)
    rec = dedup_compact_words(skey, unique_budget=budget)
    for f in range(F):
        vk = key[f][valid[f]]
        u, count = torch.unique(vk, return_counts=True)
        n_occ = torch.stack([(occ[f][valid[f]] & (vk == x)).sum() for x in u])
        n = len(u)
        assert int(rec.n_unique[f]) == n
        width = N if budget is None else budget
        assert rec.key.shape[-1] == width
        m = min(n, width)
        assert torch.equal(rec.key[f, :m], u[:m])
        assert torch.equal(rec.payload[f, :m], ((count << 16) | n_occ)[:m])
        assert (rec.key[f, m:] == EMPTY32).all()
        assert (rec.payload[f, m:] == 0).all()
        alone = dedup_compact_words(skey[f], unique_budget=budget)
        assert torch.equal(alone.key, rec.key[f])
        assert torch.equal(alone.payload, rec.payload[f])


@pytest.mark.parametrize("threshold", [35.0, 34.99999, 35.3, 120, 0.5])
@pytest.mark.parametrize("pixels", ["uint8", "int16", "int32", "float16",
                                    "bfloat16", "float32", "float64"])
def test_image_operand_compares_as_torch(pixels, threshold):
    """The kernel's test ``double(pixel) > threshold`` on the wrapper's
    operand is torch's ``images > threshold`` for every pixel dtype."""
    rng = np.random.default_rng(7)
    vals = np.concatenate([rng.integers(0, 256, 500).astype(np.float64),
                           np.arange(33.0, 37.0, 1 / 64), [0.5, 1.0, 120.0]])
    images = torch.as_tensor(vals).to(getattr(torch, pixels))
    ops, kind, thr = kw.image_operand(images, threshold)
    assert kind in (0, 1, 2)
    assert ops.dtype in (torch.uint8, torch.float32, torch.float64)
    assert torch.equal(ops.to(torch.float64) > thr, images > threshold)


def test_box_words_runs_on_cuda_only():
    images, T, tables, cfg, box_min, bits = _case(1, torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kw.box_words(images, T, tables, cfg, box_min, bits, BB,
                     torch.float32)


# ---------------------------------------------------------------- the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU form")
    return torch.device("cuda", 0)


def _same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got, want), f"{what}: {(got != want).sum()} differ"


CASES = {
    "F1": dict(frames=1),
    "F3": dict(frames=3),
    "F64": dict(frames=64),
    "frames_off": dict(frames=3, frame_on=[True, False, True]),
    "one_frame_off": dict(frames=1, frame_on=False),
    "z_filter": dict(frames=3, z_filter=True),
    "box_a_frame": dict(frames=3, box="frame"),
    "range_fail": dict(frames=3, small=True),
    "unbatched": dict(frames=1, unbatched=True),
    "float_pixels": dict(frames=3, pixels=torch.float32),
    "codes_F1": dict(frames=1, box="none"),
    "codes_F64": dict(frames=64, box="none"),
    "codes_frames_off": dict(frames=3, box="none",
                             frame_on=[False, True, True]),
    "codes_z_filter": dict(frames=3, box="none", z_filter=True),
    "codes_unbatched": dict(frames=1, box="none", unbatched=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain_chain(case, dtype):
    dev = _cuda()
    c = CASES[case]
    cfg = MapperConfig()
    if c.get("z_filter"):
        cfg = cfg.replace(z_filter_enabled=True, z_filter_min=-5.0)
    images, T, tables, cfg, box_min, bits = _case(
        c["frames"], dtype, dev, seed=11, cfg=cfg, box=c.get("box", "window"),
        small=c.get("small", False))
    if "pixels" in c:
        images = images.to(c["pixels"])
    on = c.get("frame_on")
    on = None if on is None else torch.as_tensor(on, device=dev)
    if c.get("unbatched"):
        images, T = images[0], T[0]
    before = kw.launches
    skey, aux = records.sort_words(images, T, tables, cfg, box_min, bits, BB,
                                   dtype, on)
    want_skey, want_aux = records.sort_words_plain(
        images, T, tables, cfg, box_min, bits, BB, dtype, on)
    torch.cuda.synchronize()
    assert kw.launches == before + 1
    _same(skey, want_skey, "skey")
    for name, got, want in zip(aux._fields, aux, want_aux):
        _same(got, want, name)
    n = int(want_aux.n_valid.sum())
    if on is not None:
        assert bool((want_aux.n_valid[~on.reshape(-1)] == 0).all())
    if case == "range_fail":
        assert bool(want_aux.range_fail.any())
    elif on is None:
        assert n > 0 and not bool(want_aux.range_fail.any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_cuda_sort_words_refuse_other_dtypes(dtype):
    dev = _cuda()
    images, T, tables, cfg, box_min, bits = _case(1, torch.float32, dev)
    with pytest.raises(TypeError, match="float32 or float64"):
        records.sort_words(images, T, tables, cfg, box_min, bits, BB, dtype)


def _map(dev, images, positions, quats, window, dense_mode, plain,
         monkeypatch):
    if plain:
        monkeypatch.setattr(records, "sort_words", records.sort_words_plain)
    try:
        state, stats = pipeline.map_ping_sequence(
            images, positions, quats, MapperConfig(), device=dev,
            window=window, records_batch=window, dense_mode=dense_mode)
        torch.cuda.synchronize()
        return brick_state_to_numpy(state), stats
    finally:
        monkeypatch.undo()


@pytest.mark.cuda
@pytest.mark.parametrize("dense_mode", ["pallas", "pallas-raw"])
@pytest.mark.parametrize("window", [8, 24])
def test_cuda_map_equals_plain_chain(window, dense_mode, monkeypatch):
    """A 24-ping survey maps to the same state and stats with the kernel
    and with the plain chain forced: in windows of 8 (box keys, deduped
    and raw) and in one window of 24 (no box fits: brick codes)."""
    dev = _cuda()
    images, positions, quats = make_inputs(MapperConfig(), 24, seed=5)
    before = kw.launches
    state, stats = _map(dev, images, positions, quats, window, dense_mode,
                        False, monkeypatch)
    assert kw.launches > before
    before = kw.launches
    want_state, want_stats = _map(dev, images, positions, quats, window,
                                  dense_mode, True, monkeypatch)
    assert kw.launches == before
    assert state.keys() == want_state.keys()
    for k in state:
        assert np.array_equal(state[k], want_state[k]), k
    for k in want_stats:
        assert np.array_equal(np.asarray(stats[k]),
                              np.asarray(want_stats[k])), k
    assert int(np.asarray(stats["num_occupied"]).sum()) > 0


def test_cell_tables_lanes():
    """The cell's tables give the lattice the card tests and phase 16 of
    chip_smoke.py run at: 256 rays x (73 free lanes + 40 window bins x 21
    fan steps)."""
    cfg = MapperConfig()
    tables = build_fan_tables(cfg, cfg.image_height, cfg.image_width,
                              **CELL_CAPS)
    assert tables.candidates_per_ping(cfg.occupied_window) == 233_728
