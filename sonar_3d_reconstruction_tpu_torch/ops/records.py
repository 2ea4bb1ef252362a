"""Frame records: the state-independent half of the map update (PyTorch port
of ``sonar_3d_reconstruction_tpu.ops.records``).

A frame's contribution to the map is its unique-voxel records plus a few
reductions (bounds, range check).  They need only the ping and its pose,
not the map, so the sequential dependency of the adaptive update lives
entirely in the window apply.

Box keys and brick codes reach their dedup as sort words (``sort_words``):
on the card one kernel emits them straight from the pings and poses
(kernels/box_words.py), elsewhere the PyTorch chain does
(``sort_words_plain``, the kernel's plain version).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig
from sonar_3d_reconstruction_tpu_torch.kernels import box_words as k_words
from sonar_3d_reconstruction_tpu_torch.ops.backproject import (
    FanTables,
    backproject_ping,
)
from sonar_3d_reconstruction_tpu_torch.ops.dedup import (
    CompactRecords,
    UniqueRecords,
    code_sort_words,
    compact_sort_words,
    dedup_code_words,
    dedup_compact_words,
    dedup_frame,
)
from sonar_3d_reconstruction_tpu_torch.ops.packing import (
    EMPTY32,
    key_code,
    pack_box_keys,
    pack_brick_keys,
    pack_keys,
)


class FrameAux(NamedTuple):
    """Per-frame reductions that accompany the unique records (with a
    leading frame axis for a batch or a window)."""

    cmin: torch.Tensor        # (3,) min updated-voxel center (inf if none)
    cmax: torch.Tensor        # (3,) max updated-voxel center (-inf if none)
    range_fail: torch.Tensor  # () bool: a valid key fell outside the box
    n_valid: torch.Tensor     # () int64 valid candidate emissions


def frame_records(
    image: torch.Tensor,
    T_sonar_to_world: torch.Tensor,
    tables: FanTables,
    cfg: MapperConfig,
    box_min: Optional[torch.Tensor],
    box_bits: Optional[Tuple[int, int, int]],
    brick_bits: int,
    dtype: torch.dtype = torch.float32,
    raw: bool = False,
    frame_on: Optional[torch.Tensor] = None,
    unique_budget: Optional[int] = None,
    dedup_lane_budget: int = 0,
) -> Tuple[Union[CompactRecords, UniqueRecords], FrameAux]:
    """One ping -> (records, FrameAux); or a batch of F pings (``image``
    (F, R, Bw), ``T_sonar_to_world`` (F, 4, 4)) -> records and FrameAux
    with a leading (F,) axis, each frame bit-equal to its ping alone.

    With a box (``box_min``, ``box_bits``) the records are CompactRecords
    with box-relative keys, and a candidate outside the box reports through
    ``range_fail`` (the host gate ``compute_window_boxes`` makes that
    impossible for its boxes).  ``box_min`` is (3,), or (F, 1, 3) for a
    box per frame.  Without one (``box_min=None``) they are UniqueRecords
    with two-word keys: brick codes when ``brick_bits`` > 0, voxel codes
    (the hash backend's) when it is 0; a candidate outside the packable
    range reports through ``range_fail``.

    ``frame_on`` (a bool, () or (F,)) masks whole frames: an off frame
    emits no valid candidate.

    ``raw=True`` (box keys only) skips the per-frame dedup: every valid
    candidate is its own record with payload ``1 << 16 | occ``, in the
    lane the candidate lattice gave it (valid records are NOT a prefix),
    and ``n_unique`` is the valid count.  Only the raw window apply
    (``bin_apply_raw``, which sums records per slot) may consume them.

    ``unique_budget`` (unique records only) makes the records exactly
    that many lanes wide, with the dedup's compaction slice
    ``dedup_lane_budget`` (0: the dedup's default), as in the JAX package:
    a frame with more records, or more valid candidates than the slice,
    reports through ``n_unique`` (``overflowed``).  Without it the records
    keep the candidate lattice's width and never overflow.
    """
    if raw and box_min is None:
        raise ValueError("raw records need box keys")
    budget = dict(unique_budget=unique_budget, lane_budget=dedup_lane_budget)
    if box_min is None and not brick_bits:
        occ, (hi, lo), valid, aux = _packed_candidates(
            image, T_sonar_to_world, tables, cfg, dtype, frame_on, pack_keys)
        return dedup_frame(hi, lo, occ, valid, False, **budget), aux

    skey, aux = sort_words(image, T_sonar_to_world, tables, cfg, box_min,
                           box_bits, brick_bits, dtype, frame_on)
    if box_min is None:
        return dedup_code_words(skey, True, **budget), aux
    if not raw:
        return dedup_compact_words(skey, **budget), aux
    valid = skey != EMPTY32
    return CompactRecords(
        key=torch.where(valid, skey >> 1, EMPTY32),
        payload=torch.where(valid, (1 << 16) | (skey & 1), 0),
        n_unique=aux.n_valid,
        pack_fail=torch.zeros(valid.shape[:-1], dtype=torch.bool,
                              device=valid.device),
    ), aux


def _packed_candidates(image, T_sonar_to_world, tables, cfg, dtype,
                       frame_on, pack):
    """The candidates of ``frame_records``' ping or batch with their voxel
    keys packed by ``pack`` (int voxel keys -> (*words, in_range)):
    (occupied flags, words, valid (in-range, frame on) mask, FrameAux)."""
    cand = backproject_ping(image, T_sonar_to_world, tables, cfg, dtype=dtype)
    res = torch.full((), cfg.voxel_resolution, dtype=dtype,
                     device=image.device)
    # a true division, as in the reference's floor(p / res) keying
    keys = torch.floor(cand["points"] / res).to(torch.int32)
    *words, in_range = pack(keys)
    valid = cand["valid"]
    if frame_on is not None:
        on = torch.as_tensor(frame_on, device=image.device)
        valid = valid & on[..., None]
    range_fail = (valid & ~in_range).any(dim=-1)
    valid = valid & in_range
    return (cand["is_occupied"], words, valid,
            frame_aux(keys, valid, range_fail, res))


def sort_words_plain(
    image: torch.Tensor,
    T_sonar_to_world: torch.Tensor,
    tables: FanTables,
    cfg: MapperConfig,
    box_min: Optional[torch.Tensor],
    box_bits: Optional[Tuple[int, int, int]],
    brick_bits: int,
    dtype: torch.dtype,
    frame_on: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, FrameAux]:
    """A ping's (or a batch's) dedup sort words and FrameAux, by PyTorch
    ops: backprojection, floor keying, then with a box ``pack_box_keys``
    (``ops.dedup.compact_sort_words``), without one ``pack_brick_keys``
    (``ops.dedup.code_sort_words`` of the brick codes; ``brick_bits`` > 0).
    The plain version of the records kernel (kernels/box_words.py)."""
    if box_min is None:
        occ, (hi, lo), valid, aux = _packed_candidates(
            image, T_sonar_to_world, tables, cfg, dtype, frame_on,
            lambda keys: pack_brick_keys(keys, brick_bits))
        return code_sort_words(key_code(hi, lo, True), occ, valid), aux
    occ, (bkey,), valid, aux = _packed_candidates(
        image, T_sonar_to_world, tables, cfg, dtype, frame_on,
        lambda keys: pack_box_keys(keys, box_min, box_bits, brick_bits))
    return compact_sort_words(bkey, occ, valid), aux


def sort_words(
    image: torch.Tensor,
    T_sonar_to_world: torch.Tensor,
    tables: FanTables,
    cfg: MapperConfig,
    box_min: Optional[torch.Tensor],
    box_bits: Optional[Tuple[int, int, int]],
    brick_bits: int,
    dtype: torch.dtype,
    frame_on: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, FrameAux]:
    """``sort_words_plain``'s result, bit for bit: from the records kernel
    (``kernels.box_words``, float32 or float64) where the ping is on a
    CUDA device, else from the plain version."""
    if not image.is_cuda:
        return sort_words_plain(image, T_sonar_to_world, tables, cfg,
                                box_min, box_bits, brick_bits, dtype,
                                frame_on)
    batched = image.dim() == 3
    out = k_words.box_words(
        image if batched else image[None],
        T_sonar_to_world.reshape(-1, 4, 4), tables, cfg, box_min, box_bits,
        brick_bits, dtype, frame_on)
    skey, cmin, cmax, range_fail, n_valid = (
        out if batched else (x[0] for x in out))
    return skey, FrameAux(cmin, cmax, range_fail, n_valid)


def frame_records_batch(
    images: torch.Tensor,
    transforms: torch.Tensor,
    frame_on: torch.Tensor,
    tables: FanTables,
    cfg: MapperConfig,
    dtype: torch.dtype = torch.float32,
    unique_budget: Optional[int] = None,
) -> Tuple[UniqueRecords, FrameAux]:
    """Voxel-code records of F pings at once: ``images`` (F, R, Bw),
    ``transforms`` (F, 4, 4), ``frame_on`` (F,) bool window mask ->
    UniqueRecords and FrameAux, each with a leading (F,) axis.  The
    records are ``unique_budget`` lanes wide when it is given, as the JAX
    package's always are; without it every frame keeps its N lanes, valid
    records first."""
    return frame_records(images, transforms, tables, cfg, None, None, 0,
                         dtype=dtype, frame_on=frame_on,
                         unique_budget=unique_budget)


def frame_aux(
    keys: torch.Tensor,
    valid: torch.Tensor,
    range_fail: torch.Tensor,
    res: torch.Tensor,
) -> FrameAux:
    """A frame's FrameAux from its (N, 3) int32 voxel keys, the mask of its
    valid (in-range) emissions and the voxel size ``res``, a 0-d tensor of
    the map's dtype on the keys' device; reduced row by row for (F, N, 3)
    keys and (F, N) masks."""
    dtype, device = res.dtype, keys.device
    # bounds reduce over int keys: k -> (k + 0.5) * res is exact and
    # monotone, so min/max commute with it
    imax = torch.iinfo(torch.int32).max
    kmin = torch.where(valid[..., None], keys, imax).amin(dim=-2)
    kmax = torch.where(valid[..., None], keys, -imax).amax(dim=-2)
    n_valid = valid.sum(dim=-1)
    any_valid = (n_valid > 0)[..., None]
    inf = torch.full((), float("inf"), dtype=dtype, device=device)

    def center(k):
        return (k.to(dtype) + 0.5) * res

    return FrameAux(
        cmin=torch.where(any_valid, center(kmin), inf),
        cmax=torch.where(any_valid, center(kmax), -inf),
        range_fail=range_fail,
        n_valid=n_valid,
    )


def stack_frame_records(
    outs: List[Tuple[Union[CompactRecords, UniqueRecords], FrameAux]],
    cut: bool = True,
) -> Tuple[Union[CompactRecords, UniqueRecords], FrameAux]:
    """Per-frame or per-batch (records, FrameAux), in frame order, stacked
    along one leading frame axis.  With ``cut``, unique records (a prefix
    of their lanes) are cut to the widest frame's unique count (one sync a
    call); raw candidates sit wherever the candidate lattice put them, and
    budgeted records are as wide as their budget, so both are stacked
    uncut (no read)."""
    kind = type(outs[0][0])

    def rows(t, batched):
        # one frame's fields gain the frame axis a batch's already have
        return t if batched else type(t)(*(x[None] for x in t))

    recs = kind(*(torch.cat(x) for x in zip(
        *(rows(r, r.n_unique.dim() > 0) for r, _ in outs))))
    auxs = FrameAux(*(torch.cat(x) for x in zip(
        *(rows(a, a.n_valid.dim() > 0) for _, a in outs))))
    if not cut:
        return recs, auxs
    width = max(1, int(recs.n_unique.max()))
    return kind(*(x[:, :width] if x.dim() == 2 else x for x in recs)), auxs
