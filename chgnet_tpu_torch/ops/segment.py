"""Row gathers and segment sums over CSR plans, with autograd.

Five kernel wrappers, each beside its plain PyTorch version:

* :func:`segment_sum_csr` (``csrc/segment_sum.cu``) replaces
  ``chgnet_tpu/ops/stream_ops.py`` ``_segsum_kernel`` (``_segsum_pallas``
  :209): ``out[n] = sum of x rows offsets[n] .. offsets[n + 1]`` of the
  key-sorted stream.
* :func:`segment_sum_pair` (same source) replaces ``_segsum2_kernel``
  (``_segsum2_pallas`` :345): two such sums of one ``x`` by two key streams.
* :func:`gather_rows` (``csrc/gather_rows.cu``) replaces ``_gather_kernel``
  (``_gather_pallas`` :733): ``out[l] = src[idx[l]]``, zero where the index
  is out of range (how ``expand_rows`` zeroes dropped rows).
* :func:`segment_sum_tiles` (``csrc/segment_sum.cu``) replaces
  ``_segsum_v2_kernel`` (:1003, ``_segsum_v2_pallas`` :1033): the function
  of :func:`segment_sum_csr` with the input owned, not the output.
* :func:`gather_rows_window` (``csrc/gather_window.cu``) replaces
  ``_gather_v2_kernel`` (:1109, ``_gather_v2_pallas`` :1132): the gather
  over a per-block source window, a zero row outside it.

The last two run under ``CHGNET_TPU_STREAM_V2``
(:func:`~chgnet_tpu_torch.graph.batching.stream_v2_enabled`, read at call
time; the window plans are built only when it is also set while the batch is
built): :func:`plan_segment_sum` takes the tile kernel for rows narrower
than 128 floats (``_segsum_impl`` :461) and :func:`plan_gather` the window
kernel when the plan carries windows that fit at this width
(``_gather_fwd_impl``, ``scatter.py:195``, and ``expand_rows`` :572).
``segment_sum_pair`` keeps its kernel, as ``_segsum2`` does in ``chgnet_tpu``.

A wrapper launches its kernel on a CUDA tensor (or raises) and uses the
plain version only for a tensor on the CPU. Each keeps a count of its
launches in its ``launches`` attribute, and those with bf16 arguments in
``launches_bf16``. Each also takes bf16 rows (``compute_dtype="bfloat16"``,
its ``_bf16`` C entry point): the sums widen them to f32, add in f32 (the
tile sum's carries too) and round once at the store, and the gathers copy
their bits.

The autograd functions pair the ops as ``stream_ops.py:546-603`` does: the
backward of a planned gather is a segment sum over the plan, and the
backward of a segment sum is a gather of the cotangent by the plan's
row-aligned keys. Each backward calls the other's ``apply``, so every order
of derivative stays on these kernels.
"""

from __future__ import annotations

import ctypes

import torch

from chgnet_tpu_torch.graph.batching import (
    WINDOW_BLOCK,
    SegmentPlan,
    stream_v2_enabled,
)
from chgnet_tpu_torch.ops import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_SIGNATURES = {
    "segment_sum": {
        "segment_sum_csr_f32": [_P, _P, _P, _P, _I, _I, _P],
        "segment_sum_csr_bf16": [_P, _P, _P, _P, _I, _I, _P],
        "segment_sum_pair_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "segment_sum_pair_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "segment_sum_tiles_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "segment_sum_tiles_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "gather_rows": {
        "gather_rows_f32": [_P, _P, _P, _L, _I, _I, _P],
        "gather_rows_bf16": [_P, _P, _P, _L, _I, _I, _P],
    },
    "gather_window": {
        "gather_rows_window_f32": [_P, _P, _P, _P, _L, _I, _I, _P],
        "gather_rows_window_bf16": [_P, _P, _P, _P, _L, _I, _I, _P],
    },
}
# widest row of the segment sums, the first-layer cotangent of a 128-wide
# model (K = 2 x 128): 64 units of 4 floats (64 floats where the row is not
# aligned to 4 elements), summed by a warp in chunks of 32 units
SEGMENT_MAX_D = 256
# blocks of segment_sum_tiles: one per TILES_MIN_ITEMS rows and segments of
# the stream's capacity, at most TILES_MAX_BLOCKS (four an SM of an H100's
# 132, as many as its shared memory holds at once)
TILES_MIN_ITEMS = 256
TILES_MAX_BLOCKS = 528


def _lib(name: str) -> ctypes.CDLL:
    return build.load(name, _SIGNATURES[name])


# --------------------------------------------------------------- plain
def segment_sum_plain(
    x: torch.Tensor, offsets: torch.Tensor, perm: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`segment_sum_csr`: each segment as the
    difference of two float64 prefix sums of the key-sorted rows, rounded
    once to ``x``'s type."""
    xs = x[perm.long()] if perm.numel() else x
    off = offsets.long()
    n_valid = int(off[-1])
    prefix = torch.zeros(
        (n_valid + 1, x.shape[1]), dtype=torch.float64, device=x.device
    )
    prefix[1:] = torch.cumsum(xs[:n_valid].double(), dim=0)
    return (prefix[off[1:]] - prefix[off[:-1]]).to(x.dtype)


def segment_sum_pair_plain(x, offsets_a, perm_a, offsets_b, perm_b):
    """Plain version of :func:`segment_sum_pair`."""
    return (
        segment_sum_plain(x, offsets_a, perm_a),
        segment_sum_plain(x, offsets_b, perm_b),
    )


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_rows`."""
    n_src = src.shape[0]
    ok = (idx >= 0) & (idx < n_src)
    rows = src[idx.clamp(0, max(n_src - 1, 0)).long()]
    return torch.where(ok[:, None], rows, rows.new_zeros(()))


def gather_rows_window_plain(
    src: torch.Tensor, idx: torch.Tensor, window: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`gather_rows_window`: ``src[idx]`` with the
    rows whose index lies outside their block's window zeroed."""
    block = torch.arange(idx.shape[0], device=idx.device) // WINDOW_BLOCK
    lo, hi = window[block, 0], window[block, 1]
    ok = (idx >= lo) & (idx <= hi) & (idx >= 0) & (idx < src.shape[0])
    rows = src[idx.clamp(0, max(src.shape[0] - 1, 0)).long()]
    return torch.where(ok[:, None], rows, rows.new_zeros(()))


# ------------------------------------------------------------ wrappers
def _check_width(what: str, x: torch.Tensor) -> None:
    """Raise for rows wider than the segment-sum kernels take: 64 units of
    4 elements (of one where the row is not aligned to 4 elements)."""
    d = x.shape[1]
    aligned = x.data_ptr() % (4 * x.element_size()) == 0
    units = d // 4 if d % 4 == 0 and aligned else d
    if units > SEGMENT_MAX_D // 4:
        raise ValueError(
            f"{what}: rows of at most {SEGMENT_MAX_D} aligned or "
            f"{SEGMENT_MAX_D // 4} unaligned floats (d={d})"
        )


def segment_sum_csr(
    x: torch.Tensor, offsets: torch.Tensor, perm: torch.Tensor
) -> torch.Tensor:
    """Segment sums ``[n_out, d]`` of ``x [L, d]`` over CSR ``offsets
    [n_out + 1]`` of the key-sorted stream; ``perm [L]`` (or empty when the
    stream is sorted) maps sorted positions to rows of ``x``."""
    if not build.on_cuda(x, "segment_sum_csr"):
        return segment_sum_plain(x, offsets, perm)
    kind = build.check_tensors(
        "segment_sum_csr", (x,), (offsets, perm)
    )
    _check_width("segment_sum_csr", x)
    n_out = offsets.shape[0] - 1
    out = torch.empty((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    ptr = build.ptr
    err = getattr(_lib("segment_sum"), f"segment_sum_csr_{kind}")(
        ptr(x), ptr(perm), ptr(offsets), ptr(out), n_out, x.shape[1],
        build.stream(),
    )
    build.check(err, "segment_sum_csr")
    segment_sum_csr.launches += 1
    segment_sum_csr.launches_bf16 += kind == "bf16"
    return out


segment_sum_csr.launches = segment_sum_csr.launches_bf16 = 0


def tiles_blocks(n_rows: int, n_out: int) -> int:
    """Blocks that share a :func:`segment_sum_tiles` call over ``n_rows``
    rows and ``n_out`` segments. Each takes an equal part of the merge path
    of the valid sorted rows and the segment ends (``csrc/segment_sum.cu``
    ``path_segment``), so the block boundaries, and with them the add
    order, follow from the plan and these two sizes alone."""
    return max(1, min(-(-(n_rows + n_out) // TILES_MIN_ITEMS), TILES_MAX_BLOCKS))


def segment_sum_tiles(
    x: torch.Tensor, offsets: torch.Tensor, perm: torch.Tensor
) -> torch.Tensor:
    """:func:`segment_sum_csr`'s function, input-stationary: each of
    :func:`tiles_blocks` blocks takes an equal part of the sorted rows and
    segment ends, stages its rows in shared memory ahead of the adds and
    writes every segment that lies inside its part; the two segments cut by
    its part's ends go through f32 carries that a second kernel adds in
    block order. It adds in another order than :func:`segment_sum_csr`, so
    the two agree to rounding. The TPU dispatch's raw-mode capacity clause
    (``_segsum_impl`` :462-473) has no counterpart: the port has CSR plans
    and no block-local raw plans. The carries are f32 for bf16 rows too."""
    if not build.on_cuda(x, "segment_sum_tiles"):
        return segment_sum_plain(x, offsets, perm)
    kind = build.check_tensors("segment_sum_tiles", (x,), (offsets, perm))
    _check_width("segment_sum_tiles", x)
    n_rows, d = x.shape
    n_out = offsets.shape[0] - 1
    out = torch.empty((n_out, d), dtype=x.dtype, device=x.device)
    blocks = tiles_blocks(n_rows, n_out)
    # two carry rows a block, then the segment of each block's first carry
    carry = torch.empty(blocks * (2 * d + 1), dtype=torch.float32, device=x.device)
    ptr = build.ptr
    err = getattr(_lib("segment_sum"), f"segment_sum_tiles_{kind}")(
        ptr(x), ptr(perm), ptr(offsets), ptr(out), ptr(carry), n_rows, n_out,
        d, blocks, build.stream(),
    )
    build.check(err, "segment_sum_tiles")
    segment_sum_tiles.launches += 1
    segment_sum_tiles.launches_bf16 += kind == "bf16"
    return out


segment_sum_tiles.launches = segment_sum_tiles.launches_bf16 = 0


def segment_sum_pair(x, offsets_a, perm_a, offsets_b, perm_b):
    """Two segment sums of one ``x`` by two key streams with the same
    ``n_out`` (see :func:`segment_sum_csr`), in one launch and one sweep of
    ``x``: a warp sums both streams' segments of an output row side by
    side, each in :func:`segment_sum_csr`'s order."""
    if not build.on_cuda(x, "segment_sum_pair"):
        return segment_sum_pair_plain(x, offsets_a, perm_a, offsets_b, perm_b)
    kind = build.check_tensors(
        "segment_sum_pair", (x,), (offsets_a, perm_a, offsets_b, perm_b)
    )
    _check_width("segment_sum_pair", x)
    n_out = offsets_a.shape[0] - 1
    if offsets_b.shape[0] - 1 != n_out:
        raise ValueError("segment_sum_pair: key streams differ in n_out")
    out_a = torch.empty((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    out_b = torch.empty_like(out_a)
    ptr = build.ptr
    err = getattr(_lib("segment_sum"), f"segment_sum_pair_{kind}")(
        ptr(x), ptr(perm_a), ptr(offsets_a), ptr(out_a), ptr(perm_b),
        ptr(offsets_b), ptr(out_b), x.shape[0], n_out, x.shape[1],
        build.stream(),
    )
    build.check(err, "segment_sum_pair")
    segment_sum_pair.launches += 1
    segment_sum_pair.launches_bf16 += kind == "bf16"
    return out_a, out_b


segment_sum_pair.launches = segment_sum_pair.launches_bf16 = 0


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[l] = src[idx[l]]``, a zero row where ``idx[l]`` is outside
    ``[0, src.shape[0])``."""
    if not build.on_cuda(src, "gather_rows"):
        return gather_rows_plain(src, idx)
    kind = build.check_tensors(
        "gather_rows", (src,), (idx,)
    )
    out = torch.empty(
        (idx.shape[0], src.shape[1]), dtype=src.dtype, device=src.device
    )
    ptr = build.ptr
    err = getattr(_lib("gather_rows"), f"gather_rows_{kind}")(
        ptr(src), ptr(idx), ptr(out), idx.shape[0], src.shape[0],
        src.shape[1], build.stream(),
    )
    build.check(err, "gather_rows")
    gather_rows.launches += 1
    gather_rows.launches_bf16 += kind == "bf16"
    return out


gather_rows.launches = gather_rows.launches_bf16 = 0


def window_fits(src: torch.Tensor) -> bool:
    """Whether :func:`gather_rows_window` takes rows of ``src``'s width:
    16-byte units (rows of 4k f32 or 8k bf16 values on 16-byte aligned
    storage)."""
    return (src.shape[1] * src.element_size()) % 16 == 0 and src.data_ptr() % 16 == 0


def gather_rows_window(
    src: torch.Tensor, idx: torch.Tensor, window: torch.Tensor
) -> torch.Tensor:
    """``out[l] = src[idx[l]]`` where ``window[l // WINDOW_BLOCK]`` = (first,
    last) source row of the block holds ``idx[l]``, a zero row elsewhere
    (:func:`~chgnet_tpu_torch.graph.batching.build_window_plan`)."""
    n_rows = idx.shape[0]
    if window.shape != (-(-n_rows // WINDOW_BLOCK), 2):
        raise ValueError(
            f"gather_rows_window: window {tuple(window.shape)} for {n_rows} rows"
        )
    if not build.on_cuda(src, "gather_rows_window"):
        return gather_rows_window_plain(src, idx, window)
    kind = build.check_tensors("gather_rows_window", (src,), (idx, window))
    if not window_fits(src):
        raise ValueError(
            "gather_rows_window: 16-byte aligned rows of 4k floats or 8k "
            f"bf16 values expected (d={src.shape[1]}, {src.dtype})"
        )
    out = torch.empty((n_rows, src.shape[1]), dtype=src.dtype, device=src.device)
    ptr = build.ptr
    err = getattr(_lib("gather_window"), f"gather_rows_window_{kind}")(
        ptr(src), ptr(idx), ptr(window), ptr(out), n_rows, src.shape[0],
        src.shape[1], build.stream(),
    )
    build.check(err, "gather_rows_window")
    gather_rows_window.launches += 1
    gather_rows_window.launches_bf16 += kind == "bf16"
    return out


gather_rows_window.launches = gather_rows_window.launches_bf16 = 0


# ------------------------------------------------------------ autograd
class _Gather(torch.autograd.Function):
    """``src[idx]`` whose backward is the segment sum over ``plan``. Under
    the stream-v2 switch a plan with windows that fit sends it through the
    window kernel: ``idx`` equals ``plan.key`` on every valid row, and a
    padded row outside its block's window comes out zero (every consumer
    masks padded rows, as in ``chgnet_tpu``)."""

    @staticmethod
    def forward(ctx, src, idx, plan):
        ctx.plan = plan
        src = src.contiguous()
        if stream_v2_enabled() and plan.window.shape[0] and window_fits(src):
            return gather_rows_window(src, idx, plan.window)
        return gather_rows(src, idx)

    @staticmethod
    def backward(ctx, ct):
        return _SegmentSum.apply(ct, ctx.plan), None, None


class _SegmentSum(torch.autograd.Function):
    """Segment sum over ``plan`` whose backward gathers the cotangent by the
    plan's row-aligned keys (dropped rows get zero)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        v2 = stream_v2_enabled() and x.shape[1] < 128
        kernel = segment_sum_tiles if v2 else segment_sum_csr
        return kernel(x.contiguous(), plan.offsets, plan.perm)

    @staticmethod
    def backward(ctx, ct):
        return _Gather.apply(ct, ctx.plan.key, ctx.plan), None


class _SegmentSumPair(torch.autograd.Function):
    """Two segment sums of one stream; backward adds the two expansions."""

    @staticmethod
    def forward(ctx, x, plan_a, plan_b):
        ctx.plans = (plan_a, plan_b)
        return segment_sum_pair(
            x.contiguous(), plan_a.offsets, plan_a.perm, plan_b.offsets,
            plan_b.perm,
        )

    @staticmethod
    def backward(ctx, ct_a, ct_b):
        pa, pb = ctx.plans
        d_x = _Gather.apply(ct_a, pa.key, pa) + _Gather.apply(ct_b, pb.key, pb)
        return d_x, None, None


def plan_gather(
    table: torch.Tensor, idx: torch.Tensor, plan: SegmentPlan
) -> torch.Tensor:
    """``table[idx]``; the backward sums the cotangent into ``table``'s rows
    over ``plan`` (whose keys are ``idx`` with padded rows dropped)."""
    if plan.offsets.shape[0] - 1 != table.shape[0]:
        raise ValueError(
            f"plan over {plan.offsets.shape[0] - 1} rows for a table of "
            f"{table.shape[0]}"
        )
    return _Gather.apply(table, idx, plan)


def plan_segment_sum(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Sum of ``x``'s rows per segment of ``plan`` -> ``[plan.n_out, d]``."""
    return _SegmentSum.apply(x, plan)


def plan_segment_sum_pair(
    x: torch.Tensor, plan_a: SegmentPlan, plan_b: SegmentPlan
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`plan_segment_sum` by two plans of one ``n_out`` in one sweep."""
    return _SegmentSumPair.apply(x, plan_a, plan_b)
