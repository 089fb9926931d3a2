"""Row gathers and segment sums over CSR plans, with autograd.

Three kernel wrappers, each beside its plain PyTorch version:

* :func:`segment_sum_csr` (``csrc/segment_sum.cu``) replaces
  ``chgnet_tpu/ops/stream_ops.py`` ``_segsum_kernel`` (``_segsum_pallas``
  :209): ``out[n] = sum of x rows offsets[n] .. offsets[n + 1]`` of the
  key-sorted stream.
* :func:`segment_sum_pair` (same source) replaces ``_segsum2_kernel``
  (``_segsum2_pallas`` :345): two such sums of one ``x`` by two key streams.
* :func:`gather_rows` (``csrc/gather_rows.cu``) replaces ``_gather_kernel``
  (``_gather_pallas`` :733): ``out[l] = src[idx[l]]``, zero where the index
  is out of range (how ``expand_rows`` zeroes dropped rows).

A wrapper launches its kernel on a CUDA tensor (or raises) and uses the
plain version only for a tensor on the CPU. Each keeps a count of its
launches in its ``launches`` attribute.

The autograd functions pair the ops as ``stream_ops.py:546-603`` does: the
backward of a planned gather is a segment sum over the plan, and the
backward of a segment sum is a gather of the cotangent by the plan's
row-aligned keys. Each backward calls the other's ``apply``, so every order
of derivative stays on these kernels.
"""

from __future__ import annotations

import ctypes

import torch

from chgnet_tpu_torch.graph.batching import SegmentPlan
from chgnet_tpu_torch.ops import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_SIGNATURES = {
    "segment_sum": {
        "segment_sum_csr_f32": [_P, _P, _P, _P, _I, _I, _P],
        "segment_sum_pair_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    },
    "gather_rows": {"gather_rows_f32": [_P, _P, _P, _L, _I, _I, _P]},
}


def _lib(name: str) -> ctypes.CDLL:
    return build.load(name, _SIGNATURES[name])


# --------------------------------------------------------------- plain
def segment_sum_plain(
    x: torch.Tensor, offsets: torch.Tensor, perm: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`segment_sum_csr`: each segment as the
    difference of two float64 prefix sums of the key-sorted rows."""
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


# ------------------------------------------------------------ wrappers
def _check_width(what: str, x: torch.Tensor) -> None:
    """Raise for rows wider than the segment-sum kernel takes: one warp's
    32 lanes each hold a float4 of the row (a float where the row is not
    16-byte aligned)."""
    d = x.shape[1]
    units = d // 4 if d % 4 == 0 and x.data_ptr() % 16 == 0 else d
    if units > 32:
        raise ValueError(
            f"{what}: rows of at most 128 aligned or 32 unaligned floats "
            f"(d={d})"
        )


def segment_sum_csr(
    x: torch.Tensor, offsets: torch.Tensor, perm: torch.Tensor
) -> torch.Tensor:
    """Segment sums ``[n_out, d]`` of ``x [L, d]`` over CSR ``offsets
    [n_out + 1]`` of the key-sorted stream; ``perm [L]`` (or empty when the
    stream is sorted) maps sorted positions to rows of ``x``."""
    if not build.on_cuda(x, "segment_sum_csr"):
        return segment_sum_plain(x, offsets, perm)
    build.check_tensors("segment_sum_csr", (x,), (offsets, perm))
    _check_width("segment_sum_csr", x)
    n_out = offsets.shape[0] - 1
    out = torch.empty((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    ptr = build.ptr
    err = _lib("segment_sum").segment_sum_csr_f32(
        ptr(x), ptr(perm), ptr(offsets), ptr(out), n_out, x.shape[1],
        build.stream(),
    )
    build.check(err, "segment_sum_csr")
    segment_sum_csr.launches += 1
    return out


segment_sum_csr.launches = 0


def segment_sum_pair(x, offsets_a, perm_a, offsets_b, perm_b):
    """Two segment sums of one ``x`` by two key streams with the same
    ``n_out`` (see :func:`segment_sum_csr`), in one launch."""
    if not build.on_cuda(x, "segment_sum_pair"):
        return segment_sum_pair_plain(x, offsets_a, perm_a, offsets_b, perm_b)
    build.check_tensors(
        "segment_sum_pair", (x,), (offsets_a, perm_a, offsets_b, perm_b)
    )
    _check_width("segment_sum_pair", x)
    n_out = offsets_a.shape[0] - 1
    if offsets_b.shape[0] - 1 != n_out:
        raise ValueError("segment_sum_pair: key streams differ in n_out")
    out_a = torch.empty((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    out_b = torch.empty_like(out_a)
    ptr = build.ptr
    err = _lib("segment_sum").segment_sum_pair_f32(
        ptr(x), ptr(perm_a), ptr(offsets_a), ptr(out_a), ptr(perm_b),
        ptr(offsets_b), ptr(out_b), n_out, x.shape[1], build.stream(),
    )
    build.check(err, "segment_sum_pair")
    segment_sum_pair.launches += 1
    return out_a, out_b


segment_sum_pair.launches = 0


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[l] = src[idx[l]]``, a zero row where ``idx[l]`` is outside
    ``[0, src.shape[0])``."""
    if not build.on_cuda(src, "gather_rows"):
        return gather_rows_plain(src, idx)
    build.check_tensors("gather_rows", (src,), (idx,))
    out = torch.empty(
        (idx.shape[0], src.shape[1]), dtype=src.dtype, device=src.device
    )
    ptr = build.ptr
    err = _lib("gather_rows").gather_rows_f32(
        ptr(src), ptr(idx), ptr(out), idx.shape[0], src.shape[0],
        src.shape[1], build.stream(),
    )
    build.check(err, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


# ------------------------------------------------------------ autograd
class _Gather(torch.autograd.Function):
    """``src[idx]`` whose backward is the segment sum over ``plan``."""

    @staticmethod
    def forward(ctx, src, idx, plan):
        ctx.plan = plan
        return gather_rows(src.contiguous(), idx)

    @staticmethod
    def backward(ctx, ct):
        return _SegmentSum.apply(ct, ctx.plan), None, None


class _SegmentSum(torch.autograd.Function):
    """Segment sum over ``plan`` whose backward gathers the cotangent by the
    plan's row-aligned keys (dropped rows get zero)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return segment_sum_csr(x.contiguous(), plan.offsets, plan.perm)

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
