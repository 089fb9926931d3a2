"""Fused gated-MLP tails of the conv layers, forward and backward.

    y   = silu(acc) @ blockdiag(W2c, W2g) + b2          acc [L, 2D]
    msg = silu(LN(y[:, :D])) * sigmoid(LN(y[:, D:])) * weights * mask
    upd = silu(LN(y[:, :D])) * sigmoid(LN(y[:, D:])) + resnet

Four kernel wrappers (``csrc/gated_message.cu``), each beside its plain
PyTorch version, replace the four Pallas functions of
``chgnet_tpu/ops/gated_message.py``:

* :func:`gated_message_fwd` replaces ``_kernel`` (:55, ``_forward`` :76),
  the message tail of AtomConv and BondConv;
* :func:`gated_message_bwd` replaces ``_bwd_kernel`` (:190, ``_backward``
  :231; math ``_bwd_math`` :150);
* :func:`gated_update_fwd` replaces ``_kernel_nw`` (:620, ``_forward_nw``
  :642), the AngleUpdate tail: ``y = acc`` for single-Linear branches (the
  default), else ``y`` as above;
* :func:`gated_update_bwd` replaces ``_bwd_kernel_nw`` (:734,
  ``_backward_nw`` :777; math ``_bwd_math_nw`` :690).

A fifth, :func:`gated_message_reduce`, replaces ``_reduce_kernel`` (:378,
``_reduce_pallas`` :426): the message tail and the sorted segment sum of its
rows in one sweep, so that the ``[L, D]`` message stream never reaches
device memory. The mask multiplies inside the sum: a masked row whose key
stays in range adds exactly zero (the simulation loops' dynamic-cutoff
masks zero such rows). It runs where ``chgnet_tpu`` runs it, when the
environment variable ``CHGNET_TPU_MSG_REDUCE`` is set
(:func:`msg_reduce_ok`).

A tail's parameters travel as a tuple, ``(w2c, w2g, b2, nc_scale, nc_bias,
ng_scale, ng_bias)`` or, without a second layer, the last four
(:func:`tail_params`). The backward wrappers compute ``d_mask`` and the
parameter gradients only when asked; serving asks for neither.

bf16 tails (``compute_dtype="bfloat16"``): every kernel takes bf16 ``acc``,
weights, mask, cotangent and parameters (its ``_bf16`` C entry point),
computes in f32 (the products at f32 accuracy: ``silu(acc)`` and ``d_y``
are f32 values, and a bf16 W2 needs two of 3xTF32's three passes; the
message forward and the serving backward split the f32 value into a bf16
hi and lo and take two passes on the bf16 tensor cores) and
rounds each output once, as ``chgnet_tpu``'s kernels do ("streams may be
bf16 -- in-kernel math runs in f32",
``chgnet_tpu/ops/gated_message.py:588-590``): the message-reduce sums each
segment in f32, and the backward with parameter gradients (training) sums
its per-block partials in f32 and rounds each parameter gradient once to
bf16. Their plain versions widen to f32, compute and round once
(:func:`~chgnet_tpu_torch.ops.build.plain_in_f32`).

The autograd functions mirror ``chgnet_tpu``'s ``custom_vjp``: a tail's
backward is the backward-kernel op, and that op's own backward (second
order, for force training) differentiates the plain composition, as
``_fused_grads_bwd`` (:346) and ``_fused_nw_grads_bwd`` (:882) do. The
update's ``d_resnet`` is the cotangent itself (:864-868). The reduce op's
backward (``_msg_reduce_bwd`` :509) gathers the cotangent back to the rows
by the plan's keys, dropped rows zero, and hands it to the message tail's
backward-kernel op.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from chgnet_tpu_torch.graph.batching import SegmentPlan
from chgnet_tpu_torch.ops import build
from chgnet_tpu_torch.ops.segment import plan_gather, segment_sum_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gated_fwd_f32": [_I, ctypes.POINTER(_P), _P, _P, _P, _P, _P, _I, _I, _P],
    "gated_fwd_bf16": [_I, ctypes.POINTER(_P), _P, _P, _P, _P, _P, _I, _I, _P],
    "gated_bwd_f32": [
        _I, ctypes.POINTER(_P), _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
        _I, _P,
    ],
    "gated_bwd_bf16": [
        _I, ctypes.POINTER(_P), _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
        _I, _P,
    ],
    "gated_reduce_f32": [ctypes.POINTER(_P), _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "gated_reduce_bf16": [ctypes.POINTER(_P), _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "gated_tc_occupancy": [ctypes.POINTER(_I)],
}
# widest tail the kernels take (wide_tail.cuh kD): 2D <= 256; up to 64 the
# kernels of gated_message.cu, past it those of wide_tail.cuh
TAIL_MAX_D = 128
TILE = 32  # rows per tile of the update forward with W2
# blocks of the backward with parameter gradients (kParamBlocks), at most
# one per TILE rows: the rows of its scratch buffer (each block takes an
# even share of the kernels' 16-row tiles, in order)
PARAM_BLOCKS = 256
W2_KEYS = ("w2c", "w2g", "b2")
LN_KEYS = ("nc_scale", "nc_bias", "ng_scale", "ng_bias")


def tail_params(p2: dict) -> tuple:
    """The tail's parameters of a ``gated_mlp_fused_pack`` dict, in the
    kernels' order."""
    keys = (W2_KEYS if "w2c" in p2 else ()) + LN_KEYS
    return tuple(p2[k].contiguous() for k in keys)


# ------------------------------------------------------------------ plain
def _ln_parts(x: torch.Tensor, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (x - mean) * inv, inv


def _ln_bwd(g_out, z, inv, scale):
    """d x of ``out = z * scale + bias`` with ``z = (x - mean) * inv``."""
    gz = g_out * scale
    return (
        gz - gz.mean(dim=-1, keepdim=True)
        - z * (gz * z).mean(dim=-1, keepdim=True)
    ) * inv


def _silu_grad(x: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _project(acc, w2c, w2g, b2):
    """``(y, h)``: ``y = h @ blockdiag(w2c, w2g) + b2`` with ``h = silu(acc)``,
    by the two diagonal blocks."""
    d = w2c.shape[0]
    h = F.silu(acc)
    return torch.cat([h[:, :d] @ w2c, h[:, d:] @ w2g], dim=1) + b2, h


def _back_project(d_y, w2c, w2g):
    d = w2c.shape[0]
    return torch.cat([d_y[:, :d] @ w2c.T, d_y[:, d:] @ w2g.T], dim=1)


def _gate(y, nc_scale, nc_bias, ng_scale, ng_bias):
    d = nc_scale.shape[0]
    zc, _ = _ln_parts(y[:, :d])
    zg, _ = _ln_parts(y[:, d:])
    return F.silu(zc * nc_scale + nc_bias) * torch.sigmoid(zg * ng_scale + ng_bias)


def _gate_bwd(y, ln, m):
    """The gate's backward for the upstream factor ``m`` of every element
    (``g * weights * mask`` in the message, ``g`` in the update):
    ``(d_y, silu_cn * sig_gn, layer-norm parameter gradients)``."""
    nc_scale, nc_bias, ng_scale, ng_bias = ln
    d = nc_scale.shape[0]
    zc, invc = _ln_parts(y[:, :d])
    zg, invg = _ln_parts(y[:, d:])
    cn = zc * nc_scale + nc_bias
    gn = zg * ng_scale + ng_bias
    silu_cn = F.silu(cn)
    sig_gn = torch.sigmoid(gn)
    d_cn = m * sig_gn * _silu_grad(cn)
    d_gn = m * silu_cn * sig_gn * (1.0 - sig_gn)
    d_y = torch.cat(
        [_ln_bwd(d_cn, zc, invc, nc_scale), _ln_bwd(d_gn, zg, invg, ng_scale)],
        dim=1,
    )
    ln_grads = (
        (d_cn * zc).sum(0), d_cn.sum(0), (d_gn * zg).sum(0), d_gn.sum(0)
    )
    return d_y, silu_cn * sig_gn, ln_grads


def _w2_grads(h, d_y, d):
    return (h[:, :d].T @ d_y[:, :d], h[:, d:].T @ d_y[:, d:], d_y.sum(0))


@build.plain_in_f32
def gated_message_plain(acc, weights, mask, params):
    """Plain version of :func:`gated_message_fwd` (``_reference`` :120)."""
    w2c, w2g, b2, *ln = params
    y, _ = _project(acc, w2c, w2g, b2)
    return _gate(y, *ln) * weights * mask[:, None]


@build.plain_in_f32
def gated_message_reduce_plain(acc, weights, mask, params, offsets):
    """Plain version of :func:`gated_message_reduce` (``_reduce_reference``
    :483): the message tail, then the segment sum of its sorted rows."""
    msg = gated_message_plain(acc, weights, mask, params)
    return segment_sum_plain(msg, offsets, offsets.new_zeros(0))


@build.plain_in_f32
def gated_message_bwd_plain(acc, weights, mask, params, g, need_mask, need_params):
    """Plain version of :func:`gated_message_bwd` (``_bwd_math`` :150)."""
    w2c, w2g, b2, *ln = params
    d = w2c.shape[0]
    y, h = _project(acc, w2c, w2g, b2)
    mask_col = mask[:, None]
    d_y, gate, ln_grads = _gate_bwd(y, ln, g * weights * mask_col)
    d_weights = g * gate * mask_col
    d_mask = (g * (gate * weights)).sum(-1) if need_mask else None
    d_acc = _back_project(d_y, w2c, w2g) * _silu_grad(acc)
    d_params = _w2_grads(h, d_y, d) + ln_grads if need_params else None
    return d_acc, d_weights, d_mask, d_params


def _update_gate(acc, params):
    y = _project(acc, *params[:3])[0] if len(params) == 7 else acc
    return _gate(y, *params[-4:])


@build.plain_in_f32
def gated_update_plain(acc, resnet, params):
    """Plain version of :func:`gated_update_fwd` (``_reference_nw`` :685)."""
    return _update_gate(acc, params) + resnet


@build.plain_in_f32
def gated_update_bwd_plain(acc, params, g, need_params):
    """Plain version of :func:`gated_update_bwd` (``_bwd_math_nw`` :690)."""
    if len(params) == 7:
        w2c, w2g, b2 = params[:3]
        y, h = _project(acc, w2c, w2g, b2)
    else:
        y = acc
    d_y, _, ln_grads = _gate_bwd(y, params[-4:], g)
    if len(params) == 4:
        return d_y, ln_grads if need_params else None
    d_acc = _back_project(d_y, w2c, w2g) * _silu_grad(acc)
    d_params = _w2_grads(h, d_y, w2c.shape[0]) + ln_grads if need_params else None
    return d_acc, d_params


# --------------------------------------------------------------- wrappers
def _lib() -> ctypes.CDLL:
    return build.load("gated_message", _SIGNATURES)


def _check_shapes(what, acc_shape, rows, vecs, params, msg):
    """Raise on shapes the tail kernels do not take, for an accumulator of
    ``acc_shape``; returns ``(n_rows, D)``."""
    widest = 2 * TAIL_MAX_D
    if len(acc_shape) != 2 or acc_shape[1] % 8 or not 8 <= acc_shape[1] <= widest:
        raise ValueError(
            f"{what}: acc [L, 2D] with D % 4 == 0 and 2D <= {widest} expected, "
            f"got {tuple(acc_shape)}"
        )
    n_rows, d = acc_shape[0], acc_shape[1] // 2
    if len(params) != 7 and (msg or len(params) != 4):
        raise ValueError(f"{what}: {len(params)} tail parameters")
    want = ((d, d), (d, d), (2 * d,)) if len(params) == 7 else ()
    want += ((d,),) * 4
    if tuple(tuple(p.shape) for p in params) != want:
        raise ValueError(f"{what}: tail parameters of the wrong shapes")
    if any(r.shape != (n_rows, d) for r in rows) or any(
        v.shape != (n_rows,) for v in vecs
    ):
        raise ValueError(f"{what}: rows of acc and the other streams differ")
    return n_rows, d


def _check(what, acc, rows, vecs, params, msg, ints=()):
    """Raise on what the kernels do not take; returns ``(n_rows, D, the C
    entry points' storage suffix)``."""
    n_rows, d = _check_shapes(what, tuple(acc.shape), rows, vecs, params, msg)
    kind = build.check_tensors(
        what, (acc, *rows, *vecs, *params), ints, aligned=(acc,)
    )
    return n_rows, d, kind


def tc_occupancy() -> dict[str, tuple[int, int, int]]:
    """``(shared memory bytes, warps a block, blocks of one wave)`` on the
    current card of the tensor-core tails, by kernel name; nothing is
    launched."""
    names = ("tail_fwd_tc_kernel", "tail_reduce_tc_kernel",
             "tail_bwd_tc_kernel<true, true>", "tail_bwd_bf16_kernel<true, true>",
             "tail_bwd_bf16_kernel<false, true>", "tail_bwd_bf16_kernel<false, false>",
             "tail_fwd_bf16_kernel", "tail_bwd_param_tc_kernel<true, true>",
             "tail_bwd_param_tc_kernel<false, false>",
             "tail_bwd_param_bf16_kernel<true, true>",
             "tail_bwd_param_bf16_kernel<false, false>")
    info = (_I * (3 * len(names)))()
    build.check(_lib().gated_tc_occupancy(info), "gated_tc_occupancy")
    return {name: tuple(info[3 * i: 3 * i + 3]) for i, name in enumerate(names)}


def _ptrs(*tensors):
    """Device addresses for a C entry point, null for ``None``."""
    return [None if t is None else build.ptr(t) for t in tensors]


def _tail_ptrs(params):
    """The 7 tail pointers of the C entry points, null for an absent w2."""
    full = (None,) * 3 + tuple(params) if len(params) == 4 else tuple(params)
    return (_P * 7)(*_ptrs(*full))


def _split_params(flat, d, n_params):
    sizes = ([d * d, d * d, 2 * d] if n_params == 7 else []) + [d] * 4
    parts = list(torch.split(flat, sizes))
    if n_params == 7:
        parts[0], parts[1] = parts[0].view(d, d), parts[1].view(d, d)
    return tuple(parts)


def _forward(what, acc, weights, mask, resnet, params):
    """Launch the forward kernel: the message tail with ``weights``, else
    the update tail."""
    msg = weights is not None
    rows = (weights,) if msg else (resnet,)
    n_rows, d, kind = _check(what, acc, rows, (mask,) if msg else (), params, msg)
    out = acc.new_empty((n_rows, d))
    err = getattr(_lib(), f"gated_fwd_{kind}")(
        int(msg), _tail_ptrs(params), *_ptrs(acc, weights, mask, resnet, out),
        n_rows, d, build.stream(),
    )
    build.check(err, what)
    return out


def _backward(what, acc, weights, mask, params, g, need_mask, need_params):
    """Launch the backward kernel (and, for the parameter gradients, the
    kernel that sums its per-block f32 partials and rounds them once to the
    parameters' type): ``(d_acc, d_weights | None, d_mask | None, d_params |
    None)``."""
    msg = weights is not None
    rows = (weights, g) if msg else (g,)
    n_rows, d, kind = _check(what, acc, rows, (mask,) if msg else (), params, msg)
    d_acc = torch.empty_like(acc)
    d_weights = acc.new_empty((n_rows, d)) if msg else None
    d_mask = acc.new_empty(n_rows) if need_mask else None
    n_blocks, partial, flat = 0, None, None
    if need_params:
        n_blocks = min(-(-n_rows // TILE), PARAM_BLOCKS)
        n_part = (2 * d * d + 2 * d if len(params) == 7 else 0) + 4 * d
        partial = acc.new_empty((n_blocks, n_part), dtype=torch.float32)
        flat = acc.new_empty(n_part)
    err = getattr(_lib(), f"gated_bwd_{kind}")(
        int(msg), _tail_ptrs(params),
        *_ptrs(acc, weights, mask, g, d_acc, d_weights, d_mask, partial, flat),
        n_rows, d, n_blocks, build.stream(),
    )
    build.check(err, what)
    d_params = _split_params(flat, d, len(params)) if need_params else None
    return d_acc, d_weights, d_mask, d_params


def gated_message_fwd(acc, weights, mask, params):
    """Message tail ``[L, D]`` of ``acc [L, 2D]``, ``weights [L, D]`` and
    ``mask [L]``."""
    if not build.on_cuda(acc, "gated_message_fwd"):
        return gated_message_plain(acc, weights, mask, params)
    out = _forward("gated_message_fwd", acc, weights, mask, None, params)
    gated_message_fwd.launches += 1
    gated_message_fwd.launches_bf16 += acc.dtype == torch.bfloat16
    return out


gated_message_fwd.launches = gated_message_fwd.launches_bf16 = 0


def gated_message_reduce(acc, weights, mask, params, offsets):
    """Segment sums ``[n_out, D]`` of the message tail's rows (see
    :func:`gated_message_fwd`) over CSR ``offsets [n_out + 1]`` of the
    stream's sorted keys: rows ``offsets[n] .. offsets[n + 1]`` add into
    output row ``n``, rows past ``offsets[n_out]`` are dropped."""
    if not build.on_cuda(acc, "gated_message_reduce"):
        return gated_message_reduce_plain(acc, weights, mask, params, offsets)
    what = "gated_message_reduce"
    if offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError(f"{what}: offsets [n_out + 1] expected")
    n_rows, d, kind = _check(
        what, acc, (weights,), (mask,), params, True, ints=(offsets,)
    )
    n_out = offsets.shape[0] - 1
    out = acc.new_empty((n_out, d))
    err = getattr(_lib(), f"gated_reduce_{kind}")(
        _tail_ptrs(params), *_ptrs(acc, weights, mask, offsets, out),
        n_rows, n_out, d, build.stream(),
    )
    build.check(err, what)
    gated_message_reduce.launches += 1
    gated_message_reduce.launches_bf16 += kind == "bf16"
    return out


gated_message_reduce.launches = gated_message_reduce.launches_bf16 = 0


def gated_message_bwd(acc, weights, mask, params, g, need_mask, need_params):
    """``(d_acc, d_weights, d_mask | None, d_params | None)`` of the message
    tail for the cotangent ``g [L, D]``."""
    if not build.on_cuda(acc, "gated_message_bwd"):
        return gated_message_bwd_plain(
            acc, weights, mask, params, g, need_mask, need_params
        )
    out = _backward(
        "gated_message_bwd", acc, weights, mask, params, g, need_mask,
        need_params,
    )
    gated_message_bwd.launches += 1
    gated_message_bwd.launches_bf16 += acc.dtype == torch.bfloat16
    return out


gated_message_bwd.launches = gated_message_bwd.launches_bf16 = 0


def gated_update_fwd(acc, resnet, params):
    """Update tail ``[L, D]`` of ``acc [L, 2D]`` plus ``resnet [L, D]``."""
    if not build.on_cuda(acc, "gated_update_fwd"):
        return gated_update_plain(acc, resnet, params)
    out = _forward("gated_update_fwd", acc, None, None, resnet, params)
    gated_update_fwd.launches += 1
    gated_update_fwd.launches_bf16 += acc.dtype == torch.bfloat16
    return out


gated_update_fwd.launches = gated_update_fwd.launches_bf16 = 0


def gated_update_bwd(acc, params, g, need_params):
    """``(d_acc, d_params | None)`` of the update tail for the cotangent
    ``g [L, D]`` (``d_resnet`` is ``g``)."""
    if not build.on_cuda(acc, "gated_update_bwd"):
        return gated_update_bwd_plain(acc, params, g, need_params)
    d_acc, _, _, d_params = _backward(
        "gated_update_bwd", acc, None, None, params, g, False, need_params
    )
    gated_update_bwd.launches += 1
    gated_update_bwd.launches_bf16 += acc.dtype == torch.bfloat16
    return d_acc, d_params


gated_update_bwd.launches = gated_update_bwd.launches_bf16 = 0


# --------------------------------------------------------------- autograd
def _second_order(first_order, inputs, cts):
    """VJP with cotangents ``cts`` of ``first_order`` (the plain
    composition's first-order gradients) at ``inputs``."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in inputs]
        grads = first_order(*xs)
        return torch.autograd.grad(grads, xs, cts, allow_unused=True)


class _GatedMessage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, acc, weights, mask, *params):
        ctx.save_for_backward(acc, weights, mask, *params)
        return gated_message_fwd(acc, weights, mask, params)

    @staticmethod
    def backward(ctx, g):
        acc, weights, mask, *params = ctx.saved_tensors
        need = ctx.needs_input_grad
        flags = (need[2], any(need[3:]))
        grads = _GatedMessageGrads.apply(
            flags, acc, weights, mask, g.contiguous(), *params
        )
        d_mask = grads[2] if flags[0] else None
        d_params = grads[2 + flags[0]:] if flags[1] else (None,) * len(params)
        return grads[0], grads[1], d_mask, *d_params


class _GatedMessageGrads(torch.autograd.Function):
    """``(d_acc, d_weights[, d_mask][, *d_params])`` of the message tail by
    the backward kernel (``_fused_grads``)."""

    @staticmethod
    def forward(ctx, flags, acc, weights, mask, g, *params):
        ctx.flags = flags
        ctx.save_for_backward(acc, weights, mask, g, *params)
        d_acc, d_weights, d_mask, d_params = gated_message_bwd(
            acc, weights, mask, params, g, *flags
        )
        extra = ((d_mask,) if flags[0] else ()) + (d_params if flags[1] else ())
        return (d_acc, d_weights, *extra)

    @staticmethod
    def backward(ctx, *cts):
        need_mask, need_params = ctx.flags

        def first_order(acc, weights, mask, g, *params):
            out = gated_message_plain(acc, weights, mask, params)
            wrt = [acc, weights] + ([mask] if need_mask else [])
            wrt += list(params) if need_params else []
            return torch.autograd.grad(out, wrt, g, create_graph=True)

        return (None, *_second_order(first_order, ctx.saved_tensors, cts))


class _GatedMessageReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, acc, weights, mask, *params):
        ctx.plan = plan
        ctx.save_for_backward(acc, weights, mask, *params)
        return gated_message_reduce(acc, weights, mask, params, plan.offsets)

    @staticmethod
    def backward(ctx, ct):
        acc, weights, mask, *params = ctx.saved_tensors
        need = ctx.needs_input_grad
        flags = (need[3], any(need[4:]))
        # the cotangent of every row: ct[key], zero for dropped rows
        g = plan_gather(ct, ctx.plan.key, ctx.plan)
        grads = _GatedMessageGrads.apply(flags, acc, weights, mask, g, *params)
        d_mask = grads[2] if flags[0] else None
        d_params = grads[2 + flags[0]:] if flags[1] else (None,) * len(params)
        return None, grads[0], grads[1], d_mask, *d_params


class _GatedUpdate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, acc, resnet, *params):
        ctx.save_for_backward(acc, *params)
        return gated_update_fwd(acc, resnet, params)

    @staticmethod
    def backward(ctx, g):
        acc, *params = ctx.saved_tensors
        need_params = any(ctx.needs_input_grad[2:])
        grads = _GatedUpdateGrads.apply(need_params, acc, g.contiguous(), *params)
        d_params = grads[1:] if need_params else (None,) * len(params)
        return grads[0], g, *d_params


class _GatedUpdateGrads(torch.autograd.Function):
    """``(d_acc[, *d_params])`` of the update tail by the backward kernel
    (``_fused_nw_grads``)."""

    @staticmethod
    def forward(ctx, need_params, acc, g, *params):
        ctx.need_params = need_params
        ctx.save_for_backward(acc, g, *params)
        d_acc, d_params = gated_update_bwd(acc, params, g, need_params)
        return (d_acc, *(d_params if need_params else ()))

    @staticmethod
    def backward(ctx, *cts):
        need_params = ctx.need_params

        def first_order(acc, g, *params):
            out = _update_gate(acc, params)
            wrt = [acc] + (list(params) if need_params else [])
            return torch.autograd.grad(out, wrt, g, create_graph=True)

        return (None, *_second_order(first_order, ctx.saved_tensors, cts))


# ------------------------------------------------------------ entry points
def fused_gated_message(acc, weights, mask, p2: dict) -> torch.Tensor:
    """``silu(LN(y_c)) * sigmoid(LN(y_g)) * weights * mask`` with ``y =
    silu(acc) @ blockdiag(w2c, w2g) + b2``; ``p2`` from
    ``gated_mlp_fused_pack`` (2-Linear branches)."""
    if "w2c" not in p2:
        raise ValueError("fused_gated_message needs a second layer (w2c/w2g)")
    return _GatedMessage.apply(
        acc.contiguous(), weights.contiguous(), mask.contiguous(),
        *tail_params(p2),
    )


def msg_reduce_enabled() -> bool:
    """The message-reduce switch, read at call time:
    ``CHGNET_TPU_MSG_REDUCE`` non-empty, ``CHGNET_TPU_NO_MSG_REDUCE`` and
    ``CHGNET_TPU_FUSED_PASS`` empty."""
    return (
        bool(os.environ.get("CHGNET_TPU_MSG_REDUCE"))
        and not os.environ.get("CHGNET_TPU_FUSED_PASS")
        and not os.environ.get("CHGNET_TPU_NO_MSG_REDUCE")
    )


def msg_reduce_ok(plan: SegmentPlan) -> bool:
    """Whether a message layer reduces through
    :func:`fused_gated_message_reduce`: the switch of ``chgnet_tpu``'s
    ``msg_reduce_ok`` (:530), read at call time (``CHGNET_TPU_MSG_REDUCE``
    non-empty, ``CHGNET_TPU_NO_MSG_REDUCE`` empty), and a stream sorted by
    its keys (a plan without a permutation). Off while
    ``CHGNET_TPU_FUSED_PASS`` is set: the one-kernel pass keeps the tail and
    its sum apart (``chgnet_tpu.models.layers._msg_reduce_ok`` :62)."""
    return msg_reduce_enabled() and plan.perm.shape[0] == 0


def fused_gated_message_reduce(
    acc, weights, mask, p2: dict, plan: SegmentPlan
) -> torch.Tensor:
    """``plan_segment_sum(fused_gated_message(acc, weights, mask, p2), plan)``
    ``[plan.n_out, D]`` in one sweep; ``plan`` of the stream's sorted keys
    (no permutation)."""
    if "w2c" not in p2:
        raise ValueError("fused_gated_message_reduce needs a second layer (w2c/w2g)")
    if plan.perm.shape[0] or plan.key.shape[0] != acc.shape[0]:
        raise ValueError(
            "fused_gated_message_reduce: a plan of the stream's sorted keys "
            "expected"
        )
    return _GatedMessageReduce.apply(
        plan, acc.contiguous(), weights.contiguous(), mask.contiguous(),
        *tail_params(p2),
    )


def fused_gated_update(acc, resnet, p2: dict) -> torch.Tensor:
    """``silu(LN(y_c)) * sigmoid(LN(y_g)) + resnet`` with ``y = acc``
    (single-Linear branches) or as in :func:`fused_gated_message`."""
    return _GatedUpdate.apply(
        acc.contiguous(), resnet.contiguous(), *tail_params(p2)
    )
