"""One-kernel conv-layer pass: the first-layer sum and the gated tail.

    acc = sum_k T_k[idx_k] + aligned + b1            acc [L, 2D], never stored
    out = tail(acc) * weights * mask   (message)  |  tail(acc) + resnet (update)

Port of ``chgnet_tpu/ops/fused_pass.py``. Two kernel wrappers
(``csrc/fused_pass.cu``: in f32 warp-specialised tensor-core kernels, in
bf16 warp-local tiles on the bf16 tensor cores, the backward with parameter
gradients on CUDA-core FMAs), each beside its plain PyTorch version:

* :func:`fused_pass_fwd` replaces ``_kernel`` (:157, ``_fused_pass_pallas``
  :219): K = 1..3 gathered, already projected tables ``[S_k, 2D]``, at most
  one aligned stream ``[L, 2D]``, the joint first-layer bias, then the tail
  of ``ops/gated_message.py`` (with or without a second layer);
* :func:`fused_pass_bwd` replaces ``_bwd_kernel`` (:393, ``_pass_bwd_pallas``
  :526): it gathers the same rows again, recomputes ``acc`` and writes
  ``d_total [L, 2D]`` (the cotangent of ``acc``), ``d_weights`` and, only on
  request, ``d_mask`` and the parameter gradients, ``d_b1 = sum of d_total``
  among them.

``chgnet_tpu`` folds the mask into the weights outside its kernel because of
a TPU compiler layout limit; here the kernels take the mask as the tail
kernels do, and ``d_weights`` / ``d_mask`` are those of the composition.

:func:`fused_layer_pass` is the entry point (``fused_layer_pass`` :745). Its
gate keeps the structural half of the TPU's (:781-804): the switch
``CHGNET_TPU_FUSED_PASS`` set and ``CHGNET_TPU_NO_FUSED_PASS`` not, read at
call time, at least one gathered part, every table ``2D`` wide and every
aligned part ``L`` rows long. With the gate closed it runs the unfused
composition (:func:`_reference_pass`: the multi-gather kernel, then the tail
kernels), which is ``chgnet_tpu``'s own dispatch; with the gate open it
launches the kernels, or raises on what they do not take (more than 3
gathered or more than 1 aligned part, ``2D > 128``, ``D % 4``).

Autograd as in ``chgnet_tpu`` (:351-389, :652-742): the forward op's
backward is a second op around the backward kernel, whose tables'
cotangents are segment sums of ``d_total`` over each gathered part's plan
(two plans of one size in one sweep) and ``d_total`` itself for an aligned
part; that op's own backward (second order, for force training)
differentiates the unfused composition.

bf16 (``compute_dtype="bfloat16"``): both kernels take bf16 tables, aligned
rows, ``b1``, side rows, cotangent and parameters (their ``_bf16`` C entry
points), keep ``acc`` and everything after it in f32 and round each output
once, as ``chgnet_tpu``'s kernels do (``fused_pass.py:197-207``,
``:452-489``); the parameter gradients' per-block partials are summed in f32
and rounded once to bf16. The serving forms are kernels of their own
(``tcp16::pass_fwd_bf16_kernel``, ``tcp16::pass_bwd_bf16_kernel``): each
warp copies its tile's gathered and aligned rows raw, as bf16, sums ``acc``
in f32 as it builds each product's A fragments and runs both products as
two bf16 passes (hi and lo of the f32 operand) on the bf16 tensor cores.
The plain versions widen, compute in f32 and round
once (:func:`~chgnet_tpu_torch.ops.build.plain_in_f32`), so ``acc`` is not
rounded to bf16 between the sum and the tail. The second order
differentiates the unfused composition in the inputs' type, as for f32.
"""

from __future__ import annotations

import ctypes
import os

import torch

from chgnet_tpu_torch.ops import build
from chgnet_tpu_torch.ops.gated_message import (
    PARAM_BLOCKS,
    TAIL_MAX_D,
    TILE,
    _check_shapes,
    _ptrs,
    _second_order,
    _split_params,
    _tail_ptrs,
    fused_gated_message,
    fused_gated_update,
    gated_message_bwd_plain,
    gated_message_plain,
    gated_update_bwd_plain,
    gated_update_plain,
    tail_params,
)
from chgnet_tpu_torch.ops.multi_gather import (
    cotangent_sums,
    gather_sum,
    gather_sum_rows_plain,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_PARTS = [_I, ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I), _P, _P]
_SIGNATURES = {
    "fused_pass_fwd_f32": [
        _I, ctypes.POINTER(_P), *_PARTS, _P, _P, _P, _P, _I, _I, _P,
    ],
    "fused_pass_fwd_bf16": [
        _I, ctypes.POINTER(_P), *_PARTS, _P, _P, _P, _P, _I, _I, _P,
    ],
    "fused_pass_bwd_f32": [
        _I, ctypes.POINTER(_P), *_PARTS, _P, _P, _P, _P, _P, _P, _P, _P, _I,
        _I, _I, _P,
    ],
    "fused_pass_bwd_bf16": [
        _I, ctypes.POINTER(_P), *_PARTS, _P, _P, _P, _P, _P, _P, _P, _P, _I,
        _I, _I, _P,
    ],
    "fused_tc_occupancy": [ctypes.POINTER(_I)],
    "fused_bf16_occupancy": [ctypes.POINTER(_I)],
}
MAX_PARTS = 3  # gathered parts of one launch


# ------------------------------------------------------------------ plain
def _acc_plain(tables, idxs, aligned, b1):
    return gather_sum_rows_plain(tables, idxs, aligned) + b1


@build.plain_in_f32
def fused_pass_fwd_plain(tables, idxs, aligned, b1, params, weights, mask, resnet):
    """Plain version of :func:`fused_pass_fwd`: the multi-gather's plain
    sum, the bias, then the tail's plain version."""
    acc = _acc_plain(tables, idxs, aligned, b1)
    if weights is not None:
        return gated_message_plain(acc, weights, mask, params)
    return gated_update_plain(acc, resnet, params)


@build.plain_in_f32
def fused_pass_bwd_plain(
    tables, idxs, aligned, b1, params, weights, mask, g, need_mask, need_params
):
    """Plain version of :func:`fused_pass_bwd`: ``(d_total, d_weights | None,
    d_mask | None, d_params | None)``, ``d_params`` the tail's parameter
    gradients followed by ``d_b1``."""
    acc = _acc_plain(tables, idxs, aligned, b1)
    if weights is not None:
        d_total, d_weights, d_mask, d_params = gated_message_bwd_plain(
            acc, weights, mask, params, g, need_mask, need_params
        )
    else:
        d_total, d_params = gated_update_bwd_plain(acc, params, g, need_params)
        d_weights = d_mask = None
    if need_params:
        d_params = (*d_params, d_total.sum(0))
    return d_total, d_weights, d_mask, d_params


# --------------------------------------------------------------- wrappers
def _check_parts(what, tables, idxs, aligned, b1, rows, vecs, params, msg):
    """Raise on what the kernels do not take; returns ``(n_rows, D, the C
    entry points' storage suffix)``."""
    if not 1 <= len(tables) <= MAX_PARTS or len(idxs) != len(tables):
        raise ValueError(
            f"{what}: {len(tables)} tables and {len(idxs)} index streams "
            f"(1..{MAX_PARTS} gathered parts)"
        )
    n_rows, d2 = idxs[0].shape[0], tables[0].shape[1]
    if any(t.dim() != 2 or t.shape[1] != d2 for t in tables):
        raise ValueError(f"{what}: tables of one width expected")
    if any(i.shape != (n_rows,) for i in idxs):
        raise ValueError(f"{what}: index streams differ in rows")
    if b1.shape != (d2,):
        raise ValueError(f"{what}: b1 [{d2}] expected, got {tuple(b1.shape)}")
    if aligned is not None and aligned.shape != (n_rows, d2):
        raise ValueError(f"{what}: the aligned part is off the stream axis")
    _check_shapes(what, (n_rows, d2), rows, vecs, params, msg)
    wide = (*tables, b1, *(() if aligned is None else (aligned,)))
    kind = build.check_tensors(
        what, (*wide, *rows, *vecs, *params), tuple(idxs), aligned=wide
    )
    return n_rows, d2 // 2, kind


def _part_args(tables, idxs, aligned, b1):
    n = len(tables)
    return (
        n,
        (_P * n)(*(t.data_ptr() for t in tables)),
        (_P * n)(*(i.data_ptr() for i in idxs)),
        (_I * n)(*(t.shape[0] for t in tables)),
        None if aligned is None else build.ptr(aligned),
        build.ptr(b1),
    )


def _lib() -> ctypes.CDLL:
    return build.load("fused_pass", _SIGNATURES)


def tc_occupancy() -> dict[str, tuple[int, int, int]]:
    """``(shared memory bytes, warps a block, blocks of one wave)`` on the
    current card of the serving kernels, by kernel and form, the bf16 ones
    also by the part tiles of a stage (gathered parts plus the aligned
    one); nothing is launched."""
    info = (_I * 12)()
    build.check(_lib().fused_tc_occupancy(info), "fused_tc_occupancy")
    names = ("pass_fwd_tc_kernel<true, true>", "pass_fwd_tc_kernel<false, false>",
             "pass_bwd_tc_kernel<true, true>", "pass_bwd_tc_kernel<false, false>")
    out = {name: tuple(info[3 * i: 3 * i + 3]) for i, name in enumerate(names)}
    info = (_I * 48)()
    build.check(_lib().fused_bf16_occupancy(info), "fused_bf16_occupancy")
    forms = ("pass_fwd_bf16_kernel<true, true>", "pass_fwd_bf16_kernel<false, false>",
             "pass_bwd_bf16_kernel<true, true>", "pass_bwd_bf16_kernel<false, false>")
    for i, form in enumerate(forms):
        for n in range(1, MAX_PARTS + 2):
            j = 3 * (4 * i + n - 1)
            out[f"{form} {n} tiles"] = tuple(info[j: j + 3])
    return out


def fused_pass_fwd(tables, idxs, aligned, b1, params, weights, mask, resnet):
    """``tail(sum_k tables[k][idxs[k]] + aligned + b1)`` -> ``[L, D]``: the
    message tail with ``weights [L, D]`` and ``mask [L]``, else the update
    tail plus ``resnet [L, D]``. ``tables[k]`` [S_k, 2D] f32 or bf16, ``idxs[k]`` [L]
    int32 (a zero row where out of range), ``aligned`` [L, 2D] or None,
    ``b1`` [2D], ``params`` as the tail kernels take them."""
    if not build.on_cuda(tables[0], "fused_pass_fwd"):
        return fused_pass_fwd_plain(
            tables, idxs, aligned, b1, params, weights, mask, resnet
        )
    what = "fused_pass_fwd"
    msg = weights is not None
    rows = (weights,) if msg else (resnet,)
    n_rows, d, kind = _check_parts(
        what, tables, idxs, aligned, b1, rows, (mask,) if msg else (), params, msg
    )
    out = tables[0].new_empty((n_rows, d))
    err = getattr(_lib(), f"fused_pass_fwd_{kind}")(
        int(msg), _tail_ptrs(params), *_part_args(tables, idxs, aligned, b1),
        *_ptrs(weights, mask, resnet, out), n_rows, d, build.stream(),
    )
    build.check(err, what)
    fused_pass_fwd.launches += 1
    fused_pass_fwd.launches_bf16 += kind == "bf16"
    return out


fused_pass_fwd.launches = fused_pass_fwd.launches_bf16 = 0


def fused_pass_bwd(
    tables, idxs, aligned, b1, params, weights, mask, g, need_mask, need_params
):
    """``(d_total [L, 2D], d_weights | None, d_mask | None, d_params |
    None)`` of :func:`fused_pass_fwd` for the cotangent ``g [L, D]``;
    ``d_params`` are the tail's parameter gradients followed by ``d_b1``."""
    if not build.on_cuda(tables[0], "fused_pass_bwd"):
        return fused_pass_bwd_plain(
            tables, idxs, aligned, b1, params, weights, mask, g, need_mask,
            need_params,
        )
    what = "fused_pass_bwd"
    msg = weights is not None
    rows = (weights, g) if msg else (g,)
    n_rows, d, kind = _check_parts(
        what, tables, idxs, aligned, b1, rows, (mask,) if msg else (), params, msg
    )
    d_total = tables[0].new_empty((n_rows, 2 * d))
    d_weights = d_total.new_empty((n_rows, d)) if msg else None
    d_mask = d_total.new_empty(n_rows) if msg and need_mask else None
    n_blocks, partial, flat = 0, None, None
    if need_params:
        n_blocks = min(-(-n_rows // TILE), PARAM_BLOCKS)
        n_part = (2 * d * d + 2 * d if len(params) == 7 else 0) + 6 * d
        partial = d_total.new_empty((n_blocks, n_part), dtype=torch.float32)
        flat = d_total.new_empty(n_part)
    err = getattr(_lib(), f"fused_pass_bwd_{kind}")(
        int(msg), _tail_ptrs(params), *_part_args(tables, idxs, aligned, b1),
        *_ptrs(weights, mask, g, d_total, d_weights, d_mask, partial, flat),
        n_rows, d, n_blocks, build.stream(),
    )
    build.check(err, what)
    d_params = None
    if need_params:
        d_params = (
            *_split_params(flat[: -2 * d], d, len(params)), flat[-2 * d:]
        )
    fused_pass_bwd.launches += 1
    fused_pass_bwd.launches_bf16 += kind == "bf16"
    return d_total, d_weights, d_mask, d_params


fused_pass_bwd.launches = fused_pass_bwd.launches_bf16 = 0


# --------------------------------------------------------------- autograd
class _Layout:
    """What is not a tensor of one pass: every part's index stream (None
    for the aligned part) and plan, and the form (message or update)."""

    def __init__(self, idxs, plans, msg):
        self.idxs, self.plans, self.msg = tuple(idxs), tuple(plans), msg
        self.gathered = [k for k, i in enumerate(idxs) if i is not None]
        self.aligned = [k for k, i in enumerate(idxs) if i is None]
        self.n_rows_in = 2 if msg else 1  # weights and mask, or resnet

    def split(self, tensors):
        """``(tables, b1, rows, params)`` of the ops' flat tensor list."""
        n = len(self.idxs)
        rows = tensors[n + 1: n + 1 + self.n_rows_in]
        return tensors[:n], tensors[n], rows, tensors[n + 1 + self.n_rows_in:]

    def kernel_args(self, tables, b1, params):
        aligned = tables[self.aligned[0]] if self.aligned else None
        return (
            [tables[k] for k in self.gathered],
            [self.idxs[k] for k in self.gathered], aligned, b1, tuple(params),
        )


def _reference_pass(tables, idxs, plans, b1, p2, weights, mask, resnet):
    """The unfused composition (``_reference_pass`` :312): the bias folded
    into the first aligned part, the multi-gather sum, then the fused tail
    op of the form."""
    parts = list(zip(tables, idxs, plans))
    rest = b1
    for k, (table, idx, plan) in enumerate(parts):
        if idx is None:
            parts[k] = (table + b1, idx, plan)
            rest = None
            break
    acc = gather_sum(parts)
    if rest is not None:
        acc = acc + rest
    if weights is not None:
        if mask is None:
            mask = acc.new_ones(acc.shape[0])
        out = fused_gated_message(acc, weights, mask, p2)
        return out if resnet is None else out + resnet
    if mask is not None:
        raise NotImplementedError("mask without weights is unsupported")
    if resnet is None:
        resnet = acc.new_zeros((acc.shape[0], p2["nc_scale"].shape[-1]))
    return fused_gated_update(acc, resnet, p2)


def _plain_pass(lay, tables, b1, rows, params):
    """The composition of differentiable ops that the second order
    differentiates: the planned multi-gather, then the tail's plain
    version."""
    acc = gather_sum(list(zip(tables, lay.idxs, lay.plans))) + b1
    if lay.msg:
        return gated_message_plain(acc, rows[0], rows[1], params)
    return gated_update_plain(acc, rows[0], params)


class _FusedPass(torch.autograd.Function):
    """Tensors: the parts' tables in part order, ``b1``, ``weights`` and
    ``mask`` (message) or ``resnet`` (update), the tail's parameters."""

    @staticmethod
    def forward(ctx, lay, *tensors):
        ctx.lay = lay
        ctx.save_for_backward(*tensors)
        tables, b1, rows, params = lay.split(tensors)
        args = lay.kernel_args(tables, b1, params)
        if lay.msg:
            return fused_pass_fwd(*args, rows[0], rows[1], None)
        return fused_pass_fwd(*args, None, None, rows[0])

    @staticmethod
    def backward(ctx, g):
        lay, tensors = ctx.lay, ctx.saved_tensors
        n = len(lay.idxs)
        need = ctx.needs_input_grad[1:]
        n_params = len(tensors) - n - 1 - lay.n_rows_in
        flags = (
            tuple(need[:n]),  # which tables
            lay.msg and need[n + 2],  # d_mask
            need[n] or any(need[n + 1 + lay.n_rows_in:]),  # parameters, b1
        )
        grads = list(_FusedPassGrads.apply(lay, flags, g.contiguous(), *tensors))
        d_tables = [grads.pop(0) if f else None for f in flags[0]]
        if lay.msg:
            d_rows = [grads.pop(0), grads.pop(0) if flags[1] else None]
        else:
            d_rows = [g]  # d_resnet is the cotangent
        d_params, d_b1 = (None,) * n_params, None
        if flags[2]:
            d_params, d_b1 = grads[:-1], grads[-1]
        return (None, *d_tables, d_b1, *d_rows, *d_params)


class _FusedPassGrads(torch.autograd.Function):
    """``(*d_tables asked for, [d_weights, [d_mask]], [*d_params, d_b1])``
    of the pass by the backward kernel (``_pass_grads`` :653)."""

    @staticmethod
    def forward(ctx, lay, flags, g, *tensors):
        ctx.lay, ctx.flags = lay, flags
        ctx.save_for_backward(g, *tensors)
        tables, b1, rows, params = lay.split(tensors)
        weights, mask = (rows[0], rows[1]) if lay.msg else (None, None)
        d_total, d_weights, d_mask, d_params = fused_pass_bwd(
            *lay.kernel_args(tables, b1, params), weights, mask, g, flags[1],
            flags[2],
        )
        need_tables = flags[0]
        sums = cotangent_sums(d_total, [
            p if i is not None and f else None
            for p, i, f in zip(lay.plans, lay.idxs, need_tables)
        ])
        out = [
            d_total if i is None else s
            for i, s, f in zip(lay.idxs, sums, need_tables) if f
        ]
        if lay.msg:
            out += [d_weights] + ([d_mask] if flags[1] else [])
        if flags[2]:
            out += list(d_params)
        return tuple(out)

    @staticmethod
    def backward(ctx, *cts):
        lay, (need_tables, need_mask, need_params) = ctx.lay, ctx.flags
        n = len(lay.idxs)

        def first_order(g, *tensors):
            tables, b1, rows, params = lay.split(tensors)
            out = _plain_pass(lay, tables, b1, rows, params)
            wrt = [t for t, f in zip(tables, need_tables) if f]
            if lay.msg:
                wrt += [rows[0]] + ([rows[1]] if need_mask else [])
            if need_params:
                wrt += [*params, b1]
            return torch.autograd.grad(out, wrt, g, create_graph=True)

        return (None, None, *_second_order(first_order, ctx.saved_tensors, cts))


# ------------------------------------------------------------ entry point
def fused_pass_enabled() -> bool:
    """The switch of the one-kernel pass, read at call time:
    ``CHGNET_TPU_FUSED_PASS`` non-empty and ``CHGNET_TPU_NO_FUSED_PASS``
    empty."""
    return bool(os.environ.get("CHGNET_TPU_FUSED_PASS")) and not os.environ.get(
        "CHGNET_TPU_NO_FUSED_PASS"
    )


def fused_layer_pass(
    parts, b1, p2: dict, *, weights=None, mask=None, resnet=None
) -> torch.Tensor:
    """One conv-layer pass: the first-layer sum of ``parts`` (``(projected
    table [S, 2D], idx [L] | None, plan)``) and ``b1`` [2D] (None: no bias),
    then the gated tail of ``p2`` (``gated_mlp_fused_pack``): the message
    form ``* weights * mask`` with ``weights``, else the update form
    ``+ resnet``. In one kernel when the gate is open (see the module
    docstring), else the unfused composition."""
    tables = [t for t, _, _ in parts]
    idxs = [i for _, i, _ in parts]
    plans = [p for _, _, p in parts]
    n_rows = next((i.shape[0] for i in idxs if i is not None), tables[0].shape[0])
    d2 = tables[0].shape[1]
    if b1 is None:
        b1 = tables[0].new_zeros(d2)
    lay = _Layout(idxs, plans, weights is not None)
    ok = (
        fused_pass_enabled()
        and bool(lay.gathered)
        and all(t.shape[1] == d2 for t in tables)
        and all(tables[k].shape[0] == n_rows for k in lay.aligned)
        and all(plans[k] is not None for k in lay.gathered)
    )
    if not ok:
        return _reference_pass(tables, idxs, plans, b1, p2, weights, mask, resnet)
    if len(lay.gathered) > MAX_PARTS or len(lay.aligned) > 1:
        raise ValueError(
            f"fused_layer_pass: {len(lay.gathered)} gathered and "
            f"{len(lay.aligned)} aligned parts (at most {MAX_PARTS} and 1)"
        )
    if d2 % 8 or not 8 <= d2 <= 2 * TAIL_MAX_D:
        raise ValueError(
            f"fused_layer_pass: tables [S, 2D] with D % 4 == 0 and "
            f"2D <= {2 * TAIL_MAX_D} expected (2D={d2})"
        )
    params = tail_params(p2)
    tensors = [t.contiguous() for t in tables] + [b1.contiguous()]
    if lay.msg:
        if "w2c" not in p2:
            raise ValueError("the message form needs a second layer (w2c/w2g)")
        if mask is None:
            mask = weights.new_ones(n_rows)
        out = _FusedPass.apply(
            lay, *tensors, weights.contiguous(), mask.contiguous(), *params
        )
        return out if resnet is None else out + resnet
    if mask is not None:
        raise NotImplementedError("mask without weights is unsupported")
    if resnet is None:
        resnet = tables[0].new_zeros((n_rows, d2 // 2))
    return _FusedPass.apply(lay, *tensors, resnet.contiguous(), *params)
