"""Gather-project-sum: a conv layer's first gated-MLP Linear over gathered
table rows, in one kernel.

    acc[l] = sum_p  T_p[idx_p[l]] @ W_p  +  stream[l]

:func:`gather_project_sum_kernel` (``csrc/gproj.cu``) replaces
``chgnet_tpu/ops/gproj.py`` ``_gproj_kernel`` (``_gproj_pallas`` :175). It
computes gather-then-project; its plain version
(:func:`gather_project_sum_plain`) projects each table first and gathers
the projected rows, as ``chgnet_tpu`` computes the same function off the
TPU (``models/functions.py:407-412``). The two round differently.

The backward (``chgnet_tpu/ops/gproj.py:290-320``) takes one segment sum of
the cotangent per distinct index stream, two of them paired into one
:func:`~chgnet_tpu_torch.ops.segment.segment_sum_pair` sweep, then
``d_T = S_i @ W^T`` and ``d_W = T^T @ S_i`` with ``torch.matmul`` (the JAX
package also leaves these small products to XLA).
"""

from __future__ import annotations

import ctypes

import torch

from chgnet_tpu_torch.ops import build
from chgnet_tpu_torch.ops.segment import plan_segment_sum, plan_segment_sum_pair

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gproj_f32": [
        _I, ctypes.POINTER(_P), ctypes.POINTER(_P), _P, _P, _P, _I, _I, _I,
        _I, _P,
    ],
}
MAX_PAIRS = 3  # AtomConv 2, BondConv and AngleUpdate 3 with the atom_e fold


def gather_project_sum_plain(tables, idxs, ws, stream):
    """Plain version of :func:`gather_project_sum_kernel`: project each
    pair's table, gather the projected rows, add them to ``stream``."""
    out = stream.clone()
    for table, idx, w in zip(tables, idxs, ws):
        n_src = table.shape[0]
        ok = (idx >= 0) & (idx < n_src)
        proj = (table @ w)[idx.clamp(0, n_src - 1).long()]
        out = out + torch.where(ok[:, None], proj, proj.new_zeros(()))
    return out


def gather_project_sum_kernel(tables, idxs, ws, stream):
    """``stream + sum_p tables[p][idxs[p]] @ ws[p]`` for up to 3 pairs.

    ``tables[p]`` [S, dt] (one S for all), ``idxs[p]`` [L] int32 (a zero
    row where out of range), ``ws[p]`` [dt, K], ``stream`` [L, K]."""
    if not build.on_cuda(stream, "gather_project_sum"):
        return gather_project_sum_plain(tables, idxs, ws, stream)
    n_pairs = len(tables)
    if not 1 <= n_pairs <= MAX_PAIRS:
        raise ValueError(
            f"gather_project_sum: {n_pairs} pairs (1..{MAX_PAIRS})"
        )
    n_src, dt = tables[0].shape
    n_rows, k_out = stream.shape
    if dt % 4 or k_out % 4 or k_out > 128:
        raise ValueError(
            f"gather_project_sum: needs dt % 4 == 0 and K % 4 == 0, K <= 128 "
            f"(dt={dt}, K={k_out})"
        )
    for t, i, w in zip(tables, idxs, ws):
        if t.shape != (n_src, dt) or i.shape != (n_rows,) or w.shape != (dt, k_out):
            raise ValueError("gather_project_sum: mismatched pair shapes")
    w_cat = torch.cat(list(ws), dim=0)  # [n_pairs * dt, K]
    out = torch.empty_like(stream)
    build.check_tensors(
        "gather_project_sum", (stream, *tables, *ws), tuple(idxs),
        aligned=(stream, *tables, out),
    )
    tab_ptrs = (_P * n_pairs)(*(t.data_ptr() for t in tables))
    idx_ptrs = (_P * n_pairs)(*(i.data_ptr() for i in idxs))
    lib = build.load("gproj", _SIGNATURES)
    ptr = build.ptr
    err = lib.gproj_f32(
        n_pairs, tab_ptrs, idx_ptrs, ptr(w_cat), ptr(stream), ptr(out),
        n_rows, n_src, dt, k_out, build.stream(),
    )
    build.check(err, "gather_project_sum")
    gather_project_sum_kernel.launches += 1
    return out


gather_project_sum_kernel.launches = 0


class _GatherProjectSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, meta, stream, *tensors):
        pair_tab, pair_idx, idxs, plans = meta
        n_tab = len(tensors) - len(pair_tab)
        tables, ws = tensors[:n_tab], tensors[n_tab:]
        ctx.meta = meta
        ctx.n_tab = n_tab
        ctx.save_for_backward(*tables, *ws)
        return gather_project_sum_kernel(
            [tables[t].contiguous() for t in pair_tab],
            [idxs[i] for i in pair_idx],
            [w.contiguous() for w in ws],
            stream.contiguous(),
        )

    @staticmethod
    def backward(ctx, ct):
        pair_tab, pair_idx, _, plans = ctx.meta
        saved = ctx.saved_tensors
        tables, ws = saved[: ctx.n_tab], saved[ctx.n_tab:]
        need = ctx.needs_input_grad
        need_tab = need[2: 2 + ctx.n_tab]
        need_w = need[2 + ctx.n_tab:]
        d_tables = [None] * len(tables)
        d_ws = [None] * len(ws)
        if any(need_tab) or any(need_w):
            # one segment sum of ct per distinct index stream, the first
            # two paired into one sweep
            sums = [None] * len(plans)
            if len(plans) >= 2:
                sums[0], sums[1] = plan_segment_sum_pair(ct, plans[0], plans[1])
            for k, plan in enumerate(plans):
                if sums[k] is None:
                    sums[k] = plan_segment_sum(ct, plan)
            for p, (t, i) in enumerate(zip(pair_tab, pair_idx)):
                if need_tab[t]:
                    contrib = sums[i] @ ws[p].T
                    d_tables[t] = (
                        contrib if d_tables[t] is None else d_tables[t] + contrib
                    )
                if need_w[p]:
                    d_ws[p] = tables[t].T @ sums[i]
        d_stream = ct if need[1] else None
        return (None, d_stream, *d_tables, *d_ws)


def gather_project_sum(parts, stream):
    """First-layer accumulator ``stream + sum_p T_p[idx_p] @ W_p``.

    ``parts``: ``[(table [S, dt], idx [L] int32, plan, W [dt, K])]``, all
    tables over one source axis S. Tables and index streams are shared by
    identity (``is``): the backward takes one segment sum per distinct plan.
    """
    tables: list = []
    plans: list = []
    idxs: list = []
    pair_tab, pair_idx, ws = [], [], []
    for table, idx, plan, w in parts:
        t = next((k for k, x in enumerate(tables) if x is table), None)
        if t is None:
            t = len(tables)
            tables.append(table)
        i = next((k for k, x in enumerate(plans) if x is plan), None)
        if i is None:
            i = len(plans)
            plans.append(plan)
            idxs.append(idx)
        pair_tab.append(t)
        pair_idx.append(i)
        ws.append(w)
    if len({p.n_out for p in plans}) != 1 or plans[0].n_out != tables[0].shape[0]:
        raise ValueError("gather_project_sum: tables and plans differ in rows")
    meta = (tuple(pair_tab), tuple(pair_idx), tuple(idxs), tuple(plans))
    return _GatherProjectSum.apply(meta, stream, *tables, *ws)
