"""Gather-project-sum: a conv layer's first gated-MLP Linear over gathered
table rows, in one kernel.

    acc[l] = sum_p  T_p[idx_p[l]] @ W_p  +  stream[l]

:func:`gather_project_sum_kernel` (``csrc/gproj.cu``) replaces
``chgnet_tpu/ops/gproj.py`` ``_gproj_kernel`` (``_gproj_pallas`` :175). It
takes one of two routes by the tables' length (:func:`gproj_route`):
short tables are projected first and their rows gathered and added (two
launches of ``csrc/gproj.cu``'s own kernels); long ones are gathered and
then projected. Both multiply on the tensor cores at f32 accuracy
(3xTF32). Tables over 64 wide or projections over 128 (up to 128 and 256,
a 128-wide model's first layers) take the short route whatever the tables'
length: the long route stages every pair's W at once, which at those widths
does not fit a block's shared memory. The plain version (:func:`gather_project_sum_plain`) projects
each table first and gathers the projected rows, as ``chgnet_tpu``
computes the same function off the TPU (``models/functions.py:407-412``).

bf16 tables, weights and stream (``compute_dtype="bfloat16"``): both routes
compute in f32 and round ``out`` once. The short route also rounds its
projected tables to bf16, as the plain version does (``chgnet_tpu``'s plain
path projects in bf16); the long route rounds nothing before the store, as
the TPU kernel, whose gathered rows are the bf16 rows themselves
(``chgnet_tpu/ops/gproj.py:155-159``). The long route in bf16 has a kernel
of its own (``gproj_bf16_tc_kernel``): bf16 rows gathered by ``cp.async``,
every product one pass on the bf16 tensor cores, exact in f32. :func:`gather_project_sum_route_plain`
gives the plain version each route's rounding; the wrapper's CPU path
rounds the projected tables, as ``chgnet_tpu`` does off the TPU.

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
_LONG = [_I, ctypes.POINTER(_P), ctypes.POINTER(_P), _P, _P, _P, _I, _I, _I, _I, _P]
_SHORT = [
    _I, ctypes.POINTER(_P), ctypes.POINTER(_P), _P, _P, _P, _P, _I, _I, _I, _I, _P,
]
_SIGNATURES = {
    "gproj_f32": _LONG, "gproj_bf16": _LONG,
    "gproj_short_f32": _SHORT, "gproj_short_bf16": _SHORT,
    "gproj_tc_occupancy": [ctypes.POINTER(_I)],
}
MAX_PAIRS = 3  # AtomConv 2, BondConv and AngleUpdate 3 with the atom_e fold
MAX_DT = 128  # table width the kernels take (kWideDt)
MAX_K = 256  # projected width (kWideK)
# the long route's widest call (kMaxDt, kMaxK: every pair's W staged at
# once); wider calls take the short route, one pair's W at a time
LONG_MAX_DT = 64
LONG_MAX_K = 128
# Project first while the projected tables, n_pairs x S x K elements, fit
# in half of the H100's 50 MB L2 (the gathers of the second launch then hit
# L2): AtomConv's 2 x 7,680 x 128 x 4 = 7.9 MB in f32. Longer tables are
# gathered first, where the long route takes their widths.
SHORT_TABLE_BYTES = 25 << 20


def gproj_route(
    n_pairs: int, n_src: int, k_out: int, elem_bytes: int = 4, dt: int = LONG_MAX_DT
) -> str:
    """``"short"`` (project first) or ``"long"`` (gather first) for a call
    with ``n_pairs`` tables of ``n_src`` rows, ``dt`` wide, projected to
    ``k_out`` columns of ``elem_bytes`` each."""
    fits = n_pairs * n_src * k_out * elem_bytes <= SHORT_TABLE_BYTES
    long_ok = dt <= LONG_MAX_DT and k_out <= LONG_MAX_K
    return "short" if fits or not long_ok else "long"


def call_route(tables, stream) -> str:
    """:func:`gproj_route` of one call's tables and stream."""
    return gproj_route(len(tables), tables[0].shape[0], stream.shape[1],
                       stream.element_size(), tables[0].shape[1])


def tc_occupancy() -> dict[str, tuple[int, int, int]]:
    """``(shared memory bytes, warps a block, blocks of one wave)`` on the
    current card of the long route's kernels at 3 pairs, by kernel name;
    nothing is launched."""
    names = ("gproj_tc_kernel<float>", "gproj_bf16_tc_kernel")
    info = (_I * (3 * len(names)))()
    build.check(build.load("gproj", _SIGNATURES).gproj_tc_occupancy(info),
                "gproj_tc_occupancy")
    return {name: tuple(info[3 * i: 3 * i + 3]) for i, name in enumerate(names)}


def gather_project_sum_plain(tables, idxs, ws, stream, round_tables=True):
    """Plain version of :func:`gather_project_sum_kernel`: project each
    pair's table in f32 (rounded once to the tables' type unless
    ``round_tables`` is false), gather the projected rows and add them to
    ``stream`` in f32, rounded once. For f32 tables the rounding is a no-op."""
    dtype = stream.dtype
    out = stream.float()
    for table, idx, w in zip(tables, idxs, ws):
        n_src = table.shape[0]
        ok = (idx >= 0) & (idx < n_src)
        proj = table.float() @ w.float()
        if round_tables:
            proj = proj.to(dtype).float()
        proj = proj[idx.clamp(0, n_src - 1).long()]
        out = out + torch.where(ok[:, None], proj, out.new_zeros(()))
    return out.to(dtype)


def gather_project_sum_route_plain(tables, idxs, ws, stream):
    """:func:`gather_project_sum_plain` with the rounding of the route the
    kernel takes for this call (:func:`gproj_route`): the short route
    rounds its projected tables, the long route nothing before the store.
    The card's holds compare each route with this."""
    return gather_project_sum_plain(
        tables, idxs, ws, stream, call_route(tables, stream) == "short")


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
    if dt % 4 or k_out % 4 or not (4 <= dt <= MAX_DT and 4 <= k_out <= MAX_K):
        raise ValueError(
            f"gather_project_sum: needs dt % 4 == 0 and K % 4 == 0, "
            f"4 <= dt <= {MAX_DT}, 4 <= K <= {MAX_K} (dt={dt}, K={k_out})"
        )
    for t, i, w in zip(tables, idxs, ws):
        if t.shape != (n_src, dt) or i.shape != (n_rows,) or w.shape != (dt, k_out):
            raise ValueError("gather_project_sum: mismatched pair shapes")
    w_cat = torch.cat(list(ws), dim=0)  # [n_pairs * dt, K]
    out = torch.empty_like(stream)
    kind = build.check_tensors(
        "gather_project_sum", (stream, *tables, *ws), tuple(idxs),
        aligned=(stream, *tables, out)
    )
    tab_ptrs = (_P * n_pairs)(*(t.data_ptr() for t in tables))
    idx_ptrs = (_P * n_pairs)(*(i.data_ptr() for i in idxs))
    lib = build.load("gproj", _SIGNATURES)
    ptr = build.ptr
    if call_route(tables, stream) == "short":
        proj = stream.new_empty((n_pairs, n_src, k_out))
        err = getattr(lib, f"gproj_short_{kind}")(
            n_pairs, tab_ptrs, idx_ptrs, ptr(w_cat), ptr(stream), ptr(out),
            ptr(proj), n_rows, n_src, dt, k_out, build.stream(),
        )
    else:
        err = getattr(lib, f"gproj_{kind}")(
            n_pairs, tab_ptrs, idx_ptrs, ptr(w_cat), ptr(stream), ptr(out),
            n_rows, n_src, dt, k_out, build.stream(),
        )
    build.check(err, "gather_project_sum")
    gather_project_sum_kernel.launches += 1
    gather_project_sum_kernel.launches_bf16 += kind == "bf16"
    return out


gather_project_sum_kernel.launches = gather_project_sum_kernel.launches_bf16 = 0


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
