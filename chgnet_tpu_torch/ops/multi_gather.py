"""Multi-gather sum: the sum of several gathered tables and aligned streams.

    out[l] = sum_k T_k[idx_k[l]]  (+ stream[l])

:func:`gather_sum_rows` (``csrc/multi_gather.cu``) replaces
``chgnet_tpu/ops/stream_ops.py`` ``_multi_gather_kernel`` (:775,
``_multi_gather_pallas`` :878): up to 4 gathered parts of one width and an
optional aligned stream, added in f32 from zero in part order, the stream
last, so the kernel and :func:`gather_sum_rows_plain` agree bit for bit.
A row whose index lies outside its table adds zero, as in
:func:`~chgnet_tpu_torch.ops.segment.gather_rows`. bf16 rows
(``compute_dtype="bfloat16"``) are widened to f32, added in the same order
and rounded once, by the kernel and the plain version alike.

Two autograd ops sit on it, as in ``chgnet_tpu/ops/scatter.py``:

* :func:`gather_sum` (:438): parts ``(table, idx | None, plan)``. The
  backward (:380-432) hands an aligned part the cotangent itself and a
  gathered part the cotangent's segment sum over its plan, two plans of one
  size paired into one sweep.
* :func:`twin_reduce` (:499-535): ``partial[u2d] + partial[und_second]``,
  each bond's two directed partial sums. Every directed edge is the first or
  the second edge of exactly its own bond, so the backward is one row gather
  of the cotangent by ``d2u``.

Every backward is a planned gather or segment sum of
``chgnet_tpu_torch/ops/segment.py``, whose backwards call each other, so
all orders of derivative stay on the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from chgnet_tpu_torch.ops import build
from chgnet_tpu_torch.ops.segment import (
    gather_rows,
    gather_rows_plain,
    plan_gather,
    plan_segment_sum,
    plan_segment_sum_pair,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [
    _I, ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I), _P, _P,
    ctypes.c_long, _I, _P,
]
_SIGNATURES = {"gather_sum_rows_f32": _ARGS, "gather_sum_rows_bf16": _ARGS}
MAX_PARTS = 4  # gathered parts of one launch


@build.plain_in_f32
def gather_sum_rows_plain(tables, idxs, stream=None):
    """Plain version of :func:`gather_sum_rows`: zero, plus each part's
    gathered rows in order, plus the stream."""
    out = tables[0].new_zeros((idxs[0].shape[0], tables[0].shape[1]))
    for table, idx in zip(tables, idxs):
        out = out + gather_rows_plain(table, idx)
    return out if stream is None else out + stream


def gather_sum_rows(tables, idxs, stream=None):
    """``sum_k tables[k][idxs[k]] (+ stream)`` -> ``[L, d]``.

    ``tables[k]`` [S_k, d] f32 with ``d % 4 == 0``, ``idxs[k]`` [L] int32 (a
    zero row where out of range), ``stream`` [L, d] or None; 1 to 4 parts."""
    n_parts = len(tables)
    if not 1 <= n_parts <= MAX_PARTS or len(idxs) != n_parts:
        raise ValueError(
            f"gather_sum_rows: {n_parts} tables and {len(idxs)} index "
            f"streams (1..{MAX_PARTS} parts)"
        )
    n_rows, d = idxs[0].shape[0], tables[0].shape[1]
    if any(t.dim() != 2 or t.shape[1] != d for t in tables):
        raise ValueError(
            "gather_sum_rows: tables of one width expected, got "
            f"{[tuple(t.shape) for t in tables]}"
        )
    if any(i.shape != (n_rows,) for i in idxs) or (
        stream is not None and stream.shape != (n_rows, d)
    ):
        raise ValueError("gather_sum_rows: index streams and stream differ in rows")
    if not build.on_cuda(tables[0], "gather_sum_rows"):
        return gather_sum_rows_plain(tables, idxs, stream)
    if d % 4:
        raise ValueError(f"gather_sum_rows: d % 4 == 0 expected (d={d})")
    floats = (*tables, *(() if stream is None else (stream,)))
    out = tables[0].new_empty((n_rows, d))
    kind = build.check_tensors(
        "gather_sum_rows", floats, tuple(idxs), aligned=(*floats, out)
    )
    lib = build.load("multi_gather", _SIGNATURES)
    err = getattr(lib, f"gather_sum_rows_{kind}")(
        n_parts,
        (_P * n_parts)(*(t.data_ptr() for t in tables)),
        (_P * n_parts)(*(i.data_ptr() for i in idxs)),
        (_I * n_parts)(*(t.shape[0] for t in tables)),
        None if stream is None else build.ptr(stream), build.ptr(out),
        n_rows, d, build.stream(),
    )
    build.check(err, "gather_sum_rows")
    gather_sum_rows.launches += 1
    gather_sum_rows.launches_bf16 += kind == "bf16"
    return out


gather_sum_rows.launches = gather_sum_rows.launches_bf16 = 0


# ------------------------------------------------------------ autograd
def _sum_parts(tables, idxs):
    """The forward of :func:`gather_sum`: aligned parts summed into one
    stream, gathered parts through one :func:`gather_sum_rows` launch (which
    raises on more than ``MAX_PARTS``). When the kernel would absorb no add
    (fewer than two members, ``scatter.py:473-484``) or the rows are no
    ``float4`` units, each part is gathered by
    :func:`~chgnet_tpu_torch.ops.segment.gather_rows` and added in order."""
    gathered = [k for k, i in enumerate(idxs) if i is not None]
    aligned = [k for k, i in enumerate(idxs) if i is None]
    if tables[0].shape[1] % 4 or len(gathered) + min(len(aligned), 1) < 2:
        acc = None
        for table, idx in zip(tables, idxs):
            rows = table if idx is None else gather_rows(table, idx)
            acc = rows if acc is None else acc + rows
        return acc
    acc = None
    for k in aligned:
        acc = tables[k] if acc is None else acc + tables[k]
    return gather_sum_rows(
        [tables[k] for k in gathered], [idxs[k] for k in gathered], acc
    )


def cotangent_sums(ct, plans):
    """``[plan_segment_sum(ct, p) for p in plans]`` with two plans of one
    ``n_out`` taken in one sweep
    (``chgnet_tpu.ops.scatter.paired_cotangent_sums``); None stays None."""
    sums = [None] * len(plans)
    todo = [k for k, p in enumerate(plans) if p is not None]
    while todo:
        a = todo.pop(0)
        b = next((k for k in todo if plans[k].n_out == plans[a].n_out), None)
        if b is None:
            sums[a] = plan_segment_sum(ct, plans[a])
        else:
            todo.remove(b)
            sums[a], sums[b] = plan_segment_sum_pair(ct, plans[a], plans[b])
    return sums


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idxs, plans, *tables):
        ctx.plans = plans
        return _sum_parts([t.contiguous() for t in tables], idxs)

    @staticmethod
    def backward(ctx, ct):
        need = ctx.needs_input_grad[2:]
        plans = [p if n else None for p, n in zip(ctx.plans, need)]
        sums = cotangent_sums(ct.contiguous(), plans)
        grads = [
            (ct if p is None else s) if n else None
            for p, s, n in zip(ctx.plans, sums, need)
        ]
        return (None, None, *grads)


def gather_sum(parts) -> torch.Tensor:
    """``sum_k (table_k[idx_k] if idx_k is not None else table_k)``.

    ``parts``: ``(table [S_k, d], idx [L] int32 | None, plan)``, the plan's
    keys being ``idx`` with padded rows dropped (None with ``idx`` None)."""
    tables = [t for t, _, _ in parts]
    idxs = tuple(i for _, i, _ in parts)
    plans = tuple(p for _, _, p in parts)
    n_rows = next((i.shape[0] for i in idxs if i is not None), tables[0].shape[0])
    for table, idx, plan in parts:
        if table.shape[1] != tables[0].shape[1]:
            raise ValueError("gather_sum: parts of one width expected")
        if idx is None and table.shape[0] != n_rows:
            raise ValueError("gather_sum: an aligned part off the stream axis")
        if idx is not None and (plan is None or plan.n_out != table.shape[0]):
            raise ValueError("gather_sum: a gathered part needs its table's plan")
    return _GatherSum.apply(idxs, plans, *tables)


class _TwinReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, u2d, und_second, d2u, plan_d2u):
        ctx.back = (d2u, plan_d2u)
        partial = partial.contiguous()
        return _sum_parts([partial, partial], (u2d, und_second))

    @staticmethod
    def backward(ctx, ct):
        return plan_gather(ct, *ctx.back), None, None, None, None


def twin_reduce(partial, u2d, und_second, d2u, plan_d2u) -> torch.Tensor:
    """``partial[u2d] + partial[und_second]``: per-directed-edge partial sums
    ``[E, d]`` reduced to undirected bonds ``[U, d]``. The backward is
    ``ct[d2u]``; padded edges pick up their (in-range) padded bond's
    cotangent, which every consumer of ``partial`` masks or drops."""
    return _TwinReduce.apply(partial, u2d, und_second, d2u, plan_d2u)
