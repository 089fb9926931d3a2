"""Collectives over a mesh's process group, differentiable to any order.

``chgnet_tpu`` takes these from ``jax.lax`` inside ``shard_map``, where the
transpose rules come with them. Here each is a ``torch.autograd.Function``
whose backward calls its partner's ``apply``, as the port pairs segment
sums and gathers (``ops/segment.py``), so force training, which
differentiates the force backward, stays on these collectives at every
order:

* :func:`all_gather`: every rank's block along dim 0, concatenated in rank
  order (``jax.lax.all_gather(tiled=True)``); backward :func:`reduce_scatter`:
  every rank's cotangent summed into each owner's block;
* :func:`reduce_scatter`: the sum over ranks, each rank keeping its block;
  backward :func:`all_gather`. It is an all-to-all and a sum of the received
  blocks in rank order, so its result does not depend on the backend's
  reduction order;
* :func:`all_to_all`: block ``p`` of dim 0 to rank ``p``, block ``p`` of the
  result from rank ``p`` (``jax.lax.all_to_all(tiled=True)``, the halo
  exchange); backward the same exchange of the cotangent;
* :func:`sum_ranks`: the sum over ranks, the same on every rank, taken as
  the gathered blocks added in rank order so that no rank's copy differs by
  a rounding. Its backward passes the cotangent through: a value summed
  over ranks is replicated, so a replicated loss that every rank
  differentiates charges each rank with its own terms once, and the train
  step then sums the parameter gradients over ranks
  (:func:`all_reduce_grads`). The forward passes sum their energies and
  virials with it outside the differentiated graph, as ``chgnet_tpu``
  does (``graph_sharded.py:949-972``), so forces and stress are not
  counted D times.

Every rank must call the same collectives in the same order: the entry
points are SPMD, and the autograd engine visits identical graphs in the
same order on every rank.

NCCL takes CUDA tensors and gloo CPU tensors; the gloo of the torch the
card runs (2.11) also takes CUDA tensors in all-gather, all-to-all and
all-reduce, copying them through host memory itself
(``tools/time_mesh_exchange.py``), which is how two ranks share one card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from chgnet_tpu_torch.parallel.mesh import Mesh

# the all-gather's newer name, where this torch has it
_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def gather_blocks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order (no
    autograd)."""
    x = x.contiguous()
    out = x.new_empty((mesh.size * x.shape[0], *x.shape[1:]))
    _GATHER(out, x, group=mesh.group)
    return out


def _exchange(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x = x.contiguous()
    if x.shape[0] % mesh.size:
        raise ValueError(f"all_to_all: {x.shape[0]} rows over {mesh.size} ranks")
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    return out


def _scatter_blocks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    received = _exchange(x, mesh)
    return received.view(mesh.size, -1, *x.shape[1:]).sum(0)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather_blocks(x, mesh)

    @staticmethod
    def backward(ctx, ct):
        return _ReduceScatter.apply(ct, ctx.mesh), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _scatter_blocks(x, mesh)

    @staticmethod
    def backward(ctx, ct):
        return _AllGather.apply(ct, ctx.mesh), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _exchange(x, mesh)

    @staticmethod
    def backward(ctx, ct):
        return _AllToAll.apply(ct, ctx.mesh), None


class _SumRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        blocks = gather_blocks(x.reshape(1, *x.shape), mesh)
        return blocks.reshape(mesh.size, *x.shape).sum(0)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[D * n, ...]``: every rank's ``x [n, ...]`` in rank order."""
    return _AllGather.apply(x, mesh)


def reduce_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[n / D, ...]``: this rank's block of the sum over ranks of ``x``."""
    return _ReduceScatter.apply(x, mesh)


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[D * h, ...]``: block ``p`` from rank ``p``, where every rank sends
    its block ``p`` of ``x [D * h, ...]`` to rank ``p``."""
    return _AllToAll.apply(x, mesh)


def sum_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over ranks of ``x``, equal bit for bit on every rank; the
    backward passes the cotangent through (see the module's docstring)."""
    return _SumRanks.apply(x, mesh)


def max_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise maximum over ranks of ``x`` (no autograd)."""
    with torch.no_grad():
        return gather_blocks(x.reshape(1, *x.shape), mesh).amax(0)


def all_reduce_grads(tensors, mesh: Mesh, *, average: bool) -> None:
    """Sum (``average``: mean) over ranks of every tensor's ``.grad``, in
    place, as one flat buffer (one collective for the whole model)."""
    grads = [t.grad for t in tensors]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    if average:
        flat /= mesh.size
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()
