"""Data-parallel training: one batch a rank, gradients averaged over ranks.

Port of ``chgnet_tpu.parallel.dp``. There each device of a ``shard_map``
takes one slice of a stacked batch and ``pmean`` averages the gradients;
here each rank computes the loss of its own batch with
``loss_and_metrics(..., create_graph=True)``, and after the backward one
``all_reduce`` over a flat buffer of every gradient averages them, so
every rank takes the same optimizer step. DistributedDataParallel is not
used: its gradient hooks do not serve ``torch.autograd.grad`` with
``create_graph``, which the force loss needs. Batches need not share
capacities (nothing is stacked); :func:`stack_batches` and
:func:`stack_targets` remain as the host utilities ``chgnet_tpu`` has.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from chgnet_tpu_torch.graph.batching import GraphBatch, SegmentPlan
from chgnet_tpu_torch.models.chgnet import CHGNetConfig
from chgnet_tpu_torch.parallel import collectives as coll
from chgnet_tpu_torch.parallel.mesh import Mesh
from chgnet_tpu_torch.trainer.losses import CombinedLoss, loss_and_metrics

__all__ = [
    "loss_and_metrics",
    "make_dp_train_step",
    "make_single_device_train_step",
    "stack_batches",
    "stack_targets",
]


def _harmonize_plans(batches: Sequence[GraphBatch]) -> list[GraphBatch]:
    """Give every batch's plans the same fields: a plan whose gather
    windows (built under ``CHGNET_TPU_STREAM_V2``, behind a data-dependent
    span cap) are absent in one batch loses them in all, as
    ``chgnet_tpu`` degrades a plan's streaming fields."""
    out = list(batches)
    for name in GraphBatch._fields:
        plans = [getattr(b, name) for b in out]
        if not isinstance(plans[0], SegmentPlan):
            continue
        if len({p.window.shape[0] > 0 for p in plans}) > 1:
            bare = [p._replace(window=np.zeros(0, np.int32), window_rows=None) for p in plans]
            out = [b._replace(**{name: p}) for b, p in zip(out, bare)]
    return out


def stack_batches(batches: Sequence[GraphBatch]) -> GraphBatch:
    """Stack same-capacity host GraphBatches on a new leading device axis
    (a plan's ``window_rows`` becomes the largest of the batches')."""
    batches = _harmonize_plans(batches)

    def leaves(b):
        for field in b:
            if isinstance(field, SegmentPlan):
                yield from field[:4]
            else:
                yield field

    first = list(leaves(batches[0]))
    for b in batches[1:]:
        if any(np.shape(x) != np.shape(y) for x, y in zip(first, leaves(b))):
            raise ValueError("all stacked batches must share capacities")
    fields = []
    for name in GraphBatch._fields:
        vals = [getattr(b, name) for b in batches]
        if isinstance(vals[0], SegmentPlan):
            rows = [p.window_rows for p in vals]
            fields.append(SegmentPlan(
                *(np.stack(xs) for xs in zip(*(p[:4] for p in vals))),
                window_rows=None if rows[0] is None else max(rows),
            ))
        else:
            fields.append(np.stack(vals))
    return GraphBatch(*fields)


def stack_targets(targets: Sequence[dict]) -> dict:
    return {key: np.stack([t[key] for t in targets]) for key in targets[0]}


def dropout_generator(step: int, rank: int, seed: int = 0) -> torch.Generator:
    """A CPU generator seeded from (seed, step, rank): independent dropout
    masks across ranks, as ``chgnet_tpu`` folds the axis index into the
    step's key (``dp.py:111-113``)."""
    mixed = np.random.SeedSequence([seed, step, rank]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))


def _leaves(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def _fill_missing_grads(leaves) -> None:
    """A leaf the loss does not reach gets a zero gradient, as under
    ``jax.grad``."""
    for leaf in leaves:
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)


def make_dp_train_step(
    *,
    config: CHGNetConfig,
    loss_fn: CombinedLoss,
    optimizer: torch.optim.Optimizer,
    mesh: Mesh,
):
    """A data-parallel train step, called by every rank with its own batch.

    Step signature: ``step(params, batch, targets, step) -> metrics``;
    ``batch`` and ``targets`` this rank's, as tensors on ``mesh.device``,
    ``optimizer`` over the trainable leaves of ``params``. The gradients
    and the metrics are averaged over ranks. ``step`` seeds the dropout
    generator with the rank (:func:`dropout_generator`)."""
    use_dropout = float(config.conv_dropout) > 0 or float(config.mlp_dropout) > 0
    leaves = _leaves(optimizer)

    def step(params, batch, targets, step: int):
        gen = dropout_generator(int(step), mesh.rank) if use_dropout else None
        loss, metrics = loss_and_metrics(
            params, batch, targets, config=config, loss_fn=loss_fn,
            dropout_generator=gen, create_graph=True,
        )
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _fill_missing_grads(leaves)
        coll.all_reduce_grads(leaves, mesh, average=True)
        optimizer.step()
        with torch.no_grad():
            return {
                k: coll.sum_ranks(v.detach().float(), mesh) / mesh.size
                for k, v in metrics.items()
            }

    return step


def make_single_device_train_step(
    *,
    config: CHGNetConfig,
    loss_fn: CombinedLoss,
    optimizer: torch.optim.Optimizer,
):
    """The same step on one device: ``step(params, batch, targets) ->
    metrics``."""
    leaves = _leaves(optimizer)

    def step(params, batch, targets):
        loss, metrics = loss_and_metrics(
            params, batch, targets, config=config, loss_fn=loss_fn,
            create_graph=True,
        )
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _fill_missing_grads(leaves)
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step
