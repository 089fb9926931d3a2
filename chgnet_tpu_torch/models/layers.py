"""Message-passing layers over the directed edge and angle streams.

Port of ``chgnet_tpu.models.layers``: :func:`atom_conv_apply`
(``layers.py:164``), :func:`atom_conv_dense_apply` (``:259``, the dense
per-atom slots of ``CHGNetConfig.dense_atom_conv``),
:func:`bond_conv_apply_directed` (``:424``) and
:func:`angle_update_apply_directed` (``:576``), in both bond layouts. Angle
rows are sorted by their directed bond i in both. The forms over
undirected bond tables, :func:`bond_conv_apply` (``:362``) and
:func:`angle_update_apply` (``:668``), gather every part from an atom or
bond table by its own index stream; only the graph-sharded core
(``parallel/graph_sharded.py``) calls them, on its exchanged tables.

* Directed (``CHGNetConfig.directed_bonds``, the default): bond features
  and weights live on the directed edge stream ([E, d], twin-duplicated).
  Every first-layer sum goes through the gather-project-sum kernel, and a
  bond's total is ``partial + partial[twin]``.
* Undirected (``und`` given, upstream CHGNet's layout): they live on the
  undirected bonds ([U, d]). AtomConv gathers its bond part by ``d2u``, so
  its first-layer sum projects each table and goes through the multi-gather
  kernel; the angle-side layers expand ``bond_dir = bond_feas[d2u]`` once
  and then run as in the directed layout; a bond's total is
  :func:`~chgnet_tpu_torch.ops.multi_gather.twin_reduce` of its two
  directed partial sums.

The AtomConv edge -> atom and the BondConv angle -> edge reductions go
through the CSR segment sum. With ``fused`` (``CHGNetConfig.fused_kernels``,
the default) the gated-MLP tails of a fusable config run through the fused
tail kernels (``ops/gated_message.py``), as in ``chgnet_tpu``, the message
tail together with its reduction when
:func:`~chgnet_tpu_torch.ops.gated_message.msg_reduce_ok` says so;
otherwise they run as plain PyTorch. With ``CHGNET_TPU_FUSED_PASS`` set the
fused layers project every part first and run the first-layer sum and the
tail in one kernel (:func:`_fused_layer`, ``ops/fused_pass.py``).
"""

from __future__ import annotations

import os
from collections.abc import Sequence
from typing import NamedTuple

import numpy as np
import torch

from chgnet_tpu_torch.graph.batching import SegmentPlan
from chgnet_tpu_torch.models.functions import (
    Params,
    block_generator,
    first_layer_acc,
    gated_mlp_fusable,
    gated_mlp_fused_pack,
    gated_mlp_init,
    gated_mlp_tail,
    gated_mlp_update_fusable,
    layer_norm_apply,
    mlp_apply,
    mlp_init,
    norm_init,
    project_parts_fold,
)
from chgnet_tpu_torch.ops.fused_pass import fused_layer_pass
from chgnet_tpu_torch.ops.gated_message import (
    fused_gated_message,
    fused_gated_message_reduce,
    fused_gated_update,
    msg_reduce_ok,
)
from chgnet_tpu_torch.ops.multi_gather import twin_reduce
from chgnet_tpu_torch.ops.segment import plan_gather, plan_segment_sum

# the fused tails have no dropout: a layer whose dropout is on runs its
# tail as plain PyTorch (chgnet_tpu.models.layers :222-223, :396-397,
# :523-524, :621-622, :691-692)


class UndirectedMaps(NamedTuple):
    """The maps between the directed edge stream [E] and the undirected
    bonds [U] that the undirected bond layout gathers by."""

    d2u: torch.Tensor  # [E] i32 bond of every directed edge
    plan_d2u: SegmentPlan
    u2d: torch.Tensor  # [U] i32 first directed edge of every bond
    und_second: torch.Tensor  # [U] i32 its second directed edge


def _layer_acc(gmlp: Params, parts) -> torch.Tensor:
    return first_layer_acc(gmlp["core"]["layers"], gmlp["gate"]["layers"], parts)


def _fused_layer(gmlp: Params, parts, fold=None, *, weights=None, mask=None,
                 resnet=None):
    """A conv layer's first-layer sum and fused tail
    (``chgnet_tpu.models.layers._fused_layer`` :72): with
    ``CHGNET_TPU_FUSED_PASS`` set, every part projected first (``fold``: see
    :func:`~chgnet_tpu_torch.models.functions.project_parts_fold`) and the
    one-kernel pass; else the first-layer accumulator and then the tail
    kernel. ``weights`` selects the message form, ``resnet`` the update."""
    p2 = gated_mlp_fused_pack(gmlp)
    if os.environ.get("CHGNET_TPU_FUSED_PASS"):
        projected, b1 = project_parts_fold(
            gmlp["core"]["layers"], gmlp["gate"]["layers"], parts, fold
        )
        return fused_layer_pass(
            projected, b1, p2, weights=weights, mask=mask, resnet=resnet
        )
    acc = _layer_acc(gmlp, parts)
    if weights is not None:
        return fused_gated_message(acc, weights, mask, p2)
    return fused_gated_update(acc, resnet, p2)


def _fused_message_sum(
    gmlp: Params, parts, weights, mask, plan: SegmentPlan, fold=None
):
    """A message layer through the fused kernels: the gated MLP's message
    tail ``* weights * mask`` summed over ``plan``, in one sweep when
    ``msg_reduce_ok`` (``chgnet_tpu.models.layers`` :224-233, :525-536),
    else :func:`_fused_layer` and then the segment sum."""
    if msg_reduce_ok(plan):
        return fused_gated_message_reduce(
            _layer_acc(gmlp, parts), weights, mask, gated_mlp_fused_pack(gmlp),
            plan,
        )
    return plan_segment_sum(
        _fused_layer(gmlp, parts, fold, weights=weights, mask=mask), plan
    )


def _dropout_generator(rate: float, seed: int | None, like: torch.Tensor):
    """The layer's dropout generator, None when dropout is off."""
    return block_generator(seed, like.device) if rate > 0.0 else None


def _finish(params: Params, new: torch.Tensor, old: torch.Tensor, resnet: bool):
    if "mlp_out" in params:
        new = mlp_apply(params["mlp_out"], new)
    if resnet:
        new = new + old
    if "norm" in params:
        new = layer_norm_apply(params["norm"], new)
    return new


class _InvolutionGather(torch.autograd.Function):
    """``x[inv]`` for a self-inverse permutation: the backward is the same
    gather (``chgnet_tpu.ops.scatter.involution_gather``)."""

    @staticmethod
    def forward(ctx, x, inv):
        ctx.inv = inv
        return torch.index_select(x, 0, inv)

    @staticmethod
    def backward(ctx, ct):
        return _InvolutionGather.apply(ct, ctx.inv), None


def involution_gather(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    return _InvolutionGather.apply(x, inv)


# ------------------------------------------------------------------ AtomConv
def atom_conv_init(
    rng: np.random.Generator,
    *,
    atom_fea_dim: int,
    bond_fea_dim: int,
    hidden_dim: int | Sequence[int] = 64,
    norm: str | None = None,
    gmlp_norm: str | None = "layer",
    mlp_out_bias: bool = False,
) -> Params:
    params: Params = {
        "gated_mlp": gated_mlp_init(
            rng,
            2 * atom_fea_dim + bond_fea_dim,
            atom_fea_dim,
            hidden_dim=hidden_dim,
            norm=gmlp_norm,
        ),
        "mlp_out": mlp_init(
            rng, atom_fea_dim, output_dim=atom_fea_dim, hidden_dim=0,
            bias=mlp_out_bias,
        ),
    }
    ln = norm_init(norm, atom_fea_dim)
    if ln is not None:
        params["norm"] = ln
    return params


def atom_conv_apply(
    params: Params,
    atom_feas: torch.Tensor,  # [N, d_atom]
    bond_feas: torch.Tensor,  # [E, d_bond] directed, or [U, d_bond] with und
    weights_e: torch.Tensor,  # [E, d_atom] bond weights on the edge stream
    center: torch.Tensor,  # [E] i32 center atom per edge
    nbr: torch.Tensor,  # [E] i32 neighbor atom per edge
    edge_mask: torch.Tensor,  # [E]
    plan_center: SegmentPlan,
    plan_nbr: SegmentPlan,
    *,
    activation: str = "silu",
    resnet: bool = True,
    fused: bool = False,
    und: UndirectedMaps | None = None,
    dropout: float = 0.0,
    seed: int | None = None,
    nbr_part: tuple | None = None,
) -> torch.Tensor:
    """Gated-MLP messages over directed edges, scaled by the bond weights,
    summed into their center atoms. With ``und`` the bond features are
    gathered from the undirected bonds by ``d2u``. ``seed`` turns dropout
    at rate ``dropout`` on (:func:`~chgnet_tpu_torch.models.functions.
    block_generator`). ``nbr_part`` (a halo-tiled batch: the expanded atom
    table, ``nbr_x`` and ``plan_nbr_x``) takes the place of the neighbour
    part ``(atom_feas, nbr, plan_nbr)``; its table's length differs from
    the atoms', so the first-layer sum projects each table first
    (``chgnet_tpu.models.layers`` :198-204)."""
    bond_part = (
        (bond_feas, None, None) if und is None
        else (bond_feas, und.d2u, und.plan_d2u)
    )
    parts = [
        (atom_feas, center, plan_center),
        bond_part,
        nbr_part if nbr_part is not None else (atom_feas, nbr, plan_nbr),
    ]
    gmlp = params["gated_mlp"]
    gen = _dropout_generator(dropout, seed, atom_feas)
    if fused and gen is None and gated_mlp_fusable(gmlp, activation):
        new_atom_feas = _fused_message_sum(
            gmlp, parts, weights_e, edge_mask, plan_center
        )
    else:
        messages = gated_mlp_tail(
            gmlp, _layer_acc(gmlp, parts), activation=activation,
            dropout=dropout, generator=gen,
        )
        messages = messages * weights_e * edge_mask[:, None]
        new_atom_feas = plan_segment_sum(messages, plan_center)
    return _finish(params, new_atom_feas, atom_feas, resnet)


def atom_conv_dense_apply(
    params: Params,
    atom_feas: torch.Tensor,  # [N, d_atom]
    bond_feas: torch.Tensor,  # [U, d_bond] undirected bonds
    bond_weights: torch.Tensor,  # [U, d_atom]
    dense_nbr: torch.Tensor,  # [N, K] i32
    dense_bond: torch.Tensor,  # [N, K] i32
    dense_mask: torch.Tensor,  # [N, K]
    plan_center: SegmentPlan,  # each slot's own atom -> atoms
    plan_nbr: SegmentPlan,  # dense_nbr flattened -> atoms
    plan_bond: SegmentPlan,  # dense_bond flattened -> bonds
    *,
    activation: str = "silu",
    resnet: bool = True,
) -> torch.Tensor:
    """AtomConv over the dense per-atom slots
    (``chgnet_tpu.models.layers.atom_conv_dense_apply`` :259): the centre,
    neighbour and bond parts of the joint first Linear projected on their
    tables, the ``[N, K, 2D]`` sum ``p_center[:, None] + p_nbr[dense_nbr] +
    p_bond[dense_bond]`` (+ b1), the gated MLP's tail, the message times
    ``bond_weights[dense_bond]`` times the mask, and a sum over K in place
    of the segment sum. Plain PyTorch, as ``chgnet_tpu`` runs it without a
    Pallas kernel, but for the gathers: the neighbour, bond and weight rows,
    and the centre rows in place of the broadcast, go through the slots'
    plans (:func:`plan_gather`: the gather kernel, whose backward is a
    planned segment sum), so that the backward adds in a fixed order where
    ``index_select``'s sums with float atomics on the card, and every sum
    over a table's slots is the planned one the CSR layout takes. The
    gathers copy rows, so the forward is ``chgnet_tpu``'s value for
    value."""
    gmlp = params["gated_mlp"]
    layers_c = gmlp["core"]["layers"]
    layers_g = gmlp["gate"]["layers"]
    d_atom = atom_feas.shape[1]
    d_bond = bond_feas.shape[1]
    n_atoms, k_slots = dense_nbr.shape
    first_w = torch.cat([layers_c[0]["w"], layers_g[0]["w"]], dim=1)
    p_center = atom_feas @ first_w[:d_atom]  # [N, 2D]
    p_bond = bond_feas @ first_w[d_atom: d_atom + d_bond]  # [U, 2D]
    p_nbr = atom_feas @ first_w[d_atom + d_bond:]  # [N, 2D]
    nbr_flat = dense_nbr.reshape(-1)
    bond_flat = dense_bond.reshape(-1)
    center_flat = torch.arange(
        n_atoms, dtype=torch.int32, device=dense_nbr.device
    ).repeat_interleave(k_slots)
    acc = (
        plan_gather(p_center, center_flat, plan_center)
        + plan_gather(p_nbr, nbr_flat, plan_nbr)
        + plan_gather(p_bond, bond_flat, plan_bond)
    ).reshape(n_atoms, k_slots, -1)
    if "b" in layers_c[0]:
        acc = acc + torch.cat([layers_c[0]["b"], layers_g[0]["b"]])
    messages = gated_mlp_tail(
        gmlp, acc.reshape(n_atoms * k_slots, -1), activation=activation
    )
    messages = messages * plan_gather(bond_weights, bond_flat, plan_bond)
    messages = messages.reshape(n_atoms, k_slots, -1) * dense_mask[..., None]
    return _finish(params, messages.sum(dim=1), atom_feas, resnet)


# ------------------------------------------------------------------ BondConv
def bond_conv_init(
    rng: np.random.Generator,
    *,
    atom_fea_dim: int,
    bond_fea_dim: int,
    angle_fea_dim: int,
    hidden_dim: int | Sequence[int] = 64,
    norm: str | None = None,
    gmlp_norm: str | None = "layer",
    mlp_out_bias: bool = False,
) -> Params:
    params: Params = {
        "gated_mlp": gated_mlp_init(
            rng,
            atom_fea_dim + 2 * bond_fea_dim + angle_fea_dim,
            bond_fea_dim,
            hidden_dim=hidden_dim,
            norm=gmlp_norm,
        ),
        "mlp_out": mlp_init(
            rng, bond_fea_dim, output_dim=bond_fea_dim, hidden_dim=0,
            bias=mlp_out_bias,
        ),
    }
    ln = norm_init(norm, bond_fea_dim)
    if ln is not None:
        params["norm"] = ln
    return params


def _bond_dir(bond_feas, und: UndirectedMaps | None):
    """Bond features on the directed edge stream [E, d]: as they are, or
    the undirected table expanded by ``d2u``, once per layer."""
    if und is None:
        return bond_feas
    return plan_gather(bond_feas, und.d2u, und.plan_d2u)


# the atom part of the angle-side layers shares dir_i's index stream and
# plan with the first bond part: projected, the two tables add before the
# gather (chgnet_tpu.models.layers :503, :613)
ANGLE_FOLD = {3: 0}


def _angle_parts(bond_dir, angle_feas, atom_e, dir_i, dir_j, plan_i, plan_j):
    """First-layer blocks of the angle-side layers, in the upstream input
    order [bond_i, bond_j, angle, center atom]. The center atom of an angle
    row is its dir_i edge's center, so the atoms ride the edge stream
    (``atom_e``) and share dir_i's gather and backward segment sum."""
    return [
        (bond_dir, dir_i, plan_i),
        (bond_dir, dir_j, plan_j),
        (angle_feas, None, None),
        (atom_e, dir_i, plan_i),
    ]


def bond_conv_apply_directed(
    params: Params,
    atom_e: torch.Tensor,  # [E, d_atom] atom features on the edge stream
    bond_feas: torch.Tensor,  # [E, d_bond] directed, or [U, d_bond] with und
    weights_a: torch.Tensor,  # [A, d_bond] w[dir_i] * w[dir_j]
    angle_feas: torch.Tensor,  # [A, d_angle]
    dir_i: torch.Tensor,  # [A] i32, rows sorted by it
    dir_j: torch.Tensor,  # [A] i32
    twin: torch.Tensor,  # [E] reverse-edge involution
    angle_mask: torch.Tensor,  # [A]
    plan_i: SegmentPlan,
    plan_j: SegmentPlan,
    *,
    activation: str = "silu",
    resnet: bool = True,
    fused: bool = False,
    und: UndirectedMaps | None = None,
    dropout: float = 0.0,
    seed: int | None = None,
) -> torch.Tensor:
    """BondConv over the dir_i-sorted angle stream: per-angle updates summed
    into their dir_i edge, then each bond's total: ``partial +
    partial[twin]`` on both of its directed rows or, with ``und``, the
    ``twin_reduce`` of its two directed partial sums on its undirected
    row."""
    parts = _angle_parts(
        _bond_dir(bond_feas, und), angle_feas, atom_e, dir_i, dir_j, plan_i,
        plan_j,
    )
    gmlp = params["gated_mlp"]
    gen = _dropout_generator(dropout, seed, angle_feas)
    if fused and gen is None and gated_mlp_fusable(gmlp, activation):
        partial = _fused_message_sum(
            gmlp, parts, weights_a, angle_mask, plan_i, ANGLE_FOLD
        )
    else:
        update = gated_mlp_tail(
            gmlp, _layer_acc(gmlp, parts), activation=activation,
            dropout=dropout, generator=gen,
        )
        update = update * weights_a * angle_mask[:, None]
        partial = plan_segment_sum(update, plan_i)  # [A] -> [E]
    if und is None:
        new_bond_feas = partial + involution_gather(partial, twin)
    else:
        new_bond_feas = twin_reduce(
            partial, und.u2d, und.und_second, und.d2u, und.plan_d2u
        )
    return _finish(params, new_bond_feas, bond_feas, resnet)


def _table_parts(atom_feas, bond_feas, angle_feas, center, bond_i, bond_j, plans):
    """First-layer blocks of the angle-side layers over undirected bond
    tables, in the upstream input order [bond_i, bond_j, angle, center
    atom]; ``plans`` = (bond_i, bond_j, center) plans of the tables."""
    p_bi, p_bj, p_c = plans
    return [
        (bond_feas, bond_i, p_bi),
        (bond_feas, bond_j, p_bj),
        (angle_feas, None, None),
        (atom_feas, center, p_c),
    ]


def bond_conv_apply(
    params: Params,
    atom_feas: torch.Tensor,  # [N, d_atom] atom table
    bond_feas: torch.Tensor,  # [U, d_bond] undirected bond table
    weights_a: torch.Tensor,  # [A, d_bond] w[bond_i] * w[bond_j]
    angle_feas: torch.Tensor,  # [A, d_angle]
    center: torch.Tensor,  # [A] i32 center atom of each angle row
    bond_i: torch.Tensor,  # [A] i32 undirected bond i
    bond_j: torch.Tensor,  # [A] i32 undirected bond j
    angle_mask: torch.Tensor,  # [A]
    plans: tuple,  # (bond_i, bond_j, center) SegmentPlans
    *,
    activation: str = "silu",
    resnet: bool = True,
    fused: bool = False,
    dropout: float = 0.0,
    seed: int | None = None,
) -> torch.Tensor:
    """BondConv over undirected bond tables
    (``chgnet_tpu.models.layers.bond_conv_apply`` :362), the form the
    graph-sharded core runs on its exchanged tables: per-angle updates,
    scaled by ``weights_a`` and the mask, summed into their bond i over
    ``plans[0]`` (``[plans[0].n_out, d]``, the bond table's rows). The
    fused tail never fuses with its sum here, as in ``chgnet_tpu``."""
    parts = _table_parts(
        atom_feas, bond_feas, angle_feas, center, bond_i, bond_j, plans
    )
    gmlp = params["gated_mlp"]
    gen = _dropout_generator(dropout, seed, angle_feas)
    if fused and gen is None and gated_mlp_fusable(gmlp, activation):
        update = _fused_layer(gmlp, parts, weights=weights_a, mask=angle_mask)
    else:
        update = gated_mlp_tail(
            gmlp, _layer_acc(gmlp, parts), activation=activation,
            dropout=dropout, generator=gen,
        )
        update = update * weights_a * angle_mask[:, None]
    return _finish(params, plan_segment_sum(update, plans[0]), bond_feas, resnet)


# --------------------------------------------------------------- AngleUpdate
def angle_update_init(
    rng: np.random.Generator,
    *,
    atom_fea_dim: int,
    bond_fea_dim: int,
    angle_fea_dim: int,
    hidden_dim: int | Sequence[int] = 0,
    norm: str | None = None,
    gmlp_norm: str | None = "layer",
) -> Params:
    params: Params = {
        "gated_mlp": gated_mlp_init(
            rng,
            atom_fea_dim + 2 * bond_fea_dim + angle_fea_dim,
            angle_fea_dim,
            hidden_dim=hidden_dim,
            norm=gmlp_norm,
        )
    }
    ln = norm_init(norm, angle_fea_dim)
    if ln is not None:
        params["norm"] = ln
    return params


def angle_update_apply_directed(
    params: Params,
    atom_e: torch.Tensor,
    bond_feas: torch.Tensor,
    angle_feas: torch.Tensor,
    dir_i: torch.Tensor,
    dir_j: torch.Tensor,
    plan_i: SegmentPlan,
    plan_j: SegmentPlan,
    *,
    activation: str = "silu",
    resnet: bool = True,
    fused: bool = False,
    und: UndirectedMaps | None = None,
    dropout: float = 0.0,
    seed: int | None = None,
) -> torch.Tensor:
    """Per-angle gated-MLP update over the dir_i-sorted angle stream (no
    reduction); ``bond_feas`` [E, d] directed, or [U, d] with ``und``."""
    parts = _angle_parts(
        _bond_dir(bond_feas, und), angle_feas, atom_e, dir_i, dir_j, plan_i,
        plan_j,
    )
    gmlp = params["gated_mlp"]
    gen = _dropout_generator(dropout, seed, angle_feas)
    if (
        fused
        and gen is None
        and resnet
        and "norm" not in params
        and gated_mlp_update_fusable(gmlp, activation)
    ):
        return _fused_layer(gmlp, parts, ANGLE_FOLD, resnet=angle_feas)
    new = gated_mlp_tail(
        gmlp, _layer_acc(gmlp, parts), activation=activation, dropout=dropout,
        generator=gen,
    )
    return _finish(params, new, angle_feas, resnet)


def angle_update_apply(
    params: Params,
    atom_feas: torch.Tensor,  # [N, d_atom] atom table
    bond_feas: torch.Tensor,  # [U, d_bond] undirected bond table
    angle_feas: torch.Tensor,  # [A, d_angle]
    center: torch.Tensor,
    bond_i: torch.Tensor,
    bond_j: torch.Tensor,
    plans: tuple,  # (bond_i, bond_j, center) SegmentPlans
    *,
    activation: str = "silu",
    resnet: bool = True,
    fused: bool = False,
    dropout: float = 0.0,
    seed: int | None = None,
) -> torch.Tensor:
    """Per-angle gated-MLP update over undirected bond tables, no
    reduction (``chgnet_tpu.models.layers.angle_update_apply`` :668)."""
    parts = _table_parts(
        atom_feas, bond_feas, angle_feas, center, bond_i, bond_j, plans
    )
    gmlp = params["gated_mlp"]
    gen = _dropout_generator(dropout, seed, angle_feas)
    if (
        fused
        and gen is None
        and resnet
        and "norm" not in params
        and gated_mlp_update_fusable(gmlp, activation)
    ):
        return _fused_layer(gmlp, parts, resnet=angle_feas)
    new = gated_mlp_tail(
        gmlp, _layer_acc(gmlp, parts), activation=activation, dropout=dropout,
        generator=gen,
    )
    return _finish(params, new, angle_feas, resnet)


# ------------------------------------------------------------------ readout
def attention_readout_init(
    rng: np.random.Generator,
    atom_fea_dim: int,
    *,
    num_heads: int = 3,
    hidden_dim: int = 32,
) -> Params:
    """Multi-head attention pooling
    (``chgnet_tpu.models.layers.attention_readout_init`` :726): the same
    draws in the same order."""
    return {
        "key": mlp_init(
            rng, atom_fea_dim, output_dim=num_heads, hidden_dim=hidden_dim
        )
    }


def attention_readout_apply(
    params: Params,
    atom_feas: torch.Tensor,  # [N, d]
    atom_owner: torch.Tensor,  # [N] i32 graph of every atom
    atom_mask: torch.Tensor,  # [N]
    plan_graph: SegmentPlan,
    *,
    average: bool = False,
    activation: str = "silu",
) -> torch.Tensor:
    """Per-graph softmax over atoms for each head, then the heads' weighted
    sums of the atom features -> ``[B, H * d]``
    (``chgnet_tpu.models.layers.attention_readout_apply`` :742). The
    per-graph maximum only shifts the softmax, so it is taken without a
    gradient (the result and its derivatives do not depend on it); the
    sums run over ``plan_graph``, one head at a time (rows of ``d``)."""
    logits = mlp_apply(params["key"], atom_feas, activation=activation)  # [N, H]
    n_graphs, n_heads = plan_graph.n_out, logits.shape[1]
    valid = atom_mask[:, None] > 0
    masked = torch.where(valid, logits, logits.new_full((), -1e30))
    owner = atom_owner.long()
    with torch.no_grad():
        seg_max = masked.new_full((n_graphs, n_heads), -1e30).scatter_reduce(
            0, owner[:, None].expand(-1, n_heads), masked, "amax"
        )
    expv = torch.exp(masked - seg_max[owner]) * atom_mask[:, None]
    denom = plan_segment_sum(expv, plan_graph)  # [B, H]
    weight = expv / torch.clamp(plan_gather(denom, atom_owner, plan_graph), min=1e-30)
    pooled = torch.cat(
        [plan_segment_sum(atom_feas * weight[:, h: h + 1], plan_graph)
         for h in range(n_heads)],
        dim=1,
    )  # [B, H * d]
    if average:
        counts = plan_segment_sum(atom_mask[:, None], plan_graph)
        pooled = pooled / torch.clamp(counts, min=1.0)
    return pooled
