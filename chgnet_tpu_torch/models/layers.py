"""Message-passing layers over the directed edge and angle streams.

Port of the directed forms of ``chgnet_tpu.models.layers``:
:func:`atom_conv_apply` (``layers.py:164``), :func:`bond_conv_apply_directed`
(``:424``) and :func:`angle_update_apply_directed` (``:576``). Bond features
and weights live on the directed edge stream ([E, d], twin-duplicated);
angle rows are sorted by their directed bond i. Every first-layer sum goes
through the gather-project-sum kernel, the AtomConv edge -> atom and the
BondConv angle -> edge reductions through the CSR segment sum, and the
gated-MLP tails run as plain PyTorch (``fused_kernels=False``).
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from chgnet_tpu_torch.graph.batching import SegmentPlan
from chgnet_tpu_torch.models.functions import (
    Params,
    first_layer_acc,
    gated_mlp_init,
    gated_mlp_tail,
    layer_norm_apply,
    mlp_apply,
    mlp_init,
    norm_init,
)
from chgnet_tpu_torch.ops.segment import plan_segment_sum


def _layer_acc(gmlp: Params, parts) -> torch.Tensor:
    return first_layer_acc(gmlp["core"]["layers"], gmlp["gate"]["layers"], parts)


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
    bond_feas: torch.Tensor,  # [E, d_bond] directed
    weights_e: torch.Tensor,  # [E, d_atom] directed bond weights
    center: torch.Tensor,  # [E] i32 center atom per edge
    nbr: torch.Tensor,  # [E] i32 neighbor atom per edge
    edge_mask: torch.Tensor,  # [E]
    plan_center: SegmentPlan,
    plan_nbr: SegmentPlan,
    *,
    activation: str = "silu",
    resnet: bool = True,
) -> torch.Tensor:
    """Gated-MLP messages over directed edges, scaled by the bond weights,
    summed into their center atoms."""
    parts = [
        (atom_feas, center, plan_center),
        (bond_feas, None, None),
        (atom_feas, nbr, plan_nbr),
    ]
    gmlp = params["gated_mlp"]
    messages = gated_mlp_tail(gmlp, _layer_acc(gmlp, parts), activation=activation)
    messages = messages * weights_e * edge_mask[:, None]
    new_atom_feas = plan_segment_sum(messages, plan_center)
    return _finish(params, new_atom_feas, atom_feas, resnet)


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


def _angle_parts(bond_feas, angle_feas, atom_e, dir_i, dir_j, plan_i, plan_j):
    """First-layer blocks of the angle-side layers, in the upstream input
    order [bond_i, bond_j, angle, center atom]. The center atom of an angle
    row is its dir_i edge's center, so the atoms ride the edge stream
    (``atom_e``) and share dir_i's gather and backward segment sum."""
    return [
        (bond_feas, dir_i, plan_i),
        (bond_feas, dir_j, plan_j),
        (angle_feas, None, None),
        (atom_e, dir_i, plan_i),
    ]


def bond_conv_apply_directed(
    params: Params,
    atom_e: torch.Tensor,  # [E, d_atom] atom features on the edge stream
    bond_feas: torch.Tensor,  # [E, d_bond] directed
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
) -> torch.Tensor:
    """BondConv on the directed layout: per-angle updates summed into their
    dir_i edge, then each bond's total as ``partial + partial[twin]`` on
    both of its directed rows."""
    parts = _angle_parts(
        bond_feas, angle_feas, atom_e, dir_i, dir_j, plan_i, plan_j
    )
    gmlp = params["gated_mlp"]
    update = gated_mlp_tail(gmlp, _layer_acc(gmlp, parts), activation=activation)
    update = update * weights_a * angle_mask[:, None]
    partial = plan_segment_sum(update, plan_i)  # [A] -> [E]
    new_bond_feas = partial + involution_gather(partial, twin)
    return _finish(params, new_bond_feas, bond_feas, resnet)


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
) -> torch.Tensor:
    """Per-angle gated-MLP update on the directed layout (no reduction)."""
    parts = _angle_parts(
        bond_feas, angle_feas, atom_e, dir_i, dir_j, plan_i, plan_j
    )
    gmlp = params["gated_mlp"]
    new = gated_mlp_tail(gmlp, _layer_acc(gmlp, parts), activation=activation)
    return _finish(params, new, angle_feas, resnet)
