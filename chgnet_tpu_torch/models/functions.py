"""Neural-net primitives as plain functions over parameter dicts.

Port of ``chgnet_tpu.models.functions``: every block is an ``init`` (a dict
of numpy arrays drawn from ``np.random.default_rng``, in the same order as
``chgnet_tpu``) and an ``apply`` over the same dict holding tensors, so one
seed gives bit-identical weights in both packages. Layouts (weights
``[in, out]``, the core|gate lane packing of the gated MLP) match
``chgnet_tpu``.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from chgnet_tpu_torch.ops.gproj import gather_project_sum
from chgnet_tpu_torch.ops.multi_gather import gather_sum

Params = dict


# -------------------------------------------------------------- activations
def scaled_silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x) * (1.0 / 0.6)


ACTIVATIONS = {
    "relu": F.relu,
    "silu": F.silu,
    "scaledsilu": scaled_silu,
    "gelu": F.gelu,
    "softplus": F.softplus,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


def find_activation(name: str):
    try:
        return ACTIVATIONS[name.lower()]
    except KeyError as exc:
        raise NotImplementedError(f"activation {name!r}") from exc


# ------------------------------------------------------------------ linear
def linear_init(
    rng: np.random.Generator, in_dim: int, out_dim: int, *, bias: bool = True
) -> Params:
    """Torch-default Linear init: U(-1/sqrt(in), 1/sqrt(in)) for w and b.
    Weights stored [in, out] (x @ w convention)."""
    bound = 1.0 / np.sqrt(in_dim)
    params = {"w": rng.uniform(-bound, bound, (in_dim, out_dim)).astype(np.float32)}
    if bias:
        params["b"] = rng.uniform(-bound, bound, (out_dim,)).astype(np.float32)
    return params


def linear_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    out = x @ params["w"]
    if "b" in params:
        out = out + params["b"]
    return out


# --------------------------------------------------------------- layer norm
def layer_norm_init(dim: int) -> Params:
    return {
        "scale": np.ones(dim, dtype=np.float32),
        "bias": np.zeros(dim, dtype=np.float32),
    }


def batch_norm_init(dim: int) -> Params:
    """BatchNorm1d parameters at inference (identity running statistics)."""
    return {
        "scale": np.ones(dim, dtype=np.float32),
        "bias": np.zeros(dim, dtype=np.float32),
        "mean": np.zeros(dim, dtype=np.float32),
        "var": np.ones(dim, dtype=np.float32),
    }


def layer_norm_apply(params: Params, x: torch.Tensor, *, eps: float = 1e-5):
    if "mean" in params:  # batch norm with stored statistics
        out = (x - params["mean"]) * torch.rsqrt(params["var"] + eps)
        return out * params["scale"] + params["bias"]
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    return out * params["scale"] + params["bias"]


def norm_init(name: str | None, dim: int) -> Params | None:
    if name is None:
        return None
    if name.lower() == "layer":
        return layer_norm_init(dim)
    if name.lower() == "batch":
        return batch_norm_init(dim)
    raise NotImplementedError(f"normalization {name!r}")


# -------------------------------------------------------------------- MLP
def mlp_init(
    rng: np.random.Generator,
    input_dim: int,
    *,
    output_dim: int = 1,
    hidden_dim: int | Sequence[int] | None = (64, 64),
    bias: bool = True,
) -> Params:
    """MLP of upstream CHGNet's layout: hidden None/0 -> one Linear; int ->
    one hidden layer; sequence -> stacked hidden layers."""
    if hidden_dim is None or hidden_dim == 0:
        dims = [input_dim, output_dim]
    elif isinstance(hidden_dim, int):
        dims = [input_dim, hidden_dim, output_dim]
    else:
        dims = [input_dim, *hidden_dim, output_dim]
    return {
        "layers": [
            linear_init(rng, dims[i], dims[i + 1], bias=bias)
            for i in range(len(dims) - 1)
        ]
    }


def dropout_apply(
    x: torch.Tensor, rate: float, generator: torch.Generator | None
) -> torch.Tensor:
    """Inverted dropout (``chgnet_tpu.models.functions.dropout_apply``): each
    element kept with probability ``1 - rate`` and scaled by its inverse,
    the mask drawn from ``generator`` (on ``x``'s device). Rate 0 or no
    generator (eval mode) returns ``x`` itself."""
    if rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, x.new_zeros(()))


def block_generator(seed: int | None, device) -> torch.Generator | None:
    """A generator on ``device`` seeded with ``seed`` (None for None): one per
    layer, made inside the layer, so that a rematerialized layer draws the
    same mask again."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def mlp_apply(
    params: Params,
    x: torch.Tensor,
    *,
    activation: str = "silu",
    dropout: float = 0.0,
    generator: torch.Generator | None = None,
):
    """Upstream CHGNet's MLP layout: dropout sits before the last Linear,
    active only with a ``generator``."""
    act = find_activation(activation)
    layers = params["layers"]
    for layer in layers[:-1]:
        x = act(linear_apply(layer, x))
    x = dropout_apply(x, dropout, generator)
    return linear_apply(layers[-1], x)


# ---------------------------------------------------------------- GatedMLP
def gated_mlp_init(
    rng: np.random.Generator,
    input_dim: int,
    output_dim: int,
    *,
    hidden_dim: int | Sequence[int] | None = None,
    norm: str | None = "layer",
    bias: bool = True,
) -> Params:
    params = {
        "core": mlp_init(
            rng, input_dim, output_dim=output_dim, hidden_dim=hidden_dim, bias=bias
        ),
        "gate": mlp_init(
            rng, input_dim, output_dim=output_dim, hidden_dim=hidden_dim, bias=bias
        ),
    }
    ln_core = norm_init(norm, output_dim)
    if ln_core is not None:
        params["norm_core"] = ln_core
        params["norm_gate"] = norm_init(norm, output_dim)
    return params


def project_parts(
    layers_c: Sequence[Params],
    layers_g: Sequence[Params],
    parts: Sequence[tuple],
) -> tuple[list[tuple], torch.Tensor | None]:
    """Every part's table through its rows of the joint first Linear (core |
    gate packed side by side), before any gather, and the joint bias or None
    (``chgnet_tpu.models.functions.project_parts``)."""
    first_w = torch.cat([layers_c[0]["w"], layers_g[0]["w"]], dim=1)
    projected: list[tuple] = []
    offset = 0
    for table, idx, plan in parts:
        w = first_w[offset: offset + table.shape[1]]
        offset += table.shape[1]
        projected.append((table @ w, idx, plan))
    b1 = None
    if "b" in layers_c[0]:
        b1 = torch.cat([layers_c[0]["b"], layers_g[0]["b"]])
    return projected, b1


def project_parts_fold(
    layers_c: Sequence[Params],
    layers_g: Sequence[Params],
    parts: Sequence[tuple],
    fold: dict[int, int] | None = None,
) -> tuple[list[tuple], torch.Tensor | None]:
    """:func:`project_parts` with part folding
    (``chgnet_tpu.models.functions.project_parts_fold``): ``fold`` maps a
    part's position to an earlier part whose index stream and plan it
    shares; its projected table is added to that part's before any gather,
    so one gather (and one backward segment sum) serves both. Exact row by
    row: ``(a + b)[i] == a[i] + b[i]``."""
    projected, b1 = project_parts(layers_c, layers_g, parts)
    if not fold:
        return projected, b1
    merged: dict[int, torch.Tensor] = {}
    for src, dst in fold.items():
        if not 0 <= dst < len(projected) or dst in fold:
            raise ValueError(f"fold target {dst} invalid")
        tab_s, tab_d = projected[src][0], projected[dst][0]
        if tab_s.shape != tab_d.shape:
            raise ValueError(
                f"folded part {src} shape {tuple(tab_s.shape)} != target "
                f"{dst} shape {tuple(tab_d.shape)} (index streams must match)"
            )
        merged[dst] = merged.get(dst, tab_d) + tab_s
    out = [
        (merged.get(k, tab), idx, plan)
        for k, (tab, idx, plan) in enumerate(projected)
        if k not in fold
    ]
    return out, b1


def fold_bias_into_stream(parts: Sequence[tuple], b1):
    """Add the joint first-layer bias to the first aligned part's table:
    ``(parts, the bias if no aligned part took it)``
    (``chgnet_tpu.models.functions.fold_bias_into_stream``)."""
    if b1 is not None:
        for k, (table, idx, plan) in enumerate(parts):
            if idx is None:
                out = list(parts)
                out[k] = (table + b1, idx, plan)
                return out, None
    return list(parts), b1


def first_layer_acc(
    layers_c: Sequence[Params],
    layers_g: Sequence[Params],
    parts: Sequence[tuple],
) -> torch.Tensor:
    """Joint [L, 2D] first-Linear output (core | gate packed side by side)
    over an implicit concatenation of feature blocks.

    ``parts``: ``(table, idx, plan)`` per block in the first Linear's input
    order; ``idx=None`` marks a block already on the stream axis [L, d].

    Two routes, chosen by the parts' shapes (the structural half of
    ``chgnet_tpu.ops.gproj.gproj_eligible``):

    * at least two gathered blocks whose tables share one shape (the
      directed layout's layers, and the angle side of both layouts): the
      aligned blocks are projected with ``torch.matmul`` and, with the
      bias, form the stream; the gathered blocks go through the
      gather-project-sum kernel (``ops/gproj.py``);
    * otherwise (the undirected AtomConv: atom and bond tables of different
      lengths): every table is projected first (:func:`project_parts`) and
      the projected rows are summed by the multi-gather kernel
      (``ops/multi_gather.py``), as ``chgnet_tpu`` does
      (``models/functions.py:407-412``)."""
    gathered = [table for table, idx, _ in parts if idx is not None]
    if len(gathered) < 2 or len({t.shape for t in gathered}) != 1:
        projected, b1 = fold_bias_into_stream(
            *project_parts(layers_c, layers_g, parts)
        )
        acc = gather_sum(projected)
        return acc if b1 is None else acc + b1
    first_w = torch.cat([layers_c[0]["w"], layers_g[0]["w"]], dim=1)
    stream = None
    pairs = []
    offset = 0
    for table, idx, plan in parts:
        w = first_w[offset: offset + table.shape[1]]
        offset += table.shape[1]
        if idx is None:
            proj = table @ w
            stream = proj if stream is None else stream + proj
        else:
            pairs.append((table, idx, plan, w))
    if "b" in layers_c[0]:
        b1 = torch.cat([layers_c[0]["b"], layers_g[0]["b"]])
        stream = b1 + stream if stream is not None else b1.expand(
            pairs[0][1].shape[0], -1
        )
    return gather_project_sum(pairs, stream)


def gated_mlp_fusable(params: Params, activation: str = "silu") -> bool:
    """True when both branches are exactly 2 Linears with layer norms and
    silu: the shape of the fused message tail
    (``chgnet_tpu.models.functions.gated_mlp_fusable``). Batch norm does
    not fuse: the kernels compute layer norms."""
    return (
        activation == "silu"
        and "norm_core" in params
        and "mean" not in params["norm_core"]
        and len(params["core"]["layers"]) == 2
        and len(params["gate"]["layers"]) == 2
    )


def gated_mlp_update_fusable(params: Params, activation: str = "silu") -> bool:
    """Like :func:`gated_mlp_fusable` for the weights-free update tail,
    where single-Linear branches also fuse
    (``chgnet_tpu.models.functions.gated_mlp_update_fusable``)."""
    return (
        activation == "silu"
        and "norm_core" in params
        and "mean" not in params["norm_core"]
        and len(params["core"]["layers"]) in (1, 2)
        and len(params["gate"]["layers"]) == len(params["core"]["layers"])
    )


def gated_mlp_fused_pack(params: Params) -> Params:
    """Second-layer and norm parameters of the fused tails
    (``chgnet_tpu.models.functions.gated_mlp_fused_pack``): the core and
    gate second-layer weights as the two diagonal blocks ``w2c``/``w2g``
    [D, D] of ``chgnet_tpu``'s block-diagonal ``w2``, the concatenated
    ``b2`` [2D] and the four layer-norm vectors [D]. Single-Linear
    branches have no second layer: no ``w2c``/``w2g``/``b2``."""
    out = {
        "nc_scale": params["norm_core"]["scale"],
        "nc_bias": params["norm_core"]["bias"],
        "ng_scale": params["norm_gate"]["scale"],
        "ng_bias": params["norm_gate"]["bias"],
    }
    if len(params["core"]["layers"]) == 1:
        return out
    core2 = params["core"]["layers"][1]
    gate2 = params["gate"]["layers"][1]
    zeros = core2["w"].new_zeros(core2["w"].shape[1])
    out["w2c"] = core2["w"]
    out["w2g"] = gate2["w"]
    out["b2"] = torch.cat([core2.get("b", zeros), gate2.get("b", zeros)])
    return out


def gated_mlp_tail(
    params: Params,
    acc: torch.Tensor,
    *,
    activation: str = "silu",
    dropout: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """The gated MLP after its first Linear: the remaining block-diagonal
    joint Linears, per-half norms and act(core) * sigmoid(gate), applied
    to the joint [L, 2D] first-layer output ``acc`` (bias included).
    Plain PyTorch (``chgnet_tpu.models.functions.gated_mlp_tail``). With a
    ``generator``, dropout acts where ``chgnet_tpu`` puts it: on the packed
    input of the last Linear, or on ``acc`` itself for single-Linear
    branches."""
    act = find_activation(activation)
    layers_c = params["core"]["layers"]
    layers_g = params["gate"]["layers"]
    dim = layers_c[-1]["w"].shape[1]
    if len(layers_c) != len(layers_g):
        raise ValueError("core/gate layer counts differ")
    x = acc
    if len(layers_c) == 1:
        x = dropout_apply(acc, dropout, generator)
    else:
        x = act(acc)
        for n, (lc, lg) in enumerate(zip(layers_c[1:], layers_g[1:])):
            if n == len(layers_c) - 2:
                x = dropout_apply(x, dropout, generator)
            x = x @ torch.block_diag(lc["w"], lg["w"])
            if "b" in lc:
                x = x + torch.cat([lc["b"], lg["b"]])
            if n < len(layers_c) - 2:
                x = act(x)
    if "norm_core" in params:
        nc, ng = params["norm_core"], params["norm_gate"]
        if "mean" in nc:
            mean = torch.cat([nc["mean"], ng["mean"]])
            var = torch.cat([nc["var"], ng["var"]])
            scale = torch.cat([nc["scale"], ng["scale"]])
            bias = torch.cat([nc["bias"], ng["bias"]])
            x = (x - mean) * torch.rsqrt(var + 1e-5) * scale + bias
        else:
            h = x.reshape(-1, 2, dim)
            mean = h.mean(dim=-1, keepdim=True)
            var = ((h - mean) ** 2).mean(dim=-1, keepdim=True)
            h = (h - mean) * torch.rsqrt(var + 1e-5)
            scale = torch.stack([nc["scale"], ng["scale"]])
            bias = torch.stack([nc["bias"], ng["bias"]])
            x = (h * scale + bias).reshape(-1, 2 * dim)
    return act(x[:, :dim]) * torch.sigmoid(x[:, dim:])
