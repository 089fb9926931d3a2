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


def mlp_apply(params: Params, x: torch.Tensor, *, activation: str = "silu"):
    act = find_activation(activation)
    layers = params["layers"]
    for layer in layers[:-1]:
        x = act(linear_apply(layer, x))
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


def first_layer_acc(
    layers_c: Sequence[Params],
    layers_g: Sequence[Params],
    parts: Sequence[tuple],
) -> torch.Tensor:
    """Joint [L, 2D] first-Linear output (core | gate packed side by side)
    over an implicit concatenation of feature blocks.

    ``parts``: ``(table, idx, plan)`` per block in the first Linear's input
    order; ``idx=None`` marks a block already on the stream axis [L, d].
    Aligned blocks are projected with ``torch.matmul`` and, with the bias,
    form the stream; the gathered blocks go through the gather-project-sum
    kernel (``ops/gproj.py``)."""
    first_w = torch.cat([layers_c[0]["w"], layers_g[0]["w"]], dim=1)
    stream = None
    gathered = []
    offset = 0
    for table, idx, plan in parts:
        w = first_w[offset: offset + table.shape[1]]
        offset += table.shape[1]
        if idx is None:
            proj = table @ w
            stream = proj if stream is None else stream + proj
        else:
            gathered.append((table, idx, plan, w))
    if "b" in layers_c[0]:
        b1 = torch.cat([layers_c[0]["b"], layers_g[0]["b"]])
        stream = b1 + stream if stream is not None else b1.expand(
            gathered[0][1].shape[0], -1
        )
    if not gathered:
        return stream
    return gather_project_sum(gathered, stream)


def gated_mlp_tail(
    params: Params, acc: torch.Tensor, *, activation: str = "silu"
) -> torch.Tensor:
    """The gated MLP after its first Linear: the remaining block-diagonal
    joint Linears, per-half norms and act(core) * sigmoid(gate), applied
    to the joint [L, 2D] first-layer output ``acc`` (bias included).
    Plain PyTorch (``chgnet_tpu.models.functions.gated_mlp_tail``)."""
    act = find_activation(activation)
    layers_c = params["core"]["layers"]
    layers_g = params["gate"]["layers"]
    dim = layers_c[-1]["w"].shape[1]
    if len(layers_c) != len(layers_g):
        raise ValueError("core/gate layer counts differ")
    x = acc
    if len(layers_c) > 1:
        x = act(acc)
        for n, (lc, lg) in enumerate(zip(layers_c[1:], layers_g[1:])):
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
