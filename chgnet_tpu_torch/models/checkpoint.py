"""Reference ``.pth.tar`` checkpoints -> the port's parameter tree.

Copy of ``chgnet_tpu.models.checkpoint`` (numpy, plus ``torch.load`` for
the file itself). Upstream CHGNet ships its pretrained weights as torch
``state_dict`` pickles; every entry maps 1:1 onto the parameter tree that
both packages share (Linear weights transposed to the ``x @ W``
convention).
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np


def _torch_mlp_linear_indices(hidden_dim: int | Sequence[int] | None) -> list[int]:
    """Indices of Linear modules inside the reference MLP's nn.Sequential
    (layout per ``functions.py:72-96``)."""
    if hidden_dim is None or hidden_dim == 0:
        return [1]  # [Dropout, Linear]
    if isinstance(hidden_dim, int):
        n_hidden = 1
    else:
        n_hidden = len(hidden_dim)
    # [Linear, act, (Linear, act) * (n-1), Dropout, Linear]
    indices = [2 * i for i in range(n_hidden)]
    indices.append(2 * (n_hidden - 1) + 3)
    return indices


def _take_linear(sd: dict, torch_prefix: str, *, transpose: bool = True) -> dict:
    """Extract one Linear layer from the state dict."""
    weight = np.asarray(sd[f"{torch_prefix}.weight"], dtype=np.float32)
    out = {"w": weight.T.copy() if transpose else weight.copy()}
    bias_key = f"{torch_prefix}.bias"
    if bias_key in sd:
        out["b"] = np.asarray(sd[bias_key], dtype=np.float32)
    return out


def _take_mlp(sd: dict, torch_prefix: str, hidden_dim) -> dict:
    return {
        "layers": [
            _take_linear(sd, f"{torch_prefix}.layers.{idx}")
            for idx in _torch_mlp_linear_indices(hidden_dim)
        ]
    }


def _take_layer_norm(sd: dict, torch_prefix: str) -> dict:
    return {
        "scale": np.asarray(sd[f"{torch_prefix}.weight"], dtype=np.float32),
        "bias": np.asarray(sd[f"{torch_prefix}.bias"], dtype=np.float32),
    }


def _take_batch_norm(sd: dict, torch_prefix: str) -> dict:
    """BatchNorm1d incl. running statistics (eval semantics)."""
    return {
        "scale": np.asarray(sd[f"{torch_prefix}.weight"], dtype=np.float32),
        "bias": np.asarray(sd[f"{torch_prefix}.bias"], dtype=np.float32),
        "mean": np.asarray(
            sd[f"{torch_prefix}.running_mean"], dtype=np.float32
        ),
        "var": np.asarray(
            sd[f"{torch_prefix}.running_var"], dtype=np.float32
        ),
    }


def _take_norm(sd: dict, torch_prefix: str, norm) -> dict:
    if norm == "batch":
        return _take_batch_norm(sd, torch_prefix)
    return _take_layer_norm(sd, torch_prefix)


def _take_gated_mlp(sd: dict, torch_prefix: str, hidden_dim, norm) -> dict:
    params = {
        "core": _take_mlp(sd, f"{torch_prefix}.mlp_core", hidden_dim),
        "gate": _take_mlp(sd, f"{torch_prefix}.mlp_gate", hidden_dim),
    }
    if norm in ("layer", "batch"):
        params["norm_core"] = _take_norm(sd, f"{torch_prefix}.bn1", norm)
        params["norm_gate"] = _take_norm(sd, f"{torch_prefix}.bn2", norm)
    return params


def convert_state_dict(state_dict: dict, model_args: dict) -> dict:
    """Convert a reference CHGNet state_dict (numpy-valued) to a param tree."""
    sd = state_dict
    gmlp_norm = model_args.get("gMLP_norm", "layer")
    mlp_out_bias = model_args.get("mlp_out_bias", False)
    n_conv = model_args.get("n_conv", 4)
    atom_hidden = model_args.get("atom_conv_hidden_dim", 64)
    bond_hidden = model_args.get("bond_conv_hidden_dim", 64)
    angle_hidden = model_args.get("angle_layer_hidden_dim", 0)
    mlp_hidden = model_args.get("mlp_hidden_dims", (64, 64, 64))

    params: dict = {
        "atom_embedding": {
            "weight": np.asarray(
                sd["atom_embedding.embedding.weight"], dtype=np.float32
            )
        },
        "bond_basis": {
            "freq_ag": np.asarray(
                sd["bond_basis_expansion.rbf_expansion_ag.frequencies"],
                dtype=np.float32,
            ),
            "freq_bg": np.asarray(
                sd["bond_basis_expansion.rbf_expansion_bg.frequencies"],
                dtype=np.float32,
            ),
        },
        "angle_basis": {
            "freq": np.asarray(
                sd["angle_basis_expansion.fourier_expansion.frequencies"],
                dtype=np.float32,
            )
        },
        "bond_embedding": _take_linear(sd, "bond_embedding"),
        "bond_weights_ag": _take_linear(sd, "bond_weights_ag"),
        "bond_weights_bg": _take_linear(sd, "bond_weights_bg"),
        "angle_embedding": _take_linear(sd, "angle_embedding"),
        "site_wise": _take_linear(sd, "site_wise"),
        "mlp": _take_mlp(sd, "mlp", mlp_hidden),
    }

    def conv_block(prefix: str, idx: int, gmlp_attr: str, hidden) -> dict:
        base = f"{prefix}.{idx}"
        block = {
            "gated_mlp": _take_gated_mlp(
                sd, f"{base}.{gmlp_attr}", hidden, gmlp_norm
            )
        }
        if f"{base}.mlp_out.layers.1.weight" in sd:
            block["mlp_out"] = _take_mlp(sd, f"{base}.mlp_out", 0)
            if not mlp_out_bias and "b" in block["mlp_out"]["layers"][0]:
                pass  # checkpoint carries bias; keep it (v0.2.0 compat)
        return block

    params["atom_convs"] = [
        conv_block("atom_conv_layers", i, "twoBody_atom", atom_hidden)
        for i in range(n_conv)
    ]
    if model_args.get("update_bond", True):
        params["bond_convs"] = [
            conv_block("bond_conv_layers", i, "twoBody_bond", bond_hidden)
            for i in range(n_conv - 1)
        ]
    if model_args.get("update_angle", True):
        params["angle_updates"] = [
            conv_block("angle_layers", i, "twoBody_bond", angle_hidden)
            for i in range(n_conv - 1)
        ]

    if "readout_norm.weight" in sd:
        kind = "batch" if "readout_norm.running_mean" in sd else "layer"
        params["readout_norm"] = _take_norm(sd, "readout_norm", kind)
    if "composition_model.fc.weight" in sd:
        params["composition"] = {
            "weight": np.asarray(
                sd["composition_model.fc.weight"], dtype=np.float32
            ).reshape(-1)
        }
    if "pooling.key.layers.0.weight" in sd:  # attention readout
        params["attn_readout"] = {
            "key": _take_mlp(sd, "pooling.key", 32),
        }
    return params


def load_torch_checkpoint(path: str) -> tuple[dict, dict]:
    """Load a reference ``.pth.tar`` and return (params, model_args)."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=False)
    if "model" in state:
        state = state["model"]
    model_args = dict(state["model_args"])
    sd = {k: v.detach().cpu().numpy() for k, v in state["state_dict"].items()}
    # drop reference-only / non-config keys
    for key in ("self", "__class__", "kwargs"):
        model_args.pop(key, None)
    params = convert_state_dict(sd, model_args)
    return params, model_args


def convert_torch_checkpoint(src_path: str, dst_path: str) -> None:
    """Convert a reference torch checkpoint to the native .npz format."""
    from chgnet_tpu_torch.utils.common import save_params

    params, model_args = load_torch_checkpoint(src_path)
    save_params(params, model_args, dst_path)
