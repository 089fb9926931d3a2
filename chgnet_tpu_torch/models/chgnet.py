"""CHGNet on PyTorch: energy, forces, stress and magnetic moments.

Port of ``chgnet_tpu.models.chgnet``, in both bond layouts
(``CHGNetConfig.directed_bonds``):

* ``CHGNetConfig`` has the same fields and defaults, and ``init_params``
  draws the same numpy values in the same order, so one seed gives the same
  weights in both packages;
* :func:`compute_batch` evaluates the energy at positions
  ``cart @ (I + strain)`` and lattices ``L @ (I + strain)``; one
  ``torch.autograd.grad`` over (cart, strain) gives forces and the virial
  (stress in GPa via 160.21766208 / V); magmoms are
  ``|Linear(atom_feas_mid)|`` read before the last conv block.

Every gather and reduction of a feature stream runs through the port's
CUDA kernels (``chgnet_tpu_torch/ops``). With ``fused_kernels=True`` (the
default) the gated-MLP tails of the conv layers run through the fused tail
kernels where ``chgnet_tpu`` fuses them; with ``fused_kernels=False`` they
run as plain PyTorch.

Two optional batch layouts change how AtomConv reads its edges, not what
it computes: ``dense_atom_conv`` runs it over the batch's ``[N, K]`` slots
(``batch_graphs(dense_k=...)``; plain PyTorch, as ``chgnet_tpu`` runs it
without a Pallas kernel, its gathers through the slots' plans), and a
halo-tiled batch (``batch_graphs(tile=...)``) gathers the neighbour rows, of
the positions and of every AtomConv, from its expanded table (``exp_map``,
then ``nbr_x``).

For training, :func:`compute_batch` takes a dropout generator (the conv
layers unfuse while dropout is on, as in ``chgnet_tpu``) and
``create_graph``, which keeps forces and stress differentiable in the
parameters; ``remat`` rematerializes layers by ``torch.utils.checkpoint``;
``read_out`` "attn" / "weighted" pool by per-graph attention; and
``matmul_precision`` sets the precision of the plain GEMMs.

``compute_dtype="bfloat16"`` runs the conv stack in bf16 where
``chgnet_tpu`` does (``models/chgnet.py:334-348, 435-438, 495-496, 683``):
the conv parameters, the bases, the edge and angle masks and every feature
stream are bf16, geometry and readout stay f32, and e, f, s and m come out
f32. Every kernel of PERF.md's table (rows 1-14, under every switch, and
the tails' and the one-kernel pass's parameter-gradient forms that training
runs) takes the bf16 streams, computes in f32 and rounds once at each
store.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import math
import os
import warnings
from collections.abc import Sequence
from typing import Literal

import numpy as np
import torch
import torch.utils.checkpoint

from chgnet_tpu_torch import PredTask
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.device import resolve_device
from chgnet_tpu_torch.graph.batching import GraphBatch, batch_graphs
from chgnet_tpu_torch.graph.converter import CrystalGraphConverter
from chgnet_tpu_torch.graph.crystalgraph import CrystalGraph
from chgnet_tpu_torch.models import basis
from chgnet_tpu_torch.models.composition import AtomRef
from chgnet_tpu_torch.models.convert import (
    count_params,
    params_from_jax,
    params_to_numpy,
)
from chgnet_tpu_torch.models.functions import (
    Params,
    block_generator,
    layer_norm_apply,
    linear_apply,
    linear_init,
    mlp_apply,
    mlp_init,
    norm_init,
)
from chgnet_tpu_torch.models.layers import (
    UndirectedMaps,
    angle_update_apply_directed,
    angle_update_init,
    atom_conv_apply,
    atom_conv_dense_apply,
    atom_conv_init,
    attention_readout_apply,
    attention_readout_init,
    bond_conv_apply_directed,
    bond_conv_init,
)
from chgnet_tpu_torch.ops.gated_message import TAIL_MAX_D
from chgnet_tpu_torch.ops.gproj import MAX_DT, MAX_K
from chgnet_tpu_torch.ops.segment import SEGMENT_MAX_D, plan_gather, plan_segment_sum
from chgnet_tpu_torch.utils.common import load_params, save_params

EV_A3_TO_GPA = 160.21766208  # eV/A^3 -> GPa
# matmul_precision -> whether the plain f32 GEMMs may use TF32: "highest"
# keeps them full f32; "high" and "default" let cuBLAS run them on the TF32
# tensor cores. The hand-written kernels multiply at f32 accuracy (3xTF32)
# under every setting.
TF32_MATMULS = {"highest": False, "high": True, "default": True}
# the parameter subtrees of the conv stack, cast to the conv dtype
# (chgnet_tpu.models.chgnet :341-348)
CONV_KEYS = (
    "atom_embedding", "bond_embedding", "bond_weights_ag", "bond_weights_bg",
    "angle_embedding", "atom_convs", "bond_convs", "angle_updates",
)


def conv_dtype(cfg: CHGNetConfig) -> torch.dtype:
    """The conv stack's dtype: bf16 for ``compute_dtype="bfloat16"``, else
    f32 (as ``chgnet_tpu`` reads the field)."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _remat_mode(remat) -> str | None:
    """``""`` (off), ``"all"`` or ``"angle"`` for a ``remat`` value; None for
    one ``chgnet_tpu`` refuses (``models/chgnet.py:351-356``)."""
    mode = remat if isinstance(remat, str) else ("all" if remat else "")
    return mode if mode in ("", "all", "angle") else None


@dataclasses.dataclass(frozen=True)
class CHGNetConfig:
    """Model hyperparameters: the fields and defaults of
    ``chgnet_tpu.models.chgnet.CHGNetConfig``.

    The port runs f32 and bf16 (``compute_dtype``) in both bond layouts:
    ``directed_bonds=True`` (the default) keeps bond features and weights
    on the directed edge stream [E, d], ``directed_bonds=False`` on the
    undirected bonds [U, d], as upstream CHGNet does; one parameter tree
    serves both. ``dense_atom_conv`` runs AtomConv over the dense per-atom
    slots of a batch built with ``dense_k`` (and, as in ``chgnet_tpu``, the
    bond stack in the undirected layout). :meth:`check_supported` names, on
    a CUDA device, the widths the kernels do not take
    (:meth:`kernel_width_faults`); bf16 runs under every switch and trains
    on both devices.
    ``sorted_grads`` has no effect: every backward here is a CSR segment
    sum.
    """

    atom_fea_dim: int = 64
    bond_fea_dim: int = 64
    angle_fea_dim: int = 64
    composition_model: str = "MPtrj"
    num_radial: int = 31
    num_angular: int = 31
    n_conv: int = 4
    atom_conv_hidden_dim: int | tuple[int, ...] = 64
    update_bond: bool = True
    bond_conv_hidden_dim: int | tuple[int, ...] = 64
    update_angle: bool = True
    angle_layer_hidden_dim: int | tuple[int, ...] = 0
    conv_dropout: float = 0.0
    read_out: str = "ave"
    mlp_hidden_dims: int | tuple[int, ...] = (64, 64, 64)
    mlp_dropout: float = 0.0
    mlp_first: bool = True
    is_intensive: bool = True
    non_linearity: Literal["silu", "relu", "tanh", "gelu"] = "silu"
    atom_graph_cutoff: float = 6.0
    bond_graph_cutoff: float = 3.0
    graph_converter_algorithm: str = "fast"
    cutoff_coeff: float = 8.0
    learnable_rbf: bool = True
    gMLP_norm: str | None = "layer"
    readout_norm: str | None = "layer"
    conv_norm: str | None = None
    mlp_out_bias: bool = False
    final_mlp: str = "MLP"
    num_heads: int = 3
    version: str | None = None
    atom_ref_is_intensive: bool = True
    matmul_precision: str = "highest"
    compute_dtype: str = "float32"
    fused_kernels: bool = True
    sorted_grads: bool = True
    remat: bool | str = False
    dense_atom_conv: bool = False
    directed_bonds: bool = True
    max_num_elements: int = 94

    def __post_init__(self) -> None:
        if self.num_angular % 2 != 1:
            raise ValueError(f"num_angular={self.num_angular} must be odd")
        if self.conv_dropout and self.dense_atom_conv:
            raise NotImplementedError(
                "conv_dropout with dense_atom_conv is not supported"
            )
        if self.matmul_precision not in TF32_MATMULS:
            raise ValueError(
                f"matmul_precision={self.matmul_precision!r}: use one of "
                f"{sorted(TF32_MATMULS)}"
            )
        if _remat_mode(self.remat) is None:
            raise ValueError(
                f"remat={self.remat!r}: use False, True/'all', or 'angle'"
            )
        for name in ("atom_conv_hidden_dim", "bond_conv_hidden_dim",
                     "angle_layer_hidden_dim", "mlp_hidden_dims"):
            val = getattr(self, name)
            if isinstance(val, list):
                object.__setattr__(self, name, tuple(val))

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def check_supported(self, device_type: str = "cpu") -> None:
        """Raise for settings the port does not run yet on a device of
        ``device_type`` (``"cpu"`` or ``"cuda"``): on ``"cuda"``, widths the
        kernels do not take, before anything is launched. Serving and
        training are taken alike, in both dtypes."""
        faults = self.kernel_width_faults() if device_type == "cuda" else []
        if faults:
            raise NotImplementedError(
                "CHGNetConfig widths the port's CUDA kernels do not take yet "
                "(the CPU runs them; see ROADMAP.md Queue 1 item 6b): "
                + "; ".join(faults)
            )

    @property
    def directed_layout(self) -> bool:
        """Whether bond features live on the directed edges: the dense
        slots index the undirected bonds, so ``dense_atom_conv`` takes the
        undirected layout (``chgnet_tpu.models.chgnet`` :333)."""
        return self.directed_bonds and not self.dense_atom_conv

    def kernel_width_faults(self) -> list[str]:
        """The widths of this config that the CUDA kernels do not take, one
        line for each limit a width breaks, naming its fields and the
        kernel's limit; empty when every width fits. Worked out from the
        config alone, by the kernels each conv layer picks
        (``models/layers.py``, ``models/functions.py`` ``first_layer_acc``,
        ``gated_mlp_fusable``). The plain versions take any width."""
        faults: list[str] = []

        def need(ok: bool, fields: str, limit: str) -> None:
            if not ok and f"{fields}: {limit}" not in faults:
                faults.append(f"{fields}: {limit}")

        def rows_fit(w: int) -> bool:
            return w <= SEGMENT_MAX_D and (w % 4 == 0 or w <= SEGMENT_MAX_D // 4)

        rows_limit = (
            f"segment sums take rows of at most {SEGMENT_MAX_D} floats, "
            f"{SEGMENT_MAX_D // 4} when not a multiple of 4"
        )
        for field in ("atom_fea_dim", "bond_fea_dim"):
            width = getattr(self, field)
            need(rows_fit(width), f"{field}={width}", rows_limit)
        fusing = (
            self.fused_kernels
            and self.non_linearity == "silu"
            and self.gMLP_norm == "layer"
        )
        # (output width, hidden width, message layer, first layer by
        # gather_project_sum: two gathered tables of one shape); the dense
        # AtomConv runs no kernel of its own
        directed = self.directed_layout
        layers = [] if self.dense_atom_conv else [
            ("atom_fea_dim", "atom_conv_hidden_dim", True, directed)]
        angle_side_gproj = self.atom_fea_dim == self.bond_fea_dim
        if self.update_bond:
            layers.append(
                ("bond_fea_dim", "bond_conv_hidden_dim", True, angle_side_gproj)
            )
        if self.update_angle and self.n_conv > 2:
            layers.append(
                ("angle_fea_dim", "angle_layer_hidden_dim", False, angle_side_gproj)
            )
        for out_field, hidden_field, message, gproj in layers:
            d = getattr(self, out_field)
            hidden = getattr(self, hidden_field)
            first, n_linears = _first_linear(hidden, d)
            k = 2 * first  # the first layer's joint [L, 2 first] output
            fields = f"{out_field}={d}, {hidden_field}={hidden!r}"
            need(rows_fit(k), fields, f"its first layer's K = {k} wide cotangent: "
                 + rows_limit)
            if gproj:
                need(
                    self.atom_fea_dim % 4 == 0 and 4 <= self.atom_fea_dim <= MAX_DT,
                    f"atom_fea_dim={self.atom_fea_dim}"
                    + ("" if out_field == "atom_fea_dim"
                       else f", bond_fea_dim={self.bond_fea_dim}"),
                    f"gather_project_sum takes tables dt <= {MAX_DT} wide, "
                    "a multiple of 4",
                )
                need(k % 4 == 0 and 4 <= k <= MAX_K, fields,
                     f"gather_project_sum takes K = 2 x first hidden <= {MAX_K}, "
                     f"a multiple of 4 (K = {k})")
            else:
                need(k % 4 == 0, fields,
                     f"gather_sum_rows takes K = 2 x first hidden, a multiple "
                     f"of 4 (K = {k})")
            fused = fusing and (
                n_linears == 2 if message
                else n_linears in (1, 2) and self.conv_norm is None
            )
            if fused:
                need(d % 4 == 0 and 4 <= d <= TAIL_MAX_D, fields,
                     f"the fused tails and the one-kernel pass take D <= "
                     f"{TAIL_MAX_D} (2D <= {2 * TAIL_MAX_D}), a multiple of 4")
                need(n_linears == 1 or first == d, fields,
                     "the fused tails take a second layer of D x D blocks "
                     "(hidden width = D)")
        if not directed and self.update_bond:
            need(self.bond_fea_dim % 4 == 0, f"bond_fea_dim={self.bond_fea_dim}",
                 "twin_reduce (directed_bonds=False) takes rows of a multiple "
                 "of 4 floats")
        return faults


def _first_linear(hidden, out: int) -> tuple[int, int]:
    """(output width of a gated-MLP branch's first Linear, the branch's
    Linears) for ``hidden_dim`` as ``mlp_init`` reads it."""
    if not hidden:
        return out, 1
    if isinstance(hidden, int):
        return hidden, 2
    return hidden[0], len(hidden) + 1


def init_params(config: CHGNetConfig, seed: int = 0) -> Params:
    """The full parameter tree as numpy arrays: the same draws, in the same
    order, as ``chgnet_tpu.models.chgnet.init_params``."""
    rng = np.random.default_rng(seed)
    cfg = config
    params: Params = {
        "atom_embedding": {
            "weight": rng.normal(
                size=(cfg.max_num_elements, cfg.atom_fea_dim)
            ).astype(np.float32)
        },
        "bond_basis": {
            "freq_ag": basis.bessel_frequencies(cfg.num_radial),
            "freq_bg": basis.bessel_frequencies(cfg.num_radial),
        },
        "angle_basis": {
            "freq": basis.fourier_frequencies((cfg.num_angular - 1) // 2)
        },
        "bond_embedding": linear_init(
            rng, cfg.num_radial, cfg.bond_fea_dim, bias=False
        ),
        "bond_weights_ag": linear_init(
            rng, cfg.num_radial, cfg.atom_fea_dim, bias=False
        ),
        "bond_weights_bg": linear_init(
            rng, cfg.num_radial, cfg.bond_fea_dim, bias=False
        ),
        "angle_embedding": linear_init(
            rng, cfg.num_angular, cfg.angle_fea_dim, bias=False
        ),
        "atom_convs": [
            atom_conv_init(
                rng,
                atom_fea_dim=cfg.atom_fea_dim,
                bond_fea_dim=cfg.bond_fea_dim,
                hidden_dim=cfg.atom_conv_hidden_dim,
                norm=cfg.conv_norm,
                gmlp_norm=cfg.gMLP_norm,
                mlp_out_bias=cfg.mlp_out_bias,
            )
            for _ in range(cfg.n_conv)
        ],
        "site_wise": linear_init(rng, cfg.atom_fea_dim, 1),
    }
    if cfg.update_bond:
        params["bond_convs"] = [
            bond_conv_init(
                rng,
                atom_fea_dim=cfg.atom_fea_dim,
                bond_fea_dim=cfg.bond_fea_dim,
                angle_fea_dim=cfg.angle_fea_dim,
                hidden_dim=cfg.bond_conv_hidden_dim,
                norm=cfg.conv_norm,
                gmlp_norm=cfg.gMLP_norm,
                mlp_out_bias=cfg.mlp_out_bias,
            )
            for _ in range(cfg.n_conv - 1)
        ]
    if cfg.update_angle:
        params["angle_updates"] = [
            angle_update_init(
                rng,
                atom_fea_dim=cfg.atom_fea_dim,
                bond_fea_dim=cfg.bond_fea_dim,
                angle_fea_dim=cfg.angle_fea_dim,
                hidden_dim=cfg.angle_layer_hidden_dim,
                norm=cfg.conv_norm,
                gmlp_norm=cfg.gMLP_norm,
            )
            for _ in range(cfg.n_conv - 1)
        ]
    ln = norm_init(cfg.readout_norm, cfg.atom_fea_dim)
    if ln is not None:
        params["readout_norm"] = ln
    readout_in = cfg.atom_fea_dim
    if not cfg.mlp_first and cfg.read_out in {"attn", "weighted"}:
        params["attn_readout"] = attention_readout_init(
            rng, cfg.atom_fea_dim, num_heads=cfg.num_heads
        )
        readout_in = cfg.atom_fea_dim * cfg.num_heads
    params["mlp"] = mlp_init(
        rng, readout_in, output_dim=1, hidden_dim=cfg.mlp_hidden_dims
    )
    if cfg.composition_model:
        atom_ref = AtomRef(is_intensive=cfg.is_intensive)
        atom_ref.initialize_from(cfg.composition_model)
        params["composition"] = {"weight": atom_ref.weight.copy()}
    return params


# ===================================================================== core
def _checkpointed(fn, on: bool):
    """``fn`` rematerialized in the backward (``torch.utils.checkpoint``,
    non-reentrant) when ``on``, else ``fn`` itself."""
    if not on:
        return fn
    return lambda *args: torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False
    )


def _energy_core(
    params: Params,
    cfg: CHGNetConfig,
    batch: GraphBatch,
    cart: torch.Tensor,  # [N, 3] unstrained cartesian coordinates
    strains: torch.Tensor,  # [B, 3, 3]
    seeds: Sequence[int] | None = None,
) -> tuple[torch.Tensor, dict]:
    """Extensive GNN energy per graph [B] plus auxiliary features,
    differentiable in (cart, strains). Padded rows contribute exactly zero
    and stay finite. ``seeds`` (``3 * n_conv + 1`` of them) turn dropout
    on: layer ``k`` of block ``idx`` draws from seed ``3 * idx + k`` (atom,
    bond, angle), the readout MLP from the last, as ``chgnet_tpu`` splits
    its key (``models/chgnet.py:508-510``)."""
    n_graphs = batch.lattices.shape[0]
    dtype = cart.dtype
    conv = conv_dtype(cfg)
    if conv != torch.float32:  # the conv stack in bf16; geometry stays f32
        params = dict(params) | {
            k: _cast_tree(params[k], conv) for k in CONV_KEYS if k in params
        }
    graph_ids = torch.arange(n_graphs, device=cart.device)
    deform = torch.eye(3, dtype=dtype, device=cart.device) + strains
    lat = batch.lattices @ deform  # [B, 3, 3]
    # per-atom and per-edge deformations/lattices as one-hot matmuls: their
    # backward is a small dense product instead of a scatter-add
    atom_onehot = (batch.atom_owner[:, None] == graph_ids).to(dtype)
    edge_onehot = (batch.edge_owner[:, None] == graph_ids).to(dtype)
    deform_atoms = (atom_onehot @ deform.reshape(n_graphs, 9)).reshape(-1, 3, 3)
    pos = torch.einsum("ni,nij->nj", cart, deform_atoms)

    center = batch.atom_graph[:, 0].contiguous()
    nbr = batch.atom_graph[:, 1].contiguous()
    dir_i = batch.bond_graph[:, 2].contiguous()
    dir_j = batch.bond_graph[:, 4].contiguous()
    p_center, p_nbr = batch.plan_center, batch.plan_nbr
    p_i, p_j = batch.plan_ang_vi, batch.plan_ang_vj
    remat = _remat_mode(cfg.remat)

    # the undirected layout's maps: bond features and weights on the bonds
    # [U], expanded to the directed edges by d2u
    und = None
    if not cfg.directed_layout:
        und = UndirectedMaps(
            batch.directed2undirected, batch.plan_d2u,
            batch.undirected2directed, batch.und_second,
        )
    dense = cfg.dense_atom_conv
    if dense and batch.dense_mask.shape[1] == 0:
        raise ValueError(
            "dense_atom_conv=True requires batches built with "
            "batch_graphs(..., dense_k=True)"
        )
    # the halo-tiled neighbour stream: the neighbour rows are gathered from
    # the expanded table (exp_map, then nbr_x) in the geometry and in every
    # AtomConv (chgnet_tpu.models.chgnet :324-331)
    tiled = batch.tiled

    def encode(pos, lat):
        """Geometry, bases, embeddings and the loop-invariant weight
        streams from the positions and lattices; rematerialized under
        ``remat`` (``chgnet_tpu.models.chgnet._encode``)."""
        lat_edges = (edge_onehot @ lat.reshape(n_graphs, 9)).reshape(-1, 3, 3)
        # positions ride a 4-wide stream (xyz, 0): one 16-byte unit per row
        pos4 = torch.nn.functional.pad(pos, (0, 1))
        center_pos = plan_gather(pos4, center, p_center)[:, :3]
        if tiled:
            pos_x = plan_gather(pos4, batch.exp_map, batch.plan_exp)
            nbr_pos = plan_gather(pos_x, batch.nbr_x, batch.plan_nbr_x)
        else:
            nbr_pos = plan_gather(pos4, nbr, p_nbr)
        nbr_pos = nbr_pos[:, :3] + torch.einsum(
            "ei,eij->ej", batch.images, lat_edges
        )
        vec = center_pos - nbr_pos
        dist = torch.linalg.norm(vec, dim=1)  # padded: |a| > 0, finite grads
        unit = vec / dist[:, None]
        geom = torch.cat([unit, dist[:, None]], dim=1)  # [E, 4]

        # the bond bases and embeddings live on the directed edges [E],
        # each reverse edge with its own (twin-equal to rounding) length,
        # or, in the undirected layout, on the bonds [U] by their first
        # edge's length
        bond_dist = dist
        if und is not None:
            bond_dist = plan_gather(geom, und.u2d, batch.plan_u2d)[:, 3]
            # a padded bond whose edge lies outside its block's gather
            # window (CHGNET_TPU_STREAM_V2 on a small batch) reads a zero
            # row: one unit long instead, so that its bases stay finite as
            # every padded edge's do (a NaN row can reach its neighbours in
            # a bf16 GEMM on the CPU); a real bond is never 0 long
            bond_dist = torch.where(bond_dist > 0, bond_dist, torch.ones_like(bond_dist))
        rbf_ag = basis.radial_bessel(
            bond_dist, params["bond_basis"]["freq_ag"], cfg.atom_graph_cutoff,
            cfg.cutoff_coeff,
        )
        rbf_bg = basis.radial_bessel(
            bond_dist, params["bond_basis"]["freq_bg"], cfg.bond_graph_cutoff,
            cfg.cutoff_coeff,
        )
        gi = plan_gather(geom, dir_i, p_i)
        gj = plan_gather(geom, dir_j, p_j)
        cos_ij = torch.sum(gi[:, :3] * gj[:, :3], dim=1) * (1 - 1e-6)
        angle_bases = basis.fourier(
            torch.arccos(cos_ij), params["angle_basis"]["freq"]
        )
        rbf_ag, rbf_bg, angle_bases = (
            x.to(conv) for x in (rbf_ag, rbf_bg, angle_bases)
        )

        bond_feas = linear_apply(params["bond_embedding"], rbf_ag)
        bond_weights_ag = linear_apply(params["bond_weights_ag"], rbf_ag)
        bond_weights_bg = linear_apply(params["bond_weights_bg"], rbf_bg)
        angle_feas = linear_apply(params["angle_embedding"], angle_bases)
        # the bond weights on the edge stream and their per-angle product
        # never change across layers: expanded once here (the dense AtomConv
        # reads the bonds' own table through its slots)
        weights_e = bond_weights_ag
        if und is not None and not dense:
            weights_e = plan_gather(bond_weights_ag, und.d2u, und.plan_d2u)
        weights_a = None
        if cfg.update_bond:
            w_dir = bond_weights_bg
            if und is not None:
                w_dir = plan_gather(bond_weights_bg, und.d2u, und.plan_d2u)
            weights_a = (
                plan_gather(w_dir, dir_i, p_i) * plan_gather(w_dir, dir_j, p_j)
            )
        return bond_feas, angle_feas, weights_e, weights_a

    bond_feas, angle_feas, weights_e, weights_a = _checkpointed(
        encode, bool(remat)
    )(pos, lat)

    z_index = (batch.atomic_numbers.long() - 1).clamp(0, cfg.max_num_elements - 1)
    atom_feas = params["atom_embedding"]["weight"][z_index]

    act = cfg.non_linearity
    fused = cfg.fused_kernels
    edge_mask = batch.edge_mask.to(conv)
    angle_mask = batch.angle_mask.to(conv)
    dense_mask = batch.dense_mask.to(conv) if dense else None
    rate = float(cfg.conv_dropout)
    block_seeds = list(seeds) if seeds is not None else [None] * (3 * cfg.n_conv + 1)

    def atom_step(atom_p, atom_feas, bond_feas, seed):
        if dense:
            return atom_conv_dense_apply(
                atom_p, atom_feas, bond_feas, weights_e, batch.dense_nbr,
                batch.dense_bond, dense_mask, batch.plan_dense_center,
                batch.plan_dense_nbr, batch.plan_dense_bond, activation=act,
            )
        nbr_part = None
        if tiled:
            atom_x = plan_gather(atom_feas, batch.exp_map, batch.plan_exp)
            nbr_part = (atom_x, batch.nbr_x, batch.plan_nbr_x)
        return atom_conv_apply(
            atom_p, atom_feas, bond_feas, weights_e, center, nbr,
            edge_mask, p_center, p_nbr, activation=act, fused=fused, und=und,
            dropout=rate, seed=seed, nbr_part=nbr_part,
        )

    def bond_step(bond_p, atom_e, bond_feas, angle_feas, seed):
        return bond_conv_apply_directed(
            bond_p, atom_e, bond_feas, weights_a, angle_feas, dir_i, dir_j,
            batch.twin, angle_mask, p_i, p_j, activation=act, fused=fused,
            und=und, dropout=rate, seed=seed,
        )

    def angle_step(angle_p, atom_e, bond_feas, angle_feas, seed):
        return angle_update_apply_directed(
            angle_p, atom_e, bond_feas, angle_feas, dir_i, dir_j, p_i, p_j,
            activation=act, fused=fused, und=und, dropout=rate, seed=seed,
        )

    # remat "all" checkpoints every layer of the blocks, "angle" only the
    # angle-stream layers (chgnet_tpu.models.chgnet :594-604)
    block_atom_step = _checkpointed(atom_step, remat == "all")
    bond_step = _checkpointed(bond_step, bool(remat))
    angle_step = _checkpointed(angle_step, bool(remat))

    atom_feas_mid = atom_feas
    for idx in range(cfg.n_conv - 1):
        atom_feas = block_atom_step(
            params["atom_convs"][idx], atom_feas, bond_feas, block_seeds[3 * idx]
        )
        # atoms on the edge stream, shared by BondConv and AngleUpdate
        atom_e = (
            plan_gather(atom_feas, center, p_center)
            if cfg.update_bond or cfg.update_angle
            else None
        )
        if cfg.update_bond:
            bond_feas = bond_step(
                params["bond_convs"][idx], atom_e, bond_feas, angle_feas,
                block_seeds[3 * idx + 1],
            )
        # the last block's angle update feeds nothing (the final AtomConv
        # reads atoms and bonds only), so it is skipped
        if cfg.update_angle and idx < cfg.n_conv - 2:
            angle_feas = angle_step(
                params["angle_updates"][idx], atom_e, bond_feas, angle_feas,
                block_seeds[3 * idx + 2],
            )
        if idx == cfg.n_conv - 2:
            atom_feas_mid = atom_feas
    atom_feas = atom_step(
        params["atom_convs"][cfg.n_conv - 1], atom_feas, bond_feas,
        block_seeds[3 * (cfg.n_conv - 1)],
    ).float()  # the readout stays f32
    if "readout_norm" in params:
        atom_feas = layer_norm_apply(params["readout_norm"], atom_feas)

    # pooling + readout over the atom -> graph plan
    p_graph = batch.plan_graph
    mask = batch.atom_mask[:, None]
    atoms_per_graph = plan_segment_sum(mask, p_graph).reshape(-1)
    aux: dict = {
        "atom_feas_mid": atom_feas_mid,
        "atom_feas": atom_feas,
        "atoms_per_graph": atoms_per_graph,
    }
    mlp_kw = dict(
        activation=act, dropout=float(cfg.mlp_dropout),
        generator=block_generator(block_seeds[-1], atom_feas.device),
    )
    if cfg.mlp_first:
        site_energies = mlp_apply(params["mlp"], atom_feas, **mlp_kw) * mask
        energy_ext = plan_segment_sum(site_energies, p_graph).reshape(-1)
        aux["site_energies"] = site_energies.reshape(-1)
        aux["crystal_fea"] = plan_segment_sum(atom_feas * mask, p_graph)
    else:
        if cfg.read_out in {"attn", "weighted"}:
            crystal_feas = attention_readout_apply(
                params["attn_readout"], atom_feas, batch.atom_owner,
                batch.atom_mask, p_graph, average=True, activation=act,
            )
        else:
            crystal_feas = plan_segment_sum(
                atom_feas * mask, p_graph
            ) / torch.clamp(atoms_per_graph[:, None], min=1.0)
        energy_ext = (
            mlp_apply(params["mlp"], crystal_feas, **mlp_kw).reshape(-1)
            * atoms_per_graph
        )
        aux["crystal_fea"] = crystal_feas
    return energy_ext, aux


def _cast_tree(tree, dtype: torch.dtype):
    """Every tensor of a parameter subtree cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_tree(v, dtype) for v in tree)
    return tree.to(dtype)


@contextlib.contextmanager
def _matmul_precision(precision: str):
    """The plain GEMMs at ``precision`` for the duration of a call: f32
    ones in full f32 for "highest", TF32 for "high" and "default"
    (``TF32_MATMULS``); bf16 ones (``compute_dtype="bfloat16"``) reduce in
    f32 for "highest" and may reduce in bf16 otherwise."""
    tf32 = TF32_MATMULS[precision]
    matmul = torch.backends.cuda.matmul
    saved = (
        matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
        matmul.allow_bf16_reduced_precision_reduction,
    )
    matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    matmul.allow_bf16_reduced_precision_reduction = tf32
    try:
        yield
    finally:
        (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = saved


def dropout_seeds(generator: torch.Generator, n_conv: int) -> list[int]:
    """``3 * n_conv + 1`` layer seeds drawn from ``generator``: the
    counterpart of ``jax.random.split(dropout_rng, 3 * n_conv + 1)``. A
    generator on the CPU draws without touching the card."""
    draws = torch.randint(
        0, 2**62, (3 * n_conv + 1,), generator=generator, device=generator.device
    )
    return draws.tolist()


def compute_batch(
    params: Params,
    batch: GraphBatch,
    *,
    config: CHGNetConfig,
    compute_force: bool = False,
    compute_stress: bool = False,
    compute_magmom: bool = False,
    dropout_generator: torch.Generator | None = None,
    create_graph: bool = False,
) -> dict[str, torch.Tensor]:
    """Batched prediction over a padded batch of tensors (``batch.to(dev)``).

    Returns padded tensors on the batch's device: e [B] (eV/atom if
    intensive), f [N, 3], s [B, 3, 3] (GPa), m [N], site_energies [N],
    crystal_fea [B, d], atom_fea [N, d], atoms_per_graph [B].

    ``dropout_generator`` turns train-mode dropout on at the configured
    ``conv_dropout`` / ``mlp_dropout`` rates (the counterpart of
    ``chgnet_tpu``'s ``dropout_rng``; see :func:`dropout_seeds`). With
    ``create_graph`` the outputs keep their autograd graph to the
    parameters, forces and stress included (the force backward is itself
    differentiable), as a training loss needs; otherwise they are detached.
    ``config.matmul_precision`` sets the plain GEMMs' precision
    (``TF32_MATMULS``); the hand-written kernels stay at f32 accuracy
    (3xTF32 on the tensor cores) under every setting.
    """
    cfg = config
    device = batch.frac_coords.device
    cfg.check_supported(device.type)
    n_graphs = batch.lattices.shape[0]
    want_grad = compute_force or compute_stress
    seeds = (
        dropout_seeds(dropout_generator, cfg.n_conv)
        if dropout_generator is not None
        else None
    )
    grad_mode = torch.enable_grad() if want_grad or create_graph else torch.no_grad()
    with _matmul_precision(cfg.matmul_precision), grad_mode:
        owner = batch.atom_owner.long()
        cart = torch.einsum(
            "ni,nij->nj", batch.frac_coords, batch.lattices[owner]
        ).detach()
        strains = torch.zeros(
            (n_graphs, 3, 3), dtype=cart.dtype, device=device
        )
        inputs = []
        if want_grad:
            cart.requires_grad_(True)
            inputs.append(cart)
            if compute_stress:
                strains.requires_grad_(True)
                inputs.append(strains)
        energy_ext, aux = _energy_core(params, cfg, batch, cart, strains, seeds)
        prediction: dict[str, torch.Tensor] = {}
        if want_grad:
            grads = torch.autograd.grad(
                energy_ext.sum(), inputs, create_graph=create_graph
            )
            if compute_force:
                prediction["f"] = -grads[0]
            if compute_stress:
                volumes = torch.abs(torch.linalg.det(batch.lattices))
                prediction["s"] = grads[-1] * EV_A3_TO_GPA / volumes[:, None, None]

        atoms_per_graph = aux["atoms_per_graph"]
        safe_counts = torch.clamp(atoms_per_graph, min=1.0)
        energy = energy_ext / safe_counts if cfg.is_intensive else energy_ext
        if "composition" in params:
            z_index = (batch.atomic_numbers.long() - 1).clamp(
                0, cfg.max_num_elements - 1
            )
            site_ref = params["composition"]["weight"][z_index] * batch.atom_mask
            comp_ext = plan_segment_sum(site_ref[:, None], batch.plan_graph).reshape(-1)
            energy = energy + (
                comp_ext / safe_counts if cfg.atom_ref_is_intensive else comp_ext
            )
            prediction["site_energies"] = aux.get(
                "site_energies", torch.zeros_like(site_ref)
            ) + site_ref
        elif "site_energies" in aux:
            prediction["site_energies"] = aux["site_energies"]

        prediction["e"] = energy
        prediction["atoms_per_graph"] = atoms_per_graph
        prediction["crystal_fea"] = aux["crystal_fea"]
        # read before the last conv block: bf16 under compute_dtype, widened
        # exactly, so m and atom_fea come out f32 (as jnp's promotion of
        # bf16 features times f32 site_wise weights)
        atom_feas_mid = aux["atom_feas_mid"].float()
        prediction["atom_fea"] = atom_feas_mid
        if compute_magmom:
            magmom = torch.abs(
                linear_apply(params["site_wise"], atom_feas_mid)
            ).reshape(-1)
            prediction["m"] = magmom * batch.atom_mask
    if create_graph:
        return prediction
    return {k: v.detach() for k, v in prediction.items()}


# ==================================================================== model
class CHGNet:
    """Host-facing model: config + parameters on one device + converter.

    Mirrors ``chgnet_tpu.models.chgnet.CHGNet``'s ``forward`` /
    ``predict_structure`` / ``predict_graph`` and its persistence
    (``as_dict`` / ``from_dict`` / ``save`` / ``from_file`` / ``load``),
    whose ``.npz`` files either package reads. ``device`` defaults to
    ``"cuda"`` and raises when CUDA is absent; tests pass ``"cpu"``.
    """

    def __init__(
        self,
        *,
        params: Params | None = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
        verbose: bool = False,
        **kwargs,
    ) -> None:
        converter_verbose = kwargs.pop("converter_verbose", False)
        field_names = {f.name for f in dataclasses.fields(CHGNetConfig)}
        unknown = set(kwargs) - field_names
        if unknown:
            warnings.warn(f"ignoring unknown model args {sorted(unknown)}")
        cfg_kwargs = {k: v for k, v in kwargs.items() if k in field_names}
        if "atom_ref_is_intensive" not in cfg_kwargs:
            # the AtomRef's intensiveness follows the dataset its weights
            # come from (upstream composition_model.py:320,425,532)
            comp = cfg_kwargs.get("composition_model", "MPtrj")
            cfg_kwargs["atom_ref_is_intensive"] = comp != "MPF"
        self.config = CHGNetConfig(**cfg_kwargs)
        self.device = resolve_device(device)
        self.config.check_supported(self.device.type)
        self.params = params_from_jax(
            params if params is not None else init_params(self.config, seed),
            self.device,
        )
        self.graph_converter = CrystalGraphConverter(
            atom_graph_cutoff=self.config.atom_graph_cutoff,
            bond_graph_cutoff=self.config.bond_graph_cutoff,
            algorithm=self.config.graph_converter_algorithm,
            verbose=converter_verbose,
        )
        if verbose:
            print(f"CHGNet (torch) initialized with {self.n_params:,} parameters")

    def to(self, device: str | torch.device) -> CHGNet:
        """Move the parameters to ``device`` (raises as the constructor
        does for a device the config cannot run on); returns the model."""
        dev = resolve_device(device)
        self.config.check_supported(dev.type)
        self.params = params_from_jax(params_to_numpy(self.params), dev)
        self.device = dev
        return self

    @property
    def version(self) -> str | None:
        return self.config.version

    @property
    def n_params(self) -> int:
        return count_params(self.params)

    @property
    def is_intensive(self) -> bool:
        return self.config.is_intensive

    def forward(
        self, graphs: Sequence[CrystalGraph], *, task: PredTask = "e"
    ) -> dict:
        """Batched prediction: 'e' [B] plus per-graph lists for f/s/m."""
        batch = batch_graphs(graphs, dense_k=self.config.dense_atom_conv).to(
            self.device
        )
        out = compute_batch(
            self.params,
            batch,
            config=self.config,
            compute_force="f" in task,
            compute_stress="s" in task,
            compute_magmom="m" in task,
        )
        return self._unpad({k: v.cpu().numpy() for k, v in out.items()}, graphs, task)

    __call__ = forward

    @staticmethod
    def _unpad(out: dict, graphs: Sequence[CrystalGraph], task: str) -> dict:
        n_graphs = len(graphs)
        offsets = np.concatenate([[0], np.cumsum([g.n_atoms for g in graphs])])

        def per_atom(arr):
            return [arr[offsets[i]: offsets[i + 1]] for i in range(n_graphs)]

        result: dict = {
            "e": out["e"][:n_graphs],
            "atoms_per_graph": out["atoms_per_graph"][:n_graphs],
        }
        if "f" in task:
            result["f"] = per_atom(out["f"])
        if "s" in task:
            result["s"] = [out["s"][i] for i in range(n_graphs)]
        if "m" in task:
            result["m"] = per_atom(out["m"])
        for key in ("site_energies", "atom_fea"):
            if key in out:
                result[key] = per_atom(out[key])
        result["crystal_fea"] = [out["crystal_fea"][i] for i in range(n_graphs)]
        return result

    def predict_structure(
        self,
        structure: Structure | Sequence[Structure],
        *,
        task: PredTask = "efsm",
        batch_size: int = 16,
        return_site_energies: bool = False,
        return_atom_feas: bool = False,
        return_crystal_feas: bool = False,
    ):
        """Predict E (eV/atom), F (eV/A), S (GPa), M (mu_B) from structures."""
        structures = (
            [structure] if isinstance(structure, Structure) else list(structure)
        )
        graphs = [self.graph_converter(s) for s in structures]
        return self.predict_graph(
            graphs,
            task=task,
            batch_size=batch_size,
            return_site_energies=return_site_energies,
            return_atom_feas=return_atom_feas,
            return_crystal_feas=return_crystal_feas,
        )

    def predict_graph(
        self,
        graph: CrystalGraph | Sequence[CrystalGraph],
        *,
        task: PredTask = "efsm",
        batch_size: int = 16,
        return_site_energies: bool = False,
        return_atom_feas: bool = False,
        return_crystal_feas: bool = False,
    ):
        """Predict from graphs; one numpy-valued dict per graph (or a single
        dict for a single input)."""
        graphs = [graph] if isinstance(graph, CrystalGraph) else list(graph)
        predictions: list[dict] = [{} for _ in graphs]
        for step in range(math.ceil(len(graphs) / batch_size)):
            chunk = graphs[batch_size * step: batch_size * (step + 1)]
            out = self.forward(chunk, task=task)
            for idx in range(len(chunk)):
                pred = predictions[step * batch_size + idx]
                pred["e"] = float(out["e"][idx])
                for key in "fsm":
                    if key in task:
                        pred[key] = out[key][idx]
                if return_site_energies:
                    pred["site_energies"] = out["site_energies"][idx]
                if return_atom_feas:
                    pred["atom_fea"] = out["atom_fea"][idx]
                if return_crystal_feas:
                    pred["crystal_fea"] = out["crystal_fea"][idx]
        return predictions[0] if len(graphs) == 1 else predictions

    # ---------------------------------------------------------- persistence
    def as_dict(self) -> dict:
        """Parameters (numpy, ``chgnet_tpu``'s layout) and model args."""
        return {
            "params": params_to_numpy(self.params),
            "model_args": self.config.as_dict(),
        }

    def save(self, path: str) -> None:
        """Save params + config to one ``.npz`` checkpoint, in the layout
        ``chgnet_tpu``'s ``CHGNet.save`` writes."""
        save_params(params_to_numpy(self.params), self.config.as_dict(), path)

    @classmethod
    def from_dict(cls, dct: dict, **kwargs) -> CHGNet:
        return cls(params=dct["params"], **{**dct["model_args"], **kwargs})

    @classmethod
    def from_file(cls, path: str, **kwargs) -> CHGNet:
        """Load a ``.npz`` checkpoint (either package's), or convert an
        upstream torch ``.pth.tar`` on the fly. ``kwargs`` (``device``
        among them) override the stored model args."""
        if path.endswith((".pth.tar", ".pt", ".tar")):
            from chgnet_tpu_torch.models.checkpoint import load_torch_checkpoint

            params, model_args = load_torch_checkpoint(path)
        else:
            params, model_args = load_params(path)
        model_args.update(kwargs)
        return cls(params=params, **model_args)

    @classmethod
    def load(
        cls,
        *,
        model_name: str = "0.3.0",
        device: str | torch.device = "cuda",
        verbose: bool = True,
    ) -> CHGNet:
        """Load pretrained weights by name from the first root that holds
        them: ``chgnet_tpu_torch/pretrained``, ``$CHGNET_TPU_WEIGHTS``, then
        ``~/.cache/chgnet_tpu``; in each, ``<name>.npz``, then
        ``<name>/*.pth.tar``, then ``*<name>*.pth.tar``. Nothing is fetched:
        with no weights found it raises ``FileNotFoundError``."""
        known = {"0.3.0", "0.2.0", "r2scan"}
        if model_name not in known:
            raise ValueError(f"Unknown {model_name=}, choose from {known}")
        roots = [os.path.join(os.path.dirname(__file__), "..", "pretrained")]
        if os.environ.get("CHGNET_TPU_WEIGHTS"):
            roots.append(os.environ["CHGNET_TPU_WEIGHTS"])
        roots.append(os.path.join(os.path.expanduser("~"), ".cache", "chgnet_tpu"))
        found = None
        for root in roots:
            for pattern in (
                f"{model_name}.npz",
                f"{model_name}/*.pth.tar",
                f"*{model_name}*.pth.tar",
            ):
                hits = sorted(glob.glob(os.path.join(root, pattern)))
                if hits:
                    found = hits[0]
                    break
            if found:
                break
        if found is None:
            raise FileNotFoundError(
                f"No pretrained weights for {model_name!r} under "
                f"{[os.path.abspath(r) for r in roots]}. Place the published "
                "upstream .pth.tar (or a converted .npz) in one of these "
                "directories, or point CHGNET_TPU_WEIGHTS at it."
            )
        model = cls.from_file(found, version=model_name, device=device)
        if verbose:
            print(f"CHGNet (torch) {model_name} loaded ({model.n_params:,} params)")
        return model

    def todict(self) -> dict:
        return {"model_name": type(self).__name__, "model_args": self.config.as_dict()}
