"""Standalone encoder functions: atom embedding, bond encoder, angle encoder.

Port of ``chgnet_tpu.models.encoders`` (upstream CHGNet
``chgnet/model/encoders.py``). The model's pass
(:func:`~chgnet_tpu_torch.models.chgnet.compute_batch`) computes the same
formulas inline; the functions here expose them standalone for feature
extraction, analysis and tests. Parameters are the model's dicts of
tensors (``CHGNet.params["atom_embedding"]``, ``["bond_basis"]``,
``["angle_basis"]``).
"""

from __future__ import annotations

import torch

from chgnet_tpu_torch.models import basis


def atom_embedding_apply(
    params: dict, atomic_numbers: torch.Tensor, *, max_num_elements: int = 94
) -> torch.Tensor:
    """Element embedding rows keyed by Z - 1, clipped to the table."""
    z_index = torch.clamp(atomic_numbers.long() - 1, 0, max_num_elements - 1)
    return params["weight"][z_index]


def bond_encoder(
    bond_basis_params: dict,
    *,
    center_pos: torch.Tensor,  # [U, 3] cartesian
    neighbor_pos: torch.Tensor,  # [U, 3] cartesian (image already applied)
    atom_graph_cutoff: float = 6.0,
    bond_graph_cutoff: float = 3.0,
    cutoff_coeff: float = 8.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bond vectors -> (rbf_atom_graph, rbf_bond_graph, unit vectors):
    vec = center - neighbor, two radial Bessel expansions with smooth
    polynomial cutoffs. A zero-length bond gives NaN, as upstream."""
    vec = center_pos - neighbor_pos
    dist = torch.linalg.norm(vec, dim=1)
    unit = vec / dist[:, None]
    rbf_ag = basis.radial_bessel(
        dist, bond_basis_params["freq_ag"], atom_graph_cutoff, cutoff_coeff
    )
    rbf_bg = basis.radial_bessel(
        dist, bond_basis_params["freq_bg"], bond_graph_cutoff, cutoff_coeff
    )
    return rbf_ag, rbf_bg, unit


def angle_encoder(
    angle_basis_params: dict,
    *,
    unit_vec_i: torch.Tensor,  # [A, 3]
    unit_vec_j: torch.Tensor,  # [A, 3]
) -> torch.Tensor:
    """Unit bond vectors -> Fourier angle basis; the cosine is scaled by
    (1 - 1e-6) so that arccos stays finite for parallel vectors."""
    cos_ij = torch.sum(unit_vec_i * unit_vec_j, dim=1) * (1 - 1e-6)
    return basis.fourier(torch.arccos(cos_ij), angle_basis_params["freq"])
