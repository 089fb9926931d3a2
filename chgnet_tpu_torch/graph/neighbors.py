"""Periodic radius neighbor search (host side).

Replaces pymatgen's ``Structure.get_neighbor_list`` (called at
``chgnet/graph/converter.py:132-134``). Returns the same
four arrays: directed (center, neighbor, image, distance) for every ordered
pair with 0 < d <= r + tol, where ``image`` is the periodic cell of the
neighbor site relative to its stored coordinates.

Implementation: enumerate the bounded set of lattice images that can hold a
neighbor within ``r`` (bound from reciprocal plane spacings), tile neighbor
candidate positions, and query with a cKDTree — O((N * n_images) log N)
instead of the naive O(N^2 * n_images).

A deterministic canonical ordering is applied: edges sorted by (center,
neighbor, image_a, image_b, image_c). All downstream index maps
(directed2undirected, line graph) inherit this ordering, making graph
construction reproducible across builders (numpy and C++).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from chgnet_tpu_torch.core.structure import Structure


def get_neighbor_list(
    structure: Structure,
    r: float,
    numerical_tol: float = 1e-8,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All directed periodic neighbor pairs within radius ``r``.

    Returns:
        center_index: int64 [n_edges]
        neighbor_index: int64 [n_edges]
        image: int64 [n_edges, 3] periodic image of the neighbor
        distance: float64 [n_edges]
    """
    lattice = structure.lattice
    frac = structure.frac_coords
    cart = frac @ lattice.matrix
    n_atoms = len(structure)
    if n_atoms == 0:
        empty_i = np.zeros(0, dtype=np.int64)
        return empty_i, empty_i, np.zeros((0, 3), dtype=np.int64), np.zeros(0)

    spacings = lattice.plane_spacings
    # images along each axis must cover the cutoff sphere plus any coordinate
    # spread when sites are stored outside [0, 1)
    spread = np.maximum(frac.max(axis=0) - frac.min(axis=0), 0.0)
    n_img = np.ceil(r / spacings + spread + numerical_tol).astype(np.int64)
    axes = [np.arange(-n, n + 1) for n in n_img]
    shifts = (
        np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
        .reshape(-1, 3)
        .astype(np.int64)
    )
    n_shifts = len(shifts)

    # candidate neighbor positions: [n_shifts * n_atoms, 3]
    shift_cart = shifts.astype(np.float64) @ lattice.matrix
    candidates = (cart[None, :, :] + shift_cart[:, None, :]).reshape(-1, 3)

    tree = cKDTree(candidates)
    cutoff = r + numerical_tol
    pairs = tree.query_ball_point(cart, cutoff)  # list of candidate idx lists

    centers, flat = [], []
    for i, hits in enumerate(pairs):
        centers.extend([i] * len(hits))
        flat.extend(hits)
    center_index = np.asarray(centers, dtype=np.int64)
    flat = np.asarray(flat, dtype=np.int64)
    neighbor_index = flat % n_atoms
    image = shifts[flat // n_atoms]

    diff = candidates[flat] - cart[center_index]
    distance = np.linalg.norm(diff, axis=1)

    keep = distance > numerical_tol  # drop exact self-pair (zero image)
    center_index, neighbor_index = center_index[keep], neighbor_index[keep]
    image, distance = image[keep], distance[keep]

    # canonical deterministic ordering
    order = np.lexsort(
        (image[:, 2], image[:, 1], image[:, 0], neighbor_index, center_index)
    )
    return center_index[order], neighbor_index[order], image[order], distance[order]
