"""Directed->undirected edge pairing and line-graph (angle) enumeration.

Semantics match the reference's incremental object-graph algorithm
(``chgnet/graph/graph.py:132-328``) but the implementation
is a vectorized array program (no Node/Edge objects, no hashmaps):

* every directed edge (i, j, image) has a reverse partner (j, i, -image);
  pairing on the canonical key (min(i,j), max(i,j), canonical image) is
  exact, so the reference's distance-tolerance scan is unnecessary,
* undirected edges are numbered by first appearance in the directed edge
  scan, exactly as the reference numbers them,
* the line graph enumerates, for each undirected bond with d <= cutoff and
  for each of its two directed edges (center c), all other directed edges
  from c with d < cutoff, in directed-index order.

Because the input edges are canonically ordered (see
``chgnet_tpu_torch.graph.neighbors``), all emitted index maps are deterministic;
the C++ fast builder reproduces them bit-for-bit (equivalence-tested).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class GraphArrays:
    """Flat-array crystal graph topology.

    Attributes:
        atom_graph: int64 [n_directed, 2] (center, neighbor) per directed edge
        neighbor_image: int64 [n_directed, 3] periodic image of the neighbor
        directed2undirected: int64 [n_directed] undirected id per directed edge
        undirected2directed: int64 [n_undirected] first directed edge per
            undirected edge
        bond_graph: int64 [n_angle, 5] rows
            (center_atom, undirected_i, directed_i, undirected_j, directed_j)
        distances: float64 [n_directed]
        n_atoms: int
    """

    atom_graph: np.ndarray
    neighbor_image: np.ndarray
    directed2undirected: np.ndarray
    undirected2directed: np.ndarray
    bond_graph: np.ndarray
    distances: np.ndarray
    n_atoms: int

    @property
    def n_directed(self) -> int:
        return len(self.atom_graph)

    @property
    def n_undirected(self) -> int:
        return len(self.undirected2directed)

    @property
    def n_angles(self) -> int:
        return len(self.bond_graph)


def pair_directed_edges(
    center: np.ndarray, neighbor: np.ndarray, image: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group directed edges into undirected pairs.

    Returns (directed2undirected, undirected2directed_first, second_directed)
    where the undirected numbering follows first appearance in scan order.

    Raises:
        ValueError: if any undirected edge does not have exactly two directed
            members (i.e. the input neighbor list is not reverse-complete) —
            mirrors ``graph.py:273-278`` in the reference.
    """
    center = np.asarray(center, dtype=np.int64)
    neighbor = np.asarray(neighbor, dtype=np.int64)
    image = np.asarray(image, dtype=np.int64).reshape(-1, 3)

    swap = center > neighbor
    # self-edges (i == j): canonicalize image by lexicographic sign choice
    self_edge = center == neighbor
    img_key = np.where(swap[:, None], -image, image)
    if np.any(self_edge):
        flip = self_edge & (
            (image[:, 0] < -image[:, 0])
            | ((image[:, 0] == -image[:, 0]) & (image[:, 1] < -image[:, 1]))
            | (
                (image[:, 0] == -image[:, 0])
                & (image[:, 1] == -image[:, 1])
                & (image[:, 2] < -image[:, 2])
            )
        )
        img_key = np.where(flip[:, None], -image, img_key)

    keys = np.concatenate(
        [
            np.minimum(center, neighbor)[:, None],
            np.maximum(center, neighbor)[:, None],
            img_key,
        ],
        axis=1,
    )
    _, first_idx, inverse = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    inverse = inverse.reshape(-1)
    # renumber unique keys by first appearance in the scan
    appearance = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(appearance)
    rank[appearance] = np.arange(len(appearance))
    directed2undirected = rank[inverse]
    undirected2directed = first_idx[appearance]

    counts = np.bincount(directed2undirected, minlength=len(appearance))
    if np.any(counts != 2):
        bad = int(np.argmax(counts != 2))
        raise ValueError(
            f"undirected edge {bad} has {int(counts[bad])} directed members "
            "(expected 2); neighbor list is not reverse-complete"
        )

    members = np.argsort(directed2undirected, kind="stable")
    second_directed = members[1::2]
    return directed2undirected, undirected2directed, second_directed


def line_graph(
    center: np.ndarray,
    distances: np.ndarray,
    directed2undirected: np.ndarray,
    undirected2directed: np.ndarray,
    second_directed: np.ndarray,
    n_atoms: int,
    cutoff: float,
) -> np.ndarray:
    """Enumerate angle rows (center, und_i, dir_i, und_j, dir_j).

    Semantics of ``graph.py:249-328``: undirected bonds participate as the
    left bond when d <= cutoff; the right bond ranges over all directed
    edges sharing the center atom with d < cutoff, excluding the left bond's
    own directed edge at that center.
    """
    center = np.asarray(center, dtype=np.int64)
    distances = np.asarray(distances, dtype=np.float64)

    short = np.nonzero(distances < cutoff)[0]  # directed, in index order
    short_centers = center[short]
    # `center` is ascending in canonical order, so short_centers is sorted
    offsets = np.searchsorted(short_centers, np.arange(n_atoms + 1))

    u_dist = distances[undirected2directed]
    sel = np.nonzero(u_dist <= cutoff)[0]  # undirected ids, ascending
    if len(sel) == 0:
        return np.zeros((0, 5), dtype=np.int64)

    d_first = undirected2directed[sel]
    d_second = second_directed[sel]
    ends_d = np.stack([d_first, d_second], axis=1).reshape(-1)
    ends_u = np.repeat(sel, 2)
    ends_c = center[ends_d]

    cnt = offsets[ends_c + 1] - offsets[ends_c]
    row_ptr = np.concatenate([[0], np.cumsum(cnt)])
    total = int(row_ptr[-1])
    if total == 0:
        return np.zeros((0, 5), dtype=np.int64)
    end_of_row = np.repeat(np.arange(len(ends_d)), cnt)
    intra = np.arange(total) - row_ptr[end_of_row]
    other = short[offsets[ends_c[end_of_row]] + intra]

    keep = other != ends_d[end_of_row]
    end_sel = end_of_row[keep]
    other = other[keep]
    return np.stack(
        [
            ends_c[end_sel],
            ends_u[end_sel],
            ends_d[end_sel],
            directed2undirected[other],
            other,
        ],
        axis=1,
    )


def build_graph_arrays(
    n_atoms: int,
    center: np.ndarray,
    neighbor: np.ndarray,
    image: np.ndarray,
    distance: np.ndarray,
    bond_graph_cutoff: float,
) -> GraphArrays:
    """Full topology build from a canonical directed neighbor list."""
    center = np.asarray(center, dtype=np.int64)
    neighbor = np.asarray(neighbor, dtype=np.int64)
    image = np.asarray(image, dtype=np.int64).reshape(-1, 3)
    distance = np.asarray(distance, dtype=np.float64)

    if len(center) == 0:
        return GraphArrays(
            atom_graph=np.zeros((0, 2), dtype=np.int64),
            neighbor_image=np.zeros((0, 3), dtype=np.int64),
            directed2undirected=np.zeros(0, dtype=np.int64),
            undirected2directed=np.zeros(0, dtype=np.int64),
            bond_graph=np.zeros((0, 5), dtype=np.int64),
            distances=np.zeros(0),
            n_atoms=n_atoms,
        )

    d2u, u2d, second = pair_directed_edges(center, neighbor, image)
    angles = line_graph(center, distance, d2u, u2d, second, n_atoms, bond_graph_cutoff)
    return GraphArrays(
        atom_graph=np.stack([center, neighbor], axis=1),
        neighbor_image=image,
        directed2undirected=d2u,
        undirected2directed=u2d,
        bond_graph=angles,
        distances=distance,
        n_atoms=n_atoms,
    )
