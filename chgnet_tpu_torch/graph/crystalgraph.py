"""CrystalGraph: the per-structure flat-array graph container.

Mirrors the upstream CHGNet container (``chgnet/graph/
crystalgraph.py:15-198``) but holds plain numpy arrays instead of torch
tensors with requires_grad: differentiability is a property of the
energy function (one ``torch.autograd.grad`` over positions and strain),
not of the data. Copied from ``chgnet_tpu.graph.crystalgraph``.
Serialization uses ``.npz`` instead of torch pickles.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

DTYPE = np.float32
IDTYPE = np.int32


@dataclass
class CrystalGraph:
    """Flat-array crystal graph for one structure.

    Attributes (invariant: n_directed == 2 * n_undirected):
        atomic_number: int32 [n_atoms]
        atom_frac_coord: float32 [n_atoms, 3]
        atom_graph: int32 [n_directed, 2] (center, neighbor)
        neighbor_image: float32 [n_directed, 3]
        directed2undirected: int32 [n_directed]
        undirected2directed: int32 [n_undirected]
        bond_graph: int32 [n_angle, 5]
            (center_atom, undirected_i, directed_i, undirected_j, directed_j)
        lattice: float32 [3, 3] row-vector lattice
    """

    atomic_number: np.ndarray
    atom_frac_coord: np.ndarray
    atom_graph: np.ndarray
    neighbor_image: np.ndarray
    directed2undirected: np.ndarray
    undirected2directed: np.ndarray
    bond_graph: np.ndarray
    lattice: np.ndarray
    graph_id: str | None = None
    mp_id: str | None = None
    composition: str = ""
    atom_graph_cutoff: float = 6.0
    bond_graph_cutoff: float = 3.0
    extra: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.atomic_number = np.asarray(self.atomic_number, dtype=IDTYPE)
        self.atom_frac_coord = np.asarray(self.atom_frac_coord, dtype=DTYPE)
        self.atom_graph = np.asarray(self.atom_graph, dtype=IDTYPE).reshape(-1, 2)
        self.neighbor_image = np.asarray(self.neighbor_image, dtype=DTYPE).reshape(
            -1, 3
        )
        self.directed2undirected = np.asarray(
            self.directed2undirected, dtype=IDTYPE
        )
        self.undirected2directed = np.asarray(
            self.undirected2directed, dtype=IDTYPE
        )
        self.bond_graph = np.asarray(self.bond_graph, dtype=IDTYPE).reshape(-1, 5)
        self.lattice = np.asarray(self.lattice, dtype=DTYPE).reshape(3, 3)
        if len(self.directed2undirected) != 2 * len(self.undirected2directed):
            raise ValueError(
                f"{self.graph_id=}: n_directed "
                f"({len(self.directed2undirected)}) != 2 * n_undirected "
                f"({len(self.undirected2directed)})"
            )

    @property
    def n_atoms(self) -> int:
        return len(self.atomic_number)

    @property
    def n_directed(self) -> int:
        return len(self.atom_graph)

    @property
    def n_undirected(self) -> int:
        return len(self.undirected2directed)

    @property
    def n_angles(self) -> int:
        return len(self.bond_graph)

    @property
    def num_isolated_atoms(self) -> int:
        """Number of atoms with no incident edges."""
        return self.n_atoms - len(np.unique(self.atom_graph[:, 0]))

    def __repr__(self) -> str:
        return (
            f"CrystalGraph({self.composition}, atom_graph_cutoff="
            f"{self.atom_graph_cutoff}, bond_graph_cutoff="
            f"{self.bond_graph_cutoff}, n_atoms={self.n_atoms}, "
            f"atom_graph_len={self.n_directed}, bond_graph_len={self.n_angles})"
        )

    def save(self, fname: str | None = None, save_dir: str = ".") -> str:
        """Save to compressed ``.npz`` (+ json-able metadata)."""
        import os

        if fname is None:
            fname = f"{self.composition}.npz"
        path = os.path.join(save_dir, fname)
        np.savez_compressed(
            path,
            atomic_number=self.atomic_number,
            atom_frac_coord=self.atom_frac_coord,
            atom_graph=self.atom_graph,
            neighbor_image=self.neighbor_image,
            directed2undirected=self.directed2undirected,
            undirected2directed=self.undirected2directed,
            bond_graph=self.bond_graph,
            lattice=self.lattice,
            meta=np.array(
                [
                    str(self.graph_id),
                    str(self.mp_id),
                    self.composition,
                    str(self.atom_graph_cutoff),
                    str(self.bond_graph_cutoff),
                ]
            ),
        )
        return path

    @classmethod
    def from_file(cls, file_name: str) -> CrystalGraph:
        """Load a graph saved with :meth:`save`."""
        data = np.load(file_name, allow_pickle=False)
        meta = data["meta"]
        return cls(
            atomic_number=data["atomic_number"],
            atom_frac_coord=data["atom_frac_coord"],
            atom_graph=data["atom_graph"],
            neighbor_image=data["neighbor_image"],
            directed2undirected=data["directed2undirected"],
            undirected2directed=data["undirected2directed"],
            bond_graph=data["bond_graph"],
            lattice=data["lattice"],
            graph_id=None if meta[0] == "None" else str(meta[0]),
            mp_id=None if meta[1] == "None" else str(meta[1]),
            composition=str(meta[2]),
            atom_graph_cutoff=float(meta[3]),
            bond_graph_cutoff=float(meta[4]),
        )
