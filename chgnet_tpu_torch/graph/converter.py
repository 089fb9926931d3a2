"""Structure -> CrystalGraph conversion.

Mirrors the upstream CHGNet ``CrystalGraphConverter``
(``chgnet/graph/converter.py:29-291``): radius neighbor search, edge
pairing, line graph, isolated-atom policy and error dumping. Copied from
``chgnet_tpu.graph.converter``, with two interchangeable builders:

* ``"fast"`` (the default): the port's C++ builder (``graph/fast``), neighbor
  search and topology in one native call. It has no fallback: a library
  that cannot be built makes the constructor raise;
* ``"numpy"`` (alias ``"legacy"``): the vectorized numpy builder, the
  semantic spec. An unknown name warns and uses it, as ``chgnet_tpu`` does.
"""

from __future__ import annotations

import sys
import warnings
from typing import Literal

import numpy as np

from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.graph.builder import build_graph_arrays
from chgnet_tpu_torch.graph.crystalgraph import CrystalGraph
from chgnet_tpu_torch.graph.fast import fast_graph
from chgnet_tpu_torch.graph.neighbors import get_neighbor_list


class CrystalGraphConverter:
    """Convert Structures into CrystalGraphs with two cutoff radii."""

    def __init__(
        self,
        *,
        atom_graph_cutoff: float = 6.0,
        bond_graph_cutoff: float = 3.0,
        algorithm: Literal["numpy", "fast", "legacy"] = "fast",
        on_isolated_atoms: Literal["ignore", "warn", "error"] = "error",
        verbose: bool = False,
    ) -> None:
        self.atom_graph_cutoff = atom_graph_cutoff
        self.bond_graph_cutoff = (
            atom_graph_cutoff if bond_graph_cutoff is None else bond_graph_cutoff
        )
        self.on_isolated_atoms = on_isolated_atoms

        if algorithm == "legacy":  # reference-API compatibility alias
            algorithm = "numpy"
        if algorithm == "fast":
            fast_graph.load()  # build the library now: raises if it cannot
        elif algorithm != "numpy":
            warnings.warn(
                f"Unknown {algorithm=}, using `numpy`", UserWarning, stacklevel=2
            )
            algorithm = "numpy"
        self.algorithm = algorithm

        if verbose:
            print(self)

    def __repr__(self) -> str:
        atom_graph_cutoff = self.atom_graph_cutoff
        bond_graph_cutoff = self.bond_graph_cutoff
        algorithm = self.algorithm
        return (
            f"{type(self).__name__}({algorithm=}, {atom_graph_cutoff=}, "
            f"{bond_graph_cutoff=})"
        )

    def __call__(
        self,
        structure: Structure,
        graph_id: str | None = None,
        mp_id: str | None = None,
    ) -> CrystalGraph:
        return self.forward(structure, graph_id=graph_id, mp_id=mp_id)

    def forward(
        self,
        structure: Structure,
        graph_id: str | None = None,
        mp_id: str | None = None,
    ) -> CrystalGraph:
        """Convert one structure to a CrystalGraph."""
        n_atoms = len(structure)

        if self.algorithm == "fast":
            arrays = fast_graph.build(
                structure, self.atom_graph_cutoff, self.bond_graph_cutoff
            )
        else:
            center, neighbor, image, dist = get_neighbor_list(
                structure, r=self.atom_graph_cutoff
            )
            try:
                arrays = build_graph_arrays(
                    n_atoms, center, neighbor, image, dist, self.bond_graph_cutoff
                )
            except Exception as exc:
                structure.to("bond_graph_error.cif")
                raise RuntimeError(
                    f"Failed creating bond graph for {graph_id}, check "
                    "bond_graph_error.cif"
                ) from exc

        n_isolated = n_atoms - len(np.unique(arrays.atom_graph[:, 0]))
        if n_isolated:
            atom_graph_cutoff = self.atom_graph_cutoff
            msg = (
                f"Structure {graph_id=} has {n_isolated} isolated atom(s) with "
                f"{atom_graph_cutoff=}. The model prediction will likely be wrong"
            )
            if self.on_isolated_atoms == "error":
                raise ValueError(msg)
            if self.on_isolated_atoms == "warn":
                print(msg, file=sys.stderr)

        return CrystalGraph(
            atomic_number=structure.atomic_numbers,
            atom_frac_coord=structure.frac_coords,
            atom_graph=arrays.atom_graph,
            neighbor_image=arrays.neighbor_image,
            directed2undirected=arrays.directed2undirected,
            undirected2directed=arrays.undirected2directed,
            bond_graph=arrays.bond_graph,
            lattice=structure.lattice.matrix,
            graph_id=graph_id,
            mp_id=mp_id,
            composition=structure.formula,
            atom_graph_cutoff=self.atom_graph_cutoff,
            bond_graph_cutoff=self.bond_graph_cutoff,
        )

    def set_isolated_atom_response(
        self, on_isolated_atoms: Literal["ignore", "warn", "error"]
    ) -> None:
        """Set the converter's response to structures with isolated atoms."""
        self.on_isolated_atoms = on_isolated_atoms

    def as_dict(self) -> dict:
        return {
            "atom_graph_cutoff": self.atom_graph_cutoff,
            "bond_graph_cutoff": self.bond_graph_cutoff,
            "algorithm": self.algorithm,
        }

    @classmethod
    def from_dict(cls, dct: dict) -> CrystalGraphConverter:
        return cls(**dct)
