"""Trajectory capture for relaxation and molecular dynamics.

Copy of ``chgnet_tpu.simulation.observers``: upstream CHGNet's observers
with the same pickle payload schema, fed from the batched padded arrays a
chunk of steps reads back instead of being ASE callbacks.
"""

from __future__ import annotations

import pickle

import numpy as np


class TrajectoryObserver:
    """Per-step record of energies/forces/stresses/magmoms/positions/cells.

    ``save()`` writes upstream CHGNet's pickle schema, so downstream
    analysis scripts keep working.
    """

    def __init__(self, atomic_numbers: np.ndarray | None = None) -> None:
        self.energies: list[float] = []
        self.forces: list[np.ndarray] = []
        self.stresses: list[np.ndarray] = []
        self.magmoms: list[np.ndarray] = []
        self.atom_positions: list[np.ndarray] = []
        self.cells: list[np.ndarray] = []
        self.atomic_numbers = (
            None if atomic_numbers is None else np.asarray(atomic_numbers)
        )

    def record(
        self,
        *,
        energy: float,
        forces: np.ndarray,
        stress: np.ndarray | None = None,
        magmoms: np.ndarray | None = None,
        positions: np.ndarray | None = None,
        cell: np.ndarray | None = None,
    ) -> None:
        self.energies.append(float(energy))
        self.forces.append(np.asarray(forces))
        if stress is not None:
            self.stresses.append(np.asarray(stress))
        if magmoms is not None:
            self.magmoms.append(np.asarray(magmoms))
        if positions is not None:
            self.atom_positions.append(np.asarray(positions))
        if cell is not None:
            self.cells.append(np.asarray(cell))

    def __len__(self) -> int:
        return len(self.energies)

    def compute_energy(self) -> float:
        """Latest recorded potential energy (eV)."""
        return self.energies[-1]

    def save(self, filename: str) -> None:
        out_pkl = {
            "energy": self.energies,
            "forces": self.forces,
            "stresses": self.stresses,
            "magmoms": self.magmoms,
            "atom_positions": self.atom_positions,
            "cell": self.cells,
            "atomic_number": self.atomic_numbers,
        }
        with open(filename, "wb") as file:
            pickle.dump(out_pkl, file)


class CrystalFeasObserver:
    """Record of per-step crystal feature vectors."""

    def __init__(self) -> None:
        self.crystal_feature_vectors: list[np.ndarray] = []

    def record(self, crystal_fea: np.ndarray) -> None:
        self.crystal_feature_vectors.append(np.asarray(crystal_fea))

    def __len__(self) -> int:
        return len(self.crystal_feature_vectors)

    def save(self, filename: str) -> None:
        with open(filename, "wb") as file:
            pickle.dump(
                {"crystal_feas": self.crystal_feature_vectors}, file
            )
