"""Single-point calculator over the port's CHGNet.

Port of ``chgnet_tpu.simulation.calculator``: energy / forces / stress /
magmoms for one Structure, kept in ``.results`` with upstream CHGNet's
unit conventions (total energy in eV, the intensive model output times
n_atoms; forces in eV/A; stress in eV/A^3 by the GPa conversion; magmoms in
mu_B). It also quacks like an ASE calculator (``calculate(atoms)``) without
needing ASE.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.simulation.units import GPA_TO_EV_A3


def voigt_6(stress: np.ndarray) -> np.ndarray:
    """3x3 symmetric stress -> Voigt 6-vector (xx, yy, zz, yz, xz, xy)."""
    sym = 0.5 * (stress + stress.T)
    return np.array(
        [sym[0, 0], sym[1, 1], sym[2, 2], sym[1, 2], sym[0, 2], sym[0, 1]]
    )


def resolve_model(model, use_device: str | None):
    """The CHGNet a simulation entry point runs: ``model`` (or the model of
    a calculator passed in its place), or with None the pretrained one,
    loaded on ``use_device`` (default ``"cuda"``). A ``use_device`` that
    names another device than a given model's raises: the model is never
    moved quietly."""
    if model is None:
        from chgnet_tpu_torch.models.chgnet import CHGNet

        return CHGNet.load(device=use_device or "cuda", verbose=False)
    if hasattr(model, "model"):  # a CHGNetCalculator
        model = model.model
    if use_device is not None:
        want, have = torch.device(use_device), model.device
        if want.type != have.type or (
            want.index is not None and (have.index or 0) != want.index
        ):
            raise ValueError(
                f"use_device={use_device!r} but the model is on {have}; "
                "build the model on that device instead"
            )
    return model


class CHGNetCalculator:
    """Calculator wrapping :class:`chgnet_tpu_torch.models.chgnet.CHGNet`.

    Upstream CHGNet's properties: energy, forces, stress, magmoms plus
    free_energy, crystal_fea and optional per-site energies. It runs on
    its model's device.
    """

    implemented_properties = ("energy", "forces", "stress", "magmoms", "energies")

    def __init__(
        self,
        model=None,
        *,
        use_device: str | None = None,
        stress_weight: float = GPA_TO_EV_A3,
        on_isolated_atoms: Literal["ignore", "warn", "error"] = "warn",
        return_site_energies: bool = False,
        **kwargs,
    ) -> None:
        self.model = resolve_model(model, use_device)
        self.stress_weight = stress_weight
        self.return_site_energies = return_site_energies
        self.model.graph_converter.set_isolated_atom_response(on_isolated_atoms)
        self.results: dict = {}
        self.atoms: Structure | None = None

    @property
    def version(self) -> str | None:
        return self.model.version

    @property
    def n_params(self) -> int:
        return self.model.n_params

    def calculate(
        self,
        atoms: Structure | None = None,
        properties: list | None = None,
        system_changes: list | None = None,
    ) -> None:
        """Compute properties for a Structure into ``self.results``."""
        if atoms is None:
            atoms = self.atoms
        if not isinstance(atoms, Structure):  # e.g. an ASE Atoms object
            atoms = _coerce_structure(atoms)
        self.atoms = atoms

        graph = self.model.graph_converter(atoms)
        prediction = self.model.predict_graph(
            graph,
            task="efsm",
            return_site_energies=self.return_site_energies,
            return_crystal_feas=True,
        )

        n_atoms = len(atoms)
        extensive_factor = n_atoms if self.model.is_intensive else 1
        self.results = {
            "energy": prediction["e"] * extensive_factor,
            "free_energy": prediction["e"] * extensive_factor,
            "forces": np.asarray(prediction["f"]),
            "stress": np.asarray(prediction["s"]) * self.stress_weight,
            "magmoms": np.asarray(prediction["m"]),
            "crystal_fea": np.asarray(prediction["crystal_fea"]),
        }
        if self.return_site_energies:
            self.results["energies"] = np.asarray(prediction["site_energies"])

    # ------------------------------------------------------- ASE-style sugar
    def get_potential_energy(self, atoms: Structure | None = None) -> float:
        self.calculate(atoms)
        return self.results["energy"]

    def get_forces(self, atoms: Structure | None = None) -> np.ndarray:
        self.calculate(atoms)
        return self.results["forces"]

    def get_stress(self, atoms: Structure | None = None) -> np.ndarray:
        """Voigt-6 stress in eV/A^3 (ASE convention)."""
        self.calculate(atoms)
        return voigt_6(self.results["stress"])

    def get_magmoms(self, atoms: Structure | None = None) -> np.ndarray:
        self.calculate(atoms)
        return self.results["magmoms"]


def _coerce_structure(atoms) -> Structure:
    """Accept an ASE-Atoms-like object (positions/cell/numbers) and convert."""
    cell = np.asarray(atoms.cell)
    return Structure(
        cell,
        np.asarray(atoms.numbers).tolist(),
        np.asarray(atoms.positions),
        coords_are_cartesian=True,
    )
