"""Equation of state: Birch-Murnaghan fit and bulk modulus.

Port of ``chgnet_tpu.simulation.eos`` (upstream CHGNet's
``EquationOfState``): relax the structure with cell relaxation, scan
-10%..+10% isotropic strains (n_points volumes), relax each at fixed cell,
fit Birch-Murnaghan.

The fit exploits that the BM energy is exactly a cubic polynomial in
x = V^(-2/3), so a linear least-squares polyfit IS the Birch-Murnaghan
fit (no pymatgen / scipy needed). The strained relaxations run as ONE
batched FIRE on the model's device.
"""

from __future__ import annotations

from typing import Literal

import numpy as np

from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.simulation.units import EV_A3_TO_GPA, GPA_TO_EV_A3


class BirchMurnaghan:
    """Least-squares Birch-Murnaghan EOS through (volume, energy) points."""

    def __init__(self, volumes, energies) -> None:
        self.volumes = np.asarray(volumes, dtype=np.float64)
        self.energies = np.asarray(energies, dtype=np.float64)
        self.v0 = self.e0 = self.b0 = None

    def fit(self) -> None:
        x = self.volumes ** (-2.0 / 3.0)
        # E(x) = c3 x^3 + c2 x^2 + c1 x + c0  (exact BM form)
        c3, c2, c1, c0 = np.polyfit(x, self.energies, 3)
        # stationary points of E(x): 3 c3 x^2 + 2 c2 x + c1 = 0
        disc = 4.0 * c2**2 - 12.0 * c3 * c1
        if disc < 0:
            raise ValueError("Birch-Murnaghan fit has no energy minimum")
        roots = np.array(
            [(-2.0 * c2 + s * np.sqrt(disc)) / (6.0 * c3) for s in (1, -1)]
        )
        # pick the root that is a minimum in V with positive curvature
        best = None
        for x0 in roots:
            if x0 <= 0:
                continue
            e_xx = 6.0 * c3 * x0 + 2.0 * c2
            v0 = x0 ** (-1.5)
            b0 = (4.0 / 9.0) * x0**5 * v0 * e_xx  # V0 * d2E/dV2 at V0
            if b0 > 0 and (best is None or abs(np.log(v0 / self.volumes.mean())) < best[3]):
                best = (v0, b0, x0, abs(np.log(v0 / self.volumes.mean())))
        if best is None:
            raise ValueError("Birch-Murnaghan fit found no stable minimum")
        v0, b0, x0, _ = best
        self.v0 = float(v0)
        self.b0 = float(b0)  # eV/A^3
        self.e0 = float(((c3 * x0 + c2) * x0 + c1) * x0 + c0)

    @property
    def b0_GPa(self) -> float:
        return self.b0 * EV_A3_TO_GPA


class EquationOfState:
    """Bulk modulus / compressibility via batched relax + BM fit."""

    def __init__(
        self,
        model=None,
        *,
        optimizer_class: str = "FIRE",
        use_device: str | None = None,
        stress_weight: float = GPA_TO_EV_A3,
        on_isolated_atoms: Literal["ignore", "warn", "error"] = "error",
    ) -> None:
        from chgnet_tpu_torch.simulation.relax import StructOptimizer

        self.relaxer = StructOptimizer(
            model=model,
            optimizer_class=optimizer_class,
            use_device=use_device,
            stress_weight=stress_weight,
            on_isolated_atoms=on_isolated_atoms,
        )
        self.fitted = False
        self.bm: BirchMurnaghan | None = None

    def fit(
        self,
        atoms: Structure,
        *,
        n_points: int = 11,
        fmax: float | None = 0.1,
        steps: int | None = 500,
        verbose: bool | None = False,
        **kwargs,
    ) -> None:
        """Relax ``atoms`` with the cell free, then relax the n_points
        isotropically strained copies (fixed cell, one batched FIRE) and
        fit the Birch-Murnaghan equation of state."""
        local_minima = self.relaxer.relax(
            atoms,
            relax_cell=True,
            fmax=fmax,
            steps=steps,
            verbose=verbose,
            **kwargs,
        )
        relaxed: Structure = local_minima["final_structure"]

        strained = [
            relaxed.apply_strain([eps, eps, eps])
            for eps in np.linspace(-0.1, 0.1, n_points)
        ]
        results = self.relaxer.relax(
            strained,
            relax_cell=False,
            fmax=fmax,
            steps=steps,
            verbose=verbose,
            **kwargs,
        )
        volumes = [r["final_structure"].volume for r in results]
        energies = [
            r["trajectory"].energies[-1]
            if len(r["trajectory"])
            else r["final_energy"]
            for r in results
        ]
        self.bm = BirchMurnaghan(volumes=volumes, energies=energies)
        self.bm.fit()
        self.fitted = True

    def get_bulk_modulus(
        self, unit: Literal["eV/A^3", "GPa"] = "eV/A^3"
    ) -> float:
        """Bulk modulus from the fitted EOS."""
        if not self.fitted:
            raise ValueError(
                "Equation of state needs to be fitted first through self.fit()"
            )
        if unit == "eV/A^3":
            return float(self.bm.b0)
        if unit == "GPa":
            return float(self.bm.b0_GPa)
        raise ValueError("unit has to be eV/A^3 or GPa")

    def get_compressibility(self, unit: str = "A^3/eV") -> float:
        """Compressibility = 1 / bulk modulus."""
        if not self.fitted:
            raise ValueError(
                "Equation of state needs to be fitted first through self.fit()"
            )
        if unit == "A^3/eV":
            return float(1 / self.bm.b0)
        if unit == "GPa^-1":
            return float(1 / self.bm.b0_GPa)
        if unit in {"Pa^-1", "m^2/N"}:
            return float(1 / (self.bm.b0_GPa * 1e9))
        raise NotImplementedError(
            "unit has to be one of A^3/eV, GPa^-1 Pa^-1 or m^2/N"
        )
