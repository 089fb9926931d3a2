"""Periodic lattice math (numpy, host side).

Standalone replacement for the slice of ``pymatgen.core.Lattice`` the
reference relies on: parameter <-> matrix conversion, volume, frac/cart
transforms, plane spacings for neighbor-image bounds, and cell-parameter
utilities needed by the MD barostats.
"""

from __future__ import annotations

import numpy as np


class Lattice:
    """A 3x3 row-vector lattice: rows are the a, b, c lattice vectors (Å)."""

    def __init__(self, matrix) -> None:
        self.matrix = np.asarray(matrix, dtype=np.float64).reshape(3, 3)

    @classmethod
    def from_parameters(
        cls,
        a: float,
        b: float,
        c: float,
        alpha: float,
        beta: float,
        gamma: float,
    ) -> Lattice:
        """Build from lengths (Å) and angles (degrees).

        Uses the standard crystallographic convention (c along z, b in the
        y-z plane), matching pymatgen's ``Lattice.from_parameters`` up to an
        orthogonal transform (graph construction and energies only depend on
        the metric, so any convention consistent with CIF is valid).
        """
        alpha_r, beta_r, gamma_r = np.radians([alpha, beta, gamma])
        cos_a, cos_b, cos_g = np.cos([alpha_r, beta_r, gamma_r])
        sin_a, sin_b = np.sin([alpha_r, beta_r])
        # pymatgen convention: vector_a in x-z plane, vector_b from gamma* angle
        val = (cos_a * cos_b - cos_g) / (sin_a * sin_b)
        val = np.clip(val, -1.0, 1.0)
        gamma_star = np.arccos(val)
        vec_a = [a * sin_b, 0.0, a * cos_b]
        vec_b = [
            -b * sin_a * np.cos(gamma_star),
            b * sin_a * np.sin(gamma_star),
            b * cos_a,
        ]
        vec_c = [0.0, 0.0, c]
        return cls(np.array([vec_a, vec_b, vec_c]))

    @classmethod
    def cubic(cls, a: float) -> Lattice:
        """Cubic lattice with edge ``a`` (pymatgen API parity)."""
        return cls(np.eye(3) * a)

    @classmethod
    def orthorhombic(cls, a: float, b: float, c: float) -> Lattice:
        """Orthorhombic lattice from three edge lengths."""
        return cls(np.diag([a, b, c]))

    @property
    def volume(self) -> float:
        """Signed-safe cell volume (Å^3)."""
        m = self.matrix
        return float(abs(np.dot(m[0], np.cross(m[1], m[2]))))

    @property
    def lengths(self) -> np.ndarray:
        """(a, b, c) lengths in Å."""
        return np.linalg.norm(self.matrix, axis=1)

    @property
    def angles(self) -> np.ndarray:
        """(alpha, beta, gamma) in degrees."""
        m = self.matrix
        lengths = self.lengths
        out = np.empty(3)
        for idx, (j, k) in enumerate(((1, 2), (0, 2), (0, 1))):
            cos_ang = np.dot(m[j], m[k]) / (lengths[j] * lengths[k])
            out[idx] = np.degrees(np.arccos(np.clip(cos_ang, -1.0, 1.0)))
        return out

    @property
    def parameters(self) -> tuple[float, float, float, float, float, float]:
        """(a, b, c, alpha, beta, gamma)."""
        return (*self.lengths.tolist(), *self.angles.tolist())

    @property
    def inv_matrix(self) -> np.ndarray:
        return np.linalg.inv(self.matrix)

    @property
    def reciprocal(self) -> np.ndarray:
        """Reciprocal lattice rows WITHOUT the 2*pi factor."""
        return self.inv_matrix.T

    @property
    def plane_spacings(self) -> np.ndarray:
        """Distance between consecutive (100)/(010)/(001) lattice planes.

        Used to bound how many periodic images a radius-r search must visit:
        ``ceil(r / spacing)`` per axis.
        """
        return 1.0 / np.linalg.norm(self.reciprocal, axis=1)

    def get_cartesian_coords(self, frac_coords) -> np.ndarray:
        return np.asarray(frac_coords, dtype=np.float64) @ self.matrix

    def get_fractional_coords(self, cart_coords) -> np.ndarray:
        return np.asarray(cart_coords, dtype=np.float64) @ self.inv_matrix

    def scale(self, factors) -> Lattice:
        """Scale lattice vectors by per-axis (or scalar) strain-free factors."""
        factors = np.broadcast_to(np.asarray(factors, dtype=np.float64), (3,))
        return Lattice(self.matrix * factors[:, None])

    def copy(self) -> Lattice:
        return Lattice(self.matrix.copy())

    def __repr__(self) -> str:
        a, b, c, alpha, beta, gamma = self.parameters
        return (
            f"Lattice(a={a:.4f}, b={b:.4f}, c={c:.4f}, "
            f"alpha={alpha:.2f}, beta={beta:.2f}, gamma={gamma:.2f})"
        )

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Lattice) and np.allclose(self.matrix, other.matrix)

    def as_dict(self) -> dict:
        return {"matrix": self.matrix.tolist()}

    @classmethod
    def from_dict(cls, dct: dict) -> Lattice:
        if "matrix" in dct:
            return cls(dct["matrix"])
        return cls.from_parameters(
            dct["a"], dct["b"], dct["c"], dct["alpha"], dct["beta"], dct["gamma"]
        )
