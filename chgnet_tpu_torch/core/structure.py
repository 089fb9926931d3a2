"""Standalone periodic crystal structure (numpy, host side).

Replaces the slice of ``pymatgen.core.Structure`` the reference framework
uses: species + fractional coordinates on a :class:`Lattice`, site
properties, CIF/JSON IO, supercells, perturbation and strain. Kept
deliberately small — this is the host-side data container; all compute-path
representations are flat arrays (see ``chgnet_tpu_torch.graph``).
"""

from __future__ import annotations

import numpy as np

from chgnet_tpu_torch.core import elements
from chgnet_tpu_torch.core.lattice import Lattice

# Pauling electronegativities (0 = undefined/noble gas) indexed by Z-1;
# used only for conventional formula ordering (ascending X, like pymatgen).
# fmt: off
_ELECTRONEG: tuple[float, ...] = (
    2.20, 0.0, 0.98, 1.57, 2.04, 2.55, 3.04, 3.44, 3.98, 0.0,
    0.93, 1.31, 1.61, 1.90, 2.19, 2.58, 3.16, 0.0, 0.82, 1.00,
    1.36, 1.54, 1.63, 1.66, 1.55, 1.83, 1.88, 1.91, 1.90, 1.65,
    1.81, 2.01, 2.18, 2.55, 2.96, 3.00, 0.82, 0.95, 1.22, 1.33,
    1.60, 2.16, 1.90, 2.20, 2.28, 2.20, 1.93, 1.69, 1.78, 1.96,
    2.05, 2.10, 2.66, 2.60, 0.79, 0.89, 1.10, 1.12, 1.13, 1.14,
    1.13, 1.17, 1.20, 1.20, 1.10, 1.22, 1.23, 1.24, 1.25, 1.10,
    1.27, 1.30, 1.50, 2.36, 1.90, 2.20, 2.20, 2.28, 2.54, 2.00,
    1.62, 2.33, 2.02, 2.00, 2.20, 0.0, 0.70, 0.89, 1.10, 1.30,
    1.50, 1.38, 1.36, 1.28, 1.30, 1.30, 1.30, 1.30, 1.30, 1.30,
    1.30, 1.30, 1.30,
)
# fmt: on


class Structure:
    """A periodic crystal: lattice + sites (species, fractional coords)."""

    def __init__(
        self,
        lattice: Lattice | np.ndarray | list,
        species: list[str | int],
        frac_coords,
        *,
        coords_are_cartesian: bool = False,
        site_properties: dict[str, list] | None = None,
    ) -> None:
        self.lattice = lattice if isinstance(lattice, Lattice) else Lattice(lattice)
        self.atomic_numbers = np.array(
            [elements.atomic_number(sp) for sp in species], dtype=np.int32
        )
        coords = np.asarray(frac_coords, dtype=np.float64).reshape(-1, 3)
        if coords_are_cartesian:
            coords = self.lattice.get_fractional_coords(coords)
        self.frac_coords = coords
        if len(self.atomic_numbers) != len(self.frac_coords):
            raise ValueError(
                f"species ({len(self.atomic_numbers)}) and coords "
                f"({len(self.frac_coords)}) length mismatch"
            )
        self.site_properties: dict[str, list] = dict(site_properties or {})
        for key, vals in self.site_properties.items():
            if len(vals) != len(self):
                raise ValueError(f"site property {key!r} has wrong length")

    # ---------------------------------------------------------------- basic
    def __len__(self) -> int:
        return len(self.atomic_numbers)

    @property
    def num_sites(self) -> int:
        return len(self)

    @property
    def species_symbols(self) -> list[str]:
        return [elements.symbol(int(z)) for z in self.atomic_numbers]

    @property
    def cart_coords(self) -> np.ndarray:
        return self.lattice.get_cartesian_coords(self.frac_coords)

    @property
    def volume(self) -> float:
        return self.lattice.volume

    @property
    def masses(self) -> np.ndarray:
        """Atomic masses in amu."""
        return np.array([elements.mass(int(z)) for z in self.atomic_numbers])

    @property
    def formula(self) -> str:
        """Conventional formula, element groups ordered by electronegativity
        (e.g. ``"Li2 Mn2 O4"``), matching pymatgen's ``composition.formula``.
        """
        zs, counts = np.unique(self.atomic_numbers, return_counts=True)
        order = np.argsort([_ELECTRONEG[z - 1] for z in zs], kind="stable")
        parts = [
            f"{elements.symbol(int(zs[i]))}{int(counts[i])}"
            for i in order
        ]
        return " ".join(parts)

    def __repr__(self) -> str:
        return (
            f"Structure({self.formula}, n_sites={len(self)}, "
            f"volume={self.volume:.3f} A^3)"
        )

    # ------------------------------------------------------------ transforms
    def copy(self) -> Structure:
        return Structure(
            self.lattice.copy(),
            self.atomic_numbers.tolist(),
            self.frac_coords.copy(),
            site_properties={k: list(v) for k, v in self.site_properties.items()},
        )

    def wrap(self) -> Structure:
        """Return a copy with fractional coordinates wrapped into [0, 1)."""
        new = self.copy()
        new.frac_coords = new.frac_coords % 1.0
        return new

    def make_supercell(self, scaling) -> Structure:
        """Integer diagonal supercell (na, nb, nc) or scalar n."""
        scaling = np.broadcast_to(np.asarray(scaling, dtype=np.int64), (3,))
        if np.any(scaling < 1):
            raise ValueError(f"invalid supercell {scaling}")
        na, nb, nc = (int(s) for s in scaling)
        shifts = np.array(
            [[i, j, k] for i in range(na) for j in range(nb) for k in range(nc)],
            dtype=np.float64,
        )
        n_img = len(shifts)
        # site-major order (all images of site 0, then site 1, ...), matching
        # pymatgen's make_supercell so supercell golden tests line up.
        frac = (self.frac_coords[:, None, :] + shifts[None, :, :]) / scaling
        frac = frac.reshape(-1, 3)
        species = np.repeat(self.atomic_numbers, n_img)
        new_lattice = Lattice(self.lattice.matrix * scaling[:, None])
        props = {
            k: list(np.repeat(np.asarray(v, dtype=object), n_img))
            for k, v in self.site_properties.items()
        }
        return Structure(new_lattice, species.tolist(), frac, site_properties=props)

    def spatial_sort(self, bits: int = 6) -> Structure:
        """Return a copy with sites reordered along a Morton (Z-order)
        curve over the fractional coordinates.

        Atom ORDER is a free variable for the model (energies/forces are
        permutation-equivariant), but on TPU it sets the memory locality
        of every atom-table gather: supercells built site-major (all
        images of site 0, then site 1 — pymatgen's and
        :meth:`make_supercell`'s convention) interleave each atom's
        spatial neighbors across the whole table, so the center-sorted
        edge streams reference the atom table near-randomly. Z-ordering
        brings neighbors-in-space closer in index — measured at 10k
        atoms it ROUGHLY HALVES the neighbor stream's chunk-visit
        dispersion (17x -> 10x the sequential minimum) but does NOT make
        it window-local (the 6 A shell still spans Z-curve
        discontinuities), so the streaming-gather gate stays closed
        there; angle-side streams are already local under either order.
        ``bits`` is the per-axis quantization (2^bits cells).
        """
        frac = self.frac_coords % 1.0
        q = np.minimum(
            (frac * (1 << bits)).astype(np.int64), (1 << bits) - 1
        )
        code = np.zeros(len(self), dtype=np.int64)
        for b in range(bits):
            for axis in range(3):
                code |= ((q[:, axis] >> b) & 1) << (3 * b + axis)
        order = np.argsort(code, kind="stable")
        props = {
            k: [v[i] for i in order] for k, v in self.site_properties.items()
        }
        return Structure(
            self.lattice,
            np.asarray(self.atomic_numbers)[order].tolist(),
            self.frac_coords[order],
            site_properties=props,
        )

    def perturb(self, distance: float, seed: int | None = None) -> Structure:
        """Return a copy with every site displaced by ``distance`` Å in a
        uniformly random direction (same semantics as pymatgen's perturb).
        """
        rng = np.random.default_rng(seed)
        vecs = rng.normal(size=(len(self), 3))
        vecs *= distance / np.linalg.norm(vecs, axis=1, keepdims=True)
        new = self.copy()
        new.frac_coords = new.frac_coords + self.lattice.get_fractional_coords(vecs)
        return new

    def apply_strain(self, strain) -> Structure:
        """Return a copy with lattice -> lattice @ (I + strain); fractional
        coordinates are unchanged (affine deformation of all sites).
        ``strain`` may be a scalar, a 3-vector (diagonal) or a 3x3 matrix.
        """
        strain = np.asarray(strain, dtype=np.float64)
        if strain.ndim <= 1:
            strain = np.eye(3) * strain
        new = self.copy()
        new.lattice = Lattice(self.lattice.matrix @ (np.eye(3) + strain))
        return new

    def scale_lattice(self, volume: float) -> Structure:
        """Return a copy isotropically rescaled to the target volume."""
        factor = (volume / self.volume) ** (1.0 / 3.0)
        new = self.copy()
        new.lattice = Lattice(self.lattice.matrix * factor)
        return new

    # ---------------------------------------------------------------- IO
    def as_dict(self) -> dict:
        """pymatgen-schema-compatible dict (subset) for JSON round trips."""
        sites = []
        for idx in range(len(self)):
            site: dict = {
                "species": [
                    {"element": elements.symbol(int(self.atomic_numbers[idx])), "occu": 1}
                ],
                "abc": self.frac_coords[idx].tolist(),
            }
            props = {
                k: v[idx]
                for k, v in self.site_properties.items()
            }
            if props:
                site["properties"] = props
            sites.append(site)
        return {
            "@module": "chgnet_tpu_torch.core.structure",
            "@class": "Structure",
            "lattice": self.lattice.as_dict(),
            "sites": sites,
        }

    @classmethod
    def from_dict(cls, dct: dict) -> Structure:
        """Parse a structure dict (accepts pymatgen ``Structure.as_dict``
        output, e.g. entries of the MPtrj JSON dataset).
        """
        lattice = Lattice.from_dict(dct["lattice"])
        species: list[str] = []
        coords: list[list[float]] = []
        prop_keys: set[str] = set()
        for site in dct["sites"]:
            spec = site["species"]
            if len(spec) != 1 or spec[0].get("occu", 1) != 1:
                raise ValueError("only ordered structures are supported")
            species.append(spec[0]["element"])
            coords.append(site["abc"])
            prop_keys |= set(site.get("properties") or {})
        site_properties = {
            key: [
                (site.get("properties") or {}).get(key) for site in dct["sites"]
            ]
            for key in prop_keys
        }
        return cls(lattice, species, coords, site_properties=site_properties)

    @classmethod
    def from_file(cls, filename: str) -> Structure:
        """Load a structure from a CIF or JSON file."""
        from chgnet_tpu_torch.core import cif

        name = str(filename).lower()
        if name.endswith(".json"):
            import json

            with open(filename) as file:
                return cls.from_dict(json.load(file))
        if name.endswith(".cif"):
            return cif.read_cif(filename)
        raise ValueError(f"Unsupported structure file {filename!r}")

    def to(self, filename: str) -> None:
        """Write to CIF (only format supported)."""
        from chgnet_tpu_torch.core import cif

        cif.write_cif(self, filename)
