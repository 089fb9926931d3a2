"""Periodic-table data used by the standalone structure core.

The reference framework delegates element handling to pymatgen
(``pymatgen.core.periodic_table``); this framework is fully standalone, so
the minimal element facts needed for graph construction (atomic numbers),
molecular dynamics (atomic masses, amu) and IO (symbols) live here.

CHGNet models embed elements 1..94 (H..Pu); we carry the table to Z=103 so
structure IO never fails on exotic species.
"""

from __future__ import annotations

import re

# fmt: off
ELEMENT_SYMBOLS: tuple[str, ...] = (
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No", "Lr",
)

# Standard atomic weights (amu); conventional values for radioelements.
ATOMIC_MASSES: tuple[float, ...] = (
    1.008, 4.0026, 6.94, 9.0122, 10.81, 12.011, 14.007, 15.999, 18.998, 20.180,
    22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948, 39.098, 40.078,
    44.956, 47.867, 50.942, 51.996, 54.938, 55.845, 58.933, 58.693, 63.546, 65.38,
    69.723, 72.630, 74.922, 78.971, 79.904, 83.798, 85.468, 87.62, 88.906, 91.224,
    92.906, 95.95, 97.0, 101.07, 102.91, 106.42, 107.87, 112.41, 114.82, 118.71,
    121.76, 127.60, 126.90, 131.29, 132.91, 137.33, 138.91, 140.12, 140.91, 144.24,
    145.0, 150.36, 151.96, 157.25, 158.93, 162.50, 164.93, 167.26, 168.93, 173.05,
    174.97, 178.49, 180.95, 183.84, 186.21, 190.23, 192.22, 195.08, 196.97, 200.59,
    204.38, 207.2, 208.98, 209.0, 210.0, 222.0, 223.0, 226.0, 227.0, 232.04,
    231.04, 238.03, 237.0, 244.0, 243.0, 247.0, 247.0, 251.0, 252.0, 257.0,
    258.0, 259.0, 262.0,
)
# fmt: on

SYMBOL_TO_Z: dict[str, int] = {s: z + 1 for z, s in enumerate(ELEMENT_SYMBOLS)}

MAX_NUM_ELEMENTS = 94  # embedding table size used by all CHGNet-family models

_SPECIES_RE = re.compile(r"^([A-Z][a-z]?)")


def atomic_number(species: str | int) -> int:
    """Resolve a species string (e.g. ``"Mn"``, ``"Mn3+"``, ``"O2-"``) or an
    atomic number to the element's atomic number Z.
    """
    if isinstance(species, int):
        if not 1 <= species <= len(ELEMENT_SYMBOLS):
            raise ValueError(f"Unknown atomic number {species}")
        return species
    match = _SPECIES_RE.match(species.strip())
    if match and match.group(1) in SYMBOL_TO_Z:
        return SYMBOL_TO_Z[match.group(1)]
    # one more try: single uppercase letter prefix of a 2-letter parse miss
    sym = species.strip()[:1]
    if sym in SYMBOL_TO_Z:
        return SYMBOL_TO_Z[sym]
    raise ValueError(f"Unknown species {species!r}")


def symbol(z: int) -> str:
    """Element symbol for atomic number ``z``."""
    return ELEMENT_SYMBOLS[z - 1]


def mass(z: int) -> float:
    """Standard atomic weight (amu) for atomic number ``z``."""
    return ATOMIC_MASSES[z - 1]
