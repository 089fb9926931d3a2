"""Minimal CIF reader/writer for periodic crystals.

Covers the CIF dialect produced by pymatgen (P1 symmetry, fractional
coordinates, optional oxidation-state decorations) which is what the
reference framework's fixtures and ``CIFData`` datasets consume. Symmetry
operations beyond identity are applied when a ``_symmetry_equiv_pos_as_xyz``
loop is present with simple x/y/z expressions.
"""

from __future__ import annotations

import re

import numpy as np

from chgnet_tpu_torch.core.lattice import Lattice
from chgnet_tpu_torch.core.structure import Structure


def _tokenize_line(line: str) -> list[str]:
    """Split a CIF line into tokens, honoring single/double quotes."""
    tokens = []
    for match in re.finditer(r"'([^']*)'|\"([^\"]*)\"|(\S+)", line):
        tokens.append(next(g for g in match.groups() if g is not None))
    return tokens


def _parse_number(token: str) -> float:
    """Parse a CIF numeric token, dropping a trailing (esd) suffix."""
    return float(re.sub(r"\(\d*\)$", "", token))


def _parse_blocks(text: str) -> dict[str, object]:
    """Parse the first data block into {tag: value} and loop tables
    {(tag, ...): list-of-rows}.
    """
    tags: dict[str, object] = {}
    lines = [
        line
        for line in text.splitlines()
        if line.strip() and not line.strip().startswith("#")
    ]
    idx = 0
    while idx < len(lines):
        line = lines[idx].strip()
        if line.lower().startswith("loop_"):
            idx += 1
            headers: list[str] = []
            while idx < len(lines) and lines[idx].strip().startswith("_"):
                headers.append(_tokenize_line(lines[idx].strip())[0])
                idx += 1
            rows: list[list[str]] = []
            buffer: list[str] = []
            while idx < len(lines):
                stripped = lines[idx].strip()
                if stripped.startswith(("_", "loop_", "data_")):
                    break
                buffer.extend(_tokenize_line(stripped))
                idx += 1
                while len(buffer) >= len(headers):
                    rows.append(buffer[: len(headers)])
                    buffer = buffer[len(headers):]
            tags[tuple(headers)] = rows  # type: ignore[index]
        elif line.startswith("_"):
            parts = _tokenize_line(line)
            if len(parts) >= 2:
                tags[parts[0]] = " ".join(parts[1:])
            elif idx + 1 < len(lines) and not lines[idx + 1].strip().startswith("_"):
                tags[parts[0]] = lines[idx + 1].strip().strip("'\"")
                idx += 1
            idx += 1
            continue
        else:
            idx += 1
            continue
    return tags


_SYMOP_TERM = re.compile(r"([+-]?)(\d+/\d+|\d*\.?\d*)\*?([xyz]?)")


def _parse_symop(expr: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse one 'x, y, z'-style symmetry op into (rotation, translation)."""
    rot = np.zeros((3, 3))
    trans = np.zeros(3)
    for row, part in enumerate(expr.split(",")):
        for sign_s, coeff_s, var in _SYMOP_TERM.findall(part.replace(" ", "")):
            if not coeff_s and not var:
                continue
            sign = -1.0 if sign_s == "-" else 1.0
            if coeff_s and "/" in coeff_s:
                num, den = coeff_s.split("/")
                coeff = float(num) / float(den)
            else:
                coeff = float(coeff_s) if coeff_s else 1.0
            if var:
                rot[row, "xyz".index(var)] += sign * coeff
            else:
                trans[row] += sign * coeff
    return rot, trans


def read_cif(filename: str) -> Structure:
    """Read the first data block of a CIF file into a Structure."""
    with open(filename, encoding="utf-8") as file:
        text = file.read()
    tags = _parse_blocks(text)

    params = [
        _parse_number(str(tags[key]))
        for key in (
            "_cell_length_a",
            "_cell_length_b",
            "_cell_length_c",
            "_cell_angle_alpha",
            "_cell_angle_beta",
            "_cell_angle_gamma",
        )
    ]
    lattice = Lattice.from_parameters(*params)

    site_loop = None
    for key in tags:
        if isinstance(key, tuple) and any("_atom_site_fract_x" in h for h in key):
            site_loop = key
            break
    if site_loop is None:
        raise ValueError(f"No atom sites found in {filename}")
    headers = list(site_loop)
    rows = tags[site_loop]

    def col(name: str) -> int | None:
        return headers.index(name) if name in headers else None

    ix, iy, iz = (col(f"_atom_site_fract_{ax}") for ax in "xyz")
    i_type = col("_atom_site_type_symbol")
    i_label = col("_atom_site_label")
    i_occu = col("_atom_site_occupancy")

    species: list[str] = []
    coords: list[list[float]] = []
    for row in rows:
        sym = row[i_type] if i_type is not None else row[i_label]
        if i_occu is not None and abs(_parse_number(row[i_occu]) - 1.0) > 1e-4:
            raise ValueError("partial occupancies are not supported")
        species.append(sym)
        coords.append([_parse_number(row[ix]), _parse_number(row[iy]), _parse_number(row[iz])])

    # Apply symmetry ops if the file carries more than identity.
    symops: list[tuple[np.ndarray, np.ndarray]] = []
    for key in tags:
        if isinstance(key, tuple) and any("symmetry_equiv_pos_as_xyz" in h for h in key):
            expr_col = next(
                i for i, h in enumerate(key) if "symmetry_equiv_pos_as_xyz" in h
            )
            symops = [_parse_symop(row[expr_col]) for row in tags[key]]
            break
    if len(symops) > 1:
        full_species: list[str] = []
        full_coords: list[np.ndarray] = []
        for sym, coord in zip(species, coords):
            seen: list[np.ndarray] = []
            for rot, trans in symops:
                new = (rot @ np.asarray(coord) + trans) % 1.0
                if not any(
                    np.allclose(np.minimum(abs(new - s), 1 - abs(new - s)), 0, atol=1e-5)
                    for s in seen
                ):
                    seen.append(new)
            full_species.extend([sym] * len(seen))
            full_coords.extend(seen)
        species, coords = full_species, [c.tolist() for c in full_coords]

    return Structure(lattice, species, coords)


def write_cif(structure: Structure, filename: str) -> None:
    """Write a Structure as a P1 CIF file."""
    a, b, c, alpha, beta, gamma = structure.lattice.parameters
    lines = [
        "# generated by chgnet_tpu_torch",
        f"data_{structure.formula.replace(' ', '')}",
        "_symmetry_space_group_name_H-M   'P 1'",
        f"_cell_length_a   {a:.8f}",
        f"_cell_length_b   {b:.8f}",
        f"_cell_length_c   {c:.8f}",
        f"_cell_angle_alpha   {alpha:.8f}",
        f"_cell_angle_beta   {beta:.8f}",
        f"_cell_angle_gamma   {gamma:.8f}",
        "_symmetry_Int_Tables_number   1",
        f"_chemical_formula_sum   '{structure.formula}'",
        f"_cell_volume   {structure.volume:.8f}",
        "loop_",
        " _symmetry_equiv_pos_site_id",
        " _symmetry_equiv_pos_as_xyz",
        "  1  'x, y, z'",
        "loop_",
        " _atom_site_type_symbol",
        " _atom_site_label",
        " _atom_site_symmetry_multiplicity",
        " _atom_site_fract_x",
        " _atom_site_fract_y",
        " _atom_site_fract_z",
        " _atom_site_occupancy",
    ]
    for idx, (sym, frac) in enumerate(
        zip(structure.species_symbols, structure.frac_coords)
    ):
        lines.append(
            f"  {sym}  {sym}{idx}  1  {frac[0]:.8f}  {frac[1]:.8f}  {frac[2]:.8f}  1"
        )
    with open(filename, "w", encoding="utf-8") as file:
        file.write("\n".join(lines) + "\n")
