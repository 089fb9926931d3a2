"""VASP output parsing and magmom-based charge decoration.

Port of ``chgnet_tpu.utils.vasp``, with numpy and ``xml.etree`` only (a copy:
``chgnet_tpu.utils.vasp`` imports ``chgnet_tpu.utils.common``, which imports
jax). Upstream CHGNet's ``utils/vasp_utils.py``
(which delegates to pymatgen Vasprun/Oszicar): parses ``vasprun.xml`` with
``xml.etree``, per-ionic-step magnetization(x) blocks from ``OUTCAR`` with
regexes, and ionic-step counts from ``OSZICAR``. Supports the same
electronic-convergence filter (drop steps whose electronic loop hit NELM,
``vasp_utils.py:130-134``) and returns the same dataset schema.
"""

from __future__ import annotations

import gzip
import os
import re
import warnings
import xml.etree.ElementTree as ET

import numpy as np

from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.utils.common import write_json


def _open_maybe_gz(path: str):
    """Open ``path`` or ``path + '.gz'`` as text."""
    if os.path.exists(path):
        return open(path, encoding="utf-8", errors="ignore")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rt", encoding="utf-8", errors="ignore")
    raise FileNotFoundError(path)


def _varray(elem) -> np.ndarray:
    return np.array(
        [[float(tok) for tok in v.text.split()] for v in elem.findall("v")]
    )


def _parse_vasprun(path: str) -> dict:
    """Extract ionic steps (structure/energy/forces/stress/electronic step
    count), species and NELM from a vasprun.xml."""
    with _open_maybe_gz(path) as file:
        # recover=true equivalent: wrap truncated files
        text = file.read()
    try:
        root = ET.fromstring(text)
    except ET.ParseError:
        # truncated file: close open tags crudely by trimming to the last
        # complete </calculation> and re-wrapping
        end = text.rfind("</calculation>")
        if end == -1:
            raise
        head_end = text.find("<calculation>")
        root = ET.fromstring(
            text[:head_end] + text[head_end: end + len("</calculation>")]
            + "</modeling>"
        )

    species: list[str] = []
    for array in root.iter("array"):
        if array.get("name") == "atoms":
            for rc in array.find("set").findall("rc"):
                species.append(rc.findall("c")[0].text.strip())
            break

    nelm = 60
    for i_elem in root.iter("i"):
        if i_elem.get("name") == "NELM":
            nelm = int(float(i_elem.text))
            break

    steps = []
    for calc in root.iter("calculation"):
        step: dict = {"n_electronic_steps": len(calc.findall("scstep"))}
        struct_elem = calc.find("structure")
        basis = positions = None
        for varray in struct_elem.iter("varray"):
            if varray.get("name") == "basis":
                basis = _varray(varray)
            elif varray.get("name") == "positions":
                positions = _varray(varray)
        step["lattice"] = basis
        step["frac_coords"] = positions
        for varray in calc.findall("varray"):
            if varray.get("name") == "forces":
                step["forces"] = _varray(varray)
            elif varray.get("name") == "stress":
                step["stress"] = _varray(varray)  # kBar
        energy_elem = calc.find("energy")
        for i_elem in energy_elem.findall("i"):
            if i_elem.get("name") in {"e_0_energy", "e_fr_energy"}:
                step.setdefault("energies", {})[i_elem.get("name")] = float(
                    i_elem.text
                )
        step["e_0_energy"] = step.get("energies", {}).get(
            "e_0_energy",
            step.get("energies", {}).get("e_fr_energy", float("nan")),
        )
        steps.append(step)
    return {"species": species, "nelm": nelm, "ionic_steps": steps}


def _parse_outcar_magmoms(path: str) -> list[list[float]]:
    """Per-ionic-step site magnetizations (the 'tot' column of each
    ``magnetization (x)`` block); first block per ionic step wins, like the
    reference OUTCAR scan (``vasp_utils.py:61-110``)."""
    try:
        with _open_maybe_gz(path) as file:
            lines = [line.strip() for line in file]
    except FileNotFoundError:
        return []
    blocks: list[list[float]] = []
    ion_step_count = 0
    current: list[float] | None = None
    for line in lines:
        if "magnetization (x)" in line:
            ion_step_count += 1
            current = []
            continue
        if current is None:
            continue
        if re.match(r"^\d+\s+[-\d.]+", line):
            current.append(float(line.split()[-1]))
        elif line.startswith("tot"):
            if ion_step_count == len(blocks) + 1:
                blocks.append(current)
            current = None
        elif line.startswith("---") or line.startswith("# of ion"):
            continue
        elif line and not re.match(r"^[\d\s.\-]+$", line):
            current = None
    return blocks


def _count_oszicar_steps(path: str) -> int:
    """Number of ionic steps = lines with 'F=' in OSZICAR."""
    try:
        with _open_maybe_gz(path) as file:
            return sum(1 for line in file if " F= " in f" {line}")
    except FileNotFoundError:
        return -1


def parse_vasp_dir(
    base_dir: str,
    *,
    check_electronic_convergence: bool = True,
    save_path: str | None = None,
) -> dict[str, list]:
    """Parse a VASP run directory into structures + labels.

    Same contract as the reference (``vasp_utils.py:18-152``): returns a
    dict of lists with keys structure, uncorrected_total_energy,
    energy_per_atom, force, magmom, stress (stress absent -> None).
    """
    if not os.path.isdir(base_dir):
        raise NotADirectoryError(f"{base_dir=} is not a directory")
    vasprun_path = os.path.join(base_dir, "vasprun.xml")
    oszicar_path = os.path.join(base_dir, "OSZICAR")
    if not (
        os.path.exists(vasprun_path) or os.path.exists(vasprun_path + ".gz")
    ) or not (
        os.path.exists(oszicar_path) or os.path.exists(oszicar_path + ".gz")
    ):
        raise RuntimeError(f"No data parsed from {base_dir}!")

    vasprun = _parse_vasprun(vasprun_path)
    mag_blocks = _parse_outcar_magmoms(os.path.join(base_dir, "OUTCAR"))
    n_oszicar = _count_oszicar_steps(oszicar_path)

    if n_oszicar >= 0 and mag_blocks:
        if n_oszicar == len(mag_blocks):
            warnings.warn("Unfinished OUTCAR", stacklevel=2)
        elif n_oszicar == len(mag_blocks) - 1:
            mag_blocks.pop(-1)

    species = vasprun["species"]
    n_atoms = len(species)
    has_stress = any("stress" in s for s in vasprun["ionic_steps"])
    dataset: dict[str, list] = {
        "structure": [],
        "uncorrected_total_energy": [],
        "energy_per_atom": [],
        "force": [],
        "magmom": [],
        "stress": [] if has_stress else None,
    }
    for index, step in enumerate(vasprun["ionic_steps"]):
        if (
            check_electronic_convergence
            and step["n_electronic_steps"] >= vasprun["nelm"]
        ):
            continue
        struct = Structure(step["lattice"], species, step["frac_coords"])
        dataset["structure"].append(struct)
        dataset["uncorrected_total_energy"].append(step["e_0_energy"])
        dataset["energy_per_atom"].append(step["e_0_energy"] / n_atoms)
        dataset["force"].append(step["forces"].tolist())
        if mag_blocks and index < len(mag_blocks):
            dataset["magmom"].append(mag_blocks[index])
        if has_stress:
            dataset["stress"].append(step["stress"].tolist())

    if not dataset["uncorrected_total_energy"]:
        raise RuntimeError(f"No data parsed from {base_dir}!")

    if save_path is not None:
        save_dict = dict(dataset)
        save_dict["structure"] = [
            struct.as_dict() for struct in dataset["structure"]
        ]
        write_json(save_dict, save_path)
    return dataset


def solve_charge_by_mag(
    structure: Structure,
    default_ox: dict[str, float] | None = None,
    ox_ranges: dict[str, dict[tuple[float, float], int]] | None = None,
) -> Structure | None:
    """Assign formal oxidation states from site magmoms
    (``vasp_utils.py:155-215``). Reads ``final_magmom`` or ``magmom`` site
    properties; returns a copy with an ``oxidation_state`` site property
    (this framework's Structure has no species-level charge decoration),
    or None when any site cannot be solved.
    """
    default_ox = default_ox or {"Li": 1, "O": -2}
    ox_ranges = ox_ranges or {
        "Mn": {
            (0.5, 1.5): 2,
            (1.5, 2.5): 3,
            (2.5, 3.5): 4,
            (3.5, 4.2): 3,
            (4.2, 5.0): 2,
        }
    }
    magmoms = structure.site_properties.get(
        "final_magmom", structure.site_properties.get("magmom")
    )
    if magmoms is None:
        warnings.warn("Failed to solve oxidation state: no magmoms")
        return None

    ox_list: list[int | float] = []
    for idx, symbol in enumerate(structure.species_symbols):
        assigned = False
        if symbol in ox_ranges:
            for (mn, mx), ox in ox_ranges[symbol].items():
                if mn <= magmoms[idx] < mx:
                    ox_list.append(ox)
                    assigned = True
                    break
        elif symbol in default_ox:
            ox_list.append(default_ox[symbol])
            assigned = True
        if not assigned:
            warnings.warn("Failed to solve oxidation state")
            return None

    total_charge = sum(ox_list)
    print(f"Solved oxidation state, {total_charge=}")
    out = structure.copy()
    out.site_properties["oxidation_state"] = ox_list
    return out
