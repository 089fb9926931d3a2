"""Datasets, loaders, VASP parsing and host utilities of the PyTorch port
against chgnet_tpu.

Host data is held bit for bit: under the same seed the two packages split
the same indices, serve batches in the same order and pad them into equal
arrays and NaN-padded targets (``np.array_equal`` with NaNs equal). Graphs
and ``labels.json`` written by either package's ``make_graphs`` load in the
other's ``GraphData``. ``parse_vasp_dir`` is held against chgnet_tpu's on
small vasprun.xml / OUTCAR / OSZICAR files the test writes itself. Also:
the package data ships every source the port's loaders build from.
"""

from __future__ import annotations

import fnmatch
import json
import os
import shutil
import tomllib

import numpy as np
import pytest
import torch

import chgnet_tpu.data as jdata
import chgnet_tpu.data.dataset as jdataset
import chgnet_tpu.utils.vasp as jvasp
import chgnet_tpu_torch.data as tdata
import chgnet_tpu_torch.data.dataset as tdataset
import chgnet_tpu_torch.utils as tutils
import chgnet_tpu_torch.utils.vasp as tvasp
from chgnet_tpu import ROOT
from chgnet_tpu.core.lattice import Lattice as JLattice
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu_torch.core.lattice import Lattice as TLattice
from chgnet_tpu_torch.core.structure import Structure as TStructure

CIFS = ("mp-18767-LiMnO2", "mp-1175469-Li9Co7O16")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its passes are many small
    ops, which several test processes on one machine's cores slow down many
    times over when each op spreads over every core."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _labelled(n: int = 14, seed: int = 0):
    """Perturbed NaCl cells with random e/f/s/m labels, some NaN, as plain
    lists, and each structure in both packages."""
    rng = np.random.default_rng(seed)
    lists = {"j": [], "t": [], "e": [], "f": [], "s": [], "m": []}
    for i in range(n):
        scale = 1 + (i % 3)  # 2, 4 or 6 atoms: batches of different sizes
        coords = [[0, 0, 0], [0.5, 0.5, 0.5]]
        t = TStructure(TLattice.cubic(4), ["Na", "Cl"], coords)
        t = t.make_supercell((scale, 1, 1)).perturb(0.1, seed=i)
        lists["t"].append(t)
        lists["j"].append(
            JStructure(JLattice(t.lattice.matrix), [int(z) for z in t.atomic_numbers],
                       t.frac_coords)
        )
        lists["e"].append(float(rng.normal()))
        lists["f"].append(rng.normal(size=(len(t), 3)).astype(np.float32))
        lists["s"].append(rng.normal(size=(3, 3)).astype(np.float32))
        lists["m"].append(np.abs(rng.normal(size=len(t))).astype(np.float32))
    lists["e"][2] = np.nan
    lists["f"][4] = np.full_like(lists["f"][4], np.nan)
    lists["m"][6] = None
    return lists


def _structure_data(pkg, lists, key):
    return pkg.StructureData(
        structures=lists[key], energies=lists["e"], forces=lists["f"],
        stresses=lists["s"], magmoms=lists["m"], shuffle=False,
    )


def _same_batch(tb, jb, tt, jt):
    """The port's padded batch and targets equal chgnet_tpu's, array by
    array (every array field the two GraphBatch types share)."""
    shared = [f for f in tb._fields if f in jb._fields and not f.startswith("plan_")]
    assert len(shared) >= 18
    for field in shared:
        a, b = getattr(tb, field), getattr(jb, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert sorted(tt) == sorted(jt)
    for key in tt:
        assert tt[key].dtype == jt[key].dtype, key
        assert np.array_equal(tt[key], jt[key], equal_nan=True), key


@pytest.mark.parametrize(
    "batch_size,seed,prefetch", [(4, 42, 2), (3, 7, 0)],
    ids=["bs4-seed42-prefetch", "bs3-seed7-serial"],
)
def test_loaders_bit_equal_to_chgnet_tpu(batch_size, seed, prefetch):
    """Same splits, same order, bit-equal padded batches and targets (the
    remainder batches' filler graphs and NaN padding included), over two
    epochs of the train loader."""
    lists = _labelled()
    kw = dict(batch_size=batch_size, train_ratio=0.6, val_ratio=0.2, seed=seed,
              prefetch=prefetch)
    t_loaders = tdata.get_train_val_test_loader(
        _structure_data(tdata, lists, "t"), **kw)
    j_loaders = jdata.get_train_val_test_loader(
        _structure_data(jdata, lists, "j"), **kw)
    n_batches = 0
    for tl, jl in zip(t_loaders, j_loaders):
        np.testing.assert_array_equal(tl.indices, jl.indices)
        assert len(tl) == len(jl)
        for _ in range(2):
            for (tb, tt), (jb, jt) in zip(tl, jl, strict=True):
                _same_batch(tb, jb, tt, jt)
                n_batches += 1
    assert n_batches >= 8
    tl, jl = t_loaders[0], j_loaders[0]
    assert tl.ensure_fixed_capacities() == jl.ensure_fixed_capacities()


def test_collate_padded_fillers_and_nan_padding():
    """Fewer graphs than the batch: the smallest graph repeated as filler,
    its targets NaN, ``graph_mask`` 0; the same arrays as chgnet_tpu."""
    lists = _labelled()
    tdat, jdat = _structure_data(tdata, lists, "t"), _structure_data(jdata, lists, "j")
    items_t, items_j = [tdat[i] for i in range(3)], [jdat[i] for i in range(3)]
    tb, tt = tdataset.collate_padded(items_t, n_graphs_cap=5)
    jb, jt = jdataset.collate_padded(items_j, n_graphs_cap=5)
    _same_batch(tb, jb, tt, jt)
    np.testing.assert_array_equal(tt["graph_mask"], [1, 1, 1, 0, 0])
    assert np.isnan(tt["e"][3:]).all() and np.isnan(tt["s"][3:]).all()
    graphs, targets = tdataset.collate_graphs(items_t)
    assert len(graphs) == 3 and sorted(targets) == ["e", "f", "m", "s"]


@pytest.mark.parametrize("writer", ["port", "chgnet_tpu"])
def test_make_graphs_load_across_packages(writer, tmp_path):
    """Graphs and labels.json written by one package's make_graphs load in
    the other's GraphData, graph arrays and targets equal."""
    lists = _labelled()
    source = {"port": (tdataset, tdata, "t"), "chgnet_tpu": (jdataset, jdata, "j")}
    w_mod, w_pkg, w_key = source[writer]
    r_key = "j" if w_key == "t" else "t"
    r_pkg = jdata if r_key == "j" else tdata
    data = _structure_data(w_pkg, lists, w_key)
    w_mod.make_graphs(data, str(tmp_path))
    loaded = r_pkg.GraphData(str(tmp_path), shuffle=False)
    assert len(loaded) == len(data)
    by_id = {data[i][0].graph_id: data[i] for i in range(len(data))}
    for idx in range(len(loaded)):
        graph, targets = loaded[idx]
        want_graph, want_targets = by_id[graph.graph_id]
        for field in ("atomic_number", "atom_frac_coord", "atom_graph",
                      "neighbor_image", "directed2undirected",
                      "undirected2directed", "bond_graph", "lattice"):
            np.testing.assert_array_equal(
                getattr(graph, field), getattr(want_graph, field), err_msg=field)
        for key in want_targets:
            np.testing.assert_allclose(targets[key], want_targets[key],
                                       rtol=1e-6, equal_nan=True, err_msg=key)
    # the mp-id level split draws from its own seeded generator
    t_split = tdata.GraphData(str(tmp_path), shuffle=False).get_train_val_test_loader(
        train_ratio=0.5, val_ratio=0.25, batch_size=2, seed=3)
    j_split = jdata.GraphData(str(tmp_path), shuffle=False).get_train_val_test_loader(
        train_ratio=0.5, val_ratio=0.25, batch_size=2, seed=3)
    for tl, jl in zip(t_split, j_split):
        np.testing.assert_array_equal(tl.indices, jl.indices)


def _cif_dir(tmp_path):
    labels = {}
    rng = np.random.default_rng(3)
    for name in CIFS:
        shutil.copy(f"{ROOT}/examples/{name}.cif", tmp_path / f"{name}.cif")
        n = len(TStructure.from_file(f"{ROOT}/examples/{name}.cif"))
        labels[name] = {
            "energy_per_atom": float(rng.normal()),
            "force": rng.normal(size=(n, 3)).tolist(),
            "stress": rng.normal(size=(3, 3)).tolist(),
            "magmom": np.abs(rng.normal(size=n)).tolist(),
        }
    with open(tmp_path / "labels.json", "w") as fh:
        json.dump(labels, fh)
    return labels


def _same_items(t_data, j_data):
    assert len(t_data) == len(j_data)
    for idx in range(len(t_data)):
        (tg, tt), (jg, jt) = t_data[idx], j_data[idx]
        assert tg.graph_id == jg.graph_id and tg.mp_id == jg.mp_id
        np.testing.assert_array_equal(tg.atom_graph, jg.atom_graph)
        np.testing.assert_array_equal(tg.bond_graph, jg.bond_graph)
        assert sorted(tt) == sorted(jt)
        for key in tt:
            assert np.array_equal(tt[key], jt[key], equal_nan=True), key


def test_cif_data_and_structure_json_data_on_repo_cifs(tmp_path):
    """CIFData over the repo's example CIFs with a labels.json, and
    StructureJsonData over an MPtrj-schema JSON of the same structures:
    the same graphs and targets as chgnet_tpu's."""
    labels = _cif_dir(tmp_path)
    _same_items(
        tdata.CIFData(str(tmp_path), shuffle=False),
        jdata.CIFData(str(tmp_path), shuffle=False),
    )
    mptrj = {
        name: {f"{name}-0": {
            "structure": TStructure.from_file(f"{ROOT}/examples/{name}.cif").as_dict(),
            **labels[name],
        }}
        for name in CIFS
    }
    path = str(tmp_path / "mptrj.json")
    tutils.write_json(mptrj, path)
    t_json = tdata.StructureJsonData(path, shuffle=False)
    _same_items(t_json, jdata.StructureJsonData(path, shuffle=False))
    assert t_json.labels is t_json.data


# --------------------------------------------------------------- VASP files
SPECIES = ["Li", "Mn", "O", "O"]


def _write_vasp_dir(path, *, magmoms: bool, nelm: int = 6):
    """A VASP run of 3 ionic steps over a 4-atom cell; step 1's electronic
    loop hits NELM (the convergence filter drops it)."""
    rng = np.random.default_rng(11)
    lattice = np.diag([3.0, 3.1, 3.2]) + 0.01 * rng.normal(size=(3, 3))
    steps = []
    for i in range(3):
        steps.append({
            "frac": rng.random((4, 3)),
            "forces": rng.normal(size=(4, 3)),
            "stress": rng.normal(size=(3, 3)) * 10,
            "energy": -20.0 - i + rng.normal(),
            "n_elec": nelm if i == 1 else 3 + i,
            "mag": rng.normal(size=4),
        })

    def varray(name, rows):
        body = "".join(
            "<v>" + " ".join(f"{x:.8f}" for x in row) + "</v>" for row in rows)
        return f'<varray name="{name}">{body}</varray>'

    atoms = "".join(f"<rc><c>{s}</c><c>{i + 1}</c></rc>" for i, s in enumerate(SPECIES))
    calcs = "".join(
        "<calculation>" + "<scstep/>" * st["n_elec"]
        + "<structure><crystal>" + varray("basis", lattice) + "</crystal>"
        + varray("positions", st["frac"]) + "</structure>"
        + varray("forces", st["forces"]) + varray("stress", st["stress"])
        + f'<energy><i name="e_fr_energy">{st["energy"] + 0.01}</i>'
        f'<i name="e_0_energy">{st["energy"]}</i></energy></calculation>'
        for st in steps
    )
    xml = (
        '<?xml version="1.0"?><modeling><parameters><separator name="electronic">'
        f'<i type="int" name="NELM">{nelm}</i></separator></parameters>'
        f'<atominfo><array name="atoms"><set>{atoms}</set></array></atominfo>'
        f"{calcs}</modeling>"
    )
    (path / "vasprun.xml").write_text(xml)
    (path / "OSZICAR").write_text("".join(
        f"   {i + 1} F= {st['energy']:.8E} E0= {st['energy']:.8E}\n"
        for i, st in enumerate(steps)))
    if magmoms:
        blocks = []
        for st in steps:
            rows = "".join(
                f"    {k + 1}        0.001   0.002   {m:.3f}   {m:.3f}\n"
                for k, m in enumerate(st["mag"]))
            blocks.append(
                " magnetization (x)\n\n# of ion       s       p       d       tot\n"
                "------------------------------------------\n" + rows
                + "--------------------------------------------------\n"
                "tot          0.004   0.008   1.000   1.012\n\n")
        (path / "OUTCAR").write_text("".join(blocks) + blocks[-1])


@pytest.mark.parametrize("magmoms", [True, False], ids=["magmoms", "no-magmoms"])
def test_parse_vasp_dir_matches_chgnet_tpu(magmoms, tmp_path):
    """The parsed lists equal chgnet_tpu's, with and without OUTCAR
    magmoms, with the convergence filter on and off; ``save_path`` writes
    the same JSON; ``StructureData.from_vasp`` serves the same items."""
    _write_vasp_dir(tmp_path, magmoms=magmoms)
    for check in (True, False):
        t_out = tvasp.parse_vasp_dir(str(tmp_path), check_electronic_convergence=check,
                                     save_path=str(tmp_path / "t.json"))
        j_out = jvasp.parse_vasp_dir(str(tmp_path), check_electronic_convergence=check,
                                     save_path=str(tmp_path / "j.json"))
        assert len(t_out["structure"]) == (2 if check else 3)
        assert sorted(t_out) == sorted(j_out)
        for key in t_out:
            if key == "structure":
                for a, b in zip(t_out[key], j_out[key], strict=True):
                    np.testing.assert_array_equal(a.frac_coords, b.frac_coords)
                    np.testing.assert_array_equal(a.lattice.matrix, b.lattice.matrix)
                    assert a.species_symbols == b.species_symbols == SPECIES
            else:
                assert t_out[key] == j_out[key], key
        assert bool(t_out["magmom"]) == magmoms
        saved = [tutils.read_json(str(tmp_path / f"{p}.json")) for p in "tj"]
        for dct in saved:  # the structures name their own package's class
            for struct in dct["structure"]:
                struct.pop("@module")
        assert saved[0] == saved[1]
    t_data = tdata.StructureData.from_vasp(str(tmp_path), shuffle=False)
    j_data = jdata.StructureData.from_vasp(str(tmp_path), shuffle=False)
    _same_items(t_data, j_data)
    (tmp_path / "empty").mkdir()
    with pytest.raises(RuntimeError, match="No data parsed"):
        tvasp.parse_vasp_dir(str(tmp_path / "empty"))


def test_solve_charge_by_mag_matches_chgnet_tpu():
    struct = TStructure.from_file(f"{ROOT}/examples/mp-18767-LiMnO2.cif")
    jstruct = JStructure.from_file(f"{ROOT}/examples/mp-18767-LiMnO2.cif")
    mags = [0.0 if s != "Mn" else 3.8 for s in struct.species_symbols]
    struct.site_properties["final_magmom"] = mags
    jstruct.site_properties["final_magmom"] = mags
    t_out = tvasp.solve_charge_by_mag(struct)
    j_out = jvasp.solve_charge_by_mag(jstruct)
    assert t_out.site_properties["oxidation_state"] == j_out.site_properties[
        "oxidation_state"]
    del struct.site_properties["final_magmom"]
    with pytest.warns(UserWarning, match="no magmoms"):
        assert tvasp.solve_charge_by_mag(struct) is None


# ------------------------------------------------------------- host helpers
def test_common_helpers(tmp_path, monkeypatch):
    import torch

    from chgnet_tpu_torch.models import convert
    from chgnet_tpu_torch.models.chgnet import CHGNet

    meter = tutils.AverageMeter()
    meter.update(2.0, 3)
    meter.update(4.0, 1)
    assert (meter.val, meter.sum, meter.count, meter.avg) == (4.0, 10.0, 4, 2.5)
    meter.reset()
    assert meter.avg == 0.0
    assert tutils.mae([1.0, 2.0], [2.0, 4.0]) == pytest.approx(1.5)
    path = tutils.mkdir(str(tmp_path / "a" / "b"))
    assert os.path.isdir(path)
    tutils.write_json({"x": np.float32(1.5), "y": np.arange(3), "z": np.int64(2)},
                      os.path.join(path, "f.json"))
    assert tutils.read_json(os.path.join(path, "f.json")) == {
        "x": 1.5, "y": [0, 1, 2], "z": 2}
    model = CHGNet(seed=0, device="cpu")
    assert tutils.count_params(model.params) == model.n_params == 412_525
    assert convert.count_params is tutils.count_params
    monkeypatch.delenv("CHGNET_DEVICE", raising=False)
    assert tutils.determine_device("cpu") == "cpu"
    monkeypatch.setenv("CHGNET_DEVICE", "cpu")
    assert tutils.determine_device() == "cpu"
    monkeypatch.delenv("CHGNET_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tutils.determine_device()
    assert tutils.cuda_devices_sorted_by_free_mem() == []


def test_profiling_timeit_and_trace(tmp_path):
    import torch

    x = torch.ones(64, 64)
    res = tutils.timeit(lambda a: a @ a, x, iters=3, repeats=2)
    assert res["seconds_per_iter"] > 0 and res["iters"] == 3
    with tutils.trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    assert os.path.exists(tmp_path / "trace" / "trace.json")
    assert any("mm" in e.key for e in prof.key_averages())


# ----------------------------------------------------------------- packaging
def test_package_data_ships_every_source_a_loader_opens():
    """Every source the port's build loaders open (the CUDA sources and
    headers of ops/build.py, the host libraries' C++ sources of
    utils/native/build.py's callers) matches a package-data glob of
    pyproject.toml, so an installed port can build them."""
    from chgnet_tpu_torch.graph.fast import fast_graph
    from chgnet_tpu_torch.ops import build
    from chgnet_tpu_torch.utils.native import hostops

    with open(f"{ROOT}/pyproject.toml", "rb") as fh:
        package_data = tomllib.load(fh)["tool"]["setuptools"]["package-data"]
    sources = [os.path.join(build.CSRC, f"{name}.cu") for name in build.SOURCES]
    sources += [os.path.join(build.CSRC, f) for f in os.listdir(build.CSRC)
                if f.endswith(".cuh")]
    sources += [fast_graph.SOURCE, hostops.SOURCE]

    def shipped(path):
        rel = os.path.relpath(path, ROOT)
        for package, globs in package_data.items():
            pkg_dir = package.replace(".", "/")
            if rel.startswith(pkg_dir + "/"):
                inner = rel[len(pkg_dir) + 1:]
                if any(fnmatch.fnmatch(inner, g) for g in globs):
                    return True
        return False

    assert all(os.path.exists(s) for s in sources)
    missing = [os.path.relpath(s, ROOT) for s in sources if not shipped(s)]
    assert not missing, f"not in pyproject.toml package data: {missing}"
