"""Host side of the PyTorch port (chgnet_tpu_torch) against chgnet_tpu.

Structures, graphs and padded batches are numpy in both packages, so every
comparison here is exact: CIF parsing, the numpy graph builder, and every
index and mask stream of ``batch_graphs``, with the port's CSR segment
offsets checked against the sorted keys of chgnet_tpu's gather plans.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest

from chgnet_tpu import ROOT
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.graph.batching import batch_graphs as j_batch_graphs
from chgnet_tpu.graph.converter import CrystalGraphConverter as JConverter
from chgnet_tpu_torch.core.structure import Structure as TStructure
from chgnet_tpu_torch.graph.batching import batch_graphs as t_batch_graphs
from chgnet_tpu_torch.graph.batching import make_plan
from chgnet_tpu_torch.graph.converter import CrystalGraphConverter as TConverter

CIFS = ["mp-18767-LiMnO2.cif", "mp-1175469-Li9Co7O16.cif"]

# streams both batches carry, compared bit for bit
STREAMS = [
    "atomic_numbers", "frac_coords", "lattices", "atom_owner", "atom_mask",
    "atom_graph", "edge_scatter", "edge_owner", "images",
    "directed2undirected", "edge_mask", "undirected2directed", "und_second",
    "und_mask", "twin", "bond_graph", "angle_scatter", "angle_scatter_dir",
    "angle_mask",
]
# port plan -> chgnet_tpu plan over the same index stream
PLANS = [
    ("plan_center", "plan_center"),
    ("plan_nbr", "plan_nbr"),
    ("plan_ang_vi", "plan_ang_vi"),
    ("plan_ang_vj", "plan_ang_vj"),
    ("plan_d2u", "plan_d2u"),
    ("plan_u2d", "plan_u2d"),
    ("plan_u2d2", "plan_u2d2"),
]
# port plan -> the chgnet_tpu batch's index stream and validity mask
UNDIRECTED_PLANS = [
    ("plan_d2u", "directed2undirected", "edge_mask"),
    ("plan_u2d", "undirected2directed", "und_mask"),
    ("plan_u2d2", "und_second", "und_mask"),
]


def _structures(name):
    path = f"{ROOT}/examples/{name}"
    return JStructure.from_file(path), TStructure.from_file(path)


@pytest.mark.parametrize("name", CIFS)
def test_cif_parses_identically(name):
    js, ts = _structures(name)
    assert ts.atomic_numbers.tolist() == js.atomic_numbers.tolist()
    assert ts.species_symbols == js.species_symbols
    np.testing.assert_array_equal(ts.frac_coords, js.frac_coords)
    np.testing.assert_array_equal(ts.lattice.matrix, js.lattice.matrix)


@pytest.mark.parametrize("name", CIFS)
@pytest.mark.parametrize("cutoffs", [(5.0, 3.0), (6.0, 3.0)])
def test_graph_arrays_equal_numpy_builder(name, cutoffs):
    js, ts = _structures(name)
    kw = dict(
        atom_graph_cutoff=cutoffs[0], bond_graph_cutoff=cutoffs[1],
        algorithm="numpy",
    )
    jg, tg = JConverter(**kw)(js), TConverter(**kw)(ts)
    for field in (
        "atomic_number", "atom_frac_coord", "atom_graph", "neighbor_image",
        "directed2undirected", "undirected2directed", "bond_graph", "lattice",
    ):
        np.testing.assert_array_equal(getattr(tg, field), getattr(jg, field))
    if name.startswith("mp-18767") and cutoffs == (5.0, 3.0):
        assert (tg.n_directed, tg.n_undirected, tg.n_angles) == (384, 192, 744)


def test_fast_algorithm_warns_and_builds_with_numpy():
    with pytest.warns(UserWarning, match="fast"):
        conv = TConverter(algorithm="fast")
    assert conv.algorithm == "numpy"


def _graph_sets():
    js, ts = _structures(CIFS[0])
    js2, ts2 = _structures(CIFS[1])
    kw = dict(atom_graph_cutoff=6.0, bond_graph_cutoff=3.0, algorithm="numpy")
    jc, tc = JConverter(**kw), TConverter(**kw)
    one = ([jc(js)], [tc(ts)])
    j3 = [jc(js.perturb(0.05, seed=1)), jc(js2), jc(js.perturb(0.05, seed=2))]
    t3 = [tc(ts.perturb(0.05, seed=1)), tc(ts2), tc(ts.perturb(0.05, seed=2))]
    return {"1": one, "3": (j3, t3)}


@pytest.fixture(scope="module")
def graph_sets():
    return _graph_sets()


@pytest.mark.parametrize("n_graphs", ["1", "3"])
def test_batch_streams_equal_chgnet_tpu(graph_sets, n_graphs):
    jgraphs, tgraphs = graph_sets[n_graphs]
    jb, tb = j_batch_graphs(jgraphs), t_batch_graphs(tgraphs)
    for name in STREAMS:
        j, t = getattr(jb, name), getattr(tb, name)
        assert t.dtype == j.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("n_graphs", ["1", "3"])
@pytest.mark.parametrize("t_name,j_name", PLANS)
def test_csr_offsets_agree_with_chgnet_tpu_plans(
    graph_sets, n_graphs, t_name, j_name
):
    jgraphs, tgraphs = graph_sets[n_graphs]
    jb, tb = j_batch_graphs(jgraphs), t_batch_graphs(tgraphs)
    tp, jp = getattr(tb, t_name), getattr(jb, j_name)
    np.testing.assert_array_equal(tp.sorted_keys(), jp.dst)
    np.testing.assert_array_equal(tp.perm, jp.perm)
    n_out = tp.n_out
    want = np.searchsorted(jp.dst, np.arange(n_out + 1), side="left")
    np.testing.assert_array_equal(tp.offsets, want)
    assert tp.offsets[-1] == int((jp.dst < n_out).sum())


@pytest.mark.parametrize("n_graphs", ["1", "3"])
@pytest.mark.parametrize("t_name,stream,mask", UNDIRECTED_PLANS)
def test_undirected_plans_reproduce_jax_segment_sum(
    graph_sets, n_graphs, t_name, stream, mask
):
    """The port's CSR segment sum over the undirected layout's plans equals
    ``jax.ops.segment_sum`` over the chgnet_tpu batch's streams, padded rows
    dropped; exact on integer-valued rows."""
    import jax
    import jax.numpy as jnp
    import torch

    from chgnet_tpu_torch.ops.segment import segment_sum_plain

    jgraphs, tgraphs = graph_sets[n_graphs]
    jb, tb = j_batch_graphs(jgraphs), t_batch_graphs(tgraphs)
    plan = getattr(tb, t_name)
    idx, valid = getattr(jb, stream), getattr(jb, mask) > 0
    n_out = plan.n_out
    np.testing.assert_array_equal(plan.key, np.where(valid, idx, n_out))
    rng = np.random.default_rng(9)
    x = rng.integers(-8, 9, (idx.shape[0], 4)).astype(np.float32)
    want = jax.ops.segment_sum(
        jnp.asarray(x), jnp.where(valid, idx, n_out), num_segments=n_out
    )
    got = segment_sum_plain(
        torch.tensor(x), torch.as_tensor(plan.offsets), torch.as_tensor(plan.perm)
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_graph_plan_counts_atoms_per_graph(graph_sets):
    _, tgraphs = graph_sets["3"]
    tb = t_batch_graphs(tgraphs)
    counts = np.diff(tb.plan_graph.offsets)
    assert counts.tolist() == [g.n_atoms for g in tgraphs]


def test_make_plan_drops_invalid_rows_and_rejects_unsorted():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 7, 50).astype(np.int32)
    valid = rng.random(50) < 0.8
    plan = make_plan(idx, valid, 7)
    assert plan.offsets[-1] == valid.sum()
    keys = plan.sorted_keys()
    for n in range(7):
        seg = keys[plan.offsets[n]: plan.offsets[n + 1]]
        assert (seg == n).all() and seg.size == ((idx == n) & valid).sum()
    with pytest.raises(ValueError, match="unsorted"):
        make_plan(idx, valid, 7, assume_sorted=True)


def test_import_leaves_jax_and_chgnet_tpu_out():
    code = (
        "import sys, chgnet_tpu_torch, chgnet_tpu_torch.models, "
        "chgnet_tpu_torch.ops, chgnet_tpu_torch.graph, chgnet_tpu_torch.core, "
        "chgnet_tpu_torch.simulation, chgnet_tpu_torch.utils, "
        "chgnet_tpu_torch.models.checkpoint\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'chgnet_tpu.')) or m == 'chgnet_tpu')\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_port_sources_name_neither_jax_nor_chgnet_tpu():
    """No module of the port, and not chip_smoke.py, imports jax or
    chgnet_tpu (a static check of every import line)."""
    import pathlib
    import re

    files = list(pathlib.Path(ROOT, "chgnet_tpu_torch").rglob("*.py"))
    files.append(pathlib.Path(ROOT, "chip_smoke.py"))
    pat = re.compile(r"^\s*(import|from)\s+(jax|chgnet_tpu)(\s|\.|$)", re.M)
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
