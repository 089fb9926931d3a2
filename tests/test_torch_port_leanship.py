"""Lean topology shipping (``chgnet_tpu_torch/graph/leanship.py``,
``GraphRuntime(lean=True)``), mirroring tests/test_leanship.py with bit
equality in place of its allclose: the port has no raw plan mode, so the
expanded batch is the host batch, plans included.

* The expanded batch equals ``batch.to(device)`` bit for bit (with and
  without the window plans of ``CHGNET_TPU_STREAM_V2``, with and without
  the halo-tiled fields), and its arrays equal chgnet_tpu's lean expansion.
* E/F/S/M through it equal the direct transfer's bit for bit, and lean MD
  is plain MD bit for bit.
* Images outside int8's range and the dense slots are refused; a rebuild
  after drift, a batch without angles and the pipelined rebuilds keep
  working.
"""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch

from chgnet_tpu import ROOT
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.graph.batching import batch_graphs as j_batch_graphs
from chgnet_tpu.graph.converter import CrystalGraphConverter as JConverter
from chgnet_tpu.graph.leanship import ship_lean as j_ship_lean
from chgnet_tpu_torch.core.structure import Structure as TStructure
from chgnet_tpu_torch.graph.batching import batch_graphs as t_batch_graphs
from chgnet_tpu_torch.graph.converter import CrystalGraphConverter as TConverter
from chgnet_tpu_torch.graph.leanship import batch_mismatches, make_lean, ship_lean
from chgnet_tpu_torch.models.chgnet import CHGNet as TCHGNet
from chgnet_tpu_torch.models.chgnet import compute_batch as t_compute_batch
from chgnet_tpu_torch.simulation import MolecularDynamics
from chgnet_tpu_torch.simulation.runtime import GraphRuntime, compute_batch_dynamic
from test_golden_traces import SMALL

SAVED = dict(SMALL, graph_converter_algorithm="numpy")
LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
SKIN = 0.3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its passes and MD steps
    are many small ops, which several test processes on one machine's cores
    slow down many times over when each op spreads over every core."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def model():
    return TCHGNet(seed=0, device="cpu", **SAVED)


def _structs(cls):
    base = cls.from_file(LIMNO2)
    return [base, base.make_supercell((2, 1, 1))]


@pytest.fixture(scope="module")
def batch(model):
    return t_batch_graphs(_graphs_of(model))


def _tiled_graph(model):
    struct = TStructure.from_file(LIMNO2).make_supercell((4, 3, 3))
    return model.graph_converter(struct.perturb(0.03, seed=0).spatial_sort())


def assert_same_batch(got, want):
    """Two device batches equal field by field, plan by plan, bit for bit."""
    assert batch_mismatches(got, want) == []


def _graphs_of(model):
    cfg = model.config
    conv = TConverter(atom_graph_cutoff=cfg.atom_graph_cutoff + SKIN,
                      bond_graph_cutoff=cfg.bond_graph_cutoff + SKIN, algorithm="numpy")
    return [conv(s) for s in _structs(TStructure)]


@pytest.mark.parametrize("stream_v2", [False, True], ids=["csr", "windows"])
@pytest.mark.parametrize("tile", [False, 64], ids=["untiled", "tiled"])
def test_expand_reproduces_host_batch(model, stream_v2, tile, monkeypatch):
    if stream_v2:  # the window plans are built with the batch
        monkeypatch.setenv("CHGNET_TPU_STREAM_V2", "1")
    if tile:
        host = t_batch_graphs([_tiled_graph(model)], tile=tile)
    else:
        host = t_batch_graphs(_graphs_of(model))
    assert host.tiled == bool(tile)
    assert bool(host.plan_center.window.shape[0]) == stream_v2
    assert_same_batch(ship_lean(make_lean(host), "cpu"), host.to("cpu"))


def test_expanded_batch_equals_chgnet_tpu_lean(batch, model):
    """The port's lean expansion gives chgnet_tpu's lean arrays (every
    field but the plans, whose TPU forms differ)."""
    cfg = model.config
    conv = JConverter(atom_graph_cutoff=cfg.atom_graph_cutoff + SKIN,
                      bond_graph_cutoff=cfg.bond_graph_cutoff + SKIN, algorithm="numpy")
    want = jax.tree.map(np.asarray, j_ship_lean(j_batch_graphs([conv(s) for s in _structs(JStructure)])))
    got = ship_lean(make_lean(batch), "cpu")
    shared = [f for f in got._fields if f in want._fields and not f.startswith("plan_")]
    assert len(shared) >= 24
    for name in shared:
        a, b = getattr(got, name).numpy(), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_lean_forward_and_gradients_match(model, batch):
    ref = compute_batch_dynamic(model.params, batch.to("cpu"), config=model.config)
    lean = compute_batch_dynamic(model.params, ship_lean(make_lean(batch), "cpu"), config=model.config)
    for key in ("e", "f", "s", "m"):
        assert torch.equal(ref[key], lean[key]), key


def test_batch_mismatches_names_each_differing_part(batch):
    """The equality check names a changed field and a changed plan part,
    and nothing for a batch against its own copy."""
    ref = batch.to("cpu")
    assert batch_mismatches(batch.to("cpu"), ref) == []
    masks = ref.edge_mask.clone()
    masks[0] = 0.0
    plan = ref.plan_center._replace(key=ref.plan_center.key.flip(0))
    assert batch_mismatches(ref._replace(edge_mask=masks, plan_center=plan), ref) == [
        "edge_mask", "plan_center.key"]


def test_images_out_of_int8_range_rejected(batch):
    images = batch.images.copy()
    images[0, 0] = 200.0
    with pytest.raises(ValueError, match="int8"):
        make_lean(batch._replace(images=images))


def test_dense_slots_rejected(batch, model):
    dense = t_batch_graphs(_graphs_of(model), dense_k=True)
    with pytest.raises(ValueError, match="CSR layout"):
        make_lean(dense)


def test_runtime_lean_md_equivalence(model):
    """MD with ``lean=True`` is plain MD bit for bit."""
    struct = TStructure.from_file(LIMNO2).make_supercell((2, 1, 1))

    def run(lean):
        md = MolecularDynamics(
            struct, model=model, ensemble="nve", temperature=300.0,
            starting_temperature=300.0, timestep=1.0, seed=7, lean=lean,
        )
        md.run(6)
        return md

    ref, lean = run(False), run(True)
    assert lean.runtime.lean and not ref.runtime.lean
    assert torch.equal(ref.state.frac, lean.state.frac)
    assert torch.equal(ref.state.epot, lean.state.epot)


def test_lean_rebuild_after_drift(model):
    """A lean rebuild after drift gives what a fresh plain runtime built at
    the drifted positions gives."""
    rng = np.random.default_rng(3)
    base = TStructure.from_file(LIMNO2)
    rt = GraphRuntime(model.config, [base], skin=0.4, lean=True, device="cpu")
    frac = rt.batch.frac_coords.numpy().copy()
    lat = rt.batch.lattices.numpy().copy()
    n = len(base)
    frac[:n] += rng.normal(scale=0.02, size=(n, 3)).astype(np.float32)
    rebuilt = rt.rebuild(frac, lat)
    assert rt.n_rebuilds == 1
    fresh = GraphRuntime(
        model.config,
        [TStructure(base.lattice, base.atomic_numbers.tolist(), frac[:n])],
        skin=0.4, device="cpu",
    )
    assert_same_batch(rebuilt, fresh.batch)
    out_lean = compute_batch_dynamic(model.params, rebuilt, config=model.config)
    out_ref = compute_batch_dynamic(model.params, fresh.batch, config=model.config)
    assert torch.equal(out_lean["e"], out_ref["e"])


def test_lean_zero_angle_batch(model):
    """A batch without angle rows (a tiny bond cutoff) survives the round
    trip: every angle count is 0 and every angle row padding."""
    conv = TConverter(atom_graph_cutoff=model.config.atom_graph_cutoff,
                      bond_graph_cutoff=0.5, algorithm="numpy")
    host = t_batch_graphs([conv(TStructure.from_file(LIMNO2))])
    assert float(host.angle_mask.sum()) == 0
    assert_same_batch(ship_lean(make_lean(host), "cpu"), host.to("cpu"))


def test_pipelined_rebuild_ordering(model):
    """Lean background rebuilds apply in launch order up to the pipeline
    depth; the last accepted launch's positions become the Verlet
    reference, and a launch is refused while the pipeline is full."""
    rng = np.random.default_rng(11)
    struct = TStructure.from_file(LIMNO2).make_supercell((2, 2, 1))
    rt = GraphRuntime(model.config, [struct], skin=0.8, lean=True, device="cpu")
    frac0 = rt.batch.frac_coords.numpy().copy()
    lat = rt.batch.lattices.numpy().copy()
    n = len(struct)

    def perturbed(scale):
        f = frac0.copy()
        f[:n] += rng.normal(scale=scale, size=(n, 3)).astype(np.float32)
        return f

    f1, f2, f3 = perturbed(0.02), perturbed(0.05), perturbed(0.08)
    assert rt.launch_rebuild(f1, lat)
    assert rt.launch_rebuild(f2, lat)
    assert rt.launch_rebuild(f3, lat)
    assert not rt.launch_rebuild(perturbed(0.08), lat)
    deadline = time.time() + 120
    while rt._pipeline and time.time() < deadline:
        rt.poll_rebuild()
        time.sleep(0.05)
    assert not rt._pipeline and rt.n_rebuilds == 3
    np.testing.assert_array_equal(rt._ref_frac, f3.astype(np.float32))
    assert rt.stats["put_s"] > 0


def test_tiled_lean_round_trip(model):
    """The buffer carries the halo-tiled fields and their plans; E and F
    through the lean batch equal the direct transfer's."""
    host = t_batch_graphs([_tiled_graph(model)], tile=64)
    lean = ship_lean(make_lean(host), "cpu")
    assert_same_batch(lean, host.to("cpu"))
    kw = dict(config=model.config, compute_force=True)
    r0 = t_compute_batch(model.params, host.to("cpu"), **kw)
    r1 = t_compute_batch(model.params, lean, **kw)
    assert torch.equal(r0["e"], r1["e"]) and torch.equal(r0["f"], r1["f"])
