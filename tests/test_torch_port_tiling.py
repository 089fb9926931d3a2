"""The halo-tiled neighbour layout (``batch_graphs(tile=...)``,
``GraphRuntime(tile=...)`` / ``CHGNET_TPU_MD_TILE``) of the PyTorch port,
mirroring tests/test_tiling.py against chgnet_tpu.

* ``exp_map`` / ``nbr_x`` and their plans' sorted keys equal chgnet_tpu's
  bit for bit; the expansion restates the neighbour stream row for row and
  every neighbour row lies in its centre tile's region of the expanded
  table.
* The tiled model equals the untiled one at tests/test_tiling.py's
  tolerances (e 1e-6, f 5e-5, s 5e-5, m 1e-6) and chgnet_tpu's tiled model
  within the f32 gate of tests/test_torch_port_model.py.
* Tiled MD rebuilds keep the layout and their shapes; the first build's
  expansion probe falls back untiled, with a warning, for an atom order
  that is not spatially local.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chgnet_tpu import ROOT
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.graph.batching import batch_graphs as j_batch_graphs
from chgnet_tpu.models.chgnet import CHGNet as JCHGNet
from chgnet_tpu.models.chgnet import compute_batch as j_compute_batch
from chgnet_tpu_torch.core.structure import Structure as TStructure
from chgnet_tpu_torch.graph.batching import batch_graphs as t_batch_graphs
from chgnet_tpu_torch.graph.leanship import batch_mismatches
from chgnet_tpu_torch.models.chgnet import CHGNet as TCHGNet
from chgnet_tpu_torch.models.chgnet import CHGNetConfig as TConfig
from chgnet_tpu_torch.models.chgnet import compute_batch as t_compute_batch
from chgnet_tpu_torch.simulation import MolecularDynamics
from chgnet_tpu_torch.simulation.runtime import GraphRuntime

SMALL = dict(
    atom_fea_dim=16, bond_fea_dim=16, angle_fea_dim=16, num_radial=9,
    num_angular=9, n_conv=3, mlp_hidden_dims=(16,), atom_conv_hidden_dim=16,
    bond_conv_hidden_dim=16, graph_converter_algorithm="numpy",
)
TOL = {"e": 2e-5, "f": 5e-5, "s": 2e-4, "m": 2e-5}
UNTILED_TOL = {"e": 1e-6, "f": 5e-5, "s": 5e-5, "m": 1e-6}
LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
FLAGS = dict(compute_force=True, compute_stress=True, compute_magmom=True)
TILE = 64


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
def graphs():
    """A spatially sorted 4x3x3 LiMnO2 supercell (144 atoms, three tiles
    of 64) in both packages."""
    def make(cls, model):
        struct = cls.from_file(LIMNO2).make_supercell((4, 3, 3))
        return model.graph_converter(struct.perturb(0.03, seed=0).spatial_sort())

    return (make(TStructure, TCHGNet(seed=0, device="cpu", **SMALL)),
            make(JStructure, JCHGNet(seed=0, **SMALL)))


@pytest.fixture(scope="module")
def outputs(graphs):
    tg, jg = graphs
    tm, jm = TCHGNet(seed=0, device="cpu", **SMALL), JCHGNet(seed=0, **SMALL)
    tiled = t_batch_graphs([tg], tile=TILE)
    assert tiled.tiled
    out = {"jax": {k: np.asarray(v) for k, v in j_compute_batch(
        jm.params, j_batch_graphs([jg], tile=TILE), config=jm.config, **FLAGS).items()}}
    for label, batch in (("tiled", tiled), ("untiled", t_batch_graphs([tg]))):
        out[label] = {k: v.numpy() for k, v in t_compute_batch(
            tm.params, batch.to("cpu"), config=tm.config, **FLAGS).items()}
    return out


def test_halo_map_equals_chgnet_tpu_exact_and_local(graphs):
    tg, jg = graphs
    tb, jb = t_batch_graphs([tg], tile=TILE), j_batch_graphs([jg], tile=TILE)
    for name in ("exp_map", "nbr_x"):
        got, want = getattr(tb, name), np.asarray(getattr(jb, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for name in ("plan_exp", "plan_nbr_x"):
        got, want = getattr(tb, name), getattr(jb, name)
        assert np.array_equal(got.sorted_keys(), np.asarray(want.dst)), name
        assert np.array_equal(got.perm, np.asarray(want.perm)), name
    valid = tb.edge_mask > 0
    # the expansion restates the neighbour stream row for row
    assert (tb.exp_map[tb.nbr_x][valid] == tb.atom_graph[valid, 1]).all()
    # every neighbour row lies in its centre tile's region: the tile's own
    # rows, then its distinct remote neighbours, regions in tile order
    centers, nbrs = tb.atom_graph[valid, 0], tb.atom_graph[valid, 1]
    n_tiles = -(-tb.atomic_numbers.shape[0] // TILE)
    halo = [len(set(nbrs[(centers // TILE == t) & (nbrs // TILE != t)])) for t in range(n_tiles)]
    region = np.concatenate([[0], np.cumsum(TILE + np.asarray(halo))])
    rows, tiles = tb.nbr_x[valid], centers // TILE
    assert ((region[tiles] <= rows) & (rows < region[tiles + 1])).all()
    # padded rows of the expanded table drop out of plan_exp
    n_x = int((tb.plan_exp.key < tb.atomic_numbers.shape[0]).sum())
    assert (tb.plan_exp.key[n_x:] == tb.atomic_numbers.shape[0]).all()
    assert tb.exp_map.shape[0] % 512 == 0


@pytest.mark.parametrize("key", list(TOL))
def test_tiled_model_matches_untiled_and_chgnet_tpu(outputs, key):
    got = outputs["tiled"][key]
    err_untiled = float(np.abs(got - outputs["untiled"][key]).max())
    err_jax = float(np.abs(got - outputs["jax"][key]).max())
    assert err_untiled <= UNTILED_TOL[key], (key, err_untiled)
    assert err_jax <= TOL[key], (key, err_jax)


def test_tiled_batch_adds_only_the_tile_fields(graphs):
    """``tile=`` adds the expanded table and its plans and leaves every
    other field of the batch as the untiled build makes it, bit for bit."""
    tg, _ = graphs
    tiled = t_batch_graphs([tg], tile=TILE).to("cpu")
    plain = t_batch_graphs([tg]).to("cpu")
    differ = {name.split(".")[0] for name in batch_mismatches(tiled, plain)}
    assert differ == {"exp_map", "nbr_x", "plan_exp", "plan_nbr_x"}


def test_tiled_md_runtime_rebuilds(monkeypatch):
    """MD under ``CHGNET_TPU_MD_TILE`` keeps the tiled layout and its
    shapes across rebuilds."""
    monkeypatch.setenv("CHGNET_TPU_MD_TILE", str(TILE))
    model = TCHGNet(seed=0, device="cpu", **SMALL)
    struct = TStructure.from_file(LIMNO2).make_supercell(2).perturb(0.02, seed=0)
    md = MolecularDynamics(
        struct.spatial_sort(), model=model, ensemble="nvt", thermostat="Berendsen",
        temperature=300.0, starting_temperature=300.0, timestep=1.0, seed=0,
        chunk_size=4, skin=0.2,
    )
    rt = md.runtime
    assert rt.tile == TILE and rt.batch.tiled
    n_x = rt.batch.exp_map.shape[0]
    md.run(16)
    assert rt.n_rebuilds >= 1
    assert rt.batch.tiled and rt.batch.exp_map.shape[0] >= n_x
    temp = float(md.get_temperature())
    assert 0.0 < temp < 1500.0


def test_tile_expansion_probe():
    """The runtime stays untiled unless asked; ``tile=`` on a spatially
    sorted structure is kept, on a site-major supercell (halos of most of
    the table) it falls back untiled with a warning."""
    base = TStructure.from_file(LIMNO2).make_supercell((6, 6, 6)).perturb(0.02, seed=0)
    cfg = TConfig()
    plain = GraphRuntime(cfg, [base.spatial_sort()], skin=0.2, device="cpu")
    assert plain.tile is False and not plain.batch.tiled
    kept = GraphRuntime(cfg, [base.spatial_sort()], skin=0.2, device="cpu", tile=TILE)
    assert kept.tile == TILE and kept.batch.tiled and not kept._tile_probe
    with pytest.warns(UserWarning, match="tiling disabled"):
        dropped = GraphRuntime(cfg, [base], skin=0.2, device="cpu", tile=TILE)
    assert dropped.tile is False and not dropped.batch.tiled
