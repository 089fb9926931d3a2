"""The dense per-atom slots (``CHGNetConfig.dense_atom_conv``,
``batch_graphs(dense_k=...)``) of the PyTorch port against chgnet_tpu.

* The slots ``dense_nbr`` / ``dense_bond`` / ``dense_mask`` equal
  chgnet_tpu's bit for bit, for ``dense_k=True`` and a pinned K.
* The dense model's E/F/S/M through ``compute_batch`` and
  ``predict_structure`` equal chgnet_tpu's dense model within the f32 gate
  of tests/test_torch_port_model.py (e 2e-5 eV/atom, f 5e-5 eV/A, s 2e-4
  GPa, m 2e-5 mu_B), and the port's own CSR path within
  tests/test_model.py::test_dense_atom_conv_matches' 1e-6; in bf16 they are
  within tests/test_torch_port_bf16.py's bars of f32.
* A dense model over a batch without slots, a pinned K below the most
  neighbours and ``conv_dropout`` with ``dense_atom_conv`` raise as in
  chgnet_tpu.
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
from chgnet_tpu_torch.models.chgnet import CHGNet as TCHGNet
from chgnet_tpu_torch.models.chgnet import compute_batch as t_compute_batch

SMALL = dict(
    atom_fea_dim=16, bond_fea_dim=16, angle_fea_dim=16, num_radial=9,
    num_angular=9, n_conv=3, mlp_hidden_dims=(16,), atom_conv_hidden_dim=16,
    bond_conv_hidden_dim=16, graph_converter_algorithm="numpy",
)
DENSE = dict(SMALL, dense_atom_conv=True)
TOL = {"e": 2e-5, "f": 5e-5, "s": 2e-4, "m": 2e-5}
BF16_BARS = {"e": 2e-3, "f": 2e-2, "s": 2e-2, "m": 2e-2}
CSR_TOL = 1e-6
LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
LICOO = f"{ROOT}/examples/mp-1175469-Li9Co7O16.cif"
FLAGS = dict(compute_force=True, compute_stress=True, compute_magmom=True)
SLOTS = ("dense_nbr", "dense_bond", "dense_mask")


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
    """Two crystals of a few dozen atoms in one batch, in both packages."""
    tm = TCHGNet(seed=0, device="cpu", **DENSE)
    jm = JCHGNet(seed=0, **DENSE)
    cifs = [(LIMNO2, (2, 1, 1)), (LICOO, (1, 1, 1))]
    tg = [tm.graph_converter(TStructure.from_file(f).make_supercell(n).perturb(0.03, seed=i))
          for i, (f, n) in enumerate(cifs)]
    jg = [jm.graph_converter(JStructure.from_file(f).make_supercell(n).perturb(0.03, seed=i))
          for i, (f, n) in enumerate(cifs)]
    return tg, jg


@pytest.fixture(scope="module")
def outputs(graphs):
    """E/F/S/M of the dense model in both packages, of the port's dense
    model in bf16, and of the port's CSR (undirected) model, over the same
    batch."""
    tg, jg = graphs
    jm = JCHGNet(seed=0, **DENSE)
    want = j_compute_batch(jm.params, j_batch_graphs(jg, dense_k=True),
                           config=jm.config, **FLAGS)
    dense = t_batch_graphs(tg, dense_k=True).to("cpu")
    out = {"jax": {k: np.asarray(v) for k, v in want.items()}}
    for label, kw in (("f32", DENSE), ("bf16", dict(DENSE, compute_dtype="bfloat16"))):
        tm = TCHGNet(seed=0, device="cpu", **kw)
        out[label] = {k: v.numpy() for k, v in t_compute_batch(
            tm.params, dense, config=tm.config, **FLAGS).items()}
    csr = TCHGNet(seed=0, device="cpu", directed_bonds=False, **SMALL)
    out["csr"] = {k: v.numpy() for k, v in t_compute_batch(
        csr.params, t_batch_graphs(tg).to("cpu"), config=csr.config, **FLAGS).items()}
    return out


@pytest.mark.parametrize("dense_k", [True, 120])
def test_dense_slots_equal_chgnet_tpu(graphs, dense_k):
    tg, jg = graphs
    tb, jb = t_batch_graphs(tg, dense_k=dense_k), j_batch_graphs(jg, dense_k=dense_k)
    for name in SLOTS:
        got, want = getattr(tb, name), np.asarray(getattr(jb, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert np.array_equal(got, want), name
    assert tb.dense_nbr.shape[1] % 8 == 0
    # every valid edge sits in one slot of its centre, by the undirected bond
    valid = tb.edge_mask > 0
    assert int(tb.dense_mask.sum()) == int(valid.sum())
    rows, slots = np.nonzero(tb.dense_mask)
    pairs = set(zip(rows, tb.dense_nbr[rows, slots], tb.dense_bond[rows, slots]))
    assert pairs == set(zip(tb.atom_graph[valid, 0], tb.atom_graph[valid, 1],
                            tb.directed2undirected[valid]))


def test_dense_k_below_the_most_neighbours_raises(graphs):
    tg, _ = graphs
    most = int(t_batch_graphs(tg, dense_k=True).dense_mask.sum(axis=1).max())
    with pytest.raises(ValueError, match="dense_k"):
        t_batch_graphs(tg, dense_k=most - 1)


def test_dense_model_without_slots_raises(graphs):
    tm = TCHGNet(seed=0, device="cpu", **DENSE)
    with pytest.raises(ValueError, match="dense_k"):
        t_compute_batch(tm.params, t_batch_graphs(graphs[0]).to("cpu"),
                        config=tm.config)


def test_conv_dropout_with_dense_raises():
    with pytest.raises(NotImplementedError, match="dense_atom_conv"):
        TCHGNet(seed=0, device="cpu", conv_dropout=0.1, **DENSE)


@pytest.mark.parametrize("key", list(TOL))
def test_dense_compute_batch_matches_chgnet_tpu(outputs, key):
    err = float(np.abs(outputs["f32"][key] - outputs["jax"][key]).max())
    assert err <= TOL[key], (key, err)


@pytest.mark.parametrize("key", list(TOL))
def test_dense_matches_the_port_csr_path(outputs, key):
    err = float(np.abs(outputs["f32"][key] - outputs["csr"][key]).max())
    assert err <= CSR_TOL, (key, err)


@pytest.mark.parametrize("key", list(BF16_BARS))
def test_dense_bf16_within_the_bars_of_f32(outputs, key):
    got = outputs["bf16"][key]
    assert got.dtype == np.float32 and np.isfinite(got).all()
    err = float(np.abs(got - outputs["f32"][key]).max())
    assert err <= BF16_BARS[key], (key, err)


def test_dense_predict_structure_matches_chgnet_tpu():
    """``predict_structure`` builds its batch with the slots (``dense_k``)
    and gives chgnet_tpu's dense E/F/S/M."""
    tm = TCHGNet(seed=0, device="cpu", **DENSE)
    jm = JCHGNet(seed=0, **DENSE)
    got = tm.predict_structure(TStructure.from_file(LIMNO2).perturb(0.05, seed=1))
    want = jm.predict_structure(JStructure.from_file(LIMNO2).perturb(0.05, seed=1))
    for key, tol in TOL.items():
        err = float(np.abs(np.asarray(got[key]) - np.asarray(want[key])).max())
        assert err <= tol, (key, err)
