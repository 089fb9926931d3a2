"""The port at ``WIDE128`` (every feature and hidden width 128: the
published 0.3.0 architecture with its widths doubled, ``n_conv`` cut to 3
for time) against ``chgnet_tpu`` at the same widths and weights.

Both packages draw the same parameters from one numpy seed
(``params_from_jax`` carries chgnet_tpu's across), and the port's fused
tails run their plain versions on the CPU, chgnet_tpu its XLA path. E/F/S/M
of two perturbed crystals agree at tests/test_torch_port_model.py's
tolerances (e 2e-5 eV/atom, f 5e-5 eV/A, s 2e-4 GPa, m 2e-5 mu_B) in both
bond layouts; in bf16 (``compute_dtype="bfloat16"``, ``matmul_precision=
"default"``) the port against chgnet_tpu in bf16 and against its own f32 at
tests/test_torch_port_bf16.py's bars (PARITY, BARS).
"""

from __future__ import annotations

import jax
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

WIDE128 = dict(atom_fea_dim=128, bond_fea_dim=128, angle_fea_dim=128,
               atom_conv_hidden_dim=128, bond_conv_hidden_dim=128)
KW = dict(WIDE128, n_conv=3, graph_converter_algorithm="numpy")
BF16 = dict(compute_dtype="bfloat16", matmul_precision="default")
TOL = {"e": 2e-5, "f": 5e-5, "s": 2e-4, "m": 2e-5}
PARITY = {"e": 1e-3, "f": 1e-2, "s": 2e-2, "m": 1e-2}
BARS = {"e": 2e-3, "f": 2e-2, "s": 2e-2, "m": 2e-2}
STRUCTS = ((f"{ROOT}/examples/mp-18767-LiMnO2.cif", 1),
           (f"{ROOT}/examples/mp-1175469-Li9Co7O16.cif", 2))
FLAGS = dict(compute_force=True, compute_stress=True, compute_magmom=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (many small ops; see
    tests/test_torch_port_simulation.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _run(kw):
    """(chgnet_tpu's outputs, the port's, (graphs, atoms)) of STRUCTS."""
    jm = JCHGNet(seed=0, **kw)
    tm = TCHGNet(seed=0, device="cpu", params=jax.tree.map(np.asarray, jm.params), **kw)
    gj, gt = [], []
    for path, seed in STRUCTS:
        gj.append(jm.graph_converter(JStructure.from_file(path).perturb(0.05, seed=seed)))
        gt.append(tm.graph_converter(TStructure.from_file(path).perturb(0.05, seed=seed)))
    jout = j_compute_batch(jm.params, j_batch_graphs(gj), config=jm.config, **FLAGS)
    tout = t_compute_batch(tm.params, t_batch_graphs(gt).to("cpu"), config=tm.config,
                           **FLAGS)
    return jout, tout, (len(gt), sum(g.n_atoms for g in gt))


def _err(out, ref, key, n):
    sl = n[0] if key in "es" else n[1]
    got = np.asarray(out[key], np.float64)[:sl]
    want = np.asarray(ref[key], np.float64)[:sl]
    assert np.isfinite(got).all(), key
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
def test_wide128_efsm_matches_chgnet_tpu(directed):
    jout, tout, n = _run(dict(KW, directed_bonds=directed))
    for key, tol in TOL.items():
        assert _err(tout, jout, key, n) <= tol, key


def test_wide128_bf16_matches_chgnet_tpu_and_its_f32():
    j16, t16, n = _run(dict(KW, **BF16))
    _, t32, _ = _run(KW)
    for key in "efsm":
        assert t16[key].dtype == torch.float32, key
        assert _err(t16, j16, key, n) <= PARITY[key], key
        assert _err(t16, t32, key, n) <= BARS[key], key
