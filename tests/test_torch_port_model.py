"""CHGNet in the PyTorch port against chgnet_tpu's compute_batch.

Both packages draw the same weights from one numpy seed, so the port must
reproduce chgnet_tpu's E/F/S/M in f32, with ``fused_kernels=False`` and
with the default ``fused_kernels=True`` (the port's plain PyTorch path on
the CPU, its fused tails by their plain versions; chgnet_tpu's XLA path),
within:

* e <= 2e-5 eV/atom, f <= 5e-5 eV/A, s <= 2e-4 GPa, m <= 2e-5 mu_B.

The two compute the same function in f32 with sums, products and the
first-layer projections taken in different orders (the port gathers and
then projects; the stress is a 160 x (1/V) rescaled virial, hence its
looser bound). These are the tolerances of the seed-0 pin in
tests/test_model.py::test_self_golden_regression, which the port must
also reproduce.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from chgnet_tpu import ROOT
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.graph.batching import batch_graphs as j_batch_graphs
from chgnet_tpu.models.chgnet import CHGNet as JCHGNet
from chgnet_tpu.models.chgnet import compute_batch as j_compute_batch
from chgnet_tpu_torch.core.structure import Structure as TStructure
from chgnet_tpu_torch.graph.batching import batch_graphs as t_batch_graphs
from chgnet_tpu_torch.models import convert
from chgnet_tpu_torch.models.chgnet import CHGNet as TCHGNet
from chgnet_tpu_torch.models.chgnet import CHGNetConfig as TConfig
from chgnet_tpu_torch.models.chgnet import compute_batch as t_compute_batch
from chgnet_tpu_torch.models.chgnet import init_params as t_init_params

SMALL = dict(
    atom_fea_dim=16,
    bond_fea_dim=16,
    angle_fea_dim=16,
    num_radial=9,
    num_angular=9,
    n_conv=3,
    mlp_hidden_dims=(16,),
    atom_conv_hidden_dim=16,
    bond_conv_hidden_dim=16,
    graph_converter_algorithm="numpy",
    fused_kernels=False,
)
FULL = dict(graph_converter_algorithm="numpy", fused_kernels=False)
SMALL_FUSED = dict(SMALL, fused_kernels=True)
FULL_FUSED = dict(FULL, fused_kernels=True)
TOL = {"e": 2e-5, "f": 5e-5, "s": 2e-4, "m": 2e-5}
LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
LICOO = f"{ROOT}/examples/mp-1175469-Li9Co7O16.cif"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("kw", [SMALL, FULL], ids=["small", "full"])
def test_init_params_equal_chgnet_tpu_leaf_by_leaf(kw):
    jm = JCHGNet(seed=0, **kw)
    tp = t_init_params(TConfig(**kw), seed=0)
    jl, tl = dict(_leaves(jm.params)), dict(_leaves(tp))
    assert sorted(jl) == sorted(tl)
    for name in jl:
        np.testing.assert_array_equal(tl[name], jl[name], err_msg=name)


def test_params_from_jax_round_trips():
    jm = JCHGNet(seed=3, **SMALL)
    tree = jax.tree.map(np.asarray, jm.params)
    back = convert.params_to_numpy(convert.params_from_jax(tree))
    jl, tl = dict(_leaves(tree)), dict(_leaves(back))
    assert sorted(jl) == sorted(tl)
    for name in jl:
        np.testing.assert_array_equal(tl[name], jl[name], err_msg=name)
    assert convert.count_params(convert.params_from_jax(tree)) == jm.n_params


def _both(kw, graphs_j, graphs_t, seed=0):
    jm = JCHGNet(seed=seed, **kw)
    tm = TCHGNet(
        seed=seed, device="cpu",
        params=jax.tree.map(np.asarray, jm.params), **kw,
    )
    flags = dict(compute_force=True, compute_stress=True, compute_magmom=True)
    jout = j_compute_batch(
        jm.params, j_batch_graphs(graphs_j), config=jm.config, **flags
    )
    tout = t_compute_batch(
        tm.params, t_batch_graphs(graphs_t).to("cpu"), config=tm.config, **flags
    )
    return jout, tout


def _check(jout, tout, n_graphs, n_atoms):
    for key, sl in (("e", n_graphs), ("s", n_graphs), ("f", n_atoms),
                    ("m", n_atoms)):
        j = np.asarray(jout[key])[:sl]
        t = tout[key].numpy()[:sl]
        assert np.isfinite(t).all(), key
        np.testing.assert_allclose(t, j, atol=TOL[key], rtol=0, err_msg=key)


def _graphs(paths_and_perturb, kw):
    jm_conv = JCHGNet(seed=0, **kw).graph_converter
    tm_conv = TCHGNet(seed=0, device="cpu", **kw).graph_converter
    gj, gt = [], []
    for path, seed in paths_and_perturb:
        js, ts = JStructure.from_file(path), TStructure.from_file(path)
        if seed is not None:
            js, ts = js.perturb(0.05, seed=seed), ts.perturb(0.05, seed=seed)
        gj.append(jm_conv(js))
        gt.append(tm_conv(ts))
    return gj, gt


@pytest.mark.parametrize(
    "kw,structs",
    [
        (SMALL, [(LIMNO2, None)]),
        (SMALL, [(LIMNO2, 1), (LICOO, 2), (LIMNO2, 3)]),
        (FULL, [(LIMNO2, None)]),
        (SMALL_FUSED, [(LIMNO2, None)]),
        (SMALL_FUSED, [(LIMNO2, 1), (LICOO, 2), (LIMNO2, 3)]),
        (FULL_FUSED, [(LIMNO2, None)]),
    ],
    ids=["small-1", "small-3", "full-1", "fused-small-1", "fused-small-3",
         "fused-full-1"],
)
def test_efsm_matches_chgnet_tpu(kw, structs):
    gj, gt = _graphs(structs, kw)
    jout, tout = _both(kw, gj, gt)
    _check(jout, tout, len(gt), sum(g.n_atoms for g in gt))


@pytest.mark.parametrize(
    "variant",
    [
        dict(mlp_first=False),
        dict(update_bond=False),
        dict(update_angle=False),
        dict(non_linearity="tanh"),
        dict(gMLP_norm=None, readout_norm=None, mlp_out_bias=True),
    ],
    ids=["mlp-last", "no-bond-update", "no-angle-update", "tanh", "no-norms"],
)
def test_config_variants_match_chgnet_tpu(variant):
    kw = dict(SMALL, **variant)
    gj, gt = _graphs([(LIMNO2, 8)], kw)
    jout, tout = _both(kw, gj, gt)
    _check(jout, tout, 1, gt[0].n_atoms)


@pytest.mark.parametrize("kw", [SMALL, SMALL_FUSED], ids=["plain", "fused"])
def test_reproduces_seed0_golden_pin(kw):
    """The pin of tests/test_model.py::test_self_golden_regression (its
    chgnet_tpu model runs the default fused_kernels=True, which off the TPU
    computes the same XLA function as fused_kernels=False), at its
    tolerances, with either setting of the port's fused_kernels."""
    model = TCHGNet(seed=0, device="cpu", **kw)
    out = model.predict_structure(TStructure.from_file(LIMNO2), task="efsm")
    assert float(out["e"]) == pytest.approx(-7.386071681976318, abs=2e-5)
    np.testing.assert_allclose(
        out["f"][0], [-1.12e-08, 3.82e-08, 8.430728921666741e-04], atol=2e-5
    )
    np.testing.assert_allclose(out["s"][0, 0], -0.4712256193161011, atol=2e-4)
    np.testing.assert_allclose(
        out["m"][:4], [0.3231822, 0.3231822, 0.2883548, 0.2883548], atol=2e-5
    )


def test_fused_flag_computes_the_same_function_on_cpu():
    """The fused tails' plain versions take their products and sums in
    another order than the plain gated MLP: equal at the port's
    tolerances."""
    s = TStructure.from_file(LIMNO2).perturb(0.05, seed=4)
    a = TCHGNet(seed=0, device="cpu", **SMALL).predict_structure(s)
    b = TCHGNet(seed=0, device="cpu", **SMALL_FUSED).predict_structure(s)
    for key in "efsm":
        np.testing.assert_allclose(
            np.asarray(b[key]), np.asarray(a[key]), atol=TOL[key], rtol=0,
            err_msg=key,
        )


def test_physics_invariants_on_batch():
    """Forces sum to ~0 per graph, stress is symmetric, padded atoms get
    exactly zero force and magmom."""
    gj, gt = _graphs([(LIMNO2, 5), (LICOO, 6)], SMALL)
    tm = TCHGNet(seed=0, device="cpu", **SMALL)
    batch = t_batch_graphs(gt)
    out = t_compute_batch(
        tm.params, batch.to("cpu"), config=tm.config, compute_force=True,
        compute_stress=True, compute_magmom=True,
    )
    f, s = out["f"].numpy(), out["s"].numpy()
    off = 0
    for g in gt:
        np.testing.assert_allclose(f[off: off + g.n_atoms].sum(0), 0, atol=1e-4)
        off += g.n_atoms
    np.testing.assert_allclose(f[off:], 0, atol=0)
    np.testing.assert_allclose(out["m"].numpy()[off:], 0, atol=0)
    np.testing.assert_allclose(s, np.swapaxes(s, 1, 2), atol=1e-4)


def test_unsupported_config_raises(monkeypatch):
    """bf16 builds on the CPU and passes the CUDA checks under a switch too
    (every kernel has its bf16 form); ``dense_atom_conv`` builds and passes
    them too, and only ``conv_dropout`` with it is refused before anything
    is launched, as in ``chgnet_tpu``."""
    model = TCHGNet(seed=0, device="cpu", compute_dtype="bfloat16", **SMALL)
    model.config.check_supported("cuda")
    monkeypatch.setenv("CHGNET_TPU_STREAM_V2", "1")
    model.config.check_supported("cuda")
    dense = TCHGNet(seed=0, device="cpu", dense_atom_conv=True, **SMALL)
    dense.config.check_supported("cuda")
    with pytest.raises(NotImplementedError, match="dense_atom_conv"):
        TCHGNet(seed=0, device="cpu", dense_atom_conv=True, conv_dropout=0.1, **SMALL)


def test_undirected_bond_layout_is_supported():
    model = TCHGNet(seed=0, device="cpu", directed_bonds=False, **SMALL)
    assert not model.config.directed_bonds
    model.config.check_supported()
    out = model.predict_structure(TStructure.from_file(LIMNO2), task="efsm")
    assert np.isfinite(out["e"]) and np.isfinite(out["f"]).all()


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-fallback check needs its absence")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCHGNet(seed=0, **SMALL)
