"""The port's CHGNet persistence API, checkpoint conversion and calculator
against chgnet_tpu's, on the CPU.

* ``save`` -> ``from_file`` gives the same parameters, bit for bit, and the
  same predictions;
* a ``.npz`` written by chgnet_tpu's ``CHGNet.save`` gives the port the
  same E/F/S/M as chgnet_tpu (e <= 2e-5 eV/atom, f <= 5e-5 eV/A, s <= 2e-4
  GPa, m <= 2e-5 mu_B), and ``CHGNetCalculator`` the same results;
* ``convert_state_dict`` gives chgnet_tpu's arrays on a random upstream
  state dict, and a ``.pth.tar`` of it loads through ``from_file``;
* ``load()`` finds nothing in empty roots and raises ``FileNotFoundError``;
* every optimizer name runs, what is not ported raises
  ``NotImplementedError``, and a calculator never moves its model to
  another device.

chgnet_tpu's model is compiled once here (its ``efsm`` forward).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chgnet_tpu import ROOT
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.models.checkpoint import convert_state_dict as j_convert
from chgnet_tpu.models.chgnet import CHGNet as JCHGNet
from chgnet_tpu.simulation.calculator import CHGNetCalculator as JCalculator
from chgnet_tpu_torch.core.structure import Structure as TStructure
from chgnet_tpu_torch.models.checkpoint import convert_state_dict as t_convert
from chgnet_tpu_torch.models.chgnet import CHGNet as TCHGNet
from chgnet_tpu_torch.models.convert import params_to_numpy
from chgnet_tpu_torch.simulation import (
    CHGNetCalculator,
    MolecularDynamics,
    StructOptimizer,
)
from chgnet_tpu_torch.simulation.runtime import GraphRuntime
from chgnet_tpu_torch.utils.common import flatten_params
from test_checkpoint import ARGS, _synthetic_state_dict
from test_golden_traces import SMALL

TOL = {"e": 2e-5, "f": 5e-5, "s": 2e-4, "m": 2e-5}
LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
SAVED = dict(SMALL, graph_converter_algorithm="numpy")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its loops are thousands
    of small ops, which several test processes on one machine's cores slow
    down many times over when each op spreads over every core."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jmodel():
    # not seed 0's weights, so that a loader that fell back to a fresh
    # init would be caught
    return JCHGNet(seed=5, **SAVED)


@pytest.fixture(scope="module")
def jnpz(jmodel, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    jmodel.save(path)
    return path


@pytest.fixture(scope="module")
def tstruct():
    return TStructure.from_file(LIMNO2).perturb(0.05, seed=1)


@pytest.fixture(scope="module")
def jstruct():
    return JStructure.from_file(LIMNO2).perturb(0.05, seed=1)


@pytest.fixture(scope="module")
def jpred(jmodel, jstruct):
    return jmodel.predict_structure(jstruct, task="efsm")


def _assert_same_tree(got, want):
    fg, fw = flatten_params(got), flatten_params(want)
    assert sorted(fg) == sorted(fw)
    for key in fw:
        np.testing.assert_array_equal(fg[key], fw[key], err_msg=key)


def test_save_then_from_file_is_bit_exact(tmp_path, tstruct):
    model = TCHGNet(seed=3, device="cpu", **SAVED)
    path = str(tmp_path / "port.npz")
    model.save(path)
    again = TCHGNet.from_file(path, device="cpu")
    assert again.config == model.config
    _assert_same_tree(params_to_numpy(again.params), params_to_numpy(model.params))
    a, b = model.predict_structure(tstruct), again.predict_structure(tstruct)
    for key in "efsm":
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))
    dct = model.as_dict()
    clone = TCHGNet.from_dict(dct, device="cpu")
    _assert_same_tree(params_to_numpy(clone.params), dct["params"])
    assert model.todict() == {"model_name": "CHGNet", "model_args": model.config.as_dict()}


def test_npz_saved_by_chgnet_tpu_predicts_the_same(jmodel, jnpz, jpred, tstruct):
    port = TCHGNet.from_file(jnpz, device="cpu")
    assert port.version == jmodel.version and port.is_intensive == jmodel.is_intensive
    _assert_same_tree(params_to_numpy(port.params), jmodel.params)
    got = port.predict_structure(tstruct, task="efsm")
    for key, tol in TOL.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(jpred[key]),
                                   rtol=0, atol=tol, err_msg=key)


def test_calculator_matches_chgnet_tpu(jmodel, jnpz, jstruct, tstruct):
    port = TCHGNet.from_file(jnpz, device="cpu")
    tcalc = CHGNetCalculator(port)
    jcalc = JCalculator(jmodel)
    tcalc.calculate(tstruct)
    jcalc.calculate(jstruct)
    n = len(tstruct)
    tols = {"energy": TOL["e"] * n, "free_energy": TOL["e"] * n,
            "forces": TOL["f"], "stress": TOL["s"] * tcalc.stress_weight,
            "magmoms": TOL["m"], "crystal_fea": 1e-4}
    assert sorted(tcalc.results) == sorted(jcalc.results)
    for key, tol in tols.items():
        np.testing.assert_allclose(np.asarray(tcalc.results[key]),
                                   np.asarray(jcalc.results[key]), rtol=0,
                                   atol=tol, err_msg=key)
    np.testing.assert_allclose(tcalc.get_stress(tstruct), jcalc.get_stress(jstruct),
                               rtol=0, atol=TOL["s"] * tcalc.stress_weight)


def test_convert_state_dict_equals_chgnet_tpu(tmp_path):
    sd = _synthetic_state_dict(np.random.default_rng(0))
    want = j_convert(sd, ARGS)
    _assert_same_tree(t_convert(sd, ARGS), want)
    # the same state dict as an upstream .pth.tar, loaded by from_file
    path = str(tmp_path / "upstream.pth.tar")
    torch.save({"model": {
        "model_args": dict(ARGS),
        "state_dict": {k: torch.as_tensor(v) for k, v in sd.items()},
    }}, path)
    model = TCHGNet.from_file(path, device="cpu")
    _assert_same_tree(params_to_numpy(model.params), want)


def test_load_finds_nothing_and_fetches_nothing(tmp_path, monkeypatch):
    home, weights = tmp_path / "home", tmp_path / "weights"
    home.mkdir()
    weights.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("CHGNET_TPU_WEIGHTS", str(weights))
    with pytest.raises(FileNotFoundError, match="No pretrained weights"):
        TCHGNet.load(device="cpu")
    with pytest.raises(ValueError, match="Unknown"):
        TCHGNet.load(model_name="9.9.9", device="cpu")
    # a calculator without a model loads the pretrained one
    with pytest.raises(FileNotFoundError):
        CHGNetCalculator(use_device="cpu")


@pytest.mark.parametrize(
    "name",
    ["LBFGS", "LBFGSLineSearch", "BFGS", "BFGSLineSearch", "SciPyFminCG",
     "SciPyFminBFGS"],
)
def test_every_optimizer_runs(name, tstruct):
    """Each optimizer name of chgnet_tpu's relaxer runs 3 steps on the CPU
    (the SciPy ones: at most 3 iterations); an unknown name raises."""
    model = TCHGNet(seed=0, device="cpu", **SAVED)
    result = StructOptimizer(model, optimizer_class=name).relax(
        tstruct, steps=3, fmax=1e-6, relax_cell=True, assign_magmoms=False
    )
    energies = result["trajectory"].energies
    assert len(energies) >= 3 and np.isfinite(energies).all()
    assert np.isfinite(result["final_energy"])
    with pytest.raises(NotImplementedError, match="implements"):
        StructOptimizer(model, optimizer_class="Newton")


@pytest.mark.parametrize("what", ["md mesh", "relax mesh", "halo"])
def test_unported_layouts_raise(what, tstruct):
    """The multi-device layouts need a torch.distributed process group:
    without one they raise and name chgnet_tpu_torch.parallel.initialize;
    ``halo`` without a mesh is ignored, as in chgnet_tpu."""
    model = TCHGNet(seed=0, device="cpu", **SAVED)
    with pytest.raises(RuntimeError, match="chgnet_tpu_torch.parallel.initialize"):
        if what == "md mesh":
            MolecularDynamics(tstruct, model=model, mesh=2)
        elif what == "relax mesh":
            StructOptimizer(model, mesh=2)
        else:
            MolecularDynamics(tstruct, model=model, mesh=2, halo=True)
    if what == "halo":
        runtime = GraphRuntime(model.config, [tstruct], device="cpu", halo=True)
        assert runtime.hbatch is None


def test_entry_points_never_move_the_model():
    model = TCHGNet(seed=0, device="cpu", **SAVED)
    assert CHGNetCalculator(model, use_device="cpu").model is model
    for make in (
        lambda: CHGNetCalculator(model, use_device="cuda"),
        lambda: StructOptimizer(model, use_device="cuda"),
    ):
        with pytest.raises(ValueError, match="the model is on cpu"):
            make()
