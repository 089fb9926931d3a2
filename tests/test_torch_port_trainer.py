"""The PyTorch port's loss and Trainer against chgnet_tpu's.

* Each optimizer's updates, over 8 steps with the learning rate written at
  each scheduler step, equal optax's as chgnet_tpu chains them, on the same
  parameter tree and gradients (rtol 1e-5, atol 1e-8: f32 updates summed
  in another order).
* Each schedule's learning rates equal ``_make_schedule``'s exactly.
* A 2-epoch E+F+S+M run from the same init on the same NaN-labelled
  loaders (tests/test_trainer.py's fixture at its small width): every
  step's loss within 1e-4 relative of chgnet_tpu.Trainer's. The parameters
  after the run are held at 2 x lr x steps: Adam divides each gradient by
  its own running size, so where a gradient is rounding noise near zero the
  two packages may step by about lr in opposite directions, at most 2 lr a
  step. Beyond that bound, nearly every element must agree to 1e-5.
* Composition freezing, NaN abort, checkpoint rotation, resume, a
  cross-package load of a checkpoint's model half, finite parameter
  gradients with NaN labels, device selection without a card.
"""

from __future__ import annotations

import os
import pickle
import types

import jax
import numpy as np
import optax
import pytest
import torch

from chgnet_tpu.core.lattice import Lattice as JLattice
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.data import StructureData as JStructureData
from chgnet_tpu.data import get_train_val_test_loader as j_loaders
from chgnet_tpu.models.chgnet import CHGNet as JCHGNet
from chgnet_tpu.trainer import Trainer as JTrainer
from chgnet_tpu.trainer.trainer import _make_schedule as j_make_schedule
from chgnet_tpu_torch.core.lattice import Lattice
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.data import StructureData, get_train_val_test_loader
from chgnet_tpu_torch.models import CHGNet
from chgnet_tpu_torch.models.convert import params_to_numpy
from chgnet_tpu_torch.trainer import CombinedLoss, Trainer
from chgnet_tpu_torch.trainer import trainer as trainer_mod
from chgnet_tpu_torch.trainer.losses import loss_and_metrics
from chgnet_tpu_torch.utils.common import flatten_params

SMALL = dict(
    atom_fea_dim=16,
    bond_fea_dim=16,
    angle_fea_dim=16,
    num_radial=9,
    num_angular=9,
    n_conv=2,
    mlp_hidden_dims=(16,),
    atom_conv_hidden_dim=16,
    bond_conv_hidden_dim=16,
)
NaCl = Structure(Lattice.cubic(4), ["Na", "Cl"], [[0, 0, 0], [0.5, 0.5, 0.5]])
LR = 1e-3
OPTIMIZERS = {"SGD": 0.05, "Adam": 0.05, "AdamW": 1e-2, "RAdam": 0.05}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its passes are many small
    ops, which several test processes on one machine's cores slow down many
    times over when each op spreads over every core."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def labelled():
    """20 perturbed NaCl cells labelled E+F+S+M by a seed-7 teacher, with a
    NaN energy, a NaN force block and a NaN magmom block (the fixture of
    tests/test_trainer.py; stresses in the dataset's VASP convention)."""
    teacher = CHGNet(seed=7, device="cpu", **SMALL)
    out = {"t": [], "e": [], "f": [], "s": [], "m": []}
    for index in range(20):
        struct = NaCl.perturb(0.1, seed=index)
        pred = teacher.predict_structure(struct, task="efsm")
        out["t"].append(struct)
        out["e"].append(float(pred["e"]))
        out["f"].append(np.asarray(pred["f"], dtype=np.float32))
        out["s"].append(np.asarray(pred["s"], dtype=np.float32) * -10.0)
        out["m"].append(np.asarray(pred["m"], dtype=np.float32))
    out["e"][2] = np.nan
    out["f"][4] = np.full((2, 3), np.nan, dtype=np.float32)
    out["m"][6] = np.full(2, np.nan, dtype=np.float32)
    return out


def _loaders(lab, pkg="port"):
    kw = dict(energies=lab["e"], forces=lab["f"], stresses=lab["s"],
              magmoms=lab["m"], shuffle=False)
    if pkg == "port":
        data = StructureData(structures=lab["t"], **kw)
        return get_train_val_test_loader(data, batch_size=4, train_ratio=0.6,
                                         val_ratio=0.2)
    structs = [JStructure(JLattice(s.lattice.matrix), [int(z) for z in s.atomic_numbers],
                          s.frac_coords) for s in lab["t"]]
    return j_loaders(JStructureData(structures=structs, **kw), batch_size=4,
                     train_ratio=0.6, val_ratio=0.2)


@pytest.fixture(scope="module")
def loaders(labelled):
    return _loaders(labelled)


def _trainer(model, **kw):
    return Trainer(model=model, use_device="cpu", **kw)


# ------------------------------------------------------------- optimizers
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_optax(name):
    """8 steps of the port's optimizer (weight decay on, the learning rate
    rewritten every step, one leaf without gradient, the composition
    frozen) against the optax chain of chgnet_tpu's Trainer."""
    rng = np.random.default_rng(0)
    tree = {
        "w": rng.normal(size=(5, 3)).astype(np.float32),
        "b": rng.normal(size=3).astype(np.float32),
        "unused": rng.normal(size=2).astype(np.float32),
        "composition": {"weight": rng.normal(size=4).astype(np.float32)},
    }
    grads = [
        {k: (np.zeros_like(v) if k == "unused" else
             rng.normal(size=v.shape).astype(np.float32))
         for k, v in flatten_params(tree).items()}
        for _ in range(8)
    ]
    kw = dict(optimizer=name, learning_rate=LR, epochs=1, scheduler="CosLR",
              weight_decay=OPTIMIZERS[name])

    jt = JTrainer(model=None, **kw)
    opt = jt._optimizer
    j_params = jax.tree.map(np.asarray, tree)
    state = opt.init(j_params)

    model = types.SimpleNamespace(
        params={k: ({"weight": torch.tensor(v["weight"])} if isinstance(v, dict)
                    else torch.tensor(v)) for k, v in tree.items()},
        device=torch.device("cpu"),
    )
    pt = _trainer(model, **kw)
    pt._build_optimizer(False)
    leaves = dict(trainer_mod._leaves(model.params))
    assert not leaves["composition/weight"].requires_grad
    for step, g in enumerate(grads):
        j_grads = {"w": g["w"], "b": g["b"], "unused": g["unused"],
                   "composition": {"weight": g["composition/weight"]}}
        state.hyperparams["learning_rate"] = np.float32(jt._lr_at(step))
        updates, state = opt.update(j_grads, state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        pt.scheduler_step = step
        pt._set_lr()
        for path, leaf in leaves.items():
            if leaf.requires_grad:
                leaf.grad = torch.tensor(g[path])
        pt.optimizer.step()
        got = flatten_params(params_to_numpy(model.params))
        want = flatten_params(jax.tree.map(np.asarray, j_params))
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=1e-5, atol=1e-8,
                                       err_msg=f"{name} step {step} {path}")
    np.testing.assert_array_equal(
        model.params["composition"]["weight"].numpy(), tree["composition"]["weight"])


@pytest.mark.parametrize(
    "scheduler", ["MultiStepLR", "ExponentialLR", "CosLR", "CosRestartLR"])
def test_schedules_match_chgnet_tpu(scheduler):
    for epochs, params in ((3, {}), (7, {"decay_fraction": 0.1, "gamma": 0.5})):
        port = trainer_mod._make_schedule(scheduler, 2e-3, epochs, dict(params))
        ref = j_make_schedule(scheduler, 2e-3, epochs, dict(params))
        assert [port(s) for s in range(10 * epochs + 1)] == [
            ref(s) for s in range(10 * epochs + 1)]
    with pytest.raises(NotImplementedError):
        trainer_mod._make_schedule("bogus", 1e-3, 1, {})


# ------------------------------------------------------------ the run
class _PortRecorder(Trainer):
    def train_step(self, batch, targets):
        out = super().train_step(batch, targets)
        self.step_losses.append(float(out[0]))
        return out


class _JaxRecorder(JTrainer):
    def _steps(self, flag):
        train_step, eval_step = super()._steps(flag)

        def recorded(*args):
            result = train_step(*args)
            self.step_losses.append(float(result[2]["loss"]))
            return result

        return recorded, eval_step


def test_two_epochs_match_chgnet_tpu_trainer(labelled):
    """Per-step losses and the parameters after 2 epochs of E+F+S+M
    training (Adam, CosLR, MSE) from the same init on the same loaders
    (fresh ones: a loader's shuffle advances with every epoch it serves)."""
    port = _PortRecorder(model=CHGNet(seed=0, device="cpu", **SMALL), targets="efsm",
                         learning_rate=LR, epochs=2, use_device="cpu")
    ref = _JaxRecorder(model=JCHGNet(seed=0, **SMALL), targets="efsm",
                       learning_rate=LR, epochs=2)
    port.step_losses, ref.step_losses = [], []
    port.train(*_loaders(labelled)[:2], save_dir=None)
    ref.train(*_loaders(labelled, "jax")[:2], save_dir=None)
    assert len(port.step_losses) == len(ref.step_losses) == 6
    np.testing.assert_allclose(port.step_losses, ref.step_losses, rtol=1e-4)
    assert port.scheduler_step == ref.scheduler_step
    for key in "efsm":
        np.testing.assert_allclose(port.training_history[key]["val"],
                                   ref.training_history[key]["val"], rtol=1e-3,
                                   atol=1e-5)
    got = flatten_params(params_to_numpy(port.model.params))
    want = flatten_params(jax.tree.map(np.asarray, ref.model.params))
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diffs.max() <= 2 * LR * len(port.step_losses)
    assert (diffs > 1e-5).mean() <= 0.01


@pytest.mark.parametrize("criterion", ["MSE", "MAE", "Huber"])
def test_parameter_gradients_finite_with_nan_labels(criterion, loaders):
    """A batch holding the NaN energy, force and magmom labels: the loss and
    every parameter gradient are finite, and the loss equals chgnet_tpu's
    criterion on the labels that are there."""
    model = CHGNet(seed=0, device="cpu", **SMALL)
    trainer = _trainer(model, targets="efsm", criterion=criterion)
    trainer._build_optimizer(True)
    loss_fn = trainer.criterion
    nan_batches = 0
    for batch, targets in loaders[0]:
        has_nan = any(np.isnan(targets[k][targets["graph_mask"] > 0]).any()
                      for k in "es") or np.isnan(targets["f"]).any()
        b, t = trainer._on_device(batch, targets)
        loss, metrics = loss_and_metrics(model.params, b, t, config=model.config,
                                         loss_fn=loss_fn, create_graph=True)
        grads = torch.autograd.grad(loss, trainer._trainable, allow_unused=True)
        assert torch.isfinite(loss)
        for g in grads:
            assert g is None or bool(torch.isfinite(g).all())
        nan_batches += has_nan
    assert nan_batches >= 1
    assert isinstance(loss_fn, CombinedLoss)


def test_composition_freezing(loaders):
    model = CHGNet(seed=0, device="cpu", **SMALL)
    before = model.params["composition"]["weight"].clone()
    _trainer(model, targets="ef", epochs=1).train(*loaders[:2], save_dir=None)
    assert torch.equal(model.params["composition"]["weight"], before)
    _trainer(model, targets="ef", epochs=1).train(
        *loaders[:2], save_dir=None, train_composition_model=True)
    changed = ~torch.isclose(before, model.params["composition"]["weight"].detach())
    # only Na (Z=11 -> row 10) and Cl (Z=17 -> row 16) may move
    assert set(torch.nonzero(changed).flatten().tolist()) == {10, 16}


def test_nan_loss_aborts(loaders):
    trainer = _trainer(CHGNet(seed=0, device="cpu", **SMALL), targets="ef",
                       epochs=5, learning_rate=1e12, scheduler="ExponentialLR")
    trainer.train(*loaders[:2], save_dir=None)
    assert len(trainer.training_history["e"]["train"]) < 5


def test_checkpoints_resume_and_cross_package_load(loaders, tmp_path):
    """One rotating epoch file plus bestE_ / bestF_ copies; ``load``
    resumes with the model, optimizer state, scheduler step and history;
    the model half loads in chgnet_tpu's CHGNet and predicts the same; a
    chgnet_tpu checkpoint's model half loads in the port's."""
    save_dir = str(tmp_path / "run")
    trainer = _trainer(CHGNet(seed=1, device="cpu", **SMALL), targets="efsm",
                       epochs=2)
    trainer.train(*loaders, save_dir=save_dir)
    files = os.listdir(save_dir)
    for prefix in ("epoch", "bestE_", "bestF_"):
        assert sum(f.startswith(prefix) for f in files) == 1, prefix
    for key in "efsm":
        assert np.isfinite(trainer.training_history[key]["test"])
    ckpt = os.path.join(save_dir, next(f for f in files if f.startswith("epoch")))
    restored = Trainer.load(ckpt, use_device="cpu")
    assert restored.starting_epoch == 2
    assert restored.scheduler_step == trainer.scheduler_step
    assert restored.training_history["e"]["train"] == trainer.training_history["e"]["train"]
    with open(ckpt, "rb") as fh:
        state = pickle.load(fh)
    for (path, a), (_, b) in zip(trainer_mod._leaves(restored.model.params),
                                 trainer_mod._leaves(state["model"]["params"])):
        np.testing.assert_array_equal(a.detach().numpy(), b, err_msg=path)
    saved_opt = state["opt_state"]["state"]
    for idx, entry in restored.optimizer.state_dict()["state"].items():
        np.testing.assert_array_equal(entry["exp_avg"].numpy(),
                                      saved_opt[idx]["exp_avg"])
    assert restored.optimizer.param_groups[0]["lr"] == restored._lr_at(
        restored.scheduler_step)
    restored.epochs = 3
    restored.train(*loaders[:2], save_dir=save_dir)
    assert len(restored.training_history["e"]["train"]) == 3

    struct = NaCl.perturb(0.05, seed=99)
    jstruct = JStructure(JLattice(struct.lattice.matrix), [11, 17], struct.frac_coords)
    j_model = JCHGNet.from_dict(state["model"])
    p_model = CHGNet.from_dict(state["model"], device="cpu")
    e_port = p_model.predict_structure(struct, task="e")["e"]
    assert abs(j_model.predict_structure(jstruct, task="e")["e"] - e_port) < 2e-5

    j_trainer = JTrainer(model=JCHGNet(seed=2, **SMALL), targets="ef", epochs=1)
    j_path = str(tmp_path / "j.chkpt.pkl")
    j_trainer.save(j_path)
    with open(j_path, "rb") as fh:
        j_state = pickle.load(fh)
    from_j = CHGNet.from_dict(j_state["model"], device="cpu")
    assert abs(from_j.predict_structure(struct, task="e")["e"] - JCHGNet.from_dict(
        j_state["model"]).predict_structure(jstruct, task="e")["e"]) < 2e-5


def test_get_best_model_is_a_snapshot(loaders):
    trainer = _trainer(CHGNet(seed=0, device="cpu", **SMALL), targets="ef", epochs=2)
    with pytest.raises(RuntimeError, match="trained first"):
        trainer.get_best_model()
    trainer.train(*loaders[:2], save_dir=None)
    best = trainer.get_best_model()
    assert best is not trainer.model and best.device == torch.device("cpu")
    best_epoch = int(np.argmin(trainer.training_history["e"]["val"]))
    same = torch.equal(best.params["atom_embedding"]["weight"],
                       trainer.model.params["atom_embedding"]["weight"].detach())
    assert same == (best_epoch == 1)


def test_dropout_and_remat_training(labelled):
    """Training with dropout runs, its masks drawn from the step number, so
    two runs from one init on fresh loaders agree bit for bit; with remat
    the run is the same, bit for bit."""
    runs = []
    for remat in (False, "all", False):
        model = CHGNet(seed=0, device="cpu", conv_dropout=0.1, mlp_dropout=0.1,
                       remat=remat, **SMALL)
        trainer = _trainer(model, targets="efsm", epochs=1)
        trainer.train(*_loaders(labelled)[:2], save_dir=None)
        assert np.isfinite(trainer.training_history["e"]["train"][0])
        runs.append(params_to_numpy(model.params))
    for other in runs[1:]:
        for a, b in zip(trainer_mod._leaves(runs[0]), trainer_mod._leaves(other)):
            np.testing.assert_array_equal(a[1], b[1], err_msg=a[0])
    assert not np.array_equal(runs[0]["atom_embedding"]["weight"],
                              CHGNet(seed=0, device="cpu", **SMALL).params[
                                  "atom_embedding"]["weight"].numpy())


def test_device_selection_and_unported_mesh(monkeypatch):
    """Without a card, Trainer() raises unless the CPU is asked for; a
    model on another device is moved to the trainer's; ``mesh`` raises
    without a torch.distributed process group."""
    monkeypatch.delenv("CHGNET_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = CHGNet(seed=0, device="cpu", **SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model=model)
    assert Trainer(model=model, use_device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="chgnet_tpu_torch.parallel.initialize"):
        Trainer(model=model, use_device="cpu", mesh=2)
    with pytest.raises(NotImplementedError, match="optimizer"):
        Trainer(model=model, use_device="cpu", optimizer="Lion")


def test_wandb_mocked(loaders, monkeypatch):
    from unittest.mock import MagicMock

    mock_wandb = MagicMock()
    monkeypatch.setattr(trainer_mod, "wandb", mock_wandb)
    trainer = _trainer(CHGNet(seed=0, device="cpu", **SMALL), targets="ef",
                       epochs=1, wandb_path="test-project/test-run")
    _, kwargs = mock_wandb.init.call_args
    assert (kwargs["project"], kwargs["name"]) == ("test-project", "test-run")
    trainer.train(*loaders[:2], save_dir=None, wandb_log_freq="epoch")
    logged = [c.args[0] for c in mock_wandb.log.call_args_list]
    assert any("train_e_mae" in d and "val_e_mae" in d for d in logged)
    with pytest.raises(ValueError, match="project/run_name"):
        _trainer(trainer.model, epochs=1, wandb_path="too/many/slashes")
