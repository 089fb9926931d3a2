"""The port's graph-sharded and data-parallel training on gloo ranks of the CPU.

* ``make_graph_sharded_train_step`` on 2 ranks (one SGD step at lr 1, so
  the parameters' change is the gradient): "ef", "efsm" and "ef" over the
  halo exchange, on ``tests/test_graph_sharded.py``'s structures and
  teacher labels. The metrics equal ``chgnet_tpu``'s single-device
  ``loss_and_metrics`` (rel 1e-4, abs 1e-6) and the gradients of four
  leaves the port's single-device gradients (atol 1e-4, rtol 1e-3), as
  ``test_graph_sharded_training_step`` holds them.
* ``make_dp_train_step`` on 2 ranks, rank r on batch r: the parameters after
  one SGD step equal one step with the mean of the two single-device
  gradients (rtol 2e-5, atol 2e-6: ``tests/test_trainer.py``'s DP test).
* ``Trainer(mesh=2)`` against ``chgnet_tpu``'s ``Trainer(mesh=2)`` on this
  process's virtual devices: 2 epochs of E+F+S+M on
  ``tests/test_torch_port_trainer.py``'s loaders in batches of 2 (3 steps
  an epoch): the steps taken, every epoch's MAEs (rtol 1e-3, atol 1e-5) and
  the parameters within that file's bound (2 x lr a step).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import _torch_parallel_work as work
from _torch_spawn import spawn
from chgnet_tpu.core.lattice import Lattice as JLattice
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.data import StructureData as JStructureData
from chgnet_tpu.data import get_train_val_test_loader as j_loaders
from chgnet_tpu.graph.batching import batch_graphs as j_batch_graphs
from chgnet_tpu.graph.converter import CrystalGraphConverter as JConverter
from chgnet_tpu.models.chgnet import CHGNet as JCHGNet
from chgnet_tpu.trainer import Trainer as JTrainer
from chgnet_tpu.trainer.losses import CombinedLoss as JCombinedLoss
from chgnet_tpu.trainer.losses import loss_and_metrics as j_loss_and_metrics
from chgnet_tpu.utils.common import flatten_params as j_flatten
from chgnet_tpu_torch.core.lattice import Lattice
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.graph.batching import batch_graphs
from chgnet_tpu_torch.models.chgnet import CHGNet
from chgnet_tpu_torch.trainer.losses import CombinedLoss, loss_and_metrics

JAX_SMALL = {k: v for k, v in work.SMALL.items() if k != "graph_converter_algorithm"}
RUNS = {"ef": ("ef", 0), "efsm": ("efsm", 3), "ef halo": ("ef", 5)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return spawn(work.sharded_training, 2, tmp_path_factory.mktemp("train"))


def _single_device(targets: str, seed: int):
    """The port's single-device loss gradients of the four leaves and
    chgnet_tpu's single-device metrics, on the run's structure and labels."""
    model = work._model()
    struct = work.big_structure(seed)
    batch = batch_graphs([model.graph_converter(struct)])
    tgt = work._teacher_targets(struct, batch, targets)
    for leaf in work._leaves(model.params):
        leaf.requires_grad_(True)
    loss, _ = loss_and_metrics(
        model.params, batch.to("cpu"), {k: torch.as_tensor(v) for k, v in tgt.items()},
        config=model.config, loss_fn=CombinedLoss(target_str=targets, criterion="MSE"),
        create_graph=True,
    )
    leaves = list(work._grads_of(model).values())
    grads = [g if g is not None else torch.zeros_like(t) for g, t in zip(
        torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
    jmodel = JCHGNet(seed=0, **JAX_SMALL)
    jstruct = JStructure.from_file(work.LIMNO2).make_supercell(2).perturb(0.05, seed=seed)
    jbatch = j_batch_graphs([JConverter(algorithm="numpy")(jstruct)])
    _, metrics = j_loss_and_metrics(
        jmodel.params, jbatch, tgt, config=jmodel.config,
        loss_fn=JCombinedLoss(target_str=targets, criterion="MSE"),
    )
    return dict(zip(work._grads_of(model), (g.detach().numpy() for g in grads))), metrics


@pytest.mark.parametrize("run", list(RUNS))
def test_sharded_train_step_matches_single_device(sharded, run):
    targets, seed = RUNS[run]
    grads, metrics = _single_device(targets, seed)
    got = sharded[0][run]
    for key in ["loss", "e_MAE", "f_MAE"] + [f"{t}_MAE" for t in "sm" if t in targets]:
        assert got["metrics"][key] == pytest.approx(float(metrics[key]), rel=1e-4, abs=1e-6), key
    for name, want in grads.items():
        np.testing.assert_allclose(got["grads"][name], want, atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    # the step is replicated: both ranks moved their parameters alike
    for name in grads:
        np.testing.assert_array_equal(sharded[1][run]["grads"][name], got["grads"][name])


def test_dp_step_matches_mean_of_per_batch_gradients(tmp_path):
    ranks = spawn(work.dp_step, 2, tmp_path)
    model = work._model()
    leaves = work._leaves(model.params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    per_batch = []
    for batch, tgt in work.dp_batches():
        loss, _ = loss_and_metrics(
            model.params, batch.to("cpu"), {k: torch.as_tensor(v) for k, v in tgt.items()},
            config=model.config, loss_fn=CombinedLoss(target_str="ef", criterion="MSE"),
            create_graph=True,
        )
        per_batch.append(torch.autograd.grad(loss, leaves, allow_unused=True))
    for k, leaf in enumerate(leaves):
        grads = [g[k] if g[k] is not None else torch.zeros_like(leaf) for g in per_batch]
        want = (leaf - 1e-2 * (grads[0] + grads[1]) / 2.0).detach().numpy()
        for rank in ranks:
            np.testing.assert_allclose(rank["leaves"][k], want, rtol=2e-5, atol=2e-6)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]


@pytest.fixture(scope="module")
def labelled():
    """tests/test_torch_port_trainer.py's 20 NaCl cells with teacher labels
    (a NaN energy, force block and magmom block)."""
    nacl = Structure(Lattice.cubic(4), ["Na", "Cl"], [[0, 0, 0], [0.5, 0.5, 0.5]])
    teacher = CHGNet(seed=7, device="cpu", **work.SMALL_TRAIN)
    out = {"t": [], "e": [], "f": [], "s": [], "m": []}
    for index in range(20):
        struct = nacl.perturb(0.1, seed=index)
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


def test_trainer_mesh_matches_chgnet_tpu_trainer(labelled, tmp_path):
    batch_size = 2
    ranks = spawn(work.trainer_run, 2, tmp_path, labelled, batch_size)
    structs = [JStructure(JLattice(s.lattice.matrix), [int(z) for z in s.atomic_numbers],
                          s.frac_coords) for s in labelled["t"]]
    data = JStructureData(structures=structs, energies=labelled["e"],
                          forces=labelled["f"], stresses=labelled["s"],
                          magmoms=labelled["m"], shuffle=False)
    train, val, _ = j_loaders(data, batch_size=batch_size, train_ratio=0.6, val_ratio=0.2)
    ref = JTrainer(model=JCHGNet(seed=0, **work.SMALL_TRAIN), targets="efsm",
                   learning_rate=work.TRAIN_LR, epochs=2, mesh=2)
    ref.train(train, val, save_dir=None)
    got = ranks[0]
    steps = 2 * (len(train) // 2)
    assert got["steps"] == steps == 6
    for key in "efsm":
        for split in ("train", "val"):
            np.testing.assert_allclose(got["history"][key][split],
                                       ref.training_history[key][split], rtol=1e-3,
                                       atol=1e-5, err_msg=f"{key} {split}")
    want = j_flatten(jax.tree.map(np.asarray, ref.model.params))
    diffs = np.concatenate([np.abs(got["params"][k] - want[k]).ravel() for k in want])
    assert diffs.max() <= 2 * work.TRAIN_LR * steps
    assert (diffs > 1e-5).mean() <= 0.01
    for k, v in got["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v, err_msg=k)
