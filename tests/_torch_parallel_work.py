"""What each gloo rank runs in the port's mesh tests (``tests/_torch_spawn.py``).

Every function takes the rank's CPU mesh first and returns numpy arrays or
floats, which the test process holds against ``chgnet_tpu`` and the single
device. The module imports torch and the port only: no jax, no chgnet_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from chgnet_tpu_torch import ROOT
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.graph.batching import batch_graphs
from chgnet_tpu_torch.graph.converter import CrystalGraphConverter
from chgnet_tpu_torch.models.chgnet import CHGNet, compute_batch
from chgnet_tpu_torch.parallel import collectives as coll
from chgnet_tpu_torch.parallel.graph_sharded import (
    compute_batch_sharded,
    make_graph_sharded_train_step,
    shard_batch,
    shard_batch_halo,
    shard_targets,
    unshard_atoms,
)
from chgnet_tpu_torch.simulation import MolecularDynamics, StructOptimizer
from chgnet_tpu_torch.simulation.runtime import compute_batch_dynamic

LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
# tests/test_graph_sharded.py's model (graphs by the numpy builder, as the
# JAX side builds them in the tests)
SMALL = dict(
    atom_fea_dim=16, bond_fea_dim=16, angle_fea_dim=16, num_radial=9,
    num_angular=9, n_conv=3, mlp_hidden_dims=(16,), atom_conv_hidden_dim=16,
    bond_conv_hidden_dim=16, graph_converter_algorithm="numpy",
)
# tests/test_md_sharded.py's
SMALL_MD = SMALL | dict(n_conv=2)
KEYS = "efsm"
SKIN = 0.4


def _model(device="cpu", **kw) -> CHGNet:
    return CHGNet(seed=0, device=device, **(SMALL | kw))


def big_structure(seed: int = 0) -> Structure:
    """tests/test_graph_sharded.py's 64-atom structure."""
    return Structure.from_file(LIMNO2).make_supercell(2).perturb(0.05, seed=seed)


def _host(out: dict, n: int) -> dict:
    """Per-graph outputs whole, per-atom ones unsharded to their n rows."""
    return {
        k: (unshard_atoms(v)[:n] if k in "fm" else v.cpu().numpy())
        for k, v in out.items() if k in KEYS
    }


def _sharded(model, batch, mesh, halo: bool, n: int, **kw) -> dict:
    if halo:
        sb, hb = shard_batch_halo(batch, mesh.size)
    else:
        sb, hb = shard_batch(batch, mesh.size), None
    out = compute_batch_sharded(
        model.params, sb, hb, config=model.config, mesh=mesh,
        compute_force=True, compute_stress=True, compute_magmom=True, **kw,
    )
    return _host(out, n)


def skin_batch(model, struct, seed: int):
    """tests/test_md_sharded.py's skin-built batch whose positions moved
    inside the skin (its _perturbed_skin_batch)."""
    cfg = model.config
    conv = CrystalGraphConverter(
        atom_graph_cutoff=cfg.atom_graph_cutoff + SKIN,
        bond_graph_cutoff=cfg.bond_graph_cutoff + SKIN, algorithm="numpy",
    )
    batch = batch_graphs([conv(struct, graph_id="0")])
    rng = np.random.default_rng(seed)
    frac = batch.frac_coords + (
        rng.normal(0, 0.004, batch.frac_coords.shape).astype(np.float32)
        * batch.atom_mask[:, None]
    )
    return batch._replace(frac_coords=frac.astype(np.float32))


def forward_runs(mesh) -> dict:
    """E+F+S+M of the sharded forward in every form the tests hold: the
    64-atom structure with all-gathers and with the halo exchange, three
    graphs in one batch, ``remat="angle"``, a batch sharded without plans,
    and the skin batch under ``dynamic_cutoff`` (both exchanges), on the
    mesh's device."""
    dev = mesh.device
    model = _model(dev)
    struct = big_structure()
    batch = batch_graphs([model.graph_converter(struct)])
    n = len(struct)
    runs = {
        "all-gather": _sharded(model, batch, mesh, False, n),
        "halo": _sharded(model, batch, mesh, True, n),
        "remat": _sharded(_model(dev, remat="angle"), batch, mesh, False, n),
    }
    plain = shard_batch(batch, mesh.size, plans=False)
    runs["no plans"] = _host(compute_batch_sharded(
        model.params, plain, config=model.config, mesh=mesh, compute_force=True,
        compute_stress=True, compute_magmom=True), n)
    small = Structure.from_file(LIMNO2)
    graphs = [model.graph_converter(small.perturb(0.04, seed=s)) for s in range(3)]
    multi = batch_graphs(graphs)
    runs["3 graphs"] = _sharded(model, multi, mesh, False, 3 * len(small))
    md = _model(dev, n_conv=2)
    skin = skin_batch(md, Structure.from_file(LIMNO2).make_supercell(2), seed=3)
    m = int(skin.atom_mask.sum())
    for halo in (False, True):
        runs[f"dynamic {'halo' if halo else 'all-gather'}"] = _sharded(
            md, skin, mesh, halo, m, dynamic_cutoff=True)
    return runs


def single_device_runs() -> dict:
    """The same inputs through the port's own single-device forward."""
    model = _model()
    struct = big_structure()
    n = len(struct)

    def full(m, batch, n_atoms):
        out = compute_batch(m.params, batch.to("cpu"), config=m.config,
                            compute_force=True, compute_stress=True,
                            compute_magmom=True)
        return {k: (out[k][:n_atoms] if k in "fm" else out[k]).numpy() for k in KEYS}

    batch = batch_graphs([model.graph_converter(struct)])
    small = Structure.from_file(LIMNO2)
    graphs = [model.graph_converter(small.perturb(0.04, seed=s)) for s in range(3)]
    md = _model(n_conv=2)
    skin = skin_batch(md, Structure.from_file(LIMNO2).make_supercell(2), seed=3)
    dyn = compute_batch_dynamic(md.params, skin.to("cpu"), config=md.config)
    m = int(skin.atom_mask.sum())
    return {
        "one": full(model, batch, n),
        "3 graphs": full(model, batch_graphs(graphs), 3 * len(small)),
        "dynamic": {k: (dyn[k][:m] if k in "fm" else dyn[k]).numpy() for k in KEYS},
    }


# ------------------------------------------------------------- collectives
def collective_grads(mesh) -> dict:
    """Each collective in a small composite, differentiated to second
    order, against the same composite on the gathered inputs in one
    process (every rank then holds every rank's rows). Returns the largest
    differences of values, gradients and gradients of a gradient."""
    torch.manual_seed(0)
    d, r, dev = mesh.size, mesh.rank, mesh.device
    full = torch.randn(d * 6, 5, dtype=torch.float64).to(dev)
    w = torch.randn(5, 5, dtype=torch.float64).to(dev)
    send = torch.randint(0, 6, (d, 3), generator=torch.Generator().manual_seed(1)).to(dev)

    def spmd(x):
        """One scalar from the rank's rows x [6, 5], summed over ranks."""
        table = coll.all_gather(torch.tanh(x @ w), mesh)  # [D * 6, 5]
        own = coll.reduce_scatter(table * table.sum(1, keepdim=True), mesh)
        halo = coll.all_to_all(torch.sin(x)[send.reshape(-1)], mesh)
        local = (own * x).sum() + (halo**3).sum() + table[(r * 7) % (d * 6)].sum()
        return coll.sum_ranks(local, mesh)

    def whole(xs):
        """The same scalar from every rank's rows, in one process."""
        total = 0.0
        rows = torch.tanh(xs @ w)
        blocks = xs.reshape(d, 6, 5)
        weighted = rows * rows.sum(1, keepdim=True)
        for rank in range(d):
            own = d * weighted.reshape(d, 6, 5)[rank]
            halo = torch.cat([torch.sin(blocks[p])[send[rank]] for p in range(d)])
            total = total + (own * blocks[rank]).sum() + (halo**3).sum()
            total = total + rows[(rank * 7) % (d * 6)].sum()
        return total

    x = full[r * 6: (r + 1) * 6].clone().requires_grad_(True)
    val = spmd(x)
    (g,) = torch.autograd.grad(val, x, create_graph=True)
    (gg,) = torch.autograd.grad((g**2).sum(), x)
    xs = full.clone().requires_grad_(True)
    ref = whole(xs)
    (g_ref,) = torch.autograd.grad(ref, xs, create_graph=True)
    # the second-order scalar summed over ranks is sum_r |g_r|^2 = |g_full|^2
    (gg_ref,) = torch.autograd.grad((g_ref**2).sum(), xs)
    rows = slice(r * 6, (r + 1) * 6)
    return {
        "value": abs(float(val) - float(ref)),
        "grad": float((g - g_ref[rows]).abs().max()),
        "grad of grad": float((gg - gg_ref[rows]).abs().max()),
        "same on every rank": float(val),
    }


# --------------------------------------------------------------- training
def _teacher_targets(struct, batch, targets="ef"):
    teacher = CHGNet(seed=7, device="cpu", **SMALL)
    pred = teacher.predict_structure(struct, task="efsm")
    n, n_pad = len(struct), batch.atomic_numbers.shape[0]

    def nanpad(a, width):
        return np.concatenate([np.asarray(a, np.float32),
                               np.full((n_pad - n, *width), np.nan, np.float32)])

    out = {"e": np.array([pred["e"]], np.float32),
           "graph_mask": np.ones(1, np.float32),
           "f": nanpad(pred["f"], (3,))}
    if "s" in targets:
        out["s"] = np.asarray(pred["s"], np.float32)[None]
    if "m" in targets:
        out["m"] = nanpad(pred["m"], ())
    return out


def _grads_of(model) -> dict:
    return {
        "atom_embedding": model.params["atom_embedding"]["weight"],
        "bond_embedding": model.params["bond_embedding"]["w"],
        "site_wise": model.params["site_wise"]["w"],
        "mlp0": model.params["mlp"]["layers"][0]["w"],
    }


def sharded_training(mesh) -> dict:
    """One SGD(lr 1) step of ``make_graph_sharded_train_step`` ("ef", then
    "efsm", then "ef" over the halo exchange) on tests/test_graph_sharded.py's
    structure and teacher labels: the metrics and, from the parameters'
    change, the gradients of four leaves."""
    out = {}
    for name, targets, halo, seed in (
        ("ef", "ef", False, 0), ("efsm", "efsm", False, 3), ("ef halo", "ef", True, 5)
    ):
        model = _model()
        struct = big_structure(seed)
        batch = batch_graphs([model.graph_converter(struct)])
        tgt = _teacher_targets(struct, batch, targets)
        if halo:
            sb, hb = shard_batch_halo(batch, mesh.size)
            feed = (sb, hb)
        else:
            sb = feed = shard_batch(batch, mesh.size)
        leaves = _leaves(model.params)
        for t in leaves:
            t.requires_grad_(True)
        before = {k: v.detach().clone() for k, v in _grads_of(model).items()}
        opt = torch.optim.SGD(leaves, lr=1.0)
        step = make_graph_sharded_train_step(
            config=model.config, optimizer=opt, mesh=mesh, targets=targets, halo=halo,
        )
        metrics = step(model.params, feed, shard_targets(tgt, sb))
        out[name] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: (before[k] - v.detach()).numpy()
                      for k, v in _grads_of(model).items()},
        }
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def dp_batches():
    """Two single-graph batches of one capacity and their random labels
    (tests/test_trainer.py's DP test, on LiMnO2)."""
    model = _model()
    rng = np.random.default_rng(0)
    struct = Structure.from_file(LIMNO2)
    out = []
    for dev in range(2):
        graph = model.graph_converter(struct.perturb(0.08, seed=dev), graph_id=str(dev))
        batch = batch_graphs([graph], capacities=(32, 2048, 4096))
        n_pad = batch.atomic_numbers.shape[0]
        out.append((batch, {
            "e": rng.normal(-3.0, 0.1, size=1).astype(np.float32),
            "f": rng.normal(0, 0.1, size=(n_pad, 3)).astype(np.float32),
            "graph_mask": np.ones(1, np.float32),
        }))
    return out


def dp_step(mesh) -> dict:
    """One SGD step of ``make_dp_train_step``, rank r on batch r: every
    leaf after the step, and the averaged metrics."""
    from chgnet_tpu_torch.parallel.dp import make_dp_train_step
    from chgnet_tpu_torch.trainer.losses import CombinedLoss

    model = _model()
    leaves = _leaves(model.params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.SGD(leaves, lr=1e-2)
    step = make_dp_train_step(
        config=model.config, loss_fn=CombinedLoss(target_str="ef", criterion="MSE"),
        optimizer=opt, mesh=mesh,
    )
    batch, tgt = dp_batches()[mesh.rank]
    metrics = step(model.params, batch.to("cpu"),
                   {k: torch.as_tensor(v) for k, v in tgt.items()}, 0)
    return {"leaves": [t.detach().numpy().copy() for t in leaves],
            "metrics": {k: float(v) for k, v in metrics.items()}}


# ------------------------------------------------------------- simulation
def _md_kw(**kw):
    return dict(ensemble="nvt", thermostat="Berendsen", temperature=300.0,
                starting_temperature=300.0, timestep=1.0, seed=0, skin=0.3,
                chunk_size=6) | kw


def simulation_runs(mesh) -> dict:
    """Mesh MD (all-gathers, halo, and a small skin that forces rebuilds)
    and mesh FIRE with the cell free, on tests/test_md_sharded.py's 2x2x2
    LiMnO2 and model; the final states in the padded order."""
    model = _model(n_conv=2)
    struct = Structure.from_file(LIMNO2).make_supercell(2)
    out = {}
    for name, kw, steps in (
        ("md", {}, 12),
        ("md halo", dict(halo=True), 12),
        ("md rebuilds", dict(skin=0.08, chunk_size=4), 16),
    ):
        md = MolecularDynamics(struct, model=model, mesh=mesh.size, **_md_kw(**kw))
        md.run(steps)
        n_pad = md.runtime.batch.atomic_numbers.shape[0]
        out[name] = {
            "frac": md.state.frac[:n_pad].numpy(), "vel": md.state.vel[:n_pad].numpy(),
            "epot": md.state.epot.numpy(), "temperature": md.get_temperature(),
            "rebuilds": md.runtime.n_rebuilds,
        }
    start = struct.perturb(0.06, seed=2)
    for name, halo in (("fire", False), ("fire halo", True)):
        res = StructOptimizer(model=model, mesh=mesh.size, halo=halo).relax(
            start, fmax=0.08, steps=60, relax_cell=True, assign_magmoms=False)
        out[name] = {
            "frac": res["final_structure"].frac_coords,
            "lat": res["final_structure"].lattice.matrix,
            "energy": res["final_energy"], "steps": len(res["trajectory"]),
        }
    try:
        StructOptimizer(model=model, optimizer_class="LBFGS", mesh=mesh.size)
        out["lbfgs"] = "no error"
    except NotImplementedError as err:
        out["lbfgs"] = str(err)
    return out


def single_device_simulation() -> dict:
    """The same runs on one device."""
    model = _model(n_conv=2)
    struct = Structure.from_file(LIMNO2).make_supercell(2)
    out = {}
    for name, kw, steps in (
        ("md", {}, 12), ("md rebuilds", dict(skin=0.08, chunk_size=4), 16),
    ):
        md = MolecularDynamics(struct, model=model, **_md_kw(**kw))
        md.run(steps)
        out[name] = {"frac": md.state.frac.numpy(), "vel": md.state.vel.numpy(),
                     "epot": md.state.epot.numpy(), "temperature": md.get_temperature()}
    res = StructOptimizer(model=model).relax(
        struct.perturb(0.06, seed=2), fmax=0.08, steps=60, relax_cell=True,
        assign_magmoms=False)
    out["fire"] = {"frac": res["final_structure"].frac_coords,
                   "lat": res["final_structure"].lattice.matrix,
                   "energy": res["final_energy"], "steps": len(res["trajectory"])}
    return out


# tests/test_torch_port_trainer.py's model and learning rate
SMALL_TRAIN = {k: v for k, v in SMALL.items() if k != "graph_converter_algorithm"} | dict(
    n_conv=2)
TRAIN_LR = 1e-3


def trainer_loaders(lab: dict, batch_size: int):
    from chgnet_tpu_torch.data import StructureData, get_train_val_test_loader

    data = StructureData(structures=lab["t"], energies=lab["e"], forces=lab["f"],
                         stresses=lab["s"], magmoms=lab["m"], shuffle=False)
    return get_train_val_test_loader(data, batch_size=batch_size, train_ratio=0.6,
                                     val_ratio=0.2)


def trainer_run(mesh, lab: dict, batch_size: int) -> dict:
    """``Trainer(mesh=D)``: 2 epochs of E+F+S+M (Adam, CosLR, MSE) from the
    seed-0 model on ``lab``'s loaders; the history, the steps taken and
    every parameter after the run."""
    from chgnet_tpu_torch.models.convert import params_to_numpy
    from chgnet_tpu_torch.trainer import Trainer
    from chgnet_tpu_torch.utils.common import flatten_params

    trainer = Trainer(model=CHGNet(seed=0, device="cpu", **SMALL_TRAIN),
                      targets="efsm", learning_rate=TRAIN_LR, epochs=2,
                      use_device="cpu", mesh=mesh.size)
    trainer.train(*trainer_loaders(lab, batch_size)[:2], save_dir=None)
    return {"history": trainer.training_history, "steps": trainer._global_step,
            "params": flatten_params(params_to_numpy(trainer.model.params))}
