"""The port's sums without float atomics, on the CPU, against chgnet_tpu.

* The dense slots' plans (``batch_graphs(dense_k=...)``:
  ``plan_dense_center`` and ``plan_dense_nbr`` over atoms,
  ``plan_dense_bond`` over undirected bonds): their keys are the flattened
  slots (each slot's own atom, its neighbour, its bond) with the padded
  ones dropped, their offsets and stable permutations those of the keys,
  for ``dense_k=True`` and a pinned K, and ``GraphBatch.to`` carries them.
* ``atom_conv_dense_apply``, whose gathers go through those plans (their
  backward a planned segment sum), against
  ``chgnet_tpu.models.layers.atom_conv_dense_apply``: the output and its
  gradients with respect to the atom, bond and weight tables within
  tests/test_torch_port_dense.py's tolerances of energy (2e-5) and force
  (5e-5), relative to each output's largest value.
* ``kinetic_energy``, now a sum over the batch's graph plan, and
  ``MolecularDynamics.get_temperature`` against
  ``chgnet_tpu.simulation.md.kinetic_energy`` within f32 rounding (1e-6).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chgnet_tpu import ROOT
from chgnet_tpu.models import layers as j_layers
from chgnet_tpu.simulation import md as j_md
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.graph.batching import batch_graphs, make_plan
from chgnet_tpu_torch.graph.converter import CrystalGraphConverter
from chgnet_tpu_torch.models import layers as t_layers
from chgnet_tpu_torch.models.chgnet import CHGNet
from chgnet_tpu_torch.models.convert import params_from_jax
from chgnet_tpu_torch.simulation import MolecularDynamics
from chgnet_tpu_torch.simulation import md as t_md
from chgnet_tpu_torch.simulation import units

LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
LICOO = f"{ROOT}/examples/mp-1175469-Li9Co7O16.cif"
E_TOL, F_TOL = 2e-5, 5e-5  # tests/test_torch_port_dense.py's e and f
KE_RTOL = 1e-6
WIDTH = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def graphs():
    conv = CrystalGraphConverter(atom_graph_cutoff=5, bond_graph_cutoff=3,
                                 algorithm="numpy")
    return [conv(Structure.from_file(f).make_supercell(n).perturb(0.03, seed=i))
            for i, (f, n) in enumerate([(LIMNO2, (2, 1, 1)), (LICOO, (1, 1, 1))])]


@pytest.mark.parametrize("dense_k", [True, 120])
def test_dense_plans_drop_the_padded_slots(graphs, dense_k):
    b = batch_graphs(graphs, dense_k=dense_k)
    valid = b.dense_mask.reshape(-1) > 0
    n_atoms, n_slots = b.dense_nbr.shape
    own = np.repeat(np.arange(n_atoms), n_slots)
    for plan, slots, n_out in ((b.plan_dense_center, own, n_atoms),
                               (b.plan_dense_nbr, b.dense_nbr, n_atoms),
                               (b.plan_dense_bond, b.dense_bond, b.und_mask.shape[0])):
        key = np.where(valid, slots.reshape(-1), n_out)
        assert plan.key.dtype == np.int32 and np.array_equal(plan.key, key)
        assert np.array_equal(plan.perm, np.argsort(key, kind="stable"))
        counts = np.bincount(key[valid], minlength=n_out)
        assert np.array_equal(plan.offsets, np.concatenate([[0], np.cumsum(counts)]))
        assert plan.offsets[-1] == valid.sum() < key.shape[0]
    on = b.to("cpu")
    for name in ("plan_dense_center", "plan_dense_nbr", "plan_dense_bond"):
        for host, dev in zip(getattr(b, name)[:4], getattr(on, name)[:4]):
            assert torch.equal(dev, torch.as_tensor(host))
    plain = batch_graphs(graphs)
    assert all(getattr(plain, f"plan_dense_{n}").key.shape == (0,)
               for n in ("center", "nbr", "bond"))


def _scaled_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def test_dense_atom_conv_and_its_gradients_match_chgnet_tpu(graphs):
    b = batch_graphs(graphs, dense_k=True)
    rng = np.random.default_rng(0)
    params = j_layers.atom_conv_init(rng, atom_fea_dim=WIDTH, bond_fea_dim=WIDTH,
                                     hidden_dim=WIDTH)
    n_atoms, n_bonds = b.atomic_numbers.shape[0], b.und_mask.shape[0]
    atom = rng.standard_normal((n_atoms, WIDTH)).astype(np.float32)
    bond = rng.standard_normal((n_bonds, WIDTH)).astype(np.float32)
    weights = rng.standard_normal((n_bonds, WIDTH)).astype(np.float32)
    ct = rng.standard_normal((n_atoms, WIDTH)).astype(np.float32)
    slots = (b.dense_nbr, b.dense_bond, b.dense_mask)

    def j_loss(a, u, w):
        out = j_layers.atom_conv_dense_apply(params, a, u, w, *map(jnp.asarray, slots))
        return jnp.sum(out * ct), out

    (_, want), want_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        atom, bond, weights)
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    tb = b.to("cpu")
    inputs = [torch.tensor(x, requires_grad=True) for x in (atom, bond, weights)]
    got = t_layers.atom_conv_dense_apply(
        tp, *inputs, tb.dense_nbr, tb.dense_bond, tb.dense_mask, tb.plan_dense_center,
        tb.plan_dense_nbr, tb.plan_dense_bond)
    grads = torch.autograd.grad(got, inputs, torch.tensor(ct))
    assert _scaled_err(got.detach(), want) <= E_TOL
    for name, g, w in zip(("atom", "bond", "weights"), grads, want_grads):
        assert _scaled_err(g, w) <= F_TOL, name


def test_kinetic_energy_sums_over_the_graph_plan_as_chgnet_tpu():
    rng = np.random.default_rng(3)
    sizes = [7, 1, 30, 12]
    n_pad = sum(sizes) + 5
    owner = np.zeros(n_pad, np.int32)
    owner[: sum(sizes)] = np.repeat(np.arange(len(sizes)), sizes)
    valid = np.arange(n_pad) < sum(sizes)
    vel = rng.standard_normal((n_pad, 3)).astype(np.float32) * 0.01
    vel[~valid] = 0.0
    masses = rng.uniform(1.0, 200.0, n_pad).astype(np.float32)
    plan = make_plan(owner, valid, len(sizes), assume_sorted=True).to("cpu")
    got = t_md.kinetic_energy(torch.tensor(vel), torch.tensor(masses), plan)
    want = j_md.kinetic_energy(jnp.asarray(vel), jnp.asarray(masses), jnp.asarray(owner),
                               len(sizes))
    assert got.shape == (len(sizes),)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KE_RTOL)


def test_get_temperature_matches_chgnet_tpu_kinetic_energy():
    small = dict(atom_fea_dim=16, bond_fea_dim=16, angle_fea_dim=16, num_radial=9,
                 num_angular=9, n_conv=2, mlp_hidden_dims=(16,),
                 atom_conv_hidden_dim=16, bond_conv_hidden_dim=16,
                 graph_converter_algorithm="numpy")
    structs = [Structure.from_file(LIMNO2).perturb(0.05, seed=i) for i in range(2)]
    md = MolecularDynamics(structs, model=CHGNet(seed=0, device="cpu", **small),
                           ensemble="nvt", thermostat="Berendsen", temperature=300.0,
                           starting_temperature=300.0, timestep=2.0, seed=0)
    md.run(2)
    got = md.get_temperature()
    batch = md.runtime.batch
    n_pad = batch.atomic_numbers.shape[0]
    ke = j_md.kinetic_energy(
        jnp.asarray(md.state.vel[:n_pad].numpy()), jnp.asarray(md.masses[:n_pad].numpy()),
        jnp.asarray(np.asarray(batch.atom_owner)), len(structs))
    want = 2.0 * np.asarray(ke) / (md.dof.numpy() * units.KB)
    assert got.shape == (2,) and np.all(got > 0)
    np.testing.assert_allclose(got, want, rtol=KE_RTOL)
