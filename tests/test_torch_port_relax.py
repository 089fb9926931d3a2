"""The port's LBFGS, BFGS, their line-search forms and the SciPy relaxers
against chgnet_tpu's, on the CPU, with the SMALL seed-0 model.

* ``lbfgs_chunk`` / ``bfgs_chunk``, with and without ``line_search``, 8
  steps from LiMnO2 perturbed 0.05 (seed 1) with the cell free: energies,
  fmax and the final frac/lat within ``TOL`` (relative, eV/A, absolute).
  The L-BFGS maths is elementwise and keeps chgnet_tpu's order of sums, so
  it tracks to f32 rounding; BFGS steps through ``eigh`` of a Hessian with
  degenerate eigenvalues, which LAPACK and XLA round differently in f32,
  hence its looser bounds. The line-search cases take a longer step
  (``H0 = I/20``, maxstep 1 A) so that the Armijo test rejects trial steps
  and the backtracking shows; steps that long carry the f32 differences
  further, hence their bounds;
* BFGS equals L-BFGS while the memory holds every pair, then departs;
* SciPyFminCG / SciPyFminBFGS: the final energy within ``SCIPY_ATOL`` of
  chgnet_tpu's, the trajectory written and the magmoms assigned; the
  Verlet rebuild inside a minimisation.

Both packages build their graphs with the numpy builder here (chgnet_tpu's
runtime converter is pinned to it), and each chunk of chgnet_tpu's is
compiled once.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chgnet_tpu import ROOT
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.graph.batching import batch_graphs as j_batch_graphs
from chgnet_tpu.models.chgnet import CHGNet as JCHGNet
from chgnet_tpu.simulation import StructOptimizer as JStructOptimizer
from chgnet_tpu.simulation import relax as j_relax
from chgnet_tpu.simulation import runtime as j_runtime
from chgnet_tpu_torch.core.structure import Structure as TStructure
from chgnet_tpu_torch.graph.batching import batch_graphs as t_batch_graphs
from chgnet_tpu_torch.models.chgnet import CHGNet as TCHGNet
from chgnet_tpu_torch.simulation import StructOptimizer
from chgnet_tpu_torch.simulation import relax as t_relax
from test_golden_traces import SMALL

LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
MODEL = dict(SMALL, graph_converter_algorithm="numpy")
N_STEPS = 8
# (kind, line_search) -> (energy rtol, fmax atol eV/A, frac/lattice atol)
TOL = {
    ("lbfgs", False): (1e-6, 1e-5, 5e-6),
    ("bfgs", False): (1e-6, 1e-4, 1e-4),
    ("lbfgs", True): (1e-5, 5e-4, 2e-4),
    ("bfgs", True): (1e-5, 5e-4, 2e-4),
}
SCIPY_ATOL = 1e-4  # eV, final energy of the whole 8-atom cell
# a step long enough that the Armijo test rejects some trial steps
LONG_STEP = dict(alpha=20.0, maxstep=1.0)


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
def models():
    return JCHGNet(seed=0, **MODEL), TCHGNet(seed=0, device="cpu", **MODEL)


@pytest.fixture(scope="module")
def batches(models):
    jm, tm = models
    js = JStructure.from_file(LIMNO2).perturb(0.05, seed=1)
    ts = TStructure.from_file(LIMNO2).perturb(0.05, seed=1)
    jb = j_batch_graphs([jm.graph_converter(js)])
    tb = t_batch_graphs([tm.graph_converter(ts)]).to("cpu")
    return jb, tb, float(len(ts))


def _params(module, kind, long_step):
    return (module.LBFGS if kind == "lbfgs" else module.BFGS)(
        **(LONG_STEP if long_step else {})
    )


def _run_j(kind, line_search, jm, jb, n_atoms):
    params = _params(j_relax, kind, line_search)
    common = dict(
        config=jm.config, n_steps=N_STEPS, fmax_target=1e-6,
        cell_factor=jnp.asarray([n_atoms]), relax_cell=True, record=False,
        line_search=line_search,
    )
    if kind == "lbfgs":
        state = j_relax._init_lbfgs_state(jb, params)
        return j_relax.lbfgs_chunk(jm.params, jb, state, lbfgs=params, **common)
    pg_idx, n_max = j_relax._graph_slots(jb)
    state = j_relax._init_bfgs_state(jb, params, n_max)
    return j_relax.bfgs_chunk(
        jm.params, jb, state, jnp.asarray(pg_idx), bfgs=params, n_max=n_max, **common
    )


def _run_t(kind, line_search, tm, tb, n_atoms, long_step=None):
    params = _params(t_relax, kind, line_search if long_step is None else long_step)
    common = dict(
        config=tm.config, n_steps=N_STEPS, fmax_target=1e-6,
        cell_factor=torch.tensor([n_atoms]), relax_cell=True, record=False,
        line_search=line_search,
    )
    if kind == "lbfgs":
        state = t_relax._init_lbfgs_state(tb, params)
        return t_relax.lbfgs_chunk(tm.params, tb, state, lbfgs=params, **common)
    pg_idx, n_max = t_relax._graph_slots(tb)
    state = t_relax._init_bfgs_state(tb, params, n_max)
    return t_relax.bfgs_chunk(
        tm.params, tb, state, torch.as_tensor(pg_idx), bfgs=params, n_max=n_max,
        **common,
    )


@pytest.mark.parametrize("line_search", [False, True], ids=["plain", "line_search"])
@pytest.mark.parametrize("kind", ["lbfgs", "bfgs"])
def test_chunk_matches_chgnet_tpu(models, batches, kind, line_search):
    jm, tm = models
    jb, tb, n_atoms = batches
    j_state, j_traj = _run_j(kind, line_search, jm, jb, n_atoms)
    t_state, t_traj = _run_t(kind, line_search, tm, tb, n_atoms)
    e_rtol, fmax_atol, state_atol = TOL[kind, line_search]
    np.testing.assert_allclose(
        t_traj["energy"].numpy(), np.asarray(j_traj["energy"]), rtol=e_rtol, atol=0
    )
    np.testing.assert_allclose(
        t_traj["fmax"].numpy(), np.asarray(j_traj["fmax"]), rtol=0, atol=fmax_atol
    )
    for leaf in ("frac", "lat"):
        np.testing.assert_allclose(
            getattr(t_state, leaf).numpy(), np.asarray(getattr(j_state, leaf)),
            rtol=0, atol=state_atol, err_msg=leaf,
        )
    energies = t_traj["energy"][:, 0].numpy()
    assert energies[-1] < energies[0]
    if line_search:
        # the same long step without the search: the search changed the path
        _, plain = _run_t(kind, False, tm, tb, n_atoms, long_step=True)
        assert np.abs(plain["energy"].numpy() - t_traj["energy"].numpy()).max() > 1e-3


def test_bfgs_matches_then_departs_lbfgs(models, batches):
    """L-BFGS with H0 = I/alpha is exact BFGS while its memory holds every
    (s, y) pair: the two trajectories agree inside the window and part once
    a short memory starts dropping pairs (the port's copy of
    ``tests/test_simulation.py``'s check)."""
    _, tm = models
    _, tb, _ = batches
    n_pad = float(tb.frac_coords.shape[0])
    common = dict(
        config=tm.config, n_steps=12, fmax_target=1e-6,
        cell_factor=torch.tensor([n_pad]), relax_cell=True, record=False,
    )
    pg_idx, n_max = t_relax._graph_slots(tb)
    bfgs = t_relax.BFGS()
    _, tr_b = t_relax.bfgs_chunk(
        tm.params, tb, t_relax._init_bfgs_state(tb, bfgs, n_max),
        torch.as_tensor(pg_idx), bfgs=bfgs, n_max=n_max, **common,
    )
    lbfgs = t_relax.LBFGS(memory=3)
    _, tr_l = t_relax.lbfgs_chunk(
        tm.params, tb, t_relax._init_lbfgs_state(tb, lbfgs), lbfgs=lbfgs, **common
    )
    eb = tr_b["energy"][:, 0].numpy()
    el = tr_l["energy"][:, 0].numpy()
    np.testing.assert_allclose(eb[:4], el[:4], atol=5e-5)
    assert np.abs(eb[6:] - el[6:]).max() > 1e-4


@pytest.fixture
def numpy_runtime_converter(monkeypatch):
    """chgnet_tpu's GraphRuntime builds with its numpy builder here, as the
    port's is held against it."""
    monkeypatch.setattr(
        j_runtime,
        "CrystalGraphConverter",
        functools.partial(j_runtime.CrystalGraphConverter, algorithm="numpy"),
    )


@pytest.mark.parametrize("name", ["SciPyFminCG", "SciPyFminBFGS"])
def test_scipy_matches_chgnet_tpu(models, name, tmp_path, numpy_runtime_converter):
    jm, tm = models
    kw = dict(relax_cell=True, fmax=0.02, steps=30, assign_magmoms=True)
    j_res = JStructOptimizer(model=jm, optimizer_class=name).relax(
        JStructure.from_file(LIMNO2).perturb(0.1, seed=0), **kw
    )
    path = tmp_path / "scipy_traj.pkl"
    t_res = StructOptimizer(tm, optimizer_class=name).relax(
        TStructure.from_file(LIMNO2).perturb(0.1, seed=0), save_path=str(path), **kw
    )
    assert abs(t_res["final_energy"] - j_res["final_energy"]) <= SCIPY_ATOL
    traj = t_res["trajectory"]
    assert traj.energies[-1] <= traj.energies[0]
    assert path.exists()
    magmoms = t_res["final_structure"].site_properties["magmom"]
    assert len(magmoms) == len(t_res["final_structure"])
    assert np.isfinite(magmoms).all()


def test_scipy_rebuilds_topology_mid_minimize(models):
    """With a tiny skin the topology goes stale after ~0.025 A of motion, so
    a run that never rebuilt would compute on missing edges and land
    elsewhere than a run whose skin never runs out."""
    _, tm = models
    perturbed = TStructure.from_file(LIMNO2).perturb(0.12, seed=3)
    energies = []
    for skin in (0.05, 1.0):
        result = StructOptimizer(tm, optimizer_class="SciPyFminCG").relax(
            perturbed, relax_cell=False, fmax=0.02, steps=60,
            assign_magmoms=False, skin=skin,
        )
        energies.append(result["final_energy"])
    assert abs(energies[0] - energies[1]) < 5e-3
