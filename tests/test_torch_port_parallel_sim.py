"""The port's mesh simulation and its refusals, on gloo ranks of the CPU.

One spawn of 2 ranks runs ``MolecularDynamics(mesh=2)`` (NVT Berendsen,
with all-gathers, with ``halo=True`` and with a 0.08 A skin that rebuilds
mid-run) and ``StructOptimizer(mesh=2)`` with FIRE and the cell free (both
exchanges) on ``tests/test_md_sharded.py``'s 2x2x2 LiMnO2 and model; each is
held against the same run on one device at that file's tolerances
(positions and velocities 1e-6, 1e-5 across rebuilds, energies 5e-3 eV,
temperature 0.1 K; FIRE: the same number of steps, positions and cell
1e-5). Both ranks end in the same state, and LBFGS with a mesh raises.

Without a process group every mesh entry point raises, naming
``chgnet_tpu_torch.parallel.initialize``; with one, a mesh of another size
raises, and ``make_hybrid_mesh`` keeps ``chgnet_tpu``'s shape checks.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_parallel_work as work
from _torch_spawn import spawn
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.models.chgnet import CHGNet
from chgnet_tpu_torch.parallel import initialize, make_hybrid_mesh, make_mesh
from chgnet_tpu_torch.simulation import MolecularDynamics, StructOptimizer
from chgnet_tpu_torch.simulation.runtime import GraphRuntime
from chgnet_tpu_torch.trainer import Trainer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    return spawn(work.simulation_runs, 2, tmp_path_factory.mktemp("sim"))


@pytest.fixture(scope="module")
def single():
    return work.single_device_simulation()


@pytest.mark.parametrize("run", ["md", "md halo"])
def test_mesh_md_matches_single_device(mesh_runs, single, run):
    got, want = mesh_runs[0][run], single["md"]
    np.testing.assert_allclose(got["frac"], want["frac"], atol=1e-6)
    np.testing.assert_allclose(got["vel"], want["vel"], atol=1e-6)
    assert abs(float(got["epot"][0]) - float(want["epot"][0])) < 5e-3
    assert abs(got["temperature"] - want["temperature"]) < 0.1


def test_mesh_md_across_rebuilds_matches_single_device(mesh_runs, single):
    got, want = mesh_runs[0]["md rebuilds"], single["md rebuilds"]
    assert got["rebuilds"] >= 1, "the run did not rebuild"
    np.testing.assert_allclose(got["frac"], want["frac"], atol=1e-5)
    assert abs(float(got["epot"][0]) - float(want["epot"][0])) < 5e-3


@pytest.mark.parametrize("run", ["fire", "fire halo"])
def test_mesh_fire_matches_single_device(mesh_runs, single, run):
    got, want = mesh_runs[0][run], single["fire"]
    assert got["steps"] == want["steps"]
    np.testing.assert_allclose(got["frac"], want["frac"], atol=1e-5)
    np.testing.assert_allclose(got["lat"], want["lat"], atol=1e-5)
    assert abs(got["energy"] - want["energy"]) < 5e-3


def test_ranks_end_alike_and_lbfgs_refuses_a_mesh(mesh_runs):
    first, second = mesh_runs
    for run in ("md", "md halo", "md rebuilds", "fire", "fire halo"):
        for key, val in first[run].items():
            np.testing.assert_array_equal(second[run][key], val, f"{run} {key}")
    assert "FIRE/MDMin" in first["lbfgs"]


@pytest.fixture(scope="module")
def small_model():
    return CHGNet(seed=0, device="cpu", **work.SMALL_MD)


@pytest.mark.parametrize("entry", ["md", "relax", "trainer", "runtime"])
def test_mesh_without_a_process_group_raises(small_model, entry):
    assert not dist.is_initialized()
    struct = Structure.from_file(work.LIMNO2)
    with pytest.raises(RuntimeError, match="chgnet_tpu_torch.parallel.initialize"):
        if entry == "md":
            MolecularDynamics(struct, model=small_model, mesh=2)
        elif entry == "relax":
            StructOptimizer(small_model, mesh=2)
        elif entry == "trainer":
            Trainer(model=small_model, use_device="cpu", mesh=2)
        else:
            GraphRuntime(small_model.config, [struct], device="cpu",
                         shard_mesh=make_mesh(2, "graph", device="cpu"))


def test_a_mesh_of_another_size_raises(small_model, tmp_path):
    """In a one-rank group: a mesh of 2 raises in every entry point; the
    hybrid mesh's shape checks are chgnet_tpu's; ``halo`` without a mesh is
    ignored, as there."""
    assert initialize(f"file://{tmp_path}/store", 1, 0, backend="gloo")
    try:
        struct = Structure.from_file(work.LIMNO2)
        for make in (
            lambda: MolecularDynamics(struct, model=small_model, mesh=2, halo=True),
            lambda: StructOptimizer(small_model, mesh=2),
            lambda: Trainer(model=small_model, use_device="cpu", mesh=2),
        ):
            with pytest.raises(ValueError, match="process group has 1 ranks"):
                make()
        with pytest.raises(ValueError, match="divisible"):
            make_hybrid_mesh(graph=3, device_type="cpu")
        with pytest.raises(ValueError, match="global devices"):
            make_hybrid_mesh(2, 1, device_type="cpu")
        hybrid = make_hybrid_mesh(graph=1, device_type="cpu")
        assert hybrid.mesh_dim_names == ("data", "graph")
        assert tuple(hybrid.mesh.shape) == (1, 1)
        runtime = GraphRuntime(small_model.config, [struct], device="cpu", halo=True)
        assert runtime.sbatch is None and runtime.hbatch is None
        # a one-rank mesh runs the whole graph on this process
        md = MolecularDynamics(struct, model=small_model, mesh=1, halo=True,
                               **work._md_kw())
        md.run(2)
        ref = MolecularDynamics(struct, model=small_model, **work._md_kw())
        ref.run(2)
        n = ref.state.frac.shape[0]
        np.testing.assert_allclose(md.state.frac[:n].numpy(), ref.state.frac.numpy(),
                                   atol=1e-6)
    finally:
        dist.destroy_process_group()
