"""The port's graph-partitioned forward and collectives on gloo ranks of the CPU.

Each spawn (``tests/_torch_spawn.py``) runs ``compute_batch_sharded`` on 2
or 4 ranks in every form ``tests/test_graph_sharded.py`` and
``tests/test_md_sharded.py`` hold, and the test process holds the results,
at those files' tolerances (e 1e-5 eV/atom, f 1e-4 eV/A, s 1e-4 GPa, m
1e-5 mu_B; 2e-5 for the dynamic-cutoff forms):

* against ``chgnet_tpu.parallel.compute_batch_sharded`` (and ``_halo``) on
  as many of this process's virtual CPU devices, and against ``chgnet_tpu``'s
  single-device forward;
* against the port's own single-device forward (three graphs in one
  batch, the skin batch under ``dynamic_cutoff`` against
  ``compute_batch_dynamic``);
* ``remat="angle"`` and a batch sharded without plans against the plain
  run (1e-6); every rank's outputs equal bit for bit.

The collectives are held to second order against the same composite
computed in one process on every rank's rows (float64, 1e-12).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import _torch_parallel_work as work
from _torch_spawn import spawn
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.graph.batching import batch_graphs as j_batch_graphs
from chgnet_tpu.graph.converter import CrystalGraphConverter as JConverter
from chgnet_tpu.models.chgnet import CHGNet as JCHGNet, compute_batch as j_compute_batch
from chgnet_tpu.parallel import graph_sharded as jgs
from chgnet_tpu.parallel.mesh import make_mesh as j_make_mesh

TOL = {"e": 1e-5, "f": 1e-4, "s": 1e-4, "m": 1e-5}
JAX_SMALL = {k: v for k, v in work.SMALL.items() if k != "graph_converter_algorithm"}


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def runs(request, tmp_path_factory):
    d = request.param
    return d, spawn(work.forward_runs, d, tmp_path_factory.mktemp(f"fwd{d}"))


@pytest.fixture(scope="module")
def single():
    return work.single_device_runs()


@pytest.fixture(scope="module")
def jax_inputs():
    model = JCHGNet(seed=0, **JAX_SMALL)
    struct = JStructure.from_file(work.LIMNO2).make_supercell(2).perturb(0.05, seed=0)
    batch = j_batch_graphs([JConverter(algorithm="numpy")(struct)])
    return model, batch, len(struct)


def _jax_sharded(jax_inputs, d: int, halo: bool) -> dict:
    model, batch, n = jax_inputs
    mesh = j_make_mesh(d, axis_name="graph")
    kw = dict(config=model.config, mesh=mesh, compute_force=True,
              compute_stress=True, compute_magmom=True)
    if halo:
        out = jgs.compute_batch_sharded_halo(
            model.params, *jgs.shard_batch_halo(batch, d), **kw)
    else:
        out = jgs.compute_batch_sharded(model.params, jgs.shard_batch(batch, d), **kw)
    return {k: (jgs.unshard_atoms(out[k])[:n] if k in "fm" else np.asarray(out[k]))
            for k in work.KEYS}


def _close(got: dict, want: dict, tol: dict, what: str) -> None:
    for key in work.KEYS:
        np.testing.assert_allclose(got[key], want[key][: len(got[key])], rtol=0,
                                   atol=tol[key], err_msg=f"{key}: {what}")


@pytest.mark.parametrize("exchange", ["all-gather", "halo"])
def test_forward_matches_chgnet_tpu(runs, jax_inputs, exchange):
    d, ranks = runs
    model, batch, n = jax_inputs
    want = _jax_sharded(jax_inputs, d, exchange == "halo")
    _close(ranks[0][exchange], want, TOL, f"chgnet_tpu's {exchange} on {d} devices")
    single = j_compute_batch(model.params, batch, config=model.config, compute_force=True,
                             compute_stress=True, compute_magmom=True)
    single = {k: np.asarray(single[k])[:n] if k in "fm" else np.asarray(single[k])
              for k in work.KEYS}
    _close(ranks[0][exchange], single, TOL, "chgnet_tpu's single device")


def test_forward_matches_the_single_device_port(runs, single):
    _, ranks = runs
    out = ranks[0]
    for exchange in ("all-gather", "halo"):
        _close(out[exchange], single["one"], TOL, exchange)
    _close(out["3 graphs"], single["3 graphs"], TOL, "three graphs")
    dyn = {k: 2e-5 for k in work.KEYS}
    for exchange in ("all-gather", "halo"):
        _close(out[f"dynamic {exchange}"], single["dynamic"], dyn,
               f"dynamic cutoff, {exchange}")


def test_remat_and_plan_free_shards_match(runs):
    _, ranks = runs
    out = ranks[0]
    exact = {k: 1e-6 for k in work.KEYS}
    _close(out["remat"], out["all-gather"], exact, "remat='angle'")
    _close(out["no plans"], out["all-gather"], exact, "plans built on the rank")


def test_every_rank_returns_the_same(runs):
    _, ranks = runs
    for other in ranks[1:]:
        for form, outs in ranks[0].items():
            for key, val in outs.items():
                np.testing.assert_array_equal(other[form][key], val, f"{form} {key}")


@pytest.mark.parametrize("d", [2, 4])
def test_collectives_to_second_order(tmp_path, d):
    """all_gather, reduce_scatter, all_to_all and sum_ranks in one scalar:
    its value, gradient and the gradient of its gradient's square norm on
    every rank equal the single-process composite's rows of that rank."""
    ranks = spawn(work.collective_grads, d, tmp_path)
    for res in ranks:
        assert res["value"] <= 1e-12 * max(1.0, abs(res["same on every rank"]))
        assert res["grad"] <= 1e-12
        assert res["grad of grad"] <= 1e-10
    assert len({res["same on every rank"] for res in ranks}) == 1


def test_jax_reference_is_not_degenerate(jax_inputs):
    """The reference batch spans both exchanges: at D = 4 every rank owns
    edges whose neighbours live on other ranks."""
    _, batch, _ = jax_inputs
    sb = jgs.shard_batch(batch, 4)
    n_loc = sb.atomic_numbers.shape[1]
    for r in range(4):
        valid = sb.edge_mask[r] > 0
        remote = (sb.edge_neighbor[r][valid] // n_loc) != r
        assert remote.any() and (~remote).any()
    assert jax.device_count() >= 4
