"""The port's graph-partitioned batch layouts against chgnet_tpu's, on the host.

``shard_batch`` and ``shard_batch_halo`` of the same padded batch give every
index, image, mask and send array of ``chgnet_tpu``'s bit for bit at D = 2,
4 and 8 (with and without plans: the plans point each padded tail at its
last valid row), and the bond-device waterfill gives the same choices on
random classes. The port's own per-rank plans are the plans of each rank's
arrays; ``ranks=`` builds only those asked for. No spawn, no compile.
"""

from __future__ import annotations

import numpy as np
import pytest

from chgnet_tpu import ROOT
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.graph.batching import batch_graphs as j_batch_graphs
from chgnet_tpu.graph.converter import CrystalGraphConverter as JConverter
from chgnet_tpu.parallel import dp as j_dp
from chgnet_tpu.parallel import graph_sharded as jgs
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.graph.batching import batch_graphs, make_plan
from chgnet_tpu_torch.graph.converter import CrystalGraphConverter
from chgnet_tpu_torch.parallel import dp, graph_sharded as gs

LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
ARRAYS = [f for f in gs.ShardedGraphBatch._fields if f != "plans"]
HALO_ARRAYS = [f for f in gs.HaloBatch._fields if f != "plans"]


@pytest.fixture(scope="module")
def batches():
    """A two-graph batch (2x2x2 and 1x1x2 LiMnO2, perturbed) in both
    packages, by the numpy graph builder; the host arrays agree."""
    j_structs = [JStructure.from_file(LIMNO2).make_supercell(2).perturb(0.05, seed=0),
                 JStructure.from_file(LIMNO2).make_supercell([1, 1, 2]).perturb(0.05, seed=1)]
    t_structs = [Structure.from_file(LIMNO2).make_supercell(2).perturb(0.05, seed=0),
                 Structure.from_file(LIMNO2).make_supercell([1, 1, 2]).perturb(0.05, seed=1)]
    jb = j_batch_graphs([JConverter(algorithm="numpy")(s, graph_id=str(i))
                         for i, s in enumerate(j_structs)])
    tb = batch_graphs([CrystalGraphConverter(algorithm="numpy")(s, graph_id=str(i))
                       for i, s in enumerate(t_structs)])
    for field in ("atom_graph", "bond_graph", "directed2undirected",
                  "undirected2directed", "edge_mask", "angle_mask", "frac_coords"):
        np.testing.assert_array_equal(getattr(tb, field), getattr(jb, field), field)
    return jb, tb


@pytest.mark.parametrize("d", [2, 4, 8])
def test_shard_batch_equals_chgnet_tpu(batches, d):
    jb, tb = batches
    for plans in (True, False):
        want = jgs.shard_batch(jb, d, plans=plans)
        got = gs.shard_batch(tb, d, plans=plans)
        for field in ARRAYS:
            np.testing.assert_array_equal(
                getattr(got, field), np.asarray(getattr(want, field)),
                err_msg=f"{field} plans={plans}")
        assert (got.plans is None) == (not plans)
    # monotone capacity floors, as a simulation loop carries them
    caps = (got.edge_center.shape[1] + 8, got.und_center.shape[1] + 16,
            got.ang_center.shape[1] + 24)
    floored = gs.shard_batch(tb, d, min_caps=caps)
    j_floored = jgs.shard_batch(jb, d, min_caps=caps)
    for field in ARRAYS:
        np.testing.assert_array_equal(getattr(floored, field),
                                      np.asarray(getattr(j_floored, field)), field)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_shard_batch_halo_equals_chgnet_tpu(batches, d):
    jb, tb = batches
    j_sb, j_hb = jgs.shard_batch_halo(jb, d, min_halo=(0, 24))
    sb, hb = gs.shard_batch_halo(tb, d, min_halo=(0, 24))
    for field in ARRAYS:
        np.testing.assert_array_equal(getattr(sb, field), np.asarray(getattr(j_sb, field)),
                                      err_msg=field)
    for field in HALO_ARRAYS:
        np.testing.assert_array_equal(getattr(hb, field), np.asarray(getattr(j_hb, field)),
                                      err_msg=field)
    assert hb.bond_send.shape[2] >= 24
    # every remapped reference lands on the row it named: own block or the
    # peer's send slot
    n_loc = sb.atomic_numbers.shape[1]
    for r in range(d):
        valid = sb.edge_mask[r] > 0
        pos = hb.edge_neighbor_h[r][valid]
        gid = sb.edge_neighbor[r][valid]
        own = pos < n_loc
        np.testing.assert_array_equal(pos[own], gid[own] - r * n_loc)
        peer, slot = np.divmod(pos[~own] - n_loc, hb.atom_send.shape[2])
        np.testing.assert_array_equal(hb.atom_send[peer, r, slot] + peer * n_loc, gid[~own])


def test_bond_waterfill_equals_chgnet_tpu():
    """Random endpoint classes and weights: the same device for every bond
    (the float64 waterfill's choices, bit for bit)."""
    rng = np.random.default_rng(3)
    for d in (2, 4, 8):
        n = 20_000
        dev_c = rng.integers(0, d, n).astype(np.int32)
        dev_n = np.minimum(dev_c + rng.integers(0, d, n), d - 1).astype(np.int32)
        weights = rng.integers(1, 60, n).astype(np.int64)
        np.testing.assert_array_equal(
            gs._balance_bond_devices(dev_c, dev_n, weights, d),
            jgs._balance_bond_devices(dev_c, dev_n, weights, d),
        )


def test_rank_plans_are_the_plans_of_each_rank(batches):
    """shard_batch's plans are make_plan over each rank's arrays; ranks=
    builds only the ranks asked for; the targets and the unsharding follow
    chgnet_tpu's layout."""
    _, tb = batches
    d = 4
    sb = gs.shard_batch(tb, d)
    rows = {"atoms": sb.atomic_numbers.size, "bonds": sb.und_mask.size}
    for name, (field, mask, table, sorted_) in gs.PLAN_STREAMS.items():
        for r in range(d):
            want = make_plan(getattr(sb, field)[r], getattr(sb, mask)[r] > 0,
                             rows[table], assume_sorted=sorted_)
            got = sb.plans[name][r]
            for a, b in zip(got[:4], want[:4]):
                np.testing.assert_array_equal(a, b, err_msg=f"{name} rank {r}")
    only = gs.shard_batch(tb, d, ranks=(2,))
    assert all(p[2] is not None and p[0] is None for p in only.plans.values())
    n_pad = tb.atomic_numbers.shape[0]
    rng = np.random.default_rng(0)
    targets = {"e": np.ones(2, np.float32), "graph_mask": np.ones(2, np.float32),
               "f": rng.normal(size=(n_pad, 3)).astype(np.float32),
               "m": rng.normal(size=n_pad).astype(np.float32)}
    got = gs.shard_targets(targets, sb)
    want = jgs.shard_targets(targets, sb)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(gs.unshard_atoms(got["f"]), jgs.unshard_atoms(want["f"]))


def test_stack_batches_equals_chgnet_tpu():
    """Two single-graph batches of one capacity, stacked: every array of
    chgnet_tpu's stack; unequal capacities raise in both."""
    caps = (32, 2048, 4096)
    t_graphs = [CrystalGraphConverter(algorithm="numpy")(
        Structure.from_file(LIMNO2).perturb(0.08, seed=s)) for s in range(2)]
    j_graphs = [JConverter(algorithm="numpy")(
        JStructure.from_file(LIMNO2).perturb(0.08, seed=s)) for s in range(2)]
    got = dp.stack_batches([batch_graphs([g], capacities=caps) for g in t_graphs])
    want = j_dp.stack_batches([j_batch_graphs([g], capacities=caps) for g in j_graphs])
    for field in ("atomic_numbers", "frac_coords", "atom_graph", "bond_graph",
                  "edge_mask", "angle_mask", "lattices", "images"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert got.plan_center.key.shape == (2, caps[1])
    targets = [{"e": np.float32([i]), "graph_mask": np.ones(1, np.float32)} for i in range(2)]
    np.testing.assert_array_equal(dp.stack_targets(targets)["e"],
                                  j_dp.stack_targets(targets)["e"])
    with pytest.raises(ValueError, match="share capacities"):
        dp.stack_batches([batch_graphs([t_graphs[0]], capacities=caps),
                          batch_graphs([t_graphs[1]])])
