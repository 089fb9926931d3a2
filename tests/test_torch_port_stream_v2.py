"""The port's CHGNET_TPU_STREAM_V2 path against chgnet_tpu.

* ``segment_sum_tiles`` against ``_segsum_v2_pallas`` and
  ``gather_rows_window`` against ``_gather_v2_pallas``, both in interpret
  mode, as ``tests/test_stream_ops.py`` runs them: a sorted stream with a
  padded tail, a permuted (block-local) stream, d in 32 and 64. On the CPU
  a wrapper runs its plain version, so these hold the port's function; the
  kernels themselves are held against the plain versions on the card
  (``tests/test_torch_port_cuda.py``). Tolerances: the sums 1e-5 (f32 sums
  of a few unit-normal terms in another order), the gather exact on the
  rows inside their window and zero outside.
* The window plans: absent without the switch, covering every valid index
  with it, absent when a block spans more than the cap.
* The dispatch of ``plan_gather`` / ``plan_segment_sum`` under the switch,
  and their autograd to second order.
* The whole slice: E/F/S/M with the switch on, in both bond layouts,
  against ``chgnet_tpu.compute_batch`` with the same switch and its kernels
  in interpret mode, at e 2e-5 eV/atom, f 5e-5 eV/A, s 2e-4 GPa, m 2e-5
  mu_B.
"""

from __future__ import annotations

import functools as ft

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chgnet_tpu import ROOT
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.graph.batching import batch_graphs as j_batch_graphs
from chgnet_tpu.models.chgnet import CHGNet as JCHGNet
from chgnet_tpu.models.chgnet import compute_batch as j_compute_batch
from chgnet_tpu.ops import gproj as jgproj
from chgnet_tpu.ops import stream_ops as so
from chgnet_tpu_torch.core.structure import Structure as TStructure
from chgnet_tpu_torch.graph import batching as tb
from chgnet_tpu_torch.graph.batching import SegmentPlan, make_plan
from chgnet_tpu_torch.graph.batching import batch_graphs as t_batch_graphs
from chgnet_tpu_torch.models.chgnet import CHGNet as TCHGNet
from chgnet_tpu_torch.models.chgnet import compute_batch as t_compute_batch
from chgnet_tpu_torch.ops import segment as tsg

SMALL = dict(
    atom_fea_dim=16, bond_fea_dim=16, angle_fea_dim=16, num_radial=9,
    num_angular=9, n_conv=3, mlp_hidden_dims=(16,), atom_conv_hidden_dim=16,
    bond_conv_hidden_dim=16, graph_converter_algorithm="numpy",
)
FULL = dict(graph_converter_algorithm="numpy")
TOL = {"e": 2e-5, "f": 5e-5, "s": 2e-4, "m": 2e-5}
LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
LICOO = f"{ROOT}/examples/mp-1175469-Li9Co7O16.cif"
FLAGS = dict(compute_force=True, compute_stress=True, compute_magmom=True)
ONE = [(LIMNO2, None)]
THREE = [(LIMNO2, 1), (LICOO, 2), (LIMNO2, 3)]


@pytest.fixture()
def v2(monkeypatch):
    """CHGNET_TPU_STREAM_V2 set, chgnet_tpu's TPU gates open and its Pallas
    entry points in interpret mode."""
    monkeypatch.setenv("CHGNET_TPU_STREAM_V2", "1")
    monkeypatch.delenv("CHGNET_TPU_NO_STREAM_V2", raising=False)
    monkeypatch.setattr(so, "tpu_backend", lambda: True)
    for name in ("_multi_gather_pallas", "_gather_pallas", "_segsum_pallas",
                 "_segsum2_pallas", "_segsum_v2_pallas", "_gather_v2_pallas"):
        monkeypatch.setattr(so, name, ft.partial(getattr(so, name), interpret=True))
    monkeypatch.setattr(
        jgproj, "_gproj_pallas", ft.partial(jgproj._gproj_pallas, interpret=True)
    )
    jax.clear_caches()
    yield
    jax.clear_caches()


def _t(x):
    return torch.tensor(np.asarray(x))


def _tplan(idx, valid, n_out, sorted_=False) -> SegmentPlan:
    plan = make_plan(idx, valid, n_out, assume_sorted=sorted_)
    return SegmentPlan(*(torch.as_tensor(x) for x in plan))


# ------------------------------------------------------------ row 11
@pytest.mark.parametrize("d", [32, 64])
def test_segment_sum_tiles_equals_pallas_on_a_sorted_stream_with_padded_tail(v2, d):
    rng = np.random.default_rng(21)
    n_out, L = 3 * so.BO, 4 * so.C
    x = rng.standard_normal((L, d)).astype(np.float32)
    dst = np.sort(rng.integers(0, n_out, L - 40)).astype(np.int32)
    dst = np.concatenate([dst, np.full(40, n_out, np.int32)])
    blk_lo, blk_cnt = so.build_block_plan(dst, n_out)
    want = np.asarray(so._segsum_v2_pallas(
        jnp.asarray(x), jnp.asarray(dst), jnp.asarray(blk_lo), jnp.asarray(blk_cnt),
        n_out=n_out,
    ))
    plan = _tplan(dst, dst < n_out, n_out, sorted_=True)
    got = tsg.segment_sum_tiles(_t(x), plan.offsets, plan.perm)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # empty segments are zero rows, and the op takes the same route
    empty = np.setdiff1d(np.arange(n_out), dst)
    assert empty.size and not got.numpy()[empty].any()
    op = tsg.plan_segment_sum(_t(x), plan)
    assert torch.equal(op, got)


@pytest.mark.parametrize("d", [32, 64])
def test_segment_sum_tiles_equals_pallas_on_a_permuted_stream(v2, d):
    rng = np.random.default_rng(22)
    n_out, L = 3 * so.BO, 4 * so.C
    key = np.sort(rng.integers(0, n_out, L)).astype(np.int32)
    key = key.reshape(-1, 8)[rng.permutation(L // 8)].reshape(-1)  # scrambled
    key[rng.integers(0, L, 30)] = n_out  # dropped rows anywhere
    perm = np.argsort(key, kind="stable").astype(np.int32)
    blk_lo, blk_cnt, _ = so.build_block_plan_local(key, perm, n_out)
    x = rng.standard_normal((L, d)).astype(np.float32)
    want = np.asarray(so.segment_sum_sorted(
        jnp.asarray(x), jnp.asarray(key), jnp.asarray(blk_lo), jnp.asarray(blk_cnt),
        n_out, None, None, None, True,
    ))
    plan = _tplan(key, key < n_out, n_out)
    assert plan.perm.shape[0] == L
    got = tsg.segment_sum_tiles(_t(x), plan.offsets, plan.perm)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ------------------------------------------------------------ row 12
@pytest.mark.parametrize("d", [32, 64])
def test_gather_rows_window_equals_pallas_inside_the_window(v2, d):
    rng = np.random.default_rng(23)
    n_src, L = 4 * so.W, 4 * so.C
    idx = np.sort(rng.integers(0, n_src, L)).astype(np.int32)
    valid = np.arange(L) < L - 200  # a padded tail
    idx[~valid] = idx[valid][-1]  # pointing at the last valid row
    pw = so.build_pw_plan(idx, valid, n_src)
    assert pw is not None
    src = rng.standard_normal((n_src, d)).astype(np.float32)
    want = np.asarray(so._gather_v2_pallas(
        jnp.asarray(src), jnp.asarray(idx), jnp.asarray(pw)
    ))
    plan = _tplan(idx, valid, n_src)
    assert plan.window.shape == (L // tb.WINDOW_BLOCK, 2)
    got = tsg.gather_rows_window(_t(src), _t(idx), plan.window).numpy()
    np.testing.assert_array_equal(got[valid], want[valid])
    np.testing.assert_array_equal(got[valid], src[idx[valid]])
    # a padded row gathers the row it names when that lies inside its
    # block's window and zero when it does not (here: every block but the
    # last one with a valid row)
    block = np.arange(L) // tb.WINDOW_BLOCK
    win = plan.window.numpy()
    inside = (idx >= win[block, 0]) & (idx <= win[block, 1])
    assert (~inside).any() and inside[valid].all()
    np.testing.assert_array_equal(got[inside], src[idx[inside]])
    assert not got[~inside].any()
    # the backward's direction: the plan's keys, dropped rows zero
    back = tsg.gather_rows_window(_t(src), plan.key, plan.window).numpy()
    np.testing.assert_array_equal(back[valid], src[idx[valid]])
    assert not back[~valid].any()


# ------------------------------------------------------- window plans
def test_window_plans_follow_the_switch(monkeypatch):
    rng = np.random.default_rng(24)
    L, S = 1000, 5000
    idx = (np.arange(L) * 2 + rng.integers(0, 100, L)).astype(np.int32)
    valid = rng.random(L) < 0.9
    monkeypatch.delenv("CHGNET_TPU_STREAM_V2", raising=False)
    assert make_plan(idx, valid, S).window.shape == (0,)
    monkeypatch.setenv("CHGNET_TPU_STREAM_V2", "1")
    plan = make_plan(idx, valid, S)
    n_blocks = -(-L // tb.WINDOW_BLOCK)
    assert plan.window.shape == (n_blocks, 2) and plan.window.dtype == np.int32
    block = np.arange(L) // tb.WINDOW_BLOCK
    lo, hi = plan.window[block, 0], plan.window[block, 1]
    assert ((idx >= lo) & (idx <= hi))[valid].all()  # every valid index
    for j in range(n_blocks):  # and no wider than the valid rows need
        rows = idx[(block == j) & valid]
        assert (plan.window[j] == (rows.min(), rows.max())).all()
    assert (hi - lo < tb.WINDOW_ROWS).all()
    monkeypatch.setenv("CHGNET_TPU_NO_STREAM_V2", "1")
    assert make_plan(idx, valid, S).window.shape == (0,)


def test_window_plan_is_absent_beyond_the_cap_and_empty_blocks_gather_zero(
    monkeypatch,
):
    monkeypatch.setenv("CHGNET_TPU_STREAM_V2", "1")
    idx = np.arange(512, dtype=np.int32)
    far = idx.copy()
    far[5] = 10_000  # one block spans more than WINDOW_ROWS rows
    assert make_plan(far, np.ones(512, bool), 20_000).window.shape == (0,)
    ok = make_plan(far, far < 10_000, 20_000)  # ... unless that row is padding
    assert ok.window.shape == (4, 2)
    valid = idx >= 128  # the first block has no valid row
    plan = _tplan(idx, valid, 512)
    assert tuple(plan.window[0]) == (0, -1)
    out = tsg.gather_rows_window(torch.ones(512, 4), _t(idx), plan.window)
    assert not out[:128].any() and bool((out[128:] == 1).all())
    with pytest.raises(ValueError, match="window"):
        tsg.gather_rows_window(torch.ones(512, 4), _t(idx), plan.window[:2])


def test_batch_plans_carry_windows_only_under_the_switch(monkeypatch):
    conv = TCHGNet(seed=0, device="cpu", **SMALL).graph_converter
    graphs = [conv(TStructure.from_file(LIMNO2).make_supercell(2))]
    monkeypatch.delenv("CHGNET_TPU_STREAM_V2", raising=False)
    off = t_batch_graphs(graphs)
    monkeypatch.setenv("CHGNET_TPU_STREAM_V2", "1")
    on = t_batch_graphs(graphs)
    for name in on._fields:
        plan = getattr(on, name)
        if not isinstance(plan, SegmentPlan):
            continue
        assert getattr(off, name).window.shape == (0,), name
        for field in ("key", "perm", "offsets"):
            np.testing.assert_array_equal(
                getattr(plan, field), getattr(getattr(off, name), field)
            )
        if plan.window.shape[0] == 0:  # a block spans too far: d2u, u2d2
            continue
        valid = plan.key < plan.n_out
        block = np.arange(plan.key.shape[0]) // tb.WINDOW_BLOCK
        inside = (plan.key >= plan.window[block, 0]) & (
            plan.key <= plan.window[block, 1])
        assert inside[valid].all(), name
    assert on.plan_center.window.shape[0] and on.plan_ang_vj.window.shape[0]
    dev = on.to("cpu")
    assert dev.plan_nbr.window.dtype == torch.int32
    assert dev.plan_nbr.window.shape == on.plan_nbr.window.shape


# ----------------------------------------------------------- dispatch
def _spy(monkeypatch, names):
    calls = {n: 0 for n in names}
    for name in names:
        orig = getattr(tsg, name)

        def wrapped(*a, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*a)

        monkeypatch.setattr(tsg, name, wrapped)
    return calls


def test_dispatch_under_the_switch(monkeypatch):
    """v2 for rows narrower than 128 floats and windows that fit; the v1
    kernels otherwise, and always without the switch
    (``stream_ops._segsum_impl`` :461, ``scatter._gather_fwd_impl`` :195)."""
    calls = _spy(monkeypatch, ("segment_sum_csr", "segment_sum_tiles",
                               "gather_rows", "gather_rows_window"))
    rng = np.random.default_rng(25)
    L, S = 512, 300
    idx = np.sort(rng.integers(0, S, L)).astype(np.int32)
    monkeypatch.setenv("CHGNET_TPU_STREAM_V2", "1")
    plan = _tplan(idx, np.ones(L, bool), S, sorted_=True)
    bare = SegmentPlan(plan.key, plan.perm, plan.offsets)  # no window
    for d, want in ((64, "segment_sum_tiles"), (4, "segment_sum_tiles"),
                    (128, "segment_sum_csr")):
        before = dict(calls)
        tsg.plan_segment_sum(torch.randn(L, d), plan)
        assert calls[want] == before[want] + 1, d
    for d, p, want in ((64, plan, "gather_rows_window"),
                       (128, plan, "gather_rows_window"),
                       (256, plan, "gather_rows"),  # the window does not fit
                       (3, plan, "gather_rows"),  # no float4 units
                       (64, bare, "gather_rows")):
        before = dict(calls)
        out = tsg.plan_gather(torch.randn(S, d), _t(idx), p)
        assert calls[want] == before[want] + 1, d
        assert out.shape == (L, d)
    for env in ("CHGNET_TPU_NO_STREAM_V2", None):
        if env:
            monkeypatch.setenv(env, "1")
        else:
            monkeypatch.delenv("CHGNET_TPU_STREAM_V2")
        before = dict(calls)
        tsg.plan_segment_sum(torch.randn(L, 64), plan)
        tsg.plan_gather(torch.randn(S, 64), _t(idx), plan)
        assert calls["segment_sum_csr"] == before["segment_sum_csr"] + 1
        assert calls["gather_rows"] == before["gather_rows"] + 1


def test_autograd_under_the_switch_matches_jax_to_second_order(v2):
    """plan_gather then plan_segment_sum through the v2 ops, value, gradient
    and gradient of the gradient, against chgnet_tpu's planned ops with the
    same switch."""
    from chgnet_tpu.ops import scatter as jsc

    rng = np.random.default_rng(26)
    L, S, d = 2 * so.C, 2 * so.W, 32
    idx = np.sort(rng.integers(0, S, L)).astype(np.int32)
    valid = np.arange(L) < L - 50
    idx[~valid] = idx[valid][-1]
    table = rng.standard_normal((S, d)).astype(np.float32)
    jplan = jsc.make_plan(idx, valid, S, assume_sorted=False)
    assert jplan.pw.shape[0]
    mask = valid[:, None].astype(np.float32)

    def jloss(t):
        rows = jsc.plan_gather(t, jnp.asarray(idx), jplan) * mask
        key = jnp.where(jnp.asarray(valid), jnp.asarray(idx), S)
        out = jsc.plan_segment_sum(jnp.sin(rows) * rows, key, S, jplan)
        return (out ** 2).sum()

    jt = jnp.asarray(table)
    want = [jloss(jt), jax.grad(jloss)(jt),
            jax.grad(lambda t: (jax.grad(jloss)(t) * jt).sum())(jt)]

    plan = _tplan(idx, valid, S)
    assert plan.window.shape[0]
    t = torch.tensor(table, requires_grad=True)
    rows = tsg.plan_gather(t, _t(idx), plan) * _t(mask)
    out = tsg.plan_segment_sum(torch.sin(rows) * rows, plan)
    loss = (out ** 2).sum()
    (g1,) = torch.autograd.grad(loss, t, create_graph=True)
    (g2,) = torch.autograd.grad((g1 * t.detach()).sum(), t)
    # relative to each output's largest value; the second order stands at
    # 1e-4: chgnet_tpu's one-hot products in interpret mode round one block
    # of rows at 3e-5 of it (against plain XLA the port agrees to 2e-7)
    for got, ref, tol in zip((loss, g1, g2), want, (2e-5, 2e-5, 1e-4)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            got.detach().numpy(), ref, atol=tol * np.abs(ref).max(), rtol=0
        )


# ------------------------------------------------------------ the slice
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


def _check(jout, tout, n_graphs, n_atoms):
    for key, sl in (("e", n_graphs), ("s", n_graphs), ("f", n_atoms), ("m", n_atoms)):
        j = np.asarray(jout[key])[:sl]
        t = np.asarray(tout[key])[:sl]
        assert np.isfinite(t).all(), key
        np.testing.assert_allclose(t, j, atol=TOL[key], rtol=0, err_msg=key)


@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
@pytest.mark.parametrize(
    "kw,structs", [(SMALL, THREE), (FULL, ONE)], ids=["small-3", "full-1"]
)
def test_stream_v2_efsm_matches_chgnet_tpu(v2, monkeypatch, kw, structs, directed):
    kw = dict(kw, directed_bonds=directed)
    gj, gt = _graphs(structs, kw)
    jm = JCHGNet(seed=0, **kw)
    tm = TCHGNet(seed=0, device="cpu",
                 params=jax.tree.map(np.asarray, jm.params), **kw)
    calls = _spy(monkeypatch, ("segment_sum_tiles", "gather_rows_window"))
    # both batches are built under the switch: the window plans
    jout = j_compute_batch(jm.params, j_batch_graphs(gj), config=jm.config, **FLAGS)
    batch = t_batch_graphs(gt).to("cpu")
    assert batch.plan_center.window.shape[0]
    tout = t_compute_batch(tm.params, batch, config=tm.config, **FLAGS)
    assert calls["segment_sum_tiles"] and calls["gather_rows_window"]
    _check(jout, tout, len(gt), sum(g.n_atoms for g in gt))
