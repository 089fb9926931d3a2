"""The port's CHGNET_TPU_FUSED_PASS path against chgnet_tpu.

* ``fused_layer_pass`` with the switch on (on the CPU the wrappers run
  their plain versions through the same autograd ops) against
  ``chgnet_tpu.ops.fused_pass.fused_layer_pass`` with its Pallas kernels in
  interpret mode and the fixture of ``tests/test_fused_pass.py``, in the
  message form and both update forms: values at 2e-5, first-order gradients
  of the tables, ``b1`` and the pack against ``jax.grad`` at 1e-4 of each
  gradient's largest value, second order against the reference composition
  at 1e-3 (the bars of ``tests/test_fused_pass.py`` are 5e-3 and 5e-2
  absolute).
* The kernels' plain versions against ``_fused_pass_pallas`` and
  ``_pass_bwd_pallas`` themselves, with two gathered parts.
* The gate: a spy that it selects the fused wrappers, the kill switch, the
  parts that send it to the unfused composition, and the raise cases.
* ``project_parts_fold`` against chgnet_tpu's.
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
from chgnet_tpu.models import functions as jfn
from chgnet_tpu.models.chgnet import CHGNet as JCHGNet
from chgnet_tpu.models.chgnet import compute_batch as j_compute_batch
from chgnet_tpu.ops import fused_pass as jfp
from chgnet_tpu.ops import gproj as jgproj
from chgnet_tpu.ops import scatter as jsc
from chgnet_tpu.ops import stream_ops as so
from chgnet_tpu_torch.core.structure import Structure as TStructure
from chgnet_tpu_torch.graph.batching import SegmentPlan, make_plan
from chgnet_tpu_torch.graph.batching import batch_graphs as t_batch_graphs
from chgnet_tpu_torch.models import functions as tfn
from chgnet_tpu_torch.models.chgnet import CHGNet as TCHGNet
from chgnet_tpu_torch.models.chgnet import compute_batch as t_compute_batch
from chgnet_tpu_torch.ops import fused_pass as tfp
from chgnet_tpu_torch.ops import gated_message as tgm

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
FORMS = [(True, True), (False, True), (False, False)]
FORM_IDS = ["message", "update-w2", "update"]
DIM = 64


@pytest.fixture()
def kernels_on(monkeypatch):
    """The switch set, chgnet_tpu's TPU gates open and its Pallas entry
    points in interpret mode (the fixture of ``tests/test_fused_pass.py``)."""
    monkeypatch.setattr(so, "tpu_backend", lambda: True)
    monkeypatch.setenv("CHGNET_TPU_FUSED_PASS", "1")
    monkeypatch.delenv("CHGNET_TPU_NO_FUSED_PASS", raising=False)
    for name in ("_multi_gather_pallas", "_gather_pallas", "_segsum_pallas",
                 "_segsum2_pallas", "_segsum_v2_pallas", "_gather_v2_pallas"):
        monkeypatch.setattr(so, name, ft.partial(getattr(so, name), interpret=True))
    monkeypatch.setattr(
        jgproj, "_gproj_pallas", ft.partial(jgproj._gproj_pallas, interpret=True)
    )
    jax.clear_caches()
    yield
    jax.clear_caches()


def _tplan(plan) -> SegmentPlan:
    return plan.to("cpu")


def _block_diag(a, b):
    out = np.zeros((a.shape[0] + b.shape[0], a.shape[1] + b.shape[1]), np.float32)
    out[: a.shape[0], : a.shape[1]] = a
    out[a.shape[0]:, a.shape[1]:] = b
    return out


def _inputs(seed, *, message, with_w2, n_gathered=1):
    """Numpy inputs of one pass: ``n_gathered`` sorted index streams over
    tables of 2 C rows, one aligned stream, the bias, the pack (W2 as its
    two diagonal blocks) and the message's or the update's row streams."""
    rng = np.random.default_rng(seed)
    n_src, n_rows = 2 * so.C, 2 * so.BO

    def rand(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    idxs = [np.sort(rng.integers(0, n_src, n_rows)).astype(np.int32)
            for _ in range(n_gathered)]
    data = dict(
        idxs=idxs, tables=[rand(n_src, 2 * DIM) for _ in idxs],
        stream=rand(n_rows, 2 * DIM), b1=rand(2 * DIM),
        pack={k: rand(DIM) for k in tgm.LN_KEYS},
    )
    if with_w2:
        data["pack"].update(w2c=rand(DIM, DIM, scale=0.2), w2g=rand(DIM, DIM, scale=0.2),
                            b2=rand(2 * DIM))
    if message:
        mask = np.ones(n_rows, np.float32)
        mask[rng.integers(0, n_rows, 50)] = 0.0
        data["kw"] = dict(weights=rand(n_rows, DIM), mask=mask)
    else:
        data["kw"] = dict(resnet=rand(n_rows, DIM))
    return data


def _jax_side(data):
    """(tables, idxs, plans, b1, p2, kw) as chgnet_tpu takes them; the
    gathered parts first, the aligned stream last."""
    n_src = data["tables"][0].shape[0]
    plans = [jsc.make_plan(i, np.ones(i.shape[0], bool), n_src) for i in data["idxs"]]
    assert all(p.g_lo.shape[0] == i.shape[0] // so.BO
               for p, i in zip(plans, data["idxs"]))
    p2 = {k: jnp.asarray(v) for k, v in data["pack"].items() if k in tgm.LN_KEYS}
    if "w2c" in data["pack"]:
        p2["w2"] = jnp.asarray(_block_diag(data["pack"]["w2c"], data["pack"]["w2g"]))
        p2["b2"] = jnp.asarray(data["pack"]["b2"])
    tables = tuple(jnp.asarray(t) for t in (*data["tables"], data["stream"]))
    idxs = (*(jnp.asarray(i) for i in data["idxs"]), None)
    kw = {k: jnp.asarray(v) for k, v in data["kw"].items()}
    return tables, idxs, (*plans, None), jnp.asarray(data["b1"]), p2, kw


def _torch_side(data, grad=True):
    n_src = data["tables"][0].shape[0]
    plans = [_tplan(make_plan(i, np.ones(i.shape[0], bool), n_src))
             for i in data["idxs"]]

    def leaf(x):
        return torch.tensor(x, requires_grad=grad)

    tables = [leaf(t) for t in (*data["tables"], data["stream"])]
    idxs = [*(torch.tensor(i) for i in data["idxs"]), None]
    p2 = {k: leaf(v) for k, v in data["pack"].items()}
    kw = {k: torch.tensor(v) for k, v in data["kw"].items()}
    return tables, idxs, [*plans, None], leaf(data["b1"]), p2, kw


def _jax_leaves(g_tables, g_b1, g_p2, dim=DIM):
    """chgnet_tpu's gradients in the port's order: tables, b1, then the
    pack with W2's two diagonal blocks."""
    out = [*g_tables, g_b1]
    if "w2" in g_p2:
        w2 = np.asarray(g_p2["w2"])
        out += [w2[:dim, :dim], w2[dim:, dim:], g_p2["b2"]]
    out += [g_p2[k] for k in tgm.LN_KEYS]
    return [np.asarray(x) for x in out]


def _torch_wrt(tables, b1, p2):
    keys = (tgm.W2_KEYS if "w2c" in p2 else ()) + tgm.LN_KEYS
    return [*tables, b1, *(p2[k] for k in keys)]


def _assert_scaled(got, want, tol, what):
    for k, (g, w) in enumerate(zip(got, want, strict=True)):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(
            g, w, atol=tol * max(float(np.abs(w).max()), 1e-30), rtol=0,
            err_msg=f"{what} {k}",
        )


# ------------------------------------------------------------ the pass
@pytest.mark.parametrize(("message", "with_w2"), FORMS, ids=FORM_IDS)
def test_fused_layer_pass_matches_chgnet_tpu(kernels_on, message, with_w2):
    data = _inputs(11, message=message, with_w2=with_w2)
    jt, ji, jp, jb1, jp2, jkw = _jax_side(data)

    def jparts(tables_):
        return [(t, i, p) for t, i, p in zip(tables_, ji, jp)]

    def fused_loss(tables_, b1_, p2_):
        return (jfp.fused_layer_pass(jparts(tables_), b1_, p2_, **jkw) ** 2).sum()

    def ref_loss(tables_, b1_, p2_):
        return (jfp._reference_pass(
            tables_, ji, jp, b1_, p2_, jkw.get("weights"), jkw.get("mask"),
            jkw.get("resnet"),
        ) ** 2).sum()

    # chgnet_tpu's W2 is one dense [2D, 2D] parameter whose off-diagonal
    # blocks are zero; the port holds the two diagonal blocks only, so the
    # norm of the gradient counts those alone
    blocks = jnp.asarray(_block_diag(np.ones((DIM, DIM)), np.ones((DIM, DIM))))

    def gradnorm(loss):
        def f(tables_, b1_, p2_):
            g_t, g_b1, g_p2 = jax.grad(loss, argnums=(0, 1, 2))(tables_, b1_, p2_)
            if "w2" in g_p2:
                g_p2 = dict(g_p2, w2=g_p2["w2"] * blocks)
            return sum((x ** 2).sum() for x in jax.tree.leaves((g_t, g_b1, g_p2)))
        return f

    want = np.asarray(jfp.fused_layer_pass(jparts(jt), jb1, jp2, **jkw))
    want_g = _jax_leaves(*jax.grad(fused_loss, argnums=(0, 1, 2))(jt, jb1, jp2))
    want_gg = _jax_leaves(
        *jax.grad(gradnorm(ref_loss), argnums=(0, 1, 2))(jt, jb1, jp2))

    tables, idxs, plans, b1, p2, kw = _torch_side(data)
    calls = []
    orig = tfp.fused_pass_bwd
    tfp.fused_pass_bwd = lambda *a: (calls.append(1), orig(*a))[1]
    try:
        out = tfp.fused_layer_pass(list(zip(tables, idxs, plans)), b1, p2, **kw)
        np.testing.assert_allclose(out.detach().numpy(), want, atol=2e-5, rtol=0)
        wrt = _torch_wrt(tables, b1, p2)
        grads = torch.autograd.grad((out ** 2).sum(), wrt, create_graph=True)
        assert calls  # first order through the backward wrapper
        _assert_scaled(grads, want_g, 1e-4, "gradient")
        gg = torch.autograd.grad(sum((g ** 2).sum() for g in grads), wrt)
        _assert_scaled(gg, want_gg, 1e-3, "second order")
    finally:
        tfp.fused_pass_bwd = orig


@pytest.mark.parametrize(("message", "with_w2"), FORMS, ids=FORM_IDS)
def test_plain_versions_match_the_pallas_kernels(kernels_on, message, with_w2):
    """``fused_pass_fwd`` / ``fused_pass_bwd`` (their plain versions here)
    against ``_fused_pass_pallas`` / ``_pass_bwd_pallas`` with two gathered
    parts and one aligned stream. chgnet_tpu's kernels take the mask folded
    into the weights, so its ``d_weights`` is by the folded weights: times
    the mask it is the port's, and summed against the weights the port's
    ``d_mask``."""
    data = _inputs(12, message=message, with_w2=with_w2, n_gathered=2)
    jt, ji, jp, jb1, jp2, jkw = _jax_side(data)
    weights = mask = folded = None
    if message:
        weights, mask = data["kw"]["weights"], data["kw"]["mask"]
        folded = jnp.asarray(weights * mask[:, None])
    g = np.random.default_rng(13).standard_normal(
        (data["stream"].shape[0], DIM)).astype(np.float32)
    common = dict(n_aligned=1, has_w2=with_w2, has_weights=message, interpret=True)
    gathered = (jt[:2], ji[:2], tuple(p.g_lo for p in jp[:2]),
                tuple(p.g_cnt for p in jp[:2]), jt[2:], jb1, jp2, folded)
    want = np.asarray(jfp._fused_pass_pallas(
        *gathered, jkw.get("resnet"), has_resnet=not message, **common))
    outs = list(jfp._pass_bwd_pallas(*gathered, jnp.asarray(g), **common))
    d_total = np.asarray(outs.pop(0))
    d_folded = np.asarray(outs.pop(0)) if message else None
    d_b1 = np.asarray(outs.pop(0))[0]
    d_p2 = {}
    if with_w2:
        d_p2["w2"], d_p2["b2"] = outs.pop(0), outs.pop(0)[0]
    for k in tgm.LN_KEYS:
        d_p2[k] = outs.pop(0)[0]
    want_params = _jax_leaves([], d_b1, d_p2)

    tables, idxs, _, b1, p2, _ = _torch_side(data, grad=False)
    params = tgm.tail_params(p2)
    t = torch.tensor
    args = (tables[:2], idxs[:2], tables[2], b1, params)
    rows = (t(weights), t(mask), None) if message else (None, None, t(data["kw"]["resnet"]))
    got = tfp.fused_pass_fwd(*args, *rows)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    got_total, got_w, got_mask, got_params = tfp.fused_pass_bwd(
        *args, *rows[:2], t(g), message, True)
    _assert_scaled([got_total], [d_total], 1e-4, "d_total")
    # d_b1 last in the port, first in chgnet_tpu's order
    _assert_scaled([got_params[-1], *got_params[:-1]], want_params, 1e-4, "params")
    if message:
        _assert_scaled([got_w], [d_folded * mask[:, None]], 1e-4, "d_weights")
        _assert_scaled([got_mask], [(d_folded * weights).sum(-1)], 1e-4, "d_mask")
    else:
        assert got_w is None and got_mask is None


# ------------------------------------------------------------ the gate
def _spy(monkeypatch, mod, names):
    calls = {n: 0 for n in names}
    for name in names:
        orig = getattr(mod, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)
    return calls


def test_gate_selects_the_fused_wrappers(monkeypatch):
    """With the switch on and parts that qualify, the pass goes through
    ``fused_pass_fwd`` / ``fused_pass_bwd`` and not through the multi-gather
    and the tail ops; otherwise through ``_reference_pass``: the switch off,
    the kill switch on, no gathered part, or tables of two widths."""
    data = _inputs(14, message=True, with_w2=True, n_gathered=2)
    tables, idxs, plans, b1, p2, kw = _torch_side(data)
    parts = list(zip(tables, idxs, plans))
    calls = _spy(monkeypatch, tfp, (
        "fused_pass_fwd", "fused_pass_bwd", "_reference_pass", "gather_sum",
        "fused_gated_message",
    ))
    monkeypatch.setenv("CHGNET_TPU_FUSED_PASS", "1")
    monkeypatch.delenv("CHGNET_TPU_NO_FUSED_PASS", raising=False)
    out = tfp.fused_layer_pass(parts, b1, p2, **kw)
    torch.autograd.grad(out.sum(), tables)
    assert calls == dict(fused_pass_fwd=1, fused_pass_bwd=1, _reference_pass=0,
                         gather_sum=0, fused_gated_message=0)
    want = out.detach()

    def reference_runs(parts_, **env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        before = dict(calls)
        got = tfp.fused_layer_pass(parts_, b1, p2, **kw)
        assert calls["_reference_pass"] == before["_reference_pass"] + 1
        assert calls["fused_pass_fwd"] == before["fused_pass_fwd"]
        return got.detach()

    aligned_only = [(tables[2], None, None)]
    reference_runs(aligned_only)
    two_widths = [parts[0], (tables[2][:, :64].contiguous(), None, None)]
    with pytest.raises((ValueError, RuntimeError)):
        reference_runs(two_widths)  # the composition refuses them too
    got = reference_runs(parts, CHGNET_TPU_NO_FUSED_PASS="1")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)
    monkeypatch.delenv("CHGNET_TPU_NO_FUSED_PASS")
    monkeypatch.delenv("CHGNET_TPU_FUSED_PASS")
    got = reference_runs(parts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)


def test_fused_layer_pass_raises_beyond_what_the_kernels_take(monkeypatch):
    monkeypatch.setenv("CHGNET_TPU_FUSED_PASS", "1")
    data = _inputs(15, message=True, with_w2=True)
    tables, idxs, plans, b1, p2, kw = _torch_side(data, grad=False)
    gathered = (tables[0], idxs[0], plans[0])
    aligned = (tables[1], None, None)
    with pytest.raises(ValueError, match="4 gathered"):
        tfp.fused_layer_pass([gathered] * 4, b1, p2, **kw)
    with pytest.raises(ValueError, match="2 aligned"):
        tfp.fused_layer_pass([gathered, aligned, aligned], b1, p2, **kw)
    wide = [(torch.cat([t, t], dim=1), i, p) for t, i, p in (gathered, aligned)]
    with pytest.raises(ValueError, match="2D <= 128"):
        tfp.fused_layer_pass(wide, torch.cat([b1, b1]), p2, **kw)
    odd = [(t[:, :12].contiguous(), i, p) for t, i, p in (gathered, aligned)]
    with pytest.raises(ValueError, match="D % 4"):
        tfp.fused_layer_pass(odd, b1[:12], p2, **kw)
    ln_only = {k: p2[k] for k in tgm.LN_KEYS}
    with pytest.raises(ValueError, match="second layer"):
        tfp.fused_layer_pass([gathered, aligned], b1, ln_only, **kw)
    with pytest.raises(NotImplementedError, match="mask without weights"):
        tfp.fused_layer_pass([gathered, aligned], b1, p2, mask=kw["mask"])
    # three gathered parts and no aligned one, no bias, no mask: taken
    out = tfp.fused_layer_pass([gathered] * 3, None, p2, weights=kw["weights"])
    assert out.shape == (tables[1].shape[0], DIM) and bool(torch.isfinite(out).all())


def test_msg_reduce_is_off_under_the_fused_pass_switch(monkeypatch):
    plan = _tplan(make_plan(np.arange(8, dtype=np.int32), np.ones(8, bool), 8,
                            assume_sorted=True))
    monkeypatch.setenv("CHGNET_TPU_MSG_REDUCE", "1")
    monkeypatch.delenv("CHGNET_TPU_FUSED_PASS", raising=False)
    assert tgm.msg_reduce_ok(plan)
    monkeypatch.setenv("CHGNET_TPU_FUSED_PASS", "1")
    assert not tgm.msg_reduce_ok(plan)


# ------------------------------------------------------------- the fold
def test_project_parts_fold_matches_chgnet_tpu():
    rng = np.random.default_rng(16)
    widths, dim, n_e, n_a = (16, 16, 8, 16), 24, 96, 160

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    layers = [[{"w": rand(sum(widths), dim), "b": rand(dim)}] for _ in range(2)]
    idx_i = np.sort(rng.integers(0, n_e, n_a)).astype(np.int32)
    idx_j = rng.integers(0, n_e, n_a).astype(np.int32)
    tabs = [rand(n_e, widths[0]), rand(n_e, widths[1]), rand(n_a, widths[2]),
            rand(n_e, widths[3])]
    idxs = [idx_i, idx_j, None, idx_i]
    jparts = [(jnp.asarray(t), None if i is None else jnp.asarray(i), None)
              for t, i in zip(tabs, idxs)]
    tparts = [(torch.tensor(t), None if i is None else torch.tensor(i), None)
              for t, i in zip(tabs, idxs)]
    jl = [[{k: jnp.asarray(v) for k, v in lay[0].items()}] for lay in layers]
    tl = [[{k: torch.tensor(v) for k, v in lay[0].items()}] for lay in layers]
    for fold in (None, {3: 0}):
        want, want_b1 = jfn.project_parts_fold(jl[0], jl[1], jparts, fold)
        got, got_b1 = tfn.project_parts_fold(tl[0], tl[1], tparts, fold)
        assert len(got) == len(want) == (3 if fold else 4)
        np.testing.assert_allclose(got_b1.numpy(), np.asarray(want_b1), atol=0)
        for (gt, gi, _), (wt, wi, _) in zip(got, want):
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=2e-5, rtol=0)
            assert (gi is None) == (wi is None)
            if gi is not None:
                np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    with pytest.raises(ValueError, match="fold target"):
        tfn.project_parts_fold(tl[0], tl[1], tparts, {3: 7})
    with pytest.raises(ValueError, match="shape"):
        tfn.project_parts_fold(tl[0], tl[1], tparts, {2: 0})


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
def test_fused_pass_efsm_matches_chgnet_tpu(
    kernels_on, monkeypatch, kw, structs, directed
):
    kw = dict(kw, directed_bonds=directed, fused_kernels=True)
    gj, gt = _graphs(structs, kw)
    jm = JCHGNet(seed=0, **kw)
    tm = TCHGNet(seed=0, device="cpu",
                 params=jax.tree.map(np.asarray, jm.params), **kw)
    calls = _spy(monkeypatch, tfp, ("fused_pass_fwd", "fused_pass_bwd"))
    jout = j_compute_batch(jm.params, j_batch_graphs(gj), config=jm.config, **FLAGS)
    tout = t_compute_batch(
        tm.params, t_batch_graphs(gt).to("cpu"), config=tm.config, **FLAGS
    )
    n_layers = 3 * tm.config.n_conv - 3  # AtomConvs, BondConvs, AngleUpdates
    assert calls == dict(fused_pass_fwd=n_layers, fused_pass_bwd=n_layers)
    _check(jout, tout, len(gt), sum(g.n_atoms for g in gt))
