"""The undirected bond layout of the port (``directed_bonds=False``) and its
multi-gather sum against chgnet_tpu.

On the CPU :func:`gather_sum_rows` runs its plain PyTorch version;
chgnet_tpu's ``_multi_gather_pallas`` runs in Pallas interpret mode, directly
with window plans from ``build_gather_plan`` (as tests/test_gather_stream.py
runs it) and behind ``ops.scatter.gather_sum`` / ``twin_reduce`` with the
TPU gates patched open (the pattern of tests/test_gather_stream.py:144 and
tests/test_stream_pair.py:199, which edits nothing in chgnet_tpu). Inputs
come from numpy seeds and go to both.

Tolerances: the multi-gather sum is exact in f32 where the TPU kernel adds
in part order (two parts, or 128-wide rows), else 1e-6; ``gather_sum`` /
``twin_reduce`` 1e-6 forward and 1e-5 on first and second derivatives
(segment sums of a few terms in different orders); the model at the port's bars (e 2e-5 eV/atom, f 5e-5
eV/A, s 2e-4 GPa, m 2e-5 mu_B; tests/test_torch_port_model.py says why).

The kernel is held against its plain version on the card in
tests/test_torch_port_cuda.py.
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
from chgnet_tpu.ops import scatter as jsc
from chgnet_tpu.ops import stream_ops as so
from chgnet_tpu_torch.core.structure import Structure as TStructure
from chgnet_tpu_torch.graph.batching import SegmentPlan, make_plan
from chgnet_tpu_torch.graph.batching import batch_graphs as t_batch_graphs
from chgnet_tpu_torch.models import functions as tfn
from chgnet_tpu_torch.models.chgnet import CHGNet as TCHGNet
from chgnet_tpu_torch.models.chgnet import CHGNetConfig as TConfig
from chgnet_tpu_torch.models.chgnet import compute_batch as t_compute_batch
from chgnet_tpu_torch.models.chgnet import init_params as t_init_params
from chgnet_tpu_torch.ops import multi_gather as tmg

SMALL = dict(
    atom_fea_dim=16, bond_fea_dim=16, angle_fea_dim=16, num_radial=9,
    num_angular=9, n_conv=3, mlp_hidden_dims=(16,), atom_conv_hidden_dim=16,
    bond_conv_hidden_dim=16, graph_converter_algorithm="numpy",
    directed_bonds=False,
)
WIDE = dict(SMALL, atom_fea_dim=32, bond_fea_dim=32, angle_fea_dim=32,
            atom_conv_hidden_dim=32, bond_conv_hidden_dim=32, n_conv=2)
FULL = dict(graph_converter_algorithm="numpy", directed_bonds=False)
TOL = {"e": 2e-5, "f": 5e-5, "s": 2e-4, "m": 2e-5}
LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
LICOO = f"{ROOT}/examples/mp-1175469-Li9Co7O16.cif"
FLAGS = dict(compute_force=True, compute_stress=True, compute_magmom=True)


def _t(x, requires_grad=False):
    return torch.tensor(np.asarray(x), requires_grad=requires_grad)


def _tplan(idx, valid, n_out, sorted_=False) -> SegmentPlan:
    plan = make_plan(idx, valid, n_out, assume_sorted=sorted_)
    return plan.to("cpu")


def _window_local_idx(rng, S, L, window):
    """Index stream whose ``so.BO``-row blocks stay inside a window of the
    table, so that chgnet_tpu attaches gather windows and its kernel runs."""
    nb = L // so.BO
    idx = np.empty(L, np.int32)
    for b in range(nb):
        base = int(b * max(S - window, 0) / max(nb - 1, 1))
        idx[b * so.BO: (b + 1) * so.BO] = base + rng.integers(0, window, so.BO)
    return idx


# ----------------------------------------------------------- the kernel
@pytest.mark.parametrize("with_stream", [False, True], ids=["bare", "stream"])
@pytest.mark.parametrize("n_parts", [2, 3])
@pytest.mark.parametrize("d", [64, 128])
def test_gather_sum_rows_equals_pallas_interpret(d, n_parts, with_stream):
    rng = np.random.default_rng(5)
    L = 2048
    sizes = [2048, 4096, 2048][:n_parts]
    tabs = [rng.standard_normal((s, d)).astype(np.float32) for s in sizes]
    idxs = [_window_local_idx(rng, s, L, 700 + 100 * k) for k, s in enumerate(sizes)]
    stream = rng.standard_normal((L, d)).astype(np.float32) if with_stream else None
    plans = [so.build_gather_plan(i, np.ones(L, bool), s) for i, s in zip(idxs, sizes)]
    want = np.asarray(so._multi_gather_pallas(
        [jnp.asarray(t) for t in tabs], [jnp.asarray(i) for i in idxs],
        [jnp.asarray(p[0]) for p in plans], [jnp.asarray(p[1]) for p in plans],
        None if stream is None else jnp.asarray(stream),
        has_stream=with_stream, interpret=True,
    ))
    got = tmg.gather_sum_rows(
        [_t(t) for t in tabs], [_t(i) for i in idxs],
        None if stream is None else _t(stream),
    )
    # The TPU kernel packs two 64-wide rows into one 128-lane row and keeps
    # a sum per slot, so with three parts it adds the even-indexed rows and
    # the odd-indexed rows apart: another order than the parts', equal to one
    # rounding (the bar of tests/test_gather_stream.py). With two parts, or
    # at 128 lanes, its order is the parts' and the results are equal bits.
    atol = 1e-6 if (d, n_parts) == (64, 3) else 0
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_gather_sum_rows_adds_zero_for_out_of_range_rows():
    a = torch.arange(8.0).reshape(2, 4)
    b = torch.ones(3, 4)
    out = tmg.gather_sum_rows(
        [a, b], [torch.tensor([1, 2, -1], dtype=torch.int32),
                 torch.tensor([0, 3, 2], dtype=torch.int32)],
        torch.full((3, 4), 10.0),
    )
    np.testing.assert_array_equal(
        out.numpy(), [[15, 16, 17, 18], [10] * 4, [11] * 4]
    )


# -------------------------------------------------------- the autograd ops
@pytest.fixture()
def interp(monkeypatch):
    """chgnet_tpu's TPU gates open, its Pallas entry points in interpret
    mode."""
    monkeypatch.setattr(so, "tpu_backend", lambda: True)
    for name in ("_multi_gather_pallas", "_gather_pallas", "_segsum_pallas",
                 "_segsum2_pallas"):
        monkeypatch.setattr(so, name, ft.partial(getattr(so, name), interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _plain_multi(srcs, idxs, los, cnts, stream=None, *, has_stream=False, **_):
    acc = sum(s[i] for s, i in zip(srcs, idxs))
    return acc + stream if has_stream else acc


def _gather_sum_case(seed=7):
    rng = np.random.default_rng(seed)
    d, L = 64, 2048
    sizes = (2048, 1024, 2048)  # AtomConv's shape: a table gathered twice
    t1, t2 = (rng.standard_normal((s, d)).astype(np.float32) for s in sizes[:2])
    stream = rng.standard_normal((L, d)).astype(np.float32)
    idxs = [_window_local_idx(rng, s, L, 600 + 100 * k) for k, s in enumerate(sizes)]
    return t1, t2, stream, idxs, sizes


def _jax_gather_sum_loss(idxs, sizes):
    valid = np.ones(idxs[0].shape[0], bool)
    plans = [jsc.make_plan(i, valid, s) for i, s in zip(idxs, sizes)]
    assert all(p.g_lo.shape[0] for p in plans), "chgnet_tpu must take its kernel"

    def loss(t1, t2, stream):
        out = jsc.gather_sum([
            (t1, jnp.asarray(idxs[0]), plans[0]),
            (t2, jnp.asarray(idxs[1]), plans[1]),
            (stream, None, None),
            (t1, jnp.asarray(idxs[2]), plans[2]),
        ])
        return (jnp.sin(out) * out).sum(), out

    return loss


def _torch_gather_sum_loss(idxs, sizes):
    valid = np.ones(idxs[0].shape[0], bool)
    plans = [_tplan(i, valid, s) for i, s in zip(idxs, sizes)]

    def loss(t1, t2, stream):
        out = tmg.gather_sum([
            (t1, _t(idxs[0]), plans[0]), (t2, _t(idxs[1]), plans[1]),
            (stream, None, None), (t1, _t(idxs[2]), plans[2]),
        ])
        return (torch.sin(out) * out).sum(), out

    return loss


def test_gather_sum_value_and_gradient_match_jax_kernel(interp):
    t1, t2, stream, idxs, sizes = _gather_sum_case()
    jloss = _jax_gather_sum_loss(idxs, sizes)
    (_, j_out), j_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(stream)
    )
    leaves = [_t(x, True) for x in (t1, t2, stream)]
    val, out = _torch_gather_sum_loss(idxs, sizes)(*leaves)
    grads = torch.autograd.grad(val, leaves)
    np.testing.assert_allclose(out.detach().numpy(), j_out, atol=1e-6)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_gather_sum_second_order_matches_jax(interp, monkeypatch):
    """Grad of grad through the ops' backward rules. Pallas interpret mode
    cannot differentiate its prefetch-grid kernels twice, so on the JAX side
    the multi-gather kernel is stood in for by its definition, as
    tests/test_gather_stream.py does: the custom_vjp structure is what is
    compared."""
    monkeypatch.setattr(so, "_multi_gather_pallas", _plain_multi)
    t1, t2, stream, idxs, sizes = _gather_sum_case(8)
    jloss = _jax_gather_sum_loss(idxs, sizes)

    def j_outer(t1_, t2_):
        g = jax.grad(lambda *a: jloss(*a)[0], argnums=2)(t1_, t2_, jnp.asarray(stream))
        return (g ** 2).sum()

    j_gg = jax.grad(j_outer, argnums=(0, 1))(jnp.asarray(t1), jnp.asarray(t2))
    leaves = [_t(x, True) for x in (t1, t2, stream)]
    val, _ = _torch_gather_sum_loss(idxs, sizes)(*leaves)
    (g,) = torch.autograd.grad(val, leaves[2], create_graph=True)
    gg = torch.autograd.grad((g ** 2).sum(), leaves[:2])
    for got, want in zip(gg, j_gg):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("d", [8, 64], ids=["gathers", "kernel"])
def test_twin_reduce_matches_jax_and_backward_is_d2u_gather(d):
    """Bond u owns the directed edges (2u, 2u + 1), as tests/test_stream_pair.py
    builds them; d = 8 is narrower than a float4 row on neither side, d = 64
    the model's width."""
    rng = np.random.default_rng(2)
    n_und = 300
    u2d = (2 * np.arange(n_und)).astype(np.int32)
    und2 = u2d + 1
    d2u = np.repeat(np.arange(n_und), 2).astype(np.int32)
    partial = rng.standard_normal((2 * n_und, d)).astype(np.float32)
    v = rng.standard_normal((n_und, d)).astype(np.float32)

    def jf(p):
        out = jsc.twin_reduce(
            p, jnp.asarray(u2d), jnp.asarray(und2), jnp.asarray(d2u),
            None, None, None,
        )
        return (out ** 2 * v).sum()

    j_g = jax.grad(jf)(jnp.asarray(partial))
    j_h = jax.grad(lambda p: (jax.grad(jf)(p) ** 2).sum())(jnp.asarray(partial))

    plan_d2u = _tplan(d2u, np.ones(2 * n_und, bool), n_und, True)
    pt = _t(partial, True)
    out = tmg.twin_reduce(pt, _t(u2d), _t(und2), _t(d2u), plan_d2u)
    np.testing.assert_allclose(
        out.detach().numpy(), partial[u2d] + partial[und2], atol=0
    )
    ct = _t(rng.standard_normal((n_und, d)).astype(np.float32))
    (back,) = torch.autograd.grad(out, pt, ct, retain_graph=True)
    np.testing.assert_array_equal(back.numpy(), ct.numpy()[d2u])
    (g,) = torch.autograd.grad((out ** 2 * _t(v)).sum(), pt, create_graph=True)
    (h,) = torch.autograd.grad((g ** 2).sum(), pt)
    np.testing.assert_allclose(g.detach().numpy(), j_g, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), j_h, atol=1e-5, rtol=1e-5)


def test_twin_reduce_equals_gather_sum_over_the_batch_plans():
    """On a real batch, twin_reduce and the generic gather_sum over
    (u2d, plan_u2d) and (und_second, plan_u2d2) agree in value, and in
    gradient on the valid edges (padded edges differ, and are masked)."""
    tm = TCHGNet(seed=0, device="cpu", **SMALL)
    graph = tm.graph_converter(TStructure.from_file(LIMNO2))
    b = t_batch_graphs([graph]).to("cpu")
    rng = np.random.default_rng(3)
    partial = rng.standard_normal((b.twin.shape[0], 16)).astype(np.float32)
    ct = _t(rng.standard_normal((b.und_mask.shape[0], 16)).astype(np.float32))
    ct = ct * b.und_mask[:, None]
    res = []
    for twin in (True, False):
        p = _t(partial, True)
        if twin:
            out = tmg.twin_reduce(
                p, b.undirected2directed, b.und_second, b.directed2undirected,
                b.plan_d2u,
            )
        else:
            out = tmg.gather_sum([
                (p, b.undirected2directed, b.plan_u2d),
                (p, b.und_second, b.plan_u2d2),
            ])
        (g,) = torch.autograd.grad(out, p, ct)
        res.append((out.detach(), g * b.edge_mask[:, None]))
    torch.testing.assert_close(res[0][0], res[1][0], atol=0, rtol=0)
    torch.testing.assert_close(res[0][1], res[1][1], atol=0, rtol=0)


# ------------------------------------------------- the first-layer choice
def test_first_layer_acc_takes_the_multi_gather_for_tables_of_two_shapes(monkeypatch):
    """AtomConv's parts in the undirected layout (atoms [N], bonds [U], atoms
    [N]) go project-then-gather through gather_sum_rows, the directed
    layout's (one table shape) through gather-project-sum; both equal the
    concatenated Linear."""
    rng = np.random.default_rng(4)
    n_atoms, n_und, n_edges, d = 50, 200, 400, 16
    layers = [
        [{"w": _t(rng.standard_normal((3 * d, 2 * d)).astype(np.float32) * 0.1),
          "b": _t(rng.standard_normal(2 * d).astype(np.float32))}]
        for _ in range(2)
    ]
    atoms = _t(rng.standard_normal((n_atoms, d)).astype(np.float32))
    bonds = _t(rng.standard_normal((n_und, d)).astype(np.float32))
    center = np.sort(rng.integers(0, n_atoms, n_edges)).astype(np.int32)
    nbr = rng.integers(0, n_atoms, n_edges).astype(np.int32)
    d2u = rng.integers(0, n_und, n_edges).astype(np.int32)
    valid = np.ones(n_edges, bool)
    calls = []
    for mod, name in ((tmg, "gather_sum_rows"), (tfn, "gather_project_sum")):
        orig = getattr(mod, name)
        monkeypatch.setattr(
            mod, name,
            lambda *a, _o=orig, _n=name, **k: (calls.append(_n), _o(*a, **k))[1],
        )
    first_w = torch.cat([layers[0][0]["w"], layers[1][0]["w"]], dim=1)
    b1 = torch.cat([layers[0][0]["b"], layers[1][0]["b"]])
    for bond_part, bond_rows, route in (
        ((bonds, _t(d2u), _tplan(d2u, valid, n_und)), bonds[_t(d2u).long()],
         "gather_sum_rows"),
        ((bonds[_t(d2u).long()], None, None), bonds[_t(d2u).long()],
         "gather_project_sum"),
    ):
        calls.clear()
        acc = tfn.first_layer_acc(*layers, [
            (atoms, _t(center), _tplan(center, valid, n_atoms, True)),
            bond_part,
            (atoms, _t(nbr), _tplan(nbr, valid, n_atoms)),
        ])
        assert calls == [route]
        want = torch.cat(
            [atoms[_t(center).long()], bond_rows, atoms[_t(nbr).long()]], dim=1
        ) @ first_w + b1
        torch.testing.assert_close(acc, want, atol=2e-5, rtol=0)


def test_first_layer_acc_angle_side_with_unequal_widths():
    """The angle side with atom and bond tables of different widths: every
    table is projected first and the three gathers go through gather_sum."""
    rng = np.random.default_rng(6)
    n_edges, n_ang, d_b, d_a, k = 60, 300, 8, 12, 16
    layers = [
        [{"w": _t(rng.standard_normal((2 * d_b + d_a, k)).astype(np.float32))}]
        for _ in range(2)
    ]
    bond_dir = _t(rng.standard_normal((n_edges, d_b)).astype(np.float32))
    atom_e = _t(rng.standard_normal((n_edges, d_a)).astype(np.float32))
    di = np.sort(rng.integers(0, n_edges, n_ang)).astype(np.int32)
    dj = rng.integers(0, n_edges, n_ang).astype(np.int32)
    valid = np.ones(n_ang, bool)
    p_i, p_j = _tplan(di, valid, n_edges, True), _tplan(dj, valid, n_edges)
    parts = [(bond_dir, _t(di), p_i), (bond_dir, _t(dj), p_j), (atom_e, _t(di), p_i)]
    projected, b1 = tfn.project_parts(*layers, parts)
    assert b1 is None
    assert [p is q for (_, _, p), q in zip(projected, (p_i, p_j, p_i))] == [True] * 3
    assert [tuple(t.shape) for t, _, _ in projected] == [(n_edges, 2 * k)] * 3
    acc = tfn.first_layer_acc(*layers, parts)
    first_w = torch.cat([layers[0][0]["w"], layers[1][0]["w"]], dim=1)
    want = torch.cat(
        [bond_dir[_t(di).long()], bond_dir[_t(dj).long()], atom_e[_t(di).long()]],
        dim=1,
    ) @ first_w
    torch.testing.assert_close(acc, want, atol=2e-5, rtol=0)


def test_gather_sum_raises_on_more_than_four_gathered_parts():
    rng = np.random.default_rng(7)
    table = _t(rng.standard_normal((20, 8)).astype(np.float32))
    idx = rng.integers(0, 20, 50).astype(np.int32)
    part = (table, _t(idx), _tplan(idx, np.ones(50, bool), 20))
    assert tmg.gather_sum([part] * 4).shape == (50, 8)
    with pytest.raises(ValueError, match="1..4 parts"):
        tmg.gather_sum([part] * 5)


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


ONE = [(LIMNO2, None)]
THREE = [(LIMNO2, 1), (LICOO, 2), (LIMNO2, 3)]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize(
    "kw,structs",
    [(SMALL, ONE), (SMALL, THREE), (WIDE, THREE), (FULL, ONE)],
    ids=["small-1", "small-3", "wide-3", "full-1"],
)
def test_undirected_efsm_matches_chgnet_tpu(kw, structs, fused):
    kw = dict(kw, fused_kernels=fused)
    gj, gt = _graphs(structs, kw)
    jm = JCHGNet(seed=0, **kw)
    tm = TCHGNet(seed=0, device="cpu",
                 params=jax.tree.map(np.asarray, jm.params), **kw)
    assert not tm.config.directed_bonds
    jout = j_compute_batch(jm.params, j_batch_graphs(gj), config=jm.config, **FLAGS)
    tout = t_compute_batch(
        tm.params, t_batch_graphs(gt).to("cpu"), config=tm.config, **FLAGS
    )
    _check(jout, tout, len(gt), sum(g.n_atoms for g in gt))


@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
@pytest.mark.parametrize(
    "kw,structs", [(SMALL, THREE), (FULL, ONE)], ids=["small-3", "full-1"]
)
def test_msg_reduce_switch_computes_the_same_function(
    monkeypatch, kw, structs, directed
):
    """With CHGNET_TPU_MSG_REDUCE set, the message layers take the fused
    tail-plus-segment-sum op (its plain version here), in both layouts, and
    the result equals the port's own without the switch; the kill switch
    turns it off again."""
    from chgnet_tpu_torch.ops import gated_message as tgm

    kw = dict(kw, directed_bonds=directed, fused_kernels=True)
    _, gt = _graphs(structs, kw)
    tm = TCHGNet(seed=0, device="cpu", **kw)
    batch = t_batch_graphs(gt).to("cpu")
    calls = []
    orig = tgm.gated_message_reduce
    monkeypatch.setattr(
        tgm, "gated_message_reduce",
        lambda *a: (calls.append(1), orig(*a))[1],
    )
    monkeypatch.delenv("CHGNET_TPU_MSG_REDUCE", raising=False)
    monkeypatch.delenv("CHGNET_TPU_NO_MSG_REDUCE", raising=False)
    want = t_compute_batch(tm.params, batch, config=tm.config, **FLAGS)
    assert not calls
    monkeypatch.setenv("CHGNET_TPU_MSG_REDUCE", "1")
    got = t_compute_batch(tm.params, batch, config=tm.config, **FLAGS)
    assert len(calls) == 2 * tm.config.n_conv - 1  # AtomConvs + BondConvs
    _check(want, got, len(gt), sum(g.n_atoms for g in gt))
    calls.clear()
    monkeypatch.setenv("CHGNET_TPU_NO_MSG_REDUCE", "1")
    t_compute_batch(tm.params, batch, config=tm.config, **FLAGS)
    assert not calls


@pytest.mark.parametrize("kw", [SMALL, FULL], ids=["small", "full"])
def test_one_parameter_tree_serves_both_layouts(kw):
    trees = [
        t_init_params(TConfig(**dict(kw, directed_bonds=directed)), seed=0)
        for directed in (True, False)
    ]

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, np.asarray(tree)

    a, b = (dict(leaves(t)) for t in trees)
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    jm = JCHGNet(seed=0, **dict(kw, directed_bonds=False))
    assert sorted(dict(leaves(jax.tree.map(np.asarray, jm.params)))) == sorted(a)
