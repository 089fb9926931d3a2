"""The port's fused gated tails against chgnet_tpu's Pallas kernels.

On the CPU each wrapper of ``chgnet_tpu_torch/ops/gated_message.py`` runs
its plain PyTorch version. ``chgnet_tpu``'s four Pallas functions run in
interpret mode: ``_forward``, ``_backward``, ``_forward_nw`` and
``_backward_nw`` with ``interpret=True``, and the ``custom_vjp`` ops through
``fused_gated_message`` / ``fused_gated_update`` with ``use_pallas=True``
(interpret mode off the TPU). Inputs come from a numpy seed: 2,500 rows, no
multiple of any tile, and about 10% of mask zeros.

Tolerances, as tests/test_ops.py: forward 1e-5 absolute; gradients, first
and second order, 1e-4 absolute and 1e-5 relative (64-term f32 products
and 2,500-row parameter sums taken in different orders).

The fifth, ``_reduce_pallas`` behind ``fused_gated_message_reduce`` (the
tail fused with its sorted segment sum), runs in interpret mode with
``CHGNET_TPU_MSG_REDUCE`` set and the TPU gate patched open, on the inputs
of tests/test_msg_reduce.py (masked rows whose keys stay in range, dropped
rows) and at that file's bars: forward 3e-5, gradients 5e-4, second order
1e-3.

The kernels are held against these plain versions on the card in
tests/test_torch_port_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chgnet_tpu.models import functions as jfn
from chgnet_tpu.ops import gated_message as jgm
from chgnet_tpu.ops import scatter as jsc
from chgnet_tpu.ops import stream_ops as jso
from chgnet_tpu_torch.graph.batching import SegmentPlan, make_plan
from chgnet_tpu_torch.models import functions as tfn
from chgnet_tpu_torch.models.convert import params_from_jax
from chgnet_tpu_torch.ops import gated_message as tgm

L, D = 2500, 64
FWD_ATOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-5)
LN = tgm.LN_KEYS


def _data(seed=0):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(
        acc=normal(L, 2 * D),
        weights=normal(L, D),
        mask=(rng.random(L) < 0.9).astype(np.float32),
        resnet=normal(L, D),
        g=normal(L, D),
        w2c=normal(D, D, scale=0.1),
        w2g=normal(D, D, scale=0.1),
        b2=normal(2 * D, scale=0.1),
        nc_scale=normal(D),
        nc_bias=normal(D, scale=0.1),
        ng_scale=normal(D),
        ng_bias=normal(D, scale=0.1),
    )


def _jp2(x, has_w2=True):
    """chgnet_tpu's lane-packed p2: block-diagonal w2."""
    p2 = {k: x[k] for k in LN}
    if has_w2:
        w2 = np.zeros((2 * D, 2 * D), np.float32)
        w2[:D, :D], w2[D:, D:] = x["w2c"], x["w2g"]
        p2["w2"], p2["b2"] = w2, x["b2"]
    return p2


def _tp2(x, has_w2=True, requires_grad=False):
    keys = (tgm.W2_KEYS if has_w2 else ()) + LN
    return {k: torch.tensor(x[k], requires_grad=requires_grad) for k in keys}


def _jparams_like_port(jp2, has_w2=True):
    """chgnet_tpu's parameter pytree (or its gradient) in the port's order,
    w2 cut to its two diagonal blocks."""
    out = []
    if has_w2:
        out += [jp2["w2"][:D, :D], jp2["w2"][D:, D:], jp2["b2"]]
    return out + [jp2[k] for k in LN]


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def test_message_forward_matches_pallas_interpret():
    x = _data()
    want = jgm._forward(
        x["acc"], x["weights"], x["mask"], _jp2(x), interpret=True
    )
    got = tgm.gated_message_fwd(
        torch.tensor(x["acc"]), torch.tensor(x["weights"]),
        torch.tensor(x["mask"]), tgm.tail_params(_tp2(x)),
    )
    assert got.shape == (L, D)
    _close(got, want, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize(
    "need_mask,need_params", [(True, True), (False, False)],
    ids=["all", "serving"],
)
def test_message_backward_matches_pallas_interpret(need_mask, need_params):
    x = _data(1)
    j_acc, j_w, j_mask, j_p = jgm._backward(
        x["acc"], x["weights"], x["mask"], _jp2(x), x["g"], interpret=True
    )
    d_acc, d_w, d_mask, d_p = tgm.gated_message_bwd(
        torch.tensor(x["acc"]), torch.tensor(x["weights"]),
        torch.tensor(x["mask"]), tgm.tail_params(_tp2(x)),
        torch.tensor(x["g"]), need_mask, need_params,
    )
    _close(d_acc, j_acc, **GRAD_TOL)
    _close(d_w, j_w, **GRAD_TOL)
    if not need_mask:
        assert d_mask is None and d_p is None
        return
    _close(d_mask, j_mask, **GRAD_TOL)
    for got, want in zip(d_p, _jparams_like_port(j_p), strict=True):
        _close(got, want, **GRAD_TOL)


@pytest.mark.parametrize("has_w2", [False, True], ids=["y=acc", "w2"])
def test_update_forward_matches_pallas_interpret(has_w2):
    x = _data(2)
    want = jgm._forward_nw(
        x["acc"], x["resnet"], _jp2(x, has_w2), interpret=True
    )
    got = tgm.gated_update_fwd(
        torch.tensor(x["acc"]), torch.tensor(x["resnet"]),
        tgm.tail_params(_tp2(x, has_w2)),
    )
    _close(got, want, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("need_params", [True, False], ids=["params", "serving"])
@pytest.mark.parametrize("has_w2", [False, True], ids=["y=acc", "w2"])
def test_update_backward_matches_pallas_interpret(has_w2, need_params):
    x = _data(3)
    j_acc, j_p = jgm._backward_nw(
        x["acc"], _jp2(x, has_w2), x["g"], interpret=True
    )
    d_acc, d_p = tgm.gated_update_bwd(
        torch.tensor(x["acc"]), tgm.tail_params(_tp2(x, has_w2)),
        torch.tensor(x["g"]), need_params,
    )
    _close(d_acc, j_acc, **GRAD_TOL)
    if not need_params:
        assert d_p is None
        return
    for got, want in zip(d_p, _jparams_like_port(j_p, has_w2), strict=True):
        _close(got, want, **GRAD_TOL)


def _orders(j_fn, t_fn, x, args, has_w2):
    """First- and second-order gradients of ``sum(f * v)`` through the
    ``custom_vjp`` (JAX) and the autograd ops (port), by every input.
    ``args`` names the row inputs; the tail parameters come last. The
    cotangents have scale 0.1, so that the parameters' 2,500-row sums stay
    O(1-10) in both orders."""
    rng = np.random.default_rng(11)
    v = (0.1 * rng.normal(size=(L, D))).astype(np.float32)
    jp = _jp2(x, has_w2)
    jargs = [x[a] for a in args]
    n = len(args)

    def jloss(*a):
        return jnp.sum(j_fn(*a) * v)

    jg1 = jax.grad(jloss, argnums=tuple(range(n + 1)))(*jargs, jp)
    # second-order cotangents, zero on w2's off-diagonal blocks
    us = [(0.1 * rng.normal(size=np.shape(a))).astype(np.float32) for a in jargs]
    up = {k: (0.1 * rng.normal(size=np.shape(val))).astype(np.float32)
          for k, val in jp.items()}
    if has_w2:
        up["w2"][:D, D:] = 0
        up["w2"][D:, :D] = 0

    def jsecond(*a):
        grads = jax.grad(jloss, argnums=tuple(range(n + 1)))(*a)
        total = sum(jnp.sum(gr * u) for gr, u in zip(grads[:n], us))
        return total + sum(jnp.sum(grads[n][k] * up[k]) for k in up)

    jg2 = jax.grad(jsecond, argnums=tuple(range(n + 1)))(*jargs, jp)

    targs = [torch.tensor(x[a], requires_grad=True) for a in args]
    tp = _tp2(x, has_w2, requires_grad=True)
    leaves = [*targs, *tgm.tail_params(tp)]
    loss = (t_fn(*targs, tp) * torch.tensor(v)).sum()
    tg1 = torch.autograd.grad(loss, leaves, create_graph=True)
    tus = [torch.tensor(u) for u in us]
    tus += [torch.tensor(u) for u in _jparams_like_port(up, has_w2)]
    second = sum((gr * u).sum() for gr, u in zip(tg1, tus))
    # the update's d_resnet is the cotangent itself: no second order
    tg2 = [
        torch.zeros_like(x) if gr is None else gr
        for x, gr in zip(leaves, torch.autograd.grad(second, leaves, allow_unused=True))
    ]
    for jg, tg in ((jg1, tg1), (jg2, tg2)):
        want = [*jg[:n], *_jparams_like_port(jg[n], has_w2)]
        assert len(want) == len(tg)
        for got, w in zip(tg, want):
            _close(got, w, **GRAD_TOL)


def test_fused_message_first_and_second_order_match_custom_vjp():
    _orders(
        lambda a, w, m, p: jgm.fused_gated_message(a, w, m, p, use_pallas=True),
        tgm.fused_gated_message,
        _data(4), ("acc", "weights", "mask"), has_w2=True,
    )


@pytest.mark.parametrize("has_w2", [False, True], ids=["y=acc", "w2"])
def test_fused_update_first_and_second_order_match_custom_vjp(has_w2):
    _orders(
        lambda a, r, p: jgm.fused_gated_update(a, r, p, use_pallas=True),
        tgm.fused_gated_update,
        _data(5), ("acc", "resnet"), has_w2=has_w2,
    )


def test_serving_backward_asks_for_no_mask_or_parameter_grads(monkeypatch):
    """Differentiating only by the streams (as compute_batch does, by
    positions) calls the backward kernels without d_mask or parameter
    gradients."""
    seen = []
    for name in ("gated_message_bwd", "gated_update_bwd"):
        orig = getattr(tgm, name)

        def rec(*args, _orig=orig, _name=name):
            seen.append((_name, args[-2:] if _name == "gated_message_bwd"
                         else args[-1:]))
            return _orig(*args)

        monkeypatch.setattr(tgm, name, rec)
    x = _data(6)
    acc = torch.tensor(x["acc"], requires_grad=True)
    w = torch.tensor(x["weights"], requires_grad=True)
    msg = tgm.fused_gated_message(acc, w, torch.tensor(x["mask"]), _tp2(x))
    upd = tgm.fused_gated_update(acc, torch.tensor(x["resnet"]), _tp2(x, False))
    torch.autograd.grad((msg * upd).sum(), [acc, w])
    assert sorted(seen) == [
        ("gated_message_bwd", (False, False)), ("gated_update_bwd", (False,)),
    ]


def _gmlp(n_layers, seed=0, norm="layer"):
    rng = np.random.default_rng(seed)
    hidden = D if n_layers == 2 else 0
    return jfn.gated_mlp_init(rng, 3 * D, D, hidden_dim=hidden, norm=norm)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_fused_pack_matches_chgnet_tpu_leaf_by_leaf(n_layers):
    tree = _gmlp(n_layers, seed=n_layers)
    want = jfn.gated_mlp_fused_pack(tree)
    got = tfn.gated_mlp_fused_pack(params_from_jax(tree))
    assert set(got) == ({"w2c", "w2g", "b2"} if n_layers == 2 else set()) | set(LN)
    if n_layers == 2:
        w2 = np.asarray(want["w2"])
        np.testing.assert_array_equal(w2[:D, D:], 0)
        np.testing.assert_array_equal(w2[D:, :D], 0)
        np.testing.assert_array_equal(got["w2c"].numpy(), w2[:D, :D])
        np.testing.assert_array_equal(got["w2g"].numpy(), w2[D:, D:])
    for k in set(got) - {"w2c", "w2g"}:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


@pytest.mark.parametrize(
    "n_layers,norm,act",
    [(2, "layer", "silu"), (1, "layer", "silu"), (2, "batch", "silu"),
     (2, None, "silu"), (2, "layer", "tanh"), (3, "layer", "silu")],
)
def test_fusable_predicates_match_chgnet_tpu(n_layers, norm, act):
    rng = np.random.default_rng(0)
    hidden = {1: 0, 2: D, 3: (D, D)}[n_layers]
    tree = jfn.gated_mlp_init(rng, 3 * D, D, hidden_dim=hidden, norm=norm)
    port = params_from_jax(tree)
    assert tfn.gated_mlp_fusable(port, act) == jfn.gated_mlp_fusable(tree, act)
    assert tfn.gated_mlp_update_fusable(port, act) == (
        jfn.gated_mlp_update_fusable(tree, act)
    )


# ---------------------------------------------- message tail + segment sum
@pytest.fixture()
def reduce_gates(monkeypatch):
    """chgnet_tpu's opt-in switch and TPU gate open, its stream kernels in
    interpret mode (the fixture of tests/test_msg_reduce.py)."""
    import functools as ft

    monkeypatch.setenv("CHGNET_TPU_MSG_REDUCE", "1")
    monkeypatch.delenv("CHGNET_TPU_NO_MSG_REDUCE", raising=False)
    monkeypatch.setattr(jso, "tpu_backend", lambda: True)
    for name in ("_multi_gather_pallas", "_gather_pallas", "_segsum_pallas",
                 "_segsum2_pallas"):
        monkeypatch.setattr(jso, name, ft.partial(getattr(jso, name), interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _reduce_case(n_rows=2048, n_out=1024, seed=0):
    """``_setup`` of tests/test_msg_reduce.py: a sorted key stream with
    dropped rows at the tail and rows whose mask is zero while their key
    stays in range."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n_out, n_rows)).astype(np.int32)
    mask = (rng.random(n_rows) > 0.1).astype(np.float32)
    drop = (rng.random(n_rows) > 0.5) & (mask == 0)
    dst = np.where(drop, n_out, dst).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    dst, mask = dst[order], mask[order]
    assert ((mask == 0) & (dst < n_out)).any()
    x = dict(
        acc=rng.standard_normal((n_rows, 2 * D)).astype(np.float32),
        weights=rng.standard_normal((n_rows, D)).astype(np.float32),
        mask=mask,
        w2c=(rng.standard_normal((D, D)) * 0.1).astype(np.float32),
        w2g=(rng.standard_normal((D, D)) * 0.1).astype(np.float32),
        b2=(rng.standard_normal(2 * D) * 0.1).astype(np.float32),
        nc_scale=np.ones(D, np.float32), nc_bias=np.zeros(D, np.float32),
        ng_scale=np.ones(D, np.float32), ng_bias=np.zeros(D, np.float32),
    )
    jplan = jsc.make_plan(dst, dst < n_out, n_out, assume_sorted=True)
    tplan = make_plan(dst, dst < n_out, n_out, assume_sorted=True).to("cpu")
    return x, jplan, tplan, n_out


def test_message_reduce_forward_matches_pallas_interpret(reduce_gates):
    x, jplan, tplan, n_out = _reduce_case()
    assert jgm.msg_reduce_ok(jnp.asarray(x["acc"]), jplan, n_out)
    want = jgm.fused_gated_message_reduce(
        jnp.asarray(x["acc"]), jnp.asarray(x["weights"]), jnp.asarray(x["mask"]),
        {k: jnp.asarray(v) for k, v in _jp2(x).items()}, jplan, n_out,
    )
    got = tgm.gated_message_reduce(
        torch.tensor(x["acc"]), torch.tensor(x["weights"]),
        torch.tensor(x["mask"]), tgm.tail_params(_tp2(x)), tplan.offsets,
    )
    assert got.shape == (n_out, D)
    _close(got, want, atol=3e-5, rtol=3e-5)
    # the mask multiplies inside the sum: what a masked row holds is ignored
    acc = torch.tensor(x["acc"])
    acc[torch.tensor(x["mask"]) == 0] = 50.0
    again = tgm.gated_message_reduce(
        acc, torch.tensor(x["weights"]), torch.tensor(x["mask"]),
        tgm.tail_params(_tp2(x)), tplan.offsets,
    )
    assert torch.equal(again, got)


def test_message_reduce_gradients_match_custom_vjp(reduce_gates):
    x, jplan, tplan, n_out = _reduce_case(1024, 512)
    ct = np.random.default_rng(1).standard_normal((n_out, D)).astype(np.float32)

    def jloss(a, w, p):
        out = jgm.fused_gated_message_reduce(
            a, w, jnp.asarray(x["mask"]), p, jplan, n_out
        )
        return jnp.sum(out * ct)

    jp = {k: jnp.asarray(v) for k, v in _jp2(x).items()}
    j_acc, j_w, j_p = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x["acc"]), jnp.asarray(x["weights"]), jp
    )
    acc = torch.tensor(x["acc"], requires_grad=True)
    w = torch.tensor(x["weights"], requires_grad=True)
    tp = _tp2(x, requires_grad=True)
    out = tgm.fused_gated_message_reduce(acc, w, torch.tensor(x["mask"]), tp, tplan)
    leaves = [acc, w, *tgm.tail_params(tp)]
    grads = torch.autograd.grad((out * torch.tensor(ct)).sum(), leaves)
    want = [j_acc, j_w, *_jparams_like_port(j_p)]
    for got, wnt in zip(grads, want, strict=True):
        _close(got, wnt, atol=5e-4, rtol=5e-4)


def test_message_reduce_second_order_matches_custom_vjp(reduce_gates):
    x, jplan, tplan, n_out = _reduce_case(1024, 512)
    jp = {k: jnp.asarray(v) for k, v in _jp2(x).items()}

    def j_energy(a):
        out = jgm.fused_gated_message_reduce(
            a, jnp.asarray(x["weights"]), jnp.asarray(x["mask"]), jp, jplan, n_out
        )
        return jnp.sum(jnp.tanh(out))

    want = jax.grad(lambda a: jnp.sum(jax.grad(j_energy)(a) ** 2))(
        jnp.asarray(x["acc"])
    )
    acc = torch.tensor(x["acc"], requires_grad=True)
    out = tgm.fused_gated_message_reduce(
        acc, torch.tensor(x["weights"]), torch.tensor(x["mask"]), _tp2(x), tplan
    )
    (g,) = torch.autograd.grad(torch.tanh(out).sum(), acc, create_graph=True)
    (gg,) = torch.autograd.grad((g ** 2).sum(), acc)
    _close(gg, want, atol=1e-3, rtol=1e-3)


def test_message_reduce_needs_a_sorted_plan_and_reads_the_switch(monkeypatch):
    x, _, tplan, _ = _reduce_case(256, 64)
    monkeypatch.delenv("CHGNET_TPU_MSG_REDUCE", raising=False)
    monkeypatch.delenv("CHGNET_TPU_NO_MSG_REDUCE", raising=False)
    assert not tgm.msg_reduce_ok(tplan)
    monkeypatch.setenv("CHGNET_TPU_MSG_REDUCE", "1")
    assert tgm.msg_reduce_ok(tplan)
    permuted = SegmentPlan(tplan.key, torch.arange(256, dtype=torch.int32), tplan.offsets)
    assert not tgm.msg_reduce_ok(permuted)
    monkeypatch.setenv("CHGNET_TPU_NO_MSG_REDUCE", "1")
    assert not tgm.msg_reduce_ok(tplan)
    args = (torch.tensor(x["acc"]), torch.tensor(x["weights"]), torch.tensor(x["mask"]))
    with pytest.raises(ValueError, match="sorted keys"):
        tgm.fused_gated_message_reduce(*args, _tp2(x), permuted)
    with pytest.raises(ValueError, match="second layer"):
        tgm.fused_gated_message_reduce(*args, _tp2(x, False), tplan)
