"""The port's four kernel ops (chgnet_tpu_torch/ops) against chgnet_tpu's.

On the CPU each port wrapper runs its plain PyTorch version; chgnet_tpu's
ops run their Pallas TPU kernels in interpret mode (the monkeypatch pattern
of tests/test_gproj.py, which edits nothing in chgnet_tpu). Inputs come
from numpy seeds and go to both; forward values and first-order gradients
must agree, and the plain pair must also give the right grad-of-grad.

Tolerance: 2e-5 absolute on O(1) values for the segment sums and gathers
(f32 sums of up to ~40 terms in different orders; the port's plain sum is
taken in float64), 1e-4 for gather-project-sum (64-term f32 dot products,
projected before the gather here and after it in the kernel).

The kernels themselves are held against these plain versions on the card
in tests/test_torch_port_cuda.py.
"""

from __future__ import annotations

import functools as ft

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chgnet_tpu.ops import gproj as jgp
from chgnet_tpu.ops import scatter as jsc
from chgnet_tpu.ops import stream_ops as so
from chgnet_tpu_torch.graph.batching import SegmentPlan, make_plan
from chgnet_tpu_torch.ops import gproj as tgp
from chgnet_tpu_torch.ops import segment as tsg

ATOL = 2e-5
ATOL_GPROJ = 1e-4


@pytest.fixture()
def interp(monkeypatch):
    monkeypatch.setattr(so, "tpu_backend", lambda: True)
    for mod, name in [
        (jgp, "_gproj_pallas"), (so, "_segsum_pallas"),
        (so, "_segsum2_pallas"), (so, "_gather_pallas"),
        (so, "_multi_gather_pallas"),
    ]:
        monkeypatch.setattr(
            mod, name, ft.partial(getattr(mod, name), interpret=True)
        )
    jax.clear_caches()
    yield
    jax.clear_caches()


def _window_local_idx(L, S, rng):
    """Index stream whose 512-row blocks stay inside a narrow window (so
    chgnet_tpu attaches gather windows and its kernels run)."""
    base = np.linspace(0, S - 1, L).astype(np.int64)
    jitter = rng.integers(-200, 200, L)
    return np.clip(base + jitter, 0, S - 1).astype(np.int32)


def _stream(L, S, rng, sorted_):
    idx = _window_local_idx(L, S, rng)
    valid = rng.random(L) < 0.9
    if sorted_:
        idx = np.sort(idx)
        valid = np.arange(L) < int(0.9 * L)  # padding at the tail
    return idx, valid


def _tplan(idx, valid, n_out, sorted_) -> SegmentPlan:
    plan = make_plan(idx, valid, n_out, assume_sorted=sorted_)
    return plan.to("cpu")


def _t(x, requires_grad=False):
    return torch.tensor(np.asarray(x), requires_grad=requires_grad)


@pytest.mark.parametrize("sorted_", [True, False], ids=["sorted", "perm"])
def test_segment_sum_matches_jax_kernel(interp, sorted_):
    rng = np.random.default_rng(0)
    L, S, d = 2048, 1024, 64
    idx, valid = _stream(L, S, rng, sorted_)
    x = rng.standard_normal((L, d)).astype(np.float32)
    ct = rng.standard_normal((S, d)).astype(np.float32)
    key = np.where(valid, idx, S).astype(np.int32)
    jplan = jsc.make_plan(idx, valid, S, assume_sorted=sorted_)

    def jfn(xj):
        if sorted_:
            return jsc.plan_segment_sum(xj, jnp.asarray(key), S, jplan)
        return jsc.plan_segment_sum_perm(xj, jnp.asarray(key), S, jplan)

    j_out, j_vjp = jax.vjp(jfn, jnp.asarray(x))
    (j_dx,) = j_vjp(jnp.asarray(ct))

    xt = _t(x, True)
    t_out = tsg.plan_segment_sum(xt, _tplan(idx, valid, S, sorted_))
    (t_dx,) = torch.autograd.grad(t_out, xt, _t(ct))
    np.testing.assert_allclose(t_out.detach().numpy(), j_out, atol=ATOL)
    np.testing.assert_allclose(t_dx.numpy(), j_dx, atol=ATOL)


@pytest.mark.parametrize("sorted_", [True, False], ids=["sorted", "perm"])
def test_gather_matches_jax_kernel(interp, sorted_):
    rng = np.random.default_rng(1)
    L, S, d = 2048, 1024, 64
    idx, valid = _stream(L, S, rng, sorted_)
    table = rng.standard_normal((S, d)).astype(np.float32)
    ct = rng.standard_normal((L, d)).astype(np.float32)
    jplan = jsc.make_plan(idx, valid, S, assume_sorted=sorted_)
    assert jplan.g_lo.shape[0], "chgnet_tpu must take its gather kernel"

    j_out, j_vjp = jax.vjp(
        lambda t: jsc.plan_gather(t, jnp.asarray(idx), jplan), jnp.asarray(table)
    )
    (j_dt,) = j_vjp(jnp.asarray(ct))

    tt = _t(table, True)
    t_out = tsg.plan_gather(tt, _t(idx), _tplan(idx, valid, S, sorted_))
    (t_dt,) = torch.autograd.grad(t_out, tt, _t(ct))
    # padded rows gather real rows in both (their index is in range)
    np.testing.assert_allclose(t_out.detach().numpy(), j_out, atol=0)
    np.testing.assert_allclose(t_dt.numpy(), j_dt, atol=ATOL)


def test_gather_rows_zeroes_out_of_range_rows():
    src = torch.arange(12.0).reshape(4, 3)
    out = tsg.gather_rows(src, torch.tensor([3, 4, -1, 0], dtype=torch.int32))
    np.testing.assert_array_equal(
        out.numpy(), [[9, 10, 11], [0, 0, 0], [0, 0, 0], [0, 1, 2]]
    )


def test_segment_sum_pair_matches_jax_kernel(interp):
    rng = np.random.default_rng(2)
    L, S, d = 2048, 1024, 128
    ia, va = _stream(L, S, rng, True)
    ib, vb = _stream(L, S, rng, False)
    x = rng.standard_normal((L, d)).astype(np.float32)
    cts = [rng.standard_normal((S, d)).astype(np.float32) for _ in range(2)]
    jplans = [
        jsc.make_plan(ia, va, S, assume_sorted=True),
        jsc.make_plan(ib, vb, S),
    ]
    calls = []
    real = so.segment_sum_pair

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(so, "segment_sum_pair", spy)
        j_out, j_vjp = jax.vjp(
            lambda xj: tuple(jsc.paired_cotangent_sums(xj, jplans, [S, S])),
            jnp.asarray(x),
        )
        (j_dx,) = j_vjp(tuple(jnp.asarray(c) for c in cts))
    assert calls, "chgnet_tpu must pair the two sums into its segsum2 kernel"

    xt = _t(x, True)
    ta, tb = tsg.plan_segment_sum_pair(
        xt, _tplan(ia, va, S, True), _tplan(ib, vb, S, False)
    )
    (t_dx,) = torch.autograd.grad((ta, tb), xt, [_t(c) for c in cts])
    np.testing.assert_allclose(ta.detach().numpy(), j_out[0], atol=ATOL)
    np.testing.assert_allclose(tb.detach().numpy(), j_out[1], atol=ATOL)
    np.testing.assert_allclose(t_dx.numpy(), j_dx, atol=ATOL)


def _gproj_inputs(seed=3, L=2048, S=1024, dt=64, K=128):
    rng = np.random.default_rng(seed)
    ia = np.sort(_window_local_idx(L, S, rng))
    ib = _window_local_idx(L, S, rng)
    valid = np.ones(L, bool)
    t1, t2 = (rng.standard_normal((S, dt)).astype(np.float32) for _ in range(2))
    ws = [(rng.standard_normal((dt, K)) * 0.1).astype(np.float32) for _ in range(3)]
    stream = rng.standard_normal((L, K)).astype(np.float32)
    ct = rng.standard_normal((L, K)).astype(np.float32)
    return ia, ib, valid, t1, t2, ws, stream, ct


def test_gather_project_sum_matches_jax_kernel(interp):
    """Three pairs over two tables and two index streams: the angle-side
    layout (bond table by dir_i and dir_j, atoms on the edge stream by
    dir_i)."""
    ia, ib, valid, t1, t2, ws, stream, ct = _gproj_inputs()
    S = t1.shape[0]
    pa = jsc.make_plan(ia, valid, S, assume_sorted=True)
    pb = jsc.make_plan(ib, valid, S)

    def jfn(t1j, t2j, w0, w1, w2, sj):
        ia_j, ib_j = jnp.asarray(ia), jnp.asarray(ib)
        # chgnet_tpu folds the stream in as an aligned part with identity
        # weights plus zero bias: acc = sum_p T[idx] @ W + stream
        parts = [(t1j, ia_j, pa), (t1j, ib_j, pb), (sj, None, None),
                 (t2j, ia_j, pa)]
        eye = jnp.eye(sj.shape[1], dtype=sj.dtype)
        return jgp.gather_project_sum(parts, [w0, w1, w2], None, [eye])

    args = [t1, t2, *ws, stream]
    assert jgp.gproj_eligible(
        [(jnp.asarray(t1), jnp.asarray(ia), pa),
         (jnp.asarray(t1), jnp.asarray(ib), pb)], ia.shape[0]
    )
    j_out, j_vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    j_grads = j_vjp(jnp.asarray(ct))

    tt = [_t(a, True) for a in args]
    t1t, t2t, w0, w1, w2, st = tt
    pta, ptb = _tplan(ia, valid, S, True), _tplan(ib, valid, S, False)
    ia_t, ib_t = _t(ia), _t(ib)
    out = tgp.gather_project_sum(
        [(t1t, ia_t, pta, w0), (t1t, ib_t, ptb, w1), (t2t, ia_t, pta, w2)], st
    )
    t_grads = torch.autograd.grad(out, tt, _t(ct))
    np.testing.assert_allclose(out.detach().numpy(), j_out, atol=ATOL_GPROJ)
    for name, tg, jg in zip(["t1", "t2", "w0", "w1", "w2", "stream"],
                            t_grads, j_grads):
        scale = max(1.0, float(np.abs(jg).max()))
        np.testing.assert_allclose(
            tg.numpy(), jg, atol=ATOL_GPROJ * scale, err_msg=name
        )


def test_plain_pair_grad_of_grad():
    """Second order through plan_gather -> plan_segment_sum (each
    backward calls the other) equals torch's own indexing autograd."""
    rng = np.random.default_rng(4)
    L, S, d = 300, 40, 8
    idx = rng.integers(0, S, L).astype(np.int32)
    valid = rng.random(L) < 0.9
    key = np.where(valid, idx, S)
    plan = _tplan(idx, valid, S, False)
    table = rng.standard_normal((S, d))
    v = rng.standard_normal((S, d))

    def energy(t, ours):
        if ours:
            g = tsg.plan_gather(t, _t(idx), plan)
            return (tsg.plan_segment_sum(torch.sin(g) * g, plan) ** 2).sum()
        g = t[torch.as_tensor(idx).long()]
        keep = torch.as_tensor(valid)[:, None]
        y = torch.zeros_like(t).index_add_(
            0, torch.as_tensor(np.minimum(key, S - 1)).long(),
            torch.where(keep, torch.sin(g) * g, 0.0),
        )
        return (y ** 2).sum()

    results = []
    for ours in (True, False):
        t = torch.tensor(table, dtype=torch.float32, requires_grad=True)
        (g1,) = torch.autograd.grad(energy(t, ours), t, create_graph=True)
        (g2,) = torch.autograd.grad((g1 * _t(v).float()).sum(), t)
        results.append((g1.detach().numpy(), g2.numpy()))
    # f32 values of O(100): compare relatively
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(results[0][1], results[1][1], rtol=2e-5, atol=1e-4)
