"""The port's CUDA kernels on the card: each against its plain version.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. The file imports neither jax nor chgnet_tpu, so it runs on a machine
that has only the port's dependencies:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest

Tolerances: gathers and the multi-gather sum are exact (the kernel adds in
the plain version's order); the message tail fused with its segment sum
1e-5 of the output's largest value (its row-order adds against the
tail's 1e-5 and float64 prefix sums); segment sums 2e-4 absolute on sums of up
to ~50 unit-normal terms (f32 in a fixed order against float64 prefix
sums); gather-project-sum 1e-4 (64-term dot products at 3xTF32 on the
tensor cores, either route, against the plain f32 product); the fused gated tails 1e-5
forward and 1e-4 backward, each relative to the output's max |plain|
(64-term f32 products and layer norms in another order; the parameter
gradients sum ~50,000 rows); the model at the port's CPU tolerances (e 2e-5 eV/atom,
f 5e-5 eV/A, s 2e-4 GPa, m 2e-5 mu_B); the relaxers' first 5 energies 1e-5
relative of the CPU's. The one-sweep pair sum equals ``segment_sum_csr`` over
each stream bit for bit (the same order); the update tail on near-constant
rows is held against a float64 evaluation of its plain version, within
twice the f32 plain version's own error (the mean's rounding, amplified by
1 / sqrt(eps), bounds any f32 order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chgnet_tpu_torch import ROOT
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch import ops
from chgnet_tpu_torch.graph.batching import SegmentPlan, batch_graphs, make_plan
from chgnet_tpu_torch.models.chgnet import CHGNet, compute_batch, init_params
from chgnet_tpu_torch.models.convert import params_from_jax
from chgnet_tpu_torch.ops import gated_message as tgm
from chgnet_tpu_torch.ops import gproj as tgp
from chgnet_tpu_torch.ops import multi_gather as tmg
from chgnet_tpu_torch.ops import segment as tsg

pytestmark = pytest.mark.cuda

SEG_ATOL = 2e-4
GPROJ_ATOL = 1e-4
TAIL_FWD_TOL = 1e-5
TAIL_BWD_TOL = 1e-4
REDUCE_TOL = 1e-5
TOL = {"e": 2e-5, "f": 5e-5, "s": 2e-4, "m": 2e-5}
FULL = dict(graph_converter_algorithm="numpy", fused_kernels=False)
LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _plan(idx, valid, n_out, sorted_, device) -> SegmentPlan:
    plan = make_plan(idx, valid, n_out, assume_sorted=sorted_)
    return plan.to(device)


def _stream(rng, L, S, sorted_):
    idx = rng.integers(0, S, L).astype(np.int32)
    valid = rng.random(L) < 0.9
    if sorted_:
        idx, valid = np.sort(idx), np.arange(L) < int(0.9 * L)
    return idx, valid


@pytest.mark.parametrize("d", [1, 3, 4, 64, 128])
@pytest.mark.parametrize("sorted_", [True, False], ids=["sorted", "perm"])
def test_segment_kernels_match_plain(cuda, d, sorted_):
    rng = np.random.default_rng(5)
    L, S = 1 << 16, 5000
    plan = _plan(*_stream(rng, L, S, sorted_), S, sorted_, cuda)
    plan_b = _plan(*_stream(rng, L, S, False), S, False, cuda)
    x = torch.randn(L, d, device=cuda)
    got = tsg.segment_sum_csr(x, plan.offsets, plan.perm)
    want = tsg.segment_sum_plain(x, plan.offsets, plan.perm)
    torch.testing.assert_close(got, want, atol=SEG_ATOL, rtol=0)
    args = (x, plan.offsets, plan.perm, plan_b.offsets, plan_b.perm)
    for g, w in zip(tsg.segment_sum_pair(*args), tsg.segment_sum_pair_plain(*args)):
        torch.testing.assert_close(g, w, atol=SEG_ATOL, rtol=0)
    src = torch.randn(S, d, device=cuda)
    torch.testing.assert_close(
        tsg.gather_rows(src, plan.key), tsg.gather_rows_plain(src, plan.key),
        atol=0, rtol=0,
    )


def _gproj_inputs(device, n_pairs, n_src, n_rows=65_573, shared=False, seed=7):
    """Tables of n_src rows, indices out of range on both sides; with
    shared, pairs 0 and 1 share a table (AtomConv) and pairs 0 and 2 an
    index stream (dir_i on the angle side)."""
    rng = np.random.default_rng(seed)
    tabs = [torch.randn(n_src, 64, device=device) for _ in range(n_pairs)]
    idxs = [
        torch.as_tensor(rng.integers(-2, n_src + 2, n_rows).astype(np.int32),
                        device=device)
        for _ in range(n_pairs)
    ]
    if shared and n_pairs >= 2:
        tabs[1] = tabs[0]
    if shared and n_pairs == 3:
        idxs[2] = idxs[0]
    ws = [torch.randn(64, 128, device=device) * 0.1 for _ in range(n_pairs)]
    return tabs, idxs, ws, torch.randn(n_rows, 128, device=device)


@pytest.mark.parametrize("op", ["segment_sum", "gproj short", "gproj long"])
def test_segment_sum_is_deterministic(cuda, op):
    rng = np.random.default_rng(6)
    if op == "segment_sum":
        plan = _plan(*_stream(rng, 1 << 18, 3000, False), 3000, False, cuda)
        x = torch.randn(1 << 18, 64, device=cuda)
        a = tsg.segment_sum_csr(x, plan.offsets, plan.perm)
        b = tsg.segment_sum_csr(x, plan.offsets, plan.perm)
    else:
        args = _gproj_inputs(cuda, 3, 7_680 if op.endswith("short") else 60_000,
                             shared=True)
        a = tgp.gather_project_sum_kernel(*args)
        b = tgp.gather_project_sum_kernel(*args)
    assert torch.equal(a, b)


class _Calls:
    """A kernel library that records which C entry points are called."""

    def __init__(self, lib):
        self.lib, self.names = lib, []

    def __getattr__(self, name):
        self.names.append(name)
        return getattr(self.lib, name)


def _record_gproj_calls(monkeypatch) -> list:
    load = tgp.build.load
    libs = []
    monkeypatch.setattr(
        tgp.build, "load", lambda *a: libs.append(_Calls(load(*a))) or libs[-1]
    )
    return libs


@pytest.mark.parametrize("shared", [False, True], ids=["distinct", "shared"])
@pytest.mark.parametrize("route", ["short", "long"])
@pytest.mark.parametrize("n_pairs", [1, 2, 3])
def test_gather_project_sum_kernel_matches_plain(cuda, monkeypatch, n_pairs, route,
                                                 shared):
    """Both routes: short tables (S = 7,680, AtomConv's atoms) are projected
    first, long ones (S = 60,000: over the threshold even for one pair)
    gathered first; a ragged last tile, indices out of range on both
    sides."""
    n_src = 7_680 if route == "short" else 60_000
    assert tgp.gproj_route(n_pairs, n_src, 128) == route
    args = _gproj_inputs(cuda, n_pairs, n_src, shared=shared)
    libs = _record_gproj_calls(monkeypatch)
    got = tgp.gather_project_sum_kernel(*args)
    assert libs[0].names == ["gproj_short_f32" if route == "short" else "gproj_f32"]
    torch.testing.assert_close(
        got, tgp.gather_project_sum_plain(*args), atol=GPROJ_ATOL, rtol=0,
    )


def test_gproj_routes_of_the_benchmark_shapes(cuda, monkeypatch):
    """The wrapper takes the route the threshold gives for the benchmark
    batch's two shapes: AtomConv (2 pairs over N = 7,680 atoms) projects
    first, the bond side (3 pairs over E = 647,168 edges) gathers first."""
    libs = _record_gproj_calls(monkeypatch)
    for n_pairs, n_src, want in ((2, 7_680, "gproj_short_f32"),
                                 (3, 647_168, "gproj_f32")):
        args = _gproj_inputs(cuda, n_pairs, n_src, n_rows=4_099, shared=True)
        got = tgp.gather_project_sum_kernel(*args)
        assert libs[-1].names == [want]
        torch.testing.assert_close(
            got, tgp.gather_project_sum_plain(*args), atol=GPROJ_ATOL, rtol=0,
        )


def test_wrappers_raise_on_what_kernels_do_not_take(cuda):
    x = torch.randn(100, 8, device=cuda, dtype=torch.float64)
    off = torch.zeros(11, dtype=torch.int32, device=cuda)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        tsg.segment_sum_csr(x, off, empty)
    with pytest.raises(TypeError, match="int32"):
        tsg.gather_rows(x.float(), off.long())
    t = torch.randn(10, 64, device=cuda)
    i = torch.zeros(5, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="K <= 128"):
        tgp.gather_project_sum_kernel(
            [t], [i], [torch.randn(64, 256, device=cuda)],
            torch.randn(5, 256, device=cuda),
        )
    w = torch.randn(64, 128, device=cuda)
    st = torch.randn(5, 128, device=cuda)
    with pytest.raises(ValueError, match="pairs"):
        tgp.gather_project_sum_kernel([t] * 4, [i] * 4, [w] * 4, st)
    # a contiguous view one float past an aligned start: no float4 loads
    shifted = torch.randn(10 * 64 + 1, device=cuda)[1:].view(10, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tgp.gather_project_sum_kernel([shifted], [i], [w], st)
    # one warp sums a row: at most 32 float4 (or float) units
    wide = torch.randn(100, 132, device=cuda)
    with pytest.raises(ValueError, match="at most 128"):
        tsg.segment_sum_csr(wide, off, empty)
    narrow = torch.randn(100 * 36 + 1, device=cuda)[1:].view(100, 36)
    with pytest.raises(ValueError, match="at most 128"):
        tsg.segment_sum_pair(narrow, off, empty, off, empty)


def test_second_order_through_kernels_matches_cpu(cuda):
    """grad-of-grad through plan_gather / plan_segment_sum (each backward
    calls the other's kernel) agrees with the plain path on the CPU."""
    rng = np.random.default_rng(8)
    L, S, d = 4096, 300, 16
    idx, valid = rng.integers(0, S, L).astype(np.int32), rng.random(L) < 0.9
    table = rng.standard_normal((S, d)).astype(np.float32)
    v = rng.standard_normal((S, d)).astype(np.float32)
    res = []
    for dev in (cuda, torch.device("cpu")):
        plan = _plan(idx, valid, S, False, dev)
        t = torch.tensor(table, device=dev, requires_grad=True)
        g = tsg.plan_gather(t, torch.as_tensor(idx, device=dev), plan)
        energy = (tsg.plan_segment_sum(torch.sin(g) * g, plan) ** 2).sum()
        (g1,) = torch.autograd.grad(energy, t, create_graph=True)
        (g2,) = torch.autograd.grad((g1 * torch.tensor(v, device=dev)).sum(), t)
        res.append((g1.detach().cpu(), g2.cpu()))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-4)


def test_model_on_card_matches_cpu(cuda):
    s = Structure.from_file(LIMNO2).perturb(0.05, seed=7)
    a = CHGNet(seed=0, device="cpu", **FULL).predict_structure(s)
    b = CHGNet(seed=0, device=cuda, **FULL).predict_structure(s)
    for key in "efsm":
        np.testing.assert_allclose(
            np.asarray(b[key]), np.asarray(a[key]), atol=TOL[key], err_msg=key
        )


def test_default_model_on_card_matches_cpu(cuda):
    """CHGNet(seed=0) with its default fused_kernels=True: the fused tail
    kernels on the card against their plain versions on the CPU."""
    s = Structure.from_file(LIMNO2)
    kw = dict(graph_converter_algorithm="numpy")
    a = CHGNet(seed=0, device="cpu", **kw).predict_structure(s, task="efsm")
    b = CHGNet(seed=0, device=cuda, **kw).predict_structure(s, task="efsm")
    for key in "efsm":
        np.testing.assert_allclose(
            np.asarray(b[key]), np.asarray(a[key]), atol=TOL[key], err_msg=key
        )


# ------------------------------------------------------- fused gated tails
def _tail_inputs(device, d=64, n_rows=50_000 + 13, seed=9):
    """Rows not a multiple of the kernels' 32-row tile, ~10% mask zeros."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    x = dict(
        acc=rand(n_rows, 2 * d), weights=rand(n_rows, d),
        mask=(torch.rand(n_rows, generator=gen) < 0.9).float().to(device),
        resnet=rand(n_rows, d), g=rand(n_rows, d),
    )
    p = dict(
        w2c=rand(d, d, scale=0.1), w2g=rand(d, d, scale=0.1),
        b2=rand(2 * d, scale=0.1), nc_scale=rand(d), nc_bias=rand(d, scale=0.1),
        ng_scale=rand(d), ng_bias=rand(d, scale=0.1),
    )
    return x, p


def _params(p, has_w2=True):
    return tgm.tail_params(p if has_w2 else {k: p[k] for k in tgm.LN_KEYS})


def _assert_scaled(got, want, tol):
    """max |got - want| <= tol * max |want|, over every pair."""
    got = [t for t in got if t is not None]
    want = [t for t in want if t is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= tol * float(w.abs().max()), err


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


TAIL_ROWS = [1, 15, 17, 2_500, 65_573]  # one, under, over a 16-row tile


@pytest.mark.parametrize("n_rows", TAIL_ROWS)
@pytest.mark.parametrize("d", [4, 16, 36, 64])
@pytest.mark.parametrize(
    "need_mask,need_params", [(False, False), (True, True)],
    ids=["serving", "all"],
)
def test_gated_message_kernels_match_plain(cuda, d, need_mask, need_params, n_rows):
    x, p = _tail_inputs(cuda, d, n_rows)
    args = (x["acc"], x["weights"], x["mask"], _params(p))
    _assert_scaled(
        [tgm.gated_message_fwd(*args)], [tgm.gated_message_plain(*args)],
        TAIL_FWD_TOL,
    )
    args += (x["g"], need_mask, need_params)
    got = _flat(tgm.gated_message_bwd(*args))
    want = _flat(tgm.gated_message_bwd_plain(*args))
    assert (got[2] is None) == (not need_mask)
    _assert_scaled(got, want, TAIL_BWD_TOL)


@pytest.mark.parametrize("n_rows", TAIL_ROWS)
@pytest.mark.parametrize("d", [4, 16, 36, 64])
@pytest.mark.parametrize("need_params", [False, True], ids=["serving", "params"])
@pytest.mark.parametrize("has_w2", [False, True], ids=["y=acc", "w2"])
def test_gated_update_kernels_match_plain(cuda, has_w2, need_params, d, n_rows):
    x, p = _tail_inputs(cuda, d, n_rows)
    params = _params(p, has_w2)
    args = (x["acc"], x["resnet"], params)
    _assert_scaled(
        [tgm.gated_update_fwd(*args)], [tgm.gated_update_plain(*args)],
        TAIL_FWD_TOL,
    )
    args = (x["acc"], params, x["g"], need_params)
    _assert_scaled(
        _flat(tgm.gated_update_bwd(*args)),
        _flat(tgm.gated_update_bwd_plain(*args)), TAIL_BWD_TOL,
    )


@pytest.mark.parametrize("need_params", [True, False], ids=["params", "serving"])
def test_gated_parameter_gradients_are_deterministic(cuda, need_params):
    x, p = _tail_inputs(cuda, n_rows=200_000)
    args = (x["acc"], x["weights"], x["mask"], _params(p), x["g"], need_params,
            need_params)
    a, b = tgm.gated_message_bwd(*args), tgm.gated_message_bwd(*args)
    for s_, t_ in zip(_flat(a), _flat(b)):
        assert (s_ is None and t_ is None) or torch.equal(s_, t_)


@pytest.mark.parametrize("op", ["message", "update-w2", "update"])
def test_gated_autograd_second_order_matches_cpu(cuda, op):
    """First and second order through the autograd ops (backward kernel,
    then the plain composition) on the card against the CPU."""
    res = []
    for dev in (cuda, torch.device("cpu")):
        x, p = _tail_inputs(torch.device("cpu"), n_rows=4096 + 5)
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in x.items()}
        tp = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
        if op == "message":
            out = tgm.fused_gated_message(
                leaves["acc"], leaves["weights"], leaves["mask"], tp
            )
            wrt = [leaves["acc"], leaves["weights"], leaves["mask"]]
        else:
            if op == "update":
                tp = {k: tp[k] for k in tgm.LN_KEYS}
            out = tgm.fused_gated_update(leaves["acc"], leaves["resnet"], tp)
            wrt = [leaves["acc"]]
        wrt += list(tp.values())
        grads = torch.autograd.grad((out * leaves["g"]).sum(), wrt, create_graph=True)
        second = sum((gr * gr.detach().sin()).sum() for gr in grads)
        g2 = torch.autograd.grad(second, wrt)
        res.append([t.detach().cpu() for t in (out, *grads, *g2)])
    _assert_scaled(res[0], res[1], TAIL_BWD_TOL)


@pytest.mark.parametrize("op", ["message", "update-w2", "update"])
def test_gated_autograd_serving_matches_cpu(cuda, op):
    """First order as serving runs it, with no gradient for the mask or the
    tail's parameters (the backward kernels' serving instantiations), on
    the card against the CPU."""
    res = []
    for dev in (cuda, torch.device("cpu")):
        x, p = _tail_inputs(torch.device("cpu"), n_rows=4096 + 5)
        x = {k: v.to(dev) for k, v in x.items()}
        p = {k: v.to(dev) for k, v in p.items()}
        acc = x["acc"].requires_grad_(True)
        if op == "message":
            rows = x["weights"].requires_grad_(True)
            out = tgm.fused_gated_message(acc, rows, x["mask"], p)
        else:
            if op == "update":
                p = {k: p[k] for k in tgm.LN_KEYS}
            rows = x["resnet"].requires_grad_(True)
            out = tgm.fused_gated_update(acc, rows, p)
        grads = torch.autograd.grad(out, [acc, rows], x["g"])
        res.append([t.detach().cpu() for t in (out, *grads)])
    _assert_scaled(res[0], res[1], TAIL_BWD_TOL)


def test_gated_wrappers_raise_on_what_kernels_do_not_take(cuda):
    x, p = _tail_inputs(cuda, n_rows=100)
    params = _params(p)
    acc, w, m = x["acc"], x["weights"], x["mask"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        shifted = torch.randn(100 * 128 + 1, device=cuda)[1:].view(100, 128)
        tgm.gated_message_fwd(shifted, w, m, params)
    with pytest.raises(ValueError, match="contiguous"):
        tgm.gated_message_fwd(acc, w.T.contiguous().T, m, params)
    with pytest.raises(TypeError, match="float32"):
        tgm.gated_update_fwd(acc.double(), x["resnet"], params)
    with pytest.raises(ValueError, match="tensors on"):
        tgm.gated_update_fwd(acc, x["resnet"].cpu(), params)
    with pytest.raises(ValueError, match="2D <= 128"):
        wide = torch.randn(100, 256, device=cuda)
        tgm.gated_update_fwd(wide, torch.randn(100, 128, device=cuda), params)
    with pytest.raises(ValueError, match="D % 4 == 0"):
        odd = torch.randn(100, 2 * 62, device=cuda)
        tgm.gated_update_fwd(odd, torch.randn(100, 62, device=cuda), params)
    with pytest.raises(ValueError, match="tail parameters"):
        tgm.gated_message_fwd(acc, w, m, params[3:])


# --------------------------------------------------------- multi-gather sum
@pytest.mark.parametrize("with_stream", [False, True], ids=["bare", "stream"])
@pytest.mark.parametrize("n_parts", [1, 2, 3, 4])
@pytest.mark.parametrize("d", [4, 64, 128])
def test_gather_sum_rows_kernel_is_exact(cuda, d, n_parts, with_stream):
    """Tables of different lengths, indices one past either end (zero rows),
    a row count off every block size."""
    rng = np.random.default_rng(12)
    n_rows = (1 << 16) + 37
    sizes = [7000, 30000, 7000, 100][:n_parts]
    tabs = [torch.randn(s_, d, device=cuda) for s_ in sizes]
    idxs = [
        torch.as_tensor(rng.integers(-1, s_ + 1, n_rows).astype(np.int32), device=cuda)
        for s_ in sizes
    ]
    st = torch.randn(n_rows, d, device=cuda) if with_stream else None
    got = tmg.gather_sum_rows(tabs, idxs, st)
    assert torch.equal(got, tmg.gather_sum_rows_plain(tabs, idxs, st))


def test_gather_sum_and_twin_reduce_on_card_match_cpu(cuda):
    """Value, first and second derivative of gather_sum (three tables of two
    lengths and an aligned stream) and twin_reduce on the card against the
    CPU's plain versions, each relative to the tensor's largest value."""
    rng = np.random.default_rng(13)
    n_rows, n_a, n_b, d = 4096, 300, 2048, 16
    ia, ic = (rng.integers(0, n_a, n_rows).astype(np.int32) for _ in range(2))
    ib = rng.permutation(n_rows).astype(np.int32) // 2  # each bond twice
    first = np.argsort(ib, kind="stable").reshape(-1, 2).astype(np.int32)
    valid = rng.random(n_rows) < 0.9
    data = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((n_a, d), (n_b, d), (n_rows, d), (n_b, d))]
    res = []
    for dev in (cuda, torch.device("cpu")):
        ta, tb, st, v = (torch.tensor(x, device=dev) for x in data)
        leaves = [t.requires_grad_(True) for t in (ta, tb, st)]
        pa, pc = (_plan(i, valid, n_a, False, dev) for i in (ia, ic))
        pb = _plan(ib, valid, n_b, False, dev)
        idx = [torch.as_tensor(i, device=dev) for i in (ia, ib, ic)]
        out = tmg.gather_sum(
            [(ta, idx[0], pa), (tb, idx[1], pb), (st, None, None), (ta, idx[2], pc)]
        )
        u2d, und2 = (torch.as_tensor(first[:, k].copy(), device=dev) for k in (0, 1))
        red = tmg.twin_reduce(torch.sin(out) * out, u2d, und2, idx[1], pb)
        energy = (red * v).sum() + (red ** 2).sum()
        g1 = torch.autograd.grad(energy, leaves, create_graph=True)
        g2 = torch.autograd.grad(sum((g * x.detach()).sum() for g, x in zip(g1, leaves)), leaves)
        res.append([t.detach().cpu() for t in (out, red, *g1, *g2)])
    # sums of ~30 f32 terms of size up to ~30, in two orders
    _assert_scaled(res[0], res[1], 1e-5)


def test_gather_sum_rows_raises_on_what_the_kernel_does_not_take(cuda):
    t = torch.randn(10, 64, device=cuda)
    i = torch.zeros(5, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="parts"):
        tmg.gather_sum_rows([], [])
    with pytest.raises(ValueError, match="parts"):
        tmg.gather_sum_rows([t] * 5, [i] * 5)
    with pytest.raises(ValueError, match="one width"):
        tmg.gather_sum_rows([t, torch.randn(10, 32, device=cuda)], [i, i])
    with pytest.raises(ValueError, match="d % 4"):
        tmg.gather_sum_rows([torch.randn(10, 6, device=cuda)] * 2, [i, i])
    with pytest.raises(ValueError, match="16-byte aligned"):
        shifted = torch.randn(10 * 64 + 1, device=cuda)[1:].view(10, 64)
        tmg.gather_sum_rows([t, shifted], [i, i])
    with pytest.raises(ValueError, match="contiguous"):
        tmg.gather_sum_rows([t, torch.randn(64, 10, device=cuda).T], [i, i])
    with pytest.raises(ValueError, match="tensors on"):
        tmg.gather_sum_rows([t, t.cpu()], [i, i])
    with pytest.raises(TypeError, match="int32"):
        tmg.gather_sum_rows([t, t], [i, i.long()])
    with pytest.raises(ValueError, match="differ in rows"):
        tmg.gather_sum_rows([t, t], [i, i], torch.randn(6, 64, device=cuda))


# ------------------------------------------ message tail + segment sum
def _reduce_inputs(device, d, n_rows, n_out, seed=14):
    """A sorted key stream with empty segments, ~10% masked rows whose keys
    stay in range, and dropped rows at the tail."""
    x, p = _tail_inputs(device, d, n_rows, seed)
    rng = np.random.default_rng(seed)
    key = np.sort(rng.integers(0, n_out, n_rows)).astype(np.int32)
    valid = np.arange(n_rows) < int(0.93 * n_rows)
    plan = _plan(key, valid, n_out, True, device)
    return x, p, plan


@pytest.mark.parametrize(
    "d,n_rows,n_out",
    [(64, 50_000 + 13, 700), (64, 40_000, 60_000), (16, 5_000, 3), (64, 20, 500)],
    ids=["long-segments", "short-segments", "narrow", "tiny"],
)
def test_gated_message_reduce_kernel_matches_plain(cuda, d, n_rows, n_out):
    x, p, plan = _reduce_inputs(cuda, d, n_rows, n_out)
    args = (x["acc"], x["weights"], x["mask"], _params(p), plan.offsets)
    got = tgm.gated_message_reduce(*args)
    assert got.shape == (n_out, d)
    _assert_scaled([got], [tgm.gated_message_reduce_plain(*args)], REDUCE_TOL)
    assert torch.equal(got, tgm.gated_message_reduce(*args))  # deterministic
    # the mask multiplies inside the sum: rows masked to zero add nothing
    keep = x["mask"] > 0
    masked = x["acc"].clone()
    masked[~keep] = 1e3
    args = (masked, x["weights"], x["mask"], _params(p), plan.offsets)
    assert torch.equal(got, tgm.gated_message_reduce(*args))


def test_gated_message_reduce_with_no_valid_row_is_zero(cuda):
    x, p = _tail_inputs(cuda, n_rows=100)
    off = torch.zeros(41, dtype=torch.int32, device=cuda)
    out = tgm.gated_message_reduce(
        x["acc"], x["weights"], x["mask"], _params(p), off
    )
    assert out.shape == (40, 64) and not bool(out.any())


@pytest.mark.parametrize("serving", [False, True], ids=["all", "serving"])
def test_gated_message_reduce_autograd_matches_cpu(cuda, serving):
    """First and second order through the reduce op on the card (the reduce
    kernel, the gather, the message backward kernel, then the plain
    composition) against the CPU; ``serving`` asks for no gradient by the
    mask or the parameters."""
    res = []
    for dev in (cuda, torch.device("cpu")):
        x, p, plan = _reduce_inputs(torch.device("cpu"), 64, 4096 + 5, 300)
        plan = plan.to(dev)
        grad = not serving
        leaves = {k: x[k].to(dev).requires_grad_(grad or k in ("acc", "weights"))
                  for k in ("acc", "weights", "mask")}
        tp = {k: v.to(dev).requires_grad_(grad) for k, v in p.items()}
        out = tgm.fused_gated_message_reduce(
            leaves["acc"], leaves["weights"], leaves["mask"], tp, plan
        )
        wrt = [leaves["acc"], leaves["weights"]]
        wrt += [] if serving else [leaves["mask"], *tp.values()]
        grads = torch.autograd.grad(torch.tanh(out).sum(), wrt, create_graph=True)
        second = sum((gr * gr.detach().sin()).sum() for gr in grads)
        g2 = torch.autograd.grad(second, wrt)
        res.append([t.detach().cpu() for t in (out, *grads, *g2)])
    _assert_scaled(res[0], res[1], TAIL_BWD_TOL)


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose storage starts 4 bytes past a
    16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16
    return out


@pytest.mark.parametrize("n_rows", TAIL_ROWS)
@pytest.mark.parametrize("d", [16, 32, 64])
def test_message_forward_with_misaligned_weights_matches_plain(cuda, d, n_rows):
    """The tensor-core message forward at ragged row counts, its weights
    copied 4 bytes at a time."""
    x, p = _tail_inputs(cuda, d, n_rows)
    args = (x["acc"], _misaligned(x["weights"]), x["mask"], _params(p))
    _assert_scaled(
        [tgm.gated_message_fwd(*args)], [tgm.gated_message_plain(*args)],
        TAIL_FWD_TOL,
    )


def _segment_layout(device, d, seed=21):
    """Runs of empty segments, one segment longer than any warp's share,
    short segments, ~10% masked rows and dropped rows at the tail."""
    rng = np.random.default_rng(seed)
    counts = np.r_[np.zeros(3_000, int), 60_000, rng.integers(0, 3, 20_000),
                   np.zeros(500, int), rng.integers(0, 90, 700)]
    n_out = counts.shape[0]
    key = np.repeat(np.arange(n_out), counts).astype(np.int32)
    n_valid = key.shape[0]
    key = np.r_[key, np.full(1_001, n_out - 1, np.int32)]
    valid = np.arange(key.shape[0]) < n_valid
    x, p = _tail_inputs(device, d, key.shape[0], seed)
    return x, p, _plan(key, valid, n_out, True, device)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
def test_message_reduce_over_empty_and_long_segments_matches_plain(cuda, aligned):
    x, p, plan = _segment_layout(cuda, 64)
    weights = x["weights"] if aligned else _misaligned(x["weights"])
    args = (x["acc"], weights, x["mask"], _params(p), plan.offsets)
    got = tgm.gated_message_reduce(*args)
    _assert_scaled([got], [tgm.gated_message_reduce_plain(*args)], REDUCE_TOL)
    counts = (plan.offsets[1:] - plan.offsets[:-1]).cpu()
    assert not bool(got[counts.to(cuda) == 0].any())  # empty segments are zero


def test_message_reduce_runs_give_equal_bits(cuda):
    x, p, plan = _segment_layout(cuda, 64, seed=5)
    args = (x["acc"], x["weights"], x["mask"], _params(p), plan.offsets)
    a, b = tgm.gated_message_reduce(*args), tgm.gated_message_reduce(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_width_guard_refuses_a_wide_cuda_model_before_any_launch(cuda):
    """A model wider than the kernels take raises NotImplementedError on
    the card, at construction and, for a CUDA batch, in compute_batch
    before any kernel launches; the same model serves on the CPU."""
    wide = dict(atom_fea_dim=128, atom_conv_hidden_dim=128,
                graph_converter_algorithm="numpy")
    ops.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="atom_fea_dim=128"):
        CHGNet(device=cuda, **wide)
    cpu_model = CHGNet(device="cpu", **wide)
    graph = cpu_model.graph_converter(Structure.from_file(LIMNO2))
    batch = batch_graphs([graph]).to(cuda)
    params = params_from_jax(init_params(cpu_model.config), cuda)
    with pytest.raises(NotImplementedError, match="dt <= 64"):
        compute_batch(params, batch, config=cpu_model.config, compute_force=True)
    torch.cuda.synchronize()
    assert all(fn.launches == 0 for fn in ops.KERNELS)
    e = cpu_model.predict_structure(Structure.from_file(LIMNO2), task="e")["e"]
    assert np.isfinite(e)


@pytest.mark.parametrize(
    "kw,switch",
    [(dict(directed_bonds=False), ""), (dict(directed_bonds=False), "1"), ({}, "1")],
    ids=["undirected", "undirected-msg-reduce", "msg-reduce"],
)
def test_undirected_and_msg_reduce_paths_on_card_match_cpu(cuda, monkeypatch, kw, switch):
    monkeypatch.setenv("CHGNET_TPU_MSG_REDUCE", switch)
    s = Structure.from_file(LIMNO2).perturb(0.05, seed=9)
    kw = dict(kw, graph_converter_algorithm="numpy")
    a = CHGNet(seed=0, device="cpu", **kw).predict_structure(s, task="efsm")
    b = CHGNet(seed=0, device=cuda, **kw).predict_structure(s, task="efsm")
    for key in "efsm":
        np.testing.assert_allclose(
            np.asarray(b[key]), np.asarray(a[key]), atol=TOL[key], err_msg=key
        )


# ------------------------------------ stream v2: tile sums, windowed gather
@pytest.mark.parametrize("d", [1, 3, 4, 32, 64, 124])
@pytest.mark.parametrize("sorted_", [True, False], ids=["sorted", "perm"])
@pytest.mark.parametrize(
    "L,S", [((1 << 16) + 11, 700), (40_000, 60_000), (100, 7)],
    ids=["long-segments", "short-segments", "tiny"],
)
def test_segment_sum_tiles_matches_plain(cuda, d, sorted_, L, S):
    """Ragged sizes, empty segments (S > L), dropped keys at the tail or
    scattered, segments that span many tiles and many segments per tile;
    two runs give equal bits."""
    rng = np.random.default_rng(21)
    plan = _plan(*_stream(rng, L, S, sorted_), S, sorted_, cuda)
    x = torch.randn(L, d, device=cuda)
    got = tsg.segment_sum_tiles(x, plan.offsets, plan.perm)
    want = tsg.segment_sum_plain(x, plan.offsets, plan.perm)
    assert got.shape == (S, d)
    _assert_scaled([got], [want], 1e-5)
    assert torch.equal(got, tsg.segment_sum_tiles(x, plan.offsets, plan.perm))
    # rows past offsets[-1] are never read
    if sorted_:
        x2 = x.clone()
        x2[int(plan.offsets[-1]):] = float("nan")
        assert torch.equal(got, tsg.segment_sum_tiles(x2, plan.offsets, plan.perm))


def test_segment_sum_tiles_with_no_valid_row_is_zero(cuda):
    x = torch.randn(300, 64, device=cuda)
    off = torch.zeros(41, dtype=torch.int32, device=cuda)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    out = tsg.segment_sum_tiles(x, off, empty)
    assert out.shape == (40, 64) and not bool(out.any())
    with pytest.raises(ValueError, match="at most 128"):
        tsg.segment_sum_tiles(torch.randn(8, 256, device=cuda), off, empty)


def _window_stream(rng, L, S, span):
    """Keys whose blocks of WINDOW_BLOCK rows stay within ``span`` source
    rows, ~10% of the rows dropped."""
    from chgnet_tpu_torch.graph.batching import WINDOW_BLOCK

    nb = -(-L // WINDOW_BLOCK)
    base = np.repeat(rng.integers(0, S - span, nb), WINDOW_BLOCK)[:L]
    idx = (base + rng.integers(0, span, L)).astype(np.int32)
    return idx, rng.random(L) < 0.9


@pytest.mark.parametrize("d", [4, 64, 128])
def test_gather_rows_window_matches_plain(cuda, monkeypatch, d):
    """Exact against the plain version: the rows inside their window equal
    ``src[idx]``, a padded row that points outside it is zero."""
    from chgnet_tpu_torch.graph.batching import WINDOW_ROWS

    monkeypatch.setenv("CHGNET_TPU_STREAM_V2", "1")
    rng = np.random.default_rng(22)
    L, S = 20_000 + 77, 9_000
    idx, valid = _window_stream(rng, L, S, WINDOW_ROWS)
    plan = _plan(idx, valid, S, False, cuda)
    assert plan.window.shape == (-(-L // 128), 2)
    fwd = torch.as_tensor(np.where(valid, idx, S - 1).astype(np.int32), device=cuda)
    src = torch.randn(S, d, device=cuda)
    for index in (plan.key, fwd):  # the backward's keys, the forward's indices
        got = tsg.gather_rows_window(src, index, plan.window)
        assert torch.equal(got, tsg.gather_rows_window_plain(src, index, plan.window))
        ok = torch.as_tensor(valid, device=cuda)
        assert torch.equal(got[ok], src[plan.key[ok].long()])
    assert not bool(tsg.gather_rows_window(src, plan.key, plan.window)[~ok].any())


def _window_case(rng, L, S, span):
    """Windows of ``span`` rows on even blocks and of 1-3 rows on odd ones,
    a few empty (lo > hi), one crossing the end of the table and one
    starting before it; indices inside their window but for a few padded
    rows outside it or outside ``[0, S)``."""
    from chgnet_tpu_torch.graph.batching import WINDOW_BLOCK

    nb = -(-L // WINDOW_BLOCK)
    spans = np.where(np.arange(nb) % 2 == 0, span, rng.integers(1, 4, nb))
    lo = rng.integers(0, S - spans + 1)
    hi = lo + spans - 1
    empty = rng.random(nb) < 0.05
    lo[empty], hi[empty] = rng.integers(1, 50, int(empty.sum())), 0
    lo[-2], hi[-2] = S - spans[-2] // 2, S - spans[-2] // 2 + spans[-2] - 1
    lo[0], hi[0] = -2, spans[0] - 3
    block = np.arange(L) // WINDOW_BLOCK
    idx = lo[block] + (rng.random(L) * spans[block]).astype(np.int64)
    pad = rng.random(L) < 0.05
    idx[pad] = rng.choice([-1, -7, S, S + 3], int(pad.sum()))
    out_of_window = rng.random(L) < 0.02
    idx[out_of_window] = np.clip(hi[block] + 1, 0, S - 1)[out_of_window]
    return idx.astype(np.int32), np.stack([lo, hi], axis=1).astype(np.int32)


@pytest.mark.parametrize("span", [1, 3, 200, 447])
@pytest.mark.parametrize("d", [4, 64, 128])
def test_gather_rows_window_kernel_matches_plain_exactly(cuda, d, span):
    """The kernel against the plain version, bit for bit: narrow and wide
    windows in one call, empty windows, windows past either end of the
    table, a ragged last block, indices outside the window or the table,
    and 1.2M 16-byte units, more than the grid's threads (at most 32 blocks
    of 256 a multiprocessor), so that every thread strides."""
    rng = np.random.default_rng(40 + span + d)
    L, S = 1_200_000 * 4 // d + 77, 3000
    idx, window = _window_case(rng, L, S, span)
    src = torch.randn(S, d, device=cuda)
    idx_t = torch.as_tensor(idx, device=cuda)
    win_t = torch.as_tensor(window, device=cuda)
    n0 = tsg.gather_rows_window.launches
    got = tsg.gather_rows_window(src, idx_t, win_t)
    torch.cuda.synchronize()
    assert tsg.gather_rows_window.launches == n0 + 1
    assert torch.equal(got, tsg.gather_rows_window_plain(src, idx_t, win_t))
    block = np.arange(L) // 128
    inside = (idx >= np.maximum(window[block, 0], 0)) & (idx <= window[block, 1])
    inside &= idx < S
    assert (~inside).sum() > 0 and inside.sum() > L // 2
    assert not bool(got[torch.as_tensor(~inside, device=cuda)].any())
    assert torch.equal(got[torch.as_tensor(inside, device=cuda)],
                       src[torch.as_tensor(idx[inside], device=cuda).long()])


def test_window_plan_is_absent_when_a_block_spans_too_far(cuda, monkeypatch):
    monkeypatch.setenv("CHGNET_TPU_STREAM_V2", "1")
    rng = np.random.default_rng(23)
    idx = rng.integers(0, 5000, 4096).astype(np.int32)
    plan = _plan(idx, np.ones(4096, bool), 5000, False, cuda)
    assert plan.window.shape[0] == 0
    src = torch.randn(5000, 64, device=cuda)
    n0 = tsg.gather_rows.launches
    out = tsg.plan_gather(src, plan.key, plan)  # falls to gather_rows
    assert tsg.gather_rows.launches == n0 + 1
    assert torch.equal(out, src[idx.astype(np.int64)])
    with pytest.raises(ValueError, match="window"):
        tsg.gather_rows_window(src, plan.key, plan.window)
    good = torch.zeros((32, 2), dtype=torch.int32, device=cuda)
    wide = torch.randn(5000, 256, device=cuda)  # any width of 4k floats
    key = plan.key.clamp(max=4999)
    assert torch.equal(tsg.gather_rows_window(wide, key, good),
                       tsg.gather_rows_window_plain(wide, key, good))
    with pytest.raises(ValueError, match="4k floats"):
        tsg.gather_rows_window(torch.randn(5000, 6, device=cuda), plan.key, good)


def test_stream_v2_autograd_matches_cpu(cuda, monkeypatch):
    """plan_gather and plan_segment_sum under the switch, first and second
    order, on the card (window and tile kernels) against the CPU."""
    from chgnet_tpu_torch.graph.batching import WINDOW_ROWS

    monkeypatch.setenv("CHGNET_TPU_STREAM_V2", "1")
    rng = np.random.default_rng(24)
    L, S, d = 6000 + 5, 2500, 64
    idx, valid = _window_stream(rng, L, S, WINDOW_ROWS // 2)
    table = rng.standard_normal((S, d)).astype(np.float32)
    res = []
    for dev in (cuda, torch.device("cpu")):
        plan = _plan(idx, valid, S, False, dev)
        t = torch.tensor(table, device=dev, requires_grad=True)
        before = (tsg.gather_rows_window.launches, tsg.segment_sum_tiles.launches)
        rows = tsg.plan_gather(t, plan.key.clamp(max=S - 1), plan)
        out = tsg.plan_segment_sum(torch.sin(rows) * rows, plan)
        (g1,) = torch.autograd.grad((out ** 2).sum(), t, create_graph=True)
        (g2,) = torch.autograd.grad((g1 * t.detach()).sum(), t)
        res.append([x.detach().cpu() for x in (rows, out, g1, g2)])
        if dev.type == "cuda":
            assert tsg.gather_rows_window.launches > before[0]
            assert tsg.segment_sum_tiles.launches > before[1]
    _assert_scaled(res[0], res[1], 1e-5)


# ---------------------------------------------------- the one-kernel pass
def _pass_inputs(device, n_gathered, with_aligned, d=64, n_rows=30_000 + 13, seed=31):
    x, p = _tail_inputs(device, d, n_rows, seed)
    rng = np.random.default_rng(seed)
    sizes = [4000, 9000, 4000][:n_gathered]
    tables = [torch.tensor(rng.standard_normal((s, 2 * d)).astype(np.float32),
                           device=device) for s in sizes]
    # a few indices out of range: those rows add zero
    idxs = [torch.as_tensor(rng.integers(-1, s + 1, n_rows).astype(np.int32),
                            device=device) for s in sizes]
    aligned = x["acc"] if with_aligned else None
    b1 = torch.tensor(rng.standard_normal(2 * d).astype(np.float32), device=device)
    return x, p, tables, idxs, aligned, b1


@pytest.mark.parametrize("with_aligned", [False, True], ids=["bare", "aligned"])
@pytest.mark.parametrize("n_gathered", [1, 2, 3])
@pytest.mark.parametrize(
    "form,need", [("message", False), ("message", True), ("update_w2", False),
                  ("update_w2", True), ("update", False), ("update", True)],
)
def test_fused_pass_kernels_match_plain(cuda, form, need, n_gathered, with_aligned):
    from chgnet_tpu_torch.ops import fused_pass as tfp

    x, p, tables, idxs, aligned, b1 = _pass_inputs(cuda, n_gathered, with_aligned)
    params = _params(p, has_w2=form != "update")
    msg = form == "message"
    weights, mask = (x["weights"], x["mask"]) if msg else (None, None)
    resnet = None if msg else x["resnet"]
    fwd = (tables, idxs, aligned, b1, params, weights, mask, resnet)
    got = tfp.fused_pass_fwd(*fwd)
    _assert_scaled([got], [tfp.fused_pass_fwd_plain(*fwd)], TAIL_FWD_TOL)
    assert torch.equal(got, tfp.fused_pass_fwd(*fwd))
    bwd = (tables, idxs, aligned, b1, params, weights, mask, x["g"], msg and need, need)
    got = _flat(tfp.fused_pass_bwd(*bwd))
    _assert_scaled(got, _flat(tfp.fused_pass_bwd_plain(*bwd)), TAIL_BWD_TOL)
    again = _flat(tfp.fused_pass_bwd(*bwd))
    assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)


@pytest.mark.parametrize("d", [16, 36])
def test_fused_pass_kernels_at_narrow_widths(cuda, d):
    from chgnet_tpu_torch.ops import fused_pass as tfp

    x, p, tables, idxs, aligned, b1 = _pass_inputs(cuda, 2, True, d=d, n_rows=5000 + 3)
    params = _params(p)
    fwd = (tables, idxs, aligned, b1, params, x["weights"], x["mask"], None)
    _assert_scaled([tfp.fused_pass_fwd(*fwd)], [tfp.fused_pass_fwd_plain(*fwd)],
                   TAIL_FWD_TOL)
    bwd = (tables, idxs, aligned, b1, params, x["weights"], x["mask"], x["g"], True, True)
    _assert_scaled(_flat(tfp.fused_pass_bwd(*bwd)),
                   _flat(tfp.fused_pass_bwd_plain(*bwd)), TAIL_BWD_TOL)


def _pass_args(x, p, tables, idxs, aligned, b1, form, need_mask, need_params,
               side=lambda t: t):
    """The forward's and the backward's arguments of one form; ``side`` maps
    the weights, resnet and cotangent rows (to misalign them, say)."""
    params = _params(p, has_w2=form != "update")
    msg = form == "message"
    weights = side(x["weights"]) if msg else None
    mask = x["mask"] if msg else None
    fwd = (tables, idxs, aligned, b1, params, weights, mask,
           None if msg else side(x["resnet"]))
    bwd = (tables, idxs, aligned, b1, params, weights, mask, side(x["g"]),
           msg and need_mask, need_params)
    return fwd, bwd


def _check_pass(fwd, bwd, repeat=True):
    """Both kernels against their plain versions; with ``repeat`` a second
    run of each gives equal bits."""
    from chgnet_tpu_torch.ops import fused_pass as tfp

    got = tfp.fused_pass_fwd(*fwd)
    _assert_scaled([got], [tfp.fused_pass_fwd_plain(*fwd)], TAIL_FWD_TOL)
    grads = _flat(tfp.fused_pass_bwd(*bwd))
    _assert_scaled(grads, _flat(tfp.fused_pass_bwd_plain(*bwd)), TAIL_BWD_TOL)
    if repeat:
        assert torch.equal(got, tfp.fused_pass_fwd(*fwd))
        again = _flat(tfp.fused_pass_bwd(*bwd))
        assert all(torch.equal(a, b) for a, b in zip(grads, again) if a is not None)


@pytest.mark.parametrize("form", ["message", "update_w2", "update"])
@pytest.mark.parametrize("n_rows", [1, 15, 17, 5_003])
@pytest.mark.parametrize("d", [16, 36, 64])
def test_fused_pass_serving_kernels_at_narrow_widths_and_ragged_rows(
    cuda, d, n_rows, form
):
    """The tensor-core kernels (no parameter gradients) at widths whose
    8-column tiles are padded, and with fewer rows than one warp's tile."""
    x, p, tables, idxs, aligned, b1 = _pass_inputs(cuda, 2, True, d=d, n_rows=n_rows)
    _check_pass(*_pass_args(x, p, tables, idxs, aligned, b1, form, True, False))


@pytest.mark.parametrize("form", ["message", "update"])
@pytest.mark.parametrize("n_gathered,with_aligned", [(1, False), (3, True)])
def test_fused_pass_serving_kernels_with_misaligned_rows(
    cuda, form, n_gathered, with_aligned
):
    """Weights, resnet and the cotangent copied 4 bytes at a time."""
    x, p, tables, idxs, aligned, b1 = _pass_inputs(
        cuda, n_gathered, with_aligned, n_rows=7_001)
    _check_pass(*_pass_args(x, p, tables, idxs, aligned, b1, form, False, False,
                            side=_misaligned))


# the benchmark batch's stream capacities (PERF.md section 5): the edge
# stream gathers two atom tables that stay in L2, the angle stream two edge
# tables of 331 MB, each larger than L2, one of them by random indices
PATH_SHAPES = {"edge": (647_168 + 5, 7_680), "angle": (808_960 + 5, 647_168)}


@pytest.mark.parametrize("form", ["message", "update"])
@pytest.mark.parametrize("stream", list(PATH_SHAPES))
def test_fused_pass_serving_kernels_at_the_path_shapes(cuda, stream, form):
    """Path P's row counts plus a ragged tail, its table sizes, a sorted
    and a random index stream with some indices out of range; both kernels
    give equal bits on a second run."""
    n_rows, n_src = PATH_SHAPES[stream]
    d = 64
    rng = np.random.default_rng(41)
    x, p = _tail_inputs(cuda, d, n_rows, seed=41)
    tables = [torch.randn(n_src, 2 * d, device=cuda) for _ in range(2)]
    sorted_idx = np.sort(rng.integers(0, n_src, n_rows)).astype(np.int32)
    random_idx = rng.integers(-2, n_src + 2, n_rows).astype(np.int32)
    idxs = [torch.as_tensor(i, device=cuda) for i in (sorted_idx, random_idx)]
    aligned = torch.randn(n_rows, 2 * d, device=cuda)
    b1 = torch.randn(2 * d, device=cuda) * 0.1
    _check_pass(*_pass_args(x, p, tables, idxs, aligned, b1, form, False, False))


def _kernel_names(fn) -> set[str]:
    """The CUDA kernels that ``fn()`` launches, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if e.device_type.name == "CUDA"}


@pytest.mark.parametrize("need_params", [False, True], ids=["serving", "params"])
def test_fused_pass_backward_kernel_follows_the_parameter_gradients(
    cuda, need_params
):
    """Serving runs the tensor-core backward; parameter gradients stay on
    the CUDA-core kernel, with its fixed block count."""
    from chgnet_tpu_torch.ops import fused_pass as tfp

    x, p, tables, idxs, aligned, b1 = _pass_inputs(cuda, 2, True, n_rows=4_099)
    _, bwd = _pass_args(x, p, tables, idxs, aligned, b1, "message", True,
                        need_params)
    names = _kernel_names(lambda: tfp.fused_pass_bwd(*bwd))
    tc = any("pass_bwd_tc_kernel" in n for n in names)
    fma = any("pass_bwd_kernel" in n for n in names)
    assert (tc, fma) == (not need_params, need_params), names


@pytest.mark.parametrize("form", ["message", "update_w2", "update"])
@pytest.mark.parametrize("serving", [False, True], ids=["all", "serving"])
def test_fused_layer_pass_autograd_matches_cpu(cuda, monkeypatch, form, serving):
    """First and second order through fused_layer_pass with the switch on,
    on the card (both kernels, the cotangent sums, then the unfused
    composition) against the CPU."""
    from chgnet_tpu_torch.ops import fused_pass as tfp

    monkeypatch.setenv("CHGNET_TPU_FUSED_PASS", "1")
    rng = np.random.default_rng(33)
    n_rows, sizes, d = 4096 + 5, (700, 900), 64
    idx = [rng.integers(0, s, n_rows).astype(np.int32) for s in sizes]
    valid = rng.random(n_rows) < 0.9
    res = []
    for dev in (cuda, torch.device("cpu")):
        x, p, tables, _, aligned, b1 = _pass_inputs(
            torch.device("cpu"), 2, True, n_rows=n_rows)
        tables = [t[:s].to(dev).requires_grad_(True) for t, s in zip(tables, sizes)]
        aligned = aligned.to(dev).requires_grad_(True)
        plans = [_plan(i, valid, s, False, dev) for i, s in zip(idx, sizes)]
        parts = [(tables[0], torch.as_tensor(idx[0], device=dev), plans[0]),
                 (aligned, None, None),
                 (tables[1], torch.as_tensor(idx[1], device=dev), plans[1])]
        grad = not serving
        keys = tgm.LN_KEYS if form == "update" else tuple(p)
        tp = {k: p[k].to(dev).requires_grad_(grad) for k in keys}
        b1 = b1.to(dev).requires_grad_(grad)
        wrt = [*tables, aligned]
        kw = {}
        if form == "message":
            kw["weights"] = x["weights"].to(dev).requires_grad_(True)
            kw["mask"] = x["mask"].to(dev).requires_grad_(grad)
            wrt += [kw["weights"]] + ([kw["mask"]] if grad else [])
        else:
            kw["resnet"] = x["resnet"].to(dev).requires_grad_(True)
            wrt.append(kw["resnet"])
        wrt += [b1, *tp.values()] if grad else []
        before = (tfp.fused_pass_fwd.launches, tfp.fused_pass_bwd.launches)
        out = tfp.fused_layer_pass(parts, b1, tp, **kw)
        grads = torch.autograd.grad(torch.tanh(out).sum(), wrt, create_graph=True)
        # fixed coefficients: a function of the gradients' own values (a sine,
        # say) would turn the parameter gradients' 1e-6 into 1e-4 here
        second = sum(
            (gr * torch.linspace(-1, 1, gr.numel(), device=dev).view_as(gr)).sum()
            for gr in grads
        )
        g2 = torch.autograd.grad(second, wrt, allow_unused=True)
        if dev.type == "cuda":
            # the second order passes the forward op's backward once more
            # (tanh' depends on out), so the backward kernel runs twice
            assert tfp.fused_pass_fwd.launches == before[0] + 1
            assert tfp.fused_pass_bwd.launches == before[1] + 2
        res.append([t.detach().cpu() for t in (out, *grads, *g2) if t is not None])
    _assert_scaled(res[0], res[1], TAIL_BWD_TOL)


def test_fused_pass_raises_on_what_the_kernels_do_not_take(cuda, monkeypatch):
    from chgnet_tpu_torch.ops import fused_pass as tfp

    monkeypatch.setenv("CHGNET_TPU_FUSED_PASS", "1")
    x, p, tables, idxs, aligned, b1 = _pass_inputs(cuda, 3, True, n_rows=64)
    params = _params(p)
    args = dict(weights=x["weights"], mask=x["mask"])
    plan = _plan(np.zeros(64, np.int32), np.ones(64, bool), 4000, False, cuda)
    part = (tables[0], idxs[0], plan)
    with pytest.raises(ValueError, match="gathered"):
        tfp.fused_layer_pass([part] * 4, b1, p, **args)
    with pytest.raises(ValueError, match="aligned"):
        tfp.fused_layer_pass([part, (aligned, None, None)] * 2, b1, p, **args)
    wide = torch.randn(10, 256, device=cuda)
    with pytest.raises(ValueError, match="2D <= 128"):
        tfp.fused_layer_pass([(wide, idxs[0], plan)], None, p, **args)
    with pytest.raises(ValueError, match="gathered parts"):
        tfp.fused_pass_fwd(tables * 2, idxs * 2, aligned, b1, params,
                           x["weights"], x["mask"], None)
    with pytest.raises(ValueError, match="16-byte aligned"):
        shifted = torch.randn(4000 * 128 + 1, device=cuda)[1:].view(4000, 128)
        tfp.fused_pass_fwd([shifted], idxs[:1], aligned, b1, params,
                           x["weights"], x["mask"], None)
    with pytest.raises(TypeError, match="int32"):
        tfp.fused_pass_fwd(tables[:1], [idxs[0].long()], aligned, b1, params,
                           x["weights"], x["mask"], None)
    with pytest.raises(ValueError, match="b1"):
        tfp.fused_pass_fwd(tables[:1], idxs[:1], aligned, b1[:64], params,
                           x["weights"], x["mask"], None)


@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
@pytest.mark.parametrize("switch", ["CHGNET_TPU_STREAM_V2", "CHGNET_TPU_FUSED_PASS"])
def test_stream_v2_and_fused_pass_paths_on_card_match_cpu(
    cuda, monkeypatch, switch, directed
):
    from chgnet_tpu_torch import ops

    monkeypatch.setenv(switch, "1")
    s = Structure.from_file(LIMNO2).make_supercell(2).perturb(0.05, seed=9)
    kw = dict(graph_converter_algorithm="numpy", directed_bonds=directed)
    a = CHGNet(seed=0, device="cpu", **kw).predict_structure(s, task="efsm")
    ops.reset_launch_counts()
    b = CHGNet(seed=0, device=cuda, **kw).predict_structure(s, task="efsm")
    new = (ops.segment_sum_tiles, ops.gather_rows_window) if "STREAM" in switch \
        else (ops.fused_pass_fwd, ops.fused_pass_bwd)
    assert all(fn.launches > 0 for fn in new)
    for key in "efsm":
        np.testing.assert_allclose(
            np.asarray(b[key]), np.asarray(a[key]), atol=TOL[key], err_msg=key
        )


# ------------------------------------------------------------- simulation
def _chip_smoke_goldens():
    """The pinned seed-0 traces as chip_smoke.py keeps them (held equal to
    tests/test_golden_traces.py's by a CPU test; that module imports JAX)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", f"{ROOT}/chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.GOLDEN_SMALL, module.GOLDEN_MD, module.GOLDEN_FIRE


GOLDEN_SMALL, GOLDEN_MD, GOLDEN_FIRE = _chip_smoke_goldens()


@pytest.mark.parametrize(("ensemble", "thermostat"), sorted(GOLDEN_MD))
def test_md_golden_traces_on_card(cuda, ensemble, thermostat):
    from chgnet_tpu_torch.simulation import MolecularDynamics

    model = CHGNet(seed=0, device=cuda, **GOLDEN_SMALL)
    md = MolecularDynamics(
        Structure.from_file(LIMNO2), model=model, ensemble=ensemble,
        thermostat=thermostat, temperature=300.0, starting_temperature=300.0,
        timestep=2.0, taut=50.0, taup=200.0, pressure=0.0, bulk_modulus=100.0,
        seed=0,
    )
    es, ts = [], []
    for _ in range(10):
        md.run(3)
        es.append(float(md.state.epot[0]))
        ts.append(float(md.get_temperature()))
    want_e, want_t = GOLDEN_MD[(ensemble, thermostat)]
    np.testing.assert_allclose(es, want_e, rtol=2e-3)
    np.testing.assert_allclose(ts, want_t, rtol=2e-3)


def test_fire_golden_trace_on_card(cuda):
    from chgnet_tpu_torch.simulation import StructOptimizer

    model = CHGNet(seed=0, device=cuda, **GOLDEN_SMALL)
    res = StructOptimizer(model=model, optimizer_class="FIRE").relax(
        Structure.from_file(LIMNO2).perturb(0.1, seed=3), fmax=0.01, steps=25,
        relax_cell=True, assign_magmoms=False,
    )
    np.testing.assert_allclose(res["trajectory"].energies[:25], GOLDEN_FIRE, rtol=2e-3)


def test_md_final_state_matches_the_exact_graph_on_card(cuda):
    """Skin reuse with the dynamic masks on the card: the MD state's energy
    and forces equal a fresh exact-cutoff prediction of its positions."""
    from chgnet_tpu_torch import ops
    from chgnet_tpu_torch.simulation import MolecularDynamics, units

    model = CHGNet(seed=0, device=cuda, **GOLDEN_SMALL)
    struct = Structure.from_file(LIMNO2).make_supercell(2)
    md = MolecularDynamics(
        struct, model=model, ensemble="nvt", thermostat="Berendsen",
        temperature=300.0, starting_temperature=300.0, timestep=1.0, seed=0,
        skin=0.15,
    )
    ops.reset_launch_counts()
    md.run(20)
    assert md.runtime.n_rebuilds >= 1
    assert ops.gated_message_bwd.launches > 0 and ops.segment_sum_csr.launches > 0
    n = len(struct)
    pred = model.predict_structure(md.atoms, task="ef")
    assert abs(pred["e"] - float(md.state.epot[0]) / n) <= TOL["e"]
    forces = (md.state.accel * md.masses[:, None] * units.AMU_A2_FS2_TO_EV)[:n]
    np.testing.assert_allclose(forces.cpu().numpy(), pred["f"], rtol=0, atol=TOL["f"])


def test_compute_batch_dynamic_on_card_matches_cpu(cuda):
    from chgnet_tpu_torch.simulation.runtime import GraphRuntime, compute_batch_dynamic

    model = CHGNet(seed=0, device="cpu", **GOLDEN_SMALL)
    struct = Structure.from_file(LIMNO2).make_supercell(2).perturb(0.1, seed=3)
    rt = GraphRuntime(model.config, [struct], skin=0.3, device="cpu")
    rng = np.random.default_rng(4)
    frac = rt.batch.frac_coords + torch.as_tensor(
        rng.uniform(-0.004, 0.004, rt.batch.frac_coords.shape), dtype=torch.float32)
    batch = rt.batch._replace(frac_coords=frac)
    want = compute_batch_dynamic(model.params, batch, config=model.config)
    card = CHGNet(seed=0, device=cuda, **GOLDEN_SMALL)
    got = compute_batch_dynamic(card.params, batch.to(cuda), config=card.config)
    for key in "efsm":
        np.testing.assert_allclose(got[key].cpu().numpy(), want[key].numpy(),
                                   rtol=0, atol=TOL[key], err_msg=key)


RELAX_RTOL = 1e-5  # 5 steps, each a pass within 2e-5 eV/atom of the CPU's


@pytest.mark.parametrize(
    "name",
    ["LBFGS", "LBFGSLineSearch", "BFGS", "BFGSLineSearch", "SciPyFminCG",
     "SciPyFminBFGS"],
)
def test_relaxers_on_card_match_cpu(cuda, name):
    """The first 5 energies of each relaxer (cell free) on the card equal
    the port's on the CPU (the BFGS forms: cuSOLVER's eigh on the card,
    LAPACK's on the CPU)."""
    from chgnet_tpu_torch.simulation import StructOptimizer

    struct = Structure.from_file(LIMNO2).perturb(0.05, seed=1)
    energies = []
    for device in ("cpu", cuda):
        model = CHGNet(seed=0, device=device, **GOLDEN_SMALL)
        result = StructOptimizer(model, optimizer_class=name).relax(
            struct, steps=5, fmax=1e-6, relax_cell=True, assign_magmoms=False
        )
        energies.append(np.asarray(result["trajectory"].energies[:5]))
    assert len(energies[1]) == 5
    np.testing.assert_allclose(energies[1], energies[0], rtol=RELAX_RTOL, atol=0)


def test_graph_runtime_on_card_builds_with_the_native_builder(cuda):
    from chgnet_tpu_torch.simulation.runtime import GraphRuntime

    model = CHGNet(seed=0, device=cuda, **GOLDEN_SMALL)
    rt = GraphRuntime(model.config, [Structure.from_file(LIMNO2)], device=cuda)
    assert rt.converter.algorithm == "fast"
    assert rt.batch.frac_coords.device.type == "cuda"


# ------------------------------------------------------------------ training
TRAIN_LR = 1e-3
# one train step's parameter gradients on the card against the CPU's, each
# leaf at 1e-4 of its largest value plus 1e-7: a second derivative through
# the kernels' 3xTF32 products and fixed-order sums against the plain f32
# versions
GRAD_TOL = 1e-4


def _train_loader(n=12, batch_size=4, seed=0):
    """``n`` perturbed LiMnO2 cells labelled E+F+S+M by a seed-7 teacher on
    the CPU, a NaN energy, force block and magmom block among them, in one
    loader that keeps their order."""
    from chgnet_tpu_torch.data import StructureData, get_loader

    teacher = CHGNet(seed=7, device="cpu", **GOLDEN_SMALL)
    structs = [Structure.from_file(LIMNO2).perturb(0.1, seed=seed + i)
               for i in range(n)]
    preds = teacher.predict_structure(structs, task="efsm")
    energies = [float(p["e"]) for p in preds]
    forces = [np.asarray(p["f"], np.float32) for p in preds]
    stresses = [np.asarray(p["s"], np.float32) * -10.0 for p in preds]
    magmoms = [np.asarray(p["m"], np.float32) for p in preds]
    energies[1] = np.nan
    forces[2] = np.full_like(forces[2], np.nan)
    magmoms[3] = np.full_like(magmoms[3], np.nan)
    data = StructureData(structures=structs, energies=energies, forces=forces,
                         stresses=stresses, magmoms=magmoms, shuffle=False)
    return get_loader(data, batch_size=batch_size, shuffle=False)


def _param_grads(model, batch, targets, **kw):
    from chgnet_tpu_torch.trainer import CombinedLoss
    from chgnet_tpu_torch.trainer.losses import loss_and_metrics
    from chgnet_tpu_torch.trainer.trainer import _leaves

    leaves = [leaf.requires_grad_(True) for _, leaf in _leaves(model.params)]
    dev = model.device
    t = {k: torch.as_tensor(v).to(dev) for k, v in targets.items()}
    loss, _ = loss_and_metrics(model.params, batch.to(dev), t, config=model.config,
                               loss_fn=CombinedLoss(target_str="efsm"),
                               create_graph=True, **kw)
    loss.backward()
    return float(loss.detach()), [  # the last block's angle update feeds nothing
        np.zeros(tuple(leaf.shape), np.float32) if leaf.grad is None
        else leaf.grad.cpu().numpy() for leaf in leaves
    ]


@pytest.mark.parametrize(
    "kw,switch",
    [({}, None), ({}, "CHGNET_TPU_FUSED_PASS"), (dict(fused_kernels=False), None),
     (dict(directed_bonds=False), None)],
    ids=["default", "fused-pass", "plain-tails", "undirected"],
)
def test_train_step_parameter_gradients_on_card_match_cpu(cuda, monkeypatch, kw, switch):
    """``loss.backward()`` of the E+F+S+M loss (NaN labels in the batch)
    through every autograd op of the path gives the CPU's parameter
    gradients; the tails' and the one-kernel pass's backwards run in their
    parameter-gradient form."""
    if switch:
        monkeypatch.setenv(switch, "1")
    batch, targets = next(iter(_train_loader(n=4)))
    want_loss, want = _param_grads(CHGNet(seed=0, device="cpu", **GOLDEN_SMALL, **kw),
                                   batch, targets)
    from chgnet_tpu_torch.ops import fused_pass as tfp

    asked = []
    for name in ("gated_message_bwd", "gated_update_bwd", "fused_pass_bwd"):
        mod = tgm if name.startswith("gated") else tfp
        orig = getattr(mod, name)

        def spy(*args, _orig=orig, _name=name):
            asked.append((_name, bool(args[-1])))
            return _orig(*args)

        spy.launches = spy.launches_bf16 = 0  # the wrapper counts on its module's name
        monkeypatch.setattr(mod, name, spy)
    ops.reset_launch_counts()
    got_loss, got = _param_grads(CHGNet(seed=0, device=cuda, **GOLDEN_SMALL, **kw),
                                 batch, targets)
    torch.cuda.synchronize()
    assert np.isfinite(got_loss) and abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    for g, w in zip(got, want, strict=True):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(w).max()) + 1e-7)
    assert ops.segment_sum_csr.launches and ops.gather_rows.launches
    if kw.get("fused_kernels", True):
        assert any(params for _, params in asked)  # parameter-gradient form


def test_trainer_on_card_matches_cpu(cuda):
    """A Trainer on the card takes 3 steps (Adam, CosLR, E+F+S+M, NaN
    labels): each step's loss within 1e-4 relative of the same run on the
    CPU, the parameters within 2 x lr x steps (Adam's near-zero gradients
    may step by lr either way), nearly all to 1e-5."""
    from chgnet_tpu_torch.models.convert import params_to_numpy
    from chgnet_tpu_torch.trainer import Trainer

    runs = []
    for device in ("cpu", "cuda"):
        trainer = Trainer(model=CHGNet(seed=0, device=device, **GOLDEN_SMALL),
                          targets="efsm", learning_rate=TRAIN_LR, epochs=1,
                          use_device=device)
        trainer._build_optimizer(False)
        losses = [trainer._read_metrics(trainer.train_step(
            *trainer._on_device(b, t)))["loss"] for b, t in _train_loader()]
        runs.append((losses, params_to_numpy(trainer.model.params)))
    assert len(runs[1][0]) == 3 and np.isfinite(runs[1][0]).all()
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4)
    from chgnet_tpu_torch.trainer.trainer import _leaves

    diffs = np.concatenate([np.abs(a - b).ravel() for (_, a), (_, b) in zip(
        _leaves(runs[0][1]), _leaves(runs[1][1]))])
    assert diffs.max() <= 2 * TRAIN_LR * 3 and (diffs > 1e-5).mean() <= 0.01


@pytest.mark.parametrize(
    "kw", [dict(conv_dropout=0.1, mlp_dropout=0.1), dict(remat="all"),
           dict(remat="angle")], ids=["dropout", "remat-all", "remat-angle"])
def test_dropout_and_remat_train_step_on_card(cuda, kw):
    """One train step on the card with dropout (no fused tail launches, a
    finite loss) or with remat (the loss and gradients of the step without
    it, each leaf to 1e-6 of its largest value: the recompute launches the
    same kernels on the same inputs)."""
    batch, targets = next(iter(_train_loader(n=4)))
    gen = torch.Generator().manual_seed(0) if "conv_dropout" in kw else None
    ops.reset_launch_counts()
    loss, grads = _param_grads(CHGNet(seed=0, device=cuda, **GOLDEN_SMALL, **kw),
                               batch, targets, dropout_generator=gen)
    torch.cuda.synchronize()
    assert np.isfinite(loss) and all(np.isfinite(g).all() for g in grads)
    if gen is not None:
        assert not (ops.gated_message_fwd.launches or ops.gated_update_fwd.launches
                    or ops.gated_message_bwd.launches or ops.gated_update_bwd.launches)
        return
    ref_loss, ref = _param_grads(CHGNet(seed=0, device=cuda, **GOLDEN_SMALL),
                                 batch, targets)
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    for g, w in zip(grads, ref, strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * float(np.abs(w).max()))


# ------------------------------------------ bf16 (rows 1-14, every form)
# A bf16 kernel widens its rows to f32, computes in f32 and rounds each
# output once; so does its plain version. The two then differ by at most one
# rounding of an output: BF16_ULP (2^-7, one bf16 ulp) of its largest value.
# Gathers and the multi-gather are exact. gather_project_sum is held to the
# plain version with its route's rounding: the long route rounds only the
# output (one ulp); the short route also each pair's projected table, whose
# rounding may fall on the other side of a tie (one more ulp a pair).
BF16_ULP = 2.0**-7
BF16 = torch.bfloat16


def _assert_ulps(got, want, ulps=1.0):
    got = [t for t in _flat(got) if t is not None]
    want = [t for t in _flat(want) if t is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == BF16
        err = float((g.float() - w.float()).abs().max())
        assert err <= ulps * BF16_ULP * float(w.float().abs().max()), err


@pytest.mark.parametrize("d", [1, 3, 4, 64, 128])
@pytest.mark.parametrize("sorted_", [True, False], ids=["sorted", "perm"])
def test_bf16_segment_kernels_match_plain(cuda, d, sorted_):
    rng = np.random.default_rng(5)
    L, S = 1 << 16, 5000
    plan = _plan(*_stream(rng, L, S, sorted_), S, sorted_, cuda)
    plan_b = _plan(*_stream(rng, L, S, False), S, False, cuda)
    x = torch.randn(L, d, device=cuda).to(BF16)
    ops.reset_launch_counts()
    _assert_ulps(tsg.segment_sum_csr(x, plan.offsets, plan.perm),
                 tsg.segment_sum_plain(x, plan.offsets, plan.perm))
    args = (x, plan.offsets, plan.perm, plan_b.offsets, plan_b.perm)
    _assert_ulps(tsg.segment_sum_pair(*args), tsg.segment_sum_pair_plain(*args))
    idx = torch.as_tensor(rng.integers(-2, L + 2, 3 * L).astype(np.int32), device=cuda)
    _assert_ulps(tsg.gather_rows(x, idx), tsg.gather_rows_plain(x, idx), ulps=0)
    # an odd start: the gather falls back to 2-byte units
    _assert_ulps(tsg.gather_rows(x[1:], idx.clamp(max=L - 2)),
                 tsg.gather_rows_plain(x[1:], idx.clamp(max=L - 2)), ulps=0)
    assert (ops.segment_sum_csr.launches, ops.segment_sum_pair.launches,
            ops.gather_rows.launches) == (1, 1, 2)
    assert (ops.segment_sum_csr.launches_bf16, ops.segment_sum_pair.launches_bf16,
            ops.gather_rows.launches_bf16) == (1, 1, 2)


@pytest.mark.parametrize("route", ["short", "long"])
@pytest.mark.parametrize("n_pairs", [1, 2, 3])
def test_bf16_gather_project_sum_matches_plain(cuda, monkeypatch, n_pairs, route):
    n_src = 7_680 if route == "short" else 120_000
    assert tgp.gproj_route(n_pairs, n_src, 128, 2) == route
    tabs, idxs, ws, stream = _gproj_inputs(cuda, n_pairs, n_src, shared=True)
    args = ([t.to(BF16) for t in tabs], idxs, [w.to(BF16) for w in ws],
            stream.to(BF16))
    libs = _record_gproj_calls(monkeypatch)
    got = tgp.gather_project_sum_kernel(*args)
    assert libs[0].names == [
        "gproj_short_bf16" if route == "short" else "gproj_bf16"]
    _assert_ulps(got, tgp.gather_project_sum_route_plain(*args),
                 1 + n_pairs if route == "short" else 1)


@pytest.mark.parametrize("n_rows", [1, 17, 65_573])
@pytest.mark.parametrize("d", [16, 64])
def test_bf16_gated_tails_match_plain(cuda, d, n_rows):
    """The forward tails and the serving backward of both forms."""
    x, p = _tail_inputs(cuda, d, n_rows)
    x = {k: v.to(BF16) for k, v in x.items()}
    p = {k: v.to(BF16) for k, v in p.items()}
    args = (x["acc"], x["weights"], x["mask"], _params(p))
    _assert_ulps(tgm.gated_message_fwd(*args), tgm.gated_message_plain(*args))
    args += (x["g"], False, False)
    _assert_ulps(tgm.gated_message_bwd(*args), tgm.gated_message_bwd_plain(*args))
    for has_w2 in (False, True):
        params = _params(p, has_w2)
        args = (x["acc"], x["resnet"], params)
        _assert_ulps(tgm.gated_update_fwd(*args), tgm.gated_update_plain(*args))
        args = (x["acc"], params, x["g"], False)
        _assert_ulps(tgm.gated_update_bwd(*args), tgm.gated_update_bwd_plain(*args))


@pytest.mark.parametrize("n_parts", [1, 3])
@pytest.mark.parametrize("d", [4, 128])
def test_bf16_gather_sum_rows_is_exact(cuda, d, n_parts):
    rng = np.random.default_rng(3)
    L = 70_001
    sizes = [5_000, 9_000, 5_000][:n_parts]
    tabs = [torch.randn(s, d, device=cuda).to(BF16) for s in sizes]
    idxs = [torch.as_tensor(rng.integers(-3, s + 3, L).astype(np.int32), device=cuda)
            for s in sizes]
    stream = torch.randn(L, d, device=cuda).to(BF16)
    _assert_ulps(tmg.gather_sum_rows(tabs, idxs, stream),
                 tmg.gather_sum_rows_plain(tabs, idxs, stream), ulps=0)


def test_bf16_param_reduce_tiles_launch_bf16(cuda):
    """The parameter-gradient backward, the message-reduce and the tile
    segment sum launch on bf16 through their _bf16 entry points, each
    launch counted as a bf16 launch."""
    x, p = _tail_inputs(cuda, 64, 100)
    x = {k: v.to(BF16) for k, v in x.items()}
    params = _params({k: v.to(BF16) for k, v in p.items()})
    offsets = torch.tensor([0, 50, 100], dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    got = tgm.gated_message_bwd(x["acc"], x["weights"], x["mask"], params, x["g"],
                                False, True)
    assert all(t.dtype == BF16 for t in (got[0], got[1], *got[3]))
    assert tgm.gated_message_reduce(x["acc"], x["weights"], x["mask"], params,
                                    offsets).dtype == BF16
    assert tsg.segment_sum_tiles(x["g"], offsets, offsets.new_zeros(0)).dtype == BF16
    torch.cuda.synchronize()
    for fn in (ops.gated_message_bwd, ops.gated_message_reduce, ops.segment_sum_tiles):
        assert fn.launches == fn.launches_bf16 == 1, fn.__name__


# a backward with parameter gradients rounds sums over all rows, which the
# kernel and the plain version add in different f32 orders: one rounding of
# sums that differ by up to the f32 kernels' TAIL_BWD_TOL
PARAM_ULPS = 1 + TAIL_BWD_TOL / BF16_ULP


@pytest.mark.parametrize("n_rows", [1, 17, 65_573])
@pytest.mark.parametrize("d", [16, 64])
def test_bf16_tail_parameter_gradients_match_plain(cuda, d, n_rows):
    """Rows 7 and 9 with parameter gradients (training) in bf16: d_acc,
    d_weights and d_mask within one ulp of the plain version's largest
    value, the parameter gradients within ``PARAM_ULPS``; f32 partials
    summed in a fixed order, so two runs give equal bits."""
    x, p = _tail_inputs(cuda, d, n_rows)
    x = {k: v.to(BF16) for k, v in x.items()}
    p = {k: v.to(BF16) for k, v in p.items()}
    args = (x["acc"], x["weights"], x["mask"], _params(p), x["g"], True, True)
    got = tgm.gated_message_bwd(*args)
    want = tgm.gated_message_bwd_plain(*args)
    _assert_ulps(got[:3], want[:3])
    _assert_ulps(got[3], want[3], PARAM_ULPS)
    assert all(torch.equal(a, b) for a, b in zip(_flat(got), _flat(
        tgm.gated_message_bwd(*args))))
    for has_w2 in (False, True):
        args = (x["acc"], _params(p, has_w2), x["g"], True)
        got = tgm.gated_update_bwd(*args)
        want = tgm.gated_update_bwd_plain(*args)
        _assert_ulps(got[0], want[0])
        _assert_ulps(got[1], want[1], PARAM_ULPS)


@pytest.mark.parametrize(
    "d,n_rows,n_out",
    [(64, 50_000 + 13, 700), (64, 40_000, 60_000), (16, 5_000, 3), (64, 20, 500)],
    ids=["long-segments", "short-segments", "narrow", "tiny"],
)
def test_bf16_message_reduce_matches_plain(cuda, d, n_rows, n_out):
    """Row 10 in bf16: each segment summed in f32 and rounded once, within
    one ulp of the plain version's largest value; equal bits run to run."""
    x, p, plan = _reduce_inputs(cuda, d, n_rows, n_out)
    args = (x["acc"].to(BF16), x["weights"].to(BF16), x["mask"].to(BF16),
            _params({k: v.to(BF16) for k, v in p.items()}), plan.offsets)
    ops.reset_launch_counts()
    got = tgm.gated_message_reduce(*args)
    assert ops.gated_message_reduce.launches_bf16 == 1
    _assert_ulps(got, tgm.gated_message_reduce_plain(*args))
    assert torch.equal(got, tgm.gated_message_reduce(*args))


def test_bf16_message_reduce_over_empty_and_long_segments_matches_plain(cuda):
    x, p, plan = _segment_layout(cuda, 64)
    args = (x["acc"].to(BF16), _misaligned(x["weights"].to(BF16)),
            x["mask"].to(BF16), _params({k: v.to(BF16) for k, v in p.items()}),
            plan.offsets)
    got = tgm.gated_message_reduce(*args)
    _assert_ulps(got, tgm.gated_message_reduce_plain(*args))
    counts = (plan.offsets[1:] - plan.offsets[:-1]).cpu()
    assert not bool(got[counts.to(cuda) == 0].any())


@pytest.mark.parametrize("d", [1, 3, 4, 64, 124])
@pytest.mark.parametrize("sorted_", [True, False], ids=["sorted", "perm"])
@pytest.mark.parametrize(
    "L,S", [((1 << 16) + 11, 700), (40_000, 60_000), (100, 7)],
    ids=["long-segments", "short-segments", "tiny"],
)
def test_bf16_segment_sum_tiles_matches_plain(cuda, d, sorted_, L, S):
    """Row 11 in bf16: f32 runs and carries, one rounding at the store,
    within one ulp; equal bits run to run."""
    rng = np.random.default_rng(21)
    plan = _plan(*_stream(rng, L, S, sorted_), S, sorted_, cuda)
    x = torch.randn(L, d, device=cuda).to(BF16)
    got = tsg.segment_sum_tiles(x, plan.offsets, plan.perm)
    _assert_ulps(got, tsg.segment_sum_plain(x, plan.offsets, plan.perm))
    assert torch.equal(got, tsg.segment_sum_tiles(x, plan.offsets, plan.perm))


@pytest.mark.parametrize("span", [1, 3, 200, 447])
@pytest.mark.parametrize("d", [8, 64, 128])
def test_bf16_gather_rows_window_is_exact(cuda, d, span):
    """Row 12 in bf16: 16-byte units of 8 values, bit for bit; rows of 4
    bf16 values (8 bytes) are refused."""
    rng = np.random.default_rng(24)
    L, S = 70_001, 9_000
    idx, window = (torch.as_tensor(a, device=cuda) for a in _window_case(rng, L, S, span))
    src = torch.randn(S, d, device=cuda).to(BF16)
    ops.reset_launch_counts()
    got = tsg.gather_rows_window(src, idx, window)
    assert ops.gather_rows_window.launches_bf16 == 1
    assert torch.equal(got, tsg.gather_rows_window_plain(src, idx, window))
    with pytest.raises(ValueError, match="4k floats"):
        tsg.gather_rows_window(src[:, :4].contiguous(), idx, window)


@pytest.mark.parametrize("with_aligned", [False, True], ids=["bare", "aligned"])
@pytest.mark.parametrize("n_gathered", [1, 3])
@pytest.mark.parametrize(
    "form,need_mask,need_params",
    [("message", False, False), ("message", True, False), ("message", True, True),
     ("update_w2", False, False), ("update_w2", False, True),
     ("update", False, False), ("update", False, True)],
)
def test_bf16_fused_pass_kernels_match_plain(cuda, form, need_mask, need_params,
                                             n_gathered, with_aligned):
    """Rows 13 and 14 in bf16, every form: the forward, d_total, d_weights
    and d_mask within one ulp of the plain version's largest value, the
    parameter gradients (with d_b1) within ``PARAM_ULPS``; equal bits run
    to run."""
    from chgnet_tpu_torch.ops import fused_pass as tfp

    x, p, tables, idxs, aligned, b1 = _pass_inputs(cuda, n_gathered, with_aligned)
    x = {k: v.to(BF16) for k, v in x.items()}
    p = {k: v.to(BF16) for k, v in p.items()}
    tables = [t.to(BF16) for t in tables]
    aligned = None if aligned is None else x["acc"]
    fwd, bwd = _pass_args(x, p, tables, idxs, aligned, b1.to(BF16), form, need_mask,
                          need_params)
    ops.reset_launch_counts()
    got = tfp.fused_pass_fwd(*fwd)
    _assert_ulps(got, tfp.fused_pass_fwd_plain(*fwd))
    grads = tfp.fused_pass_bwd(*bwd)
    want = tfp.fused_pass_bwd_plain(*bwd)
    assert (ops.fused_pass_fwd.launches_bf16, ops.fused_pass_bwd.launches_bf16) == (1, 1)
    _assert_ulps(grads[:3], want[:3])
    if need_params:
        _assert_ulps(grads[3], want[3], PARAM_ULPS)
    assert torch.equal(got, tfp.fused_pass_fwd(*fwd))
    assert all(torch.equal(a, b) for a, b in zip(
        _flat(grads), _flat(tfp.fused_pass_bwd(*bwd))) if a is not None)


@pytest.mark.parametrize("form", ["message", "update_w2", "update"])
@pytest.mark.parametrize("n_rows", [1, 17, 5_003])
@pytest.mark.parametrize("d", [16, 36])
def test_bf16_fused_pass_at_narrow_widths_and_ragged_rows(cuda, d, n_rows, form):
    """Rows 13 and 14 in bf16 with padded 8-column tiles and fewer rows than
    a tile, misaligned side rows (4-value units fall back to single
    values): one ulp."""
    from chgnet_tpu_torch.ops import fused_pass as tfp

    x, p, tables, idxs, aligned, b1 = _pass_inputs(cuda, 2, True, d=d, n_rows=n_rows)
    x = {k: v.to(BF16) for k, v in x.items()}
    p = {k: v.to(BF16) for k, v in p.items()}
    fwd, bwd = _pass_args(x, p, [t.to(BF16) for t in tables], idxs, x["acc"],
                          b1.to(BF16), form, True, False, side=_misaligned)
    _assert_ulps(tfp.fused_pass_fwd(*fwd), tfp.fused_pass_fwd_plain(*fwd))
    _assert_ulps(tfp.fused_pass_bwd(*bwd)[:3], tfp.fused_pass_bwd_plain(*bwd)[:3])


@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
def test_bf16_model_on_card_matches_cpu_and_f32(cuda, directed):
    """compute_dtype="bfloat16" at full width on LiMnO2: the card against
    the CPU's bf16 (both round once per kernel output, in other orders) and
    against the card's f32, at tests/test_model.py's bf16 bars (stress at
    2e-2 GPa; chip_smoke.py BF16_BARS)."""
    bars = {"e": 2e-3, "f": 2e-2, "s": 2e-2, "m": 2e-2}
    kw = dict(graph_converter_algorithm="numpy", directed_bonds=directed)
    bf16 = dict(compute_dtype="bfloat16", matmul_precision="default")
    struct = Structure.from_file(LIMNO2).perturb(0.05, seed=1)
    card = CHGNet(seed=0, device=cuda, **kw, **bf16).predict_structure(struct)
    cpu = CHGNet(seed=0, device="cpu", **kw, **bf16).predict_structure(struct)
    f32 = CHGNet(seed=0, device=cuda, **kw).predict_structure(struct)
    for key, bar in bars.items():
        for ref in (cpu, f32):
            err = float(np.abs(np.asarray(card[key]) - np.asarray(ref[key])).max())
            assert err <= bar, (key, err)


# ------------------------------------- one-sweep pair sum, group-lane update
def _pair_plans(rng, device, L, n_out, long_):
    """Stream a sorted, stream b a random permutation of its keys (no
    locality at all); ~10% of each stream's rows dropped and some keys past
    n_out. long_: only even keys, so every other segment is empty and the
    others hold ~75 rows (the kernel's long-segment launch); else ~1.3 rows
    a segment, about a quarter of them empty."""
    keys = rng.integers(0, n_out + 50, L)  # keys n_out .. n_out + 49 dropped
    if long_:
        keys = keys // 2 * 2
    a = np.sort(keys).astype(np.int32)
    b = rng.permutation(a).astype(np.int32)
    valid_a = np.arange(L) < int(0.9 * L)
    valid_b = rng.random(L) < 0.9
    return (_plan(a, valid_a, n_out, True, device),
            _plan(b, valid_b, n_out, False, device))


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,aligned", [(4, True), (64, True), (128, True),
                                       (4, False), (32, False), (3, True)])
@pytest.mark.parametrize("L,n_out,long_", [(40_000, 30_011, False),
                                           (40_000, 1_003, True)],
                         ids=["short", "long"])
def test_segment_sum_pair_one_sweep_matches_plain_and_csr(cuda, dtype, d, aligned,
                                                          L, n_out, long_):
    """Row 3 sums both streams in one sweep: each output equals
    segment_sum_csr's over its stream bit for bit (the same order and
    shuffle tree), and the plain version within SEG_ATOL (f32) or one ulp
    (bf16); widths 4 to 128 on the float4 route and up to 32 on the
    single-value route; n_out not a multiple of a block's 8 rows."""
    rng = np.random.default_rng(11)
    plan_a, plan_b = _pair_plans(rng, cuda, L, n_out, long_)
    x = torch.randn(L, d, device=cuda).to(dtype)
    if not aligned:
        x = _misaligned(x)
    args = (x, plan_a.offsets, plan_a.perm, plan_b.offsets, plan_b.perm)
    got = tsg.segment_sum_pair(*args)
    csr = (tsg.segment_sum_csr(x, plan_a.offsets, plan_a.perm),
           tsg.segment_sum_csr(x, plan_b.offsets, plan_b.perm))
    want = tsg.segment_sum_pair_plain(*args)
    for g, c, w in zip(got, csr, want):
        assert g.shape == (n_out, d) and g.dtype == dtype
        assert torch.equal(g, c)
        if dtype == BF16:
            _assert_ulps(g, w)
        else:
            torch.testing.assert_close(g, w, atol=SEG_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("long_", [False, True], ids=["short", "long"])
def test_segment_sum_pair_runs_give_equal_bits(cuda, dtype, long_):
    rng = np.random.default_rng(12)
    plan_a, plan_b = _pair_plans(rng, cuda, 1 << 17, 4_099 if long_ else 100_003,
                                 long_)
    x = torch.randn(1 << 17, 128, device=cuda).to(dtype)
    args = (x, plan_a.offsets, plan_a.perm, plan_b.offsets, plan_b.perm)
    first = tsg.segment_sum_pair(*args)
    second = tsg.segment_sum_pair(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_segment_sum_pair_with_no_valid_row_is_zero(cuda):
    offsets = torch.zeros(8_195, dtype=torch.int32, device=cuda)
    x = torch.randn(100, 64, device=cuda)
    for out in tsg.segment_sum_pair(x, offsets, offsets.new_zeros(0), offsets,
                                    offsets.new_zeros(0)):
        assert out.shape == (8_194, 64) and not out.any()


UPDATE_ROWS = [1, 3, 1_001, 65_537]  # a warp's rows at D = 8..64 do not divide


@pytest.mark.parametrize("n_rows", UPDATE_ROWS)
@pytest.mark.parametrize("d", [8, 12, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_update_forward_by_lane_groups_matches_plain(cuda, dtype, d, n_rows):
    """Row 8 without a second layer: a row per group of lanes, 16-byte
    loads (8-byte ones for bf16 at D = 12), ragged last group of rows;
    TAIL_FWD_TOL of the largest output in f32, one ulp in bf16."""
    x, p = _tail_inputs(cuda, d, n_rows)
    params = _params({k: v.to(dtype) for k, v in p.items()}, has_w2=False)
    args = (x["acc"].to(dtype), x["resnet"].to(dtype), params)
    got, want = tgm.gated_update_fwd(*args), tgm.gated_update_plain(*args)
    assert got.shape == (n_rows, d) and got.dtype == dtype
    if dtype == BF16:
        _assert_ulps(got, want)
    else:
        _assert_scaled([got], [want], TAIL_FWD_TOL)


@pytest.mark.parametrize("d", [8, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_update_forward_on_near_constant_rows_matches_plain(cuda, dtype, d):
    """Rows whose halves are almost constant (spread 1e-4 around a level of
    order 1): the layer norms' variance is about 0 and their inverse near
    1 / sqrt(eps), so the f32 rounding of the mean, in any order, is
    amplified some 300 times. f32: against the plain version evaluated in
    float64, within the larger of TAIL_FWD_TOL of its largest value and
    twice the f32 plain version's own error against it (no worse than
    PyTorch's f32 composition); bf16: one ulp of the plain version."""
    n_rows = 4_099
    x, p = _tail_inputs(cuda, d, n_rows)
    level = torch.randn(n_rows, 2, 1, device=cuda)
    noise = torch.randn(n_rows, 2, d, device=cuda) * 1e-4
    acc = (level + noise).reshape(n_rows, 2 * d).to(dtype)
    params = _params({k: v.to(dtype) for k, v in p.items()}, has_w2=False)
    args = (acc, x["resnet"].to(dtype), params)
    got, want = tgm.gated_update_fwd(*args), tgm.gated_update_plain(*args)
    assert torch.isfinite(got).all()
    if dtype == BF16:
        _assert_ulps(got, want)
        return
    exact = tgm.gated_update_plain(acc.double(), args[1].double(),
                                   tuple(t.double() for t in params))
    plain_err = float((want.double() - exact).abs().max())
    err = float((got.double() - exact).abs().max())
    assert err <= max(TAIL_FWD_TOL * float(exact.abs().max()), 2 * plain_err), (
        err, plain_err)


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_update_forward_with_misaligned_resnet_matches_plain_and_repeats(cuda, dtype):
    """resnet one element off a 16-byte boundary (read by elements); two
    runs give equal bits."""
    x, p = _tail_inputs(cuda, 64, 10_007)
    params = _params({k: v.to(dtype) for k, v in p.items()}, has_w2=False)
    resnet = _misaligned(x["resnet"].to(dtype))
    args = (x["acc"].to(dtype), resnet, params)
    got, want = tgm.gated_update_fwd(*args), tgm.gated_update_plain(*args)
    if dtype == BF16:
        _assert_ulps(got, want)
    else:
        _assert_scaled([got], [want], TAIL_FWD_TOL)
    assert torch.equal(got, tgm.gated_update_fwd(*args))
