"""The numeric argument of the bf16 tensor-core kernels' products, on the CPU.

The bf16 serving backward of rows 7 and 9 (``tcb16::tail_bwd_bf16_kernel``,
``chgnet_tpu_torch/csrc/gated_message.cu``) computes y = silu(acc) @ W2 and
d_h = d_y @ W2^T on the bf16 tensor cores, and the bf16 message forward of
row 6 (``tcb16::tail_fwd_bf16_kernel``) y = silu(acc) @ W2: the A operand
is an f32 value a, W2 holds bf16 values (exact), and a splits into hi =
bf16(a) and lo = bf16(a - hi), two passes summed in f32
(``csrc/bf16_tile.cuh``). The bf16 long route of row 4
(``gproj_bf16_tc_kernel``, ``csrc/gproj.cu``) multiplies bf16 rows by a
bf16 W in one pass a 16-deep step, its sums started from the stream rows.
This file emulates those products in plain torch, with no kernel, and
checks at the published width (D = 64):

* one bf16 pass of bf16 operands stays within 2^-20 of the f32 product of
  the widened values, relative to sum |a w| of each output: the products
  are exact, only the f32 adds round;
* the long route emulated so, with an out-of-range index and two pairs that
  share an index stream, stays within one bf16 ulp of each output's
  largest value of chgnet_tpu's ``gather_project_sum`` in bf16 (its Pallas
  kernel ``_gproj_pallas`` in interpret mode), on the same seeded inputs;
* the message forward on the split product (y kept in f32, each message
  rounded once) stays within one ulp of chgnet_tpu's ``_forward`` in bf16
  (interpret mode), on masked and weighted rows;

* it stays within 2^-15 of the f32 product, relative to sum |a w| of each
  output (the split leaves a - hi - lo within 2^-18 of a);
* one bf16 pass (a rounded to bf16 before the product) misses that bound,
  so the check can fail;
* the tails' backward built on the split product, with bf16 inputs and
  each output rounded once, stays within one bf16 ulp (2^-7) of each
  output's largest value of chgnet_tpu's tail backward in bf16
  (``chgnet_tpu/ops/gated_message.py`` ``_backward`` / ``_backward_nw``,
  its Pallas kernels in interpret mode), on the same seeded inputs: the
  rounding budget ``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``
  hold the kernel to.
"""

from __future__ import annotations

import functools as ft

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chgnet_tpu.ops import gated_message as jgm
from chgnet_tpu.ops import gproj as jgp
from chgnet_tpu.ops import scatter as jsc
from chgnet_tpu.ops import stream_ops as so

D = 64  # the published width
L = 4096  # rows of the product checks
L_TAIL = 300  # rows of the tails (chgnet_tpu's Pallas kernels interpreted)
SPLIT_BOUND = 2.0**-15
PASS_BOUND = 2.0**-20  # one pass of bf16 operands: only the f32 adds round
ULP = 2.0**-7
BF16 = torch.bfloat16


def split_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [L, K] f32 @ w [K, N] (bf16 values) as the tile takes it: the
    products of hi = bf16(a) and lo = bf16(a - hi) with w, summed in f32,
    lo first."""
    hi = a.to(BF16).float()
    lo = (a - hi).to(BF16).float()
    w = w.float()
    return lo @ w + hi @ w


def one_pass_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One bf16 pass: a rounded to bf16 before the product."""
    return a.to(BF16).float() @ w.float()


def _rel_to_abs_sum(got: torch.Tensor, a: torch.Tensor, w: torch.Tensor) -> float:
    """max |got - a @ w (f32)| / (|a| @ |w|), over every output."""
    want = (a @ w.float()).double()
    scale = a.abs().double() @ w.float().abs().double()
    return float(((got.double() - want).abs() / scale.clamp_min(1e-300)).max())


def _operands(kind: str, seed: int):
    """An A operand as the tile sees it: silu(acc) of unit normals, or a
    d_y-like operand whose magnitudes spread over several octaves; W a
    bf16 matrix of the tails' scale."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((L, D)).astype(np.float32))
    if kind == "silu(acc)":
        a = F.silu(x.to(BF16).float())
    else:
        spread = np.exp(rng.standard_normal((L, D)) * 2.0).astype(np.float32)
        a = x * torch.tensor(spread)
    w = torch.tensor((rng.standard_normal((D, D)) * 0.1).astype(np.float32)).to(BF16)
    return a, w


@pytest.mark.parametrize("kind", ["silu(acc)", "d_y"])
def test_split_product_stays_within_its_bound(kind):
    a, w = _operands(kind, 3)
    assert _rel_to_abs_sum(split_product(a, w), a, w) <= SPLIT_BOUND
    assert _rel_to_abs_sum(split_product(a, w.T), a, w.T) <= SPLIT_BOUND  # d_y @ W^T


@pytest.mark.parametrize("kind", ["silu(acc)", "d_y"])
def test_one_bf16_pass_misses_the_bound(kind):
    a, w = _operands(kind, 3)
    assert _rel_to_abs_sum(one_pass_product(a, w), a, w) > SPLIT_BOUND


# ------------------------------------------------------------- the tails
def _silu_grad(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _ln_parts(x, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    inv = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + eps)
    return (x - mean) * inv, inv


def _ln_bwd(g_out, z, inv, scale):
    gz = g_out * scale
    return (gz - gz.mean(-1, keepdim=True) - z * (gz * z).mean(-1, keepdim=True)) * inv


def emulated_backward(acc, g, p, weights=None, mask=None):
    """The serving backward of a message tail (with ``weights`` and
    ``mask``) or an update tail (W2 in ``p`` or y = acc) on bf16 inputs:
    f32 inside, both products by ``split_product``, each output rounded
    once to bf16. Returns (d_acc, d_weights | None)."""
    acc, g = acc.float(), g.float()
    p = {k: v.float() for k, v in p.items()}
    d = g.shape[1]
    if "w2c" in p:
        h = F.silu(acc)
        y = torch.cat([split_product(h[:, :d], p["w2c"]),
                       split_product(h[:, d:], p["w2g"])], 1) + p["b2"]
    else:
        y = acc
    zc, invc = _ln_parts(y[:, :d])
    zg, invg = _ln_parts(y[:, d:])
    cn = zc * p["nc_scale"] + p["nc_bias"]
    gn = zg * p["ng_scale"] + p["ng_bias"]
    silu_cn, sig_gn = F.silu(cn), torch.sigmoid(gn)
    up = g
    d_weights = None
    if weights is not None:
        m = mask.float()[:, None]
        up = g * weights.float() * m
        d_weights = (g * silu_cn * sig_gn * m).to(BF16)
    d_y = torch.cat([
        _ln_bwd(up * sig_gn * _silu_grad(cn), zc, invc, p["nc_scale"]),
        _ln_bwd(up * silu_cn * sig_gn * (1.0 - sig_gn), zg, invg, p["ng_scale"]),
    ], 1)
    if "w2c" not in p:
        return d_y.to(BF16), d_weights
    d_h = torch.cat([split_product(d_y[:, :d], p["w2c"].T),
                     split_product(d_y[:, d:], p["w2g"].T)], 1)
    return (d_h * _silu_grad(acc)).to(BF16), d_weights


def _bf16(rng, *shape, scale=1.0):
    """f32 normals rounded to bf16 once: (jax array, torch tensor), equal."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(BF16)


def _within_one_ulp(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= ULP * float(np.abs(want).max()), err


@pytest.mark.parametrize("form", ["message", "update-w2", "update"])
def test_backward_on_the_split_product_matches_chgnet_tpu_in_bf16(form):
    rng = np.random.default_rng(11)
    (ja, ta), (jg, tg) = _bf16(rng, L_TAIL, 2 * D), _bf16(rng, L_TAIL, D)
    jp, tp = {}, {}
    if form != "update":
        for k in ("w2c", "w2g"):
            jp[k], tp[k] = _bf16(rng, D, D, scale=0.1)
        jp["b2"], tp["b2"] = _bf16(rng, 2 * D, scale=0.1)
    for k, scale in (("nc_scale", 1.0), ("nc_bias", 0.1), ("ng_scale", 1.0),
                     ("ng_bias", 0.1)):
        jp[k], tp[k] = _bf16(rng, D, scale=scale)
    jp2 = {k: jp[k] for k in ("nc_scale", "nc_bias", "ng_scale", "ng_bias")}
    if form != "update":
        jp2["w2"] = jax.scipy.linalg.block_diag(jp["w2c"], jp["w2g"])
        jp2["b2"] = jp["b2"]
    if form == "message":
        (jw, tw) = _bf16(rng, L_TAIL, D)
        m = (rng.random(L_TAIL) < 0.9).astype(np.float32)
        jm, tm = jnp.asarray(m, jnp.bfloat16), torch.tensor(m).to(BF16)
        d_acc, d_w, *_ = jgm._backward(ja, jw, jm, jp2, jg, interpret=True)
        got = emulated_backward(ta, tg, tp, tw, tm)
        _within_one_ulp(got[1], d_w)
    else:
        d_acc = jgm._backward_nw(ja, jp2, jg, interpret=True)[0]
        got = emulated_backward(ta, tg, tp)
    _within_one_ulp(got[0], d_acc)


# ------------------------------------------ products of two bf16 operands
def bf16_pass(a: torch.Tensor, w: torch.Tensor, c: torch.Tensor | None = None):
    """c + a @ w for bf16 values a [L, K] and w [K, N] as the tensor cores
    take it: one pass a 16-deep step, each step's products (exact in f32)
    summed in f32 and added to the f32 accumulator c (zero when None)."""
    a, w = a.float(), w.float()
    c = a.new_zeros(a.shape[0], w.shape[1]) if c is None else c
    for k in range(0, a.shape[1], 16):
        c = c + a[:, k:k + 16] @ w[k:k + 16]
    return c


@pytest.mark.parametrize("k_out", [2 * D, 60])
def test_one_pass_of_bf16_operands_stays_within_f32_rounding(k_out):
    rng = np.random.default_rng(4)
    a = torch.tensor(rng.standard_normal((L, D)).astype(np.float32)).to(BF16)
    w = torch.tensor((rng.standard_normal((D, k_out)) * 0.1).astype(np.float32)).to(BF16)
    got = bf16_pass(a, w)
    assert _rel_to_abs_sum(got, a.float(), w) <= PASS_BOUND
    # against the f32 product of the widened values, the same bound twice
    want = a.float() @ w.float()
    scale = (a.float().abs() @ w.float().abs()).clamp_min(1e-30)
    assert float(((got - want).abs() / scale).max()) <= 2 * PASS_BOUND


# ----------------------------------------------- row 4's bf16 long route
L_GPROJ, S_GPROJ = 1024, 512  # chgnet_tpu's kernel takes L in 512-row blocks


@pytest.fixture()
def interp(monkeypatch):
    """chgnet_tpu's TPU gates open, its gather-project kernel in interpret
    mode (the pattern of tests/test_torch_port_bf16.py)."""
    monkeypatch.setattr(so, "tpu_backend", lambda: True)
    monkeypatch.setattr(jgp, "_gproj_pallas", ft.partial(jgp._gproj_pallas, interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


def emulated_long_route(tables, idxs, ws, stream) -> torch.Tensor:
    """The long route as ``gproj_bf16_tc_kernel`` computes it: f32 sums
    started from the stream rows, each pair's gathered bf16 rows (zero rows
    for indices outside the table) times its bf16 W by :func:`bf16_pass`,
    in pair order, rounded once to bf16."""
    out = stream.float()
    for table, idx, w in zip(tables, idxs, ws):
        n_src = table.shape[0]
        ok = ((idx >= 0) & (idx < n_src))[:, None]
        rows = torch.where(ok, table[idx.clamp(0, n_src - 1).long()].float(), 0.0)
        out = bf16_pass(rows, w, out)
    return out.to(BF16)


def test_long_route_on_one_bf16_pass_matches_chgnet_tpu_in_bf16(interp):
    """The last rows of stream ia are padding: out of range (-1) for the
    emulation, whose kernel gathers them as zero rows; chgnet_tpu takes no
    negative index (its batches point padding at a valid row), so it gets
    the tables' last row there, which is zero in both tables."""
    rng = np.random.default_rng(12)
    ia = np.sort(rng.integers(0, S_GPROJ - 1, L_GPROJ)).astype(np.int32)
    ib = rng.integers(0, S_GPROJ - 1, L_GPROJ).astype(np.int32)
    ia[-5:] = S_GPROJ - 1
    tabs = []
    for _ in range(2):
        x = rng.standard_normal((S_GPROJ, D)).astype(np.float32)
        x[-1] = 0.0
        tabs.append((jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(BF16)))
    (j1, t1), (j2, t2) = tabs
    ws = [_bf16(rng, D, 2 * D, scale=0.1) for _ in range(3)]
    js, ts = _bf16(rng, L_GPROJ, 2 * D)
    every = np.ones(L_GPROJ, bool)
    pa = jsc.make_plan(ia, every, S_GPROJ, assume_sorted=True)
    pb = jsc.make_plan(ib, every, S_GPROJ)
    ia_j, ib_j = jnp.asarray(ia), jnp.asarray(ib)
    # pairs 0 and 2 share the index stream ia (and 0 and 1 the table)
    parts = [(j1, ia_j, pa), (j1, ib_j, pb), (js, None, None), (j2, ia_j, pa)]
    eye = jnp.eye(2 * D, dtype=jnp.bfloat16)
    want = jgp.gather_project_sum(parts, [w[0] for w in ws], None, [eye])
    ia_t, ib_t = torch.tensor(ia), torch.tensor(ib)
    ia_t[-5:] = -1
    got = emulated_long_route([t1, t1, t2], [ia_t, ib_t, ia_t], [w[1] for w in ws], ts)
    _within_one_ulp(got, want)


# --------------------------------------------- row 6's bf16 message forward
def emulated_forward(acc, weights, mask, p) -> torch.Tensor:
    """The message forward as ``tail_fwd_bf16_kernel`` computes it on bf16
    inputs: y = b2 + silu(acc) @ W2 by :func:`split_product`, kept in f32,
    the layer norms and the gate in f32, each message rounded once."""
    acc = acc.float()
    p = {k: v.float() for k, v in p.items()}
    d = weights.shape[1]
    h = F.silu(acc)
    y = torch.cat([split_product(h[:, :d], p["w2c"]),
                   split_product(h[:, d:], p["w2g"])], 1) + p["b2"]
    zc, _ = _ln_parts(y[:, :d])
    zg, _ = _ln_parts(y[:, d:])
    cn = zc * p["nc_scale"] + p["nc_bias"]
    gn = zg * p["ng_scale"] + p["ng_bias"]
    msg = F.silu(cn) * torch.sigmoid(gn) * weights.float() * mask.float()[:, None]
    return msg.to(BF16)


def test_message_forward_on_the_split_product_matches_chgnet_tpu_in_bf16():
    rng = np.random.default_rng(13)
    (ja, ta), (jw, tw) = _bf16(rng, L_TAIL, 2 * D), _bf16(rng, L_TAIL, D)
    m = (rng.random(L_TAIL) < 0.9).astype(np.float32)
    m[:40] = 0.0  # whole masked tiles
    jm, tm = jnp.asarray(m, jnp.bfloat16), torch.tensor(m).to(BF16)
    jp, tp = {}, {}
    for k in ("w2c", "w2g"):
        jp[k], tp[k] = _bf16(rng, D, D, scale=0.1)
    jp["b2"], tp["b2"] = _bf16(rng, 2 * D, scale=0.1)
    for k, scale in (("nc_scale", 1.0), ("nc_bias", 0.1), ("ng_scale", 1.0),
                     ("ng_bias", 0.1)):
        jp[k], tp[k] = _bf16(rng, D, scale=scale)
    jp2 = {k: jp[k] for k in ("nc_scale", "nc_bias", "ng_scale", "ng_bias", "b2")}
    jp2["w2"] = jax.scipy.linalg.block_diag(jp["w2c"], jp["w2g"])
    want = jgm._forward(ja, jw, jm, jp2, interpret=True)
    got = emulated_forward(ta, tw, tm, tp)
    _within_one_ulp(got, want)
    assert not bool(got[:40].float().abs().max())
