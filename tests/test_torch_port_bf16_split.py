"""The numeric argument of the bf16 serving backward's products, on the CPU.

The bf16 serving backward of rows 7 and 9 (``tcb16::tail_bwd_bf16_kernel``,
``chgnet_tpu_torch/csrc/gated_message.cu``) computes y = silu(acc) @ W2 and
d_h = d_y @ W2^T on the bf16 tensor cores: its A operand is an f32 value
a, W2 holds bf16 values (exact), and a splits into hi = bf16(a) and lo =
bf16(a - hi), two passes summed in f32 (``csrc/bf16_tile.cuh``). This file
emulates that product in plain torch, with no kernel, and checks at the
published width (D = 64):

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chgnet_tpu.ops import gated_message as jgm

D = 64  # the published width
L = 4096  # rows of the product checks
L_TAIL = 300  # rows of the tails (chgnet_tpu's Pallas kernels interpreted)
SPLIT_BOUND = 2.0**-15
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
