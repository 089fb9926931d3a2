"""A model of the one-kernel pass's bf16 tiles, on the CPU, against float64.

The bf16 serving kernels of rows 13 and 14
(``tcp16::pass_fwd_bf16_kernel``, ``tcp16::pass_bwd_bf16_kernel``,
``chgnet_tpu_torch/csrc/fused_pass.cu``) copy the gathered and aligned rows
raw, as bf16, sum ``acc = sum_k T_k[idx_k] + aligned + b1`` in f32 in that
order as they build each product's A fragments (never rounding it to
bf16), and run y = silu(acc) @ W2 and d_h = d_y @ W2^T as two bf16 passes
of the f32 operand's hi = bf16(a) and lo = bf16(a - hi) on the bf16 tensor
cores; the rest is f32, and each output is rounded once to bf16. This file
models that arithmetic in plain torch, with no kernel and no JAX, at the
published width (D = 64), for K = 1-3 gathered parts (a few indices out of
range: zero rows), with and without an aligned part, the message form and
the update form with and without a second layer, and holds it against the
same function in float64 on the widened inputs:

* the part-order f32 sum of acc within the recursive-summation bound
  (n - 1) 2^-24 sum |terms| of its n terms, where a sum rounded to bf16
  after each part misses it (so the check can fail);
* each product within 2^-15 of sum |a w| (the split leaves a - hi - lo
  within 2^-18 of a);
* the forward's output, d_total and d_weights within one bf16 ulp (2^-7)
  of each output's largest value: the rounding budget that
  ``chip_smoke.py`` and ``tests/test_torch_port_cuda.py`` hold the kernels
  to against their plain versions.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

D = 64
L = 777  # rows: not a multiple of a warp's 16-row tile
S = (300, 500, 300)  # rows of the gathered tables
EPS = 1e-5
ULP = 2.0**-7
SPLIT_BOUND = 2.0**-15
U32 = 2.0**-24
BF16 = torch.bfloat16


def split_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [L, K] f32 @ w [K, N] (bf16 values), as two bf16 passes: the
    products of hi = bf16(a) and lo = bf16(a - hi) with w, summed in f32,
    lo first."""
    hi = a.to(BF16).float()
    lo = (a - hi).to(BF16).float()
    return lo @ w.float() + hi @ w.float()


def _inputs(n_parts: int, aligned: bool, form: str, seed: int):
    """bf16 inputs: tables, indices, aligned rows or None, b1, side rows,
    the cotangent and the tail's parameters (W2 unless form == "update")."""
    rng = np.random.default_rng(seed)

    def bf16(*shape, scale=1.0):
        return torch.tensor((rng.standard_normal(shape) * scale).astype(np.float32)).to(BF16)

    tables = [bf16(S[k], 2 * D) for k in range(n_parts)]
    idxs = [torch.tensor(rng.integers(-1, S[k] + 1, L).astype(np.int64))
            for k in range(n_parts)]
    p = {"ncs": bf16(D), "ncb": bf16(D, scale=0.1), "ngs": bf16(D), "ngb": bf16(D, scale=0.1)}
    if form != "update":
        p.update(w2c=bf16(D, D, scale=0.1), w2g=bf16(D, D, scale=0.1), b2=bf16(2 * D, scale=0.1))
    mask = torch.tensor((rng.random(L) < 0.9).astype(np.float32)).to(BF16)
    return dict(tables=tables, idxs=idxs, aligned=bf16(L, 2 * D) if aligned else None,
                b1=bf16(2 * D, scale=0.1), weights=bf16(L, D), mask=mask,
                resnet=bf16(L, D), g=bf16(L, D), p=p, msg=form == "message")


def _terms(x, dtype):
    """acc's terms in the tile's order: each gathered part (zero rows for an
    index out of range), the aligned part, b1, widened to dtype."""
    out = []
    for table, idx in zip(x["tables"], x["idxs"]):
        ok = (idx >= 0) & (idx < table.shape[0])
        rows = table.to(dtype)[idx.clamp(0, table.shape[0] - 1)]
        out.append(torch.where(ok[:, None], rows, torch.zeros((), dtype=dtype)))
    if x["aligned"] is not None:
        out.append(x["aligned"].to(dtype))
    out.append(x["b1"].to(dtype).expand(L, -1))
    return out


def tile_acc(x, round_each=False):
    """acc as the tile sums it: f32, from zero, each term in order; with
    round_each, rounded to bf16 after each add (what the tile must not do)."""
    acc = torch.zeros(L, 2 * D)
    for t in _terms(x, torch.float32):
        acc = acc + t
        if round_each:
            acc = acc.to(BF16).float()
    return acc


def _ln(y):
    mean = y.mean(-1, keepdim=True)
    inv = torch.rsqrt(((y - mean) ** 2).mean(-1, keepdim=True) + EPS)
    return (y - mean) * inv, inv


def _y(acc, p, product):
    if "w2c" not in p:
        return acc
    h = F.silu(acc)
    return torch.cat([product(h[:, :D], p["w2c"]), product(h[:, D:], p["w2g"])], 1) + p["b2"]


def tail(acc, x, p, product):
    """The pass's output from acc: the gate times weights and mask, or plus
    resnet, in acc's type."""
    dt = acc.dtype
    y = _y(acc, p, product)
    zc, _ = _ln(y[:, :D])
    zg, _ = _ln(y[:, D:])
    gate = F.silu(zc * p["ncs"] + p["ncb"]) * torch.sigmoid(zg * p["ngs"] + p["ngb"])
    if x["msg"]:
        return gate * x["weights"].to(dt) * x["mask"].to(dt)[:, None]
    return gate + x["resnet"].to(dt)


def emulated(x):
    """The kernels' arithmetic: (out, d_total, d_weights | None), each
    rounded once to bf16."""
    p = {k: v.float() for k, v in x["p"].items()}
    acc = tile_acc(x)
    out = tail(acc, x, p, split_product).to(BF16)
    y = _y(acc, p, split_product)
    zc, invc = _ln(y[:, :D])
    zg, invg = _ln(y[:, D:])
    cn = zc * p["ncs"] + p["ncb"]
    gn = zg * p["ngs"] + p["ngb"]
    sig_cn, sig_gn = torch.sigmoid(cn), torch.sigmoid(gn)
    silu_cn = cn * sig_cn
    up, d_weights = x["g"].float(), None
    if x["msg"]:
        m = x["mask"].float()[:, None]
        d_weights = (up * silu_cn * sig_gn * m).to(BF16)
        up = up * x["weights"].float() * m

    def ln_bwd(gz, z, inv):
        return (gz - gz.mean(-1, keepdim=True) - z * (gz * z).mean(-1, keepdim=True)) * inv

    d_y = torch.cat([
        ln_bwd(up * sig_gn * sig_cn * (1 + cn * (1 - sig_cn)) * p["ncs"], zc, invc),
        ln_bwd(up * silu_cn * sig_gn * (1 - sig_gn) * p["ngs"], zg, invg)], 1)
    if "w2c" not in p:
        return out, d_y.to(BF16), d_weights
    d_h = torch.cat([split_product(d_y[:, :D], p["w2c"].T),
                     split_product(d_y[:, D:], p["w2g"].T)], 1)
    s = torch.sigmoid(acc)
    return out, (d_h * s * (1 + acc * (1 - s))).to(BF16), d_weights


def reference(x):
    """The same function in float64 on the widened inputs, its gradients by
    autograd: (out, d_total, d_weights | None)."""
    p = {k: v.double() for k, v in x["p"].items()}
    acc = sum(_terms(x, torch.float64)).requires_grad_(True)
    weights = x["weights"].double().requires_grad_(True)
    out = tail(acc, dict(x, weights=weights), p, lambda a, w: a @ w)
    wrt = [acc, weights] if x["msg"] else [acc]
    grads = torch.autograd.grad(out, wrt, x["g"].double())
    return out.detach(), grads[0], grads[1] if x["msg"] else None


def _within_one_ulp(got, want):
    err = float((got.double() - want).abs().max())
    assert err <= ULP * float(want.abs().max()), err


CASES = [(k, a) for k in (1, 2, 3) for a in (False, True)]


@pytest.mark.parametrize("n_parts,aligned", CASES)
def test_part_order_f32_sum_stays_within_its_bound(n_parts, aligned):
    x = _inputs(n_parts, aligned, "message", seed=10 * n_parts + aligned)
    terms = _terms(x, torch.float64)
    want = sum(terms)
    bound = (len(terms) - 1) * U32 * sum(t.abs() for t in terms)
    assert bool(((tile_acc(x).double() - want).abs() <= bound).all())
    assert not bool(((tile_acc(x, round_each=True).double() - want).abs() <= bound).all())


@pytest.mark.parametrize("n_parts,aligned", CASES)
def test_split_products_of_the_summed_acc_stay_within_their_bound(n_parts, aligned):
    x = _inputs(n_parts, aligned, "message", seed=20 + 10 * n_parts + aligned)
    a = F.silu(tile_acc(x))[:, :D]
    w = x["p"]["w2c"]
    want = a.double() @ w.double()
    scale = a.abs().double() @ w.abs().double()
    for a_, w_, want_, scale_ in ((a, w, want, scale),
                                  (a, w.T, a.double() @ w.T.double(),
                                   a.abs().double() @ w.T.abs().double())):
        err = (split_product(a_, w_).double() - want_).abs() / scale_.clamp_min(1e-300)
        assert float(err.max()) <= SPLIT_BOUND


@pytest.mark.parametrize("form", ["message", "update_w2", "update"])
@pytest.mark.parametrize("n_parts,aligned", CASES)
def test_pass_tiles_stay_within_one_ulp_of_float64(n_parts, aligned, form):
    x = _inputs(n_parts, aligned, form, seed=100 + 10 * n_parts + aligned)
    got, want = emulated(x), reference(x)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == BF16 and bool(g.float().isfinite().all())
            _within_one_ulp(g, w)
