"""A model of the tails' backward with parameter gradients, on the CPU.

The backward with parameter gradients of rows 7 and 9 at D <= 64
(``tcb::tail_bwd_param_tc_kernel`` in f32, ``tcb16::tail_bwd_param_bf16_kernel``
in bf16, ``chgnet_tpu_torch/csrc/gated_message.cu``) splits the rows into
16-row tiles, gives each of ``n_blocks = min(ceil(L / TILE), PARAM_BLOCKS)``
blocks an even share of the tiles in order, and lets the block's warps take
them in rounds, one tile a warp. Per round the warps' tiles are added in
order into dW2 = silu(acc)^T d_y on the tensor cores, both operands split:
3xTF32 in f32 (hi = tf32(x), lo = tf32(x - hi); lo hi, hi lo, hi hi), three
bf16 passes in bf16 (hi = bf16(x), lo = bf16(x - hi)). The layer-norm
vectors' gradients are each tile's terms summed over a lane's two rows and
then over 8 lanes by a fixed tree, then over the warp's tiles, the block's
warps and the blocks, in f32. This file models that arithmetic in plain
torch, with no kernel and no JAX, at the published width (D = 64) on L = 777
rows (not a multiple of a tile), and checks:

* the partition: every row counted once, every block given a tile, for
  L in {1, 15, 16, 17, 777, 40,000}, with and without W2 (8 and 12 warps);
* dW2 by the split passes within 2^-19 (f32) and 2^-15 (bf16) of
  sum |h d_y| of each element, plus the recursive-summation bound of its L
  f32 adds, against float64; one bf16 pass of the hi parts misses that
  bound, so the check can fail;
* each vector sum in the kernel's grouping within the recursive-summation
  bound L 2^-24 sum |terms| of float64;
* the whole backward so modelled (the message form and the update form with
  and without W2) against float64 autograd: within 1e-4 of each output's
  largest value in f32, and in bf16 within one bf16 ulp (2^-7), the
  parameter gradients within one ulp plus 1e-4: the budget that
  ``chip_smoke.py`` and ``tests/test_torch_port_cuda.py`` hold the kernels
  to against their plain versions.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chgnet_tpu_torch.ops.gated_message import PARAM_BLOCKS, TILE

D = 64
L = 777
ROWS = 16  # a warp's tile
WARPS = {True: 8, False: 12}  # a block's warps with W2 and without
EPS = 1e-5
U32 = 2.0**-24
ULP = 2.0**-7
F32_TOL = 1e-4
SPLIT_BOUND = {"f32": 2.0**-19, "bf16": 2.0**-15}
BF16 = torch.bfloat16


def partition(n_rows: int, w2: bool) -> list[tuple[int, int, int, int]]:
    """(block, warp, round, tile) of every 16-row tile, as the kernels walk
    them: block b takes tiles [T b / B, T (b + 1) / B) of the T tiles, and in
    round k its warp w takes the block's tile k W + w."""
    n_tiles = -(-n_rows // ROWS)
    n_blocks = min(-(-n_rows // TILE), PARAM_BLOCKS)
    warps = WARPS[w2]
    out = []
    for b in range(n_blocks):
        first, last = n_tiles * b // n_blocks, n_tiles * (b + 1) // n_blocks
        for k in range(-(-(last - first) // warps)):
            for w in range(warps):
                if first + k * warps + w < last:
                    out.append((b, w, k, first + k * warps + w))
    return out


@pytest.mark.parametrize("w2", [True, False], ids=["w2", "no-w2"])
@pytest.mark.parametrize("n_rows", [1, 15, 16, 17, 777, 40_000])
def test_every_row_counts_once(n_rows, w2):
    parts = partition(n_rows, w2)
    rows = np.concatenate([np.arange(ROWS * t, min(ROWS * t + ROWS, n_rows))
                           for *_, t in parts])
    assert np.array_equal(np.sort(rows), np.arange(n_rows))
    n_blocks = min(-(-n_rows // TILE), PARAM_BLOCKS)
    assert {b for b, *_ in parts} == set(range(n_blocks))
    assert all(w < WARPS[w2] for _, w, _, _ in parts)


# ------------------------------------------------------------------ model
def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, to nearest with ties away (tf32x3.cuh to_tf32)."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & -8192
    return bits.view(torch.float32)


def split(x: torch.Tensor, kind: str):
    """(hi, lo) of an f32 operand: TF32 parts in f32, bf16 parts in bf16."""
    if kind == "f32":
        hi = tf32(x)
        return hi, tf32(x - hi)
    hi = x.to(BF16).float()
    return hi, (x - hi).to(BF16).float()


def product(a: torch.Tensor, w: torch.Tensor, kind: str) -> torch.Tensor:
    """a @ w as the tiles run y = silu(acc) @ W2 and d_h = d_y @ W2^T: in f32
    3xTF32 (lo hi, hi lo, hi hi); in bf16 the f32 a split against the bf16
    W2 (lo, then hi), each pass summed in f32."""
    a_hi, a_lo = split(a, kind)
    if kind == "bf16":
        return a_lo @ w + a_hi @ w
    w_hi, w_lo = split(w, kind)
    return a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi


def tile_product(h: torch.Tensor, dy: torch.Tensor, kind: str, acc: torch.Tensor,
                 passes=("lo hi", "hi lo", "hi hi")) -> torch.Tensor:
    """acc + h^T dy over one tile, its passes in order, each added in f32."""
    parts = {"hi": {}, "lo": {}}
    parts["hi"]["h"], parts["lo"]["h"] = split(h, kind)
    parts["hi"]["d"], parts["lo"]["d"] = split(dy, kind)
    for p in passes:
        a, b = p.split()
        acc = acc + parts[a]["h"].T @ parts[b]["d"]
    return acc


def blocked_dw(h, dy, kind, w2=True, passes=("lo hi", "hi lo", "hi hi")):
    """dW2 of one half: each block's tiles added in order into its own f32
    sum, then the blocks' sums in order (sum_blocks_kernel)."""
    n = h.shape[0]
    per_block = {}
    for b, _, _, t in sorted(partition(n, w2), key=lambda x: (x[0], x[2], x[1])):
        rows = slice(ROWS * t, min(ROWS * t + ROWS, n))
        per_block[b] = tile_product(h[rows], dy[rows], kind,
                                    per_block.get(b, torch.zeros(h.shape[1], dy.shape[1])),
                                    passes)
    total = torch.zeros(h.shape[1], dy.shape[1])
    for b in sorted(per_block):
        total = total + per_block[b]
    return total


def tile_tree(t: torch.Tensor) -> torch.Tensor:
    """The column sums of one tile's terms t [rows <= 16, C] as a lane group
    takes them: rows g and g + 8 into lane g, then pairs of lanes 4, 2, 1
    apart (prm::scatter8), in f32."""
    t = torch.cat([t, t.new_zeros(ROWS - t.shape[0], t.shape[1])])
    p = t[:8] + t[8:]
    s1 = p[:4] + p[4:]  # lanes 16 apart: gid bit 2
    s2 = s1[:2] + s1[2:]  # lanes 8 apart: gid bit 1
    return s2[0] + s2[1]  # lanes 4 apart: gid bit 0


def blocked_sums(t: torch.Tensor, w2: bool) -> torch.Tensor:
    """Column sums of t [L, C] in the kernels' grouping: each tile's tree,
    each warp's tiles in round order, the block's warps in warp order, the
    blocks in order; all in f32."""
    n = t.shape[0]
    warp_sums = {}
    for b, w, _, tile in sorted(partition(n, w2), key=lambda x: (x[0], x[1], x[2])):
        s = tile_tree(t[ROWS * tile: ROWS * tile + ROWS])
        warp_sums[b, w] = warp_sums.get((b, w), torch.zeros(t.shape[1])) + s
    total = torch.zeros(t.shape[1])
    for b in sorted({b for b, _ in warp_sums}):
        block = torch.zeros(t.shape[1])
        for w in range(WARPS[w2]):
            block = block + warp_sums.get((b, w), torch.zeros(t.shape[1]))
        total = total + block
    return total


def _inputs(form: str, kind: str, seed: int):
    rng = np.random.default_rng(seed)

    def rand(*shape, scale=1.0):
        x = torch.tensor((rng.standard_normal(shape) * scale).astype(np.float32))
        return x.to(BF16).float() if kind == "bf16" else x

    p = {"ncs": rand(D), "ncb": rand(D, scale=0.1), "ngs": rand(D), "ngb": rand(D, scale=0.1)}
    if form != "update":
        p.update(w2c=rand(D, D, scale=0.2), w2g=rand(D, D, scale=0.2), b2=rand(2 * D, scale=0.1))
    mask = torch.tensor((rng.random(L) < 0.9).astype(np.float32))
    return dict(acc=rand(L, 2 * D), weights=rand(L, D), mask=mask, g=rand(L, D), p=p,
                msg=form == "message", w2=form != "update")


def _ln(y):
    mean = y.mean(-1, keepdim=True)
    inv = torch.rsqrt(((y - mean) ** 2).mean(-1, keepdim=True) + EPS)
    return (y - mean) * inv, inv


def emulated(x, kind):
    """The kernel's arithmetic in f32: (d_acc, d_weights | None, d_mask |
    None, d_params), in the inputs' type (each output rounded once in
    bf16)."""
    p, acc = x["p"], x["acc"]
    h = F.silu(acc)
    y = acc
    if x["w2"]:
        y = torch.cat([product(h[:, :D], p["w2c"], kind),
                       product(h[:, D:], p["w2g"], kind)], 1) + p["b2"]
    zc, invc = _ln(y[:, :D])
    zg, invg = _ln(y[:, D:])
    cn, gn = zc * p["ncs"] + p["ncb"], zg * p["ngs"] + p["ngb"]
    sig_cn, sig_gn = torch.sigmoid(cn), torch.sigmoid(gn)
    silu_cn = cn * sig_cn
    up, d_weights, d_mask = x["g"], None, None
    if x["msg"]:
        m = x["mask"][:, None]
        d_weights = up * silu_cn * sig_gn * m
        d_mask = (up * silu_cn * sig_gn * x["weights"]).sum(-1)
        up = up * x["weights"] * m
    dcn = up * sig_gn * (sig_cn * (1 + cn * (1 - sig_cn)))
    dgn = up * silu_cn * sig_gn * (1 - sig_gn)

    def ln_bwd(gz, z, inv):
        return (gz - gz.mean(-1, keepdim=True) - z * (gz * z).mean(-1, keepdim=True)) * inv

    d_y = torch.cat([ln_bwd(dcn * p["ncs"], zc, invc), ln_bwd(dgn * p["ngs"], zg, invg)], 1)
    terms = torch.cat([dcn * zc, dcn, dgn * zg, dgn], 1)
    vec = blocked_sums(terms, x["w2"]).view(4, D)
    d_params = tuple(vec)
    if x["w2"]:
        d_h = torch.cat([product(d_y[:, :D], p["w2c"].T, kind),
                         product(d_y[:, D:], p["w2g"].T, kind)], 1)
        s = torch.sigmoid(acc)
        d_acc = d_h * s * (1 + acc * (1 - s))
        d_params = (blocked_dw(h[:, :D], d_y[:, :D], kind),
                    blocked_dw(h[:, D:], d_y[:, D:], kind),
                    blocked_sums(d_y, True)) + d_params
    else:
        d_acc = d_y
    out = (d_acc, d_weights, d_mask, d_params)
    if kind == "bf16":
        out = (d_acc.to(BF16), None if d_weights is None else d_weights.to(BF16),
               None if d_mask is None else d_mask.to(BF16),
               tuple(t.to(BF16) for t in d_params))
    return out


def reference(x):
    """The same function in float64, its gradients by autograd."""
    p = {k: v.double().requires_grad_(True) for k, v in x["p"].items()}
    acc = x["acc"].double().requires_grad_(True)
    weights = x["weights"].double().requires_grad_(True)
    mask = x["mask"].double().requires_grad_(True)
    y = acc
    if x["w2"]:
        h = F.silu(acc)
        y = torch.cat([h[:, :D] @ p["w2c"], h[:, D:] @ p["w2g"]], 1) + p["b2"]
    zc, _ = _ln(y[:, :D])
    zg, _ = _ln(y[:, D:])
    out = F.silu(zc * p["ncs"] + p["ncb"]) * torch.sigmoid(zg * p["ngs"] + p["ngb"])
    if x["msg"]:
        out = out * weights * mask[:, None]
    keys = (["w2c", "w2g", "b2"] if x["w2"] else []) + ["ncs", "ncb", "ngs", "ngb"]
    wrt = [acc] + ([weights, mask] if x["msg"] else []) + [p[k] for k in keys]
    grads = torch.autograd.grad(out, wrt, x["g"].double())
    if x["msg"]:
        return grads[0], grads[1], grads[2], tuple(grads[3:])
    return grads[0], None, None, tuple(grads[1:])


FORMS = ["message", "update_w2", "update"]


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_split_passes_of_dw2_stay_within_their_bound(kind):
    x = _inputs("message", kind, seed=3)
    h = F.silu(x["acc"])[:, :D]
    dy = torch.tensor(np.random.default_rng(4).standard_normal((L, D)).astype(np.float32))
    want = h.double().T @ dy.double()
    scale = h.abs().double().T @ dy.abs().double()
    bound = (SPLIT_BOUND[kind] + (L - 1) * U32) * scale
    assert bool(((blocked_dw(h, dy, kind).double() - want).abs() <= bound).all())
    one_pass = blocked_dw(h, dy, "bf16", passes=("hi hi",))
    assert not bool(((one_pass.double() - want).abs() <= bound).all())


@pytest.mark.parametrize("w2", [True, False], ids=["w2", "no-w2"])
def test_vector_sums_stay_within_the_recursive_summation_bound(w2):
    rng = np.random.default_rng(5 + w2)
    t = torch.tensor((rng.standard_normal((L, 4 * D)) * rng.random((L, 1)) * 4).astype(np.float32))
    want = t.double().sum(0)
    bound = L * U32 * t.abs().double().sum(0)
    assert bool(((blocked_sums(t, w2).double() - want).abs() <= bound).all())
    # a tile counted twice or dropped moves a sum by far more
    assert not bool(((blocked_sums(t[: L - 16], w2).double() - want).abs() <= bound).all())


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("form", FORMS)
def test_param_tiles_stay_within_the_kernels_tolerance_of_float64(form, kind):
    x = _inputs(form, kind, seed=100 + FORMS.index(form))
    got, want = emulated(x, kind), reference(x)
    flat_got = [got[0], got[1], got[2], *got[3]]
    flat_want = [want[0], want[1], want[2], *want[3]]
    assert len(flat_got) == len(flat_want)
    for i, (g, w) in enumerate(zip(flat_got, flat_want)):
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert bool(g.float().isfinite().all())
        err = float((g.double() - w).abs().max())
        if kind == "f32":
            tol = F32_TOL
        else:
            tol = ULP + (F32_TOL if i >= 3 else 0.0)
        assert err <= tol * float(w.abs().max()), (i, err)
