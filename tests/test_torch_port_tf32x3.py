"""The numerics of the port's tensor-core products, emulated in numpy.

The redesigned message-tail forward, backward and message-reduce and the
gather-project-sum kernels (``chgnet_tpu_torch/csrc/tf32x3.cuh``) multiply
f32 matrices on the TF32
tensor cores with the 3xTF32 split: hi = tf32(x) (round to nearest, ties
away: ``(bits + 0x1000) & 0xFFFFE000``), lo = tf32(x - hi), and per 8-deep
step of k the terms lo_a hi_b, hi_a lo_b, hi_a hi_b added to an f32
accumulator in that order. This emulation (each 8-deep partial exact in
float64, the accumulator rounded to f32 after every term) holds the split
against a float64 product at the kernels' shapes, under the tolerances that
``chip_smoke.py``'s ``KERNELS`` set for those kernels (2e-5 gather-project-
sum, 1e-5 forward and 1e-4 backward tails, relative to the output's
largest value), and shows that a single TF32 product would not be. A model
of the whole message-forward tile (``tail_fwd_tc_kernel``: y = b2 + the
3xTF32 product over 16-row tiles, two-pass layer norms, the gate, weights
and mask, all in f32) is held against a float64 forward, and a model of the
one-kernel pass's serving tiles (``csrc/fused_pass.cu``: the gathered acc,
then the forward and the serving backward of each form) against float64.
Runs on the CPU; no card, no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest

from chgnet_tpu_torch.ops import gproj

GPROJ_TOL = 2e-5
TAIL_FWD_TOL = 1e-5
TAIL_BWD_TOL = 1e-4


def tf32(x: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away: what
    ``cvt.rna.tf32.f32`` gives."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tc_product(a: np.ndarray, b: np.ndarray, split: bool, init=None) -> np.ndarray:
    """``init + a @ b`` as the tensor cores compute it: 3xTF32 with
    ``split``, else one TF32 product, f32 accumulation from ``init`` (a row
    broadcast over the rows; zero by default) over 8-deep steps of k."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if split else [(a_hi, b_hi)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    if init is not None:
        acc += np.asarray(init, np.float32)
    for k in range(0, a.shape[1], 8):
        for x, y in terms:
            part = x[:, k: k + 8].astype(np.float64) @ y[k: k + 8].astype(np.float64)
            acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def _silu(x):
    return x / (1.0 + np.exp(-x))


def _case(name: str):
    """(A, B, tolerance) at a kernel's shapes and the model's scales: the
    tail's h = silu(acc) @ W2 and d_y @ W2^T ([2,500, 64] @ [64, 64]), and
    gather-project-sum's gathered rows @ W ([4,096, 64] @ [64, 128])."""
    rng = np.random.default_rng(0)
    if name == "tail forward":
        a, b, tol = _silu(rng.standard_normal((2_500, 64))), rng.standard_normal(
            (64, 64)) * 0.1, TAIL_FWD_TOL
    elif name == "tail backward":
        a, b, tol = rng.standard_normal((2_500, 64)), (
            rng.standard_normal((64, 64)) * 0.1).T, TAIL_BWD_TOL
    else:
        a, b, tol = rng.standard_normal((4_096, 64)), rng.standard_normal(
            (64, 128)) * 0.1, GPROJ_TOL
    return a.astype(np.float32), np.ascontiguousarray(b, np.float32), tol


def _scaled_error(got, a, b) -> float:
    want = a.astype(np.float64) @ b.astype(np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


CASES = ["tail forward", "tail backward", "gproj"]


@pytest.mark.parametrize("name", CASES)
def test_three_tf32_products_stay_under_the_kernel_tolerance(name):
    a, b, tol = _case(name)
    err = _scaled_error(tc_product(a, b, split=True), a, b)
    # f32's own rounding of 64-term sums: well under every tolerance
    assert err < 1e-6 < tol, err


@pytest.mark.parametrize("name", CASES)
def test_one_tf32_product_is_not_accurate_enough(name):
    """Why three products: one keeps ~11 bits of each operand, and its error
    is above even the backward tails' 1e-4."""
    a, b, _ = _case(name)
    err = _scaled_error(tc_product(a, b, split=False), a, b)
    assert err > TAIL_BWD_TOL, err


def test_tf32_rounding_is_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1.0
    x = np.array([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23, -1.0 - ulp / 2,
                  1.0 + 3 * ulp / 4], np.float32)
    want = np.array([1.0, 1.0 + ulp, 1.0, -1.0 - ulp, 1.0 + ulp], np.float32)
    np.testing.assert_array_equal(tf32(x), want)
    # hi + lo carries x to f32 precision less the lo term's own rounding
    hi = tf32(x)
    assert np.abs(hi + tf32(x - hi) - x).max() <= 2.0 ** -21


@pytest.mark.parametrize(
    "n_pairs,n_src,route",
    [(2, 7_680, "short"), (3, 647_168, "long"), (3, 7_680, "short"),
     (1, 60_000, "long")],
    ids=["atom-conv", "bond-side", "three-short", "one-long"],
)
def test_gproj_route_follows_the_l2_threshold(n_pairs, n_src, route):
    """The benchmark's AtomConv calls (2 pairs over 7,680 atoms) project
    first, its bond-side calls (3 pairs over 647,168 edges) gather first;
    60,000 rows are over the threshold even for one pair."""
    assert gproj.gproj_route(n_pairs, n_src, 128) == route
    fits = n_pairs * n_src * 128 * 4 <= gproj.SHORT_TABLE_BYTES
    assert fits == (route == "short")


# ------------------------------------------- the message forward's tile
TILE_ROWS = 16  # rows of a warp's tile in tail_fwd_tc_kernel


def _ln_f32(y: np.ndarray) -> np.ndarray:
    """Two-pass layer norm in f32: the mean, then the centred variance."""
    d = np.float32(y.shape[1])
    mean = (y.sum(axis=1, dtype=np.float32) / d)[:, None]
    c = y - mean
    var = (c * c).sum(axis=1, dtype=np.float32) / d
    return c * (np.float32(1) / np.sqrt(var + np.float32(1e-5)))[:, None]


def _gate_f32(zc, zg, p):
    cn = zc * p["ncs"] + p["ncb"]
    gn = zg * p["ngs"] + p["ngb"]
    return (cn / (np.float32(1) + np.exp(-cn))) * (np.float32(1) / (np.float32(1) + np.exp(-gn)))


def message_tile_model(acc, weights, mask, p) -> np.ndarray:
    """The message forward as ``tail_fwd_tc_kernel`` computes it: the rows
    in 16-row tiles (the last one ragged, its missing rows zero), y = b2 +
    silu(acc) @ W per half on the tensor cores (3xTF32, the accumulator
    starting at b2), the two-pass layer norms, the gate, weights and mask,
    all in f32."""
    n_rows, d = weights.shape
    n_pad = -n_rows % TILE_ROWS
    acc = np.concatenate([acc, np.zeros((n_pad, 2 * d), np.float32)])
    h = acc * (np.float32(1) / (np.float32(1) + np.exp(-acc)))
    yc = tc_product(h[:, :d], p["w2c"], split=True, init=p["b2"][:d])
    yg = tc_product(h[:, d:], p["w2g"], split=True, init=p["b2"][d:])
    assert yc.shape[0] % TILE_ROWS == 0
    gate = _gate_f32(_ln_f32(yc), _ln_f32(yg), p)[:n_rows]
    return gate * weights * mask[:, None]


def message_f64(acc, weights, mask, p) -> np.ndarray:
    """The message tail in float64."""
    d = weights.shape[1]
    acc, f = acc.astype(np.float64), {k: v.astype(np.float64) for k, v in p.items()}
    h = acc / (1.0 + np.exp(-acc))
    y = np.concatenate([h[:, :d] @ f["w2c"], h[:, d:] @ f["w2g"]], axis=1) + f["b2"]

    def ln(x):
        c = x - x.mean(axis=1, keepdims=True)
        return c / np.sqrt((c * c).mean(axis=1, keepdims=True) + 1e-5)

    cn = ln(y[:, :d]) * f["ncs"] + f["ncb"]
    gn = ln(y[:, d:]) * f["ngs"] + f["ngb"]
    gate = cn / (1.0 + np.exp(-cn)) / (1.0 + np.exp(-gn))
    return gate * weights * mask[:, None]


@pytest.mark.parametrize("d", [64, 32])
def test_message_forward_tile_stays_under_the_forward_tolerance(d):
    """At the model's scales (the chip run's ``check_autograd`` draws) and
    a row count that leaves the last 16-row tile ragged, with ~10% of the
    rows masked."""
    rng = np.random.default_rng(d)
    n_rows = 2_000 + 13

    def rand(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    acc, weights = rand(n_rows, 2 * d), rand(n_rows, d)
    mask = (rng.random(n_rows) < 0.9).astype(np.float32)
    p = dict(w2c=rand(d, d, scale=0.1), w2g=rand(d, d, scale=0.1),
             b2=rand(2 * d, scale=0.1), ncs=rand(d), ncb=rand(d, scale=0.1),
             ngs=rand(d), ngb=rand(d, scale=0.1))
    got = message_tile_model(acc, weights, mask, p)
    want = message_f64(acc, weights, mask, p)
    assert got.shape == want.shape == (n_rows, d)
    assert not got[mask == 0].any()  # the mask zeroes its rows exactly
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err < TAIL_FWD_TOL, err


# ------------------------------------------- the one-kernel pass's tiles
# The serving kernels of csrc/fused_pass.cu (pass_fwd_tc_kernel,
# pass_bwd_tc_kernel): a producer sums each 16-row acc tile from the
# gathered parts in part order (an index out of range adds a zero row), then
# the aligned part, then the bias; the consumers run the message or update
# tail on it with 3xTF32 products and the fast gate (f32 exp and division).
def pass_acc_model(tables, idxs, aligned, b1) -> np.ndarray:
    """acc in f32, in the kernels' order: from zero, each gathered part,
    the aligned part, then the bias."""
    acc = np.zeros((idxs[0].shape[0], tables[0].shape[1]), np.float32)
    for table, idx in zip(tables, idxs):
        ok = (idx >= 0) & (idx < table.shape[0])
        acc = acc + np.where(ok[:, None], table[np.where(ok, idx, 0)], np.float32(0))
    if aligned is not None:
        acc = acc + aligned
    return acc + b1


def _pad_rows(x: np.ndarray) -> np.ndarray:
    """x with zero rows up to a whole number of 16-row tiles."""
    return np.concatenate([x, np.zeros((-x.shape[0] % TILE_ROWS, *x.shape[1:]), x.dtype)])


def _sig_f32(x):
    return np.float32(1) / (np.float32(1) + np.exp(-x))


def pass_tile_model(acc, side, mask, g, p, form):
    """(out, d_acc, d_weights) of the serving kernels in f32: y = b2 +
    silu(acc) @ W per half by 3xTF32 over 16-row tiles (the last one ragged,
    padded with zero rows), or y = acc for the update without W2; the
    two-pass layer norms, the gate; the gate's and the norms' backward;
    d_h = d_y @ W^T by 3xTF32 and d_acc = d_h silu'(acc)."""
    n_rows, d = side.shape
    msg, w2 = form == "message", form != "update"
    a = _pad_rows(acc)
    if w2:
        h = a * _sig_f32(a)
        yc = tc_product(h[:, :d], p["w2c"], split=True, init=p["b2"][:d])
        yg = tc_product(h[:, d:], p["w2g"], split=True, init=p["b2"][d:])
    else:
        yc, yg = a[:, :d], a[:, d:]
    zc, zg = _ln_f32(yc)[:n_rows], _ln_f32(yg)[:n_rows]
    cn = zc * p["ncs"] + p["ncb"]
    gn = zg * p["ngs"] + p["ngb"]
    s_cn, s_gn = _sig_f32(cn), _sig_f32(gn)
    gate = cn * s_cn * s_gn
    m = mask[:, None] if msg else np.float32(1)
    out = gate * side * m if msg else gate + side
    up = g * side * m if msg else g
    d_weights = g * gate * m if msg else None
    gzc = up * s_gn * (s_cn * (np.float32(1) + cn * (np.float32(1) - s_cn))) * p["ncs"]
    gzg = up * (cn * s_cn) * s_gn * (np.float32(1) - s_gn) * p["ngs"]

    def ln_bwd(gz, z, y):
        c = y[:n_rows] - y[:n_rows].mean(axis=1, dtype=np.float32, keepdims=True)
        inv = np.float32(1) / np.sqrt((c * c).mean(axis=1, dtype=np.float32,
                                                   keepdims=True) + np.float32(1e-5))
        m1 = gz.mean(axis=1, dtype=np.float32, keepdims=True)
        m2 = (gz * z).mean(axis=1, dtype=np.float32, keepdims=True)
        return (gz - m1 - z * m2) * inv

    dyc, dyg = ln_bwd(gzc, zc, yc), ln_bwd(gzg, zg, yg)
    if not w2:
        return out, np.concatenate([dyc, dyg], axis=1), d_weights
    dhc = tc_product(_pad_rows(dyc), np.ascontiguousarray(p["w2c"].T), split=True)
    dhg = tc_product(_pad_rows(dyg), np.ascontiguousarray(p["w2g"].T), split=True)
    dh = np.concatenate([dhc, dhg], axis=1)[:n_rows]
    s = _sig_f32(acc)
    return out, dh * (s * (np.float32(1) + acc * (np.float32(1) - s))), d_weights


def pass_f64(acc, side, mask, g, p, form):
    """(out, d_acc, d_weights) of the same tail in float64."""
    d = side.shape[1]
    msg, w2 = form == "message", form != "update"
    acc, side, g = (x.astype(np.float64) for x in (acc, side, g))
    f = {k: v.astype(np.float64) for k, v in p.items()}
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))  # noqa: E731
    if w2:
        hh = acc * sig(acc)
        y = np.concatenate([hh[:, :d] @ f["w2c"], hh[:, d:] @ f["w2g"]], axis=1) + f["b2"]
    else:
        y = acc

    def ln(x):
        c = x - x.mean(axis=1, keepdims=True)
        inv = 1.0 / np.sqrt((c * c).mean(axis=1, keepdims=True) + 1e-5)
        return c * inv, inv

    (zc, ic), (zg, ig) = ln(y[:, :d]), ln(y[:, d:])
    cn, gn = zc * f["ncs"] + f["ncb"], zg * f["ngs"] + f["ngb"]
    gate = cn * sig(cn) * sig(gn)
    m = mask.astype(np.float64)[:, None] if msg else 1.0
    out = gate * side * m if msg else gate + side
    up = g * side * m if msg else g
    d_cn = up * sig(gn) * sig(cn) * (1 + cn * (1 - sig(cn)))
    d_gn = up * cn * sig(cn) * sig(gn) * (1 - sig(gn))

    def ln_bwd(dz_out, scale, z, inv):
        gz = dz_out * scale
        return (gz - gz.mean(axis=1, keepdims=True)
                - z * (gz * z).mean(axis=1, keepdims=True)) * inv

    dy = np.concatenate([ln_bwd(d_cn, f["ncs"], zc, ic), ln_bwd(d_gn, f["ngs"], zg, ig)],
                        axis=1)
    d_weights = g * gate * m if msg else None
    if not w2:
        return out, dy, d_weights
    dh = np.concatenate([dy[:, :d] @ f["w2c"].T, dy[:, d:] @ f["w2g"].T], axis=1)
    return out, dh * sig(acc) * (1 + acc * (1 - sig(acc))), d_weights


def _pass_case(d, n_parts, with_aligned, form, seed):
    """Inputs at the model's scales: tables, indices with ~2% out of range,
    a ragged row count, ~10% of the rows masked."""
    rng = np.random.default_rng(seed)
    n_rows = 1_000 + 13

    def rand(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    sizes = [300, 700, 500][:n_parts]
    tables = [rand(s, 2 * d, scale=0.5) for s in sizes]
    idxs = [rng.integers(-5, s + 5, n_rows).astype(np.int32) for s in sizes]
    aligned = rand(n_rows, 2 * d, scale=0.5) if with_aligned else None
    b1 = rand(2 * d, scale=0.1)
    side, g = rand(n_rows, d), rand(n_rows, d)
    mask = (rng.random(n_rows) < 0.9).astype(np.float32)
    p = dict(w2c=rand(d, d, scale=0.1), w2g=rand(d, d, scale=0.1),
             b2=rand(2 * d, scale=0.1), ncs=rand(d), ncb=rand(d, scale=0.1),
             ngs=rand(d), ngb=rand(d, scale=0.1))
    return (tables, idxs, aligned, b1), side, mask, g, p


PASS_CASES = [
    (64, 1, False, "message"), (64, 2, True, "message"), (64, 3, True, "message"),
    (32, 2, True, "message"), (32, 3, False, "message"), (64, 2, True, "update"),
    (32, 1, True, "update"), (64, 3, False, "update_w2"),
]


@pytest.mark.parametrize("d,n_parts,with_aligned,form", PASS_CASES)
def test_pass_forward_tile_stays_under_the_forward_tolerance(d, n_parts, with_aligned,
                                                             form):
    parts, side, mask, g, p = _pass_case(d, n_parts, with_aligned, form, seed=d + n_parts)
    acc = pass_acc_model(*parts)
    got = pass_tile_model(acc, side, mask, g, p, form)[0]
    want = pass_f64(acc, side, mask, g, p, form)[0]
    assert got.shape == want.shape == side.shape
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err < TAIL_FWD_TOL, err


@pytest.mark.parametrize("d,n_parts,with_aligned,form", PASS_CASES)
def test_pass_serving_backward_tile_stays_under_the_backward_tolerance(
    d, n_parts, with_aligned, form
):
    parts, side, mask, g, p = _pass_case(d, n_parts, with_aligned, form, seed=d * n_parts)
    acc = pass_acc_model(*parts)
    got = pass_tile_model(acc, side, mask, g, p, form)[1:]
    want = pass_f64(acc, side, mask, g, p, form)[1:]
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape
        err = float(np.abs(a - b).max() / np.abs(b).max())
        assert err < TAIL_BWD_TOL, err


@pytest.mark.parametrize("n_parts,with_aligned", [(1, False), (2, True), (3, True)])
def test_pass_acc_model_is_the_plain_sum_bit_for_bit(n_parts, with_aligned):
    """The producers' order of adds is the port's plain version's
    (``ops/fused_pass.py`` ``_acc_plain``): equal bits on the CPU."""
    import torch

    from chgnet_tpu_torch.ops import fused_pass

    (tables, idxs, aligned, b1), *_ = _pass_case(64, n_parts, with_aligned, "message", 3)
    want = fused_pass._acc_plain(
        [torch.from_numpy(t) for t in tables], [torch.from_numpy(i) for i in idxs],
        None if aligned is None else torch.from_numpy(aligned), torch.from_numpy(b1))
    np.testing.assert_array_equal(pass_acc_model(tables, idxs, aligned, b1), want.numpy())


def _bf16_values(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (to nearest even), kept as f32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("a_bf16", [True, False], ids=["bf16 A", "f32 A"])
def test_bf16_operands_need_fewer_tf32_passes_for_the_same_sums(a_bf16):
    """The bf16 kernels' products (``tf32x3.cuh`` ``mma1_tiles`` /
    ``mma2_tiles``): a bf16 value is exact in TF32, so its lo part is zero.
    With both operands bf16 one pass (hi hi) gives 3xTF32's sums bit for
    bit; with a bf16 B only (the tails' W2 against silu(acc) or d_y), the
    two passes lo_a hi_b, hi_a hi_b do."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((16, 64)).astype(np.float32)
    b = _bf16_values(rng.standard_normal((64, 128)).astype(np.float32) * 0.1)
    if a_bf16:
        a = _bf16_values(a)
    assert np.array_equal(tf32(b), b) and np.all(tf32(b - tf32(b)) == 0)
    want = tc_product(a, b, split=True)
    a_hi, a_lo = tf32(a), tf32(a - tf32(a))
    terms = [(a_hi, b)] if a_bf16 else [(a_lo, b), (a_hi, b)]
    acc = np.zeros((16, 128), np.float32)
    for k in range(0, 64, 8):
        for x, y in terms:
            part = x[:, k: k + 8].astype(np.float64) @ y[k: k + 8].astype(np.float64)
            acc = (acc.astype(np.float64) + part).astype(np.float32)
    np.testing.assert_array_equal(acc, want)
