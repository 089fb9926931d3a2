"""bf16 on rows 10-14 and bf16 training in the port against chgnet_tpu.

``compute_dtype="bfloat16"`` under ``CHGNET_TPU_MSG_REDUCE``,
``CHGNET_TPU_STREAM_V2`` and ``CHGNET_TPU_FUSED_PASS``, and with the
parameter-gradient backward that training runs (rows 7, 9 and 14), on the
CPU. Inputs come from numpy seeds, are rounded to bf16 once and handed to
both packages. Each test states what it compares and at what tolerance:

* rows 10-14 of PERF.md's kernel table: the port's plain versions on bf16
  inputs against chgnet_tpu's Pallas kernels in interpret mode on the same
  inputs. Both widen to f32, compute in f32 and round each output once, so
  they differ by at most one rounding: ``ULP`` (2^-7) of each output's
  largest value; the windowed gather is exact. The parameter gradients of
  rows 7, 9 and 14: chgnet_tpu casts each grid tile's f32 sums to bf16 and
  adds them in bf16 (``ops/gated_message.py:222-228``,
  ``ops/fused_pass.py:504-517``), the port sums in f32 and rounds once. With
  n tiles that is at most 2 n roundings, each within half an ulp of a value
  no larger than the sum of the tiles' largest partial magnitudes ``M``:
  the bound ``n * 2^-7 * M`` (``_tile_bound``).
* the autograd of rows 10-14 to first order against ``jax.grad`` of
  chgnet_tpu's ops in bf16: each gradient is a kernel output rounded once
  and then, for the tables, summed by a segment sum that rounds once more:
  two ulps of each gradient's largest value, four for the one-kernel pass
  (its table cotangents sum a bf16 ``d_total``, which chgnet_tpu sums in
  its own block order).
* E+F+S+M of the SMALL model in bf16 under each switch (R, V, P, U + P,
  U + V) against chgnet_tpu in bf16 under the same switch with its Pallas
  kernels in interpret mode, at tests/test_torch_port_bf16.py's ``PARITY``
  bars (measured at most e 2.7e-4 eV/atom, f 1.3e-3 eV/A, s 1.9e-2 GPa, m
  2.0e-3 mu_B, the stress in the undirected layout), and against the
  port's own f32 under the switch at its ``BARS`` (measured at most e
  3.6e-4, f 1.2e-3, s 7.7e-3, m 1.7e-3).
* two ``Trainer`` steps of the SMALL bf16 model (targets efsm, Adam), with
  and without ``CHGNET_TPU_FUSED_PASS``, against chgnet_tpu's ``Trainer``
  on the same seeded data: the step losses within ``TRAIN_LOSS_RTOL``
  (measured at most 1.8e-3, on losses of the bf16 model's outputs, which
  the two packages round at other places) and every parameter within 2 x
  lr x steps (Adam steps each element by at most about lr; where a bf16
  gradient is rounding noise the two may step opposite ways), all but 1%
  of them within 1e-4 (measured 0.18%). Adam's step hides a gradient's
  scale, so each leaf's gradients are also held through Adam's first
  moments after the two steps (0.09 g1 + 0.1 g2, linear in both steps'
  gradients): within ``TRAIN_MU_RTOL`` of the leaf's largest (measured
  at most 1.8e-2); a leaf whose gradient is missing, of the wrong sign or
  more than 5% off in scale fails there.

The kernels themselves are held against these plain versions on the card in
tests/test_torch_port_cuda.py and in chip_smoke.py.
"""

from __future__ import annotations

import functools as ft

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chgnet_tpu import ROOT
from chgnet_tpu.core.lattice import Lattice as JLattice
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.data import StructureData as JStructureData
from chgnet_tpu.data import get_train_val_test_loader as j_loaders
from chgnet_tpu.graph.batching import batch_graphs as j_batch_graphs
from chgnet_tpu.models.chgnet import CHGNet as JCHGNet
from chgnet_tpu.models.chgnet import compute_batch as j_compute_batch
from chgnet_tpu.ops import fused_pass as jfp
from chgnet_tpu.ops import gated_message as jgm
from chgnet_tpu.ops import gproj as jgproj
from chgnet_tpu.ops import scatter as jsc
from chgnet_tpu.ops import stream_ops as so
from chgnet_tpu.trainer import Trainer as JTrainer
from chgnet_tpu_torch import ops as tops
from chgnet_tpu_torch.core.lattice import Lattice
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.data import StructureData, get_train_val_test_loader
from chgnet_tpu_torch.graph.batching import batch_graphs as t_batch_graphs
from chgnet_tpu_torch.graph.batching import make_plan
from chgnet_tpu_torch.models.chgnet import CHGNet as TCHGNet
from chgnet_tpu_torch.models.chgnet import compute_batch as t_compute_batch
from chgnet_tpu_torch.models.convert import params_to_numpy
from chgnet_tpu_torch.ops import fused_pass as tfp
from chgnet_tpu_torch.ops import gated_message as tgm
from chgnet_tpu_torch.ops import segment as tsg
from chgnet_tpu_torch.trainer import Trainer
from chgnet_tpu_torch.trainer.trainer import _leaves
from chgnet_tpu_torch.utils.common import flatten_params

ULP = 2.0**-7  # one bf16 ulp, relative to an output's largest value
BF16 = dict(compute_dtype="bfloat16", matmul_precision="default")
SMALL = dict(
    atom_fea_dim=16, bond_fea_dim=16, angle_fea_dim=16, num_radial=9,
    num_angular=9, n_conv=3, mlp_hidden_dims=(16,), atom_conv_hidden_dim=16,
    bond_conv_hidden_dim=16, graph_converter_algorithm="numpy",
)
# tests/test_torch_port_bf16.py's bars: the port's bf16 against its f32, and
# against chgnet_tpu's bf16 (the two round after different ops)
BARS = {"e": 2e-3, "f": 2e-2, "s": 2e-2, "m": 2e-2}
PARITY = {"e": 1e-3, "f": 1e-2, "s": 2e-2, "m": 1e-2}
TRAIN_LR = 1e-3
TRAIN_LOSS_RTOL = 5e-3
TRAIN_MU_RTOL = 5e-2
LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
D = 64
FLAGS = dict(compute_force=True, compute_stress=True, compute_magmom=True)
SWITCHES = R, V, P = (
    "CHGNET_TPU_MSG_REDUCE", "CHGNET_TPU_STREAM_V2", "CHGNET_TPU_FUSED_PASS"
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: it takes sin and cos
    early (the bases), which MKL's multi-threaded path gets wrong in some
    processes (ROADMAP.md Queue 3 item 3), and its passes are many small
    ops."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture()
def gates(monkeypatch):
    """No switch set, chgnet_tpu's TPU gates open and every Pallas entry
    point of its stream ops and gproj in interpret mode (the fused pass and
    the message-reduce take interpret mode off the TPU by themselves); a
    test sets its switches with ``monkeypatch``."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
        monkeypatch.delenv(name.replace("TPU_", "TPU_NO_"), raising=False)
    monkeypatch.setattr(so, "tpu_backend", lambda: True)
    for name in ("_multi_gather_pallas", "_gather_pallas", "_segsum_pallas",
                 "_segsum2_pallas", "_segsum_v2_pallas", "_gather_v2_pallas"):
        monkeypatch.setattr(so, name, ft.partial(getattr(so, name), interpret=True))
    monkeypatch.setattr(
        jgproj, "_gproj_pallas", ft.partial(jgproj._gproj_pallas, interpret=True)
    )
    jax.clear_caches()
    yield monkeypatch
    jax.clear_caches()


def _bf16(rng, *shape, scale=1.0):
    """f32 normals rounded to bf16 once: (jax array, torch tensor), equal."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    """|got - want| <= tol, an absolute bound."""
    assert not isinstance(got, torch.Tensor) or got.dtype == torch.bfloat16, what
    err = float(np.abs(_np(got) - _np(want)).max())
    assert err <= tol, f"{what}: {err} > {tol}"


def _ulps(got, want, ulps=1.0, what=""):
    """|got - want| <= ulps bf16 ulps of want's largest value."""
    _close(got, want, ulps * ULP * float(np.abs(_np(want)).max()), what)


def _tile_bound(partials) -> float:
    """The bound on a bf16 parameter gradient summed over n grid tiles by
    chgnet_tpu (each tile's f32 sum rounded, then added in bf16) against one
    f32 sum rounded once: 2 n roundings of half an ulp of values no larger
    than M, the sum of the tiles' largest partial magnitudes."""
    m = sum(float(np.abs(p).max()) for p in partials)
    return len(partials) * ULP * m


# ------------------------------------------------------------ row 11
@pytest.mark.parametrize("sorted_", [True, False], ids=["sorted", "perm"])
def test_segment_sum_tiles_matches_pallas_in_bf16(gates, sorted_):
    """Row 11's plain version on bf16 rows against ``_segsum_v2_pallas``
    (the sorted stream, a padded tail) and ``segment_sum_sorted`` (the
    permuted stream) in interpret mode: one ulp."""
    rng = np.random.default_rng(31)
    n_out, L = 3 * so.BO, 4 * so.C
    jx, tx = _bf16(rng, L, D)
    key = np.sort(rng.integers(0, n_out, L)).astype(np.int32)
    if sorted_:
        key[-40:] = n_out
        blk_lo, blk_cnt = so.build_block_plan(key, n_out)
        want = so._segsum_v2_pallas(
            jx, jnp.asarray(key), jnp.asarray(blk_lo), jnp.asarray(blk_cnt),
            n_out=n_out)
    else:
        key = key.reshape(-1, 8)[rng.permutation(L // 8)].reshape(-1)
        key[rng.integers(0, L, 30)] = n_out
        perm = np.argsort(key, kind="stable").astype(np.int32)
        blk_lo, blk_cnt, _ = so.build_block_plan_local(key, perm, n_out)
        want = so.segment_sum_sorted(
            jx, jnp.asarray(key), jnp.asarray(blk_lo), jnp.asarray(blk_cnt),
            n_out, None, None, None, True)
    assert want.dtype == jnp.bfloat16
    plan = make_plan(key, key < n_out, n_out, assume_sorted=sorted_).to("cpu")
    got = tsg.segment_sum_tiles(tx, plan.offsets, plan.perm)
    _ulps(got, want, what="segment_sum_tiles")


# ------------------------------------------------------------ row 12
def test_gather_rows_window_is_exact_in_bf16(gates):
    """Row 12's plain version on bf16 rows against ``_gather_v2_pallas`` in
    interpret mode, bit for bit inside the windows."""
    gates.setenv(V, "1")  # the plans carry windows only under the switch
    rng = np.random.default_rng(32)
    n_src, L = 4 * so.W, 4 * so.C
    idx = np.sort(rng.integers(0, n_src, L)).astype(np.int32)
    valid = np.arange(L) < L - 200
    idx[~valid] = idx[valid][-1]
    pw = so.build_pw_plan(idx, valid, n_src)
    jsrc, tsrc = _bf16(rng, n_src, D)
    want = _np(so._gather_v2_pallas(jsrc, jnp.asarray(idx), jnp.asarray(pw)))
    plan = make_plan(idx, valid, n_src).to("cpu")
    got = tsg.gather_rows_window(tsrc, torch.tensor(idx), plan.window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got)[valid], want[valid])
    assert tsg.window_fits(tsrc) and not tsg.window_fits(tsrc[:, :4])


def test_stream_v2_autograd_matches_jax_in_bf16(gates):
    """plan_segment_sum (row 11) and its backward, the planned gather (row
    12), and plan_gather and its backward under the switch on bf16 rows
    against chgnet_tpu's planned ops in interpret mode: one ulp forward,
    exact gathers, two ulps for the gather's backward sum."""
    gates.setenv(V, "1")
    rng = np.random.default_rng(33)
    n_out, L = 2 * so.BO, 2 * so.C
    idx = np.sort(rng.integers(0, n_out, L)).astype(np.int32)
    valid = np.arange(L) < L - 100
    jx, tx = _bf16(rng, L, D)
    jt, tt = _bf16(rng, n_out, D)
    jct, tct = _bf16(rng, n_out, D)
    jct2, tct2 = _bf16(rng, L, D)
    key = np.where(valid, idx, n_out).astype(np.int32)
    jplan = jsc.make_plan(idx, valid, n_out, assume_sorted=True)
    tplan = make_plan(idx, valid, n_out, assume_sorted=True).to("cpu")
    assert tplan.window.shape[0]
    j_out, j_vjp = jax.vjp(
        lambda x: jsc.plan_segment_sum(x, jnp.asarray(key), n_out, jplan), jx)
    tx.requires_grad_(True)
    t_out = tsg.plan_segment_sum(tx, tplan)
    _ulps(t_out, j_out, what="segment sum")
    (t_dx,) = torch.autograd.grad(t_out, tx, tct)
    _ulps(t_dx, j_vjp(jct)[0], ulps=0, what="its backward gather")
    j_g, jg_vjp = jax.vjp(lambda t: jsc.plan_gather(t, jnp.asarray(idx), jplan), jt)
    tt.requires_grad_(True)
    t_g = tsg.plan_gather(tt, torch.tensor(idx), tplan)
    np.testing.assert_array_equal(_np(t_g)[valid], _np(j_g)[valid])
    (t_dt,) = torch.autograd.grad(t_g, tt, tct2)
    _ulps(t_dt, jg_vjp(jct2)[0], ulps=2, what="the gather's backward sum")


# ------------------------------------------------------------ row 10
def _tail(rng, has_w2=True, scale=1.0):
    """A tail's parameters in bf16: (chgnet_tpu's p2, the port's tuple)."""
    p = {}
    if has_w2:
        p["w2c"], p["w2g"] = _bf16(rng, D, D, scale=0.1), _bf16(rng, D, D, scale=0.1)
        p["b2"] = _bf16(rng, 2 * D, scale=0.1)
    for k, s in zip(tgm.LN_KEYS, (scale, 0.1, scale, 0.1)):
        p[k] = _bf16(rng, D, scale=s)
    jp2 = {k: p[k][0] for k in tgm.LN_KEYS}
    if has_w2:
        jp2["w2"] = jax.scipy.linalg.block_diag(p["w2c"][0], p["w2g"][0])
        jp2["b2"] = p["b2"][0]
    keys = (tgm.W2_KEYS if has_w2 else ()) + tgm.LN_KEYS
    return jp2, tuple(p[k][1] for k in keys)


def _port_order(jd_p2, has_w2=True):
    """chgnet_tpu's parameter gradients in the port's order."""
    out = []
    if has_w2:
        w2 = _np(jd_p2["w2"])
        out += [w2[:D, :D], w2[D:, D:], jd_p2["b2"]]
    return out + [jd_p2[k] for k in tgm.LN_KEYS]


def _reduce_case(rng, n_rows=jgm.TILE, n_out=so.BO):
    dst = np.sort(rng.integers(0, n_out, n_rows)).astype(np.int32)
    mask = (rng.random(n_rows) > 0.1).astype(np.float32)
    dst = np.where((rng.random(n_rows) > 0.5) & (mask == 0), n_out, dst)
    order = np.argsort(dst, kind="stable")
    dst, mask = dst[order].astype(np.int32), mask[order]
    return dst, mask


def test_message_reduce_and_its_gradients_match_pallas_in_bf16(gates):
    """Row 10's plain version against chgnet_tpu's ``_reduce_pallas`` in
    interpret mode (one ulp), and the reduce op's gradients by the message
    tail's backward against the custom_vjp's (two ulps)."""
    gates.setenv(R, "1")
    rng = np.random.default_rng(34)
    n_out = so.BO
    dst, mask = _reduce_case(rng, n_out=n_out)
    n_rows = dst.shape[0]
    (ja, ta), (jw, tw) = _bf16(rng, n_rows, 2 * D), _bf16(rng, n_rows, D)
    jm, tm = jnp.asarray(mask, jnp.bfloat16), torch.tensor(mask).to(torch.bfloat16)
    jp2, tp = _tail(rng)
    jplan = jsc.make_plan(dst, dst < n_out, n_out, assume_sorted=True)
    tplan = make_plan(dst, dst < n_out, n_out, assume_sorted=True).to("cpu")
    assert jgm.msg_reduce_ok(ja, jplan, n_out)

    def j_reduce(a, w, p2):
        return jgm.fused_gated_message_reduce(a, w, jm, p2, jplan, n_out)

    want, vjp = jax.vjp(j_reduce, ja, jw, jp2)
    assert want.dtype == jnp.bfloat16
    _ulps(tgm.gated_message_reduce(ta, tw, tm, tp, tplan.offsets), want,
          what="message-reduce")
    jct, tct = _bf16(rng, n_out, D)
    j_da, j_dw, j_dp = vjp(jct)
    leaves = [ta, tw, *tp]
    for t in leaves:
        t.requires_grad_(True)
    p2 = dict(zip(tgm.W2_KEYS + tgm.LN_KEYS, tp))
    out = tgm.fused_gated_message_reduce(ta, tw, tm, p2, tplan)
    grads = torch.autograd.grad(out, leaves, tct)
    # one of chgnet_tpu's grid tiles: each gradient rounded once in both
    # packages, the cotangent's gather exact
    assert n_rows == jgm.TILE
    for got, want_g, what in zip(grads, [j_da, j_dw, *_port_order(j_dp)],
                                 ["d_acc", "d_weights", "dW2c", "dW2g", "db2",
                                  *tgm.LN_KEYS], strict=True):
        _ulps(got, want_g, ulps=2, what=what)


# ------------------------------------------------------- rows 7 and 9
@pytest.mark.parametrize("form", ["message", "update-w2", "update"])
def test_tail_parameter_gradients_match_pallas_in_bf16(form):
    """Rows 7 and 9 with parameter gradients (training) on bf16 inputs over
    two of chgnet_tpu's 1,024-row grid tiles: d_acc, d_weights and d_mask
    within one ulp of ``_backward`` / ``_backward_nw`` in interpret mode,
    the parameter gradients within ``_tile_bound``."""
    rng = np.random.default_rng(35)
    n_rows = 2 * jgm.TILE
    msg, has_w2 = form == "message", form != "update"
    (ja, ta), (jw, tw), (jg, tg) = (
        _bf16(rng, n_rows, 2 * D), _bf16(rng, n_rows, D), _bf16(rng, n_rows, D))
    m = (rng.random(n_rows) < 0.9).astype(np.float32)
    jm, tm = jnp.asarray(m, jnp.bfloat16), torch.tensor(m).to(torch.bfloat16)
    jp2, tp = _tail(rng, has_w2)
    if msg:
        d_acc, d_w, d_mask, j_dp = jgm._backward(ja, jw, jm, jp2, jg, interpret=True)
        got = tgm.gated_message_bwd(ta, tw, tm, tp, tg, True, True)
        _ulps(got[1], d_w, what="d_weights")
        _ulps(got[2], d_mask, what="d_mask")

        def partial(sl):
            return tgm.gated_message_bwd_plain(
                ta[sl].float(), tw[sl].float(), tm[sl].float(),
                tuple(p.float() for p in tp), tg[sl].float(), False, True)[3]
    else:
        d_acc, j_dp = jgm._backward_nw(ja, jp2, jg, interpret=True)
        got = tgm.gated_update_bwd(ta, tp, tg, True)
        got = (got[0], None, None, got[1])

        def partial(sl):
            return tgm.gated_update_bwd_plain(
                ta[sl].float(), tuple(p.float() for p in tp), tg[sl].float(), True)[1]
    _ulps(got[0], d_acc, what="d_acc")
    tiles = [slice(t * jgm.TILE, (t + 1) * jgm.TILE) for t in range(2)]
    parts = [partial(sl) for sl in tiles]
    for k, (g, w) in enumerate(zip(got[3], _port_order(j_dp, has_w2), strict=True)):
        assert g.dtype == torch.bfloat16
        _close(g, w, _tile_bound([_np(p[k]) for p in parts]), f"parameter {k}")


# ------------------------------------------------------- rows 13 and 14
def _pass_case(rng, msg, has_w2, n_gathered=2):
    """One pass on bf16 inputs: ``n_gathered`` sorted index streams over
    tables of 2 C rows, one aligned stream, the bias, the tail and the
    message's or the update's rows; 2 BO rows (two grid tiles)."""
    n_src, n_rows = 2 * so.C, 2 * so.BO
    idxs = [np.sort(rng.integers(0, n_src, n_rows)).astype(np.int32)
            for _ in range(n_gathered)]
    tabs = [_bf16(rng, n_src, 2 * D) for _ in idxs]
    stream, b1 = _bf16(rng, n_rows, 2 * D), _bf16(rng, 2 * D, scale=0.1)
    jp2, tp = _tail(rng, has_w2)
    side = _bf16(rng, n_rows, D)
    mask = np.ones(n_rows, np.float32)
    mask[rng.integers(0, n_rows, 50)] = 0.0
    return dict(idxs=idxs, tabs=tabs, stream=stream, b1=b1, jp2=jp2, tp=tp,
                side=side, mask=mask, msg=msg, has_w2=has_w2)


@pytest.mark.parametrize(("msg", "has_w2"), [(True, True), (False, True), (False, False)],
                         ids=["message", "update-w2", "update"])
def test_fused_pass_plain_versions_match_pallas_in_bf16(gates, msg, has_w2):
    """Rows 13 and 14's plain versions on bf16 inputs against
    ``_fused_pass_pallas`` / ``_pass_bwd_pallas`` in interpret mode: the
    output, ``d_total``, ``d_weights`` (chgnet_tpu's by the weights folded
    with the mask, times the mask) and ``d_mask`` within one ulp; the
    parameter gradients and ``d_b1`` within ``_tile_bound`` over the two
    tiles."""
    rng = np.random.default_rng(36)
    c = _pass_case(rng, msg, has_w2)
    n_src = c["tabs"][0][0].shape[0]
    plans = [jsc.make_plan(i, np.ones(i.shape[0], bool), n_src) for i in c["idxs"]]
    jmask = jnp.asarray(c["mask"], jnp.bfloat16)
    folded = c["side"][0] * jmask[:, None] if msg else None
    common = dict(n_aligned=1, has_w2=has_w2, has_weights=msg, interpret=True)
    gathered = (tuple(t[0] for t in c["tabs"]), tuple(jnp.asarray(i) for i in c["idxs"]),
                tuple(p.g_lo for p in plans), tuple(p.g_cnt for p in plans),
                (c["stream"][0],), c["b1"][0], c["jp2"], folded)
    want = jfp._fused_pass_pallas(*gathered, None if msg else c["side"][0],
                                  has_resnet=not msg, **common)
    jg, tg = _bf16(rng, c["stream"][0].shape[0], D)
    outs = list(jfp._pass_bwd_pallas(*gathered, jg, **common))
    d_total = outs.pop(0)
    d_folded = outs.pop(0) if msg else None
    d_b1 = outs.pop(0)[0]
    j_dp = {}
    if has_w2:
        j_dp["w2"], j_dp["b2"] = outs.pop(0), outs.pop(0)[0]
    for k in tgm.LN_KEYS:
        j_dp[k] = outs.pop(0)[0]

    tm = torch.tensor(c["mask"]).to(torch.bfloat16)
    args = ([t[1] for t in c["tabs"]], [torch.tensor(i) for i in c["idxs"]],
            c["stream"][1], c["b1"][1], c["tp"])
    rows = (c["side"][1], tm, None) if msg else (None, None, c["side"][1])
    _ulps(tfp.fused_pass_fwd(*args, *rows), want, what="forward")
    got_total, got_w, got_mask, got_p = tfp.fused_pass_bwd(*args, *rows[:2], tg, msg, True)
    _ulps(got_total, d_total, what="d_total")
    if msg:
        _ulps(got_w, _np(d_folded) * c["mask"][:, None], what="d_weights")
        _ulps(got_mask, (_np(d_folded) * _np(c["side"][0])).sum(-1), ulps=2,
              what="d_mask")

    def partial(sl):  # the f32 parameter gradients of one grid tile's rows
        return tfp.fused_pass_bwd_plain(
            [t[1].float() for t in c["tabs"]], [torch.tensor(i[sl]) for i in c["idxs"]],
            c["stream"][1][sl].float(), c["b1"][1].float(),
            tuple(p.float() for p in c["tp"]),
            *(None if x is None else x[sl].float() for x in rows[:2]),
            tg[sl].float(), False, True)[3]

    tiles = [slice(t * so.BO, (t + 1) * so.BO) for t in range(2)]
    parts = [partial(sl) for sl in tiles]
    want_p = [*_port_order(j_dp, has_w2), d_b1]
    for k, (g, w) in enumerate(zip(got_p, want_p, strict=True)):
        assert g.dtype == torch.bfloat16
        _close(g, w, _tile_bound([_np(p[k]) for p in parts]), f"parameter {k}")


def test_fused_layer_pass_gradients_match_jax_in_bf16(gates):
    """``fused_layer_pass`` in the message form on bf16 inputs, forward and
    first-order gradients of the tables, b1 and the tail against
    ``jax.grad`` of chgnet_tpu's op in interpret mode: the output within one
    ulp, the gradients within four (each a kernel output rounded once, the
    tables' then summed by a segment sum that rounds again, over a bf16
    d_total that chgnet_tpu sums in its own block order) of each one's
    largest value, the parameter gradients also within ``_tile_bound``."""
    gates.setenv(P, "1")
    rng = np.random.default_rng(37)
    c = _pass_case(rng, True, True, n_gathered=1)
    n_src = c["tabs"][0][0].shape[0]
    idx = c["idxs"][0]
    jplan = jsc.make_plan(idx, np.ones(idx.shape[0], bool), n_src)
    tplan = make_plan(idx, np.ones(idx.shape[0], bool), n_src).to("cpu")
    jm = jnp.asarray(c["mask"], jnp.bfloat16)
    tm = torch.tensor(c["mask"]).to(torch.bfloat16)
    jct, tct = _bf16(rng, idx.shape[0], D)

    def j_pass(tables, b1, p2):
        parts = [(tables[0], jnp.asarray(idx), jplan), (tables[1], None, None)]
        return jfp.fused_layer_pass(parts, b1, p2, weights=c["side"][0], mask=jm)

    jt = (c["tabs"][0][0], c["stream"][0])
    want, vjp = jax.vjp(j_pass, jt, c["b1"][0], c["jp2"])
    (jd_t, jd_b1, jd_p2) = vjp(jct)
    tt = [c["tabs"][0][1], c["stream"][1]]
    leaves = [*tt, c["b1"][1], *c["tp"]]
    for t in leaves:
        t.requires_grad_(True)
    p2 = dict(zip(tgm.W2_KEYS + tgm.LN_KEYS, c["tp"]))
    tops.reset_launch_counts()
    out = tfp.fused_layer_pass(
        [(tt[0], torch.tensor(idx), tplan), (tt[1], None, None)], c["b1"][1], p2,
        weights=c["side"][1], mask=tm)
    _ulps(out, want, what="forward")
    grads = torch.autograd.grad(out, leaves, tct)
    wants = [*jd_t, jd_b1, *_port_order(jd_p2)]
    for k, (g, w) in enumerate(zip(grads, wants, strict=True)):
        tol = 4 * ULP * float(np.abs(_np(w)).max())
        if k >= 2:  # summed over the two grid tiles
            tol = max(tol, 2 * ULP * float(np.abs(_np(w)).max()) * 2)
        _close(g, w, tol, f"gradient {k}")


# ---------------------------------------------------- the whole model
MODEL_CASES = {
    "R": (True, (R,)), "V": (True, (V,)), "P": (True, (P,)),
    "U+P": (False, (P,)), "U+V": (False, (V,)),
}


@pytest.fixture(scope="module", params=list(MODEL_CASES))
def switched(request):
    """E+F+S+M of the SMALL model on a perturbed LiMnO2 cell under one case
    of ``MODEL_CASES``: the port in bf16 and f32 and chgnet_tpu in bf16,
    each with the switch set around its batch build and pass, chgnet_tpu's
    Pallas kernels in interpret mode; and the float types each of the
    port's kernel wrappers saw in its bf16 pass."""
    directed, switches = MODEL_CASES[request.param]
    kw = dict(SMALL, directed_bonds=directed)
    with pytest.MonkeyPatch.context() as mp:
        for name in SWITCHES:
            mp.delenv(name, raising=False)
        for name in switches:
            mp.setenv(name, "1")
        mp.setattr(so, "tpu_backend", lambda: True)
        for name in ("_multi_gather_pallas", "_gather_pallas", "_segsum_pallas",
                     "_segsum2_pallas", "_segsum_v2_pallas", "_gather_v2_pallas"):
            mp.setattr(so, name, ft.partial(getattr(so, name), interpret=True))
        mp.setattr(jgproj, "_gproj_pallas",
                   ft.partial(jgproj._gproj_pallas, interpret=True))
        jax.clear_caches()
        js = JStructure.from_file(LIMNO2).perturb(0.05, seed=1)
        ts = Structure.from_file(LIMNO2).perturb(0.05, seed=1)
        jm = JCHGNet(seed=0, **kw, **BF16)
        j16 = j_compute_batch(jm.params, j_batch_graphs([jm.graph_converter(js)]),
                              config=jm.config, **FLAGS)
        t16 = TCHGNet(seed=0, device="cpu", **kw, **BF16)
        t32 = TCHGNet(seed=0, device="cpu", **kw)
        batch = t_batch_graphs([t16.graph_converter(ts)]).to("cpu")
        o32 = t_compute_batch(t32.params, batch, config=t32.config, **FLAGS)
        seen = {}
        for fn in tops.KERNELS:
            mod = {"segment": tsg, "gated_message": tgm, "fused_pass": tfp}.get(
                fn.__module__.rsplit(".", 1)[-1])
            if mod is None or not hasattr(mod, fn.__name__):
                continue

            def spy(*args, _f=fn, **kwargs):
                floats = [a for a in _flat(args) if a.is_floating_point()]
                seen.setdefault(_f.__name__, set()).update(a.dtype for a in floats)
                return _f(*args, **kwargs)
            mp.setattr(mod, fn.__name__, spy)
        o16 = t_compute_batch(t16.params, batch, config=t16.config, **FLAGS)
        jax.clear_caches()
    return dict(j16=j16, t16=o16, t32=o32, seen=seen, n=(1, len(ts)),
                case=request.param)


def _flat(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _flat(a)


def _err(out, ref, key, n):
    sl = n[0] if key in "es" else n[1]
    got = np.asarray(out[key], np.float64)[:sl]
    want = np.asarray(ref[key], np.float64)[:sl]
    assert np.isfinite(got).all(), key
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("key", "efsm")
def test_switched_efsm_in_bf16_matches_chgnet_tpu(switched, key):
    err = _err(switched["t16"], switched["j16"], key, switched["n"])
    assert err <= PARITY[key], f"{switched['case']} {key}: {err}"


@pytest.mark.parametrize("key", "efsm")
def test_switched_efsm_in_bf16_stays_within_the_bars_of_f32(switched, key):
    err = _err(switched["t16"], switched["t32"], key, switched["n"])
    assert err <= BARS[key], f"{switched['case']} {key}: {err}"


def test_switched_kernels_take_bf16(switched):
    """The switch's kernel wrappers saw the conv streams in bf16 only."""
    want = {"R": ["gated_message_reduce"],
            "V": ["segment_sum_tiles", "gather_rows_window"],
            "U+V": ["segment_sum_tiles", "gather_rows_window"],
            "P": ["fused_pass_fwd", "fused_pass_bwd"],
            "U+P": ["fused_pass_fwd", "fused_pass_bwd"]}[switched["case"]]
    seen = switched["seen"]
    for name in want:
        assert torch.bfloat16 in seen.get(name, set()), name
    for name in ("gated_message_reduce", "fused_pass_fwd", "fused_pass_bwd"):
        assert seen.get(name, {torch.bfloat16}) == {torch.bfloat16}, name


# ------------------------------------------------------------ training
NACL = Lattice.cubic(4)


@pytest.fixture(scope="module")
def labelled():
    """10 perturbed NaCl cells labelled E+F+S+M by a seed-7 f32 teacher
    (tests/test_torch_port_trainer.py's fixture, stresses in the dataset's
    VASP convention)."""
    small = {k: v for k, v in SMALL.items() if k != "graph_converter_algorithm"}
    teacher = TCHGNet(seed=7, device="cpu", **small)
    out = {"t": [], "e": [], "f": [], "s": [], "m": []}
    for index in range(10):
        struct = Structure(NACL, ["Na", "Cl"], [[0, 0, 0], [0.5, 0.5, 0.5]]).perturb(
            0.1, seed=index)
        pred = teacher.predict_structure(struct, task="efsm")
        out["t"].append(struct)
        out["e"].append(float(pred["e"]))
        out["f"].append(np.asarray(pred["f"], dtype=np.float32))
        out["s"].append(np.asarray(pred["s"], dtype=np.float32) * -10.0)
        out["m"].append(np.asarray(pred["m"], dtype=np.float32))
    return out


def _train_loaders(lab, pkg):
    """Train and validation loaders: 8 structures in two batches, 2."""
    kw = dict(energies=lab["e"], forces=lab["f"], stresses=lab["s"],
              magmoms=lab["m"], shuffle=False)
    if pkg == "port":
        data = StructureData(structures=lab["t"], **kw)
        return get_train_val_test_loader(data, batch_size=4, train_ratio=0.8,
                                         val_ratio=0.2)[:2]
    structs = [JStructure(JLattice(s.lattice.matrix), [int(z) for z in s.atomic_numbers],
                          s.frac_coords) for s in lab["t"]]
    return j_loaders(JStructureData(structures=structs, **kw), batch_size=4,
                     train_ratio=0.8, val_ratio=0.2)[:2]


def _adam_first_moments(state):
    """The ``mu`` tree of the Adam state inside an optax state tree."""
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return state.mu
    if isinstance(state, dict):
        state = list(state.values())
    for sub in state if isinstance(state, (list, tuple)) else ():
        found = _adam_first_moments(sub)
        if found is not None:
            return found
    return None


class _PortSteps(Trainer):
    def train_step(self, batch, targets):
        out = super().train_step(batch, targets)
        self.step_losses.append(float(out[0]))
        return out


class _JaxSteps(JTrainer):
    def _steps(self, flag):
        train_step, eval_step = super()._steps(flag)

        def recorded(*args):
            result = train_step(*args)
            self.step_losses.append(float(result[2]["loss"]))
            return result

        return recorded, eval_step


@pytest.mark.parametrize("switch", [None, P], ids=["default", "fused-pass"])
def test_two_bf16_trainer_steps_match_chgnet_tpu(gates, labelled, switch):
    """Two E+F+S+M train steps (Adam, CosLR, MSE, one epoch of two batches)
    of the SMALL bf16 model from the same init on the same data: the step
    losses within TRAIN_LOSS_RTOL of chgnet_tpu's Trainer, every parameter
    within 2 x lr x steps and every leaf's Adam first moments within
    TRAIN_MU_RTOL of its largest; the port's master parameters stay f32 and
    its parameter gradients reach them through the bf16 casts."""
    if switch:
        gates.setenv(switch, "1")
    small = {k: v for k, v in SMALL.items() if k != "graph_converter_algorithm"}
    kw = dict(targets="efsm", learning_rate=TRAIN_LR, epochs=1)
    port = _PortSteps(model=TCHGNet(seed=0, device="cpu", **small, **BF16),
                      use_device="cpu", **kw)
    ref = _JaxSteps(model=JCHGNet(seed=0, **small, **BF16), **kw)
    port.step_losses, ref.step_losses = [], []
    calls = []
    orig = tfp.fused_pass_bwd
    tfp.fused_pass_bwd = lambda *a: (calls.append(a[-1]), orig(*a))[1]
    try:
        port.train(*_train_loaders(labelled, "port"), save_dir=None)
    finally:
        tfp.fused_pass_bwd = orig
    ref.train(*_train_loaders(labelled, "jax"), save_dir=None)
    assert len(port.step_losses) == len(ref.step_losses) == 2
    np.testing.assert_allclose(port.step_losses, ref.step_losses, rtol=TRAIN_LOSS_RTOL)
    # under the switch the pass's backward runs its parameter-gradient form
    assert (True in calls) == bool(switch)
    got = flatten_params(params_to_numpy(port.model.params))
    want = flatten_params(jax.tree.map(np.asarray, ref.model.params))
    assert all(v.dtype == np.float32 for v in got.values())
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diffs.max() <= 2 * TRAIN_LR * len(port.step_losses)
    assert (diffs > 1e-4).mean() <= 0.01
    # each leaf's gradients, through Adam's first moments (a trained leaf
    # the loss does not reach has zero moments in both)
    got_mu = {path: port.optimizer.state[leaf]["exp_avg"].numpy()
              for path, leaf in _leaves(port.model.params)
              if leaf in port.optimizer.state}
    want_mu = flatten_params(jax.tree.map(np.asarray, _adam_first_moments(ref.opt_state)))
    assert set(got_mu) == set(want_mu)
    assert any(np.abs(v).max() > 0 for v in want_mu.values())
    for path, want_leaf in want_mu.items():
        err = np.abs(got_mu[path] - want_leaf).max()
        assert err <= TRAIN_MU_RTOL * np.abs(want_leaf).max(), (path, err)
