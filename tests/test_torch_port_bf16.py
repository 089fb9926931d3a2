"""``compute_dtype="bfloat16"`` in the port against chgnet_tpu on the CPU.

bf16 rounds at other places in the two packages, so each test states what
it compares and at what tolerance:

* rows 1-9 of PERF.md's kernel table: the port's plain versions on bf16
  inputs against chgnet_tpu's Pallas kernels in interpret mode on the same
  bf16 inputs (numpy seeds, rounded to bf16 once and handed to both). Both
  widen to f32, compute in f32 and round each output once, so they differ
  by at most one rounding of an output: ``ULP`` (2^-7, one bf16 ulp) of
  each output's largest value. The gather and the multi-gather's sums of
  two parts are exact. gather_project_sum's plain version also rounds each
  projected table (as chgnet_tpu's plain path projects in bf16), which the
  TPU kernel does not: two ulps; without that rounding (the long route's),
  one. The backward kernels are held to first
  order (the serving forms: no mask or parameter gradients).
* ``compute_batch`` E+F+S+M with the SMALL config in both bond layouts:
  the port's bf16 against chgnet_tpu's bf16 (XLA's composition, which
  rounds after its own ops), and the port's bf16 against its f32 at
  tests/test_model.py::test_bfloat16_compute_mode's bars (e 2e-3 eV/atom,
  f 2e-2 eV/A, m 2e-2 mu_B), stress at 2e-2 GPa.
* that bf16 is in effect: the op wrappers see bf16 feature streams and
  e, f, s and m come out f32.
* a few NVT steps in bf16 against chgnet_tpu's MD in bf16.

The kernels themselves are held against these plain versions on the card
in tests/test_torch_port_cuda.py and in chip_smoke.py.
"""

from __future__ import annotations

import dataclasses
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
from chgnet_tpu.ops import gated_message as jgm
from chgnet_tpu.ops import gproj as jgp
from chgnet_tpu.ops import scatter as jsc
from chgnet_tpu.ops import stream_ops as so
from chgnet_tpu.simulation import MolecularDynamics as JMD
from chgnet_tpu_torch import ops as tops
from chgnet_tpu_torch.core.structure import Structure as TStructure
from chgnet_tpu_torch.graph.batching import batch_graphs as t_batch_graphs
from chgnet_tpu_torch.graph.batching import make_plan
from chgnet_tpu_torch.models.chgnet import CHGNet as TCHGNet
from chgnet_tpu_torch.models.chgnet import compute_batch as t_compute_batch
from chgnet_tpu_torch.ops import fused_pass as tfp
from chgnet_tpu_torch.ops import gated_message as tgm
from chgnet_tpu_torch.ops import gproj as tgp
from chgnet_tpu_torch.ops import multi_gather as tmg
from chgnet_tpu_torch.ops import segment as tsg
from chgnet_tpu_torch.simulation import MolecularDynamics as TMD

ULP = 2.0**-7  # one bf16 ulp, relative to an output's largest value
BF16 = dict(compute_dtype="bfloat16", matmul_precision="default")
SMALL = dict(
    atom_fea_dim=16, bond_fea_dim=16, angle_fea_dim=16, num_radial=9,
    num_angular=9, n_conv=3, mlp_hidden_dims=(16,), atom_conv_hidden_dim=16,
    bond_conv_hidden_dim=16, graph_converter_algorithm="numpy",
)
# the port's bf16 against its f32 (tests/test_model.py:248-254), stress at
# 2e-2 GPa: chgnet_tpu's own bf16 stress gap on the CPU is 3.8e-3 GPa on 4
# of bench.py's supercells at full width (chip_smoke.py's bar is 2e-2). On
# these SMALL batches the port's gaps are at most e 2.3e-4, f 1.2e-3, s
# 7.7e-3, m 2.1e-3 (chgnet_tpu's own: 2.3e-4, 1.8e-3, 2.3e-2, 3.0e-3).
BARS = {"e": 2e-3, "f": 2e-2, "s": 2e-2, "m": 2e-2}
# the port's bf16 against chgnet_tpu's bf16: the two round after different
# ops (the port's kernels once per output, XLA after each of its own ops);
# measured at most e 4.7e-4, f 1.9e-3, s 1.5e-2, m 3.9e-3 over both layouts
PARITY = {"e": 1e-3, "f": 1e-2, "s": 2e-2, "m": 1e-2}
LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
LICOO = f"{ROOT}/examples/mp-1175469-Li9Co7O16.cif"
L, S, D = 1024, 512, 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (many small ops; see
    tests/test_torch_port_simulation.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture()
def interp(monkeypatch):
    """chgnet_tpu's TPU gates open, its Pallas entry points in interpret
    mode (the pattern of tests/test_torch_port_ops.py)."""
    monkeypatch.setattr(so, "tpu_backend", lambda: True)
    for mod, name in [
        (jgp, "_gproj_pallas"), (so, "_segsum_pallas"),
        (so, "_segsum2_pallas"), (so, "_gather_pallas"),
        (so, "_multi_gather_pallas"),
    ]:
        monkeypatch.setattr(mod, name, ft.partial(getattr(mod, name), interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _bf16(rng, *shape, scale=1.0):
    """f32 normals rounded to bf16 once: (jax array, torch tensor), equal."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(x, jnp.bfloat16)
    t = torch.tensor(x).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(j, np.float32), t.float().numpy())
    return j, t


def _close(got: torch.Tensor, want, ulps=1.0, what=""):
    """|got - want| <= ulps bf16 ulps of want's largest value."""
    assert got.dtype == torch.bfloat16, what
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= ulps * ULP * scale, f"{what}: {err} > {ulps} ulp of {scale}"


def _stream(rng, sorted_):
    base = np.linspace(0, S - 1, L).astype(np.int64)
    idx = np.clip(base + rng.integers(-100, 100, L), 0, S - 1).astype(np.int32)
    if sorted_:
        return np.sort(idx), np.arange(L) < int(0.9 * L)
    return idx, rng.random(L) < 0.9


def _plan(idx, valid, sorted_):
    return make_plan(idx, valid, S, assume_sorted=sorted_).to("cpu")


# ---------------------------------------------------------- rows 1-3
@pytest.mark.parametrize("sorted_", [True, False], ids=["sorted", "perm"])
def test_segment_sum_and_its_gather_match_jax_kernels(interp, sorted_):
    """Row 1 forward and its backward, row 2 (a planned gather)."""
    rng = np.random.default_rng(0)
    idx, valid = _stream(rng, sorted_)
    (jx, tx), (jct, tct) = _bf16(rng, L, D), _bf16(rng, S, D)
    key = np.where(valid, idx, S).astype(np.int32)
    jplan = jsc.make_plan(idx, valid, S, assume_sorted=sorted_)
    seg = jsc.plan_segment_sum if sorted_ else jsc.plan_segment_sum_perm
    j_out, j_vjp = jax.vjp(lambda x: seg(x, jnp.asarray(key), S, jplan), jx)
    (j_dx,) = j_vjp(jct)
    tx.requires_grad_(True)
    t_out = tsg.plan_segment_sum(tx, _plan(idx, valid, sorted_))
    (t_dx,) = torch.autograd.grad(t_out, tx, tct)
    _close(t_out, j_out, what="segment sum")
    _close(t_dx, j_dx, ulps=0, what="its backward gather")


def test_gather_is_exact_in_bf16(interp):
    rng = np.random.default_rng(1)
    idx, valid = _stream(rng, False)
    (jt, tt) = _bf16(rng, S, D)
    jplan = jsc.make_plan(idx, valid, S)
    assert jplan.g_lo.shape[0], "chgnet_tpu must take its gather kernel"
    want = jsc.plan_gather(jt, jnp.asarray(idx), jplan)
    got = tsg.plan_gather(tt, torch.tensor(idx), _plan(idx, valid, False))
    _close(got, want, ulps=0, what="gather")


def test_segment_sum_pair_matches_jax_kernel(interp):
    rng = np.random.default_rng(2)
    ia, va = _stream(rng, True)
    ib, vb = _stream(rng, False)
    jx, tx = _bf16(rng, L, 2 * D)
    jplans = [jsc.make_plan(ia, va, S, assume_sorted=True), jsc.make_plan(ib, vb, S)]
    want = jsc.paired_cotangent_sums(jx, jplans, [S, S])
    got = tsg.plan_segment_sum_pair(tx, _plan(ia, va, True), _plan(ib, vb, False))
    for g, w in zip(got, want):
        _close(g, w, what="segment_sum_pair")


# ------------------------------------------------------------ row 4
def test_gather_project_sum_matches_jax_kernel(interp):
    rng = np.random.default_rng(3)
    ia, _ = _stream(rng, True)
    ib, _ = _stream(rng, False)
    valid = np.ones(L, bool)
    (j1, t1), (j2, t2) = _bf16(rng, S, D), _bf16(rng, S, D)
    ws = [_bf16(rng, D, 2 * D, scale=0.1) for _ in range(3)]
    js, ts = _bf16(rng, L, 2 * D)
    pa = jsc.make_plan(ia, valid, S, assume_sorted=True)
    pb = jsc.make_plan(ib, valid, S)
    ia_j, ib_j = jnp.asarray(ia), jnp.asarray(ib)
    parts = [(j1, ia_j, pa), (j1, ib_j, pb), (js, None, None), (j2, ia_j, pa)]
    eye = jnp.eye(2 * D, dtype=jnp.bfloat16)
    want = jgp.gather_project_sum(parts, [w[0] for w in ws], None, [eye])
    pta, ptb = _plan(ia, valid, True), _plan(ib, valid, False)
    ia_t, ib_t = torch.tensor(ia), torch.tensor(ib)
    got = tgp.gather_project_sum(
        [(t1, ia_t, pta, ws[0][1]), (t1, ib_t, ptb, ws[1][1]),
         (t2, ia_t, pta, ws[2][1])], ts,
    )
    _close(got, want, ulps=2, what="gather_project_sum")


def test_gather_project_sum_long_route_rounding_matches_jax_kernel(interp):
    """The plain version with the long route's rounding (no projected table
    rounded, gather_project_sum_route_plain on the card) against the TPU
    kernel, which rounds only its output: one ulp."""
    rng = np.random.default_rng(4)
    ia, _ = _stream(rng, True)
    ib, _ = _stream(rng, False)
    valid = np.ones(L, bool)
    (j1, t1), (j2, t2) = _bf16(rng, S, D), _bf16(rng, S, D)
    ws = [_bf16(rng, D, 2 * D, scale=0.1) for _ in range(3)]
    js, ts = _bf16(rng, L, 2 * D)
    pa = jsc.make_plan(ia, valid, S, assume_sorted=True)
    pb = jsc.make_plan(ib, valid, S)
    ia_j, ib_j = jnp.asarray(ia), jnp.asarray(ib)
    parts = [(j1, ia_j, pa), (j1, ib_j, pb), (js, None, None), (j2, ia_j, pa)]
    eye = jnp.eye(2 * D, dtype=jnp.bfloat16)
    want = jgp.gather_project_sum(parts, [w[0] for w in ws], None, [eye])
    ia_t, ib_t = torch.tensor(ia), torch.tensor(ib)
    got = tgp.gather_project_sum_plain(
        [t1, t1, t2], [ia_t, ib_t, ia_t], [w[1] for w in ws], ts,
        round_tables=False,
    )
    _close(got, want, ulps=1, what="gather_project_sum long route")


# ------------------------------------------------------------ row 5
def test_gather_sum_rows_matches_jax_kernel():
    """Two parts and a stream at 128 lanes: the TPU kernel adds in the
    parts' order, so the two agree bit for bit."""
    rng = np.random.default_rng(4)
    sizes = (1024, 2048)
    tabs = [_bf16(rng, s, 2 * D) for s in sizes]
    idxs = [
        np.clip(np.arange(L) * s // L + rng.integers(0, 300, L), 0, s - 1)
        .astype(np.int32) for s in sizes
    ]
    stream = _bf16(rng, L, 2 * D)
    plans = [so.build_gather_plan(i, np.ones(L, bool), s) for i, s in zip(idxs, sizes)]
    want = so._multi_gather_pallas(
        [t[0] for t in tabs], [jnp.asarray(i) for i in idxs],
        [jnp.asarray(p[0]) for p in plans], [jnp.asarray(p[1]) for p in plans],
        stream[0], has_stream=True, interpret=True,
    )
    got = tmg.gather_sum_rows(
        [t[1] for t in tabs], [torch.tensor(i) for i in idxs], stream[1]
    )
    _close(got, want, ulps=0, what="gather_sum_rows")


# --------------------------------------------------------- rows 6-9
def _tail(rng, has_w2=True):
    p = {}
    if has_w2:
        p["w2c"], p["w2g"] = _bf16(rng, D, D, scale=0.1), _bf16(rng, D, D, scale=0.1)
        p["b2"] = _bf16(rng, 2 * D, scale=0.1)
    for k, scale in zip(tgm.LN_KEYS, (1.0, 0.1, 1.0, 0.1)):
        p[k] = _bf16(rng, D, scale=scale)
    jp2 = {k: p[k][0] for k in tgm.LN_KEYS}
    if has_w2:
        jp2["w2"] = jax.scipy.linalg.block_diag(p["w2c"][0], p["w2g"][0])
        jp2["b2"] = p["b2"][0]
    return jp2, tuple(p[k][1] for k in (tgm.W2_KEYS if has_w2 else ()) + tgm.LN_KEYS)


def test_message_tail_forward_and_serving_backward_match_pallas():
    rng = np.random.default_rng(5)
    (ja, ta), (jw, tw), (jg, tg) = _bf16(rng, L, 2 * D), _bf16(rng, L, D), _bf16(rng, L, D)
    m = (rng.random(L) < 0.9).astype(np.float32)
    jm, tm = jnp.asarray(m, jnp.bfloat16), torch.tensor(m).to(torch.bfloat16)
    jp2, tp = _tail(rng)
    want = jgm._forward(ja, jw, jm, jp2, interpret=True)
    _close(tgm.gated_message_fwd(ta, tw, tm, tp), want, what="message forward")
    d_acc, d_w, *_ = jgm._backward(ja, jw, jm, jp2, jg, interpret=True)
    got = tgm.gated_message_bwd(ta, tw, tm, tp, tg, False, False)
    assert got[2] is None and got[3] is None
    _close(got[0], d_acc, what="message d_acc")
    _close(got[1], d_w, what="message d_weights")


@pytest.mark.parametrize("has_w2", [False, True], ids=["y=acc", "w2"])
def test_update_tail_forward_and_serving_backward_match_pallas(has_w2):
    rng = np.random.default_rng(6)
    (ja, ta), (jr, tr), (jg, tg) = _bf16(rng, L, 2 * D), _bf16(rng, L, D), _bf16(rng, L, D)
    jp2, tp = _tail(rng, has_w2)
    want = jgm._forward_nw(ja, jr, jp2, interpret=True)
    _close(tgm.gated_update_fwd(ta, tr, tp), want, what="update forward")
    d_acc = jgm._backward_nw(ja, jp2, jg, interpret=True)[0]
    got, d_params = tgm.gated_update_bwd(ta, tp, tg, False)
    assert d_params is None
    _close(got, d_acc, what="update d_acc")


# ---------------------------------------------------- the whole model
def _graphs(kw):
    jconv = JCHGNet(seed=0, **kw).graph_converter
    tconv = TCHGNet(seed=0, device="cpu", **kw).graph_converter
    gj, gt = [], []
    for path, seed in ((LIMNO2, 1), (LICOO, 2)):
        js = JStructure.from_file(path).perturb(0.05, seed=seed)
        ts = TStructure.from_file(path).perturb(0.05, seed=seed)
        gj.append(jconv(js))
        gt.append(tconv(ts))
    return gj, gt


@pytest.fixture(scope="module", params=[True, False], ids=["directed", "undirected"])
def outputs(request):
    """E+F+S+M of the SMALL config (fused tails) in one bond layout: the
    port in bf16 and f32, chgnet_tpu in bf16, with the calls that reached
    the op wrappers in the port's bf16 pass."""
    kw = dict(SMALL, directed_bonds=request.param)
    gj, gt = _graphs(kw)
    flags = dict(compute_force=True, compute_stress=True, compute_magmom=True)
    jm = JCHGNet(seed=0, **kw, **BF16)
    j16 = j_compute_batch(jm.params, j_batch_graphs(gj), config=jm.config, **flags)
    tb = t_batch_graphs(gt).to("cpu")
    t32 = TCHGNet(seed=0, device="cpu", **kw)
    t16 = TCHGNet(seed=0, device="cpu", **kw, **BF16)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((tsg, "segment_sum_csr"), (tsg, "gather_rows"),
                          (tsg, "segment_sum_pair"), (tmg, "gather_sum_rows"),
                          (tgp, "gather_project_sum_kernel"),
                          (tgm, "gated_message_fwd"), (tgm, "gated_message_bwd"),
                          (tgm, "gated_update_fwd"), (tgm, "gated_update_bwd")):
            def spy(*args, _f=getattr(mod, name), _n=name):
                seen.append((_n, {t.dtype for t in _floats(args)}))
                return _f(*args)
            mp.setattr(mod, name, spy)
        o16 = t_compute_batch(t16.params, tb, config=t16.config, **flags)
    o32 = t_compute_batch(t32.params, tb, config=t32.config, **flags)
    n_atoms = sum(g.n_atoms for g in gt)
    return dict(j16=j16, t16=o16, t32=o32, seen=seen, n=(len(gt), n_atoms),
                directed=request.param)


def _floats(args):
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _floats(a)


def _err(out, ref, key, n):
    sl = n[0] if key in "es" else n[1]
    got = np.asarray(out[key], np.float64)[:sl]
    want = np.asarray(ref[key], np.float64)[:sl]
    assert np.isfinite(got).all(), key
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("key", "efsm")
def test_efsm_in_bf16_matches_chgnet_tpu_in_bf16(outputs, key):
    err = _err(outputs["t16"], outputs["j16"], key, outputs["n"])
    assert err <= PARITY[key], f"{key}: {err}"


@pytest.mark.parametrize("key", "efsm")
def test_efsm_in_bf16_stays_within_the_bars_of_f32(outputs, key):
    err = _err(outputs["t16"], outputs["t32"], key, outputs["n"])
    assert err <= BARS[key], f"{key}: {err}"


def test_bf16_is_in_effect(outputs):
    """The conv streams reach the kernels' wrappers in bf16 (geometry and
    readout sums stay f32); e, f, s and m come out f32."""
    seen = outputs["seen"]
    by_name = {}
    for name, dtypes in seen:
        by_name.setdefault(name, set()).update(dtypes)
    want = ["segment_sum_csr", "gather_rows", "segment_sum_pair",
            "gather_project_sum_kernel", "gated_message_fwd",
            "gated_message_bwd", "gated_update_fwd", "gated_update_bwd"]
    if not outputs["directed"]:
        want.append("gather_sum_rows")
    for name in want:
        assert torch.bfloat16 in by_name.get(name, set()), name
    for name in want[3:]:  # the conv layers' kernels: bf16 only
        assert by_name[name] == {torch.bfloat16}, name
    for key in "efsm":
        assert outputs["t16"][key].dtype == torch.float32, key
    assert outputs["t16"]["atom_fea"].dtype == torch.float32


def test_bf16_wrappers_count_and_raise_where_f32_only():
    """On the CPU a wrapper runs its plain version (no launch counted), and
    rows 10-14 take bf16 there as rows 1-9 do: each returns bf16; the
    CUDA-side checks name the ``_bf16`` entry point for bf16 tensors and
    still refuse a mixture of float types."""
    tops.reset_launch_counts()
    x = torch.randn(8, 4).to(torch.bfloat16)
    offsets = torch.tensor([0, 3, 8], dtype=torch.int32)
    window = torch.tensor([[0, 7]], dtype=torch.int32)
    idx = torch.arange(8, dtype=torch.int32)
    assert tsg.segment_sum_tiles(x, offsets, offsets.new_zeros(0)).dtype == torch.bfloat16
    assert tsg.gather_rows_window(x, idx, window).dtype == torch.bfloat16
    rng = np.random.default_rng(9)
    acc, w, g = (_bf16(rng, 8, 2 * D)[1], _bf16(rng, 8, D)[1], _bf16(rng, 8, D)[1])
    mask = torch.ones(8, dtype=torch.bfloat16)
    params = _tail(rng)[1]
    assert tgm.gated_message_reduce(acc, w, mask, params, offsets).dtype == torch.bfloat16
    grads = tgm.gated_message_bwd(acc, w, mask, params, g, True, True)
    assert {t.dtype for t in (*grads[:3], *grads[3])} == {torch.bfloat16}
    fwd = tfp.fused_pass_fwd([acc], [idx], None, acc[0], params, w, mask, None)
    bwd = tfp.fused_pass_bwd([acc], [idx], None, acc[0], params, w, mask, g, True, True)
    assert fwd.dtype == torch.bfloat16
    assert {t.dtype for t in (*bwd[:3], *bwd[3])} == {torch.bfloat16}
    assert all(fn.launches == fn.launches_bf16 == 0 for fn in tops.KERNELS)
    from chgnet_tpu_torch.ops import build

    assert build.check_tensors("segment_sum_tiles", (x,), (offsets,)) == "bf16"
    assert build.check_tensors("gather_rows", (x,), (offsets,)) == "bf16"
    with pytest.raises(TypeError, match="one float type"):
        build.check_tensors("gather_rows", (x, x.float()), ())


# ------------------------------------------------------------------ MD
def test_nvt_steps_in_bf16_match_chgnet_tpu():
    """Three runs of 3 NVT Berendsen steps of the SMALL model in bf16:
    potential energy within PARITY["e"] per atom and temperature within 1%
    of chgnet_tpu's bf16 run."""
    kw = dict(SMALL, **BF16)
    md_kw = dict(ensemble="nvt", thermostat="Berendsen", temperature=300.0,
                 starting_temperature=300.0, timestep=2.0, seed=0)
    tmd = TMD(TStructure.from_file(LIMNO2), model=TCHGNet(seed=0, device="cpu", **kw),
              **md_kw)
    jmd = JMD(JStructure.from_file(LIMNO2), model=JCHGNet(seed=0, **kw), **md_kw)
    n = len(TStructure.from_file(LIMNO2))
    for _ in range(3):
        tmd.run(3)
        jmd.run(3)
        e_t, e_j = float(tmd.state.epot[0]), float(jmd.state.epot[0])
        assert abs(e_t - e_j) / n <= PARITY["e"], (e_t, e_j)
        assert tmd.get_temperature() == pytest.approx(jmd.get_temperature(), rel=1e-2)
    assert tmd.state.frac.dtype == torch.float32


def test_bf16_config_is_a_dataclass_field():
    """compute_dtype round-trips through the config as in chgnet_tpu."""
    cfg = TCHGNet(seed=0, device="cpu", **SMALL, **BF16).config
    assert dataclasses.asdict(cfg)["compute_dtype"] == "bfloat16"


def test_bf16_trainer_on_cuda_passes_check_supported(monkeypatch):
    """bf16 trains on the card (the tails' and the one-kernel pass's
    parameter-gradient backwards have bf16 forms): a bf16 Trainer for CUDA
    passes ``check_supported``, with and without the switches, and without
    a card fails only on the missing card; on the CPU it builds."""
    from chgnet_tpu_torch.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = TCHGNet(seed=0, device="cpu", **SMALL, **BF16)
    for switch in (None, "CHGNET_TPU_MSG_REDUCE", "CHGNET_TPU_STREAM_V2",
                   "CHGNET_TPU_FUSED_PASS"):
        with monkeypatch.context() as mp:
            if switch:
                mp.setenv(switch, "1")
            model.config.check_supported("cuda")
            with pytest.raises(RuntimeError, match="CUDA") as info:
                Trainer(model=model, targets="ef", use_device="cuda")
            assert not isinstance(info.value, NotImplementedError)
    Trainer(model=model, targets="ef", use_device="cpu")
