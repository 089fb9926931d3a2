"""The model-side config fields of the PyTorch port against chgnet_tpu.

Dropout, remat, the attention readouts and ``matmul_precision``, at a small
width (16-wide features, 9 + 9 bases, 2 conv blocks, as
tests/test_trainer.py's model). Outputs are held at the port's usual bars
(e <= 2e-5 eV/atom, f <= 5e-5 eV/A, s <= 2e-4 GPa, m <= 2e-5 mu_B; the two
packages sum and project in different orders in f32). Parameter gradients
of a fixed weighted sum of E/F/S/M are held leaf by leaf at 2e-4 of the
leaf's largest gradient (a second derivative, through the force backward,
in different orders) plus 1e-6.

The two packages draw dropout masks from different generators (a JAX key,
a torch.Generator), so the dropout comparison replaces both packages'
``dropout_apply`` in the test only with one numpy mask source: the mask of
the k-th call with a given shape. ``chgnet_tpu`` also runs the last
block's angle update, which feeds nothing and which the port skips. Its
call comes after every other call of its shape as long as no other layer's
masks share the angle update's shape, so the dropout test narrows the angle
features to 8 (the angle update's masks [A, 16] against the others'
[E, 32] and [A, 32]), and keying by shape and order keeps the two in step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chgnet_tpu.models.functions as j_functions
import chgnet_tpu_torch.models.functions as t_functions
import chgnet_tpu_torch.models.layers as t_layers
from chgnet_tpu import ROOT
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.graph.batching import batch_graphs as j_batch_graphs
from chgnet_tpu.models.chgnet import CHGNet as JCHGNet
from chgnet_tpu.models.chgnet import compute_batch as j_compute_batch
from chgnet_tpu_torch.core.structure import Structure as TStructure
from chgnet_tpu_torch.graph.batching import batch_graphs as t_batch_graphs
from chgnet_tpu_torch.models.chgnet import CHGNet as TCHGNet
from chgnet_tpu_torch.models.chgnet import CHGNetConfig as TConfig
from chgnet_tpu_torch.models.chgnet import compute_batch as t_compute_batch

SMALL = dict(
    atom_fea_dim=16,
    bond_fea_dim=16,
    angle_fea_dim=16,
    num_radial=9,
    num_angular=9,
    n_conv=2,
    mlp_hidden_dims=(16,),
    atom_conv_hidden_dim=16,
    bond_conv_hidden_dim=16,
)
TOL = {"e": 2e-5, "f": 5e-5, "s": 2e-4, "m": 2e-5}
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
FLAGS = dict(compute_force=True, compute_stress=True, compute_magmom=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its passes are many small
    ops, which several test processes on one machine's cores slow down many
    times over when each op spreads over every core."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _structures():
    path = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
    return [
        (JStructure.from_file(path).perturb(0.05, seed=s),
         TStructure.from_file(path).perturb(0.05, seed=s))
        for s in (0, 1)
    ]


@pytest.fixture(scope="module")
def structs():
    return _structures()


def _batches(kw, structs):
    jm = JCHGNet(seed=0, **kw)
    tm = TCHGNet(seed=0, device="cpu", **kw)
    jb = j_batch_graphs([jm.graph_converter(j) for j, _ in structs])
    tb = t_batch_graphs([tm.graph_converter(t) for _, t in structs]).to("cpu")
    return jm, tm, jb, tb


def _weights(tb, n_graphs):
    """Fixed random weights of the scalar whose parameter gradient is held."""
    rng = np.random.default_rng(7)
    n = tb.atomic_numbers.shape[0]
    return {
        "e": rng.normal(size=n_graphs).astype(np.float32),
        "f": rng.normal(size=(n, 3)).astype(np.float32),
        "s": rng.normal(size=(n_graphs, 3, 3)).astype(np.float32),
        "m": rng.normal(size=n).astype(np.float32),
    }


def _scalar(out, w, n_graphs, lib):
    total = 0.0
    for key in "efsm":
        val = out[key][:n_graphs] if key in "es" else out[key]
        wk = w[key] if lib is jnp else torch.as_tensor(w[key])
        total = total + (val * wk).sum()
    return total


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _port_grads(tm, tb, w, n_graphs, **kw):
    leaves = dict(_leaves(tm.params))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    out = t_compute_batch(
        tm.params, tb, config=tm.config, create_graph=True, **FLAGS, **kw
    )
    grads = torch.autograd.grad(
        _scalar(out, w, n_graphs, torch), list(leaves.values()),
        allow_unused=True,
    )
    for leaf in leaves.values():
        leaf.requires_grad_(False)
    return {k: v.detach() for k, v in out.items()}, {
        name: (np.zeros(tuple(leaf.shape), np.float32) if g is None else g.numpy())
        for (name, leaf), g in zip(leaves.items(), grads)
    }


def _jax_grads(jm, jb, w, n_graphs, **kw):
    def scalar(params):
        out = j_compute_batch(params, jb, config=jm.config, **FLAGS, **kw)
        return _scalar(out, w, n_graphs, jnp), out

    grads, out = jax.grad(scalar, has_aux=True)(jm.params)
    return out, {k: np.asarray(v) for k, v in _leaves(grads)}


def _check_outputs(jout, tout, n_graphs, n_atoms):
    for key in "efsm":
        sl = n_graphs if key in "es" else n_atoms
        t = tout[key].detach().numpy()[:sl]
        assert np.isfinite(t).all(), key
        np.testing.assert_allclose(
            t, np.asarray(jout[key])[:sl], atol=TOL[key], rtol=0, err_msg=key
        )


def _check_grads(jg, tg):
    assert sorted(jg) == sorted(tg)
    for name in jg:
        scale = float(np.abs(jg[name]).max())
        np.testing.assert_allclose(
            tg[name], jg[name], rtol=0, atol=GRAD_RTOL * scale + GRAD_ATOL,
            err_msg=name,
        )


class MaskSource:
    """Dropout masks from numpy: the k-th call with a given shape keeps the
    elements where ``default_rng([k, *shape]).random(shape) >= rate``."""

    def __init__(self):
        self.calls: dict[tuple, int] = {}

    def keep(self, shape, rate):
        shape = tuple(int(s) for s in shape)
        k = self.calls.get(shape, 0)
        self.calls[shape] = k + 1
        return np.random.default_rng([k, *shape]).random(shape) >= rate


def _inject_masks(monkeypatch, source):
    def j_dropout(x, rate, rng):
        if rate <= 0.0 or rng is None:
            return x
        keep = source.keep(x.shape, rate)
        return jnp.where(keep, x / (1.0 - rate), 0.0).astype(x.dtype)

    def t_dropout(x, rate, generator):
        if rate <= 0.0 or generator is None:
            return x
        keep = torch.as_tensor(source.keep(x.shape, rate))
        return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))

    monkeypatch.setattr(j_functions, "dropout_apply", j_dropout)
    monkeypatch.setattr(t_functions, "dropout_apply", t_dropout)


@pytest.mark.parametrize(
    "rates", [(0.15, 0.0), (0.0, 0.25), (0.15, 0.25)],
    ids=["conv", "mlp", "conv+mlp"],
)
def test_dropout_matches_chgnet_tpu_through_injected_masks(
    rates, structs, monkeypatch
):
    """E/F/S/M and parameter gradients in train mode, both packages' masks
    from one numpy source; the fused tails unfuse in both."""
    kw = dict(SMALL, angle_fea_dim=8, conv_dropout=rates[0],
              mlp_dropout=rates[1])
    jm, tm, jb, tb = _batches(kw, structs)
    n_graphs, n_atoms = len(structs), sum(len(t) for _, t in structs)
    w = _weights(tb, jb.lattices.shape[0])
    source = MaskSource()
    _inject_masks(monkeypatch, source)
    jax.clear_caches()  # the masks enter at trace time: no earlier trace
    jout, jg = _jax_grads(jm, jb, w, n_graphs, dropout_rng=jax.random.key(0))
    jax_calls = dict(source.calls)
    source.calls.clear()
    tout, tg = _port_grads(
        tm, tb, w, n_graphs, dropout_generator=torch.Generator().manual_seed(0)
    )
    jax.clear_caches()
    # the port skips the last block's angle update: one call fewer of the
    # angle stream's shape, and otherwise the same calls
    assert sum(jax_calls.values()) - sum(source.calls.values()) == (
        1 if rates[0] else 0
    )
    _check_outputs(jout, tout, n_graphs, n_atoms)
    _check_grads(jg, tg)
    # dropout changed the function
    _, base, _, _ = _batches(dict(SMALL, angle_fea_dim=8), structs)
    plain = t_compute_batch(base.params, tb, config=base.config, **FLAGS)
    assert float((plain["e"] - tout["e"]).abs().max()) > 1e-4


def test_dropout_rate_zero_and_eval_mode_are_bit_equal(structs):
    """Rate 0 with a generator, and rates > 0 without one, give exactly the
    dropout-free outputs and gradients."""
    _, base, _, tb = _batches(SMALL, structs)
    w = _weights(tb, tb.lattices.shape[0])
    ref_out, ref_g = _port_grads(base, tb, w, len(structs))
    for kw, gen in (
        (dict(conv_dropout=0.0, mlp_dropout=0.0), torch.Generator().manual_seed(1)),
        (dict(conv_dropout=0.3, mlp_dropout=0.3), None),
    ):
        _, tm, _, _ = _batches(dict(SMALL, **kw), structs)
        out, g = _port_grads(tm, tb, w, len(structs), dropout_generator=gen)
        for key in ref_out:
            assert torch.equal(out[key], ref_out[key]), key
        for name in ref_g:
            np.testing.assert_array_equal(g[name], ref_g[name], err_msg=name)


def test_dropout_draws_from_the_generator_and_survives_remat(structs):
    """The same seed draws the same masks, another seed others; with remat
    each rematerialized layer draws its mask again from its own seed."""
    kw = dict(SMALL, conv_dropout=0.2, mlp_dropout=0.2)
    _, tm, _, tb = _batches(kw, structs)
    _, tm_remat, _, _ = _batches(dict(kw, remat="all"), structs)
    w = _weights(tb, tb.lattices.shape[0])

    def run(model, seed):
        return _port_grads(model, tb, w, len(structs),
                           dropout_generator=torch.Generator().manual_seed(seed))

    out_a, g_a = run(tm, 5)
    out_b, _ = run(tm, 5)
    out_c, _ = run(tm, 6)
    out_r, g_r = run(tm_remat, 5)
    assert torch.equal(out_a["e"], out_b["e"])
    assert not torch.equal(out_a["e"], out_c["e"])
    for key in out_a:
        assert torch.equal(out_r[key], out_a[key]), key
    for name in g_a:
        np.testing.assert_array_equal(g_r[name], g_a[name], err_msg=name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_dropout_unfuses_the_fused_tails(fused, structs, monkeypatch):
    """With dropout on, no layer takes a fused tail (chgnet_tpu's layers
    turn ``fused`` off there); without it the fused config does."""
    taken = []
    for name in ("_fused_layer", "_fused_message_sum"):
        orig = getattr(t_layers, name)

        def spy(*args, _orig=orig, _name=name, **kwargs):
            taken.append(_name)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(t_layers, name, spy)
    kw = dict(SMALL, fused_kernels=fused, conv_dropout=0.2)
    _, tm, _, tb = _batches(kw, structs)
    t_compute_batch(tm.params, tb, config=tm.config, **FLAGS,
                    dropout_generator=torch.Generator().manual_seed(0))
    assert taken == []
    t_compute_batch(tm.params, tb, config=tm.config, **FLAGS)
    assert bool(taken) == fused


@pytest.mark.parametrize("remat", ["all", "angle", True])
def test_remat_equals_no_remat(remat, structs):
    """Rematerialized layers give the same outputs and parameter gradients,
    bit for bit (the recompute runs the same operations in the same order)."""
    _, base, _, tb = _batches(SMALL, structs)
    _, tm, _, _ = _batches(dict(SMALL, remat=remat), structs)
    w = _weights(tb, tb.lattices.shape[0])
    ref_out, ref_g = _port_grads(base, tb, w, len(structs))
    out, g = _port_grads(tm, tb, w, len(structs))
    for key in ref_out:
        assert torch.equal(out[key], ref_out[key]), key
    for name in ref_g:
        np.testing.assert_array_equal(g[name], ref_g[name], err_msg=name)


@pytest.mark.parametrize("read_out", ["attn", "weighted"])
def test_attention_readout_matches_chgnet_tpu(read_out, structs):
    """The same seed draws the same weights (the readout's key MLP included)
    and the pass gives chgnet_tpu's E/F/S/M and parameter gradients."""
    kw = dict(SMALL, mlp_first=False, read_out=read_out)
    jm, tm, jb, tb = _batches(kw, structs)
    jl, tl = dict(_leaves(jm.params)), dict(_leaves(tm.params))
    assert sorted(jl) == sorted(tl) and any("attn_readout" in k for k in tl)
    for name in jl:
        np.testing.assert_array_equal(tl[name].numpy(), np.asarray(jl[name]),
                                      err_msg=name)
    n_graphs, n_atoms = len(structs), sum(len(t) for _, t in structs)
    w = _weights(tb, jb.lattices.shape[0])
    jout, jg = _jax_grads(jm, jb, w, n_graphs)
    tout, tg = _port_grads(tm, tb, w, n_graphs)
    _check_outputs(jout, tout, n_graphs, n_atoms)
    _check_grads(jg, tg)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_matmul_precision_accepted_and_exact_on_the_cpu(precision, structs):
    """TF32 does not exist on the CPU: "high" and "default" give exactly the
    "highest" outputs there, and leave the TF32 flags as they found them."""
    _, base, _, tb = _batches(SMALL, structs)
    _, tm, _, _ = _batches(dict(SMALL, matmul_precision=precision), structs)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    ref = t_compute_batch(base.params, tb, config=base.config, **FLAGS)
    out = t_compute_batch(tm.params, tb, config=tm.config, **FLAGS)
    for key in ref:
        assert torch.equal(out[key], ref[key]), key
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags


def test_config_refuses_only_bf16_and_dense(monkeypatch):
    """``check_supported`` refuses ``dense_atom_conv`` only: bf16 passes on
    both devices, for serving and training, under every switch (every
    kernel has its bf16 form); ``conv_dropout`` with ``dense_atom_conv``
    raises at construction as in chgnet_tpu; bad remat and precision values
    raise."""
    for fields in (
        dict(conv_dropout=0.1, mlp_dropout=0.1), dict(remat="angle"),
        dict(mlp_first=False, read_out="attn"), dict(matmul_precision="high"),
        dict(compute_dtype="bfloat16"),
    ):
        TConfig(**fields).check_supported("cpu")
        TConfig(**fields).check_supported("cuda")
    bf16 = TConfig(compute_dtype="bfloat16")
    bf16.check_supported("cpu")
    bf16.check_supported("cuda")
    for switch in ("CHGNET_TPU_MSG_REDUCE", "CHGNET_TPU_STREAM_V2",
                   "CHGNET_TPU_FUSED_PASS"):
        with monkeypatch.context() as mp:
            mp.setenv(switch, "1")
            bf16.check_supported("cpu")
            TConfig().check_supported("cuda")
            bf16.check_supported("cuda")
    with pytest.raises(NotImplementedError, match="dense_atom_conv"):
        TConfig(dense_atom_conv=True).check_supported("cpu")
    with pytest.raises(NotImplementedError, match="dense_atom_conv"):
        TConfig(conv_dropout=0.1, dense_atom_conv=True)
    with pytest.raises(ValueError, match="remat"):
        TConfig(remat="some")
    with pytest.raises(ValueError, match="matmul_precision"):
        TConfig(matmul_precision="bfloat16_3x")
