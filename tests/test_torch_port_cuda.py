"""The port's CUDA kernels on the card: each against its plain version.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. The file imports neither jax nor chgnet_tpu, so it runs on a machine
that has only the port's dependencies:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest

Tolerances: gathers are exact; segment sums 2e-4 absolute on sums of up
to ~50 unit-normal terms (f32 in a fixed order against float64 prefix
sums); gather-project-sum 1e-4 (64-term f32 dot products, gathered then
projected against projected then gathered); the model at the port's CPU
tolerances (e 2e-5 eV/atom, f 5e-5 eV/A, s 2e-4 GPa, m 2e-5 mu_B).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chgnet_tpu_torch import ROOT
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.graph.batching import SegmentPlan, make_plan
from chgnet_tpu_torch.models.chgnet import CHGNet
from chgnet_tpu_torch.ops import gproj as tgp
from chgnet_tpu_torch.ops import segment as tsg

pytestmark = pytest.mark.cuda

SEG_ATOL = 2e-4
GPROJ_ATOL = 1e-4
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
    return SegmentPlan(*(torch.as_tensor(x, device=device) for x in plan))


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


def test_segment_sum_is_deterministic(cuda):
    rng = np.random.default_rng(6)
    plan = _plan(*_stream(rng, 1 << 18, 3000, False), 3000, False, cuda)
    x = torch.randn(1 << 18, 64, device=cuda)
    a = tsg.segment_sum_csr(x, plan.offsets, plan.perm)
    b = tsg.segment_sum_csr(x, plan.offsets, plan.perm)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n_pairs", [1, 2, 3])
def test_gather_project_sum_kernel_matches_plain(cuda, n_pairs):
    rng = np.random.default_rng(7)
    L, S = (1 << 16) + 37, 20000  # a ragged last tile
    tabs = [torch.randn(S, 64, device=cuda) for _ in range(n_pairs)]
    idxs = [
        torch.as_tensor(rng.integers(-2, S + 2, L).astype(np.int32), device=cuda)
        for _ in range(n_pairs)
    ]
    ws = [torch.randn(64, 128, device=cuda) * 0.1 for _ in range(n_pairs)]
    st = torch.randn(L, 128, device=cuda)
    torch.testing.assert_close(
        tgp.gather_project_sum_kernel(tabs, idxs, ws, st),
        tgp.gather_project_sum_plain(tabs, idxs, ws, st),
        atol=GPROJ_ATOL, rtol=0,
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


def test_fused_kernels_true_raises_on_card(cuda):
    model = CHGNet(seed=0, device=cuda, graph_converter_algorithm="numpy")
    with pytest.raises(NotImplementedError, match="Queue 2"):
        model.predict_structure(Structure.from_file(LIMNO2))
