"""``chip_smoke.py``'s launch sets, worked out on the CPU.

The chip run holds each path's kernel launches in one E+F+S+M pass to an
exact set (``chip_smoke.PATHS``). On the CPU every kernel wrapper runs its
plain version, and a pass calls each wrapper exactly where the card
launches its kernel, so recording the wrappers' calls
(``chip_smoke.Recorder``) over one pass of a small crystal gives the same
counts: the layers fix them, and the data only in which plans carry gather
windows under ``CHGNET_TPU_STREAM_V2``. A path of another batch layout
(``chip_smoke.PATH_BATCH``: the dense slots, the halo tiles) builds its
batch in that layout. A block of the undirected layout's
``d2u`` / ``u2d`` / ``u2d2`` streams spans more than ``WINDOW_ROWS`` source
rows only in a crystal of a few hundred bonds or more, so the crystal is a
2x2x2 LiMnO2 supercell, whose plans carry windows as the benchmark batch's
do (checked). Also the product rates its bounds charge each call at
(``chip_smoke.product_rate``). No card, no JAX.
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from chgnet_tpu_torch import ROOT
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.graph.batching import batch_graphs
from chgnet_tpu_torch.models import CHGNet
from chgnet_tpu_torch.models.chgnet import compute_batch


V2 = "CHGNET_TPU_STREAM_V2"
# the plans that carry windows under the switch on chip_smoke.py's
# benchmark batch, and those that do not (its "window plans" line)
BENCH_WINDOWED = ("plan_center", "plan_nbr", "plan_ang_vi", "plan_ang_vj")
UNWINDOWED = ("plan_d2u", "plan_u2d", "plan_u2d2")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: a full-width pass of a
    small crystal is many small ops, which several test processes on one
    machine's cores slow down many times over when each op spreads over
    every core."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("path", list(chip_smoke.PATHS))
def test_recorded_calls_are_the_path_launch_set(path):
    kwargs, switch, expect = chip_smoke.PATHS[path]
    model = CHGNet(seed=0, device="cpu", graph_converter_algorithm="numpy", **kwargs)
    struct = Structure.from_file(f"{ROOT}/examples/mp-18767-LiMnO2.cif")
    with chip_smoke.env_switch(switch):
        batch = batch_graphs([model.graph_converter(struct.make_supercell(2))],
                             **chip_smoke.PATH_BATCH.get(path, {}))
        windowed = {name for name in BENCH_WINDOWED + UNWINDOWED
                    if getattr(batch, name).window.shape[0]}
        assert windowed == (set(BENCH_WINDOWED) if switch == V2 else set())
        batch = batch.to("cpu")
        with chip_smoke.Recorder() as rec:
            compute_batch(model.params, batch, config=model.config, compute_force=True,
                          compute_stress=True, compute_magmom=True)
    got = tuple(len(rec.calls[name]) for name in chip_smoke.KERNELS)
    assert got == expect
    # the storage types chip_smoke.check_bf16_launches holds the card's
    # counts to: on a bf16 path the conv stack's kernels (rows 4-10, 13, 14)
    # take bf16 only, the stream kernels (rows 1-3, 11, 12) some, none for
    # the path's F32_ONLY
    versions = chip_smoke.kernel_versions()
    for name, calls in rec.calls.items():
        n_bf16 = sum(chip_smoke.call_dtype(a) == torch.bfloat16 for a in calls)
        wrapper = versions[name][0].__name__
        if kwargs.get("compute_dtype") != "bfloat16":
            assert n_bf16 == 0, name
        elif wrapper in chip_smoke.CONV_WRAPPERS:
            assert n_bf16 == len(calls), name
        elif wrapper in chip_smoke.F32_ONLY.get(path, ()):
            assert calls and not n_bf16, name
        elif calls:
            assert n_bf16, name


@pytest.mark.parametrize("path", list(chip_smoke.WIDE_PATHS))
def test_recorded_calls_are_the_wide_path_launch_set(path):
    """The launch sets of phase 8's paths at ``WIDE128``
    (``chip_smoke.wide_launch_set``): the 64-wide path's, but the
    stream-v2 switch keeps the sums of rows 128 or 256 wide on
    ``segment_sum_csr``."""
    base, _ = chip_smoke.WIDE_PATHS[path]
    kwargs, switch, _ = chip_smoke.PATHS[base]
    model = CHGNet(seed=0, device="cpu", graph_converter_algorithm="numpy",
                   **kwargs, **chip_smoke.WIDE128)
    model.config.check_supported("cuda")
    struct = Structure.from_file(f"{ROOT}/examples/mp-18767-LiMnO2.cif")
    with chip_smoke.env_switch(switch):
        batch = batch_graphs([model.graph_converter(struct.make_supercell(2))])
        with chip_smoke.Recorder() as rec:
            compute_batch(model.params, batch.to("cpu"), config=model.config,
                          compute_force=True, compute_stress=True,
                          compute_magmom=True)
    got = tuple(len(rec.calls[name]) for name in chip_smoke.KERNELS)
    assert got == chip_smoke.wide_launch_set(base)
    # the storage types of chip_smoke.check_bf16_launches, as above
    bf16 = kwargs.get("compute_dtype") == "bfloat16"
    versions = chip_smoke.kernel_versions()
    for name, calls in rec.calls.items():
        n_bf16 = sum(chip_smoke.call_dtype(a) == torch.bfloat16 for a in calls)
        wrapper = versions[name][0].__name__
        if not bf16:
            assert n_bf16 == 0, name
        elif wrapper in chip_smoke.CONV_WRAPPERS:
            assert n_bf16 == len(calls), name
        elif wrapper in chip_smoke.F32_ONLY.get(path, ()):
            assert calls and not n_bf16, name
        elif calls:
            assert n_bf16, name


def _rate_args(name, dtype, need_params):
    """Arguments of one recorded call, reduced to what the rate reads: the
    storage type and, for a backward, ``need_params``."""
    x = torch.zeros(4, 8, dtype=dtype)
    if name == "gather_project_sum":
        return ([x], [torch.zeros(4, dtype=torch.int32)], [x], x)
    if name == "fused_pass_bwd":
        return ([x], [torch.zeros(4, dtype=torch.int32)], None, x, [x], x, x, x,
                False, need_params)
    if name == "gated_update_bwd":
        return (x, [x], x, need_params)
    return (x, x, x, [x], x, False, need_params)


@pytest.mark.parametrize("name,dtype,need_params,rate", [
    ("gather_project_sum", torch.float32, False, 495e12 / 3),
    ("gather_project_sum", torch.bfloat16, False, 989e12),
    ("gated_message_bwd", torch.float32, True, 495e12 / 3),
    ("gated_message_bwd", torch.bfloat16, False, 989e12 / 2),
    ("gated_message_bwd", torch.bfloat16, True, 3 / (2 / (989e12 / 2) + 1 / (989e12 / 3))),
    ("gated_update_bwd", torch.bfloat16, True, 3 / (2 / (989e12 / 2) + 1 / (989e12 / 3))),
    ("fused_pass_bwd", torch.bfloat16, False, 989e12 / 2),
    ("fused_pass_bwd", torch.bfloat16, True, 3 / (2 / (989e12 / 2) + 1 / (989e12 / 3))),
])
def test_product_rate_follows_the_operand_types(name, dtype, need_params, rate):
    """f32 by f32 products at 3xTF32 (495 / 3 TFLOP/s); bf16 by bf16 at the
    bf16 rate; a bf16 tail's f32 value by its bf16 W2 in two bf16 passes
    (989 / 2: the f32 value split into a bf16 hi and lo), and with
    parameter gradients two such products and one f32 by f32 (dW2, both
    split: three bf16 passes, 989 / 3) of the same size."""
    got = chip_smoke.product_rate(name, _rate_args(name, dtype, need_params))
    assert got == pytest.approx(rate, rel=1e-12)


@pytest.mark.parametrize("exchange", list(chip_smoke.MESH_LAUNCH_SETS))
def test_sharded_forward_launch_set(exchange, tmp_path):
    """Phase 9's sets (``chip_smoke.MESH_LAUNCH_SETS``): one sharded
    E+F+S+M pass of the full-width model with each exchange, on a one-rank
    gloo group. A rank runs the same layers at any world size, so its
    launches are these on the card's two ranks too."""
    import torch.distributed as dist

    from chgnet_tpu_torch.parallel import (
        compute_batch_sharded, initialize, make_mesh, shard_batch, shard_batch_halo,
    )

    model = CHGNet(seed=0, device="cpu", graph_converter_algorithm="numpy")
    struct = Structure.from_file(f"{ROOT}/examples/mp-18767-LiMnO2.cif")
    batch = batch_graphs([model.graph_converter(struct.make_supercell(2))])
    assert initialize(f"file://{tmp_path}/store", 1, 0, backend="gloo")
    try:
        mesh = make_mesh(1, "graph", device="cpu")
        sb, hb = (shard_batch_halo(batch, 1) if exchange == "halo"
                  else (shard_batch(batch, 1), None))
        with chip_smoke.Recorder() as rec:
            compute_batch_sharded(model.params, sb, hb, config=model.config, mesh=mesh,
                                  compute_force=True, compute_stress=True,
                                  compute_magmom=True)
    finally:
        dist.destroy_process_group()
    got = tuple(len(rec.calls[name]) for name in chip_smoke.KERNELS)
    assert got == chip_smoke.MESH_LAUNCH_SETS[exchange]
