"""``chip_smoke.py``'s launch sets, worked out on the CPU.

The chip run holds each path's kernel launches in one E+F+S+M pass to an
exact set (``chip_smoke.PATHS``). On the CPU every kernel wrapper runs its
plain version, and a pass calls each wrapper exactly where the card
launches its kernel, so recording the wrappers' calls
(``chip_smoke.Recorder``) over one pass of a small crystal gives the same
counts: the layers fix them, and the data only in which plans carry gather
windows under ``CHGNET_TPU_STREAM_V2``. A block of the undirected layout's
``d2u`` / ``u2d`` / ``u2d2`` streams spans more than ``WINDOW_ROWS`` source
rows only in a crystal of a few hundred bonds or more, so the crystal is a
2x2x2 LiMnO2 supercell, whose plans carry windows as the benchmark batch's
do (checked). No card, no JAX.
"""

from __future__ import annotations

import pytest

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


@pytest.mark.parametrize("path", list(chip_smoke.PATHS))
def test_recorded_calls_are_the_path_launch_set(path):
    kwargs, switch, expect = chip_smoke.PATHS[path]
    model = CHGNet(seed=0, device="cpu", graph_converter_algorithm="numpy", **kwargs)
    struct = Structure.from_file(f"{ROOT}/examples/mp-18767-LiMnO2.cif")
    with chip_smoke.env_switch(switch):
        batch = batch_graphs([model.graph_converter(struct.make_supercell(2))])
        windowed = {name for name in BENCH_WINDOWED + UNWINDOWED
                    if getattr(batch, name).window.shape[0]}
        assert windowed == (set(BENCH_WINDOWED) if switch == V2 else set())
        batch = batch.to("cpu")
        with chip_smoke.Recorder() as rec:
            compute_batch(model.params, batch, config=model.config, compute_force=True,
                          compute_stress=True, compute_magmom=True)
    got = tuple(len(rec.calls[name]) for name in chip_smoke.KERNELS)
    assert got == expect
