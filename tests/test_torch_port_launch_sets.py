"""``chip_smoke.py``'s launch sets, worked out on the CPU.

The chip run holds each path's kernel launches in one E+F+S+M pass to an
exact set (``chip_smoke.PATHS``). On the CPU every kernel wrapper runs its
plain version, and a pass calls each wrapper exactly where the card
launches its kernel, so recording the wrappers' calls
(``chip_smoke.Recorder``) over one pass of a small crystal gives the same
counts: the layers, not the data, fix them. No card, no JAX.
"""

from __future__ import annotations

import pytest

import chip_smoke
from chgnet_tpu_torch import ROOT
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.graph.batching import batch_graphs
from chgnet_tpu_torch.models import CHGNet
from chgnet_tpu_torch.models.chgnet import compute_batch


@pytest.mark.parametrize("path", list(chip_smoke.PATHS))
def test_recorded_calls_are_the_path_launch_set(path):
    kwargs, switch, expect = chip_smoke.PATHS[path]
    model = CHGNet(seed=0, device="cpu", graph_converter_algorithm="numpy", **kwargs)
    struct = Structure.from_file(f"{ROOT}/examples/mp-18767-LiMnO2.cif")
    with chip_smoke.env_switch(switch):
        batch = batch_graphs([model.graph_converter(struct)]).to("cpu")
        with chip_smoke.Recorder() as rec:
            compute_batch(model.params, batch, config=model.config, compute_force=True,
                          compute_stress=True, compute_magmom=True)
    got = tuple(len(rec.calls[name]) for name in chip_smoke.KERNELS)
    assert got == expect
