"""The tails' backward calls in one CPU train step, by where they run
(``tools/count_param_calls.py``).

A train step takes forces and stresses by ``torch.autograd.grad(...,
create_graph=True)`` and then the loss's ``backward()``. Both run the tails'
backward with parameter gradients: those asked for inside the force grad
are computed and dropped, since the parameters are not that call's inputs.
These counts are the ones ROADMAP's item I builds on; a change that stops
the force grad from asking for them changes the "force grad" counts here.
No card, no JAX.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
from count_param_calls import count_param_calls  # noqa: E402

COUNTS = {
    False: {"gated_message_bwd": {"force grad": {"params": 7}, "loss backward": {"params": 7}},
            "gated_update_bwd": {"force grad": {"params": 2}, "loss backward": {"params": 2}}},
    True: {"fused_pass_bwd": {"force grad": {"params": 9}, "loss backward": {"params": 9}}},
}


@pytest.mark.parametrize("fused_pass", [False, True], ids=["default", "fused_pass"])
def test_force_grad_asks_for_parameter_gradients(fused_pass):
    """Default model: rows 7 and 9 (7 message and 2 update tails a pass)
    run with parameter gradients once in the force grad and once in the
    loss backward; under ``CHGNET_TPU_FUSED_PASS`` row 14 (9 passes) alike."""
    assert count_param_calls(fused_pass) == COUNTS[fused_pass]
