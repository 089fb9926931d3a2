"""Count the tails' backward calls in one train step, in the force grad and in the loss backward.

    python3 tools/count_param_calls.py

Runs one ``Trainer`` step of ``CHGNet(seed=0)`` (the default configuration)
on the CPU, on a batch of two LiMnO2 cells (``examples/mp-18767-LiMnO2.cif``),
without and with ``CHGNET_TPU_FUSED_PASS``, and counts the calls of
``gated_message_bwd`` (row 7), ``gated_update_bwd`` (row 9) and
``fused_pass_bwd`` (row 14) by their ``need_params`` flag and by where they
run: inside the loss's ``backward()``, or before it, which in a train step
is inside the force and stress ``torch.autograd.grad`` of ``compute_batch``
(the step's only other backward). The parameter gradients asked for there
are computed and dropped: the parameters are not among that call's inputs.
The counts follow the model's layers, not the batch. Prints one JSON line
per switch. No card, no JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPERS = {  # module, wrapper, index of its need_params argument
    "gated_message_bwd": ("chgnet_tpu_torch.ops.gated_message", -1),
    "gated_update_bwd": ("chgnet_tpu_torch.ops.gated_message", -1),
    "fused_pass_bwd": ("chgnet_tpu_torch.ops.fused_pass", 9),
}


@contextlib.contextmanager
def _patched(obj, attr, value):
    saved = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, saved)


def count_param_calls(fused_pass: bool) -> dict:
    """``{wrapper: {"force grad" | "loss backward": {"params": n, "serving":
    n}}}`` of one CPU train step, with ``CHGNET_TPU_FUSED_PASS`` set to 1
    or unset around it; wrappers with no call are left out."""
    import importlib

    import numpy as np
    import torch

    from chgnet_tpu_torch.core import Structure
    from chgnet_tpu_torch.data import StructureData, get_train_val_test_loader
    from chgnet_tpu_torch.models import CHGNet
    from chgnet_tpu_torch.trainer import Trainer

    s = Structure.from_file(os.path.join(HERE, "examples", "mp-18767-LiMnO2.cif"))
    n = len(s)
    data = StructureData(
        structures=[s, s], energies=[-7.0, -7.1],
        forces=[np.zeros((n, 3), np.float32)] * 2,
        stresses=[np.zeros((3, 3), np.float32)] * 2,
        magmoms=[np.zeros(n, np.float32)] * 2, shuffle=False)
    train, _, _ = get_train_val_test_loader(data, batch_size=2, train_ratio=1.0,
                                            val_ratio=0.0)
    batch, targets = next(iter(train))
    where = ["force grad"]  # every backward before the loss's is the force grad's
    counts: dict = {}

    def recording(name, orig, flag):
        def rec(*args):
            kind = "params" if args[flag] else "serving"
            slot = counts.setdefault(name, {}).setdefault(where[0], {})
            slot[kind] = slot.get(kind, 0) + 1
            return orig(*args)
        return rec

    orig_backward = torch.Tensor.backward

    def loss_backward(self, *args, **kwargs):
        where[0] = "loss backward"
        return orig_backward(self, *args, **kwargs)

    with contextlib.ExitStack() as stack:
        for name, (module, flag) in WRAPPERS.items():
            mod = importlib.import_module(module)
            stack.enter_context(_patched(mod, name, recording(name, getattr(mod, name), flag)))
        stack.enter_context(_patched(torch.Tensor, "backward", loss_backward))
        saved = os.environ.pop("CHGNET_TPU_FUSED_PASS", None)
        if fused_pass:
            os.environ["CHGNET_TPU_FUSED_PASS"] = "1"
        try:
            trainer = Trainer(model=CHGNet(seed=0, device="cpu"), targets="efsm",
                              use_device="cpu")
            trainer._build_optimizer(False)
            trainer.train_step(*trainer._on_device(batch, targets))
        finally:
            os.environ.pop("CHGNET_TPU_FUSED_PASS", None)
            if saved is not None:
                os.environ["CHGNET_TPU_FUSED_PASS"] = saved
    return counts


def main() -> int:
    sys.path.insert(0, HERE)
    for fused_pass in (False, True):
        print(json.dumps({"CHGNET_TPU_FUSED_PASS": int(fused_pass),
                          "calls": count_param_calls(fused_pass)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
