"""How far the first train step's parameter gradients lie apart, in f32 and
bf16, on the CPU and on the card.

``chip_smoke.py``'s phase 7 holds the first train steps on the card against
the port's CPU run of the same steps. This script takes the same data (its
``train_data``: bench.py's supercells labelled by ``CHGNet(seed=7)``), the
same 4 structures in batches of 2 and the same full-width ``CHGNet(seed=0)``
trainer, and runs two steps in each of six settings: f32, bf16 with
``matmul_precision="default"`` (the production pair) and bf16 with
``"highest"``, each on the CPU and on the card. It prints each run's two
losses, then for every trained leaf the largest gap between the first
step's gradients of two settings over the largest f32 CPU gradient of that
leaf, for the pairs that tell rounding from a fault: the card against the
CPU in each setting, and each bf16 setting against f32. The last lines give
each pair's largest and median gap over the leaves.

``matmul_precision`` sets only the plain GEMMs' flags (TF32 for f32 GEMMs,
bf16 reductions for bf16 ones, both on the card only); the kernels do the
same arithmetic under every setting.

Run on a machine with a CUDA card, from the repository root:
``python3 scripts/bf16_train_gradient_gap.py``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from chgnet_tpu_torch.data import GraphLoader  # noqa: E402
from chgnet_tpu_torch.trainer.trainer import _leaves  # noqa: E402

SETTINGS = {
    "f32": {},
    "bf16 default": dict(compute_dtype="bfloat16", matmul_precision="default"),
    "bf16 highest": dict(compute_dtype="bfloat16", matmul_precision="highest"),
}
PAIRS = [
    ("f32 cuda", "f32 cpu"),
    ("bf16 default cpu", "f32 cpu"),
    ("bf16 default cuda", "f32 cpu"),
    ("bf16 default cuda", "bf16 default cpu"),
    ("bf16 highest cuda", "f32 cpu"),
    ("bf16 highest cuda", "bf16 highest cpu"),
]


def first_step_gradients(data, indices, device, model_kw):
    """Two train steps; (their losses, every leaf's gradient of the first)."""
    trainer = cs.make_trainer(device, **model_kw)
    trainer._build_optimizer(False)
    loader = GraphLoader(data, indices=indices, batch_size=cs.TRAIN_HOLD_BATCH,
                         shuffle=False)
    losses, grads = [], None
    for batch, targets in loader:
        losses.append(cs._step(trainer, batch, targets)["loss"])
        if grads is None:
            grads = {path: leaf.grad.detach().float().cpu().numpy()
                     for path, leaf in _leaves(trainer.model.params)
                     if leaf.grad is not None}
    return losses, grads


def main() -> None:
    print(cs.card_line(), flush=True)
    data, loaders = cs.train_data()
    indices = loaders[0].indices[:cs.TRAIN_HOLD_STRUCTS]
    runs = {}
    for setting, kw in SETTINGS.items():
        for device in ("cpu", "cuda"):
            t0 = time.perf_counter()
            name = f"{setting} {device}"
            runs[name] = first_step_gradients(data, indices, device, kw)
            print(f"{name}: losses {runs[name][0]} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
    ref = runs["f32 cpu"][1]
    scale = {k: float(np.abs(v).max()) for k, v in ref.items() if np.abs(v).max() > 0}
    gaps = {(a, b): {k: float(np.abs(runs[a][1][k] - runs[b][1][k]).max()) / s
                     for k, s in scale.items()}
            for a, b in PAIRS}
    print("leaf: " + "; ".join(f"{a} vs {b}" for a, b in PAIRS))
    for k in sorted(scale):
        print(k, " ".join(f"{gaps[p][k]:.3e}" for p in PAIRS))
    for label, fn in (("largest", max), ("median", np.median)):
        print(f"{label} over {len(scale)} leaves: "
              + "; ".join(f"{a} vs {b} {fn(list(gaps[(a, b)].values())):.3e}"
                          for a, b in PAIRS))


if __name__ == "__main__":
    main()
