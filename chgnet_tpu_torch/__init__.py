"""chgnet-tpu-torch: the CHGNet potential of ``chgnet_tpu`` on PyTorch and CUDA.

A second package beside ``chgnet_tpu``: the same structure -> crystal graph
-> padded batch -> energy/forces/stress/magmoms pipeline, with every TPU
(Pallas) kernel on its path replaced by a CUDA C++ kernel written for
Hopper (``chgnet_tpu_torch/csrc``). It imports ``torch``, numpy and scipy
and nothing of ``chgnet_tpu``: the host code it shares (structures, graph
construction, batching) is kept here as its own copy.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU,
where every kernel wrapper uses its plain PyTorch version.
"""

from __future__ import annotations

import os
from typing import Literal

TrainTask = Literal["ef", "efs", "efsm"]
PredTask = Literal["e", "ef", "em", "efs", "efsm"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

__version__ = "0.1.0"
