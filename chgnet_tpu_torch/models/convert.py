"""Parameter trees between numpy, ``chgnet_tpu`` and the port.

The port keeps ``chgnet_tpu``'s parameter layout (nested dicts and lists,
weights ``[in, out]``), so converting is a leaf-by-leaf copy. The leaves of
``chgnet_tpu``'s tree may be numpy arrays or anything ``np.asarray`` reads.
"""

from __future__ import annotations

import numpy as np
import torch


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(tree, device: str | torch.device = "cpu"):
    """The port's parameters (float32 tensors on ``device``) from a tree in
    ``chgnet_tpu``'s layout: ``chgnet_tpu``'s parameter pytree with numpy
    leaves (e.g. ``jax.tree.map(np.asarray, params)``), or this package's
    ``init_params``."""
    return _map(
        tree,
        lambda x: torch.as_tensor(
            np.asarray(x, dtype=np.float32), device=device
        ).clone(),
    )


def params_to_numpy(tree):
    """The parameter tree as numpy arrays (``chgnet_tpu``'s layout)."""
    return _map(tree, lambda x: x.detach().cpu().numpy())


def count_params(tree) -> int:
    total = 0

    def add(x):
        nonlocal total
        total += int(np.prod(x.shape))

    _map(tree, add)
    return total
