"""Common utilities: device selection, meters, metrics, JSON, parameter trees.

Port of ``chgnet_tpu.utils.common`` (that module imports jax at its top, so
its numpy functions are copied, not imported). :func:`determine_device`
picks the card unless the caller asks for another device, and never falls
back to the CPU: ``chgnet_tpu``'s takes whatever JAX finds. Torch is
imported only by the functions that need it.

Parameter trees go to and from one ``.npz`` file in the same layout in both
packages: one ``param:<path>`` array per leaf, its path the tree's keys and
list indices joined by ``/``, and the model's config as JSON under
``config:json``. A checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np


def cuda_devices_sorted_by_free_mem() -> list[int]:
    """CUDA device ids by increasing free memory (upstream CHGNet's order:
    the last has the most); empty without CUDA."""
    import torch

    if not torch.cuda.is_available():
        return []
    free = [torch.cuda.mem_get_info(i)[0] for i in range(torch.cuda.device_count())]
    return sorted(range(len(free)), key=lambda i: free[i])


def requested_device(use_device: str | None = None) -> str:
    """The device asked for: ``use_device``, else the ``CHGNET_DEVICE``
    environment variable, else ``"cuda"``, without asking for it."""
    return str(use_device or os.getenv("CHGNET_DEVICE") or "cuda")


def determine_device(use_device: str | None = None) -> str:
    """The device to run on (:func:`requested_device`). Raises when CUDA is
    asked for and absent: pass ``"cpu"`` to run there."""
    from chgnet_tpu_torch.device import resolve_device

    use_device = requested_device(use_device)
    resolve_device(use_device)
    return use_device


class AverageMeter:
    """Running average (upstream ``common_utils.py:61-83``)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = self.avg = self.sum = self.count = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        if self.count != 0:
            self.avg = self.sum / self.count


def mae(prediction, target) -> float:
    """Mean absolute error over array-likes."""
    prediction = np.asarray(prediction, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    return float(np.mean(np.abs(target - prediction)))


def _json_handler(obj):
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def read_json(filepath: str) -> dict:
    with open(filepath) as file:
        return json.load(file)


def write_json(dct, filepath: str) -> None:
    with open(filepath, mode="w") as file:
        json.dump(dct, file, default=_json_handler)


def mkdir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def count_params(tree) -> int:
    """Total number of scalars in a nested dict/list tree of arrays or
    tensors."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return int(np.prod(tree.shape))


def flatten_params(params, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a nested dict/list param tree to {'a/b/0/w': array}."""
    flat: dict[str, np.ndarray] = {}
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(params))
    else:
        flat[prefix.rstrip("/")] = np.asarray(params)
        return flat
    for key, val in items:
        flat.update(flatten_params(val, f"{prefix}{key}/"))
    return flat


def unflatten_params(flat: dict[str, np.ndarray]):
    """Inverse of :func:`flatten_params`; integer path segments become lists."""
    tree: dict = {}
    for path, val in flat.items():
        keys = path.split("/")
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def save_params(params, config: dict, path: str) -> None:
    """Serialize a numpy param tree + config to a single .npz."""
    flat = {f"param:{k}": np.asarray(v) for k, v in flatten_params(params).items()}
    flat["config:json"] = np.array(json.dumps(config, default=_json_handler))
    np.savez(path, **flat)


def load_params(path: str):
    """Load (params, config) saved by :func:`save_params`."""
    data = np.load(path, allow_pickle=False)
    flat = {
        k[len("param:"):]: data[k] for k in data.files if k.startswith("param:")
    }
    config = json.loads(str(data["config:json"]))
    return unflatten_params(flat), config
