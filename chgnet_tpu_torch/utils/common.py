"""Parameter trees to and from one ``.npz`` file, with numpy alone.

Copy of the numpy half of ``chgnet_tpu.utils.common`` (that module imports
jax at its top, so the functions are copied, not the module). The file
layout is the same in both packages: one ``param:<path>`` array per leaf,
its path the tree's keys and list indices joined by ``/``, and the model's
config as JSON under ``config:json``. A checkpoint written by either
package loads in the other.
"""

from __future__ import annotations

import json

import numpy as np


def _json_handler(obj):
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


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
