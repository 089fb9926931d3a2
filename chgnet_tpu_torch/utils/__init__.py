"""Host utilities of the port: parameter trees to and from ``.npz``."""

from chgnet_tpu_torch.utils.common import (
    flatten_params,
    load_params,
    save_params,
    unflatten_params,
)

__all__ = ["flatten_params", "load_params", "save_params", "unflatten_params"]
