"""CHGNet on PyTorch: config, parameters, layers and the batched predictor."""

from chgnet_tpu_torch.models.chgnet import (
    CHGNet,
    CHGNetConfig,
    compute_batch,
    init_params,
)
from chgnet_tpu_torch.models.convert import params_from_jax

__all__ = ["CHGNet", "CHGNetConfig", "compute_batch", "init_params", "params_from_jax"]
