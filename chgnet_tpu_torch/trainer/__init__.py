"""Training: the combined loss, optimizers and schedules, the Trainer loop
(port of ``chgnet_tpu.trainer``)."""

from chgnet_tpu_torch.trainer.losses import CombinedLoss
from chgnet_tpu_torch.trainer.trainer import Trainer

__all__ = ["CombinedLoss", "Trainer"]
