"""Combined multi-target loss over padded batches.

Port of ``chgnet_tpu.trainer.losses`` (upstream CHGNet's ``CombinedLoss``):
the weighted sum of energy / force / stress / magmom criteria with missing
labels (NaN) and padding masked out. Targets are dense padded tensors
(``chgnet_tpu_torch.data.dataset.collate_padded``): ``e`` [B], ``f``
[N, 3], ``s`` [B, 3, 3], ``m`` [N].

NaN targets are replaced by 0 (``safe_t``) before the criterion sees them,
and the masked mean takes ``torch.where`` over finite values only:
``torch.where`` passes a zero cotangent to its unselected branch, and zero
times a NaN derivative is NaN, so a criterion evaluated on a NaN label
would poison every parameter gradient.
"""

from __future__ import annotations

import torch


def _criterion(name: str, delta: float):
    name = name.lower()
    if name == "mse":
        return lambda pred, target: (pred - target) ** 2
    if name in {"mae", "l1"}:
        return lambda pred, target: torch.abs(pred - target)
    if name == "huber":

        def huber(pred, target):
            err = torch.abs(pred - target)
            quad = torch.clamp(err, max=delta)
            return 0.5 * quad**2 + delta * (err - quad)

        return huber
    raise NotImplementedError(f"criterion {name!r}")


def _masked_mean(values: torch.Tensor, valid: torch.Tensor):
    """(sum(values over valid) / max(count, 1), count)."""
    count = valid.sum().to(values.dtype)
    total = torch.where(valid, values, values.new_zeros(())).sum()
    return total / torch.clamp(count, min=1.0), count


class CombinedLoss:
    """Weighted e/f/s/m loss with NaN-label masking."""

    def __init__(
        self,
        *,
        target_str: str = "ef",
        criterion: str = "MSE",
        energy_loss_ratio: float = 1.0,
        force_loss_ratio: float = 1.0,
        stress_loss_ratio: float = 0.1,
        mag_loss_ratio: float = 0.1,
        delta: float = 0.1,
        allow_missing_labels: bool = True,
    ) -> None:
        self.target_str = target_str
        self.criterion = criterion
        self.delta = delta
        self.allow_missing_labels = allow_missing_labels
        self.energy_loss_ratio = energy_loss_ratio
        self.force_loss_ratio = force_loss_ratio if "f" in target_str else 0.0
        self.stress_loss_ratio = stress_loss_ratio if "s" in target_str else 0.0
        self.mag_loss_ratio = mag_loss_ratio if "m" in target_str else 0.0

    def __call__(
        self,
        targets: dict[str, torch.Tensor],
        prediction: dict[str, torch.Tensor],
        *,
        graph_mask: torch.Tensor,  # [B] 1 for real graphs
        atom_mask: torch.Tensor,  # [N] 1 for real atoms
    ) -> dict[str, torch.Tensor]:
        """``{'loss', '<k>_MAE', '<k>_MAE_size'}`` as tensors."""
        crit = _criterion(self.criterion, self.delta)
        out: dict[str, torch.Tensor] = {
            "loss": prediction["e"].new_zeros(())
        }
        ratios = {
            "e": self.energy_loss_ratio,
            "f": self.force_loss_ratio,
            "s": self.stress_loss_ratio,
            "m": self.mag_loss_ratio,
        }
        for key in "efsm":
            if key not in self.target_str or key not in targets:
                continue
            target = targets[key]
            mask = graph_mask if key in "es" else atom_mask
            mask = mask.reshape(mask.shape + (1,) * (target.dim() - 1))
            valid = (mask > 0).expand_as(target)
            if self.allow_missing_labels:
                valid = valid & ~torch.isnan(target)
            safe_t = torch.where(valid, target, target.new_zeros(()))
            pred = prediction[key]
            loss, count = _masked_mean(crit(pred, safe_t), valid)
            err, _ = _masked_mean(torch.abs(pred - safe_t), valid)
            out["loss"] = out["loss"] + ratios[key] * loss
            out[f"{key}_MAE"], out[f"{key}_MAE_size"] = err, count
        return out


def loss_and_metrics(
    params,
    batch,
    targets,
    *,
    config,
    loss_fn: CombinedLoss,
    dropout_generator: torch.Generator | None = None,
    create_graph: bool = False,
):
    """``(loss, metrics)`` for one padded batch of tensors; with
    ``create_graph`` the loss carries its graph to the parameters
    (forces and stress through their own backward)."""
    from chgnet_tpu_torch.models.chgnet import compute_batch

    prediction = compute_batch(
        params,
        batch,
        config=config,
        compute_force="f" in loss_fn.target_str,
        compute_stress="s" in loss_fn.target_str,
        compute_magmom="m" in loss_fn.target_str,
        dropout_generator=dropout_generator,
        create_graph=create_graph,
    )
    graph_mask = targets.get("graph_mask")
    if graph_mask is None:
        graph_mask = torch.ones_like(prediction["e"])
    # atoms of masked (filler) graphs must not enter force/magmom losses
    atom_mask = batch.atom_mask * graph_mask[batch.atom_owner.long()]
    out = loss_fn(targets, prediction, graph_mask=graph_mask, atom_mask=atom_mask)
    return out["loss"], out
