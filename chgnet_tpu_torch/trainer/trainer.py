"""Fine-tuning trainer: optimizers, schedules, checkpoints, resume.

Port of ``chgnet_tpu.trainer.trainer`` on eager PyTorch:

* optimizers SGD (momentum) / Adam / AdamW / RAdam on ``torch.optim``, each
  update equal to the optax chain ``chgnet_tpu`` builds: weight decay added
  to the gradient before SGD / Adam / RAdam (``optax.add_decayed_weights``),
  decoupled in AdamW (``optax.adamw``), and RAdam written here
  (:class:`RAdam`) because ``torch.optim.RAdam`` rectifies at another
  threshold and scales ``eps`` otherwise than ``optax.radam``;
* the composition AtomRef stays frozen, no update and no weight decay,
  unless ``train_composition_model`` (``optax.set_to_zero`` there);
* schedulers MultiStepLR / ExponentialLR / CosineAnnealingLR (T_max = 10 *
  epochs) / CosRestartLR, stepped 10 times an epoch, the learning rate
  written into the parameter groups at each step;
* criterion MSE / MAE / Huber, targets "ef" / "efs" / "efsm", NaN-loss
  abort, per-epoch checkpoint rotation with ``bestE_`` / ``bestF_`` copies,
  ``save`` / ``load`` / resume, optional wandb logging.

A train step is ``compute_batch(..., create_graph=True)`` (forces and
stress keep their graph to the parameters), ``loss.backward()`` and
``optimizer.step()``; the step's metrics come to the host in one read.
Dropout draws from a CPU generator seeded with the global step (the
counterpart of ``jax.random.fold_in(key(0), step)``), so a resumed run
draws as an unbroken one.

``mesh`` trains data-parallel over the ranks of a ``torch.distributed``
group (``parallel/dp.py``), every rank running the same ``train`` call on
the same loaders: rank r takes batch r of each group of ``mesh`` loader
batches (a trailing incomplete group is dropped, so an epoch is ``len(loader)
// mesh`` steps), the gradients are averaged over ranks after each
backward, and every rank takes the same step; validation runs whole on
every rank, and rank 0 alone writes checkpoints. The loaders must yield the
same batches in the same order on every rank (seed their shuffle).

A checkpoint's ``"model"`` half has
``chgnet_tpu``'s layout (``{"params": numpy tree, "model_args": config}``)
and loads in either package's ``CHGNet.from_dict``; its optimizer state is
the ``torch.optim`` ``state_dict`` with numpy arrays.
"""

from __future__ import annotations

import datetime
import math
import os
import pickle
import random
import shutil
import time
from typing import Literal

import numpy as np
import torch
import torch.distributed as dist

from chgnet_tpu_torch import TrainTask
from chgnet_tpu_torch.trainer.losses import CombinedLoss, loss_and_metrics
from chgnet_tpu_torch.utils.common import (
    AverageMeter,
    determine_device,
    requested_device,
    write_json,
)

try:
    import wandb
except ImportError:
    wandb = None

LogFreq = Literal["epoch", "batch"]


def _make_schedule(
    scheduler: str, learning_rate: float, epochs: int, params: dict
):
    """scheduler-step -> lr (``chgnet_tpu.trainer.trainer._make_schedule``:
    upstream's torch schedulers stepped 10 times an epoch)."""
    decay_fraction = params.pop("decay_fraction", 1e-2)
    if scheduler in {"MultiStepLR", "multistep"}:
        milestones = params.pop(
            "milestones", [4 * epochs, 6 * epochs, 8 * epochs, 9 * epochs]
        )
        gamma = params.pop("gamma", 0.3)

        def lr_at(step: int) -> float:
            return learning_rate * gamma ** sum(step >= m for m in milestones)

    elif scheduler in {"ExponentialLR", "Exp", "Exponential", "exp"}:
        gamma = params.pop("gamma", 0.98)

        def lr_at(step: int) -> float:
            return learning_rate * gamma**step

    elif scheduler in {"CosineAnnealingLR", "CosLR", "Cos", "cos"}:
        t_max = 10 * epochs
        eta_min = decay_fraction * learning_rate

        def lr_at(step: int) -> float:
            return eta_min + (learning_rate - eta_min) * 0.5 * (
                1 + math.cos(math.pi * step / t_max)
            )

    elif scheduler in {"CosRestartLR", "cosrestart"}:
        t_0 = params.pop("T_0", 10)
        t_mult = params.pop("T_mult", 2)
        eta_min = decay_fraction * learning_rate

        def lr_at(step: int) -> float:
            t_cur, t_i = step, t_0
            while t_cur >= t_i:
                t_cur -= t_i
                t_i *= t_mult
            return eta_min + (learning_rate - eta_min) * 0.5 * (
                1 + math.cos(math.pi * t_cur / t_i)
            )

    else:
        raise NotImplementedError(f"scheduler {scheduler!r}")
    return lr_at


class RAdam(torch.optim.Optimizer):
    """``optax.radam`` (b1 0.9, b2 0.999, eps 1e-8, threshold 5), with
    ``weight_decay`` added to the gradient first: moments ``mu``, ``nu``
    with bias corrections ``mu_hat``, ``nu_hat``; ``ro = ro_inf - 2 t
    b2^t / (1 - b2^t)``; the update is ``r mu_hat / (sqrt(nu_hat) + eps)``
    while ``ro >= threshold``, else ``mu_hat``. ``torch.optim.RAdam``
    rectifies only while ``ro > 5`` and divides by ``sqrt(nu) + eps``
    before the bias correction."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, threshold: float = 5.0,
                 weight_decay: float = 0.0) -> None:
        defaults = dict(lr=lr, betas=betas, eps=eps, threshold=threshold,
                        weight_decay=weight_decay)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                grad = p.grad
                if group["weight_decay"]:
                    grad = grad.add(p, alpha=group["weight_decay"])
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = int(state["step"])
                mu, nu = state["exp_avg"], state["exp_avg_sq"]
                mu.mul_(b1).add_(grad, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(grad, grad, value=1.0 - b2)
                b2t = b2**t
                ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
                mu_hat = mu / (1.0 - b1**t)
                if ro >= group["threshold"]:
                    r = math.sqrt(
                        (ro - 4.0) * (ro - 2.0) * ro_inf
                        / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)
                    )
                    update = r * mu_hat / ((nu / (1.0 - b2t)).sqrt() + group["eps"])
                else:
                    update = mu_hat
                p.add_(update, alpha=-group["lr"])


def _make_optimizer(name: str, params, lr: float, hyper: dict):
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=hyper["momentum"],
                               weight_decay=hyper["weight_decay"])
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr, weight_decay=hyper["weight_decay"])
    if name == "AdamW":
        return torch.optim.AdamW(params, lr=lr, weight_decay=hyper["weight_decay"])
    if name == "RAdam":
        return RAdam(params, lr=lr, weight_decay=hyper["weight_decay"])
    raise NotImplementedError(f"optimizer {name!r}")


def _leaves(tree, prefix: str = ""):
    """``(path, tensor)`` of every leaf of a parameter tree, in a fixed
    order."""
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _leaves(val, f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            yield from _leaves(val, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy().copy()  # a snapshot, not a view
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _to_torch(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.copy())
    if isinstance(obj, dict):
        return {k: _to_torch(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_torch(v) for v in obj]
    return obj


class Trainer:
    """Train a port ``CHGNet`` on energy / force / stress / magmom targets.

    ``use_device`` defaults to the card (``determine_device``): without one
    it raises unless ``"cpu"`` is asked for. The model is moved to that
    device. ``mesh`` (an int, the size of the initialised process group, or
    a :class:`~chgnet_tpu_torch.parallel.mesh.Mesh`) trains data-parallel
    (see the module's docstring); without a process group it raises.
    """

    def __init__(
        self,
        model=None,
        *,
        targets: TrainTask = "ef",
        energy_loss_ratio: float = 1,
        force_loss_ratio: float = 1,
        stress_loss_ratio: float = 0.1,
        mag_loss_ratio: float = 0.1,
        allow_missing_labels: bool = True,
        optimizer: str = "Adam",
        scheduler: str = "CosLR",
        criterion: str = "MSE",
        epochs: int = 50,
        starting_epoch: int = 0,
        learning_rate: float = 1e-3,
        print_freq: int = 100,
        torch_seed: int | None = None,
        data_seed: int | None = None,
        use_device: str | None = None,
        check_cuda_mem: bool = False,
        wandb_path: str | None = None,
        wandb_init_kwargs: dict | None = None,
        extra_run_config: dict | None = None,
        mesh=None,
        **kwargs,
    ) -> None:
        self.trainer_args = {
            k: v
            for k, v in locals().items()
            if k not in {"self", "__class__", "model", "kwargs", "mesh"}
        } | kwargs
        config = getattr(model, "config", None)
        if config is not None:  # before the card is asked for
            device = torch.device(requested_device(use_device))
            config.check_supported(device.type)
        self.device = torch.device(determine_device(use_device))
        self.mesh = None
        if mesh is not None:
            from chgnet_tpu_torch.parallel.mesh import resolve_mesh

            self.mesh = resolve_mesh(mesh, "data", self.device)
        self._dp = None  # (optimizer, its data-parallel step)
        self.model = model
        if model is not None and model.device != self.device:
            model.to(self.device)
        self.targets = targets
        if torch_seed is not None:
            torch.manual_seed(torch_seed)
        if data_seed is not None:
            random.seed(data_seed)
            np.random.seed(data_seed)

        self.optimizer_name = optimizer
        self.learning_rate = learning_rate
        default_decay = 1e-2 if optimizer == "AdamW" else 0.0
        self._hyper = {
            "momentum": kwargs.pop("momentum", 0.9),
            "weight_decay": kwargs.pop("weight_decay", default_decay),
        }
        if optimizer not in {"SGD", "Adam", "AdamW", "RAdam"}:
            raise NotImplementedError(f"optimizer {optimizer!r}")

        scheduler_params = kwargs.pop("scheduler_params", {})
        self.scheduler_type = scheduler
        self._lr_at = _make_schedule(
            scheduler, learning_rate, epochs, dict(scheduler_params)
        )
        self.scheduler_step = 0
        self._global_step = 0  # seeds the per-step dropout generator

        self.criterion = CombinedLoss(
            target_str=self.targets,
            criterion=criterion,
            energy_loss_ratio=energy_loss_ratio,
            force_loss_ratio=force_loss_ratio,
            stress_loss_ratio=stress_loss_ratio,
            mag_loss_ratio=mag_loss_ratio,
            allow_missing_labels=allow_missing_labels,
            **{k: kwargs[k] for k in ("delta",) if k in kwargs},
        )
        self.epochs = epochs
        self.starting_epoch = starting_epoch
        self.print_freq = print_freq
        self.training_history: dict[str, dict[str, list | float]] = {
            key: {"train": [], "val": [], "test": []} for key in self.targets
        }
        self.best_model_params = None
        self.optimizer = None
        self._train_composition = None

        if wandb_path:
            if wandb is None:
                raise ImportError(
                    "Weights and Biases not installed. pip install wandb to "
                    "use wandb logging."
                )
            if wandb_path.count("/") == 1:
                project, run_name = wandb_path.split("/")
            else:
                raise ValueError(
                    f"{wandb_path=} should be in the format "
                    "'project/run_name' (no extra slashes)"
                )
            wandb.init(
                project=project,
                name=run_name,
                config=self.trainer_args | (extra_run_config or {}),
                **(wandb_init_kwargs or {}),
            )

    # ------------------------------------------------------------ optimizer
    def _build_optimizer(self, train_composition_model: bool) -> None:
        """A fresh optimizer over the model's trainable leaves at the
        current scheduler step's learning rate; the composition AtomRef is
        left out (no gradient, no update, no decay) unless
        ``train_composition_model``."""
        trainable = []
        for path, leaf in _leaves(self.model.params):
            train = train_composition_model or not path.startswith("composition/")
            leaf.requires_grad_(train)
            if train:
                trainable.append(leaf)
        self._trainable = trainable
        self.optimizer = _make_optimizer(
            self.optimizer_name, trainable, self._lr_at(self.scheduler_step),
            self._hyper,
        )
        self._train_composition = train_composition_model

    def _set_lr(self) -> None:
        lr = self._lr_at(self.scheduler_step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    # ---------------------------------------------------------------- steps
    def _on_device(self, batch, targets):
        return batch.to(self.device), {
            k: torch.as_tensor(v).to(self.device) for k, v in targets.items()
        }

    def _metric_vector(self, metrics: dict) -> torch.Tensor:
        """The loss and each target's MAE and label count in one tensor,
        to be read in one transfer."""
        keys = ["loss"] + [f"{k}_MAE{s}" for k in self.targets for s in ("", "_size")]
        return torch.stack([metrics[k].detach().float() for k in keys])

    def _read_metrics(self, vec: torch.Tensor) -> dict:
        vals = vec.tolist()
        out = {"loss": vals[0]}
        for i, key in enumerate(self.targets):
            out[f"{key}_MAE"] = vals[1 + 2 * i]
            out[f"{key}_MAE_size"] = vals[2 + 2 * i]
        return out

    def train_step(self, batch, targets) -> torch.Tensor:
        """One optimizer step on a batch and its targets already on the
        device; returns the step's metrics as one device tensor
        (:meth:`_read_metrics` reads it)."""
        cfg = self.model.config
        if self.mesh is not None:
            metrics = self._dp_step()(
                self.model.params, batch, targets, self._global_step
            )
            self._global_step += 1
            return self._metric_vector(metrics)
        dropout = float(cfg.conv_dropout) > 0 or float(cfg.mlp_dropout) > 0
        gen = torch.Generator().manual_seed(self._global_step) if dropout else None
        loss, metrics = loss_and_metrics(
            self.model.params, batch, targets, config=cfg,
            loss_fn=self.criterion, dropout_generator=gen, create_graph=True,
        )
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        # a leaf the loss does not reach gets a zero gradient, as under
        # jax.grad, so that decay and moments treat it as optax does
        for leaf in self._trainable:
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        self.optimizer.step()
        self._global_step += 1
        return self._metric_vector(metrics)

    def _dp_step(self):
        """The data-parallel step over ``self.mesh`` for the current
        optimizer (``parallel.dp.make_dp_train_step``)."""
        from chgnet_tpu_torch.parallel.dp import make_dp_train_step

        if self._dp is None or self._dp[0] is not self.optimizer:
            self._dp = (self.optimizer, make_dp_train_step(
                config=self.model.config, loss_fn=self.criterion,
                optimizer=self.optimizer, mesh=self.mesh,
            ))
        return self._dp[1]

    def _iter_train_batches(self, train_loader):
        """(batch, targets, graphs of the step) for each train step: under a
        mesh, batch r of each group of D loader batches on rank r (a
        trailing incomplete group dropped) and the group's graphs."""
        if self.mesh is None:
            for batch, targets in train_loader:
                yield batch, targets, int(np.sum(targets["graph_mask"]))
            return
        group: list = []
        for item in train_loader:
            group.append(item)
            if len(group) == self.mesh.size:
                batch, targets = group[self.mesh.rank]
                yield batch, targets, int(sum(np.sum(t["graph_mask"]) for _, t in group))
                group = []

    @property
    def _writes(self) -> bool:
        """Whether this process writes checkpoints (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def eval_step(self, batch, targets) -> torch.Tensor:
        """Metrics of a batch on the device without an update."""
        _, metrics = loss_and_metrics(
            self.model.params, batch, targets, config=self.model.config,
            loss_fn=self.criterion,
        )
        return self._metric_vector(metrics)

    # ----------------------------------------------------------------- train
    def train(
        self,
        train_loader,
        val_loader,
        test_loader=None,
        *,
        save_dir: str | None = "auto",
        save_test_result: bool = False,
        train_composition_model: bool = False,
        wandb_log_freq: LogFreq = "batch",
    ) -> None:
        """Train over padded-batch loaders (upstream ``train`` contract).
        ``save_dir`` defaults to a UTC-date directory; ``None`` writes no
        checkpoint."""
        if self.model is None:
            raise ValueError("Model needs to be initialized")
        if save_dir == "auto":
            save_dir = f"{datetime.datetime.now(tz=datetime.timezone.utc):%m-%d-%Y}"

        print(f"Begin Training: using {self.device} device")
        print(f"training targets: {self.targets}")
        self.trainer_args["train_composition_model"] = train_composition_model
        if self.optimizer is None or (
            self._train_composition != train_composition_model
        ):
            self._build_optimizer(train_composition_model)

        for epoch in range(self.starting_epoch, self.epochs):
            train_mae = self._train(train_loader, epoch, wandb_log_freq)
            if "e" in train_mae and train_mae["e"] != train_mae["e"]:
                print("Exit due to NaN")
                break
            val_mae = self._validate(
                val_loader, is_test=False, wandb_log_freq=wandb_log_freq
            )
            for key in self.targets:
                self.training_history[key]["train"].append(train_mae[key])
                self.training_history[key]["val"].append(val_mae[key])
            if "e" in val_mae and val_mae["e"] != val_mae["e"]:
                print("Exit due to NaN")
                break
            if "e" in val_mae and val_mae["e"] == min(
                self.training_history["e"]["val"]
            ):
                # a snapshot: the live model keeps training
                self.best_model_params = _to_numpy(self.model.params)
            if save_dir:
                if self._writes:
                    self.save_checkpoint(epoch, val_mae, save_dir=save_dir)
                if self.mesh is not None:
                    dist.barrier(group=self.mesh.group)
            if (
                wandb is not None
                and wandb_log_freq == "epoch"
                and self.trainer_args.get("wandb_path")
            ):
                wandb.log(
                    {f"train_{k}_mae": v for k, v in train_mae.items()}
                    | {f"val_{k}_mae": v for k, v in val_mae.items()}
                    | {"epoch": epoch}
                )

        if test_loader is not None:
            print("---------Evaluate Model on Test Set---------------")
            best_file = None
            for file in os.listdir(save_dir) if save_dir else ():
                if file.startswith("bestE_"):
                    best_file = os.path.join(save_dir, file)
            if best_file is not None:
                with open(best_file, "rb") as fh:
                    state = pickle.load(fh)
                self._load_params(state["model"]["params"])
            test_mae = self._validate(
                test_loader,
                is_test=True,
                test_result_save_path=save_dir if save_test_result else None,
            )
            for key in self.targets:
                self.training_history[key]["test"] = test_mae[key]
            if best_file is not None and self._writes:
                self.save(filename=best_file)
            if wandb is not None and self.trainer_args.get("wandb_path"):
                wandb.log({f"test_{k}_mae": v for k, v in test_mae.items()})

    def _load_params(self, tree) -> None:
        """Copy a numpy parameter tree into the model's leaves in place (the
        optimizer keeps its references)."""
        with torch.no_grad():
            for (_, leaf), (_, val) in zip(
                _leaves(self.model.params), _leaves(tree)
            ):
                leaf.copy_(torch.as_tensor(np.asarray(val)))

    def _train(
        self,
        train_loader,
        current_epoch: int,
        wandb_log_freq: LogFreq = "batch",
    ) -> dict:
        """One training epoch; the lr stepped at each tenth of the epoch."""
        batch_time, data_time = AverageMeter(), AverageMeter()
        losses = AverageMeter()
        mae_errors = {t: AverageMeter() for t in self.targets}
        n_batches = len(train_loader) // (self.mesh.size if self.mesh else 1)
        lr_marks = set(np.arange(1, 11) * n_batches // 10)

        start = time.perf_counter()
        for idx, (batch, targets, n_graphs) in enumerate(
            self._iter_train_batches(train_loader)
        ):
            data_time.update(time.perf_counter() - start)
            metrics = self._read_metrics(
                self.train_step(*self._on_device(batch, targets))
            )
            losses.update(metrics["loss"], n_graphs)
            for key in self.targets:
                mae_errors[key].update(
                    metrics[f"{key}_MAE"], int(metrics[f"{key}_MAE_size"])
                )
            if idx + 1 in lr_marks:
                self.scheduler_step += 1
                self._set_lr()
            batch_time.update(time.perf_counter() - start)
            start = time.perf_counter()

            if idx == 0 or (idx + 1) % self.print_freq == 0:
                message = (
                    f"Epoch: [{current_epoch}][{idx + 1}/{n_batches}] | "
                    f"Time ({batch_time.avg:.3f})({data_time.avg:.3f}) | "
                    f"Loss {losses.val:.4f}({losses.avg:.4f}) | MAE "
                )
                for key in self.targets:
                    message += (
                        f"{key} {mae_errors[key].val:.3f}"
                        f"({mae_errors[key].avg:.3f})  "
                    )
                print(message)
            if (
                wandb is not None
                and wandb_log_freq == "batch"
                and self.trainer_args.get("wandb_path")
            ):
                wandb.log(
                    {f"train_{k}_mae": v.avg for k, v in mae_errors.items()}
                    | {
                        "train_loss": losses.avg,
                        "epoch": current_epoch,
                        "batch": idx,
                    }
                )
        return {key: round(err.avg, 6) for key, err in mae_errors.items()}

    def _validate(
        self,
        val_loader,
        *,
        is_test: bool = False,
        test_result_save_path: str | None = None,
        wandb_log_freq: LogFreq = "batch",
    ) -> dict:
        """Validation / test pass (upstream ``trainer.py:450-592``)."""
        losses = AverageMeter()
        mae_errors = {t: AverageMeter() for t in self.targets}
        test_pred: list = []

        for ii, (batch, targets) in enumerate(val_loader):
            metrics = self._read_metrics(
                self.eval_step(*self._on_device(batch, targets))
            )
            losses.update(metrics["loss"], int(np.sum(targets["graph_mask"])))
            for key in self.targets:
                mae_errors[key].update(
                    metrics[f"{key}_MAE"], int(metrics[f"{key}_MAE_size"])
                )
            if is_test and test_result_save_path:
                test_pred.append({"batch": ii, "loss": metrics["loss"]})
            if (
                wandb is not None
                and not is_test
                and wandb_log_freq == "batch"
                and self.trainer_args.get("wandb_path")
            ):
                wandb.log(
                    {f"val_{k}_mae": v.avg for k, v in mae_errors.items()}
                    | {"val_loss": losses.avg, "batch": ii}
                )

        if is_test:
            message = "**  "
            if test_result_save_path:
                write_json(
                    test_pred,
                    os.path.join(test_result_save_path, "test_result.json"),
                )
        else:
            message = "*   "
        for key in self.targets:
            message += f"{key}_MAE ({mae_errors[key].avg:.3f}) \t"
        print(message)
        if (
            wandb is not None
            and not is_test
            and wandb_log_freq == "epoch"
            and self.trainer_args.get("wandb_path")
        ):
            wandb.log({f"val_{k}_mae": v.avg for k, v in mae_errors.items()})
        return {k: round(v.avg, 6) for k, v in mae_errors.items()}

    # ------------------------------------------------------------ persistence
    def get_best_model(self):
        """A fresh CHGNet on the trainer's device carrying the snapshot of
        the epoch with the lowest validation energy error."""
        if self.best_model_params is None:
            raise RuntimeError("the model needs to be trained first")
        best = min(self.training_history["e"]["val"])
        print(f"Best model has val {best =:.4}")
        from chgnet_tpu_torch.models.chgnet import CHGNet

        return CHGNet(
            params=self.best_model_params, device=self.device,
            **self.model.config.as_dict(),
        )

    def save(self, filename: str = "training_result.chkpt.pkl") -> None:
        """Pickle the model half (``chgnet_tpu``'s layout), the optimizer's
        ``state_dict`` as numpy arrays, the scheduler step and history."""
        state = {
            "model": self.model.as_dict(),
            "opt_state": _to_numpy(self.optimizer.state_dict())
            if self.optimizer is not None
            else None,
            "scheduler_step": self.scheduler_step,
            "global_step": self._global_step,
            "training_history": self.training_history,
            "trainer_args": self.trainer_args,
        }
        with open(filename, "wb") as file:
            pickle.dump(state, file)

    def save_checkpoint(
        self, epoch: int, mae_error: dict, save_dir: str
    ) -> None:
        """Per-epoch rotation + bestE_/bestF_ copies (upstream
        ``trainer.py:625-665``)."""
        os.makedirs(save_dir, exist_ok=True)
        for fname in os.listdir(save_dir):
            if fname.startswith("epoch"):
                os.remove(os.path.join(save_dir, fname))
        err_str = "_".join(
            f"{key}{f'{mae_error[key] * 1000:.0f}' if key in mae_error else 'NA'}"
            for key in "efsm"
        )
        filename = os.path.join(save_dir, f"epoch{epoch}_{err_str}.chkpt.pkl")
        self.save(filename=filename)

        if mae_error["e"] == min(self.training_history["e"]["val"]):
            for fname in os.listdir(save_dir):
                if fname.startswith("bestE"):
                    os.remove(os.path.join(save_dir, fname))
            shutil.copyfile(
                filename,
                os.path.join(save_dir, f"bestE_epoch{epoch}_{err_str}.chkpt.pkl"),
            )
        if "f" in self.targets and mae_error["f"] == min(
            self.training_history["f"]["val"]
        ):
            for fname in os.listdir(save_dir):
                if fname.startswith("bestF"):
                    os.remove(os.path.join(save_dir, fname))
            shutil.copyfile(
                filename,
                os.path.join(save_dir, f"bestF_epoch{epoch}_{err_str}.chkpt.pkl"),
            )

    @classmethod
    def load(cls, path: str, *, use_device: str | None = None) -> Trainer:
        """Restore a trainer (model, optimizer, scheduler, history) from a
        checkpoint; ``starting_epoch`` resumes from the history's length.
        ``use_device`` overrides the device the checkpoint was trained
        on."""
        from chgnet_tpu_torch.models.chgnet import CHGNet

        with open(path, "rb") as file:
            state = pickle.load(file)
        args = dict(state["trainer_args"])
        args.pop("model", None)
        if use_device is not None:
            args["use_device"] = use_device
        model = CHGNet.from_dict(
            state["model"], device=determine_device(args.get("use_device"))
        )
        print(f"Loaded model params = {model.n_params:,}")
        trainer = cls(model=model, **args)
        trainer.training_history = state["training_history"]
        trainer.scheduler_step = state["scheduler_step"]
        trainer._global_step = state.get("global_step", 0)
        trainer.starting_epoch = len(trainer.training_history["e"]["train"])
        trainer._build_optimizer(args.get("train_composition_model", False))
        if state["opt_state"] is not None:
            trainer.optimizer.load_state_dict(_to_torch(state["opt_state"]))
        trainer._set_lr()
        return trainer
