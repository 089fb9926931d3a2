"""Device meshes over a ``torch.distributed`` process group.

``chgnet_tpu.parallel.mesh`` builds a ``jax.sharding.Mesh`` over the devices
one process drives and runs the mesh paths in that process through
``shard_map``. PyTorch drives several devices with one process per device
(``torch.distributed``: NCCL between cards, gloo on the CPU), so here a mesh
is this process's place in a process group: its rank, the group's size and
the device it computes on. Every rank calls a mesh entry point with the same
arguments (SPMD); per-graph results come out identical on every rank, and
per-atom results in ``chgnet_tpu``'s global block layout.

``chgnet_tpu``'s ``replicated`` and ``batch_sharding`` (``NamedSharding``
specs for ``jax.device_put``) have no counterpart: a tensor lives on one
process's device, and what is replicated is simply computed, or summed
over ranks, on every rank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from chgnet_tpu_torch.device import resolve_device

NO_GROUP = (
    "a mesh needs an initialised torch.distributed process group: call "
    "chgnet_tpu_torch.parallel.initialize() in every rank first (under "
    "torchrun, or with init_method, world_size and rank)"
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``size`` ranks of a process group along ``axis_name``,
    this process being ``rank`` and computing on ``device``. ``group`` is
    the process group (None: the default group)."""

    size: int
    rank: int
    device: torch.device
    axis_name: str = "data"
    group: Any = None

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))


def default_device() -> torch.device:
    """``cuda:{LOCAL_RANK}`` (torchrun's local rank, 0 without it)."""
    return torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")


def make_mesh(
    n_devices: int | None = None,
    axis_name: str = "data",
    *,
    device: str | torch.device | None = None,
    group=None,
) -> Mesh:
    """A 1-D mesh over the ranks of ``group`` (the default group). Raises
    without an initialised process group, and when ``n_devices`` is given
    and differs from the group's size. ``device`` defaults to
    :func:`default_device`; pass ``"cpu"`` to run the plain versions."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(NO_GROUP)
    size = dist.get_world_size(group)
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(
            f"mesh of {n_devices} devices but the process group has {size} "
            "ranks: run one process per device"
        )
    dev = resolve_device(default_device() if device is None else device)
    return Mesh(size, dist.get_rank(group), dev, axis_name, group)


def resolve_mesh(mesh, axis_name: str, device) -> Mesh:
    """An entry point's ``mesh`` argument as a :class:`Mesh`: an int is
    :func:`make_mesh` over the default group on ``device``."""
    if isinstance(mesh, Mesh):
        return mesh
    return make_mesh(int(mesh), axis_name, device=device)
