"""Process-group set-up and the hybrid (data, graph) mesh.

Counterpart of ``chgnet_tpu.parallel.distributed``: :func:`initialize`
brings up ``torch.distributed`` from torchrun's environment or from
explicit arguments (``jax.distributed.initialize`` there), and
:func:`make_hybrid_mesh` lays the ranks out as a 2-D (data, graph)
``DeviceMesh`` with ``chgnet_tpu``'s shape checks.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from chgnet_tpu_torch.parallel.mesh import NO_GROUP

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    backend: str | None = None,
    device_type: str | None = None,
    timeout: float | None = None,
) -> bool:
    """Initialise the default process group; True once one is up.

    Without arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and, where that is
    absent, stays single-process and returns False, as ``chgnet_tpu``'s
    does without a coordinator. Otherwise ``init_method``
    (``tcp://host:port`` or ``file://path``), ``world_size`` and ``rank``
    are used. The backend is ``backend`` if given, else NCCL for
    ``device_type="cuda"`` (the default when a card is present) and gloo
    for the CPU; under NCCL the process's card is ``LOCAL_RANK``'s.
    ``timeout`` (seconds) bounds every collective, so that a rank that
    fails cannot leave its peers waiting for ever."""
    if dist.is_initialized():
        return True
    explicit = init_method is not None or world_size is not None or rank is not None
    if not explicit and not all(k in os.environ for k in _TORCHRUN_VARS):
        return False
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend,
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank),
        **kwargs,
    )
    return True


def make_hybrid_mesh(
    data: int | None = None,
    graph: int = 1,
    *,
    axis_names: tuple[str, str] = ("data", "graph"),
    device_type: str = "cuda",
):
    """A 2-D (data, graph) ``torch.distributed.device_mesh.DeviceMesh`` over
    every rank, the graph axis innermost (consecutive ranks, so its
    exchanges stay within a host). ``data`` defaults to the world size over
    ``graph``; a shape that does not cover the world raises ``ValueError``,
    as ``chgnet_tpu``'s does. ``mesh.get_group(name)`` gives an axis's
    group for :func:`~chgnet_tpu_torch.parallel.mesh.make_mesh`."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(NO_GROUP)
    n = dist.get_world_size()
    if data is None:
        if n % graph:
            raise ValueError(f"{n} devices not divisible by {graph=}")
        data = n // graph
    if data * graph != n:
        raise ValueError(f"mesh {data}x{graph} != {n} global devices")
    return init_device_mesh(device_type, (data, graph), mesh_dim_names=axis_names)
