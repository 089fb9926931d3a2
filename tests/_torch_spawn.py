"""Run a function on several gloo ranks for the port's mesh tests.

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``; each
joins a gloo group through a file in the test's ``tmp_path`` (so that
parallel test workers never share a port), pins one intra-op thread, builds
a :class:`~chgnet_tpu_torch.parallel.mesh.Mesh` (on the CPU unless asked
for the card) and calls ``fn(mesh, *args)``. Every rank's return value
comes back, in rank order; a rank that raises fails the test with its
traceback, and a spawn that outlives its limit is killed and fails. The
worker functions live in modules that import neither jax nor chgnet_tpu,
so each rank starts in a few seconds.
"""

from __future__ import annotations

import os
import time
import uuid

import torch
import torch.multiprocessing as mp

GLOO_TIMEOUT_S = 60  # a rank waits this long for a peer that failed
JOIN_LIMIT_S = 240  # the whole spawn


def _entry(rank, fn, world, init, args, out_dir, device):
    import torch.distributed as dist

    from chgnet_tpu_torch.parallel import initialize, make_mesh

    torch.set_num_threads(1)
    initialize(init, world, rank, backend="gloo", timeout=GLOO_TIMEOUT_S)
    try:
        mesh = make_mesh(world, device=device)
        result = fn(mesh, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args, limit: float = JOIN_LIMIT_S,
          device: str = "cpu") -> list:
    """``[fn(mesh_r, *args) for each rank r]``, run on ``world`` gloo ranks
    whose meshes compute on ``device`` (the card's tests: every rank on
    ``cuda:0``)."""
    out_dir = os.path.join(str(tmp_path), f"spawn_{uuid.uuid4().hex[:8]}")
    os.makedirs(out_dir)
    init = f"file://{out_dir}/store"
    ctx = mp.spawn(
        _entry, args=(fn, world, init, args, out_dir, device), nprocs=world,
        join=False,
    )
    deadline = time.monotonic() + limit
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
            raise TimeoutError(f"{fn.__name__} on {world} ranks outlived {limit} s")
    return [
        torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
        for r in range(world)
    ]
