"""Time the mesh exchanges of two gloo ranks that share one card.

    python3 tools/time_mesh_exchange.py [--reps N]

Spawns two ranks on ``cuda:0`` under gloo (the transport of
``chip_smoke.py`` phase 9) and times, at the shapes of that phase's
10,240-atom supercell (per rank: an atom table of 7,104 x 64 f32, a bond
table of 315,872 x 64): the parts of a copy through host memory (to the
host, pageable and into a pinned buffer, and back); gloo's all-gather,
reduce-scatter and all-to-all on host tensors, and the reduce-scatter as an
all-to-all and a local sum; gloo's collectives on the CUDA tensors, where
this build's gloo takes them; then each collective of
``chgnet_tpu_torch.parallel.collectives`` as the port calls it (its
reduce-scatter an all-to-all and a sum). Median
milliseconds over ``--reps`` runs, rank 0's, on one JSON line, with the
card's name and power limit. Wall times of two ranks sharing one card and
its host's cores: no measure of NCCL or of several cards.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"atoms": (7104, 64), "bonds": (315872, 64)}
# the tensor forms' newer names, where this torch has them
GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _rank(rank: int, init: str, reps: int, out: str) -> None:
    sys.path.insert(0, ROOT)
    from chgnet_tpu_torch.parallel import initialize, make_mesh
    from chgnet_tpu_torch.parallel import collectives as coll

    torch.cuda.set_device(0)
    initialize(init, 2, rank, backend="gloo", timeout=600)
    mesh = make_mesh(2, "graph", device="cuda:0")
    rows = {}
    try:
        for table, shape in SHAPES.items():
            x = torch.randn(shape, device="cuda:0")
            host = x.cpu()
            pinned = torch.empty(shape, pin_memory=True)
            gathered = torch.empty((2 * shape[0], shape[1]))
            big = torch.randn(2 * shape[0], shape[1])
            scattered = torch.empty(shape)
            pinned_big = torch.empty((2 * shape[0], shape[1]), pin_memory=True)

            def a2a_sum():
                dist.all_to_all_single(gathered, big)
                return gathered.view(2, *shape).sum(0)

            row = {
                "MB": x.nbytes / 1e6,
                "to host, pageable": _median_ms(lambda: x.cpu(), reps),
                "to host, pinned": _median_ms(lambda: pinned.copy_(x), reps),
                "gloo all_gather": _median_ms(
                    lambda: GATHER(gathered, host), reps),
                "gloo reduce_scatter": _median_ms(
                    lambda: SCATTER(scattered, big), reps),
                "gloo all_to_all + sum": _median_ms(a2a_sum, reps),
                "gloo all_to_all": _median_ms(
                    lambda: dist.all_to_all_single(gathered, big), reps),
                "to card, pageable": _median_ms(lambda: big.to("cuda:0"), reps),
                "to card, pinned": _median_ms(lambda: pinned_big.to("cuda:0"), reps),
            }
            xx = torch.randn((2 * shape[0], shape[1]), device="cuda:0")
            # gloo on the CUDA tensors themselves, where it takes them
            native = {
                "all_gather": lambda: GATHER(torch.empty_like(xx), x),
                "reduce_scatter": lambda: SCATTER(torch.empty_like(x), xx),
                "all_to_all": lambda: dist.all_to_all_single(torch.empty_like(xx), xx),
                "all_reduce": lambda: dist.all_reduce(x),
            }
            for op, fn in native.items():
                try:
                    row[f"gloo {op} on CUDA tensors"] = _median_ms(fn, reps)
                except Exception as err:  # refused by this build's gloo
                    row[f"gloo {op} on CUDA tensors"] = f"refused: {str(err)[:120]}"
            row["port all_gather"] = _median_ms(lambda: coll.all_gather(x, mesh), reps)
            row["port reduce_scatter"] = _median_ms(
                lambda: coll.reduce_scatter(xx, mesh), reps)
            row["port all_to_all"] = _median_ms(lambda: coll.all_to_all(xx, mesh), reps)
            rows[table] = row
        if rank == 0:
            with open(out, "w") as fh:
                json.dump(rows, fh)
    finally:
        dist.destroy_process_group()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_mesh_exchange: needs a CUDA card", file=sys.stderr)
        return 1
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        out = os.path.join(tmp, "rank0.json")
        mp.spawn(_rank, args=(f"file://{tmp}/store", args.reps, out), nprocs=2)
        with open(out) as fh:
            rows = json.load(fh)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "ms_median": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
