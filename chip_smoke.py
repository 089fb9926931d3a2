"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``chgnet_tpu_torch/csrc`` and drives
the port's main path, E+F+S+M serving with
``CHGNet(seed=0, fused_kernels=False)`` at the default (published 0.3.0)
width, on the card:

1. card and build: the card's name and power limit, the TF32 flags, the
   kernel build time;
2. kernels: one recorded E+F+S+M pass of the benchmark batch (32 perturbed
   216-atom LiMnO2 supercells, ``bench.py``'s workload) captures every
   kernel call with its inputs; each call is re-run through the kernel and
   through its plain PyTorch version on the card and compared, and each
   kernel's autograd op is checked forward and backward against the CPU;
3. model: ``predict_structure`` on LiMnO2 against the port's own CPU run,
   then ``compute_batch`` on the benchmark batch, whose outputs must be
   finite, with per-graph force sums ~0 and symmetric stress; every
   kernel's launch count must rise during that pass; edges/s by CUDA
   events;
4. a ``{"kernels": [...]}`` line: per kernel, its launches in one pass and,
   summed over that pass's calls, its time, its plain version's time, the
   time of one PyTorch library call computing the same function, and the
   least time the card could take: summed over the calls, each call's
   larger of its bytes over 3.35 TB/s and its f32 FLOPs over 67 TFLOP/s
   (the H100 SXM data-sheet peaks), the FLOPs counted in the cheaper order
   where the function has two;
5. profile: one pass under ``torch.profiler``, the device's busy share of
   its wall time and the kernels that take the most device time.

Any failure raises. The last line is the result JSON. Needs one CUDA card;
exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, f32 without tensor cores
N_STRUCTS = 32  # bench.py's workload
TIMED_REPEATS = 5
MODEL_SAMPLES = 10

# per kernel: tolerance on max|kernel - plain| / max(1, max|plain|)
KERNELS = {
    "segment_sum_csr": dict(
        source="chgnet_tpu_torch/csrc/segment_sum.cu",
        replaces="chgnet_tpu/ops/stream_ops.py:135", tol=1e-5,
    ),
    "gather_rows": dict(
        source="chgnet_tpu_torch/csrc/gather_rows.cu",
        replaces="chgnet_tpu/ops/stream_ops.py:645", tol=0.0,
    ),
    "segment_sum_pair": dict(
        source="chgnet_tpu_torch/csrc/segment_sum.cu",
        replaces="chgnet_tpu/ops/stream_ops.py:257", tol=1e-5,
    ),
    "gather_project_sum": dict(
        source="chgnet_tpu_torch/csrc/gproj.cu",
        replaces="chgnet_tpu/ops/gproj.py:62", tol=2e-5,
    ),
}


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


# ------------------------------------------------------------ recording
class Recorder:
    """Swaps each kernel wrapper for one that logs its arguments, for one
    pass; the wrappers' own launch counts are untouched meanwhile."""

    def __init__(self, segment, gproj):
        self.slots = [
            (segment, "segment_sum_csr", "segment_sum_csr"),
            (segment, "gather_rows", "gather_rows"),
            (segment, "segment_sum_pair", "segment_sum_pair"),
            (gproj, "gather_project_sum_kernel", "gather_project_sum"),
        ]
        self.calls = {name: [] for *_, name in self.slots}
        self.saved = []

    def __enter__(self):
        for mod, attr, name in self.slots:
            orig = getattr(mod, attr)
            self.saved.append((mod, attr, orig))

            def rec(*args, _orig=orig, _log=self.calls[name]):
                _log.append(args)
                return _orig(*args)

            rec.launches = 0
            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.saved:
            setattr(mod, attr, orig)


def _rows_valid(offsets: torch.Tensor) -> int:
    return int(offsets[-1])


def bound_and_library(name, args):
    """(bytes, flops, library callable) of one recorded call."""
    if name == "segment_sum_csr":
        x, offsets, perm = args
        n_out, d = offsets.shape[0] - 1, x.shape[1]
        nv = _rows_valid(offsets)
        nbytes = nv * d * 4 + (nv * 4 if perm.numel() else 0)
        nbytes += (n_out + 1) * 4 + n_out * d * 4
        key = _segment_ids(offsets, perm, x.shape[0])
        buf = torch.zeros((n_out + 1, d), device=x.device)
        return nbytes, nv * d, lambda: buf.zero_().index_add_(0, key, x)
    if name == "segment_sum_pair":
        x, oa, pa, ob, pb = args
        n_out, d = oa.shape[0] - 1, x.shape[1]
        ka = _segment_ids(oa, pa, x.shape[0])
        kb = _segment_ids(ob, pb, x.shape[0])
        rows = int(((ka < n_out) | (kb < n_out)).sum())
        nv = _rows_valid(oa) + _rows_valid(ob)
        nbytes = rows * d * 4 + (_rows_valid(oa) * 4 if pa.numel() else 0)
        nbytes += (_rows_valid(ob) * 4 if pb.numel() else 0)
        nbytes += 2 * (n_out + 1) * 4 + 2 * n_out * d * 4
        bufs = [torch.zeros((n_out + 1, d), device=x.device) for _ in range(2)]

        def lib():
            bufs[0].zero_().index_add_(0, ka, x)
            bufs[1].zero_().index_add_(0, kb, x)

        return nbytes, nv * d, lib
    if name == "gather_rows":
        src, idx = args
        d = src.shape[1]
        ok = (idx >= 0) & (idx < src.shape[0])
        distinct = int(torch.unique(idx[ok]).numel())
        nbytes = idx.numel() * 4 + distinct * d * 4 + idx.numel() * d * 4
        safe = idx.clamp(0, src.shape[0] - 1).long()
        return nbytes, 0, lambda: torch.index_select(src, 0, safe)
    if name == "gather_project_sum":
        tables, idxs, ws, stream = args
        n_rows, k_out = stream.shape
        dt = tables[0].shape[1]
        uniq_t = {t.data_ptr(): t for t in tables}
        uniq_i = {i.data_ptr(): i for i in idxs}
        nbytes = sum(t.numel() * 4 for t in uniq_t.values())
        nbytes += sum(i.numel() * 4 for i in uniq_i.values())
        nbytes += len(ws) * dt * k_out * 4 + 2 * n_rows * k_out * 4
        # the fewer FLOPs of two orders: gather then project every row, or
        # project each distinct (table, W) once and add the gathered rows
        gather_first = 2 * n_rows * len(ws) * dt * k_out + n_rows * k_out
        projected = {
            (t.data_ptr(), w.data_ptr()): t.shape[0] for t, w in zip(tables, ws)
        }
        project_first = sum(2 * n * dt * k_out for n in projected.values())
        project_first += len(ws) * n_rows * k_out
        flops = min(gather_first, project_first)
        longs = [i.long() for i in idxs]

        def lib():
            out = stream
            for t, i, w in zip(tables, longs, ws):
                out = out + torch.index_select(t, 0, i) @ w
            return out

        return nbytes, flops, lib
    raise KeyError(name)


def _segment_ids(offsets, perm, n_rows):
    """Row-aligned segment id of every row (n_out for dropped rows)."""
    n_out = offsets.shape[0] - 1
    counts = (offsets[1:] - offsets[:-1]).long()
    sorted_ids = torch.repeat_interleave(
        torch.arange(n_out, device=offsets.device), counts
    )
    ids = torch.full((n_rows,), n_out, dtype=torch.long, device=offsets.device)
    nv = sorted_ids.numel()
    rows = perm[:nv].long() if perm.numel() else torch.arange(nv, device=ids.device)
    ids[rows] = sorted_ids
    return ids


# ------------------------------------------------------------- phases
def phase_card_and_build():
    from chgnet_tpu_torch.ops import build

    log("card:", card_line())
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))
    log("tf32: torch.backends.cuda.matmul.allow_tf32 =",
        torch.backends.cuda.matmul.allow_tf32,
        "torch.backends.cudnn.allow_tf32 =", torch.backends.cudnn.allow_tf32,
        "(compute_batch turns both off while it runs)")
    t0 = time.perf_counter()
    built = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (compiled {built})")


def bench_graphs(converter):
    from chgnet_tpu_torch import ROOT
    from chgnet_tpu_torch.core.structure import Structure

    struct = Structure.from_file(f"{ROOT}/examples/mp-18767-LiMnO2.cif")
    return [
        converter(struct.make_supercell(3).perturb(0.05, seed=seed),
                  graph_id=str(seed))
        for seed in range(N_STRUCTS)
    ]


def run_pass(model, batch):
    from chgnet_tpu_torch.models.chgnet import compute_batch

    return compute_batch(
        model.params, batch, config=model.config, compute_force=True,
        compute_stress=True, compute_magmom=True,
    )


def kernel_versions() -> dict:
    """Kernel name -> (kernel wrapper, its plain version)."""
    from chgnet_tpu_torch.ops import gproj, segment

    return {
        "segment_sum_csr": (segment.segment_sum_csr, segment.segment_sum_plain),
        "gather_rows": (segment.gather_rows, segment.gather_rows_plain),
        "segment_sum_pair": (segment.segment_sum_pair,
                             segment.segment_sum_pair_plain),
        "gather_project_sum": (gproj.gather_project_sum_kernel,
                               gproj.gather_project_sum_plain),
    }


def phase_kernels(calls):
    """Every recorded call through the kernel and its plain version."""
    errors = {}
    for name, (kern, plain) in kernel_versions().items():
        if not calls[name]:
            raise RuntimeError(f"{name}: no call recorded on the main path")
        worst, worst_scaled = 0.0, 0.0
        for args in calls[name]:
            got, want = kern(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                err = float((g - w).abs().max()) if g.numel() else 0.0
                scale = max(1.0, float(w.abs().max()) if w.numel() else 0.0)
                worst = max(worst, err)
                worst_scaled = max(worst_scaled, err / scale)
        torch.cuda.synchronize()
        tol = KERNELS[name]["tol"]
        shapes = sorted({tuple(a.shape) for a in _tensors(calls[name][0])})
        log(f"kernel {name}: {len(calls[name])} calls, max_abs_err {worst:.3e}, "
            f"scaled {worst_scaled:.3e} (tol {tol:g}); first call shapes {shapes}")
        if not worst_scaled <= tol:
            raise AssertionError(f"{name} disagrees with its plain version")
        errors[name] = worst
    return errors


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


def check_autograd(batch):
    """Each autograd op (forward + backward, so both directions of the
    gather/segment-sum pair) on the card against the same op on the CPU,
    at the benchmark batch's angle-stream shapes."""
    from chgnet_tpu_torch.ops.gproj import gather_project_sum
    from chgnet_tpu_torch.ops.segment import (
        plan_gather, plan_segment_sum, plan_segment_sum_pair,
    )

    n_edges = batch.atom_graph.shape[0]
    n_ang = batch.bond_graph.shape[0]
    gen = torch.Generator().manual_seed(0)
    cpu = batch.to("cpu")
    dir_i = batch.bond_graph[:, 2].contiguous()
    dir_j = batch.bond_graph[:, 4].contiguous()
    w = [torch.randn(64, 128, generator=gen) * 0.1 for _ in range(3)]
    inputs = dict(
        x=torch.randn(n_ang, 64, generator=gen),
        table=torch.randn(n_edges, 64, generator=gen),
        atom_e=torch.randn(n_edges, 64, generator=gen),
        acc=torch.randn(n_ang, 128, generator=gen),
    )
    cts = dict(
        seg=torch.randn(n_edges, 64, generator=gen),
        gat=torch.randn(n_ang, 64, generator=gen),
        pair=torch.randn(n_edges, 128, generator=gen),
        gproj=torch.randn(n_ang, 128, generator=gen),
    )

    def ops(dev, b, di, dj, t):
        outs = {}
        outs["segment_sum_csr"] = (
            [plan_segment_sum(t["x"], b.plan_ang_vi)], [t["x"]], [cts["seg"]])
        outs["gather_rows"] = (
            [plan_gather(t["table"], dj, b.plan_ang_vj)], [t["table"]],
            [cts["gat"]])
        outs["segment_sum_pair"] = (
            list(plan_segment_sum_pair(t["acc"], b.plan_ang_vi, b.plan_ang_vj)),
            [t["acc"]], [cts["pair"], cts["pair"] * 0.5])
        ws = [x.to(dev).requires_grad_(True) for x in w]
        outs["gather_project_sum"] = (
            [gather_project_sum(
                [(t["table"], di, b.plan_ang_vi, ws[0]),
                 (t["table"], dj, b.plan_ang_vj, ws[1]),
                 (t["atom_e"], di, b.plan_ang_vi, ws[2])], t["acc"])],
            [t["table"], t["atom_e"], t["acc"], *ws], [cts["gproj"]])
        res = {}
        for name, (out, wrt, ct) in outs.items():
            grads = torch.autograd.grad(out, wrt, [c.to(dev) for c in ct])
            res[name] = [o.detach().cpu() for o in out] + [g.cpu() for g in grads]
        return res

    def leaves(dev):
        return {k: v.to(dev).requires_grad_(True) for k, v in inputs.items()}

    on_card = ops("cuda", batch, dir_i, dir_j, leaves("cuda"))
    on_cpu = ops(
        "cpu", cpu, dir_i.cpu(), dir_j.cpu(), leaves("cpu")
    )
    for name in on_card:
        worst = 0.0
        for g, w_ in zip(on_card[name], on_cpu[name]):
            scale = max(1.0, float(w_.abs().max()))
            worst = max(worst, float((g - w_).abs().max()) / scale)
        tol = max(KERNELS[name]["tol"], 1e-5)
        log(f"autograd {name}: forward + backward vs CPU, scaled err "
            f"{worst:.3e} (tol {tol:g})")
        if not worst <= tol:
            raise AssertionError(f"{name} autograd disagrees with the CPU")


def phase_model(model, cpu_model, batch, n_edges, graphs):
    from chgnet_tpu_torch import ROOT, ops
    from chgnet_tpu_torch.core.structure import Structure

    struct = Structure.from_file(f"{ROOT}/examples/mp-18767-LiMnO2.cif")
    got = model.predict_structure(struct, task="efsm")
    want = cpu_model.predict_structure(struct, task="efsm")
    tol = {"e": 2e-5, "f": 5e-5, "s": 2e-4, "m": 2e-5}
    for key in "efsm":
        err = float(np.abs(np.asarray(got[key]) - np.asarray(want[key])).max())
        log(f"LiMnO2 {key}: card vs CPU max err {err:.3e} (tol {tol[key]:g})")
        if not err <= tol[key]:
            raise AssertionError(f"LiMnO2 {key}: card disagrees with the CPU")
    log(f"LiMnO2 e = {got['e']:.6f} eV/atom")

    ops.reset_launch_counts()
    out = run_pass(model, batch)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    log("launches in one E+F+S+M pass:", launches)
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel never launched on the main path: {launches}")

    n_graphs = len(graphs)
    for key in ("e", "f", "s", "m"):
        if not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"non-finite {key}")
    f = out["f"].cpu().numpy()
    s = out["s"].cpu().numpy()[:n_graphs]
    off, worst = 0, 0.0
    for g in graphs:
        worst = max(worst, float(np.abs(f[off: off + g.n_atoms].sum(0)).max()))
        off += g.n_atoms
    asym = float(np.abs(s - np.swapaxes(s, 1, 2)).max())
    log(f"max |sum f| per graph {worst:.3e} eV/A, max |s - s^T| {asym:.3e} GPa")
    if worst > 1e-3 or asym > 1e-3:
        raise AssertionError("force sums or stress symmetry out of bounds")
    e = out["e"].cpu().numpy()[:n_graphs]
    log(f"e mean {e.mean():.6f} eV/atom over {n_graphs} graphs")

    samples = sorted(
        cuda_ms(lambda: run_pass(model, batch), 1) for _ in range(MODEL_SAMPLES)
    )
    ms = float(np.median(samples))
    n_atoms = sum(g.n_atoms for g in graphs)
    log(f"E+F+S+M on {n_graphs} graphs, {n_atoms} atoms, {n_edges} directed "
        f"edges: median {ms:.3f} ms/pass over {MODEL_SAMPLES} passes "
        f"(min {samples[0]:.3f}, max {samples[-1]:.3f}), "
        f"{n_edges / ms * 1e3:.1f} edges/s ({card_line()})")
    return launches


def profile_pass(model, batch):
    """One E+F+S+M pass under torch.profiler: device time by kernel and the
    device's busy share of the pass's wall time."""
    from torch.profiler import ProfilerActivity, profile

    run_pass(model, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pass(model, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms <= 0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    log(f"profile: one traced pass {wall_ms:.3f} ms wall, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(events)} "
        "kernel names; top by device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
            f"{e.key[:110]}")


def phase_timing(calls, launches, errors):
    """The kernels line: per kernel, totals over one pass's calls."""
    rows = []
    for name, (kern, plain) in kernel_versions().items():
        args_list = calls[name]
        nbytes = flops = 0
        bound = {"bytes": 0.0, "operations": 0.0}  # ms, by what bounds a call
        libs = []
        for args in args_list:
            b, f, lib = bound_and_library(name, args)
            nbytes += b
            flops += f
            libs.append(lib)
            t_bytes = b / HBM_BYTES_PER_S * 1e3
            t_ops = f / F32_FLOPS * 1e3
            if t_bytes >= t_ops:
                bound["bytes"] += t_bytes
            else:
                bound["operations"] += t_ops
        row = dict(
            name=name,
            route="cuda",
            source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"],
            launches=launches[kern.__name__],
            max_abs_err=errors[name],
            ms=cuda_ms(lambda: [kern(*a) for a in args_list], TIMED_REPEATS),
            plain_ms=cuda_ms(lambda: [plain(*a) for a in args_list], 2),
            bound_ms=bound["bytes"] + bound["operations"],
            bound_by=max(bound, key=bound.get),
            library_ms=cuda_ms(lambda: [lib() for lib in libs], TIMED_REPEATS),
        )
        log(f"time {name}: {row['ms']:.4f} ms over {len(args_list)} calls "
            f"(plain {row['plain_ms']:.4f}, library {row['library_ms']:.4f}, "
            f"bound {row['bound_ms']:.4f}: {bound['bytes']:.4f} in calls bound "
            f"by bytes, {bound['operations']:.4f} by operations; "
            f"{nbytes} B, {flops} FLOP)")
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a "
              "CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chgnet_tpu_torch.graph.batching import batch_graphs
    from chgnet_tpu_torch.models import CHGNet
    from chgnet_tpu_torch.ops import gproj, segment

    phase_card_and_build()
    model = CHGNet(seed=0, fused_kernels=False, device="cuda")
    cpu_model = CHGNet(seed=0, fused_kernels=False, device="cpu")
    log(f"model: {model.n_params:,} parameters, default width, "
        f"n_conv={model.config.n_conv}")
    t0 = time.perf_counter()
    graphs = bench_graphs(model.graph_converter)
    n_edges = sum(g.n_directed for g in graphs)
    batch = batch_graphs(graphs).to("cuda")
    log(f"benchmark batch: {len(graphs)} graphs, {n_edges} directed edges, "
        f"{sum(g.n_angles for g in graphs)} angles, "
        f"capacities N={batch.atomic_numbers.shape[0]} "
        f"E={batch.atom_graph.shape[0]} A={batch.bond_graph.shape[0]} "
        f"(host build {time.perf_counter() - t0:.1f} s)")

    with Recorder(segment, gproj) as rec:
        run_pass(model, batch)
    torch.cuda.synchronize()
    with torch.no_grad():
        errors = phase_kernels(rec.calls)
    check_autograd(batch)
    launches = phase_model(model, cpu_model, batch, n_edges, graphs)
    with torch.no_grad():
        rows = phase_timing(rec.calls, launches, errors)
    profile_pass(model, batch)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
