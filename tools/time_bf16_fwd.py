"""Time rows 4 and 6 in bf16: gather_project_sum per route and gated_message_fwd.

    python3 tools/time_bf16_fwd.py [--root DIR] [--repeats N] [--passes N]
                                   [--out FILE] [--against FILE]

Builds ``chip_smoke.py``'s benchmark batch (``bench.py``'s workload: 32
perturbed 216-atom LiMnO2 supercells), records one E+F+S+M pass of
``CHGNet(seed=0)`` in f32 (the default path) and in ``bench.py``'s
production bf16 configuration (the bf16 path) with the port found under
``DIR`` (default: this checkout, so that another checkout can be timed with
this script), and times ``gather_project_sum`` (row 4, all calls and each
route's: short tables projected first, long ones gathered first) and
``gated_message_fwd`` (row 6) over each path's calls with CUDA events: all
calls of a pass back to back, and each call alone, each beside its bound
(``chip_smoke.py``'s: inputs read and outputs written once over 3.35 TB/s,
or the products at their operands' rate, whichever is larger). In bf16 the
long route runs ``gproj_bf16_tc_kernel`` and the message forward
``tail_fwd_bf16_kernel``.

The outputs are checked on seeded inputs of each call's shapes (its rows
seeded: tables and stream, or acc, weights and mask; its indices, W and
tail parameters its own): every output against its plain version
(``max_rel_err`` over each output's largest value, ``ok`` at
``chip_smoke.py``'s tolerance: ``KERNELS[...]["tol"]`` in f32,
``bf16_tol`` in bf16: one rounding, the short route one more a pair), and
a SHA-1 of each call's output bits. With ``--against`` (the ``--out`` of
another checkout's run on the same card) the f32 digests must be equal
(``f32_exact``: the f32 kernels are unchanged), and the bf16 outputs, every
``KEEP_EVERY``-th row kept beside ``--out`` (``FILE.pt``), are compared
(``bf16_rel_diff``, over each output's largest value). Then the median of
``--passes`` whole passes of each path, and each kernel's registers,
spills and static shared memory (nvcc's report from the build) and the
long route's and the message forward's dynamic shared memory, warps a
block and blocks an SM (where the checkout reports them). Prints the
card's name and power limit, then one JSON line; exits 1 when a check
fails. Needs one CUDA card.

To compare two checkouts, unpack the parent with ``git archive`` into
``build/parent`` and run, in one run on one card: ``--root build/parent
--out P1``, ``--out C1 --against P1``, ``--out C2 --against P1``, ``--root
build/parent --out P2 --against C1``.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEEP_EVERY = 997  # rows of the bf16 outputs kept for --against
ROWS = {"gather_project_sum": 4, "gated_message_fwd": 6}
# each row's seeded arguments: gather_project_sum (tables, idxs, ws, stream),
# gated_message_fwd (acc, weights, mask, params)
SEEDED = {"gather_project_sum": (0, 3), "gated_message_fwd": (0, 1, 2)}
# the kernels whose build report is kept: both forms of rows 4 and 6
PTXAS = {"gproj": ("gproj_",), "gated_message": ("tail_fwd_",)}


def _digest(tensors) -> str:
    """SHA-1 of the tensors' bits, in order."""
    import torch

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _occupancy() -> dict:
    """The checkout's tensor-core occupancy reports of rows 4 and 6, by
    kernel: (dynamic shared memory, warps a block, blocks of a wave)."""
    from chgnet_tpu_torch.ops import gated_message, gproj

    out = {}
    for mod in (gproj, gated_message):
        if hasattr(mod, "tc_occupancy"):
            out.update({k: list(v) for k, v in mod.tc_occupancy().items()
                        if "gproj" in k or "tail_fwd" in k})
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE, help="checkout whose port is timed")
    parser.add_argument("--repeats", type=int, default=20)
    parser.add_argument("--passes", type=int, default=10)
    parser.add_argument("--out", help="JSON file of this run (and FILE.pt)")
    parser.add_argument("--against", help="--out of another checkout's run")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_bf16_fwd: needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # the port under test, found first
    # this checkout's chip_smoke.py (the other checkout may lack its helpers)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from chgnet_tpu_torch.graph.batching import batch_graphs
    from chgnet_tpu_torch.models import CHGNet
    from chgnet_tpu_torch.ops import build, gproj

    ms = lambda fn: cs.cuda_ms(fn, args.repeats)  # noqa: E731

    def seeded(like, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if like.dim() == 1:  # the mask: ~10% zeros
            keep = torch.rand(like.shape, generator=gen, device="cuda") < 0.9
            return keep.to(like.dtype)
        return torch.randn(like.shape, generator=gen, device="cuda").to(like.dtype)

    def with_seeded_rows(name, a, seed0):
        out = list(a)
        for j in SEEDED[name]:
            x = a[j]
            out[j] = ([seeded(t, seed0 + 10 * j + k) for k, t in enumerate(x)]
                      if isinstance(x, list) else seeded(x, seed0 + 10 * j))
        return tuple(out)

    def timed(name, group) -> dict:
        kern = cs.kernel_versions()[name][0]
        bound, *_ = cs._bounds(name, group)
        return dict(
            calls=len(group),
            ms=ms(lambda: [kern(*a) for a in group]),
            bound_ms=bound["bytes"] + bound["operations"],
            bound_by=max(bound, key=bound.get),
        )

    def shape(name, a) -> dict:
        if name == "gather_project_sum":
            tables, _, _, stream = a
            return dict(route=gproj.call_route(tables, stream), pairs=len(tables),
                        n_src=tables[0].shape[0], rows=stream.shape[0],
                        dt=tables[0].shape[1], k=stream.shape[1])
        return dict(rows=a[0].shape[0], d=a[0].shape[1] // 2)

    def checked(name, calls, seed0, kept) -> tuple[list, list]:
        """Each call on seeded rows of its shapes: errors against the plain
        version, digests; the bf16 outputs kept (``KEEP_EVERY``)."""
        kern, plain = cs.kernel_versions()[name]
        errs, digests = [], []
        for i, a in enumerate(calls):
            a = with_seeded_rows(name, a, seed0 + 100 * i)
            got, want = kern(*a), plain(*a)
            bf16 = got.dtype == torch.bfloat16
            tol = cs.bf16_tol(name, a) if bf16 else cs.KERNELS[name]["tol"]
            err = cs._errors(got.float(), want.float())[1]
            errs.append(dict(max_rel_err=err, tol=tol, ok=err <= tol,
                             finite=bool(got.float().isfinite().all())))
            digests.append(_digest([got]))
            if bf16:
                kept.append(got[::KEEP_EVERY].float().cpu())
        return errs, digests

    graphs = None
    result = {"root": root, "card": cs.card_line(), "paths": {}}
    kept = []
    for path in ("default", "bf16"):
        model = CHGNet(seed=0, device="cuda", **cs.PATHS[path][0])
        if graphs is None:
            graphs = cs.bench_graphs(model.graph_converter)
            batch = batch_graphs(graphs).to("cuda")
        with cs.Recorder() as rec:
            cs.run_pass(model, batch)
        torch.cuda.synchronize()
        res = {}
        with torch.no_grad():
            for name, row in ROWS.items():
                calls = rec.calls[name]
                errs, digests = checked(name, calls, 1000 * row, kept)
                res[name] = dict(row=row, all=timed(name, calls),
                                 per_call=[dict(**shape(name, a), **timed(name, [a]))
                                           for a in calls],
                                 plain=errs, digests=digests)
                if name == "gather_project_sum":
                    routes = {}
                    for a in calls:
                        routes.setdefault(shape(name, a)["route"], []).append(a)
                    res[name]["routes"] = {r: timed(name, g) for r, g in routes.items()}
        samples = sorted(cs.cuda_ms(lambda: cs.run_pass(model, batch), 1)
                         for _ in range(args.passes))
        res["pass_ms"] = float(np.median(samples))
        res["pass_ms_min_max"] = [samples[0], samples[-1]]
        result["paths"][path] = res
        del model, rec
        torch.cuda.empty_cache()

    result["ptxas"] = {
        lib: [dict(kernel=k, registers=r, spilled=sp, static_smem=sm)
              for k, r, sp, sm in cs.ptxas_rows(f"{build.lib_path(lib)}.log")
              if any(p in k for p in prefixes)]
        for lib, prefixes in PTXAS.items()}
    result["occupancy"] = _occupancy()
    ok = all(e["ok"] and e["finite"] for p in result["paths"].values()
             for name in ROWS for e in p[name]["plain"])
    if args.against:
        with open(args.against) as fh:
            other = json.load(fh)
        theirs = torch.load(f"{args.against}.pt")
        exact = all(result["paths"]["default"][n]["digests"]
                    == other["paths"]["default"][n]["digests"] for n in ROWS)
        diffs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                 for a, b in zip(kept, theirs)]
        result["against"] = dict(file=args.against, f32_exact=exact,
                                 bf16_rel_diff=diffs)
        ok &= exact
    result["ok"] = ok
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh)
        torch.save(kept, f"{args.out}.pt")
    print(result["card"])
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
