"""Time rows 13 and 14, the one-kernel conv pass, in f32 and bf16 on the card.

    python3 tools/time_fused_pass.py [--root DIR] [--repeats N] [--passes N]
                                     [--out FILE] [--against FILE]

Builds ``chip_smoke.py``'s benchmark batch (``bench.py``'s workload: 32
perturbed 216-atom LiMnO2 supercells), records one E+F+S+M pass of
``CHGNet(seed=0)`` under ``CHGNET_TPU_FUSED_PASS=1`` in f32 (path P) and in
``bench.py``'s production bf16 configuration (path P bf16) with the port
found under ``DIR`` (default: this checkout, so that another checkout can be
timed with this script), and times ``fused_pass_fwd`` (row 13) and
``fused_pass_bwd`` (row 14) over each path's calls with CUDA events: all
calls of a pass back to back, per form (the message form with its second
layer, the update form without) and each call alone, each beside its bound
(``chip_smoke.py``'s: inputs read and outputs written once over 3.35 TB/s,
or the products at their operands' rate, whichever is larger). In bf16 the
serving kernels are ``pass_fwd_bf16_kernel`` and ``pass_bwd_bf16_kernel``
(before them, the f32 tiles instantiated for bf16).

The outputs are checked on seeded inputs of each call's shapes (its tables,
aligned part, side rows and cotangent seeded; its indices and parameters
its own): every output against its plain version (``max_rel_err`` over each
output's largest value, ``ok`` at ``chip_smoke.py``'s tolerance:
``KERNELS[...]["tol"]`` in f32, ``bf16_tol`` in bf16: one rounding), and a
SHA-1 of each call's output bits. With ``--against`` (the ``--out`` of
another checkout's run on the same card) the f32 digests must be equal
(``f32_exact``: the f32 kernels are unchanged), and the bf16 outputs, every
``KEEP_EVERY``-th row kept beside ``--out`` (``FILE.pt``), are compared
(``bf16_rel_diff``, over each output's largest value). Then the median of
``--passes`` whole passes of each path, and each kernel's registers, spills
and static shared memory (nvcc's report from the build) and the serving
kernels' dynamic shared memory, warps a block and blocks of a wave (where
the checkout reports them). Prints the card's name and power limit, then
one JSON line; exits 1 when a check fails. Needs one CUDA card.

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
ROWS = {"fused_pass_fwd": 13, "fused_pass_bwd": 14}
PATHS = ("CHGNET_TPU_FUSED_PASS=1", "CHGNET_TPU_FUSED_PASS=1 bf16")
# each row's seeded arguments: the tables (a list), the aligned part, and
# the forward's weights and resnet or the backward's weights and cotangent
SEEDED = {"fused_pass_fwd": (0, 2, 5, 7), "fused_pass_bwd": (0, 2, 5, 7)}


def _digest(tensors) -> str:
    """SHA-1 of the tensors' bits, in order."""
    import torch

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _outputs(out) -> list:
    """A call's output tensors, in order (the backward's that are not None,
    its parameter gradients flattened)."""
    if not isinstance(out, tuple):
        return [out]
    flat = []
    for x in out:
        if isinstance(x, (tuple, list)):
            flat += [t for t in x if t is not None]
        elif x is not None:
            flat.append(x)
    return flat


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE, help="checkout whose port is timed")
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--passes", type=int, default=10)
    parser.add_argument("--out", help="JSON file of this run (and FILE.pt)")
    parser.add_argument("--against", help="--out of another checkout's run")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_fused_pass: needs a CUDA card", file=sys.stderr)
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
    from chgnet_tpu_torch.ops import build
    from chgnet_tpu_torch.ops import fused_pass as fp

    ms = lambda fn: cs.cuda_ms(fn, args.repeats)  # noqa: E731

    def seeded(like, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(like.shape, generator=gen, device="cuda").to(like.dtype)

    def with_seeded_rows(name, a, seed0):
        out = list(a)
        for j in SEEDED[name]:
            x = a[j]
            if isinstance(x, list):
                out[j] = [seeded(t, seed0 + 10 * j + k) for k, t in enumerate(x)]
            elif x is not None:
                out[j] = seeded(x, seed0 + 10 * j)
        return tuple(out)

    def form(a) -> str:
        return "message" if a[5] is not None else "update"

    def timed(name, group) -> dict:
        kern = cs.kernel_versions()[name][0]
        bound, *_ = cs._bounds(name, group)
        return dict(
            calls=len(group),
            ms=ms(lambda: [kern(*a) for a in group]),
            bound_ms=bound["bytes"] + bound["operations"],
            bound_by=max(bound, key=bound.get),
        )

    def shape(a) -> dict:
        return dict(form=form(a), rows=a[1][0].shape[0], parts=len(a[0]),
                    aligned=a[2] is not None, n_src=[t.shape[0] for t in a[0]],
                    d=a[0][0].shape[1] // 2)

    def checked(name, calls, seed0, kept) -> tuple[list, list]:
        """Each call on seeded rows of its shapes: errors against the plain
        version, digests; the bf16 outputs kept (``KEEP_EVERY``)."""
        kern, plain = cs.kernel_versions()[name]
        errs, digests = [], []
        for i, a in enumerate(calls):
            a = with_seeded_rows(name, a, seed0 + 100 * i)
            got, want = _outputs(kern(*a)), _outputs(plain(*a))
            bf16 = got[0].dtype == torch.bfloat16
            tol = cs.bf16_tol(name, a) if bf16 else cs.KERNELS[name]["tol"]
            err = max(cs._errors(g.float(), w.float())[1] for g, w in zip(got, want))
            errs.append(dict(max_rel_err=err, tol=tol, ok=err <= tol,
                             finite=all(bool(g.float().isfinite().all()) for g in got)))
            digests.append(_digest(got))
            if bf16:
                kept += [g[::KEEP_EVERY].float().cpu() for g in got]
        return errs, digests

    graphs = None
    result = {"root": root, "card": cs.card_line(), "paths": {}}
    kept = []
    for path in PATHS:
        kwargs, switch, _ = cs.PATHS[path]
        model = CHGNet(seed=0, device="cuda", **kwargs)
        if graphs is None:
            graphs = cs.bench_graphs(model.graph_converter)
            batch = batch_graphs(graphs).to("cuda")
        with cs.env_switch(switch), cs.Recorder() as rec:
            cs.run_pass(model, batch)
        torch.cuda.synchronize()
        res = {}
        with torch.no_grad():
            for name, row in ROWS.items():
                calls = rec.calls[name]
                errs, digests = checked(name, calls, 1000 * row, kept)
                forms = {}
                for a in calls:
                    forms.setdefault(form(a), []).append(a)
                res[name] = dict(row=row, all=timed(name, calls),
                                 forms={f: timed(name, g) for f, g in forms.items()},
                                 per_call=[dict(**shape(a), **timed(name, [a]))
                                           for a in calls],
                                 plain=errs, digests=digests)
        with cs.env_switch(switch):
            samples = sorted(cs.cuda_ms(lambda: cs.run_pass(model, batch), 1)
                             for _ in range(args.passes))
        res["pass_ms"] = float(np.median(samples))
        res["pass_ms_min_max"] = [samples[0], samples[-1]]
        result["paths"][path] = res
        del model, rec
        torch.cuda.empty_cache()

    result["ptxas"] = [dict(kernel=k, registers=r, spilled=sp, static_smem=sm)
                       for k, r, sp, sm in cs.ptxas_rows(
                           f"{build.lib_path('fused_pass')}.log")
                       if "pass_" in k]
    result["occupancy"] = {k: list(v) for k, v in fp.tc_occupancy().items()}
    ok = all(e["ok"] and e["finite"] for p in result["paths"].values()
             for name in ROWS for e in p[name]["plain"])
    if args.against:
        with open(args.against) as fh:
            other = json.load(fh)
        theirs = torch.load(f"{args.against}.pt")
        f32 = PATHS[0]
        exact = all(result["paths"][f32][n]["digests"] == other["paths"][f32][n]["digests"]
                    for n in ROWS)
        diffs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                 for a, b in zip(kept, theirs)]
        result["against"] = dict(file=args.against, f32_exact=exact,
                                 bf16_rel_diff=max(diffs) if diffs else None)
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
