"""Time rows 7 and 9's serving backward (gated_message_bwd, gated_update_bwd).

    python3 tools/time_tail_bwd.py [--root DIR] [--repeats N] [--passes N]
                                   [--out FILE] [--against FILE]

Builds ``chip_smoke.py``'s benchmark batch (``bench.py``'s workload: 32
perturbed 216-atom LiMnO2 supercells), records one E+F+S+M pass of
``CHGNet(seed=0)`` in f32 (the default path) and in ``bench.py``'s
production bf16 configuration (the bf16 path) with the port found under
``DIR`` (default: this checkout, so that another checkout can be timed with
this script), and times ``gated_message_bwd`` (row 7) and
``gated_update_bwd`` (row 9) over each path's calls with CUDA events: all
calls of a pass back to back, and each call alone, each beside its bound
(``chip_smoke.py``'s: inputs read and outputs written once over 3.35 TB/s,
or the products at their operands' rate, whichever is larger). The serving
calls take the tensor-core tiles: ``tail_bwd_tc_kernel`` in f32,
``tail_bwd_bf16_kernel`` in bf16.

The outputs are checked on seeded inputs of each call's shapes with the
call's own tail parameters: every output against its plain version
(``max_rel_err`` over each output's largest value, ``ok`` at
``chip_smoke.py``'s tolerance: ``KERNELS[...]["tol"]`` in f32, ``bf16_tol``
in bf16), and a SHA-1 of each call's output bits. With ``--against`` (the
``--out`` of another checkout's run on the same card) the f32 digests must
be equal (``f32_exact``: the f32 tile is unchanged), and the bf16 outputs,
every ``KEEP_EVERY``-th row kept beside ``--out`` (``FILE.pt``), are
compared (``bf16_rel_diff``, over each output's largest value). Then the
median of ``--passes`` whole passes of each path. Prints the card's name
and power limit, then one JSON line; exits 1 when a check fails. Needs one
CUDA card.

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
ROWS = {"gated_message_bwd": 7, "gated_update_bwd": 9}


def _digest(tensors) -> str:
    """SHA-1 of the tensors' bits, in order (``None`` skipped)."""
    import torch

    h = hashlib.sha1()
    for t in tensors:
        if t is not None:
            h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _flat(out) -> list:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


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
        print("time_tail_bwd: needs a CUDA card", file=sys.stderr)
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

    ms = lambda fn: cs.cuda_ms(fn, args.repeats)  # noqa: E731

    def seeded(like, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if like.dim() == 1:  # the mask: ~10% zeros
            keep = torch.rand(like.shape, generator=gen, device="cuda") < 0.9
            return keep.to(like.dtype)
        return torch.randn(like.shape, generator=gen, device="cuda").to(like.dtype)

    def timed(name, group) -> dict:
        kern = cs.kernel_versions()[name][0]
        bound, *_ = cs._bounds(name, group)
        return dict(
            calls=len(group),
            ms=ms(lambda: [kern(*a) for a in group]),
            bound_ms=bound["bytes"] + bound["operations"],
            bound_by=max(bound, key=bound.get),
        )

    def checked(name, calls, seed0, kept) -> tuple[list, list]:
        """Each call on seeded inputs of its shapes: errors against the
        plain version, digests; the bf16 outputs kept (``KEEP_EVERY``)."""
        kern, plain = cs.kernel_versions()[name]
        errs, digests = [], []
        for i, a in enumerate(calls):
            a = tuple(seeded(x, seed0 + 10 * i + j)
                      if isinstance(x, torch.Tensor) and j != (3 if len(a) == 7 else 1)
                      else x for j, x in enumerate(a))
            got = _flat(kern(*a))
            want = _flat(plain(*a))
            bf16 = a[0].dtype == torch.bfloat16
            tol = cs.bf16_tol(name, a) if bf16 else cs.KERNELS[name]["tol"]
            err = max(cs._errors(g.float(), w.float())[1]
                      for g, w in zip(got, want) if g is not None)
            errs.append(dict(max_rel_err=err, tol=tol, ok=err <= tol,
                             finite=all(bool(g.float().isfinite().all())
                                        for g in got if g is not None)))
            digests.append(_digest(got))
            if bf16:
                kept.append([g[::KEEP_EVERY].float().cpu()
                             for g in got if g is not None])
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
                res[name] = dict(
                    row=row, all=timed(name, calls),
                    per_call=[dict(rows=a[0].shape[0], d=a[0].shape[1] // 2,
                                   w2=len(a) == 7 or len(a[1]) == 7,
                                   **timed(name, [a])) for a in calls],
                    plain=errs, digests=digests)
        samples = sorted(cs.cuda_ms(lambda: cs.run_pass(model, batch), 1)
                         for _ in range(args.passes))
        res["pass_ms"] = float(np.median(samples))
        res["pass_ms_min_max"] = [samples[0], samples[-1]]
        result["paths"][path] = res
        del model, rec
        torch.cuda.empty_cache()

    ok = all(e["ok"] and e["finite"] for p in result["paths"].values()
             for name in ROWS for e in p[name]["plain"])
    if args.against:
        with open(args.against) as fh:
            other = json.load(fh)
        theirs = torch.load(f"{args.against}.pt")
        exact = all(result["paths"]["default"][n]["digests"]
                    == other["paths"]["default"][n]["digests"] for n in ROWS)
        diffs = [max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                     for a, b in zip(mine, their))
                 for mine, their in zip(kept, theirs)]
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
