"""Time rows 3 and 8 (segment_sum_pair, gated_update_fwd) on the card.

    python3 tools/time_stream_rows.py [--root DIR] [--repeats N] [--passes N]
                                      [--out FILE] [--against FILE]

Builds ``chip_smoke.py``'s benchmark batch (``bench.py``'s workload: 32
perturbed 216-atom LiMnO2 supercells), records one E+F+S+M pass of
``CHGNet(seed=0)`` in f32 (the default path) and in ``bench.py``'s
production bf16 configuration (the bf16 path) with the port found under
``DIR`` (default: this checkout, so that another checkout can be timed with
this script), and times ``segment_sum_pair`` and ``gated_update_fwd`` over
each path's calls with CUDA events: all calls of a pass back to back, and
each call alone, each beside its bound (``chip_smoke.py``'s: inputs read and
outputs written once, over 3.35 TB/s) and the library call
(``index_add_`` for each stream of ``segment_sum_pair``; none for
``gated_update_fwd``). For each ``segment_sum_pair`` call it also prints how
wide a range of output rows reaches into ``x`` (``chip_smoke.pair_windows``):
for a block's 8 rows and for the 8,448 rows of as many blocks as the card
holds at once (``WINDOWS``).

The outputs are checked on seeded inputs of each call's shapes and plans
(the recorded ``x``, ``acc`` and ``resnet`` depend on the other kernels of
the pass): ``segment_sum_pair``'s by a SHA-1 of their bits,
``gated_update_fwd``'s against its plain version (``max_rel_err`` over the
output's largest value, ``ok`` at ``chip_smoke.py``'s tolerance) and, by
every 61st row, kept beside ``--out`` (``FILE.pt``). With ``--against`` (the
``--out`` of another checkout's run on the same card) the row-3 digests
must be equal (``exact``) and row 8's kept rows are compared
(``rel_diff``). Then the median of ``--passes`` whole passes of each path.
Prints the card's name and power limit, then one JSON line; exits 1 when a
check fails. Needs one CUDA card.

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
KEEP_EVERY = 61  # rows of gated_update_fwd's outputs kept for --against
# output rows of a block of the pair kernel (8 warps, a row each), and of
# as many such blocks as an H100 holds at once (8 an SM on 132 SMs)
WINDOWS = (8, 8 * 8 * 132)


def _digest(*tensors) -> str:
    """SHA-1 of the tensors' bits, in order."""
    import torch

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


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
        print("time_stream_rows: needs a CUDA card", file=sys.stderr)
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
    from chgnet_tpu_torch.ops import gated_message as gm
    from chgnet_tpu_torch.ops import segment

    ms = lambda fn: cs.cuda_ms(fn, args.repeats)  # noqa: E731

    def seeded(shape, dtype, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def timed(name, group) -> dict:
        kern = cs.kernel_versions()[name][0]
        bound, *_, libs = cs._bounds(name, group)
        return dict(
            calls=len(group),
            ms=ms(lambda: [kern(*a) for a in group]),
            bound_ms=bound["bytes"] + bound["operations"],
            bound_by=max(bound, key=bound.get),
            library_ms=None if libs[0] is None else ms(lambda: [f() for f in libs]),
        )

    def row3(calls) -> dict:
        per_call, digests = [], []
        for i, a in enumerate(calls):
            x = a[0]
            n_out = a[1].shape[0] - 1
            per_call.append(dict(rows=x.shape[0], n_out=n_out, d=x.shape[1],
                                 windows=[cs.pair_windows(a, r) for r in WINDOWS],
                                 **timed("segment_sum_pair", [a])))
            xs = seeded(tuple(x.shape), x.dtype, i)
            digests.append(_digest(*segment.segment_sum_pair(xs, *a[1:])))
        return dict(all=timed("segment_sum_pair", calls), per_call=per_call,
                    digests=digests)

    def row8(calls, kept) -> dict:
        per_call, errs = [], []
        tol = cs.KERNELS["gated_update_fwd"]["tol"]
        for i, (acc, resnet, params) in enumerate(calls):
            per_call.append(dict(rows=acc.shape[0], d=resnet.shape[1],
                                 **timed("gated_update_fwd", [(acc, resnet, params)])))
            a = seeded(tuple(acc.shape), acc.dtype, 100 + i)
            r = seeded(tuple(resnet.shape), resnet.dtype, 200 + i)
            got = gm.gated_update_fwd(a, r, params)
            want = gm.gated_update_plain(a, r, params)
            err = cs._errors(got.float(), want.float())[1]
            bar = cs.bf16_tol("gated_update_fwd", (a, r, params)) \
                if acc.dtype == torch.bfloat16 else tol
            errs.append(dict(max_rel_err=err, tol=bar, ok=err <= bar))
            kept.append(got[::KEEP_EVERY].float().cpu())
        return dict(all=timed("gated_update_fwd", calls), per_call=per_call,
                    plain=errs)

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
        with torch.no_grad():
            res = {"segment_sum_pair": row3(rec.calls["segment_sum_pair"]),
                   "gated_update_fwd": row8(rec.calls["gated_update_fwd"], kept)}
        samples = sorted(cs.cuda_ms(lambda: cs.run_pass(model, batch), 1)
                         for _ in range(args.passes))
        res["pass_ms"] = float(np.median(samples))
        res["pass_ms_min_max"] = [samples[0], samples[-1]]
        result["paths"][path] = res
        del model, rec
        torch.cuda.empty_cache()

    ok = all(e["ok"] for p in result["paths"].values()
             for e in p["gated_update_fwd"]["plain"])
    if args.against:
        with open(args.against) as fh:
            other = json.load(fh)
        theirs = torch.load(f"{args.against}.pt")
        compared = {}
        for path, res in result["paths"].items():
            mine = res["segment_sum_pair"]["digests"]
            compared[path] = dict(
                exact=mine == other["paths"][path]["segment_sum_pair"]["digests"])
        diffs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                 for a, b in zip(kept, theirs)]
        compared["gated_update_fwd_rel_diff"] = diffs
        result["against"] = dict(file=args.against, **compared)
        ok &= all(compared[p]["exact"] for p in result["paths"])
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
