"""Time row 11 (segment_sum_tiles) on the stream-v2 paths' calls on the card.

    python3 tools/time_tile_sums.py [--root DIR] [--repeats N] [--runs N]
                                    [--passes N] [--out FILE] [--against FILE]

Builds ``chip_smoke.py``'s benchmark batch (``bench.py``'s workload: 32
perturbed 216-atom LiMnO2 supercells) under ``CHGNET_TPU_STREAM_V2=1``, and
records one E+F+S+M pass of ``CHGNet(seed=0)`` on each of ``PATHS`` (V and
U + V, each in f32 and in ``bench.py``'s production bf16 configuration)
with the port found under ``DIR`` (default: this checkout, so another
checkout can be timed with this script). Then times ``segment_sum_tiles``
over each path's calls with CUDA events, as the median of ``--runs`` runs of
``--repeats`` launches: all calls of a pass back to back, each call alone,
and the calls of each class (n_rows, n_out, d, dtype, whether the stream is
permuted), each beside its bound (``chip_smoke.py``'s: the valid rows, their
permutation entries, the offsets and the output, once each, over 3.35 TB/s)
and ``index_add_`` on the same rows and keys. Each call's class also gives
its mean segment length and its share of empty segments.

Checks, on the recorded calls: each output against ``segment_sum_plain``
(1e-5 of the largest output in f32, one bf16 ulp in bf16, as
``chip_smoke.py`` holds row 11) and two runs equal bit for bit. On seeded
inputs of the recorded shapes it digests the outputs of the paths'
``segment_sum_csr`` and ``segment_sum_pair`` calls (rows 1 and 3, which
share row 11's source); with ``--against`` (the ``--out`` of another
checkout's run) those digests must be equal, and the class times are given
beside the other run's. Then the median of ``--passes`` whole passes of each
path. Prints the card's name and power limit, then one JSON line; exits 1
when a check fails. Needs one CUDA card.

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
PATHS = ("CHGNET_TPU_STREAM_V2=1", "CHGNET_TPU_STREAM_V2=1 bf16",
         "directed_bonds=False CHGNET_TPU_STREAM_V2=1",
         "directed_bonds=False CHGNET_TPU_STREAM_V2=1 bf16")
F32_TOL = 1e-5  # chip_smoke.py KERNELS["segment_sum_tiles"]


def _digest(*tensors) -> str:
    """SHA-1 of the tensors' bits, in order."""
    import torch

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def call_class(args) -> dict:
    """What a call's time depends on: its shape, type, permutation and
    segment lengths."""
    x, offsets, perm = args
    counts = (offsets[1:] - offsets[:-1]).float()
    n_out = counts.numel()
    return dict(n_rows=x.shape[0], n_out=n_out, d=x.shape[1],
                dtype=str(x.dtype).replace("torch.", ""), perm=bool(perm.numel()),
                mean_rows=float(counts.mean()) if n_out else 0.0,
                empty_share=float((counts == 0).float().mean()) if n_out else 0.0)


def class_key(c: dict) -> str:
    return (f"{c['n_rows']}x{c['d']} {c['dtype']} -> {c['n_out']}"
            f"{' perm' if c['perm'] else ''}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE, help="checkout whose port is timed")
    parser.add_argument("--repeats", type=int, default=20)
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--passes", type=int, default=10)
    parser.add_argument("--out", help="JSON file of this run")
    parser.add_argument("--against", help="--out of another checkout's run")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_tile_sums: needs a CUDA card", file=sys.stderr)
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
    from chgnet_tpu_torch.ops import segment

    def ms(fn) -> float:
        return float(np.median([cs.cuda_ms(fn, args.repeats) for _ in range(args.runs)]))

    def timed(group) -> dict:
        kern = segment.segment_sum_tiles
        bound, *_, libs = cs._bounds("segment_sum_tiles", group)
        return dict(calls=len(group), ms=ms(lambda: [kern(*a) for a in group]),
                    bound_ms=bound["bytes"] + bound["operations"],
                    library_ms=ms(lambda: [f() for f in libs]))

    def seeded(shape, dtype, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def checks(calls) -> list:
        out = []
        for a in calls:
            got = segment.segment_sum_tiles(*a)
            again = segment.segment_sum_tiles(*a)
            want = segment.segment_sum_plain(*a)
            err = cs._errors(got.float(), want.float())[1]
            tol = cs.BF16_ULP if got.dtype == torch.bfloat16 else F32_TOL
            out.append(dict(max_rel_err=err, tol=tol, ok=err <= tol,
                            equal_bits=bool(torch.equal(got, again))))
        return out

    def digests(rec) -> list:
        found = []
        for i, a in enumerate(rec.calls["segment_sum_csr"]):
            x = seeded(tuple(a[0].shape), a[0].dtype, 300 + i)
            found.append(_digest(segment.segment_sum_csr(x, *a[1:])))
        for i, a in enumerate(rec.calls["segment_sum_pair"]):
            x = seeded(tuple(a[0].shape), a[0].dtype, 400 + i)
            found.append(_digest(*segment.segment_sum_pair(x, *a[1:])))
        return found

    graphs = cs.bench_graphs(CHGNet(seed=0, device="cuda").graph_converter)
    with cs.env_switch("CHGNET_TPU_STREAM_V2"):  # the plans carry their windows
        batch = batch_graphs(graphs).to("cuda")
    result = {"root": root, "card": cs.card_line(), "paths": {}}
    for path in PATHS:
        kwargs, switch, _ = cs.PATHS[path]
        model = CHGNet(seed=0, device="cuda", **kwargs)
        with cs.env_switch(switch):
            with cs.Recorder() as rec:
                cs.run_pass(model, batch)
            torch.cuda.synchronize()
            calls = rec.calls["segment_sum_tiles"]
            with torch.no_grad():
                classes = {}
                per_call = []
                for a in calls:
                    c = call_class(a)
                    classes.setdefault(class_key(c), (c, []))[1].append(a)
                    per_call.append(dict(**c, **timed([a])))
                res = dict(
                    all=timed(calls), per_call=per_call,
                    classes={k: dict(**c, **timed(g)) for k, (c, g) in classes.items()},
                    checks=checks(calls), digests=digests(rec))
            samples = sorted(cs.cuda_ms(lambda: cs.run_pass(model, batch), 1)
                             for _ in range(args.passes))
        res["pass_ms"] = float(np.median(samples))
        res["pass_ms_min_max"] = [samples[0], samples[-1]]
        result["paths"][path] = res
        del model, rec, calls
        torch.cuda.empty_cache()

    ok = all(c["ok"] and c["equal_bits"] for p in result["paths"].values()
             for c in p["checks"])
    if args.against:
        with open(args.against) as fh:
            other = json.load(fh)
        compared = {}
        for path, res in result["paths"].items():
            theirs = other["paths"][path]
            compared[path] = dict(
                exact=res["digests"] == theirs["digests"],
                all_ms=[res["all"]["ms"], theirs["all"]["ms"]],
                classes_ms={k: [v["ms"], theirs["classes"].get(k, {}).get("ms")]
                            for k, v in res["classes"].items()},
                pass_ms=[res["pass_ms"], theirs["pass_ms"]])
        result["against"] = dict(file=args.against, paths=compared)
        ok &= all(c["exact"] for c in compared.values())
    result["ok"] = ok
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh)
    print(result["card"])
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
