"""SHA-1 of each chip_smoke.py path's E/F/S/M on the benchmark batch.

    python3 tools/hash_paths.py [--root DIR] [--out FILE] [--against FILE]
                                [--paths PATH ...] [--twice]

Builds ``chip_smoke.py``'s benchmark batch (``bench.py``'s workload: 32
perturbed 216-atom LiMnO2 supercells) and runs one E+F+S+M pass of every
path of the ``chip_smoke.py`` found under ``DIR`` (default: this checkout),
each under its switch and in its batch layout, with the port found under
``DIR``: so two checkouts' outputs can be held bit for bit, each run by
its own code. Prints one JSON line per path with a SHA-1 of the bits of
e, f, s and m, then the card's name and power limit; with ``--out`` the
digests go to FILE as JSON, and with ``--against`` (another run's
``--out``) every path the two share must have equal digests (``equal``),
or the script exits 1. ``--paths`` runs only the paths named. With
``--twice`` each path's pass runs again, by the same model on the same
batch, and its line also gives the second pass's SHA-1 and the largest
difference of each of e, f, s and m between the two passes (``repeat``):
how far apart two runs of the same code are. Needs one CUDA card.

To hold a change against its parent: unpack the parent with ``git
archive`` into ``build/parent`` and run ``--root build/parent --out P``,
then ``--against P`` in the same call.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke(root: str):
    """``root``'s chip_smoke.py as a module, with ``root`` first on the
    path, so that it imports ``root``'s port."""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def _digest(out) -> str:
    """SHA-1 of the bits of e, f, s and m, in that order."""
    h = hashlib.sha1()
    for key in "efsm":
        h.update(out[key].detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out")
    ap.add_argument("--against")
    ap.add_argument("--paths", nargs="+", help="only these paths")
    ap.add_argument("--twice", action="store_true", help="run each pass twice")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("hash_paths: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    cs = _load_smoke(root)
    from chgnet_tpu_torch.graph.batching import batch_graphs
    from chgnet_tpu_torch.models import CHGNet

    graphs = cs.bench_graphs(CHGNet(seed=0, device="cuda").graph_converter)
    layouts = getattr(cs, "PATH_BATCH", {})
    digests = {}
    for path, (kwargs, switch, _) in cs.PATHS.items():
        if args.paths and path not in args.paths:
            continue
        line = {"root": args.root, "path": path}
        with cs.env_switch(switch):
            batch = batch_graphs(graphs, **layouts.get(path, {})).to("cuda")
            model = CHGNet(seed=0, device="cuda", **kwargs)
            out = cs.run_pass(model, batch)
            again = cs.run_pass(model, batch) if args.twice else None
            torch.cuda.synchronize()
        digests[path] = line["sha1"] = _digest(out)
        if again is not None:
            line["sha1_again"] = _digest(again)
            line["repeat"] = {key: float((out[key] - again[key]).abs().max())
                              for key in "efsm"}
        print(json.dumps(line), flush=True)
        del batch, out, again, model
    print(cs.card_line(), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(digests, fh)
    if args.against:
        with open(args.against) as fh:
            other = json.load(fh)
        shared = [p for p in digests if p in other]
        differ = [p for p in shared if digests[p] != other[p]]
        print(json.dumps({"against": args.against, "paths": len(shared),
                          "equal": not differ, "differ": differ}), flush=True)
        if differ:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
