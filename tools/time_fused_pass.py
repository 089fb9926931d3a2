"""Time the one-kernel conv pass's kernels per form on the card.

    python3 tools/time_fused_pass.py [--root DIR] [--repeats N]

Builds ``chip_smoke.py``'s benchmark batch (``bench.py``'s workload: 32
perturbed 216-atom LiMnO2 supercells), records one E+F+S+M pass of the
default model under ``CHGNET_TPU_FUSED_PASS=1`` with the port found under
``DIR`` (default: this checkout, so another checkout can be timed with this
script), and times ``fused_pass_fwd`` and ``fused_pass_bwd`` over that
pass's calls with CUDA events: in all and per form (the message form with
its second layer, the update form without), each beside its bound
(``chip_smoke.py``'s), and each call alone. Then the median of ``--passes``
whole passes. Prints the card's name and power limit, then one JSON line.
Needs one CUDA card.

To compare two checkouts, run it on each in turns (parent, change, change,
parent) in one run on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE, help="checkout whose port is timed")
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--passes", type=int, default=10)
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_fused_pass: needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)  # chip_smoke.py's helpers
    sys.path.insert(0, root)  # the port under test, found first
    import chip_smoke as cs
    from chgnet_tpu_torch.graph.batching import batch_graphs
    from chgnet_tpu_torch.models import CHGNet
    from chgnet_tpu_torch.ops import fused_pass as fp

    switch = "CHGNET_TPU_FUSED_PASS"
    model = CHGNet(seed=0, device="cuda")
    batch = batch_graphs(cs.bench_graphs(model.graph_converter)).to("cuda")
    with cs.env_switch(switch), cs.Recorder() as rec:
        cs.run_pass(model, batch)
    torch.cuda.synchronize()
    result = {"root": root, "card": cs.card_line(), "kernels": {}}
    with torch.no_grad():
        for name, kern in (("fused_pass_fwd", fp.fused_pass_fwd),
                           ("fused_pass_bwd", fp.fused_pass_bwd)):
            calls = rec.calls[name]
            groups = {"all": calls,
                      "message": [a for a in calls if a[5] is not None],
                      "update": [a for a in calls if a[5] is None]}
            row = {}
            for form, group in groups.items():
                ms = cs.cuda_ms(lambda: [kern(*a) for a in group], args.repeats)
                bound, *_ = cs._bounds(name, group)
                row[form] = dict(calls=len(group), ms=ms,
                                 bound_ms=bound["bytes"] + bound["operations"])
            # each call alone: (rows, rows of its first table, form, ms)
            row["per_call"] = [
                (a[1][0].shape[0], a[0][0].shape[0],
                 "message" if a[5] is not None else "update",
                 cs.cuda_ms(lambda: kern(*a), args.repeats))
                for a in calls
            ]
            result["kernels"][name] = row
    with cs.env_switch(switch):
        samples = sorted(cs.cuda_ms(lambda: cs.run_pass(model, batch), 1)
                         for _ in range(args.passes))
    result["pass_ms"] = float(np.median(samples))
    result["pass_ms_min_max"] = [samples[0], samples[-1]]
    print(result["card"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
