"""Time the windowed gather on the stream-v2 path's calls on the card.

    python3 tools/time_gather_window.py [--root DIR] [--repeats N] [--passes N]

Builds ``chip_smoke.py``'s benchmark batch (``bench.py``'s workload: 32
perturbed 216-atom LiMnO2 supercells) under ``CHGNET_TPU_STREAM_V2=1``, so
that its plans carry gather windows, records one E+F+S+M pass of the default
model under that switch with the port found under ``DIR`` (default: this
checkout, so another checkout can be timed with this script), and times
``gather_rows_window`` over that pass's calls with CUDA events: in all, per
plan and width, and each call alone, each group also held bit for bit
against the plain version (``exact``). Beside each time: its bound
(``chip_smoke.py``'s: the indices, the windows, the distinct rows named
inside their windows and the output, over 3.35 TB/s), ``gather_rows`` on the
same table and indices (the unwindowed gather, which reads every row it is
named) and ``torch.index_select`` on them. Then the median of ``--passes``
whole passes. Prints the card's name and power limit, then one JSON line,
which also gives each plan's widest window (``SegmentPlan.window_rows``).
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
PLANS = ("plan_center", "plan_nbr", "plan_ang_vi", "plan_ang_vj")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE, help="checkout whose port is timed")
    parser.add_argument("--repeats", type=int, default=20)
    parser.add_argument("--passes", type=int, default=10)
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_gather_window: needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)  # chip_smoke.py's helpers
    sys.path.insert(0, root)  # the port under test, found first
    import chip_smoke as cs
    from chgnet_tpu_torch.graph.batching import batch_graphs
    from chgnet_tpu_torch.models import CHGNet
    from chgnet_tpu_torch.ops import segment

    switch = "CHGNET_TPU_STREAM_V2"
    name = "gather_rows_window"
    model = CHGNet(seed=0, device="cuda")
    with cs.env_switch(switch):
        batch = batch_graphs(cs.bench_graphs(model.graph_converter)).to("cuda")
        with cs.Recorder() as rec:
            cs.run_pass(model, batch)
    torch.cuda.synchronize()
    calls = rec.calls[name]
    plan_of = {getattr(batch, p).window.data_ptr(): p for p in PLANS}

    def timed(group) -> dict:
        bound, *_, libs = cs._bounds(name, group)
        ms = lambda fn: cs.cuda_ms(fn, args.repeats)  # noqa: E731
        return dict(
            calls=len(group),
            exact=all(torch.equal(segment.gather_rows_window(*a),
                                  segment.gather_rows_window_plain(*a))
                      for a in group),
            ms=ms(lambda: [segment.gather_rows_window(*a) for a in group]),
            bound_ms=bound["bytes"] + bound["operations"],
            gather_rows_ms=ms(lambda: [segment.gather_rows(*a[:2]) for a in group]),
            index_select_ms=ms(lambda: [lib() for lib in libs]),
        )

    groups = {}
    for a in calls:
        groups.setdefault(f"{plan_of[a[2].data_ptr()]} d={a[0].shape[1]}", []).append(a)
    result = {"root": root, "card": cs.card_line(),
              "window_rows": {p: getattr(getattr(batch, p), "window_rows", None)
                              for p in PLANS}}
    with torch.no_grad():
        result["all"] = timed(calls)
        result["by_plan"] = {key: timed(group) for key, group in sorted(groups.items())}
        result["per_call"] = [
            dict(plan=plan_of[a[2].data_ptr()], d=a[0].shape[1], rows=a[1].shape[0],
                 **timed([a]))
            for a in calls
        ]
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
