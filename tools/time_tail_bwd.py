"""Time rows 7 and 9's backward (gated_message_bwd, gated_update_bwd): serving, or in a train step.

    python3 tools/time_tail_bwd.py [--train] [--root DIR] [--repeats N]
                                   [--passes N] [--out FILE] [--against FILE]

With the port found under ``DIR`` (default: this checkout, so that another
checkout can be timed with this script) it records, in f32 and in bf16:

- serving (the default): one E+F+S+M pass of ``CHGNet(seed=0)`` over
  ``chip_smoke.py``'s benchmark batch (``bench.py``'s workload: 32
  perturbed 216-atom LiMnO2 supercells) on the default path and in
  ``bench.py``'s production bf16 configuration (the bf16 path); the calls
  take the serving tiles, ``tail_bwd_tc_kernel`` in f32 and
  ``tail_bwd_bf16_kernel`` in bf16;
- ``--train``: one ``Trainer`` step on the first train batch (8 x 216
  atoms) of ``chip_smoke.py``'s train data (its phase 7: the supercells
  labelled on the card by ``CHGNet(seed=7)``), in f32 and in the bf16
  training configuration (``chip_smoke.BF16_KW``), keeping the calls with
  parameter gradients (rows 7p and 9p), which take
  ``tail_bwd_param_tc_kernel`` in f32 and ``tail_bwd_param_bf16_kernel``
  in bf16.

Then it times each row over the recorded calls with CUDA events (mean of
``--repeats``): all calls back to back, per form (message, update with and
without W2) and each call alone, each beside its bound (``chip_smoke.py``'s:
inputs read and outputs written once over 3.35 TB/s, or the products at
their operands' rate, whichever is larger). Each call runs on seeded
inputs of its shapes with its own tail parameters: every output against
its plain version (``max_rel_err`` over each output's largest value, ``ok``
at ``chip_smoke.py``'s tolerance: ``KERNELS[...]["tol"]`` in f32,
``bf16_tol`` in bf16), twice (``repeat_exact``: equal bits), and a SHA-1 of
its output bits. Then the median of ``--passes`` whole passes, or train
steps (each ending in its metrics' read back, by the host clock:
``steps_per_s``). With ``--train`` also the registers and spills of the
kernels with parameter gradients (nvcc's report from the build) and their
shared memory, warps a block and blocks of a wave (where the checkout
reports them).

With ``--against`` (the ``--out`` of another checkout's run in the same
mode on the same card) every time is also given as a ratio to the other's;
serving, the f32 digests must be equal (``f32_exact``: the f32 tile
unchanged), and the bf16 outputs, every ``KEEP_EVERY``-th row kept beside
``--out`` (``FILE.pt``), are compared (``bf16_rel_diff``, over each
output's largest value). No bits are compared between checkouts with
``--train``: the parameter gradients' f32 sums may add in another order.
Prints the card's name and power limit, then one JSON line; exits 1 when a
check fails. Needs one CUDA card.

To compare two checkouts, unpack the parent with ``git archive`` into
``build/parent`` and run, in one run on one card (add ``--train`` to each):
``--root build/parent --out P1``, ``--out C1 --against P1``, ``--out C2
--against P1``, ``--root build/parent --out P2 --against C1``.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEEP_EVERY = 997  # rows of the serving bf16 outputs kept for --against
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


def _form(a) -> str:
    if len(a) == 7:
        return "message"
    return "update_w2" if len(a[1]) == 7 else "update"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--train", action="store_true",
                        help="a train step's calls with parameter gradients")
    parser.add_argument("--root", default=HERE, help="checkout whose port is timed")
    parser.add_argument("--repeats", type=int, default=20)
    parser.add_argument("--passes", type=int, default=10,
                        help="whole passes (or train steps) timed")
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
    from chgnet_tpu_torch.ops import build
    from chgnet_tpu_torch.ops import gated_message as gm

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
        return dict(calls=len(group), ms=ms(lambda: [kern(*a) for a in group]),
                    bound_ms=bound["bytes"] + bound["operations"],
                    bound_by=max(bound, key=bound.get))

    def checked(name, calls, seed0, kept) -> list:
        """Each call on seeded inputs of its shapes against the plain
        version, and run twice; the serving bf16 outputs kept
        (``KEEP_EVERY``)."""
        kern, plain = cs.kernel_versions()[name]
        out = []
        for i, a in enumerate(calls):
            skip = 3 if len(a) == 7 else 1  # the tail parameters stay the call's own
            a = tuple(seeded(x, seed0 + 10 * i + j)
                      if isinstance(x, torch.Tensor) and j != skip else x
                      for j, x in enumerate(a))
            got, want = _flat(kern(*a)), _flat(plain(*a))
            bf16 = a[0].dtype == torch.bfloat16
            tol = cs.bf16_tol(name, a) if bf16 else cs.KERNELS[name]["tol"]
            err = max(cs._errors(g.float(), w.float())[1]
                      for g, w in zip(got, want) if g is not None)
            digest = _digest(got)
            out.append(dict(max_rel_err=err, tol=tol, ok=err <= tol,
                            finite=all(bool(g.float().isfinite().all())
                                       for g in got if g is not None),
                            repeat_exact=digest == _digest(_flat(kern(*a))),
                            digest=digest))
            if bf16 and not args.train:
                kept.append([g[::KEEP_EVERY].float().cpu()
                             for g in got if g is not None])
        return out

    def serving_runs():
        """(label, recorded calls, one whole pass) of each serving path."""
        batch = None
        for path in ("default", "bf16"):
            model = CHGNet(seed=0, device="cuda", **cs.PATHS[path][0])
            if batch is None:
                batch = batch_graphs(cs.bench_graphs(model.graph_converter)).to("cuda")
            with cs.Recorder() as rec:
                cs.run_pass(model, batch)
            torch.cuda.synchronize()
            yield path, rec.calls, lambda: cs.cuda_ms(lambda: cs.run_pass(model, batch), 1)
            del model, rec

    def train_runs():
        """(label, recorded calls, one whole step) of each train type."""
        data, loaders = cs.train_data()
        batch, targets = next(iter(loaders[0]))
        for dtype, kw in (("f32", {}), ("bf16", cs.BF16_KW)):
            trainer = cs.make_trainer(cs.TRAIN_DEVICE, **kw)
            trainer._build_optimizer(False)
            cs._step(trainer, batch, targets)  # the kernels built, the caches warm
            torch.cuda.synchronize()
            with cs.Recorder() as rec:
                cs._step(trainer, batch, targets)
            torch.cuda.synchronize()

            def step_ms():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cs._step(trainer, batch, targets)  # ends in the metrics' read back
                return (time.perf_counter() - t0) * 1e3

            yield dtype, rec.calls, step_ms
            del trainer, rec

    result = {"root": root, "card": cs.card_line(), "mode": "train" if args.train else "serving",
              "runs": {}}
    kept = []
    for label, recorded, whole_ms in (train_runs() if args.train else serving_runs()):
        res = {}
        with torch.no_grad():
            for name, row in ROWS.items():
                calls = recorded[name]
                if args.train:
                    calls = [a for a in calls if a[cs.PARAM_FORM[name]]]
                forms = {}
                for a in calls:
                    forms.setdefault(_form(a), []).append(a)
                res[name] = dict(
                    row=f"{row}p" if args.train else row, all=timed(name, calls),
                    forms={f: timed(name, g) for f, g in forms.items()},
                    per_call=[dict(form=_form(a), rows=a[0].shape[0],
                                   d=a[0].shape[1] // 2, **timed(name, [a]))
                              for a in calls],
                    plain=checked(name, calls, 1000 * row, kept))
        samples = sorted(whole_ms() for _ in range(args.passes))
        res["whole_ms"] = float(np.median(samples))
        res["whole_ms_min_max"] = [samples[0], samples[-1]]
        if args.train:
            res["steps_per_s"] = 1e3 / res["whole_ms"]
        result["runs"][label] = res
        torch.cuda.empty_cache()

    if args.train:
        result["ptxas"] = [dict(kernel=k, registers=r, spilled=sp, static_smem=sm)
                           for k, r, sp, sm in cs.ptxas_rows(
                               f"{build.lib_path('gated_message')}.log")
                           if "tail_bwd_param" in k or "tail_bwd_kernel<" in k]
        result["occupancy"] = {k: list(v) for k, v in gm.tc_occupancy().items()
                               if "param" in k}
    ok = all(e["ok"] and e["finite"] and e["repeat_exact"]
             for r in result["runs"].values() for name in ROWS for e in r[name]["plain"])
    if args.against:
        with open(args.against) as fh:
            other = json.load(fh)
        ratio = {}
        for label, r in result["runs"].items():
            theirs = other["runs"][label]
            for name, row in ROWS.items():
                ratio[f"{label} {r[name]['row']}"] = r[name]["all"]["ms"] / theirs[name]["all"]["ms"]
            ratio[f"{label} whole"] = r["whole_ms"] / theirs["whole_ms"]
        result["against"] = dict(file=args.against, ratio=ratio)
        if not args.train:
            digests = lambda res: [e["digest"] for n in ROWS  # noqa: E731
                                   for e in res["runs"]["default"][n]["plain"]]
            theirs = torch.load(f"{args.against}.pt")
            result["against"]["f32_exact"] = digests(result) == digests(other)
            result["against"]["bf16_rel_diff"] = [
                max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                    for a, b in zip(mine, their))
                for mine, their in zip(kept, theirs)]
            ok &= result["against"]["f32_exact"]
    result["ok"] = ok
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh)
        if not args.train:
            torch.save(kept, f"{args.out}.pt")
    print(result["card"])
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
