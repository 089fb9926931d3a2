"""Count fresh processes whose first multi-threaded ``torch.sin`` on the CPU
is wrong.

Each process builds the tensor that
``tests/test_torch_port_undirected.py::test_gather_sum_value_and_gradient_match_jax_kernel``
feeds its loss (a [2048, 64] sum of gathered rows, made with plain torch
indexing on leaves that require grad, as the test's are: neither the port
nor JAX is imported), takes ``torch.sin`` of it
once and compares it with numpy's float64 ``sin``. A process counts as
wrong when some element is off by more than 1e-5. Each setting runs in its
own fresh processes, because the fault shows only on a process's first
calls:

* ``default``: torch's intra-op threads as it starts them;
* ``one thread``: ``torch.set_num_threads(1)``, as the test module pins;
* ``MKL_ENABLE_INSTRUCTIONS=AVX2`` and ``MKL_CBWR=COMPATIBLE``: MKL kept
  off its AVX-512 code paths.

Run: ``python scripts/torch_cpu_sin_first_call.py [--procs 30]``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CHILD = """
import os, numpy as np, torch
if os.environ.get("ONE_THREAD"):
    torch.set_num_threads(1)
rng = np.random.default_rng(7)
d, L = 64, 2048
sizes = (2048, 1024, 2048)
t1, t2 = (rng.standard_normal((s, d)).astype(np.float32) for s in sizes[:2])
stream = rng.standard_normal((L, d)).astype(np.float32)
idxs = [torch.tensor(rng.integers(0, s, L)) for s in sizes]
out64 = t1[idxs[0]].astype(np.float64) + t2[idxs[1]] + stream + t1[idxs[2]]
cot = np.cos(out64) * out64 + np.sin(out64)
fails = {}
for it in range(1):
    leaves = [torch.tensor(x, requires_grad=True) for x in (t1, t2, stream)]
    out = leaves[0][idxs[0]] + leaves[1][idxs[1]] + leaves[2] + leaves[0][idxs[2]]
    od = out.detach().requires_grad_()
    eo = np.abs(od.detach().numpy() - out64).max()
    s_ = torch.sin(od.detach()); es = np.abs(s_.numpy() - np.sin(out64)).max()
    c_ = torch.cos(od.detach()); ec = np.abs(c_.numpy() - np.cos(out64)).max()
    man = c_ * od.detach() + s_; em = np.abs(man.numpy() - cot).max()
    print("gather err", eo, "sin err", es, "cos err", ec, "manual cot err", em)
    g = torch.autograd.grad((torch.sin(od) * od).sum(), od)[0]
"""

SETTINGS = {
    "default": {},
    "one thread": {"ONE_THREAD": "1"},
    "MKL_ENABLE_INSTRUCTIONS=AVX2": {"MKL_ENABLE_INSTRUCTIONS": "AVX2"},
    "MKL_CBWR=COMPATIBLE": {"MKL_CBWR": "COMPATIBLE"},
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--procs", type=int, default=30)
    args = parser.parse_args()
    import torch

    print(f"torch {torch.__version__}, {torch.get_num_threads()} threads, "
          f"CPU capability {torch.backends.cpu.get_cpu_capability()}")
    for name, env in SETTINGS.items():
        errs = []
        for _ in range(args.procs):
            proc = subprocess.run(
                [sys.executable, "-c", CHILD], env={**os.environ, **env},
                check=True, capture_output=True, text=True,
            )
            errs.append(float(proc.stdout.split()[5]))  # the sin error
        wrong = [e for e in errs if e > 1e-5]
        print(f"{name}: {len(wrong)} of {args.procs} processes wrong "
              f"(largest error {max(errs):.3e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
