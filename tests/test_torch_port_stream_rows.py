"""Host arithmetic around row 3 on the CPU: the windows of ``x`` that a
range of ``segment_sum_pair``'s output rows reads
(``chip_smoke.pair_windows``, which ``tools/time_stream_rows.py`` prints),
against numpy. No card, no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from chgnet_tpu_torch.graph.batching import make_plan


def _numpy_windows(L, d, es, ka, kb, n_out, rows):
    """Per range of ``rows`` output rows, the lowest and highest row of x
    each stream reads (stream keys ka, kb; rows with a key >= n_out are
    dropped), by a loop over the rows."""
    n_ranges = -(-n_out // rows)
    lo_a = np.full(n_ranges, L)
    hi_a = np.full(n_ranges, -1)
    for row in range(L):
        if ka[row] < n_out:
            r = ka[row] // rows
            lo_a[r], hi_a[r] = min(lo_a[r], row), max(hi_a[r], row)
    lo, hi = lo_a.copy(), hi_a.copy()
    for row in range(L):
        if kb[row] < n_out:
            r = kb[row] // rows
            lo[r], hi[r] = min(lo[r], row), max(hi[r], row)
    out = {"rows": rows, "ranges": int((hi >= 0).sum())}
    for key, (l, h) in (("a", (lo_a, hi_a)), ("union", (lo, hi))):
        span = (h - l + 1)[h >= 0].astype(np.float64)
        out[key] = dict(median=int(np.sort(span)[(span.size - 1) // 2]),
                        mean=float(span.mean()), max=int(span.max()))
    out["union"]["max_bytes"] = out["union"]["max"] * d * es
    return out


@pytest.mark.parametrize("rows", [1, 8, 100, 5_000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pair_windows_against_numpy(rows, dtype):
    """A sorted stream a and a stream b that reads near it (each key moved
    by up to 3); keys past n_out dropped in both, invalid rows in b."""
    rng = np.random.default_rng(3)
    L, n_out, d = 3_000, 1_200, 16
    ka = np.sort(rng.integers(0, n_out + 20, L))
    kb = np.clip(ka + rng.integers(-3, 4, L), 0, None)
    valid_b = rng.random(L) < 0.8
    plan_a = make_plan(ka.astype(np.int32), np.ones(L, bool), n_out, assume_sorted=True)
    plan_b = make_plan(kb.astype(np.int32), valid_b, n_out)
    keys_b = np.where(valid_b, kb, n_out)
    x = torch.zeros(L, d, dtype=dtype)
    args = (x, *(torch.as_tensor(t) for t in (plan_a.offsets, plan_a.perm,
                                             plan_b.offsets, plan_b.perm)))
    got = chip_smoke.pair_windows(args, rows)
    want = _numpy_windows(L, d, x.element_size(), ka, keys_b, n_out, rows)
    assert got["rows"] == want["rows"] and got["ranges"] == want["ranges"]
    for key in ("a", "union"):
        assert got[key]["median"] == want[key]["median"]
        assert got[key]["max"] == want[key]["max"]
        assert got[key]["mean"] == pytest.approx(want[key]["mean"], rel=1e-12)
    assert got["union"]["max_bytes"] == want["union"]["max_bytes"]
