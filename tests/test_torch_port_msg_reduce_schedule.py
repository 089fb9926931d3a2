"""The schedule of the message-reduce kernel, modelled in Python.

``tail_reduce_tc_kernel`` (``chgnet_tpu_torch/csrc/gated_message.cu``)
sums the message tail's sorted rows per CSR segment without atomics or
carries: the output rows are cut into one contiguous range per warp,
balanced by cost(n) = 8 offsets[n] + n; warp c finds its range [n0, n1) by
two binary searches, walks the rows offsets[n0] .. offsets[n1] in 16-row
tiles, adds them in row order into the open segment in f32, and writes each
output row once, when its segment closes (empty segments as zeros). This
model of that schedule, with the host's choice of grid, is held against
float64 prefix sums on the layouts that test its edges; it also checks
that every output row is written exactly once and that no row past
offsets[n_out] is read. Runs on the CPU; no card, no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest

ROW_COST = 8  # kRowCost
TILE_ROWS = 16  # rows of a warp's tile
WARPS = 8  # kFwdWarps
WAVE = 132  # blocks of one wave on an H100: one block an SM
REDUCE_TOL = 1e-5  # chip_smoke.py KERNELS, relative to the largest output


def n_chunks(n_rows: int, n_out: int) -> int:
    """Warps the host launches (``gated_reduce_f32``): one per ROW_COST x
    16 rows of cost, rounded up to whole blocks, at most one wave."""
    cost = ROW_COST * n_rows + n_out
    per_block = ROW_COST * TILE_ROWS * WARPS
    return min(-(-cost // per_block), WAVE) * WARPS


def cost_lower_bound(offsets, n_out: int, x: int) -> int:
    """First n in [0, n_out] with ROW_COST * offsets[n] + n >= x."""
    lo, hi = 0, n_out
    while lo < hi:
        mid = (lo + hi) // 2
        if ROW_COST * int(offsets[mid]) + mid >= x:
            hi = mid
        else:
            lo = mid + 1
    return lo


def reduce_model(msg: np.ndarray, offsets: np.ndarray, chunks: int):
    """(out, writes per output row, rows read) of the kernel's schedule."""
    n_out, d = offsets.shape[0] - 1, msg.shape[1]
    total = ROW_COST * int(offsets[n_out]) + n_out
    chunk = -(-total // chunks)
    out = np.full((n_out, d), np.nan, np.float32)
    writes = np.zeros(n_out, int)
    read = np.zeros(msg.shape[0], bool)
    for c in range(chunks):
        n0 = cost_lower_bound(offsets, n_out, chunk * c)
        n1 = n_out if c + 1 == chunks else cost_lower_bound(offsets, n_out, chunk * (c + 1))
        if n0 >= n1:
            continue
        row_begin, row_end = int(offsets[n0]), int(offsets[n1])
        n, seg_end = n0, int(offsets[n0 + 1])
        s = np.zeros(d, np.float32)
        for row0 in range(row_begin, row_end, TILE_ROWS):
            for r in range(min(TILE_ROWS, row_end - row0)):
                while row0 + r >= seg_end:  # close segments, empty ones too
                    out[n], writes[n], s = s, writes[n] + 1, np.zeros(d, np.float32)
                    n += 1
                    seg_end = int(offsets[n + 1])
                s = s + msg[row0 + r]
                read[row0 + r] = True
        for n in range(n, n1):
            out[n], writes[n], s = s, writes[n] + 1, np.zeros(d, np.float32)
    return out, writes, read


def _offsets(counts) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def _layout(name: str, rng):
    """(segment lengths, rows past the last segment, masked fraction)."""
    if name == "empty segments":
        counts = rng.integers(0, 4, 3_000) * (rng.random(3_000) < 0.3)
        return counts, 0, 0.0
    if name == "one long segment":  # longer than any warp's share
        counts = np.r_[rng.integers(0, 3, 400), 20_000, rng.integers(0, 3, 400)]
        return counts, 0, 0.0
    if name == "dropped rows":
        return rng.integers(0, 6, 1_500), 777, 0.0
    if name == "masked rows":
        return rng.integers(1, 40, 300), 0, 0.2
    return np.array([5_000 + 3]), 9, 0.0  # n_out = 1


LAYOUTS = ["empty segments", "one long segment", "dropped rows", "masked rows",
           "one output row"]


@pytest.mark.parametrize("name", LAYOUTS)
def test_reduce_schedule_matches_float64_prefix_sums(name):
    rng = np.random.default_rng(LAYOUTS.index(name))
    counts, n_dropped, masked = _layout(name, rng)
    offsets = _offsets(counts)
    n_valid = int(offsets[-1])
    d = 64
    msg = rng.standard_normal((n_valid + n_dropped, d)).astype(np.float32)
    # the mask multiplies inside the sum: masked rows (keys in range) are
    # exactly zero messages; rows past offsets[n_out] must never be read
    msg[:n_valid][rng.random(n_valid) < masked] = 0.0
    msg[n_valid:] = np.nan
    prefix = np.concatenate([np.zeros((1, d)), np.cumsum(msg[:n_valid], 0, np.float64)])
    want = prefix[offsets[1:]] - prefix[offsets[:-1]]
    for chunks in sorted({WARPS, n_chunks(msg.shape[0], len(counts))}):
        out, writes, read = reduce_model(msg, offsets, chunks)
        assert (writes == 1).all(), name  # every output row written once
        assert not read[n_valid:].any() and read[:n_valid].all()
        assert np.isfinite(out).all()
        np.testing.assert_array_equal(out[counts == 0], 0.0)
        err = float(np.abs(out - want).max())
        assert err <= REDUCE_TOL * float(np.abs(want).max()), (name, chunks, err)
