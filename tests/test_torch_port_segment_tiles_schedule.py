"""The schedule of the tile segment sum, modelled in Python.

``segment_sum_tiles_kernel`` (``chgnet_tpu_torch/csrc/segment_sum.cu``)
sums the sorted rows of a CSR plan input-stationary. Its
``tiles_blocks(n_rows, n_out)`` blocks (``ops/segment.py``, the host's
choice, called here) split the merge path of the valid rows and the segment
ends into equal parts: block b takes path items [b P, b P + P), the rows
r0 .. r1 - 1 and the ends of segments n_first .. n_last - 1, where a point
of the path is (n, k), n the first segment with offsets[n + 1] + n >= the
item's index. A block stages its rows chunk by chunk and the offsets slice
by slice, and lane groups sum segments by their index (a warp's ``split``
lane groups taking every split-th row of a long segment, folded by a
shuffle tree). A segment that ends in the block and began in it is written
once by its group (empty ones too); n_first, when it began earlier, goes to
carry slot 0 (``head[b]``), n_last, when it has rows here, to slot 1;
``segment_sum_fixup_kernel`` adds each spanning segment's carries in block
order. This model of that walk, chunks and slices included, is held against
float64 prefix sums (``segment_sum_plain``) on streams with empty and long
segments, and bit for bit against a sum in the order the plan alone fixes
(the path's block boundaries and the split, not chunks, slices or groups).
It also checks that every output row is written exactly once, that every
valid row is read once and no row past offsets[n_out] at all, that a block
writes at most two carries, and that no block walks many more segments than
the path gives it (a run of empty segments is shared out). Runs on the CPU;
no card, no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chgnet_tpu_torch.ops import segment

THREADS = 256  # kTileThreads
STAGE_BYTES = 16384  # kStageBytes
SLICE = 1024  # kSlice
LONG_SEGMENT = 16  # kLongSegment
TOL = 1e-5  # chip_smoke.py's for segment_sum_tiles, relative to the largest output


def launch_shape(n_rows: int, n_out: int, units: int) -> tuple[int, int]:
    """(lanes per row, split) as ``launch_tiles`` picks them: a warp's lane
    groups share a segment when segments hold LONG_SEGMENT rows or more on
    average."""
    lpr = 1
    while lpr < units:
        lpr *= 2
    split = 32 // lpr if n_rows >= LONG_SEGMENT * n_out else 1
    return lpr, split


def _run(acc: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """acc + rows[0] + rows[1] + ... in f32, one add after another."""
    return np.cumsum(np.concatenate([acc[None], rows]), axis=0, dtype=np.float32)[-1]


def _fold(acc: np.ndarray) -> np.ndarray:
    """The shuffle tree over the split lane groups: group q adds group
    q + off's sum, off = split / 2 .. 1; group 0 holds the total."""
    acc = acc.copy()
    off = acc.shape[0] // 2
    while off >= 1:
        acc[:off] = acc[:off] + acc[off: 2 * off]
        off //= 2
    return acc[0]


def path_point(offsets: np.ndarray, v: int) -> tuple[int, int]:
    """(n, k) at item v of the merge path: n the first segment with
    offsets[n + 1] + n >= v (n_out when none), k = v - n."""
    keys = offsets[1:] + np.arange(offsets.shape[0] - 1)
    n = int(np.searchsorted(keys, v, "left"))
    return n, v - n


def block_parts(offsets: np.ndarray, blocks: int):
    """Each block's (start, end) points of the path: equal parts of its
    n_valid + n_out items."""
    items = int(offsets[-1]) + offsets.shape[0] - 1
    per = -(-items // blocks)
    for b in range(blocks):
        yield b, path_point(offsets, min(b * per, items)), path_point(
            offsets, min(b * per + per, items))


def tiles_model(xs, offsets, n_rows, units, chunk_rows, slice_=SLICE):
    """(out, writes per output row, reads per sorted row, carries per
    block, segments walked per block) of the kernels' schedule on the sorted
    rows ``xs``."""
    n_out, d = offsets.shape[0] - 1, xs.shape[1]
    blocks = segment.tiles_blocks(n_rows, n_out)
    lpr, split = launch_shape(n_rows, n_out, units)
    groups = THREADS // (split * lpr)
    out = np.full((n_out, d), np.nan, np.float32)
    writes = np.zeros(n_out, int)
    reads = np.zeros(xs.shape[0], int)
    carry, head = {}, [-1] * blocks
    n_carries, walked = np.zeros(blocks, int), np.zeros(blocks, int)
    for b, (n_first, r0), (n_last, r1) in block_parts(offsets, blocks):
        n_end = n_last + int(offsets[n_last] < r1)  # n_last runs on from here
        head[b] = n_first if offsets[n_first] < r0 else -1
        walked[b] = n_end - n_first
        n_chunks = max(-(-(r1 - r0) // chunk_rows), 1)
        n_cur = s0 = n_first

        def stage(s0):
            return offsets[np.minimum(s0 + np.arange(slice_ + 1), n_out)]

        soff = stage(s0)
        open_ = [-1] * groups
        acc = [np.zeros((split, d), np.float32) for _ in range(groups)]
        for j in range(n_chunks):
            c0 = r0 + j * chunk_rows
            c1 = min(c0 + chunk_rows, r1)
            limit = np.iinfo(np.int64).max if j == n_chunks - 1 else c1
            while True:
                n_seg = min(slice_, n_end - s0)
                i_lim = int(np.searchsorted(soff[:n_seg], limit, "left"))
                for i in range(n_cur - s0, i_lim):
                    n, g = s0 + i, (s0 + i) % groups
                    beg, end = int(soff[i]), int(soff[i + 1])
                    if open_[g] != n:
                        acc[g] = np.zeros((split, d), np.float32)
                    for q in range(split):
                        k0 = max(beg, c0)
                        ks = np.arange(k0 + ((q - k0) & (split - 1)), min(end, c1), split)
                        acc[g][q] = _run(acc[g][q], xs[ks])
                        reads[ks] += 1
                    if min(end, r1) > c1:
                        open_[g] = n
                        continue
                    open_[g] = -1
                    total = _fold(acc[g])
                    if beg < r0:
                        carry[b, 0] = total
                        n_carries[b] += 1
                    elif n == n_last:
                        carry[b, 1] = total
                        n_carries[b] += 1
                    else:
                        out[n] = total
                        writes[n] += 1
                if i_lim == n_seg and s0 + n_seg < n_end and soff[n_seg] < limit:
                    s0 += n_seg
                    n_cur = s0
                    soff = stage(s0)
                    continue
                break
            n_cur = s0 + i_lim - 1 if i_lim > 0 and soff[i_lim] > c1 else s0 + i_lim
    # the fix-up: a lane group per block b >= 1 whose first segment began
    # in block b - 1
    for b in range(1, blocks):
        n = head[b]
        if n < 0 or head[b - 1] == n:
            continue
        total, c = carry[b - 1, 1], b
        while c < blocks and head[c] == n:
            total, c = total + carry[c, 0], c + 1
        out[n] = total
        writes[n] += 1
    return out, writes, reads, n_carries, walked


def planned_sum(xs, offsets, n_rows, units):
    """Each segment in the order the plan fixes, with no chunks, slices or
    lane groups: its rows cut where a block's rows begin, each part the
    split lane groups' runs folded by the tree, the parts added in block
    order."""
    n_out, d = offsets.shape[0] - 1, xs.shape[1]
    _, split = launch_shape(n_rows, n_out, units)
    cuts = [r0 for _, (_, r0), _ in block_parts(offsets, segment.tiles_blocks(n_rows, n_out))]
    out = np.zeros((n_out, d), np.float32)
    for n in range(n_out):
        beg, end = int(offsets[n]), int(offsets[n + 1])
        bounds = [beg, *sorted({c for c in cuts if beg < c < end}), end]
        total = None
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            part = np.zeros((split, d), np.float32)
            for q in range(split):
                part[q] = _run(part[q], xs[lo + ((q - lo) & (split - 1)): hi: split])
            part = _fold(part)
            total = part if total is None else total + part
        if total is not None:
            out[n] = total
    return out


def _offsets(counts) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def _layout(name: str, rng):
    """(segment lengths, rows of capacity past the last segment)."""
    if name == "short and empty segments":  # the angle stream: ~1 row, half empty
        return rng.integers(1, 4, 3_000) * (rng.random(3_000) < 0.5), 411
    if name == "long segments":  # the edge stream: ~84 rows a segment
        return rng.integers(60, 110, 120), 700
    if name == "one segment spanning many blocks":
        return np.array([3, 20_000, 5]), 0
    if name == "long run of empty segments":  # longer than a staged slice
        return np.r_[300, np.zeros(100_000, int), 300], 0
    if name == "parts on segment ends":  # 8 parts of 256 items: 8 segments each
        return np.full(64, 31), 0
    if name == "parts one item short of segment ends":  # each part opens with an end
        return np.r_[0, np.full(63, 31), 30], 0
    if name == "no valid row":
        return np.zeros(40, int), 300
    return np.array([5_003]), 9  # n_out = 1


LAYOUTS = ["short and empty segments", "long segments",
           "one segment spanning many blocks", "long run of empty segments",
           "parts on segment ends", "parts one item short of segment ends",
           "no valid row", "one output row"]


@pytest.mark.parametrize("units", [1, 16])
@pytest.mark.parametrize("name", LAYOUTS)
def test_tiles_schedule_matches_prefix_sums_and_the_planned_order(name, units):
    rng = np.random.default_rng(LAYOUTS.index(name))
    counts, n_dropped = _layout(name, rng)
    offsets = _offsets(counts)
    n_valid = int(offsets[-1])
    n_rows = n_valid + n_dropped
    d = 4 * units if units > 1 else 3  # 16 float4 units, or 3 single values
    x = rng.standard_normal((n_rows, d)).astype(np.float32)
    perm = rng.permutation(n_rows)
    x[perm[n_valid:]] = np.nan  # rows perm leaves past the end: never read
    xs = x[perm]
    chunk_rows = STAGE_BYTES // (4 * d)
    out, writes, reads, n_carries, walked = tiles_model(
        xs, offsets, n_rows, units, chunk_rows)
    assert (writes == 1).all(), name  # every output row written once
    assert (reads[:n_valid] == 1).all() and not reads[n_valid:].any()
    assert (n_carries <= 2).all()
    items = n_valid + len(counts)  # a block walks at most its part's ends + 1
    per = -(-items // segment.tiles_blocks(n_rows, len(counts)))
    assert walked.max() <= per + 1, (walked.max(), per)
    np.testing.assert_array_equal(out[counts == 0], 0.0)
    want = segment.segment_sum_plain(
        torch.from_numpy(x), torch.from_numpy(offsets), torch.from_numpy(perm)
    ).numpy()
    err = float(np.abs(out - want).max()) if out.size else 0.0
    assert err <= TOL * max(float(np.abs(want).max()), 1e-30), (name, err)
    # the adds follow the plan alone: small chunks and slices (so the ring,
    # restaged slices and open segments are walked) give the same bits
    np.testing.assert_array_equal(out, planned_sum(xs, offsets, n_rows, units))
    small = tiles_model(xs, offsets, n_rows, units, chunk_rows=7, slice_=5)[0]
    np.testing.assert_array_equal(small, out)


@pytest.mark.parametrize("name,shift", [("parts on segment ends", 0),
                                        ("parts one item short of segment ends", -1)])
def test_part_bounds_fall_where_the_layouts_say(name, shift):
    counts, _ = _layout(name, None)
    offsets = _offsets(counts)
    blocks = segment.tiles_blocks(int(offsets[-1]), counts.size)
    assert blocks == 8
    for b, (n0, r0), _ in block_parts(offsets, blocks):
        if b:  # the part starts at a segment's first row, or one item before,
            # at the end of the segment whose rows all lie before it
            assert r0 == offsets[n0 - shift], (b, n0, r0)


def test_blocks_follow_the_capacity():
    assert segment.tiles_blocks(0, 0) == 1
    assert segment.tiles_blocks(7_680, 32) == 31  # atoms into the crystals
    assert segment.tiles_blocks(647_168, 7_680) == segment.TILES_MAX_BLOCKS  # edges
    assert segment.tiles_blocks(2, 100_000) == 391  # a run of empty segments
    assert segment.TILES_MAX_BLOCKS == 4 * 132


def test_trailing_empty_segments_are_shared_out():
    """bench.py's angle stream into bonds ends in the padded bonds' tens of
    thousands of empty segments: split by rows alone, one block walked them
    all; on the path every block walks at most its share."""
    counts = np.r_[np.ones(5_000, int), np.zeros(60_000, int)]
    offsets = _offsets(counts)
    blocks = segment.tiles_blocks(5_000, counts.size)
    per = -(-(5_000 + counts.size) // blocks)
    walked = [n1 + int(offsets[n1] < r1) - n0
              for _, (n0, _), (n1, r1) in block_parts(offsets, blocks)]
    assert max(walked) <= per + 1 and sum(walked) >= counts.size


def test_long_segments_take_a_warp_and_short_ones_a_lane_group():
    # bench.py's capacities (PERF.md §5): edges into atoms (84 rows a
    # segment), angles into bonds (1.25), atoms into crystals (240)
    assert launch_shape(647_168, 7_680, units=8) == (8, 4)
    assert launch_shape(647_168, 7_680, units=1) == (1, 32)
    assert launch_shape(808_960, 647_168, units=8) == (8, 1)
    assert launch_shape(7_680, 32, units=1) == (1, 32)
