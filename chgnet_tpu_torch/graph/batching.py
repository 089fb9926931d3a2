"""Static-shape padded graph batching with CSR segment plans.

Port of ``chgnet_tpu.graph.batching.batch_graphs`` for the default layout
(no dense slots, no halo tiles, no lean shipping). Capacities, padding and
every index and mask stream equal ``chgnet_tpu``'s for the same graphs:

* padding *gather* indices point at the last valid row (always in range;
  results are masked), and padded edges get image (1, 0, 0), so their bond
  length is one lattice vector: strictly positive, keeping norms, arccos
  and their gradients finite,
* padding *scatter* ids are one past the end (``>= n_out``) and drop out of
  every segment sum,
* stream capacities are aligned to 1024 rows (edges, angles) and large atom
  tables to 512, as in ``chgnet_tpu``, so the two packages' streams can be
  compared row for row.

The TPU block and window plans do not carry over. In their place every
stream that is gathered or reduced on the device carries a
:class:`SegmentPlan`: its row-aligned keys, the stable permutation that
sorts them (empty when the stream is sorted by construction) and the CSR
segment offsets ``[n_out + 1]`` of the sorted keys. A segment sum then
reads ``offsets[n]..offsets[n + 1]`` for output row ``n``, in a fixed
order and without atomics (``chgnet_tpu_torch/ops/segment.py``).

With ``CHGNET_TPU_STREAM_V2`` set while the batch is built
(:func:`stream_v2_enabled`), a plan also carries the source window of every
block of ``WINDOW_BLOCK`` stream rows (:func:`build_window_plan`), the
counterpart of ``chgnet_tpu``'s paired-window plan (``GatherPlan.pw``), for
the windowed gather kernel, and the widest of those windows as a host int
(``window_rows``), which ``chip_smoke.py`` and
``tools/time_gather_window.py`` report beside the kernel's times.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

from chgnet_tpu_torch.graph.crystalgraph import CrystalGraph

STREAM_CHUNK = 512  # row alignment of the padded streams (chgnet_tpu's C)
# The windowed gather (ops/segment.py gather_rows_window): stream rows per
# block, and the most source rows a block's window may span. The cap was
# set for a kernel that staged every window whole (448 rows of 128 floats
# fill a block's 227 KB of shared memory); it stays, so that the same
# streams carry windows.
WINDOW_BLOCK = 128
WINDOW_ROWS = 448
_EMPTY = np.zeros(0, np.int32)


def stream_v2_enabled() -> bool:
    """The switch of the input-stationary segment sum and the windowed
    gather, as ``chgnet_tpu.ops.stream_ops.stream_v2_enabled`` (:1196):
    ``CHGNET_TPU_STREAM_V2`` non-empty and ``CHGNET_TPU_NO_STREAM_V2`` empty.
    Read when a batch is built (the window plans) and at every call."""
    return bool(os.environ.get("CHGNET_TPU_STREAM_V2")) and not os.environ.get(
        "CHGNET_TPU_NO_STREAM_V2"
    )


class SegmentPlan(NamedTuple):
    """Gather/segment-sum plan of one index stream.

    ``key[l]`` is row ``l``'s segment id, ``>= n_out`` for padded rows
    (dropped). ``perm`` is the stable argsort of ``key``, empty when the
    stream is sorted by construction. ``offsets[n]`` is the first sorted
    row of segment ``n``; ``offsets[n_out]`` counts the valid rows.
    ``window[j]`` is the first and last key of the valid rows of block ``j``
    of ``WINDOW_BLOCK`` rows (first > last for a block without one); empty
    when absent (``chgnet_tpu``'s ``GatherPlan.pw``). ``window_rows`` is the
    widest window's ``last - first + 1`` (0 when every block is empty), None
    when the window is absent.
    The arrays are numpy arrays on the host and int32 tensors on the device;
    ``window_rows`` is a host int on both.
    """

    key: np.ndarray  # i32 [L]
    perm: np.ndarray  # i32 [L] or [0]
    offsets: np.ndarray  # i32 [n_out + 1]
    window: np.ndarray = _EMPTY  # i32 [ceil(L / WINDOW_BLOCK), 2] or [0]
    window_rows: int | None = None

    @property
    def n_out(self) -> int:
        return int(self.offsets.shape[0]) - 1

    def to(self, device: str | torch.device) -> SegmentPlan:
        """This plan's arrays as tensors on ``device``; ``window_rows``
        stays on the host."""
        return SegmentPlan(
            *(_on(a, device) for a in self[:4]), window_rows=self.window_rows
        )

    def sorted_keys(self) -> np.ndarray:
        """The keys in segment order (``chgnet_tpu``'s ``GatherPlan.dst``)."""
        return self.key[self.perm] if self.perm.shape[0] else self.key


def _on(x, device: str | torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def window_span(window: np.ndarray) -> int | None:
    """The widest window of a window plan, ``last - first + 1`` rows (0 when
    every block is empty), or None for an absent plan."""
    if window.shape[0] == 0:
        return None
    return int(max((window[:, 1] - window[:, 0]).max() + 1, 0))


def build_window_plan(key: np.ndarray, n_out: int) -> np.ndarray:
    """Per block of ``WINDOW_BLOCK`` rows of the stream, the least and the
    largest key among its valid rows (``key < n_out``), ``[n_blocks, 2]``
    int32, (0, -1) for a block without a valid row; empty (absent) when any
    block spans more than ``WINDOW_ROWS`` source rows or the stream is
    empty. Built over the valid rows only, as ``chgnet_tpu`` builds
    ``build_pw_plan(idx, valid, n_src)`` (``ops/scatter.py:117-123``): a
    padded row may lie outside its block's window and then gathers zero."""
    n_rows = key.shape[0]
    if n_rows == 0:
        return _EMPTY
    n_blocks = -(-n_rows // WINDOW_BLOCK)
    padded = np.full(n_blocks * WINDOW_BLOCK, n_out, dtype=np.int64)
    padded[:n_rows] = key
    blocks = padded.reshape(n_blocks, WINDOW_BLOCK)
    valid = blocks < n_out
    lo = np.where(valid, blocks, n_out).min(axis=1)
    hi = np.where(valid, blocks, -1).max(axis=1)
    lo = np.where(hi < 0, 0, lo)
    if (hi - lo >= WINDOW_ROWS).any():
        return _EMPTY
    return np.stack([lo, hi], axis=1).astype(np.int32)


def make_plan(
    idx: np.ndarray,
    valid: np.ndarray,
    n_out: int,
    *,
    assume_sorted: bool = False,
) -> SegmentPlan:
    """Plan for stream ``idx`` whose rows with ``valid`` False are dropped.

    ``assume_sorted`` marks streams sorted by construction (checked): they
    carry no permutation. The window plan is built only while
    :func:`stream_v2_enabled` (``chgnet_tpu.ops.scatter.make_plan``
    :114)."""
    key = np.where(valid, idx, n_out).astype(np.int32)
    if assume_sorted:
        if not bool((np.diff(key) >= 0).all()):
            raise ValueError("assume_sorted plan over an unsorted stream")
        perm = np.zeros(0, np.int32)
        sorted_key = key
    else:
        perm = np.argsort(key, kind="stable").astype(np.int32)
        sorted_key = key[perm]
    offsets = np.searchsorted(
        sorted_key, np.arange(n_out + 1, dtype=np.int32), side="left"
    ).astype(np.int32)
    window = build_window_plan(key, n_out) if stream_v2_enabled() else _EMPTY
    return SegmentPlan(key=key, perm=perm, offsets=offsets, window=window,
                       window_rows=window_span(window))


class GraphBatch(NamedTuple):
    """A batch of crystal graphs as padded flat arrays.

    Shapes: B graphs, N padded atoms, E padded directed edges, U = E // 2
    padded undirected edges, A padded angles. Host batches hold numpy
    arrays; :meth:`to` gives the same batch as tensors on a device.
    """

    atomic_numbers: np.ndarray  # i32 [N] (0 = padding)
    frac_coords: np.ndarray  # f32 [N, 3]
    lattices: np.ndarray  # f32 [B, 3, 3]
    atom_owner: np.ndarray  # i32 [N] graph index (0 for padding; masked)
    atom_mask: np.ndarray  # f32 [N]
    atom_graph: np.ndarray  # i32 [E, 2] gather indices (center, neighbor)
    edge_scatter: np.ndarray  # i32 [E] center or N (drop) for scatter
    edge_owner: np.ndarray  # i32 [E] graph index per edge
    images: np.ndarray  # f32 [E, 3] periodic image (padding: (1,0,0))
    directed2undirected: np.ndarray  # i32 [E]
    edge_mask: np.ndarray  # f32 [E]
    undirected2directed: np.ndarray  # i32 [U] first directed edge per bond
    und_second: np.ndarray  # i32 [U] the bond's second directed edge
    und_mask: np.ndarray  # f32 [U]
    twin: np.ndarray  # i32 [E] reverse-edge involution (padding -> self)
    bond_graph: np.ndarray  # i32 [A, 5] gather indices (dir_i-sorted rows)
    angle_scatter: np.ndarray  # i32 [A] undirected bond i or U (drop)
    angle_scatter_dir: np.ndarray  # i32 [A] directed bond i or E (drop)
    angle_mask: np.ndarray  # f32 [A]
    # segment plans of the streams the model gathers/reduces
    plan_center: SegmentPlan  # atom_graph[:, 0] -> atoms (sorted)
    plan_nbr: SegmentPlan  # atom_graph[:, 1] -> atoms
    plan_ang_vi: SegmentPlan  # bond_graph[:, 2] -> edges (sorted)
    plan_ang_vj: SegmentPlan  # bond_graph[:, 4] -> edges
    plan_graph: SegmentPlan  # atom_owner -> graphs (sorted; readout sums)
    # the undirected bond layout's maps between the [E] and [U] streams
    plan_d2u: SegmentPlan  # directed2undirected -> bonds
    plan_u2d: SegmentPlan  # undirected2directed -> edges (sorted)
    plan_u2d2: SegmentPlan  # und_second -> edges

    def to(self, device: str | torch.device) -> GraphBatch:
        """This batch as tensors on ``device`` (indices stay int32)."""
        return GraphBatch(*(
            f.to(device) if isinstance(f, SegmentPlan) else _on(f, device)
            for f in self
        ))


def round_up(n: int, *, base: int = 32, growth: float = 1.25) -> int:
    """Round ``n`` up onto a geometric bucket grid (multiples of ``base``)."""
    n = max(n, 1)
    bucket = base
    while bucket < n:
        bucket = int(math.ceil(bucket * growth / base) * base)
    return bucket


def batch_graphs(
    graphs: Sequence[CrystalGraph],
    *,
    bucket: bool = True,
    capacities: tuple[int, int, int] | None = None,
) -> GraphBatch:
    """Assemble CrystalGraphs into one padded host GraphBatch.

    Args:
        graphs: the graphs to batch.
        bucket: round padded capacities up to a geometric grid.
        capacities: optional explicit (n_atoms, n_directed, n_angles)
            capacities; wins over ``bucket``.
    """
    n_graphs = len(graphs)
    if n_graphs == 0:
        raise ValueError("cannot batch zero graphs")

    tot_atoms = sum(g.n_atoms for g in graphs)
    tot_edges = sum(g.n_directed for g in graphs)
    tot_angles = sum(g.n_angles for g in graphs)

    if capacities is not None:
        cap_n, cap_e, cap_a = capacities
    elif bucket:
        cap_n = round_up(tot_atoms)
        cap_e = round_up(tot_edges)
        cap_a = round_up(max(tot_angles, 1))
    else:
        cap_n, cap_e, cap_a = tot_atoms, tot_edges, max(tot_angles, 1)
    if capacities is not None or bucket:
        # E and A multiples of 2 * 512 keep U = E / 2 and A on the 512 grid
        chunk = 2 * STREAM_CHUNK
        cap_e = -(-cap_e // chunk) * chunk
        cap_a = -(-cap_a // chunk) * chunk
    if bucket and cap_n >= STREAM_CHUNK:
        cap_n = -(-cap_n // STREAM_CHUNK) * STREAM_CHUNK
    cap_e += cap_e % 2  # keep U = E / 2 exact
    cap_u = cap_e // 2
    if cap_n < tot_atoms or cap_e < tot_edges or cap_a < tot_angles:
        raise ValueError(
            f"capacities {(cap_n, cap_e, cap_a)} < actual "
            f"{(tot_atoms, tot_edges, tot_angles)}"
        )

    atomic_numbers = np.zeros(cap_n, dtype=np.int32)
    frac_coords = np.zeros((cap_n, 3), dtype=np.float32)
    atom_owner = np.zeros(cap_n, dtype=np.int32)
    atom_mask = np.zeros(cap_n, dtype=np.float32)
    lattices = np.zeros((n_graphs, 3, 3), dtype=np.float32)

    atom_graph = np.zeros((cap_e, 2), dtype=np.int32)
    edge_scatter = np.full(cap_e, cap_n, dtype=np.int32)  # default: drop
    edge_owner = np.zeros(cap_e, dtype=np.int32)
    images = np.zeros((cap_e, 3), dtype=np.float32)
    images[:, 0] = 1.0  # padded bond = one lattice vector, length > 0
    directed2undirected = np.zeros(cap_e, dtype=np.int32)
    edge_mask = np.zeros(cap_e, dtype=np.float32)

    undirected2directed = np.zeros(cap_u, dtype=np.int32)
    und_second = np.zeros(cap_u, dtype=np.int32)
    und_mask = np.zeros(cap_u, dtype=np.float32)
    twin = np.arange(cap_e, dtype=np.int32)  # padding: self (involution)

    bond_graph = np.zeros((cap_a, 5), dtype=np.int32)
    angle_scatter = np.full(cap_a, cap_u, dtype=np.int32)  # default: drop
    angle_mask = np.zeros(cap_a, dtype=np.float32)

    a_off = e_off = u_off = an_off = 0
    for gi, g in enumerate(graphs):
        n, e, u, a = g.n_atoms, g.n_directed, g.n_undirected, g.n_angles
        sl_a = slice(a_off, a_off + n)
        atomic_numbers[sl_a] = g.atomic_number
        frac_coords[sl_a] = g.atom_frac_coord
        atom_owner[sl_a] = gi
        atom_mask[sl_a] = 1.0
        lattices[gi] = g.lattice

        sl_e = slice(e_off, e_off + e)
        atom_graph[sl_e] = g.atom_graph + a_off
        edge_scatter[sl_e] = g.atom_graph[:, 0] + a_off
        edge_owner[sl_e] = gi
        images[sl_e] = g.neighbor_image
        directed2undirected[sl_e] = g.directed2undirected + u_off
        edge_mask[sl_e] = 1.0

        sl_u = slice(u_off, u_off + u)
        undirected2directed[sl_u] = g.undirected2directed + e_off
        # each bond's OTHER directed edge: stable-sort edges by their
        # undirected id; the two rows per id are (first, second)
        d2u_g = np.asarray(g.directed2undirected, dtype=np.int32)
        pairs = np.argsort(d2u_g, kind="stable").reshape(-1, 2)
        if not (d2u_g[pairs[:, 0]] == d2u_g[pairs[:, 1]]).all():
            raise ValueError(
                "graph invariant violated: an undirected bond does not "
                "have exactly two directed edges"
            )
        und_second[sl_u] = pairs[:, 1] + e_off
        und_mask[sl_u] = 1.0
        twin_local = np.empty(e, np.int32)
        twin_local[pairs[:, 0]] = pairs[:, 1]
        twin_local[pairs[:, 1]] = pairs[:, 0]
        twin[sl_e] = twin_local + e_off

        if a:
            sl_an = slice(an_off, an_off + a)
            bg = g.bond_graph.astype(np.int64)
            bond_graph[sl_an, 0] = bg[:, 0] + a_off
            bond_graph[sl_an, 1] = bg[:, 1] + u_off
            bond_graph[sl_an, 2] = bg[:, 2] + e_off
            bond_graph[sl_an, 3] = bg[:, 3] + u_off
            bond_graph[sl_an, 4] = bg[:, 4] + e_off
            angle_scatter[sl_an] = bg[:, 1] + u_off
            angle_mask[sl_an] = 1.0

        a_off += n
        e_off += e
        u_off += u
        an_off += a

    # padded GATHER indices point at the LAST valid row; both atoms of a
    # padded edge coincide, so with image (1,0,0) its bond vector is
    # exactly -lattice_row: norm finite, gradients zero
    atom_graph[e_off:] = max(a_off - 1, 0)
    directed2undirected[e_off:] = max(u_off - 1, 0)
    undirected2directed[u_off:] = max(e_off - 1, 0)
    und_second[u_off:] = max(e_off - 1, 0)
    # padded angle rows point at the LAST valid directed edge (cols 2/4);
    # cols 0/1/3 derive from it the way valid rows relate
    last_e = max(e_off - 1, 0)
    bond_graph[an_off:, 0] = atom_graph[last_e, 0]
    bond_graph[an_off:, 1] = directed2undirected[last_e]
    bond_graph[an_off:, 3] = directed2undirected[last_e]
    bond_graph[an_off:, 2] = last_e
    bond_graph[an_off:, 4] = last_e

    # directed angle-stream layout: rows sorted by their directed bond-i
    # edge (pads keyed one past the end stay at the tail), so the BondConv
    # partial sum over dir_i is a sorted segment sum
    a_key = np.where(angle_mask > 0, bond_graph[:, 2], cap_e).astype(np.int32)
    if not bool((np.diff(a_key) >= 0).all()):
        a_order = np.argsort(a_key, kind="stable")
        bond_graph = bond_graph[a_order]
        angle_scatter = angle_scatter[a_order]
        angle_mask = angle_mask[a_order]
    angle_scatter_dir = np.where(
        angle_mask > 0, bond_graph[:, 2], cap_e
    ).astype(np.int32)

    e_valid = edge_mask > 0
    a_valid = angle_mask > 0
    u_valid = und_mask > 0
    return GraphBatch(
        atomic_numbers=atomic_numbers,
        frac_coords=frac_coords,
        lattices=lattices,
        atom_owner=atom_owner,
        atom_mask=atom_mask,
        atom_graph=atom_graph,
        edge_scatter=edge_scatter,
        edge_owner=edge_owner,
        images=images,
        directed2undirected=directed2undirected,
        edge_mask=edge_mask,
        undirected2directed=undirected2directed,
        und_second=und_second,
        und_mask=und_mask,
        twin=twin,
        bond_graph=bond_graph,
        angle_scatter=angle_scatter,
        angle_scatter_dir=angle_scatter_dir,
        angle_mask=angle_mask,
        plan_center=make_plan(
            atom_graph[:, 0], e_valid, cap_n, assume_sorted=True
        ),
        plan_nbr=make_plan(atom_graph[:, 1], e_valid, cap_n),
        plan_ang_vi=make_plan(
            bond_graph[:, 2], a_valid, cap_e, assume_sorted=True
        ),
        plan_ang_vj=make_plan(bond_graph[:, 4], a_valid, cap_e),
        plan_graph=make_plan(
            atom_owner, atom_mask > 0, n_graphs, assume_sorted=True
        ),
        plan_d2u=make_plan(directed2undirected, e_valid, cap_u),
        # undirected ids are assigned by first appearance along the
        # center-sorted edges, so each bond's first edge is sorted
        plan_u2d=make_plan(
            undirected2directed, u_valid, cap_e, assume_sorted=True
        ),
        plan_u2d2=make_plan(und_second, u_valid, cap_e),
    )
