"""Graph-partitioned forward and training: one batch of crystal graphs
spread over the ranks of a mesh.

Port of ``chgnet_tpu.parallel.graph_sharded``. The host half is the same
numpy, on the port's own host ops (``utils/native/hostops.py``), and gives
the same arrays:

* atoms are block-partitioned over the ranks (rank ``d`` owns global ids
  ``[d * n_loc, (d + 1) * n_loc)``); every directed edge lives on the rank
  of its centre atom, every undirected bond on one of its two endpoints'
  ranks, chosen by a weighted waterfill that balances the angle rows per
  rank (:func:`_balance_bond_devices`), and angle rows follow their bond i
  (:func:`shard_batch`);
* the halo variant (:func:`shard_batch_halo`) also lists, per pair of
  ranks, the boundary rows one sends the other, and remaps every index
  stream into an ``[own block | halo slots]`` table.

``chgnet_tpu``'s stacked per-device ``GatherPlan``s become the port's
:class:`~chgnet_tpu_torch.graph.batching.SegmentPlan`, one per rank
(``plans[name][rank]``); :func:`local_shard` takes one rank's slice to its
device and builds there the plans the port adds: the geometry streams' and
the readout's, and the halo sends'.

The device half runs in one process per rank (``torch.distributed``), each
rank on its own shard: each conv layer exchanges the feature tables its
streams address, by all-gathers (:class:`_AllGatherComm`) or by the
boundary exchange (:class:`_HaloComm`), and computes its messages and
segment sums locally, through the port's kernels (the same layers as one
device: ``models/layers.py``). Each rank differentiates its own energy
partial; forces from other ranks' terms flow back through the collectives'
transposes (``parallel/collectives.py``), and energies and virials are
summed over ranks afterwards, as ``chgnet_tpu`` splits them. The conv
stack runs in f32 whatever ``compute_dtype`` says, as ``chgnet_tpu``'s
sharded core does (it never casts).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from chgnet_tpu_torch.graph.batching import (
    GraphBatch,
    _on,
    make_plan,
    round_up,
)
from chgnet_tpu_torch.models import basis
from chgnet_tpu_torch.models.chgnet import (
    EV_A3_TO_GPA,
    CHGNetConfig,
    _checkpointed,
    _matmul_precision,
    _remat_mode,
)
from chgnet_tpu_torch.models.functions import (
    layer_norm_apply,
    linear_apply,
    mlp_apply,
)
from chgnet_tpu_torch.models.layers import (
    UndirectedMaps,
    angle_update_apply,
    atom_conv_apply,
    bond_conv_apply,
)
from chgnet_tpu_torch.ops.segment import plan_gather, plan_segment_sum
from chgnet_tpu_torch.parallel import collectives as coll
from chgnet_tpu_torch.parallel.mesh import Mesh
from chgnet_tpu_torch.utils import hostmem
from chgnet_tpu_torch.utils.native.hostops import (
    fast_gather,
    gather_col,
    gather_col_into,
    stable_argsort_i32,
)

# chgnet_tpu's six per-device plans: (index field, mask field, rows of the
# table, sorted by construction), in the all-gather layout
PLAN_STREAMS = {
    "e_center": ("edge_center", "edge_mask", "atoms", True),
    "e_nbr": ("edge_neighbor", "edge_mask", "atoms", False),
    "e_bond": ("edge_bond", "edge_mask", "bonds", False),
    "ang_bi": ("ang_bond_i", "ang_mask", "bonds", False),
    "ang_bj": ("ang_bond_j", "ang_mask", "bonds", False),
    "ang_c": ("ang_center", "ang_mask", "atoms", False),
}
# the port's own: the geometry streams into the position table
GEOMETRY_STREAMS = {
    "u_c": ("und_center", "und_mask"),
    "u_n": ("und_neighbor", "und_mask"),
    "ang_ni": ("ang_nbr_i", "ang_mask"),
    "ang_nj": ("ang_nbr_j", "ang_mask"),
}
GRAPH_SHARDED_MSG = "graph-sharded forward supports mlp_first readout only"


class ShardedGraphBatch(NamedTuple):
    """A GraphBatch re-laid-out for D ranks (leading axis D everywhere
    except the replicated lattices). Atom ids stay GLOBAL (block layout:
    rank d owns [d * n_loc, (d+1) * n_loc)); undirected bonds get NEW
    global ids ``d * u_loc + slot`` matching the all-gather layout.
    :func:`local_shard` gives one rank's slice as tensors (leading axis
    dropped) with its plans on its device."""

    # atoms (block-partitioned, global ids preserved)
    atomic_numbers: np.ndarray  # i32 [D, N_loc]
    frac_coords: np.ndarray  # f32 [D, N_loc, 3]
    atom_owner: np.ndarray  # i32 [D, N_loc] graph id
    atom_mask: np.ndarray  # f32 [D, N_loc]
    lattices: np.ndarray  # f32 [B, 3, 3] replicated
    # directed edges (on center's rank)
    edge_center: np.ndarray  # i32 [D, E_loc] global atom id
    edge_neighbor: np.ndarray  # i32 [D, E_loc] global atom id
    edge_image: np.ndarray  # f32 [D, E_loc, 3]
    edge_owner: np.ndarray  # i32 [D, E_loc] graph id
    edge_bond: np.ndarray  # i32 [D, E_loc] new global undirected id
    edge_mask: np.ndarray  # f32 [D, E_loc]
    # undirected bonds (on one endpoint's rank, load-balanced)
    und_center: np.ndarray  # i32 [D, U_loc] global atom id
    und_neighbor: np.ndarray  # i32 [D, U_loc] global atom id
    und_image: np.ndarray  # f32 [D, U_loc, 3]
    und_owner: np.ndarray  # i32 [D, U_loc] graph id
    und_mask: np.ndarray  # f32 [D, U_loc]
    # angle rows (on bond_i's rank)
    ang_center: np.ndarray  # i32 [D, A_loc] global atom id
    ang_nbr_i: np.ndarray  # i32 [D, A_loc] global atom id (bond_i neighbor)
    ang_img_i: np.ndarray  # f32 [D, A_loc, 3]
    ang_nbr_j: np.ndarray  # i32 [D, A_loc]
    ang_img_j: np.ndarray  # f32 [D, A_loc, 3]
    ang_bond_i_local: np.ndarray  # i32 [D, A_loc] local scatter slot (or U_loc)
    ang_bond_i: np.ndarray  # i32 [D, A_loc] new global undirected id
    ang_bond_j: np.ndarray  # i32 [D, A_loc] new global undirected id
    ang_owner: np.ndarray  # i32 [D, A_loc] graph id
    ang_mask: np.ndarray  # f32 [D, A_loc]
    # name -> one SegmentPlan per rank (None where not built) for the
    # streams of PLAN_STREAMS; None: no plans (shard_batch(plans=False));
    # on a local shard, name -> this rank's plan on its device
    plans: dict | None = None

    @property
    def n_devices(self) -> int:
        return self.atomic_numbers.shape[0]

    @property
    def n_graphs(self) -> int:
        return self.lattices.shape[0]


def _device_order(dev: np.ndarray) -> np.ndarray | None:
    """Stable device-major ordering of rows; ``None`` if already sorted
    (batched edges are centre-sorted, so this is the common case)."""
    if dev.size == 0 or bool((np.diff(dev) >= 0).all()):
        return None
    if dev.dtype == np.int32:
        return stable_argsort_i32(dev)
    return np.argsort(dev, kind="stable")


class _Packer:
    """Pack device-major-sorted rows into padded [D, cap, ...] arrays;
    ``pack_gather`` gathers source rows (or one column) straight into each
    device's padded slice through the native gather."""

    def __init__(self, counts: np.ndarray, cap: int, alloc=None) -> None:
        self.counts = [int(c) for c in counts]
        self.starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        self.cap = cap
        self.d = len(self.counts)
        self.alloc = alloc or hostmem.populated_empty

    def slots(self) -> np.ndarray:
        """Per-row global slot id ``dev * cap + within-device index`` for
        rows in device-major order."""
        out = self.alloc(int(np.sum(self.counts)), np.int32)
        pos = 0
        for i, c in enumerate(self.counts):
            out[pos: pos + c] = np.arange(
                i * self.cap, i * self.cap + c, dtype=np.int32
            )
            pos += c
        return out

    def pack(self, vals: np.ndarray, fill=0, dtype=None) -> np.ndarray:
        out = self.alloc(
            (self.d, self.cap) + vals.shape[1:], dtype or vals.dtype
        )
        pos = 0
        for i, c in enumerate(self.counts):
            out[i, :c] = vals[pos: pos + c]
            if c < self.cap:
                out[i, c:] = fill
            pos += c
        return out

    def pack_gather(
        self, src: np.ndarray, idx: np.ndarray, col: int | None = None,
        fill=0,
    ) -> np.ndarray:
        """``pack(src[idx, col])`` without materializing the gather."""
        tail = src.shape[1:] if col is None else ()
        out = self.alloc((self.d, self.cap) + tail, src.dtype)
        pos = 0
        for i, c in enumerate(self.counts):
            seg = idx[pos: pos + c]
            if not gather_col_into(src, col, seg, out[i, :c]):
                out[i, :c] = src[seg] if col is None else src[seg, col]
            if c < self.cap:
                out[i, c:] = fill
            pos += c
        return out

    def pack_gather_img(self, src: np.ndarray, idx: np.ndarray) -> np.ndarray:
        """pack_gather for [*, 3] image rows; padded rows get (1, 0, 0)
        so padded bond lengths stay finite."""
        out = self.pack_gather(src, idx)
        for i, c in enumerate(self.counts):
            out[i, c:, 0] = 1.0
        return out

    def mask(self) -> np.ndarray:
        out = self.alloc((self.d, self.cap), np.float32)
        for i, c in enumerate(self.counts):
            out[i, :c] = 1.0
            out[i, c:] = 0.0
        return out


def _fill_tail_with_last(arr: np.ndarray, counts) -> np.ndarray:
    """Point each device row's padded tail at its last valid value (the
    batching convention: a padded gather index points at the last valid
    row)."""
    for i, c in enumerate(counts):
        if 0 < c < arr.shape[1]:
            arr[i, c:] = arr[i, c - 1]
    return arr


def _balance_bond_devices(
    dev_c: np.ndarray,  # [U_valid] device of first endpoint
    dev_n: np.ndarray,  # [U_valid] device of second endpoint
    weights: np.ndarray,  # [U_valid] angle rows carried by this bond
    d: int,
) -> np.ndarray:
    """Assign each bond to one of its two endpoint devices, balancing the
    total per-device weight. Same-device bonds are forced; free bonds are
    split per (dev_c, dev_n) class by a float64 cumsum waterfill against
    the running loads, four rounds (``chgnet_tpu``'s exactly)."""
    forced = dev_c == dev_n
    load = np.bincount(
        dev_c[forced], weights=weights[forced], minlength=d
    ).astype(np.float64)
    u_dev = dev_c.copy()
    free = np.nonzero(~forced)[0]
    if free.size == 0:
        return u_dev
    ckey = dev_c[free].astype(np.int64) * d + dev_n[free]
    order = np.argsort(ckey, kind="stable")
    fo = free[order]
    bounds = np.searchsorted(ckey[order], np.arange(d * d + 1))
    classes = [
        (c, fo[bounds[c]: bounds[c + 1]])
        for c in range(d * d)
        if bounds[c + 1] > bounds[c]
    ]
    cumw = {
        c: np.cumsum(weights[rows], dtype=np.float64)
        for c, rows in classes
    }
    to_i = {c: 0.0 for c, _ in classes}
    k_of = {c: 0 for c, _ in classes}
    for c, _ in classes:
        load[c % d] += float(cumw[c][-1])
    # each class re-splits against the current loads with its own
    # contribution removed; a single greedy pass mis-balances when a big
    # class comes before the inflow that should push it elsewhere
    for _ in range(4):
        for c, rows in classes:
            i, j = divmod(c, d)
            cw = cumw[c]
            total = float(cw[-1])
            load[i] -= to_i[c]
            load[j] -= total - to_i[c]
            x = min(max((load[j] - load[i] + total) / 2.0, 0.0), total)
            k = int(np.searchsorted(cw, x))
            xw = float(cw[k - 1]) if k > 0 else 0.0
            to_i[c] = xw
            k_of[c] = k
            load[i] += xw
            load[j] += total - xw
    for c, rows in classes:
        i, j = divmod(c, d)
        k = k_of[c]
        u_dev[rows[:k]] = i
        u_dev[rows[k:]] = j
    return u_dev


def _build_plans(spec: dict[str, tuple], ranks) -> dict:
    """Per-rank SegmentPlans of several streams, on a thread pool (the
    native argsorts release the interpreter lock). ``spec``: name -> (keys
    [D, cap], masks [D, cap], n_out, assume_sorted); ``ranks``: the ranks
    to build for, the others None."""
    n_ranks = next(iter(spec.values()))[0].shape[0]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        futures = {
            name: {
                i: pool.submit(
                    make_plan, keys[i], masks[i] > 0, n_out,
                    assume_sorted=assume_sorted,
                )
                for i in ranks
            }
            for name, (keys, masks, n_out, assume_sorted) in spec.items()
        }
        return {
            name: tuple(futs[i].result() if i in futs else None for i in range(n_ranks))
            for name, futs in futures.items()
        }


def _plan_spec(sb: ShardedGraphBatch, rows: dict) -> dict:
    """PLAN_STREAMS' plan spec over the batch's arrays with ``rows`` =
    {"atoms": n, "bonds": n}, the rows of the exchanged tables."""
    return {
        name: (getattr(sb, field), getattr(sb, mask), rows[table], sorted_)
        for name, (field, mask, table, sorted_) in PLAN_STREAMS.items()
    }


def shard_batch(
    batch: GraphBatch,
    n_devices: int,
    *,
    plans: bool = True,
    min_caps: tuple[int, int, int] | None = None,
    ranks=None,
) -> ShardedGraphBatch:
    """Host-side re-layout of a padded GraphBatch onto D ranks.

    ``min_caps`` = (e_loc, u_loc, a_loc) floors the per-rank edge, bond
    and angle capacities (simulation loops re-shard after every rebuild
    and keep them monotone). With ``plans`` the index streams' padded tails
    point at their last valid row and each stream of ``PLAN_STREAMS`` gets
    a plan per rank of ``ranks`` (default: every rank).
    """
    d = n_devices
    cap_n = batch.atomic_numbers.shape[0]
    n_loc = round_up(-(-cap_n // d), base=8)
    n_glob = n_loc * d

    atomic_numbers = np.zeros(n_glob, np.int32)
    atomic_numbers[:cap_n] = batch.atomic_numbers
    frac = np.zeros((n_glob, 3), np.float32)
    frac[:cap_n] = batch.frac_coords
    atom_owner = np.zeros(n_glob, np.int32)
    atom_owner[:cap_n] = batch.atom_owner
    atom_mask = np.zeros(n_glob, np.float32)
    atom_mask[:cap_n] = batch.atom_mask

    # --- directed edges -> device of center atom
    e_valid = np.nonzero(batch.edge_mask > 0)[0].astype(np.int32)
    centers = gather_col(batch.atom_graph, 0, e_valid)
    e_dev = centers // n_loc
    e_counts = np.bincount(e_dev, minlength=d)
    e_loc = round_up(int(e_counts.max()), base=8)
    if min_caps is not None:
        e_loc = max(e_loc, int(min_caps[0]))

    # --- undirected bonds -> one of their two endpoints' devices, balancing
    # the angle rows per device; angle rows follow their bond_i's device
    u_valid = np.nonzero(batch.und_mask > 0)[0].astype(np.int32)
    u_first_dir = gather_col(batch.undirected2directed, None, u_valid)
    u_center = gather_col(batch.atom_graph, 0, u_first_dir)
    u_nbr = gather_col(batch.atom_graph, 1, u_first_dir)
    a_valid = np.nonzero(batch.angle_mask > 0)[0].astype(np.int32)
    bond_i = gather_col(batch.bond_graph, 1, a_valid)
    u_dev = _balance_bond_devices(
        (u_center // n_loc).astype(np.int32),
        (u_nbr // n_loc).astype(np.int32),
        # +1: the bond-table rows themselves also spread
        np.bincount(bond_i, minlength=batch.und_mask.shape[0])[u_valid]
        + 1,
        d,
    )
    u_counts = np.bincount(u_dev, minlength=d)
    u_loc = round_up(int(u_counts.max()), base=8)
    if min_caps is not None:
        u_loc = max(u_loc, int(min_caps[1]))
    # new global id for each old undirected id: slot = running count within
    # its device, preserving original order
    u_order = _device_order(u_dev)
    u_pack = _Packer(u_counts, u_loc)
    new_uid = np.full(batch.undirected2directed.shape[0], -1, np.int32)
    u_valid_sorted = u_valid if u_order is None else gather_col(u_valid, None, u_order)
    new_uid[u_valid_sorted] = u_pack.slots()
    u_src = u_first_dir if u_order is None else gather_col(u_first_dir, None, u_order)

    # --- angle rows -> device of bond_i
    uid_unsorted = gather_col(new_uid, None, bond_i)
    a_dev = uid_unsorted // u_loc
    a_counts = np.bincount(a_dev, minlength=d)
    a_loc = round_up(int(max(a_counts.max(), 1)), base=8)
    if min_caps is not None:
        a_loc = max(a_loc, int(min_caps[2]))

    # every packed output and index stream carved from one pre-populated
    # slab (page supply is the host's cost at 100k atoms, utils/hostmem.py)
    n_ang = int(np.sum(a_counts))
    slab = hostmem.get_slab(
        d * (e_loc * 32 + u_loc * 28 + a_loc * 56)
        + (3 * n_ang + e_valid.shape[0]) * 4
        + (1 << 22)
    )
    u_pack.alloc = slab.carve

    def _carve_gather(src, col, idx):
        shape = idx.shape + (src.shape[1:] if col is None else ())
        out = slab.carve(shape, src.dtype)
        if not gather_col_into(src, col, idx, out):
            out[...] = src[idx] if col is None else src[idx, col]
        return out

    e_order = _device_order(e_dev)
    e_src = e_valid if e_order is None else gather_col(e_valid, None, e_order)
    e_pack = _Packer(e_counts, e_loc, alloc=slab.carve)
    a_order = _device_order(a_dev)
    a_src = a_valid if a_order is None else gather_col(a_valid, None, a_order)
    a_pack = _Packer(a_counts, a_loc, alloc=slab.carve)
    uid_i = uid_unsorted if a_order is None else gather_col(uid_unsorted, None, a_order)
    dir_i = _carve_gather(batch.bond_graph, 2, a_src)
    dir_j = _carve_gather(batch.bond_graph, 4, a_src)
    bond_j = _carve_gather(batch.bond_graph, 3, a_src)
    d2u_e = _carve_gather(batch.directed2undirected, None, e_src)

    ang_bond_i = a_pack.pack(uid_i)
    # local scatter slot (pad = one past the end): global // u_loc is the
    # own device by layout
    ang_bond_i_local = slab.carve(ang_bond_i.shape, np.int32)
    np.mod(ang_bond_i, u_loc, out=ang_bond_i_local)
    for i, c in enumerate(a_pack.counts):
        ang_bond_i_local[i, c:] = u_loc

    out = ShardedGraphBatch(
        atomic_numbers=atomic_numbers.reshape(d, n_loc),
        frac_coords=frac.reshape(d, n_loc, 3),
        atom_owner=atom_owner.reshape(d, n_loc),
        atom_mask=atom_mask.reshape(d, n_loc),
        lattices=np.asarray(batch.lattices, np.float32),
        edge_center=e_pack.pack_gather(batch.atom_graph, e_src, col=0),
        edge_neighbor=e_pack.pack_gather(batch.atom_graph, e_src, col=1),
        edge_image=e_pack.pack_gather_img(batch.images, e_src),
        edge_owner=e_pack.pack_gather(batch.edge_owner, e_src),
        edge_bond=e_pack.pack_gather(new_uid, d2u_e),
        edge_mask=e_pack.mask(),
        und_center=u_pack.pack_gather(batch.atom_graph, u_src, col=0),
        und_neighbor=u_pack.pack_gather(batch.atom_graph, u_src, col=1),
        und_image=u_pack.pack_gather_img(batch.images, u_src),
        und_owner=u_pack.pack_gather(batch.edge_owner, u_src),
        und_mask=u_pack.mask(),
        ang_center=a_pack.pack_gather(batch.atom_graph, dir_i, col=0),
        ang_nbr_i=a_pack.pack_gather(batch.atom_graph, dir_i, col=1),
        ang_img_i=a_pack.pack_gather_img(batch.images, dir_i),
        ang_nbr_j=a_pack.pack_gather(batch.atom_graph, dir_j, col=1),
        ang_img_j=a_pack.pack_gather_img(batch.images, dir_j),
        ang_bond_i_local=ang_bond_i_local,
        ang_bond_i=ang_bond_i,
        ang_bond_j=a_pack.pack_gather(new_uid, bond_j),
        ang_owner=a_pack.pack_gather(batch.edge_owner, dir_i),
        ang_mask=a_pack.mask(),
    )
    if plans:
        for arr, counts in (
            (out.edge_center, e_pack.counts),
            (out.edge_neighbor, e_pack.counts),
            (out.edge_bond, e_pack.counts),
            (out.ang_bond_i, a_pack.counts),
            (out.ang_bond_j, a_pack.counts),
            (out.ang_center, a_pack.counts),
        ):
            _fill_tail_with_last(arr, counts)
        rows = {"atoms": n_glob, "bonds": u_loc * d}
        out = out._replace(plans=_build_plans(
            _plan_spec(out, rows), range(d) if ranks is None else ranks
        ))
    return out


def unshard_atoms(arr) -> np.ndarray:
    """[D, N_loc, ...] -> [D * N_loc, ...] global block layout."""
    arr = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return arr.reshape(arr.shape[0] * arr.shape[1], *arr.shape[2:])


def shard_targets(targets: dict, sbatch: ShardedGraphBatch) -> dict:
    """Re-layout padded training targets onto the sharded atom blocks:
    ``e``, ``graph_mask`` and ``s`` stay replicated; per-atom ``f`` [N_pad,
    3] and ``m`` [N_pad] are NaN-padded to the D * N_loc block layout and
    reshaped to [D, N_loc, ...] (the new rows count as missing labels)."""
    d, n_loc = sbatch.atomic_numbers.shape
    out = {k: np.asarray(v) for k, v in targets.items() if k in ("e", "graph_mask", "s")}
    for key, width in (("f", (3,)), ("m", ())):
        if key in targets:
            src = np.asarray(targets[key], dtype=np.float32)
            full = np.full((d * n_loc, *width), np.nan, dtype=np.float32)
            full[: src.shape[0]] = src
            out[key] = full.reshape(d, n_loc, *width)
    return out


# ----------------------------------------------------- halo-exchange variant
class HaloBatch(NamedTuple):
    """Boundary-exchange metadata of the halo variant: every rank sends
    only the rows its peers reference, and the index arrays are remapped
    into the [own block | halo slots] layout. All leaves carry the leading
    device axis."""

    # which of MY local rows to send to each peer (padding -> row 0)
    atom_send: np.ndarray  # i32 [D, D, Ha]
    bond_send: np.ndarray  # i32 [D, D, Hb]
    # consumer index arrays remapped to local+halo positions
    edge_center_local: np.ndarray  # i32 [D, E_loc] scatter target (< n_loc)
    edge_neighbor_h: np.ndarray  # i32 [D, E_loc]
    edge_bond_h: np.ndarray  # i32 [D, E_loc]
    und_center_h: np.ndarray  # i32 [D, U_loc]
    und_neighbor_h: np.ndarray  # i32 [D, U_loc]
    ang_center_h: np.ndarray  # i32 [D, A_loc]
    ang_nbr_i_h: np.ndarray  # i32 [D, A_loc]
    ang_nbr_j_h: np.ndarray  # i32 [D, A_loc]
    ang_bond_j_h: np.ndarray  # i32 [D, A_loc]
    # per-rank plans over the [own | halo] tables (PLAN_STREAMS' names)
    plans: dict | None = None


# the halo layout's streams of PLAN_STREAMS: (HaloBatch field or, for
# "ang_bi", the sharded batch's, mask field, table)
HALO_STREAMS = {
    "e_center": ("edge_center_local", "edge_mask", "atoms", True),
    "e_nbr": ("edge_neighbor_h", "edge_mask", "atoms", False),
    "e_bond": ("edge_bond_h", "edge_mask", "bonds", False),
    "ang_bi": ("ang_bond_i_local", "ang_mask", "bonds", False),
    "ang_bj": ("ang_bond_j_h", "ang_mask", "bonds", False),
    "ang_c": ("ang_center_h", "ang_mask", "atoms", False),
}
HALO_GEOMETRY = {
    "u_c": "und_center_h", "u_n": "und_neighbor_h",
    "ang_ni": "ang_nbr_i_h", "ang_nj": "ang_nbr_j_h",
}


def shard_batch_halo(
    batch: GraphBatch,
    n_devices: int,
    *,
    plans: bool = True,
    min_caps: tuple[int, int, int] | None = None,
    min_halo: tuple[int, int] | None = None,
    ranks=None,
) -> tuple[ShardedGraphBatch, HaloBatch]:
    """:func:`shard_batch` plus the boundary-exchange index plans.

    ``min_caps`` floors the per-rank stream capacities; ``min_halo`` =
    (atom halo cap, bond halo cap) floors the per-peer halo slots, both
    kept monotone by simulation loops. With ``plans`` the streams get a
    plan per rank of ``ranks`` over the [own | halo] tables."""
    # the halo forward never reads the global-layout plans
    sb = shard_batch(batch, n_devices, plans=False, min_caps=min_caps)
    d = n_devices
    n_loc = sb.atomic_numbers.shape[1]
    u_loc = sb.und_mask.shape[1]

    def build_plan(ref_arrays, masks, block_size, h_floor):
        """Remap global-id references into [own | halo] positions and build
        per-peer send lists (block layout: owner = id // block_size).
        Returns (send [D, D, H], remapped [D, cap_k] arrays in order)."""
        needed = []
        for dev in range(d):
            refs = np.concatenate(
                [arr[dev][m[dev]] for arr, m in zip(ref_arrays, masks)]
            ) if ref_arrays else np.zeros(0, np.int64)
            remote = refs[(refs // block_size) != dev]
            needed.append(np.unique(remote))
        h_cap = max(
            [1, int(h_floor)]
            + [
                int(np.bincount(ids // block_size, minlength=d).max())
                for ids in needed
                if ids.size
            ]
        )
        h_cap = round_up(h_cap, base=8)
        send = np.zeros((d, d, h_cap), np.int32)
        # recv layout on dev: halo pos = block_size + p * h_cap + slot,
        # through one global-id -> local/halo lookup table per device
        own = np.tile(np.arange(block_size, dtype=np.int32), d)
        lookup = np.empty((d, d * block_size), np.int32)
        for dev in range(d):
            lookup[dev] = own  # own rows: gid - dev * block_size
            for p in range(d):
                if p == dev:
                    continue
                ids = needed[dev][(needed[dev] // block_size) == p]
                send[p, dev, : len(ids)] = ids - p * block_size
                lookup[dev, ids] = block_size + p * h_cap + np.arange(
                    len(ids), dtype=np.int32
                )

        remapped = []
        for arr, m in zip(ref_arrays, masks):
            out = np.empty(arr.shape, np.int32)
            for dev in range(d):
                out[dev] = np.where(
                    m[dev], fast_gather(lookup[dev], arr[dev].ravel()), 0
                )
            remapped.append(out)
        return send, remapped

    e_mask = sb.edge_mask > 0
    u_mask = sb.und_mask > 0
    a_mask = sb.ang_mask > 0
    atom_send, atom_remapped = build_plan(
        [sb.edge_neighbor, sb.und_center, sb.und_neighbor,
         sb.ang_center, sb.ang_nbr_i, sb.ang_nbr_j],
        [e_mask, u_mask, u_mask, a_mask, a_mask, a_mask],
        n_loc,
        min_halo[0] if min_halo else 0,
    )
    bond_send, bond_remapped = build_plan(
        [sb.edge_bond, sb.ang_bond_j], [e_mask, a_mask], u_loc,
        min_halo[1] if min_halo else 0,
    )

    halo = HaloBatch(
        atom_send=atom_send,
        bond_send=bond_send,
        edge_center_local=np.where(
            e_mask,
            sb.edge_center - (np.arange(d) * n_loc)[:, None],
            n_loc,
        ).astype(np.int32),
        edge_neighbor_h=atom_remapped[0],
        und_center_h=atom_remapped[1],
        und_neighbor_h=atom_remapped[2],
        ang_center_h=atom_remapped[3],
        ang_nbr_i_h=atom_remapped[4],
        ang_nbr_j_h=atom_remapped[5],
        edge_bond_h=bond_remapped[0],
        ang_bond_j_h=bond_remapped[1],
    )
    if plans:
        e_counts = e_mask.sum(axis=1)
        a_counts = a_mask.sum(axis=1)
        for arr, counts in (
            (halo.edge_neighbor_h, e_counts),
            (halo.edge_bond_h, e_counts),
            (halo.ang_center_h, a_counts),
            (halo.ang_bond_j_h, a_counts),
        ):
            _fill_tail_with_last(arr, counts)
        halo = halo._replace(plans=_build_plans(
            _halo_spec(sb, halo), range(d) if ranks is None else ranks
        ))
    return sb, halo


def _halo_rows(sb: ShardedGraphBatch, halo: HaloBatch) -> dict:
    """Rows of the [own | halo] atom and bond tables."""
    d = halo.atom_send.shape[0]
    return {
        "atoms": sb.atomic_numbers.shape[-1] + d * halo.atom_send.shape[-1],
        "bonds": sb.und_mask.shape[-1] + d * halo.bond_send.shape[-1],
    }


# ---------------------------------------------------------- one rank's shard
def _halo_spec(sb: ShardedGraphBatch, halo: HaloBatch) -> dict:
    """HALO_STREAMS' plan spec over the [own | halo] tables."""
    rows = _halo_rows(sb, halo)
    return {
        name: (sb.ang_bond_i_local if field == "ang_bond_i_local"
               else getattr(halo, field), getattr(sb, mask), rows[table], sorted_)
        for name, (field, mask, table, sorted_) in HALO_STREAMS.items()
    }


def local_shard(
    sbatch: ShardedGraphBatch, halo: HaloBatch | None, mesh: Mesh
) -> tuple[ShardedGraphBatch, HaloBatch | None]:
    """Rank ``mesh.rank``'s slice of a host sharded batch (and halo batch)
    as tensors on ``mesh.device``, with its plans: those :func:`shard_batch`
    built for the rank (built here where it did not), the geometry streams'
    into the position table, the readout's (atoms -> graphs) and, with
    ``halo``, the two send lists' (their backward sums the returned
    cotangents into the local rows)."""
    d, r, dev = mesh.size, mesh.rank, mesh.device
    if sbatch.n_devices != d:
        raise ValueError(f"a batch sharded over {sbatch.n_devices} ranks on a mesh of {d}")
    sb = ShardedGraphBatch(*(
        _on(leaf if name == "lattices" else leaf[r], dev)
        for name, leaf in zip(ShardedGraphBatch._fields[:-1], sbatch[:-1])
    ))
    n_loc, u_loc = sbatch.atomic_numbers.shape[1], sbatch.und_mask.shape[1]
    if halo is None:
        spec = _plan_spec(sbatch, {"atoms": n_loc * d, "bonds": u_loc * d})
        prebuilt, table, atom_rows = sbatch.plans, sbatch, n_loc * d
        geometry = {name: field for name, (field, _) in GEOMETRY_STREAMS.items()}
    else:
        spec = _halo_spec(sbatch, halo)
        prebuilt, table, geometry = halo.plans, halo, HALO_GEOMETRY
        atom_rows = _halo_rows(sbatch, halo)["atoms"]
        for name, send, rows in (("atom_send", halo.atom_send, n_loc),
                                 ("bond_send", halo.bond_send, u_loc)):
            keys = send.reshape(d, -1)
            spec[name] = (keys, np.ones(keys.shape, np.float32), rows, False)
    for name, field in geometry.items():
        mask = getattr(sbatch, GEOMETRY_STREAMS[name][1])
        spec[name] = (getattr(table, field), mask, atom_rows, False)
    spec["graph"] = (sbatch.atom_owner, sbatch.atom_mask, sbatch.n_graphs, True)
    have = {k: v[r] for k, v in (prebuilt or {}).items() if v[r] is not None}
    built = _build_plans({k: v for k, v in spec.items() if k not in have}, (r,))
    plans = {k: p[r].to(dev) for k, p in built.items()} | {
        k: p.to(dev) for k, p in have.items()}
    if halo is None:
        return sb._replace(plans=plans), None
    hb = HaloBatch(*(_on(leaf[r], dev) for leaf in halo[:-1]))
    return sb._replace(plans={"graph": plans.pop("graph")}), hb._replace(plans=plans)


def _as_local(sbatch, halo, mesh):
    """``(sbatch, halo)`` as one rank's shard: as they are when already
    local (tensors), else :func:`local_shard`."""
    if isinstance(sbatch.atom_mask, torch.Tensor):
        return sbatch, halo
    return local_shard(sbatch, halo, mesh)


# -------------------------------------------------------------- row exchange
class _AllGatherComm:
    """Row exchange by all-gathering the full feature tables each layer.

    The energy core (:func:`_energy_sharded_core`) is written against this
    small interface; :class:`_HaloComm` implements the same surface with
    the boundary exchange, so the conv stack exists once for both."""

    def __init__(self, sb: ShardedGraphBatch, mesh: Mesh):
        self.mesh = mesh
        self.n_loc = sb.atomic_numbers.shape[0]
        self.u_loc = sb.und_mask.shape[0]
        self.n_atom_rows = self.n_loc * mesh.size  # table length
        self.n_bond_rows = self.u_loc * mesh.size
        self.plans = sb.plans
        # index arrays into the exchanged tables (GLOBAL block ids here)
        self.edge_center = sb.edge_center
        self.edge_neighbor = sb.edge_neighbor
        self.edge_bond = sb.edge_bond
        self.und_center = sb.und_center
        self.und_neighbor = sb.und_neighbor
        self.ang_center = sb.ang_center
        self.ang_nbr_i = sb.ang_nbr_i
        self.ang_nbr_j = sb.ang_nbr_j
        self.ang_bond_i = sb.ang_bond_i
        self.ang_bond_j = sb.ang_bond_j

    def atoms(self, local: torch.Tensor) -> torch.Tensor:
        """Local [n_loc, F] -> the exchanged table the atom indices address."""
        return coll.all_gather(local, self.mesh)

    def bonds(self, local: torch.Tensor) -> torch.Tensor:
        return coll.all_gather(local, self.mesh)

    def own_atoms(self, table: torch.Tensor) -> torch.Tensor:
        """This rank's atom block of a conv output."""
        start = self.mesh.rank * self.n_loc
        return table[start: start + self.n_loc]

    def own_bonds(self, table: torch.Tensor) -> torch.Tensor:
        start = self.mesh.rank * self.u_loc
        return table[start: start + self.u_loc]


def _halo_exchange(local_rows, send_idx, send_plan, mesh: Mesh):
    """Send my referenced rows to each peer; return the halo table
    [D * H, F] in peer-major order (the remap's layout). The payload's
    backward sums the returned cotangents over ``send_plan``."""
    payload = plan_gather(local_rows, send_idx.reshape(-1), send_plan)  # [D * H, F]
    return coll.all_to_all(payload, mesh)  # block p: rows sent by peer p


class _HaloComm:
    """Row exchange of only the referenced boundary rows (all-to-all);
    index arrays arrive remapped to the [own block | halo slots] layout
    (:func:`shard_batch_halo`)."""

    def __init__(self, sb: ShardedGraphBatch, hb: HaloBatch, mesh: Mesh):
        self.mesh = mesh
        d = mesh.size
        self.n_loc = sb.atomic_numbers.shape[0]
        self.u_loc = sb.und_mask.shape[0]
        self.n_atom_rows = self.n_loc + d * hb.atom_send.shape[1]
        self.n_bond_rows = self.u_loc + d * hb.bond_send.shape[1]
        self.plans = hb.plans
        self._atom_send = hb.atom_send
        self._bond_send = hb.bond_send
        self.edge_center = hb.edge_center_local
        self.edge_neighbor = hb.edge_neighbor_h
        self.edge_bond = hb.edge_bond_h
        self.und_center = hb.und_center_h
        self.und_neighbor = hb.und_neighbor_h
        self.ang_center = hb.ang_center_h
        self.ang_nbr_i = hb.ang_nbr_i_h
        self.ang_nbr_j = hb.ang_nbr_j_h
        self.ang_bond_i = sb.ang_bond_i_local
        self.ang_bond_j = hb.ang_bond_j_h

    def atoms(self, local: torch.Tensor) -> torch.Tensor:
        return torch.cat([local, _halo_exchange(
            local, self._atom_send, self.plans["atom_send"], self.mesh)])

    def bonds(self, local: torch.Tensor) -> torch.Tensor:
        return torch.cat([local, _halo_exchange(
            local, self._bond_send, self.plans["bond_send"], self.mesh)])

    def own_atoms(self, table: torch.Tensor) -> torch.Tensor:
        return table[: self.n_loc]

    def own_bonds(self, table: torch.Tensor) -> torch.Tensor:
        return table[: self.u_loc]


def _comm(sb, hb, mesh):
    return _AllGatherComm(sb, mesh) if hb is None else _HaloComm(sb, hb, mesh)


# ---------------------------------------------------------------- the core
def _rows_of(onehot: torch.Tensor, per_graph: torch.Tensor) -> torch.Tensor:
    """Per-graph [B, 3, 3] matrices on rows by a one-hot [L, B] product
    (its backward a small dense product, not a scatter-add)."""
    return (onehot @ per_graph.reshape(per_graph.shape[0], 9)).reshape(-1, 3, 3)


def _energy_sharded_core(
    params,
    cfg: CHGNetConfig,
    sb: ShardedGraphBatch,  # one rank's shard
    comm,  # _AllGatherComm | _HaloComm
    cart: torch.Tensor,  # [N_loc, 3] undeformed local cartesians (diff var)
    strains: torch.Tensor,  # [B, 3, 3] replicated
    *,
    dynamic_cutoff: bool = False,
):
    """This rank's energy partial [B] (not summed over ranks, so that it
    can be differentiated without counting cross-rank terms D times; they
    flow back through the collectives' transposes) and a dict of local
    arrays.

    ``dynamic_cutoff`` restores exact-cutoff semantics for skin-built
    topologies: edge, bond and angle masks from the CURRENT positions at
    the model cutoffs, as ``simulation.runtime.apply_dynamic_cutoff``."""
    n_graphs = sb.lattices.shape[0]
    dtype = cart.dtype
    graph_ids = torch.arange(n_graphs, device=cart.device)

    def onehot(owner):
        return (owner[:, None] == graph_ids).to(dtype)

    eye = torch.eye(3, dtype=dtype, device=cart.device)
    deform = eye[None] + strains  # [B, 3, 3]
    lat = torch.einsum("bij,bjk->bik", sb.lattices, deform)

    # positions of every row the local streams reference (the one geometry
    # exchange per evaluation), on a 4-wide stream (xyz, 0)
    cart_loc = torch.einsum("ni,nij->nj", cart, _rows_of(onehot(sb.atom_owner), deform))
    pos = comm.atoms(torch.nn.functional.pad(cart_loc, (0, 1)))
    pl = comm.plans

    def bond_vec(center, p_center, neighbor, p_nbr, image, owner):
        return (
            plan_gather(pos, center, p_center)[:, :3]
            - plan_gather(pos, neighbor, p_nbr)[:, :3]
            - torch.einsum("ei,eij->ej", image, _rows_of(onehot(owner), lat))
        )

    # undirected bond bases (local bonds)
    und_vec = bond_vec(comm.und_center, pl["u_c"], comm.und_neighbor, pl["u_n"],
                       sb.und_image, sb.und_owner)
    und_dist = torch.linalg.norm(und_vec, dim=1)
    rbf_ag = basis.radial_bessel(
        und_dist, params["bond_basis"]["freq_ag"], cfg.atom_graph_cutoff,
        cfg.cutoff_coeff,
    )
    rbf_bg = basis.radial_bessel(
        und_dist, params["bond_basis"]["freq_bg"], cfg.bond_graph_cutoff,
        cfg.cutoff_coeff,
    )

    # angle basis from per-row bond vectors (no directed-edge exchange)
    vec_i = bond_vec(comm.ang_center, pl["ang_c"], comm.ang_nbr_i, pl["ang_ni"],
                     sb.ang_img_i, sb.ang_owner)
    vec_j = bond_vec(comm.ang_center, pl["ang_c"], comm.ang_nbr_j, pl["ang_nj"],
                     sb.ang_img_j, sb.ang_owner)
    unit_i = vec_i / torch.linalg.norm(vec_i, dim=1, keepdim=True)
    unit_j = vec_j / torch.linalg.norm(vec_j, dim=1, keepdim=True)
    cos_ij = torch.sum(unit_i * unit_j, dim=1) * (1 - 1e-6)
    angle_bases = basis.fourier(torch.arccos(cos_ij), params["angle_basis"]["freq"])

    edge_mask, und_mask, ang_mask = sb.edge_mask, sb.und_mask, sb.ang_mask
    if dynamic_cutoff:
        # edges stay valid while their UNDIRECTED bond is inside the atom
        # cutoff (the flag reaches edge rows through one bond-table
        # exchange: an edge may sit on another rank than its bond), angle
        # rows while bond i is within (<=) and directed bond j strictly
        # within (<) the bond-graph cutoff; padded rows keep mask 0
        tol = 1e-8
        with torch.no_grad():
            und_ok = (und_dist <= cfg.atom_graph_cutoff + tol).to(und_mask.dtype)
            und_ok_t = comm.bonds(und_ok[:, None])[:, 0]
            edge_mask = edge_mask * und_ok_t[comm.edge_bond.long()]
            dist_i = torch.linalg.norm(vec_i, dim=1)
            dist_j = torch.linalg.norm(vec_j, dim=1)
            ang_ok = (dist_i <= cfg.bond_graph_cutoff + tol) & (
                dist_j < cfg.bond_graph_cutoff - tol
            )
            ang_mask = ang_mask * ang_ok.to(ang_mask.dtype)
            und_mask = und_mask * und_ok

    # embeddings (local)
    z_index = (sb.atomic_numbers.long() - 1).clamp(0, cfg.max_num_elements - 1)
    atom_feas = params["atom_embedding"]["weight"][z_index]  # [N_loc, d]
    bond_feas = linear_apply(params["bond_embedding"], rbf_ag)  # [U_loc, d]
    bw_ag = linear_apply(params["bond_weights_ag"], rbf_ag)
    bw_bg = linear_apply(params["bond_weights_bg"], rbf_bg)
    angle_feas = linear_apply(params["angle_embedding"], angle_bases)

    # the weight tables change only with geometry: exchanged once, and
    # their edge and angle expansions gathered once for every layer
    bw_ag_t = comm.bonds(bw_ag)
    bw_bg_t = comm.bonds(bw_bg)
    conv_maps = UndirectedMaps(comm.edge_bond, pl["e_bond"], None, None)
    ang_plans = (pl["ang_bi"], pl["ang_bj"], pl["ang_c"])
    weights_e = plan_gather(bw_ag_t, comm.edge_bond, pl["e_bond"])
    weights_a = (
        plan_gather(bw_bg_t, comm.ang_bond_i, pl["ang_bi"])
        * plan_gather(bw_bg_t, comm.ang_bond_j, pl["ang_bj"])
    ) if cfg.update_bond else None

    act = cfg.non_linearity
    fused = cfg.fused_kernels

    def atom_step(atom_p, atom_t, bond_t):
        return comm.own_atoms(atom_conv_apply(
            atom_p, atom_t, bond_t, weights_e, comm.edge_center,
            comm.edge_neighbor, edge_mask, pl["e_center"], pl["e_nbr"],
            activation=act, fused=fused, und=conv_maps,
        ))

    def bond_step(bond_p, atom_t, bond_t, angle_feas):
        return comm.own_bonds(bond_conv_apply(
            bond_p, atom_t, bond_t, weights_a, angle_feas, comm.ang_center,
            comm.ang_bond_i, comm.ang_bond_j, ang_mask, ang_plans,
            activation=act, fused=fused,
        ))

    def angle_step(angle_p, atom_t, bond_t, angle_feas):
        return angle_update_apply(
            angle_p, atom_t, bond_t, angle_feas, comm.ang_center,
            comm.ang_bond_i, comm.ang_bond_j, ang_plans, activation=act,
            fused=fused,
        )

    # remat "all" checkpoints every layer, "angle" only the angle-stream
    # layers, as chgnet_tpu's sharded core does; their inputs are the
    # exchanged tables, so a recomputation exchanges nothing
    remat = _remat_mode(cfg.remat)
    atom_step = _checkpointed(atom_step, remat == "all")
    bond_step = _checkpointed(bond_step, bool(remat))
    angle_step = _checkpointed(angle_step, bool(remat))

    # each table is exchanged once a change: a block's new atom table feeds
    # its BondConv and AngleUpdate and the next AtomConv, its new bond table
    # its AngleUpdate and the next AtomConv (chgnet_tpu exchanges them again
    # for each of those layers)
    atom_feas_mid = atom_feas
    atom_t, bond_t = comm.atoms(atom_feas), comm.bonds(bond_feas)
    for idx in range(cfg.n_conv - 1):
        atom_feas = atom_step(params["atom_convs"][idx], atom_t, bond_t)
        atom_t = comm.atoms(atom_feas)
        if cfg.update_bond:
            bond_feas = bond_step(params["bond_convs"][idx], atom_t, bond_t, angle_feas)
            bond_t = comm.bonds(bond_feas)
        # the last block's angle update feeds nothing (the final AtomConv
        # reads atoms and bonds only): skipped, as on one device
        if cfg.update_angle and idx < cfg.n_conv - 2:
            angle_feas = angle_step(params["angle_updates"][idx], atom_t, bond_t, angle_feas)
        if idx == cfg.n_conv - 2:
            atom_feas_mid = atom_feas
    atom_feas = atom_step(params["atom_convs"][cfg.n_conv - 1], atom_t, bond_t)
    if "readout_norm" in params:
        atom_feas = layer_norm_apply(params["readout_norm"], atom_feas)

    p_graph = sb.plans["graph"]
    mask = sb.atom_mask[:, None]
    site_energies = mlp_apply(params["mlp"], atom_feas, activation=act) * mask
    aux = {
        "atoms_per_graph_local": plan_segment_sum(mask, p_graph).reshape(-1),
        "atom_feas_mid": atom_feas_mid,
        "site_energies": site_energies.reshape(-1),
        # local partial of the pooled crystal feature
        "crystal_fea_local": plan_segment_sum(atom_feas * mask, p_graph),
    }
    return plan_segment_sum(site_energies, p_graph).reshape(-1), aux


def _check_config(cfg: CHGNetConfig, mesh: Mesh) -> None:
    cfg.check_supported(mesh.device.type)
    if not cfg.mlp_first:
        raise NotImplementedError(GRAPH_SHARDED_MSG)


def _composition(params, cfg, sb, mesh):
    """The composition (AtomRef) energy per graph [B], summed over ranks."""
    z_index = (sb.atomic_numbers.long() - 1).clamp(0, cfg.max_num_elements - 1)
    site_ref = params["composition"]["weight"][z_index] * sb.atom_mask
    return coll.sum_ranks(
        plan_segment_sum(site_ref[:, None], sb.plans["graph"]).reshape(-1), mesh
    )


def _energy(params, cfg, sb, mesh, e_partial, atoms_local):
    """(energy [B] eV/atom if intensive, atoms per graph [B]) from the
    energy partials, summed over ranks (``compute_batch``'s readout)."""
    atoms = coll.sum_ranks(atoms_local, mesh)
    safe = torch.clamp(atoms, min=1.0)
    e_ext = coll.sum_ranks(e_partial, mesh)
    energy = e_ext / safe if cfg.is_intensive else e_ext
    if "composition" in params:
        comp = _composition(params, cfg, sb, mesh)
        energy = energy + (comp / safe if cfg.atom_ref_is_intensive else comp)
    return energy, atoms


def _cart0(sb: ShardedGraphBatch) -> torch.Tensor:
    """Undeformed local cartesians [N_loc, 3], the differentiation
    variable (``compute_batch``'s)."""
    return torch.einsum(
        "ni,nij->nj", sb.frac_coords, sb.lattices[sb.atom_owner.long()]
    ).detach()


def magmoms(params, atom_feas_mid, atom_mask) -> torch.Tensor:
    """``|Linear(atom_feas_mid)|`` on the local atoms [N_loc]."""
    return torch.abs(
        linear_apply(params["site_wise"], atom_feas_mid)
    ).reshape(-1) * atom_mask


def compute_batch_sharded(
    params,
    sbatch: ShardedGraphBatch,
    halo: HaloBatch | None = None,
    *,
    config: CHGNetConfig,
    mesh: Mesh,
    compute_force: bool = False,
    compute_stress: bool = False,
    compute_magmom: bool = False,
    dynamic_cutoff: bool = False,
) -> dict[str, torch.Tensor]:
    """Graph-partitioned prediction over a mesh, called by every rank.

    ``sbatch`` is a host batch from :func:`shard_batch` (or, with ``halo``
    from :func:`shard_batch_halo`, the boundary exchange instead of
    all-gathers) or one rank's :func:`local_shard`. Returns detached
    tensors on ``mesh.device``, the same on every rank: e [B] (eV/atom if
    intensive), f [D, N_loc, 3], s [B, 3, 3] GPa, m [D, N_loc] (per-atom
    outputs in the global block layout: ``unshard_atoms`` flattens them),
    atoms_per_graph [B]. ``dynamic_cutoff`` recomputes the edge and angle
    masks at the model cutoffs from the current positions (skin-built
    topologies, ``simulation.runtime``)."""
    cfg = config
    _check_config(cfg, mesh)
    sb, hb = _as_local(sbatch, halo, mesh)
    comm = _comm(sb, hb, mesh)
    n_graphs = sb.lattices.shape[0]
    want_grad = compute_force or compute_stress
    out: dict[str, torch.Tensor] = {}
    grad_mode = torch.enable_grad() if want_grad else torch.no_grad()
    with _matmul_precision(cfg.matmul_precision), grad_mode:
        cart0 = _cart0(sb)
        strains0 = torch.zeros((n_graphs, 3, 3), dtype=cart0.dtype, device=cart0.device)
        inputs = []
        if want_grad:
            inputs = [cart0.requires_grad_(True)]
            if compute_stress:
                inputs.append(strains0.requires_grad_(True))
        e_partial, aux = _energy_sharded_core(
            params, cfg, sb, comm, cart0, strains0, dynamic_cutoff=dynamic_cutoff
        )
        if want_grad:
            # each rank's own partial: cross-rank terms arrive through the
            # all-gathers' transposes, and the virial is summed below
            grads = torch.autograd.grad(e_partial.sum(), inputs)
            if compute_force:
                out["f"] = coll.gather_blocks(-grads[0], mesh).reshape(
                    mesh.size, -1, 3)
            if compute_stress:
                volumes = torch.abs(torch.linalg.det(sb.lattices))
                virial = coll.sum_ranks(grads[-1], mesh)
                out["s"] = virial * EV_A3_TO_GPA / volumes[:, None, None]
        with torch.no_grad():
            out["e"], out["atoms_per_graph"] = _energy(
                params, cfg, sb, mesh, e_partial.detach(),
                aux["atoms_per_graph_local"].detach(),
            )
            if compute_magmom:
                m = magmoms(params, aux["atom_feas_mid"], sb.atom_mask)
                out["m"] = coll.gather_blocks(m, mesh).reshape(mesh.size, -1)
    return {k: v.detach() for k, v in out.items()}


def compute_batch_sharded_halo(
    params,
    sbatch: ShardedGraphBatch,
    halo: HaloBatch,
    **kwargs,
) -> dict[str, torch.Tensor]:
    """:func:`compute_batch_sharded` with the boundary exchange (the halo
    batch selects it)."""
    return compute_batch_sharded(params, sbatch, halo, **kwargs)


# ------------------------------------------------------------- training step
def _masked_sq(err_valid, pred, target):
    """(sum of squared and of absolute errors, count) over ``err_valid``."""
    safe = torch.where(err_valid, target, torch.zeros_like(target))
    err = torch.where(err_valid, pred - safe, torch.zeros_like(pred))
    return (err**2).sum(), err.abs().sum(), err_valid.sum()


def sharded_loss(
    params,
    cfg: CHGNetConfig,
    sb: ShardedGraphBatch,
    hb: HaloBatch | None,
    tgt: dict,
    mesh: Mesh,
    *,
    targets: str = "ef",
    energy_loss_ratio: float = 1.0,
    force_loss_ratio: float = 1.0,
    stress_loss_ratio: float = 0.1,
    mag_loss_ratio: float = 0.1,
):
    """``(loss, metrics)`` of one rank's shard: the weighted NaN-masked MSE
    of ``make_graph_sharded_train_step``, the same value on every rank.
    The loss keeps its graph to the parameters (forces and stress through
    their own backward); its sums over ranks pass cotangents through, so
    each rank's backward gives its own share of the parameter gradient."""
    comm = _comm(sb, hb, mesh)
    n_graphs = sb.lattices.shape[0]
    cart0 = _cart0(sb).requires_grad_(True)
    strains0 = torch.zeros((n_graphs, 3, 3), dtype=cart0.dtype, device=cart0.device)
    inputs = [cart0]
    if "s" in targets:
        inputs.append(strains0.requires_grad_(True))
    with _matmul_precision(cfg.matmul_precision), torch.enable_grad():
        e_partial, aux = _energy_sharded_core(params, cfg, sb, comm, cart0, strains0)
        grads = torch.autograd.grad(e_partial.sum(), inputs, create_graph=True)
        forces = -grads[0]
        energy, _ = _energy(
            params, cfg, sb, mesh, e_partial, aux["atoms_per_graph_local"].detach()
        )
        graph_mask = tgt["graph_mask"]
        t_e = tgt["e"]
        e_sq, e_abs, e_n = _masked_sq((graph_mask > 0) & ~torch.isnan(t_e), energy, t_e)
        e_count = torch.clamp(e_n.float(), min=1.0)
        loss = energy_loss_ratio * e_sq / e_count
        metrics = {"e_MAE": e_abs / e_count}

        def local_term(valid, pred, target):
            sq, ab, n = _masked_sq(valid, pred, target)
            count = torch.clamp(coll.sum_ranks(n.float(), mesh), min=1.0)
            return coll.sum_ranks(sq, mesh) / count, coll.sum_ranks(ab.detach(), mesh) / count

        t_f = tgt["f"]
        f_valid = (sb.atom_mask[:, None] > 0) & ~torch.isnan(t_f)
        f_loss, metrics["f_MAE"] = local_term(f_valid, forces, t_f)
        loss = loss + force_loss_ratio * f_loss
        if "s" in targets:
            volumes = torch.abs(torch.linalg.det(sb.lattices))
            virial = coll.sum_ranks(grads[1], mesh)
            stress = virial * EV_A3_TO_GPA / volumes[:, None, None]
            t_s = tgt["s"]
            s_valid = (graph_mask[:, None, None] > 0) & ~torch.isnan(t_s)
            s_sq, s_abs, s_n = _masked_sq(s_valid, stress, t_s)
            s_count = torch.clamp(s_n.float(), min=1.0)
            loss = loss + stress_loss_ratio * s_sq / s_count
            metrics["s_MAE"] = s_abs / s_count
        if "m" in targets:
            magmom = magmoms(params, aux["atom_feas_mid"], sb.atom_mask)
            t_m = tgt["m"]
            m_valid = (sb.atom_mask > 0) & ~torch.isnan(t_m)
            m_loss, metrics["m_MAE"] = local_term(m_valid, magmom, t_m)
            loss = loss + mag_loss_ratio * m_loss
    metrics["loss"] = loss
    return loss, {k: v.detach() for k, v in metrics.items()}


def local_targets(tgt: dict, mesh: Mesh) -> dict:
    """One rank's slice of :func:`shard_targets`' arrays as tensors on its
    device (per-atom ``f`` and ``m`` its block, the rest whole)."""
    return {
        k: _on(np.asarray(v)[mesh.rank] if k in ("f", "m") else np.asarray(v),
               mesh.device)
        for k, v in tgt.items()
    }


def make_graph_sharded_train_step(
    *,
    config: CHGNetConfig,
    optimizer: torch.optim.Optimizer,
    mesh: Mesh,
    targets: str = "ef",
    energy_loss_ratio: float = 1.0,
    force_loss_ratio: float = 1.0,
    stress_loss_ratio: float = 0.1,
    mag_loss_ratio: float = 0.1,
    halo: bool = False,
):
    """Training over the graph-partitioned forward.

    ``optimizer`` updates the parameter tree's trainable leaves, the same
    on every rank. Step signature: ``step(params, sbatch, tgt) -> metrics``
    or, with ``halo=True``, ``step(params, (sbatch, halo_batch), tgt)``;
    batches host or local (:func:`local_shard`), targets from
    :func:`shard_targets` (or :func:`local_targets`). Each rank
    differentiates the replicated loss through its shard
    (:func:`sharded_loss`); the parameter gradients are then summed over
    ranks in one collective and every rank takes the same optimizer step.
    Loss = weighted MSE over ``targets`` ("ef" / "efs" / "efsm") with
    NaN-masked labels. ``chgnet_tpu`` turns ``fused_kernels`` off here
    (``graph_sharded.py:1083-1102``: the Pallas tails' second order trips
    ``shard_map``'s ``check_vma``); that check has no counterpart here and
    the port's tails differentiate to second order, so the kernels stay
    on."""
    ratios = dict(
        energy_loss_ratio=energy_loss_ratio, force_loss_ratio=force_loss_ratio,
        stress_loss_ratio=stress_loss_ratio, mag_loss_ratio=mag_loss_ratio,
    )
    leaves = [p for group in optimizer.param_groups for p in group["params"]]
    _check_config(config, mesh)

    def step(params, batch, tgt):
        sb, hb = (batch if halo else (batch, None))
        sb, hb = _as_local(sb, hb, mesh)
        if not isinstance(next(iter(tgt.values())), torch.Tensor):
            tgt = local_targets(tgt, mesh)
        loss, metrics = sharded_loss(
            params, config, sb, hb, tgt, mesh, targets=targets, **ratios
        )
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for leaf in leaves:
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        coll.all_reduce_grads(leaves, mesh, average=False)
        optimizer.step()
        return metrics

    return step
