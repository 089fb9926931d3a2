"""Lean topology shipping: the primary index streams of a host
:class:`~chgnet_tpu_torch.graph.batching.GraphBatch` packed into one int32
buffer, copied to the device in one transfer, and the rest of the batch
derived there.

Port of ``chgnet_tpu.graph.leanship``. A simulation loop
(``simulation/runtime.py``) rebuilds its topology on the host whenever
drift spends the Verlet skin and copies the padded batch to the device.
Most of a batch follows from a few primary streams, because padding is a
tail after the valid rows and every other array is an elementwise, masked
or gathered function of them:

* the masks from the valid-row counts (host ints, :class:`LeanMeta`),
* the centre column from the per-atom neighbour counts and the angle
  rows' bond i from the per-edge angle counts (both streams are sorted), by
  one ``repeat_interleave`` each,
* ``edge_scatter``, ``edge_owner``, ``twin``, ``angle_scatter`` /
  ``angle_scatter_dir`` and ``bond_graph``'s columns 0, 1 and 3 by
  gathers and masks (``batch_graphs`` pads columns 2 and 4 with the last
  valid edge and derives the padded 0, 1 and 3 the same way),
* ``undirected2directed`` / ``und_second``, each bond's two directed edges,
  from the stable sort of ``directed2undirected``, which is also
  ``plan_d2u``'s permutation,
* each :class:`~chgnet_tpu_torch.graph.batching.SegmentPlan`'s keys from
  its masked stream, its permutation by a stable device sort
  (``torch.sort(stable=True)``, which orders ties as the host's radix
  argsort does) and its CSR offsets by ``torch.searchsorted`` of the sorted
  keys. The window plans of ``CHGNET_TPU_STREAM_V2`` ride in the buffer.

The port has no raw plan mode, so :func:`expand_lean` gives the batch that
``batch.to(device)`` gives, array for array and bit for bit, plans
included. At the 10,240-atom MD scale this cuts the bytes of a rebuild's
copy several times over (``chgnet_tpu``: about 188 MB to 25 MB). The counts
the expansion needs are host ints in :class:`LeanMeta`, so nothing in it
reads back from the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from chgnet_tpu_torch.graph.batching import GraphBatch, SegmentPlan

# the plans of every batch, then those of the halo-tiled layout, and the
# output rows each reduces into (``GraphBatch`` field comments)
PLANS = ("center", "nbr", "ang_vi", "ang_vj", "graph", "d2u", "u2d", "u2d2")
TILE_PLANS = ("exp", "nbr_x")


class LeanMeta(NamedTuple):
    """What the expansion needs besides the buffer, all on the host:
    ``counts`` the valid rows (edges, bonds, angles, atoms, expanded
    rows), ``sorted_plans`` which plans carry no permutation,
    ``window_rows`` each plan's widest window (None without windows), and
    ``layout`` one ``(name, int32 offset, shape, dtype)`` per packed field.
    """

    counts: tuple[int, int, int, int, int]
    sorted_plans: tuple[bool, ...]
    window_rows: tuple[int | None, ...]
    layout: tuple[tuple[str, int, tuple[int, ...], str], ...]


def _plan(batch: GraphBatch, name: str) -> SegmentPlan:
    return getattr(batch, f"plan_{name}")


def _words(arr: np.ndarray) -> int:
    if arr.nbytes % 4:
        raise ValueError(f"a field of {arr.nbytes} bytes is not whole int32 words")
    return arr.nbytes // 4


def _prefix_count(mask: np.ndarray, what: str) -> int:
    """The number of valid rows of a 0/1 mask whose valid rows come first."""
    n = int(np.count_nonzero(mask))
    if not (mask[:n] > 0).all():
        raise ValueError(f"the {what} mask is not a prefix of valid rows")
    return n


def make_lean(batch: GraphBatch, *, pin: bool = False) -> tuple[torch.Tensor, LeanMeta]:
    """Pack a host batch from ``batch_graphs`` (numpy arrays, masks as
    built) into one int32 CPU tensor, in pinned memory with ``pin`` (for a
    ``non_blocking`` copy to the card), and its :class:`LeanMeta`. Images
    travel as int8 and f32 fields bit-cast; the halo-tiled fields and the
    window plans ride along when present. Refuses the dense slots, images
    outside int8's range and masks that are not a prefix of valid rows."""
    if batch.dense_nbr.size:
        raise ValueError("lean shipping is defined for the CSR layout only")
    images = np.asarray(batch.images)
    if not (np.abs(images) <= 127).all():
        raise ValueError("periodic image offsets exceed int8 range")
    cap_n = batch.atomic_numbers.shape[0]
    cap_e = batch.atom_graph.shape[0]
    n_e = _prefix_count(batch.edge_mask, "edge")
    n_u = _prefix_count(batch.und_mask, "bond")
    n_a = _prefix_count(batch.angle_mask, "angle")
    n_n = _prefix_count(batch.atom_mask, "atom")
    if n_e != 2 * n_u:
        raise ValueError(f"{n_e} valid edges for {n_u} bonds")
    plans = PLANS + (TILE_PLANS if batch.tiled else ())
    n_x = int(np.count_nonzero(batch.plan_exp.key < cap_n)) if batch.tiled else 0
    # sorted columns travel as run counts: edges are centre-sorted, angle
    # rows sorted by their directed bond i
    fields: list[tuple[str, np.ndarray]] = [
        ("atomic_numbers", batch.atomic_numbers),
        ("frac_coords", batch.frac_coords),
        ("lattices", batch.lattices),
        ("atom_owner", batch.atom_owner),
        ("deg_counts", np.bincount(
            batch.edge_scatter, minlength=cap_n + 1)[:cap_n].astype(np.int32)),
        ("nbr", np.ascontiguousarray(batch.atom_graph[:, 1])),
        # int8 images in rows of 4, so that any edge count packs into words
        ("images_i8", np.concatenate(
            [images.astype(np.int8), np.zeros((cap_e, 1), np.int8)], axis=1)),
        ("d2u", batch.directed2undirected),
        ("ang_counts", np.bincount(
            batch.bond_graph[:n_a, 2], minlength=cap_e)[:cap_e].astype(np.int32)),
        ("col4", np.ascontiguousarray(batch.bond_graph[:, 4])),
    ]
    if batch.tiled:
        fields += [("exp_map", batch.exp_map), ("nbr_x", batch.nbr_x)]
    fields += [(f"{name}.window", _plan(batch, name).window) for name in plans
               if _plan(batch, name).window.shape[0]]

    layout, off = [], 0
    for name, arr in fields:
        layout.append((name, off, tuple(arr.shape), str(arr.dtype)))
        off += _words(arr)
    blob = torch.empty(max(off, 1), dtype=torch.int32, pin_memory=pin)
    words = blob.numpy()
    for (_, arr), (_, start, _, _) in zip(fields, layout):
        words[start: start + _words(arr)] = (
            np.ascontiguousarray(arr).view(np.int32).reshape(-1))
    meta = LeanMeta(
        counts=(n_e, n_u, n_a, n_n, n_x),
        sorted_plans=tuple(_plan(batch, n).perm.shape[0] == 0 for n in plans),
        window_rows=tuple(_plan(batch, n).window_rows for n in plans),
        layout=tuple(layout),
    )
    return blob, meta


_TORCH_DTYPES = {"int32": torch.int32, "float32": torch.float32, "int8": torch.int8}


def _unpack(blob: torch.Tensor, meta: LeanMeta) -> dict:
    out = {}
    for name, off, shape, dtype in meta.layout:
        size = int(np.prod(shape, dtype=np.int64))
        words = size * np.dtype(dtype).itemsize // 4
        out[name] = blob[off: off + words].view(_TORCH_DTYPES[dtype]).reshape(shape)
    return out


def expand_lean(blob: torch.Tensor, meta: LeanMeta) -> GraphBatch:
    """The full padded batch, as tensors on ``blob``'s device, from the
    packed buffer: equal to ``batch.to(device)`` of the batch it was packed
    from, bit for bit and plans included. Device work only, no read-back."""
    lean = _unpack(blob, meta)
    dev = blob.device
    n_e, n_u, n_a, n_n, n_x = meta.counts
    d2u, nbr, col4 = lean["d2u"], lean["nbr"], lean["col4"]
    atom_owner = lean["atom_owner"]
    cap_n = lean["atomic_numbers"].shape[0]
    cap_e = nbr.shape[0]
    cap_u = cap_e // 2
    cap_a = col4.shape[0]
    n_graphs = lean["lattices"].shape[0]
    last_atom, last_edge = max(n_n - 1, 0), max(n_e - 1, 0)

    def arange(n):
        return torch.arange(n, dtype=torch.int32, device=dev)

    def padded(valid, cap, fill):
        return torch.cat([valid, valid.new_full((cap - valid.shape[0],), fill)])

    def masked(valid, x, fill):
        return torch.where(valid, x, x.new_full((), fill))

    e_valid = arange(cap_e) < n_e
    u_valid = arange(cap_u) < n_u
    a_valid = arange(cap_a) < n_a
    n_valid = arange(cap_n) < n_n
    eidx = arange(cap_e)
    center = padded(torch.repeat_interleave(
        arange(cap_n), lean["deg_counts"], output_size=n_e), cap_e, last_atom)
    edge_scatter = masked(e_valid, center, cap_n)
    edge_owner = masked(e_valid, atom_owner[center.long()], 0)
    # each bond's two directed edges are consecutive in the stable sort of
    # d2u (the first, smaller, edge before the second)
    key_d2u = masked(e_valid, d2u, cap_u)
    perm_d2u = torch.sort(key_d2u, stable=True).indices.int()
    pairs = perm_d2u[:n_e].reshape(-1, 2)
    u2d = padded(pairs[:, 0], cap_u, last_edge)
    und_second = padded(pairs[:, 1], cap_u, last_edge)
    d2u_l = d2u.long()
    # the other directed edge of e's bond; padding maps to itself
    twin = torch.where(e_valid, u2d[d2u_l] + und_second[d2u_l] - eidx, eidx)
    col2 = padded(torch.repeat_interleave(
        eidx, lean["ang_counts"], output_size=n_a), cap_a, last_edge)
    col2_l = col2.long()
    col0 = center[col2_l]
    col1 = d2u[col2_l]
    col3 = d2u[col4.long()]
    angle_scatter_dir = masked(a_valid, col2, cap_e)

    keys = {
        "center": (edge_scatter, cap_n),
        "nbr": (masked(e_valid, nbr, cap_n), cap_n),
        "ang_vi": (angle_scatter_dir, cap_e),
        "ang_vj": (masked(a_valid, col4, cap_e), cap_e),
        "graph": (masked(n_valid, atom_owner, n_graphs), n_graphs),
        "d2u": (key_d2u, cap_u),
        "u2d": (masked(u_valid, u2d, cap_e), cap_e),
        "u2d2": (masked(u_valid, und_second, cap_e), cap_e),
    }
    tiled = "exp_map" in lean
    if tiled:
        n_x_cap = lean["exp_map"].shape[0]
        keys["exp"] = (masked(arange(n_x_cap) < n_x, lean["exp_map"], cap_n), cap_n)
        keys["nbr_x"] = (masked(e_valid, lean["nbr_x"], n_x_cap), n_x_cap)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    plans = {}
    for name, is_sorted, rows in zip(keys, meta.sorted_plans, meta.window_rows):
        key, n_out = keys[name]
        if is_sorted:
            perm, sorted_key = empty, key
        else:
            perm = perm_d2u if name == "d2u" else torch.sort(key, stable=True).indices.int()
            sorted_key = key[perm.long()]
        offsets = torch.searchsorted(sorted_key, arange(n_out + 1), out_int32=True)
        plans[f"plan_{name}"] = SegmentPlan(
            key, perm, offsets, lean.get(f"{name}.window", empty), rows
        )
    # the empty fields, as batch.to(device) gives them
    no_plan = SegmentPlan(empty, empty, empty, empty)
    if tiled:
        tiled_kw = {"exp_map": lean["exp_map"], "nbr_x": lean["nbr_x"]}
    else:
        tiled_kw = {"exp_map": empty, "nbr_x": empty, "plan_exp": no_plan,
                    "plan_nbr_x": no_plan}
    no_slots = torch.zeros((0, 0), dtype=torch.int32, device=dev)
    return GraphBatch(
        dense_nbr=no_slots,
        dense_bond=no_slots,
        dense_mask=no_slots.float(),
        plan_dense_center=no_plan,
        plan_dense_nbr=no_plan,
        plan_dense_bond=no_plan,
        atomic_numbers=lean["atomic_numbers"],
        frac_coords=lean["frac_coords"],
        lattices=lean["lattices"],
        atom_owner=atom_owner,
        atom_mask=n_valid.float(),
        atom_graph=torch.stack([center, nbr], dim=1),
        edge_scatter=edge_scatter,
        edge_owner=edge_owner,
        images=lean["images_i8"][:, :3].float(),
        directed2undirected=d2u,
        edge_mask=e_valid.float(),
        undirected2directed=u2d,
        und_second=und_second,
        und_mask=u_valid.float(),
        twin=twin,
        bond_graph=torch.stack([col0, col1, col2, col3, col4], dim=1),
        angle_scatter=masked(a_valid, col1, cap_u),
        angle_scatter_dir=angle_scatter_dir,
        angle_mask=a_valid.float(),
        **plans,
        **tiled_kw,
    )


def ship_lean(packed: tuple[torch.Tensor, LeanMeta], device: str | torch.device) -> GraphBatch:
    """One copy of :func:`make_lean`'s buffer to ``device`` (``non_blocking``,
    so a pinned buffer copies asynchronously to a CUDA device) and
    :func:`expand_lean` there: the batch ``batch.to(device)`` gives."""
    blob, meta = packed
    return expand_lean(blob.to(device, non_blocking=True), meta)


def batch_mismatches(got: GraphBatch, want: GraphBatch) -> list[str]:
    """The fields of two device batches that differ in dtype, shape or any
    bit (a plan's key, permutation, offsets, window and ``window_rows``
    each on its own): empty when the batches are equal."""
    bad = []
    for name, a, b in zip(want._fields, want, got):
        if isinstance(a, SegmentPlan):
            if a.window_rows != b.window_rows:
                bad.append(f"{name}.window_rows")
            pairs = [(f"{name}.{p}", x, y) for p, x, y in zip(a._fields[:4], a[:4], b[:4])]
        else:
            pairs = [(name, a, b)]
        bad += [n for n, x, y in pairs
                if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y)]
    return bad
