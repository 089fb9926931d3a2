"""Datasets and loaders producing padded batches with dense targets.

Port of ``chgnet_tpu.data.dataset``: the same classes and functions, the
same draws in the same order, so one seed gives the same splits, the same
batch order and bit-equal padded batches and targets in both packages. As
there, a :class:`GraphLoader` packs each mini-batch into ONE padded
:class:`~chgnet_tpu_torch.graph.batching.GraphBatch` (numpy arrays; the
trainer moves it to the card) plus dense NaN-masked target arrays, with
bucketed capacities, instead of upstream CHGNet's ragged graph lists.

Dataset classes (upstream CHGNet's ``data/dataset.py`` inventory):

* :class:`StructureData`  — in-memory structures + e/f/s/m labels,
  on-the-fly graph conversion with caching, failed-structure resampling,
  ``from_vasp`` constructor,
* :class:`CIFData`        — CIF directory + ``labels.json``,
* :class:`GraphData`      — pre-converted ``.npz`` graphs, mp-id level
  train/val/test partitioning,
* :class:`StructureJsonData` — MPtrj-schema JSON.

Graphs and ``labels.json`` written by either package's :func:`make_graphs`
load in the other's :class:`GraphData`. Unit conventions are upstream's:
energies eV/atom, forces eV/A, stresses scaled by -0.1 on ingest (VASP kBar
-> model GPa sign), magmoms absolute.
"""

from __future__ import annotations

import functools
import os
import random
from collections.abc import Sequence

import numpy as np

from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.graph.batching import GraphBatch, batch_graphs, round_up
from chgnet_tpu_torch.graph.converter import CrystalGraphConverter
from chgnet_tpu_torch.graph.crystalgraph import CrystalGraph
from chgnet_tpu_torch.utils.common import read_json, write_json


class StructureData:
    """In-memory dataset of structures + energy/force/(stress)/(magmom)."""

    def __init__(
        self,
        structures: list[Structure | dict],
        energies: list[float],
        forces: list[Sequence],
        stresses: list[Sequence] | None = None,
        magmoms: list[Sequence] | None = None,
        structure_ids: list | None = None,
        graph_converter: CrystalGraphConverter | None = None,
        shuffle: bool = True,
    ) -> None:
        """Initialize the dataset; lengths of all label lists must match.

        Energies are eV/atom; stresses are multiplied by -0.1 on access
        (VASP sign/kBar convention -> model GPa, ``dataset.py:169-173``);
        magmoms are taken as absolute values.
        """
        for name, labels in {
            "energies": energies,
            "forces": forces,
            "stresses": stresses,
            "magmoms": magmoms,
            "structure_ids": structure_ids,
        }.items():
            if labels is not None and len(labels) != len(structures):
                raise RuntimeError(
                    f"Inconsistent number of structures and labels: "
                    f"{len(structures)=}, len({name})={len(labels)}"
                )
        self.structures = [
            Structure.from_dict(s) if isinstance(s, dict) else s
            for s in structures
        ]
        self.energies = energies
        self.forces = forces
        self.stresses = stresses
        self.magmoms = magmoms
        self.structure_ids = structure_ids
        self.keys = np.arange(len(structures))
        if shuffle:
            np.random.shuffle(self.keys)
        self.graph_converter = graph_converter or CrystalGraphConverter(
            atom_graph_cutoff=6, bond_graph_cutoff=3
        )
        self.failed_idx: list[int] = []
        self.failed_graph_id: dict[str, str] = {}

    @classmethod
    def from_vasp(
        cls,
        file_root: str,
        *,
        check_electronic_convergence: bool = True,
        save_path: str | None = None,
        graph_converter: CrystalGraphConverter | None = None,
        shuffle: bool = True,
    ) -> StructureData:
        """Parse a VASP output directory into a dataset (``dataset.py:93-137``)."""
        from chgnet_tpu_torch.utils.vasp import parse_vasp_dir

        result_dict = parse_vasp_dir(
            file_root,
            check_electronic_convergence=check_electronic_convergence,
            save_path=save_path,
        )
        return cls(
            structures=result_dict["structure"],
            energies=result_dict["energy_per_atom"],
            forces=result_dict["force"],
            stresses=result_dict["stress"] or None,
            magmoms=result_dict["magmom"] or None,
            graph_converter=graph_converter,
            shuffle=shuffle,
        )

    def __len__(self) -> int:
        return len(self.keys)

    @functools.cache  # noqa: B019 - as upstream's dataset
    def __getitem__(self, idx: int) -> tuple[CrystalGraph, dict]:
        """(graph, targets) for one structure; failed conversions are
        remembered and a random other index is served (``dataset.py:184-194``)."""
        graph_id = int(self.keys[idx])
        try:
            struct = self.structures[graph_id]
            if self.structure_ids is not None:
                mp_id = str(self.structure_ids[graph_id])
            else:
                mp_id = str(graph_id)
            graph = self.graph_converter(
                struct, graph_id=str(graph_id), mp_id=mp_id
            )
            targets = {
                "e": np.float32(self.energies[graph_id]),
                "f": np.asarray(self.forces[graph_id], dtype=np.float32),
            }
            if self.stresses is not None:
                targets["s"] = (
                    np.asarray(self.stresses[graph_id], dtype=np.float32)
                    * -0.1
                )
            if self.magmoms is not None:
                mag = self.magmoms[graph_id]
                targets["m"] = (
                    np.full(len(struct), np.nan, dtype=np.float32)
                    if mag is None
                    else np.abs(np.asarray(mag, dtype=np.float32)).reshape(-1)
                )
            return graph, targets
        except Exception:
            struct = self.structures[graph_id]
            self.failed_graph_id[str(graph_id)] = struct.formula
            self.failed_idx.append(idx)
            return self[random.randint(0, len(self) - 1)]


class CIFData:
    """Dataset from a directory of CIF files + ``labels.json``
    (``dataset.py:197-308``). The labels file maps cif name (without
    extension) to dicts with energy_per_atom / force / stress / magmom."""

    def __init__(
        self,
        cif_path: str,
        *,
        labels: str | dict = "labels.json",
        targets: str = "efsm",
        graph_converter: CrystalGraphConverter | None = None,
        energy_key: str = "energy_per_atom",
        force_key: str = "force",
        stress_key: str = "stress",
        magmom_key: str = "magmom",
        shuffle: bool = True,
    ) -> None:
        self.data_dir = cif_path
        if isinstance(labels, str):
            labels = read_json(os.path.join(cif_path, labels))
        self.labels = labels
        self.keys = list(self.labels)
        if shuffle:
            random.shuffle(self.keys)
        self.graph_converter = graph_converter or CrystalGraphConverter(
            atom_graph_cutoff=6, bond_graph_cutoff=3
        )
        self.targets = targets
        self.energy_key = energy_key
        self.force_key = force_key
        self.stress_key = stress_key
        self.magmom_key = magmom_key
        self.failed_idx: list[int] = []
        self.failed_graph_id: dict[str, str] = {}

    def __len__(self) -> int:
        return len(self.keys)

    @functools.cache  # noqa: B019
    def __getitem__(self, idx: int) -> tuple[CrystalGraph, dict]:
        graph_id = self.keys[idx]
        try:
            struct = Structure.from_file(
                os.path.join(self.data_dir, f"{graph_id}.cif")
            )
            labels = self.labels[graph_id]
            graph = self.graph_converter(
                struct, graph_id=graph_id, mp_id=graph_id
            )
            targets = {
                "e": np.float32(labels[self.energy_key]),
                "f": np.asarray(labels[self.force_key], dtype=np.float32),
            }
            if "s" in self.targets and self.stress_key in labels:
                targets["s"] = (
                    np.asarray(labels[self.stress_key], np.float32) * -0.1
                )
            if "m" in self.targets:
                mag = labels.get(self.magmom_key)
                targets["m"] = (
                    np.full(len(struct), np.nan, dtype=np.float32)
                    if mag is None
                    else np.abs(np.asarray(mag, np.float32)).reshape(-1)
                )
            return graph, targets
        except Exception:
            self.failed_graph_id[str(graph_id)] = ""
            self.failed_idx.append(idx)
            return self[random.randint(0, len(self) - 1)]


class GraphData:
    """Dataset of pre-converted ``.npz`` graphs + a labels json, skipping
    conversion entirely (``dataset.py:311-541``). ``labels.json`` maps
    mp_id -> {graph_id: {energy_per_atom, force, stress?, magmom?}} and
    graph files live at ``<graph_path>/<graph_id>.npz``."""

    def __init__(
        self,
        graph_path: str,
        *,
        labels: str | dict = "labels.json",
        targets: str = "efsm",
        energy_key: str = "energy_per_atom",
        exclude: str | list | None = None,
        shuffle: bool = True,
    ) -> None:
        self.graph_path = graph_path
        if isinstance(labels, str):
            labels = read_json(os.path.join(graph_path, labels))
        excluded = (
            read_json(exclude) if isinstance(exclude, str) else exclude or []
        )
        self.labels: dict[str, dict] = {}
        self.keys: list[tuple[str, str]] = []
        for mp_id, dct in labels.items():
            kept = {
                gid: val for gid, val in dct.items() if gid not in excluded
            }
            if kept:
                self.labels[mp_id] = kept
                self.keys += [(mp_id, gid) for gid in kept]
        if shuffle:
            random.shuffle(self.keys)
        self.targets = targets
        self.energy_key = energy_key
        self.failed_idx: list[int] = []
        self.failed_graph_id: dict[str, str] = {}

    def __len__(self) -> int:
        return len(self.keys)

    @functools.cache  # noqa: B019
    def __getitem__(self, idx: int) -> tuple[CrystalGraph, dict]:
        mp_id, graph_id = self.keys[idx]
        try:
            graph = CrystalGraph.from_file(
                os.path.join(self.graph_path, f"{graph_id}.npz")
            )
            labels = self.labels[mp_id][graph_id]
            targets = {
                "e": np.float32(labels[self.energy_key]),
                "f": np.asarray(labels["force"], dtype=np.float32),
            }
            if "s" in self.targets and labels.get("stress") is not None:
                targets["s"] = (
                    np.asarray(labels["stress"], np.float32) * -0.1
                )
            if "m" in self.targets:
                mag = labels.get("magmom")
                targets["m"] = (
                    np.full(graph.n_atoms, np.nan, dtype=np.float32)
                    if mag is None
                    else np.abs(np.asarray(mag, np.float32)).reshape(-1)
                )
            return graph, targets
        except Exception:
            self.failed_graph_id[str(graph_id)] = mp_id
            self.failed_idx.append(idx)
            return self[random.randint(0, len(self) - 1)]

    def get_train_val_test_loader(
        self,
        *,
        train_ratio: float = 0.8,
        val_ratio: float = 0.1,
        train_key: list[str] | None = None,
        val_key: list[str] | None = None,
        test_key: list[str] | None = None,
        batch_size: int = 32,
        seed: int = 42,
        **kwargs,
    ) -> tuple[GraphLoader, GraphLoader, GraphLoader]:
        """mp-id-level splits so that all frames of one material land in
        the same partition (``dataset.py:436-541``)."""
        if train_key is None:
            mp_ids = list(self.labels)
            random.Random(seed).shuffle(mp_ids)
            n_train = int(train_ratio * len(mp_ids))
            n_val = int(val_ratio * len(mp_ids))
            train_key = mp_ids[:n_train]
            val_key = mp_ids[n_train: n_train + n_val]
            test_key = mp_ids[n_train + n_val:]
        by_mp: dict[str, list[int]] = {}
        for idx, (mp_id, _) in enumerate(self.keys):
            by_mp.setdefault(mp_id, []).append(idx)
        loaders = []
        for key_list in (train_key, val_key, test_key):
            indices = [i for mp_id in key_list or [] for i in by_mp.get(mp_id, [])]
            loaders.append(
                GraphLoader(
                    self, indices=indices, batch_size=batch_size, **kwargs
                )
            )
        return tuple(loaders)


class StructureJsonData:
    """Dataset from MPtrj-schema JSON: {mp_id: {graph_id: {structure,
    energy_per_atom/..., force, stress, magmom}}} (``dataset.py:544-760``)."""

    def __init__(
        self,
        data: str | dict,
        *,
        graph_converter: CrystalGraphConverter | None = None,
        targets: str = "efsm",
        energy_key: str = "energy_per_atom",
        shuffle: bool = True,
    ) -> None:
        if isinstance(data, str):
            data = read_json(data)
        self.data = data
        self.keys = [
            (mp_id, graph_id)
            for mp_id, dct in data.items()
            for graph_id in dct
        ]
        if shuffle:
            random.shuffle(self.keys)
        self.graph_converter = graph_converter or CrystalGraphConverter(
            atom_graph_cutoff=6, bond_graph_cutoff=3
        )
        self.targets = targets
        self.energy_key = energy_key
        self.failed_idx: list[int] = []
        self.failed_graph_id: dict[str, str] = {}

    def __len__(self) -> int:
        return len(self.keys)

    @functools.cache  # noqa: B019
    def __getitem__(self, idx: int) -> tuple[CrystalGraph, dict]:
        mp_id, graph_id = self.keys[idx]
        try:
            entry = self.data[mp_id][graph_id]
            struct = Structure.from_dict(entry["structure"])
            graph = self.graph_converter(
                struct, graph_id=graph_id, mp_id=mp_id
            )
            targets = {
                "e": np.float32(entry[self.energy_key]),
                "f": np.asarray(entry["force"], dtype=np.float32),
            }
            if "s" in self.targets and entry.get("stress") is not None:
                targets["s"] = np.asarray(entry["stress"], np.float32) * -0.1
            if "m" in self.targets:
                mag = entry.get("magmom")
                targets["m"] = (
                    np.full(len(struct), np.nan, dtype=np.float32)
                    if mag is None
                    else np.abs(np.asarray(mag, np.float32)).reshape(-1)
                )
            return graph, targets
        except Exception:
            self.failed_graph_id[str(graph_id)] = mp_id
            self.failed_idx.append(idx)
            return self[random.randint(0, len(self) - 1)]

    def get_train_val_test_loader(self, **kwargs):
        """mp-id-level splits, same contract as :meth:`GraphData...`."""
        return GraphData.get_train_val_test_loader(self, **kwargs)

    @property
    def labels(self) -> dict:
        return self.data


# ------------------------------------------------------------------ collate
def collate_graphs(batch_data: list) -> tuple[list[CrystalGraph], dict]:
    """Reference-compatible collate: (graph list, dict of target lists)
    (``dataset.py:763-788``)."""
    graphs = [graph for graph, _ in batch_data]
    all_targets = {
        key: [targets[key] for _, targets in batch_data]
        for key in batch_data[0][1]
    }
    return graphs, all_targets


def collate_padded(
    batch_data: list,
    *,
    capacities: tuple[int, int, int] | None = None,
    n_graphs_cap: int | None = None,
) -> tuple[GraphBatch, dict]:
    """Collate (graph, targets) pairs into one padded GraphBatch + dense
    NaN-masked target arrays aligned with the batch's atom packing.

    Targets: ``e`` [Bcap], ``f`` [Ncap, 3], ``s`` [Bcap, 3, 3], ``m``
    [Ncap], ``graph_mask`` [Bcap]; padding lanes hold NaN so the loss
    masks them exactly like missing labels.
    """
    graphs, targets_list = collate_graphs(batch_data)
    n_graphs = len(graphs)
    n_graphs_cap = n_graphs_cap or n_graphs
    if n_graphs_cap < n_graphs:
        raise ValueError(f"{n_graphs_cap=} < {n_graphs=}")
    if n_graphs_cap > n_graphs:
        # pad the graph axis by repeating the smallest graph, masked out
        filler = min(graphs, key=lambda g: g.n_atoms)
        graphs = graphs + [filler] * (n_graphs_cap - n_graphs)

    batch = batch_graphs(graphs, capacities=capacities)
    cap_n = batch.atomic_numbers.shape[0]

    targets: dict[str, np.ndarray] = {
        "graph_mask": (np.arange(n_graphs_cap) < n_graphs).astype(np.float32)
    }
    e = np.full(n_graphs_cap, np.nan, dtype=np.float32)
    e[:n_graphs] = targets_list["e"]
    targets["e"] = e

    offsets = np.concatenate(
        [[0], np.cumsum([g.n_atoms for g in graphs])]
    )
    if "f" in targets_list:
        f = np.full((cap_n, 3), np.nan, dtype=np.float32)
        for gi in range(n_graphs):
            f[offsets[gi]: offsets[gi + 1]] = targets_list["f"][gi]
        targets["f"] = f
    if "s" in targets_list:
        s = np.full((n_graphs_cap, 3, 3), np.nan, dtype=np.float32)
        for gi in range(n_graphs):
            s[gi] = targets_list["s"][gi]
        targets["s"] = s
    if "m" in targets_list:
        m = np.full(cap_n, np.nan, dtype=np.float32)
        for gi in range(n_graphs):
            mag = targets_list["m"][gi]
            if mag is not None:
                m[offsets[gi]: offsets[gi + 1]] = mag
        targets["m"] = m
    return batch, targets


# ------------------------------------------------------------------- loader
class GraphLoader:
    """Mini-batch iterator yielding (GraphBatch, padded targets).

    Pads the graph axis to exactly ``batch_size`` every step and buckets
    atom/edge/angle capacities (monotone high-water mark by default) so the
    number of distinct shapes stays bounded. With
    ``fixed_capacities`` the shapes are pinned up front — required for the
    multi-device data-parallel path where every device must see identical
    shapes.
    """

    def __init__(
        self,
        dataset,
        *,
        indices: Sequence[int] | None = None,
        batch_size: int = 32,
        shuffle: bool = True,
        seed: int | None = 42,
        drop_last: bool = False,
        capacities: tuple[int, int, int] | None = None,
        num_device_batches: int = 1,
        prefetch: int = 2,
    ) -> None:
        self.dataset = dataset
        self.indices = np.asarray(
            indices if indices is not None else np.arange(len(dataset)),
            dtype=np.int64,
        )
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.capacities = capacities
        self.num_device_batches = num_device_batches
        self.prefetch = prefetch
        self._cap_hwm = (0, 0, 0)  # high-water marks when capacities=None

    def __len__(self) -> int:
        n = len(self.indices) // self.batch_size
        if not self.drop_last and len(self.indices) % self.batch_size:
            n += 1
        return n

    def ensure_fixed_capacities(self) -> tuple[int, int, int]:
        """Pin capacities so every batch has identical shapes (required by
        the multi-device data-parallel path, where all devices must see
        the same shapes). Upper-bounds by batch_size x the
        largest per-item sizes over this loader's indices."""
        if self.capacities is None:
            max_n = max_e = max_a = 1
            for idx in self.indices:
                graph, _ = self.dataset[int(idx)]
                max_n = max(max_n, graph.n_atoms)
                max_e = max(max_e, graph.n_directed)
                max_a = max(max_a, graph.n_angles)
            self.capacities = (
                round_up(self.batch_size * max_n),
                round_up(self.batch_size * max_e),
                round_up(self.batch_size * max_a),
            )
        return self.capacities

    def _capacities_for(self, graphs) -> tuple[int, int, int]:
        if self.capacities is not None:
            return self.capacities
        cap_n = round_up(sum(g.n_atoms for g in graphs))
        cap_e = round_up(sum(g.n_directed for g in graphs))
        cap_a = round_up(max(sum(g.n_angles for g in graphs), 1))
        self._cap_hwm = (
            max(self._cap_hwm[0], cap_n),
            max(self._cap_hwm[1], cap_e),
            max(self._cap_hwm[2], cap_a),
        )
        return self._cap_hwm

    def _chunks(self):
        order = self.indices.copy()
        if self.shuffle:
            self.rng.shuffle(order)
        step = self.batch_size
        for start in range(0, len(order), step):
            chunk = order[start: start + step]
            if self.drop_last and len(chunk) < step:
                return
            yield chunk

    def _collate(self, chunk):
        items = [self.dataset[int(i)] for i in chunk]
        graphs = [g for g, _ in items]
        # remainder batches are padded to batch_size with copies of the
        # smallest graph (masked out); capacities must cover the fillers
        if len(graphs) < self.batch_size:
            filler = min(graphs, key=lambda g: g.n_atoms)
            sizing = graphs + [filler] * (self.batch_size - len(graphs))
        else:
            sizing = graphs
        caps = self._capacities_for(sizing)
        return collate_padded(
            items, capacities=caps, n_graphs_cap=self.batch_size
        )

    def __iter__(self):
        if self.prefetch <= 0:
            for chunk in self._chunks():
                yield self._collate(chunk)
            return
        # threaded prefetch: host graph building overlaps device compute
        # (the role of torch DataLoader workers upstream,
        # dataset.py:798). One worker preserves batch order and is enough
        # to hide conversion latency behind a train step.
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = []
            chunks = self._chunks()
            for chunk in chunks:
                pending.append(pool.submit(self._collate, chunk))
                if len(pending) > self.prefetch:
                    yield pending.pop(0).result()
            for fut in pending:
                yield fut.result()


def get_loader(dataset, *, batch_size: int = 64, **kwargs) -> GraphLoader:
    """One loader over the full dataset (``dataset.py:851-884``)."""
    return GraphLoader(dataset, batch_size=batch_size, **kwargs)


def get_train_val_test_loader(
    dataset,
    *,
    batch_size: int = 64,
    train_ratio: float = 0.8,
    val_ratio: float = 0.1,
    return_test: bool = True,
    num_workers: int = 0,
    pin_memory: bool = True,
    seed: int = 42,
    **kwargs,
):
    """Random index split into train/val(/test) loaders
    (``dataset.py:791-848``); pin_memory accepted for API compatibility
    and ignored; num_workers > 0 maps onto the loader's threaded
    ``prefetch`` (host graph building overlapping device compute)."""
    if num_workers:
        kwargs.setdefault("prefetch", max(2, num_workers))
    total = len(dataset)
    indices = np.random.default_rng(seed).permutation(total)
    n_train = int(train_ratio * total)
    n_val = int(val_ratio * total)
    train_loader = GraphLoader(
        dataset,
        indices=indices[:n_train],
        batch_size=batch_size,
        seed=seed,
        **kwargs,
    )
    val_loader = GraphLoader(
        dataset,
        indices=indices[n_train: n_train + n_val],
        batch_size=batch_size,
        seed=seed,
        **kwargs,
    )
    if not return_test:
        return train_loader, val_loader
    test_loader = GraphLoader(
        dataset,
        indices=indices[n_train + n_val:],
        batch_size=batch_size,
        seed=seed,
        **kwargs,
    )
    return train_loader, val_loader, test_loader


def make_graphs(
    dataset,
    graph_dir: str,
    *,
    train_ratio: float = 0.8,
    val_ratio: float = 0.1,
) -> None:
    """Pre-convert a dataset's structures to saved ``.npz`` graphs + a
    labels json consumable by :class:`GraphData` (counterpart of
    upstream CHGNet's ``examples/make_graphs.py``)."""
    os.makedirs(graph_dir, exist_ok=True)
    labels: dict[str, dict] = {}
    for idx in range(len(dataset)):
        graph, targets = dataset[idx]
        graph_id = graph.graph_id or str(idx)
        mp_id = graph.mp_id or graph_id
        graph.save(fname=f"{graph_id}.npz", save_dir=graph_dir)
        entry = {
            "energy_per_atom": float(targets["e"]),
            "force": np.asarray(targets["f"]).tolist(),
        }
        if "s" in targets:
            entry["stress"] = (np.asarray(targets["s"]) * -10.0).tolist()
        if "m" in targets:
            mag = np.asarray(targets["m"])
            entry["magmom"] = None if np.isnan(mag).all() else mag.tolist()
        labels.setdefault(mp_id, {})[graph_id] = entry
    write_json(labels, os.path.join(graph_dir, "labels.json"))
