"""Skin-radius graph topology reuse for simulation loops on the device.

Port of ``chgnet_tpu.simulation.runtime`` for one device. Upstream CHGNet
rebuilds the crystal graph on the host at every MD or relaxation step.
Here the topology is built once with both cutoffs enlarged by a ``skin``
radius and reused across steps; :func:`apply_dynamic_cutoff` restores the
exact cutoffs on the device by recomputing the edge and angle masks from
the *current* positions, so a masked row keeps its place in the batch and
in its plans and only stops contributing (the masks multiply; nothing is
re-planned). The host rebuilds only when accumulated atomic drift or
lattice strain could let a neighbour cross the skin shell (the Verlet-list
criterion), on background threads while the loop keeps stepping.

The atom capacity is pinned, so per-atom state (velocities, ...) stays
valid across rebuilds; edge and angle capacities grow monotonically on the
bucket grid. ``chgnet_tpu`` also aligns the atom capacity of large systems
to its TPU stream chunk; the port keeps ``round_up`` only, so padded shapes
may differ from ``chgnet_tpu``'s while results do not.
"""

from __future__ import annotations

import os
import time
from collections.abc import Sequence
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from chgnet_tpu_torch.core.lattice import Lattice
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.device import resolve_device
from chgnet_tpu_torch.graph.batching import (
    GraphBatch,
    SegmentPlan,
    batch_graphs,
    round_up,
)
from chgnet_tpu_torch.graph.converter import CrystalGraphConverter
from chgnet_tpu_torch.models.chgnet import CHGNetConfig, compute_batch
from chgnet_tpu_torch.ops.segment import segment_sum_csr

_TOL = 1e-8  # matches the neighbour search's numerical tolerance


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def graph_sum(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Per-graph sums ``[B, ...]`` of a per-atom array ``[N, ...]`` over the
    batch's atom -> graph plan (``plan_graph``; padded atoms dropped), in a
    fixed order: ``segment_sum_csr`` on the card, its plain version on the
    CPU. The simulation loops' reductions, so that a fixed seed gives one
    trajectory."""
    flat = x.reshape(x.shape[0], -1).contiguous()
    out = segment_sum_csr(flat, plan.offsets, plan.perm)
    return out.reshape((plan.n_out, *x.shape[1:]))


def apply_dynamic_cutoff(batch: GraphBatch, config: CHGNetConfig) -> GraphBatch:
    """Recompute the edge/bond/angle masks from the batch's current
    positions at the model's cutoffs, on the batch's device, in f32 and
    outside autograd.

    The graph builder's comparisons (``graph/builder.py``), as ``chgnet_tpu``
    makes them: an atom-graph bond stays while its length ``d <=
    atom_graph_cutoff + 1e-8``; an angle row stays while its undirected bond
    i has ``d_i <= bond_graph_cutoff + 1e-8`` and its directed bond j has
    ``d_j < bond_graph_cutoff - 1e-8``. Lengths are ``sqrt(sum(v * v))`` of
    each edge's vector, the bond's length that of its first directed edge.
    """
    with torch.no_grad():
        lat = batch.lattices
        cart = torch.einsum(
            "ni,nij->nj", batch.frac_coords, lat[batch.atom_owner.long()]
        )
        ends = batch.atom_graph.long()
        vec = (
            cart[ends[:, 0]]
            - cart[ends[:, 1]]
            - torch.einsum("ei,eij->ej", batch.images, lat[batch.edge_owner.long()])
        )
        dist = torch.sqrt((vec * vec).sum(dim=1))  # [E] directed lengths
        und_dist = dist[batch.undirected2directed.long()]  # [U]

        in_atom_graph = und_dist <= config.atom_graph_cutoff + _TOL
        edge_mask = batch.edge_mask * in_atom_graph[
            batch.directed2undirected.long()
        ].to(batch.edge_mask.dtype)
        und_mask = batch.und_mask * in_atom_graph.to(batch.und_mask.dtype)

        rows = batch.bond_graph.long()
        left_ok = und_dist[rows[:, 1]] <= config.bond_graph_cutoff + _TOL
        right_ok = dist[rows[:, 4]] < config.bond_graph_cutoff - _TOL
        angle_mask = batch.angle_mask * (left_ok & right_ok).to(batch.angle_mask.dtype)
    return batch._replace(edge_mask=edge_mask, und_mask=und_mask, angle_mask=angle_mask)


def compute_batch_dynamic(
    params,
    batch: GraphBatch,
    *,
    config: CHGNetConfig,
    compute_stress: bool = True,
    compute_magmom: bool = True,
) -> dict[str, torch.Tensor]:
    """Forward pass with forces over a skin-built batch: the dynamic-cutoff
    masks first, then :func:`compute_batch` (energies per atom in eV,
    forces eV/A, stress GPa, magmoms mu_B; detached tensors)."""
    batch = apply_dynamic_cutoff(batch, config)
    return compute_batch(
        params,
        batch,
        config=config,
        compute_force=True,
        compute_stress=compute_stress,
        compute_magmom=compute_magmom,
    )


class GraphRuntime:
    """Builds and maintains a padded :class:`GraphBatch` on ``device`` for
    structures whose positions and lattices evolve there.

    Usage::

        rt = GraphRuntime(config, structures, skin=0.3, device="cuda")
        batch = rt.batch                       # initial padded batch
        ...advance frac / lattices on the device...
        if rt.needs_rebuild(frac, lattices):
            batch = rt.rebuild(frac, lattices)

    ``shard_mesh``, ``halo``, ``lean`` and ``tile`` (the multi-device,
    lean-shipping and halo-tiled layouts of ``chgnet_tpu``) are not ported
    yet and raise ``NotImplementedError`` (ROADMAP.md Queue 1 items 6 and
    9).
    """

    def __init__(
        self,
        config: CHGNetConfig,
        structures: Sequence[Structure],
        *,
        skin: float = 0.3,
        on_isolated_atoms: str = "warn",
        device: str | torch.device = "cuda",
        shard_mesh=None,
        halo: bool = False,
        lean: bool | None = None,
        tile: bool | int = False,
    ) -> None:
        unported = {
            "shard_mesh": shard_mesh is not None,
            "halo": bool(halo),
            "lean": bool(lean),
            "tile": bool(tile) or bool(os.environ.get("CHGNET_TPU_MD_TILE")),
        }
        bad = sorted(k for k, v in unported.items() if v)
        if bad:
            raise NotImplementedError(
                f"GraphRuntime options {bad} are not ported to chgnet_tpu_torch "
                "yet (ROADMAP.md Queue 1: item 9 for shard_mesh/halo, item 6 "
                "for lean/tile)"
            )
        if config.dense_atom_conv:
            raise NotImplementedError(
                "dense_atom_conv is a batching mode for inference/training "
                "batches; simulation loops use the CSR layout"
            )
        self.config = config
        self.device = resolve_device(device)
        self.skin = float(skin)
        # the port's builder is the numpy one (algorithm="fast" would fall
        # back to it with a warning)
        self.converter = CrystalGraphConverter(
            atom_graph_cutoff=config.atom_graph_cutoff + self.skin,
            bond_graph_cutoff=config.bond_graph_cutoff + self.skin,
            algorithm="numpy",
            on_isolated_atoms=on_isolated_atoms,  # type: ignore[arg-type]
        )
        self.n_structs = len(structures)
        self.sizes = [len(s) for s in structures]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self.atomic_numbers = [s.atomic_numbers.copy() for s in structures]
        self.site_properties = [dict(s.site_properties) for s in structures]
        # pinned atom capacity; edge/angle capacities grow monotonically
        self.cap_n = round_up(int(self.offsets[-1]))
        self._cap_e = 0
        self._cap_a = 0
        self.n_rebuilds = -1  # the first build is not a rebuild
        # phase timings (seconds, cumulative): graphs_s = host graph
        # builds, batch_s = padding + plans, put_s = host -> device copy,
        # stall_s = loop blocked on a rebuild, sync_rebuilds = times the
        # Verlet budget ran out with no finished background build
        self.stats = {
            "graphs_s": 0.0, "batch_s": 0.0, "put_s": 0.0,
            "stall_s": 0.0, "sync_rebuilds": 0,
        }
        self._pipeline: list = []  # in-flight ship futures, launch order
        self._launch_ref = None  # (frac, lat) of the newest launch
        self._execs: tuple[ThreadPoolExecutor, ...] | None = None
        self.batch = self._build(
            [s.frac_coords for s in structures],
            np.stack([s.lattice.matrix for s in structures]),
        )

    # ----------------------------------------------------------------- build
    def _graph_stage(self, frac_list: list[np.ndarray], lattices):
        """First rebuild stage: the host graphs only. Its own executor, so
        build N+2's graphs overlap build N+1's batching and build N's copy
        to the device (a 3-deep pipeline)."""
        t0 = time.perf_counter()
        graphs = []
        for idx in range(self.n_structs):
            struct = Structure(
                Lattice(np.asarray(lattices[idx], dtype=np.float64)),
                self.atomic_numbers[idx].tolist(),
                np.asarray(frac_list[idx], dtype=np.float64),
            )
            graphs.append(self.converter(struct, graph_id=str(idx)))
        self.stats["graphs_s"] += time.perf_counter() - t0
        return graphs

    def _batch_stage(self, graphs) -> dict:
        """Second stage: padded batching and plans. One executor, so
        consecutive builds see monotonically growing capacities in order."""
        t1 = time.perf_counter()
        tot_e = sum(g.n_directed for g in graphs)
        tot_a = sum(g.n_angles for g in graphs)
        cap_e = max(self._cap_e, round_up(tot_e))
        cap_a = max(self._cap_a, round_up(max(tot_a, 1)))
        self._cap_e, self._cap_a = cap_e, cap_a
        # bucket=False: the pinned atom capacity is taken verbatim
        batch = batch_graphs(
            graphs, bucket=False, capacities=(self.cap_n, cap_e, cap_a)
        )
        built = {
            "ref_frac": batch.frac_coords.copy(),
            "ref_lat": batch.lattices.copy(),
            "atom_owner": batch.atom_owner.copy(),
            "cap_e": cap_e,
            "cap_a": cap_a,
            "batch": batch,
        }
        self.stats["batch_s"] += time.perf_counter() - t1
        return built

    def _ship_stage(self, built: dict) -> dict:
        """Device half of a rebuild: the batch's arrays and plans copied to
        the device (a blocking copy on the default stream, so the batch is
        whole when the future completes). One executor, so batches land in
        launch order."""
        t2 = time.perf_counter()
        built["batch"] = built["batch"].to(self.device)
        self.stats["put_s"] += time.perf_counter() - t2
        return built

    def _build_worker(self, frac_list: list[np.ndarray], lattices: np.ndarray) -> dict:
        """All rebuild stages back to back (the synchronous path)."""
        return self._ship_stage(
            self._batch_stage(self._graph_stage(frac_list, lattices))
        )

    def _apply_build(self, built: dict) -> GraphBatch:
        self._cap_e = built["cap_e"]
        self._cap_a = built["cap_a"]
        self._ref_frac = built["ref_frac"]
        self._ref_lat = built["ref_lat"]
        self._ref_inv_lat = np.linalg.inv(self._ref_lat)
        self._atom_owner_np = built["atom_owner"]
        self.n_rebuilds += 1
        self.batch = built["batch"]
        return self.batch

    def _build(self, frac_list: list[np.ndarray], lattices: np.ndarray) -> GraphBatch:
        return self._apply_build(self._build_worker(frac_list, lattices))

    def _split(self, frac: np.ndarray) -> list[np.ndarray]:
        return [
            frac[self.offsets[i]: self.offsets[i + 1]]
            for i in range(self.n_structs)
        ]

    def rebuild(self, frac, lattices) -> GraphBatch:
        """Rebuild the topology from padded frac [cap_n, 3] and lattices
        [B, 3, 3] (arrays or tensors)."""
        # a fresh synchronous build supersedes any in-flight ones
        self._drain_pipeline()
        frac = np.asarray(_host(frac), dtype=np.float64)
        lattices = np.asarray(_host(lattices), dtype=np.float64)
        self._build(self._split(frac), lattices)
        return self.batch

    # ------------------------------------------------------- async rebuild
    # The host graph build takes seconds at 10k atoms, so a loop LAUNCHES a
    # rebuild on background threads as soon as drift crosses a trigger
    # fraction of the skin and keeps stepping on the (still valid) old
    # topology; the Verlet criterion is judged against the positions the
    # current batch was built from, so results do not depend on when a
    # build lands. Stages: graphs, batching, copy to the device, one thread
    # each.
    _MAX_INFLIGHT = 3

    def _executors(self) -> tuple[ThreadPoolExecutor, ...]:
        if self._execs is None:
            self._execs = tuple(
                ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"graph-{name}")
                for name in ("build", "batch", "ship")
            )
        return self._execs

    def launch_rebuild(self, frac, lattices) -> bool:
        """Start a background rebuild from these positions. Returns False
        when the pipeline is full (or these positions are too close to the
        newest in-flight build's to be worth a fresh topology)."""
        if len(self._pipeline) >= self._MAX_INFLIGHT:
            return False
        frac = np.array(_host(frac), dtype=np.float64)
        lattices = np.array(_host(lattices), dtype=np.float64)
        if self._pipeline and self._launch_ref is not None:
            # a second in-flight build pays off only once drift has moved a
            # meaningful fraction of the skin past the first's launch point
            ref_frac, ref_lat = self._launch_ref
            if self._drift_between(ref_frac, ref_lat, frac, lattices) < 0.25:
                return False
        graph_exec, batch_exec, ship_exec = self._executors()
        gf = graph_exec.submit(self._graph_stage, self._split(frac), lattices)
        bf = batch_exec.submit(lambda: self._batch_stage(gf.result()))
        sf = ship_exec.submit(lambda: self._ship_stage(bf.result()))
        self._pipeline.append(sf)
        self._launch_ref = (frac, lattices)
        return True

    def poll_rebuild(self) -> bool:
        """Swap in finished background rebuilds (in launch order); False if
        none was ready."""
        applied = False
        while self._pipeline and self._pipeline[0].done():
            self._apply_build(self._pipeline.pop(0).result())
            applied = True
        if not self._pipeline:
            self._launch_ref = None
        return applied

    def finish_rebuild(self) -> bool:
        """Block until the oldest pending background rebuild lands (True),
        or return False if none was pending."""
        if not self._pipeline:
            return False
        t0 = time.perf_counter()
        self._apply_build(self._pipeline.pop(0).result())
        self.stats["stall_s"] += time.perf_counter() - t0
        if not self._pipeline:
            self._launch_ref = None
        return True

    def _drain_pipeline(self) -> None:
        while self._pipeline:
            fut = self._pipeline.pop(0)
            fut.cancel()
            if not fut.cancelled():
                fut.result()
        self._launch_ref = None

    def step_rebuild(self, frac, lattices, *, trigger: float = 0.4) -> float:
        """One tick of the async-rebuild policy of the MD and relaxation
        loops: swap in any finished background build, then, judged against
        the (possibly new) reference positions, block on or run a rebuild
        when the Verlet budget is spent, or launch a background rebuild once
        drift crosses ``trigger`` of the skin. Returns the drift fraction."""
        frac, lattices = _host(frac), _host(lattices)
        self.poll_rebuild()
        drift = self.drift_fraction(frac, lattices)
        while drift >= 1.0 and self.finish_rebuild():
            drift = self.drift_fraction(frac, lattices)
        if drift >= 1.0:
            self.stats["sync_rebuilds"] += 1
            t0 = time.perf_counter()
            self.rebuild(frac, lattices)
            self.stats["stall_s"] += time.perf_counter() - t0
            drift = 0.0
        elif drift >= trigger:
            self.launch_rebuild(frac, lattices)
        return drift

    # --------------------------------------------------------- rebuild check
    def _drift_between(self, ref_frac, ref_lat, frac, lattices) -> float:
        """Skin-budget fraction consumed going from (ref_frac, ref_lat) to
        (frac, lattices): 2 x max displacement + strain-stretched build
        radius, over the skin."""
        return self._drift(ref_frac, np.linalg.inv(ref_lat), frac, lattices)

    def _drift(self, ref_frac, ref_inv_lat, frac, lattices) -> float:
        frac, lattices = _host(frac), _host(lattices)
        disp = np.einsum("ni,nij->nj", frac - ref_frac, lattices[self._atom_owner()])
        max_disp = float(np.sqrt((disp**2).sum(axis=1)).max()) if len(disp) else 0.0
        # operator-norm bound of the deformation relative to the build cell
        strain = np.matmul(ref_inv_lat, lattices) - np.eye(3)
        strain_norm = float(max(np.linalg.norm(s, 2) for s in strain))
        r_build = self.config.atom_graph_cutoff + self.skin
        return (2.0 * max_disp + strain_norm * r_build) / self.skin

    def drift_fraction(self, frac, lattices) -> float:
        """Fraction of the skin budget consumed since the current batch was
        built. >= 1.0 means two atoms could have closed the shell."""
        return self._drift(self._ref_frac, self._ref_inv_lat, frac, lattices)

    def needs_rebuild(self, frac, lattices) -> bool:
        """Verlet-list criterion: rebuild when two atoms could have closed
        the skin shell (2 x max displacement) or lattice strain could have
        stretched a build-radius bond by the remaining margin."""
        return self.drift_fraction(frac, lattices) >= 1.0

    def _atom_owner(self) -> np.ndarray:
        return self._atom_owner_np

    # ------------------------------------------------------------- unpadding
    def unpad(self, arr, graph_idx: int) -> np.ndarray:
        """Slice one structure's rows out of a padded per-atom array."""
        return _host(arr)[self.offsets[graph_idx]: self.offsets[graph_idx + 1]]

    def structures(self, frac, lattices) -> list[Structure]:
        """Host Structures from the padded state."""
        frac = np.asarray(_host(frac), dtype=np.float64)
        lattices = np.asarray(_host(lattices), dtype=np.float64)
        return [
            Structure(
                Lattice(lattices[i]),
                self.atomic_numbers[i].tolist(),
                self.unpad(frac, i),
                site_properties=self.site_properties[i],
            )
            for i in range(self.n_structs)
        ]
