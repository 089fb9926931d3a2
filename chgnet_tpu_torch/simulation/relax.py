"""Batched structure relaxation on the device: FIRE and MDMin.

Port of the FIRE/MDMin half of ``chgnet_tpu.simulation.relax`` for one
device. Upstream CHGNet loops ASE's FIRE on the host and rebuilds the
graph every step. Here:

* FIRE (Bitzek et al. 2006, ASE's parameters: dt0=0.1, dtmax=1.0, Nmin=5,
  finc=1.1, fdec=0.5, astart=0.1, fa=0.99, maxstep=0.2 A) runs in chunks of
  steps over a padded batch, the state on the device and the per-step
  outputs read back once per chunk;
* many structures relax in parallel, each with its own FIRE clock and
  convergence flag (converged graphs freeze in place);
* cell relaxation follows the unit-cell-filter scheme: the degrees of
  freedom are (cartesian positions, cell_factor * strain), the strain
  gradient dE/d(eps) coming from the same backward pass as the forces;
* the topology is reused across steps by :class:`GraphRuntime` skin masks.

``chgnet_tpu``'s LBFGS, BFGS, their line-search forms and the SciPy
relaxers are not ported yet (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.graph.batching import GraphBatch
from chgnet_tpu_torch.models.chgnet import CHGNetConfig
from chgnet_tpu_torch.simulation.calculator import resolve_model, voigt_6
from chgnet_tpu_torch.simulation.md import inverse_3x3
from chgnet_tpu_torch.simulation.observers import (
    CrystalFeasObserver,
    TrajectoryObserver,
)
from chgnet_tpu_torch.simulation.runtime import (
    GraphRuntime,
    compute_batch_dynamic,
    graph_sum,
)
from chgnet_tpu_torch.simulation.units import GPA_TO_EV_A3

# the optimizers chgnet_tpu's StructOptimizer takes, and those ported here
SUPPORTED = {
    "FIRE", "LBFGS", "LBFGSLineSearch", "MDMin", "BFGS", "BFGSLineSearch",
    "SciPyFminCG", "SciPyFminBFGS",
}
PORTED = {"FIRE", "MDMin"}


class FIRE(NamedTuple):
    """FIRE hyperparameters (ASE defaults)."""

    dt0: float = 0.1
    dtmax: float = 1.0
    n_min: int = 5
    f_inc: float = 1.1
    f_dec: float = 0.5
    alpha_start: float = 0.1
    f_alpha: float = 0.99
    maxstep: float = 0.2


class FireState(NamedTuple):
    """Per-batch FIRE integration state (tensors on one device)."""

    frac: torch.Tensor  # [N, 3]
    lat: torch.Tensor  # [B, 3, 3]
    vel: torch.Tensor  # [N, 3] atom DOF velocity
    vel_cell: torch.Tensor  # [B, 3, 3] scaled-strain DOF velocity
    dt: torch.Tensor  # [B]
    alpha: torch.Tensor  # [B]
    n_pos: torch.Tensor  # [B] i32
    converged: torch.Tensor  # [B] bool


def _init_state(batch: GraphBatch, fire: FIRE) -> FireState:
    """The state at the batch's positions, on the batch's device."""
    n_graphs = batch.lattices.shape[0]
    n_pad = batch.frac_coords.shape[0]
    dev = batch.frac_coords.device

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return FireState(
        frac=batch.frac_coords,
        lat=batch.lattices,
        vel=full((n_pad, 3), 0.0),
        vel_cell=full((n_graphs, 3, 3), 0.0),
        dt=full((n_graphs,), fire.dt0),
        alpha=full((n_graphs,), fire.alpha_start),
        n_pos=full((n_graphs,), 0, torch.int32),
        converged=full((n_graphs,), False, torch.bool),
    )


def make_fire_step(
    *,
    fire: FIRE,
    owner: torch.Tensor,  # [N] graph ids (sorted)
    atom_mask: torch.Tensor,  # [N, 1]
    fmax_target: float,
    cell_factor: torch.Tensor,  # [B]
    relax_cell: bool,
    record: bool,
    method: str,
    evaluate,  # (frac, lat) -> (e_total [B], forces [N,3], virial, out)
    seg_sum,  # per-atom [N] -> per-graph [B] sum over owner
    seg_max,  # per-atom [N] -> per-graph [B] max over owner
):
    """Build one FIRE/MDMin step ``state -> (state, ys)``.

    As in ``chgnet_tpu``, the optimizer maths is parameterised by the force
    engine and the atom -> graph reductions. The step reads nothing back to
    the host; run it under ``torch.no_grad()``.
    """
    owner = owner.long()

    def step(state: FireState):
        e_total, forces, virial, out = evaluate(state.frac, state.lat)
        cell_forces = (
            -virial / cell_factor[:, None, None] if relax_cell
            else torch.zeros_like(virial)
        )

        # convergence: max row norm over atoms (+ cell pseudo-atoms)
        f2_atom = (forces**2).sum(dim=1)
        fmax2 = seg_max(torch.where(atom_mask[:, 0] > 0, f2_atom, 0.0))
        if relax_cell:
            fmax2 = torch.maximum(fmax2, (cell_forces**2).sum(dim=2).amax(dim=1))
        fmax = torch.sqrt(fmax2)
        converged = state.converged | (fmax < fmax_target)

        # FIRE / MDMin: P = F . v per graph over the combined DOF
        power = seg_sum((forces * state.vel).sum(dim=1)) + (
            (cell_forces * state.vel_cell).sum(dim=(1, 2))
        )
        v_norm2 = seg_sum((state.vel**2).sum(dim=1)) + (
            (state.vel_cell**2).sum(dim=(1, 2))
        )
        f_norm2 = seg_sum(f2_atom) + (cell_forces**2).sum(dim=(1, 2))
        downhill = power > 0.0

        if method == "MDMin":
            # project v fully onto F when downhill, zero when uphill
            proj = power / torch.clamp(f_norm2, min=1e-30)
            vel = torch.where(
                downhill[owner][:, None], proj[owner][:, None] * forces, 0.0
            )
            vel_cell = torch.where(
                downhill[:, None, None], proj[:, None, None] * cell_forces, 0.0
            )
            dt, alpha, n_pos = state.dt, state.alpha, state.n_pos
        else:
            mix = state.alpha * torch.sqrt(v_norm2 / torch.clamp(f_norm2, min=1e-30))
            vel_mixed = (1.0 - state.alpha[owner])[:, None] * state.vel + mix[
                owner
            ][:, None] * forces
            velc_mixed = (
                (1.0 - state.alpha)[:, None, None] * state.vel_cell
                + mix[:, None, None] * cell_forces
            )
            vel = torch.where(downhill[owner][:, None], vel_mixed, 0.0)
            vel_cell = torch.where(downhill[:, None, None], velc_mixed, 0.0)

            grow = downhill & (state.n_pos > fire.n_min)
            dt = torch.where(
                grow,
                torch.clamp(state.dt * fire.f_inc, max=fire.dtmax),
                torch.where(downhill, state.dt, state.dt * fire.f_dec),
            )
            alpha = torch.where(
                grow,
                state.alpha * fire.f_alpha,
                torch.where(downhill, state.alpha, fire.alpha_start),
            )
            n_pos = torch.where(downhill, state.n_pos + 1, 0).to(state.n_pos.dtype)

        vel = vel + dt[owner][:, None] * forces
        vel_cell = vel_cell + dt[:, None, None] * cell_forces

        dr = dt[owner][:, None] * vel
        dr_cell = dt[:, None, None] * vel_cell
        dr_norm = torch.sqrt(
            seg_sum((dr**2).sum(dim=1)) + (dr_cell**2).sum(dim=(1, 2))
        )
        scale = torch.clamp(fire.maxstep / torch.clamp(dr_norm, min=1e-30), max=1.0)
        active = scale * torch.where(converged, 0.0, 1.0)  # freeze converged
        dr = dr * active[owner][:, None] * atom_mask
        d_strain = dr_cell * (active / cell_factor)[:, None, None]

        # fold: lat' = lat @ (I + de), cart' = (cart + dr) @ (I + de)
        eye3 = torch.eye(3, dtype=state.lat.dtype, device=state.lat.device)
        deform = eye3[None] + d_strain
        lat_new = torch.einsum("bij,bjk->bik", state.lat, deform)
        cart = torch.einsum("ni,nij->nj", state.frac, state.lat[owner]) + dr
        cart = torch.einsum("ni,nij->nj", cart, deform[owner])
        frac_new = torch.einsum("ni,nij->nj", cart, inverse_3x3(lat_new)[owner])

        new_state = FireState(
            frac=frac_new,
            lat=lat_new,
            vel=vel,
            vel_cell=vel_cell,
            dt=dt,
            alpha=alpha,
            n_pos=n_pos,
            converged=converged,
        )
        ys = {"energy": e_total, "fmax": fmax}
        if record:
            ys.update(
                forces=forces,
                stress=out["s"],
                magmom=out["m"],
                crystal_fea=out["crystal_fea"],
                frac=state.frac,
                lat=state.lat,
            )
        return new_state, ys

    return step


def fire_chunk(
    params,
    batch: GraphBatch,
    state: FireState,
    *,
    config: CHGNetConfig,
    fire: FIRE,
    n_steps: int,
    fmax_target: float,
    cell_factor: torch.Tensor,  # [B]
    relax_cell: bool,
    record: bool,
    method: str = "FIRE",
) -> tuple[FireState, dict[str, torch.Tensor]]:
    """Run ``n_steps`` fixed-topology FIRE (or MDMin) steps on the batch's
    device. Returns the state and the per-step outputs stacked on the
    device. Each step evaluates E/F(/S), updates convergence, then moves
    the unconverged graphs. MDMin is the velocity-projection quench: v is
    projected onto F when downhill and zeroed when uphill (ASE's MDMin)."""
    n_graphs = batch.lattices.shape[0]
    owner = batch.atom_owner.long()
    atom_mask = batch.atom_mask[:, None]

    def seg_max(per_atom):  # [N] -> [B]; padded atoms are masked upstream
        out = torch.zeros(n_graphs, dtype=per_atom.dtype, device=per_atom.device)
        return out.scatter_reduce(0, owner, per_atom, "amax", include_self=False)

    def evaluate(frac, lat):
        out = compute_batch_dynamic(
            params,
            batch._replace(frac_coords=frac, lattices=lat),
            config=config,
            compute_stress=relax_cell or record,
            compute_magmom=record,
        )
        n_atoms = torch.clamp(out["atoms_per_graph"], min=1.0)
        e_total = out["e"] * (n_atoms if config.is_intensive else 1.0)
        forces = out["f"] * atom_mask
        if relax_cell or record:
            volume = torch.abs(torch.linalg.det(lat))
            virial = out["s"] * GPA_TO_EV_A3 * volume[:, None, None]  # dE/d(strain) eV
            virial = 0.5 * (virial + virial.transpose(1, 2))
        else:
            virial = torch.zeros((n_graphs, 3, 3), dtype=forces.dtype, device=forces.device)
        return e_total, forces, virial, out

    step = make_fire_step(
        fire=fire,
        owner=owner,
        atom_mask=atom_mask,
        fmax_target=fmax_target,
        cell_factor=cell_factor,
        relax_cell=relax_cell,
        record=record,
        method=method,
        evaluate=evaluate,
        seg_sum=lambda x: graph_sum(x, batch.plan_graph),
        seg_max=seg_max,
    )
    trace = []
    with torch.no_grad():
        for _ in range(n_steps):
            state, ys = step(state)
            trace.append(ys)
    return state, {k: torch.stack([ys[k] for ys in trace]) for k in trace[0]}


class StructOptimizer:
    """Structure relaxation by batched FIRE or MDMin on the model's device.

    Upstream CHGNet's API: ``relax()`` returns ``{"final_structure",
    "trajectory", "final_energy"}``, or a list of such dicts when given
    several structures, all relaxed in ONE padded batch. ``final_energy``
    is the energy of the last evaluated state, one move before
    ``final_structure`` (as in ``chgnet_tpu``). The other optimizers of
    ``chgnet_tpu`` (LBFGS, BFGS, their line-search forms, SciPy) and
    ``mesh`` raise ``NotImplementedError``.
    """

    def __init__(
        self,
        model=None,
        *,
        optimizer_class: str = "FIRE",
        use_device: str | None = None,
        stress_weight: float = GPA_TO_EV_A3,
        on_isolated_atoms: str = "warn",
        fire_params: FIRE | None = None,
        mesh: int | None = None,
        halo: bool = False,
    ) -> None:
        optimizer_class = optimizer_class or "FIRE"
        if optimizer_class not in SUPPORTED:
            raise NotImplementedError(
                f"{optimizer_class=}: the relaxer implements {sorted(SUPPORTED)}"
            )
        if optimizer_class not in PORTED:
            raise NotImplementedError(
                f"{optimizer_class=} is not ported to chgnet_tpu_torch yet "
                f"(ROADMAP.md Queue 1 item 5); ported: {sorted(PORTED)}"
            )
        if mesh is not None or halo:
            raise NotImplementedError(
                "mesh= / halo= (graph-partitioned relaxation over several "
                "devices) is not ported to chgnet_tpu_torch yet (ROADMAP.md "
                "Queue 1 item 9)"
            )
        self.optimizer_class = optimizer_class
        self.model = resolve_model(model, use_device)
        self.fire = fire_params or FIRE()
        self.on_isolated_atoms = on_isolated_atoms

    @property
    def version(self) -> str | None:
        return self.model.version

    @property
    def n_params(self) -> int:
        return self.model.n_params

    def relax(
        self,
        atoms: Structure | list[Structure],
        *,
        fmax: float = 0.1,
        steps: int = 500,
        relax_cell: bool = True,
        save_path: str | None = None,
        loginterval: int | None = 1,
        crystal_feas_save_path: str | None = None,
        ase_filter: str | None = "FrechetCellFilter",
        verbose: bool = False,
        assign_magmoms: bool = True,
        chunk_size: int = 20,
        skin: float = 0.3,
        **kwargs,
    ):
        """Relax structure(s) to a local total-energy minimum.

        Upstream's ``relax`` arguments; ``chunk_size`` sets how many steps
        run between host-side convergence checks and topology rebuilds.
        """
        single = isinstance(atoms, Structure)
        structures = [atoms] if single else list(atoms)
        if ase_filter not in {"FrechetCellFilter", "ExpCellFilter", None}:
            raise NotImplementedError(
                f"{ase_filter=}: the relaxer implements a unit-cell-filter "
                "strain parameterization"
            )
        runtime = GraphRuntime(
            self.model.config,
            structures,
            skin=skin,
            on_isolated_atoms=self.on_isolated_atoms,
            device=self.model.device,
        )
        cell_factor = torch.as_tensor(
            [max(len(s), 1) for s in structures], dtype=torch.float32,
            device=self.model.device,
        )
        record = loginterval is not None or crystal_feas_save_path is not None
        state = _init_state(runtime.batch, self.fire)
        observers = [
            TrajectoryObserver(atomic_numbers=s.atomic_numbers) for s in structures
        ]
        feas_observer = CrystalFeasObserver() if crystal_feas_save_path else None

        total = 0
        last_energy = np.zeros(len(structures))
        while total < steps:
            n_steps = min(chunk_size, steps - total)
            state, traj = fire_chunk(
                self.model.params,
                runtime.batch,
                state,
                config=self.model.config,
                fire=self.fire,
                n_steps=n_steps,
                fmax_target=fmax,
                cell_factor=cell_factor,
                relax_cell=relax_cell,
                record=record,
                method=self.optimizer_class,
            )
            traj = {k: v.cpu().numpy() for k, v in traj.items()}
            last_energy = traj["energy"][-1]
            if record:
                self._record(observers, runtime, traj, total, loginterval)
                if feas_observer is not None:
                    for step in range(len(traj["crystal_fea"])):
                        feas_observer.record(traj["crystal_fea"][step])
            total += n_steps
            if verbose:
                print(
                    f"{self.optimizer_class} step {total}: E = "
                    f"{np.array2string(traj['energy'][-1], precision=4)} eV, "
                    f"fmax = {np.array2string(traj['fmax'][-1], precision=4)}"
                )
            if bool(state.converged.all()):
                break
            # async rebuild: launched in the background at 40% skin drift;
            # stepping blocks only when the Verlet budget is spent
            runtime.step_rebuild(state.frac.cpu().numpy(), state.lat.cpu().numpy())

        final_structures = runtime.structures(state.frac, state.lat)
        if assign_magmoms:
            final = self.model.predict_structure(final_structures, task="efsm")
            if isinstance(final, dict):  # predict returns a dict for one graph
                final = [final]
            for idx, struct in enumerate(final_structures):
                struct.site_properties["magmom"] = list(
                    np.asarray(final[idx]["m"], dtype=float)
                )

        if feas_observer is not None:
            feas_observer.save(crystal_feas_save_path)

        results = []
        for idx, struct in enumerate(final_structures):
            if save_path is not None:
                suffix = "" if single else f".{idx}"
                observers[idx].save(f"{save_path}{suffix}")
            results.append(
                {
                    "final_structure": struct,
                    "trajectory": observers[idx],
                    "final_energy": float(last_energy[idx]),
                }
            )
        return results[0] if single else results

    @staticmethod
    def _record(observers, runtime, traj, step_offset, loginterval):
        n_steps = len(traj["energy"])
        for step in range(n_steps):
            if (step_offset + step) % (loginterval or 1):
                continue
            for gi, obs in enumerate(observers):
                lat = traj["lat"][step][gi]
                frac = runtime.unpad(traj["frac"][step], gi)
                obs.record(
                    energy=traj["energy"][step][gi],
                    forces=runtime.unpad(traj["forces"][step], gi),
                    stress=voigt_6(traj["stress"][step][gi]) * GPA_TO_EV_A3,
                    magmoms=runtime.unpad(traj["magmom"][step], gi),
                    positions=frac @ lat,
                    cell=lat,
                )
