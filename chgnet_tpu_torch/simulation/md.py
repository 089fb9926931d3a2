"""Molecular dynamics on the device: NVE / NVT / NPT ensembles.

Port of ``chgnet_tpu.simulation.md`` for one device. Upstream CHGNet drives
ASE integrators on the host with a fresh graph every step; here each
ensemble is a velocity-Verlet step over a padded batch with a skin-reused
topology (:class:`GraphRuntime`), so several structures can run MD in
lockstep on one card. ``chgnet_tpu`` runs a chunk of steps as one
``lax.scan``; here a chunk is a Python loop over steps whose state stays on
the device, whose per-step outputs are stacked there and read back once
per chunk, and which builds no autograd graph across steps. Supported
(upstream's ensemble/thermostat matrix):

* ``nve``                -- velocity Verlet
* ``nvt``  + Berendsen / Nose-Hoover
* ``npt``  + Berendsen (isotropic) / Berendsen_inhomogeneous (per-axis) /
  Nose-Hoover (isotropic MTK) / Nose-Hoover-full a.k.a. Parrinello-Rahman
  (anisotropic full-cell MTK: shear relaxes too).

Units: fs, eV, Angstrom, amu, K, GPa (see ``simulation/units.py``).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.models.chgnet import CHGNetConfig
from chgnet_tpu_torch.simulation import units
from chgnet_tpu_torch.simulation.calculator import resolve_model, voigt_6
from chgnet_tpu_torch.simulation.observers import (
    CrystalFeasObserver,
    TrajectoryObserver,
)
from chgnet_tpu_torch.simulation.runtime import (
    GraphRuntime,
    compute_batch_dynamic,
    graph_sum,
)


class MDState(NamedTuple):
    """Batched MD integration state (tensors on one device)."""

    frac: torch.Tensor  # [N, 3]
    lat: torch.Tensor  # [B, 3, 3]
    vel: torch.Tensor  # [N, 3] A/fs
    accel: torch.Tensor  # [N, 3] A/fs^2 at current positions
    epot: torch.Tensor  # [B] total potential energy, eV
    stress: torch.Tensor  # [B, 3, 3] potential stress, GPa
    zeta: torch.Tensor  # [B] Nose-Hoover thermostat variable, 1/fs
    eps_dot: torch.Tensor  # [B] isotropic barostat strain rate, 1/fs (MTK)
    cell_rate: torch.Tensor  # [B, 3, 3] full-cell barostat strain-rate
    # matrix (symmetric, 1/fs) for the anisotropic Parrinello-Rahman NPT


class MDParams(NamedTuple):
    """MD parameters as 0-d f32 tensors on the state's device."""

    dt: torch.Tensor  # fs
    temperature: torch.Tensor  # K
    taut: torch.Tensor  # fs
    taup: torch.Tensor  # fs
    pressure: torch.Tensor  # GPa
    compressibility: torch.Tensor  # 1/GPa


def kinetic_energy(
    vel: torch.Tensor, masses: torch.Tensor, owner: torch.Tensor, n_graphs: int
) -> torch.Tensor:
    """Per-graph kinetic energy [B] in eV (vel A/fs, masses amu)."""
    ke_atom = 0.5 * masses * (vel**2).sum(dim=1) * units.AMU_A2_FS2_TO_EV
    out = torch.zeros(n_graphs, dtype=ke_atom.dtype, device=ke_atom.device)
    return out.index_add_(0, owner.long(), ke_atom)


def inverse_3x3(lat: torch.Tensor) -> torch.Tensor:
    """Inverses of a batch of 3x3 matrices, with no host sync (the error
    check of ``torch.linalg.inv`` waits for the device)."""
    return torch.linalg.inv_ex(lat).inverse


def _trace(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=1, dim2=2).sum(dim=-1)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (``jnp.cbrt``): ``pow(x, 1/3)`` is NaN for x < 0."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def make_md_step(
    *,
    md: MDParams,
    masses: torch.Tensor,  # [N] amu (padding: 1)
    dof: torch.Tensor,  # [B]
    owner: torch.Tensor,  # [N] graph ids (sorted)
    atom_mask: torch.Tensor,  # [N, 1]
    ensemble: str,
    thermostat: str,
    record: bool,
    evaluate,  # (frac [N,3], lat [B,3,3]) -> (epot [B] eV, accel, out)
    seg_sum,  # per-atom [N, ...] -> per-graph [B, ...] sum over owner
):
    """Build one velocity-Verlet MD step ``state -> (state, ys)``.

    All ensemble/thermostat/barostat maths lives here, parameterised by
    the force engine (``evaluate``) and the atom -> graph reduction
    (``seg_sum``), as in ``chgnet_tpu``. The step reads nothing back to the
    host; run it under ``torch.no_grad()``.
    """
    thermo = thermostat.lower()
    owner = owner.long()
    # NVE is plain velocity Verlet: the thermostat argument is inert there
    nose_hoover = ensemble in ("nvt", "npt") and (
        thermo.startswith("nose") or thermo.startswith("parrinello")
    )
    # anisotropic Parrinello-Rahman cell dynamics (upstream's NPT with the
    # full upper-triangular cell free)
    full_cell = nose_hoover and ("full" in thermo or thermo.startswith("parrinello"))
    # Nose-Hoover mass Q = dof * kB * T0 * taut^2  [eV fs^2]
    q_nh = dof * units.KB * md.temperature * md.taut**2
    # whether evaluate() carries the strain branch (see md_chunk)
    need_stress = ensemble == "npt" or record

    def kinetic(vel):
        return seg_sum(0.5 * masses * (vel**2).sum(dim=1) * units.AMU_A2_FS2_TO_EV)

    def total_pressure(state, ke):
        """Instantaneous pressure [B] in GPa incl. the ideal-gas term."""
        volume = torch.abs(torch.linalg.det(state.lat))
        p_pot = -_trace(state.stress) / 3.0
        p_kin = 2.0 * ke / (3.0 * volume) * units.EV_A3_TO_GPA
        return p_pot + p_kin

    def rescale_cell(state, eta):
        """Scale lattices (and positions implicitly, via frac) by eta [B,3]."""
        return state._replace(lat=state.lat * eta[:, :, None])  # row i by eta_i

    def temperature(ke):
        return 2.0 * ke / torch.clamp(dof * units.KB, min=1e-30)

    def step(state: MDState):
        dt = md.dt
        vel = state.vel

        # --- thermostat pre-step
        if nose_hoover:
            vel = vel + 0.5 * dt * (state.accel - state.zeta[owner][:, None] * vel)
        else:
            vel = vel + 0.5 * dt * state.accel

        # --- drift
        cart = torch.einsum("ni,nij->nj", state.frac, state.lat[owner])
        cart = cart + dt * vel
        frac = torch.einsum("ni,nij->nj", cart, inverse_3x3(state.lat)[owner])

        epot, accel, out = evaluate(frac, state.lat)

        # --- kick 2
        if nose_hoover:
            ke_half = kinetic(vel)
            zeta = state.zeta + dt * (
                2.0 * ke_half - dof * units.KB * md.temperature
            ) / torch.clamp(q_nh, min=1e-30)
            vel = (vel + 0.5 * dt * accel) / (1.0 + 0.5 * dt * zeta[owner][:, None])
        else:
            zeta = state.zeta
            vel = vel + 0.5 * dt * accel

        state = MDState(
            frac=frac,
            lat=state.lat,
            vel=vel * atom_mask,
            accel=accel,
            epot=epot,
            # without the strain branch the priming-time stress would ride
            # along forever: carry zeros rather than a stale value
            stress=out["s"] if need_stress else torch.zeros_like(state.stress),
            zeta=zeta,
            eps_dot=state.eps_dot,
            cell_rate=state.cell_rate,
        )

        # --- Berendsen velocity rescale (nvt/npt with Berendsen thermostat)
        ke = kinetic(state.vel)
        temp = temperature(ke)
        if ensemble in {"nvt", "npt"} and not nose_hoover:
            lam2 = 1.0 + dt / md.taut * (
                md.temperature / torch.clamp(temp, min=1e-10) - 1.0
            )
            lam = torch.sqrt(torch.clamp(lam2, 0.81, 1.21))
            state = state._replace(vel=state.vel * lam[owner][:, None])
            ke = kinetic(state.vel)
            temp = temperature(ke)

        # --- barostat (npt)
        if ensemble == "npt" and full_cell:
            # Full-cell (anisotropic) Nose-Hoover-Parrinello-Rahman / MTK
            # barostat: the cell strain rate is a symmetric 3x3 matrix G
            # driven by the full internal stress tensor, so shear relaxes too.
            #   dG/dt = V (P_int - P0 I) / W + (2 KE / Nf) I / W
            #   cell:  h <- h (I + dt G)        (row-vector lattice)
            #   vel:   v <- v - dt (G + tr(G)/Nf I) v
            volume = torch.abs(torch.linalg.det(state.lat))
            eye3 = torch.eye(3, dtype=state.lat.dtype, device=state.lat.device)
            # kinetic stress sum(m v v^T) / V, eV/A^3
            kin_outer = seg_sum(
                masses[:, None, None] * state.vel[:, :, None] * state.vel[:, None, :]
            ) * units.AMU_A2_FS2_TO_EV / volume[:, None, None]
            # state.stress is +dE/dstrain/V (GPa): the NEGATIVE of the
            # internal pressure tensor
            p_int = -state.stress * units.GPA_TO_EV_A3 + kin_outer
            p_int = 0.5 * (p_int + p_int.transpose(1, 2))
            w_baro = (dof + 3.0) * units.KB * md.temperature * md.taup**2
            drive = volume[:, None, None] * (
                p_int - md.pressure * units.GPA_TO_EV_A3 * eye3
            ) + (2.0 * ke / torch.clamp(dof, min=1.0))[:, None, None] * eye3
            cell_rate = state.cell_rate + dt * drive / torch.clamp(
                w_baro, min=1e-30
            )[:, None, None]
            # bound the per-step deformation for stability
            cell_rate = torch.clamp(cell_rate, -0.02 / dt, 0.02 / dt)
            drag = cell_rate + (
                _trace(cell_rate) / torch.clamp(dof, min=1.0)
            )[:, None, None] * eye3
            vel_new = state.vel - dt * torch.einsum(
                "nij,nj->ni", drag[owner], state.vel
            )
            lat_new = torch.einsum(
                "bij,bjk->bik", state.lat, eye3[None] + dt * cell_rate
            )
            state = state._replace(
                cell_rate=cell_rate, vel=vel_new * atom_mask, lat=lat_new
            )
            ke = kinetic(state.vel)
            temp = temperature(ke)
        elif ensemble == "npt" and nose_hoover:
            # MTK-style isotropic Nose-Hoover-Parrinello-Rahman barostat:
            # d(eps_dot)/dt = 3 V (P - P0) / W, W = (dof + 3) kB T0 taup^2
            volume = torch.abs(torch.linalg.det(state.lat))
            p_inst = total_pressure(state, ke)
            w_baro = (dof + 3.0) * units.KB * md.temperature * md.taup**2
            eps_dot = state.eps_dot + dt * 3.0 * volume * (
                (p_inst - md.pressure) * units.GPA_TO_EV_A3
            ) / torch.clamp(w_baro, min=1e-30)
            eta_iso = torch.exp(torch.clamp(eps_dot * dt, -0.02, 0.02))
            state = state._replace(
                eps_dot=eps_dot,
                vel=state.vel * torch.exp(
                    -(1.0 + 3.0 / torch.clamp(dof, min=1.0)) * eps_dot * dt
                )[owner][:, None],
            )
            state = rescale_cell(state, eta_iso[:, None].expand(-1, 3))
            ke = kinetic(state.vel)
            temp = temperature(ke)
        elif ensemble == "npt":
            if thermo.endswith("inhomogeneous"):
                # per-axis coupling to the diagonal stress components
                volume = torch.abs(torch.linalg.det(state.lat))
                sigma_kin = (
                    seg_sum(masses[:, None] * state.vel**2)
                    * units.AMU_A2_FS2_TO_EV
                    / volume[:, None]
                    * units.EV_A3_TO_GPA
                )  # [B, 3] ideal-gas diagonal, GPa
                p_axis = -torch.diagonal(state.stress, dim1=1, dim2=2) + sigma_kin
                eta = 1.0 + dt / md.taup * (md.compressibility / 3.0) * (
                    p_axis - md.pressure
                )
            else:
                p_inst = total_pressure(state, ke)
                eta3 = 1.0 + dt / md.taup * md.compressibility * (
                    p_inst - md.pressure
                )
                eta = _cbrt(eta3)[:, None].expand(-1, 3)
            state = rescale_cell(state, torch.clamp(eta, 0.98, 1.02))

        ys = {
            "epot": state.epot,
            "ekin": ke,
            "temperature": temp,
            "stress": state.stress,
        }
        if record:
            ys.update(
                forces=state.accel * masses[:, None] * units.AMU_A2_FS2_TO_EV,
                magmom=out["m"],
                crystal_fea=out["crystal_fea"],
                frac=state.frac,
                lat=state.lat,
            )
        return state, ys

    return step


def md_chunk(
    params,
    batch,
    state: MDState,
    md: MDParams,
    masses: torch.Tensor,  # [N] amu (padding: 1)
    dof: torch.Tensor,  # [B] degrees of freedom (3 n_atoms)
    *,
    config: CHGNetConfig,
    ensemble: str,
    thermostat: str,
    n_steps: int,
    record: bool,
) -> tuple[MDState, dict[str, torch.Tensor]]:
    """Run ``n_steps`` fixed-topology MD steps on the batch's device.
    Returns the new state and the per-step outputs stacked on the device
    (``[n_steps, ...]`` each)."""
    owner = batch.atom_owner
    atom_mask = batch.atom_mask[:, None]
    # stress (the strain branch of the force pass) only feeds the barostats
    # and recording observers; NVE/NVT without observers skip it (the
    # per-step ys["stress"] is zeros there)
    need_stress = ensemble == "npt" or record

    def evaluate(frac, lat):
        out = compute_batch_dynamic(
            params,
            batch._replace(frac_coords=frac, lattices=lat),
            config=config,
            compute_stress=need_stress,
            compute_magmom=record,
        )
        n_atoms = torch.clamp(out["atoms_per_graph"], min=1.0)
        epot = out["e"] * (n_atoms if config.is_intensive else 1.0)
        accel = out["f"] * atom_mask / masses[:, None] * units.EV_PER_AMU_A_TO_A_FS2
        return epot, accel, out

    step = make_md_step(
        md=md,
        masses=masses,
        dof=dof,
        owner=owner,
        atom_mask=atom_mask,
        ensemble=ensemble,
        thermostat=thermostat,
        record=record,
        evaluate=evaluate,
        seg_sum=lambda x: graph_sum(x, batch.plan_graph),
    )
    trace = []
    with torch.no_grad():
        for _ in range(n_steps):
            state, ys = step(state)
            trace.append(ys)
    return state, {k: torch.stack([ys[k] for ys in trace]) for k in trace[0]}


def maxwell_boltzmann_velocities(
    masses: np.ndarray,
    temperature: float,
    *,
    seed: int | None = None,
    force_temp: bool = True,
    stationary: bool = True,
) -> np.ndarray:
    """Velocities [n, 3] in A/fs from the Maxwell-Boltzmann distribution
    (numpy ``default_rng``: the same draws as ``chgnet_tpu``'s)."""
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(units.KB * temperature / (masses * units.AMU_A2_FS2_TO_EV))
    vel = rng.normal(size=(len(masses), 3)) * sigma[:, None]
    if stationary:
        vel -= (masses[:, None] * vel).sum(axis=0) / masses.sum()
    if force_temp and temperature > 0:
        ke = 0.5 * (masses[:, None] * vel**2).sum() * units.AMU_A2_FS2_TO_EV
        target = 1.5 * len(masses) * units.KB * temperature
        vel *= np.sqrt(target / max(ke, 1e-30))
    return vel


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


class MolecularDynamics:
    """Molecular dynamics over one Structure, or several in lockstep.

    Upstream CHGNet's constructor arguments: ensemble nve/nvt/npt,
    thermostat Berendsen / Berendsen_inhomogeneous / Nose-Hoover,
    temperature [K], timestep [fs], pressure [GPa], taut/taup time
    constants [fs], bulk_modulus [GPa] (fitted by EOS for NPT when not
    given, 2 GPa if the fit fails), logfile + loginterval, trajectory and
    crystal-feature capture. It runs on the model's device; ``use_device``
    naming another raises. ``mesh`` (graph-partitioned MD over several
    devices) is not ported yet (ROADMAP.md Queue 1 item 9), nor are
    ``halo`` and ``lean``.
    """

    def __init__(
        self,
        atoms: Structure | list[Structure],
        *,
        model=None,
        ensemble: str = "nvt",
        thermostat: str = "Berendsen_inhomogeneous",
        temperature: float = 300.0,
        starting_temperature: float | None = None,
        timestep: float = 2.0,
        pressure: float = units.ATM_IN_GPA,
        taut: float | None = None,
        taup: float | None = None,
        bulk_modulus: float | None = None,
        trajectory: str | None = None,
        logfile: str | None = None,
        loginterval: int = 1,
        crystal_feas_logfile: str | None = None,
        on_isolated_atoms: str = "warn",
        use_device: str | None = None,
        seed: int | None = None,
        skin: float = 0.3,
        chunk_size: int = 10,
        mesh: int | None = None,
        halo: bool = False,
        lean: bool | None = None,
    ) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (graph-partitioned MD over several devices) is not "
                "ported to chgnet_tpu_torch yet (ROADMAP.md Queue 1 item 9)"
            )
        self.model = model = resolve_model(model, use_device)
        self.ensemble = ensemble.lower()
        self.thermostat = thermostat
        if self.ensemble not in {"nve", "nvt", "npt"}:
            raise ValueError(f"Ensemble not supported: {ensemble}")

        single = isinstance(atoms, Structure)
        self.structures = [atoms] if single else list(atoms)
        self._single = single
        self.temperature = float(temperature)
        self.timestep = float(timestep)
        self.pressure = float(pressure)
        self.taut = float(taut if taut is not None else 100 * timestep)
        self.taup = float(taup if taup is not None else 1000 * timestep)
        self.loginterval = int(loginterval)
        self.chunk_size = int(chunk_size)
        # drift fraction of the skin at which a background topology rebuild
        # is launched (the chunk keeps running on the old, still valid
        # topology while the host builds)
        self._rebuild_trigger = 0.4
        self._n_steps_done = 0

        if bulk_modulus is None and self.ensemble == "npt":
            bulk_modulus = self._auto_bulk_modulus()
        self.bulk_modulus = bulk_modulus
        compressibility = 1.0 / bulk_modulus if bulk_modulus else 0.0

        self.runtime = GraphRuntime(
            model.config,
            self.structures,
            skin=skin,
            on_isolated_atoms=on_isolated_atoms,
            device=model.device,
            halo=halo,
            lean=lean,
        )
        batch = self.runtime.batch
        dev = model.device
        n_state = batch.atomic_numbers.shape[0]
        masses = np.ones(n_state)
        vel = np.zeros((n_state, 3))
        for idx, struct in enumerate(self.structures):
            sl = slice(self.runtime.offsets[idx], self.runtime.offsets[idx + 1])
            masses[sl] = struct.masses
            if starting_temperature is not None:
                vel[sl] = maxwell_boltzmann_velocities(
                    struct.masses,
                    starting_temperature,
                    seed=None if seed is None else seed + idx,
                )
        self.masses = _f32(masses, dev)
        self.dof = _f32([3.0 * len(s) for s in self.structures], dev)
        self.md_params = MDParams(
            *(_f32(v, dev) for v in (
                self.timestep, self.temperature, self.taut, self.taup,
                self.pressure, compressibility,
            ))
        )
        n_graphs = len(self.structures)

        # prime accel/epot/stress with one evaluation
        epot0, accel0, stress0 = self._evaluate_full(batch.frac_coords, batch.lattices)
        self.state = MDState(
            frac=batch.frac_coords,
            lat=batch.lattices,
            vel=_f32(vel, dev),
            accel=accel0,
            epot=epot0,
            stress=stress0,
            zeta=torch.zeros(n_graphs, device=dev),
            eps_dot=torch.zeros(n_graphs, device=dev),
            cell_rate=torch.zeros((n_graphs, 3, 3), device=dev),
        )

        self.observers: list[TrajectoryObserver] | None = None
        self._trajectory_path = trajectory
        if trajectory is not None:
            self.observers = [
                TrajectoryObserver(atomic_numbers=s.atomic_numbers)
                for s in self.structures
            ]
        self.crystal_feas_observer = (
            CrystalFeasObserver() if crystal_feas_logfile else None
        )
        self._crystal_feas_logfile = crystal_feas_logfile
        self._logfile = logfile
        if logfile:
            with open(logfile, "w") as file:
                file.write(
                    "Time[ps]      Etot[eV]     Epot[eV]     Ekin[eV]    T[K]\n"
                )

    def _evaluate_full(self, frac, lat):
        """(epot [B] eV, accel [N, 3], stress [B, 3, 3] GPa) at the given
        positions."""
        cfg = self.model.config
        batch = self.runtime.batch
        out = compute_batch_dynamic(
            self.model.params,
            batch._replace(frac_coords=frac, lattices=lat),
            config=cfg,
            compute_magmom=False,
        )
        n_atoms = torch.clamp(out["atoms_per_graph"], min=1.0)
        epot = out["e"] * (n_atoms if cfg.is_intensive else 1.0)
        accel = (
            out["f"] * batch.atom_mask[:, None] / self.masses[:, None]
            * units.EV_PER_AMU_A_TO_A_FS2
        )
        return epot, accel, out["s"]

    def _auto_bulk_modulus(self) -> float:
        """Bulk modulus by an EOS fit, 2 GPa if the fit fails (upstream's
        behaviour)."""
        from chgnet_tpu_torch.simulation.eos import EquationOfState

        try:
            eos = EquationOfState(model=self.model)
            eos.fit(self.structures[0], steps=500, fmax=0.1)
            bulk = eos.get_bulk_modulus(unit="GPa")
            print(f"Bulk modulus of fitted material = {bulk:.3f} GPa")
            return float(bulk)
        except Exception:
            warnings.warn(
                "Warning!!! Equation of State fitting failed, setting bulk "
                "modulus to 2 GPa. NPT simulation can proceed with incorrect "
                "pressure relaxation time."
            )
            return 2.0

    # -------------------------------------------------------------------- run
    def _safe_steps(self, drift_fraction: float) -> int:
        """Upper bound on steps before two atoms could close the skin shell,
        from the current max atomic speed (with a 1.5x margin for
        acceleration during the chunk). Keeps long chunks from overrunning
        the Verlet budget mid-chunk."""
        vmax = float(self.state.vel.abs().max()) * np.sqrt(3.0)
        budget = max(1.0 - drift_fraction, 0.0) * self.runtime.skin
        per_step = 2.0 * vmax * self.timestep * 1.5
        if per_step <= 0.0:
            return self.chunk_size
        return max(int(budget / per_step), 1)

    def run(self, steps: int = 50) -> None:
        """Advance the dynamics by ``steps`` timesteps."""
        record = self.observers is not None or self.crystal_feas_observer is not None
        done = 0
        drift = self.runtime.drift_fraction(self.state.frac, self.state.lat)
        while done < steps:
            n_steps = min(self.chunk_size, steps - done, self._safe_steps(drift))
            if n_steps < min(self.chunk_size, steps - done):
                # round down to a power of two, as chgnet_tpu buckets its
                # adaptive scan lengths: the chunk boundaries, and so the
                # rebuild checks, fall where chgnet_tpu's do
                n_steps = 1 << (n_steps.bit_length() - 1)
            self.state, ys = md_chunk(
                self.model.params,
                self.runtime.batch,
                self.state,
                self.md_params,
                self.masses,
                self.dof,
                config=self.model.config,
                ensemble=self.ensemble,
                thermostat=self.thermostat,
                n_steps=n_steps,
                record=record,
            )
            ys = {k: v.cpu().numpy() for k, v in ys.items()}
            self._log_chunk(ys, n_steps)
            done += n_steps
            self._n_steps_done += n_steps
            # async-rebuild policy (GraphRuntime.step_rebuild): a background
            # build launched at the trigger hides the host build; stepping
            # blocks only when the Verlet budget is spent
            drift = self.runtime.step_rebuild(
                self.state.frac.cpu().numpy(),
                self.state.lat.cpu().numpy(),
                trigger=self._rebuild_trigger,
            )
        if self.observers is not None and self._trajectory_path:
            for idx, obs in enumerate(self.observers):
                suffix = "" if self._single else f".{idx}"
                obs.save(f"{self._trajectory_path}{suffix}")
        if self.crystal_feas_observer and self._crystal_feas_logfile:
            self.crystal_feas_observer.save(self._crystal_feas_logfile)

    # -------------------------------------------------------------- logging
    def _log_chunk(self, ys: dict, n_steps: int) -> None:
        for step in range(n_steps):
            global_step = self._n_steps_done + step + 1
            if global_step % self.loginterval:
                continue
            if self._logfile:
                with open(self._logfile, "a") as file:
                    for gi in range(len(self.structures)):
                        epot = ys["epot"][step][gi]
                        ekin = ys["ekin"][step][gi]
                        temp = ys["temperature"][step][gi]
                        time_ps = global_step * self.timestep / 1000.0
                        file.write(
                            f"{time_ps:<10.4f} {epot + ekin:12.4f} "
                            f"{epot:12.4f} {ekin:12.4f} {temp:6.1f}\n"
                        )
            if self.observers is not None:
                for gi, obs in enumerate(self.observers):
                    lat = ys["lat"][step][gi]
                    frac = self.runtime.unpad(ys["frac"][step], gi)
                    obs.record(
                        energy=ys["epot"][step][gi],
                        forces=self.runtime.unpad(ys["forces"][step], gi),
                        stress=voigt_6(ys["stress"][step][gi]) * units.GPA_TO_EV_A3,
                        magmoms=self.runtime.unpad(ys["magmom"][step], gi),
                        positions=frac @ lat,
                        cell=lat,
                    )
            if self.crystal_feas_observer is not None:
                self.crystal_feas_observer.record(ys["crystal_fea"][step])

    # ------------------------------------------------------------ accessors
    @property
    def atoms(self) -> Structure | list[Structure]:
        """Current structure(s) from the device state."""
        structs = self.runtime.structures(self.state.frac, self.state.lat)
        return structs[0] if self._single else structs

    def get_temperature(self) -> float | np.ndarray:
        ke = kinetic_energy(
            self.state.vel,
            self.masses,
            self.runtime.batch.atom_owner,
            len(self.structures),
        )
        temp = (2.0 * ke / (self.dof * units.KB)).cpu().numpy()
        return float(temp[0]) if self._single else temp

    def upper_triangular_cell(self, *, verbose: bool | None = False) -> None:
        """Re-express every cell in an upper-triangular basis.

        Upstream's ASE Nose-Hoover NPT requires an upper-triangular cell.
        The integrators here take general cells, so this is a rigid
        re-expression: the new basis has the same cell parameters (an
        orthogonal map M relates the bases), fractional coordinates are
        unchanged, and velocities rotate with M.
        """
        lats = self.state.lat.cpu().numpy().astype(np.float64)
        new_lats = np.empty_like(lats)
        rotate = np.empty_like(lats)
        changed = False
        for idx, lat in enumerate(lats):
            if np.allclose(lat[np.tril_indices(3, -1)], 0.0, atol=1e-12):
                new_lats[idx] = lat
                rotate[idx] = np.eye(3)
                continue
            changed = True
            lengths = np.linalg.norm(lat, axis=1)
            a, b, c = lengths
            cos_a = lat[1] @ lat[2] / (b * c)  # alpha: angle(b, c)
            cos_b = lat[0] @ lat[2] / (a * c)
            cos_g = lat[0] @ lat[1] / (a * b)
            sin_a = np.sqrt(1.0 - cos_a**2)
            sin_b = np.sqrt(1.0 - cos_b**2)
            cos_p = np.clip((cos_g - cos_a * cos_b) / (sin_a * sin_b), -1.0, 1.0)
            sin_p = np.sqrt(1.0 - cos_p**2)
            new_lats[idx] = np.array(
                [
                    (a * sin_b * sin_p, a * sin_b * cos_p, a * cos_b),
                    (0.0, b * sin_a, b * cos_a),
                    (0.0, 0.0, c),
                ]
            )
            # cart_new = cart_old @ M with M = lat^-1 @ new_lat orthogonal
            rotate[idx] = np.linalg.solve(lat, new_lats[idx])
        if not changed:
            return
        dev = self.model.device
        owner = self.runtime.batch.atom_owner.cpu().numpy()
        vel = torch.einsum("ni,nij->nj", self.state.vel, _f32(rotate[owner], dev))
        self.state = self.state._replace(lat=_f32(new_lats, dev), vel=vel)
        # refresh the skin topology's reference frame and derived state
        self.runtime.rebuild(self.state.frac, self.state.lat)
        epot, accel, stress = self._evaluate_full(self.state.frac, self.state.lat)
        self.state = self.state._replace(accel=accel, epot=epot, stress=stress)
        if verbose:
            print("Transformed to upper triangular unit cell.", flush=True)

    def set_atoms(self, atoms: Structure | list[Structure]) -> None:
        """Replace the structures (new topology, velocities kept)."""
        structures = [atoms] if isinstance(atoms, Structure) else list(atoms)
        if [len(s) for s in structures] != self.runtime.sizes:
            raise ValueError("set_atoms requires matching atom counts")
        self.runtime.rebuild(
            np.concatenate([s.frac_coords for s in structures]),
            np.stack([s.lattice.matrix for s in structures]),
        )
        batch = self.runtime.batch
        self.state = self.state._replace(frac=batch.frac_coords, lat=batch.lattices)
