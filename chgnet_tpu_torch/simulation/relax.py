"""Batched structure relaxation on the device: FIRE, MDMin, LBFGS, BFGS,
their line-search forms, and SciPy's CG and BFGS on the host.

Port of ``chgnet_tpu.simulation.relax`` for one device. Upstream CHGNet loops
ASE's optimizers on the host and rebuilds the graph every step. Here:

* FIRE (Bitzek et al. 2006, ASE's parameters: dt0=0.1, dtmax=1.0, Nmin=5,
  finc=1.1, fdec=0.5, astart=0.1, fa=0.99, maxstep=0.2 A), MDMin, L-BFGS
  and dense-Hessian BFGS run in chunks of steps over a padded batch, the
  state on the device and the per-step outputs read back once per chunk;
* many structures relax in parallel, each with its own optimizer state and
  convergence flag (converged graphs freeze in place);
* cell relaxation follows the unit-cell-filter scheme: the degrees of
  freedom are (cartesian positions, cell_factor * strain), the strain
  gradient dE/d(eps) coming from the same backward pass as the forces;
* the line-search forms try the steps 1, 0.5 and 0.25 of the direction per
  graph (Armijo backtracking, energies only) and pick each graph's factor
  on the device;
* the topology is reused across steps by :class:`GraphRuntime` skin masks.

The SciPy relaxers minimise over float64 host DOF, one structure at a
time; each evaluation reads its energy and gradient back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.graph.batching import GraphBatch
from chgnet_tpu_torch.models.chgnet import CHGNetConfig, compute_batch
from chgnet_tpu_torch.simulation.calculator import resolve_model, voigt_6
from chgnet_tpu_torch.simulation.md import inverse_3x3
from chgnet_tpu_torch.simulation.observers import (
    CrystalFeasObserver,
    TrajectoryObserver,
)
from chgnet_tpu_torch.simulation.runtime import (
    GraphRuntime,
    _host,
    apply_dynamic_cutoff,
    compute_batch_dynamic,
    graph_sum,
)
from chgnet_tpu_torch.simulation.units import GPA_TO_EV_A3

# the optimizers StructOptimizer takes (those of chgnet_tpu's)
SUPPORTED = {
    "FIRE", "LBFGS", "LBFGSLineSearch", "MDMin", "BFGS", "BFGSLineSearch",
    "SciPyFminCG", "SciPyFminBFGS",
}
ARMIJO_C1 = 1e-4  # sufficient-decrease constant of the line searches
LINE_SEARCH_TRIALS = (1.0, 0.5, 0.25)  # step factors, largest first


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


def _init_state(
    batch: GraphBatch, fire: FIRE, n_state: int | None = None, device=None
) -> FireState:
    """The state at the batch's positions, on ``device`` (the batch's);
    ``n_state`` extends the per-atom leaves past the padded batch with a
    zero tail (the mesh's global block layout)."""
    n_graphs = batch.lattices.shape[0]
    dev = batch.frac_coords.device if device is None else device
    frac = torch.as_tensor(batch.frac_coords, device=dev)
    if n_state is not None and n_state > frac.shape[0]:
        frac = torch.cat([frac, frac.new_zeros((n_state - frac.shape[0], 3))])

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return FireState(
        frac=frac,
        lat=torch.as_tensor(batch.lattices, device=dev),
        vel=full((frac.shape[0], 3), 0.0),
        vel_cell=full((n_graphs, 3, 3), 0.0),
        dt=full((n_graphs,), fire.dt0),
        alpha=full((n_graphs,), fire.alpha_start),
        n_pos=full((n_graphs,), 0, torch.int32),
        converged=full((n_graphs,), False, torch.bool),
    )


def _fold(frac, lat, owner, dr, d_strain):
    """Positions and cells after a step: ``lat' = lat @ (I + de)``,
    ``cart' = (cart + dr) @ (I + de)``, back to fractional coordinates."""
    eye3 = torch.eye(3, dtype=lat.dtype, device=lat.device)
    deform = eye3[None] + d_strain
    lat_new = torch.einsum("bij,bjk->bik", lat, deform)
    cart = torch.einsum("ni,nij->nj", frac, lat[owner]) + dr
    cart = torch.einsum("ni,nij->nj", cart, deform[owner])
    return torch.einsum("ni,nij->nj", cart, inverse_3x3(lat_new)[owner]), lat_new


def _seg_max(owner: torch.Tensor, n_graphs: int):
    """Per-atom [N] -> per-graph [B] maximum (padded atoms masked
    upstream)."""

    def seg_max(per_atom):
        out = torch.zeros(n_graphs, dtype=per_atom.dtype, device=per_atom.device)
        return out.scatter_reduce(0, owner, per_atom, "amax", include_self=False)

    return seg_max


def _make_evaluate(params, batch: GraphBatch, *, config, relax_cell: bool, record: bool):
    """``(frac, lat) -> (e_total [B], forces [N, 3], virial [B, 3, 3], out)``
    at the batch's topology: total energies, masked forces and the
    symmetrised virial dE/d(strain) in eV (zero unless the cell relaxes or
    the step is recorded)."""
    n_graphs = batch.lattices.shape[0]
    atom_mask = batch.atom_mask[:, None]

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

    return evaluate


def _line_search(params, batch: GraphBatch, config, apply_step, e_total, g_dot_d):
    """Per-graph Armijo backtracking on the device: the largest factor of
    ``LINE_SEARCH_TRIALS`` whose energy satisfies ``E(a) <= E0 + c1 a g.d``,
    else the smallest. ``apply_step(alpha [B]) -> (frac, lat)``."""
    n_graphs = e_total.shape[0]
    dev = e_total.device
    alpha_sel = torch.full((n_graphs,), LINE_SEARCH_TRIALS[-1], dtype=e_total.dtype, device=dev)
    accepted = torch.zeros((n_graphs,), dtype=torch.bool, device=dev)
    for trial in LINE_SEARCH_TRIALS:
        frac_t, lat_t = apply_step(
            torch.full((n_graphs,), trial, dtype=e_total.dtype, device=dev)
        )
        # the energy alone, the dynamic masks first (chgnet_tpu's
        # compute_batch_dynamic, whose unused forces its compiler prunes)
        out_t = compute_batch(
            params,
            apply_dynamic_cutoff(batch._replace(frac_coords=frac_t, lattices=lat_t), config),
            config=config,
        )
        n_at = torch.clamp(out_t["atoms_per_graph"], min=1.0)
        e_t = out_t["e"] * (n_at if config.is_intensive else 1.0)
        ok = (~accepted) & (e_t <= e_total + ARMIJO_C1 * trial * g_dot_d)
        alpha_sel = torch.where(ok, trial, alpha_sel)
        accepted = accepted | ok
    return alpha_sel


def _record_ys(ys: dict, record: bool, forces, out, frac, lat) -> dict:
    """The per-step outputs: energy and fmax, and what the observers
    record when ``record``."""
    if record:
        ys.update(
            forces=forces,
            stress=out["s"],
            magmom=out["m"],
            crystal_fea=out["crystal_fea"],
            frac=frac,
            lat=lat,
        )
    return ys


def _run_chunk(step, state, n_steps: int):
    """``n_steps`` of ``step`` under ``no_grad``; the per-step outputs
    stacked on the device."""
    trace = []
    with torch.no_grad():
        for _ in range(n_steps):
            state, ys = step(state)
            trace.append(ys)
    return state, {k: torch.stack([ys[k] for ys in trace]) for k in trace[0]}


def _cell_forces(virial, cell_factor, relax_cell: bool):
    """Forces on the scaled-strain DOF, zero with the cell fixed."""
    if relax_cell:
        return -virial / cell_factor[:, None, None]
    return torch.zeros_like(virial)


def _fmax(forces, cell_forces, atom_mask, seg_max, relax_cell: bool):
    """Per-graph largest force row norm, over atoms and the cell's
    pseudo-atoms."""
    fmax2 = seg_max(torch.where(atom_mask[:, 0] > 0, (forces**2).sum(dim=1), 0.0))
    if relax_cell:
        fmax2 = torch.maximum(fmax2, (cell_forces**2).sum(dim=2).amax(dim=1))
    return torch.sqrt(fmax2)


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
        cell_forces = _cell_forces(virial, cell_factor, relax_cell)
        fmax = _fmax(forces, cell_forces, atom_mask, seg_max, relax_cell)
        converged = state.converged | (fmax < fmax_target)
        f2_atom = (forces**2).sum(dim=1)

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

        frac_new, lat_new = _fold(state.frac, state.lat, owner, dr, d_strain)

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
        return new_state, _record_ys(ys, record, forces, out, state.frac, state.lat)

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
    owner = batch.atom_owner.long()
    step = make_fire_step(
        fire=fire,
        owner=owner,
        atom_mask=batch.atom_mask[:, None],
        fmax_target=fmax_target,
        cell_factor=cell_factor,
        relax_cell=relax_cell,
        record=record,
        method=method,
        evaluate=_make_evaluate(
            params, batch, config=config, relax_cell=relax_cell, record=record
        ),
        seg_sum=lambda x: graph_sum(x, batch.plan_graph),
        seg_max=_seg_max(owner, batch.lattices.shape[0]),
    )
    return _run_chunk(step, state, n_steps)


class LBFGS(NamedTuple):
    """LBFGS hyperparameters (ASE defaults: H0 = I/70, damping 1, maxstep
    0.2 A; ``memory`` pairs of history kept on the device)."""

    memory: int = 10
    alpha: float = 70.0
    damping: float = 1.0
    maxstep: float = 0.2


class LbfgsState(NamedTuple):
    """Batched LBFGS state: circular history of (s, y) pairs per graph."""

    frac: torch.Tensor  # [N, 3]
    lat: torch.Tensor  # [B, 3, 3]
    s_hist: torch.Tensor  # [M, N, 3]
    y_hist: torch.Tensor  # [M, N, 3]
    s_cell: torch.Tensor  # [M, B, 3, 3]
    y_cell: torch.Tensor  # [M, B, 3, 3]
    rho: torch.Tensor  # [M, B]
    prev_grad: torch.Tensor  # [N, 3]
    prev_grad_cell: torch.Tensor  # [B, 3, 3]
    prev_dr: torch.Tensor  # [N, 3]
    prev_dr_cell: torch.Tensor  # [B, 3, 3]
    n_hist: torch.Tensor  # [B] i32 pairs stored so far
    converged: torch.Tensor  # [B] bool


def _init_lbfgs_state(batch: GraphBatch, lbfgs: LBFGS) -> LbfgsState:
    """An empty history at the batch's positions, on the batch's device."""
    n_graphs = batch.lattices.shape[0]
    n_pad = batch.frac_coords.shape[0]
    mem = lbfgs.memory
    kw = dict(dtype=torch.float32, device=batch.frac_coords.device)
    return LbfgsState(
        frac=batch.frac_coords,
        lat=batch.lattices,
        s_hist=torch.zeros((mem, n_pad, 3), **kw),
        y_hist=torch.zeros((mem, n_pad, 3), **kw),
        s_cell=torch.zeros((mem, n_graphs, 3, 3), **kw),
        y_cell=torch.zeros((mem, n_graphs, 3, 3), **kw),
        rho=torch.zeros((mem, n_graphs), **kw),
        prev_grad=torch.zeros((n_pad, 3), **kw),
        prev_grad_cell=torch.zeros((n_graphs, 3, 3), **kw),
        prev_dr=torch.zeros((n_pad, 3), **kw),
        prev_dr_cell=torch.zeros((n_graphs, 3, 3), **kw),
        n_hist=torch.zeros((n_graphs,), dtype=torch.int32, device=kw["device"]),
        converged=torch.zeros((n_graphs,), dtype=torch.bool, device=kw["device"]),
    )


def _step_scale(dr_atoms, dr_cell, atom_mask, seg_max, maxstep: float, converged):
    """Per-graph factor that clips the longest per-atom (or cell) step to
    ``maxstep`` (ASE's ``determine_step``), zero for converged graphs."""
    step_len2 = (dr_atoms**2).sum(dim=1)
    longest2 = seg_max(torch.where(atom_mask[:, 0] > 0, step_len2, 0.0))
    longest2 = torch.maximum(longest2, (dr_cell**2).sum(dim=(1, 2)))
    longest = torch.sqrt(torch.clamp(longest2, min=1e-30))
    scale = torch.clamp(maxstep / longest, max=1.0)
    return scale * torch.where(converged, 0.0, 1.0)


def lbfgs_chunk(
    params,
    batch: GraphBatch,
    state: LbfgsState,
    *,
    config: CHGNetConfig,
    lbfgs: LBFGS,
    n_steps: int,
    fmax_target: float,
    cell_factor: torch.Tensor,  # [B]
    relax_cell: bool,
    record: bool,
    line_search: bool = False,
) -> tuple[LbfgsState, dict[str, torch.Tensor]]:
    """``n_steps`` of batched limited-memory BFGS over the (positions,
    scaled strain) DOF on the batch's device: a per-graph two-loop
    recursion over circular histories, in ``chgnet_tpu``'s order of sums
    (each slot read by its graph's index, unwritten slots at rho = 0).

    ``line_search`` adds the per-graph Armijo backtracking along the L-BFGS
    direction (upstream's ``LBFGSLineSearch``): three energy-only trial
    evaluations a step, the factor chosen on the device."""
    n_graphs = batch.lattices.shape[0]
    owner = batch.atom_owner.long()
    atom_mask = batch.atom_mask[:, None]
    mem = lbfgs.memory
    dev = batch.frac_coords.device
    rows = torch.arange(batch.frac_coords.shape[0], device=dev)
    graphs = torch.arange(n_graphs, device=dev)
    slots = torch.arange(mem, device=dev)
    evaluate = _make_evaluate(params, batch, config=config, relax_cell=relax_cell, record=record)
    seg_max = _seg_max(owner, n_graphs)

    def dot(a_atoms, a_cell, b_atoms, b_cell):
        """Per-graph inner product over the combined DOF -> [B]."""
        return graph_sum((a_atoms * b_atoms).sum(dim=1), batch.plan_graph) + (
            (a_cell * b_cell).sum(dim=(1, 2))
        )

    def step(state: LbfgsState):
        e_total, forces, virial, out = evaluate(state.frac, state.lat)
        cell_forces = _cell_forces(virial, cell_factor, relax_cell)
        grad, grad_cell = -forces, -cell_forces
        fmax = _fmax(forces, cell_forces, atom_mask, seg_max, relax_cell)
        converged = state.converged | (fmax < fmax_target)

        # push the previous (s, y) pair into each graph's slot
        have_prev = state.n_hist > 0
        y_new = grad - state.prev_grad
        y_cell_new = grad_cell - state.prev_grad_cell
        sy = dot(state.prev_dr, state.prev_dr_cell, y_new, y_cell_new)
        slot = torch.remainder(state.n_hist - 1, mem)  # [B]
        put = (slots[:, None] == slot[None, :]) & have_prev[None, :]  # [M, B]
        put_atoms = put[:, owner, None]  # [M, N, 1]
        put_cell = put[:, :, None, None]
        s_hist = torch.where(put_atoms, state.prev_dr[None], state.s_hist)
        y_hist = torch.where(put_atoms, y_new[None], state.y_hist)
        s_cell = torch.where(put_cell, state.prev_dr_cell[None], state.s_cell)
        y_cell = torch.where(put_cell, y_cell_new[None], state.y_cell)
        rho_new = torch.where(torch.abs(sy) > 1e-30, 1.0 / sy, 0.0)
        rho = torch.where(put, rho_new[None, :], state.rho)

        # two-loop recursion over a static M, newest pair first
        q, q_cell = grad, grad_cell
        pairs = []
        for i in range(mem):
            idx = torch.remainder(state.n_hist - 1 - i, mem)  # [B]
            idx_atoms = idx[owner]
            pair = (
                s_hist[idx_atoms, rows], y_hist[idx_atoms, rows],
                s_cell[idx, graphs], y_cell[idx, graphs], rho[idx, graphs],
            )
            s_i, y_i, sc_i, yc_i, rho_i = pair
            valid = ((i < state.n_hist) & ~converged).to(rho_i.dtype)
            a_i = rho_i * valid * dot(s_i, sc_i, q, q_cell)  # [B]
            q = q - a_i[owner][:, None] * y_i
            q_cell = q_cell - a_i[:, None, None] * yc_i
            pairs.append((a_i, pair))
        q = q / lbfgs.alpha
        q_cell = q_cell / lbfgs.alpha
        for a_i, (s_i, y_i, sc_i, yc_i, rho_i) in reversed(pairs):
            b_i = rho_i * dot(y_i, yc_i, q, q_cell)
            q = q + (a_i - b_i)[owner][:, None] * s_i
            q_cell = q_cell + (a_i - b_i)[:, None, None] * sc_i

        dr = -q * lbfgs.damping * atom_mask
        dr_cell = -q_cell * lbfgs.damping
        active = _step_scale(dr, dr_cell, atom_mask, seg_max, lbfgs.maxstep, converged)
        dr = dr * active[owner][:, None]
        dr_cell = dr_cell * active[:, None, None]

        def apply_step(alpha_b):
            d_strain = dr_cell * (alpha_b / cell_factor)[:, None, None]
            return _fold(state.frac, state.lat, owner, dr * alpha_b[owner][:, None], d_strain)

        if line_search:
            g_dot_d = dot(grad, grad_cell, dr, dr_cell)  # [B] (< 0)
            alpha_sel = _line_search(params, batch, config, apply_step, e_total, g_dot_d)
            frac_new, lat_new = apply_step(alpha_sel)
            dr = dr * alpha_sel[owner][:, None]
            dr_cell = dr_cell * alpha_sel[:, None, None]
        else:
            frac_new, lat_new = apply_step(torch.ones_like(e_total))

        new_state = LbfgsState(
            frac=frac_new,
            lat=lat_new,
            s_hist=s_hist,
            y_hist=y_hist,
            s_cell=s_cell,
            y_cell=y_cell,
            rho=rho,
            prev_grad=grad,
            prev_grad_cell=grad_cell,
            prev_dr=dr,
            prev_dr_cell=dr_cell,
            n_hist=torch.where(converged, state.n_hist, state.n_hist + 1),
            converged=converged,
        )
        ys = {"energy": e_total, "fmax": fmax}
        return new_state, _record_ys(ys, record, forces, out, state.frac, state.lat)

    return _run_chunk(step, state, n_steps)


class BFGS(NamedTuple):
    """Dense-Hessian BFGS hyperparameters (ASE ``BFGS``: H0 = alpha * I with
    alpha = 70 eV/A^2, maxstep 0.2 A)."""

    alpha: float = 70.0
    maxstep: float = 0.2


class BfgsState(NamedTuple):
    """Batched dense-Hessian BFGS state: one (3 * n_max + 9)-DOF Hessian
    per graph (positions + scaled strain, the unit-cell-filter DOF)."""

    frac: torch.Tensor  # [N, 3]
    lat: torch.Tensor  # [B, 3, 3]
    hessian: torch.Tensor  # [B, D, D] with D = 3 * n_max + 9
    prev_grad: torch.Tensor  # [B, D]
    prev_dr: torch.Tensor  # [B, D]
    have_prev: torch.Tensor  # [B] bool
    converged: torch.Tensor  # [B] bool


def _graph_slots(batch: GraphBatch) -> tuple[np.ndarray, int]:
    """Host map flat atoms -> per-graph slots: ``pg_idx[b, k]`` is the flat
    index of graph ``b``'s ``k``-th atom (padding repeats the last valid
    flat row; its force is zero so it never moves the DOF)."""
    owner = _host(batch.atom_owner)
    mask = _host(batch.atom_mask) > 0
    n_graphs = batch.lattices.shape[0]
    counts = np.bincount(owner[mask], minlength=n_graphs)
    if counts.size and int(counts.min()) == 0:
        # a zero-atom graph would get rows of flat index 0 (a real atom of
        # graph 0) in valid slots, mixing graph 0 into it
        raise ValueError("every graph in a BFGS batch needs >= 1 atom")
    n_max = max(int(counts.max()) if counts.size else 1, 1)
    pg_idx = np.zeros((n_graphs, n_max), np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])[:-1]
    for b in range(n_graphs):
        rows = offsets[b] + np.arange(counts[b])
        pg_idx[b, : counts[b]] = rows
        pg_idx[b, counts[b]:] = rows[-1] if counts[b] else 0
    return pg_idx.astype(np.int32), n_max


def _init_bfgs_state(batch: GraphBatch, bfgs: BFGS, n_max: int) -> BfgsState:
    """H0 = alpha * I at the batch's positions, on the batch's device."""
    n_graphs = batch.lattices.shape[0]
    dof = 3 * n_max + 9
    dev = batch.frac_coords.device
    eye = torch.eye(dof, dtype=torch.float32, device=dev) * bfgs.alpha
    return BfgsState(
        frac=batch.frac_coords,
        lat=batch.lattices,
        hessian=eye.expand(n_graphs, dof, dof).clone(),
        prev_grad=torch.zeros((n_graphs, dof), dtype=torch.float32, device=dev),
        prev_dr=torch.zeros((n_graphs, dof), dtype=torch.float32, device=dev),
        have_prev=torch.zeros((n_graphs,), dtype=torch.bool, device=dev),
        converged=torch.zeros((n_graphs,), dtype=torch.bool, device=dev),
    )


def bfgs_chunk(
    params,
    batch: GraphBatch,
    state: BfgsState,
    pg_idx: torch.Tensor,  # [B, n_max] flat atom index per graph slot
    *,
    config: CHGNetConfig,
    bfgs: BFGS,
    n_steps: int,
    n_max: int,
    fmax_target: float,
    cell_factor: torch.Tensor,  # [B]
    relax_cell: bool,
    record: bool,
    line_search: bool = False,
) -> tuple[BfgsState, dict[str, torch.Tensor]]:
    """``n_steps`` of batched dense-Hessian BFGS (ASE ``BFGS``) on the
    batch's device: per graph, a (3 n + 9)-DOF Hessian updated by the two
    rank-one BFGS terms and stepped through its eigendecomposition, ``dr =
    V (V^T f / |omega|)``, so saddle directions are walked downhill as ASE
    does. ``torch.linalg.eigh`` (cuSOLVER on the card) checks its result on
    the host, one wait a step. The (3N)^2 memory and eigh cost keep this to
    small systems; LBFGS covers large ones. ``line_search`` adds the
    per-graph Armijo backtracking of :func:`lbfgs_chunk` (ASE's
    ``BFGSLineSearch`` analogue)."""
    n_graphs = batch.lattices.shape[0]
    owner = batch.atom_owner.long()
    atom_mask = batch.atom_mask[:, None]
    pg_idx = pg_idx.long()
    seg_max = _seg_max(owner, n_graphs)
    evaluate = _make_evaluate(params, batch, config=config, relax_cell=relax_cell, record=record)
    # padded slots repeat the last valid flat row: keep only the FIRST
    # occurrence so that the to-graph scatter is well defined
    first = torch.cat(
        [torch.ones_like(pg_idx[:, :1], dtype=torch.bool), pg_idx[:, 1:] != pg_idx[:, :-1]],
        dim=1,
    )
    slot_ok = ((batch.atom_mask[pg_idx] > 0) & first).to(torch.float32)[..., None]

    def to_graph(x_atoms, x_cell):
        """Flat per-atom [N, 3] + per-graph cell [B, 3, 3] -> [B, D]."""
        per = x_atoms[pg_idx] * slot_ok  # [B, n_max, 3]
        return torch.cat(
            [per.reshape(n_graphs, 3 * n_max), x_cell.reshape(n_graphs, 9)], dim=1
        )

    def from_graph(v):
        """[B, D] -> flat per-atom [N, 3] + per-graph cell [B, 3, 3]; each
        flat row takes its one valid slot (the other slots add zero)."""
        per = (v[:, : 3 * n_max].reshape(n_graphs, n_max, 3) * slot_ok).reshape(-1, 3)
        flat = torch.zeros((batch.frac_coords.shape[0], 3), dtype=v.dtype, device=v.device)
        flat = flat.index_add(0, pg_idx.reshape(-1), per)
        return flat, v[:, 3 * n_max:].reshape(n_graphs, 3, 3)

    def step(state: BfgsState):
        e_total, forces, virial, out = evaluate(state.frac, state.lat)
        cell_forces = _cell_forces(virial, cell_factor, relax_cell)
        f_vec = to_graph(forces, cell_forces)  # [B, D] forces (= -grad)
        grad = -f_vec
        fmax = _fmax(forces, cell_forces, atom_mask, seg_max, relax_cell)
        converged = state.converged | (fmax < fmax_target)

        # ASE BFGS.update: H -= df df^T / (s . df) + dg dg^T / (s . dg)
        # with s the previous step, df the force difference, dg = H s;
        # skipped when the previous step was (numerically) zero
        s = state.prev_dr
        df = f_vec - (-state.prev_grad)
        a = torch.einsum("bd,bd->b", s, df)
        dg = torch.einsum("bij,bj->bi", state.hessian, s)
        b = torch.einsum("bd,bd->b", s, dg)
        upd_ok = (
            state.have_prev
            & (torch.abs(s).amax(dim=1) > 1e-7)
            & (torch.abs(a) > 1e-30)
            & (torch.abs(b) > 1e-30)
        )
        # graphs left out still divide: keep their denominators off zero
        a_safe = torch.where(upd_ok, a, 1.0)[:, None, None]
        b_safe = torch.where(upd_ok, b, 1.0)[:, None, None]
        hessian = state.hessian - upd_ok.to(torch.float32)[:, None, None] * (
            torch.einsum("bi,bj->bij", df, df) / a_safe
            + torch.einsum("bi,bj->bij", dg, dg) / b_safe
        )

        # step through the eigendecomposition, |omega| regularised
        omega, vecs = torch.linalg.eigh(hessian)
        f_modes = torch.einsum("bdk,bd->bk", vecs, f_vec)
        dr = torch.einsum("bdk,bk->bd", vecs, f_modes / torch.abs(omega))

        dr_atoms, dr_cell = from_graph(dr)
        active = _step_scale(dr_atoms, dr_cell, atom_mask, seg_max, bfgs.maxstep, converged)
        dr = dr * active[:, None]
        dr_atoms = dr_atoms * active[owner][:, None] * atom_mask
        dr_cell = dr_cell * active[:, None, None]

        def apply_step(alpha_b):
            d_strain = dr_cell * (alpha_b / cell_factor)[:, None, None]
            return _fold(
                state.frac, state.lat, owner, dr_atoms * alpha_b[owner][:, None], d_strain
            )

        if line_search:
            g_dot_d = torch.einsum("bd,bd->b", grad, dr)
            alpha_sel = _line_search(params, batch, config, apply_step, e_total, g_dot_d)
            frac_new, lat_new = apply_step(alpha_sel)
            dr = dr * alpha_sel[:, None]
        else:
            frac_new, lat_new = apply_step(torch.ones_like(e_total))

        new_state = BfgsState(
            frac=frac_new,
            lat=lat_new,
            hessian=hessian,
            prev_grad=grad,
            prev_dr=dr,
            have_prev=torch.ones_like(state.have_prev),
            converged=converged,
        )
        ys = {"energy": e_total, "fmax": fmax}
        return new_state, _record_ys(ys, record, forces, out, state.frac, state.lat)

    return _run_chunk(step, state, n_steps)


class StructOptimizer:
    """Structure relaxation on the model's device.

    Upstream CHGNet's API: ``relax()`` returns ``{"final_structure",
    "trajectory", "final_energy"}``, or a list of such dicts when given
    several structures. FIRE, MDMin, LBFGS, BFGS and their line-search
    forms relax all of them in ONE padded batch; ``final_energy`` is the
    energy of the last evaluated state, one move before ``final_structure``
    (as in ``chgnet_tpu``). SciPyFminCG and SciPyFminBFGS minimise one
    structure at a time on the host. ``mesh`` (an int, the size of the
    initialised process group, or a :class:`~chgnet_tpu_torch.parallel.
    mesh.Mesh`) relaxes with FIRE or MDMin over the ranks of a
    ``torch.distributed`` group, every rank calling with the same arguments
    (``parallel/relax_sharded.py``; ``halo=True``: the boundary exchange);
    other optimizers raise with a mesh, and ``halo`` without one is
    ignored, as in ``chgnet_tpu``.
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
        lbfgs_params: LBFGS | None = None,
        bfgs_params: BFGS | None = None,
        mesh: int | None = None,
        halo: bool = False,
    ) -> None:
        optimizer_class = optimizer_class or "FIRE"
        if optimizer_class not in SUPPORTED:
            raise NotImplementedError(
                f"{optimizer_class=}: the relaxer implements {sorted(SUPPORTED)}"
            )
        if mesh is not None and optimizer_class not in {"FIRE", "MDMin"}:
            raise NotImplementedError(
                f"mesh relaxation supports FIRE/MDMin, not {optimizer_class}"
            )
        self.optimizer_class = optimizer_class
        self.model = resolve_model(model, use_device)
        self._mesh = None
        if mesh is not None:
            from chgnet_tpu_torch.parallel.mesh import resolve_mesh

            self._mesh = resolve_mesh(mesh, "graph", self.model.device)
        self._halo = bool(halo)
        self.fire = fire_params or FIRE()
        self.lbfgs = lbfgs_params or LBFGS()
        self.bfgs = bfgs_params or BFGS()
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
        if self.optimizer_class.startswith("SciPyFmin"):
            results = self._relax_scipy(
                structures,
                fmax=fmax,
                steps=steps,
                relax_cell=relax_cell,
                save_path=save_path,
                assign_magmoms=assign_magmoms,
                skin=skin,
                verbose=verbose,
            )
            return results[0] if single else results
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
            shard_mesh=self._mesh,
            halo=self._halo,
        )
        n_pad = runtime.batch.atomic_numbers.shape[0]
        cell_factor = torch.as_tensor(
            [max(len(s), 1) for s in structures], dtype=torch.float32,
            device=self.model.device,
        )
        record = loginterval is not None or crystal_feas_save_path is not None
        chunk = dict(
            config=self.model.config,
            fmax_target=fmax,
            cell_factor=cell_factor,
            relax_cell=relax_cell,
            record=record,
        )
        if self.optimizer_class in {"BFGS", "BFGSLineSearch"}:
            pg_idx, n_max = _graph_slots(runtime.batch)
            pg_idx = torch.as_tensor(pg_idx, device=self.model.device)
            state = _init_bfgs_state(runtime.batch, self.bfgs, n_max)

            def run(batch, state, n_steps):
                return bfgs_chunk(
                    self.model.params, batch, state, pg_idx, bfgs=self.bfgs,
                    n_steps=n_steps, n_max=n_max,
                    line_search=self.optimizer_class == "BFGSLineSearch", **chunk,
                )
        elif self.optimizer_class in {"LBFGS", "LBFGSLineSearch"}:
            state = _init_lbfgs_state(runtime.batch, self.lbfgs)

            def run(batch, state, n_steps):
                return lbfgs_chunk(
                    self.model.params, batch, state, lbfgs=self.lbfgs,
                    n_steps=n_steps,
                    line_search=self.optimizer_class == "LBFGSLineSearch", **chunk,
                )
        elif self._mesh is not None:
            from chgnet_tpu_torch.parallel.relax_sharded import fire_chunk_sharded

            mesh = self._mesh
            state = _init_state(
                runtime.batch, self.fire,
                mesh.size * runtime.sbatch.atomic_numbers.shape[0], self.model.device,
            )

            def run(batch, state, n_steps):
                return fire_chunk_sharded(
                    self.model.params, runtime.sbatch, state, runtime.hbatch,
                    mesh=mesh, fire=self.fire, n_steps=n_steps,
                    method=self.optimizer_class, **chunk,
                )
        else:
            state = _init_state(runtime.batch, self.fire)

            def run(batch, state, n_steps):
                return fire_chunk(
                    self.model.params, batch, state, fire=self.fire,
                    n_steps=n_steps, method=self.optimizer_class, **chunk,
                )
        observers = [
            TrajectoryObserver(atomic_numbers=s.atomic_numbers) for s in structures
        ]
        feas_observer = CrystalFeasObserver() if crystal_feas_save_path else None

        total = 0
        last_energy = np.zeros(len(structures))
        while total < steps:
            n_steps = min(chunk_size, steps - total)
            state, traj = run(runtime.batch, state, n_steps)
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
            # stepping blocks only when the Verlet budget is spent (mesh
            # mode's state carries a zero tail past the padded order)
            runtime.step_rebuild(
                state.frac[:n_pad].cpu().numpy(), state.lat.cpu().numpy()
            )

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

    def _relax_scipy(
        self,
        structures: list[Structure],
        *,
        fmax: float,
        steps: int,
        relax_cell: bool,
        save_path: str | None,
        assign_magmoms: bool,
        skin: float,
        verbose: bool,
    ) -> list[dict]:
        """SciPyFminCG / SciPyFminBFGS: ``scipy.optimize.minimize`` over the
        flattened float64 (cartesian, scaled-strain) DOF, one structure at a
        time, as upstream wraps ASE's SciPy optimizers. Each evaluation
        runs on the model's device and returns float64 numpy to scipy; the
        Verlet criterion is checked at every evaluation, since scipy may
        move atoms arbitrarily far between two."""
        from scipy.optimize import minimize

        method = "CG" if self.optimizer_class.endswith("CG") else "BFGS"
        dev = self.model.device
        results = []
        for s_idx, struct in enumerate(structures):
            runtime = GraphRuntime(
                self.model.config,
                [struct],
                skin=skin,
                on_isolated_atoms=self.on_isolated_atoms,
                device=dev,
            )
            n = len(struct)
            cell_factor = float(max(n, 1))
            lat0 = _host(runtime.batch.lattices[0]).astype(np.float64)
            cap = runtime.batch.frac_coords.shape[0]
            observer = TrajectoryObserver(atomic_numbers=struct.atomic_numbers)

            def unpack(x):
                cart = x[: 3 * n].reshape(n, 3)
                strain = (
                    x[3 * n:].reshape(3, 3) / cell_factor
                    if relax_cell
                    else np.zeros((3, 3))
                )
                lat = lat0 @ (np.eye(3) + strain)
                return cart @ np.linalg.inv(lat), lat

            def fun(x):
                frac, lat = unpack(x)
                frac_pad = np.zeros((cap, 3), np.float32)
                frac_pad[:n] = frac
                # the dynamic masks only remove edges, never add them: a
                # stale topology must be rebuilt before it is evaluated
                if runtime.needs_rebuild(frac_pad, lat[None]):
                    runtime.rebuild(frac_pad, lat[None])
                out = compute_batch_dynamic(
                    self.model.params,
                    runtime.batch._replace(
                        frac_coords=torch.as_tensor(frac_pad, device=dev),
                        lattices=torch.as_tensor(lat[None], dtype=torch.float32, device=dev),
                    ),
                    config=self.model.config,
                    compute_stress=True,
                    compute_magmom=False,
                )
                e = float(out["e"][0]) * (n if self.model.config.is_intensive else 1.0)
                forces = out["f"][:n].cpu().numpy()
                stress = out["s"][0].cpu().numpy()
                grad = [-forces.ravel().astype(np.float64)]
                if relax_cell:
                    virial = stress * GPA_TO_EV_A3 * abs(np.linalg.det(lat))
                    grad.append((virial / cell_factor).ravel().astype(np.float64))
                observer.record(
                    energy=e,
                    forces=forces,
                    stress=voigt_6(stress) * GPA_TO_EV_A3,
                    magmoms=None,
                    positions=frac @ lat,
                    cell=lat,
                )
                return e, np.concatenate(grad)

            x0 = [(_host(runtime.batch.frac_coords[:n]).astype(np.float64) @ lat0).ravel()]
            if relax_cell:
                x0.append(np.zeros(9))
            res = minimize(
                fun,
                np.concatenate(x0),
                jac=True,
                method=method,
                options={"maxiter": steps, "gtol": fmax},
            )
            frac, lat = unpack(res.x)
            final = Structure(
                lat, [int(z) for z in struct.atomic_numbers], np.mod(frac, 1.0)
            )
            if assign_magmoms:
                pred = self.model.predict_structure(final, task="em")
                final.site_properties["magmom"] = list(np.asarray(pred["m"], dtype=float))
            if verbose:
                print(
                    f"SciPyFmin{method} [{s_idx}]: E = {res.fun:.4f} eV "
                    f"({res.nit} iterations, success={res.success})"
                )
            if save_path is not None:
                suffix = "" if len(structures) == 1 else f".{s_idx}"
                observer.save(f"{save_path}{suffix}")
            results.append(
                {
                    "final_structure": final,
                    "trajectory": observer,
                    "final_energy": float(res.fun),
                }
            )
        return results

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
