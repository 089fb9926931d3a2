"""Graph-partitioned molecular dynamics: one structure's MD over a mesh.

Port of ``chgnet_tpu.parallel.md_sharded``: the single-device velocity
Verlet step (``simulation.md.make_md_step``) runs on every rank over its
atom block of the :class:`~chgnet_tpu_torch.parallel.graph_sharded.
ShardedGraphBatch` layout:

* per-atom state (positions, velocities, accelerations) is this rank's
  block during a chunk, and comes in and goes out in the global block
  layout ``[D * N_loc, ...]`` (one all-gather a chunk);
* forces come from the sharded energy core with ``dynamic_cutoff=True``
  (exact cutoffs over the skin-built topology);
* per-graph reductions (kinetic energy, kinetic stress) sum each rank's
  partial over ranks, so the thermostat and barostat see the same [B]
  values on every rank, bit for bit.

Use via ``MolecularDynamics(..., mesh=N)`` (``simulation.md``).
"""

from __future__ import annotations

import torch

from chgnet_tpu_torch.models.chgnet import EV_A3_TO_GPA, CHGNetConfig, _matmul_precision
from chgnet_tpu_torch.parallel import collectives as coll
from chgnet_tpu_torch.parallel.graph_sharded import (
    ShardedGraphBatch,
    _as_local,
    _check_config,
    _comm,
    _energy,
    _energy_sharded_core,
    magmoms,
)
from chgnet_tpu_torch.parallel.mesh import Mesh
from chgnet_tpu_torch.simulation import units
from chgnet_tpu_torch.simulation.md import MDParams, MDState, make_md_step
from chgnet_tpu_torch.simulation.runtime import graph_sum

__all__ = ["md_chunk_sharded", "sharded_energy_eval"]


def sharded_energy_eval(
    params,
    cfg: CHGNetConfig,
    sb: ShardedGraphBatch,  # one rank's shard
    hb,  # its HaloBatch or None (all-gathers)
    mesh: Mesh,
    frac: torch.Tensor,  # [N_loc, 3]
    lat: torch.Tensor,  # [B, 3, 3] replicated
    *,
    need_stress: bool,
    record: bool,
) -> dict:
    """Local E/F(/S) evaluation inside a sharded simulation step.

    Returns ``epot`` (extensive [B] eV with the composition term, the same
    on every rank), ``forces`` (local [N_loc, 3], unmasked), ``s`` ([B, 3,
    3] GPa, zeros without ``need_stress``) and, under ``record``, local
    ``m`` and the summed ``crystal_fea``. Shared by the sharded MD and
    relaxation chunks."""
    sb = sb._replace(frac_coords=frac, lattices=lat)
    n_graphs = lat.shape[0]
    with _matmul_precision(cfg.matmul_precision), torch.enable_grad():
        cart0 = torch.einsum("ni,nij->nj", frac, lat[sb.atom_owner.long()]).detach()
        strains0 = torch.zeros((n_graphs, 3, 3), dtype=cart0.dtype, device=cart0.device)
        inputs = [cart0.requires_grad_(True)]
        if need_stress:
            inputs.append(strains0.requires_grad_(True))
        e_partial, aux = _energy_sharded_core(
            params, cfg, sb, _comm(sb, hb, mesh), cart0, strains0, dynamic_cutoff=True
        )
        grads = torch.autograd.grad(e_partial.sum(), inputs)
    with torch.no_grad():
        if need_stress:
            volumes = torch.abs(torch.linalg.det(lat))
            stress = coll.sum_ranks(grads[1], mesh) * EV_A3_TO_GPA / volumes[:, None, None]
        else:
            stress = torch.zeros((n_graphs, 3, 3), dtype=lat.dtype, device=lat.device)
        energy, atoms = _energy(
            params, cfg, sb, mesh, e_partial.detach(), aux["atoms_per_graph_local"]
        )
        epot = energy * torch.clamp(atoms, min=1.0) if cfg.is_intensive else energy
        out = {"epot": epot, "forces": -grads[0], "s": stress}
        if record:
            out["m"] = magmoms(params, aux["atom_feas_mid"], sb.atom_mask)
            out["crystal_fea"] = coll.sum_ranks(aux["crystal_fea_local"].detach(), mesh)
    return out


def own_block(x: torch.Tensor, mesh: Mesh, n_loc: int) -> torch.Tensor:
    """This rank's rows of a global block-layout array."""
    return x[mesh.rank * n_loc: (mesh.rank + 1) * n_loc]


def gather_steps(ys: dict, keys, mesh: Mesh) -> dict:
    """Per-atom recorded outputs ``[n_steps, N_loc, ...]`` to the global
    block layout ``[n_steps, D * N_loc, ...]``."""
    for key in keys:
        local = ys[key].transpose(0, 1).contiguous()
        ys[key] = coll.gather_blocks(local, mesh).transpose(0, 1)
    return ys


def md_chunk_sharded(
    params,
    sbatch: ShardedGraphBatch,
    state: MDState,
    md: MDParams,
    masses: torch.Tensor,  # [N_glob] amu (padding: 1), block layout
    dof: torch.Tensor,  # [B]
    halo=None,  # HaloBatch: the boundary exchange instead of all-gathers
    *,
    config: CHGNetConfig,
    mesh: Mesh,
    ensemble: str,
    thermostat: str,
    n_steps: int,
    record: bool,
) -> tuple[MDState, dict[str, torch.Tensor]]:
    """``n_steps`` fixed-topology MD steps over the mesh, called by every
    rank. ``state``'s per-atom leaves use the GLOBAL block layout [N_glob =
    D * N_loc, ...] (``unshard_atoms`` order); the returned state and the
    recorded per-atom outputs come back in the same layout, the same on
    every rank."""
    _check_config(config, mesh)
    sb, hb = _as_local(sbatch, halo, mesh)
    n_loc = sb.atomic_numbers.shape[0]
    owner = sb.atom_owner
    atom_mask = sb.atom_mask[:, None]
    masses_l = own_block(masses, mesh, n_loc)
    need_stress = ensemble == "npt" or record
    p_graph = sb.plans["graph"]

    def seg_sum(x):
        return coll.sum_ranks(graph_sum(x, p_graph), mesh)

    def evaluate(frac, lat):
        out = sharded_energy_eval(
            params, config, sb, hb, mesh, frac, lat,
            need_stress=need_stress, record=record,
        )
        accel = (
            out.pop("forces") * atom_mask / masses_l[:, None]
            * units.EV_PER_AMU_A_TO_A_FS2
        )
        return out.pop("epot"), accel, out

    step = make_md_step(
        md=md, masses=masses_l, dof=dof, owner=owner, atom_mask=atom_mask,
        ensemble=ensemble, thermostat=thermostat, record=record,
        evaluate=evaluate, seg_sum=seg_sum,
    )
    per_atom = ("frac", "vel", "accel")
    local = state._replace(**{k: own_block(getattr(state, k), mesh, n_loc) for k in per_atom})
    trace = []
    with torch.no_grad():
        for _ in range(n_steps):
            local, ys = step(local)
            trace.append(ys)
        ys = {k: torch.stack([y[k] for y in trace]) for k in trace[0]}
        if record:
            ys = gather_steps(ys, ("forces", "magmom", "frac"), mesh)
        state = local._replace(**{
            k: coll.gather_blocks(getattr(local, k), mesh) for k in per_atom
        })
    return state, ys
