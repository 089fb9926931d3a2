"""Graph-partitioned structure relaxation: FIRE / MDMin over a mesh.

Port of ``chgnet_tpu.parallel.relax_sharded``: the single-device FIRE /
MDMin step (``simulation.relax.make_fire_step``) on every rank over its
atom block, forces from the sharded energy core with dynamic-cutoff masks,
and the per-graph reductions (power, velocity and force norms, the
convergence fmax) summed or maxed over ranks, so that every rank takes the
same optimizer decisions. Use via ``StructOptimizer(..., mesh=N)``.
"""

from __future__ import annotations

import torch

from chgnet_tpu_torch.models.chgnet import CHGNetConfig
from chgnet_tpu_torch.parallel import collectives as coll
from chgnet_tpu_torch.parallel.graph_sharded import (
    ShardedGraphBatch,
    _as_local,
    _check_config,
)
from chgnet_tpu_torch.parallel.md_sharded import (
    gather_steps,
    own_block,
    sharded_energy_eval,
)
from chgnet_tpu_torch.parallel.mesh import Mesh
from chgnet_tpu_torch.simulation.relax import (
    FIRE,
    FireState,
    _run_chunk,
    _seg_max,
    make_fire_step,
)
from chgnet_tpu_torch.simulation.runtime import graph_sum
from chgnet_tpu_torch.simulation.units import GPA_TO_EV_A3

__all__ = ["fire_chunk_sharded"]


def fire_chunk_sharded(
    params,
    sbatch: ShardedGraphBatch,
    state: FireState,
    halo=None,  # HaloBatch: the boundary exchange instead of all-gathers
    *,
    config: CHGNetConfig,
    mesh: Mesh,
    fire: FIRE,
    n_steps: int,
    fmax_target: float,
    cell_factor: torch.Tensor,  # [B]
    relax_cell: bool,
    record: bool,
    method: str = "FIRE",
) -> tuple[FireState, dict[str, torch.Tensor]]:
    """``n_steps`` fixed-topology FIRE/MDMin steps over the mesh, called by
    every rank. ``state``'s per-atom leaves use the GLOBAL block layout
    [N_glob = D * N_loc, ...]; the returned state and the recorded
    per-atom outputs come back in it, the same on every rank."""
    _check_config(config, mesh)
    sb, hb = _as_local(sbatch, halo, mesh)
    n_loc = sb.atomic_numbers.shape[0]
    n_graphs = sb.lattices.shape[0]
    owner = sb.atom_owner.long()
    atom_mask = sb.atom_mask[:, None]
    need_stress = relax_cell or record
    p_graph = sb.plans["graph"]
    local_max = _seg_max(owner, n_graphs)

    def evaluate(frac, lat):
        out = sharded_energy_eval(
            params, config, sb, hb, mesh, frac, lat,
            need_stress=need_stress, record=record,
        )
        forces = out.pop("forces") * atom_mask
        if need_stress:
            volume = torch.abs(torch.linalg.det(lat))
            virial = out["s"] * GPA_TO_EV_A3 * volume[:, None, None]  # eV
            virial = 0.5 * (virial + virial.transpose(1, 2))
        else:
            virial = torch.zeros((n_graphs, 3, 3), dtype=forces.dtype, device=forces.device)
        return out.pop("epot"), forces, virial, out

    step = make_fire_step(
        fire=fire, owner=owner, atom_mask=atom_mask, fmax_target=fmax_target,
        cell_factor=cell_factor, relax_cell=relax_cell, record=record,
        method=method, evaluate=evaluate,
        seg_sum=lambda x: coll.sum_ranks(graph_sum(x, p_graph), mesh),
        seg_max=lambda x: coll.max_ranks(local_max(x), mesh),
    )
    per_atom = ("frac", "vel")
    local = state._replace(**{k: own_block(getattr(state, k), mesh, n_loc) for k in per_atom})
    local, ys = _run_chunk(step, local, n_steps)
    with torch.no_grad():
        if record:
            ys = gather_steps(ys, ("forces", "magmom", "frac"), mesh)
        state = local._replace(**{
            k: coll.gather_blocks(getattr(local, k), mesh) for k in per_atom
        })
    return state, ys
