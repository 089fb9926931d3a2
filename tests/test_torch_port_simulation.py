"""The port's simulation layer against chgnet_tpu's, on the CPU.

* the dynamic-cutoff masks of a skin batch, bit for bit;
* ``compute_batch_dynamic`` on that batch against chgnet_tpu's (e <= 2e-5
  eV/atom, f <= 5e-5 eV/A, s <= 2e-4 GPa, m <= 2e-5 mu_B), and against the
  port's own ``compute_batch`` on an exact-cutoff batch of the same
  positions;
* one step of every MD ensemble and of FIRE / MDMin, both packages driven
  by one analytic force field (a harmonic well, no model), within 1e-6 of
  each leaf's largest value;
* the pinned seed-0 traces of ``tests/test_golden_traces.py`` (six MD
  ensembles, NVE's inert thermostat, FIRE) at their rtol of 2e-3;
* Maxwell-Boltzmann velocities bit for bit, skin reuse against a skin that
  never rebuilds (rtol 1e-5), the Birch-Murnaghan fit, and the goldens
  ``chip_smoke.py`` keeps for the card.

chgnet_tpu's model is compiled once here (``compute_batch_dynamic``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chgnet_tpu import ROOT
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.graph.batching import batch_graphs as j_batch_graphs
from chgnet_tpu.graph.converter import CrystalGraphConverter as JConverter
from chgnet_tpu.models.chgnet import CHGNet as JCHGNet
from chgnet_tpu.simulation import eos as j_eos
from chgnet_tpu.simulation import md as j_md
from chgnet_tpu.simulation import relax as j_relax
from chgnet_tpu.simulation import runtime as j_runtime
from chgnet_tpu_torch.core.structure import Structure as TStructure
from chgnet_tpu_torch.graph.batching import batch_graphs as t_batch_graphs
from chgnet_tpu_torch.graph.converter import CrystalGraphConverter as TConverter
from chgnet_tpu_torch.models.chgnet import CHGNet as TCHGNet
from chgnet_tpu_torch.models.chgnet import compute_batch as t_compute_batch
from chgnet_tpu_torch.simulation import MolecularDynamics, StructOptimizer
from chgnet_tpu_torch.simulation import eos as t_eos
from chgnet_tpu_torch.simulation import md as t_md
from chgnet_tpu_torch.simulation import relax as t_relax
from chgnet_tpu_torch.simulation import runtime as t_runtime
from test_golden_traces import GOLDEN_FIRE, GOLDEN_MD, SMALL

TOL = {"e": 2e-5, "f": 5e-5, "s": 2e-4, "m": 2e-5}
STEP_RTOL = 1e-6
LIMNO2 = f"{ROOT}/examples/mp-18767-LiMnO2.cif"
SKIN = 0.3
ENSEMBLES = sorted(GOLDEN_MD)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its loops are thousands
    of small ops, which several test processes on one machine's cores slow
    down many times over when each op spreads over every core."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def tmodel():
    return TCHGNet(seed=0, device="cpu", **SMALL)


@pytest.fixture(scope="module")
def tstruct():
    return TStructure.from_file(LIMNO2)


@pytest.fixture(scope="module")
def skin_batches(tmodel):
    """The skin-0.3 batch of perturb(0.1, seed=3) LiMnO2 in both packages
    (numpy builders), its atoms then moved by up to 0.05 A, as a step
    would; and the port's exact-cutoff batch of the moved positions."""
    cfg = tmodel.config
    js = JStructure.from_file(LIMNO2).perturb(0.1, seed=3)
    ts = TStructure.from_file(LIMNO2).perturb(0.1, seed=3)
    cut = dict(atom_graph_cutoff=cfg.atom_graph_cutoff + SKIN,
               bond_graph_cutoff=cfg.bond_graph_cutoff + SKIN)
    jb = j_batch_graphs([JConverter(**cut, algorithm="numpy")(js)])
    tb = t_batch_graphs([TConverter(**cut, algorithm="numpy")(ts)])
    for field in ("atom_graph", "bond_graph", "images", "edge_mask", "angle_mask"):
        np.testing.assert_array_equal(getattr(tb, field), getattr(jb, field))
    rng = np.random.default_rng(11)
    n = len(ts)
    frac = tb.frac_coords.copy()
    frac[:n] += (rng.uniform(-0.05, 0.05, (n, 3)) @ np.linalg.inv(ts.lattice.matrix))
    frac = frac.astype(np.float32)
    jb = jb._replace(frac_coords=frac)
    tb = tb._replace(frac_coords=frac)
    moved = TStructure(ts.lattice, ts.atomic_numbers.tolist(), frac[:n])
    exact = t_batch_graphs([tmodel.graph_converter(moved)])
    return jb, tb.to("cpu"), exact.to("cpu"), n


def test_dynamic_cutoff_masks_equal_chgnet_tpu_bit_for_bit(tmodel, skin_batches):
    jb, tb, exact, _ = skin_batches
    jcfg = JCHGNet(seed=0, **SMALL).config
    jm = j_runtime.apply_dynamic_cutoff(jax.tree.map(jnp.asarray, jb), jcfg)
    tm = t_runtime.apply_dynamic_cutoff(tb, tmodel.config)
    for field in ("edge_mask", "und_mask", "angle_mask"):
        np.testing.assert_array_equal(
            getattr(tm, field).numpy(), np.asarray(getattr(jm, field)), err_msg=field
        )
        # the skin's rows are valid in the plans but masked off
        assert (getattr(tm, field) < getattr(tb, field)).any(), field
    # what stays is the exact-cutoff graph
    assert int(tm.edge_mask.sum()) == int(exact.edge_mask.sum())
    assert int(tm.angle_mask.sum()) == int(exact.angle_mask.sum())


def test_compute_batch_dynamic_matches_chgnet_tpu_and_the_exact_batch(
    tmodel, skin_batches
):
    jb, tb, exact, n = skin_batches
    jmodel = JCHGNet(seed=0, **SMALL)
    want = j_runtime.compute_batch_dynamic(
        jmodel.params, jax.tree.map(jnp.asarray, jb), config=jmodel.config
    )
    got = t_runtime.compute_batch_dynamic(tmodel.params, tb, config=tmodel.config)
    ref = t_compute_batch(
        tmodel.params, exact, config=tmodel.config, compute_force=True,
        compute_stress=True, compute_magmom=True,
    )
    assert bool(torch.isfinite(got["f"]).all())
    for key, tol in TOL.items():
        g = got[key].numpy()
        rows = slice(0, 1) if key in "es" else slice(0, n)
        np.testing.assert_allclose(g[rows], np.asarray(want[key])[rows], rtol=0,
                                   atol=tol, err_msg=f"{key} vs chgnet_tpu")
        np.testing.assert_allclose(g[rows], ref[key].numpy()[rows], rtol=0,
                                   atol=tol, err_msg=f"{key} vs exact batch")


# ------------------------------------------------------------ integrators
N_ATOMS = (3, 5)  # two graphs, two padded rows
N_PAD = 10


def _harmonic_inputs():
    rng = np.random.default_rng(2)
    owner = np.repeat(np.arange(2), N_ATOMS).astype(np.int32)
    owner = np.concatenate([owner, np.zeros(N_PAD - owner.size, np.int32)])
    mask = (np.arange(N_PAD) < sum(N_ATOMS)).astype(np.float32)
    masses = np.where(mask > 0, rng.uniform(6.0, 60.0, N_PAD), 1.0).astype(np.float32)
    lat = (np.eye(3) * 4.0 + rng.normal(0, 0.2, (2, 3, 3))).astype(np.float32)
    frac = (rng.uniform(0.1, 0.9, (N_PAD, 3)) * mask[:, None]).astype(np.float32)
    vel = (rng.normal(0, 0.01, (N_PAD, 3)) * mask[:, None]).astype(np.float32)
    anchor = rng.uniform(0.0, 4.0, (N_PAD, 3)).astype(np.float32)
    return dict(owner=owner, mask=mask, masses=masses, lat=lat, frac=frac,
                vel=vel, anchor=anchor)


def _harmonic_field(xp, einsum, seg_sum, inp, asarray, k=0.7):
    """A harmonic well per atom: (frac, lat) -> (epot [B], forces, out) with
    a stress of -(sum of r (x) f) / V in GPa."""
    owner, mask, anchor = (asarray(inp[k_]) for k_ in ("owner", "mask", "anchor"))

    def field(frac, lat):
        cart = einsum("ni,nij->nj", frac, lat[owner])
        disp = (cart - anchor) * mask[:, None]
        forces = -k * disp
        epot = seg_sum(0.5 * k * (disp**2).sum(1))
        vol = xp.abs(xp.linalg.det(lat))
        virial = seg_sum(disp[:, :, None] * forces[:, None, :])
        stress = -virial / vol[:, None, None] * 160.21766208
        return epot, forces, {"s": stress}

    return field


def _packages(inp):
    """(step builder kwargs) for both packages: seg_sum / seg_max and the
    harmonic field, each in its own arrays."""
    n_graphs = 2

    def j_seg_sum(x):
        return jax.ops.segment_sum(x, jnp.asarray(inp["owner"]), num_segments=n_graphs)

    def j_seg_max(x):
        return jax.ops.segment_max(x, jnp.asarray(inp["owner"]), num_segments=n_graphs)

    towner = torch.as_tensor(inp["owner"]).long()

    def t_seg_sum(x):
        out = torch.zeros((n_graphs, *x.shape[1:]), dtype=x.dtype)
        return out.index_add_(0, towner, x)

    def t_seg_max(x):
        return torch.zeros(n_graphs).scatter_reduce(0, towner, x, "amax",
                                                    include_self=False)

    j = dict(seg_sum=j_seg_sum, seg_max=j_seg_max, field=_harmonic_field(
        jnp, jnp.einsum, j_seg_sum, inp, jnp.asarray), asarray=jnp.asarray)
    t = dict(seg_sum=t_seg_sum, seg_max=t_seg_max, field=_harmonic_field(
        torch, torch.einsum, t_seg_sum, inp, torch.as_tensor), asarray=torch.as_tensor)
    return j, t


def _assert_leaves_close(got: dict, want: dict):
    for key in want:
        w = np.asarray(want[key], dtype=np.float64)
        g = np.asarray(got[key], dtype=np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=STEP_RTOL, atol=STEP_RTOL * scale,
                                   err_msg=key)


@pytest.mark.parametrize(("ensemble", "thermostat"), ENSEMBLES)
def test_md_step_matches_chgnet_tpu(ensemble, thermostat):
    inp = _harmonic_inputs()
    jpk, tpk = _packages(inp)
    params = dict(dt=2.0, temperature=300.0, taut=50.0, taup=200.0,
                  pressure=0.5, compressibility=0.01)

    def run(pkg, mod, state_cls, param_cls, is_jax):
        a = pkg["asarray"]
        masses, mask = a(inp["masses"]), a(inp["mask"])[:, None]
        field = pkg["field"]

        def evaluate(frac, lat):
            epot, forces, out = field(frac, lat)
            return epot, forces * mask / masses[:, None] * t_md.units.EV_PER_AMU_A_TO_A_FS2, out

        md = param_cls(**{k: a(np.float32(v)) for k, v in params.items()})
        step = mod.make_md_step(
            md=md, masses=masses, dof=a(np.float32([3.0 * n for n in N_ATOMS])),
            owner=a(inp["owner"]), atom_mask=mask, ensemble=ensemble,
            thermostat=thermostat, record=False, evaluate=evaluate,
            seg_sum=pkg["seg_sum"],
        )
        epot, accel, out = evaluate(a(inp["frac"]), a(inp["lat"]))
        zeros = np.zeros(2, np.float32)
        state = state_cls(
            frac=a(inp["frac"]), lat=a(inp["lat"]), vel=a(inp["vel"]), accel=accel,
            epot=epot, stress=out["s"], zeta=a(zeros + 1e-3), eps_dot=a(zeros + 1e-4),
            cell_rate=a(np.full((2, 3, 3), 1e-4, np.float32)),
        )
        state, ys = step(state, None) if is_jax else step(state)
        return {**state._asdict(), **{f"ys_{k}": v for k, v in ys.items()}}

    want = run(jpk, j_md, j_md.MDState, j_md.MDParams, True)
    with torch.no_grad():
        got = run(tpk, t_md, t_md.MDState, t_md.MDParams, False)
    _assert_leaves_close({k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("method", ["FIRE", "MDMin"])
def test_fire_step_matches_chgnet_tpu(method):
    inp = _harmonic_inputs()
    jpk, tpk = _packages(inp)
    fire_kw = dict(dt0=0.1, dtmax=1.0, n_min=5, f_inc=1.1, f_dec=0.5,
                   alpha_start=0.1, f_alpha=0.99, maxstep=0.2)

    def run(pkg, mod, is_jax):
        a = pkg["asarray"]
        mask = a(inp["mask"])[:, None]
        field = pkg["field"]
        xp = jnp if is_jax else torch

        def evaluate(frac, lat):
            epot, forces, out = field(frac, lat)
            vol = xp.abs(xp.linalg.det(lat))
            virial = out["s"] / 160.21766208 * vol[:, None, None]
            return epot, forces * mask, virial, out

        step = mod.make_fire_step(
            fire=mod.FIRE(**fire_kw), owner=a(inp["owner"]), atom_mask=mask,
            fmax_target=0.05, cell_factor=a(np.float32(N_ATOMS)), relax_cell=True,
            record=False, method=method, evaluate=evaluate,
            seg_sum=pkg["seg_sum"], seg_max=pkg["seg_max"],
        )
        # graph 0 downhill past n_min (dt grows), graph 1 fresh
        state = mod.FireState(
            frac=a(inp["frac"]), lat=a(inp["lat"]), vel=a(inp["vel"] * -3.0),
            vel_cell=a(np.full((2, 3, 3), 1e-3, np.float32)),
            dt=a(np.float32([0.3, 0.1])), alpha=a(np.float32([0.08, 0.1])),
            n_pos=a(np.int32([7, 0])), converged=a(np.array([False, False])),
        )
        out = {}
        for i in range(2):
            state, ys = step(state, None) if is_jax else step(state)
            out.update({f"{k}_{i}": v for k, v in state._asdict().items()})
            out.update({f"ys_{k}_{i}": v for k, v in ys.items()})
        return out

    want = run(jpk, j_relax, True)
    with torch.no_grad():
        got = run(tpk, t_relax, False)
    _assert_leaves_close({k: v.numpy() for k, v in got.items()}, want)


# ---------------------------------------------------------------- goldens
def _md(tmodel, struct, ensemble, thermostat, **kw):
    return MolecularDynamics(
        struct, model=tmodel, ensemble=ensemble, thermostat=thermostat,
        temperature=300.0, starting_temperature=300.0, timestep=2.0, seed=0, **kw,
    )


@pytest.mark.parametrize(("ensemble", "thermostat"), ENSEMBLES)
def test_md_golden_trace(tmodel, tstruct, ensemble, thermostat):
    md = _md(tmodel, tstruct, ensemble, thermostat, taut=50.0, taup=200.0,
             pressure=0.0, bulk_modulus=100.0)
    es, ts = [], []
    for _ in range(10):
        md.run(3)
        es.append(float(md.state.epot[0]))
        ts.append(float(md.get_temperature()))
    want_e, want_t = GOLDEN_MD[(ensemble, thermostat)]
    np.testing.assert_allclose(es, want_e, rtol=2e-3)
    np.testing.assert_allclose(ts, want_t, rtol=2e-3)


def test_nve_ignores_thermostat_choice(tmodel, tstruct):
    def run(thermostat):
        md = _md(tmodel, tstruct, "nve", thermostat)
        md.run(10)
        return md.state.epot.numpy(), md.state.vel.numpy()

    e_b, v_b = run("Berendsen_inhomogeneous")
    e_n, v_n = run("Nose-Hoover")
    np.testing.assert_array_equal(e_b, e_n)
    np.testing.assert_array_equal(v_b, v_n)


def test_fire_golden_trajectory(tmodel, tstruct):
    res = StructOptimizer(model=tmodel, optimizer_class="FIRE").relax(
        tstruct.perturb(0.1, seed=3), fmax=0.01, steps=25, relax_cell=True,
        assign_magmoms=False,
    )
    es = [float(e) for e in res["trajectory"].energies[:25]]
    np.testing.assert_allclose(es, GOLDEN_FIRE, rtol=2e-3)


def test_chip_smoke_goldens_equal_the_pinned_ones():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", f"{ROOT}/chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.GOLDEN_SMALL == SMALL
    assert chip_smoke.GOLDEN_MD == GOLDEN_MD
    assert chip_smoke.GOLDEN_FIRE == GOLDEN_FIRE


# ------------------------------------------------------------- the rest
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_maxwell_boltzmann_velocities_equal_chgnet_tpu(tmodel, tstruct, seed):
    want = j_md.maxwell_boltzmann_velocities(tstruct.masses, 300.0, seed=seed)
    got = t_md.maxwell_boltzmann_velocities(tstruct.masses, 300.0, seed=seed)
    np.testing.assert_array_equal(got, want)
    if seed == 0:  # the MD state holds them as f32, as chgnet_tpu's does
        md = _md(tmodel, tstruct, "nve", "Berendsen")
        np.testing.assert_array_equal(
            md.state.vel.numpy()[: len(tstruct)], np.asarray(jnp.asarray(want, jnp.float32))
        )


def test_skin_reuse_matches_a_skin_that_never_rebuilds(tmodel, tstruct):
    small = _md(tmodel, tstruct, "nvt", "Berendsen", skin=0.05)
    large = _md(tmodel, tstruct, "nvt", "Berendsen", skin=1.0)
    small.run(3)
    large.run(3)
    assert small.runtime.n_rebuilds >= 1 and large.runtime.n_rebuilds == 0
    for field in ("frac", "vel", "accel", "epot"):
        np.testing.assert_allclose(
            getattr(small.state, field).numpy(), getattr(large.state, field).numpy(),
            rtol=1e-5, atol=1e-7, err_msg=field,
        )


def test_birch_murnaghan_fit_equals_chgnet_tpu():
    v0, b0, bp, e0 = 80.0, 0.6, 4.2, -30.0
    vols = np.linspace(0.9, 1.1, 11) * v0
    eta = (v0 / vols) ** (2.0 / 3.0)
    energies = e0 + 9.0 * v0 * b0 / 16.0 * (
        (eta - 1.0) ** 3 * bp + (eta - 1.0) ** 2 * (6.0 - 4.0 * eta)
    )
    fits = []
    for mod in (j_eos, t_eos):
        bm = mod.BirchMurnaghan(vols, energies)
        bm.fit()
        fits.append((bm.v0, bm.e0, bm.b0, bm.b0_GPa))
    assert fits[0] == fits[1]
    np.testing.assert_allclose(fits[1][:3], (v0, e0, b0), rtol=1e-6)
