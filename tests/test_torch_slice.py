"""The whole ported slice against the JAX package on the CPU: init_state,
one sync point from a carried JAX state, and 3 sync points from the same
ICs. The configuration is tests/test_grid_cache.py's (lcdm_gas_ics at
n_side 12, pmgrid 24, block SPH with subcap 64; JAX with use_pallas off).
There the JAX package runs shortrange_gravity_cells and cic_deposit while
the port runs kernels A and B's plain versions: the same physics through
independent code. Plus the slice's semantics the ROADMAP pins: inactive
particles keep their frozen fields; an over-capacity cell sets the sticky
overflow bit and its dropped particles keep their forecast fields. And
the tier rule of models/forces.py: a full-active sync point takes the
dense kernels, a near-idle one (chip_smoke.make_near_idle) the
active-entry kernels E, F, G, and matches the JAX package's dense step
from the same state."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import make_near_idle, tier
from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.config import \
    parse_parameter_text as j_parse
from gadget_leicester_tpu.models.ics import lcdm_gas_ics
from gadget_leicester_tpu.models.simulation import Simulation as JSimulation
from gadget_leicester_tpu.models.simulation import \
    sync_point_step as j_step
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.core.state import (EXACT_FIELDS,
                                                   assert_states_close,
                                                   from_numpy, to_numpy)
from gadget_leicester_tpu_torch.models.forces import compute_forces
from gadget_leicester_tpu_torch.models.simulation import (Simulation,
                                                          sync_point_step)
from gadget_leicester_tpu_torch.ops.sph_blocks import build_block_lists

BOX = 50000.0
PARAM = f"""
InitCondFile x
OutputDir  /tmp/grid_cache_test
TimeBegin  0.090909
TimeMax    1.0
ComovingIntegrationOn 1
PeriodicBoundariesOn 1
BoxSize    {BOX}
Omega0     0.3
OmegaLambda 0.7
OmegaBaryon 0.04
HubbleParam 0.7
ErrTolIntAccuracy 0.025
MaxSizeTimestep 0.02
CourantFac 0.15
DesNumNgb 33
MaxNumNgbDeviation 2
ArtBulkViscConst 0.8
InitGasTemp 1000
MinGasTemp 5
SofteningGas  100
SofteningHalo 100
SofteningGasMaxPhys  100
SofteningHaloMaxPhys 100
MinGasHsmlFractional 0.1
"""
OPTS = dict(periodic=True, pmgrid=24, gravity_mode="treepm",
            sph_backend="blocks", sph_capacity=64)
N_STEPS = 3
# The bounds are core/state.py's (CLOSE_TOL = 2e-5 of each field's largest
# value, the tolerance of tests/test_grid_cache.py, on all but MAX_EXCLUDED
# rows; none was excluded on this CPU). chip_smoke.py holds the card to the
# CPU by the same bounds.


def _jax_dict(st):
    out = {}
    for g in ("p", "gas", "sinks"):
        sub = getattr(st, g)
        for f in dataclasses.fields(sub):
            out[f"{g}.{f.name}"] = np.asarray(getattr(sub, f.name))
    for k in EXACT_FIELDS[4:]:
        out[k] = np.asarray(getattr(st, k))
    return out


def _ics():
    cfg = parse_parameter_text(PARAM)
    return lcdm_gas_ics(n_side=12, box=BOX, omega0=0.3, omega_b=0.04,
                        hubble=cfg.hubble_internal, g=cfg.grav_internal)


@pytest.fixture(scope="module")
def runs():
    """JAX and port trajectories (numpy dicts), plus one port step from
    the JAX init state carried across with from_numpy."""
    ics = _ics()
    pos, vel, mass, ptype, u = ics
    jcfg = j_parse(PARAM)
    jopts = JOptions(use_pallas="off", **OPTS)
    jsim = JSimulation(jcfg, jopts)
    jsim.set_ics(pos, vel, mass, ptype, u=u)
    j_init = jsim.state
    jax_traj = [_jax_dict(j_init)]
    st = j_init
    for i in range(N_STEPS):
        st = j_step(st, jcfg, jopts)
        jax_traj.append(_jax_dict(st))
        if i == 0:
            j_after_one = st

    cfg = parse_parameter_text(PARAM)
    opts = SimOptions(**OPTS)
    sim = Simulation(cfg, opts, "cpu")
    sim.set_ics(pos, vel, mass, ptype, u=u)
    init_state = sim.state
    port_traj = [to_numpy(sim.state)]
    for _ in range(N_STEPS):
        sim.step()
        port_traj.append(to_numpy(sim.state))
    with tier() as carried_tiers:
        t_carried = to_numpy(sync_point_step(from_numpy(jax_traj[0], "cpu"),
                                             cfg, opts))
    return dict(jax=jax_traj, port=port_traj, t_carried=t_carried,
                carried_tiers=carried_tiers, cfg=cfg, opts=opts,
                init_state=init_state, jcfg=jcfg, jopts=jopts,
                j_after_one=j_after_one)


def test_init_state_matches(runs):
    assert_states_close(runs["port"][0], runs["jax"][0])


def test_carried_state_one_step_matches(runs):
    """The JAX init state carried across with from_numpy gives the JAX
    state after one sync point. The carried state has no grid cache and
    builds its grids fresh; the JAX step reuses the grids it built at init,
    at the same positions (the first sync point drifts by zero ticks)."""
    assert int(runs["jax"][0]["ti_current"]) == int(
        runs["jax"][1]["ti_current"]) == 0
    assert_states_close(runs["t_carried"], runs["jax"][1])


@pytest.mark.parametrize("step", range(1, N_STEPS + 1))
def test_trajectory_matches(runs, step):
    got, want = runs["port"][step], runs["jax"][step]
    assert int(got["ti_current"]) == int(want["ti_current"])
    assert_states_close(got, want, fields=("p.pos", "p.vel", "gas.density",
                                           "gas.hsml", "gas.dt_entropy"))
    assert np.isfinite(got["p.pos"]).all() and np.isfinite(got["p.vel"]).all()


def test_inactive_particles_keep_frozen_fields(runs):
    """Only particles whose step ends now get fresh forces: the others keep
    their acc and SPH fields exactly, whatever they hold."""
    st = runs["init_state"]
    rng = np.random.default_rng(11)
    n = st.n_max
    inactive = torch.from_numpy(rng.uniform(size=n) < 0.5) & st.p.alive
    ng = st.n_gas_max
    p = dataclasses.replace(
        st.p, ti_endstep=torch.where(inactive, 2 ** 20, st.p.ti_endstep),
        acc=st.p.acc + 1.0)
    gas = dataclasses.replace(st.gas, density=st.gas.density * 1.5,
                              hsml=st.gas.hsml * 0.9,
                              dt_entropy=st.gas.dt_entropy + 3.0,
                              hydro_acc=st.gas.hydro_acc - 2.0)
    before = dataclasses.replace(st, p=p, gas=gas, grids=None)
    after = compute_forces(before, runs["cfg"], runs["opts"], do_pm=False)
    off, off_g = inactive, inactive[:ng]
    torch.testing.assert_close(after.p.acc[off], before.p.acc[off],
                               rtol=0, atol=0)
    for f in ("density", "hsml", "dt_entropy", "hydro_acc",
              "max_signal_vel", "div_vel", "curl_vel"):
        torch.testing.assert_close(getattr(after.gas, f)[off_g],
                                   getattr(before.gas, f)[off_g], rtol=0,
                                   atol=0, msg=f)
    on = ~inactive & st.p.alive
    assert not torch.equal(after.p.acc[on], before.p.acc[on])
    on_g = on[:ng] & (st.p.ptype[:ng] == 0)
    assert not torch.equal(after.gas.density[on_g], before.gas.density[on_g])


def test_overflow_sets_sticky_bit_and_keeps_forecast(runs):
    """A fine subcell over capacity drops particles: bit 2 is set, the
    dropped particles' density comes back 0 and they keep their forecast
    fields; a later pass without overflow leaves the bit set."""
    st = dataclasses.replace(runs["init_state"], grids=None)
    cfg = runs["cfg"]
    small = dataclasses.replace(runs["opts"], sph_capacity=8)
    ng = st.n_gas_max
    gas_mask = st.p.alive[:ng] & (st.p.ptype[:ng] == 0)
    cl_e, _ = build_block_lists(st.p.pos[:ng], gas_mask, 0.0, BOX, 3, 8)
    dropped = (cl_e.gslot < 0) & gas_mask
    assert bool(cl_e.overflow) and dropped.any()
    after = compute_forces(st, cfg, small, do_pm=False)
    assert int(after.overflow_flags) & 2
    for f in ("density", "hsml", "dt_entropy", "hydro_acc", "pressure"):
        got = getattr(after.gas, f)[dropped]
        want = getattr(st.gas, f)[dropped]
        if f == "pressure":   # P = A_pred rho^gamma of the kept rho
            want = st.gas.entropy_pred[dropped] * st.gas.density[
                dropped] ** (5.0 / 3.0)
        torch.testing.assert_close(got, want, msg=f)
    kept = gas_mask & ~dropped
    assert (after.gas.density[kept] > 0).all()
    again = compute_forces(after, cfg, runs["opts"], do_pm=False)
    assert int(again.overflow_flags) & 2
    assert torch.isfinite(again.gas.density).all()


def test_full_active_step_takes_dense_tier(runs):
    """Every particle active (the carried first sync point): gravity and
    SPH both take the dense kernels, decided by the active count alone (the
    entry count is never taken, as behind the reference's lax.cond)."""
    log = runs["carried_tiers"]
    assert len(log) == 2 and not any(took for *_, took in log)
    assert log[0][0] == int(runs["jax"][0]["p.alive"].sum())
    assert [n_entries for _, n_entries, *_ in log] == [None, None]


def test_near_idle_step_takes_entries_tier_and_matches_jax(runs):
    """From the state after 1 sync point, 3% of the particles made active
    alone (chip_smoke.make_near_idle): gravity and SPH both take the
    active-entry tier, and the port's step matches the JAX package's step
    from the same state (its dense path with use_pallas off: independent
    code) by the slice's bounds."""
    idle = make_near_idle(from_numpy(runs["jax"][1], "cpu"), 0.03, 7)
    with tier() as log:
        got = to_numpy(sync_point_step(idle, runs["cfg"], runs["opts"]))
    assert len(log) == 2 and all(took for *_, took in log)
    n_active = int(np.asarray(runs["jax"][1]["p.alive"]).sum() * 0.03 + 0.5)
    assert log[0][0] == n_active
    jst = runs["j_after_one"]
    jidle = dataclasses.replace(jst, p=dataclasses.replace(
        jst.p, ti_endstep=jnp.asarray(idle.p.ti_endstep.numpy())))
    want = _jax_dict(j_step(jidle, runs["jcfg"], runs["jopts"]))
    assert int(got["ti_current"]) == int(want["ti_current"]) > int(
        runs["jax"][1]["ti_current"])
    assert_states_close(got, want)
