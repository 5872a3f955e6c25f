"""The Leicester disc under block SPH on its vacuum grid, on the CPU: 3
sync points of ``disc_ics(n_gas=800, r_in=0.2)`` around a registered
star (beta cooling, sinks, direct gravity) with ``sph_backend="blocks"``
forced, the port against the JAX package's Simulation with
``use_pallas="off"`` (its block kernels in Pallas interpret mode); and the
vacuum grid's cached lists: re-fitted to the gas when the gas count
changes (accretion) or the drift passes the margin, 2 kappa times the
cached grid's fine edge."""

import dataclasses

import numpy as np
import pytest
import torch

from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.models.simulation import Simulation as JSimulation
from gadget_leicester_tpu.models.sinks import \
    register_sinks_from_types as j_register
from gadget_leicester_tpu_torch.core.config import SimOptions
from gadget_leicester_tpu_torch.core.state import (CLOSE_FIELDS,
                                                   EXACT_FIELDS,
                                                   assert_states_close,
                                                   to_numpy)
from gadget_leicester_tpu_torch.models.forces import (comoving_factors,
                                                      compute_sph)
from gadget_leicester_tpu_torch.models.grids import KAPPA_SPH
from gadget_leicester_tpu_torch.models.ics import disc_ics
from gadget_leicester_tpu_torch.models.simulation import Simulation
from gadget_leicester_tpu_torch.models.sinks import register_sinks_from_types
from tests.test_features import _cfg as j_cfg
from tests.test_torch_sinks import port_cfg
from tests.test_torch_slice import _jax_dict

N_GAS = 800
N_STEPS = 3
EXTRA = dict(SofteningBndry=0.05, SinkAccretionRadius=0.35,
             MaxSizeTimestep=0.01, CoolingBeta=1.0)
# 256 slots a subcell: no subcell of the 2^3 blocks overflows, so the JAX
# package's set_ics (which keeps an overflow) and the port's start alike
OPTS = dict(cooling="beta", sinks=True, sph_backend="blocks",
            sph_capacity=256)
FIELDS = CLOSE_FIELDS[:2] + ("p.mass",) + CLOSE_FIELDS[2:] \
    + ("sinks.acc_mass",)
EXACT = EXACT_FIELDS + ("sinks.slot", "sinks.n_accreted")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ics():
    """The ICs, velocities given a seeded 2% scatter (tests/test_torch_
    disc.py says why)."""
    pos, vel, mass, ptype, u = disc_ics(n_gas=N_GAS, r_in=0.2)
    rng = np.random.default_rng(11)
    vel = vel + 0.02 * rng.standard_normal(vel.shape) \
        * np.linalg.norm(vel, axis=1, keepdims=True)
    return pos, vel, mass, ptype, u


def _port_sim():
    pos, vel, mass, ptype, u = _ics()
    sim = Simulation(port_cfg(**EXTRA), SimOptions(**OPTS), "cpu")
    sim.set_ics(pos, vel, mass, ptype, u=u)
    sim.state = register_sinks_from_types(sim.state)
    return sim


@pytest.fixture(scope="module")
def runs():
    """(JAX, port) trajectories of numpy dicts, the start first."""
    pos, vel, mass, ptype, u = _ics()
    jsim = JSimulation(j_cfg(**EXTRA), JOptions(use_pallas="off", **OPTS))
    jsim.set_ics(pos, vel, mass, ptype, u=u)
    jsim.state = j_register(jsim.state)
    sim = _port_sim()
    assert not sim.init_notes and int(jsim.state.overflow_flags) == 0
    jt, pt = [_jax_dict(jsim.state)], [to_numpy(sim.state)]
    for _ in range(N_STEPS):
        jsim.step()
        sim.step()
        jt.append(_jax_dict(jsim.state))
        pt.append(to_numpy(sim.state))
    return jt, pt


@pytest.mark.parametrize("step", range(N_STEPS + 1))
def test_disc_on_blocks_matches_jax(runs, step):
    """After 0 to 3 sync points: the timeline, types, alive flags, sink
    slots and tallies equal, every other field (SPH fields from the
    absolute-mode kernels, dt_entropy with the cooling term) within
    core/state.py's 2e-5 of its largest value."""
    jt, pt = runs
    assert_states_close(pt[step], jt[step], fields=FIELDS, exact=EXACT)


def test_disc_on_blocks_is_under_the_h_cap(runs):
    """The comparison is not one of two caps: every gas particle's h is
    below (1 - 2 kappa) times the fine edge of the lists it ends on."""
    _, pt = runs
    last = pt[-1]
    ng = len(last["gas.hsml"])
    gas = last["p.alive"][:ng] & (last["p.ptype"][:ng] == 0)
    sim = _port_sim()
    cap = (1 - 2 * KAPPA_SPH) / float(sim.state.grids.sph[0].inv_cell[0])
    assert (last["gas.hsml"][gas] < cap).all()


def test_accretion_rebuilds_the_vacuum_lists():
    """Accretion (after the force pass of a sync point) lowers the gas
    count, and the next force pass, finding a count other than the cached
    one, re-fits the lists: each pass's cache holds the gas count it saw,
    and a pass that saw a new count has new lists."""
    sim = _port_sim()
    rebuilds = 0
    for _ in range(20):
        st = sim.state
        ng = st.n_gas_max
        n_gas = int((st.p.alive[:ng] & (st.p.ptype[:ng] == 0)).sum())
        cached, count = st.grids.sph, int(st.grids.sph_count)
        sim.step()
        assert int(sim.state.grids.sph_count) == n_gas
        if n_gas != count:
            assert sim.state.grids.sph is not cached
            rebuilds += 1
    assert int(sim.state.sinks.n_accreted.sum()) > 0 and rebuilds > 0


@pytest.mark.parametrize("share,rebuilt", [(0.49, False), (0.51, True)])
def test_refresh_margin_is_the_cached_fine_edge(share, rebuilt):
    """The lists are kept while twice the drift since the build is under
    2 kappa times the cached grid's fine edge, and re-fitted to the gas
    past it (JAX forces.py:641-656)."""
    sim = _port_sim()
    st = sim.state
    cached = st.grids.sph
    margin = 2.0 * KAPPA_SPH / float(cached[0].inv_cell[0])
    st = dataclasses.replace(st, grids=dataclasses.replace(
        st.grids, sph_disp=torch.tensor(share * margin)))
    active = st.p.alive[:st.n_gas_max].clone()
    out = compute_sph(st, sim.cfg, sim.opts,
                      comoving_factors(sim.cfg, st.ti_current), active)
    assert (out.grids.sph is not cached) == rebuilt
    assert float(out.grids.sph_disp) == (0.0 if rebuilt else
                                         pytest.approx(share * margin))
