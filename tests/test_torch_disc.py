"""The Leicester disc on the CPU: 20 sync points of ``disc_ics(n_gas=400,
r_in=0.2)`` around a registered star, beta cooling and sinks, direct
gravity and all-pairs SPH, the port against the JAX package from the same
ICs (the sinks group included); mass conservation under accretion; and
the port's twin of tests/test_features.py::
test_sink_accretion_conserves_mass_momentum on the unperturbed ICs."""

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
from gadget_leicester_tpu_torch.models.ics import disc_ics
from gadget_leicester_tpu_torch.models.simulation import Simulation
from gadget_leicester_tpu_torch.models.sinks import register_sinks_from_types
from tests.test_features import _cfg as j_cfg
from tests.test_torch_sinks import port_cfg
from tests.test_torch_slice import _jax_dict

N_STEPS = 20
EXTRA = dict(SofteningBndry=0.05, SinkAccretionRadius=0.35,
             MaxSizeTimestep=0.01, CoolingBeta=1.0)
FIELDS = CLOSE_FIELDS[:2] + ("p.mass",) + CLOSE_FIELDS[2:] \
    + ("sinks.acc_mass",)
EXACT = EXACT_FIELDS + ("sinks.slot", "sinks.n_accreted")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ics(scatter: float):
    """The ICs, velocities given a seeded ``scatter``: on exact circular
    orbits around the star the sign of dv . dx, which decides whether gas
    approaches the sink, is a rounding residue, and two packages that
    round apart accrete different particles."""
    pos, vel, mass, ptype, u = disc_ics(n_gas=400, r_in=0.2)
    rng = np.random.default_rng(11)
    vel = vel + scatter * rng.standard_normal(vel.shape) \
        * np.linalg.norm(vel, axis=1, keepdims=True)
    return pos, vel, mass, ptype, u


@pytest.fixture(scope="module")
def runs():
    """(JAX, port) trajectories of numpy dicts, the start first."""
    pos, vel, mass, ptype, u = _ics(0.02)
    opts = dict(cooling="beta", sinks=True)
    jsim = JSimulation(j_cfg(**EXTRA), JOptions(**opts))
    jsim.set_ics(pos, vel, mass, ptype, u=u)
    jsim.state = j_register(jsim.state)
    sim = Simulation(port_cfg(**EXTRA), SimOptions(**opts), "cpu")
    sim.set_ics(pos, vel, mass, ptype, u=u)
    sim.state = register_sinks_from_types(sim.state)
    jt, pt = [_jax_dict(jsim.state)], [to_numpy(sim.state)]
    for _ in range(N_STEPS):
        jsim.step()
        sim.step()
        jt.append(_jax_dict(jsim.state))
        pt.append(to_numpy(sim.state))
    return jt, pt


@pytest.mark.parametrize("step", [0, N_STEPS // 2, N_STEPS])
def test_disc_run_matches_jax(runs, step):
    """After 0, 10 and 20 sync points: the timeline, types, alive flags,
    sink slots and tallies equal, every other field (masses, velocities,
    SPH fields, dt_entropy with the cooling term, acc_mass) within
    core/state.py's 2e-5 of its largest value."""
    jt, pt = runs
    assert_states_close(pt[step], jt[step], fields=FIELDS, exact=EXACT)


def test_disc_run_matches_jax_at_every_sync_point(runs):
    jt, pt = runs
    for g, w in zip(pt, jt):
        assert_states_close(g, w, fields=FIELDS, exact=EXACT)


def _alive_mass(d):
    return float(d["p.mass"][d["p.alive"]].astype(np.float64).sum())


def test_disc_run_accretes_and_conserves_mass(runs):
    """The star accretes; the alive mass stays the start's to 1e-5
    (each accreted particle's mass moves to the star), the alive count
    falls by exactly the tally, and the star's gain is its acc_mass.
    (Momentum moves over exactly at each accretion, test_torch_sinks.py;
    over a run with individual timesteps it is not conserved exactly.)"""
    _, pt = runs
    first, last = pt[0], pt[-1]
    n_acc = int(last["sinks.n_accreted"].sum())
    assert n_acc > 0
    assert int(first["p.alive"].sum()) - int(last["p.alive"].sum()) == n_acc
    assert _alive_mass(last) == pytest.approx(_alive_mass(first), rel=1e-5)
    star = first["sinks.slot"][0]
    gained = float(last["p.mass"][star]) - float(first["p.mass"][star])
    assert float(last["sinks.acc_mass"][0]) == pytest.approx(gained, rel=1e-5)


def test_disc_ics_equal_jax():
    """The port's copy of disc_ics gives the JAX package's arrays bit for
    bit."""
    from gadget_leicester_tpu.models.ics import disc_ics as j_disc_ics
    for kw in (dict(), dict(n_gas=400, r_in=0.2), dict(n_gas=20000)):
        for g, w in zip(disc_ics(**kw), j_disc_ics(**kw)):
            np.testing.assert_array_equal(g, w)


def test_sink_accretion_conserves_mass_momentum():
    """tests/test_features.py::test_sink_accretion_conserves_mass_momentum
    on the port: the unperturbed ICs, sinks only, 20 sync points."""
    cfg = port_cfg(SofteningBndry=0.05, SinkAccretionRadius=0.35,
                   MaxSizeTimestep=0.01)
    sim = Simulation(cfg, SimOptions(sinks=True), "cpu")
    pos, vel, mass, ptype, u = disc_ics(n_gas=400, r_in=0.2)
    sim.set_ics(pos, vel, mass, ptype, u=u)
    sim.state = register_sinks_from_types(sim.state)
    d0 = to_numpy(sim.state)
    sim.step(20)
    d1 = to_numpy(sim.state)
    n_acc = int(d1["sinks.n_accreted"].sum())
    assert n_acc > 0, "no accretion happened in the test setup"
    assert _alive_mass(d1) == pytest.approx(_alive_mass(d0), rel=1e-5)
    assert d1["p.alive"].sum() == d0["p.alive"].sum() - n_acc

