"""The fork's cooling on the CPU: the Bell & Lin opacity and
``apply_cooling`` (beta, with and without a registered sink, and
Stamatellos) of the port against the JAX package's on the same inputs,
and the signs the reference's own tests pin (tests/test_features.py::
test_beta_cooling_cools, ::test_stamatellos_cooling_sign)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.models import cooling as jcool
from gadget_leicester_tpu.models.ics import disc_ics
from gadget_leicester_tpu.models.simulation import Simulation as JSimulation
from gadget_leicester_tpu.models.sinks import \
    register_sinks_from_types as j_register
from gadget_leicester_tpu_torch.core.config import SimOptions
from gadget_leicester_tpu_torch.core.state import from_numpy
from gadget_leicester_tpu_torch.models import cooling
from gadget_leicester_tpu_torch.models.simulation import Simulation
from gadget_leicester_tpu_torch.models.sinks import register_sinks_from_types
from tests.test_features import _cfg as j_cfg
from tests.test_torch_slice import _jax_dict
from tests.test_torch_sinks import port_cfg


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_bell_lin_opacity_matches_jax():
    """A log grid of (rho, T) from 1e-18 to 1e-2 g/cm^3 and 1 K to 1e7 K
    crosses every one of the eight regimes and their seven boundaries.
    Both packages take kappa = exp(ln k0 + a ln rho + b ln T) in float32,
    where exp turns one rounding of ln T (1.9e-6 at ln T = 16) times |b|
    (up to 24) into a relative error: each stands 2.2e-5 from the same
    formula in float64 on this grid, their float32 log and exp round
    apart, and they differ by up to 1.5e-5 of the value. So the port is
    held within 3e-5 of the JAX package, and no farther from the float64
    evaluation than 1.5 times the JAX package is (a wrong regime is an
    O(1) error: the opacity is continuous at a boundary, so a choice that
    flips there by one rounding changes the value by less)."""
    rho = np.logspace(-18, -2, 41)
    temp = np.logspace(0, 7, 301)
    r, t = (a.astype(np.float32).ravel() for a in np.meshgrid(rho, temp))
    got = cooling.bell_lin_opacity(torch.from_numpy(r),
                                   torch.from_numpy(t)).numpy()
    want = np.asarray(jcool.bell_lin_opacity(jnp.asarray(r), jnp.asarray(t)))
    exact = cooling.bell_lin_opacity(torch.from_numpy(r).double(),
                                     torch.from_numpy(t).double()).numpy()
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=0)
    jax_err = np.abs(want / exact - 1).max()
    assert np.abs(got / exact - 1).max() <= max(1e-5, 1.5 * jax_err)
    # every regime is met on the grid
    logk = [np.log(k0) + a * np.log(r.astype(np.float64))
            + b * np.log(t.astype(np.float64))
            for k0, a, b in cooling.BELL_LIN]
    hit = {int(np.argmin(np.abs(np.log(g) - np.array(logk)[:, i])))
           for i, g in enumerate(got.astype(np.float64))}
    assert hit == set(range(len(cooling.BELL_LIN)))


def test_bell_lin_opacity_regimes():
    """The regime scalings of tests/test_features.py on the port."""
    def k(rho, t):
        return float(cooling.bell_lin_opacity(torch.tensor(rho),
                                              torch.tensor(t)))
    assert k(1e-13, 10.0) == pytest.approx(2e-4 * 10.0 ** 2, rel=1e-5)
    assert k(1e-13, 50.0) == pytest.approx(2e-4 * 50.0 ** 2, rel=1e-5)
    assert k(1e-6, 1e7) == pytest.approx(0.348, rel=1e-5)


def _disc_state(**extra):
    """A disc_ics(n_gas=300) state initialised by the JAX package (direct
    gravity, all-pairs SPH), and the same carried to the port."""
    jcfg = j_cfg(SofteningBndry=0.05, MaxSizeTimestep=0.01, **extra)
    jsim = JSimulation(jcfg, JOptions())
    pos, vel, mass, ptype, u = disc_ics(n_gas=300)
    jsim.set_ics(pos, vel, mass, ptype, u=u)
    return jsim.state, from_numpy(_jax_dict(jsim.state), "cpu")


@pytest.fixture(scope="module")
def disc():
    jst, st = _disc_state()
    return dict(jst=jst, st=st, jst_sink=j_register(jst),
                st_sink=register_sinks_from_types(st))


@pytest.mark.parametrize("mode,sink,tbg", [
    ("beta", False, 10.0), ("beta", True, 10.0),
    ("stamatellos", False, 1.0), ("stamatellos", True, 1.0),
    ("stamatellos", True, 1e7)])
def test_apply_cooling_matches_jax(disc, mode, sink, tbg):
    """dt_entropy after apply_cooling, on one carried state: within 1e-5
    of the largest |dcool|; 0 where not gas. With a registered sink, beta
    cooling takes its position and mass and Stamatellos takes its point
    mass out of psi (a vacuum run: no minimum image)."""
    extra = dict(CoolingBeta=1.0, CoolingTbg=tbg)
    jcfg, cfg = j_cfg(SofteningBndry=0.05, **extra), \
        port_cfg(SofteningBndry=0.05, **extra)
    jst = disc["jst_sink" if sink else "jst"]
    st = disc["st_sink" if sink else "st"]
    want = np.asarray(jcool.apply_cooling(jst, jcfg, JOptions(cooling=mode))
                      .gas.dt_entropy) - np.asarray(jst.gas.dt_entropy)
    got = (cooling.apply_cooling(st, cfg, SimOptions(cooling=mode))
           .gas.dt_entropy - st.gas.dt_entropy).numpy()
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    ng = st.n_gas_max
    gas = (st.p.alive[:ng] & (st.p.ptype[:ng] == 0)).numpy()
    assert not got[~gas].any()


def test_no_cooling_leaves_the_state(disc):
    st = disc["st"]
    assert cooling.apply_cooling(st, port_cfg(), SimOptions()) is st


def test_stamatellos_cooling_sign(disc):
    """Gas hotter than the background cools; colder gas heats toward it
    (tests/test_features.py::test_stamatellos_cooling_sign)."""
    st = disc["st"]
    ng = st.n_gas_max
    gm = (st.p.alive[:ng] & (st.p.ptype[:ng] == 0)).numpy()
    opts = SimOptions(cooling="stamatellos")
    before = st.gas.dt_entropy.numpy()
    cold_bg = port_cfg(SofteningBndry=0.05, CoolingTbg=1.0)
    dcool = (cooling.apply_cooling(st, cold_bg, opts).gas.dt_entropy.numpy()
             - before)[gm]
    assert np.all(dcool <= 0) and np.any(dcool < 0), "hot gas must cool"
    hot_bg = port_cfg(SofteningBndry=0.05, CoolingTbg=1e7)
    dheat = (cooling.apply_cooling(st, hot_bg, opts).gas.dt_entropy.numpy()
             - before)[gm]
    assert np.all(dheat >= 0) and np.any(dheat > 0), "cold gas must heat"


def test_beta_cooling_cools():
    """Disc gas under beta cooling loses entropy over 30 sync points
    (tests/test_features.py::test_beta_cooling_cools, on the port)."""
    cfg = port_cfg(SofteningBndry=0.05, CoolingBeta=1.0, MaxSizeTimestep=0.01)
    cfg = cfg.replace(art_bulk_visc_const=0.0)
    sim = Simulation(cfg, SimOptions(cooling="beta"), "cpu")
    pos, vel, mass, ptype, u = disc_ics(n_gas=400)
    sim.set_ics(pos, vel, mass, ptype, u=u)
    sim.state = register_sinks_from_types(sim.state)
    ng = sim.state.n_gas_max

    def entropy():
        p = sim.state.p
        gm = p.alive[:ng] & (p.ptype[:ng] == 0)
        return float(sim.state.gas.entropy[gm].sum())
    s0 = entropy()
    sim.step(30)
    assert entropy() < 0.95 * s0


def test_sink_correction_takes_the_minimum_image():
    """In a periodic box the port's point-mass term takes each sink at its
    nearest image; the reference's (cooling.py:108) takes the raw
    difference (ROADMAP queue 3). A gas particle 0.02 from a sink across
    the boundary of a unit box: -G m / 0.02 here, -G m / 0.98 there."""
    jcfg = j_cfg(BoxSize=1.0, PeriodicBoundariesOn=1)
    cfg = port_cfg(BoxSize=1.0, PeriodicBoundariesOn=1)
    pos = np.array([[0.99, 0.5, 0.5], [0.01, 0.5, 0.5]])
    vel = np.zeros((2, 3))
    mass = np.array([1e-3, 2.0])
    ptype = np.array([0, 5], np.int32)
    from gadget_leicester_tpu.core.state import from_arrays as j_from_arrays
    jst = j_register(j_from_arrays(pos, vel, mass, ptype, np.arange(1, 3),
                                   JOptions(periodic=True)))
    st = from_numpy(_jax_dict(jst), "cpu")
    got = float(cooling.sink_potential_correction(
        st, cfg, SimOptions(periodic=True), st.n_gas_max)[0])
    want = float(jcool._sink_potential_correction(jst, jcfg,
                                                  jst.gas.n_gas_max)[0])
    g = cfg.grav_internal
    assert got == pytest.approx(-g * 2.0 / 0.02, rel=1e-4)
    assert want == pytest.approx(-g * 2.0 / 0.98, rel=1e-4)
    vac = float(cooling.sink_potential_correction(
        st, cfg, SimOptions(periodic=False), st.n_gas_max)[0])
    assert vac == pytest.approx(want, rel=1e-6)


def test_stamatellos_reads_the_in_step_potential(disc):
    """Stamatellos reads p.pot: a deeper potential gives a larger column
    and, for gas hotter than the background, a smaller cooling rate in
    magnitude (the optically thick limit)."""
    st = disc["st"]
    cfg = port_cfg(SofteningBndry=0.05, CoolingTbg=1.0,
                   CoolingColumnFac=1e6)
    opts = SimOptions(cooling="stamatellos")
    deeper = dataclasses.replace(st, p=dataclasses.replace(
        st.p, pot=st.p.pot * 100.0))
    a = cooling.apply_cooling(st, cfg, opts).gas.dt_entropy - \
        st.gas.dt_entropy
    b = cooling.apply_cooling(deeper, cfg, opts).gas.dt_entropy - \
        st.gas.dt_entropy
    ng = st.n_gas_max
    gm = st.p.alive[:ng] & (st.p.ptype[:ng] == 0)
    assert bool((b[gm].abs() <= a[gm].abs()).all())
    assert bool((b[gm].abs() < a[gm].abs()).any())
