"""Sinks and Stamatellos cooling on the port's slab step (``parallel/``),
on rings of two gloo processes, from test_spmd_sinks.py's ICs at n_side 8
(the JAX test runs 16, marked slow): lcdm gas and three heavy sinks, one
inside a slab, one on the inner face and one on the periodic wrap, with
uniform slab edges. Accretion alone, and with ``SinkFormationDensity`` at
the gas density's 99th percentile (and the JAX test's SinkAccretionRadius)
so that sinks form, with Stamatellos cooling; held by pid to the
port's single-device step (tallies by sink PID, survivors, masses,
velocities, total mass, the in-step potential, the registry's round trip
through ``spmd_to_canonical``) and, for accretion, to the JAX package's
slab step with ``use_pallas="off"``. Stamatellos cooling is held to the
single device only: the JAX slab step reads the registry's
PIDs as rows of each chunk there (ROADMAP queue 3), and the last test shows
what the port does instead.

Every run starts from the state the JAX package's ``set_ics`` gives (with
the sinks registered), carried across with ``core/state.py ::
from_numpy``; each ring is spawned once (one thread a rank)."""

import dataclasses

import numpy as np
import pytest
import torch

from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.config import parse_parameter_text as jparse
from gadget_leicester_tpu.models.ics import lcdm_gas_ics
from gadget_leicester_tpu.models.simulation import Simulation as JSimulation
from gadget_leicester_tpu.models.sinks import register_sinks_from_types
from gadget_leicester_tpu.parallel import spmd as jspmd
from gadget_leicester_tpu.parallel.mesh import make_mesh
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.core.state import from_numpy
from gadget_leicester_tpu_torch.models.cooling import \
    sink_potential_correction
from gadget_leicester_tpu_torch.models.simulation import sync_point_step
from gadget_leicester_tpu_torch.parallel import launch
from gadget_leicester_tpu_torch.parallel import spmd

BOX = 50000.0
N_SIDE = 8
D = 2
# test_spmd_sinks.py's parameters, with SinkAccretionRadius at the same
# share of the mean spacing (BOX / 16 at n_side 16): about four gas within
# reach of each sink
PARAM = f"""
InitCondFile x
OutputDir  /tmp/spmd_sink_test
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
SofteningBndry 100
SofteningGasMaxPhys  100
SofteningHaloMaxPhys 100
SofteningBndryMaxPhys 100
MinGasHsmlFractional 0.1
SinkAccretionRadius {BOX / 8}
"""
N_STEPS = 2
EDGES = np.linspace(0.0, BOX, D + 1)
OPTS = dict(periodic=True, pmgrid=24, gravity_mode="treepm",
            sph_backend="blocks", sph_capacity=16, sinks=True)
COOL_OPTS = dict(OPTS, cooling="stamatellos")
# test_spmd_sinks.py's bounds; the potential and the velocities of the
# gas as test_torch_spmd.py holds the slab step to one device
MASS_RTOL = 1e-5
VEL_TOL = 2e-3
TOTAL_RTOL = 1e-6
TOL_SINGLE = 5e-4
FORM_PERCENTILE = 99
RING_TIMEOUT = 900


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ics_with_sinks(cfg, n_side, edges):
    """test_spmd_sinks.py::_ics_with_sinks: lcdm gas (its dark matter
    dropped) and 3 sinks of 50 times the gas mass, inside slab 0, on the
    face edges[1] and on the periodic wrap, the gas within 0.9
    SinkAccretionRadius of each falling in at 50 km/s."""
    pos, vel, mass, ptype, u = lcdm_gas_ics(
        n_side=n_side, box=BOX, omega0=0.3, omega_b=0.04,
        hubble=cfg.hubble_internal, g=cfg.grav_internal)
    ngas = n_side ** 3
    pos, vel, mass, ptype, u = (pos[:ngas], vel[:ngas], mass[:ngas],
                                ptype[:ngas], u[:ngas])
    s_pos = np.array([[0.38 * BOX, 0.5 * BOX, 0.5 * BOX],
                      [float(edges[1]), 0.3 * BOX, 0.6 * BOX],
                      [0.0, 0.7 * BOX, 0.2 * BOX]], np.float32)
    s_mass = np.full(3, float(np.sum(mass)) * 50.0, np.float32)
    r_acc = cfg.sink_accretion_radius
    for sp in s_pos:
        d = pos - sp[None, :]
        d -= BOX * np.round(d / BOX)
        r = np.sqrt(np.sum(d * d, axis=1))
        near = r < 0.9 * r_acc
        vel[near] = (-d[near] / np.maximum(r[near], 1.0)[:, None]) * 50.0
    return (np.concatenate([pos, s_pos]),
            np.concatenate([vel, np.zeros((3, 3), np.float32)]),
            np.concatenate([mass, s_mass]),
            np.concatenate([ptype, np.full(3, 5, np.int32)]), u)


def _jax_dict(st):
    out = {}
    for g in ("p", "gas", "sinks"):
        sub = getattr(st, g)
        for f in dataclasses.fields(sub):
            out[f"{g}.{f.name}"] = np.asarray(getattr(sub, f.name))
    for k in ("ti_current", "pm_ti_endstep", "pm_ti_begstep",
              "overflow_flags"):
        out[k] = np.asarray(getattr(st, k))
    return out


@pytest.fixture(scope="module")
def init():
    """The JAX package's ``set_ics`` of the ICs, the sinks registered:
    (the state as a dict, the formation threshold, the JAX state)."""
    cfg = jparse(PARAM)
    sim = JSimulation(cfg, JOptions(periodic=True, pmgrid=24,
                                    gravity_mode="treepm",
                                    sph_backend="cells", use_pallas="off",
                                    sinks=True))
    pos, vel, mass, ptype, u = ics_with_sinks(cfg, N_SIDE, EDGES)
    sim.set_ics(pos, vel, mass, ptype, u=u)
    st = register_sinks_from_types(sim.state)
    rho = np.asarray(st.gas.density)[:N_SIDE ** 3]
    return _jax_dict(st), float(np.percentile(rho, FORM_PERCENTILE)), st


def _case(name, init):
    """(options, config fields replaced) of a case: accretion alone, or
    formation with Stamatellos cooling."""
    if name == "accretion":
        return OPTS, None
    # the JAX test's radius: at BOX / 8 a candidate always has deeper gas
    # within reach, and none forms
    return COOL_OPTS, {"sink_formation_density": init[1],
                       "sink_accretion_radius": BOX / 16}


_SINGLE, _RING = {}, {}


def single(name, init):
    """The port's single-device step from the same state, by pid."""
    if name not in _SINGLE:
        opts_kw, cfg_kw = _case(name, init)
        cfg = parse_parameter_text(PARAM)
        if cfg_kw:
            cfg = cfg.replace(**cfg_kw)
        st = dataclasses.replace(from_numpy(init[0], "cpu"), grids=None)
        steps = []
        for _ in range(N_STEPS):
            st = sync_point_step(st, cfg, SimOptions(**opts_kw))
            steps.append(launch._by_pid(st))
        assert int(st.overflow_flags) == 0
        _SINGLE[name] = (steps[-1], int(st.ti_current), steps)
    return _SINGLE[name]


def ring(name, init):
    """The port's slab step on a ring of two at the uniform edges."""
    if name not in _RING:
        opts_kw, cfg_kw = _case(name, init)
        _RING[name] = launch.spawn(
            launch.slab_run, D,
            (PARAM, opts_kw, init[0], N_STEPS, "cpu", EDGES, cfg_kw, True),
            timeout=RING_TIMEOUT)[0]
    return _RING[name]


@pytest.fixture(scope="module")
def jax_slab(init):
    """The JAX package's slab step at d = 2 (``use_pallas="off"``) on the
    uniform edges, accretion alone: (by pid, tallies by sink pid, the
    overflow bits); a particle the reference duplicated in its migration
    counted once."""
    cfg = jparse(PARAM)
    opts = JOptions(periodic=True, pmgrid=24, gravity_mode="treepm",
                    sph_backend="cells", use_pallas="off", sinks=True)
    mesh = make_mesh(D)
    jst = init[2]
    mw = jspmd.spmd_min_width(cfg, opts, jst.gas.n_gas_max)
    st, caps, edges = jspmd.to_spmd(jst, mesh, cfg, edges=EDGES,
                                    min_width=mw)
    step = jspmd.make_spmd_step(cfg, opts, mesh, edges=edges)(st)
    for _ in range(N_STEPS):
        st = step(st)
    slot = np.asarray(st.sinks.slot)
    tallies = {int(q): (float(st.sinks.acc_mass[k]),
                        int(st.sinks.n_accreted[k]))
               for k, q in enumerate(slot) if q >= 0}
    canon = jspmd.spmd_to_canonical(st, *caps)
    alive = np.asarray(canon.p.alive)
    pid = np.asarray(canon.p.pid)[alive]
    # at d = 2 the reference sends a migrating particle both ways (ROADMAP
    # queue 3), so a pid may be alive twice: its first copy is kept
    pid, first = np.unique(pid, return_index=True)
    assert len(first) >= len(alive[alive]) - 4
    by_pid = {"pid": pid, **{
        f: np.asarray(getattr(canon.p, f))[alive][first]
        for f in ("mass", "vel", "ptype", "pos")}}
    return by_pid, tallies, int(st.overflow_flags)


def _tallies(res):
    """{sink pid: (acc_mass, n_accreted)} of a by-pid result."""
    return {q: (m, k) for q, m, k in res["sinks"].values()}


def _hold_sinks(got, want, got_tally, want_tally, what):
    """test_spmd_sinks.py's checks: the same survivors and types, sink
    masses within 1e-5, sink velocities within 2e-3 of their largest,
    equal tallies by sink PID (acc_mass within 1e-5)."""
    assert np.array_equal(got["pid"], want["pid"]), (
        what, "survivors differ", sorted(set(got["pid"].tolist())
                                         ^ set(want["pid"].tolist())))
    np.testing.assert_array_equal(got["ptype"], want["ptype"], err_msg=what)
    np.testing.assert_allclose(got["mass"], want["mass"], rtol=MASS_RTOL,
                               err_msg=what)
    sel = want["ptype"] == 5
    vscale = max(np.abs(want["vel"][sel]).max(), 1e-30)
    np.testing.assert_allclose(got["vel"][sel], want["vel"][sel],
                               atol=VEL_TOL * vscale, rtol=0, err_msg=what)
    assert set(got_tally) == set(want_tally), what
    for q, (m, k) in want_tally.items():
        assert got_tally[q][1] == k, (what, q)
        np.testing.assert_allclose(got_tally[q][0], m, rtol=MASS_RTOL,
                                   err_msg=f"{what}: sink {q}")


@pytest.mark.parametrize("name", ["accretion", "formation"])
def test_slab_sinks_match_single_device(init, name):
    """Accretion (and formation with Stamatellos cooling) on a ring of two
    against the port's single-device step by pid: survivors, sink masses and velocities,
    tallies by sink PID, total mass, gas positions and velocities within
    5e-4, no overflow; every sink has a registry slot on both."""
    got = ring(name, init)
    want, ti, _ = single(name, init)
    assert got["overflow"] == 0 and got["ti_current"] == ti
    _hold_sinks(got, want, _tallies(got), _tallies(want), name)
    n_acc = sum(k for _, k in _tallies(want).values())
    assert n_acc > 0, "no gas was accreted"
    m0 = float(np.sum(init[0]["p.mass"][init[0]["p.alive"]]))
    for res in (got, want):
        np.testing.assert_allclose(res["mass"].sum(dtype=np.float64), m0,
                                   rtol=TOTAL_RTOL)
    dpos = got["pos"] - want["pos"]
    dpos -= BOX * np.round(dpos / BOX)
    assert np.abs(dpos).max() / (BOX / N_SIDE) < TOL_SINGLE
    vscale = np.abs(want["vel"]).max()
    np.testing.assert_allclose(got["vel"], want["vel"],
                               atol=TOL_SINGLE * vscale, rtol=0)
    if name == "formation":
        assert len(want["sinks"]) > 3, "no sink formed"


def test_slab_formation_potential_matches_single_device(init):
    """The in-step potential that formation reads (kernel A's slab mode
    with the potential, the mesh's, the self-term) by pid against the
    single-device step's after the first sync point, at which every
    particle is active (an inactive particle's short-range part is that of
    its tile's activity, which the two grids tile differently), within
    5e-4 of the largest |pot|."""
    got = ring("formation", init)["steps"][0]
    want = single("formation", init)[2][0]
    np.testing.assert_array_equal(got["pid"], want["pid"])
    assert np.all(want["ti_begstep"] == want["ti_begstep"][0])
    scale = np.abs(want["pot"]).max()
    np.testing.assert_allclose(got["pot"], want["pot"],
                               atol=TOL_SINGLE * scale, rtol=0)


def test_slab_sinks_match_jax_slab_step(init, jax_slab):
    """Accretion on the port's ring of two against the JAX package's slab
    step at d = 2 on the same edges, by pid and by sink PID."""
    got = ring("accretion", init)
    want, want_tally, ovf = jax_slab
    assert ovf == got["overflow"] == 0
    _hold_sinks(got, want, _tallies(got), want_tally, "against JAX")


def test_slab_registry_round_trip(init):
    """The registry holds PIDs on slabs (``to_spmd``) and rows again in
    the canonical layout (``spmd_to_canonical``), each row the alive sink
    of that PID, formed sinks included."""
    cfg = parse_parameter_text(PARAM)
    st = from_numpy(init[0], "cpu")
    full, caps, _ = spmd.to_spmd(st, D, cfg, edges=EDGES)
    rows = st.sinks.slot.numpy()
    pids = full.sinks.slot.numpy()
    used = rows >= 0
    np.testing.assert_array_equal(pids[used], st.p.pid.numpy()[rows[used]])
    assert np.all(pids[~used] == -1)
    back = spmd.spmd_to_canonical(full, *caps)
    brow = back.sinks.slot.numpy()
    np.testing.assert_array_equal(back.p.pid.numpy()[brow[used]], pids[used])
    assert np.all(back.p.ptype.numpy()[brow[used]] == 5)
    got = ring("formation", init)
    canon = got["sinks"]
    assert [q for q, _, _ in canon.values()] == \
        [int(q) for q in got["slot_pids"] if q >= 0]


def test_slab_stamatellos_matches_single_device(init):
    """Stamatellos cooling with the sinks (the formation case) on a ring of
    two (the point-mass term over the ring's sinks) against the
    single-device step by pid: dt_entropy and entropy of the gas the last
    sync point kicked in both (cooling adds to every gas particle's
    dt_entropy, hydro to the active ones') within 5e-4 of their
    largest."""
    got = ring("formation", init)
    want, ti, _ = single("formation", init)
    np.testing.assert_array_equal(got["gas.pid"], want["gas.pid"])
    kicked = np.intersect1d(want["pid"][want["ti_begstep"] == ti],
                            got["pid"][got["ti_begstep"] == ti])
    act = np.isin(want["gas.pid"], kicked)
    assert act.sum() > 0
    for f in ("gas.dt_entropy", "gas.entropy"):
        scale = np.abs(want[f][act]).max()
        np.testing.assert_allclose(got[f][act], want[f][act],
                                   atol=TOL_SINGLE * scale, rtol=0,
                                   err_msg=f)


def test_slab_cooling_takes_the_ring_sinks(init):
    """The departure from the JAX slab step: the point-mass term of each
    rank's gas sums the registered sinks of the whole ring, gathered by
    PID; rank 0's gas feels the sink rank 1 holds (its term differs from
    that of rank 0's own sinks alone), and each rank's term equals the
    single device's by pid."""
    res = launch.spawn(launch.cooling_probe, D,
                       (PARAM, OPTS, init[0], EDGES), timeout=RING_TIMEOUT)
    cfg = parse_parameter_text(PARAM)
    st = from_numpy(init[0], "cpu")
    ng = st.n_gas_max
    gas = (st.p.alive[:ng] & (st.p.ptype[:ng] == 0)).numpy()
    ref = sink_potential_correction(st, cfg, SimOptions(**OPTS), ng).numpy()
    ref_by = dict(zip(st.p.pid[:ng].numpy()[gas], ref[gas]))
    assert len(res[0]["held"]) and len(res[1]["held"])
    for r in res:
        want = np.array([ref_by[q] for q in r["gas_pid"]])
        np.testing.assert_allclose(r["ring"], want, rtol=1e-5)
    other = res[0]["ring"] - res[0]["own"]
    assert np.abs(other).max() > 1e-3 * np.abs(res[0]["ring"]).max()
