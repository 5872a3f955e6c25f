"""The port's vacuum slab step (``parallel/``: the domain cube, masked
outer-face ghosts, grids clamped on every axis, the free-space PM across
the ring) on rings of gloo processes, on test_spmd_vacuum.py's two
clumps (384 particles, pmgrid 24): against the JAX package's vacuum slab
step at d = 4 by pid; its first sync point's gravity against the dense
split of the same TreePM (the port's ``pm_forces_nonperiodic`` plus a
direct erfc-truncated pair sum); and, on the gas sphere of its gas test
(256 gas; the clumps as gas pack some 190 gas into one fine cell of the
domain's block grid, minutes a sync point through the plain versions),
d = 2 against d = 1 through the same vacuum code.

Every ring starts from the state the JAX package's ``set_ics`` gives
(carried across with ``core/state.py :: from_numpy``) and is spawned once
(``parallel/launch.py``, one thread a rank)."""

import dataclasses

import numpy as np
import pytest
import torch

from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.config import parse_parameter_text as jparse
from gadget_leicester_tpu.models.simulation import Simulation as JSimulation
from gadget_leicester_tpu.parallel import spmd as jspmd
from gadget_leicester_tpu_torch.core.config import parse_parameter_text
from gadget_leicester_tpu_torch.ops.gravity_direct import shortrange_trunc
from gadget_leicester_tpu_torch.ops.pm import (ASMTH, RCUT,
                                               pm_forces_nonperiodic)
from gadget_leicester_tpu_torch.ops.softening import SOFTFAC, grav_fac
from gadget_leicester_tpu_torch.parallel import launch

# test_spmd_vacuum.py's configuration
PARAM = """
InitCondFile x
OutputDir  /tmp/spmd_vac_test
TimeBegin  0.0
TimeMax    1.0
ComovingIntegrationOn 0
PeriodicBoundariesOn 0
BoxSize    0
ErrTolIntAccuracy 0.025
MaxSizeTimestep 0.01
CourantFac 0.15
DesNumNgb 33
MaxNumNgbDeviation 2
ArtBulkViscConst 0.8
InitGasTemp 100
MinGasTemp 5
SofteningGas  0.02
SofteningHalo 0.02
SofteningGasMaxPhys  0.02
SofteningHaloMaxPhys 0.02
MinGasHsmlFractional 0.05
"""
N_STEPS = 2
GAS_STEPS = 2
PMGRID = 24
# sr_capacity: the clump core packs one cell past the automatic capacity
# (test_spmd_vacuum.py's choice)
OPTS = dict(periodic=False, pmgrid=PMGRID, gravity_mode="treepm",
            sph_backend="blocks", sr_capacity=512)
# against the JAX slab step (test_torch_spmd.py's), against the dense
# split (test_spmd_vacuum.py's), d = 2 against d = 1 (its gas test's)
TOL_JAX = 2e-4
TOL_DENSE = 2e-3
TOL_RING = 5e-4
RING_TIMEOUT = 900


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def two_clumps(n=384, seed=3):
    """test_spmd_vacuum.py::_two_clumps: two off-centre Gaussian clumps."""
    rng = np.random.default_rng(seed)
    half = n // 2
    c1, c2 = np.array([-0.6, 0.1, -0.2]), np.array([0.7, -0.3, 0.4])
    p1 = c1 + 0.25 * rng.standard_normal((half, 3))
    p2 = c2 + 0.35 * rng.standard_normal((n - half, 3))
    pos = np.concatenate([p1, p2]).astype(np.float32)
    vel = 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    return pos, vel, mass


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


def _jax_by_pid(st):
    alive = np.asarray(st.p.alive)
    pid = np.asarray(st.p.pid)[alive]
    order = np.argsort(pid)
    return {"pid": pid[order],
            **{f: np.asarray(getattr(st.p, f))[alive][order]
               for f in ("pos", "vel", "acc", "acc_pm")}}


def _jax_init(ptype, u=None):
    """The JAX package's vacuum ring of 4 after ``set_ics`` on the clumps
    of type ``ptype``: (its canonical state as a dict, the
    simulation)."""
    cfg = jparse(PARAM)
    opts = JOptions(periodic=False, pmgrid=PMGRID, sph_backend="cells",
                    use_pallas="off", sr_capacity=512)
    pos, vel, mass = two_clumps()
    sim = JSimulation(cfg, opts, mesh=4)
    sim.set_ics(pos, vel, mass, ptype, u=u)
    init = _jax_dict(jspmd.spmd_to_canonical(sim.state, *sim.spmd_caps))
    return init, sim


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's vacuum slab step at d = 4 on the clumps (type
    1), N_STEPS sync points with ``use_pallas="off"``."""
    init, sim = _jax_init(np.ones(384, np.int32))
    dom = sim.spmd_domain
    sim.step(N_STEPS)
    st = jspmd.spmd_to_canonical(sim.state, *sim.spmd_caps)
    return dict(init=init, by_pid=_jax_by_pid(st), edges=sim.spmd_edges,
                domain=(np.asarray(dom[0]), float(dom[1])),
                overflow=int(st.overflow_flags),
                ti_current=int(st.ti_current))


@pytest.fixture(scope="module")
def ring4(jax_run):
    """The port's vacuum slab step at d = 4 from the JAX init state, its
    state after each sync point."""
    return launch.spawn(launch.slab_run, 4,
                        (PARAM, OPTS, jax_run["init"], N_STEPS, "cpu", None,
                         None, True),
                        timeout=RING_TIMEOUT)[0]


def _hold(got, want, tol, scale_pos, what):
    np.testing.assert_array_equal(got["pid"], want["pid"])
    err = np.abs(got["pos"] - want["pos"]).max() / scale_pos
    assert err < tol, (what, "pos", err)
    for f in ("vel", "acc"):
        scale = max(np.abs(want[f]).max(), 1e-30)
        np.testing.assert_allclose(got[f], want[f], atol=tol * scale, rtol=0,
                                   err_msg=f"{what}: {f}")


def test_vacuum_slab_step_d4_matches_jax(jax_run, ring4):
    """The port's vacuum slab step at d = 4 against the JAX package's at
    d = 4, by pid, within 2e-4 (position of the mean spacing over the
    domain, velocity and acc of their largest value); the same domain cube,
    slab edges and PM mesh, and no overflow."""
    got = ring4
    dom = jax_run["domain"]
    np.testing.assert_array_equal(got["domain"][0], dom[0])
    assert got["domain"][1] == dom[1]
    np.testing.assert_array_equal(got["edges"], jax_run["edges"])
    assert got["pmgrid"] == PMGRID
    assert got["overflow"] == jax_run["overflow"] == 0
    assert got["ti_current"] == jax_run["ti_current"]
    spacing = dom[1] / 384 ** (1.0 / 3.0)
    _hold(got, jax_run["by_pid"], TOL_JAX, spacing, "d = 4 against JAX")


def dense_split(pos, mass, soft, domain, pmgrid, g):
    """The vacuum TreePM split on one device, densely: the port's
    free-space mesh over the domain plus the erfc-truncated softened pair
    sum of every pair within rcut (test_spmd_vacuum.py's oracle)."""
    origin, extent = domain
    asmth = ASMTH * float(extent) / pmgrid
    rcut = RCUT * asmth
    p = torch.from_numpy(pos).double()
    m = torch.from_numpy(mass).double()
    alive = torch.ones(len(pos), dtype=torch.bool)
    acc_pm = pm_forces_nonperiodic(torch.from_numpy(pos),
                                   torch.from_numpy(mass), alive,
                                   torch.from_numpy(origin), float(extent),
                                   pmgrid).double()
    dx = p[:, None, :] - p[None, :, :]
    r = torch.sqrt((dx * dx).sum(-1))
    fac = grav_fac(r, torch.full_like(r, SOFTFAC * soft)) \
        * shortrange_trunc(r, asmth)
    fac = torch.where((r < rcut) & (r > 0), fac, torch.zeros_like(fac))
    acc_sr = -(fac[:, :, None] * dx * m[None, :, None]).sum(1)
    return ((acc_sr + acc_pm) * g).numpy()


def test_vacuum_slab_gravity_matches_dense_split(ring4):
    """The first sync point's gravity (every particle active, a PM step)
    of the port's vacuum ring of 4 against the dense split on the same
    domain, within 2e-3 of the largest value."""
    first = ring4["steps"][0]
    cfg = parse_parameter_text(PARAM)
    want = dense_split(first["pos"], first["mass"], cfg.softening_halo,
                       ring4["domain"], PMGRID, cfg.grav_internal)
    got = first["acc"] + first["acc_pm"]
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL_DENSE, err


def gas_sphere(n=256, seed=11):
    """test_spmd_vacuum.py::test_vacuum_spmd_gas_d4_matches_d1's sphere:
    r ~ U(0.05, 1)^(1/3), at rest, u = 0.05."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.05, 1.0, n) ** (1.0 / 3.0)
    u_dir = rng.standard_normal((n, 3))
    u_dir /= np.linalg.norm(u_dir, axis=1, keepdims=True)
    pos = (r[:, None] * u_dir).astype(np.float32)
    return (pos, np.zeros((n, 3), np.float32),
            np.full(n, 1.0 / n, np.float32), np.full(n, 0.05, np.float32))


@pytest.fixture(scope="module")
def gas_rings():
    """The gas sphere through the port's vacuum slab step on rings of 1
    and 2, GAS_STEPS sync points each, from the JAX init state."""
    cfg = jparse(PARAM)
    opts = JOptions(periodic=False, pmgrid=PMGRID, sph_backend="cells",
                    use_pallas="off")
    pos, vel, mass, u = gas_sphere()
    sim = JSimulation(cfg, opts, mesh=4)
    sim.set_ics(pos, vel, mass, np.zeros(len(pos), np.int32), u=u)
    init = _jax_dict(jspmd.spmd_to_canonical(sim.state, *sim.spmd_caps))
    opts_kw = dict(OPTS, sr_capacity=0)
    return {d: launch.spawn(launch.slab_run, d,
                            (PARAM, opts_kw, init, GAS_STEPS),
                            timeout=RING_TIMEOUT)[0]
            for d in (1, 2)}


def test_vacuum_gas_d2_matches_d1(gas_rings):
    """d = 2 (ghosts across the one inner face, masked at the outer ones)
    against d = 1 (every ghost its own and masked) through the same
    vacuum code: positions within 5e-4 of their scale, finite velocities,
    momentum kept to 5e-4 of sum |m v| (test_spmd_vacuum.py's gas test)."""
    one, two = gas_rings[1], gas_rings[2]
    assert one["overflow"] == two["overflow"] == 0
    assert one["ti_current"] == two["ti_current"]
    np.testing.assert_array_equal(one["pid"], two["pid"])
    scale = np.abs(one["pos"]).max()
    assert np.abs(one["pos"] - two["pos"]).max() / scale < TOL_RING
    assert np.isfinite(two["vel"]).all()
    mv = two["mass"][:, None] * two["vel"]
    assert np.abs(mv.sum(0)).max() < TOL_RING * np.abs(mv).sum()
    assert np.all(two["gas.density"] > 0)


def test_vacuum_escapee_sets_bit_4_and_the_refit_takes_it():
    """A particle that leaves the domain cube sets overflow bit 4 in the
    migration (a ring of one in this process), and the decomposition the
    run loop answers it with refits the cube around it."""
    from gadget_leicester_tpu_torch.core.config import SimOptions
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    pos, vel, mass = two_clumps()
    sim = Simulation(parse_parameter_text(PARAM), SimOptions(**OPTS), "cpu",
                     mesh=1)
    sim.set_ics(pos, vel, mass, np.ones(len(pos), np.int32))
    origin, extent, _ = sim.spmd_domain
    st = sim.state
    far = st.p.pos.clone()
    row = int(torch.nonzero(st.p.alive)[0])
    far[row] = torch.from_numpy(origin) + 1.5 * extent
    sim.state = dataclasses.replace(st, p=dataclasses.replace(st.p, pos=far))
    st = sim._spmd_step.migrate(sim.state)
    assert int(st.overflow_flags) & 4
    sim.state = dataclasses.replace(st, overflow_flags=torch.zeros_like(
        st.overflow_flags))
    sim._decompose()
    origin2, extent2, _ = sim.spmd_domain
    assert extent2 > extent
    cst = sim.canonical_state()
    rel = cst.p.pos[cst.p.alive].numpy() - origin2
    assert np.all((rel >= 0) & (rel < extent2))
    assert int(sim._spmd_step.migrate(sim.state).overflow_flags) == 0
