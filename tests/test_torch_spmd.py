"""The slab step of the port (``parallel/``) on rings of gloo processes:
against the JAX package's slab step on its virtual CPU devices, and
against the port's single-device step, by pid; the host layout and
geometry against the JAX package's; the migration and the dead-slot
insert.

The ring of one in this process (the slab grid cache) is in
test_torch_spmd_cache.py. The ranks run in spawned processes through
``parallel/launch.py`` (the
workers are the port's: a child imports no JAX and no test module), each
on one thread, with a timeout. Every run starts from the state the JAX
package's ``set_ics`` gives, carried across with ``core/state.py ::
from_numpy``, so the comparisons hold the steps alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.config import parse_parameter_text as jparse
from gadget_leicester_tpu.models.ics import lcdm_gas_ics
from gadget_leicester_tpu.models.simulation import Simulation as JSimulation
from gadget_leicester_tpu.parallel import spmd as jspmd
from gadget_leicester_tpu.parallel.mesh import make_mesh
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.core.state import from_numpy, to_numpy
from gadget_leicester_tpu_torch.models.simulation import sync_point_step
from gadget_leicester_tpu_torch.parallel import launch
from gadget_leicester_tpu_torch.parallel import spmd

BOX = 50000.0
PARAM = f"""
InitCondFile x
OutputDir  /tmp/spmd_test
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
N_SIDE = 8
N_STEPS = 2
OPTS = dict(periodic=True, pmgrid=24, gravity_mode="treepm",
            sph_backend="blocks")
# the slab runs take 16 slots a fine cell (about 2.4 gas a cell of the
# slab's 8,333 edge at this spacing; no overflow): a quarter of the pairs
# of the default 32, which the plain density sweeps of the capped h (40 a
# pass, as in the JAX package) pay on one thread a rank
SLAB_OPTS = dict(OPTS, sph_capacity=16)
# against the JAX slab step: test_spmd_pallas.py's bound; against the
# port's single-device step: test_spmd_step.py's. Position as a share of
# the mean spacing, velocity and acc of their largest value.
TOL_JAX = 2e-4
TOL_SINGLE = 5e-4
RING_TIMEOUT = 900


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
               for f in ("pos", "vel", "acc")}}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package: ``set_ics`` of lcdm_gas 2x8^3 (its jnp path), and
    its slab step at d = 4 for N_STEPS sync points with
    ``use_pallas="off"``; with the edges it chose."""
    cfg = jparse(PARAM)
    opts = JOptions(periodic=True, pmgrid=24, gravity_mode="treepm",
                    sph_backend="cells", use_pallas="off")
    sim = JSimulation(cfg, opts)
    pos, vel, mass, ptype, u = lcdm_gas_ics(
        n_side=N_SIDE, box=BOX, omega0=0.3, omega_b=0.04,
        hubble=cfg.hubble_internal, g=cfg.grav_internal)
    sim.set_ics(pos, vel, mass, ptype, u=u)
    init = _jax_dict(sim.state)
    mesh = make_mesh(4)
    mw = jspmd.spmd_min_width(cfg, opts, sim.state.gas.n_gas_max)
    st, caps, edges = jspmd.to_spmd(sim.state, mesh, cfg, min_width=mw)
    step = jspmd.make_spmd_step(cfg, opts, mesh, edges=edges)(st)
    for _ in range(N_STEPS):
        st = step(st)
    return dict(init=init, state=st, by_pid=_jax_by_pid(st), edges=edges,
                caps=caps, min_width=mw)


_RINGS = {}


def ring_run(jax_run, d, opts=None):
    """The port's slab step on d gloo ranks from the JAX init state (run
    once a module for each ring and options: SLAB_OPTS by default)."""
    opts = SLAB_OPTS if opts is None else opts
    key = (d, tuple(sorted(opts.items())))
    if key not in _RINGS:
        _RINGS[key] = launch.spawn(
            launch.slab_run, d, (PARAM, opts, jax_run["init"], N_STEPS),
            timeout=RING_TIMEOUT)[0]
    return _RINGS[key]


@pytest.fixture(scope="module")
def single_run(jax_run):
    """The port's single-device step from the same state (the same 16
    slots a fine cell: no overflow at its 12,500 edge)."""
    cfg = parse_parameter_text(PARAM)
    st = from_numpy(jax_run["init"], "cpu")
    st = dataclasses.replace(st, grids=None)
    for _ in range(N_STEPS):
        st = sync_point_step(st, cfg, SimOptions(**SLAB_OPTS))
    assert int(st.overflow_flags) == 0
    return launch._by_pid(st), int(st.ti_current)


def _hold(got, want, tol, what):
    np.testing.assert_array_equal(got["pid"], want["pid"])
    dpos = got["pos"] - want["pos"]
    dpos -= BOX * np.round(dpos / BOX)
    assert np.abs(dpos).max() / (BOX / N_SIDE) < tol, (what, "pos")
    for f in ("vel", "acc"):
        scale = max(np.abs(want[f]).max(), 1e-30)
        np.testing.assert_allclose(got[f], want[f], atol=tol * scale, rtol=0,
                                   err_msg=f"{what}: {f}")


def test_slab_step_d4_matches_jax(jax_run):
    """The port's slab step at d = 4 (gloo) against the JAX package's at
    d = 4, by pid, within 2e-4; the same slab edges and overflow-free."""
    got = ring_run(jax_run, 4)
    np.testing.assert_array_equal(got["edges"], jax_run["edges"])
    assert got["caps"] == tuple(jax_run["caps"])
    assert got["overflow"] == 0
    assert got["ti_current"] == int(jax_run["state"].ti_current)
    _hold(got, jax_run["by_pid"], TOL_JAX, "d = 4 against JAX")


@pytest.mark.parametrize("d", [2, 4])
def test_slab_step_matches_single_device(jax_run, single_run, d):
    """The port's slab step at d ranks against its own single-device
    step from the same state, by pid, within 5e-4."""
    got = ring_run(jax_run, d)
    want, ti = single_run
    assert got["overflow"] == 0 and got["ti_current"] == ti
    _hold(got, want, TOL_SINGLE, f"d = {d} against one device")


# the coarse-cell branch: the JAX run's own (use_pallas off, 64 slots a
# cell); 16 slots hold the slab's cells here (about 4 gas a cell of the
# 10,000 edge, none overflows) at a quarter of the pairs of 32, as the
# capped h's 40 density sweeps are paid on one thread a rank
CELLS_OPTS = dict(SLAB_OPTS, sph_backend="cells")


def test_slab_cells_d4_matches_jax(jax_run):
    """``sph_backend="cells"`` on the slab step at d = 4 (gloo; kernels I/J
    and K's ghost-row mode, their plain versions here) against the JAX
    package's slab step at d = 4 with ``use_pallas="off"``, whose coarse
    cells it mirrors, by pid, within 2e-4; the same edges, no overflow."""
    got = ring_run(jax_run, 4, CELLS_OPTS)
    np.testing.assert_array_equal(got["edges"], jax_run["edges"])
    assert got["overflow"] == 0
    assert got["ti_current"] == int(jax_run["state"].ti_current)
    _hold(got, jax_run["by_pid"], TOL_JAX, "cells, d = 4 against JAX")


@pytest.fixture(scope="module")
def cells_ring_of_one(jax_run):
    """The coarse-cell branch on a ring of one in this process (gloo),
    N_STEPS sync points from the JAX init state with every kernel call
    recorded, and the port's single-device ``sph_backend="cells"`` step
    from the same state; 48 slots a slab cell (about 19 gas a cell of the
    16,667 edge, which is also the single device's, so neither caps h)."""
    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg = parse_parameter_text(PARAM)
    opts = SimOptions(**dict(OPTS, sph_backend="cells", sph_capacity=48))
    ring = Simulation(cfg, opts, "cpu", mesh=1)
    ring.state = from_numpy(jax_run["init"], "cpu")
    ring._decompose()
    kernels.history = []
    try:
        ring.step(N_STEPS)
        calls = [name for name, _ in kernels.history]
    finally:
        kernels.history = None
    st = dataclasses.replace(from_numpy(jax_run["init"], "cpu"), grids=None)
    for _ in range(N_STEPS):
        st = sync_point_step(st, cfg, opts)
    assert int(st.overflow_flags) == int(ring.state.overflow_flags) == 0
    return (launch._by_pid(ring.canonical_state()), int(ring.state.ti_current),
            calls, launch._by_pid(st), int(st.ti_current),
            ring._spmd_step.geometry(ring.state))


def test_slab_cells_ring_of_one_matches_single_device(cells_ring_of_one):
    """The coarse-cell branch on a ring of one against the port's
    single-device coarse-cell step from the same state, by pid, within
    5e-4."""
    got, ti, _, want, ti_want, _ = cells_ring_of_one
    assert ti == ti_want
    _hold(got, want, TOL_SINGLE, "cells, a ring of one against one device")


def test_slab_cells_takes_the_cells_branch(cells_ring_of_one):
    """``sph_backend="cells"`` on slabs runs kernels I/J and K in their
    ghost-row mode, never the blocks' C and D: each density sweep and
    hydro pass of the sync points called the ``_slab`` wrappers, on the
    (nx, n, n) grid of the geometry, clamped in x; the blocks stay the
    branch of every other backend."""
    _, _, calls, _, _, geo = cells_ring_of_one
    assert "sph_cells_density_slab" in calls
    assert calls.count("sph_cells_hydro_slab") == N_STEPS
    assert not {"sph_density_aniso", "sph_hydro_aniso", "sph_cells_density",
                "sph_cells_hydro"} & set(calls)
    assert geo["n_c"] == 3 and geo["nx_c"] == 5 and geo["cap_c"] == 48
    cfg = parse_parameter_text(PARAM)
    for backend, cells in (("cells", True), ("blocks", False),
                           ("auto", False), ("dense", False)):
        step = spmd.SpmdStep(cfg, SimOptions(**dict(OPTS,
                                                    sph_backend=backend)),
                             _FakeRing(), np.array([0.0, BOX]))
        assert step.cells is cells
    with pytest.raises(ValueError, match="unknown sph_backend"):
        spmd.check_slab_supported(SimOptions(**dict(OPTS,
                                                    sph_backend="tree")))


class _FakeRing:
    """The rank, size and device of a ring of one, for a step that is
    built and never run."""
    rank, size, device = 0, 1, torch.device("cpu")


def test_to_spmd_round_trip_exact(jax_run):
    """to_spmd then spmd_to_canonical gives the state back exactly (the
    alive rows and all their fields), and each chunk holds its slab's
    particles only, gas first."""
    cfg = parse_parameter_text(PARAM)
    st = from_numpy(jax_run["init"], "cpu")
    full, caps, edges = spmd.to_spmd(st, 4, cfg,
                                     min_width=jax_run["min_width"])
    back = spmd.spmd_to_canonical(full, *caps)
    a, b = to_numpy(st), to_numpy(back)
    alive = a["p.alive"]
    order_a = np.argsort(a["p.pid"][alive])
    alive_b = b["p.alive"]
    order_b = np.argsort(b["p.pid"][alive_b])
    for k in a:
        if k.startswith("p."):
            np.testing.assert_array_equal(a[k][alive][order_a],
                                          b[k][alive_b][order_b], err_msg=k)
    ng = st.n_gas_max
    ga = a["p.alive"][:ng] & (a["p.ptype"][:ng] == 0)
    gb = b["p.alive"][:back.n_gas_max] & (b["p.ptype"][:back.n_gas_max] == 0)
    oa = np.argsort(a["p.pid"][:ng][ga])
    ob = np.argsort(b["p.pid"][:back.n_gas_max][gb])
    for k in a:
        if k.startswith("gas.") and k not in ("gas.hsml",
                                              "gas.dhsml_density_factor"):
            np.testing.assert_array_equal(a[k][ga][oa], b[k][gb][ob],
                                          err_msg=k)
    stride = sum(caps)
    for r in range(4):
        ch = spmd.local_chunk(full, r, caps)
        x = np.mod(ch.p.pos[:, 0].numpy(), BOX)[ch.p.alive.numpy()]
        assert ((x >= edges[r]) & (x < edges[r + 1])).all()
        assert ch.n_max == stride and ch.n_gas_max == caps[0]
        assert (ch.p.ptype[:caps[0]][ch.p.alive[:caps[0]]] == 0).all()


def test_host_geometry_equals_jax(jax_run):
    """balance_edges, spmd_min_width and slab_grid_geom equal the JAX
    package's (the latter with its kernels on, the branch the port
    takes)."""
    cfg, jcfg = parse_parameter_text(PARAM), jparse(PARAM)
    opts = SimOptions(**OPTS)
    jopts = JOptions(**OPTS, use_pallas="on")
    init = jax_run["init"]
    ng = init["gas.hsml"].shape[0]
    assert spmd.spmd_min_width(cfg, opts, ng) == \
        jspmd.spmd_min_width(jcfg, jopts, ng)
    rng = np.random.default_rng(3)
    x = rng.uniform(0, BOX, 4000)
    alive = rng.uniform(size=4000) > 0.2
    for d, mw in ((4, 0.0), (4, 13000.0), (3, 20000.0), (2, 0.0)):
        np.testing.assert_array_equal(
            spmd.balance_edges(x, alive, BOX, d, mw),
            jspmd.balance_edges(x, alive, BOX, d, mw))
    for d, w_min, w_max, n_loc, ng_loc in ((4, 12500.0, 12500.0, 432, 216),
                                           (2, 20000.0, 30000.0, 800, 400),
                                           (1, BOX, BOX, 1800, 900)):
        got = spmd.slab_grid_geom(cfg, opts, d, BOX, w_min, w_max, n_loc,
                                  ng_loc)
        want = jspmd.slab_grid_geom(jcfg, jopts, d, BOX, w_min, w_max, True,
                                    n_loc, ng_loc)
        assert got == want


def test_insert_into_dead_ranks_valid_arrivals():
    """test_spmd_step.py's case: arrivals go in by their rank among the
    valid rows, not their buffer position; one arrival too many
    overflows."""
    n, mcap = 16, 8
    alive = torch.ones(n, dtype=torch.bool)
    alive[[3, 7]] = False
    valid_in = torch.zeros(2 * mcap, dtype=torch.bool)
    valid_in[[mcap, mcap + 1]] = True
    vals = torch.zeros(2 * mcap)
    vals[mcap], vals[mcap + 1] = 101.0, 102.0
    field = torch.arange(n, dtype=torch.float32)
    (out,), alive_new, ovf = spmd._insert_into_dead([field], alive, [vals],
                                                    valid_in)
    assert not bool(ovf)
    assert bool(alive_new.all())
    assert sorted(float(out[i]) for i in (3, 7)) == [101.0, 102.0]
    valid_in[mcap + 2] = True
    _, _, ovf = spmd._insert_into_dead([field], alive, [vals], valid_in)
    assert bool(ovf)


def test_migration_moves_across_a_face(jax_run):
    """On 4 ranks: a particle moved one slab over migrates to that rank,
    the count and the pids kept, no overflow; one moved two slabs over
    sets bit 4."""
    init = jax_run["init"]
    edges = jax_run["edges"]
    alive = init["p.alive"]
    x = np.mod(init["p.pos"][:, 0], BOX)
    in0 = np.where(alive & (x >= edges[0]) & (x < edges[1]))[0]
    hop, jump = int(init["p.pid"][in0[0]]), int(init["p.pid"][in0[1]])
    mid = 0.5 * (edges[1] + edges[2])
    far = 0.5 * (edges[2] + edges[3])
    res = launch.spawn(launch.migrate_probe, 4,
                       (PARAM, SLAB_OPTS, init, {hop: mid}),
                       timeout=RING_TIMEOUT)[0]
    before, after = res["before"], res["after"]
    assert res["overflow"] == 0
    assert sorted(sum(before, [])) == sorted(sum(after, []))
    assert hop in before[0] and hop not in after[0] and hop in after[1]
    assert len(after[0]) == len(before[0]) - 1
    res = launch.spawn(launch.migrate_probe, 4,
                       (PARAM, SLAB_OPTS, init, {jump: far}),
                       timeout=RING_TIMEOUT)[0]
    assert res["overflow"] & 4
