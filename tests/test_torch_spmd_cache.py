"""The slab step of the port (``parallel/spmd.py``) on a ring of one in
this process (``Simulation(..., mesh=1)``, a gloo group of one): the slab
grid cache against fresh builds and its rebuilds (on the margin, a
population change, and a particle that wraps across x = 0, which on a
ring of one no migration reports), the capacity raises of the
decomposition's probe, and the packing ghost exchange against the
rows-driven one. The rings of several ranks are in test_torch_spmd.py."""

import dataclasses

import numpy as np
import pytest
import torch

from gadget_leicester_tpu.models.ics import lcdm_gas_ics
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.core.state import from_numpy, to_numpy
from gadget_leicester_tpu_torch.models.simulation import Simulation
from gadget_leicester_tpu_torch.parallel import spmd

BOX = 50000.0
# test_torch_spmd.py's configuration (test_spmd_step.py's)
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
OPTS = dict(periodic=True, pmgrid=24, gravity_mode="treepm",
            sph_backend="blocks")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ring_of_one():
    """A 2x11^3 box (h under the slab's cap, so the density solve
    converges; some 21 gas a fine cell of the slab's 12,500 edge, so 32
    slots hold them) decomposed on a ring of one."""
    cfg = parse_parameter_text(PARAM)
    sim = Simulation(cfg, SimOptions(**OPTS), "cpu")
    pos, vel, mass, ptype, u = lcdm_gas_ics(
        n_side=11, box=BOX, omega0=0.3, omega_b=0.04,
        hubble=cfg.hubble_internal, g=cfg.grav_internal)
    sim.set_ics(pos, vel, mass, ptype, u=u)
    state = to_numpy(sim.state)
    ring = Simulation(cfg, SimOptions(**OPTS), "cpu", mesh=1)
    ring.state = from_numpy(state, "cpu")
    ring._decompose()
    return ring


@pytest.fixture(scope="module")
def two_steps(ring_of_one):
    """Two sync points of the ring of one on its cache: the first builds,
    the second takes the cached structures."""
    step = ring_of_one._spmd_step
    st = step(ring_of_one.state)
    assert step.last_rebuilt == {"grav": True, "sph": True}
    st = step(st)
    assert step.last_rebuilt == {"grav": False, "sph": False}
    return st


def test_slab_cache_matches_fresh_builds(ring_of_one, two_steps):
    """Sync points on the cached slab grids equal per-step fresh builds
    to float32 rounding: positions exactly, velocities and densities
    within 2e-5 of their largest value (test_grid_cache.py's bounds)."""
    step = ring_of_one._spmd_step
    a = two_steps
    b = ring_of_one.state
    for _ in range(2):
        b = step(dataclasses.replace(b, grids=None))
    assert int(a.overflow_flags) == 0 == int(b.overflow_flags)
    assert a.grids.grav is not None and float(a.grids.grav_disp) > 0.0
    assert int(a.ti_current) == int(b.ti_current)
    assert torch.equal(a.p.pos, b.p.pos)
    for x, y in ((a.p.vel, b.p.vel), (a.gas.density, b.gas.density)):
        scale = float(y.abs().max())
        assert float((x - y).abs().max()) <= 2e-5 * scale


def test_slab_cache_rebuilds_on_margin_and_population(ring_of_one,
                                                     two_steps):
    """A step within the margin keeps both cached structures (the second
    of ``two_steps``); a displacement counter past the margin rebuilds
    both, and so does a population change (one gas particle killed)."""
    step = ring_of_one._spmd_step
    st = two_steps
    g0 = st.grids
    poked = dataclasses.replace(st, grids=dataclasses.replace(
        g0, grav_disp=torch.tensor(1e9), sph_disp=torch.tensor(1e9)))
    after = step(poked)
    assert step.last_rebuilt == {"grav": True, "sph": True}
    assert float(after.grids.grav_disp) < 1e6
    alive = st.p.alive.clone()
    kill = int(torch.nonzero(alive[:st.n_gas_max])[0])
    alive[kill] = False
    after = step(dataclasses.replace(st, p=dataclasses.replace(st.p,
                                                               alive=alive)))
    assert step.last_rebuilt == {"grav": True, "sph": True}
    assert int(after.grids.grav_count) == int(alive.sum())


def test_slab_cache_drops_a_list_a_wrap_in_x_left_stale(ring_of_one,
                                                        two_steps):
    """On a ring of one, a particle that drifts across x = box stays on its
    rank, and its cached cell would lie at the other face of the clamped
    x axis: the step rebuilds both structures, and equals a fresh build."""
    step = ring_of_one._spmd_step
    st = two_steps
    p = st.p
    i = int(torch.nonzero(p.alive)[0])
    pos, vel = p.pos.clone(), p.vel.clone()
    pos[i, 0] = BOX * (1.0 - 1e-7)
    vel[i, 0] = abs(float(vel[i, 0])) + 50.0
    st = dataclasses.replace(st, p=dataclasses.replace(p, pos=pos, vel=vel))
    fresh = step(dataclasses.replace(st, grids=None))
    after = step(st)
    assert step.last_rebuilt == {"grav": True, "sph": True}
    assert float(after.p.pos[i, 0]) < 0.5 * BOX
    assert torch.equal(after.p.pos, fresh.p.pos)
    assert torch.equal(after.p.acc, fresh.p.acc)


def test_decompose_raises_capacities_while_the_slab_lists_overflow(
        ring_of_one):
    """40 gas particles piled into one fine cell overflow the slab's 32
    slots a cell: ``_decompose`` probes the fresh lists and doubles the
    blocks' subcap until they fit, noting the raise, before any step
    runs; the probe of the result is clean."""
    cfg = parse_parameter_text(PARAM)
    sim = Simulation(cfg, SimOptions(**OPTS), "cpu", mesh=1)
    st = ring_of_one.canonical_state()
    gas = torch.nonzero(st.p.alive[:st.n_gas_max]
                        & (st.p.ptype[:st.n_gas_max] == 0)).flatten()[:40]
    pos = st.p.pos.clone()
    pos[gas] = torch.tensor([1000.0, 2000.0, 3000.0]) \
        + torch.arange(40, dtype=pos.dtype)[:, None]
    sim.state = dataclasses.replace(st, p=dataclasses.replace(st.p, pos=pos))
    sim._decompose()
    assert sim.opts.sph_capacity == 64
    notes = [n for n in sim.init_notes if n.startswith("slab lists")]
    assert len(notes) == 1 and "overflow 2" in notes[0]
    assert sim._spmd_step.probe(sim.state) == (0, 0)


def test_ghost_exchange_by_packing_equals_by_rows(ring_of_one):
    """``_ghost_exchange`` (the packing exchange of the reference's cells
    branch) and ``_ghost_exchange_rows`` on ``_ghost_rows_select``'s rows
    give the same ghosts on a ring of one; ``from_spmd`` lists the alive
    rows."""
    st = ring_of_one.state
    ring = ring_of_one.mesh
    p = st.p
    x = torch.remainder(p.pos[:, 0], BOX)
    x0, x1 = ring_of_one._spmd_step.x0, ring_of_one._spmd_step.x1
    reach, gcap = 0.2 * BOX, p.n_max
    fields = [p.pos, p.mass]
    packed, valid_p, ovf_p = spmd._ghost_exchange(ring, fields, x, p.alive,
                                                  x0, x1, reach, gcap)
    rows, ovf_r = spmd._ghost_rows_select(x, p.alive, x0, x1, reach, gcap)
    by_rows, valid_r = spmd._ghost_exchange_rows(ring, fields, p.alive, rows,
                                                 gcap)
    assert not bool(ovf_p) and not bool(ovf_r)
    assert torch.equal(valid_p, valid_r) and int(valid_p.sum()) > 0
    for a, b in zip(packed, by_rows):
        assert torch.equal(a, b)
    pos, _, _, _, src = spmd.from_spmd(st, *ring_of_one.spmd_caps)
    assert len(src) == int(p.alive.sum())
    np.testing.assert_array_equal(pos, p.pos[p.alive].numpy())
