"""The in-step potential on the CPU: with sinks (or Stamatellos cooling)
under TreePM, p.pot is the full potential of the active particles, made
inside the step from the PM piece, the short-range row of kernel H (dense
tier) or of kernel E's potential mode (entries tier), and the PM
self-term; inactive particles keep their last one.

- the port's twin of tests/test_instep_potential.py (n_side 10, pmgrid 24,
  2e-4 of the largest |pot|), and the same state against the JAX
  package's in-step potential;
- E's potential mode (its plain version, through ``gravity_entries``)
  against the JAX package's ``shortrange_gravity_pallas_entries(
  with_potential=True)`` in interpret mode;
- the self-pair of the potential in the entries path;
- a near-idle sync point through the entries tier against the same with
  the tier forced dense, and the inactive particles' frozen potential;
- without sinks and Stamatellos, the step calls kernels A and E, not H or
  E's potential mode."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import make_near_idle, recorded_inputs, tier
from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.config import \
    parse_parameter_text as j_parse
from gadget_leicester_tpu.models.simulation import init_state as j_init
from gadget_leicester_tpu.ops import pallas_cells as jpc
from gadget_leicester_tpu.ops.neighbors import build_cell_list as j_build
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.models.forces import compute_potential
from gadget_leicester_tpu_torch.models.ics import lcdm_gas_ics
from gadget_leicester_tpu_torch.models.simulation import Simulation
from gadget_leicester_tpu_torch.ops import cells
from gadget_leicester_tpu_torch.ops.neighbors import build_cell_list
from tests.test_instep_potential import BOX, PARAM
from tests.test_torch_entries import (ASMTH, G_BOX, G_CAP, G_CELLS, G_KMAX,
                                      LANES, RCUT, _grav_active, _grav_setup,
                                      _t)

OPTS = dict(periodic=True, pmgrid=24, gravity_mode="treepm", sinks=True)
# the bound of tests/test_instep_potential.py: the in-step potential
# against compute_potential, as a share of the largest |pot|
INSTEP_TOL = 2e-4
# the port against the JAX package, and one tier against the other, on
# one state: the same pairs through independent code (JAX with use_pallas
# off sums in absolute coordinates), as a share of the largest |pot|
SAME_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ics(cfg):
    return lcdm_gas_ics(n_side=10, box=BOX, omega0=0.3, omega_b=0.04,
                        hubble=cfg.hubble_internal, g=cfg.grav_internal)


@pytest.fixture(scope="module")
def jax_cells_state():
    """The JAX package's in-step potential after init_state (cells SPH,
    use_pallas off), as tests/test_instep_potential.py makes it."""
    cfg = j_parse(PARAM)
    st = j_init(cfg, JOptions(sph_backend="cells", use_pallas="off", **OPTS),
                *_ics(cfg)[:4], u=_ics(cfg)[4])
    return np.asarray(st.p.pot), np.asarray(st.p.alive)


@pytest.fixture(scope="module")
def blocks_sim():
    """The small box under block SPH with sinks after set_ics, and the
    kernel wrappers set_ics called."""
    cfg = parse_parameter_text(PARAM)
    opts = SimOptions(sph_backend="blocks", sph_capacity=64, **OPTS)
    pos, vel, mass, ptype, u = _ics(cfg)
    sim = Simulation(cfg, opts, "cpu")
    with recorded_inputs() as rec:
        sim.set_ics(pos, vel, mass, ptype, u=u)
        called = set(rec)
    return sim, called


def test_instep_potential_matches_full_potential(blocks_sim):
    """After set_ics (every particle active, a PM step) p.pot is the full
    potential within 2e-4 of its largest value, and not the PM piece
    alone; the step called kernel H's wrapper and not A's."""
    sim, called = blocks_sim
    state = sim.state
    assert "shortrange_potential" in called
    assert "shortrange_gravity" not in called
    ref = compute_potential(state, sim.cfg, sim.opts).p.pot
    alive = state.p.alive
    got = state.p.pot
    scale = float(ref.abs().max())
    assert float((got - ref)[alive].abs().max()) <= INSTEP_TOL * scale
    assert float((got - state.p.pot_pm)[alive].abs().max()) > 1e-3 * scale


def test_instep_potential_matches_jax(blocks_sim, jax_cells_state):
    """The same in-step potential as the JAX package's on the same ICs,
    within 2e-5 of its largest value (gravity does not depend on the SPH
    backend: the JAX run takes the reference test's cells)."""
    state = blocks_sim[0].state
    want, alive = jax_cells_state
    np.testing.assert_array_equal(state.p.alive.numpy(), alive)
    got = state.p.pot.numpy()
    np.testing.assert_allclose(got[alive], want[alive], rtol=0,
                               atol=SAME_TOL * np.abs(want[alive]).max())


def _port_entries(pos, mass, soft, alive, active, with_potential=True):
    tp, tm, ts, ta, tact = _t(pos, mass, soft, alive, active)
    cl = build_cell_list(tp, ta, 0.0, G_BOX, G_CELLS, G_CAP)
    soa = cells.pack_cells_soa(cl, tp, tm, ts, ta)
    ec, es, _ = cells.build_active_entries(cl, tact, LANES, G_KMAX)
    return cells.gravity_entries(cl, soa, ec, es, tp, tm, ts, ta, G_BOX,
                                 ASMTH, RCUT,
                                 with_potential=with_potential).numpy()


@pytest.mark.parametrize("mode", ["spread", "spill", "wrap"])
def test_potential_entries_match_jax(mode):
    """E's potential mode (plain version, through gravity_entries) against
    JAX's shortrange_gravity_pallas_entries(with_potential=True), relative
    mode, interpret: acc and pot within 2e-4 of their largest value on the
    active particles (test_torch_entries.py's bound); other rows 0 in
    both, the dead ones included."""
    pos, mass, soft, alive = _grav_setup()
    active = _grav_active(mode, pos, alive)
    got = _port_entries(pos, mass, soft, alive, active)
    assert got.shape == (len(pos), 4)
    jcl = j_build(jnp.asarray(pos), jnp.asarray(alive), 0.0, G_BOX,
                  n_cells=G_CELLS, capacity=G_CAP, periodic=True)
    ec, es, _ = jpc.build_active_entries(jcl, jnp.asarray(active), LANES,
                                         G_KMAX)
    acc, pot, _ = jpc.shortrange_gravity_pallas_entries(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(soft),
        jnp.asarray(alive), G_BOX, n_cells=G_CELLS, capacity=G_CAP,
        asmth=ASMTH, rcut=RCUT, entry_cell=ec, entry_slot=es, cl=jcl,
        periodic=True, interpret=True, relative=True, with_potential=True)
    want = np.concatenate([np.asarray(acc), np.asarray(pot)[:, None]], 1)
    for k, what in ((slice(0, 3), "acc"), (slice(3, 4), "pot")):
        w = want[active, k]
        np.testing.assert_allclose(got[active, k], w, rtol=0,
                                   atol=2e-4 * np.abs(w).max(), err_msg=what)
    assert not got[~active].any() and not want[~active].any()
    # the force rows are E's force mode's
    np.testing.assert_array_equal(
        got[:, :3], _port_entries(pos, mass, soft, alive, active, False))


def test_isolated_particle_has_zero_potential_in_the_entries_path():
    """The entries twin of test_torch_potential.py::
    test_isolated_particle_has_zero_short_range_potential: the target rows
    come from the pack's own arithmetic, so a lone particle meets its own
    slot at r2 == 0 exactly and its potential row is 0, bit for bit, in
    the cell interior and across the periodic wrap."""
    for x in (0.5, 0.0, 0.9999):
        pos = np.array([[x, 0.31, 0.77], [0.2, 0.7, 0.2]], np.float32)
        mass = np.array([2.0, 1.0], np.float32)
        soft = np.full(2, 0.02, np.float32)
        alive = np.array([True, False])
        rows = _port_entries(pos, mass, soft, alive, alive)
        assert rows[0, 3] == 0.0 and not rows[0, :3].any()


@pytest.fixture(scope="module")
def idle_runs(blocks_sim):
    """From the block-SPH box after one sync point with a seeded 3% of the
    particles given half their step (``make_near_idle``): one near-idle
    sync point through each tier. Returns (the start, {tier: (state, tier
    log, kernel wrappers called)})."""
    sim, _ = blocks_sim
    sim.step()
    start = make_near_idle(sim.state, 0.03, 7)
    out = {}
    for label, force in (("entries", None), ("dense", False)):
        sim.state = copy.deepcopy(start)
        with recorded_inputs() as rec, tier(force) as log:
            sim.step()
            called = set(rec)
        out[label] = (sim.state, log, called)
    sim.state = start
    return start, out


def test_entries_tier_potential_matches_dense_tier(idle_runs):
    """The entries tier (E's potential mode) and the dense tier (kernel H
    on the step's pack and tile flags) give one potential: within 2e-5 of
    its largest value, and the accelerations too."""
    _, runs = idle_runs
    st_e, log_e, called_e = runs["entries"]
    st_d, log_d, called_d = runs["dense"]
    assert log_e[0][3] and not log_d[0][3]
    assert "shortrange_potential_entries" in called_e
    assert {"shortrange_gravity_entries", "shortrange_potential",
            "shortrange_gravity"}.isdisjoint(called_e)
    assert "shortrange_potential" in called_d
    assert {"shortrange_gravity", "shortrange_potential_entries",
            "shortrange_gravity_entries"}.isdisjoint(called_d)
    alive = st_d.p.alive
    for f in ("pot", "acc"):
        g, w = getattr(st_e.p, f)[alive], getattr(st_d.p, f)[alive]
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= SAME_TOL * scale, f


def test_inactive_particles_keep_their_potential(idle_runs):
    """At the near-idle sync point only the active particles' p.pot is
    new; every other keeps the value it had, bit for bit."""
    start, runs = idle_runs
    st, _, _ = runs["entries"]
    active = (start.p.ti_endstep == st.ti_current) & start.p.alive
    assert 0 < int(active.sum()) < int(start.p.alive.sum()) // 10
    assert torch.equal(st.p.pot[~active], start.p.pot[~active])
    assert bool((st.p.pot[active] != start.p.pot[active]).all())
    # PM did not run: the frozen PM piece is the start's
    assert torch.equal(st.p.pot_pm, start.p.pot_pm)


def test_without_sinks_the_step_takes_a_and_e(idle_runs, blocks_sim):
    """No sinks and no Stamatellos cooling, from the same near-idle state:
    the dense tier calls kernel A and the entries tier E's force mode, as
    before; p.pot is the PM piece."""
    start, _ = idle_runs
    cfg, opts = blocks_sim[0].cfg, blocks_sim[0].opts.replace(sinks=False)
    sim = Simulation(cfg, opts, "cpu")
    for force, want in ((None, "shortrange_gravity_entries"),
                        (False, "shortrange_gravity")):
        sim.state = copy.deepcopy(start)
        with recorded_inputs() as rec, tier(force):
            sim.step()
            called = set(rec)
        assert want in called
        assert {"shortrange_potential",
                "shortrange_potential_entries"}.isdisjoint(called)
        assert torch.equal(sim.state.p.pot, sim.state.p.pot_pm)
