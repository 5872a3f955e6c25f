"""The lcdm_gas slice with ``sph_backend="cells"`` against the JAX package
on the CPU: init_state and 3 sync points from the same ICs (lcdm_gas_ics
at n_side 12, pmgrid 24, a 4^3 SPH grid of 128 slots). The JAX side runs
its ``jnp`` cells branch (``use_pallas="off"``: ops/sph_cells.py over the
same grid, the plain reference of kernels I/J and K, which cannot run on a
CPU without ``interpret``); the port runs the plain versions of its
kernels through ``ops/sph_cells.py``. Plus what this backend pins: every
sync point sweeps all gas and the inactive keep their frozen fields; a
full cell sets the sticky bit 2 and its dropped particles keep their
forecast; the capacity bump starts from 128 for cells and 32 for blocks;
asked for the card where there is none, it stops."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.config import \
    parse_parameter_text as j_parse
from gadget_leicester_tpu.models.simulation import Simulation as JSimulation
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.core.state import (assert_states_close,
                                                   to_numpy)
from gadget_leicester_tpu_torch.models.forces import compute_forces
from gadget_leicester_tpu_torch.models.grids import sph_cells_geometry
from gadget_leicester_tpu_torch.models.simulation import Simulation
from gadget_leicester_tpu_torch.ops.neighbors import build_cell_list
from tests.test_torch_slice import BOX, PARAM, _ics, _jax_dict

OPTS = dict(periodic=True, pmgrid=24, gravity_mode="treepm",
            sph_backend="cells", sph_grid=4, sph_capacity=128)
N_STEPS = 3
# The bounds are core/state.py's, as in tests/test_torch_slice.py: CLOSE_TOL
# = 2e-5 of each field's largest value on all but MAX_EXCLUDED rows.


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The shapes here are small: two intra-op threads do the work of
    eight, and leave the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    pos, vel, mass, ptype, u = _ics()
    jsim = JSimulation(j_parse(PARAM), JOptions(use_pallas="off", **OPTS))
    jsim.set_ics(pos, vel, mass, ptype, u=u)
    jax_traj = [_jax_dict(jsim.state)]
    cfg = parse_parameter_text(PARAM)
    opts = SimOptions(**OPTS)
    sim = Simulation(cfg, opts, "cpu")
    sim.set_ics(pos, vel, mass, ptype, u=u)
    init_state = sim.state
    port_traj = [to_numpy(sim.state)]
    for _ in range(N_STEPS):
        jsim.step()
        jax_traj.append(_jax_dict(jsim.state))
        sim.step()
        port_traj.append(to_numpy(sim.state))
    return dict(jax=jax_traj, port=port_traj, cfg=cfg, opts=opts,
                init_state=init_state, stats=sim.stats)


def test_geometry_is_the_kernels_on_branch():
    """n_cells = max(3, round((ng / 100)^(1/3))), the capacity rounded up
    to a multiple of 128; sph_grid and sph_capacity override them."""
    cfg = parse_parameter_text(PARAM)
    auto = SimOptions(periodic=True, sph_backend="cells")
    assert sph_cells_geometry(cfg, auto, 2 * 128 ** 3 // 2) == (28, 128)
    assert sph_cells_geometry(cfg, auto, 300) == (3, 128)
    assert sph_cells_geometry(cfg, auto.replace(sph_capacity=200),
                              64 ** 3) == (14, 256)
    assert sph_cells_geometry(cfg, SimOptions(**OPTS), 1792) == (4, 128)


def test_init_state_matches(runs):
    assert_states_close(runs["port"][0], runs["jax"][0])


@pytest.mark.parametrize("step", range(1, N_STEPS + 1))
def test_trajectory_matches(runs, step):
    got, want = runs["port"][step], runs["jax"][step]
    assert int(got["ti_current"]) == int(want["ti_current"])
    assert_states_close(got, want)
    assert np.isfinite(got["p.pos"]).all() and np.isfinite(got["p.vel"]).all()
    assert int(got["overflow_flags"]) == 0


def test_cells_list_is_not_cached(runs):
    """The grid cache holds the gravity grid only: the coarse-cell list is
    built fresh at every force pass."""
    grids = runs["init_state"].grids
    assert grids.grav is not None and grids.sph is None
    assert len(runs["stats"]["density_iters"]) == 2 + N_STEPS


def test_inactive_particles_keep_frozen_fields(runs):
    """No ``active`` reaches this backend: it sweeps all gas, and only the
    gas whose step ends now takes the fresh fields."""
    st = runs["init_state"]
    rng = np.random.default_rng(11)
    inactive = torch.from_numpy(rng.uniform(size=st.n_max) < 0.5) & st.p.alive
    ng = st.n_gas_max
    p = dataclasses.replace(
        st.p, ti_endstep=torch.where(inactive, 2 ** 20, st.p.ti_endstep))
    gas = dataclasses.replace(st.gas, density=st.gas.density * 1.5,
                              hsml=st.gas.hsml * 0.9,
                              dt_entropy=st.gas.dt_entropy + 3.0,
                              hydro_acc=st.gas.hydro_acc - 2.0)
    before = dataclasses.replace(st, p=p, gas=gas, grids=None)
    after = compute_forces(before, runs["cfg"], runs["opts"], do_pm=False)
    off_g = inactive[:ng]
    for f in ("density", "hsml", "dt_entropy", "hydro_acc", "max_signal_vel",
              "div_vel", "curl_vel"):
        torch.testing.assert_close(getattr(after.gas, f)[off_g],
                                   getattr(before.gas, f)[off_g], rtol=0,
                                   atol=0, msg=f)
    on_g = ~off_g & st.p.alive[:ng] & (st.p.ptype[:ng] == 0)
    assert not torch.equal(after.gas.density[on_g], before.gas.density[on_g])


def test_full_cell_sets_sticky_bit_and_keeps_forecast(runs):
    """400 gas particles crowded into one cell of 128 slots: bit 2 is set,
    the dropped particles come back with rho = 0 and keep their forecast
    fields, and a later pass without overflow leaves the bit set."""
    st = dataclasses.replace(runs["init_state"], grids=None)
    cfg, opts = runs["cfg"], runs["opts"]
    ng = st.n_gas_max
    gas_mask = st.p.alive[:ng] & (st.p.ptype[:ng] == 0)
    pos = st.p.pos.clone()
    pos[:400] = pos[:400] * 0.2 + 100.0
    crowded = dataclasses.replace(st, p=dataclasses.replace(st.p, pos=pos))
    cl = build_cell_list(pos[:ng], gas_mask, 0.0, BOX, 4, 128)
    dropped = (cl.gslot < 0) & gas_mask
    assert bool(cl.overflow) and dropped.any()
    after = compute_forces(crowded, cfg, opts, do_pm=False)
    assert int(after.overflow_flags) & 2
    for f in ("density", "hsml", "dt_entropy", "hydro_acc"):
        torch.testing.assert_close(getattr(after.gas, f)[dropped],
                                   getattr(st.gas, f)[dropped], msg=f)
    kept = gas_mask & ~dropped
    assert (after.gas.density[kept] > 0).all()
    again = compute_forces(dataclasses.replace(after, p=st.p), cfg, opts,
                           do_pm=False)
    assert int(again.overflow_flags) & 2
    assert torch.isfinite(again.gas.density).all()


def test_two_cells_an_axis_are_refused_on_a_periodic_grid(runs):
    """A periodic 27-cell stencil over fewer than 3 cells an axis would
    meet a neighbour twice: the wrapper raises."""
    st = dataclasses.replace(runs["init_state"], grids=None)
    two = dataclasses.replace(runs["opts"], sph_grid=2, sph_capacity=512)
    with pytest.raises(ValueError, match="n_cells >= 3"):
        compute_forces(st, runs["cfg"], two, do_pm=False)


@pytest.mark.parametrize("backend,start,want", [
    ("cells", 0, 256), ("blocks", 0, 64), ("cells", 256, 512),
    ("blocks", 64, 128)])
def test_capacity_bump_starts_from_the_backends_default(runs, backend, start,
                                                        want):
    """Overflow bit 2 doubles the SPH capacity, from 128 slots a cell for
    the coarse cells and 32 a subcell for the blocks when none was set
    (the JAX package's simulation.py:596-606); the bits are cleared."""
    opts = dataclasses.replace(runs["opts"], sph_backend=backend,
                               sph_capacity=start)
    sim = Simulation(runs["cfg"], opts, "cpu")
    sim.state = dataclasses.replace(
        runs["init_state"], overflow_flags=torch.tensor(2, dtype=torch.int32))
    notes = []
    sim.logs = types.SimpleNamespace(
        log_info=lambda *a, note="", **k: notes.append(note))
    sim._bump_capacities(2, 0.1)
    assert sim.opts.sph_capacity == want and sim.opts.sr_capacity == 0
    assert int(sim.state.overflow_flags) == 0
    assert f"sph={want}" in notes[0]


def test_cells_on_cuda_without_a_card_stops():
    """Asked for the card where there is none, the simulation raises and
    never runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(parse_parameter_text(PARAM), SimOptions(**OPTS), "cuda")
