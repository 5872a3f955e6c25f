"""The vacuum gas path of the port against the JAX package on the CPU: the
subsampled Evrard sphere of tests/test_gassphere_e2e.py (every third
particle of ``gassphere_ics``, direct gravity, all-pairs SPH, not
comoving, no PM step) over 36 sync points, state by state; its energies
by the reference's own acceptance bounds; the full potential of the direct
sum; a comoving run with vacuum boundaries (the background correction);
and the port's command line on a gassphere parameter file in a child
process where jax cannot be imported."""

import numpy as np
import pytest
import torch

import chip_smoke
from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.config import \
    parse_parameter_text as j_parse
from gadget_leicester_tpu.models.ics import gassphere_ics
from gadget_leicester_tpu.models.ics import plummer_ics
from gadget_leicester_tpu.models.simulation import Simulation as JSimulation
from gadget_leicester_tpu.models.simulation import \
    potential_pass as j_potential_pass
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.core.state import (assert_states_close,
                                                   to_numpy)
from gadget_leicester_tpu_torch.models.simulation import (Simulation,
                                                          potential_pass,
                                                          uses_pm_split)
from gadget_leicester_tpu_torch.utils.diagnostics import energy_statistics
from tests.test_config import GASSPHERE_PARAM
from tests.test_torch_cli import cli
from tests.test_torch_slice import _jax_dict

N_STEPS = 36
PARAM = (GASSPHERE_PARAM
         .replace("GravityConstantInternal  0", "GravityConstantInternal  1.0")
         .replace("MaxSizeTimestep     0.03", "MaxSizeTimestep     0.02"))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The shapes here are small: two intra-op threads do the work of
    eight, and leave the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ics():
    pos, vel, mass, ptype, u = gassphere_ics(mode="grid")
    keep = np.arange(0, len(pos), 3)
    return (pos[keep], vel[keep], mass[keep] * len(pos) / len(keep),
            ptype[keep], u[keep])


@pytest.fixture(scope="module")
def runs():
    pos, vel, mass, ptype, u = _ics()
    jsim = JSimulation(j_parse(PARAM), JOptions(periodic=False))
    jsim.set_ics(pos, vel, mass, ptype, u=u)
    cfg, opts = parse_parameter_text(PARAM), SimOptions(periodic=False)
    sim = Simulation(cfg, opts, "cpu")
    sim.set_ics(pos, vel, mass, ptype, u=u)
    jax_traj, port_traj = [_jax_dict(jsim.state)], [to_numpy(sim.state)]
    e0 = energy_statistics(potential_pass(sim.state, cfg, opts), cfg, opts)
    for _ in range(N_STEPS):
        jsim.step()
        sim.step()
        jax_traj.append(_jax_dict(jsim.state))
        port_traj.append(to_numpy(sim.state))
    return dict(jax=jax_traj, port=port_traj, cfg=cfg, opts=opts, sim=sim,
                jsim=jsim, e0=e0)


def test_run_is_direct_dense_and_has_no_pm_step(runs):
    """597 gas in vacuum: direct gravity, all-pairs SPH, no grid cache
    entry, no PM step (pm_ti_endstep stays 0 and never bounds a sync
    point)."""
    from gadget_leicester_tpu_torch.models.grids import (resolve_gravity_mode,
                                                         resolve_sph_backend)
    st = runs["sim"].state
    assert resolve_gravity_mode(runs["opts"], st.n_max) == "direct"
    assert resolve_sph_backend(runs["opts"], st.n_gas_max) == "dense"
    assert not uses_pm_split(runs["opts"])
    assert st.grids.grav is None and st.grids.sph is None
    assert int(st.pm_ti_endstep) == 0 < int(st.ti_current)
    assert not st.p.acc_pm.any()


@pytest.mark.parametrize("step", [0, 1, 12, 24, N_STEPS])
def test_trajectory_matches_state_by_state(runs, step):
    """Every float field within 2e-5 of its largest value on all but 3
    rows, the timeline fields equal (core/state.py's bounds, the slice's):
    two float32 all-pairs sums in another order, through 36 sync
    points."""
    got, want = runs["port"][step], runs["jax"][step]
    assert int(got["ti_current"]) == int(want["ti_current"])
    assert_states_close(got, want)


def test_all_sync_points_match_on_the_tracked_fields(runs):
    for got, want in zip(runs["port"], runs["jax"]):
        assert_states_close(got, want, fields=("p.pos", "p.vel",
                                               "gas.density", "gas.hsml",
                                               "gas.entropy"))


def test_energies_by_the_reference_bounds(runs):
    """tests/test_gassphere_e2e.py's acceptance: Epot ~ -2/3, Eint 0.05
    and no motion at the start; by the last sync point (t ~ 0.4) the
    sphere collapses (Epot falls, Ekin grows) with |dE| < 0.02, momentum
    below 5e-4 and mass conserved."""
    cfg, opts, sim, e0 = (runs[k] for k in ("cfg", "opts", "sim", "e0"))
    assert float(e0.potential) == pytest.approx(-2.0 / 3.0, rel=0.08)
    assert float(e0.internal) == pytest.approx(0.05, rel=0.05)
    assert float(e0.kinetic) < 1e-6
    en = energy_statistics(potential_pass(sim.state, cfg, opts), cfg, opts)
    assert sim.time > 0.35
    assert float(en.potential) < float(e0.potential) - 0.03
    assert float(en.kinetic) > 0.01
    assert abs(float(en.total) - float(e0.total)) < 0.02
    assert (en.momentum.abs() < 5e-4).all()
    assert float(en.mass) == pytest.approx(float(e0.mass), rel=1e-6)


def test_full_potential_of_the_direct_sum_matches(runs):
    """``compute_potential`` under direct gravity against the JAX
    package's, on the last state of each run: 2e-5 of the largest
    value."""
    cfg, opts = runs["cfg"], runs["opts"]
    got = potential_pass(runs["sim"].state, cfg, opts).p.pot.numpy()
    jsim = runs["jsim"]
    want = np.asarray(j_potential_pass(jsim.state, jsim.cfg, jsim.opts).p.pot)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    assert (got[: len(_ics()[0])] < 0).all()


def test_comoving_vacuum_run_gets_the_background_term():
    """A collisionless Plummer sphere in comoving coordinates with vacuum
    boundaries (the cluster workload's setting): direct gravity plus
    Omega0 H0^2 / 2 x, held to the JAX package after set_ics and 2 sync
    points by the slice's bounds."""
    param = (PARAM.replace("ComovingIntegrationOn 0",
                           "ComovingIntegrationOn 1")
             .replace("TimeBegin           0.0", "TimeBegin           0.1")
             .replace("TimeMax             3.0", "TimeMax             1.0")
             .replace("Omega0              0", "Omega0              0.3")
             .replace("OmegaLambda         0", "OmegaLambda         0.7"))
    pos, vel, mass, ptype, _ = plummer_ics(300, seed=3)
    jsim = JSimulation(j_parse(param), JOptions(periodic=False))
    jsim.set_ics(pos, vel, mass, ptype)
    cfg = parse_parameter_text(param)
    assert cfg.comoving_integration_on and cfg.omega0 == 0.3
    sim = Simulation(cfg, SimOptions(periodic=False), "cpu")
    sim.set_ics(pos, vel, mass, ptype)
    fields = ("p.pos", "p.vel", "p.acc")
    assert_states_close(to_numpy(sim.state), _jax_dict(jsim.state), fields)
    corr = 0.5 * cfg.omega0 * cfg.hubble_internal ** 2
    assert corr > 0
    jsim.step(2)
    sim.step(2)
    assert int(sim.state.ti_current) > 0
    assert_states_close(to_numpy(sim.state), _jax_dict(jsim.state), fields)


def test_cli_runs_a_gassphere_parameter_file_on_the_cpu(tmp_path):
    """``python -m gadget_leicester_tpu_torch gassphere.param 0 --device
    cpu`` on the stock parameter file and the stock IC generator's file,
    jax unimportable: exit 0, direct gravity with no PM mesh chosen from
    the file alone, an energy.txt row at t = 0 with the Evrard energies,
    and a restart dump."""
    n = chip_smoke.write_gassphere_ics(str(tmp_path / "ics.dat"))
    param = tmp_path / "gassphere.param"
    param.write_text(chip_smoke.gassphere_param_text(
        str(tmp_path / "ics.dat"), str(tmp_path / "out"), 0.5))
    proc = cli(param, 0, "--device", "cpu", "--max-steps", 3)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"N={n} particles on cpu" in proc.stdout
    assert "gravity=auto, pmgrid=0" in proc.stdout
    assert "done: 3 steps" in proc.stdout
    rows = np.loadtxt(tmp_path / "out" / "energy.txt", ndmin=2)
    assert rows.shape[1] == 28 and rows[0, 0] == 0.0
    assert rows[0, 2] == pytest.approx(-2.0 / 3.0, rel=0.08)
    assert rows[0, 1] == pytest.approx(0.05, rel=0.05)
    assert (tmp_path / "out" / "restart.npz").exists()
    assert torch.isfinite(torch.from_numpy(rows)).all()
