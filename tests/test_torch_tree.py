"""The tree-gravity path of the port (ops/tree.py, ops/ewald.py, the
``tree`` branch of models/forces.py): the cases of tests/test_tree.py on
the port, the port against the JAX package's ``tree_gravity`` on the same
seeded inputs (both opening criteria, vacuum; periodic with the Ewald
correction), the copied numpy modules against their originals, a short
galaxy-collision run of both ``Simulation`` classes, and the command line
on the stock galaxy parameter file."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.config import \
    parse_parameter_text as j_parse
from gadget_leicester_tpu.models import ics as jics
from gadget_leicester_tpu.models.simulation import Simulation as JSimulation
from gadget_leicester_tpu.models.simulation import \
    potential_pass as j_potential_pass
from gadget_leicester_tpu.ops import ewald as jew
from gadget_leicester_tpu.ops import tree as jtree
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.core.state import (assert_states_close,
                                                   to_numpy)
from gadget_leicester_tpu_torch.models import ics as tics
from gadget_leicester_tpu_torch.models.forces import check_supported
from gadget_leicester_tpu_torch.models.grids import resolve_gravity_mode
from gadget_leicester_tpu_torch.models.simulation import (Simulation,
                                                          potential_pass,
                                                          uses_pm_split)
from gadget_leicester_tpu_torch.ops import ewald as tew
from gadget_leicester_tpu_torch.ops import tree as ttree
from gadget_leicester_tpu_torch.ops.gravity_direct import direct_gravity
from gadget_leicester_tpu_torch.utils.diagnostics import energy_statistics
from tests.test_config import GASSPHERE_PARAM
from tests.test_torch_cli import cli
from tests.test_torch_slice import _jax_dict

# port against JAX on the same inputs: the same pair terms in float32,
# summed in another order (the leaf buckets compacted), as a share of the
# largest |acc| and |pot|; no frontier fills in these cases
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cloud(seed, n):
    pos, _, mass, _, _ = tics.plummer_ics(n, seed=seed)
    return pos.astype(np.float32), mass.astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_morton_keys_nest_and_equal_the_reference():
    pos = np.array([[0.1, 0.1, 0.1], [0.12, 0.11, 0.13], [0.9, 0.9, 0.9]],
                   np.float32)
    k = ttree.morton_keys(torch.from_numpy(pos), torch.zeros(3),
                          torch.tensor(1.0), 10)
    assert int(k[0]) >> 24 == int(k[1]) >> 24
    assert int(k[0]) >> 24 != int(k[2]) >> 24
    rng = np.random.default_rng(0)
    pos = rng.uniform(-0.2, 1.2, (500, 3)).astype(np.float32)
    for depth in (3, 8, 10):
        got = ttree.morton_keys(torch.from_numpy(pos), torch.zeros(3),
                                torch.tensor(1.0), depth)
        want = jtree.morton_keys(jnp.asarray(pos), jnp.zeros(3),
                                 jnp.asarray(1.0), depth)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_octree_mass_and_com():
    n = 500
    pos, mass = _cloud(1, n)
    alive = np.ones(n, bool)
    alive[-7:] = False
    soft = np.full(n, 0.05, np.float32)
    tree = ttree.build_octree(*_t(pos, mass, soft, alive), depth=6)
    jt = jtree.build_octree(jnp.asarray(pos), jnp.asarray(mass),
                            jnp.asarray(soft), jnp.asarray(alive), depth=6)
    m_tot = mass[alive].sum()
    com_tot = (mass[alive, None] * pos[alive]).sum(0) / m_tot
    np.testing.assert_array_equal(tree.order.numpy(), np.asarray(jt.order))
    for lvl in range(tree.depth):
        assert float(tree.mass[lvl].sum()) == pytest.approx(m_tot, rel=1e-5)
        cw = (tree.mass[lvl][:, None] * tree.com[lvl]).sum(0).numpy() / m_tot
        np.testing.assert_allclose(cw, com_tot, rtol=1e-4, atol=1e-5)
        # node for node the reference's arrays (empty nodes carry no mass)
        live = np.asarray(jt.mass[lvl]) > 0
        np.testing.assert_array_equal(tree.mass[lvl].numpy() > 0, live)
        _close(tree.mass[lvl], jt.mass[lvl], 1e-6)
        _close(tree.com[lvl][live], np.asarray(jt.com[lvl])[live], 1e-6)
        for f in ("pfx", "pstart", "pcount", "child_lo", "child_hi"):
            np.testing.assert_array_equal(
                getattr(tree, f)[lvl].numpy()[live],
                np.asarray(getattr(jt, f)[lvl])[live], err_msg=f)


@pytest.mark.parametrize("opening", [0, 1])
def test_tree_vs_direct_and_vs_the_reference(opening):
    """tests/test_tree.py's accuracy bounds against the direct sum, and
    the JAX package's tree on the same inputs within TOL."""
    n = 1500
    pos, mass = _cloud(2 + opening, n)
    soft = np.full(n, 0.05, np.float32)
    alive = np.ones(n, bool)
    t = _t(pos, mass, soft, alive)
    acc_d, pot_d = direct_gravity(*t, block=256)
    old_acc = acc_d.norm(dim=-1)
    acc_t, pot_t = ttree.tree_gravity(*t, theta=0.5, opening=opening,
                                      old_acc=old_acc, depth=8)
    err = (acc_t - acc_d).norm(dim=-1) / acc_d.norm(dim=-1).clamp_min(1e-10)
    assert float(err.quantile(0.99)) < 1e-2
    assert float(err.median()) < 2e-3
    perr = (pot_t - pot_d).abs() / pot_d.abs().max()
    assert float(perr.quantile(0.99)) < 1e-2
    acc_j, pot_j = jtree.tree_gravity(
        *[jnp.asarray(a) for a in (pos, mass, soft, alive)], theta=0.5,
        opening=opening, old_acc=jnp.asarray(old_acc.numpy()), depth=8)
    _close(acc_t, acc_j)
    _close(pot_t, pot_j)


def test_tree_with_full_buckets_matches_the_reference():
    """Small buckets put the residual monopoles in play in most blocks
    (the frontier holds every node of the last level, so it never fills);
    the sums still agree, and the chunking of blocks does not enter."""
    n = 1200
    pos, mass = _cloud(7, n)
    soft = np.full(n, 0.05, np.float32)
    alive = np.ones(n, bool)
    alive[::11] = False
    kw = dict(theta=0.3, opening=0, depth=4, block=128, frontier_cap=4096,
              bucket_cap=4)
    acc_t, pot_t = ttree.tree_gravity(*_t(pos, mass, soft, alive), **kw)
    acc_j, pot_j = jtree.tree_gravity(
        *[jnp.asarray(a) for a in (pos, mass, soft, alive)], **kw)
    _close(acc_t, acc_j)
    _close(pot_t, pot_j)
    acc_1, pot_1 = ttree.tree_gravity(*_t(pos, mass, soft, alive),
                                      block_chunk=1, **kw)
    _close(acc_1, acc_t.numpy(), 1e-6)
    _close(pot_1, pot_t.numpy(), 1e-6)
    # the residual monopoles were in play: this is not the direct sum
    acc_d, _ = direct_gravity(*_t(pos, mass, soft, alive))
    assert float((acc_t - acc_d).abs().max()) > 1e-3 * float(acc_d.abs().max())


def test_a_full_frontier_sums_directly_where_the_reference_forces_monopoles():
    """A wide Plummer sphere (radii up to 20 a): the Morton blocks of its
    outskirts span the centre and open everything, and a frontier of 256
    nodes fills. The reference then takes parents whose cells may hold
    targets as monopoles: force errors above 10% on many particles and a
    net force. The port sums those parents' particles directly: the
    accuracy bounds of tests/test_tree.py hold, and momentum is conserved
    as well as with an ample frontier."""
    n = 1500
    pos, mass = _cloud(12, n)
    arrays = (pos, mass, np.full(n, 0.05, np.float32), np.ones(n, bool))
    kw = dict(theta=0.5, opening=0, depth=8, frontier_cap=256)
    acc_d, pot_d = direct_gravity(*_t(*arrays))

    def errors(acc):
        return ((acc - acc_d).norm(dim=-1)
                / acc_d.norm(dim=-1).clamp_min(1e-10))

    acc_t, pot_t = ttree.tree_gravity(*_t(*arrays), **kw)
    err = errors(acc_t)
    assert float(err.quantile(0.99)) < 1e-2 and float(err.median()) < 2e-3
    assert float(((pot_t - pot_d).abs() / pot_d.abs().max()).max()) < 1e-2
    net = (torch.from_numpy(mass)[:, None] * acc_t).sum(0).abs().max()
    assert float(net) < 2e-3 * float((torch.from_numpy(mass)[:, None]
                                      * acc_t).abs().sum())
    acc_j, _ = jtree.tree_gravity(*[jnp.asarray(a) for a in arrays], **kw)
    err_j = errors(torch.from_numpy(np.array(acc_j)))
    assert int((err_j > 0.1).sum()) > 10 * max(1, int((err > 0.1).sum()))
    # with an ample frontier nothing fills, and the two packages agree
    kw["frontier_cap"] = 2048
    acc_t, _ = ttree.tree_gravity(*_t(*arrays), **kw)
    acc_j, _ = jtree.tree_gravity(*[jnp.asarray(a) for a in arrays], **kw)
    _close(acc_t, acc_j)


def test_tree_is_finite_where_mass_times_position_is_large():
    """The stock cluster ICs (masses 0.05, positions of order 25,000): the
    reference's residual-monopole centre overflows float32 there and its
    forces are NaN; the port's are finite and equal the direct sum's by
    tests/test_tree.py's bounds."""
    n = 1200
    pos, _, mass, _ = chip_smoke.tree_ics("cluster", n)
    arrays = (pos.astype(np.float32), mass.astype(np.float32),
              np.full(n, 0.28, np.float32), np.ones(n, bool))
    acc_t, pot_t = ttree.tree_gravity(*_t(*arrays), theta=0.5, opening=0)
    assert torch.isfinite(acc_t).all() and torch.isfinite(pot_t).all()
    acc_d, pot_d = direct_gravity(*_t(*arrays))
    err = (acc_t - acc_d).norm(dim=-1) / acc_d.norm(dim=-1).clamp_min(1e-10)
    assert float(err.quantile(0.99)) < 1e-2 and float(err.median()) < 2e-3
    acc_j, _ = jtree.tree_gravity(*[jnp.asarray(a) for a in arrays],
                                  theta=0.5, opening=0)
    assert not bool(jnp.isfinite(acc_j).all())     # the reference's fault


def test_tree_momentum_conservation():
    n = 800
    pos, mass = _cloud(4, n)
    acc, _ = ttree.tree_gravity(*_t(pos, mass, np.full(n, 0.05, np.float32),
                                    np.ones(n, bool)),
                                theta=0.4, opening=0, depth=8)
    net = (mass[:, None] * acc.numpy()).sum(0)
    scale = np.abs(mass[:, None] * acc.numpy()).sum()
    assert np.all(np.abs(net) < 2e-3 * scale)


def test_tree_dead_particles():
    n = 300
    pos, mass = _cloud(5, n)
    alive = np.ones(n, bool)
    alive[::3] = False
    na = int(alive.sum())
    kw = dict(theta=0.4, opening=0, depth=7)
    acc_a, pot_a = ttree.tree_gravity(
        *_t(pos, mass, np.full(n, 0.05, np.float32), alive), **kw)
    acc_live, _ = ttree.tree_gravity(
        *_t(pos[alive], mass[alive], np.full(na, 0.05, np.float32),
            np.ones(na, bool)), **kw)
    np.testing.assert_allclose(acc_a.numpy()[alive], acc_live.numpy(),
                               rtol=2e-2, atol=1e-4)
    assert (acc_a.numpy()[~alive] == 0).all()
    assert (pot_a.numpy()[~alive] == 0).all()


def test_tree_periodic_ewald():
    """The Ewald-corrected periodic tree against the exact periodic sum
    (tests/test_tree.py's bounds) and against the JAX package's."""
    n, box = 160, 1.0
    rng = np.random.default_rng(6)
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n)
    soft = np.full(n, 0.004, np.float32)
    alive = np.ones(n, bool)
    kw = dict(theta=0.3, opening=0, depth=6, periodic=True, box=box)
    acc_t, pot_t = ttree.tree_gravity(
        *_t(pos, mass.astype(np.float32), soft, alive), **kw)
    oracle = tew.direct_periodic_forces(pos.astype(np.float64), mass, box)
    err = np.linalg.norm(acc_t.numpy() - oracle, axis=1) / np.abs(oracle).max()
    assert np.quantile(err, 0.95) < 2e-2
    assert np.median(err) < 5e-3
    acc_j, pot_j = jtree.tree_gravity(
        jnp.asarray(pos), jnp.asarray(mass, jnp.float32), jnp.asarray(soft),
        jnp.asarray(alive), **kw)
    _close(acc_t, acc_j)
    _close(pot_t, pot_j)


def test_ewald_copy_equals_the_original(tmp_path, monkeypatch):
    """The numpy functions array for array; the table built fresh by both
    at a small resolution array for array, and the port's 32^3 table
    against the one the JAX package ships; the torch interpolation against
    ``ewald_correction_jnp``. The port caches under build/ewald/ and not
    beside the JAX module."""
    rng = np.random.default_rng(8)
    r = rng.uniform(-0.5, 0.5, (40, 3))
    np.testing.assert_array_equal(tew.ewald_pair_force(r, 1.0),
                                  jew.ewald_pair_force(r, 1.0))
    np.testing.assert_array_equal(tew.ewald_pair_potential(r, 1.0),
                                  jew.ewald_pair_potential(r, 1.0))
    pos, m = rng.uniform(0, 2.0, (12, 3)), rng.uniform(0.5, 1.5, 12)
    np.testing.assert_array_equal(tew.direct_periodic_forces(pos, m, 2.0),
                                  jew.direct_periodic_forces(pos, m, 2.0))
    monkeypatch.setattr(tew, "_EWALD_CACHE", {})
    monkeypatch.setattr(jew, "_EWALD_CACHE", {})
    got = tew.ewald_correction_table(6, cache_dir=str(tmp_path / "t"))
    want = jew.ewald_correction_table(6, cache_dir=str(tmp_path / "j"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (tmp_path / "t" / "ewald_table_6.npz").exists()
    monkeypatch.undo()
    assert tew.CACHE_DIR.parts[-2:] == ("build", "ewald")
    got, want = tew.ewald_correction_table(32), jew.ewald_correction_table(32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    dx = rng.uniform(-3.0, 3.0, (5, 7, 3)).astype(np.float32)
    ca, cp = tew.ewald_correction(torch.from_numpy(dx), 2.0,
                                  tew.device_table(32, "cpu"))
    ja, jp = jew.ewald_correction_jnp(jnp.asarray(dx), 2.0, want)
    np.testing.assert_allclose(ca.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(cp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)


def test_ic_copies_are_identical():
    for got, want in ((tics.plummer_ics(700, total_mass=3.0, a=2.0, g=4.0),
                       jics.plummer_ics(700, total_mass=3.0, a=2.0, g=4.0)),
                      (tics.galaxy_collision_ics(n_each=300),
                       jics.galaxy_collision_ics(n_each=300))):
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        assert got[4] is None and want[4] is None
    pos, vel, mass, ptype = chip_smoke.tree_ics("galaxy", 600)
    np.testing.assert_array_equal(
        pos, jics.galaxy_collision_ics(n_each=300)[0])
    pos, vel, mass, ptype = chip_smoke.tree_ics("cluster", 500)
    want = jics.plummer_ics(500, total_mass=1000.0, a=500.0, g=43007.1)
    np.testing.assert_array_equal(pos, want[0] + 25000.0)
    np.testing.assert_array_equal(vel, want[1])


GALAXY_PARAM = (GASSPHERE_PARAM
                .replace("GravityConstantInternal  0",
                         "GravityConstantInternal  1.0")
                .replace("SofteningHalo      0.1", "SofteningHalo      0.05")
                .replace("MaxSizeTimestep     0.03",
                         "MaxSizeTimestep     0.05")
                + "\nSofteningDisk 0.05\nTimeMax 3.0\n")
GALAXY_STEPS = 6


@pytest.fixture(scope="module")
def galaxy_runs():
    """tests/test_galaxy_cluster_e2e.py's galaxy collision (2 x 400, tree
    gravity, the relative opening criterion from the second force on) in
    both packages, state by state."""
    pos, vel, mass, ptype, _ = tics.galaxy_collision_ics(n_each=400, sep=4.0,
                                                         vrel=0.5)
    jsim = JSimulation(j_parse(GALAXY_PARAM), JOptions(gravity_mode="tree"))
    jsim.set_ics(pos, vel, mass, ptype)
    cfg, opts = parse_parameter_text(GALAXY_PARAM), \
        SimOptions(gravity_mode="tree")
    sim = Simulation(cfg, opts, "cpu")
    sim.set_ics(pos, vel, mass, ptype)
    e0 = energy_statistics(potential_pass(sim.state, cfg, opts), cfg, opts)
    jax_traj, port_traj = [_jax_dict(jsim.state)], [to_numpy(sim.state)]
    for _ in range(GALAXY_STEPS):
        jsim.step()
        sim.step()
        jax_traj.append(_jax_dict(jsim.state))
        port_traj.append(to_numpy(sim.state))
    return dict(jax=jax_traj, port=port_traj, sim=sim, jsim=jsim, cfg=cfg,
                opts=opts, e0=e0)


def test_galaxy_run_takes_the_tree_and_no_pm_step(galaxy_runs):
    sim, opts = galaxy_runs["sim"], galaxy_runs["opts"]
    assert resolve_gravity_mode(opts, sim.state.n_max) == "tree"
    assert resolve_gravity_mode(SimOptions(periodic=False), 20000) == "tree"
    assert resolve_gravity_mode(SimOptions(periodic=True, pmgrid=0),
                                100) == "tree"
    check_supported(galaxy_runs["cfg"], SimOptions(periodic=True, pmgrid=0),
                    100, 1)
    assert not uses_pm_split(opts)
    assert sim.state.grids.grav is None
    assert int(sim.state.pm_ti_endstep) == 0 < int(sim.state.ti_current)
    assert not sim.state.p.acc_pm.any()
    assert float(sim.state.p.old_acc[sim.state.p.alive].min()) > 0


@pytest.mark.parametrize("step", [0, 1, 3, GALAXY_STEPS])
def test_galaxy_trajectory_matches_the_reference(galaxy_runs, step):
    """Positions, velocities, accelerations and the tree's potential
    within 2e-5 of each field's largest value on all but 3 rows, the
    timeline equal (core/state.py's bounds), through 6 sync points."""
    got, want = galaxy_runs["port"][step], galaxy_runs["jax"][step]
    assert int(got["ti_current"]) == int(want["ti_current"])
    assert_states_close(got, want, fields=("p.pos", "p.vel", "p.acc",
                                           "p.pot", "p.old_acc"))
    np.testing.assert_array_equal(got["p.ti_endstep"], want["p.ti_endstep"])


def test_galaxy_potential_pass_and_energy(galaxy_runs):
    """``compute_potential`` under the tree against the JAX package's on
    the last state of each run; energy and momentum over the 6 sync points
    by the reference's bounds."""
    sim, jsim = galaxy_runs["sim"], galaxy_runs["jsim"]
    cfg, opts = galaxy_runs["cfg"], galaxy_runs["opts"]
    st = potential_pass(sim.state, cfg, opts)
    want = np.asarray(j_potential_pass(jsim.state, jsim.cfg, jsim.opts).p.pot)
    _close(st.p.pot, want)
    assert (st.p.pot[st.p.alive] < 0).all()
    e0, en = galaxy_runs["e0"], energy_statistics(st, cfg, opts)
    assert abs(float(en.total) - float(e0.total)) < 0.02 * abs(float(e0.total))
    assert ((en.momentum - e0.momentum).abs() < 1e-3).all()


def test_cli_runs_the_galaxy_parameter_file_on_the_cpu(tmp_path):
    """``python -m gadget_leicester_tpu_torch galaxy.param 0 --device cpu``
    on the stock parameter file with 2 x 4,200 particles (above
    ``direct_threshold``, so the file alone selects the tree), jax
    unimportable: the state is initialised through the tree (the first
    force computation) and the run ends with exit 0; without ``--device``
    and without a card it stops with the clear error and never takes the
    CPU."""
    n = chip_smoke.write_tree_ics(str(tmp_path / "ics.dat"), "galaxy", 8400)
    param = tmp_path / "galaxy.param"
    param.write_text(chip_smoke.stock_param_text(
        "galaxy", str(tmp_path / "ics.dat"), str(tmp_path / "out"), 0.2))
    proc = cli(param, 0, "--device", "cpu", "--max-steps", 0)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert n == 8400 and f"N={n} particles on cpu" in proc.stdout
    assert "gravity=auto, pmgrid=0" in proc.stdout
    assert "done: 0 steps, t=0" in proc.stdout
    if not torch.cuda.is_available():
        proc = cli(param, 0, "--max-steps", 1)
        assert proc.returncode == 1
        assert "no CUDA device" in proc.stderr
        assert "NotImplementedError" not in proc.stderr
