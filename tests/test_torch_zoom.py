"""The zoom gravity of the port against the JAX package on the CPU: the
vacuum and band-pass PM functions (``ops/pm.py``) at meshes of 16 and 32
cells, the stencil and pair driver (``ops/neighbors.py``), and
``compute_forces`` / ``compute_potential`` with ``gravity_mode="zoom"`` on
tests/test_zoom.py's clump in a sparse background, against the JAX package
(its kernels off) and against the direct sum by test_zoom.py's bounds; an
overflowing coarse list sets bit 1 as in the reference."""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.config import \
    parse_parameter_text as j_parse
from gadget_leicester_tpu.core.state import from_arrays as j_from_arrays
from gadget_leicester_tpu.models.forces import \
    compute_forces as j_compute_forces
from gadget_leicester_tpu.models.forces import \
    compute_potential as j_compute_potential
from gadget_leicester_tpu.ops import neighbors as jnb
from gadget_leicester_tpu.ops import pm as jpm
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.core.state import from_arrays
from gadget_leicester_tpu_torch.models.forces import (compute_forces,
                                                      compute_potential,
                                                      softening_table)
from gadget_leicester_tpu_torch.ops import neighbors as nb
from gadget_leicester_tpu_torch.ops import pm
from gadget_leicester_tpu_torch.ops.gravity_direct import direct_gravity
from gadget_leicester_tpu_torch.ops.softening import SOFTFAC
from tests.test_zoom import _zoom_setup

PARAM = """
InitCondFile x
OutputDir /tmp/zoom
TimeBegin 0
TimeMax 1
ComovingIntegrationOn 0
PeriodicBoundariesOn 0
SofteningGas 0.5
SofteningHalo 0.5
SofteningDisk 20
"""
OPTS = dict(periodic=False, pmgrid=32, hr_pmgrid=32, hr_types=0b10,
            gravity_mode="zoom")
# float32 FFTs and erf of two libraries, and the sums of a pass in another
# order: the PM pieces to 2e-5 of their largest value (vacuum mesh
# kernels 1e-5), the zoom's forces and potentials to 1e-4 of the largest
# (the short-range sums cancel to ~1e-3 of their terms near the clump)
PM_TOL = 2e-5
KERNEL_TOL = 1e-5
ZOOM_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: {err:.2e} of the largest |value| {scale:.4g}"


def _region(seed, n):
    """A seeded clumpy cloud and its bounding region, as the zoom fits it
    (origin [3] float32, extent float32)."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.normal(30.0, 4.0, (n // 2, 3)),
                          rng.uniform(5.0, 60.0, (n - n // 2, 3))])
    pos = pos.astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.05
    lo, hi = pos.min(0), pos.max(0)
    pad = np.float32(0.01) * (hi - lo).max() + np.float32(1e-6)
    return pos, mass, alive, (lo - pad).astype(np.float32), \
        np.float32((hi - lo).max() + 2 * pad)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n", [16, 32])
def test_freespace_kernel_matches(n):
    cell = float(np.float32(70.0) / n)
    asmth = pm.ASMTH * cell
    got = pm._freespace_kernel_k(n, cell, asmth, "cpu").numpy()
    want = np.asarray(jpm._freespace_kernel_k(n, cell, asmth, jnp.float32))
    assert got.shape == want.shape == (2 * n, 2 * n, n + 1)
    close(got, want, KERNEL_TOL, "free-space kernel")


@pytest.mark.parametrize("n", [16, 32])
def test_freespace_diff_kernel_matches(n):
    cell = float(np.float32(40.0) / n)
    a_hi, a_lo = pm.ASMTH * cell, 3.7 * pm.ASMTH * cell
    got = pm._freespace_diff_kernel_k(n, cell, a_hi, a_lo, "cpu").numpy()
    want = np.asarray(jpm._freespace_diff_kernel_k(n, cell, a_hi, a_lo,
                                                   jnp.float32))
    close(got, want, KERNEL_TOL, "band-pass kernel")


@pytest.mark.parametrize("n", [16, 32])
def test_vacuum_field_matches(n):
    """The mass in the first octant of the padded mesh, as the deposit
    leaves it."""
    rng = np.random.default_rng(n)
    grid = np.zeros((2 * n,) * 3, np.float32)
    grid[:n, :n, :n] = rng.uniform(0, 1, (n, n, n)) ** 4
    cell = float(np.float32(50.0) / n)
    force, phi = pm.vacuum_field(torch.from_numpy(grid), n, cell,
                                 pm.ASMTH * cell)
    jforce, jphi = jpm.vacuum_field(jnp.asarray(grid), n, cell,
                                    pm.ASMTH * cell)
    close(force.numpy(), jforce, PM_TOL, "force")
    close(phi.numpy(), jphi, PM_TOL, "phi")


@pytest.mark.parametrize("n", [16, 32])
def test_pm_forces_nonperiodic_matches(n):
    pos, mass, alive, origin, extent = _region(3, 1500)
    acc, pot = pm.pm_forces_nonperiodic(*_t(pos, mass, alive, origin),
                                        float(extent), n,
                                        with_potential=True)
    jacc, jpot = jpm.pm_forces_nonperiodic(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(alive),
        jnp.asarray(origin), jnp.float32(extent), n, with_potential=True)
    close(acc.numpy(), jacc, PM_TOL, "acc")
    close(pot.numpy(), jpot, PM_TOL, "pot")
    assert not acc.numpy()[~alive].any() and not pot.numpy()[~alive].any()
    alone = pm.pm_forces_nonperiodic(*_t(pos, mass, alive, origin),
                                     float(extent), n)
    assert torch.equal(alone, acc)


@pytest.mark.parametrize("n", [16, 32])
def test_pm_forces_diff_matches(n):
    """The fine region: the clump's bounding cube, 5% padding; the
    particles outside it get zeros and are no sources."""
    pos, mass, alive, _, ext_c = _region(4, 1500)
    inner = np.abs(pos - 30.0).max(1) < 9.0
    lo, hi = pos[inner].min(0), pos[inner].max(0)
    pad = np.float32(0.05) * (hi - lo).max() + np.float32(1e-6)
    origin, extent = (lo - pad).astype(np.float32), \
        np.float32((hi - lo).max() + 2 * pad)
    asmth_lo = float(pm.ASMTH * ext_c / n)
    acc, pot, in_reg = pm.pm_forces_diff(*_t(pos, mass, alive, origin),
                                         float(extent), n, asmth_lo,
                                         with_potential=True)
    jacc, jpot, jin = jpm.pm_forces_diff(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(alive),
        jnp.asarray(origin), jnp.float32(extent), n, asmth_lo,
        with_potential=True)
    assert np.array_equal(in_reg.numpy(), np.asarray(jin))
    assert in_reg.sum() > 400 and (~in_reg.numpy() & alive).sum() > 400
    close(acc.numpy(), jacc, PM_TOL, "acc")
    close(pot.numpy(), jpot, PM_TOL, "pot")


def _lists(periodic, capacity=64, n_cells=5, seed=7):
    pos, _, alive, origin, extent = _region(seed, 1200)
    if periodic:
        origin, extent = np.zeros(3, np.float32), np.float32(70.0)
        pos = np.mod(pos, 70.0).astype(np.float32)
    jcl = jnb.build_cell_list(jnp.asarray(pos), jnp.asarray(alive),
                              jnp.asarray(origin), jnp.float32(extent),
                              n_cells=n_cells, capacity=capacity,
                              periodic=periodic)
    cl = nb.build_cell_list(*_t(pos, alive, origin), float(extent),
                            n_cells=n_cells, capacity=capacity,
                            periodic=periodic)
    return pos, alive, jcl, cl


@pytest.mark.parametrize("periodic", [False, True])
def test_candidate_indices_match(periodic):
    """The same candidates, slot for slot, for targets inside the grid, on
    its edge and beyond it (clamped or wrapped)."""
    pos, _, jcl, cl = _lists(periodic)
    rng = np.random.default_rng(8)
    tgt = np.concatenate([pos[:300], rng.uniform(-20, 90, (100, 3))]
                         ).astype(np.float32)
    got = nb.candidate_indices(cl, torch.from_numpy(tgt)).numpy()
    want = np.asarray(jnb.candidate_indices(jcl, jnp.asarray(tgt)))
    assert got.shape == want.shape == (400, 27 * 64)
    assert np.array_equal(got, want)


def _neighbour_mass(pos, mass, radius, xp):
    """A pair function of both packages: the mass and the count of the
    candidates within ``radius`` of each target."""
    def fn(idx, tp, cand):
        ci = xp.where(cand >= 0, cand, 0)
        d = tp[:, None, :] - pos[ci]
        near = (cand >= 0) & ((d * d).sum(-1) < radius ** 2)
        return (xp.where(near, mass[ci], 0.0).sum(-1),
                near.sum(-1))
    return fn


@pytest.mark.parametrize("periodic", [False, True])
def test_apply_pairwise_matches(periodic):
    """A pair function through both drivers: counts equal, masses to
    float32 rounding; a restricted target count gives the prefix."""
    pos, alive, jcl, cl = _lists(periodic)
    mass = np.random.default_rng(9).uniform(1, 2, len(pos)).astype(
        np.float32)
    m, c = nb.apply_pairwise(cl, torch.from_numpy(pos), _neighbour_mass(
        torch.from_numpy(pos), torch.from_numpy(mass), 6.0, torch),
        block=128)
    jm, jc = jnb.apply_pairwise(jcl, jnp.asarray(pos), _neighbour_mass(
        jnp.asarray(pos), jnp.asarray(mass), 6.0, jnp), block=128)
    assert np.array_equal(c.numpy(), np.asarray(jc)) and c.sum() > len(pos)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6)
    m5, _ = nb.apply_pairwise(cl, torch.from_numpy(pos), _neighbour_mass(
        torch.from_numpy(pos), torch.from_numpy(mass), 6.0, torch),
        block=64, n_targets=500)
    assert torch.equal(m5, m[:500])


def test_stencil_sum_does_not_depend_on_the_block():
    """Each row's sum of :func:`stencil_sum` is the same bit for bit in a
    block of 1, 7 or all 40 rows, for a capacity that is not a power of
    two (padded), and equals the plain sum to float32 rounding."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=(40, 27 * 48, 4)).astype(
        np.float32))
    whole = nb.stencil_sum(x, 48)
    for b in (1, 7):
        parts = torch.cat([nb.stencil_sum(x[i:i + b], 48)
                           for i in range(0, 40, b)])
        assert torch.equal(parts, whole)
    np.testing.assert_allclose(whole.numpy(), x.double().sum(1).numpy(),
                               rtol=0, atol=1e-4)


# tests/test_zoom.py's own realization: its rng fixture seeds numpy with
# the crc32 of the test's node id. The zoom's error against the direct sum
# depends on the realization, in both packages alike (to 1e-7): seeds 1, 3
# and 11 give an HR rms of 1.8%, 3.8% and 2.7% (test_zoom's bound 1%), its
# own 0.93% (ROADMAP queue 3)
ZOOM_SEED = zlib.crc32(b"tests/test_zoom.py::test_zoom_gravity_vs_direct")


def _zoom_states(opts_over=None):
    pos, vel, mass, ptype, n_hr = _zoom_setup(
        np.random.default_rng(ZOOM_SEED))
    over = opts_over or {}
    cfg, jcfg = parse_parameter_text(PARAM), j_parse(PARAM)
    opts = SimOptions(**OPTS, **over)
    jopts = JOptions(use_pallas="off", **OPTS, **over)
    st = from_arrays(pos, vel, mass, ptype, np.arange(1, len(mass) + 1),
                     opts, "cpu")
    jst = j_from_arrays(pos, vel, mass, ptype, np.arange(1, len(mass) + 1),
                        jopts)
    return cfg, opts, st, jcfg, jopts, jst


@pytest.fixture(scope="module")
def zoom():
    cfg, opts, st, jcfg, jopts, jst = _zoom_states()
    got = compute_forces(st, cfg, opts, do_sph=False)
    want = j_compute_forces(jst, jcfg, jopts, do_sph=False)
    got_pot = compute_potential(st, cfg, opts)
    want_pot = j_compute_potential(jst, jcfg, jopts)
    return dict(cfg=cfg, st=st, got=got, want=want, got_pot=got_pot,
                want_pot=want_pot)


def test_zoom_forces_match_jax(zoom):
    """acc (the two short-range passes), acc_pm (both meshes, times G) and
    the potential of the force pass, port against the JAX package."""
    got, want = zoom["got"].p, zoom["want"].p
    for name in ("acc", "acc_pm", "pot"):
        close(getattr(got, name).numpy(), getattr(want, name), ZOOM_TOL,
              name)
    assert not got.pot_pm.any() and not np.asarray(want.pot_pm).any()
    # the clump fills one coarse cell beyond the reference's default
    # capacity: both set bit 1 (pass A drops no HR-HR pair it would keep)
    assert int(zoom["got"].overflow_flags) == \
        int(zoom["want"].overflow_flags) == 1


def test_zoom_potential_matches_jax(zoom):
    close(zoom["got_pot"].p.pot.numpy(), zoom["want_pot"].p.pot, ZOOM_TOL,
          "pot")
    # the same pass as the force pass's, whose dead rows are not zeroed
    alive = zoom["st"].p.alive
    assert torch.equal(zoom["got_pot"].p.pot[alive], zoom["got"].p.pot[alive])
    assert not zoom["got_pot"].p.pot[~alive].any()


def test_zoom_matches_the_direct_sum(zoom):
    """test_zoom.py's bounds: HR rms force error < 1%, all < 2%, HR
    potential rms < 2%, against the float64 direct sum."""
    st, p = zoom["st"], zoom["got"].p
    cfg = zoom["cfg"]
    soft = SOFTFAC * softening_table(cfg, torch.ones(()))[st.p.ptype.long()]
    acc_d, pot_d = direct_gravity(st.p.pos.double(), st.p.mass.double(),
                                  soft.double(), st.p.alive)
    g = cfg.grav_internal
    ref, got = (acc_d * g).numpy(), (p.acc + p.acc_pm).double().numpy()
    alive = st.p.alive.numpy()
    is_hr = alive & (st.p.ptype.numpy() == 1)
    rel = np.sqrt(((got - ref) ** 2).sum(1)
                  / np.maximum((ref ** 2).sum(1), 1e-30))
    assert np.sqrt(np.mean(rel[is_hr] ** 2)) < 0.01
    assert np.sqrt(np.mean(rel[alive] ** 2)) < 0.02
    pref = (pot_d * g).numpy()
    perr = np.abs(p.pot.double().numpy() - pref) / np.maximum(np.abs(pref),
                                                               1e-30)
    assert np.sqrt(np.mean(perr[is_hr] ** 2)) < 0.02


def test_overflowing_coarse_list_sets_bit_1():
    """At 128 slots a cell the coarse cell list overflows (the clump puts
    its 3,000 particles into one coarse cell) and the fine one does not (at
    most 66 a cell): bit 1 is set in the force pass and in the potential,
    as in the reference, and the other bits stay clear."""
    cfg, opts, st, jcfg, jopts, jst = _zoom_states(dict(sr_capacity=128))
    got = compute_forces(st, cfg, opts, do_sph=False)
    want = j_compute_forces(jst, jcfg, jopts, do_sph=False)
    assert int(got.overflow_flags) == int(want.overflow_flags) == 1
    pot = compute_potential(dataclasses.replace(
        st, overflow_flags=torch.zeros_like(st.overflow_flags)), cfg, opts)
    assert int(pot.overflow_flags) == 1


def test_set_ics_raises_the_short_range_capacity_on_a_zoom_overflow():
    """chip_smoke.zoom_ics at 8^3 HR and 4^3 coarse particles, 16 slots a
    cell: the coarse list overflows in ``set_ics``, which raises the
    short-range capacity as the run loop does (+128) and starts over;
    the state it keeps has no overflow bit, and a sync point runs."""
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg = chip_smoke.zoom_config()
    pos, vel, mass, ptype = chip_smoke.zoom_ics(cfg, hr_side=8, lr_side=4)
    opts = SimOptions(**dict(chip_smoke.ZOOM_OPTS, pmgrid=32, hr_pmgrid=32,
                             sr_capacity=16))
    sim = Simulation(cfg, opts, "cpu")
    sim.set_ics(pos, vel, mass, ptype)
    assert sim.init_notes == ["overflow 1: capacities -> sph=0 sr=144 "
                              "ghost=0.0"]
    assert sim.opts.sr_capacity == 144
    assert int(sim.state.overflow_flags) == 0
    sim.step()
    assert int(sim.state.overflow_flags) == 0
    assert torch.isfinite(sim.state.p.acc).all()


def test_check_supported_takes_the_zoom_and_the_switches():
    """Zoom, nogravity, adaptive gas softening and the isothermal EOS are
    accepted, and so is the force test; per-axis periodic tuples (the
    slab step builds its own) are refused, and so is TreePM with vacuum
    boundaries, a fault of the reference, with a message naming the zoom
    and the slab step; a zoom without a coarse mesh is an error."""
    from gadget_leicester_tpu_torch.models.forces import check_supported
    cfg = parse_parameter_text(PARAM)
    for over in ({}, dict(nogravity=True), dict(adaptive_gravsoft_forgas=True),
                 dict(isotherm_eqs=True)):
        check_supported(cfg, SimOptions(**OPTS, **over), 3500, 1)
    for over in (dict(gravity_mode="treepm"), dict(isotherm_eqs=True),
                 dict(adaptive_gravsoft_forgas=True)):
        check_supported(cfg, SimOptions(periodic=True, pmgrid=32, **over),
                        3500, 3000)
    check_supported(cfg, SimOptions(**OPTS, forcetest=0.1), 3500, 1)
    with pytest.raises(NotImplementedError, match="per-axis periodic"):
        check_supported(cfg, SimOptions(periodic=(False, True, True)), 10, 1)
    with pytest.raises(NotImplementedError,
                       match='gravity_mode="zoom".*--devices K'):
        check_supported(cfg, SimOptions(periodic=False, pmgrid=32,
                                        gravity_mode="treepm"), 3500, 1)
    check_supported(cfg, SimOptions(periodic=False, pmgrid=32,
                                    gravity_mode="treepm", nogravity=True),
                    3500, 1)
    with pytest.raises(ValueError, match="pmgrid > 0"):
        check_supported(cfg, SimOptions(**dict(OPTS, pmgrid=0)), 3500, 1)
