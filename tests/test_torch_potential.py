"""The full potential on the CPU: kernel H's plain version
(ops/gravity_short.py, through the wrapper in ops/cells.py) against the
JAX package's shortrange_gravity_cells with the potential, the port's
pm_potential_periodic and compute_potential against the JAX package's
(use_pallas off: independent code), the self-pair rule of the potential,
and the overflow bit of the fresh cell list."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.config import \
    parse_parameter_text as j_parse
from gadget_leicester_tpu.core.state import from_arrays as j_from_arrays
from gadget_leicester_tpu.models.forces import \
    compute_potential as j_compute_potential
from gadget_leicester_tpu.models.ics import lcdm_gas_ics
from gadget_leicester_tpu.ops import pm as jpm
from gadget_leicester_tpu.ops.gravity_short import shortrange_gravity_cells
from gadget_leicester_tpu.ops.neighbors import build_cell_list as j_build
from gadget_leicester_tpu.ops.softening import grav_pot as j_grav_pot
from gadget_leicester_tpu_torch import kernels
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.core.state import CLOSE_TOL, from_numpy
from gadget_leicester_tpu_torch.models.forces import compute_potential
from gadget_leicester_tpu_torch.ops import pm
from gadget_leicester_tpu_torch.ops.cells import (pack_cells_soa,
                                                  shortrange_potential_tiles)
from gadget_leicester_tpu_torch.ops.neighbors import (build_cell_list,
                                                      merge_rows)
from tests.test_torch_slice import OPTS, PARAM, _jax_dict

BOX = 1.0
N_CELLS = 5
CAP = 128                    # holds the clump of _particles: no overflow
ASMTH, RCUT = 0.04, 0.18     # rcut < cell edge 0.2: the stencil is complete
SOFT = 0.02


def _particles(seed, n=900):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)).astype(np.float32) * BOX
    pos[: n // 9] = (0.08 + 0.12 * rng.random((n // 9, 3))).astype(np.float32)
    pos[-40:, 0] = (rng.random(40) * 0.01).astype(np.float32)  # at x = 0
    mass = (rng.random(n) + 0.5).astype(np.float32)
    soft = np.full(n, SOFT, np.float32)
    alive = np.ones(n, bool)
    alive[-7:] = False
    return pos, mass, soft, alive


def _port_tiles(pos, mass, soft, alive, cap=CAP):
    """(acc [N, 3], pot [N]) of kernel H's plain version, no G."""
    t = [torch.from_numpy(np.asarray(a)) for a in (pos, mass, soft, alive)]
    cl = build_cell_list(t[0], t[3], 0.0, BOX, N_CELLS, cap)
    soa = pack_cells_soa(cl, *t)
    flags = torch.ones(N_CELLS ** 3, dtype=torch.int32)
    before = dict(kernels.launches)
    out = shortrange_potential_tiles(soa, flags, N_CELLS, BOX, ASMTH, RCUT)
    assert kernels.launches == before   # the CPU path launches nothing
    assert out.shape == (N_CELLS ** 3, 4, cap)
    rows = merge_rows(out, cl, 4)
    return rows[:, :3].numpy(), rows[:, 3].numpy()


def test_plain_h_matches_jax_shortrange_cells():
    """H's plain version against shortrange_gravity_cells(...,
    with_potential=True), which takes erfc exactly: the potential within
    2e-5 of its largest |value| (the degree-10 erfc polynomial errs by at
    most 5.2e-7 per pair, float32 sums in another order); the
    accelerations within 1e-4 of the largest |acc| (the force polynomial
    errs by 6.5e-6 per pair, summed over ~100 pairs of either sign)."""
    pos, mass, soft, alive = _particles(3)
    acc, pot = _port_tiles(pos, mass, soft, alive)
    jcl = j_build(jnp.asarray(pos), jnp.asarray(alive), 0.0, BOX,
                  n_cells=N_CELLS, capacity=CAP, periodic=True)
    jacc, jpot = shortrange_gravity_cells(
        jcl, jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(soft),
        jnp.asarray(alive), ASMTH, RCUT, box=BOX, periodic=True,
        with_potential=True)
    jacc, jpot = np.asarray(jacc), np.asarray(jpot)
    np.testing.assert_allclose(pot, jpot, rtol=0,
                               atol=2e-5 * np.abs(jpot).max())
    np.testing.assert_allclose(acc, jacc, rtol=0,
                               atol=1e-4 * np.abs(jacc).max())
    assert not pot[~alive].any() and not acc[~alive].any()


def test_pm_potential_matches_jax():
    """The mesh potential: pocketfft vs XLA's FFT, the same deposit and
    gather; 1e-5 of the largest |phi|, as the PM forces
    (tests/test_torch_pm.py)."""
    rng = np.random.default_rng(5)
    n, box, g = 2000, 100.0, 16
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    pos[:500] = (20.0 + 10.0 * rng.random((500, 3))).astype(np.float32)
    mass = (rng.random(n) + 0.5).astype(np.float32)
    alive = rng.random(n) < 0.95
    got = pm.pm_potential_periodic(torch.from_numpy(pos),
                                   torch.from_numpy(mass),
                                   torch.from_numpy(alive), box, g).numpy()
    want = np.asarray(jpm.pm_potential_periodic(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(alive), box, g))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _lcdm_states(opts_kw=None):
    """One lcdm_gas 2x12^3 state (test_torch_slice's configuration) in the
    JAX package and carried to the port with from_numpy."""
    cfg = parse_parameter_text(PARAM)
    pos, vel, mass, ptype, _ = lcdm_gas_ics(
        n_side=12, box=cfg.box_size, omega0=0.3, omega_b=0.04,
        hubble=cfg.hubble_internal, g=cfg.grav_internal)
    kw = dict(OPTS, **(opts_kw or {}))
    jopts = JOptions(use_pallas="off", **kw)
    pid = np.arange(1, len(pos) + 1)
    jst = j_from_arrays(pos, vel, mass, ptype, pid, jopts)
    return (jst, from_numpy(_jax_dict(jst), "cpu"), j_parse(PARAM), jopts,
            cfg, SimOptions(**kw))


def test_compute_potential_matches_jax():
    """From one state: p.pot within CLOSE_TOL (2e-5) of its largest value,
    the overflow flags equal (0: the box is near uniform). The JAX
    package's CPU branch sums on its own cell list with exact erfc; the
    port runs kernel H's plain version on the fresh 128-slot list and the
    point deposit of the mesh potential."""
    jst, st, jcfg, jopts, cfg, opts = _lcdm_states()
    got = compute_potential(st, cfg, opts)
    want = j_compute_potential(jst, jcfg, jopts)
    wpot = np.asarray(want.p.pot)
    gpot = got.p.pot.numpy()
    assert np.isfinite(gpot).all()
    np.testing.assert_allclose(gpot, wpot, rtol=0,
                               atol=CLOSE_TOL * np.abs(wpot).max())
    assert int(got.overflow_flags) == int(want.overflow_flags) == 0
    alive = st.p.alive.numpy()
    assert not gpot[~alive].any() and (gpot[alive] != 0).all()
    # nothing but p.pot and the overflow flags changes
    assert torch.equal(got.p.pos, st.p.pos) and got.gas is st.gas


def test_compute_potential_refuses_outside_slice():
    """float64 lies outside the slice (the kernels are float32) and is
    refused; the force test's fraction no longer does: with it set the
    potential pass runs and gives the same p.pot bit for bit."""
    _, st, _, _, cfg, opts = _lcdm_states()
    with pytest.raises(NotImplementedError, match="float32"):
        compute_potential(st, cfg, dataclasses.replace(opts, dtype="f64"))
    want = compute_potential(st, cfg, opts)
    got = compute_potential(st, cfg, dataclasses.replace(opts, forcetest=0.1))
    assert torch.equal(got.p.pot, want.p.pot)


def test_isolated_particle_has_zero_short_range_potential():
    """The self-pair (grav_pot(0, h) = -2.8/h) adds nothing: a target meets
    its own pack slot at r2 == 0 exactly. A lone particle's row is 0, bit
    for bit, in the cell interior and across the periodic wrap."""
    for x in (0.5, 0.0, 0.9999):
        pos = np.array([[x, 0.31, 0.77], [0.2, 0.7, 0.2]], np.float32)
        mass = np.array([2.0, 1.0], np.float32)
        soft = np.full(2, SOFT, np.float32)
        alive = np.array([True, False])
        acc, pot = _port_tiles(pos, mass, soft, alive, cap=8)
        assert pot[0] == 0.0 and not acc[0].any()


@pytest.mark.parametrize("where", ["same cell", "neighbour cell", "wrap",
                                   "softened"])
def test_pair_potential_at_known_r(where):
    """Two particles at separation r: each sees -m_j grav_pot(r, h)
    erfc(r / (2 asmth)) (grav_pot = -1/r outside the softening h), within
    the erfc polynomial's 5.2e-7 plus 1e-6 for float32 rounding, of m/r.
    'softened': r < h, the spline branch."""
    a = {"same cell": (0.42, 0.55), "neighbour cell": (0.35, 0.47),
         "wrap": (0.97, 0.07), "softened": (0.50, 0.512)}[where]
    pos = np.array([[a[0], 0.5, 0.5], [a[1], 0.5, 0.5]], np.float32)
    mass = np.array([1.5, 0.75], np.float32)
    soft = np.full(2, SOFT, np.float32)
    alive = np.ones(2, bool)
    _, pot = _port_tiles(pos, mass, soft, alive, cap=8)
    dx = float(pos[1, 0]) - float(pos[0, 0])
    r = abs(dx - BOX * round(dx / BOX))
    gp = float(j_grav_pot(jnp.float32(r), SOFT)) if r < SOFT else -1.0 / r
    erfc = math.erfc(r / (2 * ASMTH))
    for i, j in ((0, 1), (1, 0)):
        want = float(mass[j]) * gp * erfc
        assert abs(pot[i] - want) <= (5.2e-7 + 1e-6) * float(mass[j]) / r


def test_clump_over_capacity_sets_bit_1():
    """More than 128 particles in one cell of the fresh list: bit 1 of
    overflow_flags, and the potential stays finite; a capacity of 256 (the
    overflow bump's next step) holds them."""
    _, st, _, _, cfg, opts = _lcdm_states()
    n_clump = 200
    pos = st.p.pos.clone()
    pos[:n_clump] = torch.tensor([1000.0, 1000.0, 1000.0]) \
        + 50.0 * torch.rand(n_clump, 3, generator=torch.Generator()
                            .manual_seed(3))
    st = dataclasses.replace(st, p=dataclasses.replace(st.p, pos=pos))
    got = compute_potential(st, cfg, opts)
    assert int(got.overflow_flags) & 1
    assert torch.isfinite(got.p.pot).all()
    bigger = compute_potential(
        st, cfg, dataclasses.replace(opts, sr_capacity=256))
    assert int(bigger.overflow_flags) == 0



def test_walk_model_of_kernel_h_keeps_every_pair_inside_rcut():
    """chip_smoke.gravity_walk, the model of the culling of kernels A and
    H (csrc/shortrange_gravity.cu), on a clump that puts more than 128
    live slots in one cell of a 256-slot list (two passes of 128 targets,
    each ranked on its own) and particles at x = 0: every pair of a live
    target and a source with m > 0 at 0 < r2 < rcut^2 (float32, as the
    kernels take it) is walked, and the walk leaves out some pairs."""
    import chip_smoke
    from gadget_leicester_tpu_torch.ops.gravity_short import stencil_sources
    pos, mass, soft, alive = _particles(3, n=1400)
    t = [torch.from_numpy(np.asarray(a)) for a in (pos, mass, soft, alive)]
    cl = build_cell_list(t[0], t[3], 0.0, BOX, N_CELLS, 256)
    assert not bool(cl.overflow)
    soa = pack_cells_soa(cl, *t)
    assert int((soa[:, 5] > 0).sum(1).max()) > 128
    flags = torch.ones(N_CELLS ** 3, dtype=torch.int32)
    args = (soa, flags, N_CELLS, BOX, ASMTH, RCUT)
    rcut2 = torch.tensor(RCUT * RCUT, dtype=torch.float32)
    inside = kept = walked = stencil = 0
    for c0 in range(0, N_CELLS ** 3, 5):
        cells = torch.arange(c0, c0 + 5)
        xyz, lv, sxyz, near = chip_smoke.gravity_walk(args, cells)
        d2 = 0.0
        for a in range(3):
            d = xyz[:, a, :, :, None] - sxyz[:, a, None, None, :]
            d2 = d2 + d * d
        s_live = (soa[stencil_sources(N_CELLS, cells)[0]][:, :, 3] != 0)
        pair = lv[..., None] & s_live.flatten(1)[:, None, None, :]
        in_cut = pair & (d2 > 0) & (d2 < rcut2)
        inside += int(in_cut.sum())
        kept += int((in_cut & near[:, :, None, :]).sum())
        walked += int((pair & near[:, :, None, :]).sum())
        stencil += int(pair.sum())
    assert inside > 0 and kept == inside
    assert walked < stencil


@pytest.mark.parametrize("grid", ["periodic", "clamped", "clamped, no cut"])
def test_walk_model_of_kernel_m_keeps_every_pair_inside_rcut(grid):
    """chip_smoke.gravity_cells_walk, the model of kernel M's culling
    (csrc/shortrange_gravity_cells.cu: targets ranked by glt::rank_by_box,
    a box a warp, the distance of each axis's interval of dx from the
    nearest multiple of the box), on a fresh list of 3^3 cells of 256
    slots (two passes of 128 targets where a cell holds more): periodic,
    with coordinates equal to the box, filed in cell 0 beside their
    neighbours' images; on a clamped grid cut at the cell edge; and on a
    clamped grid with rcut = 1e30 (plain softened gravity, nothing may be
    culled). Every pair of a live target and a source with m != 0 in a
    stencil cell on the grid at 0 < r2 < rcut^2 (1 + 1e-6) (float32,
    after the per-pair minimum image, as the kernel takes it) is walked;
    with a cut, the walk leaves out some pairs."""
    import chip_smoke
    from gadget_leicester_tpu_torch.ops.gravity_short import \
        shortrange_gravity_fresh
    from gadget_leicester_tpu_torch.ops.neighbors import stencil_cells
    periodic = grid == "periodic"
    box, n_cells, n = 10.0, 3, 4000
    rcut = 1e30 if grid.endswith("no cut") else 3.15
    rng = np.random.default_rng(21)
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    pos[:3] = [[box, 1.0, 1.0], [0.0, box, 0.5], [box, box, box]]
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    soft = rng.uniform(0.05, 0.3, n).astype(np.float32)
    alive = np.ones(n, bool)
    alive[-9:] = False
    t = [torch.from_numpy(a) for a in (pos, mass, soft, alive)]
    with chip_smoke.recorded_inputs() as rec:
        _, ovf = shortrange_gravity_fresh(
            *t, box, n_cells, capacity=256, asmth=0.7 if periodic else 0.0,
            rcut=rcut, periodic=periodic)
    assert not bool(ovf)
    args = rec["shortrange_gravity_cells"]
    soa = args[0]
    assert int((soa[:, 5] > 0).sum(1).max()) > 128
    up = torch.tensor(min(rcut * rcut * (1.0 + 1e-6),
                          float(np.finfo(np.float32).max)))
    fbox = torch.tensor(box)
    inside = kept = walked = stencil = 0
    for c0 in range(0, n_cells ** 3, 3):
        cells = torch.arange(c0, c0 + 3)
        xyz, lv, sxyz, near = chip_smoke.gravity_cells_walk(args, cells)
        d2 = 0.0
        for a in range(3):
            d = xyz[:, a, :, :, None] - sxyz[:, a, None, None, :]
            if periodic:
                d = d - fbox * torch.round(d * (1.0 / fbox))
            d2 = d2 + d * d
        ids, _, on = stencil_cells(n_cells, cells, periodic)
        src = ((soa[ids][:, :, 3] != 0) & on[:, :, None]).flatten(1)
        pair = lv[..., None] & src[:, None, None, :]
        in_cut = pair & (d2 > 0) & (d2 < up)
        inside += int(in_cut.sum())
        kept += int((in_cut & near[:, :, None, :]).sum())
        walked += int((pair & near[:, :, None, :]).sum())
        stencil += int(pair.sum())
    assert inside > 0 and kept == inside
    if rcut < 1e30:
        assert walked < stencil
    else:
        assert walked == stencil
