"""The slab step's kernel modes, through their plain versions, against the
JAX package: kernel A's slab mode (``ops/cells.py ::
shortrange_gravity_slab``; the reference's ``shortrange_gravity_pallas_dma9``
on a tuple ``n_cells`` with ``periodic=(False, True, True)`` and, in
vacuum, ``(False, False, False)``, run in interpret mode), with and
without the potential row, and kernels C and D on anisotropic block grids
(``ops/sph_blocks.py`` with a tuple ``n_blocks`` and ``fine_edge``), on
the slab's grid and clamped on all axes; the per-axis cell and block
lists equal to the JAX package's; and every cubic call unchanged by the
per-axis generalisation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.ops import neighbors as jn
from gadget_leicester_tpu.ops import pallas_cells as jpc
from gadget_leicester_tpu.ops import sph_blocks as jsb
from gadget_leicester_tpu_torch.ops import cells as tc
from gadget_leicester_tpu_torch.ops import gravity_short as gs
from gadget_leicester_tpu_torch.ops import sph_blocks as sb
from gadget_leicester_tpu_torch.ops.neighbors import (build_cell_list,
                                                      merge_rows)

# the port against the JAX package: the same float32 pair terms summed in
# another order, as a share of the largest value
TOL_GRAV = 2e-5
# the SPH fields: the Newton solve on the same sums, rho and h relative per
# particle, the hydro acceleration as a share of its largest value
TOL_RHO = 2e-5
TOL_DIV = 1e-4
TOL_ACC = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# per-axis lists
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ncv,per", [((3, 5, 5), (False, True, True)),
                                     ((1, 4, 4), (False, True, True)),
                                     ((4, 4, 4), True),
                                     ((4, 4, 4), False)])
def test_cell_list_per_axis_equals_jax(ncv, per):
    rng = np.random.default_rng(11)
    n = 500
    lo = np.array([-0.15, 0.0, 0.0])
    ext = np.array([0.6, 1.0, 1.0])
    pos = (lo + ext * rng.uniform(-0.05, 1.05, (n, 3))).astype(np.float32)
    alive = rng.uniform(size=n) > 0.1
    # a cubic grid passes its count as an int, as every cubic caller does
    ncv_arg = ncv[0] if len(set(ncv)) == 1 else ncv
    got = build_cell_list(torch.from_numpy(pos), torch.from_numpy(alive),
                          torch.from_numpy(lo.astype(np.float32)),
                          torch.from_numpy(ext.astype(np.float32)),
                          n_cells=ncv_arg, capacity=32, periodic=per)
    want = jn.build_cell_list(jnp.asarray(pos), jnp.asarray(alive),
                              jnp.asarray(lo, jnp.float32),
                              jnp.asarray(ext, jnp.float32),
                              n_cells=ncv_arg, capacity=32, periodic=per)
    for f in ("cells", "counts", "gslot"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(got.cell_of.numpy()[alive],
                                  np.asarray(want.cell_of)[alive])
    assert bool(got.overflow) == bool(want.overflow)
    assert got.n_cells == ncv_arg


@pytest.mark.parametrize("nb,per", [((1, 2, 2), (False, True, True)),
                                    ((3, 4, 4), (False, True, True)),
                                    (2, True), (2, False)])
def test_block_lists_per_axis_equal_jax(nb, per):
    rng = np.random.default_rng(12)
    n = 600
    fine = 0.25
    nb3 = nb if isinstance(nb, tuple) else (nb,) * 3
    ext = np.array([2 * q * fine for q in nb3])
    lo = np.array([0.1, 0.0, 0.0])
    pos = (lo + ext * rng.uniform(0.0, 1.0, (n, 3))).astype(np.float32)
    mask = rng.uniform(size=n) > 0.2
    got = sb.build_block_lists(torch.from_numpy(pos), torch.from_numpy(mask),
                               torch.from_numpy(lo.astype(np.float32)),
                               torch.from_numpy(ext.astype(np.float32)),
                               n_blocks=nb, subcap=64, periodic=per)
    want = jsb.build_block_lists(jnp.asarray(pos), jnp.asarray(mask),
                                 jnp.asarray(lo, jnp.float32),
                                 jnp.asarray(ext, jnp.float32),
                                 n_blocks=nb, subcap=64, periodic=per)
    for g, w in zip(got, want):
        assert g.n_cells == w.n_cells
        np.testing.assert_array_equal(g.cells.numpy(), np.asarray(w.cells))
        np.testing.assert_array_equal(g.gslot.numpy(), np.asarray(w.gslot))
        np.testing.assert_array_equal(g.counts.numpy(), np.asarray(w.counts))
        assert bool(g.overflow) == bool(w.overflow)


# --------------------------------------------------------------------------
# kernel A's slab mode
# --------------------------------------------------------------------------
def _slab_gravity_inputs(seed, ncv):
    """test_spmd_pallas.py::test_anisotropic_gravity_kernel_parity's
    geometry: x in [-0.15, 0.45) clamped in 3 cells of 0.2 (or ``ncv``'s
    count over the same span), y and z periodic over [0, 1)."""
    rng = np.random.default_rng(seed)
    n = 160
    pos = np.stack([rng.uniform(-0.15, 0.45, n), rng.uniform(0, 1.0, n),
                    rng.uniform(0, 1.0, n)], axis=1).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    soft = np.full(n, 0.02, np.float32)
    alive = np.ones(n, bool)
    alive[::17] = False
    lo = np.array([-0.15, 0.0, 0.0], np.float32)
    ext = np.array([0.6, 1.0, 1.0], np.float32)
    return pos, mass, soft, alive, lo, ext


SLAB_GRIDS = [(3, 5, 5), (1, 5, 5), (2, 4, 4)]
SLAB_PER = (False, True, True)
VACUUM_PER = (False, False, False)


def _slab_gravity_jax(pos, mass, soft, alive, lo, ext, ncv, per,
                      with_potential):
    """The JAX package's kernel A on the slab grid (interpret mode): acc,
    and with ``with_potential`` the potential too."""
    box, asmth, rcut = 1.0, 0.05, 0.19
    jcl = jn.build_cell_list(jnp.asarray(pos), jnp.asarray(alive),
                             jnp.asarray(lo), jnp.asarray(ext), n_cells=ncv,
                             capacity=128, periodic=per)
    res = jpc.shortrange_gravity_pallas_dma9(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(soft),
        jnp.asarray(alive), box=box, n_cells=ncv, capacity=128, asmth=asmth,
        rcut=rcut, periodic=per, cl=jcl, interpret=True,
        with_potential=with_potential)
    assert not bool(res[-1])
    return [np.asarray(r) for r in res[:-1]]


def _slab_gravity_port(pos, mass, soft, alive, lo, ext, ncv, per,
                       with_potential):
    """The port's A slab mode (the plain version on the CPU): the wrapper's
    tiles and the rows merged to particles."""
    t = [torch.from_numpy(a) for a in (pos, mass, soft, alive)]
    cl = build_cell_list(t[0], t[3], torch.from_numpy(lo),
                         torch.from_numpy(ext), n_cells=ncv, capacity=128,
                         periodic=per)
    soa = tc.pack_cells_abs(cl, *t)
    flags = torch.ones(soa.shape[0], dtype=torch.int32)
    out = tc.shortrange_gravity_slab(soa, flags, ncv, 1.0, per, 0.05, 0.19,
                                     with_potential=with_potential)
    return out, merge_rows(out, cl, 4 if with_potential else 3).numpy()


@pytest.mark.parametrize(
    "ncv,per", [(g, SLAB_PER) for g in SLAB_GRIDS]
    + [(g, VACUUM_PER) for g in SLAB_GRIDS],
    ids=["ncv0", "ncv1", "ncv2", "ncv0-vacuum", "ncv1-vacuum",
         "ncv2-vacuum"])
def test_gravity_slab_plain_equals_jax(ncv, per):
    """A's slab mode against the JAX package's on the slab grid, periodic
    in y and z and, in vacuum, clamped on all three axes."""
    pos, mass, soft, alive, lo, ext = _slab_gravity_inputs(3, ncv)
    (want,) = _slab_gravity_jax(pos, mass, soft, alive, lo, ext, ncv, per,
                                False)
    _, got = _slab_gravity_port(pos, mass, soft, alive, lo, ext, ncv, per,
                                False)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=TOL_GRAV * scale, rtol=0)
    assert np.all(got[~alive] == 0)


@pytest.mark.parametrize("per", [SLAB_PER, VACUUM_PER],
                         ids=["slab", "vacuum"])
@pytest.mark.parametrize("ncv", SLAB_GRIDS)
def test_gravity_slab_potential_plain_equals_jax(ncv, per):
    """A's slab mode with the potential against the JAX package's
    ``with_potential=True`` (interpret mode), force and potential within
    TOL_GRAV of their largest values; its rows 0-2 equal the force-only
    mode's bit for bit."""
    pos, mass, soft, alive, lo, ext = _slab_gravity_inputs(3, ncv)
    want_acc, want_pot = _slab_gravity_jax(pos, mass, soft, alive, lo, ext,
                                           ncv, per, True)
    out4, got = _slab_gravity_port(pos, mass, soft, alive, lo, ext, ncv,
                                   per, True)
    out3, _ = _slab_gravity_port(pos, mass, soft, alive, lo, ext, ncv, per,
                                 False)
    assert torch.equal(out4[:, :3], out3)
    for g, w in ((got[:, :3], want_acc), (got[:, 3], want_pot)):
        np.testing.assert_allclose(g, w, atol=TOL_GRAV * np.abs(w).max(),
                                   rtol=0)
    assert np.all(got[~alive] == 0)
    assert np.all(want_pot[alive] < 0)


def test_gravity_slab_potential_refuses_the_cube():
    """The potential mode is instantiated for the slab's periodicities
    only: a periodic cube raises before anything runs."""
    soa = torch.zeros(27, 8, 32)
    flags = torch.ones(27, dtype=torch.int32)
    with pytest.raises(ValueError, match="not instantiated"):
        tc.shortrange_gravity_slab(soa, flags, (3, 3, 3), 1.0, True, 0.05,
                                   0.19, with_potential=True)


def test_gravity_slab_flags_gate_tiles():
    """A's tile flags: a gated cell writes zeros, a flagged cell the sums
    of the ungated call, bit for bit."""
    pos, mass, soft, alive, lo, ext = _slab_gravity_inputs(4, (3, 5, 5))
    t = [torch.from_numpy(a) for a in (pos, mass, soft, alive)]
    cl = build_cell_list(t[0], t[3], torch.from_numpy(lo),
                         torch.from_numpy(ext), n_cells=(3, 5, 5),
                         capacity=32, periodic=(False, True, True))
    soa = tc.pack_cells_abs(cl, *t)
    active = torch.from_numpy(np.random.default_rng(5).uniform(
        size=len(pos)) < 0.3) & t[3]
    flags = tc.grav_tile_flags(cl, active)
    args = ((3, 5, 5), 1.0, (False, True, True), 0.05, 0.19)
    full = tc.shortrange_gravity_slab(soa, torch.ones_like(flags), *args)
    gated = tc.shortrange_gravity_slab(soa, flags, *args)
    on = flags > 0
    assert 0 < int(on.sum()) < len(flags)
    assert torch.equal(gated[on], full[on])
    assert not bool(gated[~on].any())


@pytest.mark.parametrize("periodic", [True, False])
def test_gravity_slab_on_a_cube_equals_kernel_m(periodic):
    """Every cubic call unchanged: the slab mode on (n, n, n) with one
    periodicity for all axes is M's plain version bit for bit."""
    rng = np.random.default_rng(6)
    n, box = 300, 2.0
    pos = torch.from_numpy(rng.uniform(0, box, (n, 3)).astype(np.float32))
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    soft = torch.full((n,), 0.05)
    alive = torch.ones(n, dtype=torch.bool)
    cl = build_cell_list(pos, alive, 0.0, box, n_cells=4, capacity=64,
                         periodic=periodic)
    soa = tc.pack_cells_abs(cl, pos, mass, soft, alive)
    m = gs.shortrange_gravity_cells_plain(soa, 4, box, periodic, 0.1, 0.45)
    slab = gs.shortrange_gravity_slab_plain(
        soa, torch.ones(64, dtype=torch.int32), (4, 4, 4), box,
        (periodic,) * 3, 0.1, 0.45)
    assert torch.equal(m, slab)


@pytest.mark.parametrize("grid", ["slab", "vacuum", "vacuum, no cut"])
def test_walk_model_of_the_slab_mode_keeps_every_pair_inside_rcut(grid):
    """chip_smoke.slab_gravity_walk, the model of the culling of A's slab
    mode (csrc/shortrange_gravity_cells.cu: each cell ranked whole, a warp
    a chunk of 32 ranks, chunk boxes, then single sources), on a slab grid
    of 3 x 4 x 4 cells of up to 160 slots (a clump fills one cell past
    128: five chunks of live ranks), with coordinates equal to the box filed in cell 0
    on the periodic axes; periodic in y and z, clamped on every axis, and
    clamped with rcut = 1e30 (nothing may be culled). Every pair of a live
    target and a source with m != 0 of a stencil cell on the grid at 0 <
    r2 < rcut^2 (1 + 1e-6) (float32, after the per-axis minimum image, as
    the kernel takes it) is walked; with a cut, the walk leaves out some
    pairs."""
    import chip_smoke
    from gadget_leicester_tpu_torch.ops.neighbors import stencil_cells
    per = SLAB_PER if grid == "slab" else VACUUM_PER
    box, ncv, n = 4.0, (3, 4, 4), 600
    rcut = 1e30 if grid.endswith("no cut") else 0.9
    rng = np.random.default_rng(23)
    pos = np.stack([rng.uniform(-0.2, 3.2, n), rng.uniform(0, box, n),
                    rng.uniform(0, box, n)], 1).astype(np.float32)
    pos[:140] = np.asarray([1.5, 2.5, 2.5]) + rng.uniform(-0.5, 0.5,
                                                          (140, 3))
    pos[140:143] = [[1.0, box, 1.0], [0.5, 0.0, box], [2.0, box, box]]
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    alive = np.ones(n, bool)
    alive[-9:] = False
    t = [torch.from_numpy(a) for a in (pos, mass, np.full(n, 0.05,
                                                          np.float32),
                                       alive)]
    cl = build_cell_list(t[0], t[3], torch.tensor([0.0, 0.0, 0.0]),
                         torch.tensor([3.0, box, box]), n_cells=ncv,
                         capacity=160, periodic=per)
    assert not bool(cl.overflow)
    soa = tc.pack_cells_abs(cl, *t)
    assert int((soa[:, 5] > 0).sum(1).max()) > 128
    flags = torch.ones(soa.shape[0], dtype=torch.int32)
    args = (soa, flags, ncv, box, per, 0.2, rcut)
    ranked = chip_smoke.slab_ranked(soa)
    up = torch.tensor(min(rcut * rcut * (1.0 + 1e-6),
                          float(np.finfo(np.float32).max)))
    fbox = torch.tensor(box)
    inside = kept = walked = stencil = 0
    for c0 in range(0, soa.shape[0], 16):
        cells = torch.arange(c0, c0 + 16)
        xyz, lv, sxyz, near = chip_smoke.slab_gravity_walk(args, cells,
                                                           ranked)
        ids, _, on = stencil_cells(ncv, cells, per)
        w = xyz.shape[2]
        src = (ranked[1][ids] != 0).flatten(1) \
            & on.repeat_interleave(32 * w, 1)
        d2 = 0.0
        for a in range(3):
            d = xyz[:, a, :, :, None] - sxyz[:, a, None, None, :]
            if per[a]:
                d = d - fbox * torch.round(d * (1.0 / fbox))
            d2 = d2 + d * d
        pair = lv[..., None] & src[:, None, None, :]
        in_cut = pair & (d2 > 0) & (d2 < up)
        inside += int(in_cut.sum())
        kept += int((in_cut & near[:, :, None, :]).sum())
        walked += int((pair & near[:, :, None, :]).sum())
        stencil += int(pair.sum())
    assert inside > 0 and kept == inside
    assert (walked < stencil) == (rcut < 1e30)


# --------------------------------------------------------------------------
# kernels C and D on anisotropic block grids
# --------------------------------------------------------------------------
BOX = 2.0
FINE = 0.5
NB = (1, 2, 2)
PER = (False, True, True)
ORIGIN = (0.1, 0.0, 0.0)
EXTENT = (2 * 1 * FINE, BOX, BOX)


SUBCAP = 96


def _sph_setup(seed, n=1000, grid="slab"):
    """test_sph_blocks_aniso.py::_setup's geometry at 1,000 of its 2,500
    particles (h about 0.27, under the cap of 0.45): x in [0.2, 0.8] of a
    grid clamped over [0.1, 1.1], y and z periodic over the box. In vacuum
    (``grid`` "vacuum", every axis clamped) a ball of radius 0.45 about
    (0.6, 1, 1) instead, so that no particle sits in a corner of the grid
    with an eighth of its neighbours (its h would reach the cap)."""
    rng = np.random.default_rng(seed)
    if grid == "slab":
        pos = np.stack([rng.uniform(0.2, 0.8, n), rng.uniform(0.0, BOX, n),
                        rng.uniform(0.0, BOX, n)], axis=-1)
    else:
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        r = rng.uniform(size=n) ** (1.0 / 3.0)
        pos = np.array([0.6, 1.0, 1.0]) \
            + np.array([0.45, 0.9, 0.9]) * r[:, None] * d
    pos = pos.astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    h = np.full(n, 0.27, np.float32)
    mask = np.ones(n, bool)
    mask[-5:] = False
    return pos, vel, mass, h, mask


_SPH = {}


def sph_case(grid: str = "slab"):
    """The port's density (relative mode on the anisotropic grid) and the
    JAX package's in both its modes on the same inputs, then each one's
    hydro force on the JAX package's relative-mode density fields; on the
    slab's grid (``grid`` "slab": clamped x, periodic y and z) or clamped
    on all three axes ("vacuum"). Computed once a grid."""
    if grid in _SPH:
        return _SPH[grid]
    per = PER if grid == "slab" else VACUUM_PER
    pos, vel, mass, h, mask = _sph_setup(21, grid=grid)
    max_hsml = (1.0 - 0.1) * FINE
    t = [torch.from_numpy(a) for a in (pos, vel, mass, h, mask)]
    cls = sb.build_block_lists(t[0], t[4], torch.tensor(ORIGIN),
                               torch.tensor(EXTENT), n_blocks=NB,
                               subcap=SUBCAP, periodic=per)
    got, _ = sb.density_adaptive_blocks(
        t[0], t[1], t[2], torch.clamp(t[3], max=max_hsml), t[4],
        des_num_ngb=33.0, max_dev=2.0, box=BOX, cls=cls, max_hsml=max_hsml,
        fine_edge=FINE)
    j = [jnp.asarray(a) for a in (pos, vel, mass, h, mask)]
    jcls = jsb.build_block_lists(j[0], j[4], ORIGIN, EXTENT, n_blocks=NB,
                                 subcap=SUBCAP, periodic=per)
    want = {}
    for relative in (True, False):
        want[relative], _ = jsb.density_adaptive_blocks(
            j[0], j[1], j[2], jnp.minimum(j[3], max_hsml), j[4],
            des_num_ngb=33.0, max_dev=2.0, box=BOX, subcap=SUBCAP,
            max_hsml=max_hsml, periodic=per, cls=jcls, interpret=True,
            fine_edge=FINE if relative else None)
    # the hydro inputs: the JAX package's density fields, so the hydro
    # sums alone are compared
    d = want[True]
    hsml, rho, dhf, divv, curlv = (np.asarray(getattr(d, f)) for f in (
        "hsml", "rho", "dhsml_factor", "div_vel", "curl_vel"))
    assert hsml[mask].max() < max_hsml
    rho = np.where(mask, rho, 1.0).astype(np.float32)
    prs = (0.8 * rho ** (5.0 / 3.0)).astype(np.float32)
    fields = (hsml, rho, prs, dhf, divv, curlv)
    hgot = sb.hydro_force_blocks(
        cls, t[0], t[1], t[2], *(torch.tensor(a) for a in fields), t[4],
        visc_const=0.8, box=BOX, hubble_a2_flow=0.0, hubble_a2_norm=1.0,
        fac_mu=1.0, fine_edge=FINE)
    hwant = {relative: jsb.hydro_force_blocks(
        jcls, j[0], j[1], j[2], *(jnp.asarray(a) for a in fields), j[4],
        visc_const=0.8, box=BOX, interpret=True,
        fine_edge=FINE if relative else None) for relative in (True, False)}
    _SPH[grid] = (mask, got, want, hgot, hwant)
    return _SPH[grid]


SPH_CASES = dict(argnames="grid,relative",
                 argvalues=[("slab", True), ("slab", False),
                            ("vacuum", True), ("vacuum", False)],
                 ids=["True", "False", "vacuum-True", "vacuum-False"])


@pytest.mark.parametrize(**SPH_CASES)
def test_density_aniso_plain_equals_jax(grid, relative):
    mask, got, want, _, _ = sph_case(grid)
    want = want[relative]
    for f in ("rho", "hsml"):
        np.testing.assert_allclose(getattr(got, f).numpy()[mask],
                                   np.asarray(getattr(want, f))[mask],
                                   rtol=TOL_RHO, atol=0)
    for f in ("div_vel", "curl_vel"):
        w = np.asarray(getattr(want, f))[mask]
        np.testing.assert_allclose(getattr(got, f).numpy()[mask], w,
                                   atol=TOL_DIV * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize(**SPH_CASES)
def test_hydro_aniso_plain_equals_jax(grid, relative):
    mask, _, _, got, want = sph_case(grid)
    want = want[relative]
    for f in ("acc", "dt_entropy", "max_signal_vel"):
        w = np.asarray(getattr(want, f))[mask]
        np.testing.assert_allclose(getattr(got, f).numpy()[mask], w,
                                   atol=TOL_ACC * np.abs(w).max(), rtol=0)


def test_block_sums_on_a_cube_unchanged():
    """Every cubic call unchanged: C's and D's plain versions on a cubic
    periodic grid named per axis, (nb, nb, nb) and (True, True, True),
    equal the int-named call bit for bit, and the wrappers count them
    under their cubic names."""
    rng = np.random.default_rng(8)
    n, box, nb = 800, 1.0, 2
    pos = torch.from_numpy(rng.uniform(0, box, (n, 3)).astype(np.float32))
    vel = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    mass = torch.full((n,), 1.0 / n)
    mask = torch.ones(n, dtype=torch.bool)
    cl_e, cl_o = sb.build_block_lists(pos, mask, 0.0, box, n_blocks=nb,
                                      subcap=32, periodic=True)
    lf = box / (2 * nb)
    ones = torch.ones(n)
    soa_e = sb.pack_sph_soa(cl_e, pos, vel, mass, ones, mask,
                            sb.block_centers(nb, "even", lf, cl_e.origin), box)
    soa_o = sb.pack_sph_soa(cl_o, pos, vel, mass, ones, mask,
                            sb.block_centers(nb, "odd", lf, cl_o.origin), box)
    h = torch.full(soa_e.shape[::2], 0.1)
    flags = torch.ones(nb ** 3, dtype=torch.int32)
    cube = sb.density_sums_blocks_plain(soa_e, soa_o, h, flags, nb, lf)
    axes = sb.density_sums_blocks_plain(soa_e, soa_o, h, flags, (nb,) * 3,
                                        lf, (True,) * 3)
    assert torch.equal(cube, axes)
    rho = torch.full((n,), 1.0)
    packs = sb.pack_hydro_blocks((cl_e, cl_o), pos, vel, mass,
                                 torch.full((n,), 0.1), rho, rho * 0.5,
                                 ones, torch.zeros(n), torch.zeros(n), mask,
                                 box, 0.0, 1.0)
    cube = sb.hydro_sums_blocks_plain(*packs, nb, lf, 0.8)
    axes = sb.hydro_sums_blocks_plain(*packs, (nb,) * 3, lf, 0.8,
                                      (True,) * 3)
    assert torch.equal(cube, axes)
    assert sb._kernel_name("sph_density", lf, nb) == "sph_density"
    assert sb._kernel_name("sph_hydro", None, nb) == "sph_hydro_abs"
    assert sb._kernel_name("sph_hydro", lf, (nb,) * 3) == "sph_hydro_aniso"
