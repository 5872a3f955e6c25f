"""The coarse-cell SPH backend (ops/sph_cells.py): the plain versions of
kernels I/J (density) and K (hydro) against the JAX package's Pallas
kernels in interpret mode (``density_sums_pallas``, the grid twin J of the
DMA kernel I, and ``hydro_sums_pallas``) on one cell list, periodic and
vacuum, at capacities 128 and 256; the adaptive solve and the hydro force
against ``density_adaptive_pallas`` / ``hydro_force_pallas``; and the
semantics the port pins: the self-pair, parked slots, a full cell, two
particles at zero density."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.ops import pallas_cells as jpc
from gadget_leicester_tpu.ops.neighbors import build_cell_list as j_build
from gadget_leicester_tpu_torch.ops import sph_cells as sc
from gadget_leicester_tpu_torch.ops.neighbors import build_cell_list

BOX = 3.0
# (periodic, cells per axis, capacity, particles): no cell overflows
GRIDS = [(True, 3, 128, 900), (True, 4, 128, 1500), (True, 3, 256, 2500),
         (False, 3, 128, 700), (False, 3, 256, 1500)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The shapes here are small: two intra-op threads do the work of
    eight, and leave the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(seed, n, periodic):
    """Particles in the box (periodic) or in a ball (vacuum, with the
    bounding-box grid of models/forces.py); the last 5 are masked out."""
    rng = np.random.default_rng(seed)
    if periodic:
        pos = rng.uniform(0, BOX, (n, 3))
        origin, extent, box = 0.0, BOX, BOX
    else:
        pos = rng.normal(size=(n, 3))
        pos *= (rng.uniform(size=n) ** (1 / 3) * 1.4
                / np.linalg.norm(pos, axis=1))[:, None]
        pos += 0.3
        lo, hi = pos[:-5].min(0), pos[:-5].max(0)
        pad = 0.01 * (hi - lo).max() + 1e-6
        origin = (lo - pad).astype(np.float32)
        extent, box = np.float32((hi - lo).max() + 2 * pad), 1.0
    mask = np.ones(n, bool)
    mask[-5:] = False
    f = np.float32
    return dict(pos=pos.astype(f), vel=rng.normal(size=(n, 3)).astype(f),
                mass=rng.uniform(0.5, 1.5, n).astype(f) / n,
                h=rng.uniform(0.25, 0.4, n).astype(f), mask=mask,
                origin=origin, extent=extent, box=box)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _lists(d, n_cells, cap, periodic):
    t = build_cell_list(*_t(d["pos"], d["mask"]),
                        torch.as_tensor(d["origin"]),
                        torch.as_tensor(d["extent"]), n_cells, cap, periodic)
    j = j_build(jnp.asarray(d["pos"]), jnp.asarray(d["mask"]),
                jnp.asarray(d["origin"]), jnp.asarray(d["extent"]),
                n_cells=n_cells, capacity=cap, periodic=periodic)
    return t, j


def _rows_close(got, want, tol, valid):
    """Each output row of [C, R, cap] within ``tol`` of its largest value,
    on the ``valid`` [C, cap] target slots (parked targets are zeros in
    the port and unread sums in the reference)."""
    for r in range(want.shape[1]):
        g, w = got[:, r][valid], want[:, r][valid]
        assert np.abs(w).max() > 0, f"row {r} is all zero"
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=f"row {r}")


@pytest.mark.parametrize("periodic,n_cells,cap,n", GRIDS)
def test_cell_list_and_pack_identical(periodic, n_cells, cap, n):
    """One stable sort: identical slot tables, gslot maps and packs, with a
    per-axis origin and a clamped (vacuum) or wrapped (periodic) grid."""
    d = _setup(1, n, periodic)
    t, j = _lists(d, n_cells, cap, periodic)
    for f in ("cells", "gslot", "counts", "cell_of", "inv_cell", "origin"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert bool(t.overflow) == bool(j.overflow) is False
    assert t.periodic is periodic
    want = jpc.pack_sph_soa(j, *[jnp.asarray(d[k]) for k in
                                 ("pos", "vel", "mass", "h", "mask")])
    got = sc.pack_sph_soa(t, *_t(d["pos"], d["vel"], d["mass"], d["h"],
                                 d["mask"]), d["box"])
    # live slots bit for bit; the parked coordinate (-7 / inv_cell, which
    # nothing reads) to a rounding of the division
    live = (t.cells >= 0).numpy()
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 1)[live],
                                  np.asarray(want).transpose(0, 2, 1)[live])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("periodic,n_cells,cap,n", GRIDS)
def test_density_sums_match_jax_kernel(periodic, n_cells, cap, n):
    """Kernels I/J's plain version against kernel J in interpret mode on
    the same pack: the same float32 pair terms, the wrap as a shift of the
    whole tile instead of the per-pair minimum image (a rounding of one
    ulp of the box in dx), summed in another order: 2e-5 of each row's
    largest value. Gated cells return zeros."""
    d = _setup(2, n, periodic)
    t, j = _lists(d, n_cells, cap, periodic)
    soa = jpc.pack_sph_soa(j, jnp.asarray(d["pos"]), jnp.asarray(d["vel"]),
                           jnp.asarray(d["mass"]),
                           jnp.ones(n, jnp.float32), jnp.asarray(d["mask"]))
    cells = np.asarray(j.cells)
    valid = cells >= 0
    h_slots = np.where(valid, d["h"][np.maximum(cells, 0)], 1.0).astype(
        np.float32)
    want = np.asarray(jpc.density_sums_pallas(
        j, soa, jnp.asarray(h_slots), d["box"], n_cells,
        interpret=True))[:, :6]
    flags = np.ones(n_cells ** 3, np.int32)
    for gated in (False, True):
        if gated:
            flags[::3] = 0
        got = sc.density_sums_cells(*_t(soa, h_slots, flags), n_cells,
                                    d["box"], periodic).numpy()
        _rows_close(got, want, 2e-5, valid & (flags > 0)[:, None])
        assert not got[flags == 0].any()
        assert not got.transpose(0, 2, 1)[~valid].any()   # parked targets


def _hydro_fields(d, seed):
    n = len(d["pos"])
    rng = np.random.default_rng(seed)
    f = np.float32
    rho = (rng.uniform(0.8, 1.2, n) * 0.05).astype(f)
    pressure = np.where(d["mask"], 0.5 * rho ** (5.0 / 3.0), 0.0).astype(f)
    return (d["pos"], d["vel"], d["mass"], d["h"], rho, pressure,
            rng.uniform(0.9, 1.1, n).astype(f), rng.normal(size=n).astype(f),
            rng.uniform(0, 1, n).astype(f), d["mask"])


@pytest.mark.parametrize("periodic,n_cells,cap,n", GRIDS[:1] + GRIDS[2:])
def test_hydro_sums_match_jax_kernel(periodic, n_cells, cap, n):
    """Kernel K's plain version against ``hydro_sums_pallas`` in interpret
    mode on the reference's own two packs (rows 0-7 and 8-15 of the port's
    one pack, held equal here), with the Hubble-flow term on the periodic
    grids (a comoving box) and without it on the vacuum ones: 2e-5 of
    each row's largest value."""
    hubble = 0.3 if periodic else 0.0
    d = _setup(3, n, periodic)
    t, j = _lists(d, n_cells, cap, periodic)
    arrays = _hydro_fields(d, 13)
    pos, vel, mass, h, rho, pressure, dhsml, div, curl, mask = \
        [jnp.asarray(a) for a in arrays]
    fac_mu = 0.9
    # the reference's packs, as hydro_force_pallas builds them
    rho_safe = jnp.where(rho > 0, rho, 1.0)
    c_snd = jnp.sqrt(5.0 / 3.0 * pressure / rho_safe)
    por = pressure / rho_safe ** 2 * dhsml
    bal = jnp.abs(div) / (jnp.abs(div) + curl + 1e-4 * c_snd / h / fac_mu)
    soa_a = jpc.pack_sph_soa(j, pos, vel, mass, h, mask)
    idx = jnp.maximum(j.cells, 0)
    valid = ((j.cells >= 0) & mask[idx]).astype(jnp.float32)
    zero = jnp.zeros_like(valid)
    soa_b = jnp.stack([rho[idx], por[idx], c_snd[idx], bal[idx], valid, zero,
                       zero, zero], axis=1)
    want = np.asarray(jpc.hydro_sums_pallas(
        j, soa_a, soa_b, d["box"], n_cells, 0.8, hubble, fac_mu,
        interpret=True))[:, :5]
    soa16 = sc.pack_hydro_cells(t, *_t(*arrays), torch.tensor(fac_mu),
                                d["box"])
    on = np.asarray(valid) > 0
    for rows, ref in ((slice(0, 8), soa_a), (slice(8, 13), soa_b[:, :5])):
        np.testing.assert_allclose(
            soa16[:, rows].numpy().transpose(0, 2, 1)[on],
            np.asarray(ref).transpose(0, 2, 1)[on], rtol=1e-6, atol=0)
    params = torch.tensor([hubble, fac_mu], dtype=torch.float32)
    got = sc.hydro_sums_cells(soa16, params, n_cells, d["box"], periodic,
                              0.8).numpy()
    _rows_close(got, want, 2e-5, on)
    assert not got.transpose(0, 2, 1)[~on].any()


@pytest.mark.parametrize("periodic,n_cells,cap,n", [GRIDS[0], GRIDS[3]])
def test_density_adaptive_matches(periodic, n_cells, cap, n):
    """The Newton/bisection h-loop in slot space over kernels I/J against
    ``density_adaptive_pallas`` in interpret mode: the same sweep count,
    2e-5 of the largest value per field; masked-out particles get the fill
    row (rho 0, h and dhsml 1)."""
    d = _setup(4, n, periodic)
    max_h = float(d["extent"]) / n_cells
    kw = dict(des_num_ngb=33.0, max_dev=2.0, box=d["box"], n_cells=n_cells,
              capacity=cap, min_hsml=0.01, max_hsml=max_h, periodic=periodic)
    names = ("pos", "vel", "mass", "h", "mask")
    jres, _ = jpc.density_adaptive_pallas(
        *[jnp.asarray(d[k]) for k in names], origin=jnp.asarray(d["origin"]),
        extent=jnp.asarray(d["extent"]), interpret=True, **kw)
    tres, cl = sc.density_adaptive_cells(
        *_t(*[d[k] for k in names]), origin=torch.as_tensor(d["origin"]),
        extent=torch.as_tensor(d["extent"]), **kw)
    assert tres.iters == int(jres.iters) > 0
    assert cl.cells.shape == (n_cells ** 3, cap)
    for f in ("rho", "hsml", "div_vel", "curl_vel", "dhsml_factor",
              "num_ngb_eff"):
        w = np.asarray(getattr(jres, f))
        np.testing.assert_allclose(getattr(tres, f).numpy(), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max(), err_msg=f)
    off = ~d["mask"]
    assert not tres.rho.numpy()[off].any()
    assert (tres.hsml.numpy()[off] == 1).all()
    assert (tres.dhsml_factor.numpy()[off] == 1).all()


@pytest.mark.parametrize("periodic,n_cells,cap,n",
                         [GRIDS[0], GRIDS[2], GRIDS[3]])
def test_hydro_force_matches(periodic, n_cells, cap, n):
    """``hydro_force_cells`` (pack, kernel K, merge, the dA/dt factor)
    against ``hydro_force_pallas`` in interpret mode: 2e-5 of the largest
    value per output."""
    hubble = 0.3 if periodic else 0.0
    d = _setup(5, n, periodic)
    t, j = _lists(d, n_cells, cap, periodic)
    arrays = _hydro_fields(d, 15)
    kw = dict(visc_const=0.8, box=d["box"], hubble_a2_flow=hubble,
              hubble_a2_norm=1.3, fac_mu=0.9)
    jres = jpc.hydro_force_pallas(j, *[jnp.asarray(a) for a in arrays],
                                  n_cells=n_cells, interpret=True, **kw)
    tres = sc.hydro_force_cells(t, *_t(*arrays), **kw)
    for f in ("acc", "dt_entropy", "max_signal_vel"):
        w = np.asarray(getattr(jres, f))
        assert np.abs(w).max() > 0, f
        np.testing.assert_allclose(getattr(tres, f).numpy(), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max(), err_msg=f)


def _few(pos, h=0.3, periodic=True, n_cells=3, cap=128):
    """A handful of equal particles at ``pos`` in the periodic box or a
    vacuum grid on [0, BOX): (list, fields for the host functions)."""
    n = len(pos)
    f = torch.float32
    pos = torch.tensor(pos, dtype=f)
    mask = torch.ones(n, dtype=torch.bool)
    cl = build_cell_list(pos, mask, 0.0, BOX, n_cells, cap, periodic)
    return cl, dict(pos=pos, vel=torch.zeros(n, 3), mass=torch.ones(n),
                    hsml=torch.full((n,), h), mask=mask)


def _hydro_of(cl, d, rho, box=BOX):
    n = len(d["pos"])
    one = torch.ones(n)
    return sc.hydro_force_cells(cl, d["pos"], d["vel"], d["mass"], d["hsml"],
                                rho, 0.4 * rho ** (5.0 / 3.0), one, one,
                                torch.zeros(n), d["mask"],
                                visc_const=0.8, box=box)


def test_self_pair_included_in_density_and_excluded_in_hydro():
    """A lone particle: its density is its own m W(0, h) = 8 m / (pi h^3)
    exactly as the kernel's arithmetic gives it, div v and rot v are 0
    (dW/dr(0) = 0), and its hydro sums are 0 bit for bit: the absolute
    coordinates meet at r2 == 0 through the centre cell's zero shift."""
    cl, d = _few([[1.7, 0.4, 2.9]])
    soa = sc.pack_sph_soa(cl, d["pos"], d["vel"], d["mass"],
                          torch.ones(1), d["mask"], BOX)
    slot = int(cl.gslot[0])
    h_slots = torch.full(cl.cells.shape, 0.3)
    out = sc.density_sums_cells(soa, h_slots, torch.ones(27, dtype=torch.int32),
                                3, BOX, True)
    rows = out.transpose(1, 2).reshape(-1, 6)[slot]
    np.testing.assert_allclose(float(rows[0]), 8 / np.pi / 0.3 ** 3,
                               rtol=1e-6)
    assert float(rows[1]) < 0 and not rows[2:].any()
    hres = _hydro_of(cl, d, torch.tensor([float(rows[0])]))
    assert not hres.acc.any() and not hres.dt_entropy.any()


def test_isolated_particle_has_zero_hydro_signal():
    """Two particles farther apart than both h: no pair is inside the
    support, so the max over the signal velocity stays at its start, 0
    (with the self-pair it would be 2 c_i)."""
    cl, d = _few([[0.5, 0.5, 0.5], [1.4, 0.5, 0.5]])
    hres = _hydro_of(cl, d, torch.tensor([3.0, 3.0]))
    assert not hres.max_signal_vel.any() and not hres.acc.any()
    # and a pair inside the support across the periodic wrap does interact
    cl, d = _few([[0.1, 0.5, 0.5], [2.9, 0.5, 0.5]])
    hres = _hydro_of(cl, d, torch.tensor([3.0, 3.0]))
    assert (hres.max_signal_vel > 0).all()
    assert float(hres.acc[0, 0]) > 0 > float(hres.acc[1, 0])
    # but not on a vacuum grid, where nothing wraps
    cl, d = _few([[0.1, 0.5, 0.5], [2.9, 0.5, 0.5]], periodic=False)
    assert not _hydro_of(cl, d, torch.tensor([3.0, 3.0]), box=1.0).acc.any()


@pytest.mark.parametrize("periodic", [True, False])
def test_parked_slots_stay_finite(periodic):
    """Nearly empty tiles: every output of both sweeps is finite, parked
    target slots are zero, and parked sources add nothing (m = 0 in
    density, valid = 0 in hydro)."""
    cl, d = _few([[0.2, 0.2, 0.2], [0.35, 0.2, 0.2], [2.8, 2.8, 2.8]],
                 periodic=periodic)
    res, cl2 = sc.density_adaptive_cells(
        d["pos"], d["vel"], d["mass"], d["hsml"], d["mask"], 33.0, 2.0, BOX,
        3, 128, max_hsml=BOX / 3, periodic=periodic)
    for x in res[:6]:
        assert torch.isfinite(x).all()
    hres = _hydro_of(cl2, d, res.rho)
    for x in hres:
        assert torch.isfinite(x).all()
    soa16 = sc.pack_hydro_cells(cl2, d["pos"], d["vel"], d["mass"], res.hsml,
                                res.rho, 0.4 * res.rho, torch.ones(3),
                                torch.ones(3), torch.zeros(3), d["mask"],
                                torch.tensor(1.0), BOX)
    out = sc.hydro_sums_cells(soa16, torch.tensor([0.0, 1.0]), 3, BOX,
                              periodic, 0.8)
    assert torch.isfinite(out).all()
    assert not out.transpose(1, 2)[cl2.cells < 0].any()


def test_full_cell_sets_overflow_and_drops_with_rho_zero():
    """A cell over capacity: the list reports overflow, the dropped
    particles come back with rho = 0 and the fill h = 1 (models/forces.py
    then keeps their forecast), the kept ones with rho > 0."""
    rng = np.random.default_rng(8)
    n = 200
    pos = torch.tensor(rng.uniform(0.05, 0.95, (n, 3)), dtype=torch.float32)
    mask = torch.ones(n, dtype=torch.bool)
    res, cl = sc.density_adaptive_cells(
        pos, torch.zeros(n, 3), torch.full((n,), 1.0 / n),
        torch.full((n,), 0.3), mask, 33.0, 2.0, BOX, 3, 128,
        max_hsml=BOX / 3)
    dropped = cl.gslot < 0
    assert bool(cl.overflow) and int(dropped.sum()) == n - 128
    assert not res.rho[dropped].any() and (res.hsml[dropped] == 1).all()
    assert (res.rho[~dropped] > 0).all()


def test_two_particles_at_zero_density_give_no_nan():
    """rho_i = rho_j = 0 sends 1 / rho_ij to 1e37, and a fast approaching
    pair's viscosity term overflows to inf; outside the support its kernel
    gradients are 0 and inf * 0 is NaN. The masks are selects, not
    products: the pair adds exact zeros and every output stays finite."""
    cl, d = _few([[1.0, 1.0, 1.0], [1.5, 1.0, 1.0]])
    d["vel"] = torch.tensor([[10.0, 0, 0], [-10.0, 0, 0]])
    hres = _hydro_of(cl, d, torch.zeros(2))
    for x in hres:
        assert torch.isfinite(x).all() and not x.any()


def test_particle_on_the_box_edge_keeps_its_neighbours():
    """A coordinate equal to the box (a float64 position just below it,
    rounded to float32, as one of the 2x128^3 lcdm_gas ICs has) is filed in
    cell 0, a box away from the neighbours it is filed with. The pack
    stores the image nearest its cell, so the whole-tile wrap shift still
    finds every pair: the cells sweeps match kernel J, whose per-pair
    minimum image never had the fault, and the all-pairs sums, to 2e-5;
    every other coordinate is packed bit for bit."""
    from gadget_leicester_tpu_torch.ops import sph_dense as tsd
    d = _setup(9, 900, True)
    d["pos"][:3] = [[BOX, 1.0, 1.0], [0.0, BOX, 0.5], [BOX, BOX, BOX]]
    n_cells, cap = 3, 128
    t, j = _lists(d, n_cells, cap, True)
    assert int(t.cell_of[0]) // 9 == 0 and int(t.cell_of[2]) == 0
    tens = _t(*[d[k] for k in ("pos", "vel", "mass", "h", "mask")])
    soa = sc.pack_sph_soa(t, *tens, BOX)
    want_soa = np.asarray(jpc.pack_sph_soa(j, *[jnp.asarray(d[k]) for k in (
        "pos", "vel", "mass", "h", "mask")]))
    live = (t.cells >= 3).numpy()       # every slot but the three moved ones
    np.testing.assert_array_equal(soa.numpy().transpose(0, 2, 1)[live],
                                  want_soa.transpose(0, 2, 1)[live])
    moved = soa.transpose(1, 2).reshape(-1, 8)[t.gslot[:3].long(), :3]
    np.testing.assert_array_equal(
        moved.numpy(), [[0.0, 1.0, 1.0], [0.0, 0.0, 0.5], [0.0, 0.0, 0.0]])
    cells = np.asarray(j.cells)
    h_slots = np.where(cells >= 0, d["h"][np.maximum(cells, 0)], 1.0).astype(
        np.float32)
    want = np.asarray(jpc.density_sums_pallas(
        j, jnp.asarray(want_soa), jnp.asarray(h_slots), BOX, n_cells,
        interpret=True))[:, :6]
    got = sc.density_sums_cells(soa, torch.from_numpy(h_slots),
                                torch.ones(27, dtype=torch.int32), n_cells,
                                BOX, True)
    _rows_close(got.numpy(), want, 2e-5, cells >= 0)
    oracle = tsd.density_sums(*tens, box=BOX, periodic=True)[0]
    rho = sc.merge_rows(got, t, 1)[:, 0]
    np.testing.assert_allclose(rho[d["mask"]].numpy(),
                               oracle[d["mask"]].numpy(), rtol=0,
                               atol=2e-5 * float(oracle.max()))
    assert float(rho[0]) > 0.5 * float(rho.median())


@pytest.mark.parametrize("periodic,cap", [(True, 128), (False, 128),
                                          (True, 224)])
def test_walk_model_of_kernel_ij_keeps_every_pair_inside_the_support(
        periodic, cap):
    """chip_smoke.cells_density_walk, the model of kernel I/J's culling
    (csrc/sph_cells_density.cu: chunk boxes, warp boxes with the reach of
    the largest target h), on seeded gas with coordinates equal to the box
    (periodic), a fifth of the gas at h equal to the cell edge (the cap)
    and a target with h = 0; at 224 slots a clump puts more than 128 live
    slots in one cell (two passes of targets, seven chunks a cell). Every
    pair of a live target with h > 0 and a source with m > 0 in the grid
    inside the support (r < h, or r (1/h) < 1 in float32 as the kernel
    takes u) is walked, and the walk leaves out some pairs."""
    import chip_smoke
    d = _setup(40 + cap + periodic, 1400, periodic)
    n_cells, n = 3, 1400
    rng = np.random.default_rng(cap)
    if periodic:
        d["pos"][:3] = [[BOX, 1.0, 1.0], [0.0, BOX, 0.5], [BOX, BOX, BOX]]
    if cap > 128:
        d["pos"][3:153] = rng.uniform(1.1, 1.9, (150, 3))
    edge = np.float32(d["extent"] / n_cells)
    d["h"][rng.choice(n, n // 5, replace=False)] = edge
    d["h"][5] = 0.0
    t = build_cell_list(*_t(d["pos"], d["mask"]),
                        torch.as_tensor(d["origin"]),
                        torch.as_tensor(d["extent"]), n_cells, cap, periodic)
    assert not bool(t.overflow)
    tens = _t(*[d[k] for k in ("pos", "vel", "mass", "h", "mask")])
    soa = sc.pack_sph_soa(t, *tens, d["box"])
    cells = t.cells.numpy()
    h_slots = torch.from_numpy(np.where(cells >= 0, d["h"][np.maximum(
        cells, 0)], 1.0).astype(np.float32))
    if cap > 128:
        assert int((soa[:, 3] > 0).sum(1).max()) > 128
    c = n_cells ** 3
    args = (soa, h_slots, torch.ones(c, dtype=torch.int32), n_cells,
            d["box"], periodic)
    k = torch.arange(c)
    live, walked = chip_smoke.cells_density_walk(args, k)
    s, inside = sc._gather_sources(soa, k, n_cells, d["box"], periodic,
                                   range(4))
    r = sc._pair_geometry(soa, s)[3]
    hs = h_slots[:, :, None]
    support = ((r < hs) | (r * (1.0 / hs) < 1.0)) & (hs > 0)
    pair = live[..., None] & ((s[3] > 0) & inside)[:, None, :]
    assert int((pair & support).sum()) > 0
    assert not bool((pair & support & ~walked).any())
    assert int((pair & walked).sum()) < int(pair.sum())


@pytest.mark.parametrize("periodic,cap", [(True, 128), (False, 128),
                                          (True, 224)])
def test_walk_model_of_kernel_k_keeps_every_pair_inside_the_support(
        periodic, cap):
    """chip_smoke.cells_hydro_walk, the model of kernel K's culling
    (csrc/sph_cells_hydro.cu: chunk boxes with the largest h of their
    sources, warp boxes with the reach max(h_max, h_s)), on the gas of the
    I/J case above: coordinates equal to the box (periodic), a fifth of
    the gas at h equal to the cell edge, twenty sources at h 1.6 cell
    edges (above it) and a target with h = 0; at 224 slots more than 128
    live slots in one cell. Every pair of a live target and a valid
    source in the stencil with 0 < r < max(h_i, h_j) is walked, and the
    walk leaves out some pairs."""
    import chip_smoke
    d = _setup(60 + cap + periodic, 1400, periodic)
    n_cells, n = 3, 1400
    rng = np.random.default_rng(cap + 1)
    if periodic:
        d["pos"][:3] = [[BOX, 1.0, 1.0], [0.0, BOX, 0.5], [BOX, BOX, BOX]]
    if cap > 128:
        d["pos"][3:153] = rng.uniform(1.1, 1.9, (150, 3))
    edge = np.float32(d["extent"] / n_cells)
    d["h"][rng.choice(n, n // 5, replace=False)] = edge
    d["h"][rng.choice(n, 20, replace=False)] = 1.6 * edge
    d["h"][5] = 0.0
    t = build_cell_list(*_t(d["pos"], d["mask"]),
                        torch.as_tensor(d["origin"]),
                        torch.as_tensor(d["extent"]), n_cells, cap, periodic)
    assert not bool(t.overflow)
    soa16 = sc.pack_hydro_cells(t, *_t(*_hydro_fields(d, 5)),
                                torch.tensor(0.9), d["box"])
    if cap > 128:
        assert int((soa16[:, 12] > 0).sum(1).max()) > 128
    args = (soa16, torch.tensor([0.1, 0.9]), n_cells, d["box"], periodic,
            0.8)
    k = torch.arange(n_cells ** 3)
    live, walked = chip_smoke.cells_hydro_walk(args, k)
    s, inside = sc._gather_sources(soa16, k, n_cells, d["box"], periodic,
                                   (0, 1, 2, 7, 12))
    _, _, _, r, _, r2 = sc._pair_geometry(soa16, s)
    support = (r < torch.maximum(soa16[:, 7, :, None], s[3][:, None, :])) \
        & (r2 > 0.0)
    pair = live[..., None] & ((s[4] > 0) & inside)[:, None, :]
    assert int((pair & support).sum()) > 0
    assert not bool((pair & support & ~walked).any())
    assert int((pair & walked).sum()) < int(pair.sum())
