"""The ghost-row mode of the coarse-cell SPH (ops/sph_cells.py): kernels
I/J and K on the slab step's anisotropic grid, (nx, n, n) cells over
[x0 - cell, x1 + cell) x [0, box)^2, clamped in x and periodic in y and z
on a periodic box (clamped on all three axes in vacuum), with the slab's
own particles as the first ``n_targets`` rows and the ghosts after them.

The plain ghost modes (``density_adaptive_cells(n_targets=, cl=)``,
``hydro_force_cells(n_targets=)``) are held against the JAX package's
``jnp`` path, ``ops/sph_cells.py :: density_adaptive_cells`` and
``hydro_force_cells`` with ``n_targets``, on the same cell list: the path
the JAX slab step runs with ``use_pallas="off"``, and which stands in for
its Pallas ghost mode (``density_adaptive_pallas(n_targets=, cl=)``;
2e-7 apart on such a grid, and ten times slower in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.ops import sph_cells as jsc
from gadget_leicester_tpu.ops.neighbors import build_cell_list as j_build
from gadget_leicester_tpu_torch import kernels
from gadget_leicester_tpu_torch.ops import sph_cells as sc
from gadget_leicester_tpu_torch.ops.neighbors import build_cell_list

BOX = 5.0            # y, z: 5 cells of edge 1
X0, X1 = 1.0, 3.0    # the slab; its grid spans [0, 4) in x, 4 cells
N_TGT, N_GHOST = 300, 120
TOL = 1e-5           # of the largest value of each field


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _slab(seed, periodic):
    """Targets in the slab [X0, X1) (one of them on the face at x = X1, one
    at y = BOX on a periodic box), ghosts in the strips within one cell
    edge of its faces; the last 3 targets and ghosts masked out."""
    rng = np.random.default_rng(seed)
    f = np.float32
    tgt = np.column_stack([rng.uniform(X0, X1, N_TGT),
                           rng.uniform(0, BOX, (N_TGT, 2))])
    tgt[0, 0] = X1
    if periodic:
        tgt[1, 1] = BOX
    side = rng.uniform(size=N_GHOST) < 0.5
    gx = np.where(side, rng.uniform(X0 - 1.0, X0, N_GHOST),
                  rng.uniform(X1, X1 + 1.0, N_GHOST))
    ghost = np.column_stack([gx, rng.uniform(0, BOX, (N_GHOST, 2))])
    n = N_TGT + N_GHOST
    mask = np.ones(n, bool)
    mask[N_TGT - 3:N_TGT] = False
    mask[-3:] = False
    return dict(pos=np.concatenate([tgt, ghost]).astype(f),
                vel=rng.normal(size=(n, 3)).astype(f),
                mass=rng.uniform(0.5, 1.5, n).astype(f) / n,
                h=rng.uniform(0.6, 0.9, n).astype(f), mask=mask)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _grid(periodic):
    per = (False, periodic, periodic)
    origin = np.array([X0 - 1.0, 0.0, 0.0], np.float32)
    extent = np.array([X1 - X0 + 2.0, BOX, BOX], np.float32)
    return (4, 5, 5), per, origin, extent


def _lists(d, cap, periodic):
    n_cells, per, origin, extent = _grid(periodic)
    t = build_cell_list(*_t(d["pos"], d["mask"]), torch.from_numpy(origin),
                        torch.from_numpy(extent), n_cells, cap, per)
    j = j_build(jnp.asarray(d["pos"]), jnp.asarray(d["mask"]),
                jnp.asarray(origin), jnp.asarray(extent), n_cells=n_cells,
                capacity=cap, periodic=per)
    return t, j


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.abs(want).max() > 0, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("periodic,cap", [(True, 64), (True, 40),
                                          (False, 64)])
def test_ghost_modes_match_jax_jnp_path(periodic, cap):
    """The adaptive density solve and the hydro force in the ghost-row
    mode against the JAX package's jnp path with ``n_targets`` on the same
    slab list: every field of the live targets within 1e-5 of its largest
    value, outputs of ``n_targets`` rows, the same sweep count; cap 40, as
    the slab step's formula rounds it (to 8), is no multiple of 32."""
    d = _slab(7 if periodic else 8, periodic)
    t, j = _lists(d, cap, periodic)
    assert not bool(t.overflow) and not bool(j.overflow)
    np.testing.assert_array_equal(t.cells.numpy(), np.asarray(j.cells))
    n_cells, per, origin, extent = _grid(periodic)
    kw = dict(des_num_ngb=20.0, max_dev=1.0, min_hsml=0.01, max_hsml=1.0)
    names = ("pos", "vel", "mass", "h", "mask")
    jres = jsc.density_adaptive_cells(
        j, *[jnp.asarray(d[k]) for k in names], box=BOX, periodic=periodic,
        n_targets=N_TGT, **kw)
    kernels.reset_launches()
    tres, cl = sc.density_adaptive_cells(
        *_t(*[d[k] for k in names]), box=BOX, n_cells=n_cells, capacity=cap,
        periodic=per, origin=torch.from_numpy(origin),
        extent=torch.from_numpy(extent), n_targets=N_TGT, **kw)
    assert cl.n_cells == n_cells and cl.periodic == per
    assert tres.iters == int(jres.iters) > 0
    live = d["mask"][:N_TGT]
    for f in ("rho", "hsml", "div_vel", "curl_vel", "dhsml_factor",
              "num_ngb_eff"):
        got = getattr(tres, f).numpy()
        assert got.shape == (N_TGT,), f
        _close(got[live], np.asarray(getattr(jres, f))[live], f)
    # a masked-out target: the fill row of a particle in no slot (the
    # Pallas solve's; the jnp path keeps its clipped h there)
    assert not tres.rho.numpy()[~live].any()
    assert (tres.hsml.numpy()[~live] == 1).all()
    # the plain version counts nothing
    assert not any(kernels.launches.values())

    # hydro on the density fields of the targets and ghosts' own
    rng = np.random.default_rng(11)
    n = len(d["pos"])
    rho = np.concatenate([np.asarray(jres.rho),
                          rng.uniform(0.5, 1.5, n - N_TGT)]).astype(np.float32)
    hsml = np.concatenate([np.asarray(jres.hsml),
                           d["h"][N_TGT:]]).astype(np.float32)
    prs = (0.4 * rho ** (5.0 / 3.0)).astype(np.float32)
    dhf = rng.uniform(0.8, 1.2, n).astype(np.float32)
    div = rng.normal(size=n).astype(np.float32)
    curl = rng.uniform(0.0, 1.0, n).astype(np.float32)
    arrays = (d["pos"], d["vel"], d["mass"], hsml, rho, prs, dhf, div, curl,
              d["mask"])
    hkw = dict(visc_const=0.8, box=BOX, hubble_a2_flow=0.3 if periodic
               else 0.0, hubble_a2_norm=1.3, fac_mu=0.9)
    jh = jsc.hydro_force_cells(j, *[jnp.asarray(a) for a in arrays],
                               periodic=periodic, n_targets=N_TGT, **hkw)
    th = sc.hydro_force_cells(cl, *_t(*arrays), n_targets=N_TGT, **hkw)
    for f in ("acc", "dt_entropy", "max_signal_vel"):
        _close(getattr(th, f).numpy(), getattr(jh, f), f)


def test_ghost_mode_sums_only_target_cells():
    """The cells that hold no target slot are flagged off in both modes'
    plain versions (zeros there), the other cells' sums equal an all-on
    pass bit for bit (K's without flags too), and a ghost row never
    reaches the outputs."""
    d = _slab(9, True)
    t, _ = _lists(d, 64, True)
    n_cells, per, _, _ = _grid(True)
    pos, vel, mass, h, mask = _t(*[d[k] for k in ("pos", "vel", "mass", "h",
                                                  "mask")])
    soa = sc.pack_sph_soa(t, pos, vel, mass, torch.ones_like(mass), mask,
                          BOX)
    idx = t.cells.clamp_min(0).long()
    tgt = ((t.cells >= 0) & mask[idx] & (idx < N_TGT)).any(1)
    assert bool(tgt.any()) and not bool(tgt.all())
    h_slots = torch.where(t.cells >= 0, h[idx], torch.ones_like(h[idx]))
    on = torch.ones(len(tgt), dtype=torch.int32)
    part = sc.density_sums_cells(soa, h_slots, tgt.to(torch.int32), n_cells,
                                 BOX, per)
    full = sc.density_sums_cells(soa, h_slots, on, n_cells, BOX, per)
    assert not part[~tgt].any()
    assert torch.equal(part[tgt], full[tgt])
    soa16 = sc.pack_hydro_cells(t, pos, vel, mass, h, torch.ones_like(mass),
                                torch.ones_like(mass), torch.ones_like(mass),
                                torch.zeros_like(mass), torch.zeros_like(mass),
                                mask, torch.tensor(1.0), BOX)
    params = torch.tensor([0.0, 1.0])
    hp = sc.hydro_sums_cells(soa16, params, n_cells, BOX, per, 0.8,
                             tgt.to(torch.int32))
    hf = sc.hydro_sums_cells(soa16, params, n_cells, BOX, per, 0.8, on)
    assert not hp[~tgt].any() and torch.equal(hp[tgt], hf[tgt])
    # no flags: every cell summed, as the cube takes it
    assert torch.equal(sc.hydro_sums_cells(soa16, params, n_cells, BOX, per,
                                           0.8), hf)
    with pytest.raises(ValueError, match="n_cells >= 3"):
        sc.density_sums_cells(soa.reshape(20, 5, 8, 64)[:, :2].reshape(
            40, 8, 64).contiguous(), h_slots[:40].contiguous(), on[:40],
            (4, 2, 5), BOX, per)


def _reached(on, n_cells, per):
    """The cells of the grid in the 27-cell stencils of the cells ``on``,
    by walking the grid."""
    nx, ny, nz = n_cells
    reach = np.zeros(nx * ny * nz, bool)
    for c in np.nonzero(on)[0]:
        cxyz = (c // (ny * nz), c // nz % ny, c % nz)
        for off in np.ndindex(3, 3, 3):
            ijk = [i + o - 1 for i, o in zip(cxyz, off)]
            if any(not p and not 0 <= i < n
                   for i, n, p in zip(ijk, n_cells, per)):
                continue
            x, y, z = (i % n for i, n in zip(ijk, n_cells))
            reach[(x * ny + y) * nz + z] = True
    return reach


@pytest.mark.parametrize("periodic", [True, False])
def test_cells_bytes_counts_live_slots(periodic):
    """chip_smoke.cells_bytes on the ghost modes' arguments: of the cells
    that hold a target and the cells of their stencils on the grid (found
    by walking the grid), I/J's seven rows of each live slot, h of each
    live slot it sums, the flags and six output rows a summed slot; K's
    rows 0-12, its two parameters and five output rows; with the cells
    that hold a target flagged and with one cell alone; K without flags
    sums every cell. kernel_bound counts these bytes and no others."""
    import chip_smoke
    d = _slab(10, periodic)
    t, _ = _lists(d, 64, periodic)
    n_cells, per, _, _ = _grid(periodic)
    pos, vel, mass, h, mask = _t(*[d[k] for k in ("pos", "vel", "mass", "h",
                                                  "mask")])
    soa = sc.pack_sph_soa(t, pos, vel, mass, torch.ones_like(mass), mask,
                          BOX)
    idx = t.cells.clamp_min(0).long()
    flags = ((t.cells >= 0) & mask[idx] & (idx < N_TGT)).any(1).to(
        torch.int32)
    h_slots = torch.where(t.cells >= 0, h[idx], torch.ones_like(h[idx]))
    soa16 = sc.pack_hydro_cells(t, pos, vel, mass, h, torch.ones_like(mass),
                                torch.ones_like(mass), torch.ones_like(mass),
                                torch.zeros_like(mass), torch.zeros_like(mass),
                                mask, torch.tensor(1.0), BOX)
    params = torch.tensor([0.0, 1.0])
    live = soa[:, 3].numpy() > 0
    assert np.array_equal(live, soa16[:, 12].numpy() > 0)
    # the cells that hold a target, and the first of them alone
    one = torch.zeros_like(flags)
    one[int(torch.nonzero(flags)[0])] = 1
    for fl in (flags, one):
        on = fl.numpy() > 0
        reach = _reached(on, n_cells, per)
        assert on.any() and not on.all()
        n_src, n_tgt, c = int(live[reach].sum()), int(live[on].sum()), len(on)
        dens = (soa, h_slots, fl, n_cells, BOX, per)
        hyd = (soa16, params, n_cells, BOX, per, 0.8, fl)
        want = {"sph_cells_density_slab":
                4 * (7 * n_src + 6 * n_tgt + n_tgt + c),
                "sph_cells_hydro_slab": 4 * (13 * n_src + 5 * n_tgt + 2 + c)}
        for name, args, fn in (("sph_cells_density_slab", dens,
                                sc.density_sums_cells),
                               ("sph_cells_hydro_slab", hyd,
                                sc.hydro_sums_cells)):
            assert chip_smoke.cells_bytes(name, args) == want[name]
            assert chip_smoke.cells_bytes(name + "_vacuum", args) \
                == want[name]
            bound = chip_smoke.kernel_bound(name, args, fn(*args))
            assert bound["bytes"] == want[name]
    assert not reach.all()
    everything = int(live.sum())
    assert chip_smoke.cells_bytes("sph_cells_hydro", hyd[:6]) \
        == 4 * (18 * everything + 2)
