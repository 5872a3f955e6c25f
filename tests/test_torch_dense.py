"""The all-pairs paths of the port against the JAX package: the SPH
density sums, the adaptive solve and the hydro force of ops/sph_dense.py,
and the direct-summation gravity of ops/gravity_direct.py with its
potential and its erfc truncation; then the port's coarse-cell SPH sweeps
(ops/sph_cells.py) against the port's all-pairs sums, the oracle that
shares no list, pack or stencil with them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.ops import gravity_direct as jgd
from gadget_leicester_tpu.ops import sph_dense as jsd
from gadget_leicester_tpu_torch.ops import gravity_direct as tgd
from gadget_leicester_tpu_torch.ops import sph_cells as sc
from gadget_leicester_tpu_torch.ops import sph_dense as tsd

BOX = 2.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The shapes here are small: two intra-op threads do the work of
    eight, and leave the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(seed, n=700):
    rng = np.random.default_rng(seed)
    f = np.float32
    mask = np.ones(n, bool)
    mask[-7:] = False
    return dict(pos=rng.uniform(0, BOX, (n, 3)).astype(f),
                vel=rng.normal(size=(n, 3)).astype(f),
                mass=(rng.uniform(0.5, 1.5, n) / n).astype(f),
                h=rng.uniform(0.3, 0.45, n).astype(f), mask=mask)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, tol, msg=""):
    want = np.asarray(want)
    assert np.abs(want).max() > 0, msg
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=msg)


NAMES = ("pos", "vel", "mass", "h", "mask")


@pytest.mark.parametrize("periodic", [False, True])
def test_density_sums_match(periodic):
    """One all-pairs sweep, chunked over 256 targets where the reference
    takes 512: the same float32 pair terms in another order, 1e-5 of each
    sum's largest value."""
    d = _setup(1)
    want = jsd.density_sums(*[jnp.asarray(d[k]) for k in NAMES], box=BOX,
                            periodic=periodic)
    got = tsd.density_sums(*_t(*[d[k] for k in NAMES]), box=BOX, block=256,
                           periodic=periodic)
    for g, w, name in zip(got, want, ("rho", "drho_dh", "divv", "rot")):
        _close(g, w, 1e-5, name)


@pytest.mark.parametrize("periodic", [False, True])
def test_density_adaptive_matches(periodic):
    """The uncapped Newton/bisection solve on the all-pairs sums: the same
    sweep count as the reference's while_loop, 2e-5 of the largest value
    per field."""
    d = _setup(2)
    kw = dict(des_num_ngb=33.0, max_dev=2.0, min_hsml=0.01, box=BOX,
              periodic=periodic)
    want = jsd.density_adaptive(*[jnp.asarray(d[k]) for k in NAMES], **kw)
    got = tsd.density_adaptive(*_t(*[d[k] for k in NAMES]), **kw)
    assert got.iters == int(want.iters) > 0
    for f in ("rho", "hsml", "div_vel", "curl_vel", "dhsml_factor",
              "num_ngb_eff"):
        _close(getattr(got, f), getattr(want, f), 2e-5, f)


def _hydro_fields(d, seed):
    n = len(d["pos"])
    rng = np.random.default_rng(seed)
    f = np.float32
    rho = (rng.uniform(0.8, 1.2, n) * 0.12).astype(f)
    pressure = np.where(d["mask"], 0.5 * rho ** (5.0 / 3.0), 0.0).astype(f)
    return (d["pos"], d["vel"], d["mass"], d["h"], rho, pressure,
            rng.uniform(0.9, 1.1, n).astype(f), rng.normal(size=n).astype(f),
            rng.uniform(0, 1, n).astype(f), d["mask"])


@pytest.mark.parametrize("periodic,hubble", [(False, 0.0), (True, 0.3)])
def test_hydro_force_matches(periodic, hubble):
    """The all-pairs hydro force and entropy rate: 2e-5 of the largest
    value per output."""
    arrays = _hydro_fields(_setup(3), 13)
    kw = dict(visc_const=0.8, box=BOX, periodic=periodic,
              hubble_a2_flow=hubble, hubble_a2_norm=1.3, fac_mu=0.9)
    want = jsd.hydro_force(*[jnp.asarray(a) for a in arrays], **kw)
    got = tsd.hydro_force(*_t(*arrays), block=256, **kw)
    for f in ("acc", "dt_entropy", "max_signal_vel"):
        _close(getattr(got, f), getattr(want, f), 2e-5, f)


def _gravity_setup(seed, n=900):
    rng = np.random.default_rng(seed)
    f = np.float32
    alive = np.ones(n, bool)
    alive[-9:] = False
    soft = np.where(rng.uniform(size=n) < 0.5, 0.14, 0.28).astype(f)
    return (rng.uniform(0, BOX, (n, 3)).astype(f),
            (rng.uniform(0.5, 1.5, n) / n).astype(f), soft, alive)


@pytest.mark.parametrize("kw", [
    dict(), dict(periodic=True, box=BOX),
    dict(asmth=0.11, rcut=0.5, periodic=True, box=BOX),
    dict(asmth=0.11), dict(with_potential=False)],
    ids=["vacuum", "periodic", "shortrange", "erfc_no_cut", "no_potential"])
def test_direct_gravity_matches(kw):
    """The direct sum with its potential, under the minimum image, and as
    the TreePM short-range oracle (exact erfc, with and without the cut),
    chunked over 400 targets where the reference takes 1024: 2e-5 of the
    largest acceleration and potential; dead particles get zeros."""
    pos, mass, soft, alive = _gravity_setup(4)
    acc_w, pot_w = jgd.direct_gravity(jnp.asarray(pos), jnp.asarray(mass),
                                      jnp.asarray(soft), jnp.asarray(alive),
                                      **kw)
    acc, pot = tgd.direct_gravity(*_t(pos, mass, soft, alive), block=400,
                                  **kw)
    _close(acc, acc_w, 2e-5, "acc")
    if kw.get("with_potential", True):
        _close(pot, pot_w, 2e-5, "pot")
    else:
        assert not pot.any() and not np.asarray(pot_w).any()
    assert not acc[~torch.from_numpy(alive)].any()


def test_shortrange_truncation_factors_match():
    """erfc(x) + 2x/sqrt(pi) exp(-x^2) and erfc(x) at x = r / (2 asmth):
    float32, 2e-6 absolute (two libm implementations of erfc and exp)."""
    r = np.linspace(0.0, 1.2, 241).astype(np.float32)
    for name in ("shortrange_trunc", "shortrange_trunc_pot"):
        want = np.asarray(getattr(jgd, name)(jnp.asarray(r), 0.11))
        got = getattr(tgd, name)(torch.from_numpy(r), 0.11).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _vacuum_grid(pos, mask):
    lo, hi = pos[mask].min(0).values, pos[mask].max(0).values
    pad = 0.01 * (hi - lo).max() + 1e-6
    return lo - pad, (hi - lo).max() + 2 * pad


@pytest.mark.parametrize("periodic,n_cells,cap",
                         [(True, 3, 128), (True, 4, 128), (False, 3, 256)])
def test_cells_sweeps_match_all_pairs_oracle(periodic, n_cells, cap):
    """The port's coarse-cell density sweep and hydro force (kernels I/J
    and K's plain versions through their packs and merges) against the
    port's all-pairs sums at the same h, all below the cell edge: 2e-5 of
    the largest value per field. Masked-out particles get zeros in
    both."""
    d = _setup(5, 1000)
    pos, vel, mass, h, mask = _t(*[d[k] for k in NAMES])
    if periodic:
        origin, extent, box = 0.0, BOX, BOX
    else:
        origin, extent = _vacuum_grid(pos, mask)
        box = 1.0
    assert float(h.max()) < float(extent) / n_cells
    cl = sc.build_cell_list(pos, mask, origin, extent, n_cells, cap, periodic)
    assert not bool(cl.overflow)
    soa = sc.pack_sph_soa(cl, pos, vel, mass, torch.ones_like(mass), mask,
                          box)
    idx = cl.cells.clamp_min(0).long()
    h_slots = torch.where(cl.cells >= 0, h[idx], torch.ones_like(h[idx]))
    out = sc.density_sums_cells(
        soa, h_slots, torch.ones(n_cells ** 3, dtype=torch.int32), n_cells,
        box, periodic)
    got = sc.merge_rows(out, cl, 6)
    want = tsd.density_sums(pos, vel, mass, h, mask, box=BOX,
                            periodic=periodic)
    want = torch.cat([w.reshape(len(pos), -1) for w in want], dim=1)
    want = torch.where(mask[:, None], want, torch.zeros_like(want))
    for r in range(6):
        _close(got[:, r], want[:, r], 2e-5, f"density row {r}")

    arrays = _t(*_hydro_fields(d, 17))
    kw = dict(visc_const=0.8, hubble_a2_flow=0.0 if not periodic else 0.3,
              hubble_a2_norm=1.3, fac_mu=0.9)
    hc = sc.hydro_force_cells(cl, *arrays, box=box, **kw)
    hd = tsd.hydro_force(*arrays, box=BOX, periodic=periodic, **kw)
    for f in ("acc", "dt_entropy", "max_signal_vel"):
        _close(getattr(hc, f), getattr(hd, f).numpy(), 2e-5, f)
