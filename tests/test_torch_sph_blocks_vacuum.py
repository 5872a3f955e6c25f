"""Block SPH on a clamped (vacuum) grid: the absolute-coordinate mode of
kernels C, D, F and G (their plain versions) and the host code around
them, against the JAX package's block kernels with ``relative=False`` /
``periodic=False`` in Pallas interpret mode.

The cloud: 800 gas particles uniform in the unit sphere, unequal masses,
a radial infall with noise, on 2^3 even (3^3 odd) blocks of 64 slots a
subcell over its bounding cube, as ``models/forces.py`` takes it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.ops import sph_blocks as jsb
from gadget_leicester_tpu.ops.pallas_cells import pack_sph_soa as j_pack
from gadget_leicester_tpu_torch.core.config import SimOptions
from gadget_leicester_tpu_torch.models.forces import (check_supported,
                                                      gas_bounding_grid)
from gadget_leicester_tpu_torch.models.grids import KAPPA_SPH
from gadget_leicester_tpu_torch.ops import cells
from gadget_leicester_tpu_torch.ops import sph_blocks as tsb
from gadget_leicester_tpu_torch.ops.sph_dense import hydro_params, hydro_table
from gadget_leicester_tpu_torch.ops.sph_kernels import kernel_w

N, NB, SUBCAP = 800, 2, 64
LANES = cells.ENTRY_LANES
DKW = dict(des_num_ngb=33.0, max_dev=2.0, min_hsml=0.001)
HKW = dict(visc_const=0.8, hubble_a2_flow=0.0, hubble_a2_norm=1.0,
           fac_mu=1.0)
# the port's bound against the JAX package: float32 sums in another order
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _blob(seed=1, n=N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    x *= (rng.uniform(size=n) ** (1 / 3) / np.linalg.norm(x, axis=1))[:, None]
    vel = -0.3 * x + 0.05 * rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n) / n
    mask = np.ones(n, bool)
    mask[-3:] = False
    h = rng.uniform(0.25, 0.4, n)
    return (x.astype(np.float32), vel.astype(np.float32),
            mass.astype(np.float32), h.astype(np.float32), mask)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(np.array(a)) for a in arrays]


def _grid(pos, mask):
    """The bounding cube of the gas (models/forces.py's)."""
    return gas_bounding_grid(*_t(pos, mask))


def _lists(pos, mask, nb=NB, subcap=SUBCAP, grid=None):
    origin, extent = _grid(pos, mask) if grid is None else grid
    t = tsb.build_block_lists(*_t(pos, mask), origin, extent, nb, subcap,
                              periodic=False)
    j = jsb.build_block_lists(*_j(pos, mask), *_j(origin, extent),
                              n_blocks=nb, subcap=subcap, periodic=False)
    return t, j


def _max_h(cl_e):
    return (1.0 - 2.0 * KAPPA_SPH) / cl_e.inv_cell[0]


def _hydro_fields(seed, n, mask):
    """rho, pressure, dhsml, div v, curl v of a plausible gas state."""
    rng = np.random.default_rng(seed)
    rho = (rng.uniform(0.8, 1.2, n) * 0.2).astype(np.float32)
    pressure = np.where(mask, 0.5 * rho ** (5.0 / 3.0), 0.0).astype(
        np.float32)
    return (rho, pressure, rng.uniform(0.9, 1.1, n).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32))


def _close(got, want, live, what=""):
    """Within TOL of the largest |want| on the ``live`` rows."""
    g, w = np.asarray(got)[live], np.asarray(want)[live]
    scale = np.abs(w).max()
    assert scale > 0, what
    np.testing.assert_allclose(g, w, rtol=0, atol=TOL * scale, err_msg=what)


# ---------------------------------------------------------------------------
# the clamped lists and the absolute packs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nb,subcap", [(2, 64), (3, 32)])
def test_clamped_block_lists_equal_jax(nb, subcap):
    """Fine coordinates clamped per axis, the odd grid of (nb+1)^3 blocks
    unwrapped: the even and odd slot tables, gslot maps, counts and
    geometry equal the JAX package's slot for slot."""
    pos, _, _, _, mask = _blob(2)
    (te, to), (je, jo) = _lists(pos, mask, nb, subcap)
    assert (te.n_cells, to.n_cells) == (je.n_cells, jo.n_cells) == \
        (nb, nb + 1)
    assert te.periodic is to.periodic is False
    for t, j in ((te, je), (to, jo)):
        for f in ("cells", "gslot", "counts", "cell_of", "inv_cell",
                  "origin"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)),
                                          err_msg=f)
        assert bool(t.overflow) == bool(j.overflow)


def test_absolute_packs_equal_jax():
    """pack_sph_soa without centres: absolute x, y, z; parked slots at -7
    fine cells with m = 0 and h = 1, as the JAX package's."""
    pos, vel, mass, h, mask = _blob(3)
    (te, to), (je, jo) = _lists(pos, mask)
    for t, j in ((te, je), (to, jo)):
        got = tsb.pack_sph_soa(t, *_t(pos, vel, mass, h, mask))
        want = j_pack(j, *_j(pos, vel, mass, h, mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the four kernels, each on the same inputs as the JAX kernel
# ---------------------------------------------------------------------------
def _density_inputs(seed):
    pos, vel, mass, h, mask = _blob(seed)
    (te, to), (je, jo) = _lists(pos, mask)
    ones = np.ones(len(pos), np.float32)
    soa_e = tsb.pack_sph_soa(te, *_t(pos, vel, mass, ones, mask))
    soa_o = tsb.pack_sph_soa(to, *_t(pos, vel, mass, ones, mask))
    idx = te.cells.clamp_min(0).long()
    h_slots = torch.where(te.cells >= 0, torch.from_numpy(h)[idx],
                          torch.ones(()))
    return soa_e, soa_o, h_slots, je


@pytest.mark.parametrize("gated", [False, True])
def test_density_kernel_matches_jax(gated):
    """Kernel C in absolute mode against the JAX kernel (relative=False):
    TOL of each row's largest value on the live targets; parked targets
    and gated tiles are 0 in the port."""
    soa_e, soa_o, h_slots, je = _density_inputs(4)
    flags = torch.ones(NB ** 3, dtype=torch.int32)
    if gated:
        flags[::3] = 0
    want = np.asarray(jsb.density_sums_blocks(
        je, *_j(soa_e, soa_o, h_slots), 1.0, interpret=True,
        flags=jnp.asarray(flags.numpy()), relative=False))[:, :6]
    got = tsb.density_sums_blocks(soa_e, soa_o, h_slots, flags, NB,
                                  None).numpy()
    live = soa_e[:, 3].numpy() > 0
    for r in range(6):
        _close(got[:, r], want[:, r], live, f"row {r}")
    assert not got.transpose(0, 2, 1)[~live].any()
    assert not got[flags.numpy() == 0].any()


def _hydro_inputs(seed, hubble=0.0):
    pos, vel, mass, h, mask = _blob(seed)
    (te, to), (je, jo) = _lists(pos, mask)
    fields = (pos, vel, mass, h, *_hydro_fields(seed + 10, len(pos), mask),
              mask)
    packs = tsb.pack_hydro_blocks((te, to), *_t(*fields), box=1.0,
                                  hubble_a2_flow=hubble, fac_mu=0.9)
    return packs, (te, to), (je, jo), fields


@pytest.mark.parametrize("hubble", [0.0, 0.3])
def test_hydro_kernel_matches_jax(hubble):
    """Kernel D in absolute mode against the JAX kernel (relative=False,
    the self-pair dropped by r > 0) on the same packs: TOL of each row's
    largest value on the valid targets; invalid targets are 0."""
    (a, b, src16, idx_e, idx_o, flags, params), (te, _), (je, _), _ = \
        _hydro_inputs(5, hubble)
    want = np.asarray(jsb.hydro_sums_blocks(
        je, *_j(a, b, src16), 1.0, 0.8, hubble, 0.9, interpret=True,
        flags=jnp.asarray(flags.numpy()), relative=False))[:, :5]
    got = tsb.hydro_sums_blocks(a, b, src16, idx_e, idx_o, flags, params,
                                NB, None, 0.8).numpy()
    live = b[:, 4].numpy() > 0
    for r in range(5):
        _close(got[:, r], want[:, r], live, f"row {r}")
    assert not got.transpose(0, 2, 1)[~live].any()


def _entries(cl_e, pos, mask, seed=6, frac=0.1):
    rng = np.random.default_rng(seed)
    active = (rng.uniform(size=len(pos)) < frac) & mask
    ec, es, total = cells.build_active_entries(
        cl_e, torch.from_numpy(active), LANES, 2 * NB ** 3 * 4)
    assert int(total) <= ec.shape[0]
    return active, ec, es


def _wide(x, rows):
    """[K, R, 8] entry tiles -> the JAX kernel's [K, rows, 128] layout."""
    out = np.zeros((x.shape[0], rows, 128), np.float32)
    out[:, :x.shape[1], :x.shape[2]] = x
    return out


def test_density_entries_kernel_matches_jax():
    """Kernel F in absolute mode against the JAX entry kernel
    (periodic=False) on the same targets and odd sources (the JAX
    kernel's padded (nb+1)^3 layout): TOL on the live lanes."""
    pos, vel, mass, h, mask = _blob(7)
    (te, to), (je, jo) = _lists(pos, mask)
    _, ec, es = _entries(te, pos, mask)
    tp, tv, tm, th, tmask = _t(pos, vel, mass, h, mask)
    ones = torch.ones_like(tm)
    soa_o = tsb.pack_sph_soa(to, tp, tv, tm, ones, tmask)
    pidx, valid = cells.entry_particles(te, ec, es, tmask)
    tgt = tsb._sph_rows(te, pidx, valid, None, None, tp, tv, tm, ones)
    tgt = tgt.transpose(1, 2).contiguous()
    h_slots = torch.where(valid, th[pidx.clamp_min(0).long()],
                          torch.ones(()))
    got = tsb.density_sums_blocks_entries(soa_o, tgt, h_slots, ec, NB,
                                          None).numpy()
    want = np.asarray(jsb.density_sums_blocks_entries(
        je, jnp.asarray(_wide(tgt.numpy(), 8)),
        jnp.asarray(_wide(h_slots.numpy()[:, None], 1)[:, 0]),
        jsb._xyzpad_odd_full(jnp.asarray(soa_o.numpy()), NB, False),
        jnp.asarray(ec.numpy()), 1.0, interpret=True))[:, :6, :LANES]
    live = tgt[:, 3].numpy() > 0
    for r in range(6):
        _close(got[:, r], want[:, r], live, f"row {r}")


def test_hydro_entries_kernel_matches_jax():
    """Kernel G in absolute mode against the JAX entry kernel
    (periodic=False, the self-pair dropped by r > 0) on the same targets
    and sources: TOL on the live lanes."""
    packs, (te, to), (je, _), fields = _hydro_inputs(8, 0.1)
    pos, vel, mass, h, *sph, mask = _t(*fields)
    _, ec, es = _entries(te, fields[0], fields[-1])
    table16 = hydro_table(pos, vel, mass, h, *sph, torch.tensor(0.9))
    src16, idx_o = packs[2], packs[4]
    pidx, valid = cells.entry_particles(te, ec, es, mask)
    tgt16 = tsb._hydro_rows(te, table16, pidx, valid, None, 1.0)
    tgt16 = tgt16.transpose(1, 2).contiguous()
    tidx = torch.where(valid, pidx, torch.full_like(pidx, -1)).contiguous()
    params = hydro_params(0.1, torch.tensor(0.9))
    got = tsb.hydro_sums_blocks_entries(tgt16, tidx, src16, idx_o, ec,
                                        params, NB, None, 0.8).numpy()
    want = np.asarray(jsb.hydro_sums_blocks_entries(
        je, jnp.asarray(_wide(tgt16.numpy(), 16)),
        jsb._xyzpad_odd_full(jnp.asarray(src16.numpy()), NB, False),
        jnp.asarray(ec.numpy()), 1.0, 0.8, 0.1, 0.9,
        interpret=True))[:, :5, :LANES]
    live = tgt16[:, 12].numpy() > 0
    for r in range(5):
        _close(got[:, r], want[:, r], live, f"row {r}")


# ---------------------------------------------------------------------------
# the callers: the Newton loop and the hydro pass, dense and entries tier
# ---------------------------------------------------------------------------
DENSITY_FIELDS = ("rho", "hsml", "div_vel", "curl_vel", "dhsml_factor",
                  "num_ngb_eff")


@pytest.mark.parametrize("use_active", [False, True])
def test_density_adaptive_matches_jax(use_active):
    """density_adaptive_blocks on a clamped grid (box 1, no minimum image)
    against the JAX loop over the interpret-mode kernel: TOL of each
    field's largest value, the same number of sweeps."""
    pos, vel, mass, h, mask = _blob(9)
    (te, to), (je, jo) = _lists(pos, mask)
    active = np.random.default_rng(9).uniform(size=len(pos)) < 0.3
    act = active if use_active else None
    max_h = _max_h(te)
    jres, _ = jsb.density_adaptive_blocks(
        *_j(pos, vel, mass, h, mask), n_blocks=NB, subcap=SUBCAP,
        periodic=False, interpret=True, cls=(je, jo), box=1.0,
        max_hsml=jnp.asarray(max_h.numpy()),
        active=None if act is None else jnp.asarray(act), **DKW)
    tres, _ = tsb.density_adaptive_blocks(
        *_t(pos, vel, mass, h, mask), box=1.0, cls=(te, to), max_hsml=max_h,
        active=None if act is None else torch.from_numpy(act), **DKW)
    sel = mask & (act if act is not None else True)
    for f in DENSITY_FIELDS:
        _close(getattr(tres, f).numpy(), getattr(jres, f), sel, f)
    assert tres.iters == int(jres.iters)


@pytest.mark.parametrize("use_active", [False, True])
def test_hydro_force_matches_jax(use_active):
    """hydro_force_blocks on a clamped grid against the JAX package's:
    TOL of each output's largest value on the (active) gas."""
    _, tcls, jcls, fields = _hydro_inputs(10, 0.2)
    active = np.random.default_rng(10).uniform(size=N) < 0.3
    kw = dict(HKW, hubble_a2_flow=0.2, box=1.0)
    jres = jsb.hydro_force_blocks(
        jcls, *_j(*fields), interpret=True,
        active=jnp.asarray(active) if use_active else None, **kw)
    tres = tsb.hydro_force_blocks(
        tcls, *_t(*fields),
        active=torch.from_numpy(active) if use_active else None, **kw)
    sel = fields[-1] & (active if use_active else True)
    for f in ("acc", "dt_entropy", "max_signal_vel"):
        _close(getattr(tres, f).numpy(), getattr(jres, f), sel, f)


def test_density_entries_adaptive_matches_jax():
    """density_adaptive_blocks_entries on a clamped grid against the JAX
    package's (interpret): TOL of each field's largest value on the
    active gas, the same number of sweeps."""
    pos, vel, mass, h, mask = _blob(11)
    (te, to), (je, jo) = _lists(pos, mask)
    active, ec, es = _entries(te, pos, mask, seed=11)
    max_h = _max_h(te)
    got = tsb.density_adaptive_blocks_entries(
        *_t(pos, vel, mass, h, mask), ec, es, box=1.0, cls=(te, to),
        max_hsml=max_h, **DKW)
    want = jsb.density_adaptive_blocks_entries(
        *_j(pos, vel, mass, h, mask), *_j(ec, es), box=1.0, cls=(je, jo),
        max_hsml=jnp.asarray(max_h.numpy()), periodic=False, interpret=True,
        **DKW)
    for f in DENSITY_FIELDS:
        _close(getattr(got, f).numpy(), getattr(want, f), active, f)
    assert got.iters == int(want.iters)


def test_hydro_entries_adaptive_matches_jax():
    """hydro_force_blocks_entries on a clamped grid against the JAX
    package's (interpret): TOL on the active gas; other rows 0 in both."""
    _, (te, to), jcls, fields = _hydro_inputs(12, 0.1)
    active, ec, es = _entries(te, fields[0], fields[-1], seed=12)
    kw = dict(HKW, hubble_a2_flow=0.1, box=1.0)
    got = tsb.hydro_force_blocks_entries((te, to), *_t(*fields), ec, es,
                                         **kw)
    want = jsb.hydro_force_blocks_entries(jcls, *_j(*fields), *_j(ec, es),
                                          interpret=True, **kw)
    for f in ("acc", "dt_entropy", "max_signal_vel"):
        _close(getattr(got, f).numpy(), getattr(want, f), active, f)
        assert not getattr(got, f).numpy()[~active].any(), f


@pytest.mark.parametrize("frac", [0.02, 0.1, 0.3])
def test_entries_match_dense_in_vacuum(frac):
    """F and G against C and D on the same active gas of the clamped grid
    (the JAX package tests only density here): 1e-6 of each field's
    largest value, the same number of sweeps; other rows exactly 0."""
    pos, vel, mass, h, mask = _blob(13)
    tcls = _lists(pos, mask)[0]
    active, ec, es = _entries(tcls[0], pos, mask, seed=13, frac=frac)
    ta = torch.from_numpy(active)
    args = _t(pos, vel, mass, h, mask)
    kw = dict(box=1.0, cls=tcls, max_hsml=_max_h(tcls[0]), **DKW)
    got = tsb.density_adaptive_blocks_entries(*args, ec, es, **kw)
    want, _ = tsb.density_adaptive_blocks(*args, active=ta, **kw)
    assert got.iters == want.iters
    for f in DENSITY_FIELDS:
        g, w = getattr(got, f).numpy(), getattr(want, f).numpy()
        np.testing.assert_allclose(g[active], w[active], rtol=0,
                                   atol=1e-6 * np.abs(w[active]).max(),
                                   err_msg=f)
    assert not got.rho.numpy()[~active].any()
    fields = _t(pos, vel, mass, h, *_hydro_fields(14, N, mask), mask)
    kw = dict(HKW, hubble_a2_flow=0.1, box=1.0)
    got = tsb.hydro_force_blocks_entries(tcls, *fields, ec, es, **kw)
    want = tsb.hydro_force_blocks(tcls, *fields, active=ta, **kw)
    for f in ("acc", "dt_entropy", "max_signal_vel"):
        g, w = getattr(got, f).numpy(), getattr(want, f).numpy()
        assert np.abs(w[active]).max() > 0, f
        np.testing.assert_allclose(g[active], w[active], rtol=0,
                                   atol=1e-6 * np.abs(w[active]).max(),
                                   err_msg=f)
        assert not g[~active].any(), f


# ---------------------------------------------------------------------------
# parked slots, the self-pair, the clamped edge, the refusal
# ---------------------------------------------------------------------------
def test_parked_slots_inside_the_cloud_give_the_reference_sums():
    """A cube of gas over [-0.95, 0.05]^3 on 4^3 blocks: the parked point
    (-7 fine cells, absolute) lies inside it, and a gas particle sits on
    it. Kernels C and D skip parked sources by their mass and valid row:
    finite sums equal to the JAX kernels', and that particle's density
    equals the float64 sum over the real gas."""
    rng = np.random.default_rng(15)
    n, nb = 1000, 4
    pos = (rng.uniform(size=(n, 3)) - 0.95).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    mass = np.full(n, 1.0 / n, np.float32)
    h = np.full(n, 0.1, np.float32)
    mask = np.ones(n, bool)
    origin, extent = _grid(pos, mask)
    park = float(-7.0 / (2 * nb / extent))
    assert (pos.min(0) < park).all() and (pos.max(0) > park).all()
    pos[0] = park                       # on the parked point, grid unchanged
    (te, to), (je, jo) = _lists(pos, mask, nb, 32, (origin, extent))
    assert not bool(te.overflow)
    ones = np.ones(n, np.float32)
    soa_e = tsb.pack_sph_soa(te, *_t(pos, vel, mass, ones, mask))
    soa_o = tsb.pack_sph_soa(to, *_t(pos, vel, mass, ones, mask))
    assert (soa_o[:, 3] == 0).any() and (soa_o[:, 0][soa_o[:, 3] == 0]
                                         == park).all()
    h_slots = torch.where(te.cells >= 0, torch.from_numpy(h)[
        te.cells.clamp_min(0).long()], torch.ones(()))
    flags = torch.ones(nb ** 3, dtype=torch.int32)
    got = tsb.density_sums_blocks(soa_e, soa_o, h_slots, flags, nb, None)
    want = np.asarray(jsb.density_sums_blocks(
        je, *_j(soa_e, soa_o, h_slots), 1.0, interpret=True,
        relative=False))[:, :6]
    live = soa_e[:, 3].numpy() > 0
    assert np.isfinite(got.numpy()).all()
    for r in range(6):
        _close(got.numpy()[:, r], want[:, r], live, f"row {r}")
    slot = int(te.gslot[0])
    r0 = np.linalg.norm(pos.astype(np.float64) - pos[0], axis=1)
    w = kernel_w(torch.from_numpy(r0), torch.tensor(0.1, dtype=torch.float64))
    direct = float((mass * w.numpy()).sum())
    assert float(got[slot // te.cells.shape[1], 0,
                     slot % te.cells.shape[1]]) == pytest.approx(direct,
                                                                 rel=1e-5)
    fields = (pos, vel, mass, h, *_hydro_fields(16, n, mask), mask)
    a, b, src16, idx_e, idx_o, fl, params = tsb.pack_hydro_blocks(
        (te, to), *_t(*fields), box=1.0, hubble_a2_flow=0.0, fac_mu=1.0)
    got = tsb.hydro_sums_blocks(a, b, src16, idx_e, idx_o, fl, params, nb,
                                None, 0.8).numpy()
    want = np.asarray(jsb.hydro_sums_blocks(
        je, *_j(a, b, src16), 1.0, 0.8, 0.0, 1.0, interpret=True,
        relative=False))[:, :5]
    assert np.isfinite(got).all()
    for r in range(5):
        _close(got[:, r], want[:, r], b[:, 4].numpy() > 0, f"row {r}")


def test_coincident_gas_drop_each_others_pair_as_the_reference_does():
    """Two gas particles at one position: in absolute mode the self-pair
    rule r > 0 drops their pair too (target and source rows are copies of
    one table row). Kernels D and G give each the signal velocity and
    force of the JAX package's kernels, which follow the same rule: the
    two do not count each other."""
    pos, vel, mass, h, mask = _blob(17)
    pos[1] = pos[0]
    vel[1] = -vel[0]                    # approaching: a large mu if counted
    _, tcls, jcls, fields = _hydro_inputs(17)
    fields = (pos, vel, mass, h) + fields[4:]
    kw = dict(HKW, box=1.0)
    got = tsb.hydro_force_blocks(tcls, *_t(*fields), **kw)
    want = jsb.hydro_force_blocks(jcls, *_j(*fields), interpret=True, **kw)
    for f in ("acc", "dt_entropy", "max_signal_vel"):
        _close(getattr(got, f).numpy(), getattr(want, f), mask, f)
    te = tcls[0]
    active = np.zeros(N, bool)
    active[:2] = True
    ec, es, _ = cells.build_active_entries(te, torch.from_numpy(active),
                                           LANES, 8)
    ent = tsb.hydro_force_blocks_entries(tcls, *_t(*fields), ec, es, **kw)
    for f in ("acc", "dt_entropy", "max_signal_vel"):
        _close(getattr(ent, f).numpy(), getattr(want, f), active, f)
    # counted, the pair would add c_0 + c_1 - 3 mu > c_0 + c_1 to v_sig
    c = np.sqrt(5.0 / 3.0 * fields[5] / fields[4])
    assert (got.max_signal_vel.numpy()[:2] < 4 * c[:2]).all()


def test_particle_on_the_clamped_edge_keeps_its_neighbours():
    """A particle exactly on origin + extent (x) is clamped into the edge
    fine cell, as in the JAX package; its density over the 8-block
    stencil equals the float64 sum over every gas particle within h."""
    pos, vel, mass, _, mask = _blob(18)
    origin, extent = _grid(pos, mask)
    k = int(np.argmax(np.where(mask, pos[:, 0], -np.inf)))
    pos[k, 0] = float(origin[0] + extent)
    (te, to), (je, jo) = _lists(pos, mask, grid=(origin, extent))
    for t, j in ((te, je), (to, jo)):
        np.testing.assert_array_equal(t.cells.numpy(), np.asarray(j.cells))
    m = 2 * NB
    assert int(te.cell_of[k]) // (m * m) == m - 1
    hk = 0.9 * float(_max_h(te))
    ones = np.ones(N, np.float32)
    soa_e = tsb.pack_sph_soa(te, *_t(pos, vel, mass, ones, mask))
    soa_o = tsb.pack_sph_soa(to, *_t(pos, vel, mass, ones, mask))
    h_slots = torch.where(te.cells >= 0, torch.full((), hk), torch.ones(()))
    out = tsb.density_sums_blocks(soa_e, soa_o, h_slots,
                                  torch.ones(NB ** 3, dtype=torch.int32), NB,
                                  None)
    slot = int(te.gslot[k])
    lanes = te.cells.shape[1]
    r = np.linalg.norm(pos.astype(np.float64) - pos[k], axis=1)
    w = kernel_w(torch.from_numpy(r),
                 torch.tensor(hk, dtype=torch.float64)).numpy()
    assert (w[mask] > 0).sum() > 10
    direct = float((mass[mask] * w[mask]).sum())
    assert float(out[slot // lanes, 0, slot % lanes]) == pytest.approx(
        direct, rel=1e-5)


def test_check_supported_takes_blocks_on_a_vacuum_grid():
    """Block SPH on a vacuum grid is ported: check_supported accepts it,
    forced and through ``auto`` above 4,096 gas; a per-axis periodic
    tuple (the slab's grids) is still refused."""
    from gadget_leicester_tpu_torch.core.config import parse_parameter_text
    from gadget_leicester_tpu_torch.models.grids import resolve_sph_backend
    from tests.test_torch_sinks import GASSPHERE_PARAM
    cfg = parse_parameter_text(GASSPHERE_PARAM)
    for opts in (SimOptions(sph_backend="blocks"), SimOptions()):
        check_supported(cfg, opts, 20001, 20000)
    assert resolve_sph_backend(SimOptions(), 20000) == "blocks"
    with pytest.raises(NotImplementedError, match="per-axis periodic"):
        check_supported(cfg, SimOptions(periodic=(True, True, False)),
                        20001, 20000)
