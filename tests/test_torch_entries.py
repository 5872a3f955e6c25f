"""The near-idle tier of the port on the CPU: the active-entry lists, and
kernels E, F and G's plain versions through their host code, against the
JAX package's entry path (Pallas interpret mode) and against the port's
own dense path.

Setups: gravity on tests/test_compact_entries.py's (900 particles, a
corner halo, 5^3 cells of capacity 64), SPH on tests/test_sph_entries.py's
(4000 uniform gas particles, 3^3 blocks of subcap 64) for the lists, and
a smaller SPH box (1500 particles, 2^3 blocks, tests/test_torch_sph_blocks
.py's) for the rest, where the JAX package's interpret mode costs less."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import recorded_inputs
from gadget_leicester_tpu.ops import pallas_cells as jpc
from gadget_leicester_tpu.ops import sph_blocks as jsb
from gadget_leicester_tpu.ops.neighbors import build_cell_list as j_build
from gadget_leicester_tpu_torch.ops import cells
from gadget_leicester_tpu_torch.ops import sph_blocks as tsb
from gadget_leicester_tpu_torch.ops.neighbors import (build_cell_list,
                                                      merge_rows)

MODES = ["corner", "wrap", "spread", "spill", "empty"]
LANES = cells.ENTRY_LANES

# gravity: tests/test_compact_entries.py's setup; rcut below the cell edge
# 0.2 so the 27-cell stencil is complete
G_BOX, G_CELLS, G_CAP, G_KMAX = 1.0, 5, 64, 256
ASMTH, RCUT = 0.04, 0.18


def _grav_setup(seed=3, n=900):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)) * G_BOX
    k = n // 3
    pos[:k] = 0.08 + 0.12 * rng.random((k, 3))          # corner halo
    mass = rng.random(n).astype(np.float32) + 0.5
    soft = np.full(n, 0.02, np.float32)
    alive = np.ones(n, bool)
    alive[-7:] = False
    return pos.astype(np.float32), mass, soft, alive


def _grav_active(mode, pos, alive):
    n = len(pos)
    if mode == "corner":
        a = (pos[:, 0] < 0.25) & (pos[:, 1] < 0.25)
    elif mode == "wrap":
        a = ((pos[:, 0] > 0.9) | (pos[:, 0] < 0.1)) & (pos[:, 1] < 0.3) \
            & (pos[:, 2] < 0.3)
    elif mode == "spread":
        a = np.arange(n) % 29 == 0
    elif mode == "spill":
        a = (pos[:, 0] < 0.2) & (pos[:, 1] < 0.2) & (pos[:, 2] < 0.2)
    else:
        a = np.zeros(n, bool)
    return a & alive


# SPH: tests/test_sph_entries.py's setup
S_BOX, S_NB, S_SUBCAP = 1.0, 3, 64
S_KMAX = 4 * S_NB ** 3
DKW = dict(des_num_ngb=33.0, max_dev=2.0, min_hsml=0.001)
# the smaller SPH box of tests/test_torch_sph_blocks.py
C_BOX, C_NB, C_KMAX = 2.0, 2, 64
C_MAXH = 0.9 * C_BOX / (2 * C_NB)


def _sph_setup(seed, n=4000, box=S_BOX):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)).astype(np.float32) * box
    vel = (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.3
    mass = np.full(n, 1.0 / n, np.float32)
    gas_mask = np.ones(n, bool)
    gas_mask[-9:] = False
    h0 = np.full(n, 0.12 * box, np.float32)
    return pos, vel, mass, h0, gas_mask


def _sph_active(mode, pos, gas_mask, box=S_BOX):
    n = len(pos)
    x, y = pos[:, 0] / box, pos[:, 1] / box
    if mode == "corner":
        a = (x < 0.35) & (y < 0.35)
    elif mode == "wrap":
        a = ((x > 0.85) | (x < 0.15)) & (y < 0.4)
    elif mode == "spread":
        a = np.arange(n) % 37 == 0
    elif mode == "spill":
        a = (x < 0.5) & (y < 0.25)
    else:
        a = np.zeros(n, bool)
    return a & gas_mask


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _hydro_fields(seed, pos, gas_mask):
    """rho, pressure, dhsml, div v, curl v of a plausible gas state."""
    rng = np.random.default_rng(seed)
    n = len(pos)
    rho = (rng.uniform(0.8, 1.2, n) * n / 8).astype(np.float32)
    pressure = np.where(gas_mask, 0.5 * rho ** (5.0 / 3.0), 0.0).astype(
        np.float32)
    return (rho, pressure, rng.uniform(0.9, 1.1, n).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32))


HKW = dict(visc_const=0.8, hubble_a2_flow=0.01, hubble_a2_norm=1.1,
           fac_mu=0.9)


# ---------------------------------------------------------------------------
# (a) the entry lists equal the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_gravity_entry_lists_equal_jax(mode):
    pos, mass, soft, alive = _grav_setup()
    active = _grav_active(mode, pos, alive)
    cl = build_cell_list(*_t(pos, alive), 0.0, G_BOX, G_CELLS, G_CAP)
    jcl = j_build(jnp.asarray(pos), jnp.asarray(alive), 0.0, G_BOX,
                  n_cells=G_CELLS, capacity=G_CAP, periodic=True)
    got = cells.build_active_entries(cl, torch.from_numpy(active), LANES,
                                     G_KMAX)
    want = jpc.build_active_entries(jcl, jnp.asarray(active), LANES, G_KMAX)
    for g, w, what in zip(got, want, ("entry_cell", "entry_slot", "total")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    assert int(cells.count_active_entries(cl, torch.from_numpy(active))) \
        == int(jpc.count_active_entries(jcl, jnp.asarray(active), LANES))
    if mode == "empty":
        assert int(got[2]) == 0 and (got[0] == -1).all()


@pytest.mark.parametrize("mode", MODES)
def test_sph_entry_lists_equal_jax(mode):
    pos, _, _, _, gas_mask = _sph_setup(5)
    active = _sph_active(mode, pos, gas_mask)
    tcl = tsb.build_block_lists(*_t(pos, gas_mask), 0.0, S_BOX, S_NB,
                                S_SUBCAP)[0]
    jcl = jsb.build_block_lists(jnp.asarray(pos), jnp.asarray(gas_mask), 0.0,
                                S_BOX, n_blocks=S_NB, subcap=S_SUBCAP,
                                periodic=True)[0]
    got = cells.build_active_entries(tcl, torch.from_numpy(active), LANES,
                                     S_KMAX)
    want = jpc.build_active_entries(jcl, jnp.asarray(active), LANES, S_KMAX)
    for g, w, what in zip(got, want, ("entry_blk", "entry_slot", "total")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    assert int(tsb.count_block_entries(tcl, torch.from_numpy(active))) \
        == int(jsb.count_block_entries(jcl, jnp.asarray(active), LANES))


def test_entry_lists_spill_past_k_max():
    """More entries than k_max: the lists keep the first k_max, total
    still counts them all (the caller then takes the dense tier), as in
    the JAX package."""
    pos, _, _, alive = _grav_setup()
    active = alive.copy()
    cl = build_cell_list(*_t(pos, alive), 0.0, G_BOX, G_CELLS, G_CAP)
    jcl = j_build(jnp.asarray(pos), jnp.asarray(alive), 0.0, G_BOX,
                  n_cells=G_CELLS, capacity=G_CAP, periodic=True)
    got = cells.build_active_entries(cl, torch.from_numpy(active), LANES, 64)
    want = jpc.build_active_entries(jcl, jnp.asarray(active), LANES, 64)
    assert int(got[2]) > 64
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# (b) the port's entry path against the JAX package's (interpret mode)
# ---------------------------------------------------------------------------
def _port_gravity(pos, mass, soft, alive, active, entries: bool):
    tp, tm, ts, ta, tact = _t(pos, mass, soft, alive, active)
    cl = build_cell_list(tp, ta, 0.0, G_BOX, G_CELLS, G_CAP)
    soa = cells.pack_cells_soa(cl, tp, tm, ts, ta)
    if entries:
        ec, es, _ = cells.build_active_entries(cl, tact, LANES, G_KMAX)
        return cells.gravity_entries(cl, soa, ec, es, tp, tm, ts, ta, G_BOX,
                                     ASMTH, RCUT).numpy()
    out = cells.shortrange_gravity_tiles(soa, cells.grav_tile_flags(cl, tact),
                                         G_CELLS, G_BOX, ASMTH, RCUT)
    return merge_rows(out, cl, 3).numpy()


@pytest.mark.parametrize("mode", ["spread", "spill"])
def test_gravity_entries_match_jax(mode):
    """Kernel E's plain version through gravity_entries against JAX's
    shortrange_gravity_pallas_entries (relative mode, interpret): 2e-4 of
    the largest |acc|, JAX's own tolerance between its two tiers. The JAX
    entry path recomputes its targets with the box wrap, the port takes
    them from the pack's arithmetic: the same numbers up to rounding."""
    pos, mass, soft, alive = _grav_setup()
    active = _grav_active(mode, pos, alive)
    got = _port_gravity(pos, mass, soft, alive, active, True)
    jcl = j_build(jnp.asarray(pos), jnp.asarray(alive), 0.0, G_BOX,
                  n_cells=G_CELLS, capacity=G_CAP, periodic=True)
    ec, es, _ = jpc.build_active_entries(jcl, jnp.asarray(active), LANES,
                                         G_KMAX)
    want, _ = jpc.shortrange_gravity_pallas_entries(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(soft),
        jnp.asarray(alive), G_BOX, n_cells=G_CELLS, capacity=G_CAP,
        asmth=ASMTH, rcut=RCUT, entry_cell=ec, entry_slot=es, cl=jcl,
        periodic=True, interpret=True, relative=True)
    want = np.asarray(want)
    scale = np.abs(want[active]).max()
    np.testing.assert_allclose(got[active], want[active], rtol=0,
                               atol=2e-4 * scale)
    assert not got[~active].any() and not want[~active].any()


def _lists(pos, gas_mask, box, nb, subcap=S_SUBCAP):
    t = tsb.build_block_lists(*_t(pos, gas_mask), 0.0, box, nb, subcap)
    j = jsb.build_block_lists(jnp.asarray(pos), jnp.asarray(gas_mask), 0.0,
                              box, n_blocks=nb, subcap=subcap, periodic=True)
    return t, j


@pytest.mark.parametrize("mode", ["spread", "spill"])
def test_density_entries_match_jax(mode):
    """The Newton loop over kernel F's plain version against JAX's
    density_adaptive_blocks_entries (interpret): 2e-4 of each field's
    largest value on the active gas, the same number of sweeps."""
    pos, vel, mass, h0, gas_mask = _sph_setup(5, n=1500, box=C_BOX)
    active = _sph_active(mode, pos, gas_mask, C_BOX)
    tcls, jcls = _lists(pos, gas_mask, C_BOX, C_NB)
    ec, es, _ = cells.build_active_entries(tcls[0], torch.from_numpy(active),
                                           LANES, C_KMAX)
    got = tsb.density_adaptive_blocks_entries(
        *_t(pos, vel, mass, h0, gas_mask), ec, es, box=C_BOX, cls=tcls,
        max_hsml=C_MAXH, **DKW)
    want = jsb.density_adaptive_blocks_entries(
        *[jnp.asarray(a) for a in (pos, vel, mass, h0, gas_mask)],
        jnp.asarray(ec.numpy()), jnp.asarray(es.numpy()), box=C_BOX,
        cls=jcls, max_hsml=C_MAXH, periodic=True, interpret=True, **DKW)
    for f in ("rho", "hsml", "dhsml_factor", "div_vel", "curl_vel",
              "num_ngb_eff"):
        w = np.asarray(getattr(want, f))[active]
        g = getattr(got, f).numpy()[active]
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4 * np.abs(w).max(),
                                   err_msg=f)
    assert got.iters == int(want.iters)
    assert not got.rho.numpy()[~active].any()


@pytest.mark.parametrize("mode", ["spread", "spill"])
def test_hydro_entries_match_jax(mode):
    """Kernel G's plain version through hydro_force_blocks_entries against
    JAX's (interpret): 2e-4 of each output's largest value on the active
    gas; rows of other particles are 0 in both."""
    pos, vel, mass, _, gas_mask = _sph_setup(7, n=1500, box=C_BOX)
    h = np.full(len(pos), 0.2, np.float32)
    active = _sph_active(mode, pos, gas_mask, C_BOX)
    tcls, jcls = _lists(pos, gas_mask, C_BOX, C_NB)
    ec, es, _ = cells.build_active_entries(tcls[0], torch.from_numpy(active),
                                           LANES, C_KMAX)
    fields = (pos, vel, mass, h, *_hydro_fields(8, pos, gas_mask), gas_mask)
    got = tsb.hydro_force_blocks_entries(tcls, *_t(*fields), ec, es,
                                         box=C_BOX, **HKW)
    want = jsb.hydro_force_blocks_entries(
        jcls, *[jnp.asarray(a) for a in fields], jnp.asarray(ec.numpy()),
        jnp.asarray(es.numpy()), box=C_BOX, interpret=True, **HKW)
    for f in ("acc", "dt_entropy", "max_signal_vel"):
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert np.abs(w[active]).max() > 0, f
        np.testing.assert_allclose(g[active], w[active], rtol=0,
                                   atol=2e-4 * np.abs(w[active]).max(),
                                   err_msg=f)
        assert not g[~active].any() and not w[~active].any(), f


# ---------------------------------------------------------------------------
# (c) the port's entry path against its dense path, all five modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_gravity_entries_match_dense(mode):
    """The same float32 pair terms of the same sources for each active
    target: 1e-6 of the largest |acc| (room for the order of the sums);
    inactive rows are exactly 0."""
    pos, mass, soft, alive = _grav_setup()
    active = _grav_active(mode, pos, alive)
    got = _port_gravity(pos, mass, soft, alive, active, True)
    want = _port_gravity(pos, mass, soft, alive, active, False)
    if active.any():
        scale = np.abs(want[active]).max()
        np.testing.assert_allclose(got[active], want[active], rtol=0,
                                   atol=1e-6 * scale)
    assert not got[~active].any()


def _small_sph(seed):
    pos, vel, mass, h0, gas_mask = _sph_setup(seed, n=1500, box=C_BOX)
    tcls = tsb.build_block_lists(*_t(pos, gas_mask), 0.0, C_BOX, C_NB,
                                 S_SUBCAP)
    return pos, vel, mass, h0, gas_mask, tcls


@pytest.mark.parametrize("mode", MODES)
def test_sph_entries_match_dense(mode):
    """Density (the Newton loop) and hydro through F and G against C and
    D on the same active gas: 1e-6 of each field's largest value, the
    same number of sweeps; rows of other particles are exactly 0."""
    pos, vel, mass, h0, gas_mask, tcls = _small_sph(2)
    active = _sph_active(mode, pos, gas_mask, C_BOX)
    ta = torch.from_numpy(active)
    ec, es, total = cells.build_active_entries(tcls[0], ta, LANES, C_KMAX)
    assert int(total) <= C_KMAX
    args = _t(pos, vel, mass, h0, gas_mask)
    kw = dict(box=C_BOX, cls=tcls, max_hsml=C_MAXH, **DKW)
    got = tsb.density_adaptive_blocks_entries(*args, ec, es, **kw)
    want, _ = tsb.density_adaptive_blocks(*args, active=ta, **kw)
    assert got.iters == want.iters
    for f in ("rho", "hsml", "dhsml_factor", "div_vel", "curl_vel",
              "num_ngb_eff"):
        g, w = getattr(got, f).numpy(), getattr(want, f).numpy()
        if active.any():
            np.testing.assert_allclose(
                g[active], w[active], rtol=0,
                atol=1e-6 * np.abs(w[active]).max(), err_msg=f)
    assert not got.rho.numpy()[~active].any()

    h = np.full(len(pos), 0.2, np.float32)
    fields = _t(pos, vel, mass, h, *_hydro_fields(3, pos, gas_mask),
                gas_mask)
    hg = tsb.hydro_force_blocks_entries(tcls, *fields, ec, es, box=C_BOX,
                                        **HKW)
    hw = tsb.hydro_force_blocks(tcls, *fields, box=C_BOX, active=ta, **HKW)
    for f in ("acc", "dt_entropy", "max_signal_vel"):
        g, w = getattr(hg, f).numpy(), getattr(hw, f).numpy()
        if active.any():
            np.testing.assert_allclose(
                g[active], w[active], rtol=0,
                atol=1e-6 * np.abs(w[active]).max(), err_msg=f)
        assert not g[~active].any(), f


# ---------------------------------------------------------------------------
# (d) entry targets are their own slots of the full pack, bit for bit
# ---------------------------------------------------------------------------
def _recorded(fn, *args, **kw):
    with recorded_inputs() as rec:
        fn(*args, **kw)
    return dict(rec)


def _assert_slots_equal(tgt, pack, ec, es):
    """tgt [K, R, L] lane (k, l) == pack[ec[k], :R, es[k, l]] wherever the
    lane is live."""
    live = (ec[:, None] >= 0) & (es >= 0)
    k, l = torch.nonzero(live, as_tuple=True)
    want = pack[ec[k].long(), :tgt.shape[1], es[k, l].long()]
    assert k.numel() > 0
    assert torch.equal(tgt[k, :, l], want)


def test_entry_targets_equal_pack_slots():
    """Gravity, density and hydro targets gathered per entry equal, bit
    for bit, their slots in the pack that holds them, so a gravity target
    sees itself at r2 = 0 exactly (and the self-pair drops out as in
    kernel A)."""
    pos, mass, soft, alive = _grav_setup()
    active = _grav_active("spill", pos, alive)
    tp, tm, ts, ta, tact = _t(pos, mass, soft, alive, active)
    cl = build_cell_list(tp, ta, 0.0, G_BOX, G_CELLS, G_CAP)
    soa = cells.pack_cells_soa(cl, tp, tm, ts, ta)
    ec, es, _ = cells.build_active_entries(cl, tact, LANES, G_KMAX)
    rec = _recorded(cells.gravity_entries, cl, soa, ec, es, tp, tm, ts, ta,
                    G_BOX, ASMTH, RCUT)
    _assert_slots_equal(rec["shortrange_gravity_entries"][2], soa, ec, es)

    pos, vel, mass, h0, gas_mask, tcls = _small_sph(4)
    ta = torch.from_numpy(_sph_active("spread", pos, gas_mask, C_BOX))
    ec, es, _ = cells.build_active_entries(tcls[0], ta, LANES, C_KMAX)
    args = _t(pos, vel, mass, h0, gas_mask)
    rec = _recorded(tsb.density_adaptive_blocks_entries, *args, ec, es,
                    box=C_BOX, cls=tcls, max_hsml=C_MAXH, **DKW)
    lf = C_BOX / (2 * C_NB)
    soa_e = tsb.pack_sph_soa(tcls[0], args[0], args[1], args[2],
                             torch.ones_like(args[2]), args[4],
                             tsb.block_centers(C_NB, "even", lf,
                                               tcls[0].origin), C_BOX)
    _assert_slots_equal(rec["sph_density_entries"][1], soa_e, ec, es)

    h = np.full(len(pos), 0.2, np.float32)
    fields = _t(pos, vel, mass, h, *_hydro_fields(3, pos, gas_mask),
                gas_mask)
    rec = _recorded(tsb.hydro_force_blocks_entries, tcls, *fields, ec, es,
                    box=C_BOX, **HKW)
    soa_a, soa_b, *_ = tsb.pack_hydro_blocks(
        tcls, *fields, box=C_BOX, hubble_a2_flow=HKW["hubble_a2_flow"],
        fac_mu=HKW["fac_mu"])
    tgt16 = rec["sph_hydro_entries"][0]
    _assert_slots_equal(tgt16, torch.cat([soa_a, soa_b], 1), ec, es)


# ---------------------------------------------------------------------------
# (e) kernel G excludes the self-pair by particle index
# ---------------------------------------------------------------------------
def test_hydro_entries_isolated_particle_has_no_signal():
    """A gas particle with no neighbour inside its support has
    max_signal_vel == 0 exactly: kept, its own pair (r = rounding in
    relative coordinates) would give 2 c_i through the max."""
    pos, vel, mass, _, gas_mask, _ = _small_sph(6)
    lone = 0
    d = np.abs(pos - pos[lone])
    d = np.minimum(d, C_BOX - d)
    near = (np.sqrt((d ** 2).sum(1)) < 0.3) & (np.arange(len(pos)) != lone)
    keep = ~near
    pos, vel, mass, gas_mask = pos[keep], vel[keep], mass[keep], \
        gas_mask[keep]
    tcls = tsb.build_block_lists(*_t(pos, gas_mask), 0.0, C_BOX, C_NB,
                                 S_SUBCAP)
    active = np.zeros(len(pos), bool)
    active[lone] = True
    ec, es, _ = cells.build_active_entries(tcls[0], torch.from_numpy(active),
                                           LANES, C_KMAX)
    h = np.full(len(pos), 0.2, np.float32)
    fields = _t(pos, vel, mass, h, *_hydro_fields(3, pos, gas_mask),
                gas_mask)
    res = tsb.hydro_force_blocks_entries(tcls, *fields, ec, es, box=C_BOX,
                                         **HKW)
    assert float(fields[5][lone]) > 0       # a sound speed to leak
    assert float(res.max_signal_vel[lone]) == 0.0
    assert not res.acc[lone].any()


def test_hydro_entries_self_pair_excluded_by_int_index():
    """As kernel D's test: shifting every index by 2^24 changes nothing,
    while float32 ids (exact only below 2^24) merge neighbouring indices
    and drop real pairs. Every gas particle is a target here, so that
    some merged index pairs are neighbours."""
    pos, vel, mass, _, gas_mask, tcls = _small_sph(5)
    ec, es, total = cells.build_active_entries(
        tcls[0], torch.from_numpy(gas_mask), LANES, 256)
    assert int(total) <= 256
    h = np.full(len(pos), 0.2, np.float32)
    fields = _t(pos, vel, mass, h, *_hydro_fields(3, pos, gas_mask),
                gas_mask)
    rec = _recorded(tsb.hydro_force_blocks_entries, tcls, *fields, ec, es,
                    box=C_BOX, **HKW)
    tgt16, tidx, src16, idx_o, eblk, params, nb, lf, visc = \
        rec["sph_hydro_entries"]

    def sums(ti, io):
        return tsb.hydro_sums_blocks_entries(tgt16, ti, src16, io, eblk,
                                             params, nb, lf, visc)

    def shifted(idx, to_f32=False):
        big = torch.where(idx >= 0, idx + 2 ** 24, idx)
        return big.float().int() if to_f32 else big

    base = sums(tidx, idx_o)
    torch.testing.assert_close(sums(shifted(tidx), shifted(idx_o)), base,
                               rtol=0, atol=0)
    assert not torch.equal(sums(shifted(tidx, True), shifted(idx_o, True)),
                           base)


@pytest.mark.parametrize("n_active,n_entries,took,counted", [
    (8 * 100 + 1, 1, False, False),   # over the pre-gate: never counted
    (8 * 100, 101, False, True),      # entries do not fit
    (8 * 100, 100, True, True),
    (0, 0, True, True),
])
def test_tier_rule_counts_entries_only_past_pre_gate(n_active, n_entries,
                                                     took, counted):
    """forces.use_entries with k_max = 100: n_active <= 8 k_max, then the
    entry count <= k_max [JAX forces.py:285-290]; the count is taken only
    when the first test passes."""
    from gadget_leicester_tpu_torch.models.forces import use_entries
    calls = []

    def count():
        calls.append(1)
        return torch.tensor(n_entries)
    assert use_entries(torch.tensor(n_active), count, 100) is took
    assert bool(calls) is counted


# ---------------------------------------------------------------------------
# (f) the model of kernel F's walk keeps every pair inside the support
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("subcap", [32, 64])
@pytest.mark.parametrize("periodic", [True, False])
def test_walk_model_of_kernel_f_keeps_every_pair_inside_the_support(
        periodic, subcap):
    """chip_smoke.entries_density_walk, the model of kernel F's culling
    (csrc/sph_density_entries.cu: 32-slot chunk boxes of the sources with
    m > 0, the box of a warp's live lanes with the reach of their largest
    h), on the smaller SPH box's gas on its periodic grid (relative
    coordinates) or on a clamped one over the same cube (absolute), with
    coordinates equal to the box among the active gas and an entry with
    one live lane, on the arguments the Newton loop gives kernel F with
    every entry on. Every pair of a live lane with h > 0 and a source with
    m > 0 inside the support (r < h, or r (1/h) < 1 in float32 as the
    kernel takes u) is walked, and the walk leaves out some pairs."""
    import chip_smoke
    pos, vel, mass, h0, gas_mask = _sph_setup(11 + subcap, n=900, box=C_BOX)
    pos[:3] = [[C_BOX, 1.0, 1.0], [0.0, C_BOX, 0.5], [C_BOX, C_BOX, C_BOX]]
    active = _sph_active("spread", pos, gas_mask, C_BOX)
    active[:3] = True
    tcls = tsb.build_block_lists(*_t(pos, gas_mask), 0.0, C_BOX, C_NB,
                                 subcap, periodic=periodic)
    assert not bool(tcls[0].overflow)
    # particle 0 alone active in its even block: an entry of one live lane
    blk = (tcls[0].gslot // (8 * subcap)).numpy()
    active &= (blk != blk[0]) | (np.arange(len(pos)) == 0)
    ec, es, _ = cells.build_active_entries(tcls[0], torch.from_numpy(active),
                                           LANES, C_KMAX)
    assert int(((es >= 0).sum(1) == 1).sum()) > 0
    rec = _recorded(tsb.density_adaptive_blocks_entries,
                    *_t(pos, vel, mass, h0, gas_mask), ec, es, box=C_BOX,
                    cls=tcls, max_hsml=C_MAXH, **DKW)
    name = "sph_density_entries" if periodic else "sph_density_entries_abs"
    soa_o, tgt, h, _, nb, lf = rec[name]
    args = (soa_o, tgt, h, ec, nb, lf)
    e = torch.nonzero(ec >= 0).flatten()
    live, walked = chip_smoke.entries_density_walk(args, e)
    ids, units = tsb.odd_sources(nb, ec[e].long(), periodic)
    rows, shift = tsb._gather_sources(soa_o, ids, units, lf, (0, 1, 2, 3))
    r = tsb._pair_geometry(tgt[e], rows, shift)[3]
    hl = h[e][:, :, None]
    support = ((r < hl) | (r * (1.0 / hl) < 1.0)) & (hl > 0)
    pair = live[..., None] & (rows[3] > 0)[:, None, :]
    assert int((pair & support).sum()) > 0
    assert not bool((pair & support & ~walked).any())
    assert int((pair & walked).sum()) < int(pair.sum())


@pytest.mark.parametrize("with_potential", [False, True])
@pytest.mark.parametrize("mode", ["wrap", "spread"])
def test_walk_model_of_kernel_e_keeps_every_pair_inside_rcut(mode,
                                                              with_potential):
    """chip_smoke.entries_gravity_walk, the model of kernel E's culling
    (csrc/shortrange_gravity_entries.cu: the 32-slot chunks of the
    stencil cells whose box lies within rcut of the box of the entry's
    live lanes and, in those, the sources with m != 0 within rcut,
    shifted as E takes dx = t - (s + shift)), on the arguments
    gravity_entries gives E in either mode, the gravity setup's targets across the periodic wrap at x
    = 0 ("wrap") or spread over the box, with an entry of one live lane.
    Every pair of a live lane and a source with m != 0 at 0 < r2 <
    rcut^2 (float32, as the kernel takes it: the support of the force and
    of the potential alike) is walked, and the walk leaves out some
    pairs."""
    import chip_smoke
    from gadget_leicester_tpu_torch.ops.gravity_short import stencil_sources
    pos, mass, soft, alive = _grav_setup()
    active = _grav_active(mode, pos, alive)
    tp, tm, ts, ta, tact = _t(pos, mass, soft, alive, active)
    cl = build_cell_list(tp, ta, 0.0, G_BOX, G_CELLS, G_CAP)
    soa = cells.pack_cells_soa(cl, tp, tm, ts, ta)
    ec, es, _ = cells.build_active_entries(cl, tact, LANES, G_KMAX)
    assert int(((es >= 0).sum(1) == 1).sum()) > 0
    name = ("shortrange_potential_entries" if with_potential
            else "shortrange_gravity_entries")
    rec = _recorded(cells.gravity_entries, cl, soa, ec, es, tp, tm, ts, ta,
                    G_BOX, ASMTH, RCUT, with_potential)
    args = rec[name]
    _, entry_cell, tgt, n, box, _, rcut = args
    e = torch.nonzero(entry_cell >= 0).flatten()
    live, walked = chip_smoke.entries_gravity_walk(args, e)
    ids, offs = stencil_sources(n, entry_cell[e].long())
    sh = offs.float() * torch.tensor(box / n, dtype=torch.float32)
    s = soa[ids]
    d2 = 0.0
    for a in range(3):
        sa = (s[:, :, a] + sh[None, :, a, None]).flatten(1)
        d = tgt[e][:, a, :, None] - sa[:, None, :]
        d2 = d2 + d * d
    rcut2 = torch.tensor(rcut * rcut, dtype=torch.float32)
    pair = live[..., None] & (s[:, :, 3] != 0).flatten(1)[:, None, :]
    in_cut = pair & (d2 > 0) & (d2 < rcut2)
    assert int(in_cut.sum()) > 0
    assert not bool((in_cut & ~walked).any())
    assert int((pair & walked).sum()) < int(pair.sum())


@pytest.mark.parametrize("subcap", [32, 64])
@pytest.mark.parametrize("periodic", [True, False])
def test_walk_model_of_kernel_g_keeps_every_pair_inside_the_support(
        periodic, subcap):
    """chip_smoke.entries_hydro_walk, the model of kernel G's culling
    (csrc/sph_hydro_entries.cu: 32-slot chunk boxes of the valid sources
    with their largest h, the box of a warp's live lanes with the reach
    max(their largest h, the chunk's or the source's h)), on the smaller
    SPH box's gas on its periodic grid (relative coordinates) or on a
    clamped one over the same cube (absolute), on the arguments
    hydro_force_blocks_entries gives kernel G. The gas holds coordinates
    equal to the box, an entry of one live lane, and active targets of h
    0.1 whose only neighbour within reach is an inactive source of h 0.3
    at 0.3 (1 -+ 1e-5) (across the periodic wrap on the periodic grid).
    Every pair of a live lane and a valid source other than itself with r
    < max(h_i, h_j), the source's own h among them, is walked, and the
    walk leaves out some pairs."""
    import chip_smoke
    pos, vel, mass, _, gas_mask = _sph_setup(41 + subcap, n=900, box=C_BOX)
    h = np.full(len(pos), 0.2, np.float32)
    pos[:3] = [[C_BOX, 1.0, 1.0], [0.0, C_BOX, 0.5], [C_BOX, C_BOX, C_BOX]]
    # targets 3 and 5 (h 0.1) with a source of h 0.3 at 0.3 (1 -+ 1e-5)
    # in -x: across x = 0 on the periodic grid; the other gas within 0.45
    # of them made dark matter
    special = np.array([[0.05, 1.25, 0.25], [0.05, 1.25, 0.25],
                        [0.05, 0.25, 1.25], [0.05, 0.25, 1.25]], np.float32)
    for i, sign in ((0, -1.0), (2, 1.0)):
        special[i + 1, 0] = np.float32(
            (0.05 - 0.3 * (1.0 + sign * 1e-5)) % C_BOX) if periodic else \
            np.float32(0.05 + 0.3 * (1.0 + sign * 1e-5))
    pos[3:7] = special
    h[3:7] = [0.1, 0.3, 0.1, 0.3]
    near = np.zeros(len(pos), bool)
    for c in special:
        d = np.abs(pos - c)
        if periodic:
            d = np.minimum(d, C_BOX - d)
        near |= np.sqrt((d ** 2).sum(1)) < 0.45
    near[:7] = False
    gas_mask &= ~near
    active = _sph_active("spread", pos, gas_mask, C_BOX)
    active[:7] = [True, True, True, True, False, True, False]
    tcls = tsb.build_block_lists(*_t(pos, gas_mask), 0.0, C_BOX, C_NB,
                                 subcap, periodic=periodic)
    assert not bool(tcls[0].overflow)
    # particle 0 alone active in its even block: an entry of one live lane
    blk = (tcls[0].gslot // (8 * subcap)).numpy()
    active &= (blk != blk[0]) | (np.arange(len(pos)) == 0)
    assert active[[3, 5]].all()
    ec, es, _ = cells.build_active_entries(tcls[0], torch.from_numpy(active),
                                           LANES, C_KMAX)
    assert int(((es >= 0).sum(1) == 1).sum()) > 0
    fields = (pos, vel, mass, h, *_hydro_fields(43, pos, gas_mask), gas_mask)
    rec = _recorded(tsb.hydro_force_blocks_entries, tcls, *_t(*fields), ec,
                    es, box=C_BOX, **HKW)
    name = "sph_hydro_entries" if periodic else "sph_hydro_entries_abs"
    args = rec[name]
    tgt16, tidx, src16, idx_o, _, _, nb, lf, _ = args
    e = torch.nonzero(ec >= 0).flatten()
    live, walked = chip_smoke.entries_hydro_walk(args, e)
    ids, units = tsb.odd_sources(nb, ec[e].long(), periodic)
    rows, shift = tsb._gather_sources(src16, ids, units, lf, (0, 1, 2, 7, 12))
    r = tsb._pair_geometry(tgt16[e], rows, shift)[3]
    ht, hs = tgt16[e][:, 7, :, None], rows[3][:, None, :]
    support = r < torch.maximum(ht, hs)
    if periodic:
        other = tidx[e][:, :, None] != idx_o[ids].flatten(1)[:, None, :]
    else:
        other = r > 0.0
    pair = live[..., None] & (rows[4] > 0)[:, None, :] & other
    assert int((pair & support).sum()) > 0
    assert not bool((pair & support & ~walked).any())
    assert int((pair & walked).sum()) < int(pair.sum())
    # the sources' own h is the only reach of some pairs, and those are
    # walked
    own = pair & support & ~(r < ht)
    assert int(own.sum()) > 0 and bool(walked[own].all())


# ---------------------------------------------------------------------------
# (g) chip_smoke's bound and recorder of kernel F
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("periodic", [True, False])
def test_kernel_f_bound_counts_only_the_sources_its_entries_reach(periodic):
    """chip_smoke.entries_bytes on the arguments the Newton loop gives
    kernel F: the 7 rows F reads of each odd block that a switched-on
    entry reaches, each block once, plus tgt, h and entry_blk whole; with
    one entry on, its 8 odd blocks; with none, no source block."""
    import chip_smoke
    pos, vel, mass, h0, gas_mask = _sph_setup(29, n=900, box=C_BOX)
    active = _sph_active("spread", pos, gas_mask, C_BOX)
    tcls = tsb.build_block_lists(*_t(pos, gas_mask), 0.0, C_BOX, C_NB, 32,
                                 periodic=periodic)
    ec, es, _ = cells.build_active_entries(tcls[0], torch.from_numpy(active),
                                           LANES, C_KMAX)
    rec = _recorded(tsb.density_adaptive_blocks_entries,
                    *_t(pos, vel, mass, h0, gas_mask), ec, es, box=C_BOX,
                    cls=tcls, max_hsml=C_MAXH, **DKW)
    name = "sph_density_entries" if periodic else "sph_density_entries_abs"
    soa_o, tgt, h, _, nb, lf = rec[name]
    small = sum(a.numel() * a.element_size() for a in (tgt, h, ec))
    block = 7 * soa_o.shape[2] * 4
    on = torch.nonzero(ec >= 0).flatten()
    assert on.numel() > 1
    one = torch.full_like(ec, -1)
    one[on[0]] = ec[on[0]]
    reached = tsb.odd_sources(nb, ec[on].long(), periodic)[0].unique()
    for blk, blocks in ((ec, reached.numel()), (one, 8),
                        (torch.full_like(ec, -1), 0)):
        args = (soa_o, tgt, h, blk, nb, lf)
        assert chip_smoke.entries_bytes(name, args) == small + blocks * block
    assert reached.numel() <= soa_o.shape[0]


def test_kernel_e_bound_counts_only_the_rows_a_design_needs():
    """chip_smoke.entries_bytes of kernel E (either mode) on the arguments
    gravity_entries gives it: of the cells its switched-on entries reach,
    the mass of every slot, x, y, z of the slots with m != 0, and soft and
    1/soft of those within rcut of a live lane of an entry reaching them,
    plus entry_cell and tgt whole; with no entry on, only those two. The
    rule of PRs 11-12 (six rows of every slot of every reached cell)
    counts more."""
    import chip_smoke
    from gadget_leicester_tpu_torch.ops.gravity_short import stencil_sources
    pos, mass, soft, alive = _grav_setup()
    active = _grav_active("spread", pos, alive)
    tp, tm, ts, ta, tact = _t(pos, mass, soft, alive, active)
    cl = build_cell_list(tp, ta, 0.0, G_BOX, G_CELLS, G_CAP)
    soa = cells.pack_cells_soa(cl, tp, tm, ts, ta)
    ec, es, _ = cells.build_active_entries(cl, tact, LANES, G_KMAX)
    args = _recorded(cells.gravity_entries, cl, soa, ec, es, tp, tm, ts, ta,
                     G_BOX, ASMTH, RCUT)["shortrange_gravity_entries"]
    tgt = args[2]
    small = (ec.numel() + tgt.numel()) * 4
    on = torch.nonzero(ec >= 0).flatten()
    ids, offs = stencil_sources(G_CELLS, ec[on].long())
    reached = ids.unique()
    # the sources within rcut of a live lane, by an explicit loop
    need = set()
    edge = G_BOX / G_CELLS
    for row, e in enumerate(on.tolist()):
        for j in range(27):
            c = int(ids[row, j])
            for k in range(G_CAP):
                if float(soa[c, 3, k]) == 0.0:
                    continue
                s = soa[c, :3, k] + offs[j].float() * edge
                d2 = ((tgt[e, :3] - s[:, None]) ** 2).sum(0)
                hit = (d2 < RCUT * RCUT) & (d2 > 0) & (tgt[e, 5] > 0)
                if bool(hit.any()):
                    need.add((c, k))
    packed = int((soa[reached, 3] != 0).sum())
    want = small + 4 * (reached.numel() * G_CAP + 3 * packed + 2 * len(need))
    assert chip_smoke.entries_bytes("shortrange_gravity_entries", args) \
        == want
    assert chip_smoke.entries_bytes("shortrange_potential_entries",
                                    args) == want
    assert want < small + 6 * reached.numel() * G_CAP * 4
    none = (args[0], torch.full_like(ec, -1)) + args[2:]
    assert chip_smoke.entries_bytes("shortrange_gravity_entries",
                                    none) == small


def test_busiest_entries_keeps_the_sync_point_of_the_most_live_lanes():
    """chip_smoke.busiest_entries keeps, cloned, F's first call and G's
    call of the entries-tier sync point whose switched-on entries hold the
    most live lanes (the first of equals), and every such count."""
    import chip_smoke
    from gadget_leicester_tpu_torch import kernels
    f, g = "sph_density_entries_abs", "sph_hydro_entries_abs"

    def g_args(lanes, off=False):
        tgt16 = torch.zeros(3, 16, LANES)
        tgt16[0, 12, :lanes] = 1.0
        blk = torch.tensor([-1 if off else 0, 1, -1], dtype=torch.int32)
        return (tgt16, None, None, None, blk)

    with chip_smoke.busiest_entries(f, g) as kept:
        for sweeps, lanes, off in ((2, 3, False), (3, 5, False),
                                   (1, 5, False), (1, 7, True)):
            for s in range(sweeps):
                kernels.note_call(f, (torch.tensor([lanes, s]),))
            args = g_args(lanes, off)
            kernels.note_call(g, args)
            args[0].fill_(0.0)        # a later pass reuses the buffer
    assert kept["lanes"] == [3, 5, 5, 0]
    assert torch.equal(kept["args"][f][0], torch.tensor([5, 0]))
    assert int(kept["args"][g][0][0, 12].sum()) == 5
