"""Kernel B's plain version (ops/pm_tiles.py) against the JAX package's
pm_deposit_tiles in Pallas interpret mode and against both packages'
point-scatter cic_deposit; and the periodic PM force against the JAX
pm_forces_periodic."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.ops import pm as jpm
from gadget_leicester_tpu.ops.neighbors import build_cell_list as j_build
from gadget_leicester_tpu.ops.pm_tiles import pm_deposit_tiles as j_deposit
from gadget_leicester_tpu_torch.ops import pm
from gadget_leicester_tpu_torch.ops.cells import pack_cells_soa
from gadget_leicester_tpu_torch.ops.neighbors import build_cell_list
from gadget_leicester_tpu_torch.ops.pm_tiles import pm_deposit_tiles

BOX = 100.0
N_PM = 32
N_CELLS = 5


def _setup(seed, n=900):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
    alive = rng.uniform(size=n) > 0.1
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return pos, mass, alive


def _port_deposit(pos_build, pos, mass, alive):
    t = {k: torch.from_numpy(v) for k, v in
         dict(b=pos_build, p=pos, m=mass, a=alive).items()}
    cl = build_cell_list(t["b"], t["a"], 0.0, BOX, N_CELLS, 128)
    soa = pack_cells_soa(cl, t["p"], t["m"], torch.ones_like(t["m"]), t["a"])
    return pm_deposit_tiles(soa, N_CELLS, BOX, N_PM).numpy()


@pytest.mark.parametrize("stale", [False, True])
def test_deposit_matches_jax_tiles_and_scatter(stale):
    """Same CIC weights from the same cell-relative pack: 2e-5 of the
    largest mesh cell (float32 sums in another order), the tolerance of
    tests/test_pm_tiles.py. Stale: positions drift (across the periodic
    seam too) after the cell build, within a quarter cell."""
    pos, mass, alive = _setup(1)
    pos_now, margin_pm = pos, 1.0
    if stale:
        rng = np.random.default_rng(2)
        margin = 0.25 * BOX / N_CELLS
        pos_now = (pos + rng.uniform(-margin / 2, margin / 2, pos.shape)
                   ).astype(np.float32)
        margin_pm = margin * N_PM / BOX
    got = _port_deposit(pos, pos_now, mass, alive)
    jcl = j_build(jnp.asarray(pos), jnp.asarray(alive), 0.0, BOX,
                  n_cells=N_CELLS, capacity=128, periodic=True)
    want = np.asarray(j_deposit(jcl, jnp.asarray(pos_now),
                                jnp.asarray(mass), jnp.asarray(alive), BOX,
                                N_PM, N_CELLS, margin_pm=margin_pm,
                                interpret=True))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale)
    w_alive = np.where(alive, mass, 0.0).astype(np.float32)
    scatter = pm.cic_deposit(torch.from_numpy(np.mod(pos_now, BOX)),
                             torch.from_numpy(w_alive), BOX, N_PM).numpy()
    np.testing.assert_allclose(got, scatter, rtol=0, atol=2e-5 * scale)
    j_scatter = np.asarray(jpm.cic_deposit(jnp.asarray(np.mod(pos_now, BOX)),
                                           jnp.asarray(w_alive), BOX, N_PM))
    np.testing.assert_allclose(scatter, j_scatter, rtol=0,
                               atol=2e-5 * scale)
    # only alive mass lands on the mesh
    np.testing.assert_allclose(got.sum(), w_alive.sum(), rtol=1e-5)


def test_greens_function_matches():
    got = pm.greens_function(N_PM, BOX, "cpu").numpy()
    want = np.asarray(jpm.greens_function(N_PM, BOX, jpm.ASMTH))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("with_grid", [False, True])
def test_pm_forces_periodic_matches(with_grid):
    """cuFFT/pocketfft vs XLA's FFT and two gathers: 1e-5 of the largest
    |acc|. with_grid: the mesh comes from kernel B's plain version."""
    pos, mass, alive = _setup(3, n=2000)
    t = [torch.from_numpy(a) for a in (pos, mass, alive)]
    rho = None
    if with_grid:
        rho = torch.from_numpy(_port_deposit(pos, pos, mass, alive))
    got = pm.pm_forces_periodic(*t, BOX, N_PM, rho_grid=rho).numpy()
    want = np.asarray(jpm.pm_forces_periodic(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(alive), BOX, N_PM))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    assert not got[~alive].any()


def test_cic_gather_matches():
    rng = np.random.default_rng(8)
    field = rng.normal(size=(N_PM, N_PM, N_PM, 3)).astype(np.float32)
    pos = rng.uniform(-5, BOX + 5, (500, 3)).astype(np.float32)
    got = pm.cic_gather_vec(torch.from_numpy(field),
                            torch.from_numpy(np.mod(pos, BOX)), BOX, N_PM)
    want = jpm.cic_gather_vec(jnp.asarray(field),
                              jnp.asarray(np.mod(pos, BOX)), BOX, N_PM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_pm_potential_gathered_apart_equals_the_stack_gather():
    """with_potential gathers the force and the potential in one K = 4
    gather of the [n, n, n, 4] mesh stack; each equals its column of the
    CIC gather of that stack bit for bit, the force that of the
    force-only call (K = 3), and dead particles get 0."""
    pos, mass, alive = _setup(4, n=1500)
    t = [torch.from_numpy(a) for a in (pos, mass, alive)]
    acc, pot = pm.pm_forces_periodic(*t, BOX, N_PM, with_potential=True)
    stack = pm.pm_forces_periodic(*t, BOX, N_PM, with_potential=True,
                                  return_field=True)
    rows = pm.cic_gather_vec(stack, torch.remainder(t[0], BOX), BOX, N_PM)
    rows = torch.where(t[2][:, None], rows, torch.zeros_like(rows))
    assert torch.equal(acc, rows[:, :3]) and torch.equal(pot, rows[:, 3])
    assert torch.equal(acc, pm.pm_forces_periodic(*t, BOX, N_PM))
    assert not pot[~t[2]].any() and pot[t[2]].abs().min() > 0


def _stale_pack(seed, n_cells, n_pm, n=900, margin=None):
    """A short-range pack on an n_cells^3 grid built at ``pos`` and packed
    at positions moved by up to ``margin`` per axis (the grid cache's
    staleness margin of models/grids.py :: grav_grid_geometry unless
    given), with coordinates equal to the box and a mesh coordinate just
    below n_pm among them; returns (pack, positions now, alive mass)."""
    from gadget_leicester_tpu_torch.models.grids import SOFT_RCUT_FRAC
    if margin is None:
        rcut = pm.RCUT * pm.ASMTH * BOX / n_pm
        margin = max(BOX / n_cells - rcut, SOFT_RCUT_FRAC * rcut)
    pos, mass, alive = _setup(seed, n)
    rng = np.random.default_rng(seed + 1)
    now = pos + rng.uniform(-margin, margin, pos.shape).astype(np.float32)
    now[:3] = [[BOX, 0.5 * BOX, 0.5 * BOX], [0.0, BOX, BOX],
               [BOX * (1 - 1e-6), 1.0, BOX]]
    pos[:3] = np.mod(now[:3], BOX)
    alive[:3] = True
    t = {k: torch.from_numpy(v) for k, v in
         dict(b=pos, p=now, m=mass, a=alive).items()}
    cl = build_cell_list(t["b"], t["a"], 0.0, BOX, n_cells, 128)
    assert not bool(cl.overflow)
    soa = pack_cells_soa(cl, t["p"], t["m"], torch.ones_like(t["m"]), t["a"])
    return soa, now, np.where(alive, mass, 0.0).astype(np.float32)


@pytest.mark.parametrize("n_cells,n_pm", [(N_CELLS, N_PM), (3, 16)])
def test_deposit_plain_equals_cic_deposit_with_stale_slots(n_cells, n_pm):
    """Kernel B's plain version on a pack whose slots lie up to the grid
    cache's staleness margin outside their cells (and on the mesh wrap)
    equals ops/pm.py :: cic_deposit of the alive mass at the wrapped
    positions, within 2e-5 of the largest mesh cell (float32 sums in
    another order), and keeps the alive mass to float32 rounding."""
    from gadget_leicester_tpu_torch.ops.pm_tiles import \
        pm_deposit_tiles_plain
    soa, now, w_alive = _stale_pack(5, n_cells, n_pm)
    half = 0.5 * BOX / n_cells
    live = soa[:, 3] != 0
    beyond = (soa[:, :3].abs() > half).any(1) & live
    assert int(beyond.sum()) > 0           # slots outside their cells
    got = pm_deposit_tiles_plain(soa, n_cells, BOX, n_pm).numpy()
    want = pm.cic_deposit(torch.from_numpy(np.mod(now, BOX)),
                          torch.from_numpy(w_alive), BOX, n_pm).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(got.sum(dtype=np.float64),
                               w_alive.sum(dtype=np.float64), rtol=1e-5)


def test_kernel_b_bound_counts_only_the_rows_it_reads():
    """chip_smoke.deposit_bytes on kernel B's arguments: the mass of every
    slot and x, y, z and the packed flag of the packed ones (m != 0), each
    once; chip_smoke.kernel_bound adds the mesh, written once, and 44
    operations a packed slot."""
    import chip_smoke
    soa, _, w_alive = _stale_pack(6, N_CELLS, N_PM)
    args = (soa, N_CELLS, BOX, N_PM)
    packed = int(np.count_nonzero(w_alive))
    slots = soa.shape[0] * soa.shape[2]
    assert packed == int((soa[:, 3] != 0).sum()) and packed < slots
    assert chip_smoke.deposit_bytes(args) == 4 * (slots + 4 * packed)
    mesh = pm_deposit_tiles(*args)
    bound = chip_smoke.kernel_bound("pm_deposit", args, mesh)
    assert bound["bytes"] == 4 * (slots + 4 * packed) + 4 * N_PM ** 3
    assert bound["ops"] == packed * chip_smoke.OPS_PER_DEPOSIT
    empty = torch.zeros_like(soa)
    assert chip_smoke.deposit_bytes((empty,) + args[1:]) == 4 * slots
