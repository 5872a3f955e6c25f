"""The PM gather of kernel L (ops/pm.py :: cic_gather_vec, and its
cell-list entry ops/pm_tiles.py :: pm_gather_tiles): the port's path
through the plain version against the JAX package's Pallas gather in
interpret mode (``pm_gather_tiles(..., interpret=True)``) and against the
row gather, on the cases of tests/test_pm_tiles.py: fresh cells at two
margins, stale cells with unwrapped positions across the periodic seam,
the K = 4 stack with the potential; and what the port pins: dead
particles and particles in no cell give 0, a constant mesh interpolates to
itself, a particle moved far beyond the margin is still exact, the
wrapper refuses wrong shapes, the plain version equals the JAX package's
row gather for K = 1 to 4 on exact mesh planes and at u == n, the step's
PM gather goes through kernel L's wrapper once per PM step (K = 4 under
the in-step potential), and ``pm_forces_periodic(..., return_field=True)``
gives the reference's mesh stack."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.ops import pm as jpm
from gadget_leicester_tpu.ops import pm_tiles as jpt
from gadget_leicester_tpu.ops.neighbors import build_cell_list as j_build
from gadget_leicester_tpu_torch.ops import pm as tpm
from gadget_leicester_tpu_torch.ops import pm_tiles as tpt
from gadget_leicester_tpu_torch.ops.neighbors import build_cell_list

BOX = 100.0
N_PM = 32
N_CELLS = 5
# the same float32 products summed in another order (8 corners against the
# reference's one-hot contractions); tests/test_pm_tiles.py's tolerance
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(seed, n=900, dead_frac=0.1, k=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
    alive = rng.uniform(size=n) > dead_frac
    field = rng.normal(size=(N_PM, N_PM, N_PM, k)).astype(np.float32)
    return rng, pos, alive, field


def _both(field, pos_build, pos_now, alive, margin_pm):
    """(port through the plain version, port's wrapper on CPU tensors, JAX
    Pallas gather in interpret mode, row gather) on one cell list built at
    ``pos_build`` and read at ``pos_now``."""
    t = [torch.from_numpy(a) for a in (field, pos_build, pos_now, alive)]
    cl = build_cell_list(t[1], t[3], 0.0, BOX, n_cells=N_CELLS, capacity=128)
    plain = tpm.cic_gather_vec_plain(t[0], torch.remainder(t[2], BOX), BOX,
                                     N_PM)
    plain = torch.where((t[3] & (cl.gslot >= 0))[:, None], plain,
                        torch.zeros_like(plain))
    wrapped = tpt.pm_gather_tiles(t[0], cl, t[2], t[3], BOX, N_PM, N_CELLS,
                                  margin_pm)
    jcl = j_build(jnp.asarray(pos_build), jnp.asarray(alive), 0.0, BOX,
                  n_cells=N_CELLS, capacity=128, periodic=True)
    want = jpt.pm_gather_tiles(jnp.asarray(field), jcl, jnp.asarray(pos_now),
                               jnp.asarray(alive), BOX, N_PM, N_CELLS,
                               margin_pm=margin_pm, interpret=True)
    rows = tpm.cic_gather_vec(t[0], torch.remainder(t[2], BOX), BOX, N_PM)
    rows = torch.where(t[3][:, None], rows, torch.zeros_like(rows))
    return plain.numpy(), wrapped.numpy(), np.asarray(want), rows.numpy()


@pytest.mark.parametrize("margin_pm", [0.5, 2.0])
def test_gather_matches_jax_and_rowgather(margin_pm):
    _, pos, alive, field = _setup(1)
    plain, wrapped, want, rows = _both(field, pos, pos, alive, margin_pm)
    np.testing.assert_array_equal(plain, wrapped)   # CPU tensors: the plain
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_allclose(plain, rows, **TOL)
    assert (plain[~alive] == 0).all()


def test_gather_stale_cells_and_wrap():
    """Positions drift (also across the periodic seam, unwrapped) after
    the cell build."""
    rng, pos, alive, field = _setup(2)
    margin = 0.25 * BOX / N_CELLS
    newpos = pos + rng.uniform(-margin / 2, margin / 2, pos.shape).astype(
        np.float32)
    assert (newpos < 0).any() and (newpos >= BOX).any()
    plain, _, want, rows = _both(field, pos, newpos, alive,
                                 margin * N_PM / BOX)
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_allclose(plain, rows, **TOL)


def test_gather_with_potential_column():
    """K = 4: (fx, fy, fz, phi), the with_potential stack."""
    _, pos, alive, field = _setup(3, k=4)
    plain, _, want, rows = _both(field, pos, pos, alive, 1.0)
    assert plain.shape == (len(pos), 4)
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_allclose(plain, rows, **TOL)


def test_particle_beyond_the_margin_is_still_exact():
    """The reference clamps a slot whose corners leave its window to a
    wrong corner; the port reads the mesh itself there. Particles moved
    by up to two cells after the build (the margin covers a tenth of
    one) still get the row gather's values."""
    rng, pos, alive, field = _setup(4)
    cell = BOX / N_CELLS
    newpos = pos + rng.uniform(-2 * cell, 2 * cell, pos.shape).astype(
        np.float32)
    t = [torch.from_numpy(a) for a in (field, pos, newpos, alive)]
    cl = build_cell_list(t[1], t[3], 0.0, BOX, n_cells=N_CELLS, capacity=128)
    got = tpt.pm_gather_tiles(t[0], cl, t[2], t[3], BOX, N_PM, N_CELLS,
                              0.1 * cell * N_PM / BOX)
    rows = tpm.cic_gather_vec(t[0], torch.remainder(t[2], BOX), BOX, N_PM)
    rows = torch.where(t[3][:, None], rows, torch.zeros_like(rows))
    np.testing.assert_allclose(got.numpy(), rows.numpy(), **TOL)


def test_parked_slots_give_zero():
    """Dead particles and alive ones that sit in no cell of the list (left
    out of its build) get 0 rows, whatever the mesh holds; a constant mesh
    interpolates to itself at every other particle (the 8 weights sum to
    1)."""
    _, pos, alive, _ = _setup(5)
    field = torch.full((N_PM, N_PM, N_PM, 3), 7.0)
    t_pos, t_alive = torch.from_numpy(pos), torch.from_numpy(alive)
    listed = t_alive.clone()
    listed[::7] = False
    cl = build_cell_list(t_pos, listed, 0.0, BOX, n_cells=N_CELLS,
                         capacity=128)
    out = tpt.pm_gather_tiles(field, cl, t_pos, t_alive, BOX, N_PM, N_CELLS,
                              1.0)
    keep = t_alive & listed
    assert int((t_alive & ~listed).sum()) > 0
    assert (out[~keep] == 0).all()
    np.testing.assert_allclose(out[keep].numpy(), 7.0, rtol=1e-6)


def test_gather_refuses_wrong_shapes():
    """Kernel L's wrapper takes a [n, n, n, K] mesh of K = 1 to 4, float32
    or float64, positions [N, 3] of the same type, and meshes of at most
    MAX_GATHER_MESH cells a side."""
    pos = torch.zeros(10, 3)
    with pytest.raises(ValueError):
        tpm.cic_gather_vec(torch.zeros(8, 8, 9, 3), pos, 1.0, 8)
    with pytest.raises(ValueError):
        tpm.cic_gather_vec(torch.zeros(8, 8, 8, 5), pos, 1.0, 8)
    with pytest.raises(ValueError):
        tpm.cic_gather_vec(torch.zeros(8, 8, 8), pos, 1.0, 8)
    with pytest.raises(ValueError):
        tpm.cic_gather_vec(torch.zeros(8, 8, 8, 3), torch.zeros(10, 2), 1.0,
                           8)
    with pytest.raises(TypeError):
        tpm.cic_gather_vec(torch.zeros(8, 8, 8, 3), pos.double(), 1.0, 8)
    with pytest.raises(TypeError):
        tpm.cic_gather_vec(torch.zeros(8, 8, 8, 3, dtype=torch.int32), pos,
                           1.0, 8)
    n = tpm.MAX_GATHER_MESH + 1
    with pytest.raises(ValueError):
        tpm.cic_gather_vec(torch.zeros(1, 1, 1, 1).expand(n, n, n, 1), pos,
                           1.0, n)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_cic_gather_plain_matches_jax(k):
    """Kernel L's plain version against the JAX package's
    ``ops/pm.py :: cic_gather_vec`` on wrapped positions that include
    exact mesh planes, the last plane (u = n - 1), and u == n (a float32
    coordinate equal to the box, index 0 with frac 0): the same float32
    weights and corners, summed in another order, within 1e-6 of the
    largest |value|."""
    rng = np.random.default_rng(20 + k)
    field = rng.normal(size=(N_PM, N_PM, N_PM, k)).astype(np.float32)
    pos = rng.uniform(0, BOX, (600, 3)).astype(np.float32)
    cell = BOX / N_PM
    pos[:40] = rng.integers(0, N_PM, (40, 3)) * cell          # mesh planes
    pos[40:60, 0] = (N_PM - 1) * cell
    pos[60:80] = BOX                                            # u == n
    pos[80:100, 1] = BOX
    pos = np.float32(pos)
    assert (pos * np.float32(N_PM / BOX) == N_PM).any()
    got = tpm.cic_gather_vec_plain(torch.from_numpy(field),
                                   torch.from_numpy(pos), BOX, N_PM).numpy()
    want = np.asarray(jpm.cic_gather_vec(jnp.asarray(field),
                                         jnp.asarray(pos), BOX, N_PM))
    assert got.shape == (len(pos), k)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    # u == n reads the corner at index 0 with weight 1 on it
    np.testing.assert_array_equal(got[60:80], np.broadcast_to(
        field[0, 0, 0], (20, k)))
    # the wrapper on CPU tensors is the plain version
    assert np.array_equal(got, tpm.cic_gather_vec(
        torch.from_numpy(field), torch.from_numpy(pos), BOX, N_PM).numpy())


@pytest.mark.parametrize("sinks", [False, True])
def test_step_pm_gather_goes_through_kernel_l(sinks, monkeypatch):
    """On the step, every PM force pass gathers once through kernel L's
    wrapper (``ops/pm.py :: cic_gather_vec``): the three force components
    (K = 3), or with the in-step potential (sinks) the force and the mesh
    potential together (K = 4); no other gather runs in the step."""
    from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                        parse_parameter_text)
    from gadget_leicester_tpu_torch.models import forces
    from gadget_leicester_tpu_torch.models.ics import lcdm_gas_ics
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    from tests.test_instep_potential import BOX as SBOX
    from tests.test_instep_potential import PARAM
    gathers, passes = [], []
    real_gather, real_pass = tpm.cic_gather_vec, forces.pm_forces_periodic

    def gather(field, pos, box, n):
        gathers.append(field.shape[-1])
        return real_gather(field, pos, box, n)

    def pm_pass(*args, **kw):
        passes.append(kw.get("with_potential", False))
        return real_pass(*args, **kw)

    monkeypatch.setattr(tpm, "cic_gather_vec", gather)
    monkeypatch.setattr(forces, "pm_forces_periodic", pm_pass)
    cfg = parse_parameter_text(PARAM)
    pos, vel, mass, ptype, u = lcdm_gas_ics(
        n_side=6, box=SBOX, omega0=0.3, omega_b=0.04,
        hubble=cfg.hubble_internal, g=cfg.grav_internal)
    sim = Simulation(cfg, SimOptions(periodic=True, pmgrid=16,
                                     gravity_mode="treepm", sinks=sinks),
                     "cpu")
    sim.set_ics(pos, vel, mass, ptype, u=u)
    sim.step(2)
    assert len(passes) >= 2 and passes == [sinks] * len(passes)
    assert gathers == [4 if sinks else 3] * len(passes)


@pytest.mark.parametrize("with_potential", [False, True])
def test_mesh_stack_equals_the_reference(with_potential):
    """``pm_forces_periodic(return_field=True)`` against the JAX package's
    mesh stack, within 2e-5 of its largest value per component (two FFT
    libraries); the default call is kernel L's gather of that stack."""
    rng = np.random.default_rng(6)
    n, n_pm = 600, 16
    pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.1
    t = [torch.from_numpy(a) for a in (pos, mass, alive)]
    got = tpm.pm_forces_periodic(*t, BOX, n_pm, return_field=True,
                                 with_potential=with_potential)
    want = np.asarray(jpm.pm_forces_periodic(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(alive), BOX, n_pm,
        return_field=True, with_potential=with_potential))
    assert got.shape == (n_pm, n_pm, n_pm, 4 if with_potential else 3)
    for k in range(got.shape[-1]):
        scale = np.abs(want[..., k]).max()
        assert np.abs(got[..., k].numpy() - want[..., k]).max() <= 2e-5 * scale
    # the stack through the cell-list gather equals the default call
    cl = build_cell_list(t[0], t[2], 0.0, BOX, n_cells=3, capacity=512)
    via = tpt.pm_gather_tiles(got, cl, t[0], t[2], BOX, n_pm, 3, 1.0)
    direct = tpm.pm_forces_periodic(*t, BOX, n_pm,
                                    with_potential=with_potential)
    if with_potential:
        direct = torch.cat([direct[0], direct[1][:, None]], -1)
    scale = float(direct.abs().max())
    assert float((via - direct).abs().max()) <= 2e-5 * scale
