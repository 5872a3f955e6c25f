"""The cell-window PM gather (ops/pm_tiles.py, kernel L): the port's path
through the plain version against the JAX package's Pallas gather in
interpret mode (``pm_gather_tiles(..., interpret=True)``) and against the
row gather, on the cases of tests/test_pm_tiles.py: fresh cells at two
margins, stale cells with unwrapped positions across the periodic seam,
the K = 4 stack with the potential; and what the port pins: parked slots
give 0, a particle moved far beyond the margin is still exact, the window
geometry equals the reference's, and ``pm_forces_periodic(...,
return_field=True)`` gives the reference's mesh stack."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.ops import pm as jpm
from gadget_leicester_tpu.ops import pm_tiles as jpt
from gadget_leicester_tpu.ops.neighbors import build_cell_list as j_build
from gadget_leicester_tpu_torch.ops import pm as tpm
from gadget_leicester_tpu_torch.ops import pm_tiles as tpt
from gadget_leicester_tpu_torch.ops.cells import pack_cells_soa
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
    plain = tpt.pm_gather_tiles_plain(t[0], cl, t[2], t[3], BOX, N_PM,
                                      N_CELLS, margin_pm)
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
    """The [C, K, cap] output is 0 at every slot that holds no alive
    particle, whatever the mesh holds."""
    _, pos, alive, _ = _setup(5)
    field = torch.full((N_PM, N_PM, N_PM, 3), 7.0)
    one = torch.ones(len(pos))
    t_pos, t_alive = torch.from_numpy(pos), torch.from_numpy(alive)
    cl = build_cell_list(t_pos, t_alive, 0.0, BOX, n_cells=N_CELLS,
                         capacity=128)
    soa = pack_cells_soa(cl, t_pos, one, one, t_alive)
    out = tpt.pm_gather_windows(soa, field, N_CELLS, BOX, N_PM, 1.0)
    live = (cl.cells >= 0)[:, None, :].expand(-1, 3, -1)
    assert (out[~live] == 0).all()
    # a constant mesh interpolates to itself: the 8 weights sum to 1
    np.testing.assert_allclose(out[live].numpy(), 7.0, rtol=1e-6)
    assert int(live.sum()) == 3 * int(alive.sum())


def test_gather_refuses_wrong_shapes():
    soa = torch.zeros(27, 8, 128)
    with pytest.raises(ValueError):
        tpt.pm_gather_windows(soa, torch.zeros(8, 8, 8, 3), 4, 1.0, 8)
    with pytest.raises(ValueError):
        tpt.pm_gather_windows(soa, torch.zeros(8, 8, 8, 5), 3, 1.0, 8)
    with pytest.raises(ValueError):
        tpt.pm_gather_windows(soa, torch.zeros(8, 8, 9, 3), 3, 1.0, 8)


@pytest.mark.parametrize("n_pm,n_cells,margin_pm", [
    (32, 5, 0.5), (32, 5, 2.0), (192, 34, 0.08 * 4.5 * 1.25), (24, 3, 1.0)])
def test_window_geometry_equals_the_reference(n_pm, n_cells, margin_pm):
    assert tpt.window_geometry(n_pm, n_cells, margin_pm) == \
        jpt._window_geometry(n_pm, n_cells, margin_pm)


@pytest.mark.parametrize("with_potential", [False, True])
def test_mesh_stack_equals_the_reference(with_potential):
    """``pm_forces_periodic(return_field=True)`` against the JAX package's
    mesh stack, within 2e-5 of its largest value per component (two FFT
    libraries); the default call is the row gather of that stack."""
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
    # the stack through the cell-window gather equals the default call
    cl = build_cell_list(t[0], t[2], 0.0, BOX, n_cells=3, capacity=512)
    via = tpt.pm_gather_tiles(got, cl, t[0], t[2], BOX, n_pm, 3, 1.0)
    direct = tpm.pm_forces_periodic(*t, BOX, n_pm,
                                    with_potential=with_potential)
    if with_potential:
        direct = torch.cat([direct[0], direct[1][:, None]], -1)
    scale = float(direct.abs().max())
    assert float((via - direct).abs().max()) <= 2e-5 * scale
