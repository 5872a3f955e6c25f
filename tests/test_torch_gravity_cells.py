"""Short-range gravity over a fresh cell list in absolute coordinates
(ops/gravity_short.py :: shortrange_gravity_fresh, kernel M): the port,
through M's plain version, against the JAX package's Pallas kernel in
interpret mode (``shortrange_gravity_pallas(..., interpret=True)``),
periodic with the erfc truncation and on a clamped (vacuum) grid without
it; against direct sums with the exact truncation; and what the port
pins: the absolute pack, the particle on the box edge, the self-pair, an
overflow, the refusal of fewer than 3 cells an axis."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.ops import pallas_cells as jpc
from gadget_leicester_tpu.ops.neighbors import build_cell_list as j_build
from gadget_leicester_tpu_torch.ops import cells as tc
from gadget_leicester_tpu_torch.ops import gravity_short as gs
from gadget_leicester_tpu_torch.ops.gravity_direct import direct_gravity
from gadget_leicester_tpu_torch.ops.neighbors import build_cell_list

BOX = 10.0
# port against Pallas in interpret mode: the same float32 pair terms summed
# in another order, as a share of the largest |acc|
TOL_JAX = 2e-5
# against the direct sum: the degree-10 fit of the truncation (max error
# 6.5e-6 of a pair term) and float32 sums over ~100 pairs
TOL_DIRECT = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(seed, n, periodic):
    """Particles in the box (periodic) or a blob inside [0, BOX) (vacuum),
    unequal masses and softenings, a tenth not alive."""
    rng = np.random.default_rng(seed)
    if periodic:
        pos = rng.uniform(0, BOX, (n, 3))
    else:
        pos = 0.5 * BOX + 0.18 * BOX * rng.normal(size=(n, 3))
        pos = np.clip(pos, 0.01, BOX - 0.01)
    f = np.float32
    return dict(pos=pos.astype(f), mass=rng.uniform(0.5, 1.5, n).astype(f),
                soft=rng.uniform(0.05, 0.3, n).astype(f),
                alive=rng.uniform(size=n) > 0.1)


def _t(d):
    return [torch.from_numpy(d[k]) for k in ("pos", "mass", "soft", "alive")]


def _j(d):
    return [jnp.asarray(d[k]) for k in ("pos", "mass", "soft", "alive")]


# (periodic, cells an axis, capacity, particles, asmth, rcut): the cell
# edge is at least rcut, so the 27 cells hold every pair inside it
CASES = [(True, 4, 128, 1500, 0.5, 2.25), (True, 3, 128, 900, 0.7, 3.15),
         (True, 3, 256, 2000, 0.7, 3.15), (False, 4, 128, 1200, 0.0, 2.5),
         (False, 3, 256, 700, 0.0, 1e30)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"per{c[0]}-n{c[1]}-"
                         f"cap{c[2]}-asmth{c[4]}")
def test_fresh_matches_jax_pallas(case):
    periodic, n_cells, cap, n, asmth, rcut = case
    d = _setup(n_cells + cap, n, periodic)
    got, ovf = gs.shortrange_gravity_fresh(
        *_t(d), BOX, n_cells, capacity=cap, asmth=asmth, rcut=rcut,
        periodic=periodic)
    want, j_ovf = jpc.shortrange_gravity_pallas(
        *_j(d), BOX, n_cells, capacity=cap, asmth=asmth, rcut=rcut,
        periodic=periodic, interpret=True)
    want = np.asarray(want)
    assert not bool(ovf) and not bool(j_ovf)
    assert torch.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL_JAX * scale)
    assert (got.numpy()[~d["alive"]] == 0).all()


def test_absolute_pack_matches_jax():
    """``pack_cells_abs`` is the reference's ``pack_cells_soa(...,
    relative=False)`` bit for bit, parked slots included."""
    d = _setup(3, 900, True)
    cl = build_cell_list(*[_t(d)[i] for i in (0, 3)], 0.0, BOX, n_cells=3,
                         capacity=128)
    jcl = j_build(_j(d)[0], _j(d)[3], 0.0, BOX, n_cells=3, capacity=128,
                  periodic=True)
    got = tc.pack_cells_abs(cl, *_t(d))
    want = np.asarray(jpc.pack_cells_soa(jcl, *_j(d), relative=False))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("periodic", [True, False])
def test_fresh_matches_direct_sum(periodic):
    """Against the all-pairs sum with the exact truncation
    (``shortrange_trunc``) and the same cut: the stencil misses no pair
    inside rcut."""
    asmth, rcut, n_cells = (0.5, 2.25, 4) if periodic else (0.0, 2.5, 4)
    d = _setup(11, 1200, periodic)
    got, ovf = gs.shortrange_gravity_fresh(*_t(d), BOX, n_cells, asmth=asmth,
                                           rcut=rcut, periodic=periodic)
    want, _ = direct_gravity(*_t(d), box=BOX, asmth=asmth, rcut=rcut,
                             periodic=periodic, with_potential=False)
    assert not bool(ovf)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL_DIRECT * scale


def test_particle_on_the_box_edge_keeps_its_neighbours():
    """A coordinate equal to the box (a float64 position just below it,
    rounded to float32, as one of the 2x128^3 lcdm_gas ICs has) is filed in
    cell 0, a box away from the neighbours it sits among. The minimum
    image is taken per pair, so nothing is lost: the forces equal the
    Pallas kernel's and the all-pairs sum's."""
    d = _setup(9, 900, True)
    d["pos"][:3] = [[BOX, 1.0, 1.0], [0.0, BOX, 0.5], [BOX, BOX, BOX]]
    d["alive"][:3] = True
    n_cells, asmth, rcut = 3, 0.7, 3.15
    cl = build_cell_list(_t(d)[0], _t(d)[3], 0.0, BOX, n_cells=n_cells,
                         capacity=128)
    assert int(cl.cell_of[0]) // 9 == 0 and int(cl.cell_of[2]) == 0
    got, _ = gs.shortrange_gravity_fresh(*_t(d), BOX, n_cells, asmth=asmth,
                                         rcut=rcut)
    want, _ = jpc.shortrange_gravity_pallas(*_j(d), BOX, n_cells, asmth=asmth,
                                            rcut=rcut, interpret=True)
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL_JAX * scale)
    oracle, _ = direct_gravity(*_t(d), box=BOX, asmth=asmth, rcut=rcut,
                               periodic=True, with_potential=False)
    assert float((got - oracle).abs().max()) <= TOL_DIRECT * scale
    # the moved particles feel their neighbours across the seam
    assert float(got[:3].abs().amax(-1).min()) > 1e-3 * scale


def test_isolated_particle_has_zero_force():
    """Alone in its stencil a particle meets only its own pack slot, at
    r == 0 bit for bit, before and after the minimum image: the force is
    exactly 0, periodic (coordinates up to the box) and vacuum."""
    pos = torch.tensor([[9.999, 0.0, 5.0], [5.0, 5.0, 5.0]])
    one = torch.ones(2)
    alive = torch.ones(2, dtype=torch.bool)
    for periodic in (True, False):
        got, _ = gs.shortrange_gravity_fresh(pos, one, 0.1 * one, alive, BOX,
                                             5, asmth=0.4, rcut=1.8,
                                             periodic=periodic)
        assert (got == 0).all()
    # two particles in reach of each other do pull, equally and oppositely
    pos = torch.tensor([[9.9, 5.0, 5.0], [0.2, 5.0, 5.0]])
    got, _ = gs.shortrange_gravity_fresh(pos, one, 0.1 * one, alive, BOX, 5,
                                         asmth=0.4, rcut=1.8)
    assert float(got[0, 0]) > 0 and float(got[0, 0]) == -float(got[1, 0])
    # across the edge of a clamped grid they do not
    got, _ = gs.shortrange_gravity_fresh(pos, one, 0.1 * one, alive, BOX, 5,
                                         asmth=0.4, rcut=1.8, periodic=False)
    assert (got == 0).all()


def test_overflow_is_reported():
    d = _setup(13, 1500, True)
    t = _t(d)
    t[0][:200] = 5.0 + 0.1 * t[0][:200] / BOX      # 200 in one cell
    got, ovf = gs.shortrange_gravity_fresh(*t, BOX, 4, capacity=128,
                                           asmth=0.5, rcut=2.25)
    want, j_ovf = jpc.shortrange_gravity_pallas(
        jnp.asarray(t[0].numpy()), *_j(d)[1:], BOX, 4, capacity=128,
        asmth=0.5, rcut=2.25, interpret=True)
    assert bool(ovf) and bool(j_ovf)
    assert torch.isfinite(got).all()
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL_JAX * scale)


def test_wrapper_refuses_bad_input():
    soa = torch.zeros(8, 8, 128)
    with pytest.raises(ValueError, match="n_cells >= 3"):
        tc.shortrange_gravity_cells(soa, 2, BOX, True, 0.5, 2.0)
    with pytest.raises(ValueError):
        tc.shortrange_gravity_cells(torch.zeros(27, 7, 128), 3, BOX, True,
                                    0.5, 2.0)
    with pytest.raises(TypeError):
        tc.shortrange_gravity_cells(torch.zeros(27, 8, 128).double(), 3, BOX,
                                    True, 0.5, 2.0)
