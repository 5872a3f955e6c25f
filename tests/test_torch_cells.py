"""Kernel A's plain version (ops/gravity_short.py, through the wrapper in
ops/cells.py) against the JAX package's shortrange_gravity_pallas_dma9 in
relative mode, run in Pallas interpret mode on the CPU; and the cell list
against the JAX build_cell_list."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.ops import softening as jsoft
from gadget_leicester_tpu.ops.neighbors import build_cell_list as j_build
from gadget_leicester_tpu.ops.pallas_cells import \
    shortrange_gravity_pallas_dma9
from gadget_leicester_tpu.ops.pallas_cells import _grav_fac_nodiv
from gadget_leicester_tpu_torch import kernels
from gadget_leicester_tpu_torch.ops import softening
from gadget_leicester_tpu_torch.ops.cells import (cell_activity_flags,
                                                  grav_tile_flags,
                                                  pack_cells_soa,
                                                  shortrange_gravity_tiles)
from gadget_leicester_tpu_torch.ops.neighbors import (build_cell_list,
                                                      merge_rows)

BOX = 1.0
N_CELLS = 5
CAP = 64
ASMTH, RCUT = 0.04, 0.18     # rcut < cell edge 0.2: the stencil is complete


def _setup(seed, n=900):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)).astype(np.float32) * BOX
    pos[: n // 3] = (0.08 + 0.12 * rng.random((n // 3, 3))).astype(np.float32)
    pos[-40:, 0] = (rng.random(40) * 0.01).astype(np.float32)  # at x = 0
    mass = (rng.random(n) + 0.5).astype(np.float32)
    soft = np.full(n, 0.02, np.float32)
    alive = np.ones(n, bool)
    alive[-7:] = False
    active = rng.random(n) < 0.25
    return pos, mass, soft, alive, active


def _port(pos_build, pos, mass, soft, alive, active=None):
    t = [torch.from_numpy(a) for a in (pos_build, pos, mass, soft, alive)]
    cl = build_cell_list(t[0], t[4], 0.0, BOX, N_CELLS, CAP)
    soa = pack_cells_soa(cl, t[1], t[2], t[3], t[4])
    if active is None:
        flags = torch.ones(N_CELLS ** 3, dtype=torch.int32)
    else:
        flags = grav_tile_flags(cl, torch.from_numpy(active))
    out = shortrange_gravity_tiles(soa, flags, N_CELLS, BOX, ASMTH, RCUT)
    acc = merge_rows(out, cl, 3)
    return torch.where(t[4][:, None], acc, 0.0).numpy(), cl, soa, out


def _jax(pos_build, pos, mass, soft, alive, active=None):
    cl = j_build(jnp.asarray(pos_build), jnp.asarray(alive), 0.0, BOX,
                 n_cells=N_CELLS, capacity=CAP, periodic=True)
    acc, _ = shortrange_gravity_pallas_dma9(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(soft),
        jnp.asarray(alive), BOX, n_cells=N_CELLS, capacity=CAP, asmth=ASMTH,
        rcut=RCUT, periodic=True,
        active=None if active is None else jnp.asarray(active), cl=cl,
        interpret=True, relative=True)
    return np.asarray(acc)


def test_cell_list_matches_jax():
    """Stable sort: identical slot tables, counts, gslot and cell_of."""
    pos, _, _, alive, _ = _setup(1)
    cl = build_cell_list(torch.from_numpy(pos), torch.from_numpy(alive),
                         0.0, BOX, N_CELLS, 40)
    jcl = j_build(jnp.asarray(pos), jnp.asarray(alive), 0.0, BOX,
                  n_cells=N_CELLS, capacity=40, periodic=True)
    for f in ("cells", "counts", "gslot", "cell_of", "inv_cell"):
        np.testing.assert_array_equal(getattr(cl, f).numpy(),
                                      np.asarray(getattr(jcl, f)), err_msg=f)
    assert bool(cl.overflow) == bool(jcl.overflow) is True


@pytest.mark.parametrize("case", ["all", "gated", "stale"])
def test_shortrange_matches_jax_dma9(case):
    """Same float32 pair arithmetic, sums in another order: 2e-5 of the
    largest |acc|. Gated: cells without an active particle return zeros
    in both. Stale: positions drift (some across the x = 0 wrap) after
    the cell build; relative coordinates keep the pairs exact."""
    pos, mass, soft, alive, active = _setup(3)
    pos_now = pos
    if case == "stale":
        rng = np.random.default_rng(4)
        pos_now = np.mod(pos - 0.008 + 0.016 * rng.random(pos.shape),
                         BOX).astype(np.float32)
    act = active if case == "gated" else None
    got, cl, _, _ = _port(pos, pos_now, mass, soft, alive, act)
    want = _jax(pos, pos_now, mass, soft, alive, act)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale)
    if case == "gated":
        flags = cell_activity_flags(cl, torch.from_numpy(active)).numpy()
        off = flags[cl.cell_of.numpy().clip(0)] == 0
        assert off.any() and not np.abs(got[off & alive]).any()


def test_parked_slots_stay_finite():
    """Partly empty cells: parked slots sit at a finite -7 cells with
    m = 0, and every output slot, parked ones included, is finite (0 for
    parked targets); 1e30 parking would give inf * 0 = NaN."""
    pos, mass, soft, alive, _ = _setup(5, n=200)
    _, cl, soa, out = _port(pos, pos, mass, soft, alive)
    parked = cl.cells < 0
    assert parked.any()
    rows = soa.transpose(1, 2)[parked]
    assert torch.isfinite(soa).all()
    np.testing.assert_allclose(rows[:, 0].numpy(), -7.0 * BOX / N_CELLS,
                               rtol=1e-6)
    assert (rows[:, 3] == 0).all()
    assert torch.isfinite(out).all()
    assert (out.transpose(1, 2)[parked] == 0).all()


def test_wrapper_refuses_bad_input():
    pos, mass, soft, alive, _ = _setup(6, n=100)
    _, _, soa, _ = _port(pos, pos, mass, soft, alive)
    flags = torch.ones(N_CELLS ** 3, dtype=torch.int32)
    with pytest.raises(TypeError):
        shortrange_gravity_tiles(soa.double(), flags, N_CELLS, BOX, ASMTH,
                                 RCUT)
    with pytest.raises(ValueError):
        shortrange_gravity_tiles(soa, flags[:-1], N_CELLS, BOX, ASMTH, RCUT)
    with pytest.raises(ValueError):
        shortrange_gravity_tiles(soa.transpose(1, 2).contiguous()
                                 .transpose(1, 2), flags, N_CELLS, BOX,
                                 ASMTH, RCUT)
    before = dict(kernels.launches)
    shortrange_gravity_tiles(soa, flags, N_CELLS, BOX, ASMTH, RCUT)
    assert kernels.launches == before   # the CPU path launches nothing


def test_wrapper_records_arguments_only_while_recording():
    """chip_smoke.py replays what the path gave each wrapper: a wrapper
    keeps its last arguments while ``kernels.recording`` is on, and keeps
    nothing otherwise."""
    pos, mass, soft, alive, _ = _setup(6, n=100)
    _, _, soa, _ = _port(pos, pos, mass, soft, alive)
    flags = torch.ones(N_CELLS ** 3, dtype=torch.int32)
    kernels.recorded.clear()
    shortrange_gravity_tiles(soa, flags, N_CELLS, BOX, ASMTH, RCUT)
    assert not kernels.recorded
    kernels.recording = True
    try:
        shortrange_gravity_tiles(soa, flags, N_CELLS, BOX, ASMTH, RCUT)
    finally:
        kernels.recording = False
    args = kernels.recorded.pop("shortrange_gravity")
    assert args[0] is soa and args[1] is flags
    assert args[2:] == (N_CELLS, BOX, ASMTH, RCUT)


def test_softening_matches_jax():
    """Spline-softened force and potential factors, including r = 0, the
    inner/outer branch seam and the Newtonian tail: float32, 1e-6
    relative."""
    r = np.concatenate([[0.0], np.linspace(1e-4, 0.08, 400)]).astype(
        np.float32)
    h = np.float32(0.028)
    for tf, jf in ((softening.grav_fac, jsoft.grav_fac),
                   (softening.grav_pot, jsoft.grav_pot)):
        got = tf(torch.from_numpy(r), h).numpy()
        want = np.asarray(jf(jnp.asarray(r), h))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    rinv = 1.0 / np.maximum(r, 1e-30)
    got = softening.grav_fac_nodiv(*_t4(r, rinv, h, 1.0 / h)).numpy()
    want = np.asarray(_grav_fac_nodiv(jnp.asarray(r), jnp.asarray(rinv),
                                      h, 1.0 / h))
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-6, atol=0)


def _t4(r, rinv, h, hinv):
    return (torch.from_numpy(r), torch.from_numpy(rinv.astype(np.float32)),
            torch.tensor(h), torch.tensor(np.float32(hinv)))
