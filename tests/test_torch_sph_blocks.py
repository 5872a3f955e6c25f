"""Kernels C and D's plain versions (ops/sph_blocks.py) and the block-SPH
host code against the JAX package's block kernels in Pallas interpret
mode (block-relative coordinates, as on the main path)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.ops import sph_blocks as jsb
from gadget_leicester_tpu.ops import sph_kernels as jk
from gadget_leicester_tpu.ops.pallas_cells import pack_sph_soa as j_pack
from gadget_leicester_tpu_torch.ops import sph_blocks as tsb
from gadget_leicester_tpu_torch.ops import sph_kernels as tk

BOX = 2.0
N_BLOCKS = 2
SUBCAP = 64
LF = BOX / (2 * N_BLOCKS)
MAX_H = 0.9 * LF


def _setup(seed, n=1500):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    h = rng.uniform(0.2, 0.3, n).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-5:] = False
    active = rng.uniform(size=n) < 0.3
    return pos, vel, mass, h, mask, active


def test_w4_kernel_matches_jax():
    """W, dW/dr and dW/dh across both spline branches, the support edge
    and h = 0: float32, 1e-6 relative."""
    r = np.linspace(0.0, 1.3, 531).astype(np.float32)
    for h in (np.float32(1.0), np.float32(0.37), np.float32(0.0)):
        rt, ht = torch.from_numpy(r), torch.tensor(h)
        rj, hj = jnp.asarray(r), jnp.asarray(h)
        pairs = [(tk.kernel_w(rt, ht), jk.kernel_w(rj, hj)),
                 (tk.kernel_dw_dr(rt, ht), jk.kernel_dw_dr(rj, hj))]
        pairs += list(zip(tk.kernel_w_and_dwdh(rt, ht),
                          jk.kernel_w_and_dwdh(rj, hj)))
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=0)


def _lists(pos, mask):
    t = tsb.build_block_lists(torch.from_numpy(pos), torch.from_numpy(mask),
                              0.0, BOX, N_BLOCKS, SUBCAP)
    j = jsb.build_block_lists(jnp.asarray(pos), jnp.asarray(mask), 0.0, BOX,
                              n_blocks=N_BLOCKS, subcap=SUBCAP, periodic=True)
    return t, j


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_block_lists_identical():
    """One stable sort: identical even/odd slot tables and gslot maps."""
    pos, _, _, _, mask, _ = _setup(1)
    (te, to), (je, jo) = _lists(pos, mask)
    for t, j in ((te, je), (to, jo)):
        for f in ("cells", "gslot", "counts", "cell_of", "inv_cell"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)),
                                          err_msg=f)
        assert bool(t.overflow) == bool(j.overflow) is False


@pytest.mark.parametrize("gated", [False, True])
def test_density_sums_match_jax_kernel(gated):
    """Kernel C's plain version on the JAX package's own packs: the same
    float32 pair terms summed in another order, 1e-5 of each row's
    largest value. Gated tiles return zeros in both."""
    pos, vel, mass, h, mask, active = _setup(2)
    (te, to), (je, jo) = _lists(pos, mask)
    ones = jnp.ones(len(pos), jnp.float32)
    args = (jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), ones,
            jnp.asarray(mask))
    soa_e = j_pack(je, *args, centers=jsb.block_centers(
        N_BLOCKS, "even", LF, je.origin, jnp.float32), wrap=BOX)
    soa_o = j_pack(jo, *args, centers=jsb.block_centers(
        N_BLOCKS, "odd", LF, jo.origin, jnp.float32), wrap=BOX)
    idx = np.maximum(np.asarray(je.cells), 0)
    h_slots = np.where(np.asarray(je.cells) >= 0, h[idx], 1.0).astype(
        np.float32)
    flags = np.ones(N_BLOCKS ** 3, np.int32)
    if gated:
        flags[::3] = 0
    want = np.asarray(jsb.density_sums_blocks(
        je, soa_e, soa_o, jnp.asarray(h_slots), BOX, interpret=True,
        flags=jnp.asarray(flags), relative=True))[:, :6]
    got = tsb.density_sums_blocks(*_t(soa_e, soa_o, h_slots, flags),
                                  N_BLOCKS, LF).numpy()
    for r in range(6):
        scale = np.abs(want[:, r]).max()
        np.testing.assert_allclose(got[:, r], want[:, r], rtol=0,
                                   atol=1e-5 * scale, err_msg=f"row {r}")
    assert not got[flags == 0].any()
    # the port's own packs equal the JAX packs
    tsoa = tsb.pack_sph_soa(te, *_t(pos, vel, mass, np.ones(len(pos),
                                                            np.float32),
                                    mask),
                            tsb.block_centers(N_BLOCKS, "even", LF,
                                              te.origin), BOX)
    np.testing.assert_array_equal(tsoa.numpy(), np.asarray(soa_e))


@pytest.mark.parametrize("use_active", [False, True])
def test_density_adaptive_matches(use_active):
    """The Newton/bisection h-loop over kernel C against the JAX loop over
    the interpret-mode kernel: 2e-5 of the largest value per field."""
    pos, vel, mass, h, mask, active = _setup(3)
    (te, to), (je, jo) = _lists(pos, mask)
    act = active if use_active else None
    kw = dict(des_num_ngb=33.0, max_dev=2.0, box=BOX, max_hsml=MAX_H)
    jres, _ = jsb.density_adaptive_blocks(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
        jnp.asarray(h), jnp.asarray(mask), n_blocks=N_BLOCKS, subcap=SUBCAP,
        periodic=True, interpret=True, cls=(je, jo),
        active=None if act is None else jnp.asarray(act), **kw)
    tres, _ = tsb.density_adaptive_blocks(
        *_t(pos, vel, mass, h, mask), cls=(te, to),
        active=None if act is None else torch.from_numpy(act), **kw)
    sel = mask & (act if act is not None else True)
    for f in ("rho", "hsml", "div_vel", "curl_vel", "dhsml_factor",
              "num_ngb_eff"):
        w = np.asarray(getattr(jres, f))[sel]
        g = getattr(tres, f).numpy()[sel]
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 * np.abs(w).max(),
                                   err_msg=f)
    assert tres.iters == int(jres.iters)


def _hydro_args(seed):
    pos, vel, mass, h, mask, active = _setup(seed)
    (te, to), (je, jo) = _lists(pos, mask)
    rng = np.random.default_rng(seed + 10)
    rho = rng.uniform(0.8, 1.2, len(pos)).astype(np.float32) * len(pos) / 8
    pressure = np.where(mask, 0.5 * rho ** (5.0 / 3.0), 0.0).astype(
        np.float32)
    extra = [rng.uniform(0.9, 1.1, len(pos)).astype(np.float32),
             rng.normal(size=len(pos)).astype(np.float32),
             rng.uniform(0, 1, len(pos)).astype(np.float32)]
    arrays = (pos, vel, mass, h, rho, pressure, *extra, mask)
    return arrays, (te, to), (je, jo), active


@pytest.mark.parametrize("use_active,hubble", [(False, 0.0), (True, 0.0),
                                               (False, 0.3)])
def test_hydro_force_matches(use_active, hubble):
    """Kernel D through hydro_force_blocks against the JAX path: 2e-5 of
    the largest value per output (float32 sums in another order)."""
    arrays, tcls, jcls, active = _hydro_args(4)
    kw = dict(visc_const=0.8, box=BOX, hubble_a2_flow=hubble,
              hubble_a2_norm=1.3, fac_mu=0.9)
    jres = jsb.hydro_force_blocks(
        jcls, *[jnp.asarray(a) for a in arrays], interpret=True,
        active=jnp.asarray(active) if use_active else None, **kw)
    tres = tsb.hydro_force_blocks(
        tcls, *_t(*arrays),
        active=torch.from_numpy(active) if use_active else None, **kw)
    sel = arrays[-1] & (active if use_active else True)
    for f in ("acc", "dt_entropy", "max_signal_vel"):
        w = np.asarray(getattr(jres, f))[sel]
        g = getattr(tres, f).numpy()[sel]
        assert np.abs(w).max() > 0, f
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 * np.abs(w).max(),
                                   err_msg=f)


def test_self_pair_excluded_by_int_index():
    """Relative mode: the self-pair has r ~ rounding, so it is excluded by
    particle index. The port compares int32 indices: shifting every index
    by 2^24 changes nothing, while float32 ids (exact only below 2^24)
    would merge neighbouring indices and drop real pairs."""
    arrays, (te, to), _, _ = _hydro_args(5)
    a, b, src16, idx_e, idx_o, flags, params = tsb.pack_hydro_blocks(
        (te, to), *_t(*arrays), box=BOX, hubble_a2_flow=0.0, fac_mu=1.0)

    def sums(ie, io):
        return tsb.hydro_sums_blocks(a, b, src16, ie, io, flags, params,
                                     N_BLOCKS, LF, 0.8)

    def shifted(idx, to_f32=False):
        big = torch.where(idx >= 0, idx + 2 ** 24, idx)
        return big.float().int() if to_f32 else big

    base = sums(idx_e, idx_o)
    torch.testing.assert_close(sums(shifted(idx_e), shifted(idx_o)), base,
                               rtol=0, atol=0)
    assert not torch.equal(sums(shifted(idx_e, True), shifted(idx_o, True)),
                           base)
