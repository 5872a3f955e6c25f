"""Force computation at a sync point [G2: accel.c ::
compute_accelerations(), gravtree.c, hydra.c].

Counterpart of ``gadget_leicester_tpu/models/forces.py:31-468, 590-921``
(``comoving_factors``, ``softening_table``, ``compute_forces``,
``_treepm_gravity``, ``compute_potential``, ``_tree_gravity``,
``compute_sph``). Gravity: periodic TreePM, direct summation (small
vacuum runs), or the Barnes-Hut tree (``ops/tree.py``: vacuum runs above
``direct_threshold`` particles, and periodic runs without a PM mesh
through the Ewald correction). SPH: the
block-packed, the coarse-cell or the all-pairs backend
(``SimOptions.sph_backend``; ``auto`` takes all-pairs at <= 4096 gas
slots and blocks above). Order, as in the reference: short-range gravity
-> long-range PM (PM steps only) -> SPH density (adaptive h) -> SPH
hydro.

Kernels on these paths: A (short-range gravity, ``ops/cells.py``), B (PM
deposit, ``ops/pm_tiles.py``), C and D (block SPH density and hydro,
``ops/sph_blocks.py``) and at near-idle sync points their active-entry
twins E, F and G; I/J and K (coarse-cell SPH density and hydro,
``ops/sph_cells.py``). The FFTs, the CIC gather, direct gravity, the
tree and the all-pairs SPH sums are PyTorch's own operators, as the JAX
package leaves them to XLA. The full potential of the diagnostics
(:func:`compute_potential`, outside the step) runs kernel H on a fresh
cell list, the direct sum, or the tree.

Two tiers under TreePM and block SPH, by the JAX package's rule
(:func:`use_entries`): a sync point at which few particles are active
compacts them into entries of at most ``ENTRY_LANES`` targets of one cell
(gravity) or even block (SPH) and runs E, F and G over the entries; any
other runs the flag-gated dense kernels A, C and D. Density and hydro take
the same tier, from one count. The tier decides speed only: both give the
same forces. The coarse-cell backend has neither tier nor gate, as in the
reference: every sync point sweeps all gas, and the inactive keep their
frozen fields.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from gadget_leicester_tpu_torch.core.config import GAMMA, SimConfig, SimOptions
from gadget_leicester_tpu_torch.core.cosmology import hubble_function
from gadget_leicester_tpu_torch.core.state import SimState
from gadget_leicester_tpu_torch.models.grids import (KAPPA_SPH,
                                                     grav_grid_geometry,
                                                     refresh,
                                                     resolve_gravity_mode,
                                                     resolve_sph_backend,
                                                     sph_blocks_geometry,
                                                     sph_cells_geometry)
from gadget_leicester_tpu_torch.ops.cells import (ENTRY_LANES,
                                                  build_active_entries,
                                                  count_active_entries,
                                                  grav_tile_flags,
                                                  gravity_entries,
                                                  pack_cells_soa,
                                                  shortrange_gravity_tiles,
                                                  shortrange_potential_tiles)
from gadget_leicester_tpu_torch.ops.gravity_direct import direct_gravity
from gadget_leicester_tpu_torch.ops.neighbors import (build_cell_list,
                                                      merge_rows)
from gadget_leicester_tpu_torch.ops.pm import (ASMTH, RCUT,
                                               pm_forces_periodic,
                                               pm_potential_periodic)
from gadget_leicester_tpu_torch.ops.pm_tiles import pm_deposit_tiles
from gadget_leicester_tpu_torch.ops.softening import SOFTFAC
from gadget_leicester_tpu_torch.ops.tree import tree_gravity
from gadget_leicester_tpu_torch.ops.sph_blocks import (
    build_block_lists, count_block_entries, density_adaptive_blocks,
    density_adaptive_blocks_entries, hydro_force_blocks,
    hydro_force_blocks_entries)
from gadget_leicester_tpu_torch.ops.sph_cells import (density_adaptive_cells,
                                                      hydro_force_cells)
from gadget_leicester_tpu_torch.ops.sph_dense import (density_adaptive,
                                                      hydro_force)


class ComovingFactors(NamedTuple):
    """All a(t)-dependent factors of one force pass (0-d float32)."""

    atime: torch.Tensor           # a (1 for physical)
    hubble_a: torch.Tensor        # H(a) (1 for physical)
    hubble_a2_flow: torch.Tensor  # a^2 H for the pairwise Hubble flow
    hubble_a2_norm: torch.Tensor  # a^2 H for the DtEntropy normalisation
    fac_mu: torch.Tensor          # a^{3(gamma-1)/2 - 1}
    a3inv: torch.Tensor           # 1/a^3


def comoving_factors(cfg: SimConfig, ti_current: torch.Tensor):
    dev = ti_current.device
    if not cfg.comoving_integration_on:
        one = torch.ones((), dtype=torch.float32, device=dev)
        return ComovingFactors(one, one, torch.zeros_like(one), one, one, one)
    a = torch.exp(ti_current.to(torch.float32) * cfg.timebase_interval) \
        * cfg.time_begin
    h_a = hubble_function(a, cfg.omega0, cfg.omega_lambda,
                          cfg.hubble_internal)
    ha2 = a * a * h_a
    fac_mu = a ** (3.0 * (GAMMA - 1.0) / 2.0) / a
    return ComovingFactors(a, h_a, ha2, ha2, fac_mu, 1.0 / a ** 3)


def softening_table(cfg: SimConfig, atime: torch.Tensor) -> torch.Tensor:
    """[6] per-type softening with comoving -> physical capping
    [G2: gravtree.c :: set_softenings()]."""
    vals = []
    for e, mp in zip(cfg.softenings, cfg.softenings_max_phys):
        e32 = torch.full((), e, dtype=torch.float32, device=atime.device)
        if cfg.comoving_integration_on and mp > 0:
            vals.append(torch.minimum(e32, mp / atime))
        else:
            vals.append(e32)
    return torch.stack(vals)


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


def use_entries(n_active: torch.Tensor, count_entries, k_max: int) -> bool:
    """The tier rule [JAX forces.py:285-290, :685-691]: the active-entry
    kernels when the active count leaves them in play (n_active <=
    ENTRY_LANES k_max) and the entries fit (``count_entries()`` <= k_max),
    the dense kernels otherwise. The entry count is taken only past the
    first test, as the reference's ``lax.cond`` does, so a busy sync point
    reads one host boolean and a near-idle one two."""
    if not bool(n_active <= k_max * ENTRY_LANES):
        return False
    return bool(count_entries() <= k_max)


def check_supported(cfg: SimConfig, opts: SimOptions, n_max: int,
                    n_gas_max: int) -> None:
    """Refuse every configuration outside the ported slice."""
    if opts.dtype != "f32":
        _refuse("dtype f64", "the kernels are float32")
    if opts.cooling != "none":
        _refuse(f"cooling={opts.cooling!r}", "ROADMAP queue 1 item 13")
    if opts.sinks:
        _refuse("sinks", "ROADMAP queue 1 item 13")
    if opts.nogravity or opts.adaptive_gravsoft_forgas:
        _refuse("nogravity / adaptive gas softening",
                "ROADMAP queue 1 item 12")
    if opts.isotherm_eqs:
        _refuse("isotherm_eqs", "ROADMAP queue 1 item 12")
    if opts.forcetest > 0:
        _refuse("forcetest", "ROADMAP queue 1 item 11")
    mode = resolve_gravity_mode(opts, n_max)
    if mode not in ("treepm", "direct", "tree") or \
            (mode == "treepm" and not opts.periodic):
        _refuse(f"gravity mode {mode!r} (periodic={opts.periodic})",
                "ROADMAP queue 1 item 12: vacuum and zoom PM")
    if n_gas_max > 1:
        backend = resolve_sph_backend(opts, n_gas_max)
        if backend not in ("blocks", "cells", "dense"):
            raise ValueError(f"unknown sph_backend {backend!r}")
        if backend == "blocks" and not opts.periodic:
            _refuse("sph_backend 'blocks' on a vacuum grid",
                    "ROADMAP queue 1 item 12: the non-relative block "
                    "kernels")


def compute_forces(state: SimState, cfg: SimConfig, opts: SimOptions,
                   do_sph: bool = True, do_pm: bool = True,
                   stats: dict | None = None) -> SimState:
    """One full force computation at the current sync point: p.acc
    (short-range or direct, active particles only), p.acc_pm (TreePM, only
    when ``do_pm``, frozen otherwise; zeros under direct gravity), p.pot
    (the PM piece under TreePM, the whole potential under direct or tree
    gravity),
    and the SPH fields of active gas. ``stats`` (optional dict) receives
    ``density_iters``."""
    check_supported(cfg, opts, state.n_max, state.n_gas_max)
    p = state.p
    fac = comoving_factors(cfg, state.ti_current)
    # the active set: only these particles receive fresh forces
    active = (p.ti_endstep == state.ti_current) & p.alive
    eps = softening_table(cfg, fac.atime)
    soft = SOFTFAC * eps[p.ptype.long()]

    mode = resolve_gravity_mode(opts, state.n_max)
    if mode == "treepm":
        acc, pot_pm, sr_ovf, acc_pm, state = _treepm_gravity(
            state, cfg, opts, soft, do_pm, active)
        state = dataclasses.replace(
            state,
            overflow_flags=state.overflow_flags | sr_ovf.to(torch.int32))
        pot_pm = pot_pm * cfg.grav_internal
        pot = pot_pm
    else:
        if mode == "tree":
            acc, pot = _tree_gravity(state, cfg, opts, soft)
        else:
            acc, pot = direct_gravity(p.pos, p.mass, soft, p.alive,
                                      box=float(cfg.box_size),
                                      periodic=opts.periodic)
        acc_pm = torch.zeros_like(acc)
        pot_pm = torch.zeros_like(pot)
        pot = pot * cfg.grav_internal
    acc = acc * cfg.grav_internal
    if cfg.comoving_integration_on and not opts.periodic:
        # a comoving run with vacuum boundaries: the homogeneous
        # background's term [G2: gravtree.c comoving correction]
        acc = acc + 0.5 * cfg.omega0 * cfg.hubble_internal ** 2 * p.pos
    zero3 = torch.zeros_like(acc)
    # inactive particles keep their frozen acc (gated tiles returned 0)
    acc = torch.where(active[:, None], acc, p.acc)
    acc = torch.where(p.alive[:, None], acc, zero3)
    acc_pm = torch.where(p.alive[:, None], acc_pm, zero3)
    total = acc + acc_pm
    p = dataclasses.replace(p, acc=acc, acc_pm=acc_pm, pot=pot,
                            pot_pm=pot_pm,
                            old_acc=torch.sqrt((total * total).sum(-1)))
    state = dataclasses.replace(state, p=p)
    if do_sph and state.n_gas_max > 1:
        state = compute_sph(state, cfg, opts, fac, active[:state.n_gas_max],
                            stats)
    return state


def _treepm_gravity(state: SimState, cfg: SimConfig, opts: SimOptions,
                    soft, do_pm: bool, active):
    """Short-range gravity through kernel A (kernel E at a near-idle sync
    point) on the cached cell grid and, on PM steps, long-range PM through
    kernel B, cuFFT and a CIC gather.
    Returns (acc_sr, pot_pm, overflow, acc_pm scaled by G, state with the
    updated grid cache)."""
    p = state.p
    box = float(cfg.box_size)
    g = opts.pmgrid
    asmth_len = ASMTH * box / g
    rcut = RCUT * asmth_len
    n_cells, cap, margin = grav_grid_geometry(cfg, opts, p.n_max)

    def build():
        return build_cell_list(p.pos, p.alive, 0.0, box, n_cells=n_cells,
                               capacity=cap)

    grids = state.grids
    if grids is not None:
        count_now = p.alive.sum().to(torch.int32)
        cl, disp, count, _ = refresh(grids.grav, grids.grav_disp,
                                     grids.grav_count, margin, count_now,
                                     build)
        state = dataclasses.replace(state, grids=dataclasses.replace(
            grids, grav=cl, grav_disp=disp, grav_count=count))
    else:
        cl = build()

    # one pack shared by kernel A or E and the PM deposit (kernel B)
    soa = pack_cells_soa(cl, p.pos, p.mass, soft, p.alive)
    # entry capacity sized for ~1% spread activity, with room for spill
    k_max = max(256, (3 * n_cells ** 3) // 2)
    if use_entries(active.sum(), lambda: count_active_entries(cl, active),
                   k_max):
        ec, es, _ = build_active_entries(cl, active, ENTRY_LANES, k_max)
        acc_sr = gravity_entries(cl, soa, ec, es, p.pos, p.mass, soft,
                                 p.alive, box, asmth_len, rcut)
    else:
        flags = grav_tile_flags(cl, active)
        out = shortrange_gravity_tiles(soa, flags, n_cells, box, asmth_len,
                                       rcut)
        acc_sr = merge_rows(out, cl, 3)
    acc_sr = torch.where(p.alive[:, None], acc_sr, torch.zeros_like(acc_sr))

    if do_pm:
        rho_grid = pm_deposit_tiles(soa, n_cells, box, g)
        acc_pm = pm_forces_periodic(p.pos, p.mass, p.alive, box, g,
                                    rho_grid=rho_grid) * cfg.grav_internal
        pot_pm = torch.zeros_like(p.pot)
    else:
        acc_pm = p.acc_pm
        pot_pm = p.pot_pm / max(cfg.grav_internal, 1e-37)
    return acc_sr, pot_pm, cl.overflow, acc_pm, state


def compute_potential(state: SimState, cfg: SimConfig,
                      opts: SimOptions) -> SimState:
    """The full gravitational potential of every particle, on demand
    [G2: potential.c :: compute_potential()]: for the energy statistics
    and the OUTPUTPOTENTIAL snapshot block; the step's p.pot carries only
    the PM piece. TreePM: the PM mesh potential, plus the erfc-truncated
    softened short-range sum of kernel H on a FRESH cell list (the cached
    grid of the step may be stale and coarsened), plus the PM self-term
    m / (sqrt(pi) asmth); times G, 0 where not alive. The fresh list's
    overflow sets bit 1 of ``overflow_flags``. Direct and tree gravity:
    the potential of the direct sum or of the tree walk at the current
    positions."""
    check_supported(cfg, opts, state.n_max, state.n_gas_max)
    p = state.p
    fac = comoving_factors(cfg, state.ti_current)
    soft = SOFTFAC * softening_table(cfg, fac.atime)[p.ptype.long()]
    box = float(cfg.box_size)
    mode = resolve_gravity_mode(opts, state.n_max)
    if mode != "treepm":
        if mode == "tree":
            _, pot = _tree_gravity(state, cfg, opts, soft)
        else:
            _, pot = direct_gravity(p.pos, p.mass, soft, p.alive, box=box,
                                    periodic=opts.periodic)
        pot = torch.where(p.alive, pot * cfg.grav_internal,
                          torch.zeros_like(pot))
        return dataclasses.replace(state, p=dataclasses.replace(p, pot=pot))
    g = opts.pmgrid
    asmth_len = ASMTH * box / g
    rcut = RCUT * asmth_len
    n_cells = max(3, int(box / rcut))
    cap = opts.sr_capacity if opts.sr_capacity > 0 else 128
    cap = max(128, ((cap + 127) // 128) * 128)
    pot_pm = pm_potential_periodic(p.pos, p.mass, p.alive, box, g)
    cl = build_cell_list(p.pos, p.alive, 0.0, box, n_cells=n_cells,
                         capacity=cap)
    soa = pack_cells_soa(cl, p.pos, p.mass, soft, p.alive)
    flags = torch.ones(n_cells ** 3, dtype=torch.int32, device=soa.device)
    out = shortrange_potential_tiles(soa, flags, n_cells, box, asmth_len,
                                     rcut)
    pot_sr = merge_rows(out, cl, 1, row0=3)[:, 0]
    # the mesh potential holds each particle's own smoothed cloud,
    # -m / (sqrt(pi) asmth); take it out [G2: potential.c]
    pot = pot_pm + pot_sr + p.mass / (math.sqrt(math.pi) * asmth_len)
    pot = pot * cfg.grav_internal
    pot = torch.where(p.alive, pot, torch.zeros_like(pot))
    return dataclasses.replace(
        state, p=dataclasses.replace(p, pot=pot),
        overflow_flags=state.overflow_flags | cl.overflow.to(torch.int32))


def _tree_gravity(state: SimState, cfg: SimConfig, opts: SimOptions, soft):
    """Barnes-Hut tree gravity (acc, pot; no G): vacuum, or periodic
    without PM with the tabulated Ewald correction [G2:
    force_treeevaluate_ewald_correction]. ``old_acc`` enters the relative
    opening criterion without G, as the tree's own accelerations are."""
    p = state.p
    return tree_gravity(
        p.pos, p.mass, soft, p.alive, theta=cfg.err_tol_theta,
        opening=cfg.type_of_opening_criterion,
        err_tol_force_acc=cfg.err_tol_force_acc,
        old_acc=p.old_acc / max(cfg.grav_internal, 1e-37),
        depth=opts.tree_depth, periodic=opts.periodic,
        box=float(cfg.box_size))


def gas_bounding_grid(pos_g, gas_mask):
    """(origin [3], extent 0-d) of a vacuum SPH grid: the gas bounding
    box, padded by 1% of its longest side, as one cube; device tensors,
    no host sync."""
    inf = torch.full_like(pos_g, float("inf"))
    lo = torch.where(gas_mask[:, None], pos_g, inf).amin(0)
    hi = torch.where(gas_mask[:, None], pos_g, -inf).amax(0)
    pad_w = 0.01 * (hi - lo).max() + 1e-6
    return lo - pad_w, (hi - lo).max() + 2 * pad_w


def _sph_blocks(state, cfg, opts, fields, active, active_g, dkw, hkw):
    """Block backend: kernels C and D on the cached (even, odd) lists, or
    F and G over the active entries at a near-idle sync point. Returns
    (DensityResult, hydro(fields), overflow, state with the updated
    cache); h is capped 2 kappa below the fine-cell edge, the correctness
    contract of the 8-block stencil under staleness."""
    pos_g, vel_g, mass_g, hsml0, gas_mask = fields
    ng = pos_g.shape[0]
    box = float(cfg.box_size)
    n_blocks, subcap = sph_blocks_geometry(cfg, opts, ng)

    def build_blocks():
        return build_block_lists(pos_g, gas_mask, 0.0, box,
                                 n_blocks=n_blocks, subcap=subcap)

    subcell = box / (2 * n_blocks)
    grids = state.grids
    if grids is not None:
        count_now = gas_mask.sum().to(torch.int32)
        cls, disp, count, _ = refresh(grids.sph, grids.sph_disp,
                                      grids.sph_count,
                                      2.0 * KAPPA_SPH * subcell,
                                      count_now, build_blocks)
        state = dataclasses.replace(state, grids=dataclasses.replace(
            grids, sph=cls, sph_disp=disp, sph_count=count))
    else:
        cls = build_blocks()
    max_hsml = (1.0 - 2.0 * KAPPA_SPH) * subcell
    hsml_in = torch.clamp(hsml0, max=max_hsml)
    k_max = 2 * n_blocks ** 3
    entries = None
    if use_entries(active_g.sum(),
                   lambda: count_block_entries(cls[0], active_g), k_max):
        entries = build_active_entries(cls[0], active_g, ENTRY_LANES,
                                       k_max)[:2]
    dkw = dict(dkw, box=box, cls=cls, max_hsml=max_hsml)
    if entries is None:
        dres, cls = density_adaptive_blocks(
            pos_g, vel_g, mass_g, hsml_in, gas_mask, active=active, **dkw)
    else:
        dres = density_adaptive_blocks_entries(
            pos_g, vel_g, mass_g, hsml_in, gas_mask, *entries, **dkw)

    def hydro(*sph_fields):
        args = (cls, pos_g, vel_g, mass_g, *sph_fields, gas_mask)
        if entries is None:
            return hydro_force_blocks(*args, active=active, box=box, **hkw)
        return hydro_force_blocks_entries(*args, *entries, box=box, **hkw)

    return dres, hydro, cls[0].overflow, state


def _sph_cells(cfg, opts, fields, dkw, hkw):
    """Coarse-cell backend: kernels I/J and K on a fresh cell list, every
    gas particle a target (no ``active`` reaches it, as in the reference).
    Periodic: the box; vacuum: the gas bounding box, unit ``box``. h is
    capped at the cell edge. Returns (DensityResult, hydro(fields),
    overflow)."""
    pos_g, vel_g, mass_g, hsml0, gas_mask = fields
    n_cells, cap = sph_cells_geometry(cfg, opts, pos_g.shape[0])
    if opts.periodic:
        origin, extent = 0.0, float(cfg.box_size)
        box = extent
    else:
        origin, extent = gas_bounding_grid(pos_g, gas_mask)
        box = 1.0
    max_hsml = extent / n_cells
    dres, cl = density_adaptive_cells(
        pos_g, vel_g, mass_g, torch.clamp(hsml0, max=max_hsml), gas_mask,
        box=box, n_cells=n_cells, capacity=cap, max_hsml=max_hsml,
        periodic=opts.periodic, origin=origin, extent=extent, **dkw)

    def hydro(*sph_fields):
        return hydro_force_cells(cl, pos_g, vel_g, mass_g, *sph_fields,
                                 gas_mask, box=box, **hkw)

    return dres, hydro, cl.overflow


def _sph_dense(cfg, opts, fields, dkw, hkw):
    """All-pairs backend (small gas counts): no list, no cap on h, no
    overflow. Returns (DensityResult, hydro(fields))."""
    pos_g, vel_g, mass_g, hsml0, gas_mask = fields
    geom = dict(box=float(cfg.box_size), periodic=opts.periodic)
    dres = density_adaptive(pos_g, vel_g, mass_g, hsml0, gas_mask, **dkw,
                            **geom)

    def hydro(*sph_fields):
        return hydro_force(pos_g, vel_g, mass_g, *sph_fields, gas_mask,
                           **hkw, **geom)

    return dres, hydro


def compute_sph(state: SimState, cfg: SimConfig, opts: SimOptions,
                fac: ComovingFactors, active, stats: dict | None = None):
    """density (adaptive h) -> hydro [G2: accel.c ordering], through the
    backend ``resolve_sph_backend`` names. Inactive gas keeps its
    drift-forecast fields; a particle dropped by a full cell or subcell
    comes back with rho = 0 and keeps its forecast too (the sticky
    overflow bit 2 asks for a larger capacity)."""
    gas = state.gas
    ng = gas.n_gas_max
    p = state.p
    gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
    active_g = active & gas_mask
    eps_gas = softening_table(cfg, fac.atime)[0]
    fields = (p.pos[:ng], gas.vel_pred, p.mass[:ng], gas.hsml, gas_mask)
    dkw = dict(des_num_ngb=cfg.des_num_ngb,
               max_dev=cfg.max_num_ngb_deviation,
               min_hsml=cfg.min_gas_hsml_fractional * SOFTFAC * eps_gas)
    hkw = dict(visc_const=cfg.art_bulk_visc_const,
               hubble_a2_flow=fac.hubble_a2_flow,
               hubble_a2_norm=fac.hubble_a2_norm, fac_mu=fac.fac_mu)
    backend = resolve_sph_backend(opts, ng)
    ovf = None
    if backend == "blocks":
        dres, hydro, ovf, state = _sph_blocks(state, cfg, opts, fields,
                                              active, active_g, dkw, hkw)
    elif backend == "cells":
        dres, hydro, ovf = _sph_cells(cfg, opts, fields, dkw, hkw)
    else:
        dres, hydro = _sph_dense(cfg, opts, fields, dkw, hkw)
    if stats is not None:
        stats.setdefault("density_iters", []).append(dres.iters)

    take = active_g & (dres.rho > 0)
    rho = torch.where(take, dres.rho, gas.density)
    hsml = torch.where(take, dres.hsml, gas.hsml)
    dhsml = torch.where(take, dres.dhsml_factor, gas.dhsml_density_factor)
    div_vel = torch.where(take, dres.div_vel, gas.div_vel)
    curl_vel = torch.where(take, dres.curl_vel, gas.curl_vel)
    num_ngb = torch.where(take, dres.num_ngb_eff, gas.num_ngb)
    pressure = torch.where(gas_mask, gas.entropy_pred * rho ** GAMMA,
                           torch.zeros_like(rho))

    hres = hydro(hsml, rho, pressure, dhsml, div_vel, curl_vel)
    hydro_acc = torch.where(take[:, None], hres.acc, gas.hydro_acc)
    dt_entropy = torch.where(take, hres.dt_entropy, gas.dt_entropy)
    msv = torch.where(take, hres.max_signal_vel, gas.max_signal_vel)
    flags = state.overflow_flags
    if ovf is not None:
        flags = flags | ovf.to(torch.int32) * 2
    gas = dataclasses.replace(
        gas, density=rho, hsml=hsml, pressure=pressure, div_vel=div_vel,
        curl_vel=curl_vel, dhsml_density_factor=dhsml, num_ngb=num_ngb,
        hydro_acc=hydro_acc, dt_entropy=dt_entropy, max_signal_vel=msv)
    return dataclasses.replace(state, gas=gas, overflow_flags=flags)
