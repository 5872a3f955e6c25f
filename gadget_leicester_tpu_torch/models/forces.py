"""Force computation at a sync point [G2: accel.c ::
compute_accelerations(), gravtree.c, hydra.c].

Counterpart of ``gadget_leicester_tpu/models/forces.py`` (``comoving_factors``,
``softening_table``, ``compute_forces``, ``_treepm_gravity``,
``compute_potential``, ``_tree_gravity``, ``_zoom_gravity``,
``compute_sph``). Gravity: periodic TreePM, direct summation (small
vacuum runs), the Barnes-Hut tree (``ops/tree.py``: vacuum runs above
``direct_threshold`` particles, and periodic runs without a PM mesh
through the Ewald correction), or the two-mesh zoom of vacuum runs
(``gravity_mode="zoom"``, :func:`_zoom_gravity`); none with
``nogravity``. With ``adaptive_gravsoft_forgas`` the gas softening
follows h (:func:`gravity_softening`); with ``isotherm_eqs`` the entropy
slot holds c_s^2, P = c_s^2 rho and the entropy does not change. SPH: the
block-packed, the coarse-cell or the all-pairs backend
(``SimOptions.sph_backend``; ``auto`` takes all-pairs at <= 4096 gas
slots and blocks above). Order, as in the reference: short-range gravity
-> long-range PM (PM steps only) -> SPH density (adaptive h) -> SPH
hydro.

Kernels on these paths: A (short-range gravity, ``ops/cells.py``), B (PM
deposit, ``ops/pm_tiles.py``), L (the PM step's CIC gather, ``ops/pm.py``;
the JAX package's step keeps a row gather there; also the gathers of the
zoom's two vacuum meshes), C and D (block SPH
density and hydro, ``ops/sph_blocks.py``; block-relative on a periodic
box, absolute on the clamped grid of a vacuum run) and at near-idle sync
points their active-entry twins E, F and G; I/J and K (coarse-cell SPH
density and hydro, ``ops/sph_cells.py``). The FFTs, direct gravity, the
tree and the all-pairs SPH sums are PyTorch's own operators, as the JAX
package leaves them to XLA, and so are the zoom's two short-range pair
passes (``ops/neighbors.py::apply_pairwise``). The full potential of the
diagnostics (:func:`compute_potential`, outside the step) runs kernel H on a fresh
cell list and L on the mesh potential, the direct sum, or the tree.

The in-step potential (:func:`in_step_potential`: sinks or Stamatellos
cooling under TreePM, which read p.pot inside the step): the dense tier
runs kernel H on the step's cached pack and tile flags in place of A, the
entries tier E's potential mode, a PM step gathers the mesh potential too,
and p.pot becomes the full potential, frozen for inactive particles as
acc is. Without it p.pot holds the PM piece alone, and A and E run as
they always did. Direct and tree gravity give the full potential anyway.

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
from gadget_leicester_tpu_torch.ops.gravity_direct import (
    direct_gravity, shortrange_trunc, shortrange_trunc_pot)
from gadget_leicester_tpu_torch.ops.neighbors import (apply_pairwise,
                                                      build_cell_list,
                                                      merge_rows,
                                                      stencil_sum)
from gadget_leicester_tpu_torch.ops.pm import (ASMTH, RCUT, pm_forces_diff,
                                               pm_forces_nonperiodic,
                                               pm_forces_periodic,
                                               pm_potential_periodic)
from gadget_leicester_tpu_torch.ops.pm_tiles import pm_deposit_tiles
from gadget_leicester_tpu_torch.ops.softening import (SOFTFAC, grav_fac,
                                                      grav_pot)
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


def gravity_softening(state: SimState, cfg: SimConfig, opts: SimOptions,
                      atime: torch.Tensor) -> torch.Tensor:
    """[N] force softening h = 2.8 eps of each particle's type; with
    ``adaptive_gravsoft_forgas`` gas takes max(h_sph, 2.8 eps_gas) [G2:
    ADAPTIVE_GRAVSOFT_FORGAS] from the hsml it holds now. It is made
    afresh at every force pass, and so is every pack that holds it (A, E,
    H, M): no softening outlives the pass that made it."""
    p = state.p
    eps = softening_table(cfg, atime)
    soft = SOFTFAC * eps[p.ptype.long()]
    if opts.adaptive_gravsoft_forgas and state.n_gas_max > 1:
        ng = state.n_gas_max
        gas_soft = torch.maximum(state.gas.hsml, SOFTFAC * eps[0])
        soft[:ng] = torch.where(p.ptype[:ng] == 0, gas_soft, soft[:ng])
    return soft


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
    """Refuse every configuration outside the ported slice. A vacuum run
    with a PM mesh resolves to ``treepm``, as ``PMGRID`` does in the JAX
    package, whose TreePM then takes the periodic mesh over ``BoxSize``
    (0 in a vacuum parameter file): a fault of the reference, refused
    here. Vacuum PM runs through the zoom."""
    if opts.dtype != "f32":
        _refuse("dtype f64", "the kernels are float32")
    if opts.cooling not in ("none", "beta", "stamatellos"):
        raise ValueError(f"unknown cooling {opts.cooling!r}")
    if not isinstance(opts.periodic, bool):
        raise NotImplementedError(
            f"per-axis periodic {opts.periodic!r}: the option is a bool, as "
            "in the JAX package; the slab step (Simulation(mesh=K), "
            "--devices K) builds its own per-axis grids")
    mode = resolve_gravity_mode(opts, n_max)
    if mode not in ("treepm", "direct", "tree", "zoom"):
        raise ValueError(f"unknown gravity mode {mode!r}")
    if not opts.nogravity and mode == "treepm" and not opts.periodic:
        raise NotImplementedError(
            "TreePM with vacuum boundaries (PMGRID without PERIODIC) would "
            "run the periodic mesh over BoxSize, as the JAX package does: "
            "a fault of the reference, not a mode to port (ROADMAP queue "
            "3). Vacuum PM runs as gravity_mode=\"zoom\" with hr_types "
            "(PLACEHIGHRESREGION), and vacuum TreePM on slabs "
            "(Simulation(mesh=K), --devices K)")
    if not opts.nogravity and mode == "zoom" and opts.pmgrid <= 0:
        raise ValueError("gravity_mode=\"zoom\" needs pmgrid > 0 (the "
                         "coarse mesh)")
    if n_gas_max > 1:
        backend = resolve_sph_backend(opts, n_gas_max)
        if backend not in ("blocks", "cells", "dense"):
            raise ValueError(f"unknown sph_backend {backend!r}")


def compute_forces(state: SimState, cfg: SimConfig, opts: SimOptions,
                   do_sph: bool = True, do_pm: bool = True,
                   stats: dict | None = None) -> SimState:
    """One full force computation at the current sync point: p.acc
    (short-range or direct, active particles only), p.acc_pm (TreePM, only
    when ``do_pm``, frozen otherwise; the zoom's two meshes at every
    pass; zeros under direct gravity), p.pot
    (the PM piece under TreePM, or the full potential of the active
    particles with :func:`in_step_potential`; the whole potential under
    direct, tree or zoom gravity; all zeros with ``nogravity``),
    and the SPH fields of active gas. ``stats`` (optional dict) receives
    ``density_iters``."""
    check_supported(cfg, opts, state.n_max, state.n_gas_max)
    p = state.p
    fac = comoving_factors(cfg, state.ti_current)
    # the active set: only these particles receive fresh forces
    active = (p.ti_endstep == state.ti_current) & p.alive
    if opts.nogravity:
        zero3, zero1 = torch.zeros_like(p.acc), torch.zeros_like(p.pot)
        p = dataclasses.replace(p, acc=zero3, acc_pm=zero3.clone(),
                                pot=zero1, pot_pm=zero1.clone(),
                                old_acc=zero1.clone())
        state = dataclasses.replace(state, p=p)
        if do_sph and state.n_gas_max > 1:
            state = compute_sph(state, cfg, opts, fac,
                                active[:state.n_gas_max], stats)
        return state
    soft = gravity_softening(state, cfg, opts, fac.atime)

    mode = resolve_gravity_mode(opts, state.n_max)
    if mode == "treepm":
        acc, pot, pot_pm, sr_ovf, acc_pm, state = _treepm_gravity(
            state, cfg, opts, soft, do_pm, active)
        state = dataclasses.replace(
            state,
            overflow_flags=state.overflow_flags | sr_ovf.to(torch.int32))
        pot_pm = pot_pm * cfg.grav_internal
        pot = pot * cfg.grav_internal
        if in_step_potential(opts):
            # the short-range row is tile-gated like the force: inactive
            # particles keep their last full potential [G2: P.Potential is
            # refreshed when the particle is active]
            pot = torch.where(active, pot, p.pot)
    elif mode == "zoom":
        acc, pot, acc_pm, z_ovf = _zoom_gravity(state, cfg, opts, soft)
        state = dataclasses.replace(
            state,
            overflow_flags=state.overflow_flags | z_ovf.to(torch.int32))
        pot_pm = torch.zeros_like(pot)
        pot = pot * cfg.grav_internal
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


def in_step_potential(opts: SimOptions) -> bool:
    """Does the TreePM step carry the full potential in p.pot? Only sink
    formation's potential-minimum check and the Stamatellos column read
    it [JAX forces.py:244]; otherwise p.pot holds the PM piece and the
    diagnostics take the full potential from :func:`compute_potential`."""
    return opts.sinks or opts.cooling == "stamatellos"


def _treepm_gravity(state: SimState, cfg: SimConfig, opts: SimOptions,
                    soft, do_pm: bool, active):
    """Short-range gravity through kernel A (kernel E at a near-idle sync
    point) on the cached cell grid and, on PM steps, long-range PM through
    kernel B, cuFFT and a CIC gather. With :func:`in_step_potential`, the
    dense tier runs kernel H (A's ``with_potential`` mode) and the entries
    tier E's potential mode on the same pack and flags or entries, and the
    PM pass gathers the mesh potential as a fourth component; the frozen
    PM piece serves between PM steps, as the frozen PM force does.
    Returns (acc_sr, pot, pot_pm, overflow, acc_pm scaled by G, state with
    the updated grid cache); pot and pot_pm without G: pot is pot_pm, or
    with the in-step potential pot_pm + the short-range potential + the
    PM self-term m / (sqrt(pi) asmth) [JAX forces.py:358-362]."""
    p = state.p
    box = float(cfg.box_size)
    g = opts.pmgrid
    asmth_len = ASMTH * box / g
    rcut = RCUT * asmth_len
    n_cells, cap, margin = grav_grid_geometry(cfg, opts, p.n_max)
    with_pot = in_step_potential(opts)

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

    # one pack shared by kernel A, E or H and the PM deposit (kernel B)
    soa = pack_cells_soa(cl, p.pos, p.mass, soft, p.alive)
    # entry capacity sized for ~1% spread activity, with room for spill
    k_max = max(256, (3 * n_cells ** 3) // 2)
    n_rows = 4 if with_pot else 3
    if use_entries(active.sum(), lambda: count_active_entries(cl, active),
                   k_max):
        ec, es, _ = build_active_entries(cl, active, ENTRY_LANES, k_max)
        rows = gravity_entries(cl, soa, ec, es, p.pos, p.mass, soft,
                               p.alive, box, asmth_len, rcut,
                               with_potential=with_pot)
    else:
        flags = grav_tile_flags(cl, active)
        tiles = shortrange_potential_tiles if with_pot \
            else shortrange_gravity_tiles
        rows = merge_rows(tiles(soa, flags, n_cells, box, asmth_len, rcut),
                          cl, n_rows)
    rows = torch.where(p.alive[:, None], rows, torch.zeros_like(rows))
    acc_sr = rows[:, :3]

    if do_pm:
        rho_grid = pm_deposit_tiles(soa, n_cells, box, g)
        if with_pot:
            acc_pm, pot_pm = pm_forces_periodic(p.pos, p.mass, p.alive, box,
                                                g, rho_grid=rho_grid,
                                                with_potential=True)
        else:
            acc_pm = pm_forces_periodic(p.pos, p.mass, p.alive, box, g,
                                        rho_grid=rho_grid)
            pot_pm = torch.zeros_like(p.pot)
        acc_pm = acc_pm * cfg.grav_internal
    else:
        acc_pm = p.acc_pm
        pot_pm = p.pot_pm / max(cfg.grav_internal, 1e-37)
    pot = pot_pm
    if with_pot:
        pot = pot_pm + rows[:, 3] \
            + p.mass / (math.sqrt(math.pi) * asmth_len)
    return acc_sr, pot, pot_pm, cl.overflow, acc_pm, state


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
    positions. Zoom: the whole of :func:`_zoom_gravity` (both meshes and
    both pair passes), its overflow into bit 1. With ``nogravity`` the
    state comes back as it is."""
    check_supported(cfg, opts, state.n_max, state.n_gas_max)
    if opts.nogravity:
        return state
    p = state.p
    fac = comoving_factors(cfg, state.ti_current)
    soft = gravity_softening(state, cfg, opts, fac.atime)
    box = float(cfg.box_size)
    mode = resolve_gravity_mode(opts, state.n_max)
    if mode == "zoom":
        _, pot, _, z_ovf = _zoom_gravity(state, cfg, opts, soft)
        pot = torch.where(p.alive, pot * cfg.grav_internal,
                          torch.zeros_like(pot))
        return dataclasses.replace(
            state, p=dataclasses.replace(p, pot=pot),
            overflow_flags=state.overflow_flags | z_ovf.to(torch.int32))
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


# target blocks of the zoom's pair passes on the card: about this many
# (target, candidate) pairs a block, some 20 float32 temporaries of it
# alive at once (a few GB); the CPU takes the reference's 256 targets
PAIR_BLOCK_CANDIDATES = 1 << 25


def pair_block(device: torch.device, n_candidates: int) -> int:
    """Targets a block of :func:`zoom_shortrange` (a multiple of 256)."""
    if device.type != "cuda":
        return 256
    return max(256, PAIR_BLOCK_CANDIDATES // n_candidates // 256 * 256)


def _bounding_cube(pos, sel, pad_frac: float):
    """(origin [3], extent 0-d) of the cube around the selected positions,
    padded by ``pad_frac`` of its longest side plus 1e-6 on each side."""
    inf = torch.full_like(pos, float("inf"))
    lo = torch.where(sel[:, None], pos, inf).amin(0)
    hi = torch.where(sel[:, None], pos, -inf).amax(0)
    pad = pad_frac * (hi - lo).max() + 1e-6
    return lo - pad, (hi - lo).max() + 2 * pad


def zoom_shortrange(cl, pos, soft, src_mass, in_hr_f, rcut: float,
                    asmth: float, exclude_hr_pairs: bool, hr_only: bool,
                    block: int = 256) -> torch.Tensor:
    """One short-range pass of the zoom [G2: forcetree.c short-range walk
    with the region's truncation]: for every particle, over the candidates
    of its 27-cell stencil in ``cl``, the erfc-truncated softened force
    and potential within ``rcut``, symmetrised softening max(h_i, h_j);
    ``exclude_hr_pairs`` drops pairs with both ends in the HR region,
    ``hr_only`` weights the sources by ``in_hr_f``. Returns [N, 4]: acc
    (no G) and the potential (no G, no self-pair). Plain PyTorch, as the
    JAX package's pass is plain jnp; each target's sums in a fixed order
    (:func:`ops.neighbors.stencil_sum`), whatever the block."""
    cap = cl.cells.shape[1]
    cols = [pos[:, k].contiguous() for k in range(3)]

    def pair_fn(idx, tp, cand):
        ci = cand.clamp_min(0).long()
        sm = torch.where(cand >= 0, src_mass[ci], torch.zeros(
            (), dtype=pos.dtype, device=pos.device))
        if hr_only:
            sm = sm * in_hr_f[ci]
        dx = [tp[:, k, None] - cols[k][ci] for k in range(3)]
        r = torch.sqrt(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2])
        h = torch.maximum(soft[idx][:, None], soft[ci])
        zero = torch.zeros_like(r)
        fac = grav_fac(r, h) * shortrange_trunc(r, asmth)
        fac = torch.where(r < rcut, fac, zero)
        pw = grav_pot(r, h) * shortrange_trunc_pot(r, asmth)
        pw = torch.where((r < rcut) & (r > 0), pw, zero)
        if exclude_hr_pairs:
            keep = 1.0 - in_hr_f[idx][:, None] * in_hr_f[ci]
            fac = fac * keep
            pw = pw * keep
        w = sm * fac
        sums = stencil_sum(torch.stack(
            [w * dx[0], w * dx[1], w * dx[2], sm * pw], dim=-1), cap)
        return torch.cat([-sums[:, :3], sums[:, 3:]], dim=1)

    return apply_pairwise(cl, pos, pair_fn, block=block)


def _zoom_gravity(state: SimState, cfg: SimConfig, opts: SimOptions, soft):
    """PLACEHIGHRESREGION two-mesh zoom gravity for vacuum boundaries [G2:
    pm_nonperiodic.c with PLACEHIGHRESREGION; forcetree.c short-range with
    the region's truncation]:

      * the COARSE vacuum mesh over the bounding cube of everything alive
        (1% padding; smoothing a_c = 1.25 coarse cells);
      * the FINE band-pass mesh (erf(a_h) - erf(a_c)) over the bounding
        cube of the ``opts.hr_types`` particle types (5% padding);
      * short-range pass A: every particle, erfc(a_c) cut at rcut_c, on
        a cell list over the coarse cube, no pair with both ends in the
        HR region;
      * pass B: the HR particles, erfc(a_h) cut at rcut_h, on a cell list
        of the HR particles over the fine cube.

    A pair of HR particles gets B + fine + coarse, any other pair A +
    coarse. Both regions are re-fitted at every pass; their extents are
    read to the host once here, for the meshes' launches (kernel L takes
    n / box as a number). Returns (acc_sr, pot, acc_pm scaled by G,
    overflow of either cell list); acc_sr and pot without G, pot with the
    meshes' self-energies taken out [G2: potential.c]."""
    p = state.p
    alive = p.alive
    n_c = opts.pmgrid
    n_h = opts.hr_pmgrid if opts.hr_pmgrid > 0 else opts.pmgrid
    origin_c, extent_c = _bounding_cube(p.pos, alive, 0.01)
    hr_sel = alive & (((opts.hr_types >> p.ptype.clamp(0, 5)) & 1) == 1)
    origin_h, extent_h = _bounding_cube(p.pos, hr_sel, 0.05)
    ext_c, ext_h = torch.stack([extent_c, extent_h]).tolist()
    asmth_c = ASMTH * ext_c / n_c
    asmth_h = ASMTH * ext_h / n_h

    acc_c, pot_c = pm_forces_nonperiodic(p.pos, p.mass, alive, origin_c,
                                         ext_c, n_c, with_potential=True)
    acc_f, pot_f, in_hr = pm_forces_diff(p.pos, p.mass, alive, origin_h,
                                         ext_h, n_h, asmth_c,
                                         with_potential=True)
    acc_pm = (acc_c + acc_f) * cfg.grav_internal
    pot_pm = pot_c + pot_f

    src_mass = torch.where(alive, p.mass, torch.zeros_like(p.mass))
    in_hr_f = in_hr.to(p.pos.dtype)
    passes = []
    for origin, ext, n_mesh, asmth, mask, hr_pass in (
            (origin_c, ext_c, n_c, asmth_c, alive, False),
            (origin_h, ext_h, n_h, asmth_h, alive & in_hr, True)):
        n_cells = max(3, int(n_mesh / (RCUT * ASMTH)))
        cap = opts.sr_capacity if opts.sr_capacity > 0 else max(
            64, -(-4 * p.n_max // n_cells ** 3 // 8) * 8)
        cl = build_cell_list(p.pos, mask, origin, ext, n_cells=n_cells,
                             capacity=cap, periodic=False)
        rows = zoom_shortrange(
            cl, p.pos, soft, src_mass, in_hr_f, RCUT * asmth, asmth,
            exclude_hr_pairs=not hr_pass, hr_only=hr_pass,
            block=pair_block(p.pos.device, 27 * cap))
        passes.append((rows, cl.overflow))
    (rows_a, ovf_a), (rows_b, ovf_b) = passes
    rows_b = torch.where(in_hr[:, None], rows_b, torch.zeros_like(rows_b))
    acc_sr = rows_a[:, :3] + rows_b[:, :3]
    # each mesh holds the particle's own smoothed cloud: the coarse one
    # -m / (sqrt(pi) a_c) for everyone, the band-pass one a further
    # -m (1/a_h - 1/a_c) / sqrt(pi) inside the HR region [G2: potential.c]
    self_c = p.mass / (math.sqrt(math.pi) * asmth_c)
    self_h = p.mass * (1.0 / asmth_h - 1.0 / asmth_c) / math.sqrt(math.pi)
    pot = pot_pm + rows_a[:, 3] + rows_b[:, 3] + self_c \
        + torch.where(in_hr, self_h, torch.zeros_like(self_h))
    acc_pm = torch.where(alive[:, None], acc_pm, torch.zeros_like(acc_pm))
    return acc_sr, pot, acc_pm, ovf_a | ovf_b


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
    contract of the 8-block stencil under staleness. Periodic: the box,
    relative coordinates. Vacuum: the gas bounding cube, re-fitted at
    every rebuild, absolute coordinates (unit ``box``), the fine edge and
    the refresh margin read from the cached lists."""
    pos_g, vel_g, mass_g, hsml0, gas_mask = fields
    ng = pos_g.shape[0]
    periodic = opts.periodic
    box = float(cfg.box_size) if periodic else 1.0
    n_blocks, subcap = sph_blocks_geometry(cfg, opts, ng)

    def build_blocks():
        origin, extent = (0.0, box) if periodic else \
            gas_bounding_grid(pos_g, gas_mask)
        return build_block_lists(pos_g, gas_mask, origin, extent,
                                 n_blocks=n_blocks, subcap=subcap,
                                 periodic=periodic)

    def fine_edge(cls):
        return box / (2 * n_blocks) if periodic else 1.0 / cls[0].inv_cell[0]

    grids = state.grids
    if grids is not None:
        count_now = gas_mask.sum().to(torch.int32)
        margin = 0.0 if grids.sph is None else \
            2.0 * KAPPA_SPH * fine_edge(grids.sph)
        cls, disp, count, _ = refresh(grids.sph, grids.sph_disp,
                                      grids.sph_count, margin, count_now,
                                      build_blocks)
        state = dataclasses.replace(state, grids=dataclasses.replace(
            grids, sph=cls, sph_disp=disp, sph_count=count))
    else:
        cls = build_blocks()
    max_hsml = (1.0 - 2.0 * KAPPA_SPH) * fine_edge(cls)
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
    # the entropy slot holds c_s^2 under the isothermal EOS: P = c_s^2 rho
    pressure = gas.entropy_pred * (rho if opts.isotherm_eqs
                                   else rho ** GAMMA)
    pressure = torch.where(gas_mask, pressure, torch.zeros_like(rho))

    hres = hydro(hsml, rho, pressure, dhsml, div_vel, curl_vel)
    hydro_acc = torch.where(take[:, None], hres.acc, gas.hydro_acc)
    dt_entropy = torch.where(take, hres.dt_entropy, gas.dt_entropy)
    msv = torch.where(take, hres.max_signal_vel, gas.max_signal_vel)
    if opts.isotherm_eqs:
        dt_entropy = torch.zeros_like(dt_entropy)   # c_s^2 stays fixed
    flags = state.overflow_flags
    if ovf is not None:
        flags = flags | ovf.to(torch.int32) * 2
    gas = dataclasses.replace(
        gas, density=rho, hsml=hsml, pressure=pressure, div_vel=div_vel,
        curl_vel=curl_vel, dhsml_density_factor=dhsml, num_ngb=num_ngb,
        hydro_acc=hydro_acc, dt_entropy=dt_entropy, max_signal_vel=msv)
    return dataclasses.replace(state, gas=gas, overflow_flags=flags)
