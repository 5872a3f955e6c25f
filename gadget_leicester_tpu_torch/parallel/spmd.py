"""The owner-computes slab step [G2: domain.c :: domain_Decomposition(),
domain_exchangeParticles(); gravtree.c, density.c, hydra.c export and
import loops], periodic and vacuum geometry, with sinks and Stamatellos
cooling.

Counterpart of ``gadget_leicester_tpu/parallel/spmd.py``: the host layout
(``balance_edges`` :64, ``spmd_min_width`` :90, ``SLAB_FILL`` :108,
``to_spmd`` :111, ``from_spmd`` :196, ``spmd_to_canonical`` :210), the
static slab-grid geometry and its cache (``slab_grid_geom`` :290,
``make_spmd_grid_cache`` :344), the in-rank helpers (``_pack`` :416,
``_ghost_exchange`` :438, ``_select_rows`` :455, ``_ghost_rows_select``
:466, ``_ghost_exchange_rows`` :474, ``_wrap_to_slab`` :501, ``_ghost_x``
:506, ``_ghost_cap`` :520, ``_insert_into_dead`` :530) and
``make_spmd_step`` (:555): ``_migrate`` (:673), ``_gravity`` (:763, with
the in-step potential), ``_sph_blocks`` (:941-1127) and the coarse-cell
branch of ``_sph`` (:1120-1315), ``_sinks`` (:1316) and ``local_step``
(:1479).

Ownership: x-slabs, one a rank; each rank holds a fixed-capacity chunk
[cap_g gas slots | cap_r other slots] of every particle array, so its
local state is a smaller valid ``SimState``. After the drift, particles
that crossed a face move one hop to the neighbour's dead slots; a jump over
more than one slab, or full migration buffers, set overflow bit 4. Ghosts,
the boundary strips within reach of a face, travel both ways each sync
point: within rcut (and the grid's staleness margin) for short-range
gravity, within the SPH fine-cell edge twice, positions and velocities
before the density pass and the density fields before hydro; full ghost
buffers set bit 1 (gravity) or bit 2 (SPH). Each rank builds an
anisotropic grid over [x0 - reach, x1 + reach) x [0, box)^2, clamped in x,
and runs kernel A's slab mode (``ops/cells.py ::
shortrange_gravity_slab``) and kernels C and D on anisotropic blocks
(``ops/sph_blocks.py``, ``fine_edge``) with its own particles as targets and
the ghosts as sources. Under ``sph_backend="cells"`` the SPH takes the
reference's coarse-cell branch instead: ghosts within one coarse cell edge,
one cell list over (nx, n, n) cells clamped in x, and kernels I/J and K in
their ghost-row mode (``ops/sph_cells.py``, ``n_targets``), fresh at every
sync point as in the reference; every other backend takes the blocks (the
reference picks its branch by ``use_pallas``: the blocks on a TPU, the
coarse cells without kernels). The PM runs across the ring
(``parallel/pm_sharded.py``). The next sync point is the ``pmin`` of the
ranks' next ticks; the PM step's v_rms sums over the ring.

Two geometries. Periodic TreePM: slabs over [0, BoxSize), y and z
periodic, ghost x wrapped onto the receiving faces, the pencil-FFT PM.
Vacuum TreePM (``PeriodicBoundariesOn 0`` with a PM mesh; the caller picks
``auto_pmgrid`` where it is 0): ``domain`` = (origin [3], extent), a cube
that encloses the particles with room to spare, fitted by the caller
(``Simulation._decompose``); slabs partition its x, every grid is clamped
on all three axes in the domain's frame (positions less the origin), a
ghost is kept only where it lies in the half-strip it arrived for (so the
ring's arrivals across an outer face, and a ring of one's own, drop out),
the PM is the free-space mesh with one ``all_reduce`` of its octant, a
comoving run adds the background term, and a particle that leaves the
cube sets bit 4, on which the caller refits the cube and decomposes anew.

With sinks or Stamatellos cooling the step carries the full potential in
p.pot, as the single-device step does: the PM potential (gathered with the
force on PM steps, the stored piece between them), kernel A's slab mode
with the potential row on the step's pack and tile flags, and the PM
self-term. Cooling then runs as on one device, with the registered sinks
of the whole ring (gathered by PID) in the Stamatellos point-mass term:
the JAX package reads the registry's PIDs as rows of each rank's chunk
there (ROADMAP queue 3). Sinks (:meth:`SpmdStep.sinks`): the registry
``SinkState.slot`` holds PIDs in the slab layout (rows move under
migration; :func:`to_spmd` and :func:`spmd_to_canonical` translate) and
is the same on every rank; formation elects the ring's densest candidate,
accretion ships each rank's sinks to both neighbours and the claims on
ghost sinks back to their owners.

The reference traces each branch around a collective with a ``psum``ed
predicate; here each such branch reads one host boolean that every rank
reduces first (:meth:`parallel.mesh.Ring.any`): the migration's any-hop
test, the gravity grid's rebuild, the SPH lists' rebuild, the formation of
a sink. The grid cache (:func:`make_spmd_grid_cache`) holds each rank's
cell lists and ghost-row selections between rebuilds, as
``models/grids.py`` does for one device; an empty slot means "build"
(the coarse-cell branch keeps nothing there). The reference's GSPMD
placement (``parallel/step.py``, ``mesh.py``) is
``parallel/step.py :: make_sharded_step`` here, the single-device step on
one device: this slab step is the port's multi-device path. Refused
(:func:`check_slab_supported`, each with its reason): the zoom, a periodic
tree run, ``nogravity``, adaptive gas softening and beta cooling on slabs,
and float64.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gadget_leicester_tpu_torch.core import timeline
from gadget_leicester_tpu_torch.core.config import (GAMMA, GAMMA_MINUS1,
                                                    SimConfig, SimOptions)
from gadget_leicester_tpu_torch.core.state import (GasState, ParticleState,
                                                   SimState)
from gadget_leicester_tpu_torch.models import integrate
from gadget_leicester_tpu_torch.models.cooling import apply_cooling
from gadget_leicester_tpu_torch.models.forces import (comoving_factors,
                                                      in_step_potential,
                                                      softening_table)
from gadget_leicester_tpu_torch.models.grids import (KAPPA_SPH,
                                                     SOFT_RCUT_FRAC,
                                                     GridCache,
                                                     sph_blocks_geometry)
from gadget_leicester_tpu_torch.ops.cells import (grav_tile_flags,
                                                  pack_cells_abs,
                                                  shortrange_gravity_slab)
from gadget_leicester_tpu_torch.models.sinks import (dot3, first_argmax,
                                                     min_image)
from gadget_leicester_tpu_torch.ops.neighbors import (build_cell_list,
                                                      merge_rows)
from gadget_leicester_tpu_torch.ops.pm import ASMTH, RCUT
from gadget_leicester_tpu_torch.ops.softening import SOFTFAC
from gadget_leicester_tpu_torch.ops.sph_blocks import (
    build_block_lists, density_adaptive_blocks, hydro_force_blocks)
from gadget_leicester_tpu_torch.ops.sph_cells import (density_adaptive_cells,
                                                      hydro_force_cells)
from gadget_leicester_tpu_torch.parallel.pm_sharded import (
    pm_local_forces, pm_local_forces_vacuum)

_P_FIELDS = ["pos", "vel", "mass", "ptype", "pid", "acc", "acc_pm",
             "pot", "pot_pm", "old_acc", "ti_begstep", "ti_endstep"]
_G_FIELDS = [f.name for f in dataclasses.fields(GasState)]


def check_slab_supported(opts: SimOptions) -> None:
    """Refuse what the slab step does not run, each with its reason. The
    SPH backend picks the branch: ``cells`` the coarse cells, every other
    one the blocks."""
    if opts.sph_backend not in ("auto", "blocks", "cells", "dense"):
        raise ValueError(f"unknown sph_backend {opts.sph_backend!r}")
    if opts.gravity_mode not in ("auto", "treepm"):
        raise NotImplementedError(
            f"gravity_mode={opts.gravity_mode!r} on slabs: the JAX slab "
            "step runs TreePM alone, periodic or vacuum (its _gravity is "
            "the PM plus the short-range pass), so there is no reference "
            "for the zoom, the tree or the direct sum on slabs")
    if opts.periodic is True and opts.pmgrid <= 0:
        raise NotImplementedError(
            "the slab step runs a periodic box as TreePM (PERIODIC with "
            "PMGRID): the JAX slab step has no periodic tree (no Ewald "
            "sum across slabs)")
    if opts.cooling == "beta":
        raise NotImplementedError(
            "beta cooling on slabs: the JAX slab step takes each slab's own "
            "non-gas mass as the central mass, and reads the registry's "
            "first sink slot, a PID there, as a row of the slab's chunk "
            "(ROADMAP queue 3), so it has no sound reference")
    if opts.nogravity or opts.adaptive_gravsoft_forgas:
        raise NotImplementedError(
            "nogravity and adaptive gas softening on slabs: the JAX slab "
            "step reads neither (its _gravity always runs, on the type "
            "softening table), so there is no reference for them")
    if opts.dtype != "f32":
        raise NotImplementedError("dtype f64: the kernels are float32")


# ---------------------------------------------------------------------------
# Host-side layout
# ---------------------------------------------------------------------------
def balance_edges(pos_x, alive, box: float, d: int,
                  min_width: float = 0.0, origin: float = 0.0,
                  periodic: bool = True) -> np.ndarray:
    """Cost-balanced slab boundaries [G2: domain.c :: domain_decompose()]:
    the x-quantiles of the alive particles, blended toward uniform just
    enough that every slab is at least ``min_width`` wide. A vacuum run
    (``periodic`` False) works in the domain's frame: x less ``origin``,
    clamped into [0, box], ``box`` the domain's extent."""
    x_raw = np.asarray(pos_x)[np.asarray(alive)]
    x = np.sort(np.mod(x_raw, box) if periodic
                else np.clip(x_raw - origin, 0.0, box))
    if len(x) == 0:
        return np.linspace(0.0, box, d + 1)
    q = np.quantile(x, np.linspace(0.0, 1.0, d + 1))
    q[0], q[-1] = 0.0, box
    uniform = np.linspace(0.0, box, d + 1)
    for t in np.linspace(0.0, 1.0, 21):
        e = (1 - t) * q + t * uniform
        if min_width <= 0 or np.min(np.diff(e)) >= min_width:
            return e
    return uniform


def spmd_min_width(cfg: SimConfig, opts: SimOptions, n_gas: int,
                   extent: float | None = None) -> float:
    """The slab-width floor: rcut (gravity ghosts) and the SPH cell edge
    (density and hydro ghosts), with 2% to spare; ``extent`` (the vacuum
    domain's edge) in place of the box where given."""
    box = float(cfg.box_size) if extent is None else float(extent)
    rcut = RCUT * ASMTH * box / max(opts.pmgrid, 1)
    spacing_cells = (n_gas ** (1.0 / 3.0)) / (
        1.6 * (3.0 * cfg.des_num_ngb / (4.0 * 3.14159)) ** (1.0 / 3.0))
    cell_sph = box / max(3, int(spacing_cells))
    return max(rcut, cell_sph) * 1.02


# the least share of a vacuum domain the slab grids take as occupied: a
# flat cloud would otherwise ask for grids too fine to hold in memory
MIN_FILL = 0.1


def fit_domain(pos: np.ndarray, alive: np.ndarray):
    """The vacuum slab step's domain, (origin [3] float32, extent, fill):
    the cube 1.3 times the largest extent of the alive particles, centred
    on their bounding box (``models/simulation.py:396-401`` of the JAX
    package), and the share of it that box occupies (at least
    ``MIN_FILL``), for :func:`slab_grid_geom`."""
    pts = np.asarray(pos, np.float32)[np.asarray(alive)]
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    ext = float((hi - lo).max()) * 1.3 + 1e-6
    fill = float(np.prod((hi - lo).astype(np.float64) / ext))
    return 0.5 * (lo + hi) - 0.5 * ext, ext, max(MIN_FILL, min(1.0, fill))


# slot head-room of the slab layout: a chunk holds ceil(max slab count /
# SLAB_FILL) slots, so SLAB_FILL times the slots is the step's estimate of
# the real count of the fullest slab
SLAB_FILL = 0.6


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def to_spmd(state: SimState, d: int, cfg: SimConfig,
            fill_frac: float = SLAB_FILL, edges=None,
            min_width: float = 0.0, domain=None):
    """The canonical ``state`` re-laid into the slab layout of ``d``
    ranks: rank r's chunk is rows [r stride, (r+1) stride) of each particle
    array, [cap_g gas | cap_r other] with stride = cap_g + cap_r, and rows
    [r cap_g, (r+1) cap_g) of each gas array. ``edges`` [d+1] (None:
    :func:`balance_edges`). ``domain`` (origin [3], extent, fill;
    :func:`fit_domain`): a vacuum run,
    whose edges and slab membership are in the domain's frame. The sink
    registry's slots, rows of the canonical layout, become the PIDs of
    those rows (rows move under migration). Returns (state, (cap_g,
    cap_r), edges), the state on the input's device, without a grid
    cache."""
    per = domain is None
    box = float(cfg.box_size) if per else float(domain[1])
    orig_x = 0.0 if per else float(np.asarray(domain[0]).reshape(3)[0])
    p = state.p
    dev = p.pos.device
    ng = state.n_gas_max
    pos = _np(p.pos)
    alive = _np(p.alive)
    ptype = _np(p.ptype)
    is_gas = np.zeros(p.n_max, bool)
    is_gas[:ng] = (ptype[:ng] == 0) & alive[:ng]
    is_rest = alive & ~is_gas
    if edges is None:
        edges = balance_edges(pos[:, 0], alive, box, d, min_width,
                              origin=orig_x, periodic=per)
    edges = np.asarray(edges, np.float64)
    xw = np.mod(pos[:, 0], box) if per else np.clip(
        pos[:, 0] - orig_x, 0.0, np.nextafter(box, 0.0))
    slab = np.clip(np.searchsorted(edges, xw, side="right") - 1, 0, d - 1)

    def cap_for(sel):
        counts = np.bincount(slab[sel], minlength=d)
        return max(8, int(np.ceil(counts.max() / fill_frac / 8.0)) * 8)

    cap_g, cap_r = cap_for(is_gas), cap_for(is_rest)
    stride = cap_g + cap_r
    dst = np.full(p.n_max, -1, np.int64)
    for sh in range(d):
        rows_g = np.where(is_gas & (slab == sh))[0]
        dst[rows_g] = sh * stride + np.arange(len(rows_g))
        rows_r = np.where(is_rest & (slab == sh))[0]
        dst[rows_r] = sh * stride + cap_g + np.arange(len(rows_r))

    def scat(t, n_out, rows, to):
        out = torch.zeros((n_out,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=dev)
        out[torch.from_numpy(to).to(dev)] = t[torch.from_numpy(rows).to(dev)]
        return out

    rows_all = np.where(dst >= 0)[0]
    newp = ParticleState(**{f: scat(getattr(p, f), d * stride, rows_all,
                                    dst[rows_all]) for f in _P_FIELDS},
                         alive=scat(p.alive, d * stride, rows_all,
                                    dst[rows_all]))
    rows_g = np.where(is_gas)[0]
    gdst = dst[rows_g]
    gdst = (gdst // stride) * cap_g + gdst % stride
    g = state.gas
    newg = GasState(**{f: scat(getattr(g, f), d * cap_g, rows_g, gdst)
                       for f in _G_FIELDS})
    newg = dataclasses.replace(
        newg,
        dhsml_density_factor=torch.where(newg.hsml > 0,
                                         newg.dhsml_density_factor,
                                         torch.ones_like(newg.hsml)),
        hsml=newg.hsml.clamp_min(1e-30))
    sinks = state.sinks
    slot = _np(sinks.slot)
    if np.any(slot >= 0):
        pid = _np(p.pid)
        slot = np.where(slot >= 0, pid[np.maximum(slot, 0)], -1)
        sinks = dataclasses.replace(sinks, slot=torch.from_numpy(
            slot.astype(np.int32)).to(sinks.slot.device))
    return (dataclasses.replace(state, p=newp, gas=newg, sinks=sinks,
                                grids=None),
            (cap_g, cap_r), edges)


def local_chunk(state: SimState, rank: int, caps) -> SimState:
    """Rank ``rank``'s chunk of a slab-layout state (copies)."""
    cap_g, cap_r = caps
    stride = cap_g + cap_r
    p = ParticleState(**{f: getattr(state.p, f)[rank * stride:
                                                (rank + 1) * stride].clone()
                         for f in _P_FIELDS + ["alive"]})
    g = GasState(**{f: getattr(state.gas, f)[rank * cap_g:
                                             (rank + 1) * cap_g].clone()
                    for f in _G_FIELDS})
    return dataclasses.replace(state, p=p, gas=g, grids=None)


def gather_chunks(ring, local: SimState) -> SimState:
    """The slab-layout state of the whole ring, on every rank: each
    particle and gas array all-gathered along dim 0 (bool as uint8); the
    sink registry, the same on every rank, as it is."""
    def ag(t):
        if t.dtype == torch.bool:
            return ring.all_gather(t.to(torch.uint8)).to(torch.bool)
        return ring.all_gather(t)
    p = ParticleState(**{f: ag(getattr(local.p, f))
                         for f in _P_FIELDS + ["alive"]})
    g = GasState(**{f: ag(getattr(local.gas, f)) for f in _G_FIELDS})
    return dataclasses.replace(local, p=p, gas=g, grids=None)


def from_spmd(state: SimState, cap_g: int, cap_r: int):
    """The alive particles of a slab-layout state as host arrays (pos, vel,
    mass, ptype, source rows), for quick analysis; the full state goes
    through :func:`spmd_to_canonical`."""
    alive = _np(state.p.alive)
    rows = np.where(alive)[0]
    return (_np(state.p.pos)[rows], _np(state.p.vel)[rows],
            _np(state.p.mass)[rows], _np(state.p.ptype)[rows], rows)


def spmd_to_canonical(state: SimState, cap_g: int, cap_r: int) -> SimState:
    """The lossless slab -> canonical layout: particle rows permuted so
    every rank's gas block comes first (the gas arrays are in that order
    already), and the sink registry's PIDs turned back into the rows that
    hold them alive (-1 where none does). Snapshots, energy, restart dumps
    and re-decomposition all go through it."""
    stride = cap_g + cap_r
    d = state.p.n_max // stride
    gas_rows = (np.arange(d)[:, None] * stride
                + np.arange(cap_g)[None, :]).reshape(-1)
    rest_rows = (np.arange(d)[:, None] * stride + cap_g
                 + np.arange(cap_r)[None, :]).reshape(-1)
    order = torch.from_numpy(np.concatenate([gas_rows, rest_rows])).to(
        state.p.pos.device)
    newp = ParticleState(**{f: getattr(state.p, f)[order]
                            for f in _P_FIELDS + ["alive"]})
    sinks = state.sinks
    slot = _np(sinks.slot)
    if np.any(slot >= 0):
        pid, alive = _np(newp.pid), _np(newp.alive)
        row_of = {int(q): r for r, q in zip(np.flatnonzero(alive),
                                            pid[alive])}
        slot = np.asarray([row_of.get(int(q), -1) if q >= 0 else -1
                           for q in slot], np.int32)
        sinks = dataclasses.replace(sinks, slot=torch.from_numpy(slot).to(
            sinks.slot.device))
    return dataclasses.replace(state, p=newp, sinks=sinks, grids=None)


# ---------------------------------------------------------------------------
# Static slab-grid geometry and the per-rank grid cache
# ---------------------------------------------------------------------------
def _ghost_cap(n_local: int, reach: float, w_min: float,
               frac_override: float = 0.0) -> int:
    """Per-direction ghost-buffer capacity: the strip's share reach /
    w_min of the chunk with 2x for clustering, at most the chunk."""
    frac = frac_override if frac_override > 0.0 else min(
        1.0, 2.0 * reach / max(w_min, 1e-30))
    return min(n_local, max(8, -(-int(frac * n_local) // 8) * 8))


def _occ_grid_static(n_cat, span_x, cap, nyz0, box):
    """The (nx, nyz) slab grid coarsened from the reach-fine one until the
    mean slot fill reaches ~0.8 of the lane capacity; cell edges never
    drop below the reach."""
    def _nx(nyz):
        return max(1, int(span_x / (box / nyz)))
    nyz_e = nyz0
    while (nyz_e > 4
           and n_cat / (_nx(nyz_e - 1) * (nyz_e - 1) ** 2) <= 0.8 * cap):
        nyz_e -= 1
    return _nx(nyz_e), nyz_e


def _occ_cap_static(n_cat, n_cells_est, base):
    """Lane capacity: 128 where the finest grid's estimated fill allows,
    in steps of 128 up to 512 otherwise; ``base`` (opts.sr_capacity) when
    set."""
    if base > 0:
        return max(128, ((base + 127) // 128) * 128)
    est = n_cat / max(1, n_cells_est)
    return max(128, min(512, (-(-int(est / 0.8) // 128)) * 128))


def slab_grid_geom(cfg: SimConfig, opts: SimOptions, d: int, box: float,
                   w_min: float, w_max: float, n_loc: int,
                   ng_loc: int, fill: float = 1.0) -> dict:
    """All static geometry of a rank's slab grids, as the reference's
    kernel branch (``use_pallas``) takes it: rcut and nyz; the gravity
    grid's ghost capacity gcap_g, lane capacity cap_sr, cells (nx, nyz_g)
    and staleness margin margin_g; the SPH blocks' nb_g, subcap, fine edge
    subcell, x blocks nbx, ghost capacity gcap_s, margin margin_s and h
    cap max_hsml. ``fill``: the share of the grids' volume the particles
    occupy (1 on a periodic box; a vacuum domain's, :func:`fit_domain`):
    the occupancy estimates count the particles over that share, where the
    reference counts them over the whole domain cube and so sizes cells
    and capacities for a mean fill that the occupied cells exceed by
    1 / fill (the lcdm box in vacuum: 2.2x), which no capacity raise
    reaches, since each raise also coarsens the grid (ROADMAP queue 3)."""
    asmth_len = ASMTH * box / opts.pmgrid
    rcut = RCUT * asmth_len
    nyz = max(3, int(box / rcut))
    out = dict(rcut=rcut, nyz=nyz)
    gcap_g = _ghost_cap(n_loc, rcut, w_min, opts.spmd_ghost_frac)
    n_est = int(SLAB_FILL * n_loc * (1.0 + 3.0 * rcut / w_min) / fill)
    nx0 = max(1, int((w_min + 2.0 * rcut) / (box / nyz)))
    cap_sr = _occ_cap_static(n_est, nx0 * nyz * nyz, opts.sr_capacity)
    nx, nyz_g = _occ_grid_static(n_est, w_min + 2.0 * rcut, cap_sr, nyz, box)
    edge_x_min = (w_min + 2.0 * rcut) / nx
    edge_yz = box / nyz_g
    margin_g = max(min(edge_x_min, edge_yz) - rcut, SOFT_RCUT_FRAC * rcut)
    out.update(gcap_g=gcap_g, cap_sr=cap_sr, nx=nx, nyz_g=nyz_g,
               margin_g=margin_g)

    n_glob = max(1, int(SLAB_FILL * ng_loc * d / fill))
    nb_g, subcap = sph_blocks_geometry(cfg, opts, n_glob)
    nb_g = max(nb_g, int(np.ceil(1.02 * box / (2.0 * w_min))))
    subcell = box / (2 * nb_g)
    nbx = max(1, int(np.ceil((w_max + 2.05 * subcell) / (2.0 * subcell))))
    gcap_s = _ghost_cap(ng_loc, subcell, w_min, opts.spmd_ghost_frac)
    out.update(nb_g=nb_g, subcap=subcap, subcell=subcell, nbx=nbx,
               gcap_s=gcap_s, margin_s=2.0 * KAPPA_SPH * subcell,
               max_hsml=(1.0 - 2.0 * KAPPA_SPH) * subcell)
    if opts.sph_backend == "cells":
        out.update(slab_cells_geom(cfg, opts, d, box, w_min, ng_loc, fill))
    return out


def slab_cells_geom(cfg: SimConfig, opts: SimOptions, d: int, box: float,
                    w_min: float, ng_loc: int, fill: float = 1.0) -> dict:
    """The coarse-cell SPH branch's geometry, as the reference's branch
    without kernels (``use_pallas`` off, ``parallel/spmd.py:1141-1201``)
    takes it: the cell edge ``cell_c`` (also the h cap and the ghosts'
    reach) from ``spacing_cells`` on the ring's gas count, floored so that
    it never exceeds a slab width; ``n_c`` cells along y and z, ``nx_c``
    along x over the widest slab's [x0 - cell_c, x1 + cell_c); the ghost
    capacity ``gcap_c`` and the lane capacity ``cap_c`` (``sph_capacity``,
    or three times the mean fill of the [locals | ghosts] rows, at least
    64, rounded up to 8). A vacuum domain counts the gas over the share
    ``fill`` it occupies (:func:`slab_grid_geom`)."""
    n_glob = ng_loc * d / fill
    spacing_cells = (n_glob ** (1.0 / 3.0)) / (
        1.6 * (3.0 * cfg.des_num_ngb / (4.0 * 3.14159)) ** (1.0 / 3.0))
    n_c = max(3, int(spacing_cells), int(np.ceil(1.02 * box / w_min)))
    cell_c = box / n_c
    if w_min < cell_c:
        raise ValueError("slab thinner than the SPH cell edge")
    gcap_c = _ghost_cap(ng_loc, cell_c, w_min, opts.spmd_ghost_frac)
    nx_c = max(1, int((w_min + 2 * cell_c) / cell_c))
    n_cat = int((ng_loc + 2 * gcap_c) / fill)
    cap_c = opts.sph_capacity if opts.sph_capacity > 0 else max(
        64, -(-3 * n_cat // (nx_c * n_c * n_c) // 8) * 8)
    return dict(n_c=n_c, cell_c=cell_c, nx_c=nx_c, gcap_c=gcap_c,
                cap_c=cap_c)


def make_spmd_grid_cache(device) -> GridCache:
    """An empty per-rank grid cache of the slab step: the first sync
    point builds. ``grav`` then holds (cell list, ghost rows) and ``sph``
    (even list, odd list, ghost rows); the ghost rows are part of it
    because the lists index the [locals | ghosts] arrays, so the ghost
    slot of each particle stays fixed between rebuilds."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    c = torch.full((), -1, dtype=torch.int32, device=device)
    return GridCache(grav=None, sph=None, grav_disp=z, sph_disp=z.clone(),
                     grav_count=c, sph_count=c.clone())


def raised_slab_capacities(opts: SimOptions, ovf: int, geo: dict,
                           buffers: int | None = None):
    """The options after overflow bits ``ovf`` of a slab step with
    geometry ``geo``: bit 1 adds 128 to the slab grid's own capacity
    (cap_sr; the single-device raise of ``sr_capacity or 128`` would give
    back the 256 the slab grid picks for itself, and change nothing), bit
    2 doubles the slab blocks' subcap, and ``buffers`` (the bits of the
    ghost and migration buffers; unknown, ``ovf & 7``, when None, as in
    the run loop, where they share bits 1, 2 and 4 with the lists)
    doubles ``spmd_ghost_frac``. Under ``sph_backend="cells"`` bit 2
    doubles the coarse cells' lane capacity ``cap_c`` instead."""
    if ovf & 1:
        opts = dataclasses.replace(opts, sr_capacity=geo["cap_sr"] + 128)
    if ovf & 2:
        opts = dataclasses.replace(opts, sph_capacity=2 * geo.get(
            "cap_c", geo["subcap"]))
    if (ovf & 7 if buffers is None else buffers):
        opts = dataclasses.replace(opts, spmd_ghost_frac=min(
            1.0, 2 * (opts.spmd_ghost_frac or 0.25)))
    return opts


# ---------------------------------------------------------------------------
# In-rank primitives
# ---------------------------------------------------------------------------
def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _pack(fields, mask, cap: int):
    """Stream-compact the rows where ``mask`` into [cap] buffers; returns
    (buffers, count, count > cap)."""
    idxpos = torch.cumsum(mask.to(torch.int64), 0) - 1
    put = torch.where(mask & (idxpos < cap), idxpos,
                      torch.full_like(idxpos, cap))
    outs = []
    for f in fields:
        buf = f.new_zeros((cap + 1,) + tuple(f.shape[1:]))
        buf[put] = torch.where(_bcast(mask, f), f, torch.zeros_like(f))
        outs.append(buf[:cap])
    count = mask.sum().to(torch.int32)
    return outs, count, count > cap


def _select_rows(mask, cap: int):
    """Packed row indices [cap] (int32, -1 pad) of ``mask``, and whether
    more than ``cap`` rows were set: the index half of :func:`_pack`."""
    n = mask.shape[0]
    idxpos = torch.cumsum(mask.to(torch.int64), 0) - 1
    put = torch.where(mask & (idxpos < cap), idxpos,
                      torch.full_like(idxpos, cap))
    rows = torch.full((cap + 1,), -1, dtype=torch.int32, device=mask.device)
    rows[put] = torch.arange(n, dtype=torch.int32, device=mask.device)
    # rows past the cap all land on the dump slot; the last one written
    # there is dropped with it
    return rows[:cap], mask.sum() > cap


def _ghost_rows_select(pos_x, alive, x0, x1, reach: float, gcap: int):
    """A fresh boundary-strip row selection: [2 gcap] rows (the strip for
    the left neighbour first) and the overflow of either."""
    rl, o1 = _select_rows(alive & (pos_x < x0 + reach), gcap)
    rr, o2 = _select_rows(alive & (pos_x >= x1 - reach), gcap)
    return torch.cat([rl, rr]), o1 | o2


def _ghost_exchange(ring, fields, pos_x, alive, x0, x1, margin: float,
                    gcap: int):
    """Both-ways boundary-strip exchange by packing: ([2 gcap] ghost
    arrays, ghost-valid mask, overflow)."""
    near_l = alive & (pos_x < x0 + margin)
    near_r = alive & (pos_x >= x1 - margin)
    bl, cl_, o1 = _pack(fields, near_l, gcap)
    br, cr_, o2 = _pack(fields, near_r, gcap)
    from_left = ring.ring(br + [cr_.reshape(1)], +1)
    from_right = ring.ring(bl + [cl_.reshape(1)], -1)
    c_l, c_r = from_left[-1][0], from_right[-1][0]
    ghosts = [torch.cat([a, b]) for a, b in zip(from_left[:-1],
                                                from_right[:-1])]
    ar = torch.arange(gcap, device=alive.device)
    gvalid = torch.cat([ar < c_l, ar < c_r])
    return ghosts, gvalid, o1 | o2 | (c_l > gcap) | (c_r > gcap)


def _ghost_exchange_rows(ring, fields, alive, rows, gcap: int):
    """The rows-driven exchange (cached selections): ``rows`` [2 gcap] from
    :func:`_ghost_rows_select`, possibly of an earlier sync point; whether
    a row is still alive ships as data. Returns ([2 gcap] ghost arrays,
    [from-left | from-right], ghost-valid mask)."""
    def gather(rws):
        i = rws.clamp_min(0).long()
        v = (rws >= 0) & alive[i]
        return [torch.where(_bcast(v, f[i]), f[i], torch.zeros_like(f[i]))
                for f in fields], v
    bl, vl = gather(rows[:gcap])
    br, vr = gather(rows[gcap:])
    from_left = ring.ring(br + [vr.to(torch.int32)], +1)
    from_right = ring.ring(bl + [vl.to(torch.int32)], -1)
    ghosts = [torch.cat([a, b]) for a, b in zip(from_left[:-1],
                                                from_right[:-1])]
    return ghosts, torch.cat([from_left[-1] > 0, from_right[-1] > 0])


def _wrap_to_slab(x, xc, box: float):
    """x mapped to the frame of the slab centred at ``xc``."""
    return xc + (x - xc) - box * torch.round((x - xc) / box)


def _ghost_x(gx, x0, x1, margin: float, box: float, gcap: int):
    """The directional ghost-x mapping of a [2 gcap] exchange buffer: the
    from-left half onto [x0 - margin, ...), the from-right half onto [x1,
    ...), each by its own mod (a ring of one or two ranks delivers both
    halves from one slab, which must land on opposite faces)."""
    lo = x0 - margin
    gl = lo + torch.remainder(gx[:gcap] - lo, box)
    gr = x1 + torch.remainder(gx[gcap:] - x1, box)
    return torch.cat([gl, gr])


def _insert_into_dead(fields, alive, recv, valid_in):
    """Received rows into dead slots: the k-th valid arrival (ranked over
    the valid mask) into the k-th dead slot. Returns (fields, alive,
    overflow)."""
    n = alive.shape[0]
    order = torch.argsort(alive.to(torch.int32), stable=True)   # dead first
    n_dead = (~alive).sum()
    rank = torch.cumsum(valid_in.to(torch.int64), 0) - 1
    tgt = torch.where(valid_in & (rank < n_dead),
                      order[rank.clamp(0, n - 1)], torch.full_like(rank, n))
    outs = []
    for f, rec in zip(fields, recv):
        fbuf = torch.cat([f, f.new_zeros((1,) + tuple(f.shape[1:]))])
        fbuf[tgt] = rec
        outs.append(fbuf[:n])
    alive_new = torch.cat([alive, alive.new_zeros(1)])
    alive_new[tgt] = True
    return outs, alive_new[:n], valid_in.sum() > n_dead


# ---------------------------------------------------------------------------
# The slab step
# ---------------------------------------------------------------------------
class SpmdStep:
    """``make_spmd_step``: one owner-computes sync point of this rank's
    chunk, ``step(state) -> state``. ``edges`` [d+1] are the slab
    boundaries of :func:`to_spmd`; ``domain`` (origin [3], extent, fill)
    the vacuum run's cube (:func:`fit_domain`; None on a periodic box). ``last_rebuilt`` says
    which cached structures the last sync point rebuilt; ``times``, when a
    dict, gets the seconds of each part (with a device sync on both
    sides)."""

    def __init__(self, cfg: SimConfig, opts: SimOptions, ring, edges,
                 migrate_frac: float = 0.15, domain=None):
        check_slab_supported(opts)
        self.cfg, self.opts, self.ring = cfg, opts, ring
        self.d = ring.size
        self.me = ring.rank
        self.per = bool(opts.periodic)
        if self.per:
            self.box = float(cfg.box_size)
            dom0 = np.zeros(3)
        else:
            if domain is None or opts.pmgrid <= 0:
                raise ValueError("a vacuum slab step needs a PM mesh (pmgrid "
                                 "> 0) and a domain (origin, extent, fill)")
            self.box = float(domain[1])
            dom0 = np.asarray(domain[0], np.float32).reshape(3)
        # the occupied share of the grids' volume (slab_grid_geom)
        self.fill = 1.0 if self.per else float(domain[2])
        # every grid's per-axis periodicity: x clamped; y and z periodic on
        # a periodic box, clamped in vacuum
        self.periodic3 = (False, self.per, self.per)
        self.edges = np.asarray(edges, np.float64)
        if len(self.edges) != self.d + 1:
            raise ValueError(f"{len(self.edges)} edges for {self.d} slabs")
        self.w_min = float(np.min(np.diff(self.edges)))
        self.w_max = float(np.max(np.diff(self.edges)))
        self.migrate_frac = migrate_frac
        self.asmth_len = ASMTH * self.box / opts.pmgrid
        self.rcut = RCUT * self.asmth_len
        if self.w_min < self.rcut:
            raise ValueError(f"min slab width {self.w_min:.1f} < rcut "
                             f"{self.rcut:.1f}: fewer ranks or a finer PM "
                             "mesh")
        if self.per and opts.pmgrid % self.d:
            raise ValueError(f"pmgrid {opts.pmgrid} must divide the "
                             f"{self.d}-rank ring")
        dev = ring.device
        self.dom0 = torch.tensor(dom0, dtype=torch.float32, device=dev)
        self.edges_t = torch.tensor(self.edges, dtype=torch.float32,
                                    device=dev)
        self.x0 = self.edges_t[self.me]
        self.x1 = self.edges_t[self.me + 1]
        self.xc = 0.5 * (self.x0 + self.x1)
        self.want_pot = in_step_potential(opts)
        # the coarse-cell SPH branch; every other backend takes the blocks
        self.cells = opts.sph_backend == "cells"
        self.last_rebuilt = {}
        self.times = None

    # -- helpers ----------------------------------------------------------
    def _timed(self, name, fn, *args):
        if self.times is None:
            return fn(*args)
        import time
        dev = self.ring.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.times[name] = self.times.get(name, 0.0) \
            + time.perf_counter() - t0
        return out

    def geometry(self, st: SimState) -> dict:
        return slab_grid_geom(self.cfg, self.opts, self.d, self.box,
                              self.w_min, self.w_max, st.n_max, st.n_gas_max,
                              self.fill)

    def _wx(self, x):
        """Absolute x in the domain's frame, [0, box) (the box's x on a
        periodic one, x less the origin in vacuum)."""
        if self.per:
            return torch.remainder(x, self.box)
        return x - self.dom0[0]

    def _dompos(self, q):
        """Absolute positions in the frame of the grids: as they are on a
        periodic box, less the domain's origin in vacuum."""
        return q if self.per else q - self.dom0[None, :]

    def _fix_ghost_x(self, gx, margin: float, gvalid, gcap: int):
        """The ghosts' x and validity on the receiving slab. Periodic:
        wrapped onto its faces (:func:`_ghost_x`). Vacuum: as they are, a
        ghost kept only where it lies in the half-strip it arrived for,
        [x0 - margin, x0) from the left, [x1, x1 + margin) from the right:
        across an outer face there is no neighbour."""
        if self.per:
            return _ghost_x(gx, self.x0, self.x1, margin, self.box,
                            gcap), gvalid
        ok = torch.cat([(gx[:gcap] >= self.x0 - margin) & (gx[:gcap] < self.x0),
                        (gx[gcap:] >= self.x1)
                        & (gx[gcap:] < self.x1 + margin)])
        return gx, gvalid & ok

    def _local_pos(self, pos):
        """This rank's positions in the frame of its grids: on a periodic
        box x taken to the slab's own frame around its centre."""
        lpos = self._dompos(pos).clone()
        if self.per:
            lpos[:, 0] = _wrap_to_slab(torch.remainder(pos[:, 0], self.box),
                                       self.xc, self.box)
        return lpos

    def _need(self, cached, disp, count, count_now, margin: float) -> bool:
        """The rebuild decision, the same on every rank: a rank whose
        structure is missing, whose particles drifted past the margin or
        whose population changed asks, and all rebuild."""
        need = cached is None or bool((2.0 * disp > margin)
                                      | (count_now != count))
        return self.ring.any(need)

    # -- migration -----------------------------------------------------------
    def migrate(self, st: SimState) -> SimState:
        p = st.p
        d, me = self.d, self.me
        cap_g = st.n_gas_max
        mcap = max(8, int(self.migrate_frac * p.n_max))
        xw = self._wx(p.pos[:, 0])
        slab_of = (torch.searchsorted(self.edges_t, xw, right=True)
                   - 1).clamp(0, d - 1).to(torch.int32)
        stay = slab_of == me
        go_l = p.alive & (slab_of == (me - 1) % d) & ~stay
        # on a ring of two the left and the right neighbour are one rank:
        # a particle goes one way only
        go_r = p.alive & (slab_of == (me + 1) % d) & ~stay & ~go_l
        lost = p.alive & ~stay & ~go_l & ~go_r
        if not self.per:
            # a particle that left the domain on any axis: the caller refits
            # the cube (bit 4, as a jump over a slab)
            rel = self._dompos(p.pos)
            lost = lost | (p.alive & ((rel < 0.0) | (rel >= self.box)).any(1))
        flags = st.overflow_flags | (lost.any().to(torch.int32) * 4)
        if d == 1:
            return dataclasses.replace(st, overflow_flags=flags)
        n_move = self.ring.psum((go_l | go_r).sum().to(torch.int32))
        if int(n_move) == 0:
            return dataclasses.replace(st, overflow_flags=flags)
        gfields = [getattr(st.gas, f) for f in _G_FIELDS]

        def move_block(lo, hi, gas_block):
            sl, sr = go_l[lo:hi], go_r[lo:hi]
            fields = [getattr(p, f)[lo:hi] for f in _P_FIELDS]
            if gas_block:
                fields = fields + gfields
            bl, cl_, o1 = _pack(fields, sl, mcap)
            br, cr_, o2 = _pack(fields, sr, mcap)
            from_r = self.ring.ring(bl + [cl_.reshape(1)], -1)
            from_l = self.ring.ring(br + [cr_.reshape(1)], +1)
            recv = [torch.cat([a, b]) for a, b in zip(from_l[:-1],
                                                      from_r[:-1])]
            c_l, c_r = from_l[-1][0], from_r[-1][0]
            ar = torch.arange(mcap, device=p.pos.device)
            valid_in = torch.cat([ar < c_l, ar < c_r])
            alive_blk = p.alive[lo:hi] & stay[lo:hi]
            outs, alive_new, o3 = _insert_into_dead(fields, alive_blk, recv,
                                                    valid_in)
            return outs, alive_new, o1 | o2 | o3 | (c_l > mcap) | (c_r > mcap)

        outs_g, alive_g, ovf_g = move_block(0, cap_g, True)
        outs_r, alive_r, ovf_r = move_block(cap_g, p.n_max, False)
        p_new = ParticleState(
            **{f: torch.cat([outs_g[i], outs_r[i]])
               for i, f in enumerate(_P_FIELDS)},
            alive=torch.cat([alive_g, alive_r]))
        gas_new = GasState(**{f: outs_g[len(_P_FIELDS) + i]
                              for i, f in enumerate(_G_FIELDS)})
        flags = flags | ((ovf_g | ovf_r).to(torch.int32) * 4)
        grids = st.grids
        if grids is not None:
            # particles moved rows: every cached list and ghost selection
            # is stale (n_move is the ring's, so all ranks drop theirs)
            grids = dataclasses.replace(grids, grav=None, sph=None)
        return dataclasses.replace(st, p=p_new, gas=gas_new, grids=grids,
                                   overflow_flags=flags)

    # -- gravity -------------------------------------------------------------
    def _pm(self, p):
        """The PM pass across the ring: (acc [N, 3] times G, the mesh
        potential [N] without G: zeros without the in-step potential)."""
        cfg, box, g = self.cfg, self.box, self.opts.pmgrid
        if self.per:
            res = pm_local_forces(self.ring, p.pos, p.mass, p.alive, box, g,
                                  with_potential=self.want_pot)
        else:
            res = pm_local_forces_vacuum(self.ring, p.pos, p.mass, p.alive,
                                         self.dom0, box, g,
                                         with_potential=self.want_pot)
        acc, pot = res if self.want_pot else (res, torch.zeros_like(p.mass))
        return acc * cfg.grav_internal, pot

    def gravity(self, st: SimState, is_pm_step: bool):
        cfg, box = self.cfg, self.box
        p = st.p
        fac = comoving_factors(cfg, st.ti_current)
        active = (p.ti_endstep == st.ti_current) & p.alive
        eps = softening_table(cfg, fac.atime)
        soft = SOFTFAC * eps[p.ptype.long()]
        if is_pm_step:
            acc_pm, pot = self._timed("PM", self._pm, p)
        else:
            acc_pm = p.acc_pm
            pot = p.pot_pm / max(cfg.grav_internal, 1e-37)

        geo = self.geometry(st)
        gr = st.grids
        count_now = p.alive.sum().to(torch.int32)
        cached = None if gr is None else gr.grav
        need = True if gr is None else self._need(
            cached, gr.grav_disp, gr.grav_count, count_now, geo["margin_g"])
        cl, rows, ovf, cat, n_cells = self._grav_lists(st, soft, geo,
                                                       cached, need)
        cat_pos, cat_mass, cat_soft, cat_alive = cat
        gvalid = cat_alive[p.n_max:]
        if gr is not None:
            st = dataclasses.replace(st, grids=dataclasses.replace(
                gr, grav=(cl, rows),
                grav_disp=torch.zeros_like(gr.grav_disp) if need
                else gr.grav_disp,
                grav_count=count_now))
        self.last_rebuilt["grav"] = need
        soa = pack_cells_abs(cl, cat_pos, cat_mass, cat_soft, cat_alive)
        # the step's activity as A's tile flags: ghosts are sources only
        flags = grav_tile_flags(cl, torch.cat(
            [active, torch.zeros_like(gvalid)]))
        label = "kernel A (slab mode" + (", potential)" if self.want_pot
                                         else ")")
        out = self._timed(label, shortrange_gravity_slab, soa, flags,
                          n_cells, box, self.periodic3, self.asmth_len,
                          self.rcut, self.want_pot)
        n_rows = 4 if self.want_pot else 3
        rows_sr = merge_rows(out, cl, n_rows)
        rows_sr = torch.where(cat_alive[:, None], rows_sr,
                              torch.zeros_like(rows_sr))[:p.n_max]
        oflags = st.overflow_flags | ((cl.overflow | ovf).to(torch.int32))

        acc = rows_sr[:, :3] * cfg.grav_internal
        if not self.per and cfg.comoving_integration_on:
            # a comoving vacuum run: the homogeneous background's term, as
            # on one device [G2: gravtree.c comoving correction]
            acc = acc + (0.5 * cfg.omega0 * cfg.hubble_internal ** 2) * p.pos
        acc = torch.where(active[:, None], acc, p.acc)
        zero3 = torch.zeros_like(acc)
        acc = torch.where(p.alive[:, None], acc, zero3)
        acc_pm = torch.where(p.alive[:, None], acc_pm, zero3)
        pot_pm_g = pot * cfg.grav_internal
        if self.want_pot:
            # the full potential: the mesh's, the short-range sum and the
            # PM self-term m / (sqrt(pi) asmth) taken out [JAX spmd.py:926]
            pot_full = (pot + rows_sr[:, 3] + p.mass
                        / (math.sqrt(math.pi) * self.asmth_len)) \
                * cfg.grav_internal
        else:
            pot_full = pot_pm_g
        total = acc + acc_pm
        p = dataclasses.replace(
            p, acc=acc, acc_pm=acc_pm, pot=pot_full, pot_pm=pot_pm_g.clone(),
            old_acc=torch.sqrt((total * total).sum(-1)))
        return dataclasses.replace(st, p=p, overflow_flags=oflags), active

    def _grav_lists(self, st: SimState, soft, geo: dict, cached, need: bool):
        """The gravity grid of a sync point: the ghost rows (fresh where
        ``need``, else the cached ones), their exchange, the [locals |
        ghosts] arrays in the grids' frame, and the cell list (fresh or
        cached). Returns (cell list, ghost rows, ghost overflow, (pos,
        mass, soft, alive) of the concatenation, cells per axis)."""
        p, box = st.p, self.box
        gcap, margin_g = geo["gcap_g"], geo["margin_g"]
        reach_w = self.rcut + margin_g
        n_cells = (geo["nx"], geo["nyz_g"], geo["nyz_g"])
        if need:
            rows, ovf = _ghost_rows_select(
                self._wx(p.pos[:, 0]), p.alive, self.x0, self.x1, reach_w,
                gcap)
        else:
            rows, ovf = cached[1], torch.zeros((), dtype=torch.bool,
                                               device=p.pos.device)
        ghosts, gvalid = self._timed(
            "ghosts (gravity)", _ghost_exchange_rows, self.ring,
            [p.pos, p.mass, soft], p.alive, rows, gcap)
        gpos, gmass, gsoft = ghosts
        gpos = self._dompos(gpos).clone()
        gpos[:, 0], gvalid = self._fix_ghost_x(gpos[:, 0], reach_w + margin_g,
                                               gvalid, gcap)
        lpos = self._local_pos(p.pos)
        cat_pos = torch.cat([lpos, gpos])
        cat_mass = torch.cat([p.mass, gmass])
        cat_soft = torch.cat([soft, gsoft])
        cat_alive = torch.cat([p.alive, gvalid])
        if need:
            f32 = lpos.dtype
            zero = torch.zeros((), dtype=f32, device=lpos.device)
            origin = torch.stack([self.x0 - self.rcut, zero, zero])
            extent = torch.stack([(self.x1 - self.x0) + 2.0 * self.rcut,
                                  zero + box, zero + box])
            cl = build_cell_list(cat_pos, cat_alive, origin, extent,
                                 n_cells=n_cells, capacity=geo["cap_sr"],
                                 periodic=self.periodic3)
        else:
            cl = cached[0]
        return cl, rows, ovf, (cat_pos, cat_mass, cat_soft, cat_alive), \
            n_cells

    def probe(self, st: SimState) -> tuple:
        """The overflow bits that fresh slab structures would raise on
        ``st`` (ghost selections, the gravity grid and the SPH block
        lists, built and dropped; no force computed), OR-ed over the ring:
        (the lists', the ghost buffers'), 1 for gravity, 2 for SPH."""
        p = st.p
        fac = comoving_factors(self.cfg, st.ti_current)
        soft = SOFTFAC * softening_table(self.cfg, fac.atime)[p.ptype.long()]
        geo = self.geometry(st)
        cl, _, ovf, _, _ = self._grav_lists(st, soft, geo, None, True)
        bits = cl.overflow.to(torch.int32) | ovf.to(torch.int32) * 4
        if st.n_gas_max > 1:
            if self.cells:
                cl_s, _, ovf_s, _ = self._sph_cells_lists(st, geo)
            else:
                cls, _, ovf_s, _ = self._sph_lists(st, geo, None, True)
                cl_s = cls[0]
            bits = bits | cl_s.overflow.to(torch.int32) * 2 \
                | ovf_s.to(torch.int32) * 8
        bits = int(self.ring.or_bits(bits))
        return bits & 3, bits >> 2

    # -- SPH on anisotropic blocks ---------------------------------------
    def sph(self, st: SimState, active):
        """The SPH of a sync point: the coarse cells under
        ``sph_backend="cells"`` (:meth:`_sph_cells`), the anisotropic
        blocks under every other backend."""
        if self.cells:
            return self._sph_cells(st, active)
        return self._sph_blocks(st, active)

    def _sph_blocks(self, st: SimState, active):
        cfg, box = self.cfg, self.box
        gas, p = st.gas, st.p
        ng = gas.n_gas_max
        fac = comoving_factors(cfg, st.ti_current)
        gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
        active_g = active[:ng] & gas_mask
        eps_gas = softening_table(cfg, fac.atime)[0]
        min_hsml = cfg.min_gas_hsml_fractional * SOFTFAC * eps_gas
        geo = self.geometry(st)
        subcell, max_hsml = geo["subcell"], geo["max_hsml"]
        gcap = geo["gcap_s"]
        h0 = gas.hsml.clamp(max=max_hsml)
        gr = st.grids
        count_now = gas_mask.sum().to(torch.int32)
        cached = None if gr is None else gr.sph
        need = True if gr is None else self._need(
            cached, gr.sph_disp, gr.sph_count, count_now, geo["margin_s"])
        cls, rows, ovf1, cat = self._sph_lists(st, geo, cached, need)
        cat_pos, cat_vel, cat_mass, cat_mask = cat
        gv = cat_mask[ng:]
        # ghosts are sources only: the activity (the target gate) ends at
        # the local block
        act_cat = torch.cat([active_g, torch.zeros_like(gv)])
        h_cat = torch.cat([h0, torch.ones(2 * gcap, dtype=h0.dtype,
                                          device=h0.device)])
        if gr is not None:
            st = dataclasses.replace(st, grids=dataclasses.replace(
                st.grids, sph=(cls[0], cls[1], rows),
                sph_disp=torch.zeros_like(gr.sph_disp) if need
                else gr.sph_disp,
                sph_count=count_now))
        self.last_rebuilt["sph"] = need
        dres, _ = self._timed(
            "density", density_adaptive_blocks, cat_pos, cat_vel, cat_mass,
            h_cat, cat_mask, cfg.des_num_ngb, cfg.max_num_ngb_deviation, box,
            cls, max_hsml, min_hsml, act_cat, subcell)

        def hydro(*fields):
            return hydro_force_blocks(
                cls, cat_pos, cat_vel, cat_mass, *fields,
                cfg.art_bulk_visc_const, box, fac.hubble_a2_flow,
                fac.hubble_a2_norm, fac.fac_mu, act_cat, subcell)
        return self._sph_hydro(st, active_g, dres, rows, gv, gcap, hydro,
                               cls[0].overflow | ovf1)

    def _sph_hydro(self, st: SimState, active_g, dres, rows, gv, gcap: int,
                   hydro, ovf):
        """The tail of both SPH branches: the density results kept for the
        active gas ``active_g``, the pressure, the second ghost round (the
        density fields, on the first round's rows ``rows``; ``gv`` the
        first round's ghost mask), the hydro pass ``hydro(h, rho, pressure,
        dhsml, div v, curl v, mask)`` over [locals | ghosts], and the state
        with the SPH fields and overflow bit 2 where ``ovf``."""
        gas, p = st.gas, st.p
        ng = gas.n_gas_max
        gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)

        def keep(new, old):
            return torch.where(active_g, new[:ng], old)
        rho = keep(dres.rho, gas.density)
        hsml = keep(dres.hsml, gas.hsml)
        dhf = keep(dres.dhsml_factor, gas.dhsml_density_factor)
        divv = keep(dres.div_vel, gas.div_vel)
        curlv = keep(dres.curl_vel, gas.curl_vel)
        nngb = keep(dres.num_ngb_eff, gas.num_ngb)
        pressure = gas.entropy_pred * (rho if self.opts.isotherm_eqs
                                       else rho ** GAMMA)
        pressure = torch.where(gas_mask, pressure, torch.zeros_like(pressure))

        # round 2: the density fields, on the same row selection
        ghosts2, gv2 = self._timed(
            "ghosts (SPH 2)", _ghost_exchange_rows, self.ring,
            [hsml, rho, pressure, dhf, divv, curlv], gas_mask, rows, gcap)
        local = [hsml, rho, pressure, dhf, divv, curlv]
        hres = self._timed(
            "hydro", hydro, *[torch.cat([a, g]) for a, g in zip(local,
                                                                 ghosts2)],
            torch.cat([gas_mask, gv2 & gv]))
        hydro_acc = torch.where(active_g[:, None], hres.acc[:ng],
                                gas.hydro_acc)
        dt_entropy = keep(hres.dt_entropy, gas.dt_entropy)
        if self.opts.isotherm_eqs:
            dt_entropy = torch.zeros_like(dt_entropy)
        msv = keep(hres.max_signal_vel, gas.max_signal_vel)
        flags = st.overflow_flags | (ovf.to(torch.int32) * 2)
        gas = dataclasses.replace(
            gas, density=rho, hsml=hsml, pressure=pressure, div_vel=divv,
            curl_vel=curlv, dhsml_density_factor=dhf, num_ngb=nngb,
            hydro_acc=hydro_acc, dt_entropy=dt_entropy,
            max_signal_vel=msv)
        return dataclasses.replace(st, gas=gas, overflow_flags=flags)

    def _sph_lists(self, st: SimState, geo: dict, cached, need: bool):
        """The SPH blocks of a sync point: the ghost rows (fresh where
        ``need``, else the cached ones), the first ghost round (positions,
        velocities, masses), the [locals | ghosts] arrays in the slab's
        grids' frame and the (even, odd) block lists on the anisotropic grid
        (fresh or cached). Returns (lists, ghost rows, ghost overflow,
        (pos, vel, mass, mask) of the concatenation)."""
        p, gas, box = st.p, st.gas, self.box
        ng = gas.n_gas_max
        gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
        subcell, reach = geo["subcell"], geo["subcell"]
        # the x block count covers the widest slab; narrower slabs carry
        # empty trailing blocks (their flags are 0)
        nb3 = (geo["nbx"], geo["nb_g"], geo["nb_g"])
        gcap = geo["gcap_s"]
        if need:
            rows, ovf = _ghost_rows_select(
                self._wx(p.pos[:ng, 0]), gas_mask, self.x0, self.x1, reach,
                gcap)
        else:
            rows, ovf = cached[2], torch.zeros((), dtype=torch.bool,
                                               device=p.pos.device)
        # round 1: positions and velocities for the density solve
        ghosts, gv = self._timed(
            "ghosts (SPH 1)", _ghost_exchange_rows, self.ring,
            [p.pos[:ng], gas.vel_pred, p.mass[:ng]], gas_mask, rows, gcap)
        gpos, gvel, gmass = ghosts
        gpos = self._dompos(gpos).clone()
        gpos[:, 0], gv = self._fix_ghost_x(gpos[:, 0], reach + geo["margin_s"],
                                           gv, gcap)
        lpos = self._local_pos(p.pos[:ng])
        cat_pos = torch.cat([lpos, gpos])
        cat_mask = torch.cat([gas_mask, gv])
        if need:
            f32 = lpos.dtype
            zero = torch.zeros((), dtype=f32, device=lpos.device)
            origin3 = torch.stack([self.x0 - reach, zero, zero])
            extent3 = torch.tensor([2.0 * nb3[0] * subcell, box, box],
                                   dtype=f32, device=lpos.device)
            cls = build_block_lists(cat_pos, cat_mask, origin3, extent3,
                                    n_blocks=nb3, subcap=geo["subcap"],
                                    periodic=self.periodic3)
        else:
            cls = cached[:2]
        return cls, rows, ovf, (cat_pos, torch.cat([gas.vel_pred, gvel]),
                                torch.cat([p.mass[:ng], gmass]), cat_mask)

    # -- SPH on coarse cells (kernels I/J and K, ghost rows) -------------
    def _sph_cells(self, st: SimState, active):
        """The reference's coarse-cell branch of ``_sph``
        (``parallel/spmd.py:1129-1313``): ghosts within one cell edge in two
        rounds on one row selection, one cell list over (nx_c, n_c, n_c)
        cells clamped in x, kernel I/J's ghost-row mode for the density
        solve with this rank's gas as the targets, and kernel K's on the
        same list for hydro. Everything is built fresh at every sync point,
        as in the reference; all gas is solved and the active gas keeps the
        results."""
        cfg, box = self.cfg, self.box
        gas, p = st.gas, st.p
        ng = gas.n_gas_max
        fac = comoving_factors(cfg, st.ti_current)
        gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
        active_g = active[:ng] & gas_mask
        eps_gas = softening_table(cfg, fac.atime)[0]
        min_hsml = cfg.min_gas_hsml_fractional * SOFTFAC * eps_gas
        geo = self.geometry(st)
        cell, gcap = geo["cell_c"], geo["gcap_c"]
        cl, rows, ovf1, cat = self._sph_cells_lists(st, geo)
        cat_pos, cat_vel, cat_mass, cat_mask = cat
        h_cat = torch.cat([gas.hsml.clamp(max=cell),
                           torch.ones(2 * gcap, dtype=gas.hsml.dtype,
                                      device=gas.hsml.device)])
        self.last_rebuilt["sph"] = True
        dres, _ = self._timed(
            "density", density_adaptive_cells, cat_pos, cat_vel, cat_mass,
            h_cat, cat_mask, cfg.des_num_ngb, cfg.max_num_ngb_deviation, box,
            cl.n_cells, cl.cells.shape[1], min_hsml, cell, cl.periodic, 0.0,
            None, ng, cl)

        # the hydro pass reuses the density pass's list (the reference's
        # cl2 = cl: the positions and the mask are round 1's)
        def hydro(*fields):
            return hydro_force_cells(
                cl, cat_pos, cat_vel, cat_mass, *fields,
                cfg.art_bulk_visc_const, box, fac.hubble_a2_flow,
                fac.hubble_a2_norm, fac.fac_mu, ng)
        return self._sph_hydro(st, active_g, dres, rows, cat_mask[ng:], gcap,
                               hydro, cl.overflow | ovf1)

    def _sph_cells_lists(self, st: SimState, geo: dict):
        """The coarse cells of a sync point: a fresh ghost-row selection
        within one cell edge of each face, the first ghost round
        (positions, velocities, masses), the [locals | ghosts] arrays in
        the slab's grids' frame and the cell list over (nx_c, n_c, n_c)
        cells on [x0 - cell, x1 + cell) x [0, box)^2. Returns (list, ghost
        rows, ghost overflow, (pos, vel, mass, mask) of the
        concatenation)."""
        p, gas, box = st.p, st.gas, self.box
        ng = gas.n_gas_max
        gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
        cell, gcap = geo["cell_c"], geo["gcap_c"]
        rows, ovf = _ghost_rows_select(self._wx(p.pos[:ng, 0]), gas_mask,
                                       self.x0, self.x1, cell, gcap)
        ghosts, gv = self._timed(
            "ghosts (SPH 1)", _ghost_exchange_rows, self.ring,
            [p.pos[:ng], gas.vel_pred, p.mass[:ng]], gas_mask, rows, gcap)
        gpos, gvel, gmass = ghosts
        gpos = self._dompos(gpos).clone()
        gpos[:, 0], gv = self._fix_ghost_x(gpos[:, 0], cell, gv, gcap)
        lpos = self._local_pos(p.pos[:ng])
        cat_pos = torch.cat([lpos, gpos])
        cat_mask = torch.cat([gas_mask, gv])
        f32 = lpos.dtype
        zero = torch.zeros((), dtype=f32, device=lpos.device)
        origin3 = torch.stack([self.x0 - cell, zero, zero])
        extent3 = torch.stack([self.x1 - self.x0 + 2.0 * cell,
                               zero + box, zero + box])
        cl = build_cell_list(cat_pos, cat_mask, origin3, extent3,
                             n_cells=(geo["nx_c"], geo["n_c"], geo["n_c"]),
                             capacity=geo["cap_c"], periodic=self.periodic3)
        return cl, rows, ovf, (cat_pos, torch.cat([gas.vel_pred, gvel]),
                               torch.cat([p.mass[:ng], gmass]), cat_mask)

    # -- the fork's physics ---------------------------------------------
    def ring_sinks(self, st: SimState):
        """(pos [U, 3], mass [U]) of the registered sinks of the whole
        ring, in the registry's order of its used slots: each gathered by
        its PID from the rank that holds it (one sum over the ring of a
        [U, 4] block, float64, in which every slot has one term); None
        where no slot is used."""
        p, slot = st.p, st.sinks.slot
        used = slot[slot >= 0]
        if used.numel() == 0:
            return None
        hit = (p.pid[None, :] == used[:, None].to(p.pid.dtype)) \
            & p.alive[None, :]                           # [U, N]
        mine = hit.any(1)
        idx = torch.where(mine, hit.to(torch.int32).argmax(1),
                          torch.zeros_like(used, dtype=torch.int64))
        block = torch.cat([p.pos[idx], p.mass[idx, None]], 1).double()
        block = torch.where(mine[:, None], block, torch.zeros_like(block))
        block = self.ring.psum(block)
        return block[:, :3].to(p.pos.dtype), block[:, 3].to(p.mass.dtype)

    def cool(self, st: SimState) -> SimState:
        """``models/cooling.py :: apply_cooling`` on this rank's gas, the
        Stamatellos point-mass term over the ring's registered sinks
        (:meth:`ring_sinks`)."""
        return apply_cooling(st, self.cfg, self.opts,
                             sink_points=self.ring_sinks(st))

    def sinks(self, st: SimState) -> SimState:
        """Sink formation and accretion across the ring (``_sinks`` of the
        reference): see the module docstring."""
        if self.cfg.sink_formation_density > 0:
            st = self._form_sink(st)
        if self.cfg.sink_accretion_radius > 0:
            st = self._accrete(st)
        return st

    def _u_gas(self, gas):
        rho_safe = torch.clamp(gas.density, min=1e-30)
        return gas.entropy_pred * rho_safe ** GAMMA_MINUS1 / GAMMA_MINUS1

    def _form_sink(self, st: SimState) -> SimState:
        """The ring's densest candidate (the greatest density over the
        ring, its lowest rank on ties, the first row there) becomes a sink
        where no gas within SinkAccretionRadius of it lies deeper in the
        potential and a registry slot is free (``models/sinks.py ::
        create_sinks``'s tests)."""
        cfg, opts, ring = self.cfg, self.opts, self.ring
        p, gas, sinks = st.p, st.gas, st.sinks
        ng = gas.n_gas_max
        gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
        pot = p.pot[:ng]
        psi_mag = torch.clamp(-pot, min=1e-30)
        cand = (gas_mask & (gas.density > cfg.sink_formation_density)
                & (gas.div_vel < 0.0) & (self._u_gas(gas) <= 0.5 * psi_mag))
        rho_c = torch.where(cand, gas.density,
                            torch.full_like(gas.density, -1.0))
        best = first_argmax(rho_c)
        rho_l = rho_c[best]
        rho_g = ring.pmax(rho_l)
        if not bool(rho_g > 0.0):          # the ring's value: all agree
            return st
        owner = ring.pmin(torch.where(
            rho_l == rho_g, torch.tensor(self.me, device=rho_l.device),
            torch.tensor(self.d, device=rho_l.device)))
        is_owner = bool(owner == self.me)
        # the candidate's position, potential and PID, from its owner
        mine = torch.cat([p.pos[best].double(), pot[best, None].double(),
                          p.pid[best, None].double()]) if is_owner \
            else torch.zeros(5, dtype=torch.float64, device=p.pos.device)
        won = ring.psum(mine)
        bpos = won[:3].to(p.pos.dtype)
        bpot = won[3].to(pot.dtype)
        new_pid = won[4].round().to(p.pid.dtype)
        r_acc = max(cfg.sink_accretion_radius, 0.0)
        dxb = min_image(p.pos[:ng] - bpos[None, :], cfg, opts)
        near = gas_mask & (dot3(dxb, dxb) < r_acc * r_acc)
        if is_owner:
            near[best] = False
        deeper = ring.psum((near & (pot < bpot)).sum().to(torch.int32))
        free = sinks.slot < 0
        if bool(deeper > 0) or not bool(free.any()):
            return st
        free_slot = first_argmax(free.to(torch.int32))
        slot = sinks.slot.clone()
        slot[free_slot] = new_pid.to(slot.dtype)
        ptype = p.ptype
        if is_owner:
            ptype = ptype.clone()
            ptype[best] = 5
        return dataclasses.replace(
            st, p=dataclasses.replace(p, ptype=ptype),
            sinks=dataclasses.replace(sinks, slot=slot))

    def _accrete(self, st: SimState) -> SimState:
        """Accretion by export, evaluate and return: each rank's
        registered sinks (compacted to the registry's used slots U) go to
        both neighbours; every rank tests its own gas against [its own |
        from the left | from the right] sinks by ``models/sinks.py ::
        accrete_onto_sinks``'s criteria, each gas particle going to the
        nearest claiming sink, the first on ties (its own rows first, so
        the copies a ring of one or two sends itself claim nothing); the
        claims on the neighbours' sinks go back to their owners. The
        registry's tallies are sums over the ring (one owner a sink)."""
        cfg, opts, ring = self.cfg, self.opts, self.ring
        p, gas, sinks = st.p, st.gas, st.sinks
        slot = sinks.slot
        u = int((slot >= 0).sum())
        if u == 0:                          # the registry is the ring's
            return st
        ng = gas.n_gas_max
        dev = p.pos.device
        gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
        reg = slot[slot >= 0]
        in_reg = (p.pid[:, None] == reg[None, :].to(p.pid.dtype)).any(1)
        sink_mask = p.alive & (p.ptype == 5) & in_reg
        idx_s, ovf_s = _select_rows(sink_mask, u)
        valid_s = idx_s >= 0
        i_s = idx_s.clamp_min(0).long()
        zero = torch.zeros((), dtype=p.pos.dtype, device=dev)
        spos = torch.where(valid_s[:, None], p.pos[i_s], zero)
        svel = torch.where(valid_s[:, None], p.vel[i_s], zero)
        smass = torch.where(valid_s, p.mass[i_s], zero)
        spid = torch.where(valid_s, p.pid[i_s], torch.full_like(p.pid[i_s],
                                                                -1))
        bufs = [spos, svel, smass, valid_s.to(torch.int32)]
        from_l = ring.ring(bufs, +1)
        from_r = ring.ring(bufs, -1)
        cpos = torch.cat([spos, from_l[0], from_r[0]])
        cvel = torch.cat([svel, from_l[1], from_r[1]])
        cmass = torch.cat([smass, from_l[2], from_r[2]])
        cvalid = torch.cat([valid_s, from_l[3] > 0, from_r[3] > 0])

        dx = min_image(cpos[:, None, :] - p.pos[None, :ng, :], cfg, opts)
        r2 = dot3(dx, dx)                                  # [3U, Ng]
        dv = cvel[:, None, :] - p.vel[None, :ng, :]
        inside = r2 < cfg.sink_accretion_radius ** 2
        approaching = dot3(dv, dx) < 0
        v2 = dot3(dv, dv)
        eps = cfg.softenings[5]
        r_soft = torch.sqrt(r2 + eps * eps)
        bound = 0.5 * v2 + self._u_gas(gas)[None, :] \
            < cfg.grav_internal * cmass[:, None] / r_soft
        take = inside & approaching & bound & gas_mask[None, :] \
            & cvalid[:, None]
        r2m = torch.where(take, r2, torch.full_like(r2, 1e30))
        rank = torch.arange(3 * u, device=dev)[:, None]
        winner = torch.where(r2m == r2m.min(0).values, rank,
                             3 * u).min(0).values
        any_take = take.any(0)
        claim = (rank == winner[None, :]) & any_take[None, :]
        m_g = torch.where(gas_mask, p.mass[:ng], torch.zeros_like(p.mass[:ng]))
        w = torch.where(claim, m_g[None, :], torch.zeros_like(r2))
        dm = w.sum(1)                                      # [3U]
        dp = (w[:, :, None] * p.vel[None, :ng, :]).sum(1)  # [3U, 3]
        n_acc = claim.sum(1).to(torch.int32)

        # the claims on the neighbours' sinks go back to their owners
        ret_r = ring.ring([dm[u:2 * u], dp[u:2 * u], n_acc[u:2 * u]], -1)
        ret_l = ring.ring([dm[2 * u:], dp[2 * u:], n_acc[2 * u:]], +1)
        dm_t = dm[:u] + ret_r[0] + ret_l[0]
        dp_t = dp[:u] + ret_r[1] + ret_l[1]
        n_t = n_acc[:u] + ret_r[2] + ret_l[2]

        new_mass = smass + dm_t
        new_vel = (smass[:, None] * svel + dp_t) \
            / torch.clamp(new_mass, min=1e-30)[:, None]
        rows = i_s[valid_s]
        mass = p.mass.clone()
        vel = p.vel.clone()
        mass[rows] = new_mass[valid_s]
        vel[rows] = new_vel[valid_s]
        alive = p.alive.clone()
        alive[:ng] = p.alive[:ng] & ~any_take
        # the registry's tallies: each slot's sink has one owner, so the
        # ring's sum of [U, 2] blocks (float64: one term a slot) is exact
        match = (slot[:, None].to(p.pid.dtype) == spid[None, :]) \
            & valid_s[None, :] & (slot[:, None] >= 0)     # [S, U]
        mt = match.to(torch.float64)
        tallies = ring.psum(torch.stack([mt @ dm_t.double(),
                                         mt @ n_t.double()], 1))
        sinks = dataclasses.replace(
            sinks, acc_mass=sinks.acc_mass + tallies[:, 0].to(
                sinks.acc_mass.dtype),
            n_accreted=sinks.n_accreted + tallies[:, 1].round().to(
                sinks.n_accreted.dtype))
        flags = st.overflow_flags | (ovf_s.to(torch.int32) * 8)
        return dataclasses.replace(
            st, p=dataclasses.replace(p, mass=mass, vel=vel, alive=alive),
            sinks=sinks, overflow_flags=flags)

    # -- the sync point ------------------------------------------------------
    def __call__(self, st: SimState) -> SimState:
        cfg, opts = self.cfg, self.opts
        ti_local = timeline.min_active_ti_end(st.p.ti_endstep, st.p.alive)
        ti_next = torch.minimum(self.ring.pmin(ti_local), st.pm_ti_endstep)
        x_prev = st.p.pos[:, 0]
        st = self._timed("drift", integrate.drift_all, st, cfg, opts,
                         ti_next)
        if self.per and self.d == 1 and st.grids is not None and bool(
                (((st.p.pos[:, 0] - x_prev).abs() > 0.5 * self.box)
                 & st.p.alive).any()):
            # a ring of one: a particle that crossed x = 0 / box stays on
            # its rank (no migration drops the cache), but the slab's x
            # axis is clamped, so a cached list would keep it in a cell at
            # the other face, and its cached ghost copy inside the slab;
            # the JAX package keeps both (ROADMAP queue 3)
            st = dataclasses.replace(st, grids=dataclasses.replace(
                st.grids, grav=None, sph=None))
        is_pm_step = bool(st.ti_current == st.pm_ti_endstep)
        st = self._timed("migrate", self.migrate, st)
        st, active = self._timed("gravity", self.gravity, st, is_pm_step)
        if st.n_gas_max > 1:
            st = self._timed("SPH", self.sph, st, active)
        if opts.cooling != "none":
            st = self._timed("cooling", self.cool, st)
        if opts.sinks:
            st = self._timed("sinks", self.sinks, st)
        st = self._timed("kick", integrate.advance_and_find_timesteps, st,
                         cfg, opts)
        st = integrate.pm_step_update(st, cfg, opts, is_pm_step,
                                      ring=self.ring, pm_box=self.box)
        # the overflow bits are the rank's own: OR them over the ring so
        # every rank sees every rank's trouble
        return dataclasses.replace(
            st, overflow_flags=self.ring.or_bits(st.overflow_flags))
