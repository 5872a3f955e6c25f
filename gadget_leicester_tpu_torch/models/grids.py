"""Persistent stale-tolerant neighbour grids [G2: domain.c — the tree and
domain are rebuilt on a cadence, not every sync point].

Counterpart of ``gadget_leicester_tpu/models/grids.py`` (``GridCache``,
``grav_grid_geometry``, ``sph_blocks_geometry``, ``sph_cells_geometry``,
``make_grid_cache``, ``note_drift``, ``refresh``). The cell ASSIGNMENTS are cached across sync
points; pair forces always read fresh positions. A pair within range r is
found while r + 2 * (displacement since the build) <= cell edge, so each
grid carries a margin and a running displacement, and is rebuilt when
2 * disp > margin or the alive count changed. Where the JAX package
traces that decision with ``lax.cond``, :func:`refresh` reads one host
boolean. The SPH block lists of a vacuum grid are re-fitted to the gas
bounding cube at each rebuild, and their margin is 2 kappa times the
cached lists' fine edge (``models/forces.py::_sph_blocks``); accretion
changes the gas count and so rebuilds them.

Geometry: the short-range and coarse-cell SPH capacities are rounded up
to 128 on every device, as the JAX package's Pallas path does; its CPU
branch's ``8 N / n^3`` and ``6 N / n^3`` capacities are not used. Results
do not depend on capacity while no cell overflows. The coarse-cell SPH
list is not cached: every force pass builds it fresh, so its h cap is the
whole cell edge (the ``sph`` slot of the cache stays None for it, and for
the all-pairs backend).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from gadget_leicester_tpu_torch.core.config import SimConfig, SimOptions
from gadget_leicester_tpu_torch.ops.neighbors import CellList

# SPH staleness margin as a fraction of the fine-cell edge: h is capped at
# (1 - 2 kappa) * subcell, leaving 2 kappa * subcell for the two pair ends
KAPPA_SPH = 0.05
# gravity soft-margin floor, as a fraction of rcut
SOFT_RCUT_FRAC = 0.08


@dataclass
class GridCache:
    """Cached neighbour structures and staleness bookkeeping."""

    grav: Optional[CellList]            # short-range gravity grid
    sph: Optional[tuple]                # (even, odd) SPH block lists
    grav_disp: torch.Tensor             # 0-d f32: displacement since build
    sph_disp: torch.Tensor
    grav_count: torch.Tensor            # 0-d int32: alive count at build
    sph_count: torch.Tensor             # 0-d int32: alive gas at build


def resolve_gravity_mode(opts: SimOptions, n_max: int) -> str:
    """The static gravity dispatch of compute_forces."""
    mode = opts.gravity_mode
    if mode == "auto":
        if opts.periodic:
            mode = "treepm" if opts.pmgrid > 0 else "tree"
        else:
            mode = "direct" if n_max <= opts.direct_threshold else "tree"
    return mode


def resolve_sph_backend(opts: SimOptions, ng: int) -> str:
    """``auto`` picks dense at <= 4096 gas slots and blocks above, as the
    JAX package does with its kernels on."""
    if opts.sph_backend == "auto":
        return "dense" if ng <= 4096 else "blocks"
    return opts.sph_backend


def grav_grid_geometry(cfg: SimConfig, opts: SimOptions, n_max: int):
    """(n_cells, capacity, margin) of the periodic TreePM short-range
    grid; the capacity is rounded up to a multiple of 128."""
    from gadget_leicester_tpu_torch.ops.pm import ASMTH, RCUT
    box = float(cfg.box_size)
    asmth_len = ASMTH * box / opts.pmgrid
    rcut = RCUT * asmth_len
    n_cells = max(3, int(box / rcut))
    cap_hint = opts.sr_capacity if opts.sr_capacity > 0 else 128
    while n_cells > 4 and n_max / (n_cells - 1) ** 3 <= 0.80 * cap_hint:
        n_cells -= 1
    margin = max(box / n_cells - rcut, SOFT_RCUT_FRAC * rcut)
    cap = max(128, ((cap_hint + 127) // 128) * 128)
    return n_cells, cap, margin


def sph_blocks_geometry(cfg: SimConfig, opts: SimOptions, ng: int):
    """(n_blocks, subcap) of the block-packed SPH path."""
    subcap = opts.sph_capacity if opts.sph_capacity > 0 else 32
    if opts.sph_grid > 0:
        n_blocks = max(2, opts.sph_grid // 2)
    else:
        n_blocks = max(2, int(round(
            (ng / (8 * 0.78 * subcap)) ** (1.0 / 3.0))))
    return n_blocks, subcap


def sph_cells_geometry(cfg: SimConfig, opts: SimOptions, ng: int):
    """(n_cells, capacity) of the coarse-cell SPH path: a mean occupancy
    of ~100 gas particles per cell (a cell edge of ~4.6 interparticle
    spacings, above the h of ~2 spacings that DesNumNgb 33-50 implies),
    the capacity rounded up to a multiple of 128."""
    if opts.sph_grid > 0:
        n_cells = opts.sph_grid
    else:
        n_cells = max(3, int(round((ng / 100.0) ** (1.0 / 3.0))))
    cap = opts.sph_capacity if opts.sph_capacity > 0 else 128
    return n_cells, max(128, ((cap + 127) // 128) * 128)


def make_grid_cache(device) -> GridCache:
    """An empty cache: the first force pass builds both grids."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    c = torch.full((), -1, dtype=torch.int32, device=device)
    return GridCache(grav=None, sph=None, grav_disp=z, sph_disp=z.clone(),
                     grav_count=c, sph_count=c.clone())


def note_drift(grids: Optional[GridCache], dx_max) -> Optional[GridCache]:
    """Add this drift's max per-particle |dx|_inf to both counters."""
    if grids is None:
        return None
    d = dx_max.to(torch.float32)
    return dataclasses.replace(grids, grav_disp=grids.grav_disp + d,
                               sph_disp=grids.sph_disp + d)


def refresh(cached, disp: torch.Tensor, count: torch.Tensor, margin: float,
            count_now: torch.Tensor, build_fn):
    """Rebuild-on-demand: returns (structure, disp', count', rebuilt). One
    host boolean decides, where the JAX package traces ``lax.cond``."""
    need = cached is None or bool((2.0 * disp > margin)
                                  | (count_now != count))
    if need:
        return build_fn(), torch.zeros_like(disp), count_now, True
    return cached, disp, count, False
