"""Cell tiles for TreePM short-range gravity, the active-entry lists, and
the wrappers of kernels A, E, H and M.

Counterpart of ``gadget_leicester_tpu/ops/pallas_cells.py``:
``pack_cells_soa`` (:38; relative mode here :func:`pack_cells_soa`,
absolute mode :func:`pack_cells_abs`), ``_cell_centers`` (:92),
``cell_activity_flags`` (:423), ``shortrange_gravity_pallas_dma9``
(:669, here :func:`shortrange_gravity_tiles`), ``grav_tile_flags``
(:741), ``ENTRY_LANES`` (:758), ``count_active_entries`` (:790),
``build_active_entries`` (:801), ``shortrange_gravity_pallas_entries``
(:973, here :func:`gravity_entries` around the kernel wrapper
:func:`shortrange_gravity_entries`) and ``shortrange_gravity_pallas_dma``
(:433, with_potential, here :func:`shortrange_potential_tiles`) and the
kernel call of ``shortrange_gravity_pallas`` (:1581, here
:func:`shortrange_gravity_cells`; its entry is ``ops/gravity_short.py ::
shortrange_gravity_fresh``).

Kernel A (``csrc/shortrange_gravity.cu``) takes the ``[C, 8, cap]`` pack
directly and walks the 27 neighbour cells itself; the TPU kernel's
z-padded column layout is a DMA device and is not carried over. Kernel E
(``csrc/shortrange_gravity_entries.cu``) runs A's physics for the few
active targets of each entry against the same pack. Kernel H
(``csrc/shortrange_potential.cu``) adds the potential row to A's sums,
for the full potential of the diagnostics. Kernel M
(``csrc/shortrange_gravity_cells.cu``) sums the same pair force on the
absolute pack with a per-pair minimum image, on a periodic or a clamped
grid. Their plain versions are in ``ops/gravity_short.py``.
"""

from __future__ import annotations

import torch

from gadget_leicester_tpu_torch import kernels
from gadget_leicester_tpu_torch.ops.gravity_short import (
    shortrange_gravity_cells_plain, shortrange_gravity_entries_plain,
    shortrange_gravity_tiles_plain, shortrange_potential_tiles_plain)
from gadget_leicester_tpu_torch.ops.neighbors import (CellList,
                                                      scatter_rows)

# Target lanes per active entry: at the measured ~2 active particles per
# active cell, one entry holds a cell's active targets ~99% of the time.
ENTRY_LANES = 8


def cell_centers(cl: CellList) -> torch.Tensor:
    """[C, 3] geometric centres of the grid cells."""
    n = cl.n_cells
    c_arr = torch.arange(n ** 3, dtype=torch.int32, device=cl.cells.device)
    f = cl.origin.dtype
    xyz = torch.stack([(c_arr // (n * n)).to(f), ((c_arr % (n * n)) // n).to(f),
                       (c_arr % n).to(f)], -1)
    return (xyz + 0.5) / cl.inv_cell + cl.origin


def _tile_rows(cl: CellList, idx, valid, centers, pos, mass,
               soft) -> torch.Tensor:
    """[..., L, 8] rows x, y, z (relative to ``centers`` [..., 3],
    minimum-imaged; absolute, as the particles hold them, when ``centers``
    is None), m, soft, 1, 1/soft, 0 of particles ``idx`` [..., L];
    slots that are not ``valid`` are parked at a FINITE offset of -7
    cells with m = 0: 1e30 would square to inf and leak NaN through
    0 * inf. The one arithmetic of the pack and of the entry targets."""
    i = idx.clamp_min(0).long()
    s = soft[i]
    rel = pos[i]
    if centers is not None:
        rel = rel - centers[..., None, :]
        ext = cl.n_cells / cl.inv_cell
        rel = rel - ext * torch.round(rel / ext)
    rest = torch.stack([mass[i], s, torch.ones_like(s),
                        torch.where(s > 0, 1.0 / s, torch.zeros_like(s)),
                        torch.zeros_like(s)], -1)
    rows = torch.cat([rel, rest], dim=-1)
    park = torch.zeros(8, dtype=rows.dtype, device=rows.device)
    park[:3] = -7.0 / cl.inv_cell[0]
    return torch.where(valid[..., None], rows, park)


def pack_cells_soa(cl: CellList, pos, mass, soft, alive) -> torch.Tensor:
    """[C, 8, cap] tiles of :func:`_tile_rows`, relative to each cell's
    centre."""
    valid = (cl.cells >= 0) & alive[cl.cells.clamp_min(0).long()]
    rows = _tile_rows(cl, cl.cells, valid, cell_centers(cl), pos, mass, soft)
    return rows.transpose(1, 2).contiguous()


def pack_cells_abs(cl: CellList, pos, mass, soft, alive) -> torch.Tensor:
    """[C, 8, cap] tiles of :func:`_tile_rows` in absolute coordinates
    (the reference's ``pack_cells_soa(..., relative=False)``): kernel M's
    pack, on a periodic or a clamped cell list."""
    valid = (cl.cells >= 0) & alive[cl.cells.clamp_min(0).long()]
    rows = _tile_rows(cl, cl.cells, valid, None, pos, mass, soft)
    return rows.transpose(1, 2).contiguous()


def cell_activity_flags(cl: CellList, active) -> torch.Tensor:
    """[C] int32: 1 where a cell holds an active particle."""
    idx = cl.cells.clamp_min(0).long()
    act = (cl.cells >= 0) & active[idx]
    return act.any(dim=1).to(torch.int32)


def grav_tile_flags(cl: CellList, active) -> torch.Tensor:
    """[C] int32 tile flags by an O(N) scatter over ``cell_of`` (valid for
    a stale cached list: it agrees with the cells the kernel walks)."""
    c = cl.n_cells ** 3
    co = torch.where(cl.cell_of >= 0, cl.cell_of,
                     torch.full_like(cl.cell_of, c)).long()
    out = torch.zeros(c + 1, dtype=torch.int32, device=co.device)
    out.scatter_reduce_(0, co, active.to(torch.int32), reduce="amax")
    return out[:c]


def _tiles_call(name: str, plain, n_rows: int, soa: torch.Tensor,
                flags: torch.Tensor, n_cells: int, box: float, asmth: float,
                rcut: float) -> torch.Tensor:
    """Check the arguments of tile kernel ``name`` (A or H), then run its
    plain version on CPU tensors or launch it on CUDA tensors: out [C,
    n_rows, cap]."""
    c, rows, cap = soa.shape
    if c != n_cells ** 3 or rows != 8:
        raise ValueError(f"soa shape {tuple(soa.shape)} does not match "
                         f"{n_cells}^3 cells of 8 rows")
    kernels.check(soa, "soa", torch.float32)
    kernels.check(flags, "flags", torch.int32, (c,), soa.device)
    kernels.note_call(name, (soa, flags, n_cells, box, asmth, rcut))
    if not kernels.on_cuda(soa, flags):
        return plain(soa, flags, n_cells, box, asmth, rcut)
    out = torch.empty(c, n_rows, cap, dtype=soa.dtype, device=soa.device)
    kernels.launch(name, soa.data_ptr(), flags.data_ptr(), out.data_ptr(),
                   n_cells, cap, box / n_cells, 0.5 / asmth, rcut * rcut)
    return out


def shortrange_gravity_tiles(soa: torch.Tensor, flags: torch.Tensor,
                             n_cells: int, box: float, asmth: float,
                             rcut: float) -> torch.Tensor:
    """Kernel A: short-range accelerations of the packed targets, [C, 3,
    cap], zeros in cells whose flag is 0. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    return _tiles_call("shortrange_gravity", shortrange_gravity_tiles_plain,
                       3, soa, flags, n_cells, box, asmth, rcut)


def shortrange_potential_tiles(soa: torch.Tensor, flags: torch.Tensor,
                               n_cells: int, box: float, asmth: float,
                               rcut: float) -> torch.Tensor:
    """Kernel H: [C, 4, cap], kernel A's accelerations as rows 0-2 and the
    erfc-truncated softened potential as row 3 (no G), zeros in cells
    whose flag is 0. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    return _tiles_call("shortrange_potential",
                       shortrange_potential_tiles_plain, 4, soa, flags,
                       n_cells, box, asmth, rcut)


def shortrange_gravity_cells(soa: torch.Tensor, n_cells: int, box: float,
                             periodic: bool, asmth: float,
                             rcut: float) -> torch.Tensor:
    """Kernel M: accelerations [C, 3, cap] (no G) of the slots of the
    absolute pack ``soa`` from the 27 cells around each, pairs with 0 < r <
    rcut, each pair's separation reduced to its minimum image on a
    periodic grid; a clamped grid (``periodic`` False) reduces nothing and
    skips stencil cells beyond its edge. ``asmth == 0`` switches the erfc
    truncation off. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    c, rows, cap = soa.shape
    if c != n_cells ** 3 or rows != 8:
        raise ValueError(f"soa shape {tuple(soa.shape)} does not match "
                         f"{n_cells}^3 cells of 8 rows")
    if n_cells < 3:
        raise ValueError("the 27-cell stencil needs n_cells >= 3: below it "
                         "a periodic stencil meets a cell twice")
    kernels.check(soa, "soa", torch.float32)
    kernels.note_call("shortrange_gravity_cells",
                      (soa, n_cells, box, periodic, asmth, rcut))
    if not kernels.on_cuda(soa):
        return shortrange_gravity_cells_plain(soa, n_cells, box, periodic,
                                              asmth, rcut)
    out = torch.empty(c, 3, cap, dtype=soa.dtype, device=soa.device)
    kernels.launch("shortrange_gravity_cells", soa.data_ptr(), out.data_ptr(),
                   n_cells, cap, box, int(bool(periodic)),
                   0.5 / asmth if asmth > 0.0 else 0.0, rcut)
    return out


# ---------------------------------------------------------------------------
# Active entries: the near-idle tier [G2: gravtree.c walks the active list]
# ---------------------------------------------------------------------------
def count_active_entries(cl: CellList, active,
                         lanes: int = ENTRY_LANES) -> torch.Tensor:
    """0-d: the entries :func:`build_active_entries` would need, the sum
    over cells of ceil(n_active / lanes), counted in O(N) through
    ``cell_of`` (an upper bound when a full cell dropped particles)."""
    c = cl.cells.shape[0]
    co = torch.where(cl.cell_of >= 0, cl.cell_of,
                     torch.full_like(cl.cell_of, c)).long()
    counts = torch.zeros(c + 1, dtype=torch.int32, device=co.device)
    counts.index_add_(0, co, active.to(torch.int32))
    return ((counts[:c] + lanes - 1) // lanes).sum()


def build_active_entries(cl: CellList, active, lanes: int, k_max: int):
    """Compact the active targets of each cell into entries of ``lanes``
    slots. Returns (entry_cell [k_max] int32, -1 padded; entry_slot
    [k_max, lanes] int32 slot-in-cell, -1 padded; total, the true entry
    count, which may exceed ``k_max``: the caller then takes the dense
    tier). A cell with more than ``lanes`` active targets spills into
    consecutive entries of the same cell, lanes filled in slot order.

    The fixed-size compaction of ``jnp.nonzero(size=..., fill_value=-1)``
    without a host sync, as gathers only: each entry finds its cell, and
    each lane its slot, by a binary search in a running count (a scatter
    would send every padding row to one dump row, and the card serialises
    writes to one address)."""
    cells = cl.cells
    c, cap = cells.shape
    dev = cells.device
    act = (cells >= 0) & active[cells.clamp_min(0).long()]
    n_act = act.sum(1)                                   # [C]
    groups = (n_act + lanes - 1) // lanes
    g_end = torch.cumsum(groups, 0)
    g = torch.arange(k_max, device=dev)
    ec = torch.searchsorted(g_end, g, right=True)        # C past the end
    live = ec < c
    e = ec.clamp_max(c - 1)
    # rank of each lane among its cell's active targets, then its rank
    # among all active slots in (cell, slot) order
    rank = (g - (g_end[e] - groups[e]))[:, None] * lanes \
        + torch.arange(lanes, device=dev)
    ok = live[:, None] & (rank < n_act[e][:, None])
    nth = (torch.cumsum(n_act, 0) - n_act)[e][:, None] + rank
    flat = torch.searchsorted(torch.cumsum(act.reshape(-1), 0), nth + 1)
    entry_cell = torch.where(live, ec, torch.full_like(ec, -1))
    entry_slot = torch.where(ok, flat % cap, torch.full_like(flat, -1))
    return (entry_cell.to(torch.int32), entry_slot.to(torch.int32),
            groups.sum())


def entry_particles(cl: CellList, entry_cell, entry_slot, mask):
    """(pidx [K, L] particle index, valid [K, L]) of the entries' lanes:
    valid where the lane holds a slot of a real entry whose particle is
    in ``mask``."""
    pidx = cl.cells[entry_cell.clamp_min(0).long()[:, None],
                    entry_slot.clamp_min(0).long()]
    valid = (entry_cell[:, None] >= 0) & (entry_slot >= 0) & (pidx >= 0)
    return pidx, valid & mask[pidx.clamp_min(0).long()]


def shortrange_gravity_entries(soa: torch.Tensor, entry_cell: torch.Tensor,
                               tgt: torch.Tensor, n_cells: int, box: float,
                               asmth: float, rcut: float) -> torch.Tensor:
    """Kernel E: short-range accelerations [K, 3, ENTRY_LANES] of the
    entries' targets ``tgt`` [K, 8, ENTRY_LANES] (rows as in ``soa``)
    from the 27 cells around ``entry_cell`` [K] (-1: padding, zeros).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    c, rows, cap = soa.shape
    k = entry_cell.shape[0]
    if c != n_cells ** 3 or rows != 8:
        raise ValueError(f"soa shape {tuple(soa.shape)} does not match "
                         f"{n_cells}^3 cells of 8 rows")
    kernels.check(soa, "soa", torch.float32)
    kernels.check(entry_cell, "entry_cell", torch.int32, (k,), soa.device)
    kernels.check(tgt, "tgt", torch.float32, (k, 8, ENTRY_LANES), soa.device)
    kernels.note_call("shortrange_gravity_entries",
                      (soa, entry_cell, tgt, n_cells, box, asmth, rcut))
    if not kernels.on_cuda(soa, entry_cell, tgt):
        return shortrange_gravity_entries_plain(soa, entry_cell, tgt,
                                                n_cells, box, asmth, rcut)
    out = torch.empty(k, 3, ENTRY_LANES, dtype=soa.dtype, device=soa.device)
    kernels.launch("shortrange_gravity_entries", soa.data_ptr(),
                   entry_cell.data_ptr(), tgt.data_ptr(), out.data_ptr(),
                   n_cells, cap, k, box / n_cells, 0.5 / asmth, rcut * rcut)
    return out


def gravity_entries(cl: CellList, soa, entry_cell, entry_slot, pos, mass,
                    soft, alive, box: float, asmth: float,
                    rcut: float) -> torch.Tensor:
    """[N, 3] short-range accelerations of the entries' targets through
    kernel E; rows of particles in no entry are 0 (callers keep their
    frozen values). Targets are gathered per entry by the pack's own
    arithmetic, so each equals its slot of ``soa`` bit for bit."""
    pidx, valid = entry_particles(cl, entry_cell, entry_slot, alive)
    centers = cell_centers(cl)[entry_cell.clamp_min(0).long()]
    tgt = _tile_rows(cl, pidx, valid, centers, pos, mass, soft)
    out = shortrange_gravity_entries(soa, entry_cell,
                                     tgt.transpose(1, 2).contiguous(),
                                     cl.n_cells, box, asmth, rcut)
    return scatter_rows(out, pidx, valid, pos.shape[0])
