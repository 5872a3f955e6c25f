"""Block-packed SPH: even/odd block lists, packs, the wrappers of
kernels C (density) and D (hydro), and of their active-entry twins F and
G.

Counterpart of ``gadget_leicester_tpu/ops/sph_blocks.py:57-243, 696-913``
(``build_block_lists``, ``block_centers``, ``density_sums_blocks``,
``hydro_sums_blocks``, ``density_adaptive_blocks``,
``hydro_force_blocks``), of its entry variants ``:927-1390``
(``count_block_entries``, ``density_sums_blocks_entries``,
``hydro_sums_blocks_entries``, ``density_adaptive_blocks_entries``,
``hydro_force_blocks_entries``) and of ``ops/pallas_cells.py:1071``
(``pack_sph_soa``).

Particles are binned into fine subcells (2 n_blocks per axis, capacity
``subcap``), packed 2x2x2 into tiles of ``8 subcap`` lanes. The EVEN
packing (block b holds fine cells {2b, 2b+1}) holds targets; the ODD
packing (block w holds {2w-1, 2w}) holds sources, so the source region of
target block b is exactly the odd blocks b + {0,1}^3. The stencil is
complete while h <= Lf (Lf the fine-cell edge); the caller caps h at
(1 - 2 kappa) Lf (``models/forces.py``).

Two modes, as in the JAX package (``relative`` there):

* a periodic grid (the box): coordinates relative to each block's centre,
  the odd grid wraps (nb^3 blocks) and the stencil geometry is a constant
  shift of (1 - 2g) Lf per axis, exact for stale in-margin assignments.
  The wrappers take the fine edge ``lf``;
* a clamped (vacuum) grid over the gas bounding cube: absolute
  coordinates, fine coordinates clamped to the edge cells, an odd grid of
  (nb+1)^3 blocks that needs no wrap, and dx = t - s with no shift. The
  wrappers take ``lf=None``. Slots of an empty subcell are parked at -7
  fine cells, which in absolute coordinates is a place that may lie
  inside the cloud: every kernel skips a parked source by its mass or
  valid row, never by its distance. The self-pair of the hydro sums is
  dropped by r > 0, as the JAX package drops it there (target and source
  rows are copies of one row of the table, so its r2 is exactly 0). A
  target slot that is parked, or that the Newton loop marks done (h = 0),
  gets zeros: a tile of a thin disc holds few live slots among thousands.

An anisotropic grid (the slab step's, ``parallel/spmd.py``): per-axis
block counts and periodicity, clamped along x and periodic along y and z,
in the relative mode with the fine edge given (``fine_edge``, uniform
across the axes). A clamped axis gains an odd block and its ids do not
wrap; the shift (1 - 2g) Lf is the same on every axis. Kernels C and D
take it through their ``_aniso`` entries (counters ``sph_density_aniso``,
``sph_hydro_aniso``); the wrappers take ``nb`` as a 3-tuple and the
per-axis ``periodic``.
"""

from __future__ import annotations

import torch

from gadget_leicester_tpu_torch import kernels
from gadget_leicester_tpu_torch.ops.cells import (ENTRY_LANES,
                                                  cell_activity_flags,
                                                  entry_particles)
from gadget_leicester_tpu_torch.ops.neighbors import (CellList, _axes3,
                                                      dims3, merge_rows,
                                                      per3, scatter_rows,
                                                      segment_ranks)
from gadget_leicester_tpu_torch.ops.sph_dense import (
    DENSITY_FILL, DensityResult, HydroResult, density_adaptive_generic,
    density_columns, density_result, hydro_params, hydro_result, hydro_table)
from gadget_leicester_tpu_torch.ops.sph_kernels import (kernel_dw_dr,
                                                        kernel_w_and_dwdh)


def odd_dims(nb, periodic) -> tuple:
    """Per-axis odd-grid block counts: a clamped axis gains a block."""
    return tuple(n if p else n + 1 for n, p in zip(dims3(nb), per3(periodic)))


def build_block_lists(pos, mask, origin, extent, n_blocks,
                      subcap: int, periodic=True):
    """(even, odd) CellLists whose ``cells`` are [B, 8 subcap] tiles, lane =
    subcell * subcap + rank, subcell order z-slowest (sz*4 + sy*2 + sx),
    over [origin, origin + extent) (a float or a tensor, per axis or one
    for all). A periodic axis wraps fine coordinates and its odd grid has
    nb blocks; a clamped one clamps them to the edge cells and its odd
    grid has nb + 1. ``n_blocks`` and ``periodic`` are one for all axes or
    per-axis tuples (the lists then carry tuples); the fine edge should be
    the same on every axis. One stable sort serves both packings; overflow
    means a fine cell holds more than ``subcap`` particles."""
    n = pos.shape[0]
    dev = pos.device
    if isinstance(n_blocks, (tuple, list)) or \
            isinstance(periodic, (tuple, list)):
        return _build_block_lists3(pos, mask, origin, extent,
                                   dims3(n_blocks), subcap, per3(periodic))
    m = 2 * n_blocks
    origin_t = _axes3(origin, pos)
    extent_t = _axes3(extent, pos)
    inv_cell = float(m) / extent_t
    coords = torch.floor((pos - origin_t) * inv_cell).to(torch.int32)
    coords = torch.remainder(coords, m) if periodic else \
        coords.clamp(0, m - 1)
    cid_f = (coords[:, 0] * m + coords[:, 1]) * m + coords[:, 2]
    total_f = m ** 3
    cid_sort = torch.where(mask, cid_f, torch.full_like(cid_f, total_f))
    cid_sorted, order = torch.sort(cid_sort, stable=True)
    order = order.to(torch.int32)
    rank = segment_ranks(cid_sorted)
    ok = (rank < subcap) & (cid_sorted < total_f)
    c_sorted = coords[order.long()]
    lanes = 8 * subcap

    counts = torch.zeros(total_f + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, cid_sorted.long(), torch.ones_like(cid_sorted))
    overflow = (counts[:total_f] > subcap).any()

    def mk(c, nbl):
        b = c >> 1
        s = c & 1
        bid = (b[:, 0] * nbl + b[:, 1]) * nbl + b[:, 2]
        lane = ((s[:, 2] * 2 + s[:, 1]) * 2 + s[:, 0]) * subcap + rank
        nb3 = nbl ** 3
        cells = torch.full((nb3 + 1, lanes), -1, dtype=torch.int32,
                           device=dev)
        cells[torch.where(ok, bid, torch.full_like(bid, nb3)).long(),
              torch.where(ok, lane, torch.zeros_like(lane)).long()] = \
            torch.where(ok, order, torch.full_like(order, -1))
        gslot = torch.full((n,), -1, dtype=torch.int32, device=dev)
        gslot[order.long()] = torch.where(ok, bid * lanes + lane,
                                          torch.full_like(bid, -1))
        return CellList(cells=cells[:nb3].contiguous(), cell_of=cid_f,
                        counts=counts[:total_f], overflow=overflow,
                        origin=origin_t, inv_cell=inv_cell, gslot=gslot,
                        n_cells=nbl, periodic=periodic)

    # odd packing: fine coords shifted by +1 (block w holds {2w-1, 2w});
    # a periodic grid wraps, a clamped one gains a block per axis
    if periodic:
        return mk(c_sorted, n_blocks), mk(torch.remainder(c_sorted + 1, m),
                                          n_blocks)
    return mk(c_sorted, n_blocks), mk(c_sorted + 1, n_blocks + 1)


def _build_block_lists3(pos, mask, origin, extent, nb3: tuple, subcap: int,
                        pv: tuple):
    """:func:`build_block_lists` on per-axis block counts ``nb3`` and
    periodicity ``pv`` (the reference's ``_nb3``/``_per3`` path)."""
    n = pos.shape[0]
    dev = pos.device
    m3 = tuple(2 * q for q in nb3)
    origin_t = _axes3(origin, pos)
    extent_t = _axes3(extent, pos)
    inv_cell = torch.tensor(m3, dtype=pos.dtype, device=dev) / extent_t
    coords = torch.floor((pos - origin_t) * inv_cell).to(torch.int32)
    coords = torch.stack([torch.remainder(coords[:, a], m3[a]) if pv[a]
                          else coords[:, a].clamp(0, m3[a] - 1)
                          for a in range(3)], -1)
    cid_f = (coords[:, 0] * m3[1] + coords[:, 1]) * m3[2] + coords[:, 2]
    total_f = m3[0] * m3[1] * m3[2]
    cid_sort = torch.where(mask, cid_f, torch.full_like(cid_f, total_f))
    cid_sorted, order = torch.sort(cid_sort, stable=True)
    order = order.to(torch.int32)
    rank = segment_ranks(cid_sorted)
    ok = (rank < subcap) & (cid_sorted < total_f)
    c_sorted = coords[order.long()]
    lanes = 8 * subcap

    counts = torch.zeros(total_f + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, cid_sorted.long(), torch.ones_like(cid_sorted))
    overflow = (counts[:total_f] > subcap).any()

    def mk(c, dims):
        b = c >> 1
        s = c & 1
        bid = (b[:, 0] * dims[1] + b[:, 1]) * dims[2] + b[:, 2]
        lane = ((s[:, 2] * 2 + s[:, 1]) * 2 + s[:, 0]) * subcap + rank
        nbl = dims[0] * dims[1] * dims[2]
        cells = torch.full((nbl + 1, lanes), -1, dtype=torch.int32,
                           device=dev)
        cells[torch.where(ok, bid, torch.full_like(bid, nbl)).long(),
              torch.where(ok, lane, torch.zeros_like(lane)).long()] = \
            torch.where(ok, order, torch.full_like(order, -1))
        gslot = torch.full((n,), -1, dtype=torch.int32, device=dev)
        gslot[order.long()] = torch.where(ok, bid * lanes + lane,
                                          torch.full_like(bid, -1))
        return CellList(cells=cells[:nbl].contiguous(), cell_of=cid_f,
                        counts=counts[:total_f], overflow=overflow,
                        origin=origin_t, inv_cell=inv_cell, gslot=gslot,
                        n_cells=dims, periodic=pv)

    # odd packing: fine coords shifted by +1; periodic axes wrap, clamped
    # axes gain a block
    c_o = torch.stack([torch.remainder(c_sorted[:, a] + 1, m3[a]) if pv[a]
                       else c_sorted[:, a] + 1 for a in range(3)], -1)
    return mk(c_sorted, nb3), mk(c_o, odd_dims(nb3, pv))


def block_centers(nb, parity: str, fine_edge: float,
                  origin: torch.Tensor) -> torch.Tensor:
    """[prod(nb), 3] centres: even block w spans fine cells {2w, 2w+1}
    (centre (2w+1) Lf), odd block w spans {2w-1, 2w} (centre 2w Lf).
    ``nb``: one count for all axes or per axis (the grid's own: pass the
    odd grid's counts for the odd blocks)."""
    nx, ny, nz = dims3(nb)
    c_arr = torch.arange(nx * ny * nz, dtype=torch.int32,
                         device=origin.device)
    f = origin.dtype
    xyz = torch.stack([(c_arr // (ny * nz)).to(f),
                       ((c_arr // nz) % ny).to(f),
                       (c_arr % nz).to(f)], -1) * 2.0
    if parity == "even":
        xyz = xyz + 1.0
    return xyz * fine_edge + origin


def _centers(cl: CellList, parity: str, lf):
    """The block centres of a periodic list (relative rows), None on a
    clamped grid (``lf`` None: absolute rows)."""
    return None if lf is None else block_centers(cl.n_cells, parity, lf,
                                                 cl.origin)


def _sph_rows(cl: CellList, idx, valid, centers, wrap, pos, vel, mass,
              hsml) -> torch.Tensor:
    """[..., L, 8] rows x, y, z, m, vx, vy, vz, h of particles ``idx``
    [..., L], x, y, z relative to ``centers`` [..., 3] and minimum-imaged
    mod ``wrap`` (absolute where ``centers`` is None); slots that are not
    ``valid`` are parked at -7 fine cells with m = 0 and h = 1. The one
    arithmetic of the packs and of the entry targets."""
    i = idx.clamp_min(0).long()
    xyz = pos[i]
    if centers is not None:
        xyz = xyz - centers[..., None, :]
        xyz = xyz - wrap * torch.round(xyz / wrap)
    rows = torch.cat([xyz, mass[i][..., None], vel[i], hsml[i][..., None]],
                     dim=-1)
    park = torch.zeros(8, dtype=rows.dtype, device=rows.device)
    park[:3] = -7.0 / cl.inv_cell[0]
    park[7] = 1.0
    return torch.where(valid[..., None], rows, park)


def pack_sph_soa(cl: CellList, pos, vel, mass, hsml, gas_mask,
                 centers=None, wrap=None) -> torch.Tensor:
    """[B, 8, lanes] tiles of :func:`_sph_rows`, relative to each block's
    centre ``centers`` [B, 3], or absolute."""
    valid = (cl.cells >= 0) & gas_mask[cl.cells.clamp_min(0).long()]
    rows = _sph_rows(cl, cl.cells, valid, centers, wrap, pos, vel, mass, hsml)
    return rows.transpose(1, 2).contiguous()


def odd_sources(nb, blocks: torch.Tensor, periodic=True, relative=None):
    """For even blocks ``blocks`` [K]: the 8 odd source blocks [K, 8],
    b + {0,1}^3, and their shifts in units of Lf [8, 3]; along a periodic
    axis the ids wrap mod nb, along a clamped one they index the odd grid
    of nb + 1 blocks. ``nb`` and ``periodic``: one for all axes or per-axis
    tuples. The shifts come with the relative mode, None in the absolute
    one; ``relative`` defaults to every axis periodic (a cubic grid's mode
    follows its periodicity)."""
    (nx, ny, nz), pv = dims3(nb), per3(periodic)
    if relative is None:
        relative = all(pv)
    g = torch.arange(8, device=blocks.device)
    gxyz = torch.stack([g >> 2, (g >> 1) & 1, g & 1], -1)
    bxyz = torch.stack([blocks // (ny * nz), (blocks // nz) % ny,
                        blocks % nz], -1)
    o = bxyz[:, None, :] + gxyz[None]
    no = odd_dims((nx, ny, nz), pv)
    o = [torch.remainder(o[..., a], n) if pv[a] else o[..., a]
         for a, n in enumerate((nx, ny, nz))]
    return (o[0] * no[1] + o[1]) * no[2] + o[2], \
        (1 - 2 * gxyz) if relative else None


def _grid_per(nb, lf, periodic):
    """The per-axis periodicity of a kernel call: as given for an
    anisotropic grid (``nb`` a tuple), else periodic in the relative mode
    (``lf`` given) and clamped in the absolute one."""
    if isinstance(nb, (tuple, list)):
        if periodic is None or lf is None:
            raise ValueError("an anisotropic block grid needs its per-axis "
                             "periodic and the relative mode's fine edge")
        return per3(periodic)
    return (lf is not None,) * 3


def _odd_blocks(nb, lf, periodic=None) -> int:
    """Odd blocks of a periodic grid (``lf`` given), a clamped one, or an
    anisotropic one (``nb`` and ``periodic`` per axis)."""
    no = odd_dims(nb, _grid_per(nb, lf, periodic))
    return no[0] * no[1] * no[2]


def _pieces(todo: torch.Tensor, targets: int, sources: int,
            temporaries: int):
    """(tiles, target-lane slice) pieces of ``todo`` for a plain version,
    each ~1 GB of [K, L, 8 sources] float32 temporaries: whole tiles at a
    time, or a slice of one tile's lanes where a tile is larger."""
    per_lane = temporaries * 4 * 8 * sources
    lane_step = min(targets, max(1, (1 << 30) // per_lane))
    chunk = max(1, (1 << 30) // (per_lane * lane_step))
    for k0 in range(0, todo.numel(), chunk):
        for l0 in range(0, targets, lane_step):
            yield todo[k0:k0 + chunk], slice(l0, l0 + lane_step)


def _pair_geometry(t, s, shift):
    """dx, dy, dz [K, L, 8L] = (t - s) + shift (no shift where ``shift``
    is None), r, rinv."""
    d = [t[:, a, :, None] - s[a][:, None, :] for a in range(3)]
    if shift is not None:
        d = [d[a] + shift[a][None, None, :] for a in range(3)]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    rinv = torch.rsqrt(r2.clamp_min(1e-37))
    return d[0], d[1], d[2], r2 * rinv, rinv


def _live_first(live: torch.Tensor) -> torch.Tensor:
    """[K, n] lane indices that put each row's live lanes of ``live``
    [K, L] first, n the most live lanes of any row."""
    n = int(live.sum(1).max()) if live.numel() else 0
    return torch.argsort((~live).to(torch.int8), dim=1, stable=True)[:, :n]


def _gather_sources(soa_o, src_ids, shift_units, lf, rows, live_row=None):
    """Source rows [K, 8 L] of the 8 odd blocks, and the per-lane shifts
    (None without ``shift_units``). With ``live_row`` (absolute mode) the
    lanes whose row ``live_row`` is not > 0 are left out as far as the
    fullest row allows: their terms are 0, and a vacuum tile is mostly
    parked slots."""
    s = soa_o[src_ids]                                   # [K, 8, R, L]
    lanes = s.shape[-1]
    out = [s[:, :, r].flatten(1) for r in rows]
    if live_row is not None:
        keep = _live_first(s[:, :, live_row].flatten(1) > 0)
        out = [o.gather(1, keep) for o in out]
    if shift_units is None:
        return out, None
    sh = (shift_units.to(soa_o.dtype) * lf).repeat_interleave(lanes, dim=0)
    return out, [sh[:, a] for a in range(3)]


def _density_sums(t, ht, soa_o, blocks, nb, lf,
                  periodic=None) -> torch.Tensor:
    """[K, 6, L] = rho, drho/dh, raw div v, raw rot v of the targets ``t``
    [K, 8, L] (rows as in the even pack) with smoothing lengths ``ht``
    [K, L], of even blocks ``blocks`` [K], over their 8 odd source
    blocks (``lf`` None: absolute rows on a clamped grid; ``nb`` and
    ``periodic`` per axis on an anisotropic one)."""
    src_ids, units = odd_sources(nb, blocks, _grid_per(nb, lf, periodic),
                                 relative=lf is not None)
    s, shift = _gather_sources(soa_o, src_ids, units, lf,
                               (0, 1, 2, 3, 4, 5, 6),
                               live_row=3 if lf is None else None)
    dx, dy, dz, r, rinv = _pair_geometry(t, s, shift)
    ht = ht[:, :, None]
    w, dwdh = kernel_w_and_dwdh(r, ht)
    dwdr = kernel_dw_dr(r, ht)
    m = s[3][:, None, :]
    fac = m * dwdr * rinv
    dvx = t[:, 4, :, None] - s[4][:, None, :]
    dvy = t[:, 5, :, None] - s[5][:, None, :]
    dvz = t[:, 6, :, None] - s[6][:, None, :]
    vdotr = dvx * dx + dvy * dy + dvz * dz
    return torch.stack([(m * w).sum(-1), (m * dwdh).sum(-1),
                        -(fac * vdotr).sum(-1),
                        (fac * (dvy * dz - dvz * dy)).sum(-1),
                        (fac * (dvz * dx - dvx * dz)).sum(-1),
                        (fac * (dvx * dy - dvy * dx)).sum(-1)], 1)


def density_sums_blocks_plain(soa_e, soa_o, h_slots, flags, nb, lf,
                              periodic=None):
    """Plain PyTorch version of kernel C: out [B, 6, lanes] = rho,
    drho/dh, raw div v, raw rot v (x, y, z); zeros where flags is 0, and
    in absolute mode (``lf`` None) at parked targets (m = 0) and at
    targets with h = 0. ``nb`` a 3-tuple and ``periodic`` per axis: the
    relative mode on an anisotropic grid."""
    b, _, lanes = soa_e.shape
    out = torch.zeros(b, 6, lanes, dtype=soa_e.dtype, device=soa_e.device)
    todo = torch.nonzero(flags > 0).flatten()
    for bc, sl in _pieces(todo, lanes, lanes, 24):
        t, ht = soa_e[bc, :, sl], h_slots[bc, sl]
        if lf is None:
            out[bc, :, sl] = _live_targets(
                lambda k: _density_sums(_lanes(t, k), ht.gather(1, k), soa_o,
                                        bc, nb, lf),
                (t[:, 3] > 0) & (ht > 0), 6)
        else:
            out[bc, :, sl] = _density_sums(t, ht, soa_o, bc, nb, lf,
                                           periodic)
    return out


def _lanes(rows: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """[K, R, n] lanes ``keep`` [K, n] of ``rows`` [K, R, L]."""
    return rows.gather(2, keep[:, None, :].expand(-1, rows.shape[1], -1))


def _live_targets(sums_of, live: torch.Tensor, n_out: int) -> torch.Tensor:
    """[K, n_out, L] sums of the live targets of ``live`` [K, L], zeros
    elsewhere: ``sums_of(keep)`` computes them on the lanes ``keep`` only
    (a vacuum tile is mostly parked slots)."""
    keep = _live_first(live)
    sums = sums_of(keep)
    sums = torch.where(live.gather(1, keep)[:, None], sums,
                       torch.zeros_like(sums))
    out = sums.new_zeros(live.shape[0], n_out, live.shape[1])
    return out.scatter_(2, keep[:, None, :].expand(-1, n_out, -1), sums)


def _kernel_name(name: str, lf, nb=None) -> str:
    """A kernel's counter and C entry: ``<name>_abs`` in absolute mode,
    ``<name>_aniso`` on an anisotropic grid (``nb`` a tuple)."""
    if isinstance(nb, (tuple, list)):
        return f"{name}_aniso"
    return name if lf is not None else f"{name}_abs"


def _grid_args(nb, lf, periodic) -> tuple:
    """The block-grid arguments of an ``_aniso`` C entry: the per-axis
    counts and the mask of the periodic axes (bit a for axis a)."""
    pv = _grid_per(nb, lf, periodic)
    return (*dims3(nb), pv[0] | (pv[1] << 1) | (pv[2] << 2))


def _check_blocks(b: int, rows: int, nb, what: str, shape) -> None:
    nx, ny, nz = dims3(nb)
    if b != nx * ny * nz or rows != 8:
        raise ValueError(f"{what} shape {tuple(shape)} does not match "
                         f"{nb} blocks of 8 rows")


def density_sums_blocks(soa_e: torch.Tensor, soa_o: torch.Tensor,
                        h_slots: torch.Tensor, flags: torch.Tensor, nb,
                        lf, periodic=None) -> torch.Tensor:
    """Kernel C: density sums [B, 6, lanes] of the even-block targets over
    their 8 odd source blocks; ``lf`` the fine edge of a periodic grid, or
    None for the absolute mode of a clamped one (``soa_o`` then has
    (nb+1)^3 blocks; parked and h = 0 targets get zeros). With ``nb`` a
    3-tuple and ``periodic`` per axis, the relative mode on an anisotropic
    grid (the slab's; ``soa_o`` has one block more along a clamped axis).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    b, rows, lanes = soa_e.shape
    _check_blocks(b, rows, nb, "soa_e", soa_e.shape)
    dev = soa_e.device
    kernels.check(soa_e, "soa_e", torch.float32)
    kernels.check(soa_o, "soa_o", torch.float32,
                  (_odd_blocks(nb, lf, periodic), 8, lanes), dev)
    kernels.check(h_slots, "h_slots", torch.float32, (b, lanes), dev)
    kernels.check(flags, "flags", torch.int32, (b,), dev)
    name = _kernel_name("sph_density", lf, nb)
    aniso = name.endswith("_aniso")
    kernels.note_call(name, (soa_e, soa_o, h_slots, flags, nb, lf)
                      + ((per3(periodic),) if aniso else ()))
    if not kernels.on_cuda(soa_e, soa_o, h_slots, flags):
        return density_sums_blocks_plain(soa_e, soa_o, h_slots, flags, nb, lf,
                                         periodic)
    out = torch.empty(b, 6, lanes, dtype=soa_e.dtype, device=dev)
    # the kernel's workspace: the box of each source subcell's sources
    boxes = torch.empty(soa_o.shape[0] * 64, dtype=torch.float32, device=dev)
    ptrs = (soa_e.data_ptr(), soa_o.data_ptr(), h_slots.data_ptr(),
            flags.data_ptr(), boxes.data_ptr(), out.data_ptr())
    if aniso:
        ptrs += (*_grid_args(nb, lf, periodic), lanes, lf)
    else:
        ptrs += (nb, lanes) + ((lf,) if lf is not None else ())
    kernels.launch(name, *ptrs)
    return out


def density_sums_blocks_entries_plain(soa_o, tgt, h_slots, entry_blk,
                                      nb: int, lf):
    """Plain PyTorch version of kernel F: out [K, 6, L] as kernel C's rows
    for the targets ``tgt`` [K, 8, L] of the entries ``entry_blk`` [K];
    padded or switched-off entries (-1) and dead lanes (m = 0) are 0."""
    k, _, lt = tgt.shape
    out = torch.zeros(k, 6, lt, dtype=soa_o.dtype, device=soa_o.device)
    todo = torch.nonzero(entry_blk >= 0).flatten()
    for e, sl in _pieces(todo, lt, soa_o.shape[2], 24):
        t = tgt[e][:, :, sl]
        sums = _density_sums(t, h_slots[e][:, sl], soa_o,
                             entry_blk[e].long(), nb, lf)
        out[e, :, sl] = torch.where(t[:, 3:4] > 0, sums,
                                    torch.zeros_like(sums))
    return out


def _chunk_workspace(blocks: int, lanes: int, entries: int, dev):
    """The workspace of the entries kernels F and G: the box (and largest
    h) of each 32-slot chunk of each of ``blocks`` source blocks of
    ``lanes`` slots, and a need word a group of 32 chunks of each entry's
    8 odd blocks."""
    chunks = (lanes + 31) // 32
    boxes = torch.empty(blocks * chunks * 8, dtype=torch.float32, device=dev)
    need = torch.empty(entries * ((8 * chunks + 31) // 32),
                       dtype=torch.int32, device=dev)
    return boxes, need


def density_sums_blocks_entries(soa_o: torch.Tensor, tgt: torch.Tensor,
                                h_slots: torch.Tensor, entry_blk: torch.Tensor,
                                nb: int, lf) -> torch.Tensor:
    """Kernel F: density sums [K, 6, ENTRY_LANES] of the entries' targets
    ``tgt`` [K, 8, ENTRY_LANES] (rows as in the even pack, smoothing
    lengths ``h_slots`` [K, ENTRY_LANES]) over the 8 odd source blocks of
    ``entry_blk`` [K] (-1: skipped, zeros); ``lf`` as for kernel C. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    b, rows, lanes = soa_o.shape
    k = entry_blk.shape[0]
    if b != _odd_blocks(nb, lf) or rows != 8:
        raise ValueError(f"soa_o shape {tuple(soa_o.shape)} does not match "
                         f"the odd blocks of nb = {nb}, 8 rows")
    dev = soa_o.device
    kernels.check(soa_o, "soa_o", torch.float32)
    kernels.check(tgt, "tgt", torch.float32, (k, 8, ENTRY_LANES), dev)
    kernels.check(h_slots, "h_slots", torch.float32, (k, ENTRY_LANES), dev)
    kernels.check(entry_blk, "entry_blk", torch.int32, (k,), dev)
    name = _kernel_name("sph_density_entries", lf)
    kernels.note_call(name, (soa_o, tgt, h_slots, entry_blk, nb, lf))
    if not kernels.on_cuda(soa_o, tgt, h_slots, entry_blk):
        return density_sums_blocks_entries_plain(soa_o, tgt, h_slots,
                                                 entry_blk, nb, lf)
    out = torch.empty(k, 6, ENTRY_LANES, dtype=soa_o.dtype, device=dev)
    boxes, need = _chunk_workspace(b, lanes, k, dev)
    ptrs = (soa_o.data_ptr(), tgt.data_ptr(), h_slots.data_ptr(),
            entry_blk.data_ptr(), boxes.data_ptr(), need.data_ptr(),
            out.data_ptr(), nb, lanes, k)
    if lf is not None:
        ptrs += (lf,)
    kernels.launch(name, *ptrs)
    return out


def _hydro_sums(ta, tb, tid, src16, idx_o, blocks, params, nb,
                lf, visc_const: float, periodic=None) -> torch.Tensor:
    """[K, 5, L] = ax, ay, az, raw dA/dt, max signal velocity of the
    targets (rows ``ta``, ``tb`` [K, 8, L] as kernel D's soa_a, soa_b;
    particle indices ``tid`` [K, L]) of even blocks ``blocks`` [K] over
    their 8 odd source blocks. The self-pair is excluded by index in
    relative mode, by r > 0 in absolute mode (``lf`` None)."""
    hubble_a2_flow, fac_mu = params[0], params[1]
    src_ids, units = odd_sources(nb, blocks, _grid_per(nb, lf, periodic),
                                 relative=lf is not None)
    s, shift = _gather_sources(src16, src_ids, units, lf, range(13),
                               live_row=12 if lf is None else None)
    dx, dy, dz, r, rinv = _pair_geometry(ta, s, shift)
    ht = ta[:, 7, :, None]
    hs = s[7][:, None, :]
    if lf is None:
        other = r > 0.0
    else:
        other = tid[:, :, None] != idx_o[src_ids].flatten(1)[:, None, :]
    inside = (r < torch.maximum(ht, hs)) & other & (s[12][:, None, :] > 0.0)
    dwk_i = kernel_dw_dr(r, ht)
    dwk_j = kernel_dw_dr(r, hs)
    dvx = ta[:, 4, :, None] - s[4][:, None, :]
    dvy = ta[:, 5, :, None] - s[5][:, None, :]
    dvz = ta[:, 6, :, None] - s[6][:, None, :]
    vdotr2 = dvx * dx + dvy * dy + dvz * dz + hubble_a2_flow * (r * r)
    approaching = vdotr2 < 0.0
    mu_ij = fac_mu * vdotr2 * rinv
    zero = torch.zeros_like(mu_ij)
    vsig = tb[:, 2, :, None] + s[10][:, None, :] \
        - 3.0 * torch.where(approaching, mu_ij, zero)
    rho_ij = 0.5 * (tb[:, 0, :, None] + s[8][:, None, :])
    rs = torch.rsqrt(rho_ij.clamp_min(1e-37))
    f_ij = 0.5 * (tb[:, 3, :, None] + s[11][:, None, :])
    visc = torch.where(approaching, 0.5 * visc_const * vsig * (-mu_ij)
                       * (rs * rs) * f_ij, zero)
    m = s[3][:, None, :]
    hfc_visc = 0.5 * m * visc * (dwk_i + dwk_j) * rinv
    hfc = hfc_visc + m * (tb[:, 1, :, None] * dwk_i
                          + s[9][:, None, :] * dwk_j) * rinv
    hfc = torch.where(inside, hfc, zero)
    hfc_visc = torch.where(inside, hfc_visc, zero)
    return torch.stack([-(hfc * dx).sum(-1), -(hfc * dy).sum(-1),
                        -(hfc * dz).sum(-1),
                        0.5 * (hfc_visc * vdotr2).sum(-1),
                        torch.where(inside, vsig, zero).amax(-1)], 1)


def hydro_sums_blocks_plain(soa_a, soa_b, src16, idx_e, idx_o, flags,
                            params, nb, lf, visc_const: float,
                            periodic=None):
    """Plain PyTorch version of kernel D: out [B, 5, lanes] = ax, ay, az,
    raw dA/dt, max signal velocity; zeros where flags is 0, and in
    absolute mode (``lf`` None) at invalid targets (soa_b row 4 = 0).
    ``nb`` a 3-tuple and ``periodic`` per axis: the relative mode on an
    anisotropic grid."""
    b, _, lanes = soa_a.shape
    out = torch.zeros(b, 5, lanes, dtype=soa_a.dtype, device=soa_a.device)
    todo = torch.nonzero(flags > 0).flatten()
    for bc, sl in _pieces(todo, lanes, lanes, 40):
        ta, tb, tid = soa_a[bc, :, sl], soa_b[bc, :, sl], idx_e[bc, sl]
        if lf is None:
            out[bc, :, sl] = _live_targets(
                lambda k: _hydro_sums(_lanes(ta, k), _lanes(tb, k),
                                      tid.gather(1, k), src16, idx_o, bc,
                                      params, nb, lf, visc_const),
                tb[:, 4] > 0, 5)
        else:
            out[bc, :, sl] = _hydro_sums(ta, tb, tid, src16, idx_o, bc,
                                         params, nb, lf, visc_const,
                                         periodic)
    return out


def hydro_sums_blocks(soa_a: torch.Tensor, soa_b: torch.Tensor,
                      src16: torch.Tensor, idx_e: torch.Tensor,
                      idx_o: torch.Tensor, flags: torch.Tensor,
                      params: torch.Tensor, nb, lf,
                      visc_const: float, periodic=None) -> torch.Tensor:
    """Kernel D: hydro sums [B, 5, lanes]. ``idx_e``/``idx_o`` [B, lanes]
    int32 particle indices (-1 for empty slots) exclude the self-pair in
    relative mode; ``lf`` None is the absolute mode of a clamped grid
    (``src16`` with (nb+1)^3 blocks, the self-pair dropped by r > 0,
    invalid targets zero). ``params`` [2] = (hubble_a2_flow, fac_mu).
    With ``nb`` a 3-tuple and ``periodic`` per axis, the relative mode on
    an anisotropic grid (the slab's). CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    b, rows, lanes = soa_a.shape
    _check_blocks(b, rows, nb, "soa_a", soa_a.shape)
    dev = soa_a.device
    bo = _odd_blocks(nb, lf, periodic)
    kernels.check(soa_a, "soa_a", torch.float32)
    kernels.check(soa_b, "soa_b", torch.float32, (b, 8, lanes), dev)
    kernels.check(src16, "src16", torch.float32, (bo, 16, lanes), dev)
    kernels.check(idx_e, "idx_e", torch.int32, (b, lanes), dev)
    kernels.check(idx_o, "idx_o", torch.int32, (bo, lanes), dev)
    kernels.check(flags, "flags", torch.int32, (b,), dev)
    kernels.check(params, "params", torch.float32, (2,), dev)
    name = _kernel_name("sph_hydro", lf, nb)
    aniso = name.endswith("_aniso")
    kernels.note_call(name, (soa_a, soa_b, src16, idx_e, idx_o, flags,
                             params, nb, lf, visc_const)
                      + ((per3(periodic),) if aniso else ()))
    if not kernels.on_cuda(soa_a, soa_b, src16, idx_e, idx_o, flags, params):
        return hydro_sums_blocks_plain(soa_a, soa_b, src16, idx_e, idx_o,
                                       flags, params, nb, lf, visc_const,
                                       periodic)
    out = torch.empty(b, 5, lanes, dtype=soa_a.dtype, device=dev)
    # the kernel's workspace: a box and the largest h of each source subcell
    boxes = torch.empty(bo * 64, dtype=torch.float32, device=dev)
    if lf is None:
        kernels.launch(name, soa_a.data_ptr(), soa_b.data_ptr(),
                       src16.data_ptr(), flags.data_ptr(), params.data_ptr(),
                       boxes.data_ptr(), out.data_ptr(), nb, lanes,
                       0.5 * visc_const)
    elif aniso:
        kernels.launch(name, soa_a.data_ptr(), soa_b.data_ptr(),
                       src16.data_ptr(), idx_e.data_ptr(), idx_o.data_ptr(),
                       flags.data_ptr(), params.data_ptr(), boxes.data_ptr(),
                       out.data_ptr(), *_grid_args(nb, lf, periodic), lanes,
                       lf, 0.5 * visc_const)
    else:
        kernels.launch(name, soa_a.data_ptr(), soa_b.data_ptr(),
                       src16.data_ptr(), idx_e.data_ptr(), idx_o.data_ptr(),
                       flags.data_ptr(), params.data_ptr(), boxes.data_ptr(),
                       out.data_ptr(), nb, lanes, lf, 0.5 * visc_const)
    return out


def hydro_sums_blocks_entries_plain(tgt16, tidx, src16, idx_o, entry_blk,
                                    params, nb: int, lf, visc_const: float):
    """Plain PyTorch version of kernel G: out [K, 5, L] as kernel D's rows
    for the targets ``tgt16`` [K, 16, L] (particle indices ``tidx``) of
    the entries ``entry_blk`` [K]; padded entries (-1) and dead lanes
    (row 12 = 0) are 0."""
    k, _, lt = tgt16.shape
    out = torch.zeros(k, 5, lt, dtype=src16.dtype, device=src16.device)
    todo = torch.nonzero(entry_blk >= 0).flatten()
    for e, sl in _pieces(todo, lt, src16.shape[2], 40):
        t = tgt16[e][:, :, sl]
        sums = _hydro_sums(t[:, :8], t[:, 8:], tidx[e][:, sl], src16, idx_o,
                           entry_blk[e].long(), params, nb, lf, visc_const)
        out[e, :, sl] = torch.where(t[:, 12:13] > 0, sums,
                                    torch.zeros_like(sums))
    return out


def hydro_sums_blocks_entries(tgt16: torch.Tensor, tidx: torch.Tensor,
                              src16: torch.Tensor, idx_o: torch.Tensor,
                              entry_blk: torch.Tensor, params: torch.Tensor,
                              nb: int, lf,
                              visc_const: float) -> torch.Tensor:
    """Kernel G: hydro sums [K, 5, ENTRY_LANES] of the entries' targets
    ``tgt16`` [K, 16, ENTRY_LANES] (rows as in kernel D's even pack,
    int32 particle indices ``tidx`` [K, ENTRY_LANES], -1 for dead lanes)
    over the 8 odd source blocks of ``entry_blk`` [K] (-1: padding,
    zeros); the self-pair is excluded by index, or by r > 0 in the
    absolute mode (``lf`` None, as for kernel D). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    b, rows, lanes = src16.shape
    k = entry_blk.shape[0]
    if b != _odd_blocks(nb, lf) or rows != 16:
        raise ValueError(f"src16 shape {tuple(src16.shape)} does not match "
                         f"the odd blocks of nb = {nb}, 16 rows")
    dev = src16.device
    kernels.check(tgt16, "tgt16", torch.float32, (k, 16, ENTRY_LANES), dev)
    kernels.check(tidx, "tidx", torch.int32, (k, ENTRY_LANES), dev)
    kernels.check(src16, "src16", torch.float32)
    kernels.check(idx_o, "idx_o", torch.int32, (b, lanes), dev)
    kernels.check(entry_blk, "entry_blk", torch.int32, (k,), dev)
    kernels.check(params, "params", torch.float32, (2,), dev)
    name = _kernel_name("sph_hydro_entries", lf)
    kernels.note_call(name, (tgt16, tidx, src16, idx_o, entry_blk, params,
                             nb, lf, visc_const))
    if not kernels.on_cuda(tgt16, tidx, src16, idx_o, entry_blk, params):
        return hydro_sums_blocks_entries_plain(tgt16, tidx, src16, idx_o,
                                               entry_blk, params, nb, lf,
                                               visc_const)
    out = torch.empty(k, 5, ENTRY_LANES, dtype=src16.dtype, device=dev)
    boxes, need = _chunk_workspace(b, lanes, k, dev)
    work = (params.data_ptr(), boxes.data_ptr(), need.data_ptr(),
            out.data_ptr(), nb, lanes, k)
    if lf is None:
        kernels.launch(name, tgt16.data_ptr(), src16.data_ptr(),
                       entry_blk.data_ptr(), *work, 0.5 * visc_const)
    else:
        kernels.launch(name, tgt16.data_ptr(), tidx.data_ptr(),
                       src16.data_ptr(), idx_o.data_ptr(),
                       entry_blk.data_ptr(), *work, lf, 0.5 * visc_const)
    return out


def _block_flags(cl_e: CellList, active, gas_mask):
    if active is None:
        return torch.ones(cl_e.cells.shape[0], dtype=torch.int32,
                          device=cl_e.cells.device)
    return cell_activity_flags(cl_e, active & gas_mask)


def _fine_edge(cl_e: CellList, box: float, fine_edge=None):
    """``lf`` of the kernel wrappers: ``fine_edge`` where the caller gives
    it (an anisotropic grid's relative mode), the fine edge of a periodic
    cubic list, None on a clamped grid (absolute mode)."""
    if fine_edge is not None:
        return fine_edge
    if isinstance(cl_e.n_cells, tuple):
        raise ValueError("an anisotropic block grid runs in the relative "
                         "mode only: give its fine_edge")
    return box / (2 * cl_e.n_cells) if cl_e.periodic else None


def _grid_periodic(cl_e: CellList):
    """The per-axis periodicity an anisotropic list passes its kernels
    (None for a cubic one, whose mode says it)."""
    return cl_e.periodic if isinstance(cl_e.n_cells, tuple) else None


def density_adaptive_blocks(pos, vel, mass, hsml0, gas_mask,
                            des_num_ngb: float, max_dev: float, box: float,
                            cls, max_hsml, min_hsml: float = 0.0,
                            active=None, fine_edge=None):
    """Adaptive-h density on kernel C over the cached (even, odd) lists
    ``cls`` (periodic, or clamped: absolute mode, ``box`` unused; or an
    anisotropic pair in the relative mode with ``fine_edge`` given, the
    minimum image of the packs mod ``box``). ``active`` (None = all): only
    active targets are solved and tiles without one are skipped. Returns
    (DensityResult, cls)."""
    cl_e, cl_o = cls
    nb = cl_e.n_cells
    b, lanes = cl_e.cells.shape
    lf = _fine_edge(cl_e, box, fine_edge)
    per = _grid_periodic(cl_e)
    flags = _block_flags(cl_e, active, gas_mask)
    ones = torch.ones_like(mass)
    soa_e = pack_sph_soa(cl_e, pos, vel, mass, ones, gas_mask,
                         _centers(cl_e, "even", lf), box)
    soa_o = pack_sph_soa(cl_o, pos, vel, mass, ones, gas_mask,
                         _centers(cl_o, "odd", lf), box)
    idx = cl_e.cells.clamp_min(0).long()
    valid = (cl_e.cells >= 0) & gas_mask[idx]
    if active is not None:
        valid = valid & active[idx]
    mass_slots = soa_e[:, 3, :].reshape(-1)
    mask_slots = valid.reshape(-1)
    h0_slots = torch.where(valid, hsml0[idx],
                           torch.ones_like(hsml0[idx])).reshape(-1)

    def sweep(h_slots, undone):
        fl = flags
        if undone is not None:
            fl = undone.reshape(b, lanes).any(dim=1).to(torch.int32)
        if lf is None:
            # absolute mode: a slot the loop does not solve is passed h = 0,
            # where its sums are 0 anyway, and costs the kernel nothing
            live = mask_slots if undone is None else undone
            h_slots = torch.where(live, h_slots, torch.zeros_like(h_slots))
        out = density_sums_blocks(soa_e, soa_o, h_slots.reshape(b, lanes),
                                  fl, nb, lf, per)
        rot = out[:, 3:6, :].transpose(1, 2).reshape(-1, 3)
        return (out[:, 0].reshape(-1), out[:, 1].reshape(-1),
                out[:, 2].reshape(-1), rot)

    res = density_adaptive_generic(
        sweep, mass_slots, h0_slots, mask_slots, des_num_ngb, max_dev,
        min_hsml=min_hsml, max_hsml=max_hsml)

    # one row gather over the inverse slot map; dropped/dead particles
    # take the fill row
    slots = density_columns(res)
    slots = torch.cat([slots, slots.new_tensor([DENSITY_FILL])], 0)
    gidx = torch.where(cl_e.gslot >= 0, cl_e.gslot,
                       torch.full_like(cl_e.gslot, b * lanes)).long()
    return density_result(slots[gidx], res.iters), cls


def _entry_centers(cl_e: CellList, entry_blk, lf):
    """The even-block centre of each entry [K, 3], or None (absolute)."""
    c = _centers(cl_e, "even", lf)
    return None if c is None else c[entry_blk.clamp_min(0).long()]


def density_adaptive_blocks_entries(pos, vel, mass, hsml0, gas_mask,
                                    entry_blk, entry_slot, des_num_ngb: float,
                                    max_dev: float, box: float, cls,
                                    max_hsml, min_hsml: float = 0.0
                                    ) -> DensityResult:
    """Adaptive-h density of the active entries' targets on kernel F: the
    targets are gathered per entry, the Newton loop runs over their
    ``K * ENTRY_LANES`` slots, and each sweep after the first switches off
    (-1) the entries whose lanes have all converged. ``entry_blk`` /
    ``entry_slot`` come from :func:`build_active_entries` on the even
    list. Particles in no entry get the fill row (rho 0)."""
    cl_e, cl_o = cls
    nb = cl_e.n_cells
    lf = _fine_edge(cl_e, box)
    k, lt = entry_slot.shape
    ones = torch.ones_like(mass)
    soa_o = pack_sph_soa(cl_o, pos, vel, mass, ones, gas_mask,
                         _centers(cl_o, "odd", lf), box)
    pidx, valid = entry_particles(cl_e, entry_blk, entry_slot, gas_mask)
    tgt = _sph_rows(cl_e, pidx, valid, _entry_centers(cl_e, entry_blk, lf),
                    box, pos, vel, mass, ones)
    tgt = tgt.transpose(1, 2).contiguous()
    i = pidx.clamp_min(0).long()
    mass_slots = torch.where(valid, mass[i], torch.zeros_like(mass[i]))
    h0_slots = torch.where(valid, hsml0[i], torch.ones_like(hsml0[i]))

    def sweep(h_slots, undone):
        ids = entry_blk if undone is None else torch.where(
            undone.reshape(k, lt).any(dim=1), entry_blk,
            torch.full_like(entry_blk, -1))
        out = density_sums_blocks_entries(soa_o, tgt, h_slots.reshape(k, lt),
                                          ids, nb, lf)
        rot = out[:, 3:6, :].transpose(1, 2).reshape(-1, 3)
        return (out[:, 0].reshape(-1), out[:, 1].reshape(-1),
                out[:, 2].reshape(-1), rot)

    res = density_adaptive_generic(
        sweep, mass_slots.reshape(-1), h0_slots.reshape(-1),
        valid.reshape(-1), des_num_ngb, max_dev, min_hsml=min_hsml,
        max_hsml=max_hsml)
    slots = density_columns(res).reshape(k, lt, 6).transpose(1, 2)
    vals = scatter_rows(slots, pidx, valid, pos.shape[0],
                        fill=slots.new_tensor(DENSITY_FILL))
    return density_result(vals, res.iters)


def count_block_entries(cl_e: CellList, active,
                        lanes: int = ENTRY_LANES) -> torch.Tensor:
    """0-d: the entries the SPH entry path would need, the sum over even
    blocks of ceil(n_active / lanes), counted in O(N) through the fine
    ``cell_of`` (an upper bound when a subcell overflowed)."""
    nb = cl_e.n_cells
    m = 2 * nb
    cid = cl_e.cell_of
    cx, cy, cz = cid // (m * m), (cid // m) % m, cid % m
    bid = ((cx >> 1) * nb + (cy >> 1)) * nb + (cz >> 1)
    # each particle adds 0 or 1 to its own block: no shared dump bin for
    # the many inactive ones to contend on
    counts = torch.zeros(nb ** 3, dtype=torch.int32, device=bid.device)
    counts.index_add_(0, bid.long(), active.to(torch.int32))
    return ((counts + lanes - 1) // lanes).sum()


def _hydro_rows(cl: CellList, table16, idx, valid, centers,
                box: float) -> torch.Tensor:
    """[..., L, 16] rows of ``table16`` at particles ``idx`` [..., L],
    x, y, z relative to ``centers`` [..., 3] and minimum-imaged (absolute
    where ``centers`` is None); slots that are not ``valid`` parked at -7
    fine cells with h = 1 and valid 0. The one arithmetic of kernel D's
    packs and of kernel G's targets."""
    rows = table16[idx.clamp_min(0).long()]
    if centers is not None:
        rel = rows[..., :3] - centers[..., None, :]
        rel = rel - box * torch.round(rel * (1.0 / box))
        rows = torch.cat([rel, rows[..., 3:]], dim=-1)
    park = torch.zeros(16, dtype=rows.dtype, device=rows.device)
    park[:3] = -7.0 / cl.inv_cell[0]
    park[7] = 1.0
    return torch.where(valid[..., None], rows, park)


def _pack16(cl: CellList, table16, gas_mask, centers, box: float):
    """[B, 16, lanes] tiles of :func:`_hydro_rows` and their [B, lanes]
    int32 particle indices (-1 for empty slots)."""
    valid = (cl.cells >= 0) & gas_mask[cl.cells.clamp_min(0).long()]
    rows = _hydro_rows(cl, table16, cl.cells, valid, centers, box)
    ids = torch.where(valid, cl.cells, torch.full_like(cl.cells, -1))
    return rows.transpose(1, 2).contiguous(), ids.contiguous()


def pack_hydro_blocks(cls, pos, vel, mass, hsml, rho, pressure,
                      dhsml_factor, div_vel, curl_vel, gas_mask, box: float,
                      hubble_a2_flow, fac_mu, active=None, fine_edge=None):
    """Kernel D's inputs: (soa_a, soa_b, src16, idx_e, idx_o, flags,
    params) from the particle fields, as one [N, 16]-row gather per list
    (rows of :func:`hydro_table`, soa_a = rows 0-7, soa_b = rows
    8-15)."""
    cl_e, cl_o = cls
    lf = _fine_edge(cl_e, box, fine_edge)
    fac_mu = torch.as_tensor(fac_mu, dtype=pos.dtype, device=pos.device)
    table16 = hydro_table(pos, vel, mass, hsml, rho, pressure, dhsml_factor,
                           div_vel, curl_vel, fac_mu)
    rows_e, idx_e = _pack16(cl_e, table16, gas_mask,
                            _centers(cl_e, "even", lf), box)
    src16, idx_o = _pack16(cl_o, table16, gas_mask,
                           _centers(cl_o, "odd", lf), box)
    return (rows_e[:, :8].contiguous(), rows_e[:, 8:].contiguous(), src16,
            idx_e, idx_o, _block_flags(cl_e, active, gas_mask),
            hydro_params(hubble_a2_flow, fac_mu))


def hydro_force_blocks(cls, pos, vel, mass, hsml, rho, pressure,
                       dhsml_factor, div_vel, curl_vel, gas_mask,
                       visc_const: float, box: float, hubble_a2_flow,
                       hubble_a2_norm, fac_mu, active=None,
                       fine_edge=None) -> HydroResult:
    """Entropy-form hydro force on kernel D [G2: hydra.c ::
    hydro_evaluate()]; ``cls`` = (even, odd) lists from the density
    pass (periodic, or clamped: absolute mode, ``box`` unused; or an
    anisotropic pair with ``fine_edge``, as for
    :func:`density_adaptive_blocks`). The comoving factors are 0-d
    tensors (or floats)."""
    cl_e = cls[0]
    packs = pack_hydro_blocks(cls, pos, vel, mass, hsml, rho, pressure,
                              dhsml_factor, div_vel, curl_vel, gas_mask, box,
                              hubble_a2_flow, fac_mu, active, fine_edge)
    out = hydro_sums_blocks(*packs, cl_e.n_cells,
                            _fine_edge(cl_e, box, fine_edge), visc_const,
                            _grid_periodic(cl_e))
    return hydro_result(merge_rows(out, cl_e, 5), rho, gas_mask,
                         hubble_a2_norm)


def hydro_force_blocks_entries(cls, pos, vel, mass, hsml, rho, pressure,
                               dhsml_factor, div_vel, curl_vel, gas_mask,
                               entry_blk, entry_slot, visc_const: float,
                               box: float, hubble_a2_flow, hubble_a2_norm,
                               fac_mu) -> HydroResult:
    """The hydro force of the active entries' targets on kernel G; the
    contract of :func:`hydro_force_blocks`, with zeros for particles in no
    entry (callers keep their frozen values)."""
    cl_e, cl_o = cls
    lf = _fine_edge(cl_e, box)
    fac_mu = torch.as_tensor(fac_mu, dtype=pos.dtype, device=pos.device)
    table16 = hydro_table(pos, vel, mass, hsml, rho, pressure, dhsml_factor,
                           div_vel, curl_vel, fac_mu)
    src16, idx_o = _pack16(cl_o, table16, gas_mask,
                           _centers(cl_o, "odd", lf), box)
    pidx, valid = entry_particles(cl_e, entry_blk, entry_slot, gas_mask)
    tgt16 = _hydro_rows(cl_e, table16, pidx, valid,
                        _entry_centers(cl_e, entry_blk, lf), box)
    tidx = torch.where(valid, pidx, torch.full_like(pidx, -1))
    out = hydro_sums_blocks_entries(
        tgt16.transpose(1, 2).contiguous(), tidx.contiguous(), src16, idx_o,
        entry_blk, hydro_params(hubble_a2_flow, fac_mu), cl_e.n_cells, lf,
        visc_const)
    return hydro_result(scatter_rows(out, pidx, valid, pos.shape[0]), rho,
                         gas_mask, hubble_a2_norm)
