"""Uniform-grid cell lists with fixed per-cell capacity.

Counterpart of ``gadget_leicester_tpu/ops/neighbors.py`` (``CellList``,
``merge_rows``, ``build_cell_list``, and the stencil and pair driver
``_stencil_cids``, ``candidate_indices``, ``apply_pairwise``, plain
PyTorch as the reference is plain ``jnp``). Particles are binned
into a uniform grid, sorted by cell id with a STABLE sort (so slot ranks
equal those of the JAX package's ``argsort``), and placed into a
``[cells, capacity]`` table; excess particles of a full cell are dropped
and reported through ``overflow`` (the caller re-runs with a bigger
capacity). A periodic grid wraps cell coordinates; a vacuum grid (the gas
bounding box of a run without a box) clamps them to its edge cells. The
cell counts and the periodicity may be per-axis tuples, as the reference
takes them: the slab step's grid is clamped along x and periodic along y
and z (``parallel/spmd.py``). ``gslot`` is the inverse map used to merge kernel outputs back
to particles with one row gather; :func:`scatter_rows` merges the
active-entry kernels' outputs with one drop-mode row scatter.
:func:`stencil_cells` names the 27 cells around a cell, with their wrap
shifts, on a cubic or per-axis grid (kernels A, I/J, K, M and their plain
versions).
:func:`apply_pairwise` evaluates a pair function over blocks of targets
and the candidates of their 27-cell stencils (the zoom's short-range
passes, ``models/forces.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class CellList:
    cells: torch.Tensor     # [n_cells^3, capacity] int32 particle idx, -1 pad
    cell_of: torch.Tensor   # [N] int32 flat cell id per particle (-1 masked)
    counts: torch.Tensor    # [n_cells^3] int32 occupancy (may exceed capacity)
    overflow: torch.Tensor  # 0-d bool: any cell over capacity
    origin: torch.Tensor    # [3]
    inv_cell: torch.Tensor  # [3] 1/cell_size
    gslot: torch.Tensor     # [N] int32 flat slot in cells (-1 dead/dropped)
    n_cells: int            # per axis: an int (cube) or (nx, ny, nz)
    periodic: bool = True   # wrapped cell coordinates (False: clamped), or
                            # per axis (px, py, pz)


def dims3(n) -> tuple:
    """An int or a 3-tuple of per-axis counts as a 3-tuple."""
    return tuple(int(v) for v in n) if isinstance(n, (tuple, list)) \
        else (int(n),) * 3


def per3(periodic) -> tuple:
    """A bool or a 3-tuple of per-axis periodicity as a 3-tuple."""
    return tuple(bool(v) for v in periodic) \
        if isinstance(periodic, (tuple, list)) else (bool(periodic),) * 3


def stencil_cells(n_cells, cells: torch.Tensor, periodic):
    """For target cells ``cells`` [K]: the flat ids [K, 27] of the 27
    cells around each, wrapped along the periodic axes and clamped along
    the others; their wrap shifts in boxes [K, 27, 3] int32 (-1 where the
    neighbour lies below the grid along a periodic axis, +1 above, else
    0); and which of them are cells of the grid [K, 27] (all, when every
    axis is periodic). ``n_cells`` and ``periodic``: one for all axes, or
    per-axis tuples (the slab step's grids)."""
    ncv, pv = dims3(n_cells), per3(periodic)
    nv = torch.tensor(ncv, device=cells.device)
    j = torch.arange(27, device=cells.device)
    offs = torch.stack([j // 9 - 1, (j // 3) % 3 - 1, j % 3 - 1], -1)
    cxyz = torch.stack([cells // (ncv[1] * ncv[2]), (cells // ncv[2])
                        % ncv[1], cells % ncv[2]], -1)
    nb = cxyz[:, None, :] + offs[None]                     # [K, 27, 3]
    below, above = nb < 0, nb >= nv
    wrap = torch.tensor(pv, device=cells.device)
    shift = torch.where(wrap, above.to(torch.int32) - below.to(torch.int32),
                        torch.zeros_like(nb, dtype=torch.int32))
    inside = ~((below | above) & ~wrap).any(-1)
    nb = torch.where(wrap, torch.remainder(nb, nv),
                     torch.minimum(nb.clamp_min(0), nv - 1))
    return (nb[..., 0] * ncv[1] + nb[..., 1]) * ncv[2] + nb[..., 2], shift, \
        inside


def merge_rows(out: torch.Tensor, cl: CellList, n_rows: int,
               row0: int = 0) -> torch.Tensor:
    """Kernel output ``[C, K, cap]`` -> ``[N, n_rows]`` via one row gather
    over ``gslot``; dead or dropped particles get zero rows."""
    c, _, cap = out.shape
    rows = out[:, row0:row0 + n_rows, :].transpose(1, 2).reshape(-1, n_rows)
    rows = torch.cat([rows, rows.new_zeros(1, n_rows)], dim=0)
    gidx = torch.where(cl.gslot >= 0, cl.gslot,
                       torch.full_like(cl.gslot, c * cap))
    return rows[gidx.long()]


def live_width(soa: torch.Tensor, live_row: int) -> int:
    """The slots of a [C, R, cap] pack up to the last one that is live
    (row ``live_row`` > 0) in any cell: every slot past it is parked in
    every cell, adds nothing as a source and gets zeros as a target, so a
    plain version sums over the first ones alone (a cell list fills each
    cell's slots from the first)."""
    live = torch.nonzero((soa[:, live_row] > 0).any(0)).flatten()
    return int(live[-1]) + 1 if live.numel() else 1


def scatter_rows(out: torch.Tensor, pidx: torch.Tensor, valid: torch.Tensor,
                 n: int, fill=None) -> torch.Tensor:
    """Active-entry output ``[K, R, L]`` -> ``[n, R]``: each valid lane's
    row goes to its particle ``pidx`` [K, L] through a dump row at index
    ``n`` (the drop-mode scatter of the JAX package); particles no lane
    holds get ``fill`` [R] (zeros by default)."""
    _, r, _ = out.shape
    res = out.new_zeros(n + 1, r) if fill is None else \
        fill.to(out.dtype).expand(n + 1, r).clone()
    dst = torch.where(valid, pidx, torch.full_like(pidx, n)).reshape(-1)
    res[dst.long()] = out.transpose(1, 2).reshape(-1, r)
    return res[:n]


def segment_ranks(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal ids (input sorted)."""
    n = sorted_ids.shape[0]
    i_arr = torch.arange(n, dtype=torch.int32, device=sorted_ids.device)
    newseg = torch.ones(n, dtype=torch.bool, device=sorted_ids.device)
    newseg[1:] = sorted_ids[1:] != sorted_ids[:-1]
    first = torch.cummax(torch.where(newseg, i_arr, torch.zeros_like(i_arr)),
                         dim=0).values
    return i_arr - first


def _axes3(v, like: torch.Tensor) -> torch.Tensor:
    """A float, a 0-d tensor or a [3] tensor as a [3] tensor like ``like``
    (a device tensor stays on the device: no host sync)."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).expand(
        3).clone()


def _wrap_or_clamp(coords: torch.Tensor, ncv: tuple, pv: tuple):
    """Integer cell coordinates [..., 3] wrapped on the periodic axes and
    clamped to the edge cells on the others."""
    if pv[0] == pv[1] == pv[2] and ncv[0] == ncv[1] == ncv[2]:
        n = ncv[0]
        return torch.remainder(coords, n) if pv[0] else coords.clamp(0, n - 1)
    return torch.stack([torch.remainder(coords[..., a], ncv[a]) if pv[a]
                        else coords[..., a].clamp(0, ncv[a] - 1)
                        for a in range(3)], -1)


def build_cell_list(pos: torch.Tensor, mask: torch.Tensor, origin, extent,
                    n_cells, capacity: int, periodic=True) -> CellList:
    """Bin ``pos`` into an n_cells^3 grid over [origin, origin + extent)
    (``origin``, ``extent``: a float or a tensor, per axis or one for all;
    ``n_cells`` and ``periodic`` one for all axes or per-axis tuples).
    Cell coordinates wrap on a periodic axis and are clamped to the edge
    cells otherwise. Masked particles land in no cell; a full cell drops
    its excess."""
    n = pos.shape[0]
    dev = pos.device
    ncv, pv = dims3(n_cells), per3(periodic)
    origin_t = _axes3(origin, pos)
    extent_t = _axes3(extent, pos)
    inv_cell = torch.tensor(ncv, dtype=pos.dtype, device=dev) / extent_t
    coords = torch.floor((pos - origin_t) * inv_cell).to(torch.int32)
    coords = _wrap_or_clamp(coords, ncv, pv)
    cid_real = (coords[:, 0] * ncv[1] + coords[:, 1]) * ncv[2] \
        + coords[:, 2]
    total = ncv[0] * ncv[1] * ncv[2]
    cid = torch.where(mask, cid_real, torch.full_like(cid_real, total))

    cid_sorted, order = torch.sort(cid, stable=True)   # dead sort last
    order = order.to(torch.int32)
    rank = segment_ranks(cid_sorted)
    ok = rank < capacity
    cells = torch.full((total + 1, capacity), -1, dtype=torch.int32,
                       device=dev)
    cells[torch.where(ok, cid_sorted, torch.full_like(cid_sorted, total)).long(),
          torch.where(ok, rank, torch.zeros_like(rank)).long()] = \
        torch.where(ok, order, torch.full_like(order, -1))
    counts = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, cid_sorted.long(), torch.ones_like(cid_sorted))
    overflow = (counts[:total] > capacity).any()
    ok_live = ok & (cid_sorted < total)
    gslot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    gslot[order.long()] = torch.where(ok_live, cid_sorted * capacity + rank,
                                      torch.full_like(rank, -1))
    return CellList(
        cells=cells[:total].contiguous(),
        cell_of=torch.where(mask, cid_real, torch.full_like(cid_real, -1)),
        counts=counts[:total], overflow=overflow, origin=origin_t,
        inv_cell=inv_cell, gslot=gslot, n_cells=n_cells,
        periodic=periodic)


_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def _stencil_cids(coords: torch.Tensor, n_cells: int,
                  periodic: bool) -> torch.Tensor:
    """[..., 27] flat cell ids of the 3^3 stencil around the integer cell
    coordinates ``coords`` [..., 3], in the reference's order (dz fastest);
    off a clamped grid's edge -1."""
    offs = torch.tensor(_OFFSETS, dtype=coords.dtype, device=coords.device)
    c = coords[..., None, :] + offs
    if periodic:
        c = torch.remainder(c, n_cells)
        valid = torch.ones(c.shape[:-1], dtype=torch.bool, device=c.device)
    else:
        valid = ((c >= 0) & (c < n_cells)).all(dim=-1)
        c = c.clamp(0, n_cells - 1)
    cid = (c[..., 0] * n_cells + c[..., 1]) * n_cells + c[..., 2]
    return torch.where(valid, cid, torch.full_like(cid, -1))


def candidate_indices(cl: CellList, target_pos: torch.Tensor) -> torch.Tensor:
    """[T, 27 capacity] int32 candidate particle indices of each target
    position (-1: none), stencil cell by stencil cell."""
    coords = torch.floor((target_pos - cl.origin) * cl.inv_cell).to(
        torch.int32)
    coords = torch.remainder(coords, cl.n_cells) if cl.periodic else \
        coords.clamp(0, cl.n_cells - 1)
    cids = _stencil_cids(coords, cl.n_cells, cl.periodic)
    cand = cl.cells[cids.clamp_min(0).long()]
    cand = torch.where(cids[..., None] >= 0, cand, torch.full_like(cand, -1))
    return cand.reshape(target_pos.shape[0], -1)


def apply_pairwise(cl: CellList, target_pos: torch.Tensor, pair_fn,
                   block: int = 256, n_targets: int | None = None):
    """Blocked pair evaluation [G2: gravtree.c BunchSizeForce]: for each
    block of ``block`` targets, ``pair_fn(tgt_idx [B], tgt_pos [B, 3],
    cand [B, 27 cap])`` returns a tensor, or a tuple of tensors, of
    per-target rows; the blocks are concatenated. The last block is
    shorter: a pair function whose per-target sums do not depend on the
    other rows of its block (:func:`stencil_sum`) gives each target the
    same result at any ``block``. ``n_targets`` restricts the targets to
    the first rows of ``target_pos``."""
    if n_targets is not None:
        target_pos = target_pos[:n_targets]
    t = target_pos.shape[0]
    dev = target_pos.device
    outs = []
    for start in range(0, t, block):
        idx = torch.arange(start, min(start + block, t), device=dev)
        tp = target_pos[start:start + block]
        outs.append(pair_fn(idx, tp, candidate_indices(cl, tp)))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def stencil_sum(x: torch.Tensor, cap: int) -> torch.Tensor:
    """Sum over the candidate axis of ``x`` [B, 27 cap, ...] in a fixed
    order of element-wise adds: a halving tree over each stencil cell's
    ``cap`` slots (padded with zeros to a power of two), then the 27 cells
    in stencil order. Each row's sum depends on its own elements alone,
    not on the rows beside it: a library reduction may split a row's sum
    by the shape of the whole tensor, and so by the block."""
    b = x.shape[0]
    x = x.reshape(b, 27, cap, *x.shape[2:])
    width = 1 << max(cap - 1, 0).bit_length()
    if width != cap:
        pad = x.new_zeros(b, 27, width - cap, *x.shape[3:])
        x = torch.cat([x, pad], dim=2)
    while width > 1:
        width //= 2
        x = x[:, :, :width] + x[:, :, width:]
    x = x[:, :, 0]
    out = x[:, 0]
    for k in range(1, 27):
        out = out + x[:, k]
    return out
