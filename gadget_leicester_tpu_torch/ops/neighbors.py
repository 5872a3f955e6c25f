"""Uniform-grid cell lists with fixed per-cell capacity.

Counterpart of ``gadget_leicester_tpu/ops/neighbors.py:33-147``
(``CellList``, ``merge_rows``, ``build_cell_list``). Particles are binned
into a uniform grid, sorted by cell id with a STABLE sort (so slot ranks
equal those of the JAX package's ``argsort``), and placed into a
``[cells, capacity]`` table; excess particles of a full cell are dropped
and reported through ``overflow`` (the caller re-runs with a bigger
capacity). A periodic grid wraps cell coordinates; a vacuum grid (the gas
bounding box of a run without a box) clamps them to its edge cells. ``gslot`` is the inverse map used to merge kernel outputs back
to particles with one row gather; :func:`scatter_rows` merges the
active-entry kernels' outputs with one drop-mode row scatter.
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
    n_cells: int            # per axis
    periodic: bool = True   # wrapped cell coordinates (False: clamped)


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


def build_cell_list(pos: torch.Tensor, mask: torch.Tensor, origin, extent,
                    n_cells: int, capacity: int,
                    periodic: bool = True) -> CellList:
    """Bin ``pos`` into an n_cells^3 grid over [origin, origin + extent)
    (``origin``, ``extent``: a float or a tensor, per axis or one for all).
    Cell coordinates wrap on a periodic grid and are clamped to the edge
    cells otherwise. Masked particles land in no cell; a full cell drops
    its excess."""
    n = pos.shape[0]
    dev = pos.device
    origin_t = _axes3(origin, pos)
    extent_t = _axes3(extent, pos)
    inv_cell = torch.full_like(extent_t, n_cells) / extent_t
    coords = torch.floor((pos - origin_t) * inv_cell).to(torch.int32)
    coords = torch.remainder(coords, n_cells) if periodic else \
        coords.clamp(0, n_cells - 1)
    cid_real = (coords[:, 0] * n_cells + coords[:, 1]) * n_cells \
        + coords[:, 2]
    total = n_cells ** 3
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
