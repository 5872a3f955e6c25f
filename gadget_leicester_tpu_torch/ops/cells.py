"""Cell tiles for TreePM short-range gravity, and kernel A's wrapper.

Counterpart of ``gadget_leicester_tpu/ops/pallas_cells.py``:
``pack_cells_soa`` (:38, relative mode), ``_cell_centers`` (:92),
``cell_activity_flags`` (:423), ``shortrange_gravity_pallas_dma9``
(:669, here :func:`shortrange_gravity_tiles`) and ``grav_tile_flags``
(:741).

Kernel A (``csrc/shortrange_gravity.cu``) takes the ``[C, 8, cap]`` pack
directly and walks the 27 neighbour cells itself; the TPU kernel's
z-padded column layout is a DMA device and is not carried over. Its plain
version is ``ops/gravity_short.py :: shortrange_gravity_tiles_plain``.
"""

from __future__ import annotations

import torch

from gadget_leicester_tpu_torch import kernels
from gadget_leicester_tpu_torch.ops.gravity_short import \
    shortrange_gravity_tiles_plain
from gadget_leicester_tpu_torch.ops.neighbors import CellList


def cell_centers(cl: CellList) -> torch.Tensor:
    """[C, 3] geometric centres of the grid cells."""
    n = cl.n_cells
    c_arr = torch.arange(n ** 3, dtype=torch.int32, device=cl.cells.device)
    f = cl.origin.dtype
    xyz = torch.stack([(c_arr // (n * n)).to(f), ((c_arr % (n * n)) // n).to(f),
                       (c_arr % n).to(f)], -1)
    return (xyz + 0.5) / cl.inv_cell + cl.origin


def pack_cells_soa(cl: CellList, pos, mass, soft, alive) -> torch.Tensor:
    """[C, 8, cap] tiles, rows x, y, z (relative to the cell centre,
    minimum-imaged), m, soft, 1, 1/soft, 0. Empty or dead slots are parked
    at a FINITE offset of -7 cells with m = 0: 1e30 would square to inf and
    leak NaN through 0 * inf."""
    idx = cl.cells.clamp_min(0).long()
    valid = (cl.cells >= 0) & alive[idx]
    soft_inv = torch.where(soft > 0, 1.0 / soft, torch.zeros_like(soft))
    table = torch.stack([pos[:, 0], pos[:, 1], pos[:, 2], mass, soft,
                         torch.ones_like(mass), soft_inv,
                         torch.zeros_like(mass)], dim=1)
    rows = table[idx]                                   # [C, cap, 8]
    rel = rows[:, :, :3] - cell_centers(cl)[:, None, :]
    ext = cl.n_cells / cl.inv_cell
    rel = rel - ext * torch.round(rel / ext)
    rows = torch.cat([rel, rows[:, :, 3:]], dim=-1)
    far = -7.0 / cl.inv_cell[0]
    park = torch.zeros(8, dtype=rows.dtype, device=rows.device)
    park[:3] = far
    rows = torch.where(valid[:, :, None], rows, park)
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


def shortrange_gravity_tiles(soa: torch.Tensor, flags: torch.Tensor,
                             n_cells: int, box: float, asmth: float,
                             rcut: float) -> torch.Tensor:
    """Kernel A: short-range accelerations of the packed targets, [C, 3,
    cap], zeros in cells whose flag is 0. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    c, rows, cap = soa.shape
    if c != n_cells ** 3 or rows != 8:
        raise ValueError(f"soa shape {tuple(soa.shape)} does not match "
                         f"{n_cells}^3 cells of 8 rows")
    kernels.check(soa, "soa", torch.float32)
    kernels.check(flags, "flags", torch.int32, (c,), soa.device)
    kernels.note_call("shortrange_gravity",
                      (soa, flags, n_cells, box, asmth, rcut))
    if not kernels.on_cuda(soa, flags):
        return shortrange_gravity_tiles_plain(soa, flags, n_cells, box,
                                              asmth, rcut)
    out = torch.empty(c, 3, cap, dtype=soa.dtype, device=soa.device)
    kernels.launch("shortrange_gravity", soa.data_ptr(), flags.data_ptr(),
                   out.data_ptr(), n_cells, cap, box / n_cells,
                   0.5 / asmth, rcut * rcut)
    return out
