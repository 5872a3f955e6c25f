"""PM mass deposit from, and PM field gather to, the short-range cell
lists: the wrapper of kernel B and the cell-list entry of kernel L.

Counterpart of ``gadget_leicester_tpu/ops/pm_tiles.py:419-509``
(``pm_deposit_tiles``) and ``:194-264`` (``pm_gather_tiles``). The deposit
reads the short-range pack (``ops/cells.py :: pack_cells_soa``), so
particles are found through their (possibly stale) cells and their
coordinates are cell-relative; the absolute mesh coordinate is u = rel *
n_pm / box + cell centre in mesh units. Kernel B (``csrc/pm_deposit.cu``)
adds each slot's 8 CIC weights with atomics into the periodic mesh;
:func:`pm_deposit_tiles_plain` is its plain version (a deterministic
``index_add_``). The TPU kernel's padded windows, colour-class order and
fold are not carried over: a periodic wrap of the corner index replaces
them.

:func:`pm_gather_tiles` keeps the reference's entry: the CIC
interpolation of a mesh stack to the particles that sit in a cell of a
short-range list. It is kernel L (``ops/pm.py :: cic_gather_vec``, one
thread a particle from its wrapped position, the PM step's gather too)
followed by the mask of the particles that are dead or in no cell. The
reference's cell windows are not carried over.
"""

from __future__ import annotations

import torch

from gadget_leicester_tpu_torch import kernels
from gadget_leicester_tpu_torch.ops.neighbors import CellList
from gadget_leicester_tpu_torch.ops.pm import cic_gather_vec


def _mesh_coordinate(soa, n_cells: int, box: float, n_pm: int):
    """u [C, 3, cap] of the pack's slots in mesh units: rel * n_pm / box
    plus the cell centre (the coordinate kernels B and L take)."""
    c = soa.shape[0]
    cid = torch.arange(c, device=soa.device)
    cxyz = torch.stack([cid // (n_cells * n_cells), (cid // n_cells) % n_cells,
                        cid % n_cells], -1).to(soa.dtype)
    off = (cxyz + 0.5) * (n_pm / n_cells)
    return soa[:, :3, :] * (n_pm / box) + off[:, :, None]


def pm_deposit_tiles_plain(soa, n_cells: int, box: float,
                           n_pm: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B: the [n_pm]^3 mass mesh."""
    u = _mesh_coordinate(soa, n_cells, box, n_pm)         # [C, 3, cap]
    m = soa[:, 3, :]
    valid = soa[:, 5, :]
    i0f = torch.floor(u)
    frac = u - i0f
    i0 = torch.remainder(i0f.to(torch.int64), n_pm)
    keep = (m != 0).flatten()
    i0 = i0.permute(0, 2, 1).reshape(-1, 3)[keep]
    frac = frac.permute(0, 2, 1).reshape(-1, 3)[keep]
    m = m.flatten()[keep]
    valid = valid.flatten()[keep]
    mesh = torch.zeros(n_pm ** 3, dtype=soa.dtype, device=soa.device)
    for dx in (0, 1):
        wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
        ix = (i0[:, 0] + dx) % n_pm
        for dy in (0, 1):
            wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
            iy = (i0[:, 1] + dy) % n_pm
            wxy = wx * wy * valid
            for dz in (0, 1):
                wz = m * (frac[:, 2] if dz else 1.0 - frac[:, 2])
                iz = (i0[:, 2] + dz) % n_pm
                mesh.index_add_(0, (ix * n_pm + iy) * n_pm + iz, wxy * wz)
    return mesh.reshape(n_pm, n_pm, n_pm)


def pm_deposit_tiles(soa: torch.Tensor, n_cells: int, box: float,
                     n_pm: int) -> torch.Tensor:
    """Kernel B: CIC mass mesh [n_pm, n_pm, n_pm] of the packed slots
    (alive particles only: others are parked with m = 0). CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    c, rows, cap = soa.shape
    if c != n_cells ** 3 or rows != 8:
        raise ValueError(f"soa shape {tuple(soa.shape)} does not match "
                         f"{n_cells}^3 cells of 8 rows")
    kernels.check(soa, "soa", torch.float32)
    kernels.note_call("pm_deposit", (soa, n_cells, box, n_pm))
    if not kernels.on_cuda(soa):
        return pm_deposit_tiles_plain(soa, n_cells, box, n_pm)
    mesh = torch.zeros(n_pm, n_pm, n_pm, dtype=soa.dtype, device=soa.device)
    kernels.launch("pm_deposit", soa.data_ptr(), mesh.data_ptr(), n_cells,
                   cap, n_pm, n_pm / box, n_pm / n_cells)
    return mesh


def pm_gather_tiles(field, cl: CellList, pos, alive, box: float, n_pm: int,
                    n_cells: int, margin_pm: float) -> torch.Tensor:
    """CIC-interpolate the mesh field [n_pm, n_pm, n_pm, K] to the
    particles: [N, K], 0 where not alive or in no cell of the short-range
    list ``cl``. Kernel L at the wrapped positions, then the mask.
    ``margin_pm``, the grid cache's staleness margin in mesh cells, sized
    the reference's cell windows; the gather from positions needs none."""
    if cl.n_cells != n_cells:
        raise ValueError(f"the cell list has {cl.n_cells} cells an axis, "
                         f"not {n_cells}")
    rows = cic_gather_vec(field.contiguous(), torch.remainder(pos, box),
                          box, n_pm)
    keep = alive & (cl.gslot >= 0)
    return torch.where(keep[:, None], rows, torch.zeros_like(rows))
