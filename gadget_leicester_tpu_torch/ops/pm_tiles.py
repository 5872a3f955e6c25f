"""PM mass deposit from, and PM force gather to, the short-range cell
tiles: the wrappers of kernels B and L.

Counterpart of ``gadget_leicester_tpu/ops/pm_tiles.py:419-509``
(``pm_deposit_tiles``) and ``:46-57, 194-264`` (``_window_geometry``,
``pm_gather_tiles``). The deposit reads the short-range pack
(``ops/cells.py :: pack_cells_soa``), so particles are found through
their (possibly stale) cells and their coordinates are cell-relative; the
absolute mesh coordinate is u = rel * n_pm / box + cell centre in mesh
units. Kernel B (``csrc/pm_deposit.cu``) adds each slot's 8 CIC weights
with atomics into the periodic mesh; :func:`pm_deposit_tiles_plain` is its
plain version (a deterministic ``index_add_``). The TPU kernel's padded
windows, colour-class order and fold are not carried over: a periodic wrap
of the corner index replaces them.

The gather (kernel L, ``csrc/pm_gather.cu``) interpolates a K-component
mesh field to the slots of the same pack: one thread block per cell stages
the cell's mesh window (:func:`window_geometry`) in shared memory and each
slot reads its 8 corners there, or in the mesh itself when the particle
drifted out of the window, so the result is exact for any position.
:func:`pm_gather_windows_plain` is its plain version (8 indexed reads of
the mesh). The step keeps the row gather of ``ops/pm.py``, as the
reference's does; :func:`pm_gather_tiles` is the entry for the mesh stack
of ``pm_forces_periodic(..., return_field=True)``.
"""

from __future__ import annotations

import math

import torch

from gadget_leicester_tpu_torch import kernels
from gadget_leicester_tpu_torch.ops.neighbors import CellList, merge_rows


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


def window_geometry(n_pm: int, n_cells: int, margin_pm: float):
    """(w, p0): the side of a cell's mesh window and its low-side reach, in
    mesh cells. A particle filed in cell c lies within [c edge - m, (c + 1)
    edge + m) in mesh units (m the staleness margin) and CIC touches
    floor(u) and floor(u) + 1, so the window from floor(c edge - m) spans
    ceil(edge + 2 m) + 2 cells, and 1 more for the floor's jitter at a
    non-integer edge."""
    edge_pm = n_pm / n_cells
    return (int(math.ceil(edge_pm + 2.0 * margin_pm)) + 3,
            int(math.ceil(margin_pm)) + 1)


def pm_gather_windows_plain(soa, field, n_cells: int, box: float, n_pm: int,
                            margin_pm: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of kernel L: [C, K, cap], the CIC
    interpolation of ``field`` [n_pm, n_pm, n_pm, K] at the pack's slots,
    0 at parked slots. ``margin_pm`` sizes the kernel's window only and is
    not used here."""
    c, _, cap = soa.shape
    k = field.shape[-1]
    u = _mesh_coordinate(soa, n_cells, box, n_pm)
    i0f = torch.floor(u)
    frac = u - i0f
    i0 = torch.remainder(i0f.to(torch.int64), n_pm)
    flat = field.reshape(-1, k)
    out = torch.zeros(c, cap, k, dtype=field.dtype, device=field.device)
    for dx in (0, 1):
        wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
        ix = (i0[:, 0] + dx) % n_pm
        for dy in (0, 1):
            wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
            iy = (i0[:, 1] + dy) % n_pm
            wxy = wx * wy
            for dz in (0, 1):
                wz = frac[:, 2] if dz else 1.0 - frac[:, 2]
                iz = (i0[:, 2] + dz) % n_pm
                out += flat[(ix * n_pm + iy) * n_pm + iz] * (wxy * wz)[..., None]
    valid = soa[:, 5, :] > 0
    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    return out.transpose(1, 2).contiguous()


def pm_gather_windows(soa: torch.Tensor, field: torch.Tensor, n_cells: int,
                      box: float, n_pm: int,
                      margin_pm: float = 0.0) -> torch.Tensor:
    """Kernel L: [C, K, cap], the CIC interpolation of ``field`` [n_pm,
    n_pm, n_pm, K] (K <= 4) at the slots of the pack ``soa``, 0 at parked
    slots; each cell's window is sized for particles up to ``margin_pm``
    mesh cells outside their cell, and a particle beyond it is still
    exact. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    c, rows, cap = soa.shape
    if c != n_cells ** 3 or rows != 8:
        raise ValueError(f"soa shape {tuple(soa.shape)} does not match "
                         f"{n_cells}^3 cells of 8 rows")
    k = field.shape[-1]
    if not 1 <= k <= 4:
        raise ValueError(f"field has {k} components; the gather takes 1 to 4")
    kernels.check(soa, "soa", torch.float32)
    kernels.check(field, "field", torch.float32, (n_pm, n_pm, n_pm, k),
                  soa.device)
    kernels.note_call("pm_gather", (soa, field, n_cells, box, n_pm, margin_pm))
    if not kernels.on_cuda(soa, field):
        return pm_gather_windows_plain(soa, field, n_cells, box, n_pm,
                                       margin_pm)
    w, _ = window_geometry(n_pm, n_cells, margin_pm)
    out = torch.empty(c, k, cap, dtype=soa.dtype, device=soa.device)
    kernels.launch("pm_gather", soa.data_ptr(), field.data_ptr(),
                   out.data_ptr(), n_cells, cap, n_pm, k, w, n_pm / box,
                   n_pm / n_cells, float(margin_pm))
    return out


def _gather_tiles(windows, field, cl: CellList, pos, alive, box: float,
                  n_pm: int, n_cells: int, margin_pm: float) -> torch.Tensor:
    from gadget_leicester_tpu_torch.ops.cells import pack_cells_soa
    if cl.n_cells != n_cells:
        raise ValueError(f"the cell list has {cl.n_cells} cells an axis, "
                         f"not {n_cells}")
    one = torch.ones_like(pos[:, 0])
    soa = pack_cells_soa(cl, pos, one, one, alive)
    out = windows(soa, field.contiguous(), n_cells, box, n_pm, margin_pm)
    res = merge_rows(out, cl, field.shape[-1])
    return torch.where(alive[:, None], res, torch.zeros_like(res))


def pm_gather_tiles(field, cl: CellList, pos, alive, box: float, n_pm: int,
                    n_cells: int, margin_pm: float) -> torch.Tensor:
    """CIC-interpolate the mesh field [n_pm, n_pm, n_pm, K] to the
    particles through their (possibly stale) short-range cell list ``cl``:
    [N, K], 0 where not alive or in no cell. The unit-mass relative pack,
    kernel L over every cell, and one row gather over ``gslot``.
    ``margin_pm``: the grid cache's staleness margin in mesh cells
    (``grav_grid_geometry``'s margin times n_pm / box)."""
    return _gather_tiles(pm_gather_windows, field, cl, pos, alive, box, n_pm,
                         n_cells, margin_pm)


def pm_gather_tiles_plain(field, cl: CellList, pos, alive, box: float,
                          n_pm: int, n_cells: int,
                          margin_pm: float) -> torch.Tensor:
    """:func:`pm_gather_tiles` through kernel L's plain version, on any
    device: the same pack, the same mesh coordinate, the same merge."""
    return _gather_tiles(pm_gather_windows_plain, field, cl, pos, alive, box,
                         n_pm, n_cells, margin_pm)
