"""PM mass deposit from the short-range cell tiles: kernel B's wrapper.

Counterpart of ``gadget_leicester_tpu/ops/pm_tiles.py:419-509``
(``pm_deposit_tiles``). The deposit reads the short-range pack
(``ops/cells.py :: pack_cells_soa``), so particles are found through
their (possibly stale) cells and their coordinates are cell-relative; the
absolute mesh coordinate is u = rel * n_pm / box + cell centre in mesh
units. Kernel B (``csrc/pm_deposit.cu``) adds each slot's 8 CIC weights
with atomics into the periodic mesh; :func:`pm_deposit_tiles_plain` is its
plain version (a deterministic ``index_add_``). The TPU kernel's padded
windows, colour-class order and fold are not carried over: a periodic wrap
of the corner index replaces them.
"""

from __future__ import annotations

import torch

from gadget_leicester_tpu_torch import kernels


def pm_deposit_tiles_plain(soa, n_cells: int, box: float,
                           n_pm: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B: the [n_pm]^3 mass mesh."""
    c, _, cap = soa.shape
    scale = n_pm / box
    edge_pm = n_pm / n_cells
    cid = torch.arange(c, device=soa.device)
    cxyz = torch.stack([cid // (n_cells * n_cells), (cid // n_cells) % n_cells,
                        cid % n_cells], -1).to(soa.dtype)
    off = (cxyz + 0.5) * edge_pm                          # [C, 3]
    u = soa[:, :3, :] * scale + off[:, :, None]           # [C, 3, cap]
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
