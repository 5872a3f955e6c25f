"""The plain short-range gravity sum over cell tiles: the plain versions
of kernels A and E.

Counterpart of ``gadget_leicester_tpu/ops/gravity_short.py ::
shortrange_gravity_cells`` (:32), the erfc-truncated softened pair sum
[G2: forcetree.c :: force_treeevaluate_shortrange()]. Here it works on
the same ``[C, 8, cap]`` cell-relative pack as kernels A and E
(``ops/cells.py :: shortrange_gravity_tiles``,
``shortrange_gravity_entries``), with the float32 arithmetic of the TPU
kernels in relative mode (``ops/pallas_cells.py :: _make_kernel_dma9``,
``_make_kernel_entries``). It is the CPU path of those kernels and the
reference the card is checked against, not a separate backend.
"""

from __future__ import annotations

import torch

from gadget_leicester_tpu_torch.ops.softening import grav_fac_nodiv

# trunc(x) = erfc(x) + 2x/sqrt(pi) exp(-x^2) as a degree-10 polynomial on
# x = r/(2 asmth) in [0, 2.25] (max |err| 6.5e-6) — the JAX package's
# _TRUNC_P10, written out again in csrc/glt_common.cuh
TRUNC_P10 = (0.999996443, 0.00034025031, -0.00511726609, -0.724873424,
             -0.060829609, 0.480734922, 0.121668214, -0.426925219,
             0.239634766, -0.0574951754, 0.00527855602)


def stencil_sources(n: int, cells: torch.Tensor):
    """For target cells ``cells`` [K]: the flat ids [K, 27] of the 27
    neighbours (periodic) and their integer offsets [27, 3]."""
    j = torch.arange(27, device=cells.device)
    offs = torch.stack([j // 9 - 1, (j // 3) % 3 - 1, j % 3 - 1], -1)
    cxyz = torch.stack([cells // (n * n), (cells // n) % n, cells % n], -1)
    nb = torch.remainder(cxyz[:, None, :] + offs[None], n)
    return (nb[..., 0] * n + nb[..., 1]) * n + nb[..., 2], offs


def _trunc_p10(x):
    p = torch.full_like(x, TRUNC_P10[-1])
    for c in TRUNC_P10[-2::-1]:
        p = p * x + c
    return p


def _stencil_sums(t, soa, cells, n_cells: int, box: float, asmth: float,
                  rcut: float) -> torch.Tensor:
    """Accelerations [K, 3, L] of the targets ``t`` [K, 8, L] (rows as in
    the pack) of cells ``cells`` [K] from the 27 cells around each."""
    src_ids, offs = stencil_sources(n_cells, cells)
    s = soa[src_ids]                                   # [K, 27, 8, cap]
    shift = offs.to(soa.dtype) * (box / n_cells)       # [27, 3]
    sx = (s[:, :, 0] + shift[None, :, 0, None]).flatten(1)
    sy = (s[:, :, 1] + shift[None, :, 1, None]).flatten(1)
    sz = (s[:, :, 2] + shift[None, :, 2, None]).flatten(1)
    sm, sh, shinv = (s[:, :, r].flatten(1) for r in (3, 4, 6))
    dx = t[:, 0, :, None] - sx[:, None, :]             # [K, L, 27 cap]
    dy = t[:, 1, :, None] - sy[:, None, :]
    dz = t[:, 2, :, None] - sz[:, None, :]
    r2 = dx * dx + dy * dy + dz * dz
    rinv = torch.rsqrt(r2.clamp_min(1e-37))
    r = r2 * rinv
    hh = torch.maximum(t[:, 4, :, None], sh[:, None, :])
    hhinv = torch.minimum(t[:, 6, :, None], shinv[:, None, :])
    fac = grav_fac_nodiv(r, rinv, hh, hhinv)
    fac = fac * _trunc_p10(torch.clamp(r * (0.5 / asmth), max=2.25))
    ok = (r2 < rcut * rcut) & (r2 > 0.0)
    w = torch.where(ok, sm[:, None, :] * fac, torch.zeros_like(fac))
    return -torch.stack([(w * dx).sum(-1), (w * dy).sum(-1),
                         (w * dz).sum(-1)], 1)


def _chunk(lanes: int, cap: int) -> int:
    """Targets' cells per step: ~12 live [K, lanes, 27 cap] temporaries,
    ~1 GB in all."""
    return max(1, (1 << 30) // (12 * 4 * 27 * cap * lanes))


def shortrange_gravity_tiles_plain(soa, flags, n_cells: int, box: float,
                                   asmth: float, rcut: float) -> torch.Tensor:
    """Plain PyTorch version of kernel A: out [C, 3, cap] (no G)."""
    c, _, cap = soa.shape
    chunk = _chunk(cap, cap)
    out = torch.zeros(c, 3, cap, dtype=soa.dtype, device=soa.device)
    todo = torch.nonzero(flags > 0).flatten()
    for k0 in range(0, todo.numel(), chunk):
        tc = todo[k0:k0 + chunk]
        out[tc] = _stencil_sums(soa[tc], soa, tc, n_cells, box, asmth, rcut)
    return out


def shortrange_gravity_entries_plain(soa, entry_cell, tgt, n_cells: int,
                                     box: float, asmth: float,
                                     rcut: float) -> torch.Tensor:
    """Plain PyTorch version of kernel E: out [K, 3, lanes] (no G) for
    the targets ``tgt`` [K, 8, lanes] of the entries ``entry_cell`` [K];
    padded entries (-1) and dead lanes (row 5 = 0) are 0."""
    k, _, lanes = tgt.shape
    chunk = _chunk(lanes, soa.shape[2])
    out = torch.zeros(k, 3, lanes, dtype=soa.dtype, device=soa.device)
    todo = torch.nonzero(entry_cell >= 0).flatten()
    for k0 in range(0, todo.numel(), chunk):
        e = todo[k0:k0 + chunk]
        t = tgt[e]
        acc = _stencil_sums(t, soa, entry_cell[e].long(), n_cells, box,
                            asmth, rcut)
        out[e] = torch.where(t[:, 5:6] > 0, acc, torch.zeros_like(acc))
    return out
