"""The plain short-range gravity sum over cell tiles: the plain versions
of kernels A, E (with its potential mode), H and M, and kernel M's entry.

Counterpart of ``gadget_leicester_tpu/ops/gravity_short.py ::
shortrange_gravity_cells`` (:32), the erfc-truncated softened pair sum
[G2: forcetree.c :: force_treeevaluate_shortrange()]. Here it works on
the same ``[C, 8, cap]`` cell-relative pack as kernels A, E and H
(``ops/cells.py :: shortrange_gravity_tiles``,
``shortrange_gravity_entries``, ``shortrange_potential_tiles``), with the
float32 arithmetic of the TPU kernels (``ops/pallas_cells.py ::
_make_kernel_dma9``, ``_make_kernel_entries`` in relative mode, and
``_make_kernel_dma`` with ``with_potential``, whose absolute coordinates
and per-tile wrap shift H replaces by the relative pack; the
``with_potential`` mode of ``_make_kernel_dma9`` is H's rows, that of
``_make_kernel_entries`` E's potential mode). It is the CPU path of those
kernels and the reference the card is checked against, not
a separate backend.

:func:`shortrange_gravity_fresh` is the counterpart of ``ops/pallas_cells.py
:: shortrange_gravity_pallas`` (:1549): a fresh cell list, the ABSOLUTE
pack, kernel M (``ops/cells.py :: shortrange_gravity_cells``; kernel body
``_make_kernel``, :227) with the per-pair minimum image, periodic or on a
clamped grid; :func:`shortrange_gravity_cells_plain` is M's plain version.
:func:`shortrange_gravity_slab_plain` is the plain version of kernel A's
slab mode (``ops/cells.py :: shortrange_gravity_slab``; the reference's
``shortrange_gravity_pallas_dma9`` on per-axis cell counts with
``periodic=(False, True, True)``, absolute coordinates): M's arithmetic on
per-axis counts and an image on the periodic axes only, gated by tile
flags; with ``with_potential`` it adds the potential row of the reference's
``with_potential=True`` (the in-step potential of the slab step).
"""

from __future__ import annotations

import torch

from gadget_leicester_tpu_torch.ops.neighbors import live_width
from gadget_leicester_tpu_torch.ops.softening import (erfc_trunc,
                                                      grav_fac_nodiv,
                                                      grav_pot_nodiv)

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
                  rcut: float, with_potential: bool = False) -> torch.Tensor:
    """Accelerations [K, 3, L] of the targets ``t`` [K, 8, L] (rows as in
    the pack) of cells ``cells`` [K] from the 27 cells around each; with
    ``with_potential``, [K, 4, L] with the erfc-truncated softened
    potential as row 3. A target meets its own pack slot at r2 == 0
    exactly (the centre cell's shift is 0), so the self-pair adds
    nothing."""
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
    rows = [-(w * dx).sum(-1), -(w * dy).sum(-1), -(w * dz).sum(-1)]
    if with_potential:
        pfac = grav_pot_nodiv(r, rinv, hh, hhinv) * erfc_trunc(r, asmth)
        rows.append(torch.where(ok, sm[:, None, :] * pfac,
                                torch.zeros_like(pfac)).sum(-1))
    return torch.stack(rows, 1)


def _chunk(lanes: int, cap: int) -> int:
    """Targets' cells per step: ~12 live [K, lanes, 27 cap] temporaries,
    ~1 GB in all."""
    return max(1, (1 << 30) // (12 * 4 * 27 * cap * lanes))


def shortrange_gravity_tiles_plain(soa, flags, n_cells: int, box: float,
                                   asmth: float, rcut: float,
                                   with_potential: bool = False):
    """Plain PyTorch version of kernel A: out [C, 3, cap] (no G); with
    ``with_potential``, kernel H's [C, 4, cap] with the erfc-truncated
    softened potential as row 3. Zeros in cells whose flag is 0 and at
    parked slots (it sums the slots up to the last live one of any cell,
    :func:`live_width`)."""
    c, _, cap = soa.shape
    w = live_width(soa, 5)
    live = soa[..., :w]
    chunk = _chunk(w, w)
    out = torch.zeros(c, 4 if with_potential else 3, cap, dtype=soa.dtype,
                      device=soa.device)
    todo = torch.nonzero(flags > 0).flatten()
    for k0 in range(0, todo.numel(), chunk):
        tc = todo[k0:k0 + chunk]
        out[tc, :, :w] = _stencil_sums(live[tc], live, tc, n_cells, box,
                                       asmth, rcut, with_potential)
    return out


def shortrange_potential_tiles_plain(soa, flags, n_cells: int, box: float,
                                     asmth: float, rcut: float) -> torch.Tensor:
    """Plain PyTorch version of kernel H: out [C, 4, cap] (no G), rows ax,
    ay, az and the erfc-truncated softened potential."""
    return shortrange_gravity_tiles_plain(soa, flags, n_cells, box, asmth,
                                          rcut, with_potential=True)


def shortrange_gravity_entries_plain(soa, entry_cell, tgt, n_cells: int,
                                     box: float, asmth: float, rcut: float,
                                     with_potential: bool = False
                                     ) -> torch.Tensor:
    """Plain PyTorch version of kernel E: out [K, 3, lanes] (no G) for
    the targets ``tgt`` [K, 8, lanes] of the entries ``entry_cell`` [K];
    with ``with_potential``, [K, 4, lanes] with the erfc-truncated
    softened potential as row 3 (E's potential mode). Padded entries (-1)
    and dead lanes (row 5 = 0) are 0."""
    k, _, lanes = tgt.shape
    src = soa[..., :live_width(soa, 5)]
    chunk = _chunk(lanes, src.shape[2])
    out = torch.zeros(k, 4 if with_potential else 3, lanes, dtype=soa.dtype,
                      device=soa.device)
    todo = torch.nonzero(entry_cell >= 0).flatten()
    for k0 in range(0, todo.numel(), chunk):
        e = todo[k0:k0 + chunk]
        t = tgt[e]
        acc = _stencil_sums(t, src, entry_cell[e].long(), n_cells, box,
                            asmth, rcut, with_potential)
        out[e] = torch.where(t[:, 5:6] > 0, acc, torch.zeros_like(acc))
    return out


def _stencil_sums_abs(t, soa, cells, n_cells, box: float, periodic,
                      asmth: float, rcut: float,
                      with_potential: bool = False) -> torch.Tensor:
    """Accelerations [K, 3, L] of the targets ``t`` [K, 8, L] (rows of the
    absolute pack) of cells ``cells`` [K] from the 27 cells around each:
    kernel M's arithmetic. Each pair's separation is reduced to its minimum
    image along the periodic axes (``periodic`` one for all or per axis);
    stencil cells beyond a clamped face add nothing. A target meets its
    own pack slot at r == 0 exactly, so the self-pair adds nothing. With
    ``with_potential``, [K, 4, L] with the erfc-truncated softened
    potential as row 3 (A's slab mode with the potential)."""
    from gadget_leicester_tpu_torch.ops.neighbors import per3, stencil_cells
    ids, _, inside = stencil_cells(n_cells, cells, periodic)
    s = soa[ids]                                       # [K, 27, 8, cap]
    sx, sy, sz, sm, sh, shinv = (s[:, :, r].flatten(1)
                                 for r in (0, 1, 2, 3, 4, 6))
    src_ok = ((s[:, :, 5] > 0) & inside[:, :, None]).flatten(1)
    d = [t[:, a, :, None] - sa[:, None, :] for a, sa in enumerate((sx, sy, sz))]
    d = [x - box * torch.round(x * (1.0 / box)) if p else x
         for x, p in zip(d, per3(periodic))]
    dx, dy, dz = d
    r2 = dx * dx + dy * dy + dz * dz
    rinv = torch.rsqrt(r2.clamp_min(1e-37))
    r = r2 * rinv
    hh = torch.maximum(t[:, 4, :, None], sh[:, None, :])
    hhinv = torch.minimum(t[:, 6, :, None], shinv[:, None, :])
    fac = grav_fac_nodiv(r, rinv, hh, hhinv)
    if asmth > 0.0:
        fac = fac * _trunc_p10(torch.clamp(r * (0.5 / asmth), max=2.25))
    ok = (r < rcut) & (r > 0.0) & src_ok[:, None, :]
    w = torch.where(ok, sm[:, None, :] * fac, torch.zeros_like(fac))
    rows = [-(w * dx).sum(-1), -(w * dy).sum(-1), -(w * dz).sum(-1)]
    if with_potential:
        pfac = grav_pot_nodiv(r, rinv, hh, hhinv)
        if asmth > 0.0:
            pfac = pfac * erfc_trunc(r, asmth)
        rows.append(torch.where(ok, sm[:, None, :] * pfac,
                                torch.zeros_like(pfac)).sum(-1))
    return torch.stack(rows, 1)


def shortrange_gravity_cells_plain(soa, n_cells: int, box: float,
                                   periodic: bool, asmth: float,
                                   rcut: float) -> torch.Tensor:
    """Plain PyTorch version of kernel M: out [C, 3, cap] (no G) on the
    absolute pack ``soa``, chunked over target cells; zeros at parked
    slots (it sums the slots up to the last live one of any cell)."""
    c, _, cap = soa.shape
    w = live_width(soa, 5)
    live = soa[..., :w]
    chunk = _chunk(w, w)
    out = torch.zeros(c, 3, cap, dtype=soa.dtype, device=soa.device)
    todo = torch.nonzero((soa[:, 5] > 0).any(-1)).flatten()
    for k0 in range(0, todo.numel(), chunk):
        tc = todo[k0:k0 + chunk]
        t = live[tc]
        acc = _stencil_sums_abs(t, live, tc, n_cells, box, periodic, asmth,
                                rcut)
        out[tc, :, :w] = torch.where(t[:, 5:6] > 0, acc,
                                     torch.zeros_like(acc))
    return out


def shortrange_gravity_slab_plain(soa, flags, n_cells: tuple, box: float,
                                  periodic: tuple, asmth: float,
                                  rcut: float,
                                  with_potential: bool = False
                                  ) -> torch.Tensor:
    """Plain PyTorch version of kernel A's slab mode: out [C, 3, cap] (no
    G) on the absolute pack ``soa`` of a grid of per-axis ``n_cells``,
    each pair reduced to its minimum image along the axes ``periodic``
    holds True, stencil cells beyond a clamped face left out; zeros where
    ``flags`` is 0 and at parked slots. With ``with_potential``, the mode
    with the potential: [C, 4, cap], the erfc-truncated softened potential
    as row 3, rows 0-2 as without it. It sums the slots up to the last
    live one of any cell."""
    c, _, cap = soa.shape
    w = live_width(soa, 5)
    live = soa[..., :w]
    chunk = _chunk(w, w)
    out = torch.zeros(c, 4 if with_potential else 3, cap, dtype=soa.dtype,
                      device=soa.device)
    todo = torch.nonzero(flags > 0).flatten()
    for k0 in range(0, todo.numel(), chunk):
        tc = todo[k0:k0 + chunk]
        t = live[tc]
        acc = _stencil_sums_abs(t, live, tc, n_cells, box, periodic, asmth,
                                rcut, with_potential)
        out[tc, :, :w] = torch.where(t[:, 5:6] > 0, acc,
                                     torch.zeros_like(acc))
    return out


def shortrange_gravity_fresh(pos, mass, soft, alive, box: float, n_cells: int,
                             capacity: int = 128, asmth: float = 0.0,
                             rcut: float = 1e30, periodic: bool = True):
    """(acc [N, 3] without G, overflow): the short-range pair force of
    every alive particle over the 27 cells around its cell of a FRESH
    n_cells^3 cell list over [0, box), through kernel M. Counterpart of
    ``gadget_leicester_tpu/ops/pallas_cells.py ::
    shortrange_gravity_pallas``. ``periodic`` False clamps the grid and
    takes no minimum image; ``asmth == 0`` is plain softened gravity, cut
    at ``rcut``. Particles a full cell dropped get zeros and set
    ``overflow``."""
    from gadget_leicester_tpu_torch.ops.cells import (pack_cells_abs,
                                                      shortrange_gravity_cells)
    from gadget_leicester_tpu_torch.ops.neighbors import (build_cell_list,
                                                          merge_rows)
    cl = build_cell_list(pos, alive, 0.0, box, n_cells=n_cells,
                         capacity=capacity, periodic=periodic)
    soa = pack_cells_abs(cl, pos, mass, soft, alive)
    out = shortrange_gravity_cells(soa, n_cells, box, periodic, asmth, rcut)
    acc = merge_rows(out, cl, 3)
    return torch.where(alive[:, None], acc, torch.zeros_like(acc)), cl.overflow
