"""Coarse-cell SPH: the pack, the wrappers of kernels I/J (density) and K
(hydro) over the 27-cell stencil of one cell list, and the host functions
around them.

Counterpart of ``gadget_leicester_tpu/ops/pallas_cells.py:1071-1544``
(``pack_sph_soa`` in its plain form, ``density_sums_pallas_dma`` and its
grid twin ``density_sums_pallas``, ``hydro_sums_pallas``,
``density_adaptive_pallas``, ``hydro_force_pallas``,
``scatter_cell_rows``): the ``sph_backend="cells"`` path. Gas is binned
into one coarse cell list (cell edge >= the largest h, which the caller
caps there), packed as ``[C, rows, cap]`` tiles of ABSOLUTE positions,
and every target slot sums over the 27 cells around its own. A periodic
grid adds -+box to a whole neighbour tile that lies across the wrap; a
vacuum grid (``periodic=False``) adds nothing and leaves out the stencil
cells beyond its edge. The two TPU density kernels are two schedules of
one function, so one CUDA kernel stands for both.

A whole-tile shift is right only if every particle of a tile lies in that
tile's cell. Rounding can file a particle on the far side of the wrap: a
coordinate equal to the box (a float64 position just below it, rounded to
float32) lands in cell 0, a box away from the neighbours it is filed
with, and the reference's kernel I then loses them (its twin J, with the
per-pair minimum image, does not). The packs here therefore store each
coordinate as its image nearest the centre of the particle's cell
(:func:`_cell_rows`), the same value for its target and its source copy;
for every other particle that is the coordinate itself, bit for bit.

Absolute coordinates make the self-pair exact: a target meets its own
slot in the centre cell, whose shift is 0, at r2 == 0 bit for bit.
Density includes it (m W(0, h); dW/dr(0) = 0); hydro excludes it by
r2 > 0. Empty slots are parked at -7 cells with m = 0, h = 1 and valid 0;
a parked TARGET slot gets zeros (no particle reads them). Kernel outputs
go back to particles with one row gather over ``gslot``
(``neighbors.merge_rows``), which gives what the reference's drop-mode
``scatter_cell_rows`` gives: zeros for a particle in no slot.
"""

from __future__ import annotations

import torch

from gadget_leicester_tpu_torch import kernels
from gadget_leicester_tpu_torch.ops.neighbors import (CellList,
                                                      build_cell_list,
                                                      merge_rows)
from gadget_leicester_tpu_torch.ops.sph_dense import (
    DENSITY_FILL, HydroResult, density_adaptive_generic, density_columns,
    density_result, hydro_params, hydro_result, hydro_table)
from gadget_leicester_tpu_torch.ops.sph_kernels import (kernel_dw_dr,
                                                        kernel_w_and_dwdh)


def stencil_cells(n: int, cells: torch.Tensor, periodic: bool):
    """For target cells ``cells`` [K]: the flat ids [K, 27] of the 27
    cells around each, their wrap shifts in boxes [K, 27, 3] (-1 where
    the neighbour lies below the grid, +1 above, on a periodic grid; 0 on
    a vacuum grid) and whether each lies inside the grid [K, 27] (always,
    on a periodic grid)."""
    j = torch.arange(27, device=cells.device)
    offs = torch.stack([j // 9 - 1, (j // 3) % 3 - 1, j % 3 - 1], -1)
    cxyz = torch.stack([cells // (n * n), (cells // n) % n, cells % n], -1)
    nb = cxyz[:, None, :] + offs[None]                     # [K, 27, 3]
    below, above = nb < 0, nb >= n
    if periodic:
        shift = above.to(torch.int32) - below.to(torch.int32)
        inside = torch.ones(nb.shape[:2], dtype=torch.bool,
                            device=cells.device)
        nb = torch.remainder(nb, n)
    else:
        shift = torch.zeros_like(nb, dtype=torch.int32)
        inside = ~(below | above).any(-1)
        nb = nb.clamp(0, n - 1)
    return (nb[..., 0] * n + nb[..., 1]) * n + nb[..., 2], shift, inside


def _park(cl: CellList, rows: int, like: torch.Tensor) -> torch.Tensor:
    """The row of an empty slot: x, y, z at -7 cells, h (row 7) = 1, all
    else 0 (m = 0, valid = 0)."""
    park = torch.zeros(rows, dtype=like.dtype, device=like.device)
    park[:3] = -7.0 / cl.inv_cell[0]
    park[7] = 1.0
    return park


def _slot_valid(cl: CellList, gas_mask):
    idx = cl.cells.clamp_min(0).long()
    return idx, (cl.cells >= 0) & gas_mask[idx]


def _cell_rows(cl: CellList, table, gas_mask, box: float) -> torch.Tensor:
    """[C, R, cap] tiles of the [N, R] rows ``table`` (x, y, z first) as
    one row gather; on a periodic grid x, y, z become their images nearest
    the centre of the slot's cell (a change only for a particle that
    rounding filed across the wrap); empty slots parked
    (:func:`_park`)."""
    idx, valid = _slot_valid(cl, gas_mask)
    rows = table[idx]                                      # [C, cap, R]
    if cl.periodic:
        n = cl.n_cells
        c = torch.arange(n ** 3, device=table.device)
        cxyz = torch.stack([c // (n * n), (c // n) % n, c % n], -1)
        centre = (cxyz.to(table.dtype) + 0.5) / cl.inv_cell + cl.origin
        rel = rows[:, :, :3] - centre[:, None, :]
        rows = torch.cat([rows[:, :, :3] - box * torch.round(rel / box),
                          rows[:, :, 3:]], dim=-1)
    rows = torch.where(valid[:, :, None], rows,
                       _park(cl, table.shape[1], table))
    return rows.transpose(1, 2).contiguous()


def pack_sph_soa(cl: CellList, pos, vel, mass, hsml, gas_mask,
                 box: float) -> torch.Tensor:
    """[C, 8, cap] rows x, y, z (absolute), m, vx, vy, vz, h
    (:func:`_cell_rows`; ``box`` is read on a periodic grid only)."""
    table = torch.cat([pos, mass[:, None], vel, hsml[:, None]], dim=1)
    return _cell_rows(cl, table, gas_mask, box)


def _chunk(cap: int, temporaries: int) -> int:
    """Target cells per step of a plain version: ~1 GB of [K, cap, 27 cap]
    float32."""
    return max(1, (1 << 30) // (temporaries * 4 * 27 * cap * cap))


def _gather_sources(soa, cells, n: int, box: float, periodic: bool, rows):
    """Source rows [K, 27 cap] of the 27 cells around ``cells`` [K], x, y
    and z (rows 0-2) with the wrap shift added to the whole tile, and the
    [K, 27 cap] mask of the lanes whose cell lies inside the grid."""
    ids, shift, inside = stencil_cells(n, cells, periodic)
    s = soa[ids]                                           # [K, 27, R, cap]
    cap = s.shape[-1]
    sh = shift.to(soa.dtype) * box
    out = []
    for r in rows:
        x = s[:, :, r]
        if r < 3:
            x = x + sh[:, :, r, None]
        out.append(x.flatten(1))
    return out, inside[:, :, None].expand(-1, -1, cap).flatten(1)


def _pair_geometry(t, s):
    """dx, dy, dz [K, L, 27 cap] = t - s, r, rinv, r2."""
    d = [t[:, a, :, None] - s[a][:, None, :] for a in range(3)]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    rinv = torch.rsqrt(r2.clamp_min(1e-37))
    return d[0], d[1], d[2], r2 * rinv, rinv, r2


def _density_sums(t, ht, soa, cells, n: int, box: float,
                  periodic: bool) -> torch.Tensor:
    """[K, 6, L] = rho, drho/dh, raw div v, raw rot v of the targets ``t``
    [K, 8, L] with smoothing lengths ``ht`` [K, L] of cells ``cells``
    [K]; zeros for parked targets."""
    s, inside = _gather_sources(soa, cells, n, box, periodic, range(7))
    dx, dy, dz, r, rinv, _ = _pair_geometry(t, s)
    ht = ht[:, :, None]
    w, dwdh = kernel_w_and_dwdh(r, ht)
    dwdr = kernel_dw_dr(r, ht)
    m = torch.where(inside, s[3], torch.zeros_like(s[3]))[:, None, :]
    fac = m * dwdr * rinv          # dW/dr(0) == 0 exactly; rinv finite
    dvx = t[:, 4, :, None] - s[4][:, None, :]
    dvy = t[:, 5, :, None] - s[5][:, None, :]
    dvz = t[:, 6, :, None] - s[6][:, None, :]
    vdotr = dvx * dx + dvy * dy + dvz * dz
    sums = torch.stack([(m * w).sum(-1), (m * dwdh).sum(-1),
                        -(fac * vdotr).sum(-1),
                        (fac * (dvy * dz - dvz * dy)).sum(-1),
                        (fac * (dvz * dx - dvx * dz)).sum(-1),
                        (fac * (dvx * dy - dvy * dx)).sum(-1)], 1)
    return torch.where(t[:, 3:4] > 0, sums, torch.zeros_like(sums))


def density_sums_cells_plain(soa, h_slots, flags, n_cells: int, box: float,
                             periodic: bool) -> torch.Tensor:
    """Plain PyTorch version of kernels I and J: out [C, 6, cap] = rho,
    drho/dh, raw div v, raw rot v (x, y, z); zeros where flags is 0."""
    c, _, cap = soa.shape
    chunk = _chunk(cap, 24)
    out = torch.zeros(c, 6, cap, dtype=soa.dtype, device=soa.device)
    todo = torch.nonzero(flags > 0).flatten()
    for k0 in range(0, todo.numel(), chunk):
        tc = todo[k0:k0 + chunk]
        out[tc] = _density_sums(soa[tc], h_slots[tc], soa, tc, n_cells, box,
                                periodic)
    return out


def _check_grid(soa, rows: int, n_cells: int, periodic: bool) -> None:
    c, r, _ = soa.shape
    if c != n_cells ** 3 or r != rows:
        raise ValueError(f"pack shape {tuple(soa.shape)} does not match "
                         f"{n_cells}^3 cells of {rows} rows")
    if periodic and n_cells < 3:
        raise ValueError("a periodic 27-cell stencil needs n_cells >= 3")


def density_sums_cells(soa: torch.Tensor, h_slots: torch.Tensor,
                       flags: torch.Tensor, n_cells: int, box: float,
                       periodic: bool) -> torch.Tensor:
    """Kernels I and J: density sums [C, 6, cap] of every live target slot
    of the pack ``soa`` [C, 8, cap] (:func:`pack_sph_soa`) at its
    smoothing length ``h_slots`` [C, cap], over the 27 cells around its
    own; cells whose flag is 0 are skipped (zeros). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    _check_grid(soa, 8, n_cells, periodic)
    c, _, cap = soa.shape
    kernels.check(soa, "soa", torch.float32)
    kernels.check(h_slots, "h_slots", torch.float32, (c, cap), soa.device)
    kernels.check(flags, "flags", torch.int32, (c,), soa.device)
    kernels.note_call("sph_cells_density",
                      (soa, h_slots, flags, n_cells, box, periodic))
    if not kernels.on_cuda(soa, h_slots, flags):
        return density_sums_cells_plain(soa, h_slots, flags, n_cells, box,
                                        periodic)
    out = torch.empty(c, 6, cap, dtype=soa.dtype, device=soa.device)
    kernels.launch("sph_cells_density", soa.data_ptr(), h_slots.data_ptr(),
                   flags.data_ptr(), out.data_ptr(), n_cells, cap, box,
                   int(periodic))
    return out


def _hydro_sums(t, soa16, cells, params, n: int, box: float, periodic: bool,
                visc_const: float) -> torch.Tensor:
    """[K, 5, L] = ax, ay, az, raw dA/dt, max signal velocity of the
    targets ``t`` [K, 16, L] of cells ``cells`` [K]; every mask is a
    select (1 / rho_ij reaches 1e37 where both densities are 0); zeros
    for parked targets."""
    hubble_a2_flow, fac_mu = params[0], params[1]
    s, inside_grid = _gather_sources(soa16, cells, n, box, periodic,
                                     range(13))
    dx, dy, dz, r, rinv, r2 = _pair_geometry(t, s)
    ht = t[:, 7, :, None]
    hs = s[7][:, None, :]
    inside = (r < torch.maximum(ht, hs)) & (r2 > 0.0) \
        & ((s[12] > 0.0) & inside_grid)[:, None, :]
    dwk_i = kernel_dw_dr(r, ht)
    dwk_j = kernel_dw_dr(r, hs)
    dvx = t[:, 4, :, None] - s[4][:, None, :]
    dvy = t[:, 5, :, None] - s[5][:, None, :]
    dvz = t[:, 6, :, None] - s[6][:, None, :]
    vdotr2 = dvx * dx + dvy * dy + dvz * dz + hubble_a2_flow * (r * r)
    approaching = vdotr2 < 0.0
    mu_ij = fac_mu * vdotr2 * rinv
    zero = torch.zeros_like(mu_ij)
    vsig = t[:, 10, :, None] + s[10][:, None, :] \
        - 3.0 * torch.where(approaching, mu_ij, zero)
    rho_ij = 0.5 * (t[:, 8, :, None] + s[8][:, None, :])
    rs = torch.rsqrt(rho_ij.clamp_min(1e-37))
    f_ij = 0.5 * (t[:, 11, :, None] + s[11][:, None, :])
    visc = torch.where(approaching, 0.5 * visc_const * vsig * (-mu_ij)
                       * (rs * rs) * f_ij, zero)
    m = s[3][:, None, :]
    hfc_visc = 0.5 * m * visc * (dwk_i + dwk_j) * rinv
    hfc = hfc_visc + m * (t[:, 9, :, None] * dwk_i
                          + s[9][:, None, :] * dwk_j) * rinv
    hfc = torch.where(inside, hfc, zero)
    hfc_visc = torch.where(inside, hfc_visc, zero)
    sums = torch.stack([-(hfc * dx).sum(-1), -(hfc * dy).sum(-1),
                        -(hfc * dz).sum(-1),
                        0.5 * (hfc_visc * vdotr2).sum(-1),
                        torch.where(inside, vsig, zero).amax(-1)], 1)
    return torch.where(t[:, 12:13] > 0, sums, torch.zeros_like(sums))


def hydro_sums_cells_plain(soa16, params, n_cells: int, box: float,
                           periodic: bool, visc_const: float) -> torch.Tensor:
    """Plain PyTorch version of kernel K: out [C, 5, cap] = ax, ay, az,
    raw dA/dt, max signal velocity."""
    c, _, cap = soa16.shape
    chunk = _chunk(cap, 40)
    out = torch.empty(c, 5, cap, dtype=soa16.dtype, device=soa16.device)
    for k0 in range(0, c, chunk):
        tc = torch.arange(k0, min(k0 + chunk, c), device=soa16.device)
        out[tc] = _hydro_sums(soa16[tc], soa16, tc, params, n_cells, box,
                              periodic, visc_const)
    return out


def hydro_sums_cells(soa16: torch.Tensor, params: torch.Tensor, n_cells: int,
                     box: float, periodic: bool,
                     visc_const: float) -> torch.Tensor:
    """Kernel K: hydro sums [C, 5, cap] of every live target slot of the
    pack ``soa16`` [C, 16, cap] (:func:`pack_hydro_cells`: rows 0-7 x, y,
    z, m, vx, vy, vz, h; 8-12 rho, P/rho^2 f, c_sound, Balsara, valid)
    over the 27 cells around its own, pairs with 0 < r < max(h_i, h_j);
    ``params`` [2] = (hubble_a2_flow, fac_mu). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check_grid(soa16, 16, n_cells, periodic)
    c, _, cap = soa16.shape
    kernels.check(soa16, "soa16", torch.float32)
    kernels.check(params, "params", torch.float32, (2,), soa16.device)
    kernels.note_call("sph_cells_hydro",
                      (soa16, params, n_cells, box, periodic, visc_const))
    if not kernels.on_cuda(soa16, params):
        return hydro_sums_cells_plain(soa16, params, n_cells, box, periodic,
                                      visc_const)
    out = torch.empty(c, 5, cap, dtype=soa16.dtype, device=soa16.device)
    kernels.launch("sph_cells_hydro", soa16.data_ptr(), params.data_ptr(),
                   out.data_ptr(), n_cells, cap, box, int(periodic),
                   0.5 * visc_const)
    return out


def density_adaptive_cells(pos, vel, mass, hsml0, gas_mask,
                           des_num_ngb: float, max_dev: float, box: float,
                           n_cells: int, capacity: int = 128, min_hsml=0.0,
                           max_hsml=None, periodic: bool = True, origin=0.0,
                           extent=None):
    """Adaptive-h density on kernels I/J over a fresh cell list of
    ``n_cells``^3 cells x ``capacity`` slots on [origin, origin + extent)
    (``extent`` defaults to ``box``). The Newton/bisection loop runs in
    slot space [C * cap]: a sweep moves only the h slots in and the sums
    out, and each sweep after the first skips the cells whose slots have
    all converged. One row gather at the end gives particle space; a
    particle that a full cell dropped comes back with rho = 0 (h and
    dhsml 1). Returns (DensityResult, CellList)."""
    cl = build_cell_list(pos, gas_mask, origin,
                         box if extent is None else extent, n_cells=n_cells,
                         capacity=capacity, periodic=periodic)
    c, cap = cl.cells.shape
    soa = pack_sph_soa(cl, pos, vel, mass, torch.ones_like(mass), gas_mask,
                       box)
    idx, valid = _slot_valid(cl, gas_mask)
    h0_slots = torch.where(valid, hsml0[idx], torch.ones_like(hsml0[idx]))
    all_on = torch.ones(c, dtype=torch.int32, device=pos.device)

    def sweep(h_slots, undone):
        fl = all_on if undone is None else \
            undone.reshape(c, cap).any(dim=1).to(torch.int32)
        out = density_sums_cells(soa, h_slots.reshape(c, cap), fl, n_cells,
                                 box, periodic)
        rot = out[:, 3:6, :].transpose(1, 2).reshape(-1, 3)
        return (out[:, 0].reshape(-1), out[:, 1].reshape(-1),
                out[:, 2].reshape(-1), rot)

    res = density_adaptive_generic(
        sweep, soa[:, 3, :].reshape(-1), h0_slots.reshape(-1),
        valid.reshape(-1), des_num_ngb, max_dev, min_hsml=min_hsml,
        max_hsml=max_hsml)
    slots = density_columns(res)
    slots = torch.cat([slots, slots.new_tensor([DENSITY_FILL])], 0)
    gidx = torch.where(cl.gslot >= 0, cl.gslot,
                       torch.full_like(cl.gslot, c * cap)).long()
    return density_result(slots[gidx], res.iters), cl


def pack_hydro_cells(cl: CellList, pos, vel, mass, hsml, rho, pressure,
                     dhsml_factor, div_vel, curl_vel, gas_mask, fac_mu,
                     box: float) -> torch.Tensor:
    """Kernel K's pack [C, 16, cap]: the rows of ``sph_dense.hydro_table``
    (:func:`_cell_rows`); empty slots parked with valid (row 12) 0."""
    table16 = hydro_table(pos, vel, mass, hsml, rho, pressure, dhsml_factor,
                          div_vel, curl_vel, fac_mu)
    return _cell_rows(cl, table16, gas_mask, box)


def hydro_force_cells(cl: CellList, pos, vel, mass, hsml, rho, pressure,
                      dhsml_factor, div_vel, curl_vel, gas_mask,
                      visc_const: float, box: float, hubble_a2_flow=0.0,
                      hubble_a2_norm=1.0, fac_mu=1.0) -> HydroResult:
    """Entropy-form hydro force on kernel K [G2: hydra.c ::
    hydro_evaluate()]; ``cl`` from :func:`density_adaptive_cells`. The
    comoving factors are 0-d tensors (or floats). Particles in no slot
    get zeros."""
    fac_mu = torch.as_tensor(fac_mu, dtype=pos.dtype, device=pos.device)
    soa16 = pack_hydro_cells(cl, pos, vel, mass, hsml, rho, pressure,
                             dhsml_factor, div_vel, curl_vel, gas_mask,
                             fac_mu, box)
    out = hydro_sums_cells(soa16, hydro_params(hubble_a2_flow, fac_mu),
                           cl.n_cells, box, cl.periodic, visc_const)
    return hydro_result(merge_rows(out, cl, 5), rho, gas_mask,
                        hubble_a2_norm)
