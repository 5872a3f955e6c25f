"""Block-packed SPH: even/odd block lists, packs, and the wrappers of
kernels C (density) and D (hydro).

Counterpart of ``gadget_leicester_tpu/ops/sph_blocks.py:57-243, 696-913``
(``build_block_lists``, ``block_centers``, ``density_sums_blocks``,
``hydro_sums_blocks``, ``density_adaptive_blocks``,
``hydro_force_blocks``) and of ``ops/pallas_cells.py:1071``
(``pack_sph_soa``).

Particles are binned into fine subcells (2 n_blocks per axis, capacity
``subcap``), packed 2x2x2 into tiles of ``8 subcap`` lanes. The EVEN
packing (block b holds fine cells {2b, 2b+1}) holds targets; the ODD
packing (block w holds {2w-1, 2w}) holds sources, so the source region of
target block b is exactly the odd blocks b + {0,1}^3. Coordinates are
relative to each block's centre and the stencil geometry is a constant
shift of (1 - 2g) Lf per axis (Lf the fine-cell edge), exact for stale
in-margin assignments. The stencil is complete while h <= Lf; the caller
caps h at (1 - 2 kappa) Lf (``models/forces.py``).

Only fully periodic cubic grids are ported (the main path's); vacuum
grids are refused.
"""

from __future__ import annotations

import torch

from gadget_leicester_tpu_torch import kernels
from gadget_leicester_tpu_torch.core.config import GAMMA, GAMMA_MINUS1
from gadget_leicester_tpu_torch.ops.cells import cell_activity_flags
from gadget_leicester_tpu_torch.ops.neighbors import (CellList, merge_rows,
                                                      segment_ranks)
from gadget_leicester_tpu_torch.ops.sph_dense import (DensityResult,
                                                      HydroResult,
                                                      density_adaptive_generic)
from gadget_leicester_tpu_torch.ops.sph_kernels import (kernel_dw_dr,
                                                        kernel_w_and_dwdh)

def build_block_lists(pos, mask, origin: float, extent: float, n_blocks: int,
                      subcap: int):
    """(even, odd) CellLists of a periodic grid whose ``cells`` are
    [B, 8 subcap] tiles, lane = subcell * subcap + rank, subcell order
    z-slowest (sz*4 + sy*2 + sx). One stable sort serves both packings;
    overflow means a fine cell holds more than ``subcap`` particles."""
    n = pos.shape[0]
    dev = pos.device
    m = 2 * n_blocks
    origin_t = torch.full((3,), float(origin), dtype=pos.dtype, device=dev)
    extent_t = torch.full((3,), float(extent), dtype=pos.dtype, device=dev)
    inv_cell = float(m) / extent_t
    coords = torch.remainder(
        torch.floor((pos - origin_t) * inv_cell).to(torch.int32), m)
    cid_f = (coords[:, 0] * m + coords[:, 1]) * m + coords[:, 2]
    total_f = m ** 3
    cid_sort = torch.where(mask, cid_f, torch.full_like(cid_f, total_f))
    cid_sorted, order = torch.sort(cid_sort, stable=True)
    order = order.to(torch.int32)
    rank = segment_ranks(cid_sorted)
    ok = (rank < subcap) & (cid_sorted < total_f)
    c_sorted = coords[order.long()]
    lanes = 8 * subcap
    nb3 = n_blocks ** 3

    def pack(c):
        b = c >> 1
        s = c & 1
        bid = (b[:, 0] * n_blocks + b[:, 1]) * n_blocks + b[:, 2]
        sub = (s[:, 2] * 2 + s[:, 1]) * 2 + s[:, 0]
        return bid, sub * subcap + rank

    counts = torch.zeros(total_f + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, cid_sorted.long(), torch.ones_like(cid_sorted))
    overflow = (counts[:total_f] > subcap).any()

    def mk(c):
        bid, lane = pack(c)
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
                        n_cells=n_blocks)

    # odd packing: fine coords shifted by +1 (block w holds {2w-1, 2w})
    return mk(c_sorted), mk(torch.remainder(c_sorted + 1, m))


def block_centers(nb: int, parity: str, fine_edge: float,
                  origin: torch.Tensor) -> torch.Tensor:
    """[nb^3, 3] centres: even block w spans fine cells {2w, 2w+1}
    (centre (2w+1) Lf), odd block w spans {2w-1, 2w} (centre 2w Lf)."""
    c_arr = torch.arange(nb ** 3, dtype=torch.int32, device=origin.device)
    f = origin.dtype
    xyz = torch.stack([(c_arr // (nb * nb)).to(f), ((c_arr // nb) % nb).to(f),
                       (c_arr % nb).to(f)], -1) * 2.0
    if parity == "even":
        xyz = xyz + 1.0
    return xyz * fine_edge + origin


def pack_sph_soa(cl: CellList, pos, vel, mass, hsml, gas_mask,
                 centers: torch.Tensor, wrap: float) -> torch.Tensor:
    """[B, 8, lanes] rows x, y, z (relative to ``centers``, minimum-imaged
    mod ``wrap``), m, vx, vy, vz, h; invalid slots parked at -7 fine cells
    with m = 0 and h = 1."""
    idx = cl.cells.clamp_min(0).long()
    valid = (cl.cells >= 0) & gas_mask[idx]
    table = torch.stack([pos[:, 0], pos[:, 1], pos[:, 2], mass,
                         vel[:, 0], vel[:, 1], vel[:, 2], hsml], dim=1)
    rows = table[idx]
    rel = rows[:, :, :3] - centers[:, None, :]
    rel = rel - wrap * torch.round(rel / wrap)
    rows = torch.cat([rel, rows[:, :, 3:]], dim=-1)
    park = torch.zeros(8, dtype=rows.dtype, device=rows.device)
    park[:3] = -7.0 / cl.inv_cell[0]
    park[7] = 1.0
    rows = torch.where(valid[:, :, None], rows, park)
    return rows.transpose(1, 2).contiguous()


def odd_sources(nb: int, blocks: torch.Tensor):
    """For even blocks ``blocks`` [K]: the 8 odd source blocks [K, 8]
    (b + {0,1}^3, periodic) and their shifts in units of Lf [8, 3]."""
    g = torch.arange(8, device=blocks.device)
    gxyz = torch.stack([g >> 2, (g >> 1) & 1, g & 1], -1)
    bxyz = torch.stack([blocks // (nb * nb), (blocks // nb) % nb,
                        blocks % nb], -1)
    o = torch.remainder(bxyz[:, None, :] + gxyz[None], nb)
    return (o[..., 0] * nb + o[..., 1]) * nb + o[..., 2], 1 - 2 * gxyz


def _chunk(lanes: int, temporaries: int) -> int:
    """Blocks per step of a plain version: ~1 GB of [K, L, 8L] float32."""
    return max(1, (1 << 30) // (temporaries * 4 * 8 * lanes * lanes))


def _pair_geometry(t, s, shift):
    """dx, dy, dz [K, L, 8L] = (t - s) + shift, r, rinv."""
    d = [(t[:, a, :, None] - s[a][:, None, :]) + shift[a][None, None, :]
         for a in range(3)]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    rinv = torch.rsqrt(r2.clamp_min(1e-37))
    return d[0], d[1], d[2], r2 * rinv, rinv


def _gather_sources(soa_o, src_ids, shift_units, lf, rows):
    """Source rows [K, 8 L] of the 8 odd blocks, and the per-lane shifts."""
    s = soa_o[src_ids]                                   # [K, 8, R, L]
    lanes = s.shape[-1]
    out = [s[:, :, r].flatten(1) for r in rows]
    sh = (shift_units.to(soa_o.dtype) * lf).repeat_interleave(lanes, dim=0)
    return out, [sh[:, a] for a in range(3)]


def density_sums_blocks_plain(soa_e, soa_o, h_slots, flags, nb: int,
                              lf: float):
    """Plain PyTorch version of kernel C: out [B, 6, lanes] = rho,
    drho/dh, raw div v, raw rot v (x, y, z); zeros where flags is 0."""
    b, _, lanes = soa_e.shape
    chunk = _chunk(lanes, 24)
    out = torch.zeros(b, 6, lanes, dtype=soa_e.dtype, device=soa_e.device)
    todo = torch.nonzero(flags > 0).flatten()
    for k0 in range(0, todo.numel(), chunk):
        bc = todo[k0:k0 + chunk]
        t = soa_e[bc]
        ht = h_slots[bc][:, :, None]
        src_ids, units = odd_sources(nb, bc)
        s, shift = _gather_sources(soa_o, src_ids, units, lf,
                                   (0, 1, 2, 3, 4, 5, 6))
        dx, dy, dz, r, rinv = _pair_geometry(t, s, shift)
        w, dwdh = kernel_w_and_dwdh(r, ht)
        dwdr = kernel_dw_dr(r, ht)
        m = s[3][:, None, :]
        fac = m * dwdr * rinv
        dvx = t[:, 4, :, None] - s[4][:, None, :]
        dvy = t[:, 5, :, None] - s[5][:, None, :]
        dvz = t[:, 6, :, None] - s[6][:, None, :]
        vdotr = dvx * dx + dvy * dy + dvz * dz
        out[bc, 0] = (m * w).sum(-1)
        out[bc, 1] = (m * dwdh).sum(-1)
        out[bc, 2] = -(fac * vdotr).sum(-1)
        out[bc, 3] = (fac * (dvy * dz - dvz * dy)).sum(-1)
        out[bc, 4] = (fac * (dvz * dx - dvx * dz)).sum(-1)
        out[bc, 5] = (fac * (dvx * dy - dvy * dx)).sum(-1)
    return out


def density_sums_blocks(soa_e: torch.Tensor, soa_o: torch.Tensor,
                        h_slots: torch.Tensor, flags: torch.Tensor, nb: int,
                        lf: float) -> torch.Tensor:
    """Kernel C: density sums [B, 6, lanes] of the even-block targets over
    their 8 odd source blocks. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    b, rows, lanes = soa_e.shape
    if b != nb ** 3 or rows != 8:
        raise ValueError(f"soa_e shape {tuple(soa_e.shape)} does not match "
                         f"{nb}^3 blocks of 8 rows")
    kernels.check(soa_e, "soa_e", torch.float32)
    kernels.check(soa_o, "soa_o", torch.float32, (b, 8, lanes), soa_e.device)
    kernels.check(h_slots, "h_slots", torch.float32, (b, lanes), soa_e.device)
    kernels.check(flags, "flags", torch.int32, (b,), soa_e.device)
    kernels.note_call("sph_density", (soa_e, soa_o, h_slots, flags, nb, lf))
    if not kernels.on_cuda(soa_e, soa_o, h_slots, flags):
        return density_sums_blocks_plain(soa_e, soa_o, h_slots, flags, nb, lf)
    out = torch.empty(b, 6, lanes, dtype=soa_e.dtype, device=soa_e.device)
    kernels.launch("sph_density", soa_e.data_ptr(), soa_o.data_ptr(),
                   h_slots.data_ptr(), flags.data_ptr(), out.data_ptr(), nb,
                   lanes, lf)
    return out


def hydro_sums_blocks_plain(soa_a, soa_b, src16, idx_e, idx_o, flags,
                            params, nb: int, lf: float, visc_const: float):
    """Plain PyTorch version of kernel D: out [B, 5, lanes] = ax, ay, az,
    raw dA/dt, max signal velocity; zeros where flags is 0."""
    b, _, lanes = soa_a.shape
    chunk = _chunk(lanes, 40)
    hubble_a2_flow, fac_mu = params[0], params[1]
    out = torch.zeros(b, 5, lanes, dtype=soa_a.dtype, device=soa_a.device)
    todo = torch.nonzero(flags > 0).flatten()
    for k0 in range(0, todo.numel(), chunk):
        bc = todo[k0:k0 + chunk]
        ta, tb = soa_a[bc], soa_b[bc]
        src_ids, units = odd_sources(nb, bc)
        s, shift = _gather_sources(src16, src_ids, units, lf, range(13))
        sid = idx_o[src_ids].flatten(1)
        dx, dy, dz, r, rinv = _pair_geometry(ta, s, shift)
        ht = ta[:, 7, :, None]
        hs = s[7][:, None, :]
        inside = (r < torch.maximum(ht, hs)) \
            & (idx_e[bc][:, :, None] != sid[:, None, :]) \
            & (s[12][:, None, :] > 0.0)
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
        out[bc, 0] = -(hfc * dx).sum(-1)
        out[bc, 1] = -(hfc * dy).sum(-1)
        out[bc, 2] = -(hfc * dz).sum(-1)
        out[bc, 3] = 0.5 * (hfc_visc * vdotr2).sum(-1)
        out[bc, 4] = torch.where(inside, vsig, zero).amax(-1)
    return out


def hydro_sums_blocks(soa_a: torch.Tensor, soa_b: torch.Tensor,
                      src16: torch.Tensor, idx_e: torch.Tensor,
                      idx_o: torch.Tensor, flags: torch.Tensor,
                      params: torch.Tensor, nb: int, lf: float,
                      visc_const: float) -> torch.Tensor:
    """Kernel D: hydro sums [B, 5, lanes]. ``idx_e``/``idx_o`` [B, lanes]
    int32 particle indices (-1 for empty slots) exclude the self-pair;
    ``params`` [2] = (hubble_a2_flow, fac_mu). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    b, rows, lanes = soa_a.shape
    if b != nb ** 3 or rows != 8:
        raise ValueError(f"soa_a shape {tuple(soa_a.shape)} does not match "
                         f"{nb}^3 blocks of 8 rows")
    dev = soa_a.device
    kernels.check(soa_a, "soa_a", torch.float32)
    kernels.check(soa_b, "soa_b", torch.float32, (b, 8, lanes), dev)
    kernels.check(src16, "src16", torch.float32, (b, 16, lanes), dev)
    kernels.check(idx_e, "idx_e", torch.int32, (b, lanes), dev)
    kernels.check(idx_o, "idx_o", torch.int32, (b, lanes), dev)
    kernels.check(flags, "flags", torch.int32, (b,), dev)
    kernels.check(params, "params", torch.float32, (2,), dev)
    kernels.note_call("sph_hydro", (soa_a, soa_b, src16, idx_e, idx_o, flags,
                                    params, nb, lf, visc_const))
    if not kernels.on_cuda(soa_a, soa_b, src16, idx_e, idx_o, flags, params):
        return hydro_sums_blocks_plain(soa_a, soa_b, src16, idx_e, idx_o,
                                       flags, params, nb, lf, visc_const)
    out = torch.empty(b, 5, lanes, dtype=soa_a.dtype, device=dev)
    kernels.launch("sph_hydro", soa_a.data_ptr(), soa_b.data_ptr(),
                   src16.data_ptr(), idx_e.data_ptr(), idx_o.data_ptr(),
                   flags.data_ptr(), params.data_ptr(), out.data_ptr(), nb,
                   lanes, lf, 0.5 * visc_const)
    return out


def _block_flags(cl_e: CellList, active, gas_mask):
    if active is None:
        return torch.ones(cl_e.cells.shape[0], dtype=torch.int32,
                          device=cl_e.cells.device)
    return cell_activity_flags(cl_e, active & gas_mask)


def density_adaptive_blocks(pos, vel, mass, hsml0, gas_mask,
                            des_num_ngb: float, max_dev: float, box: float,
                            cls, max_hsml: float, min_hsml: float = 0.0,
                            active=None):
    """Adaptive-h density on kernel C over the cached (even, odd) lists
    ``cls``. ``active`` (None = all): only active targets are solved and
    tiles without one are skipped. Returns (DensityResult, cls)."""
    cl_e, cl_o = cls
    nb = cl_e.n_cells
    b, lanes = cl_e.cells.shape
    lf = box / (2 * nb)
    flags = _block_flags(cl_e, active, gas_mask)
    ones = torch.ones_like(mass)
    soa_e = pack_sph_soa(cl_e, pos, vel, mass, ones, gas_mask,
                         block_centers(nb, "even", lf, cl_e.origin), box)
    soa_o = pack_sph_soa(cl_o, pos, vel, mass, ones, gas_mask,
                         block_centers(nb, "odd", lf, cl_o.origin), box)
    idx = cl_e.cells.clamp_min(0).long()
    valid = (cl_e.cells >= 0) & gas_mask[idx]
    if active is not None:
        valid = valid & active[idx]
    mass_slots = soa_e[:, 3, :].reshape(-1)
    mask_slots = valid.reshape(-1)
    h0_slots = torch.where(valid, hsml0[idx],
                           torch.ones_like(hsml0[idx])).reshape(-1)

    def sweep(h_slots, undone):
        fl = flags if undone is None else \
            undone.reshape(b, lanes).any(dim=1).to(torch.int32)
        out = density_sums_blocks(soa_e, soa_o, h_slots.reshape(b, lanes),
                                  fl, nb, lf)
        rot = out[:, 3:6, :].transpose(1, 2).reshape(-1, 3)
        return (out[:, 0].reshape(-1), out[:, 1].reshape(-1),
                out[:, 2].reshape(-1), rot)

    res = density_adaptive_generic(
        sweep, mass_slots, h0_slots, mask_slots, des_num_ngb, max_dev,
        min_hsml=min_hsml, max_hsml=max_hsml)

    # one row gather over the inverse slot map; dropped/dead particles
    # take the fill row (rho 0, dhsml 1, ..., h 1)
    slots = torch.stack([res.rho, res.dhsml_factor, res.div_vel,
                         res.curl_vel, res.num_ngb_eff, res.hsml], -1)
    fills = torch.tensor([[0.0, 1.0, 0.0, 0.0, 0.0, 1.0]],
                         dtype=slots.dtype, device=slots.device)
    slots = torch.cat([slots, fills], 0)
    gidx = torch.where(cl_e.gslot >= 0, cl_e.gslot,
                       torch.full_like(cl_e.gslot, b * lanes)).long()
    vals = slots[gidx]
    return DensityResult(rho=vals[:, 0], dhsml_factor=vals[:, 1],
                         div_vel=vals[:, 2], curl_vel=vals[:, 3],
                         num_ngb_eff=vals[:, 4], hsml=vals[:, 5],
                         iters=res.iters), cls


def pack_hydro_blocks(cls, pos, vel, mass, hsml, rho, pressure,
                      dhsml_factor, div_vel, curl_vel, gas_mask, box: float,
                      hubble_a2_flow, fac_mu, active=None):
    """Kernel D's inputs: (soa_a, soa_b, src16, idx_e, idx_o, flags,
    params) from the particle fields, as one [N, 16]-row gather per list.
    Rows: x, y, z (block-relative), m, vx, vy, vz, h, rho, P/rho^2 f,
    c_sound, Balsara, valid; row 13 stays 0 (the self-pair is excluded by
    the int32 ``idx`` arrays instead)."""
    cl_e, cl_o = cls
    nb = cl_e.n_cells
    lf = box / (2 * nb)
    dev, f = pos.device, pos.dtype
    fac_mu = torch.as_tensor(fac_mu, dtype=f, device=dev)
    rho_safe = torch.where(rho > 0, rho, torch.ones_like(rho))
    c_snd = torch.sqrt(GAMMA * pressure / rho_safe)
    p_over_rho2 = pressure / rho_safe ** 2 * dhsml_factor
    h_safe = torch.where(hsml > 0, hsml, torch.ones_like(hsml))
    balsara = div_vel.abs() / (div_vel.abs() + curl_vel
                               + 1e-4 * c_snd / h_safe / fac_mu)
    zero = torch.zeros_like(mass)
    table16 = torch.stack(
        [pos[:, 0], pos[:, 1], pos[:, 2], mass, vel[:, 0], vel[:, 1],
         vel[:, 2], hsml, rho, p_over_rho2, c_snd, balsara,
         torch.ones_like(mass), zero, zero, zero], dim=1)
    park16 = torch.zeros(16, dtype=f, device=dev)
    park16[:3] = -7.0 / cl_e.inv_cell[0]
    park16[7] = 1.0

    def pack16(cl, centers):
        idx = cl.cells.clamp_min(0).long()
        valid = (cl.cells >= 0) & gas_mask[idx]
        rows = table16[idx]
        rel = rows[:, :, :3] - centers[:, None, :]
        rel = rel - box * torch.round(rel * (1.0 / box))
        rows = torch.cat([rel, rows[:, :, 3:]], dim=-1)
        rows = torch.where(valid[:, :, None], rows, park16)
        ids = torch.where(valid, cl.cells, torch.full_like(cl.cells, -1))
        return rows.transpose(1, 2).contiguous(), ids.contiguous()

    rows_e, idx_e = pack16(cl_e, block_centers(nb, "even", lf, cl_e.origin))
    src16, idx_o = pack16(cl_o, block_centers(nb, "odd", lf, cl_o.origin))
    params = torch.stack([torch.as_tensor(hubble_a2_flow, dtype=f,
                                          device=dev), fac_mu])
    return (rows_e[:, :8].contiguous(), rows_e[:, 8:].contiguous(), src16,
            idx_e, idx_o, _block_flags(cl_e, active, gas_mask), params)


def hydro_force_blocks(cls, pos, vel, mass, hsml, rho, pressure,
                       dhsml_factor, div_vel, curl_vel, gas_mask,
                       visc_const: float, box: float, hubble_a2_flow,
                       hubble_a2_norm, fac_mu, active=None) -> HydroResult:
    """Entropy-form hydro force on kernel D [G2: hydra.c ::
    hydro_evaluate()]; ``cls`` = (even, odd) lists from the density
    pass. The comoving factors are 0-d tensors (or floats)."""
    cl_e = cls[0]
    packs = pack_hydro_blocks(cls, pos, vel, mass, hsml, rho, pressure,
                              dhsml_factor, div_vel, curl_vel, gas_mask, box,
                              hubble_a2_flow, fac_mu, active)
    out = hydro_sums_blocks(*packs, cl_e.n_cells, box / (2 * cl_e.n_cells),
                            visc_const)
    res5 = merge_rows(out, cl_e, 5)
    rho_safe = torch.where(rho > 0, rho, torch.ones_like(rho))
    norm = torch.as_tensor(hubble_a2_norm, dtype=rho.dtype, device=rho.device)
    dt_ent = res5[:, 3] * GAMMA_MINUS1 / (norm * rho_safe ** GAMMA_MINUS1)
    zero = torch.zeros_like(rho)
    return HydroResult(
        acc=torch.where(gas_mask[:, None], res5[:, :3],
                        torch.zeros_like(res5[:, :3])),
        dt_entropy=torch.where(gas_mask, dt_ent, zero),
        max_signal_vel=torch.where(gas_mask, res5[:, 4], zero))
