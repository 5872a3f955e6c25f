"""All-pairs SPH density and hydro force, and the adaptive
smoothing-length solve [G2: density.c :: density(), hydra.c ::
hydro_force()].

Counterpart of ``gadget_leicester_tpu/ops/sph_dense.py`` (``DensityResult``,
``HydroResult``, ``density_sums``, ``density_adaptive``,
``density_adaptive_generic``, ``hydro_force``). The all-pairs sums are the
``sph_backend="dense"`` path of small gas counts (the gassphere run) and
the oracle of the cell and block backends: they share no pack, list or
stencil with them. Plain PyTorch, chunked over targets, as they are plain
``jnp`` in the JAX package; no kernel.

The JAX package runs the Newton/bisection loop as one ``lax.while_loop``
on the device. Here it is a Python loop that reads one host boolean per
iteration (``done.all()``), with the same stopping rule: stop when every
live gas slot has converged or after 40 sweeps. Each sweep after the
first may skip the tiles whose slots have all converged.

Also here, shared by the backends: the per-particle hydro table
(:func:`hydro_table`), the (hubble_a2_flow, fac_mu) pair the hydro kernels
read from device memory (:func:`hydro_params`), the dA/dt normalisation
(:func:`hydro_result`) and the slot-to-particle columns of a density
solve (:func:`density_columns`, :data:`DENSITY_FILL`,
:func:`density_result`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gadget_leicester_tpu_torch.core.config import GAMMA, GAMMA_MINUS1
from gadget_leicester_tpu_torch.ops.sph_kernels import (kernel_dw_dr,
                                                        kernel_w_and_dwdh)

NORM_COEFF = 4.0 * math.pi / 3.0  # effective-Ngb normalisation
MAX_ITERS = 40                     # Newton sweeps after the seed sweep


class DensityResult(NamedTuple):
    rho: torch.Tensor
    dhsml_factor: torch.Tensor   # f_i = (1 + h/(3 rho) drho/dh)^-1
    div_vel: torch.Tensor        # velocity divergence (normalised by rho)
    curl_vel: torch.Tensor       # |rot v| / rho
    num_ngb_eff: torch.Tensor    # (4 pi/3) h^3 rho / m
    hsml: torch.Tensor
    iters: int                   # Newton sweeps after the seed sweep


class HydroResult(NamedTuple):
    acc: torch.Tensor            # [Ng, 3]
    dt_entropy: torch.Tensor     # [Ng]
    max_signal_vel: torch.Tensor  # [Ng]


def density_adaptive_generic(sweep, mass, hsml0, gas_mask,
                             des_num_ngb: float, max_dev: float,
                             min_hsml=0.0, max_hsml=None) -> DensityResult:
    """Newton step on N_eff = (4 pi/3) h^3 rho / m toward DesNumNgb, with
    bisection brackets as fallback, until every live slot converges
    (|N_eff - des| < max_dev) or after ``MAX_ITERS`` sweeps; h stays in
    [min_hsml, max_hsml] (the cap keeps a cell or block stencil complete;
    None, the all-pairs sums', is no cap; both may be 0-d tensors).
    ``sweep(h, undone)`` returns (rho, drho_dh, divv_raw, rot_raw);
    ``undone`` (None on the seed sweep) marks the slots still iterating,
    and the sweep may return anything for the others (they keep their
    last accepted sums)."""
    one = torch.ones_like(hsml0)

    def eff_ngb(h, rho):
        m_safe = torch.where(mass > 0, mass, one)
        return NORM_COEFF * h ** 3 * rho / m_safe

    def dh_factor(h, rho, drho_dh):
        rho_safe = torch.where(rho > 0, rho, one)
        fac = 1.0 / (1.0 + h * drho_dh / (3.0 * rho_safe))
        return torch.where((fac > 0.1) & (fac < 10.0), fac, one)

    min_hsml = torch.as_tensor(min_hsml, dtype=hsml0.dtype,
                               device=hsml0.device)
    max_hsml = torch.as_tensor(float("inf") if max_hsml is None else max_hsml,
                               dtype=hsml0.dtype, device=hsml0.device)

    def clip(x):
        return torch.minimum(torch.maximum(x, min_hsml), max_hsml)

    h = clip(hsml0)
    sums = sweep(h, None)
    left = torch.zeros_like(h)
    right = torch.zeros_like(h)
    done = (torch.abs(eff_ngb(h, sums[0]) - des_num_ngb) < max_dev) \
        | ~gas_mask
    it = 0
    while it < MAX_ITERS and not bool(done.all()):
        rho, drho_dh = sums[0], sums[1]
        neff = eff_ngb(h, rho)
        dh_fac = dh_factor(h, rho, drho_dh)
        conv = torch.abs(neff - des_num_ngb) < max_dev
        narrow = (left > 0) & (right > 0) & ((right - left) < 1e-3 * left)
        now_done = conv | narrow | ~gas_mask | done
        low = neff < des_num_ngb
        left_n = torch.where(~now_done & low, torch.maximum(h, left), left)
        right_n = torch.where(
            ~now_done & ~low,
            torch.where(right > 0, torch.minimum(h, right), h), right)
        neff_safe = neff.clamp_min(1e-6)
        fac = 1.0 - (neff - des_num_ngb) / (3.0 * neff_safe) * dh_fac
        fac = fac.clamp(1.0 / 1.26, 1.26)
        h_newton = h * fac
        h_bisect = torch.pow(0.5 * (left_n ** 3 + right_n ** 3), 1.0 / 3.0)
        both = (left_n > 0) & (right_n > 0)
        h_next = clip(torch.where(both, h_bisect, h_newton))
        h = torch.where(now_done, h, h_next)
        raw = sweep(h, ~now_done)
        sums = tuple(torch.where(now_done if o.dim() == 1
                                 else now_done[:, None], o, n)
                     for o, n in zip(sums, raw))
        left, right, done = left_n, right_n, now_done
        it += 1

    rho, drho_dh, divv_raw, rot_raw = sums
    rho_safe = torch.where(rho > 0, rho, one)
    zero = torch.zeros_like(rho)
    return DensityResult(
        rho=torch.where(gas_mask, rho, zero),
        dhsml_factor=torch.where(gas_mask, dh_factor(h, rho, drho_dh), one),
        div_vel=torch.where(gas_mask, divv_raw / rho_safe, zero),
        curl_vel=torch.where(gas_mask, torch.sqrt((rot_raw ** 2).sum(-1))
                             / rho_safe, zero),
        num_ngb_eff=eff_ngb(h, rho),
        hsml=h,
        iters=it,
    )


# a particle that no slot holds: rho 0, dhsml 1, div 0, curl 0, ngb 0, h 1
DENSITY_FILL = (0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def density_columns(res: DensityResult) -> torch.Tensor:
    """[S, 6] per-slot fields in the order of DENSITY_FILL."""
    return torch.stack([res.rho, res.dhsml_factor, res.div_vel, res.curl_vel,
                        res.num_ngb_eff, res.hsml], -1)


def density_result(vals: torch.Tensor, iters: int) -> DensityResult:
    return DensityResult(rho=vals[:, 0], dhsml_factor=vals[:, 1],
                         div_vel=vals[:, 2], curl_vel=vals[:, 3],
                         num_ngb_eff=vals[:, 4], hsml=vals[:, 5], iters=iters)


def hydro_table(pos, vel, mass, hsml, rho, pressure, dhsml_factor, div_vel,
                curl_vel, fac_mu) -> torch.Tensor:
    """[N, 16] rows x, y, z, m, vx, vy, vz, h, rho, P/rho^2 f, c_sound,
    Balsara, valid (1), 0, 0, 0."""
    rho_safe = torch.where(rho > 0, rho, torch.ones_like(rho))
    c_snd = torch.sqrt(GAMMA * pressure / rho_safe)
    p_over_rho2 = pressure / rho_safe ** 2 * dhsml_factor
    h_safe = torch.where(hsml > 0, hsml, torch.ones_like(hsml))
    balsara = div_vel.abs() / (div_vel.abs() + curl_vel
                               + 1e-4 * c_snd / h_safe / fac_mu)
    zero = torch.zeros_like(mass)
    return torch.stack(
        [pos[:, 0], pos[:, 1], pos[:, 2], mass, vel[:, 0], vel[:, 1],
         vel[:, 2], hsml, rho, p_over_rho2, c_snd, balsara,
         torch.ones_like(mass), zero, zero, zero], dim=1)


def hydro_params(hubble_a2_flow, fac_mu: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.as_tensor(hubble_a2_flow, dtype=fac_mu.dtype,
                                        device=fac_mu.device), fac_mu])


def hydro_result(res5, rho, gas_mask, hubble_a2_norm) -> HydroResult:
    """HydroResult from the merged [Ng, 5] sums: dA/dt gets its factor
    (gamma - 1) / (a^2 H rho^(gamma - 1)); non-gas rows are 0."""
    rho_safe = torch.where(rho > 0, rho, torch.ones_like(rho))
    norm = torch.as_tensor(hubble_a2_norm, dtype=rho.dtype, device=rho.device)
    dt_ent = res5[:, 3] * GAMMA_MINUS1 / (norm * rho_safe ** GAMMA_MINUS1)
    zero = torch.zeros_like(rho)
    return HydroResult(
        acc=torch.where(gas_mask[:, None], res5[:, :3],
                        torch.zeros_like(res5[:, :3])),
        dt_entropy=torch.where(gas_mask, dt_ent, zero),
        max_signal_vel=torch.where(gas_mask, res5[:, 4], zero))


def _min_image(dx, box: float):
    return dx - box * torch.round(dx / box)


def density_sums(pos, vel, mass, hsml, gas_mask, box: float = 0.0,
                 block: int = 512, periodic: bool = False):
    """One all-pairs density sweep: (rho, drho/dh, raw div v [Ng], raw
    rot v [Ng, 3]) of every gas slot at its ``hsml``, ``block`` targets
    at a time against all sources; the sums still need their 1/rho."""
    ng = pos.shape[0]
    zero = torch.zeros_like(mass)
    m = torch.where(gas_mask, mass, zero)[None, :]
    out = [], [], [], []
    for i0 in range(0, ng, block):
        tp, tv = pos[i0:i0 + block], vel[i0:i0 + block]
        th = hsml[i0:i0 + block, None]
        dx = tp[:, None, :] - pos[None, :, :]
        if periodic:
            dx = _min_image(dx, box)
        r = torch.sqrt((dx * dx).sum(-1))
        w, dwdh = kernel_w_and_dwdh(r, th)
        dwdr = kernel_dw_dr(r, th)
        dv = tv[:, None, :] - vel[None, :, :]
        rinv = torch.where(r > 0, 1.0 / r.clamp_min(1e-37),
                           torch.zeros_like(r))
        fac = m * dwdr * rinv
        out[0].append((m * w).sum(-1))
        out[1].append((m * dwdh).sum(-1))
        out[2].append(-(fac * (dv * dx).sum(-1)).sum(-1))
        out[3].append((fac[:, :, None]
                       * torch.linalg.cross(dv, dx)).sum(1))
    return tuple(torch.cat(o) for o in out)


def density_adaptive(pos, vel, mass, hsml0, gas_mask, des_num_ngb: float,
                     max_dev: float, min_hsml=0.0, box: float = 0.0,
                     periodic: bool = False,
                     block: int = 512) -> DensityResult:
    """The all-pairs adaptive-h density solve: no cap on h."""

    def sweep(h, undone):
        return density_sums(pos, vel, mass, h, gas_mask, box=box,
                            block=block, periodic=periodic)

    return density_adaptive_generic(sweep, mass, hsml0, gas_mask,
                                    des_num_ngb, max_dev, min_hsml=min_hsml)


def hydro_force(pos, vel, mass, hsml, rho, pressure, dhsml_factor, div_vel,
                curl_vel, gas_mask, visc_const: float, box: float = 0.0,
                periodic: bool = False, block: int = 512,
                hubble_a2_flow=0.0, hubble_a2_norm=1.0,
                fac_mu=1.0) -> HydroResult:
    """All-pairs entropy-form SPH force and entropy rate [G2: hydra.c ::
    hydro_evaluate()], Springel & Hernquist (2002): the pressure terms
    with the grad-h factors, Monaghan-Balsara viscosity from the pairwise
    signal velocity v_sig = c_i + c_j - 3 mu_ij with the Balsara limiter,
    over pairs with 0 < r < max(h_i, h_j). The comoving factors are floats
    or 0-d tensors (0, 1, 1 for a physical run)."""
    ng = pos.shape[0]
    fac_mu = torch.as_tensor(fac_mu, dtype=pos.dtype, device=pos.device)
    tab = hydro_table(pos, vel, mass, hsml, rho, pressure, dhsml_factor,
                      div_vel, curl_vel, fac_mu)
    por, c_snd, bal = tab[:, 9], tab[:, 10], tab[:, 11]
    m = torch.where(gas_mask, mass, torch.zeros_like(mass))[None, :]
    acc, dt_ent, msv = [], [], []
    for i0 in range(0, ng, block):
        sl = slice(i0, i0 + block)
        dx = pos[sl, None, :] - pos[None, :, :]
        if periodic:
            dx = _min_image(dx, box)
        r2 = (dx * dx).sum(-1)
        r = torch.sqrt(r2)
        zero = torch.zeros_like(r)
        inside = (r < torch.maximum(hsml[sl, None], hsml[None, :])) \
            & (r > 0) & gas_mask[None, :]
        rinv = torch.where(r > 0, 1.0 / r.clamp_min(1e-37), zero)
        dwk_i = kernel_dw_dr(r, hsml[sl, None])
        dwk_j = kernel_dw_dr(r, hsml[None, :].expand_as(r))
        dv = vel[sl, None, :] - vel[None, :, :]
        vdotr2 = (dv * dx).sum(-1) + hubble_a2_flow * r2
        approaching = vdotr2 < 0
        mu_ij = fac_mu * vdotr2 * rinv
        vsig = c_snd[sl, None] + c_snd[None, :] \
            - 3.0 * torch.where(approaching, mu_ij, zero)
        rho_ij = 0.5 * (rho[sl, None] + rho[None, :])
        rho_ij = torch.where(rho_ij > 0, rho_ij, torch.ones_like(rho_ij))
        f_ij = 0.5 * (bal[sl, None] + bal[None, :])
        visc = torch.where(approaching, 0.5 * visc_const * vsig * (-mu_ij)
                           / rho_ij * f_ij, zero)
        hfc_visc = 0.5 * m * visc * (dwk_i + dwk_j) * rinv
        hfc = hfc_visc + m * (por[sl, None] * dwk_i
                              + por[None, :] * dwk_j) * rinv
        hfc = torch.where(inside, hfc, zero)
        hfc_visc = torch.where(inside, hfc_visc, zero)
        acc.append(-(hfc[:, :, None] * dx).sum(1))
        dt_ent.append(0.5 * (hfc_visc * vdotr2).sum(-1))
        msv.append(torch.where(inside, vsig, zero).amax(-1))
    res5 = torch.cat([torch.cat(acc), torch.cat(dt_ent)[:, None],
                      torch.cat(msv)[:, None]], dim=1)
    return hydro_result(res5, rho, gas_mask, hubble_a2_norm)
