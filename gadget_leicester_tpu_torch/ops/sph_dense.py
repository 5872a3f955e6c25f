"""Adaptive smoothing-length solve [G2: density.c :: density()].

Counterpart of ``gadget_leicester_tpu/ops/sph_dense.py:38-47, 119-244``
(``DensityResult``, ``HydroResult``, ``density_adaptive_generic``). The
all-pairs density and hydro sums of that module (the dense backend) are
not ported: ``sph_backend="dense"`` is refused.

The JAX package runs the Newton/bisection loop as one ``lax.while_loop``
on the device. Here it is a Python loop that reads one host boolean per
iteration (``done.all()``), with the same stopping rule: stop when every
live gas slot has converged or after 40 sweeps. Each sweep after the
first skips the tiles whose slots have all converged.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

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
                             min_hsml: float, max_hsml: float
                             ) -> DensityResult:
    """Newton step on N_eff = (4 pi/3) h^3 rho / m toward DesNumNgb, with
    bisection brackets as fallback, until every live slot converges
    (|N_eff - des| < max_dev) or after ``MAX_ITERS`` sweeps; h stays in
    [min_hsml, max_hsml] (the cap keeps the block stencil complete).
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

    h = hsml0.clamp_min(min_hsml).clamp(max=max_hsml)
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
        h_next = torch.where(both, h_bisect, h_newton).clamp_min(
            min_hsml).clamp(max=max_hsml)
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
