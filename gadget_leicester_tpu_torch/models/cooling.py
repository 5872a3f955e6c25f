"""Radiative cooling of the Leicester fork: Gammie beta cooling and the
Stamatellos et al. (2007) pseudo-cloud radiative rate.

Counterpart of ``gadget_leicester_tpu/models/cooling.py`` (``_BELL_LIN``
:57, ``bell_lin_opacity`` :71, ``_sink_potential_correction`` :98,
``apply_cooling`` :114). Pointwise per gas particle, plain PyTorch (the
JAX package has no kernel here either); the rate is folded into
``dt_entropy``, so the entropy kick of the step integrates it.

beta cooling: dA/dt = -A Omega / beta, Omega the Keplerian frequency
about the first registered sink (else the origin with the total non-gas
mass). Stamatellos: du/dt = 4 sigma_SB (T_bg^4 - T^4) / (Sigma^2 kappa +
1/kappa) with Sigma^2 = zeta rho |psi| / (4 pi G), psi the gas's own
potential (p.pot less the registered sinks' point masses) and kappa the
Bell & Lin (1994) opacity.

Two departures from the reference, both recorded in ROADMAP queue 3:
the sinks' point-mass term takes the minimum image in a periodic box
(:func:`models.sinks.min_image`; the reference's ``cooling.py:108`` takes
none), and, as in the reference, the Stamatellos rate reads the comoving
density without ``a3inv`` (its own comment at ``cooling.py:139-140``).
The point-mass term is summed over the used sink slots only, so its
memory is [used slots, gas] and not [64, gas]; the result is the same.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gadget_leicester_tpu_torch.core.config import (BOLTZMANN_CGS,
                                                    GAMMA_MINUS1,
                                                    HYDROGEN_MASSFRAC,
                                                    PROTONMASS_CGS, SimConfig,
                                                    SimOptions)
from gadget_leicester_tpu_torch.core.state import SimState
from gadget_leicester_tpu_torch.models.sinks import (dot3, min_image,
                                                     used_slots)

SIGMA_SB_CGS = 5.6704e-5   # erg cm^-2 s^-1 K^-4
MEAN_MOL_NEUTRAL = 4.0 / (1.0 + 3.0 * HYDROGEN_MASSFRAC)

# Bell & Lin (1994) opacity regimes, kappa = k0 rho^a T^b [cgs], in order:
# regime n hands over to n + 1 at the crossing temperature
# T_{n,n+1}(rho) = (k0_n rho^a_n / (k0_{n+1} rho^a_{n+1}))^(1 / (b_{n+1} - b_n))
BELL_LIN = (
    (2.0e-4, 0.0, 2.0),           # ice grains
    (2.0e16, 0.0, -7.0),          # ice evaporation
    (0.1, 0.0, 0.5),              # metal/dust grains
    (2.0e81, 1.0, -24.0),         # dust evaporation
    (1.0e-8, 2.0 / 3.0, 3.0),     # molecules
    (1.0e-36, 1.0 / 3.0, 10.0),   # H- scattering
    (1.5e20, 1.0, -2.5),          # bound-free / free-free
    (0.348, 0.0, 0.0),            # electron scattering
)


def bell_lin_opacity(rho_cgs: torch.Tensor, temp_k: torch.Tensor):
    """Rosseland-mean opacity [cm^2/g] of Bell & Lin (1994), the regime
    chosen by the density-dependent crossing temperatures. The selection
    runs in log space with Python-float log(k0): k0 spans 1e-36 to 2e81,
    beyond float32, so k0 rho^a T^b or a float32 log(k0) would overflow
    and corrupt the choice."""
    logr = torch.log(torch.clamp(rho_cgs, min=1e-30))
    logt = torch.log(torch.clamp(temp_k, min=1.0))
    logk0 = [math.log(k0) for k0, _, _ in BELL_LIN]
    log_kappas = [logk0[i] + a * logr + b * logt
                  for i, (_, a, b) in enumerate(BELL_LIN)]
    out_log = log_kappas[-1]
    for i in range(len(BELL_LIN) - 2, -1, -1):
        _, aa, ba = BELL_LIN[i]
        _, ab, bb = BELL_LIN[i + 1]
        log_tcross = (logk0[i] - logk0[i + 1] + (aa - ab) * logr) / (bb - ba)
        out_log = torch.where(logt < log_tcross, log_kappas[i], out_log)
    # the physical range is ~1e-8 to 1e10 cm^2/g
    return torch.exp(torch.clamp(out_log, -60.0, 60.0))


def sink_potential_correction(state: SimState, cfg: SimConfig,
                              opts: SimOptions, ng: int,
                              sink_points=None) -> torch.Tensor:
    """[ng]: -G sum_s M_s / |x - x_s| over the registered sinks, the
    point-mass part of the potential, to be taken out of psi so that the
    column estimate sees the gas cloud's own gravity [Stamatellos 2007].
    ``sink_points`` (pos [U, 3], mass [U]), the used slots' sinks in slot
    order, where they are not rows of ``state`` (the slab step, whose
    registry holds PIDs: ``parallel/spmd.py :: SpmdStep.ring_sinks``);
    None: the registry's rows."""
    p = state.p
    out = torch.zeros(ng, dtype=p.pos.dtype, device=p.pos.device)
    if sink_points is None:
        idx = used_slots(state.sinks.slot)
        if idx.numel() == 0:
            return out
        s_pos, s_mass = p.pos[idx], p.mass[idx]
    else:
        s_pos, s_mass = sink_points
    dx = min_image(p.pos[None, :ng, :] - s_pos[:, None, :], cfg, opts)
    r = torch.clamp(torch.sqrt(dot3(dx, dx)), min=1e-20)
    return out - cfg.grav_internal * (s_mass[:, None] / r).sum(0)


def apply_cooling(state: SimState, cfg: SimConfig, opts: SimOptions,
                  sink_points=None) -> SimState:
    """Add the cooling rate of ``opts.cooling`` to the gas's dt_entropy
    (0 where not gas). ``sink_points``: the registered sinks as
    :func:`sink_potential_correction` takes them (the slab step's, for
    Stamatellos; beta cooling reads the registry's rows)."""
    gas, p = state.gas, state.p
    ng = gas.n_gas_max
    gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
    if opts.cooling == "beta":
        # the central object: the first registered sink, else the origin
        # with the total non-gas mass
        slot0 = state.sinks.slot[0]
        has_sink = slot0 >= 0
        idx = slot0.clamp_min(0).long()
        center = torch.where(has_sink, p.pos[idx], torch.zeros_like(p.pos[0]))
        m_other = torch.where(p.alive & (p.ptype != 0), p.mass,
                              torch.zeros_like(p.mass)).sum()
        m_central = torch.where(has_sink, p.mass[idx], m_other)
        dx = p.pos[:ng] - center[None, :]
        r = torch.clamp(torch.sqrt(dot3(dx, dx)), min=1e-10)
        omega = torch.sqrt(cfg.grav_internal
                           * torch.clamp(m_central, min=1e-30) / r ** 3)
        dcool = -gas.entropy_pred * omega / cfg.cooling_beta
    elif opts.cooling == "stamatellos":
        rho = torch.clamp(gas.density, min=1e-30)
        # temperature from the entropy function A: u = A rho^(g-1) / (g-1)
        u_int = gas.entropy_pred * rho ** GAMMA_MINUS1 / GAMMA_MINUS1
        u_cgs = u_int * cfg.unit_velocity_in_cm_per_s ** 2
        temp = torch.clamp(GAMMA_MINUS1 * MEAN_MOL_NEUTRAL * PROTONMASS_CGS
                           / BOLTZMANN_CGS * u_cgs, min=1.0)
        rho_cgs = rho * cfg.unit_density_in_cgs
        # the gas's own potential: the registered sinks' term taken out
        psi = p.pot[:ng] - sink_potential_correction(state, cfg, opts, ng,
                                                     sink_points)
        psi_mag = torch.clamp(-psi, min=0.0)
        sigma2_int = (cfg.cooling_column_fac * rho * psi_mag
                      / (4.0 * math.pi * cfg.grav_internal))
        sigma2_cgs = sigma2_int * (cfg.unit_mass_in_g
                                   / cfg.unit_length_in_cm ** 2) ** 2
        # at least the particle's own smoothing-length column
        sigma_self = rho_cgs * torch.clamp(gas.hsml, min=1e-30) \
            * cfg.unit_length_in_cm
        sigma2_cgs = torch.maximum(sigma2_cgs, sigma_self ** 2)
        kappa = bell_lin_opacity(rho_cgs, temp)
        tbg4 = torch.tensor(cfg.cooling_tbg, dtype=temp.dtype,
                            device=temp.device) ** 4
        dudt_cgs = (4.0 * SIGMA_SB_CGS * (tbg4 - temp ** 4)
                    / (sigma2_cgs * kappa + 1.0 / kappa))
        dudt_int = dudt_cgs / (cfg.unit_velocity_in_cm_per_s ** 2
                               / cfg.unit_time_in_s)
        dcool = GAMMA_MINUS1 * dudt_int / rho ** GAMMA_MINUS1
    else:
        return state
    dcool = torch.where(gas_mask, dcool, torch.zeros_like(dcool))
    return dataclasses.replace(state, gas=dataclasses.replace(
        gas, dt_entropy=gas.dt_entropy + dcool))
