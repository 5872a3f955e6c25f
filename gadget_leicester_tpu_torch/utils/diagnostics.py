"""Energy and conservation diagnostics [G2: global.c ::
compute_global_quantities_of_system() / energy_statistics()], written to
``energy.txt``.

Counterpart of ``gadget_leicester_tpu/utils/diagnostics.py:26-143``
(``EnergyStats``, ``energy_statistics``, ``format_energy_line``,
``LayzerIrvineTracker``). Energies are taken at the current sync time with
velocities closed to it (each particle's half-kick from its step midpoint,
the PM kick from the PM midpoint), as the JAX package does. The tracker is
plain Python, the same as the JAX package's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gadget_leicester_tpu_torch.core import cosmology
from gadget_leicester_tpu_torch.core.config import (GAMMA_MINUS1, SimConfig,
                                                    SimOptions)
from gadget_leicester_tpu_torch.core.state import SimState
from gadget_leicester_tpu_torch.models.forces import comoving_factors
from gadget_leicester_tpu_torch.models.integrate import _midpoint_ti


class EnergyStats(NamedTuple):
    kinetic: torch.Tensor
    internal: torch.Tensor
    potential: torch.Tensor
    total: torch.Tensor
    momentum: torch.Tensor        # [3]
    ang_mom: torch.Tensor         # [3]
    mass: torch.Tensor
    kinetic_comp: torch.Tensor    # [6] per particle type
    internal_comp: torch.Tensor   # [6]
    potential_comp: torch.Tensor  # [6]
    mass_comp: torch.Tensor       # [6]


def _by_type(x, seg) -> torch.Tensor:
    """[6] sums of ``x`` per particle type (dead particles carry 6): one
    masked reduction per type, where a scatter into 7 bins would
    serialise millions of atomic adds on the card and sum in a different
    order on every run."""
    zero = torch.zeros_like(x)
    return torch.stack([torch.where(seg == t, x, zero).sum()
                        for t in range(6)])


def energy_statistics(state: SimState, cfg: SimConfig,
                      opts: SimOptions) -> EnergyStats:
    p, gas = state.p, state.gas
    ng = gas.n_gas_max
    m = torch.where(p.alive, p.mass, torch.zeros_like(p.mass))

    mid = _midpoint_ti(p.ti_begstep, p.ti_endstep)
    dt_gk = cosmology.gravkick_factor(cfg, mid, state.ti_current)
    dt_hk = cosmology.hydrokick_factor(cfg, mid, state.ti_current)
    pm_mid = _midpoint_ti(state.pm_ti_begstep, state.pm_ti_endstep)
    dt_gk_pm = cosmology.gravkick_factor(cfg, pm_mid, state.ti_current)
    hyd = torch.zeros_like(p.acc)
    hyd[:ng] = gas.hydro_acc
    vel_sync = (p.vel + p.acc * dt_gk[:, None] + p.acc_pm * dt_gk_pm
                + hyd * dt_hk[:, None])

    ke_i = 0.5 * m * (vel_sync ** 2).sum(-1)
    pe_i = 0.5 * m * p.pot
    gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
    rho_safe = torch.where(gas.density > 0, gas.density,
                           torch.ones_like(gas.density))
    dt_entr = (state.ti_current - p.ti_begstep[:ng]).to(gas.entropy.dtype) \
        * cfg.timebase_interval
    a_now = gas.entropy + gas.dt_entropy * dt_entr
    if opts.isotherm_eqs:
        u = a_now / GAMMA_MINUS1
    else:
        # entropy -> u with the PHYSICAL density [G2: global.c]
        a3inv = comoving_factors(cfg, state.ti_current).a3inv
        u = a_now * (rho_safe * a3inv) ** GAMMA_MINUS1 / GAMMA_MINUS1
    ie_i = torch.zeros_like(m)
    ie_i[:ng] = torch.where(gas_mask, m[:ng] * u, torch.zeros_like(u))
    ke, pe, ie = ke_i.sum(), pe_i.sum(), ie_i.sum()

    seg = torch.where(p.alive, p.ptype, torch.full_like(p.ptype, 6)).long()
    return EnergyStats(
        kinetic=ke, internal=ie, potential=pe, total=ke + ie + pe,
        momentum=(m[:, None] * vel_sync).sum(0),
        ang_mom=(m[:, None] * torch.linalg.cross(p.pos, vel_sync)).sum(0),
        mass=m.sum(), kinetic_comp=_by_type(ke_i, seg),
        internal_comp=_by_type(ie_i, seg),
        potential_comp=_by_type(pe_i, seg), mass_comp=_by_type(m, seg))


def format_energy_line(time: float, st: EnergyStats) -> str:
    """One energy.txt-style line: time, Etot, Eint, Epot, Ekin."""
    return (
        f"{time:.8g} {float(st.total):.8g} {float(st.internal):.8g} "
        f"{float(st.potential):.8g} {float(st.kinetic):.8g}"
    )


class LayzerIrvineTracker:
    """Cosmic energy (Layzer-Irvine) conservation for comoving runs
    (Springel 2005 §5). With internal velocities vel = a^2 dx/dt and the
    comoving potential p.pot, the peculiar energies are

        T = 0.5 sum m (vel/a)^2      (kinetic)
        W = 0.5 sum m phi_c / a      (potential)
        U = sum m u_phys             (thermal)

    and the cosmic energy equation d(T+W+U)/dln a = -(2T + W + 2U) makes
    E_LI = T + W + U + INT (2T + W + 2U) dln a a conserved quantity.
    ``update(a, stats)`` accumulates the integral by the trapezoid rule
    and returns the drift |E_LI - E_LI(a0)| / |W|; BASELINE.json's gate is
    a drift below 1e-3."""

    def __init__(self):
        self._prev = None          # (ln a, integrand)
        self._integral = 0.0
        self._e0 = None

    def update(self, a: float, stats: EnergyStats) -> float:
        a = float(a)
        t = float(stats.kinetic) / a ** 2
        w = float(stats.potential) / a
        u = float(stats.internal)
        integrand = 2.0 * t + w + 2.0 * u
        lna = math.log(a)
        if self._prev is not None:
            lna0, i0 = self._prev
            self._integral += 0.5 * (integrand + i0) * (lna - lna0)
        self._prev = (lna, integrand)
        e = t + w + u + self._integral
        if self._e0 is None:
            self._e0 = e
        wnorm = max(abs(w), 1e-30)
        return abs(e - self._e0) / wnorm
