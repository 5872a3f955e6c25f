"""KDK leapfrog with individual power-of-two block timesteps.

Counterpart of ``gadget_leicester_tpu/models/integrate.py``
(``drift_all``, ``get_timesteps``, ``advance_and_find_timesteps``,
``pm_step_update``): rebuild of [G2: predict.c :: move_particles()] and
[G2: timestep.c :: advance_and_find_timesteps()/get_timestep()] as masked
full-width tensor updates. Only ACTIVE particles (ti_endstep ==
ti_current) receive kicks and new timesteps. ``p.vel`` holds the velocity
at the midpoint of each particle's current step; ``gas.vel_pred`` is
extrapolated to the sync time for the SPH pair terms.

Functions return new dataclasses; tensors they do not change are shared
with the input state.
"""

from __future__ import annotations

import dataclasses

import torch

from gadget_leicester_tpu_torch.core import cosmology, timeline
from gadget_leicester_tpu_torch.core.config import (BOLTZMANN_CGS, GAMMA,
                                                    GAMMA_MINUS1,
                                                    HYDROGEN_MASSFRAC,
                                                    PROTONMASS_CGS, TIMEBASE,
                                                    SimConfig, SimOptions)
from gadget_leicester_tpu_torch.core.state import SimState
from gadget_leicester_tpu_torch.models.forces import (comoving_factors,
                                                      softening_table)
from gadget_leicester_tpu_torch.models.grids import note_drift


def _midpoint_ti(ti_beg, ti_end):
    """Tick of a particle's last half-kick: the midpoint of its step."""
    return ti_beg + torch.div(ti_end - ti_beg, 2, rounding_mode="floor")


def drift_all(state: SimState, cfg: SimConfig, opts: SimOptions,
              ti_next: torch.Tensor) -> SimState:
    """Drift all particles from ti_current to ti_next and forecast the
    SPH fields [G2: predict.c drift_particle()]."""
    p, gas = state.p, state.gas
    dt_drift = cosmology.drift_factor(cfg, state.ti_current, ti_next)
    dx = p.vel * dt_drift
    pos = p.pos + dx
    if opts.periodic and cfg.box_size > 0:
        pos = torch.remainder(pos, cfg.box_size)
    pos = torch.where(p.alive[:, None], pos, p.pos)
    p = dataclasses.replace(p, pos=pos)
    grids = state.grids
    if grids is not None:
        step_max = torch.where(p.alive, dx.abs().amax(dim=-1),
                               torch.zeros_like(p.mass)).max()
        grids = note_drift(grids, step_max)

    ng = gas.n_gas_max
    mid = _midpoint_ti(p.ti_begstep[:ng], p.ti_endstep[:ng])
    dt_gk = cosmology.gravkick_factor(cfg, mid, ti_next)
    dt_hk = cosmology.hydrokick_factor(cfg, mid, ti_next)
    pm_mid = _midpoint_ti(state.pm_ti_begstep, state.pm_ti_endstep)
    dt_gk_pm = cosmology.gravkick_factor(cfg, pm_mid, ti_next)
    vel_pred = (p.vel[:ng] + p.acc[:ng] * dt_gk[:, None]
                + p.acc_pm[:ng] * dt_gk_pm + gas.hydro_acc * dt_hk[:, None])
    # entropy is defined at step starts, so its forecast runs from there
    dt_entr = (ti_next - p.ti_begstep[:ng]).to(gas.entropy.dtype) \
        * cfg.timebase_interval
    entropy_pred = torch.maximum(gas.entropy + gas.dt_entropy * dt_entr,
                                 0.5 * gas.entropy)
    rho = gas.density * torch.exp(-gas.div_vel * dt_drift)
    hsml = (gas.hsml * torch.exp(gas.div_vel / 3.0 * dt_drift)
            ).clamp_min(1e-30)
    if opts.isotherm_eqs:
        pressure = entropy_pred * rho
    else:
        pressure = entropy_pred * rho ** GAMMA
    gas = dataclasses.replace(gas, vel_pred=vel_pred,
                              entropy_pred=entropy_pred, density=rho,
                              hsml=hsml, pressure=pressure)
    return dataclasses.replace(state, p=p, gas=gas, grids=grids,
                               ti_current=ti_next.to(torch.int32))


def get_timesteps(state: SimState, cfg: SimConfig,
                  opts: SimOptions) -> torch.Tensor:
    """Per-particle timestep in timeline units (dloga comoving), not yet
    quantized [G2: timestep.c :: get_timestep(), criterion 0]."""
    p, gas = state.p, state.gas
    ng = gas.n_gas_max
    fac = comoving_factors(cfg, state.ti_current)
    if cfg.comoving_integration_on:
        fac1 = 1.0 / (fac.atime * fac.atime)
        fac2 = 1.0 / fac.atime ** (3.0 * GAMMA - 2.0)
        fac3 = fac.atime ** (3.0 * (1.0 - GAMMA) / 2.0)
        hubble_a = fac.hubble_a
    else:
        fac1 = fac2 = fac3 = hubble_a = 1.0
    acc_vec = (p.acc + p.acc_pm) * fac1
    hyd = torch.zeros_like(p.acc)
    hyd[:ng] = gas.hydro_acc * fac2
    is_gas = p.ptype == 0
    acc_vec = acc_vec + torch.where(is_gas[:, None], hyd,
                                    torch.zeros_like(hyd))
    ac = torch.sqrt((acc_vec * acc_vec).sum(-1)).clamp_min(1e-30)
    eps = softening_table(cfg, fac.atime)[p.ptype.long()]
    dt = torch.sqrt(2.0 * cfg.err_tol_int_accuracy * fac.atime * eps / ac)
    msv = gas.max_signal_vel.clamp_min(1e-30)
    dt_courant = 2.0 * cfg.courant_fac * fac.atime * gas.hsml / (fac3 * msv)
    dt_c_full = torch.full_like(dt, float("inf"))
    dt_c_full[:ng] = dt_courant
    dt = torch.where(is_gas, torch.minimum(dt, dt_c_full), dt)
    dt = dt * hubble_a
    if opts.cooling != "none":
        # the cooling criterion: |dA| at most 30% of A a step (dt_entropy
        # holds the radiative term: cooling runs before the kick)
        dt_cool = 0.3 * gas.entropy.clamp_min(1e-30) \
            / gas.dt_entropy.abs().clamp_min(1e-30)
        dt_cool_full = torch.full_like(dt, float("inf"))
        dt_cool_full[:ng] = dt_cool
        dt = torch.where(is_gas, torch.minimum(dt, dt_cool_full), dt)
    return dt.clamp(cfg.min_size_timestep, cfg.max_size_timestep)


def advance_and_find_timesteps(state: SimState, cfg: SimConfig,
                               opts: SimOptions) -> SimState:
    """Closing + opening kicks and new quantized steps for ACTIVE
    particles [G2: timestep.c :: advance_and_find_timesteps()]."""
    p, gas = state.p, state.gas
    ng = gas.n_gas_max
    ti_now = state.ti_current
    active = timeline.active_mask(p.ti_endstep, ti_now, p.alive)

    ti_step_f = get_timesteps(state, cfg, opts) / cfg.timebase_interval
    ti_step_f = torch.minimum(ti_step_f, (TIMEBASE - ti_now).to(
        ti_step_f.dtype))
    ti_step = timeline.quantize_timestep(ti_step_f, ti_now)
    ti_step = torch.minimum(ti_step, TIMEBASE - ti_now).clamp_min(1)

    old_mid = _midpoint_ti(p.ti_begstep, p.ti_endstep)
    new_mid = ti_now + torch.div(ti_step, 2, rounding_mode="floor")
    dt_gk = (cosmology.gravkick_factor(cfg, old_mid, ti_now)
             + cosmology.gravkick_factor(cfg, ti_now, new_mid))
    dt_hk = (cosmology.hydrokick_factor(cfg, old_mid, ti_now)
             + cosmology.hydrokick_factor(cfg, ti_now, new_mid))
    hyd_full = torch.zeros_like(p.acc)
    hyd_full[:ng] = gas.hydro_acc
    is_gas = p.ptype == 0
    vel_new = (p.vel + p.acc * dt_gk[:, None]
               + torch.where(is_gas[:, None], hyd_full * dt_hk[:, None],
                             torch.zeros_like(hyd_full)))
    vel = torch.where(active[:, None], vel_new, p.vel)

    # entropy advances over [old midpoint, new midpoint] [G2: timestep.c]
    dt_entr = (new_mid - old_mid).to(gas.entropy.dtype)[:ng] \
        * cfg.timebase_interval
    entropy_new = torch.maximum(gas.entropy + gas.dt_entropy * dt_entr,
                                0.5 * gas.entropy)
    if cfg.min_gas_temp > 0:
        a3inv = comoving_factors(cfg, ti_now).a3inv
        min_entropy = _min_entropy(cfg, gas.density * a3inv)
        entropy_new = torch.where(gas.density > 0,
                                  torch.maximum(entropy_new, min_entropy),
                                  entropy_new)
    entropy = torch.where(active[:ng], entropy_new, gas.entropy)

    p = dataclasses.replace(
        p, vel=vel, ti_begstep=torch.where(active, ti_now, p.ti_begstep),
        ti_endstep=torch.where(active, ti_now + ti_step, p.ti_endstep))
    gas = dataclasses.replace(gas, entropy=entropy)
    return dataclasses.replace(state, p=p, gas=gas)


def pm_step_update(state: SimState, cfg: SimConfig, opts: SimOptions,
                   is_pm_step: bool, ring=None,
                   pm_box: float | None = None) -> SimState:
    """PM-step kick and new PM interval [G2: timestep.c PM part]. At a PM
    step every particle gets the long-range kick closing the old PM
    half-step and opening the new one; the new global PM step is bounded
    by MaxRMSDisplacementFac * (Box/PMGRID) / v_rms and MaxSizeTimestep.
    ``is_pm_step`` is a host boolean (the JAX package masks with a traced
    one). ``ring`` (the slab step's :class:`parallel.mesh.Ring`, the
    reference's ``axis_name``): the sums of m v^2 and m run over every
    rank's particles. ``pm_box``: the mesh's span where it is not the
    box (the vacuum slab step's domain extent)."""
    if not is_pm_step:
        return state
    p = state.p
    ti_now = state.ti_current
    fac = comoving_factors(cfg, ti_now)
    m = torch.where(p.alive, p.mass, torch.zeros_like(p.mass))
    v2 = (p.vel * p.vel).sum(-1)
    if ring is None:
        vrms = torch.sqrt((m * v2).sum() / m.sum().clamp_min(1e-37))
    else:
        sums = ring.psum(torch.stack([(m * v2).sum(), m.sum()]))
        vrms = torch.sqrt(sums[0] / sums[1].clamp_min(1e-37))
    vrms = vrms.clamp_min(1e-30)
    span = cfg.box_size if pm_box is None else pm_box
    dsp = cfg.max_rms_displacement_fac * span / max(opts.pmgrid, 1)
    if cfg.comoving_integration_on:
        dt = dsp * fac.atime ** 2 * fac.hubble_a / vrms
    else:
        dt = dsp / vrms
    dt = dt.clamp(cfg.min_size_timestep, cfg.max_size_timestep)
    ti_step_f = torch.minimum(dt / cfg.timebase_interval,
                              (TIMEBASE - ti_now).to(dt.dtype))
    ti_step = timeline.quantize_timestep(ti_step_f, ti_now)
    ti_step = torch.minimum(ti_step, TIMEBASE - ti_now).clamp_min(1)
    old_mid = _midpoint_ti(state.pm_ti_begstep, state.pm_ti_endstep)
    new_mid = ti_now + torch.div(ti_step, 2, rounding_mode="floor")
    dt_gk = (cosmology.gravkick_factor(cfg, old_mid, ti_now)
             + cosmology.gravkick_factor(cfg, ti_now, new_mid))
    vel = torch.where(p.alive[:, None], p.vel + p.acc_pm * dt_gk, p.vel)
    return dataclasses.replace(
        state, p=dataclasses.replace(p, vel=vel),
        pm_ti_begstep=ti_now.clone(),
        pm_ti_endstep=(ti_now + ti_step).to(torch.int32))


def _min_entropy(cfg: SimConfig, rho):
    """Entropy floor from MinGasTemp for PHYSICAL density ``rho``."""
    mean_mol = 4.0 / (1.0 + 3.0 * HYDROGEN_MASSFRAC)
    min_egy = (BOLTZMANN_CGS / PROTONMASS_CGS * cfg.min_gas_temp / mean_mol
               / GAMMA_MINUS1 / cfg.unit_velocity_in_cm_per_s ** 2)
    return GAMMA_MINUS1 * min_egy / rho.clamp_min(1e-30) ** GAMMA_MINUS1
