"""Sink particles of the Leicester fork: registration, formation and
accretion [Bate et al. 1995 style checks].

Counterpart of ``gadget_leicester_tpu/models/sinks.py`` (``_min_image``
:25, ``register_sinks_from_types`` :33, ``accrete_onto_sinks`` :47,
``create_sinks`` :111). A sink is a collisionless particle named in
``SinkState.slot``. Accreted gas gives its mass and momentum to the
nearest claiming sink and is masked dead (``alive = False``); a new sink
is a gas particle whose type flips to 5 in place. Static shapes, as in
the reference: nothing is compacted.

The reference builds [64 slots, gas] matrices; here the work is
restricted to the used slots (:func:`used_slots`, one host read of their
count), so the memory is [used slots, gas]: 1.6 GB a matrix at 2x128^3
with all 64 slots against a few MB with a few sinks. The results are the
same: the nearest claiming sink and the densest candidate are the first
index on ties, as ``argmin``/``argmax`` are in the reference, by explicit
first-index reductions that the card and the CPU compute alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gadget_leicester_tpu_torch.core.config import (GAMMA_MINUS1, SimConfig,
                                                    SimOptions)
from gadget_leicester_tpu_torch.core.state import SimState


def min_image(dx: torch.Tensor, cfg: SimConfig, opts: SimOptions):
    """Periodic minimum-image displacement (no-op for vacuum runs)."""
    if not opts.periodic or cfg.box_size <= 0:
        return dx
    box = cfg.box_size
    return dx - box * torch.round(dx / box)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis of 3, spelled out as elementwise products
    and sums: each is correctly rounded alike on the card and the CPU,
    where a reduction kernel may sum in another order. The sign of dv . dx
    decides ``approaching``, and for gas on a circular orbit it is a
    rounding residue."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def used_slots(slot: torch.Tensor) -> torch.Tensor:
    """[U] int64: the particle indices of the used sink slots, in slot
    order."""
    return slot[slot >= 0].long()


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """0-d int64: the first index of the largest value of ``x`` [n]."""
    ids = torch.arange(x.shape[0], device=x.device)
    return torch.where(x == x.max(), ids, x.shape[0]).min()


def register_sinks_from_types(state: SimState, sink_type: int = 5) -> SimState:
    """Mark every alive particle of ``sink_type`` as a sink, in index
    order, as many as there are slots (host-side set-up)."""
    ptype = state.p.ptype.cpu().numpy()
    alive = state.p.alive.cpu().numpy()
    idx = np.flatnonzero((ptype == sink_type) & alive)
    cap = state.sinks.slot.shape[0]
    slot = np.full(cap, -1, np.int32)
    slot[:min(len(idx), cap)] = idx[:cap]
    return dataclasses.replace(state, sinks=dataclasses.replace(
        state.sinks, slot=torch.from_numpy(slot).to(state.sinks.slot.device)))


def accrete_onto_sinks(state: SimState, cfg: SimConfig,
                       opts: SimOptions) -> SimState:
    """Gas inside a sink's accretion radius that approaches it and is
    bound to it (0.5 v_rel^2 + u < G M_s / sqrt(r^2 + eps_5^2)) goes to
    the nearest claiming sink, first slot on ties: its mass and momentum
    move over exactly, it dies, and the sink's ``acc_mass`` and
    ``n_accreted`` grow."""
    if cfg.sink_accretion_radius <= 0:
        return state
    p, gas, sinks = state.p, state.gas, state.sinks
    used = torch.nonzero(sinks.slot >= 0).flatten()
    if used.numel() == 0:
        return state
    ng = gas.n_gas_max
    gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
    s_idx = sinks.slot[used].long()
    s_pos, s_vel, s_mass = p.pos[s_idx], p.vel[s_idx], p.mass[s_idx]

    dx = min_image(s_pos[:, None, :] - p.pos[None, :ng, :], cfg, opts)
    r2 = dot3(dx, dx)                                   # [U, Ng]
    dv = s_vel[:, None, :] - p.vel[None, :ng, :]
    inside = r2 < cfg.sink_accretion_radius ** 2
    approaching = dot3(dv, dx) < 0
    v2 = dot3(dv, dv)
    eps = cfg.softenings[5]
    r_soft = torch.sqrt(r2 + eps * eps)
    rho_safe = torch.clamp(gas.density, min=1e-30)
    u_gas = gas.entropy_pred * rho_safe ** GAMMA_MINUS1 / GAMMA_MINUS1
    bound = 0.5 * v2 + u_gas[None, :] \
        < cfg.grav_internal * s_mass[:, None] / r_soft
    take = inside & approaching & bound & gas_mask[None, :]

    # each gas particle goes to the nearest claiming sink, the first on ties
    r2m = torch.where(take, r2, torch.full_like(r2, 1e30))
    u = used.shape[0]
    rank = torch.arange(u, device=r2.device)[:, None]
    winner = torch.where(r2m == r2m.min(0).values, rank, u).min(0).values
    claim = (rank == winner[None, :]) & take.any(0)[None, :]

    m_g = torch.where(gas_mask, p.mass[:ng], torch.zeros_like(p.mass[:ng]))
    w = torch.where(claim, m_g[None, :], torch.zeros_like(r2))
    dm = w.sum(1)
    dp = (w[:, :, None] * p.vel[None, :ng, :]).sum(1)
    n_acc = claim.sum(1).to(torch.int32)

    new_mass = s_mass + dm
    new_vel = (s_mass[:, None] * s_vel + dp) \
        / torch.clamp(new_mass, min=1e-30)[:, None]
    mass = p.mass.clone()
    vel = p.vel.clone()
    mass[s_idx] = new_mass
    vel[s_idx] = new_vel
    alive = p.alive.clone()
    alive[:ng] = p.alive[:ng] & ~claim.any(0)
    acc_mass = sinks.acc_mass.clone()
    n_accreted = sinks.n_accreted.clone()
    acc_mass[used] = acc_mass[used] + dm
    n_accreted[used] = n_accreted[used] + n_acc
    return dataclasses.replace(
        state, p=dataclasses.replace(p, mass=mass, vel=vel, alive=alive),
        sinks=dataclasses.replace(sinks, acc_mass=acc_mass,
                                  n_accreted=n_accreted))


def create_sinks(state: SimState, cfg: SimConfig,
                 opts: SimOptions) -> SimState:
    """Density-threshold sink formation: a gas particle becomes a sink
    when its density exceeds SinkFormationDensity, its flow converges (div
    v < 0), it is bound (u <= |psi| / 2), no gas within
    SinkAccretionRadius has a lower potential, and a slot is free. At most
    one forms per sync point, the densest candidate (the first on ties),
    in the first free slot; its type flips to 5 in place, so mass and
    momentum are kept exactly."""
    if cfg.sink_formation_density <= 0:
        return state
    p, gas, sinks = state.p, state.gas, state.sinks
    ng = gas.n_gas_max
    gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
    rho = gas.density
    rho_safe = torch.clamp(rho, min=1e-30)
    u = gas.entropy_pred * rho_safe ** GAMMA_MINUS1 / GAMMA_MINUS1
    pot = p.pot[:ng]
    psi_mag = torch.clamp(-pot, min=1e-30)
    cand = (gas_mask & (rho > cfg.sink_formation_density)
            & (gas.div_vel < 0.0) & (u <= 0.5 * psi_mag))
    best = first_argmax(torch.where(cand, rho, torch.full_like(rho, -1.0)))

    # the potential minimum among all gas within r_acc of the candidate
    r_acc = max(cfg.sink_accretion_radius, 0.0)
    dxb = min_image(p.pos[:ng] - p.pos[best][None, :], cfg, opts)
    near = gas_mask & (dot3(dxb, dxb) < r_acc * r_acc)
    near[best] = False
    is_pot_min = ~(near & (pot < pot[best])).any()

    free = sinks.slot < 0
    free_slot = first_argmax(free.to(torch.int32))
    do_form = cand.any() & is_pot_min & free.any()

    ptype = p.ptype.clone()
    ptype[best] = torch.where(do_form, torch.full_like(ptype[best], 5),
                              ptype[best])
    slot = sinks.slot.clone()
    slot[free_slot] = torch.where(do_form, best.to(slot.dtype),
                                  slot[free_slot])
    return dataclasses.replace(
        state, p=dataclasses.replace(p, ptype=ptype),
        sinks=dataclasses.replace(sinks, slot=slot))
