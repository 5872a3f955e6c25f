"""SimState <-> snapshot conversion with GADGET's unit conventions.

Counterpart of ``gadget_leicester_tpu/io/state_io.py:22-93``
(``snapshot_from_state``, ``ic_arrays_from_snapshot``). Velocities
[G2: read_ic.c / io.c]: snapshot and IC files store v_file = v_peculiar /
sqrt(a) in comoving runs; the internal variable is vel = a v_peculiar, so
v_file = vel / a^(3/2) on write (``init_state`` applies the inverse on
read). Physical runs: vel = v_file.
"""

from __future__ import annotations

import numpy as np

from gadget_leicester_tpu_torch.core import timeline
from gadget_leicester_tpu_torch.core.config import (GAMMA_MINUS1, SimConfig,
                                                    SimOptions)
from gadget_leicester_tpu_torch.core.state import SimState
from gadget_leicester_tpu_torch.io.snapshot import Header, SnapshotData


def snapshot_from_state(state: SimState, cfg: SimConfig, opts: SimOptions,
                        with_potential: bool = False) -> SnapshotData:
    """The live state as a GADGET snapshot, types in file order
    [G2: io.c :: savepositions()/fill_write_buffer()]."""
    alive = state.p.alive.cpu().numpy()
    ptype = state.p.ptype.cpu().numpy()
    a_now = timeline.ti_to_time(int(state.ti_current), cfg)

    order = np.argsort(ptype[alive], kind="stable")  # types 0..5 file order
    idx = np.where(alive)[0][order]

    pos = state.p.pos.cpu().numpy()[idx]
    vel = state.p.vel.cpu().numpy()[idx]
    if cfg.comoving_integration_on:
        vel = vel / a_now ** 1.5
    mass = state.p.mass.cpu().numpy()[idx]
    ids = state.p.pid.cpu().numpy()[idx].astype(np.uint32)

    npart = np.zeros(6, np.uint32)
    for t in range(6):
        npart[t] = int((ptype[idx] == t).sum())
    h = Header()
    h.npart = npart
    h.npart_total = npart.copy()
    h.time = a_now
    h.redshift = 1.0 / a_now - 1.0 if cfg.comoving_integration_on else 0.0
    h.box_size = cfg.box_size
    h.omega0 = cfg.omega0
    h.omega_lambda = cfg.omega_lambda
    h.hubble_param = cfg.hubble_param

    # gas blocks: u from the entropy with the PHYSICAL density [G2: io.c
    # IO_U writes Entropy / GAMMA_MINUS1 * pow(Density a3inv, GAMMA_MINUS1)]
    n_gas_file = int(npart[0])
    u = rho = hsml = None
    if n_gas_file:
        gidx = idx[:n_gas_file]  # gas slots (all < n_gas_max)
        ent = state.gas.entropy.cpu().numpy()[gidx]
        dens = state.gas.density.cpu().numpy()[gidx]
        if opts.isotherm_eqs:
            u_val = ent / GAMMA_MINUS1
        else:
            a3inv = 1.0 / a_now ** 3 if cfg.comoving_integration_on else 1.0
            u_val = (ent * np.maximum(dens * a3inv, 1e-37) ** GAMMA_MINUS1
                     / GAMMA_MINUS1)
        u = u_val.astype(np.float32)
        rho = dens.astype(np.float32)
        hsml = state.gas.hsml.cpu().numpy()[gidx].astype(np.float32)

    pot = (state.p.pot.cpu().numpy()[idx].astype(np.float32)
           if with_potential else None)
    return SnapshotData(
        header=h, pos=pos.astype(np.float32), vel=vel.astype(np.float32),
        ids=ids, mass=mass.astype(np.float32), u=u, rho=rho, hsml=hsml,
        pot=pot)


def ic_arrays_from_snapshot(snap: SnapshotData, cfg: SimConfig):
    """IC file -> (pos, vel, mass, ptype, u) for ``init_state``
    [G2: read_ic.c :: read_ic()]; the velocity conversion is applied
    there."""
    pos = np.asarray(snap.pos, np.float64)
    vel = np.asarray(snap.vel, np.float64)
    mass = np.asarray(snap.mass, np.float64)
    return pos, vel, mass, snap.ptype, snap.u
