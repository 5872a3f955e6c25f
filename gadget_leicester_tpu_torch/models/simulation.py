"""The simulation driver [G2: run.c :: run(), init.c :: init()].

Counterpart of ``gadget_leicester_tpu/models/simulation.py:84-116,
157-271, 277-497`` (``sync_point_step``, ``init_state``, and
``Simulation`` with ``set_ics``, ``step`` and ``time``). One call of
:func:`sync_point_step` is one iteration of the reference's main loop:
find the next sync point, drift, forces, kick and new timesteps, PM step.

PyTorch runs eagerly, so where the JAX package traces a branch the port
reads one host boolean: whether this sync point is a PM step, whether a
cached grid must be rebuilt (``models/grids.py``), and whether the Newton
loop of the density solve is done (``ops/sph_dense.py``).

``Simulation.run()`` (snapshots, restarts, energy statistics and
``compute_potential``) is not ported yet (ROADMAP queue 1 items 10-11).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gadget_leicester_tpu_torch.core import timeline
from gadget_leicester_tpu_torch.core.config import (BOLTZMANN_CGS,
                                                    GAMMA, GAMMA_MINUS1,
                                                    HYDROGEN_MASSFRAC,
                                                    PROTONMASS_CGS,
                                                    SimConfig, SimOptions)
from gadget_leicester_tpu_torch.core.state import SimState, from_arrays
from gadget_leicester_tpu_torch.models import integrate
from gadget_leicester_tpu_torch.models.forces import (check_supported,
                                                      comoving_factors,
                                                      compute_forces)
from gadget_leicester_tpu_torch.models.grids import make_grid_cache


def sync_point_step(state: SimState, cfg: SimConfig, opts: SimOptions,
                    stats: dict | None = None) -> SimState:
    """One sync-point iteration [G2: run.c]. TreePM (the only gravity
    the port runs) keeps PM on its own global timestep: the next sync
    point is the earlier of the particle bins' end and the PM step end;
    PM forces recompute only at PM steps. Overflow bits are sticky."""
    ti_next = torch.minimum(
        timeline.min_active_ti_end(state.p.ti_endstep, state.p.alive),
        state.pm_ti_endstep)
    state = integrate.drift_all(state, cfg, opts, ti_next)
    is_pm_step = bool(state.ti_current == state.pm_ti_endstep)
    state = compute_forces(state, cfg, opts, do_pm=is_pm_step, stats=stats)
    state = integrate.advance_and_find_timesteps(state, cfg, opts)
    return integrate.pm_step_update(state, cfg, opts, is_pm_step)


def _initial_hsml_guess(pos: np.ndarray, mask: np.ndarray,
                        des_ngb: float) -> float:
    """Mean-interparticle-spacing h guess; the adaptive solve refines it."""
    if mask.sum() == 0:
        return 1.0
    pts = pos[mask]
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    vol = float(np.prod(np.maximum(hi - lo, 1e-10)))
    n = int(mask.sum())
    return float((3.0 * vol * des_ngb / (4.0 * np.pi * max(n, 1)))
                 ** (1.0 / 3.0))


def init_state(cfg: SimConfig, opts: SimOptions, pos, vel, mass, ptype,
               device, pid=None, u=None,
               stats: dict | None = None) -> SimState:
    """IC arrays -> consistent runtime state [G2: init.c :: init()]:
    comoving velocity scaling, initial smoothing lengths by the adaptive
    density pass, u -> entropy, and a full force computation so the first
    kick has accelerations."""
    n = pos.shape[0]
    if pid is None:
        pid = np.arange(1, n + 1)
    if cfg.comoving_integration_on:
        # IC files store v_pec / sqrt(a); internal vel = a v_pec
        vel = np.asarray(vel) * cfg.time_begin ** 1.5
    state = from_arrays(pos, vel, mass, ptype, pid, opts, device, u=u)
    check_supported(cfg, opts, state.n_max, state.n_gas_max)
    state = dataclasses.replace(state, grids=make_grid_cache(state.device))
    n_gas = int((np.asarray(ptype) == 0).sum())
    if not n_gas:
        return compute_forces(state, cfg, opts, do_sph=False, stats=stats)

    ng = state.n_gas_max
    gas = state.gas
    hsml = gas.hsml.clone()
    hsml[:n_gas] = _initial_hsml_guess(np.asarray(pos), np.asarray(ptype) == 0,
                                       cfg.des_num_ngb)
    u_arr = np.zeros(ng)
    if u is not None:
        u_arr[:n_gas] = np.asarray(u)[:n_gas]
    if cfg.init_gas_temp > 0 and (u is None or np.all(u_arr[:n_gas] == 0)):
        mean_mol = 4.0 / (1.0 + 3.0 * HYDROGEN_MASSFRAC)
        u_arr[:n_gas] = (BOLTZMANN_CGS / PROTONMASS_CGS * cfg.init_gas_temp
                         / mean_mol / GAMMA_MINUS1
                         / cfg.unit_velocity_in_cm_per_s ** 2)
    gas = dataclasses.replace(
        gas, hsml=hsml,
        entropy=torch.as_tensor(u_arr, dtype=gas.entropy.dtype).to(device),
        vel_pred=state.p.vel[:ng].clone())
    state = dataclasses.replace(state, gas=gas)
    gas_mask = torch.zeros(ng, dtype=torch.bool, device=state.device)
    gas_mask[:n_gas] = True

    # first density pass, then u -> entropy with the PHYSICAL density
    # [G2: init.c Entropy = GAMMA_MINUS1 u / (Density / a^3)^GAMMA_MINUS1]
    state = compute_forces(state, cfg, opts, do_sph=True, stats=stats)
    gas = state.gas
    rho_safe = torch.where(gas.density > 0, gas.density,
                           torch.ones_like(gas.density))
    a3inv = comoving_factors(cfg, state.ti_current).a3inv
    a_ent = GAMMA_MINUS1 * gas.entropy / (rho_safe * a3inv) ** GAMMA_MINUS1
    a_ent = torch.where(gas_mask, a_ent, torch.zeros_like(a_ent))
    gas = dataclasses.replace(gas, entropy=a_ent, entropy_pred=a_ent,
                              pressure=a_ent * gas.density ** GAMMA)
    state = dataclasses.replace(state, gas=gas)
    # hydro forces again with the entropy-based pressure
    return compute_forces(state, cfg, opts, do_sph=True, stats=stats)


class Simulation:
    """Owns config, options, device and state; ``set_ics`` then ``step``.

    ``device`` has no default: the port runs where the caller says
    (``"cuda"`` for the kernels, ``"cpu"`` for their plain versions)."""

    def __init__(self, cfg: SimConfig, opts: SimOptions, device):
        self.cfg = cfg
        self.opts = opts
        self.device = torch.device(device)
        self.state: Optional[SimState] = None
        self.step_count = 0
        self.stats: dict = {}   # density_iters: Newton sweeps per pass
        # float32 stays float32: no TF32 in any matmul or convolution
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def set_ics(self, pos, vel, mass, ptype, pid=None, u=None) -> SimState:
        self.state = init_state(self.cfg, self.opts, pos, vel, mass, ptype,
                                self.device, pid=pid, u=u, stats=self.stats)
        return self.state

    @property
    def time(self) -> float:
        return timeline.ti_to_time(int(self.state.ti_current), self.cfg)

    def step(self, n: int = 1) -> SimState:
        for _ in range(n):
            self.state = sync_point_step(self.state, self.cfg, self.opts,
                                         stats=self.stats)
        self.step_count += n
        return self.state

    def run(self, *args, **kwargs):
        raise NotImplementedError(
            "Simulation.run() with snapshots, restarts and energy "
            "statistics is not ported yet (ROADMAP queue 1 items 10-11)")
