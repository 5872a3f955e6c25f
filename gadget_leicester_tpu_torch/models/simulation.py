"""The simulation loop [G2: run.c :: run(), init.c :: init(),
main.c].

Counterpart of ``gadget_leicester_tpu/models/simulation.py:41-45, 84-116,
157-271, 277-704`` (``potential_pass``, ``sync_point_step``,
``init_state``, and ``Simulation`` with ``from_param_file``, ``set_ics``,
``canonical_state``, ``step``, ``run_until`` and ``run``). One call of
:func:`sync_point_step` is one iteration of the reference's main loop:
find the next sync point, drift, forces, kick and new timesteps, PM step.
``Simulation.run`` wraps it in the host loop of the reference: the energy
statistics with the full potential (kernel H) and the Layzer-Irvine
drift, snapshots, restart dumps, the log files and the overflow bump of
capacities; none of that runs inside the step.

PyTorch runs eagerly, so where the JAX package traces a branch the port
reads one host boolean: whether this sync point is a PM step, whether a
cached grid must be rebuilt (``models/grids.py``), and whether the Newton
loop of the density solve is done (``ops/sph_dense.py``).

Left out, each an item of ROADMAP: the SPMD branches of ``run()``
(``mesh``, ``_decompose``, ``maybe_rebalance``; queue 1 item 14), the
``GLT_PROFILE_DIR`` profiler hook and the ``GLT_CPU_DETAIL`` probes
(tracing), and ``forcetest``, which ``check_supported`` refuses.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time as _time
from typing import Optional

import numpy as np
import torch

from gadget_leicester_tpu_torch.core import timeline
from gadget_leicester_tpu_torch.core.config import (
    BOLTZMANN_CGS, GAMMA, GAMMA_MINUS1, HYDROGEN_MASSFRAC, PROTONMASS_CGS,
    TIMEBASE, SimConfig, SimOptions, options_from_config,
    options_sidecar_path, parse_makefile_options, read_parameter_file)
from gadget_leicester_tpu_torch.core.state import SimState, from_arrays
from gadget_leicester_tpu_torch.io.restart import load_restart, save_restart
from gadget_leicester_tpu_torch.io.snapshot import (read_snapshot,
                                                    write_snapshot_set)
from gadget_leicester_tpu_torch.io.state_io import (ic_arrays_from_snapshot,
                                                    snapshot_from_state)
from gadget_leicester_tpu_torch.models import integrate
from gadget_leicester_tpu_torch.models.forces import (check_supported,
                                                      comoving_factors,
                                                      compute_forces,
                                                      compute_potential)
from gadget_leicester_tpu_torch.models.grids import (make_grid_cache,
                                                     resolve_sph_backend)
from gadget_leicester_tpu_torch.utils.diagnostics import (
    LayzerIrvineTracker, energy_statistics)
from gadget_leicester_tpu_torch.utils.logfiles import RunLogs


def potential_pass(state: SimState, cfg: SimConfig,
                   opts: SimOptions) -> SimState:
    """The full potential on demand [G2: potential.c]."""
    return compute_potential(state, cfg, opts)


def uses_pm_split(opts: SimOptions) -> bool:
    """Does this configuration run the two-timescale TreePM machinery?"""
    return opts.periodic and opts.pmgrid > 0 and not opts.nogravity and \
        opts.gravity_mode in ("auto", "treepm")


def sync_point_step(state: SimState, cfg: SimConfig, opts: SimOptions,
                    stats: dict | None = None) -> SimState:
    """One sync-point iteration [G2: run.c]. TreePM keeps PM on its own
    global timestep: the next sync point is the earlier of the particle
    bins' end and the PM step end; PM forces recompute only at PM steps.
    A run without a PM mesh (direct gravity) has no PM step: the particle
    bins alone set the sync points and ``pm_ti_endstep`` stays 0.
    Overflow bits are sticky."""
    ti_next = timeline.min_active_ti_end(state.p.ti_endstep, state.p.alive)
    if not uses_pm_split(opts):
        state = integrate.drift_all(state, cfg, opts, ti_next)
        state = compute_forces(state, cfg, opts, stats=stats)
        return integrate.advance_and_find_timesteps(state, cfg, opts)
    ti_next = torch.minimum(ti_next, state.pm_ti_endstep)
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


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; raises when CUDA is asked for and
    there is none (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for, but no CUDA device is "
            "available (torch.cuda.is_available() is False); run on the card "
            "or ask for the CPU explicitly (device='cpu', CLI --device cpu)")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Simulation:
    """begrun()/run(): owns config, options, device, state and the host
    loop.

    ``device`` defaults to ``"cuda"``, where the kernels run; ``"cpu"``
    runs their plain versions. Asked for CUDA where there is none, it
    raises."""

    def __init__(self, cfg: SimConfig, opts: Optional[SimOptions] = None,
                 device="cuda"):
        self.cfg = cfg
        self.opts = opts if opts is not None else options_from_config(cfg)
        self.device = resolve_device(device)
        self.state: Optional[SimState] = None
        self.step_count = 0
        self.stats: dict = {}   # density_iters: Newton sweeps per pass
        self.logs: Optional[RunLogs] = None
        self.li_tracker: Optional[LayzerIrvineTracker] = None
        self.li_drift = 0.0     # latest |dE_LI| / |W|
        self.snapshot_count = 0
        self.next_snapshot_time = cfg.time_of_first_snapshot
        self.next_stats_time = cfg.time_begin
        self.last_restart_wall = None
        # float32 stays float32: no TF32 in any matmul or convolution
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    @classmethod
    def from_param_file(cls, path: str, opts: Optional[SimOptions] = None,
                        restart_flag: int = 0,
                        opt_overrides: Optional[dict] = None,
                        device="cuda") -> "Simulation":
        """``Gadget2 param.txt [restartflag]`` [G2: main.c]: restart_flag
        0 starts from InitCondFile, 1 resumes from the restart dump in
        OutputDir, 2 starts from a snapshot named by InitCondFile.

        When ``opts`` is None the static flags come from, in order: the
        config (periodic; TreePM with an automatic pmgrid from the particle
        count), the ``<paramfile>.opts`` Makefile-style sidecar, then
        ``opt_overrides`` (the CLI's explicit flags)."""
        dev = resolve_device(device)
        cfg = read_parameter_file(path)
        sidecar = options_sidecar_path(path)
        side_kw = {}
        if opts is None and os.path.exists(sidecar):
            with open(sidecar) as fh:
                side_kw = parse_makefile_options(fh.read())
        if opt_overrides:
            side_kw.update(opt_overrides)
        if restart_flag == 1:
            state, meta = load_restart(
                os.path.join(cfg.output_dir, cfg.restart_file or "restart"),
                dev)
            if opts is None:
                opts = options_from_config(
                    cfg, n_particles=int(state.p.alive.sum()), **side_kw)
            sim = cls(cfg, opts, dev)
            # dumps hold no grid cache (derived data): start an empty one
            sim.state = dataclasses.replace(state, grids=make_grid_cache(dev))
            sim.step_count = meta.get("step_count", 0)
            sim.snapshot_count = meta.get("snapshot_count", 0)
        else:
            snap = read_snapshot(cfg.init_cond_file)
            pos, vel, mass, ptype, u = ic_arrays_from_snapshot(snap, cfg)
            if opts is None:
                opts = options_from_config(cfg, n_particles=len(pos),
                                           **side_kw)
            sim = cls(cfg, opts, dev)
            sim.set_ics(pos, vel, mass, ptype, pid=snap.ids.astype(np.int64),
                        u=u)
        return sim

    def set_ics(self, pos, vel, mass, ptype, pid=None, u=None) -> SimState:
        self.state = init_state(self.cfg, self.opts, pos, vel, mass, ptype,
                                self.device, pid=pid, u=u, stats=self.stats)
        return self.state

    def canonical_state(self) -> SimState:
        """The state in canonical (gas-first) layout, what every I/O and
        diagnostics consumer expects: the state itself, as the port has no
        SPMD layout."""
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

    def run_until(self, time_end: Optional[float] = None,
                  max_steps: int = 100000, callback=None) -> SimState:
        """Step until ``time_end`` (default TimeMax) [G2: run.c]."""
        cfg = self.cfg
        t_end = cfg.time_max if time_end is None else time_end
        if cfg.comoving_integration_on:
            ti_end = int(round(np.log(t_end / cfg.time_begin)
                               / cfg.timebase_interval))
        else:
            ti_end = int(round((t_end - cfg.time_begin)
                               / cfg.timebase_interval))
        ti_end = min(ti_end, TIMEBASE)
        for _ in range(max_steps):
            if int(self.state.ti_current) >= ti_end:
                break
            self.step()
            if callback is not None:
                callback(self)
        return self.state

    def write_restart(self) -> None:
        """Dump the state to OutputDir/RestartFile.npz, then empty the grid
        cache: the run goes on from exactly what the dump holds, as a run
        resumed from it does, so the two continue bit for bit."""
        cfg = self.cfg
        save_restart(os.path.join(cfg.output_dir,
                                  cfg.restart_file or "restart"),
                     self.canonical_state(), step_count=self.step_count,
                     extra_meta={"snapshot_count": self.snapshot_count})
        self.state = dataclasses.replace(
            self.state, grids=make_grid_cache(self.device))

    def _bump_capacities(self, ovf: int, t_now: float) -> None:
        """The sticky overflow bits say some cell dropped particles since
        the last reading [G2: gravtree.c realloc on overflow]: double the
        SPH capacity (bit 2; from 32 slots a subcell for the block
        backend, 128 a cell for the coarse cells), add 128 to the
        short-range one (bit 1), clear the bits, rebuild the grid cache
        and note it in info.txt."""
        new_opts = self.opts
        if ovf & 2:
            backend = resolve_sph_backend(new_opts, self.state.n_gas_max)
            cur = new_opts.sph_capacity or (32 if backend == "blocks"
                                            else 128)
            new_opts = dataclasses.replace(new_opts, sph_capacity=cur * 2)
        if ovf & 1:
            new_opts = dataclasses.replace(
                new_opts, sr_capacity=(new_opts.sr_capacity or 128) + 128)
        self.logs.log_info(
            self.step_count, t_now, 0.0,
            note=f"overflow {ovf}: capacities -> "
            f"sph={new_opts.sph_capacity} sr={new_opts.sr_capacity} "
            f"ghost={new_opts.spmd_ghost_frac}")
        self.opts = new_opts
        self.state = dataclasses.replace(
            self.state, overflow_flags=torch.zeros_like(
                self.state.overflow_flags),
            grids=make_grid_cache(self.device))

    def run(self, max_steps: int = 1000000,
            wall_limit_s: Optional[float] = None) -> SimState:
        """The main loop with the statistics, snapshot and restart cadence
        and the log files [G2: run.c :: run()]."""
        cfg = self.cfg
        if self.logs is None:
            self.logs = RunLogs(cfg)
        # OutputListOn: snapshot times from a file [G2: begrun.c]
        output_times = None
        if cfg.output_list_on and cfg.output_list_filename:
            with open(cfg.output_list_filename) as fh:
                output_times = sorted(
                    float(line.split()[0]) for line in fh
                    if line.strip() and not line.startswith("%"))
        wall0 = _time.time()
        limit = wall_limit_s if wall_limit_s is not None else \
            cfg.time_limit_cpu
        self.last_restart_wall = _time.time()

        for _ in range(max_steps):
            if int(self.state.ti_current) >= TIMEBASE:
                break
            if _time.time() - wall0 > limit:
                # a planned stop before the queue's limit [G2: run.c
                # TimeLimitCPU, ResubmitOn/ResubmitCommand]
                self.write_restart()
                if cfg.resubmit_on and cfg.resubmit_command:
                    subprocess.Popen(cfg.resubmit_command, shell=True)
                break
            t_before = self.time
            t0 = _time.time()
            pm_beg_before = int(self.state.pm_ti_begstep)
            self.step()
            _sync(self.device)
            dt_wall = _time.time() - t0
            phases = {"total": dt_wall}
            was_pm = int(self.state.pm_ti_begstep) != pm_beg_before
            t_now = self.time
            self.logs.log_info(self.step_count, t_now, t_now - t_before)
            n_active = int(timeline.active_mask(
                self.state.p.ti_begstep, self.state.ti_current,
                self.state.p.alive).sum())
            self.logs.log_timings(self.step_count, n_active, dt_wall,
                                  pm=was_pm)

            if t_now >= self.next_stats_time:
                ovf = int(self.state.overflow_flags)
                if ovf:
                    self._bump_capacities(ovf, t_now)
                # the full potential [G2: potential.c]: the step's p.pot
                # holds only the PM piece
                tp0 = _time.time()
                self.state = potential_pass(self.canonical_state(), cfg,
                                            self.opts)
                st = energy_statistics(self.state, cfg, self.opts)
                _sync(self.device)
                phases["potential"] = _time.time() - tp0
                self.logs.log_energy(t_now, st)
                if cfg.comoving_integration_on:
                    if self.li_tracker is None:
                        self.li_tracker = LayzerIrvineTracker()
                    self.li_drift = self.li_tracker.update(t_now, st)
                self.next_stats_time += cfg.time_bet_statistics
            if output_times is not None:
                due = (self.snapshot_count < len(output_times)
                       and t_now >= output_times[self.snapshot_count])
            else:
                due = (t_now >= self.next_snapshot_time
                       and cfg.time_bet_snapshot > 0)
            if due:
                ts0 = _time.time()
                if self.opts.output_potential:
                    self.state = potential_pass(self.canonical_state(), cfg,
                                                self.opts)
                snap = snapshot_from_state(
                    self.canonical_state(), cfg, self.opts,
                    with_potential=self.opts.output_potential)
                base = os.path.join(
                    cfg.output_dir,
                    f"{cfg.snapshot_file_base}_{self.snapshot_count:03d}")
                write_snapshot_set(base, snap, cfg.num_files_per_snapshot,
                                   fmt=cfg.snap_format)
                self.snapshot_count += 1
                phases["snapshot"] = _time.time() - ts0
                if output_times is None:
                    if cfg.comoving_integration_on:
                        self.next_snapshot_time = max(
                            self.next_snapshot_time * cfg.time_bet_snapshot,
                            t_now * 1.0000001)
                    else:
                        self.next_snapshot_time += cfg.time_bet_snapshot
            if (_time.time() - self.last_restart_wall
                    > cfg.cpu_time_bet_restart_file):
                tr0 = _time.time()
                self.write_restart()
                self.last_restart_wall = _time.time()
                phases["restart"] = _time.time() - tr0
            self.logs.log_cpu(self.step_count, t_now, phases)
        return self.state
