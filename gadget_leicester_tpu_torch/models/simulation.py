"""The simulation loop [G2: run.c :: run(), init.c :: init(),
main.c].

Counterpart of ``gadget_leicester_tpu/models/simulation.py:41-45, 84-116,
157-271, 277-704`` (``potential_pass``, ``sync_point_step``,
``init_state``, and ``Simulation`` with ``from_param_file``, ``set_ics``,
``canonical_state``, ``step``, ``run_until`` and ``run``). One call of
:func:`sync_point_step` is one iteration of the reference's main loop:
find the next sync point, drift, forces, the fork's cooling and sinks
(``models/cooling.py``, ``models/sinks.py``), kick and new timesteps, PM
step.
``Simulation.run`` wraps it in the host loop of the reference: the energy
statistics with the full potential (kernel H) and the Layzer-Irvine
drift, snapshots, restart dumps, the log files and the overflow bump of
capacities; none of that runs inside the step.

PyTorch runs eagerly, so where the JAX package traces a branch the port
reads one host boolean: whether this sync point is a PM step, whether a
cached grid must be rebuilt (``models/grids.py``), and whether the Newton
loop of the density solve is done (``ops/sph_dense.py``).

``mesh`` (``Simulation(..., mesh=K)``, the reference's :289-311, and its
branches of ``from_param_file``, ``_decompose``, ``maybe_rebalance``,
``canonical_state``, ``step`` and ``run()``) routes the steps through the
slab step of ``parallel/spmd.py``, periodic or vacuum (a domain cube
fitted at each decomposition, ``auto_pmgrid`` where pmgrid is 0), with
sinks and Stamatellos cooling: this process is one rank of a ring
(``parallel/mesh.py``), its state the chunk of its slab between steps.
Every rank builds the same slab layout from the same global state and
keeps its own chunk; outputs gather the chunks and take the canonical
layout (``spmd_to_canonical``), and rank 0 alone writes energy.txt,
cpu.txt, info.txt, snapshots and restart dumps.

``run()`` also keeps the reference's tracing hooks (:562-570, :455-475,
:653-657): with ``GLT_PROFILE_DIR`` set, a ``torch.profiler`` trace of
the sync points from ``GLT_PROFILE_START`` (2) for ``GLT_PROFILE_STEPS``
(2) is written there (``utils/logfiles.py :: profile_steps`` traces a
number of steps on demand); with ``GLT_CPU_DETAIL=1`` the statistics
cadence times drift, gravity, hydro and kick as standalone passes on the
current state (results dropped) into cpu.txt's sampled columns, without a
ring, as in the reference; and with ``SimOptions.forcetest`` above 0 the
force test (``utils/forcetest.py``) appends to forcetest.txt there.

Left out on slabs, each refused with its reason
(``parallel/spmd.py :: check_slab_supported``): the zoom, a periodic tree
run, ``nogravity``, adaptive gas softening and beta cooling.
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
from gadget_leicester_tpu_torch.models.cooling import apply_cooling
from gadget_leicester_tpu_torch.models.forces import (check_supported,
                                                      comoving_factors,
                                                      compute_forces,
                                                      compute_potential,
                                                      compute_sph)
from gadget_leicester_tpu_torch.models.grids import (make_grid_cache,
                                                     resolve_sph_backend)
from gadget_leicester_tpu_torch.models.sinks import (accrete_onto_sinks,
                                                     create_sinks)
from gadget_leicester_tpu_torch.utils.diagnostics import (
    LayzerIrvineTracker, energy_statistics)
from gadget_leicester_tpu_torch.utils.forcetest import (run_forcetest,
                                                        write_forcetest_file)
from gadget_leicester_tpu_torch.utils.logfiles import RunLogs, start_profiler


# the phases cpu.txt samples with GLT_CPU_DETAIL=1 (the reference's
# _probe_* programs, :53-81): each a standalone pass on the current state
def _probe_drift(state: SimState, cfg: SimConfig, opts: SimOptions):
    ti_next = timeline.min_active_ti_end(state.p.ti_endstep, state.p.alive)
    return integrate.drift_all(state, cfg, opts,
                               torch.minimum(ti_next, state.pm_ti_endstep))


def _probe_gravity(state: SimState, cfg: SimConfig, opts: SimOptions):
    return compute_forces(state, cfg, opts, do_sph=False,
                          do_pm=not uses_pm_split(opts))


def _probe_hydro(state: SimState, cfg: SimConfig, opts: SimOptions):
    fac = comoving_factors(cfg, state.ti_current)
    active = (state.p.ti_endstep == state.ti_current) & state.p.alive
    return compute_sph(state, cfg, opts, fac, active[:state.n_gas_max])


def _probe_kick(state: SimState, cfg: SimConfig, opts: SimOptions):
    state = integrate.advance_and_find_timesteps(state, cfg, opts)
    if uses_pm_split(opts):
        state = integrate.pm_step_update(state, cfg, opts, False)
    return state


def potential_pass(state: SimState, cfg: SimConfig,
                   opts: SimOptions) -> SimState:
    """The full potential on demand [G2: potential.c]."""
    return compute_potential(state, cfg, opts)


def uses_pm_split(opts: SimOptions) -> bool:
    """Does this configuration run the two-timescale TreePM machinery?"""
    return opts.periodic and opts.pmgrid > 0 and not opts.nogravity and \
        opts.gravity_mode in ("auto", "treepm")


def fork_physics(state: SimState, cfg: SimConfig,
                 opts: SimOptions) -> SimState:
    """The Leicester fork's physics between the forces and the kick
    [JAX simulation.py:105-111]: cooling into dt_entropy, then sink
    formation and accretion."""
    if opts.cooling != "none":
        state = apply_cooling(state, cfg, opts)
    if opts.sinks:
        state = create_sinks(state, cfg, opts)
        state = accrete_onto_sinks(state, cfg, opts)
    return state


def sync_point_step(state: SimState, cfg: SimConfig, opts: SimOptions,
                    stats: dict | None = None) -> SimState:
    """One sync-point iteration [G2: run.c]: drift, forces, the fork's
    cooling and sinks (:func:`fork_physics`), kick and new timesteps.
    TreePM keeps PM on its own global timestep: the next sync point is the
    earlier of the particle bins' end and the PM step end; PM forces
    recompute only at PM steps. A run without a PM mesh (direct or tree
    gravity) has no PM step: the particle bins alone set the sync points
    and ``pm_ti_endstep`` stays 0. Overflow bits are sticky."""
    ti_next = timeline.min_active_ti_end(state.p.ti_endstep, state.p.alive)
    if not uses_pm_split(opts):
        state = integrate.drift_all(state, cfg, opts, ti_next)
        state = compute_forces(state, cfg, opts, stats=stats)
        state = fork_physics(state, cfg, opts)
        return integrate.advance_and_find_timesteps(state, cfg, opts)
    ti_next = torch.minimum(ti_next, state.pm_ti_endstep)
    state = integrate.drift_all(state, cfg, opts, ti_next)
    is_pm_step = bool(state.ti_current == state.pm_ti_endstep)
    state = compute_forces(state, cfg, opts, do_pm=is_pm_step, stats=stats)
    state = fork_physics(state, cfg, opts)
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
    density pass, u -> entropy (with ``isotherm_eqs``, u -> c_s^2 =
    (gamma - 1) u), and a full force computation so the first kick has
    accelerations."""
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
    if opts.isotherm_eqs:
        # the isothermal EOS keeps c_s^2 = (gamma - 1) u in the entropy slot
        a_ent = GAMMA_MINUS1 * gas.entropy
    else:
        a3inv = comoving_factors(cfg, state.ti_current).a3inv
        a_ent = GAMMA_MINUS1 * gas.entropy \
            / (rho_safe * a3inv) ** GAMMA_MINUS1
    a_ent = torch.where(gas_mask, a_ent, torch.zeros_like(a_ent))
    pressure = a_ent * (gas.density if opts.isotherm_eqs
                        else gas.density ** GAMMA)
    gas = dataclasses.replace(gas, entropy=a_ent, entropy_pred=a_ent,
                              pressure=pressure)
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


# set_ics raises the capacities at most this many times (SPH: 2^8 times
# the first)
MAX_INIT_BUMPS = 8


def raised_capacities(opts: SimOptions, ovf: int,
                      n_gas_max: int) -> SimOptions:
    """The capacities after overflow bits ``ovf``: the SPH one doubled
    (bit 2; from 32 slots a subcell for the block backend, 128 a cell for
    the coarse cells), 128 added to the short-range one (bit 1)."""
    if ovf & 2:
        backend = resolve_sph_backend(opts, n_gas_max)
        cur = opts.sph_capacity or (32 if backend == "blocks" else 128)
        opts = dataclasses.replace(opts, sph_capacity=cur * 2)
    if ovf & 1:
        opts = dataclasses.replace(
            opts, sr_capacity=(opts.sr_capacity or 128) + 128)
    return opts


def _capacity_note(ovf: int, opts: SimOptions) -> str:
    return (f"overflow {ovf}: capacities -> sph={opts.sph_capacity} "
            f"sr={opts.sr_capacity} ghost={opts.spmd_ghost_frac}")


class _NoLogs:
    """The log files of a rank other than 0: it writes none."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class Simulation:
    """begrun()/run(): owns config, options, device, state and the host
    loop.

    ``device`` defaults to ``"cuda"``, where the kernels run; ``"cpu"``
    runs their plain versions. Asked for CUDA where there is none, it
    raises. ``mesh`` (None, an int world size or a process group) runs
    the slab step on a ring of ranks (``parallel/mesh.py :: join``):
    ``mesh=1`` outside any group starts a group of one; a larger ring is
    started by the CLI (``--devices``) or ``parallel/launch.py``."""

    def __init__(self, cfg: SimConfig, opts: Optional[SimOptions] = None,
                 device="cuda", mesh=None):
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
        self.init_notes: list = []   # capacity bumps of set_ics
        self.next_snapshot_time = cfg.time_of_first_snapshot
        self.next_stats_time = cfg.time_begin
        self.last_restart_wall = None
        # float32 stays float32: no TF32 in any matmul or convolution
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.mesh = None            # the slab ring (parallel.mesh.Ring)
        self.spmd_edges = None      # the slab boundaries [d+1]
        self.spmd_caps = None       # (cap_g, cap_r) of a rank's chunk
        self.spmd_domain = None     # a vacuum ring's (origin, extent, fill)
        self._spmd_step = None      # parallel.spmd.SpmdStep
        if mesh is not None:
            from gadget_leicester_tpu_torch.parallel.mesh import join
            from gadget_leicester_tpu_torch.parallel.spmd import \
                check_slab_supported
            check_slab_supported(self.opts)
            self.mesh = join(mesh, self.device)

    @property
    def is_root(self) -> bool:
        """Rank 0 of the ring, or a run without one: the process that
        writes the outputs."""
        return self.mesh is None or self.mesh.rank == 0

    @classmethod
    def from_param_file(cls, path: str, opts: Optional[SimOptions] = None,
                        restart_flag: int = 0,
                        opt_overrides: Optional[dict] = None,
                        device="cuda", mesh=None) -> "Simulation":
        """``Gadget2 param.txt [restartflag]`` [G2: main.c]: restart_flag
        0 starts from InitCondFile, 1 resumes from the restart dump in
        OutputDir, 2 starts from a snapshot named by InitCondFile.

        When ``opts`` is None the static flags come from, in order: the
        config (periodic; TreePM with an automatic pmgrid from the particle
        count), the ``<paramfile>.opts`` Makefile-style sidecar, then
        ``opt_overrides`` (the CLI's explicit flags). ``mesh``: as for
        the constructor; a resumed dump is re-decomposed."""
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
            sim = cls(cfg, opts, dev, mesh=mesh)
            # dumps hold no grid cache (derived data): start an empty one
            sim.state = dataclasses.replace(state, grids=make_grid_cache(dev))
            sim.step_count = meta.get("step_count", 0)
            sim.snapshot_count = meta.get("snapshot_count", 0)
            if sim.mesh is not None:
                # dumps are in the canonical layout: re-decompose
                sim._decompose()
        else:
            snap = read_snapshot(cfg.init_cond_file)
            pos, vel, mass, ptype, u = ic_arrays_from_snapshot(snap, cfg)
            if opts is None:
                opts = options_from_config(cfg, n_particles=len(pos),
                                           **side_kw)
            sim = cls(cfg, opts, dev, mesh=mesh)
            sim.set_ics(pos, vel, mass, ptype, pid=snap.ids.astype(np.int64),
                        u=u)
        return sim

    def set_ics(self, pos, vel, mass, ptype, pid=None, u=None) -> SimState:
        """The initial state (:func:`init_state`). A cell that overflows
        there drops gas whose density stays 0 and whose entropy is taken at
        a density of 1; a later capacity bump lists such a particle again
        as a source of density 0, and the hydro sums turn NaN (ROADMAP
        queue 3: the JAX package's ``set_ics`` keeps it). So while the
        initialisation overflows, the capacities are raised as the run
        loop raises them (:func:`raised_capacities`), at most
        ``MAX_INIT_BUMPS`` times, and it starts over; the notes go to
        info.txt when :meth:`run` opens it."""
        for _ in range(MAX_INIT_BUMPS + 1):
            self.state = init_state(self.cfg, self._init_opts(), pos, vel,
                                    mass, ptype, self.device, pid=pid, u=u,
                                    stats=self.stats)
            ovf = int(self.state.overflow_flags)
            if not ovf or len(self.init_notes) == MAX_INIT_BUMPS:
                break
            self.opts = raised_capacities(self.opts, ovf,
                                          self.state.n_gas_max)
            self.init_notes.append(_capacity_note(ovf, self.opts))
        if self.mesh is not None:
            self._decompose()
        return self.state

    def _init_opts(self) -> SimOptions:
        """The options of :func:`init_state`: the run's, save that a vacuum
        ring initialises without gravity. The first sync point of a fresh
        state is a PM step at which every particle is active (ti_current =
        ti_endstep = pm_ti_endstep = 0), so the slab step computes all of
        the gravity there; the single device has no vacuum TreePM to give
        it, and a tree walk of the whole box would be thrown away."""
        if self.mesh is None or self.opts.periodic:
            return self.opts
        return dataclasses.replace(self.opts, nogravity=True)

    # ------------------------------------------------------------------
    # The slab decomposition [G2: domain.c :: domain_Decomposition()]
    # ------------------------------------------------------------------
    def _decompose(self, edges=None) -> None:
        """(Re-)lay the state onto the ring with cost-balanced slab edges
        (``edges`` [d+1] where given) and a fresh slab step: every rank
        builds the same layout from the same canonical state (gathered
        first where the state is already a chunk) and keeps its own chunk,
        with an empty grid cache. A vacuum run refits its domain, the cube
        1.3 times the extent of the alive particles
        (``parallel/spmd.py :: fit_domain``), and takes ``auto_pmgrid`` of
        the alive count where pmgrid is 0, as the JAX package's
        ``_decompose`` does (``models/simulation.py:389-407``). While the
        slab's fresh lists would overflow (:meth:`SpmdStep.probe`), the
        capacities are raised (``raised_slab_capacities``), at most
        ``MAX_INIT_BUMPS`` times, as :meth:`set_ics` raises them for the
        initialisation: the slab grid keeps its mean fill at 0.8 of its
        capacity, and a near-uniform box overflows its fullest cells at
        the first sync point (2x128^3 on one rank)."""
        from gadget_leicester_tpu_torch.core.config import auto_pmgrid
        from gadget_leicester_tpu_torch.parallel.spmd import (
            SpmdStep, fit_domain, local_chunk, make_spmd_grid_cache,
            raised_slab_capacities, spmd_min_width, to_spmd)
        state = self.canonical_state()
        domain = None
        if not self.opts.periodic:
            alive = state.p.alive.cpu().numpy()
            domain = fit_domain(state.p.pos.cpu().numpy(), alive)
            if self.opts.pmgrid <= 0:
                self.opts = dataclasses.replace(
                    self.opts, pmgrid=auto_pmgrid(int(alive.sum())))
        mw = spmd_min_width(self.cfg, self.opts, state.n_gas_max,
                            extent=None if domain is None else domain[1])
        full, caps, edges = to_spmd(state, self.mesh.size, self.cfg,
                                    min_width=mw, edges=edges, domain=domain)
        local = local_chunk(full, self.mesh.rank, caps)
        del full
        for n_bumps in range(MAX_INIT_BUMPS + 1):
            step = SpmdStep(self.cfg, self.opts, self.mesh, edges,
                            domain=domain)
            lists, buffers = step.probe(local)
            ovf = lists | buffers
            if not ovf or n_bumps == MAX_INIT_BUMPS:
                break
            self.opts = raised_slab_capacities(
                self.opts, lists, step.geometry(local), buffers)
            note = f"slab lists: {_capacity_note(ovf, self.opts)}"
            self.init_notes.append(note)
            if self.logs is not None:
                self.logs.log_info(self.step_count, self.time, 0.0,
                                   note=note)
        self.state = dataclasses.replace(
            local, grids=make_spmd_grid_cache(self.device))
        self.spmd_caps = caps
        self.spmd_edges = edges
        self.spmd_domain = domain
        self._spmd_step = step

    def maybe_rebalance(self, threshold: float = 1.3) -> bool:
        """Re-decompose when the per-slab particle counts have drifted from
        balance (the reference's TreeDomainUpdateFrequency analog): the
        ring's largest count above ``threshold`` times the mean. Returns
        True when it re-decomposed. Each rank holds its slab's particles,
        so the counts are the ranks' own, in either frame (the JAX
        package counts by the edges, in the domain's frame in vacuum,
        ``models/simulation.py:430-455``)."""
        if self.mesh is None:
            return False
        n_local = self.state.p.alive.sum().to(torch.int32)
        total = int(self.mesh.psum(n_local))
        largest = int(-self.mesh.pmin(-n_local))
        if largest > threshold * max(1.0, total / self.mesh.size):
            self._decompose()
            return True
        return False

    def canonical_state(self) -> SimState:
        """The state in canonical (gas-first) layout, what every I/O and
        diagnostics consumer expects: the state itself without a ring;
        with one, every rank's chunk gathered and re-laid
        (``spmd_to_canonical``), on every rank (a collective: all ranks
        call it together)."""
        if self.mesh is None or self.spmd_caps is None:
            return self.state
        from gadget_leicester_tpu_torch.parallel.spmd import (
            gather_chunks, spmd_to_canonical)
        return spmd_to_canonical(gather_chunks(self.mesh, self.state),
                                 *self.spmd_caps)

    @property
    def time(self) -> float:
        return timeline.ti_to_time(int(self.state.ti_current), self.cfg)

    def step(self, n: int = 1) -> SimState:
        for _ in range(n):
            if self._spmd_step is not None:
                self.state = self._spmd_step(self.state)
            else:
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

    @property
    def potential_opts(self) -> SimOptions:
        """The options of the full potential of the diagnostics: the run's,
        save that a vacuum ring's potential is the direct sum or the tree
        walk on the gathered state (the single device has no vacuum
        TreePM: ``models/forces.py :: check_supported``)."""
        if self.mesh is None or self.opts.periodic:
            return self.opts
        return dataclasses.replace(self.opts, pmgrid=0, gravity_mode="auto")

    def _sample_cpu(self) -> dict:
        """The sampled device seconds of cpu.txt [G2: run.c CPU_Gravity,
        CPU_Hydro ... buckets], with ``GLT_CPU_DETAIL=1``: each phase run
        alone on the current state, its result dropped, with a device sync
        on both sides; none on a ring (the slab step has no standalone
        phases), as in the reference."""
        if self.mesh is not None or os.environ.get("GLT_CPU_DETAIL") != "1":
            return {}
        probes = [("drift", _probe_drift), ("gravity", _probe_gravity),
                  ("kick", _probe_kick)]
        if self.state.n_gas_max > 1:
            probes.insert(2, ("hydro", _probe_hydro))
        out = {}
        for name, fn in probes:
            _sync(self.device)
            t0 = _time.time()
            fn(self.state, self.cfg, self.opts)
            _sync(self.device)
            out[name] = _time.time() - t0
        return out

    def _empty_grids(self):
        if self.mesh is None:
            return make_grid_cache(self.device)
        from gadget_leicester_tpu_torch.parallel.spmd import \
            make_spmd_grid_cache
        return make_spmd_grid_cache(self.device)

    def _agree(self, flag: bool) -> bool:
        """A host decision every rank takes alike (True where any rank's
        is): the wall-clock tests of a ring."""
        return flag if self.mesh is None else self.mesh.any(flag)

    def write_restart(self) -> None:
        """Dump the state to OutputDir/RestartFile.npz (rank 0, in the
        canonical layout), then empty the grid cache: the run goes on from
        exactly what the dump holds, as a run resumed from it does, so
        without a ring the two continue bit for bit."""
        cfg = self.cfg
        cst = self.canonical_state()
        if self.is_root:
            save_restart(os.path.join(cfg.output_dir,
                                      cfg.restart_file or "restart"),
                         cst, step_count=self.step_count,
                         extra_meta={"snapshot_count": self.snapshot_count})
        self.state = dataclasses.replace(self.state,
                                         grids=self._empty_grids())

    def _bump_capacities(self, ovf: int, t_now: float) -> None:
        """The sticky overflow bits say some cell dropped particles since
        the last reading [G2: gravtree.c realloc on overflow]: raise the
        capacities (:func:`raised_capacities`; on a ring
        ``parallel/spmd.py :: raised_slab_capacities``, which also doubles
        the ghost and migration buffers), clear the bits, rebuild the grid
        cache and note it in info.txt; a ring re-decomposes."""
        if self.mesh is None:
            new_opts = raised_capacities(self.opts, ovf,
                                         self.state.n_gas_max)
        else:
            from gadget_leicester_tpu_torch.parallel.spmd import \
                raised_slab_capacities
            new_opts = raised_slab_capacities(
                self.opts, ovf, self._spmd_step.geometry(self.state))
        self.logs.log_info(self.step_count, t_now, 0.0,
                           note=_capacity_note(ovf, new_opts))
        self.opts = new_opts
        self.state = dataclasses.replace(
            self.state, overflow_flags=torch.zeros_like(
                self.state.overflow_flags),
            grids=self._empty_grids())
        if self.mesh is not None:
            self._decompose()   # a new slab step with the new capacities

    def run(self, max_steps: int = 1000000,
            wall_limit_s: Optional[float] = None) -> SimState:
        """The main loop with the statistics, snapshot and restart cadence
        and the log files [G2: run.c :: run()]."""
        cfg = self.cfg
        if self.logs is None:
            self.logs = RunLogs(cfg) if self.is_root else _NoLogs()
            for note in self.init_notes:
                self.logs.log_info(self.step_count, self.time, 0.0,
                                   note=f"set_ics: {note}")
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
        # the profiler hook: a torch.profiler trace of the sync points
        # [GLT_PROFILE_START, GLT_PROFILE_START + GLT_PROFILE_STEPS) into
        # GLT_PROFILE_DIR (the reference's jax.profiler trace)
        pdir = os.environ.get("GLT_PROFILE_DIR")
        pstart = int(os.environ.get("GLT_PROFILE_START", "2"))
        pn = int(os.environ.get("GLT_PROFILE_STEPS", "2"))
        prof = None

        for _ in range(max_steps):
            if int(self.state.ti_current) >= TIMEBASE:
                break
            if self._agree(_time.time() - wall0 > limit):
                # a planned stop before the queue's limit [G2: run.c
                # TimeLimitCPU, ResubmitOn/ResubmitCommand]
                self.write_restart()
                if cfg.resubmit_on and cfg.resubmit_command and self.is_root:
                    subprocess.Popen(cfg.resubmit_command, shell=True)
                break
            t_before = self.time
            t0 = _time.time()
            if pdir and self.step_count == pstart:
                prof = start_profiler(pdir, self.device)
            elif prof is not None and self.step_count == pstart + pn:
                _sync(self.device)
                prof.stop()
                prof = None
            pm_beg_before = int(self.state.pm_ti_begstep)
            self.step()
            _sync(self.device)
            dt_wall = _time.time() - t0
            phases = {"total": dt_wall}
            was_pm = int(self.state.pm_ti_begstep) != pm_beg_before
            t_now = self.time
            self.logs.log_info(self.step_count, t_now, t_now - t_before)
            n_active = timeline.active_mask(
                self.state.p.ti_begstep, self.state.ti_current,
                self.state.p.alive).sum()
            n_active = int(n_active if self.mesh is None
                           else self.mesh.psum(n_active))
            self.logs.log_timings(self.step_count, n_active, dt_wall,
                                  pm=was_pm)

            if t_now >= self.next_stats_time:
                ovf = int(self.state.overflow_flags)
                if ovf:
                    self._bump_capacities(ovf, t_now)
                # the full potential [G2: potential.c]: the step's p.pot
                # holds only the PM piece. On a ring, rank 0 takes it on the
                # gathered canonical state, and the chunks keep theirs
                tp0 = _time.time()
                cst = self.canonical_state()
                if self.is_root:
                    cst = potential_pass(cst, cfg, self.potential_opts)
                    if self.mesh is None:
                        self.state = cst
                    st = energy_statistics(cst, cfg, self.opts)
                    _sync(self.device)
                    self.logs.log_energy(t_now, st)
                    if cfg.comoving_integration_on:
                        if self.li_tracker is None:
                            self.li_tracker = LayzerIrvineTracker()
                        self.li_drift = self.li_tracker.update(t_now, st)
                phases["potential"] = _time.time() - tp0
                phases.update(self._sample_cpu())
                if self.opts.forcetest > 0 and self.is_root:
                    # the force test [G2: gravity_forcetest()] on the
                    # canonical state, at the statistics cadence
                    write_forcetest_file(run_forcetest(cst, cfg, self.opts),
                                         cst, cfg)
                self.next_stats_time += cfg.time_bet_statistics
                # work balance on the same cadence [G2: domain.c]
                td0 = _time.time()
                if self.maybe_rebalance():
                    phases["domain"] = _time.time() - td0
            if output_times is not None:
                due = (self.snapshot_count < len(output_times)
                       and t_now >= output_times[self.snapshot_count])
            else:
                due = (t_now >= self.next_snapshot_time
                       and cfg.time_bet_snapshot > 0)
            if due:
                ts0 = _time.time()
                cst = self.canonical_state()
                if self.is_root:
                    if self.opts.output_potential:
                        cst = potential_pass(cst, cfg, self.potential_opts)
                        if self.mesh is None:
                            self.state = cst
                    snap = snapshot_from_state(
                        cst, cfg, self.opts,
                        with_potential=self.opts.output_potential)
                    base = os.path.join(
                        cfg.output_dir,
                        f"{cfg.snapshot_file_base}_{self.snapshot_count:03d}")
                    write_snapshot_set(base, snap,
                                       cfg.num_files_per_snapshot,
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
            if self._agree(_time.time() - self.last_restart_wall
                           > cfg.cpu_time_bet_restart_file):
                tr0 = _time.time()
                self.write_restart()
                self.last_restart_wall = _time.time()
                phases["restart"] = _time.time() - tr0
            self.logs.log_cpu(self.step_count, t_now, phases)
        if prof is not None:
            _sync(self.device)
            prof.stop()
        return self.state
