"""The run's diagnostic files, in the reference's formats [G2: begrun.c ::
open_outputfiles(), run.c :: every_timestep_stuff(), global.c ::
energy_statistics(), gravtree.c timings].

Counterpart of ``gadget_leicester_tpu/utils/logfiles.py:25-96``
(``RunLogs``) and :121 (``profile_steps``):

* ``energy.txt``  -- 28 columns: time, Eint, Epot, Ekin, then per type
  (Eint_i, Epot_i, Ekin_i) x 6, then the mass per type x 6;
* ``info.txt``    -- per sync point: step number, time, systemstep;
* ``cpu.txt``     -- per step, the wall-clock seconds of each phase;
* ``timings.txt`` -- per step, the active particles and particles/sec.

:func:`profile_steps` traces sync points with ``torch.profiler`` where
the reference takes a ``jax.profiler`` trace (CPU activity, and the
card's kernels through CUPTI on a CUDA device); ``models/simulation.py``
starts the same profiler for its ``GLT_PROFILE_DIR`` hook
(:func:`start_profiler`). A trace is a ``*.pt.trace.json`` file in the
directory, for TensorBoard's profiler plugin or chrome://tracing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch

from gadget_leicester_tpu_torch.core.config import SimConfig
from gadget_leicester_tpu_torch.utils.diagnostics import EnergyStats


@dataclass
class RunLogs:
    cfg: SimConfig
    outdir: str = ""
    _files: dict = field(default_factory=dict)

    def __post_init__(self):
        self.outdir = self.cfg.output_dir or "."
        os.makedirs(self.outdir, exist_ok=True)

    def _file(self, name):
        if name not in self._files:
            self._files[name] = open(os.path.join(self.outdir, name), "a")
        return self._files[name]

    def close(self):
        for fh in self._files.values():
            fh.close()
        self._files.clear()

    # -- energy.txt [G2: energy_statistics()] ---------------------------
    def log_energy(self, t: float, st: EnergyStats):
        cols = [t, float(st.internal), float(st.potential), float(st.kinetic)]
        for i in range(6):
            cols += [float(st.internal_comp[i]), float(st.potential_comp[i]),
                     float(st.kinetic_comp[i])]
        cols += [float(st.mass_comp[i]) for i in range(6)]
        fh = self._file(self.cfg.energy_file or "energy.txt")
        fh.write(" ".join(f"{c:.10g}" for c in cols) + "\n")
        fh.flush()

    # -- info.txt [G2: every_timestep_stuff()] --------------------------
    def log_info(self, step: int, t: float, systemstep: float,
                 note: str = ""):
        fh = self._file(self.cfg.info_file or "info.txt")
        fh.write(f"\nBegin Step {step}, Time: {t:g}, Systemstep: {systemstep:g}\n")
        if note:
            fh.write(f"  {note}\n")
        fh.flush()

    # -- cpu.txt [G2: run.c CPU_* buckets] -------------------------------
    CPU_COLUMNS = ("total", "gravity", "hydro", "drift", "kick",
                   "potential", "domain", "snapshot", "restart", "misc")

    def log_cpu(self, step: int, t: float, buckets: dict):
        """Per-step wall-clock breakdown with the reference's column set.
        'total' is measured every step; potential/snapshot/restart are the
        host phases of this step. gravity/hydro/drift/kick are sampled at
        the statistics cadence with GLT_CPU_DETAIL=1 (each phase run alone
        on the current state, ``Simulation._sample_cpu``), 0.0 otherwise,
        as in the JAX package, whose "(sampled)" tag the column names
        keep."""
        fh = self._file(self.cfg.cpu_file or "cpu.txt")
        known = {k: buckets.get(k, 0.0) for k in self.CPU_COLUMNS}
        known["misc"] = sum(v for k, v in buckets.items()
                            if k not in self.CPU_COLUMNS)
        fh.write(f"Step {step}, Time: {t:g}, CPUs: 1\n")
        cols = [k + "(sampled)" if k in ("gravity", "hydro", "drift", "kick")
                else k for k in self.CPU_COLUMNS]
        fh.write(" ".join(f"{known[k]:.3f}" for k in self.CPU_COLUMNS)
                 + "   # " + " ".join(cols) + "\n")
        fh.flush()

    # -- timings.txt [G2: gravtree.c FdTimings] -------------------------
    def log_timings(self, step: int, n_active: int, elapsed: float,
                    pm: bool = False):
        fh = self._file(self.cfg.timings_file or "timings.txt")
        pps = n_active / elapsed if elapsed > 0 else 0.0
        tag = "  PM-step" if pm else ""
        fh.write(f"Step= {step}  t= {elapsed:.4f}s  active= {n_active}  "
                 f"part/sec= {pps:.1f}{tag}\n")
        fh.flush()


def start_profiler(trace_dir: str, device) -> "torch.profiler.profile":
    """A started ``torch.profiler`` session that writes its trace into
    ``trace_dir`` when stopped: CPU activity, and CUDA's on a CUDA
    ``device``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(trace_dir))
    prof.start()
    return prof


def profile_steps(sim, n_steps: int = 3, trace_dir: str | None = None) -> str:
    """A ``torch.profiler`` trace of ``n_steps`` sync points of ``sim`` (a
    ``Simulation``), the counterpart of the reference's ``jax.profiler``
    trace of its steps, written into ``trace_dir`` (by default ``trace``
    in the run's OutputDir). Returns the directory."""
    if trace_dir is None:
        trace_dir = os.path.join(sim.cfg.output_dir or ".", "trace")
    prof = start_profiler(trace_dir, sim.device)
    try:
        sim.step(n_steps)
        if sim.device.type == "cuda":
            torch.cuda.synchronize(sim.device)
    finally:
        prof.stop()
    return trace_dir
