#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, the CUDA toolkit (``nvcc``) and this checkout; it
imports nothing of JAX. Phases, each printing its own lines:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile the seven kernels of ``gadget_leicester_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once);
3. kernels: the arguments the path gives each dense kernel's wrapper (A-D)
   while it initialises a small lcdm_gas box, replayed through the kernel
   and its plain PyTorch version, in float32 and in float64 (all tiles,
   and every other tile gated off), within the bound stated at ``TOL``;
4. slice: 2 sync points of the small box on the card against the same on
   the CPU (the plain versions), by the bounds of tests/test_torch_slice;
   then, from the state after 1 of them, a near-idle sync point
   (:func:`make_near_idle`) on the card against the CPU, through the
   active-entry kernels E-G, whose arguments are replayed as in phase 3
   (all entries, and every other entry switched off);
5. main path: lcdm_gas 2x128^3 with pmgrid = auto_pmgrid(2 * 128^3),
   ``Simulation(..., device="cuda")``, ``set_ics`` and 6 steps, with the
   kernels' launch counts of that run;
6. kernels at the main path's shapes: the arguments each wrapper got last
   in phase 5, replayed as in phase 3, and each kernel's time beside its
   plain version's;
7. profile: the phases of 4 more sync points, each timed with a device
   sync around it, then the device's busy and idle time over 2 more from
   ``torch.profiler``;
8. near-idle at full width: from the state phase 5 left, a sync point at
   which 1% of the particles are active, once through the entries tier
   (E, F, G and not A, C, D) and once with the tier forced dense (A, C, D
   and not E, F, G), the two held to each other; each timed 3 times and
   once by phases; E, F and G replayed on the arguments of the entries
   run, with their times beside their plain versions'.

Any failure raises, so the exit code is not 0. The line before the last
is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

N_SIDE_SMALL = 16        # phases 3 and 4
N_SIDE_MAIN = 128        # phases 5 to 8
MAIN_STEPS = 6
SLICE_STEPS = 2
PROFILE_STEPS = 4
# near-idle sync points (phases 4 and 8): the active share, uniform over
# the alive particles; the small box's is as low as keeps one active gas
# particle in most SPH blocks while the entries still fit
IDLE_FRAC_SMALL = 0.03
IDLE_FRAC_MAIN = 0.01
IDLE_SEED = 7
IDLE_REPS = 3
# kernel vs plain version on the same inputs, per output row: the kernel's
# distance from the plain version evaluated in float64 is at most TOL of
# the row's largest value, or F32_FACTOR times the float32 plain version's
# own distance from it, whichever is larger. The kernels sum float32 in
# another order (B's atomics in one that changes from run to run); where
# float32 cancels (gravity in a near-uniform box: the net short-range force
# is far below its pair terms) both float32 sums stray from the float64
# one by more than TOL, by the same amount. A fault is O(1).
TOL = {"shortrange_gravity": 1e-4, "pm_deposit": 1e-5,
       "sph_density": 1e-4, "sph_hydro": 1e-4,
       "shortrange_gravity_entries": 1e-4, "sph_density_entries": 1e-4,
       "sph_hydro_entries": 1e-4}
F32_FACTOR = 4.0

DENSE = ("shortrange_gravity", "pm_deposit", "sph_density", "sph_hydro")
ENTRIES = ("shortrange_gravity_entries", "sph_density_entries",
           "sph_hydro_entries")
KERNELS = {
    "shortrange_gravity": (
        "gadget_leicester_tpu_torch/csrc/shortrange_gravity.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:669"),
    "pm_deposit": ("gadget_leicester_tpu_torch/csrc/pm_deposit.cu",
                   "gadget_leicester_tpu/ops/pm_tiles.py:419"),
    "sph_density": ("gadget_leicester_tpu_torch/csrc/sph_density.cu",
                    "gadget_leicester_tpu/ops/sph_blocks.py:397"),
    "sph_hydro": ("gadget_leicester_tpu_torch/csrc/sph_hydro.cu",
                  "gadget_leicester_tpu/ops/sph_blocks.py:630"),
    "shortrange_gravity_entries": (
        "gadget_leicester_tpu_torch/csrc/shortrange_gravity_entries.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:973"),
    "sph_density_entries": (
        "gadget_leicester_tpu_torch/csrc/sph_density_entries.cu",
        "gadget_leicester_tpu/ops/sph_blocks.py:1125"),
    "sph_hydro_entries": (
        "gadget_leicester_tpu_torch/csrc/sph_hydro_entries.cu",
        "gadget_leicester_tpu/ops/sph_blocks.py:1175"),
}
# where the tile flags or entry ids sit among each wrapper's arguments (B
# has none)
FLAGS_ARG = {"shortrange_gravity": 1, "sph_density": 3, "sph_hydro": 5,
             "shortrange_gravity_entries": 1, "sph_density_entries": 3,
             "sph_hydro_entries": 4}
PARAMS_ARG = 6           # kernel D's (hubble_a2_flow, fac_mu)

_PKG = "gadget_leicester_tpu_torch"
# phase 7: the functions a sync point spends its time in, each timed with
# a device sync on both sides; (module, attribute, label), the label
# indented under the phase that calls it
TIMED = (
    (f"{_PKG}.models.integrate", "drift_all", "drift"),
    (f"{_PKG}.models.forces", "_treepm_gravity", "gravity"),
    (f"{_PKG}.models.forces", "pack_cells_soa", "  SR pack"),
    (f"{_PKG}.models.forces", "count_active_entries", "  SR tier count"),
    (f"{_PKG}.models.forces", "grav_tile_flags", "  SR flags"),
    (f"{_PKG}.models.forces", "shortrange_gravity_tiles", "  kernel A"),
    (f"{_PKG}.models.forces", "merge_rows", "  SR merge"),
    (f"{_PKG}.models.forces", "gravity_entries", "  SR entries"),
    (f"{_PKG}.ops.cells", "shortrange_gravity_entries", "    kernel E"),
    (f"{_PKG}.models.forces", "pm_deposit_tiles", "  kernel B"),
    (f"{_PKG}.models.forces", "pm_forces_periodic", "  PM FFT + gather"),
    (f"{_PKG}.models.forces", "compute_sph", "SPH"),
    (f"{_PKG}.models.forces", "count_block_entries", "  SPH tier count"),
    (f"{_PKG}.models.forces", "density_adaptive_blocks", "  density"),
    (f"{_PKG}.ops.sph_blocks", "density_sums_blocks", "    kernel C"),
    (f"{_PKG}.models.forces", "density_adaptive_blocks_entries",
     "  density entries"),
    (f"{_PKG}.ops.sph_blocks", "density_sums_blocks_entries", "    kernel F"),
    (f"{_PKG}.models.forces", "hydro_force_blocks", "  hydro"),
    (f"{_PKG}.ops.sph_blocks", "hydro_sums_blocks", "    kernel D"),
    (f"{_PKG}.models.forces", "hydro_force_blocks_entries",
     "  hydro entries"),
    (f"{_PKG}.ops.sph_blocks", "hydro_sums_blocks_entries", "    kernel G"),
    (f"{_PKG}.models.forces", "build_active_entries",
     "entry lists (gravity + SPH)"),
    (f"{_PKG}.models.integrate", "advance_and_find_timesteps", "advance"),
    (f"{_PKG}.models.integrate", "pm_step_update", "PM step update"),
)


def param_text(n_side: int, box: float = 50000.0) -> str:
    """bench.py's lcdm_gas parameter text (bench.py:95-120)."""
    soft = f"{box / n_side / 30:.3f}"
    return f"""
InitCondFile x
OutputDir  /tmp/bench_out
TimeBegin  0.090909
TimeMax    1.0
ComovingIntegrationOn 1
PeriodicBoundariesOn 1
BoxSize    {box}
Omega0     0.3
OmegaLambda 0.7
OmegaBaryon 0.04
HubbleParam 0.7
ErrTolIntAccuracy 0.025
MaxSizeTimestep 0.025
CourantFac 0.15
DesNumNgb 33
MaxNumNgbDeviation 2
ArtBulkViscConst 0.8
InitGasTemp 1000
MinGasTemp 5
SofteningGas  {soft}
SofteningHalo {soft}
SofteningGasMaxPhys  {soft}
SofteningHaloMaxPhys {soft}
MinGasHsmlFractional 0.1
"""


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def setup(n_side: int):
    """cfg, opts and IC arrays of the lcdm_gas box at ``n_side``."""
    from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                        auto_pmgrid,
                                                        parse_parameter_text)
    from gadget_leicester_tpu_torch.models.ics import lcdm_gas_ics
    cfg = parse_parameter_text(param_text(n_side))
    opts = SimOptions(periodic=True, pmgrid=auto_pmgrid(2 * n_side ** 3),
                      gravity_mode="treepm", sph_backend="blocks")
    ics = lcdm_gas_ics(n_side=n_side, box=cfg.box_size, omega0=0.3,
                       omega_b=0.04, hubble=cfg.hubble_internal,
                       g=cfg.grav_internal)
    return cfg, opts, ics


@contextlib.contextmanager
def recorded_inputs():
    """Within the body, each kernel wrapper's last arguments are kept in
    the dict this yields."""
    from gadget_leicester_tpu_torch import kernels
    kernels.recorded.clear()
    kernels.recording = True
    try:
        yield kernels.recorded
    finally:
        kernels.recording = False


def record_init(n_side: int, device) -> dict:
    """The arguments the path gives each kernel wrapper while ``set_ics``
    initialises the lcdm_gas box at ``n_side`` (two full force passes,
    the first a PM step)."""
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg, opts, ics = setup(n_side)
    pos, vel, mass, ptype, u = ics
    with recorded_inputs() as rec:
        Simulation(cfg, opts, device).set_ics(pos, vel, mass, ptype, u=u)
    return dict(rec)


def kernel_pairs() -> dict:
    """{kernel: (wrapper, plain version)}; both take the wrapper's
    arguments."""
    from gadget_leicester_tpu_torch.ops import cells, gravity_short, pm_tiles
    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    return {
        "shortrange_gravity": (cells.shortrange_gravity_tiles,
                               gravity_short.shortrange_gravity_tiles_plain),
        "pm_deposit": (pm_tiles.pm_deposit_tiles,
                       pm_tiles.pm_deposit_tiles_plain),
        "sph_density": (sb.density_sums_blocks, sb.density_sums_blocks_plain),
        "sph_hydro": (sb.hydro_sums_blocks, sb.hydro_sums_blocks_plain),
        "shortrange_gravity_entries": (
            cells.shortrange_gravity_entries,
            gravity_short.shortrange_gravity_entries_plain),
        "sph_density_entries": (sb.density_sums_blocks_entries,
                                sb.density_sums_blocks_entries_plain),
        "sph_hydro_entries": (sb.hydro_sums_blocks_entries,
                              sb.hydro_sums_blocks_entries_plain),
    }


def cases(name: str, recorded: dict) -> list:
    """(label, arguments) of each comparison on the arguments
    ``recorded[name]``: every tile on, every other tile gated off, and for
    kernel D also the gated case without the Hubble-flow term; for E, F
    and G, all entries and every other entry switched off (-1). B has no
    tile flags: one case."""
    import torch
    args = recorded[name]
    i = FLAGS_ARG.get(name)
    if i is None:
        return [("all tiles", args)]
    if name in ENTRIES:
        ids = args[i]
        if name == "sph_density_entries":
            # F's last call may be a later Newton sweep, which switched off
            # the entries whose lanes had converged; one entry list serves
            # density and hydro, so G's is the whole list
            ids = recorded["sph_hydro_entries"][FLAGS_ARG["sph_hydro_entries"]]
        off = ids.clone()
        off[1::2] = -1
        return [(label, args[:i] + (e,) + args[i + 1:])
                for label, e in (("all entries", ids),
                                 ("every other entry off", off))]
    out = []
    for label in ("all tiles", "gated"):
        flags = torch.ones_like(args[i])
        if label == "gated":
            flags[1::2] = 0
        out.append((label, args[:i] + (flags,) + args[i + 1:]))
    if name == "sph_hydro":
        gated = out[1][1]
        params = gated[PARAMS_ARG].clone()
        params[0] = 0.0
        out.append(("gated, no Hubble flow", gated[:PARAMS_ARG] + (params,)
                    + gated[PARAMS_ARG + 1:]))
    return out


def as_float64(args: tuple) -> tuple:
    """The arguments with every floating-point tensor in float64."""
    import torch
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def compare(name: str, got, want, exact):
    """Hold kernel output ``got`` to the bound above, ``want`` being the
    plain version's output and ``exact`` the plain version's in float64.
    Per row along dim 1 (an output row of a tile kernel, a y-plane of the
    PM mesh). Returns (max |got - want|, and for the row nearest its
    bound: the kernel's and the float32 plain version's distance from
    ``exact`` relative to the row's largest |exact|, and the share of the
    bound used)."""
    import torch
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output not finite")
    worst = (0.0, 0.0, 0.0)
    for r in range(got.shape[1]):
        ex = exact[:, r]
        scale = float(ex.abs().max()) or 1.0
        k = float((got[:, r].double() - ex).abs().max()) / scale
        p = float((want[:, r].double() - ex).abs().max()) / scale
        used = k / max(TOL[name], F32_FACTOR * p)
        if used >= worst[2]:
            worst = (k, p, used)
    return (float((got - want).abs().max()),) + worst


def time_ms(fn, reps: int):
    """(mean ms per call over ``reps`` calls after one warm-up, the last
    call's output), by CUDA events."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def check_kernels(recorded: dict, where: str, results: dict, names,
                  timed: bool = False) -> None:
    """Each kernel of ``names`` against its plain version on the arguments
    the path gave its wrapper (``recorded``), in every case of
    :func:`cases`, by :func:`compare`; with ``timed``, each one's time
    beside its plain version's in the first case (all tiles or
    entries)."""
    pairs = kernel_pairs()
    for name in names:
        if name not in recorded:
            raise AssertionError(f"the path never called kernel {name}")
        kern, plain = pairs[name]
        r = results.setdefault(name, {})
        r.setdefault("max_abs_err", 0.0)
        for n, (case, args) in enumerate(cases(name, recorded)):
            if timed and n == 0:
                r["ms"], got = time_ms(lambda: kern(*args), reps=5)
                r["plain_ms"], want = time_ms(lambda: plain(*args), reps=1)
            else:
                got, want = kern(*args), plain(*args)
            abs_err, k, p, used = compare(name, got, want,
                                          plain(*as_float64(args)))
            ok = used <= 1.0
            say("kernels", f"{name} {where} {case}: max_abs_err {abs_err:.3e};"
                f" from float64: kernel {k:.2e}, plain float32 {p:.2e} of the "
                f"largest value (limit max({TOL[name]:.0e}, {F32_FACTOR:g} x "
                f"plain float32)) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version ({where}, {case})")
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        if timed:
            say("kernels", f"{name} {where}: kernel {r['ms']:.3f} ms, plain "
                f"{r['plain_ms']:.3f} ms")


def phase_kernels(results: dict, device="cuda", n_small=N_SIDE_SMALL):
    check_kernels(record_init(n_small, device), f"n_side={n_small}", results,
                  DENSE)


def report_close(phase: str, what: str, res: dict) -> None:
    """One line on an :func:`assert_states_close` result."""
    from gadget_leicester_tpu_torch.core.state import CLOSE_TOL, MAX_EXCLUDED
    worst = max(res, key=lambda f: res[f][0])
    say(phase, f"{what}: timeline fields equal; worst {worst} "
        f"{res[worst][0]:.2e} of its largest value, "
        f"{sum(n for _, n in res.values())} rows beyond {CLOSE_TOL} (at "
        f"most {MAX_EXCLUDED} per field)")


def phase_slice(device="cuda", n_small=N_SIDE_SMALL):
    """Returns the card's state after 1 sync point."""
    from gadget_leicester_tpu_torch.core.state import (assert_states_close,
                                                       to_numpy)
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg, opts, ics = setup(n_small)
    pos, vel, mass, ptype, u = ics
    runs = {}
    for dev in (device, "cpu"):
        sim = Simulation(cfg, opts, dev)
        sim.set_ics(pos, vel, mass, ptype, u=u)
        runs[dev] = [to_numpy(sim.state)]
        for _ in range(SLICE_STEPS):
            sim.step()
            if dev == device and len(runs[dev]) == 1:
                after_one = sim.state
            runs[dev].append(to_numpy(sim.state))
    for i, (g, c) in enumerate(zip(runs[device], runs["cpu"])):
        report_close("slice", f"after {i} steps, ti_current "
                     f"{int(g['ti_current'])}", assert_states_close(g, c))
    return after_one


def make_near_idle(state, frac: float, seed: int):
    """The same state, with the steps of a seeded uniform ``frac`` of the
    alive particles halved, so that the next sync point activates them
    alone and is not a PM step.

    ``state`` must sit at a sync point at which every alive particle has
    just begun a new step (ti_begstep == ti_current), as after the ICs'
    first sync points. Each chosen particle's step, a power of two of at
    least 2 ticks that ti_begstep is a multiple of, becomes its lower half:
    ti_endstep = ti_begstep + (ti_endstep - ti_begstep) // 2, itself an
    aligned power-of-two bin. The chosen particles took their opening
    half-kick with the old step, so their next closing kick is off by a
    quarter of it: the state is a start for comparing two runs of the same
    sync point (card and CPU, entries and dense tier, port and JAX), not
    a continuation of the run. Raises ``AssertionError`` where the state
    does not allow it."""
    import dataclasses

    import numpy as np
    import torch
    p = state.p
    alive = p.alive.cpu().numpy()
    beg = p.ti_begstep.cpu().numpy().astype(np.int64)
    end = p.ti_endstep.cpu().numpy().astype(np.int64)
    ti_now = int(state.ti_current)
    if not (beg[alive] == ti_now).all():
        raise AssertionError("not every alive particle has just begun a "
                             "new step")
    idx = np.flatnonzero(alive)
    rng = np.random.default_rng(seed)
    pick = rng.choice(idx, size=max(1, round(frac * idx.size)),
                      replace=False)
    step = end[pick] - beg[pick]
    if (step < 2).any() or (step & (step - 1)).any() or \
            (beg[pick] % step).any():
        raise AssertionError("a chosen step is not an aligned power of two "
                             "of at least 2 ticks")
    end[pick] = beg[pick] + step // 2
    ti_next = end[alive].min()
    chosen = np.zeros(alive.shape, bool)
    chosen[pick] = True
    if not np.array_equal((end == ti_next) & alive, chosen):
        raise AssertionError("the next sync point would not activate the "
                             "chosen particles alone")
    if not int(state.pm_ti_endstep) > ti_next:
        raise AssertionError("the next sync point would be a PM step")
    ti_endstep = torch.from_numpy(end.astype(np.int32)).to(
        p.ti_endstep.device)
    return dataclasses.replace(state, p=dataclasses.replace(
        p, ti_endstep=ti_endstep))


@contextlib.contextmanager
def tier(force=None):
    """Within the body, each tier decision of models/forces.py
    (``use_entries``) is logged as (n_active, n_entries, k_max, entries
    taken) in the list this yields; n_entries is None where the rule did
    not count them. ``force`` (True or False) overrides the decision after
    the rule has run, so the counting work is the rule's own."""
    from gadget_leicester_tpu_torch.models import forces
    real = forces.use_entries
    log = []

    def spy(n_active, count_entries, k_max):
        counted = []

        def count():
            n = count_entries()
            counted.append(int(n))
            return n
        took = real(n_active, count, k_max)
        if force is not None:
            took = force
        log.append((int(n_active), counted[0] if counted else None, k_max,
                    took))
        return took

    forces.use_entries = spy
    try:
        yield log
    finally:
        forces.use_entries = real


def say_tiers(phase: str, log: list) -> None:
    for (n_act, n_ent, k_max, took), what in zip(log, ("gravity", "SPH")):
        ent = "entries not counted" if n_ent is None else f"{n_ent} entries"
        say(phase, f"{what}: {n_act} active, {ent}, k_max {k_max}"
            f" -> {'entries' if took else 'dense'} tier")


def check_tier_launches(counts: dict, entries: bool) -> None:
    """A near-idle sync point (no PM step) launched E, F and G and none
    of A-D (``entries``), or A, C and D and none of B, E, F, G."""
    used = set(ENTRIES) if entries else set(DENSE) - {"pm_deposit"}
    for name, n in counts.items():
        if (n > 0) != (name in used):
            raise AssertionError(f"kernel {name} launched {n} times in a "
                                 f"{'entries' if entries else 'dense'}-tier "
                                 f"sync point")


def phase_idle_small(results: dict, after_one, device="cuda",
                     n_small=N_SIDE_SMALL) -> None:
    """A near-idle sync point of the small box on the card against the
    CPU, both from one near-idle state built from the card's state after
    one sync point, and E, F and G against their plain versions on its
    arguments."""
    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.core.state import (assert_states_close,
                                                       from_numpy, to_numpy)
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg, opts, _ = setup(n_small)
    idle = to_numpy(make_near_idle(after_one, IDLE_FRAC_SMALL,
                                   IDLE_SEED))
    runs = {}
    for dev in (device, "cpu"):
        sim = Simulation(cfg, opts, dev)
        sim.state = from_numpy(idle, dev)
        with recorded_inputs() as rec, tier() as log:
            kernels.reset_launches()
            sim.step()
            counts = dict(kernels.launches)
        if dev == device:
            recorded = dict(rec)
            say_tiers("idle", log)
            say("idle", f"2x{n_small}^3 near-idle launches {counts}")
            check_tier_launches(counts, entries=True)
        runs[dev] = to_numpy(sim.state)
    report_close("idle", f"2x{n_small}^3 near-idle sync point, card vs CPU",
                 assert_states_close(runs[device], runs["cpu"]))
    check_kernels(recorded, f"2x{n_small}^3 near-idle", results, ENTRIES)


def phase_main(results: dict, card: str, device="cuda",
               n_side=N_SIDE_MAIN):
    """Returns the simulation and the arguments each kernel wrapper got
    last."""
    import dataclasses

    import torch

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.core import timeline
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg, opts, ics = setup(n_side)
    # bench.py's options: sph_backend "auto" resolves to blocks at 2x128^3
    opts = dataclasses.replace(opts, sph_backend="auto")
    pos, vel, mass, ptype, u = ics
    sim = Simulation(cfg, opts, device)
    step_s, updates = [], 0
    with recorded_inputs() as rec:
        kernels.reset_launches()
        t0 = time.time()
        sim.set_ics(pos, vel, mass, ptype, u=u)
        sync(device)
        init_s = time.time() - t0
        for _ in range(MAIN_STEPS):
            st = sim.state
            ti_next = timeline.min_active_ti_end(st.p.ti_endstep, st.p.alive)
            ti_next = torch.minimum(ti_next, st.pm_ti_endstep)
            updates += int(timeline.active_mask(st.p.ti_endstep, ti_next,
                                                st.p.alive).sum())
            t0 = time.time()
            sim.step()
            sync(device)
            step_s.append(time.time() - t0)
        counts = dict(kernels.launches)
    recorded = dict(rec)
    st = sim.state
    say("main", f"pmgrid {opts.pmgrid}, {st.n_max} slots, init {init_s:.3f} s"
        f" ({card})")
    say("main", "per-step seconds " + ", ".join(f"{s:.3f}" for s in step_s)
        + f" ({card})")
    say("main", f"{updates} particle updates in {sum(step_s):.3f} s: "
        f"{updates / sum(step_s):.1f} updates/s ({card})")
    say("main", f"Newton sweeps per density pass: "
        f"{sim.stats.get('density_iters')}")
    say("main", f"launches {counts}; ti_current {int(st.ti_current)}, "
        f"overflow_flags {int(st.overflow_flags)}")
    for name, t in (("p.pos", st.p.pos), ("p.vel", st.p.vel),
                    ("p.acc", st.p.acc), ("p.acc_pm", st.p.acc_pm),
                    ("gas.density", st.gas.density),
                    ("gas.hsml", st.gas.hsml),
                    ("gas.entropy", st.gas.entropy)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} is not finite")
    if int(st.overflow_flags) != 0:
        raise AssertionError(f"overflow_flags {int(st.overflow_flags)}")
    if int(st.ti_current) <= 0:
        raise AssertionError("ti_current did not advance")
    # every sync point from the ICs is full-active: the dense tier
    for name in DENSE:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
        results.setdefault(name, {})["launches"] = counts[name]
    for name in ENTRIES:
        if counts[name] != 0:
            raise AssertionError(f"kernel {name} was launched on the "
                                 "full-active main path")
    return sim, recorded


@contextlib.contextmanager
def phase_timer(device="cuda"):
    """Within the body, each function of TIMED runs with a device sync on
    both sides and adds its seconds and calls to the dict this yields
    (label -> [seconds, calls]; nested phases add their syncs to their
    parents')."""
    import importlib
    totals = {label: [0.0, 0] for _, _, label in TIMED}

    def timed(label, fn):
        def run(*args, **kwargs):
            sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(device)
            totals[label][0] += time.perf_counter() - t0
            totals[label][1] += 1
            return out
        return run

    saved = []
    for mod_name, attr, label in TIMED:
        mod = importlib.import_module(mod_name)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, timed(label, getattr(mod, attr)))
    try:
        yield totals
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def say_phases(phase: str, totals: dict, steps: int) -> None:
    """The phases that ran, in ms per step."""
    for _, _, label in TIMED:
        s, n = totals[label]
        if n:
            say(phase, f"  {label:<28s} {1e3 * s / steps:9.3f} ms/step "
                f"({n} calls)")


def phase_profile(sim, card: str, device="cuda",
                  steps=PROFILE_STEPS) -> None:
    """Per-phase times of ``steps`` sync points (:func:`phase_timer`);
    then the device's busy and idle time over 2 more sync points under
    torch.profiler, kernel rows only."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with phase_timer(device) as totals:
        sync(device)
        t0 = time.perf_counter()
        sim.step(steps)
        sync(device)
        wall = time.perf_counter() - t0
    say("profile", f"{steps} sync points, a device sync around each phase: "
        f"{1e3 * wall / steps:.3f} ms/step ({card})")
    say_phases("profile", totals, steps)

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        sim.step(2)
        sync(device)
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    by_name: dict = {}
    for e in sorted(dev_events, key=lambda e: e.time_range.start):
        s, f = e.time_range.start, e.time_range.end
        if f > end:
            busy += f - max(s, end)
            end = f
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + f - s, n + 1)
    if not dev_events:
        say("profile", "the profiler saw no device activity: idle share "
            "not measured")
        return
    busy *= 1e-6
    say("profile", f"2 sync points under torch.profiler: device busy "
        f"{1e3 * busy:.3f} ms of {1e3 * wall:.3f} ms wall, idle "
        f"{100 * (1 - busy / wall):.1f}% ({card})")
    total = sum(t for t, _ in by_name.values())
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        say("profile", f"  {t * 1e-3:9.3f} ms {100 * t / total:5.1f}% x{n:4d}"
            f"  {name[:90]}")


def phase_idle_main(results: dict, state, card: str, device="cuda",
                    n_side=N_SIDE_MAIN) -> None:
    """A near-idle sync point at full width from ``state``: (a) through
    the tier the rule picks, which must be the entries tier, (b) with the
    tier forced dense; (a) and (b) held to each other, timed, and E, F and
    G replayed on (a)'s arguments."""
    import dataclasses

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.core.state import (assert_states_close,
                                                       to_numpy)
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg, opts, _ = setup(n_side)
    opts = dataclasses.replace(opts, sph_backend="auto")
    idle = make_near_idle(state, IDLE_FRAC_MAIN, IDLE_SEED)
    sim = Simulation(cfg, opts, device)

    def run(force):
        """One sync point from a clone of ``idle``: (state, launches,
        tier log, seconds)."""
        sim.state = copy.deepcopy(idle)
        with tier(force) as log:
            kernels.reset_launches()
            sync(device)
            t0 = time.perf_counter()
            sim.step()
            sync(device)
            dt = time.perf_counter() - t0
            counts = dict(kernels.launches)
        return sim.state, counts, log, dt

    with recorded_inputs() as rec:
        st_a, counts_a, log_a, _ = run(None)
    recorded = dict(rec)
    say_tiers("idle", log_a)
    say("idle", f"2x{n_side}^3 entries tier launches {counts_a}")
    check_tier_launches(counts_a, entries=True)
    for name in ENTRIES:
        results.setdefault(name, {})["launches"] = counts_a[name]
    st_b, counts_b, log_b, _ = run(False)
    say("idle", f"2x{n_side}^3 dense tier launches {counts_b}")
    check_tier_launches(counts_b, entries=False)
    report_close("idle", f"2x{n_side}^3 near-idle sync point, entries vs "
                 "dense tier", assert_states_close(to_numpy(st_a),
                                                   to_numpy(st_b)))
    del st_a, st_b
    times = {"entries": [], "dense": []}
    for _ in range(IDLE_REPS):
        for label, force in (("entries", None), ("dense", False)):
            times[label].append(run(force)[3])
    for label, ts in times.items():
        say("idle", f"{label} tier: " + ", ".join(f"{1e3 * t:.3f}"
                                                 for t in ts)
            + f" ms per near-idle sync point ({card})")
    for label, force in (("entries", None), ("dense", False)):
        with phase_timer(device) as totals:
            run(force)
        say("idle", f"{label} tier, a device sync around each phase:")
        say_phases("idle", totals, 1)
    check_kernels(recorded, f"2x{n_side}^3 near-idle", results, ENTRIES,
                  timed=True)


def sync(device) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; it runs only on the "
                         "card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from gadget_leicester_tpu_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = smi
    say("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernels.library()
    say("build", f"nvcc build {kernels.build_info['seconds']:.1f} s -> "
        f"{kernels.build_info['path']}")
    for line in kernels.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("build", line.strip())

    results: dict = {}
    phase_kernels(results)
    phase_idle_small(results, phase_slice())
    sim, recorded = phase_main(results, card)
    main_state = sim.state
    check_kernels(recorded, f"2x{N_SIDE_MAIN}^3", results, DENSE, timed=True)
    del recorded
    kernels.recorded.clear()
    phase_profile(sim, card)
    del sim
    phase_idle_main(results, main_state, card)

    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": results[name]["launches"],
             "max_abs_err": results[name]["max_abs_err"],
             "ms": results[name]["ms"],
             "plain_ms": results[name]["plain_ms"]}
            for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
