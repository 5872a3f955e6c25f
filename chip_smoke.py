#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, the CUDA toolkit (``nvcc``) and this checkout; it
imports nothing of JAX. Phases, each printing its own lines:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile the four kernels of ``gadget_leicester_tpu_torch/csrc``;
3. kernels: the arguments the path gives each kernel's wrapper while it
   initialises a small lcdm_gas box, replayed through the kernel and its
   plain PyTorch version, in float32 and in float64 (all tiles, and every
   other tile gated off), within the bound stated at ``TOL``;
4. slice: 2 sync points of the small box on the card against the same on
   the CPU (the plain versions), by the bounds of tests/test_torch_slice;
5. main path: lcdm_gas 2x128^3 with pmgrid = auto_pmgrid(2 * 128^3),
   ``Simulation(..., device="cuda")``, ``set_ics`` and 6 steps, with the
   kernels' launch counts of that run;
6. kernels at the main path's shapes: the arguments each wrapper got last
   in phase 5, replayed as in phase 3, and each kernel's time beside its
   plain version's;
7. profile: the phases of 4 more sync points, each timed with a device
   sync around it, then the device's busy and idle time over 2 more from
   ``torch.profiler``.

Any failure raises, so the exit code is not 0. The line before the last
is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

N_SIDE_SMALL = 16        # phases 3 and 4
N_SIDE_MAIN = 128        # phases 5 and 6
MAIN_STEPS = 6
SLICE_STEPS = 2
PROFILE_STEPS = 4
# kernel vs plain version on the same inputs, per output row: the kernel's
# distance from the plain version evaluated in float64 is at most TOL of
# the row's largest value, or F32_FACTOR times the float32 plain version's
# own distance from it, whichever is larger. The kernels sum float32 in
# another order (B's atomics in one that changes from run to run); where
# float32 cancels (gravity in a near-uniform box: the net short-range force
# is far below its pair terms) both float32 sums stray from the float64
# one by more than TOL, by the same amount. A fault is O(1).
TOL = {"shortrange_gravity": 1e-4, "pm_deposit": 1e-5,
       "sph_density": 1e-4, "sph_hydro": 1e-4}
F32_FACTOR = 4.0

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
}
# where the tile flags sit among each wrapper's arguments (B has none)
FLAGS_ARG = {"shortrange_gravity": 1, "sph_density": 3, "sph_hydro": 5}
PARAMS_ARG = 6           # kernel D's (hubble_a2_flow, fac_mu)

_PKG = "gadget_leicester_tpu_torch"
# phase 7: the functions a sync point spends its time in, each timed with
# a device sync on both sides; (module, attribute, label), the label
# indented under the phase that calls it
TIMED = (
    (f"{_PKG}.models.integrate", "drift_all", "drift"),
    (f"{_PKG}.models.forces", "_treepm_gravity", "gravity"),
    (f"{_PKG}.models.forces", "pack_cells_soa", "  SR pack"),
    (f"{_PKG}.models.forces", "grav_tile_flags", "  SR flags"),
    (f"{_PKG}.models.forces", "shortrange_gravity_tiles", "  kernel A"),
    (f"{_PKG}.models.forces", "merge_rows", "  SR merge"),
    (f"{_PKG}.models.forces", "pm_deposit_tiles", "  kernel B"),
    (f"{_PKG}.models.forces", "pm_forces_periodic", "  PM FFT + gather"),
    (f"{_PKG}.models.forces", "compute_sph", "SPH"),
    (f"{_PKG}.models.forces", "density_adaptive_blocks", "  density"),
    (f"{_PKG}.ops.sph_blocks", "density_sums_blocks", "    kernel C"),
    (f"{_PKG}.models.forces", "hydro_force_blocks", "  hydro"),
    (f"{_PKG}.ops.sph_blocks", "hydro_sums_blocks", "    kernel D"),
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
    from gadget_leicester_tpu_torch.ops.cells import shortrange_gravity_tiles
    from gadget_leicester_tpu_torch.ops.gravity_short import \
        shortrange_gravity_tiles_plain
    from gadget_leicester_tpu_torch.ops.pm_tiles import (
        pm_deposit_tiles, pm_deposit_tiles_plain)
    from gadget_leicester_tpu_torch.ops.sph_blocks import (
        density_sums_blocks, density_sums_blocks_plain, hydro_sums_blocks,
        hydro_sums_blocks_plain)
    return {
        "shortrange_gravity": (shortrange_gravity_tiles,
                               shortrange_gravity_tiles_plain),
        "pm_deposit": (pm_deposit_tiles, pm_deposit_tiles_plain),
        "sph_density": (density_sums_blocks, density_sums_blocks_plain),
        "sph_hydro": (hydro_sums_blocks, hydro_sums_blocks_plain),
    }


def cases(name: str, args: tuple) -> list:
    """(label, arguments) of each comparison: every tile on, every other
    tile gated off, and for kernel D also the gated case without the
    Hubble-flow term. B has no tile flags: one case."""
    import torch
    i = FLAGS_ARG.get(name)
    if i is None:
        return [("all tiles", args)]
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


def check_kernels(recorded: dict, where: str, results: dict,
                  timed: bool = False) -> None:
    """Each kernel against its plain version on the arguments the path
    gave its wrapper (``recorded``), in every case of :func:`cases`, by
    :func:`compare`; with ``timed``, each one's time beside its plain
    version's on all tiles."""
    pairs = kernel_pairs()
    for name in KERNELS:
        if name not in recorded:
            raise AssertionError(f"the path never called kernel {name}")
        kern, plain = pairs[name]
        r = results.setdefault(name, {})
        r.setdefault("max_abs_err", 0.0)
        for case, args in cases(name, recorded[name]):
            if timed and case == "all tiles":
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
    check_kernels(record_init(n_small, device), f"n_side={n_small}", results)


def phase_slice(device="cuda", n_small=N_SIDE_SMALL) -> None:
    from gadget_leicester_tpu_torch.core.state import (CLOSE_TOL,
                                                       MAX_EXCLUDED,
                                                       assert_states_close,
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
            runs[dev].append(to_numpy(sim.state))
    for i, (g, c) in enumerate(zip(runs[device], runs["cpu"])):
        res = assert_states_close(g, c)
        worst = max(res, key=lambda f: res[f][0])
        say("slice", f"after {i} steps: ti_current {int(g['ti_current'])}, "
            f"timeline fields equal; worst {worst} {res[worst][0]:.2e} of its"
            f" largest value, {sum(n for _, n in res.values())} rows beyond "
            f"{CLOSE_TOL} (at most {MAX_EXCLUDED} per field)")


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
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
        results.setdefault(name, {})["launches"] = n
    return sim, recorded


def phase_profile(sim, card: str, device="cuda",
                  steps=PROFILE_STEPS) -> None:
    """Per-phase times of ``steps`` sync points, each function of TIMED
    with a device sync on both sides (nested phases add their syncs to
    their parents'); then the device's busy and idle time over 2 more sync
    points under torch.profiler, kernel rows only."""
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile
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
        sync(device)
        t0 = time.perf_counter()
        sim.step(steps)
        sync(device)
        wall = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    say("profile", f"{steps} sync points, a device sync around each phase: "
        f"{1e3 * wall / steps:.3f} ms/step ({card})")
    for _, _, label in TIMED:
        s, n = totals[label]
        say("profile", f"  {label:<24s} {1e3 * s / steps:9.3f} ms/step "
            f"({n} calls)")

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
    phase_slice()
    sim, recorded = phase_main(results, card)
    check_kernels(recorded, f"2x{N_SIDE_MAIN}^3", results, timed=True)
    del recorded
    kernels.recorded.clear()
    phase_profile(sim, card)

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
