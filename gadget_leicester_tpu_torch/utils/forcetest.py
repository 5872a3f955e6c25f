"""The force test [G2: gravtree_forcetest.c :: gravity_forcetest()]
(-DFORCETEST=frac): for a random subset of the particles, the exact force
by direct summation (the Ewald lattice sum in a periodic box) beside the
force the run computed, and their relative error, appended to
``forcetest.txt``.

Counterpart of ``gadget_leicester_tpu/utils/forcetest.py``
(``run_forcetest`` :24, ``write_forcetest_file`` :91): the same subset
(numpy's generator from the same seed over the same alive rows), the same
float64 sums on the host with the spline softening in float32 (as the
reference evaluates its ``grav_fac``), the same file columns. The run
loop calls both at the statistics cadence when ``SimOptions.forcetest``
is above 0 (``models/simulation.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gadget_leicester_tpu_torch.core import timeline
from gadget_leicester_tpu_torch.core.config import SimConfig, SimOptions
from gadget_leicester_tpu_torch.core.state import SimState
from gadget_leicester_tpu_torch.models.forces import (comoving_factors,
                                                      softening_table)
from gadget_leicester_tpu_torch.ops.ewald import ewald_pair_force
from gadget_leicester_tpu_torch.ops.softening import SOFTFAC, grav_fac


def _grav_fac32(d: np.ndarray, h: np.ndarray) -> np.ndarray:
    """The softened 1/r^3 factor in float32, as the reference takes it."""
    return grav_fac(torch.from_numpy(d.astype(np.float32)),
                    torch.from_numpy(h.astype(np.float32))).numpy()


def run_forcetest(state: SimState, cfg: SimConfig, opts: SimOptions,
                  fraction: float | None = None, rng_seed: int = 0,
                  max_subset: int = 512) -> dict:
    """Relative force errors of a random subset: ``subset`` (rows of the
    state), ``acc_exact`` and ``acc_code`` [n, 3] (float64; the code's
    force is ``p.acc + p.acc_pm`` as the last step left them, so the whole
    stack is measured) and ``rel_err`` [n]. The exact force is the direct
    sum with spline softening; a periodic box takes the Ewald pair sum,
    the spline inside the softening length.

    The reference reads ``p.acc`` alone: under TreePM that is the
    short-range part, and its errors are the PM force's size (a fault of
    the reference, ROADMAP queue 3; GADGET-2's force test prints the sum
    of the tree and the PM force). Without a PM mesh ``acc_pm`` is 0 and
    the two agree."""
    frac = opts.forcetest if fraction is None else fraction
    p = state.p
    alive = p.alive.cpu().numpy()
    idx_all = np.where(alive)[0]
    rng = np.random.default_rng(rng_seed)
    n_test = max(1, min(int(len(idx_all) * frac), max_subset))
    subset = rng.choice(idx_all, size=n_test, replace=False)

    pos = p.pos.cpu().numpy().astype(np.float64)
    mass = p.mass.cpu().numpy().astype(np.float64)
    mass[~alive] = 0.0
    fac = comoving_factors(cfg, state.ti_current)
    eps = softening_table(cfg, fac.atime).cpu().numpy()
    soft = SOFTFAC * eps[p.ptype.cpu().numpy()]

    acc_exact = np.zeros((n_test, 3))
    periodic = bool(opts.periodic) and cfg.box_size > 0
    for k, i in enumerate(subset):
        r = pos[i] - pos
        d = np.linalg.norm(r, axis=1)
        hmax = np.maximum(soft[i], soft)
        if periodic:
            f = ewald_pair_force(r, cfg.box_size, nmax=3, kmax=3)
            f[i] = 0.0
            # the spline kernel in place of -r / r^3 within the softening
            near = (d < hmax) & (d > 0)
            if near.any():
                f[near] = -r[near] * _grav_fac32(d[near], hmax[near])[:, None]
        else:
            f = -r * _grav_fac32(d, hmax)[:, None]
            f[i] = 0.0
        acc_exact[k] = (mass[:, None] * f).sum(axis=0)

    acc_exact *= cfg.grav_internal
    acc_code = (p.acc + p.acc_pm).cpu().numpy().astype(np.float64)[subset]
    err = np.linalg.norm(acc_code - acc_exact, axis=1) / np.maximum(
        np.linalg.norm(acc_exact, axis=1), 1e-30)
    return {"subset": subset, "acc_exact": acc_exact, "acc_code": acc_code,
            "rel_err": err}


def write_forcetest_file(result: dict, state: SimState, cfg: SimConfig,
                         path: str | None = None) -> str:
    """Append the lines of ``forcetest.txt`` [G2: gravity_forcetest()
    output]: type, time, |pos|, f_exact (x, y, z), f_code (x, y, z),
    rel_err. Returns the path."""
    path = path or os.path.join(cfg.output_dir or ".", "forcetest.txt")
    t = float(timeline.ti_to_time(int(state.ti_current), cfg))
    ptype = state.p.ptype.cpu().numpy()
    pos = state.p.pos.cpu().numpy()
    with open(path, "a") as fh:
        for k, i in enumerate(result["subset"]):
            r = np.linalg.norm(pos[i])
            fe, fc = result["acc_exact"][k], result["acc_code"][k]
            fh.write(
                f"{ptype[i]} {t:.6g} {r:.6g} "
                f"{fe[0]:.6g} {fe[1]:.6g} {fe[2]:.6g} "
                f"{fc[0]:.6g} {fc[1]:.6g} {fc[2]:.6g} "
                f"{result['rel_err'][k]:.6g}\n")
    return path
