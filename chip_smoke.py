#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, the CUDA toolkit (``nvcc``) and this checkout; it
imports nothing of JAX. Phases, each printing its own lines:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile the eleven kernel sources of
   ``gadget_leicester_tpu_torch/csrc`` (one ``nvcc`` per source, all at
   once; A's source holds A and H, E's its two modes, C's, D's, F's and
   G's their relative and absolute modes, M's A's slab mode with and
   without the potential, I/J's and K's their ghost-row modes);
3. kernels: the arguments the path gives each dense kernel's wrapper (A-D)
   while it initialises a small lcdm_gas box, and kernel H's while it then
   computes the full potential, replayed through the kernel and its plain
   PyTorch version, in float32 and in float64 (all tiles, and every other
   tile gated off), within the bound stated at ``TOL``; H's force rows
   also against kernel A on the same arguments; the coarse-cell SPH
   kernels I/J and K the same way, on the small box with
   ``sph_backend="cells"`` (periodic) and on a vacuum blob, at capacities
   128 and 256; kernel L (the CIC gather of the PM mesh) through
   ``pm_gather_tiles`` on the small box's mesh stack with 3 and 4
   components, at fresh and at drifted positions, equal to its plain
   version bit for bit; kernel M (short-range gravity in absolute
   coordinates) on the small box, periodic with the TreePM truncation, and
   on a vacuum blob on a clamped grid without it; kernels C, D, F and G in
   their absolute mode on the vacuum blob through block SPH on its clamped
   grid (the entries on a seeded 3% of its gas); kernel E's potential
   mode and kernel H on the arguments a near-idle sync point of the small
   box with sinks gives them (the entries tier, and the tier forced dense:
   the step's cached pack and gated flags), H's force rows also against
   kernel A bit for bit;
4. slice: 2 sync points of the small box on the card against the same on
   the CPU (the plain versions), by the bounds of tests/test_torch_slice;
   the full potential of the state after 1 of them, card against CPU;
   then, from that state, a near-idle sync point (:func:`make_near_idle`)
   on the card against the CPU, through the active-entry kernels E-G,
   whose arguments are replayed as in phase 3 (all entries, and every
   other entry switched off); then the small box with
   ``sph_backend="cells"``, card against CPU; the small box with sinks
   (the in-step potential), card against CPU, p.pot included; the small
   Leicester disc of ``tests/test_torch_disc.py`` (400 gas, beta cooling,
   accretion onto the star) for 20 sync points, card against CPU;
5. main path: lcdm_gas 2x128^3 with pmgrid = auto_pmgrid(2 * 128^3),
   ``Simulation(..., device="cuda")``, ``set_ics`` and 6 steps, with the
   kernels' launch counts of that run: kernel L once per PM force pass
   (:func:`pm_passes`);
6. kernels at the main path's shapes: the arguments each wrapper got last
   in phase 5, replayed as in phase 3, and each kernel's time beside its
   plain version's and its bound (for A, C and D also the pairs they
   evaluate by the models of their culling rules, :func:`gravity_walk`,
   :func:`hydro_walk`, :func:`density_walk`; C's and B's times beside
   their earlier designs', :data:`EARLIER_MS`, and their registers, and
   those of A, H, F, G, I/J and K); then the full potential of phase 5's
   state (kernel H on a fresh cell list, L on the mesh potential), its
   parts timed, and H replayed and timed the same way, beside its earlier
   design's time and the pairs the model of its walk evaluates
   (:func:`gravity_walk`);
7. profile: the phases of 4 more sync points, each timed with a device
   sync around it, then the device's busy and idle time over 2 more from
   ``torch.profiler``;
8. near-idle at full width: from the state phase 5 left, a sync point at
   which 1% of the particles are active, once through the entries tier
   (E, F, G and not A, C, D) and once with the tier forced dense (A, C, D
   and not E, F, G), the two held to each other, neither with a PM step
   (no L); each timed 3 times and
   once by phases; E, F and G replayed on the arguments of the entries
   run, with their times beside their plain versions' (F's and G's beside
   their earlier designs' and the pairs the models of their walks
   evaluate, :func:`entries_density_walk`, :func:`entries_hydro_walk`);
8b. the coarse-cell SPH backend at full width (:func:`phase_cells`):
   lcdm_gas 2x128^3 with ``sph_backend="cells"``, ``set_ics`` and 6 sync
   points through kernels I/J and K (C and D not launched; A, B and L
   as on the block path); its SPH
   fields after ``set_ics`` held against the block backend's on the same
   ICs; I and K replayed and timed on its arguments (each beside its
   earlier design's time and the pairs the model of its walk evaluates,
   :func:`cells_density_walk`, :func:`cells_hydro_walk`); the synced
   phases of its SPH pass; a near-idle sync point, which this backend sweeps whole;
9. the command line at full width: a 2x128^3 IC file and parameter file
   (with an ``.opts`` sidecar asking for OUTPUTPOTENTIAL), ``python -m
   gadget_leicester_tpu_torch param 0`` in a child process for up to
   ``CLI_STEPS`` sync points with the energy statistics every
   ``TimeBetStatistics``, a snapshot and restart dumps; its energy.txt held
   to the Layzer-Irvine gate (|dE_LI|/|W| < 1e-3 on every row, up to a row
   at a >= 0.25) and printed beside ``docs/li_gate_128.md``; then restart
   flag 1 for 2 more sync points; kernel L, its plain version and
   ``grid_sample`` timed on the mesh stack of the run's snapshot at a =
   0.2 (:func:`gather_timings`), the particles in the order the run
   keeps;
10. the vacuum gas run (:func:`phase_gassphere`): an Evrard-sphere IC file
   and ``parameterfiles/gassphere.param`` with its paths and TimeMax set,
   ``python -m gadget_leicester_tpu_torch param 0`` in a child process to
   t = 0.5 (direct gravity, all-pairs SPH), its energy.txt and final
   momentum held to the bounds of ``tests/test_gassphere_e2e.py``; then,
   on that run's last state, one SPH pass through the coarse-cell backend
   in vacuum mode held against the all-pairs pass;
11. kernel L at full width (:func:`phase_gather`): the main path's
   launches of L beside its PM force passes; from the 2x128^3 state phase
   5 left, one PM step's mesh stack (kernel B's deposit,
   ``pm_forces_periodic(..., return_field=True)``) with 3 and 4
   components, gathered by L and by its plain version (the row gather),
   equal bit for bit, and through ``pm_gather_tiles`` over the cached
   gravity cell list; L replayed against its float64 plain version and
   timed beside the plain version, its bound and
   ``torch.nn.functional.grid_sample`` (:func:`gather_timings`);
12. kernel M at full width (:func:`phase_gravity_cells`): on the same
   state, ``shortrange_gravity_fresh`` with the TreePM asmth and rcut on
   the potential pass's fresh grid, held to its float64 plain version and
   to kernel H's force rows on the same fresh list, timed beside A and H;
12b. C, D, F and G in absolute mode at full width
   (:func:`phase_vacuum_blocks`): the gas of the same state as a vacuum
   cloud, ``compute_sph`` with ``periodic=False`` on 22^3 blocks, all gas
   active and a seeded 1% (the entries tier), each kernel replayed and
   timed beside its relative mode's time, its plain version and its bound,
   C's, F's and G's beside their earlier designs' (:data:`EARLIER_MS`);
13. the tree runs (:func:`phase_tree`): ``parameterfiles/galaxy.param`` and
   ``cluster.param`` on their 20,000-particle ICs through ``python -m
   gadget_leicester_tpu_torch`` in child processes, TimeMax cut, held to
   the bounds of ``tests/test_galaxy_cluster_e2e.py``; one tree force
   computation of the galaxy ICs against the direct sum; a small periodic
   box through the Ewald tree against the exact periodic sum;
14. lcdm_gas 2x128^3 with sinks (:func:`phase_sinks`): ``set_ics`` and 6
   sync points through kernel H on the step's pack (not A) and L's K = 4
   gather (force and mesh potential) once per PM force pass, with sink
   formation above the 99.999th percentile of the initial gas density and
   accretion within 2.8 gas softenings; gates: the in-step potential after
   ``set_ics`` against ``compute_potential``, at least one sink, mass and
   momentum across cooling and sinks, a finite state without overflow;
   H replayed and timed on the step's arguments (beside its earlier
   design's time), and against A bit for bit; the PM pass with and
   without the potential, L's gather of 1, 3 and 4 components, cooling
   and the sink functions timed; a near-idle sync point through E's
   potential mode
   against the same with the tier forced dense (H), E's potential mode
   replayed and timed;
15. the Leicester disc (:func:`phase_disc`): ``parameterfiles/disc.param``
   on the 20,000-gas ICs of ``parameterfiles/make_ics.py disc`` through
   ``python -m gadget_leicester_tpu_torch ... --cooling beta --sinks`` in
   a child process to t = 0.3 (tree gravity, block SPH on its vacuum grid,
   which ``auto`` takes above 4,096 gas, beta cooling), its launch counts
   (C and D in absolute mode, no periodic or coarse-cell SPH kernel), the
   capacity raises of ``set_ics`` and the mass of its last snapshot; then
   through ``Simulation.run()`` with the star registered as a sink for 8
   sync points: gates: finite, the alive mass kept, the accretion tally
   equal to the dead; kernels F and G replayed and timed on the disc's
   own arguments at the entries-tier sync point of the most live lanes
   (:func:`busiest_entries`) beside their earlier designs' times, the
   three launches of each timed apart (:func:`device_split`), with their
   launch counts in both runs; on its last state one SPH
   pass under blocks against one under cells, and ``apply_cooling``
   (beta, Stamatellos) card against CPU;
16. the zoom (:func:`phase_zoom`): ``parameterfiles/cluster.param``'s
   configuration with ``gravity_mode="zoom"``, pmgrid and hr_pmgrid 128,
   on 290,816 particles (:func:`zoom_ics`: a jittered 64^3 lattice of
   type 1 over the central half of a 10 Mpc/h cube, a 32^3 lattice of
   type 2, 8x heavier, over the rest), ``set_ics`` and 4 sync points
   (kernel L twice a force pass, no other kernel); finite, no overflow;
   one force pass with every particle active, its parts timed (the two
   vacuum meshes, L, both cell lists, pass A, pass B), and the full
   potential, held to the float64 direct sum on 4,096 seeded HR and
   4,096 seeded targets by tests/test_zoom.py's bounds; L's gathers of
   both meshes against its plain version, bit for bit, timed beside it,
   its bound and ``grid_sample``; the share of pass A's candidates that
   are HR-HR pairs it masks out;
17. the switches and the glass (:func:`phase_switches`): 2 sync points of
   phase 4's box under ``nogravity``, ``adaptive_gravsoft_forgas`` (and
   its full potential) and ``isotherm_eqs``, card against CPU;
   ``python -m gadget_leicester_tpu_torch ... --makeglass 64`` in a child
   process, its glass.dat held to tests/test_features.py::test_make_glass's
   checks (L once a relaxation step); the Zel'dovich pancake of
   tests/test_zeldovich.py on the card, by its bounds;
18. the slab step (:func:`phase_slab`): phase 5's configuration through
   ``Simulation(cfg, opts, device="cuda", mesh=1)``, a ring of one rank on
   NCCL (``parallel/``): ``set_ics`` and ``SLAB_STEPS`` sync points with
   the launch counts read for each, held by pid to the single-device run
   of the same ICs over the same sync points by tests/test_spmd_step.py's
   bounds; kernel A's slab mode and C's and D's anisotropic mode replayed
   on the path's arguments against their float64 plain versions and
   timed, L's launches on the slab PM and its gather bit for bit; a sync
   point by parts beside the single-device one's; ``python -m
   gadget_leicester_tpu_torch ... --devices 1`` against the same CLI run
   without it (energy.txt and the snapshot, by the same bounds); and
   ``--devices 2`` on a machine with fewer cards exits non-zero, counting
   them;
19. the slab step's fork physics and vacuum geometry
   (:func:`phase_slab_fork`), on a ring of one on NCCL: (a) phase 14's
   configuration with sinks through ``Simulation(mesh=1)`` for
   ``SLAB_SINK_STEPS`` sync points, held by pid to the single-device run of
   the same ICs (:func:`hold_slab`), its registry (PIDs, acc_mass,
   n_accreted) equal, alive mass and momentum across the sinks, the
   in-step potential after the first sync point; (b) A's slab mode with
   the potential row replayed on (a)'s arguments against its float64
   plain version and timed, its rows 0-2 equal to the force-only mode's
   bit for bit; (d) Stamatellos cooling with the sinks, one sync point on
   (a)'s states, ring against one device; (c) the 2x128^3 ICs in vacuum
   (``PeriodicBoundariesOn 0``, comoving) for ``SLAB_VACUUM_STEPS`` sync
   points, the first one's gravity against the dense split of the same
   TreePM on seeded targets, A's slab mode at image mask 0 and C's and
   D's anisotropic mode on clamped grids replayed and timed (rows of
   their own in the kernels line); (e) a sync point of each by parts;
20. the slab step's coarse-cell SPH (:func:`phase_slab_cells`):
   ``sph_backend="cells"`` on the 2x128^3 box through
   ``Simulation(mesh=1)`` (NCCL) for ``SLAB_CELLS_STEPS`` sync points,
   held by pid to the single-device coarse-cell step of the same ICs
   (:func:`hold_slab`), the launch counts read (kernels I/J and K in their
   ghost-row mode, never C and D); the two modes replayed on the path's
   arguments on every ``SLAB_CELLS_EVERY``-th target cell against their
   float64 plain versions and timed beside them; a sync point by parts;
   the same ICs in vacuum, one sync point, the modes on the cells that
   hold a target (rows of their own in the kernels line); and the force
   test once at phase 9's statistics cadence (:func:`phase_forcetest`).

Any failure raises, so the exit code is not 0. The line before the last
is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import gc
import json
import shutil
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
# phase 9: the CLI run, to a >= LI_A_END within CLI_STEPS sync points (the
# JAX package reached a = 0.2535 in 120 on the same integer timeline), held
# to BASELINE.json's Layzer-Irvine gate. Restart dumps are written every
# CpuTimeBetRestartFile seconds of the run's wall clock: the interval is
# short enough that the run, some 8 s on an H100, writes at least one for
# the resume to start from.
CLI_STEPS = 128
LI_A_END = 0.25
LI_GATE = 1e-3
CLI_CADENCE = """
TimeBetStatistics 0.005
TimeOfFirstSnapshot 0.2
TimeBetSnapshot 2.0
CpuTimeBetRestartFile 3.0
"""
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
       "sph_hydro_entries": 1e-4, "shortrange_potential": 1e-4,
       "sph_cells_density": 1e-4, "sph_cells_hydro": 1e-4,
       "pm_gather": 1e-5, "shortrange_gravity_cells": 1e-4,
       "shortrange_potential_entries": 1e-4, "sph_density_abs": 1e-4,
       "sph_hydro_abs": 1e-4, "sph_density_entries_abs": 1e-4,
       "sph_hydro_entries_abs": 1e-4, "shortrange_gravity_slab": 1e-4,
       "sph_density_aniso": 1e-4, "sph_hydro_aniso": 1e-4,
       "shortrange_gravity_slab_pot": 1e-4, "sph_cells_density_slab": 1e-4,
       "sph_cells_hydro_slab": 1e-4}
F32_FACTOR = 4.0

# the coarse-cell SPH grids of the small comparisons, (cells per axis,
# slots per cell): 4,096 gas of the 2x16^3 box or 3,000 of the vacuum blob
# overflow neither
SMALL_CELL_GRIDS = ((4, 128), (3, 256))
DENSE = ("shortrange_gravity", "pm_deposit", "sph_density", "sph_hydro")
ENTRIES = ("shortrange_gravity_entries", "sph_density_entries",
           "sph_hydro_entries")
POTENTIAL = ("shortrange_potential",)
# kernel E's potential mode: the entries tier of a step with the in-step
# potential (sinks, Stamatellos cooling)
POTENTIAL_ENTRIES = ("shortrange_potential_entries",)
CELLS = ("sph_cells_density", "sph_cells_hydro")
GATHER = ("pm_gather",)
GRAVITY_CELLS = ("shortrange_gravity_cells",)
# the absolute-coordinate modes of C, D (dense tier) and F, G (entries
# tier): block SPH on a clamped (vacuum) grid
ABS_DENSE = ("sph_density_abs", "sph_hydro_abs")
ABS_ENTRIES = ("sph_density_entries_abs", "sph_hydro_entries_abs")
ABS = ABS_DENSE + ABS_ENTRIES
# the slab step's modes: A's slab mode, C and D on
# anisotropic block grids (phase 18), A's slab mode with the potential row
# (phase 19: sinks, Stamatellos cooling)
SLAB_FORCE = ("shortrange_gravity_slab", "sph_density_aniso",
              "sph_hydro_aniso")
SLAB_POT = ("shortrange_gravity_slab_pot",)
SLAB = SLAB_FORCE + SLAB_POT
# the vacuum slab step's modes (phase 19): the same wrappers on grids
# clamped on every axis (A's image mask 0, C's and D's (F, F, F)), with
# rows of their own in the kernels line
VACUUM = "_vacuum"
SLAB_VACUUM = tuple(n + VACUUM for n in SLAB_FORCE)
# A's slab mode with the potential in vacuum: on no path (the vacuum run
# has no sinks), held and timed on the vacuum slab's arguments (phase 19)
SLAB_POT_VACUUM = ("shortrange_gravity_slab_pot" + VACUUM,)
# the slab step's coarse-cell SPH (phase 20): I/J's and K's ghost-row mode
# on the slab's (nx, n, n) cells, periodic (image mask 6) and in vacuum (0)
SLAB_CELLS = ("sph_cells_density_slab", "sph_cells_hydro_slab")
SLAB_CELLS_VACUUM = tuple(n + VACUUM for n in SLAB_CELLS)
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
    # A's kernel with the potential row (kPot)
    "shortrange_potential": (
        "gadget_leicester_tpu_torch/csrc/shortrange_gravity.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:433"),
    # I and its grid twin J (pallas_cells.py:1276) are two TPU schedules of
    # one function: one kernel
    "sph_cells_density": (
        "gadget_leicester_tpu_torch/csrc/sph_cells_density.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:1251"),
    "sph_cells_hydro": (
        "gadget_leicester_tpu_torch/csrc/sph_cells_hydro.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:1363"),
    "pm_gather": ("gadget_leicester_tpu_torch/csrc/pm_gather.cu",
                  "gadget_leicester_tpu/ops/pm_tiles.py:231"),
    "shortrange_gravity_cells": (
        "gadget_leicester_tpu_torch/csrc/shortrange_gravity_cells.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:1581"),
    # E's with_potential mode (kernel body :855, potential rows :941-964)
    "shortrange_potential_entries": (
        "gadget_leicester_tpu_torch/csrc/shortrange_gravity_entries.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:973"),
    # C, D, F, G in absolute coordinates (relative=False, periodic=False;
    # the pair geometry _pair_geom_minimage :200 without a shift)
    "sph_density_abs": ("gadget_leicester_tpu_torch/csrc/sph_density.cu",
                        "gadget_leicester_tpu/ops/sph_blocks.py:397"),
    "sph_hydro_abs": ("gadget_leicester_tpu_torch/csrc/sph_hydro.cu",
                      "gadget_leicester_tpu/ops/sph_blocks.py:630"),
    "sph_density_entries_abs": (
        "gadget_leicester_tpu_torch/csrc/sph_density_entries.cu",
        "gadget_leicester_tpu/ops/sph_blocks.py:1125"),
    "sph_hydro_entries_abs": (
        "gadget_leicester_tpu_torch/csrc/sph_hydro_entries.cu",
        "gadget_leicester_tpu/ops/sph_blocks.py:1175"),
    # the slab step's modes: A's with a tuple n_cells, periodic (False,
    # True, True), absolute, cl= (parallel/spmd.py:889-898), in M's source;
    # C and D with per-axis blocks and fine_edge (spmd.py:1054, :1087)
    "shortrange_gravity_slab": (
        "gadget_leicester_tpu_torch/csrc/shortrange_gravity_cells.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:669"),
    "sph_density_aniso": ("gadget_leicester_tpu_torch/csrc/sph_density.cu",
                          "gadget_leicester_tpu/ops/sph_blocks.py:397"),
    "sph_hydro_aniso": ("gadget_leicester_tpu_torch/csrc/sph_hydro.cu",
                        "gadget_leicester_tpu/ops/sph_blocks.py:630"),
    # A's slab mode with the potential row: with_potential=True on the
    # same call (parallel/spmd.py:888-898), kPot in M's source
    "shortrange_gravity_slab_pot": (
        "gadget_leicester_tpu_torch/csrc/shortrange_gravity_cells.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:669"),
    # the vacuum slab step's modes: periodic=(False, False, False)
    "shortrange_gravity_slab_vacuum": (
        "gadget_leicester_tpu_torch/csrc/shortrange_gravity_cells.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:669"),
    "shortrange_gravity_slab_pot_vacuum": (
        "gadget_leicester_tpu_torch/csrc/shortrange_gravity_cells.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:669"),
    "sph_density_aniso_vacuum": (
        "gadget_leicester_tpu_torch/csrc/sph_density.cu",
        "gadget_leicester_tpu/ops/sph_blocks.py:397"),
    "sph_hydro_aniso_vacuum": (
        "gadget_leicester_tpu_torch/csrc/sph_hydro.cu",
        "gadget_leicester_tpu/ops/sph_blocks.py:630"),
    # I/J's and K's ghost-row mode, the slab step's coarse cells:
    # density_adaptive_pallas(n_targets=, cl=) and hydro_force_pallas(
    # n_targets=) with a tuple n_cells and periodic (False, pyz, pyz)
    # (parallel/spmd.py:1216, :1282), on the sweep kernels of :1251, :1363
    "sph_cells_density_slab": (
        "gadget_leicester_tpu_torch/csrc/sph_cells_density.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:1401"),
    "sph_cells_hydro_slab": (
        "gadget_leicester_tpu_torch/csrc/sph_cells_hydro.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:1483"),
    "sph_cells_density_slab_vacuum": (
        "gadget_leicester_tpu_torch/csrc/sph_cells_density.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:1401"),
    "sph_cells_hydro_slab_vacuum": (
        "gadget_leicester_tpu_torch/csrc/sph_cells_hydro.cu",
        "gadget_leicester_tpu/ops/pallas_cells.py:1483"),
}
# where the tile flags or entry ids sit among each wrapper's arguments (B
# has none)
FLAGS_ARG = {"shortrange_gravity": 1, "sph_density": 3, "sph_hydro": 5,
             "shortrange_gravity_entries": 1, "sph_density_entries": 3,
             "sph_hydro_entries": 4, "shortrange_potential": 1,
             "sph_cells_density": 2, "shortrange_potential_entries": 1,
             "sph_density_abs": 3, "sph_hydro_abs": 5,
             "sph_density_entries_abs": 3, "sph_hydro_entries_abs": 4,
             "shortrange_gravity_slab": 1, "sph_density_aniso": 3,
             "sph_hydro_aniso": 5, "shortrange_gravity_slab_pot": 1,
             "sph_cells_density_slab": 2, "sph_cells_hydro_slab": 6}
# where (hubble_a2_flow, fac_mu) sits among the hydro wrappers' arguments
PARAMS_ARG = {"sph_hydro": 6, "sph_cells_hydro": 1, "sph_hydro_abs": 6,
              "sph_hydro_aniso": 6, "sph_cells_hydro_slab": 1}
for _n in SLAB_FORCE + SLAB_POT + SLAB_CELLS:
    TOL[_n + VACUUM] = TOL[_n]
    FLAGS_ARG[_n + VACUUM] = FLAGS_ARG[_n]
    if _n in PARAMS_ARG:
        PARAMS_ARG[_n + VACUUM] = PARAMS_ARG[_n]
# The bound of each kernel (the least time the card could take): the
# larger of its float32 operations over PEAK_FLOPS and its bytes (each
# input tensor read once, the output written once) over PEAK_BYTES; the
# H100 SXM's published rates at 700 W. Operations are counted on the pair
# arithmetic of csrc/glt_common.cuh, which is the plain version's (add,
# multiply, compare, min, max 1 each, FMA 2, rsqrt 1), and only where the
# function needs them: the pairs inside the cut (0 < r < rcut for
# gravity, r < h or max(h_i, h_j) for SPH, counted on the recorded
# arguments) pay OPS_PER_PAIR each, the test of the cut and the branch
# beyond the softening included; a pair outside adds nothing to the
# result, so it costs the bound nothing, however many of them a kernel
# walks. Kernel B: its live slots times OPS_PER_DEPOSIT. Kernel L: its
# particles times 15 (the mesh coordinate, floor and the six weights)
# plus, for each of 8 corners, 2 for its weight and a multiply and an add
# per component; its bytes are the positions, the mesh and the output
# (torch.nn.functional.grid_sample computes the same function and
# moves the same bytes). Kernel M: a pair inside the cut pays A's 50 plus
# 12 for the per-pair minimum image on a periodic grid (per axis a
# multiply, a round and an FMA) and 2 for the exact r < rcut test, less 22
# where the truncation polynomial is off (asmth = 0). The absolute modes of
# C, D, F, G pay 3 operations less on every pair: dx = t - s, no shift.
# A's slab mode pays M's, with the minimum image on its periodic axes
# only (MIN_IMAGE_OPS / 3 an axis: two on a periodic slab, none in
# vacuum), and with the potential row H's potential on top (OPS_PER_PAIR
# of H less A's: the softened potential, its erfc and the sum); C's and
# D's anisotropic mode their relative mode's, in vacuum too. Kernels I/J
# and K, either mode, move only the rows of their live slots and the
# output rows of the live slots they sum (:func:`cells_bytes`).
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_PAIR = {"shortrange_gravity": 50, "shortrange_gravity_entries": 50,
                "shortrange_potential": 77,
                "shortrange_potential_entries": 77, "sph_density": 73,
                "sph_density_entries": 73, "sph_hydro": 86,
                "sph_hydro_entries": 86, "sph_cells_density": 73,
                "sph_cells_hydro": 86}
OPS_PER_PAIR.update({n: OPS_PER_PAIR[n.removesuffix("_abs")] - 3
                     for n in ABS})
OPS_PER_PAIR.update(sph_density_aniso=OPS_PER_PAIR["sph_density"],
                    sph_hydro_aniso=OPS_PER_PAIR["sph_hydro"])
# the ghost-row modes pay the cube's arithmetic: dx = t - (s + shift) on
# every axis (a clamped axis adds a shift of 0)
OPS_PER_PAIR.update(sph_cells_density_slab=OPS_PER_PAIR["sph_cells_density"],
                    sph_cells_hydro_slab=OPS_PER_PAIR["sph_cells_hydro"])
OPS_PER_DEPOSIT = 44
MIN_IMAGE_OPS = 12
TRUNC_OPS = 22

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
    (f"{_PKG}.models.forces", "shortrange_potential_tiles", "  kernel H"),
    (f"{_PKG}.models.forces", "merge_rows", "  SR merge"),
    (f"{_PKG}.models.forces", "gravity_entries", "  SR entries"),
    (f"{_PKG}.ops.cells", "shortrange_gravity_entries",
     "    kernel E (either mode)"),
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
    (f"{_PKG}.models.simulation", "apply_cooling", "cooling"),
    (f"{_PKG}.models.simulation", "create_sinks", "sink formation"),
    (f"{_PKG}.models.simulation", "accrete_onto_sinks", "accretion"),
    (f"{_PKG}.models.integrate", "advance_and_find_timesteps", "advance"),
    (f"{_PKG}.models.integrate", "pm_step_update", "PM step update"),
)


# phase 6: the parts of the full potential (models/forces.py ::
# compute_potential), each timed as in TIMED
POTENTIAL_TIMED = (
    (f"{_PKG}.models.forces", "pm_potential_periodic", "PM potential"),
    (f"{_PKG}.models.forces", "build_cell_list", "fresh cell list"),
    (f"{_PKG}.models.forces", "pack_cells_soa", "pack"),
    (f"{_PKG}.models.forces", "shortrange_potential_tiles", "kernel H"),
    (f"{_PKG}.models.forces", "merge_rows", "merge"),
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


def run_param_text(n_side: int, ics: str, outdir: str, extra: str) -> str:
    """:func:`param_text` with a real IC file and output directory, and
    the lines ``extra`` (the output cadences) appended."""
    return (param_text(n_side)
            .replace("InitCondFile x", f"InitCondFile {ics}")
            .replace("OutputDir  /tmp/bench_out", f"OutputDir  {outdir}")
            + extra)


def write_ics(path: str, n_side: int) -> int:
    """``lcdm_gas_ics(n_side)`` as a format-1 GADGET IC file, types in
    file order as ``parameterfiles/make_ics.py`` writes them, through the
    port's snapshot writer; returns the particle count."""
    import numpy as np

    from gadget_leicester_tpu_torch.io.snapshot import (Header, SnapshotData,
                                                        write_snapshot)
    cfg, _, (pos, vel, mass, ptype, u) = setup(n_side)
    order = np.argsort(ptype, kind="stable")
    h = Header()
    for t in range(6):
        h.npart[t] = int((ptype == t).sum())
    h.npart_total = h.npart.copy()
    h.box_size = cfg.box_size
    n = len(pos)
    write_snapshot(path, SnapshotData(
        header=h, pos=pos[order].astype(np.float32),
        vel=vel[order].astype(np.float32),
        ids=np.arange(1, n + 1, dtype=np.uint32),
        mass=mass[order].astype(np.float32),
        u=np.asarray(u, np.float32)), fmt=1)
    return n


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def setup(n_side: int, param_extra: str = "", **opt_overrides):
    """cfg, opts and IC arrays of the lcdm_gas box at ``n_side``;
    ``param_extra`` is appended to the parameter text, ``opt_overrides``
    replace fields of the options (block SPH by default)."""
    from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                        auto_pmgrid,
                                                        parse_parameter_text)
    from gadget_leicester_tpu_torch.models.ics import lcdm_gas_ics
    cfg = parse_parameter_text(param_text(n_side) + param_extra)
    opts = SimOptions(periodic=True, pmgrid=auto_pmgrid(2 * n_side ** 3),
                      gravity_mode="treepm",
                      sph_backend="blocks").replace(**opt_overrides)
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


def record_init(n_side: int, device, **opt_overrides) -> dict:
    """The arguments the path gives each kernel wrapper while ``set_ics``
    initialises the lcdm_gas box at ``n_side`` (two full force passes,
    the first a PM step), and kernel H's while the full potential of the
    initialised state is computed."""
    from gadget_leicester_tpu_torch.models.forces import compute_potential
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg, opts, ics = setup(n_side, **opt_overrides)
    pos, vel, mass, ptype, u = ics
    with recorded_inputs() as rec:
        state = Simulation(cfg, opts, device).set_ics(pos, vel, mass, ptype,
                                                      u=u)
        compute_potential(state, cfg, opts)
    return dict(rec)


def vacuum_blob(device, n: int = 3000, seed: int = 5):
    """(pos, vel, mass, gas_mask) of a seeded vacuum gas blob: ``n``
    particles uniform in the unit sphere, unequal masses, a radial infall
    with noise."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    x *= (rng.uniform(size=n) ** (1 / 3) / np.linalg.norm(x, axis=1))[:, None]
    v = -0.3 * x + 0.05 * rng.normal(size=(n, 3))

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32).to(device)

    pos, vel = dev(x), dev(v)
    mass = dev(rng.uniform(0.5, 1.5, size=n) / n)
    return pos, vel, mass, torch.ones(n, dtype=torch.bool, device=pos.device)


def record_vacuum_blob(device, n_cells: int, cap: int, n: int = 3000,
                       seed: int = 5) -> dict:
    """The arguments kernels I/J and K get from one SPH pass of the
    coarse-cell backend in vacuum mode over :func:`vacuum_blob`; the grid
    is the blob's bounding box, as ``models/forces.py`` takes it. Raises
    if a cell overflowed."""
    import torch

    from gadget_leicester_tpu_torch.models.forces import gas_bounding_grid
    from gadget_leicester_tpu_torch.ops import sph_cells as sc
    pos, vel, mass, gas_mask = vacuum_blob(device, n, seed)
    origin, extent = gas_bounding_grid(pos, gas_mask)
    with recorded_inputs() as rec:
        res, cl = sc.density_adaptive_cells(
            pos, vel, mass, torch.full_like(mass, 0.2), gas_mask, 33.0, 2.0,
            box=1.0, n_cells=n_cells, capacity=cap,
            max_hsml=extent / n_cells, periodic=False, origin=origin,
            extent=extent)
        sc.hydro_force_cells(cl, pos, vel, mass, res.hsml, res.rho,
                             0.05 * res.rho ** (5.0 / 3.0), res.dhsml_factor,
                             res.div_vel, res.curl_vel, gas_mask,
                             visc_const=0.8, box=1.0)
    if bool(cl.overflow):
        raise AssertionError(f"the vacuum blob overflowed {n_cells}^3 cells "
                             f"of {cap} slots")
    return dict(rec)


# the block grid of the vacuum blob's checks of C, D, F, G in absolute
# mode: (blocks per axis, slots per subcell), 3,000 gas in the unit sphere
# overflow no subcell; the seeded active share of its entries pass
VACUUM_BLOCKS = (3, 64)
VACUUM_IDLE_FRAC = 0.03


def record_vacuum_blocks(device, n_blocks: int, subcap: int, pos, vel, mass,
                         gas_mask, idle_frac: float, seed: int = IDLE_SEED,
                         h0=0.2) -> tuple:
    """The arguments kernels C, D, F and G get in their absolute mode from
    the vacuum block-SPH path over the gas (``pos``, ...): the even and
    odd lists of its bounding cube (clamped), a density pass (the Newton
    loop from h = ``h0``, a float or a tensor, capped 2 kappa below the
    fine edge) and a hydro
    pass on every gas particle (C, D), then both again on a seeded
    ``idle_frac`` of the gas through the active entries (F, G). Returns
    (recorded arguments, seconds of the two dense passes and of the two
    entry passes, each between device syncs). Raises if a subcell
    overflowed or the entries did not fit."""
    import torch

    from gadget_leicester_tpu_torch.models.forces import gas_bounding_grid
    from gadget_leicester_tpu_torch.models.grids import KAPPA_SPH
    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    from gadget_leicester_tpu_torch.ops.cells import (ENTRY_LANES,
                                                      build_active_entries)
    origin, extent = gas_bounding_grid(pos, gas_mask)
    cls = sb.build_block_lists(pos, gas_mask, origin, extent, n_blocks,
                               subcap, periodic=False)
    if bool(cls[0].overflow):
        raise AssertionError(f"the vacuum cloud overflowed {n_blocks}^3 "
                             f"blocks of {subcap} slots a subcell")
    max_hsml = (1.0 - 2.0 * KAPPA_SPH) / cls[0].inv_cell[0]
    h = torch.clamp(h0 if torch.is_tensor(h0) else torch.full_like(mass, h0),
                    max=max_hsml)
    dkw = dict(des_num_ngb=33.0, max_dev=2.0, box=1.0, cls=cls,
               max_hsml=max_hsml)
    hkw = dict(visc_const=0.8, box=1.0, hubble_a2_flow=0.0,
               hubble_a2_norm=1.0, fac_mu=1.0)

    def hydro(fn, res, *extra):
        return fn(cls, pos, vel, mass, res.hsml, res.rho,
                  0.05 * res.rho ** (5.0 / 3.0), res.dhsml_factor,
                  res.div_vel, res.curl_vel, gas_mask, *extra, **hkw)

    gen = torch.Generator().manual_seed(seed)
    active = (torch.rand(pos.shape[0], generator=gen) < idle_frac).to(
        pos.device) & gas_mask
    k_max = 2 * n_blocks ** 3
    seconds = []
    with recorded_inputs() as rec:
        sync(device)
        t0 = time.perf_counter()
        res, _ = sb.density_adaptive_blocks(pos, vel, mass, h, gas_mask,
                                            **dkw)
        hydro(sb.hydro_force_blocks, res)
        sync(device)
        seconds.append(time.perf_counter() - t0)
        ec, es, total = build_active_entries(cls[0], active, ENTRY_LANES,
                                             k_max)
        if int(total) > k_max:
            raise AssertionError(f"{int(total)} entries do not fit {k_max}")
        t0 = time.perf_counter()
        ires = sb.density_adaptive_blocks_entries(pos, vel, mass, h,
                                                  gas_mask, ec, es, **dkw)
        # the active gas takes its fresh solve, the rest keeps the dense
        # pass's fields, as compute_sph merges them
        take = active & (ires.rho > 0)
        ires = res._replace(**{f: torch.where(take, getattr(ires, f),
                                              getattr(res, f))
                               for f in ("rho", "hsml", "dhsml_factor",
                                         "div_vel", "curl_vel")})
        hydro(sb.hydro_force_blocks_entries, ires, ec, es)
        sync(device)
        seconds.append(time.perf_counter() - t0)
    return seed_sweep_args(dict(rec), cls[0], res.hsml), seconds


def seed_sweep_args(recorded: dict, cl_e, hsml) -> dict:
    """``recorded`` with C's absolute-mode arguments at every gas slot's
    h = ``hsml``: C's last call is a late Newton sweep, in which the slots
    already solved are passed h = 0 and cost nothing, so it is replayed on
    the pass's own packs with the converged h, as the seed sweep of the
    next pass gives them."""
    import torch
    soa_e, soa_o, _, flags, nb, lf = recorded["sph_density_abs"]
    cells = cl_e.cells
    h_slots = torch.where(cells >= 0, hsml[cells.clamp_min(0).long()],
                          torch.zeros((), device=cells.device))
    return dict(recorded, sph_density_abs=(soa_e, soa_o,
                                           h_slots.contiguous(), flags, nb,
                                           lf))


def record_gather_small(device, n_side: int, k: int, drifted: bool,
                        seed: int = 11) -> dict:
    """The arguments kernel L's wrapper gets from ``pm_gather_tiles`` on
    the lcdm_gas box at ``n_side``: the mesh stack of one PM step with
    ``k`` components (3 forces, or 4 with the potential), the gravity cell
    list built at the ICs, and the positions read either there or, with
    ``drifted``, after a seeded drift of up to half the list's margin with
    1% of the particles moved by up to two cells, across the periodic
    seam too. The gathered values are held to the plain version's (the
    row gather) on the same mesh, bit for bit."""
    import numpy as np
    import torch

    from gadget_leicester_tpu_torch.models.grids import grav_grid_geometry
    from gadget_leicester_tpu_torch.ops.neighbors import build_cell_list
    from gadget_leicester_tpu_torch.ops.pm import (cic_gather_vec_plain,
                                                   pm_forces_periodic)
    from gadget_leicester_tpu_torch.ops.pm_tiles import pm_gather_tiles
    cfg, opts, (pos, _, mass, _, _) = setup(n_side)
    box, g = float(cfg.box_size), opts.pmgrid
    n_cells, cap, margin = grav_grid_geometry(cfg, opts, len(pos))
    pos_t = torch.as_tensor(pos, dtype=torch.float32).to(device)
    mass_t = torch.as_tensor(mass, dtype=torch.float32).to(device)
    alive = torch.ones(len(pos), dtype=torch.bool, device=pos_t.device)
    alive[::17] = False
    cl = build_cell_list(pos_t, alive, 0.0, box, n_cells=n_cells,
                         capacity=cap)
    if bool(cl.overflow):
        raise AssertionError("the small box overflowed its gravity cells")
    if drifted:
        rng = np.random.default_rng(seed)
        d = rng.uniform(-margin / 2, margin / 2, pos.shape)
        far = rng.uniform(size=len(pos)) < 0.01
        d[far] = rng.uniform(-2 * box / n_cells, 2 * box / n_cells,
                             (int(far.sum()), 3))
        pos_t = pos_t + torch.as_tensor(d, dtype=torch.float32).to(device)
    field = pm_forces_periodic(pos_t, mass_t, alive, box, g,
                               return_field=True, with_potential=k == 4)
    with recorded_inputs() as rec:
        got = pm_gather_tiles(field, cl, pos_t, alive, box, g, n_cells,
                              margin * g / box)
    want = cic_gather_vec_plain(field, torch.remainder(pos_t, box), box, g)
    want = torch.where(alive[:, None], want, torch.zeros_like(want))
    check_gather_equal("kernels", f"pm_gather_tiles n_side={n_side} K={k} "
                       f"{'drifted' if drifted else 'fresh'}", got, want)
    return dict(rec)


def check_gather_equal(phase: str, what: str, got, want) -> None:
    """Kernel L's values ``got`` equal its plain version's ``want`` (the
    row gather) bit for bit: the kernel repeats its float32 arithmetic
    operation for operation, each product and sum rounded on its own."""
    import torch
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: wrong shape or not finite")
    same = torch.equal(got, want)
    say(phase, f"{what}: kernel L vs its plain version (the row gather), "
        f"max |difference| {float((got - want).abs().max()):.3e}, bit for "
        f"bit {'yes' if same else 'NO'}")
    if not same:
        raise AssertionError(f"{what}: kernel L is not its plain version "
                             "bit for bit")


def record_gravity_cells_small(device, n_side: int, periodic: bool,
                               seed: int = 5) -> dict:
    """The arguments kernel M's wrapper gets from
    ``shortrange_gravity_fresh``: periodic, on the lcdm_gas box at
    ``n_side`` with the TreePM asmth and rcut and the potential pass's
    grid; vacuum, on a seeded blob of 3,000 unequal masses inside the unit
    box on a clamped 4^3 grid, plain softened gravity cut at the cell
    edge. Raises if a cell overflowed."""
    import numpy as np
    import torch

    from gadget_leicester_tpu_torch.ops.gravity_short import \
        shortrange_gravity_fresh
    from gadget_leicester_tpu_torch.ops.pm import ASMTH, RCUT
    if periodic:
        cfg, opts, (pos, _, mass, _, _) = setup(n_side)
        box = float(cfg.box_size)
        asmth = ASMTH * box / opts.pmgrid
        rcut = RCUT * asmth
        n_cells = max(3, int(box / rcut))
        soft = np.full(len(pos), 2.8 * box / n_side / 30)
    else:
        rng = np.random.default_rng(seed)
        n = 3000
        x = rng.normal(size=(n, 3))
        x *= (rng.uniform(size=n) ** (1 / 3) / np.linalg.norm(x, axis=1))[:, None]
        pos, mass = 0.5 + 0.45 * x, rng.uniform(0.5, 1.5, size=n) / n
        box, asmth, rcut, n_cells = 1.0, 0.0, 0.25, 4
        soft = rng.uniform(0.01, 0.05, size=n)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32).to(device)

    alive = torch.ones(len(pos), dtype=torch.bool, device=dev(mass).device)
    alive[::13] = False
    with recorded_inputs() as rec:
        acc, ovf = shortrange_gravity_fresh(
            dev(pos), dev(mass), dev(soft), alive, box, n_cells,
            capacity=256, asmth=asmth, rcut=rcut, periodic=periodic)
    if bool(ovf) or not bool(torch.isfinite(acc).all()):
        raise AssertionError("kernel M's small case overflowed or is not "
                             "finite")
    return dict(rec)


def kernel_pairs() -> dict:
    """{kernel: (wrapper, plain version)}; both take the wrapper's
    arguments."""
    from gadget_leicester_tpu_torch.ops import (cells, gravity_short, pm,
                                                pm_tiles)
    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    from gadget_leicester_tpu_torch.ops import sph_cells as sc
    pairs = {
        "sph_cells_density": (sc.density_sums_cells,
                              sc.density_sums_cells_plain),
        "sph_cells_hydro": (sc.hydro_sums_cells, sc.hydro_sums_cells_plain),
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
        "shortrange_potential": (
            cells.shortrange_potential_tiles,
            gravity_short.shortrange_potential_tiles_plain),
        "pm_gather": (pm.cic_gather_vec, pm.cic_gather_vec_plain),
        "shortrange_gravity_cells": (
            cells.shortrange_gravity_cells,
            gravity_short.shortrange_gravity_cells_plain),
        # the absolute modes: the same wrappers and plain versions (lf None)
        **{f"{name}_abs": pair for name, pair in (
            ("sph_density", (sb.density_sums_blocks,
                             sb.density_sums_blocks_plain)),
            ("sph_hydro", (sb.hydro_sums_blocks, sb.hydro_sums_blocks_plain)),
            ("sph_density_entries", (sb.density_sums_blocks_entries,
                                     sb.density_sums_blocks_entries_plain)),
            ("sph_hydro_entries", (sb.hydro_sums_blocks_entries,
                                   sb.hydro_sums_blocks_entries_plain)))},
        # the slab step's modes
        "shortrange_gravity_slab": (
            cells.shortrange_gravity_slab,
            gravity_short.shortrange_gravity_slab_plain),
        "sph_density_aniso": (sb.density_sums_blocks,
                              sb.density_sums_blocks_plain),
        "sph_hydro_aniso": (sb.hydro_sums_blocks, sb.hydro_sums_blocks_plain),
        # E's potential mode: the same wrapper and plain version
        "shortrange_potential_entries": (
            functools.partial(cells.shortrange_gravity_entries,
                              with_potential=True),
            functools.partial(gravity_short.shortrange_gravity_entries_plain,
                              with_potential=True)),
        # A's slab mode with the potential row
        "shortrange_gravity_slab_pot": (
            functools.partial(cells.shortrange_gravity_slab,
                              with_potential=True),
            functools.partial(gravity_short.shortrange_gravity_slab_plain,
                              with_potential=True)),
    }
    # the ghost-row modes: the same wrappers, counted apart, and plain
    # versions, per-axis
    pairs.update(sph_cells_density_slab=(
        functools.partial(sc.density_sums_cells, ghost_rows=True),
        sc.density_sums_cells_plain), sph_cells_hydro_slab=(
        functools.partial(sc.hydro_sums_cells, ghost_rows=True),
        sc.hydro_sums_cells_plain))
    # the vacuum slab step's modes: the same wrappers and plain versions
    pairs.update({n + VACUUM: pairs[n]
                  for n in SLAB_FORCE + SLAB_POT + SLAB_CELLS})
    return pairs


def occupied_flags(name: str, args: tuple):
    """The tile flags of ``args`` with every tile that holds a live target
    on and the others off: a vacuum grid's cells beyond the cloud, more
    than half of its domain cube, are empty, and a plain version switched
    on there sums nothing at full cost."""
    import torch
    i = FLAGS_ARG[name]
    ones = torch.ones_like(args[i])
    base = name.removesuffix(VACUUM)
    if base.startswith("shortrange_gravity_slab"):
        occ = (args[0][:, 5] > 0).any(-1)
    else:
        _, live, k, _, _ = _targets(base, args[:i] + (ones,) + args[i + 1:])
        occ = torch.zeros_like(ones, dtype=torch.bool)
        occ[k[live.any(1)]] = True
    return occ.to(ones.dtype)


def cases(name: str, recorded: dict) -> list:
    """(label, arguments) of each comparison on the arguments
    ``recorded[name]``: every tile on, every other tile gated off, and for
    kernels D and K also the last case without the Hubble-flow term; for
    E, F and G, all entries and every other entry switched off (-1); for
    the vacuum slab modes every occupied tile on (:func:`occupied_flags`).
    B and K have no tile flags."""
    import torch
    args = recorded[name]
    i = FLAGS_ARG.get(name)
    if name.removesuffix(VACUUM) in SLAB_CELLS:
        # the ghost-row modes: the cells that hold a target, K's flags on
        # the list that I/J's last sweep took too (its own flags are that
        # sweep's cells still iterating), and every other one of them
        hydro = name.replace("density", "hydro")
        on = recorded[hydro][FLAGS_ARG[hydro]]
        half = on.clone()
        half[1::2] = 0
        return [(label, args[:i] + (f,) + args[i + 1:])
                for label, f in (("target cells", on),
                                 ("every other target cell", half))]
    if name in ENTRIES + POTENTIAL_ENTRIES + ABS_ENTRIES:
        ids = args[i]
        if name.startswith("sph_density_entries"):
            # F's last call may be a later Newton sweep, which switched off
            # the entries whose lanes had converged; one entry list serves
            # density and hydro, so G's is the whole list
            hydro = name.replace("density", "hydro")
            ids = recorded[hydro][FLAGS_ARG[hydro]]
        off = ids.clone()
        off[1::2] = -1
        return [(label, args[:i] + (e,) + args[i + 1:])
                for label, e in (("all entries", ids),
                                 ("every other entry off", off))]
    out = [("all particles" if name in GATHER else "all tiles", args)]
    if name.endswith(VACUUM):
        out = [("every occupied tile", args[:i] + (occupied_flags(name, args),)
                + args[i + 1:])]
    elif i is not None:
        out = []
        for label in ("all tiles", "gated"):
            flags = torch.ones_like(args[i])
            if label == "gated":
                flags[1::2] = 0
            out.append((label, args[:i] + (flags,) + args[i + 1:]))
    if name in PARAMS_ARG:
        j = PARAMS_ARG[name]
        label, last = out[-1]
        params = last[j].clone()
        params[0] = 0.0
        out.append((f"{label}, no Hubble flow",
                    last[:j] + (params,) + last[j + 1:]))
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


def time_ms(fn, reps: int, warmup: bool = True):
    """(mean ms per call over ``reps`` calls after one warm-up call, none
    without ``warmup``, the last call's output), by CUDA events."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def _targets(name: str, args: tuple):
    """(target rows [K, 8, L], live targets [K, L], target cells or
    blocks [K], their smoothing lengths [K, L] for SPH or None, their
    particle indices [K, L] for hydro or None) of the tiles or entries that
    ``args`` switch on."""
    import torch
    name = name.removesuffix("_abs").removesuffix("_aniso")
    if name in ("shortrange_gravity", "shortrange_potential"):
        soa, flags = args[:2]
        k = torch.nonzero(flags > 0).flatten()
        return soa[k], soa[k, 5] > 0, k, None, None
    if name in ("shortrange_gravity_entries", "shortrange_potential_entries"):
        cell, tgt = args[1:3]
        e = torch.nonzero(cell >= 0).flatten()
        return tgt[e], tgt[e, 5] > 0, cell[e].long(), None, None
    if name == "sph_density":
        soa_e, _, h, flags = args[:4]
        k = torch.nonzero(flags > 0).flatten()
        return soa_e[k], soa_e[k, 3] > 0, k, h[k], None
    if name == "sph_density_entries":
        tgt, h, blk = args[1:4]
        e = torch.nonzero(blk >= 0).flatten()
        return tgt[e], tgt[e, 3] > 0, blk[e].long(), h[e], None
    if name == "sph_hydro":
        soa_a, idx_e, flags = args[0], args[3], args[5]
        k = torch.nonzero(flags > 0).flatten()
        return soa_a[k], idx_e[k] >= 0, k, soa_a[k, 7], idx_e[k]
    tgt16, tidx, blk = args[0], args[1], args[4]        # sph_hydro_entries
    e = torch.nonzero(blk >= 0).flatten()
    return (tgt16[e, :8], tgt16[e, 12] > 0, blk[e].long(), tgt16[e, 7],
            tidx[e])


def cells_pair_count(name: str, args: tuple) -> tuple:
    """:func:`pair_count` of the coarse-cell kernels I/J and K: the live
    pairs of the 27-cell stencil (sources of cells beyond a vacuum grid's
    edge left out), and those with r < h_i (density) or 0 < r <
    max(h_i, h_j) (hydro)."""
    import torch

    from gadget_leicester_tpu_torch.ops import sph_cells as sc
    density = name.startswith("sph_cells_density")
    if density:
        soa, h_slots, flags, n, box, periodic = args
        cells = torch.nonzero(flags > 0).flatten()
        live_row = 3
    else:
        soa, _, n, box, periodic, _ = args[:6]
        cells = torch.arange(soa.shape[0], device=soa.device) \
            if len(args) == 6 else torch.nonzero(args[6] > 0).flatten()
        live_row = 12
    stencil = in_cut = 0
    for k0 in range(0, cells.numel(), 64):
        k = cells[k0:k0 + 64]
        t = soa[k]
        s, inside = sc._gather_sources(soa, k, n, box, periodic,
                                       (0, 1, 2, 7, live_row))
        _, _, _, r, _, r2 = sc._pair_geometry(t, s)
        if density:
            ok = r < h_slots[k][:, :, None]
        else:
            ok = (r < torch.maximum(t[:, 7, :, None], s[3][:, None, :])) \
                & (r2 > 0.0)
        pair = (t[:, live_row] > 0)[:, :, None] \
            & ((s[4] > 0) & inside)[:, None, :]
        stencil += int(pair.sum())
        in_cut += int((pair & ok).sum())
    return stencil, in_cut


def gravity_cells_pair_count(args: tuple, flags=None) -> tuple:
    """:func:`pair_count` of kernel M: the live pairs of the 27-cell
    stencil on the absolute pack (cells beyond a clamped grid's edge left
    out), and those with 0 < r < rcut after the per-pair minimum image;
    with ``flags``, A's slab mode (per-axis cells and periodicity, the
    cells ``flags`` switches on)."""
    import torch

    from gadget_leicester_tpu_torch.ops.neighbors import per3, stencil_cells
    soa, n, box, periodic, _, rcut = args
    pv = per3(periodic)
    live = (soa[:, 5] > 0).any(-1)
    if flags is not None:
        live = live & (flags > 0)
    cells = torch.nonzero(live).flatten()
    stencil = in_cut = 0
    for k0 in range(0, cells.numel(), 64):
        k = cells[k0:k0 + 64]
        ids, _, inside = stencil_cells(n, k, periodic)
        t, s = soa[k], soa[ids]
        d2 = 0.0
        for a in range(3):
            d = t[:, a, :, None] - s[:, :, a].flatten(1)[:, None, :]
            if pv[a]:
                d = d - box * torch.round(d * (1.0 / box))
            d2 = d2 + d * d
        sl = ((s[:, :, 5] > 0) & inside[:, :, None]).flatten(1)
        pair = (t[:, 5] > 0)[:, :, None] & sl[:, None, :]
        r = torch.sqrt(d2)
        stencil += int(pair.sum())
        in_cut += int((pair & (r < rcut) & (r > 0.0)).sum())
    return stencil, in_cut


def pair_count(name: str, args: tuple) -> tuple:
    """(pairs of a live target and a live source in the target's stencil,
    the pairs among them inside the cut) over the tiles or entries that
    ``args`` switch on; for kernel B, its live slots twice."""
    import torch

    from gadget_leicester_tpu_torch.ops import gravity_short as gs
    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    if name == "pm_deposit":
        n = int((args[0][:, 3] != 0).sum())
        return n, n
    if name.removesuffix(VACUUM) in CELLS + SLAB_CELLS:
        return cells_pair_count(name.removesuffix(VACUUM), args)
    if name == "pm_gather":
        n = args[1].shape[0]
        return n, n
    if name == "shortrange_gravity_cells":
        return gravity_cells_pair_count(args)
    name = name.removesuffix(VACUUM)
    if name in ("shortrange_gravity_slab", "shortrange_gravity_slab_pot"):
        soa, flags, n, box, periodic, asmth, rcut = args
        return gravity_cells_pair_count((soa, n, box, periodic, asmth, rcut),
                                        flags)
    t_all, live_all, where_all, h_all, tid_all = _targets(name, args)
    absolute = name.endswith("_abs")
    grid_per = args[-1] if name.endswith("_aniso") else None
    name = name.removesuffix("_abs").removesuffix("_aniso")
    gravity = name.startswith("shortrange")
    if gravity:
        soa, n = args[0], args[3 if name.endswith("entries") else 2]
        box, rcut = args[-3], args[-1]
        s_live = soa[:, 3] != 0
    else:
        src = args[1] if name == "sph_density" else (
            args[0] if name == "sph_density_entries" else args[2])
        nb, lf = args[4 if "density" in name else 7 if name == "sph_hydro"
                      else 6], args[5 if "density" in name else 8
                                    if name == "sph_hydro" else 7]
        idx_o = args[4] if name == "sph_hydro" else (
            args[3] if name == "sph_hydro_entries" else None)
        s_live = (src[:, 12] > 0) if idx_o is not None else (src[:, 3] > 0)
    stencil = in_cut = 0
    step = 64 if gravity else 128
    for k0 in range(0, t_all.shape[0], step):
        t, live = t_all[k0:k0 + step], live_all[k0:k0 + step]
        where = where_all[k0:k0 + step]
        if gravity:
            ids, offs = gs.stencil_sources(n, where)
            shift = offs.to(soa.dtype) * (box / n)
            s = soa[ids]
            d2 = 0.0
            for a in range(3):
                sa = (s[:, :, a] + shift[None, :, a, None]).flatten(1)
                d = t[:, a, :, None] - sa[:, None, :]
                d2 = d2 + d * d
            ok = (d2 < rcut * rcut) & (d2 > 0.0)
            sl = s_live[ids].flatten(1)
        else:
            if grid_per is None:
                ids, units = sb.odd_sources(nb, where, not absolute)
            else:
                ids, units = sb.odd_sources(nb, where, grid_per,
                                            relative=True)
            rows, shift = sb._gather_sources(src, ids, units, lf, (0, 1, 2, 7))
            _, _, _, r, _ = sb._pair_geometry(t, rows, shift)
            h = h_all[k0:k0 + step][:, :, None]
            if idx_o is None:
                ok = r < h
                if absolute:   # the kernel skips targets with h = 0
                    live = live & (h[:, :, 0] > 0)
            else:
                ok = r < torch.maximum(h, rows[3][:, None, :])
                if absolute:
                    ok = ok & (r > 0.0)
                else:
                    sid = idx_o[ids].flatten(1)
                    ok = ok & (tid_all[k0:k0 + step][:, :, None]
                               != sid[:, None, :])
            sl = s_live[ids].flatten(1)
        pair = live[:, :, None] & sl[:, None, :]
        stencil += int(pair.sum())
        in_cut += int((pair & ok).sum())
    return stencil, in_cut


# Kernels A, H, C, D, E, F, G, I/J, K and M walk fewer pairs than their
# stencil holds, in the same order of sums (csrc/shortrange_gravity.cu,
# csrc/sph_density.cu, csrc/sph_hydro.cu,
# csrc/shortrange_gravity_entries.cu, csrc/sph_density_entries.cu,
# csrc/sph_hydro_entries.cu, csrc/sph_cells_density.cu,
# csrc/sph_cells_hydro.cu, csrc/shortrange_gravity_cells.cu). The bound above counts only the pairs inside
# the cut; these mirror each design's culling rules in float32 and count
# the pairs they leave to evaluate, which a share of the stencil pairs
# compares across designs. They are models of the kernels' walks, not
# counts taken in the kernels.
# A and H: live targets ranked per pass of A_THREADS slots by the Morton
# key of their position on an A_KEY_CELLS^3 grid over their cell, in warps
# of 32, each warp walking the live sources within rcut^2 CULL_MARGIN2 of
# its targets' bounding box. D: warps of 32 target lanes with a box of
# their valid targets and one of their parked targets (relative mode),
# each box walking the source subcells whose box of valid sources lies
# within max(h_max, h_s) of it and, in those, the valid sources within
# max(h_max, h_j) (squares times CULL_MARGIN2). C: D's walk with the reach
# of a target's h alone (source subcells' boxes of their sources with m >
# 0, whose h counts as 0), its valid targets those with m > 0 (and, in
# absolute mode, 0 < h < inf), its parked ones (relative mode) the rest.
# I/J: live targets (m > 0) ranked per pass of A_THREADS slots by the
# Morton key of their position on an A_KEY_CELLS^3 grid over the box of
# the pass's live targets, in warps of 32, each warp with the reach of its
# largest target h walking the chunks of 32 slots of its 27 stencil cells
# whose box of sources with m > 0, shifted, lies within reach and, in
# those, the sources with m > 0 within reach (squares times CULL_MARGIN2).
# K: I/J's walk over the valid sources (row 12) with the reach max(h_max,
# h_chunk) for a chunk (its largest source h) and max(h_max, h_s) for a
# source. F and G: :func:`_entries_walk`. E: :func:`entries_gravity_walk`;
# M: :func:`gravity_cells_walk` (I/J's ranking, A's walk with a torus-aware
# box test); A's slab mode: :func:`slab_gravity_walk` (whole-cell ranking,
# chunk boxes, then single sources).
A_THREADS = 128
A_KEY_CELLS = 8
CULL_MARGIN2 = 1.00002


def _morton_order(f, live, nt: int):
    """[K, P nt]: the slots of each pass of ``nt`` (the slots [K, P nt]
    padded to whole passes) in rank order: ``live`` ones by the Morton key
    of their cells ``floor(f)`` [K, 3, P nt] on an A_KEY_CELLS^3 grid, ties
    by slot, the others last."""
    import torch
    k, _, width = f.shape
    q = f.floor().clamp(0, A_KEY_CELLS - 1).long().view(k, 3, -1, nt)
    key = torch.zeros_like(q[:, 0])
    for bit in range(A_KEY_CELLS.bit_length() - 1):
        for a in range(3):
            key |= ((q[:, a] >> bit) & 1) << (3 * bit + 2 - a)
    key = torch.where(live.view(k, -1, nt), key, torch.full_like(key, 1 << 9))
    slot = torch.arange(nt, device=f.device)
    order = torch.argsort(key * nt + slot, dim=-1)
    base = torch.arange(0, width, nt, device=f.device)[:, None]
    return (order + base).view(k, width)


def gravity_walk(args: tuple, cells):
    """Kernel A's (and H's) walk over the target cells ``cells`` [K] of
    ``args``: (target coordinates [K, 3, W, 32] in the kernel's lane
    order, passes of A_THREADS slots one after another, their live mask
    [K, W, 32], the shifted source coordinates [K, 3, 27 cap], the sources
    each warp walks [K, W, 27 cap])."""
    import torch

    from gadget_leicester_tpu_torch.ops import gravity_short as gs
    soa, _, n, box, _, rcut = args
    dev, f32 = soa.device, torch.float32
    cap = soa.shape[2]
    nt = min(-(-cap // 32) * 32, A_THREADS)
    width = -(-cap // nt) * nt
    edge = torch.tensor(box / n, dtype=f32)   # the wrapper's c_float
    scale = (torch.tensor(float(A_KEY_CELLS), dtype=f32) / edge).to(dev)
    cull2 = float(torch.tensor(rcut * rcut, dtype=f32)
                  * torch.tensor(CULL_MARGIN2, dtype=f32))
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    t = torch.nn.functional.pad(soa[cells], (0, width - cap))
    live = t[:, 5] > 0
    order = _morton_order(t[:, :3] * scale + float(A_KEY_CELLS // 2), live,
                          nt)
    xyz = t[:, :3].gather(2, order[:, None].expand(-1, 3, -1))
    lv = live.gather(1, order)
    xyz, lv = xyz.view(-1, 3, width // 32, 32), lv.view(-1, width // 32, 32)
    lo = torch.where(lv[:, None], xyz, inf).amin(-1)          # [K, 3, W]
    hi = torch.where(lv[:, None], xyz, -inf).amax(-1)
    ids, offs = gs.stencil_sources(n, cells)
    s = soa[ids]                                              # [K, 27, 8, cap]
    sxyz = torch.stack([(s[:, :, a] + offs[None, :, a, None].to(f32)
                         * edge.item()).flatten(1) for a in range(3)], 1)
    d2 = 0.0
    for a in range(3):
        e = torch.clamp(torch.maximum(lo[:, a, :, None] - sxyz[:, None, a],
                                      sxyz[:, None, a] - hi[:, a, :, None]),
                        min=0.0)
        d2 = d2 + e * e
    near = (d2 < cull2) & (s[:, :, 3] != 0).flatten(1)[:, None, :]
    return xyz, lv, sxyz, near


def gravity_evaluated_pairs(args: tuple) -> int:
    """The pairs of a live target and a source that kernel A evaluates on
    ``args``."""
    import torch
    cells = torch.nonzero(args[1] > 0).flatten()
    total = 0
    for k0 in range(0, cells.numel(), 256):
        _, lv, _, near = gravity_walk(args, cells[k0:k0 + 256])
        total += int((near.sum(-1) * lv.sum(-1)).sum())
    return total


def _box(xyz, h, keep, width: int):
    """(lo, hi [K, 3, W], largest h [K, W]) of the lanes ``keep`` [K, L]
    of ``xyz`` [K, 3, L] and ``h`` [K, L] in groups of ``width``."""
    import torch
    inf = torch.tensor(float("inf"), dtype=xyz.dtype, device=xyz.device)
    pad = (0, -xyz.shape[-1] % width)
    x = torch.nn.functional.pad(xyz, pad).unflatten(-1, (-1, width))
    k = torch.nn.functional.pad(keep, pad).unflatten(-1, (-1, width))
    hh = torch.nn.functional.pad(h, pad).unflatten(-1, (-1, width))
    return (torch.where(k[:, None], x, inf).amin(-1),
            torch.where(k[:, None], x, -inf).amax(-1),
            torch.where(k, hh, torch.zeros_like(hh)).amax(-1))


def _near(tbox, sbox, shift):
    """[K, W, S]: kernel D's test of target boxes ``tbox`` (lo, hi [K, 3,
    W], h [K, W]) against source boxes ``sbox`` (lo, hi [K, 3, S], h [K,
    S]), per axis dx = (t - s) + ``shift`` [3][S] (None in absolute
    mode)."""
    import torch
    (lo, hi, ht), (slo, shi, hs) = tbox, sbox
    d2 = 0.0
    for a in range(3):
        e0 = lo[:, a, :, None] - shi[:, a, None, :]
        e1 = hi[:, a, :, None] - slo[:, a, None, :]
        if shift is not None:
            e0, e1 = e0 + shift[a], e1 + shift[a]
        e = torch.clamp(torch.maximum(e0, -e1), min=0.0)
        d2 = d2 + e * e
    hh = torch.maximum(ht[..., None], hs[:, None, :])
    return d2 < hh * hh * CULL_MARGIN2


def hydro_walk(args: tuple, blocks):
    """Kernel D's walk (either mode) over the even blocks ``blocks`` [K]
    of ``args``: (the target rows [K, 8, L], the source rows x, y, z, h
    [K, 8 L] of the 8 odd blocks and their shifts (None in absolute
    mode), and the pairs each lane walks [K, L, 8 L])."""
    import torch

    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    soa_a, soa_b, src16, _, _, _, _, nb, lf, _ = args
    lanes = soa_a.shape[2]
    sub = lanes // 8
    t = soa_a[blocks]
    valid = soa_b[blocks, 4] > 0
    parked = ~valid if lf is not None else torch.zeros_like(valid)
    ids, units = sb.odd_sources(nb, blocks, lf is not None)
    rows, shift = sb._gather_sources(src16, ids, units, lf, (0, 1, 2, 7))
    sv = (src16[ids][:, :, 12] > 0).flatten(1)
    sxyz = torch.stack(rows[:3], 1)                           # [K, 3, 8 L]
    cells = _box(sxyz, rows[3], sv, sub)                      # [K, ., 64]
    cell_shift = None if shift is None else [x[::sub] for x in shift]
    pairs = None
    for kind in (valid, parked):
        box = _box(t[:, :3], t[:, 7], kind, 32)
        need = _near(box, cells, cell_shift).repeat_interleave(sub, -1)
        near = _near(box, (sxyz, sxyz, rows[3]), shift) & need & sv[:, None]
        pairs = near if pairs is None else pairs | near      # [K, W, 8 L]
    pairs = pairs.repeat_interleave(32, dim=1)[:, :lanes]
    return t, rows, shift, (valid | parked)[..., None] & pairs


def hydro_evaluated_pairs(args: tuple) -> int:
    """The pairs of a valid target and a valid source that kernel D
    (either mode) evaluates on ``args``."""
    import torch
    blocks = torch.nonzero(args[5] > 0).flatten()
    total = 0
    for k0 in range(0, blocks.numel(), 32):
        bk = blocks[k0:k0 + 32]
        walk = hydro_walk(args, bk)[-1]
        total += int((walk & (args[1][bk, 4] > 0)[..., None]).sum())
    return total


def density_walk(args: tuple, blocks):
    """Kernel C's walk (either mode) over the even blocks ``blocks`` [K]
    of ``args``: (its valid targets [K, L], the pairs each lane walks [K,
    L, 8 L])."""
    import torch

    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    soa_e, soa_o, h, _, nb, lf = args
    lanes = soa_e.shape[2]
    sub = lanes // 8
    t, ht = soa_e[blocks], h[blocks]
    massive = t[:, 3] > 0
    if lf is None:
        valid = massive & (ht > 0) & torch.isfinite(ht)
        parked = torch.zeros_like(valid)
    else:
        valid, parked = massive, ~massive
    ids, units = sb.odd_sources(nb, blocks, lf is not None)
    rows, shift = sb._gather_sources(soa_o, ids, units, lf, (0, 1, 2, 3))
    sv = rows[3] > 0
    zero = torch.zeros_like(rows[3])
    sxyz = torch.stack(rows[:3], 1)                           # [K, 3, 8 L]
    cells = _box(sxyz, zero, sv, sub)                         # [K, ., 64]
    cell_shift = None if shift is None else [x[::sub] for x in shift]
    pairs = None
    for kind in (valid, parked):
        box = _box(t[:, :3], ht, kind, 32)
        need = _near(box, cells, cell_shift).repeat_interleave(sub, -1)
        near = _near(box, (sxyz, sxyz, zero), shift) & need & sv[:, None]
        pairs = near if pairs is None else pairs | near      # [K, W, 8 L]
    pairs = pairs.repeat_interleave(32, dim=1)[:, :lanes]
    return valid, (valid | parked)[..., None] & pairs


def density_evaluated_pairs(args: tuple) -> int:
    """The pairs of a valid target and a source with m > 0 that kernel C
    (either mode) evaluates on ``args``."""
    import torch
    blocks = torch.nonzero(args[3] > 0).flatten()
    total = 0
    for k0 in range(0, blocks.numel(), 32):
        valid, walk = density_walk(args, blocks[k0:k0 + 32])
        total += int((walk & valid[..., None]).sum())
    return total


def _ranked_by_box(xyz, live, whole: bool = False):
    """The targets ``xyz`` [K, 3, cap] of a cell, ``live`` [K, cap], as
    ``glt::rank_by_box`` orders them (kernels I/J, K and M): passes of
    A_THREADS slots (fewer for a smaller cap, whole warps), each ranked by
    the Morton key of its slots on an A_KEY_CELLS^3 grid over the box of
    the pass's live ones; with ``whole``, one pass of all the cell's slots
    (A's slab mode). Returns (the slot of each rank [K, P nt], the ranked
    coordinates [K, 3, W, 32] and live mask [K, W, 32], each warp's box
    lo, hi [K, 3, W])."""
    import torch
    k, _, cap = xyz.shape
    f32, dev = torch.float32, xyz.device
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    nt = -(-cap // 32) * 32
    if not whole:
        nt = min(nt, A_THREADS)
    width = -(-cap // nt) * nt
    x = torch.nn.functional.pad(xyz, (0, width - cap))
    live = torch.nn.functional.pad(live, (0, width - cap))
    xp, lv = x.view(k, 3, -1, nt), live.view(k, 1, -1, nt)
    lo = torch.where(lv, xp, inf).amin(-1, keepdim=True)
    hi = torch.where(lv, xp, -inf).amax(-1, keepdim=True)
    scale = torch.where(hi > lo, torch.tensor(float(A_KEY_CELLS), dtype=f32,
                                              device=dev) / (hi - lo),
                        torch.zeros_like(lo))
    order = _morton_order(((xp - lo) * scale).view(k, 3, width), live, nt)
    w = width // 32
    xyz = x.gather(2, order[:, None].expand(-1, 3, -1)).view(k, 3, w, 32)
    lvr = live.gather(1, order).view(k, w, 32)
    tlo = torch.where(lvr[:, None], xyz, inf).amin(-1)        # [K, 3, W]
    thi = torch.where(lvr[:, None], xyz, -inf).amax(-1)
    return order, xyz, lvr, tlo, thi


def _cells_walk(soa, ht_slots, live_row: int, h_row, n: int, box: float,
                periodic: bool, cells):
    """The walk of kernel I/J (``h_row`` None: the reach of the target's h
    alone) or K (``h_row`` the sources' h row: the reach max(h_max, h_s))
    over the target cells ``cells`` [K] of the pack ``soa``: targets with
    row ``live_row`` > 0 at smoothing lengths ``ht_slots`` [C, cap],
    sources with it > 0. Returns (the live targets [K, cap], the pairs
    each target slot walks [K, cap, 27 cap], both in slot order)."""
    import torch

    from gadget_leicester_tpu_torch.ops.neighbors import stencil_cells
    dev, f32 = soa.device, torch.float32
    k, cap = len(cells), soa.shape[2]
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    margin = torch.tensor(CULL_MARGIN2, dtype=f32, device=dev)
    t = soa[cells]
    live = t[:, live_row] > 0
    order, xyz, lvr, tlo, thi = _ranked_by_box(t[:, :3], live)
    w = lvr.shape[1]
    hr = torch.nn.functional.pad(ht_slots[cells], (0, 32 * w - cap)).gather(
        1, order).view(k, w, 32)
    reach = torch.where(lvr & ~torch.isnan(hr), hr, torch.zeros_like(hr))
    reach = reach.amax(-1).clamp(min=0.0)                     # [K, W]
    # the 27 stencil cells, their shifts and their chunk boxes
    ids, shift, inside = stencil_cells(n, cells, periodic)
    sh = shift.to(f32) * torch.tensor(box, dtype=f32)         # [K, 27, 3]
    s = soa[ids]                                              # [K, 27, R, cap]
    chunks = -(-cap // 32)
    cpad = (0, chunks * 32 - cap)
    on = torch.nn.functional.pad(s[:, :, live_row], cpad).view(
        k, 27, chunks, 32) > 0
    if h_row is None:
        hs = torch.zeros_like(s[:, :, 0])
    else:
        hs = torch.nan_to_num(s[:, :, h_row], nan=0.0)
    ch = torch.where(on, torch.nn.functional.pad(hs, cpad).view(
        k, 27, chunks, 32), torch.zeros((), device=dev)).amax(-1).clamp(
        min=0.0).flatten(1)                                   # [K, 27 ch]

    def within(lo_s, hi_s, h_s):
        """[K, W, S]: the box distance from the warps' boxes to the
        shifted source boxes [K, 3, S] below max(reach, h_s [K, S])."""
        d2 = 0.0
        for a in range(3):
            e = torch.clamp(torch.maximum(tlo[:, a, :, None] - hi_s[:, None, a],
                                          lo_s[:, None, a]
                                          - thi[:, a, :, None]), min=0.0)
            d2 = d2 + e * e
        hh = torch.maximum(reach[..., None], h_s[:, None, :])
        return d2 < hh * hh * margin

    sxyz, clo, chi = [], [], []
    for a in range(3):
        raw = torch.nn.functional.pad(s[:, :, a], cpad).view(k, 27, chunks,
                                                             32)
        clo.append((torch.where(on, raw, inf).amin(-1)
                    + sh[:, :, a, None]).flatten(1))
        chi.append((torch.where(on, raw, -inf).amax(-1)
                    + sh[:, :, a, None]).flatten(1))
        sxyz.append((s[:, :, a] + sh[:, :, a, None]).flatten(1))
    need = within(torch.stack(clo, 1), torch.stack(chi, 1), ch) \
        & inside.repeat_interleave(chunks, 1)[:, None, :]     # [K, W, 27 ch]
    need = need.repeat_interleave(32, -1).view(k, w, 27, chunks * 32)
    sxyz = torch.stack(sxyz, 1)                               # [K, 3, 27 cap]
    near = within(sxyz, sxyz, hs.flatten(1)) \
        & (s[:, :, live_row] > 0).flatten(1)[:, None, :] \
        & need[..., :cap].flatten(2)                          # [K, W, 27 cap]
    walked = lvr[..., None] & near[:, :, None, :]             # [K, W, 32, .]
    out = torch.zeros_like(walked.view(k, 32 * w, -1))
    out.scatter_(1, order[..., None].expand_as(out),
                 walked.view(k, 32 * w, -1))
    return live, out[:, :cap]


def cells_density_walk(args: tuple, cells):
    """Kernel I/J's walk (either grid) over the target cells ``cells``
    [K] of ``args``: (its live targets [K, cap], the pairs each target
    slot walks [K, cap, 27 cap], both in slot order)."""
    soa, h_slots, _, n, box, periodic = args
    return _cells_walk(soa, h_slots, 3, None, n, box, periodic, cells)


def cells_density_evaluated_pairs(args: tuple) -> int:
    """The pairs of a live target and a source with m > 0 that kernel I/J
    evaluates on ``args``."""
    import torch
    cells = torch.nonzero(args[2] > 0).flatten()
    total = 0
    for k0 in range(0, cells.numel(), 32):
        total += int(cells_density_walk(args, cells[k0:k0 + 32])[1].sum())
    return total


def cells_hydro_walk(args: tuple, cells):
    """Kernel K's walk (either grid) over the target cells ``cells`` [K]
    of ``args``: (its live targets [K, cap], the pairs each target slot
    walks [K, cap, 27 cap], both in slot order)."""
    soa16, _, n, box, periodic, _ = args
    return _cells_walk(soa16, soa16[:, 7], 12, 7, n, box, periodic, cells)


def cells_hydro_evaluated_pairs(args: tuple) -> int:
    """The pairs of a live target and a valid source that kernel K
    evaluates on ``args``."""
    import torch
    cells = torch.arange(args[0].shape[0], device=args[0].device)
    total = 0
    for k0 in range(0, cells.numel(), 32):
        total += int(cells_hydro_walk(args, cells[k0:k0 + 32])[1].sum())
    return total


def _entries_walk(src, t, ht, live, blk, nb: int, lf, valid_row: int,
                  h_row):
    """The walk of kernel F or G (either mode) over entries whose target
    rows are ``t`` [E, >=3, 8] (smoothing lengths ``ht`` [E, 8], live
    lanes ``live`` [E, 8]) on the even blocks ``blk`` [E]: a warp an
    entry, with the box of its live lanes and the reach of their largest
    h, walking the 32-slot chunks of its 8 odd blocks of ``src`` whose box
    of valid sources (row ``valid_row`` > 0) lies within reach and, in
    those, the valid sources within reach, each for all the entry's live
    lanes (squares times CULL_MARGIN2). With ``h_row`` the reach of a
    chunk or a source is max(the entry's, the largest source h of row
    ``h_row`` in it) (G); without, the entry's alone (F). Returns the
    pairs each lane walks [E, 8, 8 lanes]."""
    import torch

    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    lanes = src.shape[2]
    chunks = -(-lanes // 32)
    e = blk.shape[0]
    rows = (0, 1, 2, valid_row) + (() if h_row is None else (h_row,))
    ids, units = sb.odd_sources(nb, blk.long(), lf is not None)
    s, shift = sb._gather_sources(src, ids, units, lf, rows)
    sv = s[3] > 0                                             # [E, 8 L]
    sxyz = torch.stack(s[:3], 1)                              # [E, 3, 8 L]
    hs = torch.zeros_like(s[3]) if h_row is None else s[4]
    reach = torch.where(live & ~torch.isnan(ht), ht, torch.zeros_like(ht))
    box = _box(t[:, :3], reach, live, 8)                      # [E, ., 1]
    box = box[:2] + (box[2].clamp(min=0.0),)
    # the chunk boxes of each block, chunks padded to whole 32 slots
    cpad = (0, chunks * 32 - lanes)
    xyz_c = torch.nn.functional.pad(sxyz.view(e, 3, 8, lanes), cpad)
    sv_c = torch.nn.functional.pad(sv.view(e, 8, lanes), cpad)
    hs_c = torch.nn.functional.pad(hs.view(e, 8, lanes), cpad)
    chunk_boxes = _box(xyz_c.flatten(2), hs_c.flatten(1), sv_c.flatten(1),
                       32)                                    # [E, ., 8 ch]
    chunk_shift = None if shift is None else [
        x.view(8, lanes)[:, :1].expand(8, chunks).flatten() for x in shift]
    need = _near(box, chunk_boxes, chunk_shift).view(e, -1, 8, chunks)
    need = need.repeat_interleave(32, -1)[..., :lanes].flatten(2)
    near = _near(box, (sxyz, sxyz, hs), shift) & need & sv[:, None]
    return near & live[..., None]                             # [E, 8, 8 L]


def entries_density_walk(args: tuple, entries):
    """Kernel F's walk (either mode) over the entries ``entries`` [E] of
    ``args`` (:func:`_entries_walk` with the sources with m > 0 valid and
    the reach of the entry's h alone). Returns (the live lanes [E, 8], the
    pairs each lane walks [E, 8, 8 lanes])."""
    soa_o, tgt, h, blk, nb, lf = args
    t = tgt[entries]
    live = t[:, 3] > 0                                        # [E, 8]
    return live, _entries_walk(soa_o, t, h[entries], live, blk[entries], nb,
                               lf, 3, None)


def entries_hydro_walk(args: tuple, entries):
    """Kernel G's walk (either mode) over the entries ``entries`` [E] of
    ``args`` (:func:`_entries_walk` with the valid sources of row 12 and
    hydro's reach max(h_i, h_j): each chunk's and each source's h, row
    7). Returns (the live lanes [E, 8], the pairs each lane walks [E, 8,
    8 lanes])."""
    tgt16, _, src16, _, blk, _, nb, lf, _ = args
    t = tgt16[entries]
    live = t[:, 12] > 0                                       # [E, 8]
    return live, _entries_walk(src16, t, t[:, 7], live, blk[entries], nb,
                               lf, 12, 7)


def entries_evaluated_pairs(walk, blk_arg: int, args: tuple) -> int:
    """The pairs of a live lane and a valid source that an entries kernel
    (F or G, either mode) evaluates on ``args`` by the model of its walk
    ``walk`` (entry blocks in argument ``blk_arg``)."""
    import torch
    entries = torch.nonzero(args[blk_arg] >= 0).flatten()
    total = 0
    for k0 in range(0, entries.numel(), 16):
        total += int(walk(args, entries[k0:k0 + 16])[1].sum())
    return total


def entries_gravity_walk(args: tuple, entries):
    """Kernel E's walk (either mode) over the entries ``entries`` [E] of
    ``args``: a warp an entry, with the box of its live lanes and rcut as
    its reach, walking the 32-slot chunks of its 27 stencil cells whose
    box of sources with m > 0 lies within reach and, in those, the
    sources with m != 0 within reach, each for all the entry's live lanes
    (squares times CULL_MARGIN2; every box and source shifted by the
    stencil offset times the cell edge, as E takes dx = t - (s + shift)).
    Returns (the live lanes [E, 8], the pairs each lane walks [E, 8, 27
    cap], sources in stencil order)."""
    import torch

    from gadget_leicester_tpu_torch.ops import gravity_short as gs
    soa, entry_cell, tgt, n, box, _, rcut = args
    f32 = torch.float32
    cap = soa.shape[2]
    chunks = -(-cap // 32)
    t = tgt[entries]
    live = t[:, 5] > 0                                        # [E, 8]
    ids, offs = gs.stencil_sources(n, entry_cell[entries].long())
    edge = torch.tensor(box / n, dtype=f32)                   # the c_float
    sh = offs.to(f32) * edge.to(soa.device)                   # [27, 3]
    s = soa[ids]                                              # [E, 27, 8, cap]
    lo, hi, _ = _box(t[:, :3], t[:, 5], live, 8)              # [E, 3, 1]
    reach = torch.sqrt(torch.tensor(rcut * rcut, dtype=f32))
    cull = reach * reach * CULL_MARGIN2
    pad = (0, chunks * 32 - cap)
    valid = torch.nn.functional.pad(s[:, :, 3], pad).view(-1, 27, chunks,
                                                          32) > 0
    d2 = c2 = 0.0
    for a in range(3):
        sa = s[:, :, a] + sh[None, :, a, None]                # [E, 27, cap]
        e = torch.clamp(torch.maximum(lo[:, a, :, None] - sa,
                                      sa - hi[:, a, :, None]), min=0.0)
        d2 = d2 + e * e
        raw = torch.nn.functional.pad(s[:, :, a], pad).view(-1, 27, chunks,
                                                            32)
        clo = torch.where(valid, raw, torch.inf).amin(-1) + sh[None, :, a,
                                                               None]
        chi = torch.where(valid, raw, -torch.inf).amax(-1) + sh[None, :, a,
                                                                None]
        g = torch.clamp(torch.maximum(lo[:, a, :, None] - chi,
                                      clo - hi[:, a, :, None]), min=0.0)
        c2 = c2 + g * g                                       # [E, 27, ch]
    need = (c2 < cull).repeat_interleave(32, -1)[..., :cap]
    near = ((d2 < cull) & (s[:, :, 3] != 0) & need).flatten(1)
    return live, live[..., None] & near[:, None, :]


def entries_gravity_evaluated_pairs(args: tuple) -> int:
    """The pairs of a live lane and a source with m != 0 that kernel E
    (either mode) evaluates on ``args``."""
    import torch
    entries = torch.nonzero(args[1] >= 0).flatten()
    total = 0
    for k0 in range(0, entries.numel(), 64):
        total += int(entries_gravity_walk(args, entries[k0:k0 + 64])[1].sum())
    return total


def gravity_cells_walk(args: tuple, cells):
    """Kernel M's walk over the target cells ``cells`` [K] of ``args``:
    live targets (row 5 > 0) ranked as ``glt::rank_by_box`` ranks them,
    in warps of 32, each warp walking the sources with m != 0 of the
    stencil cells on the grid whose distance from its box, per axis that
    of the interval [lo - s, hi - s] of dx from the nearest multiple of
    the box on a periodic grid (0 where the interval spans half the box
    or more), from 0 on a clamped one, is below rcut (square times (1 +
    1e-6), clamped to the largest float, times CULL_MARGIN2). Returns (the
    ranked targets [K, 3, W, 32], their live mask [K, W, 32], the sources
    [K, 3, 27 cap], the sources each warp walks [K, W, 27 cap])."""
    import numpy as np
    import torch

    from gadget_leicester_tpu_torch.ops.neighbors import stencil_cells
    soa, n, box, periodic, _, rcut = args
    f32 = torch.float32
    t = soa[cells]
    _, xyz, lvr, tlo, thi = _ranked_by_box(t[:, :3], t[:, 5] > 0)
    ids, _, inside = stencil_cells(n, cells, periodic)
    s = soa[ids]                                              # [K, 27, 8, cap]
    sxyz = s[:, :, :3].transpose(1, 2).flatten(2)             # [K, 3, 27 cap]
    up = float(rcut) * float(rcut) * (1.0 + 1e-6)
    rcut2_up = torch.tensor(min(up, float(np.finfo(np.float32).max)),
                            dtype=f32)
    cull2 = rcut2_up * torch.tensor(CULL_MARGIN2, dtype=f32)  # inf at 1e30
    boxf = torch.tensor(box, dtype=f32, device=soa.device)
    inv_box = 1.0 / boxf
    d2 = 0.0
    for a in range(3):
        sa = sxyz[:, None, a]
        lo, hi = tlo[:, a, :, None] - sa, thi[:, a, :, None] - sa
        if periodic:
            kb = torch.round(0.5 * (lo + hi) * inv_box) * boxf
            e = None
            for k in (kb, kb - boxf, kb + boxf):
                g = torch.clamp(torch.maximum(lo - k, k - hi), min=0.0)
                e = g if e is None else torch.minimum(e, g)
            e = torch.where(hi - lo < 0.5 * boxf, e, torch.zeros_like(e))
        else:
            e = torch.clamp(torch.maximum(lo, -hi), min=0.0)
        d2 = d2 + e * e
    src = ((s[:, :, 3] != 0) & inside[:, :, None]).flatten(1)
    near = (d2 < cull2.to(soa.device)) & src[:, None, :]      # [K, W, 27 cap]
    return xyz, lvr, sxyz, near


def _image_gap(lo, hi, boxf, periodic: bool):
    """The distance of the intervals [lo, hi] of dx from the nearest
    multiple of the box ``boxf`` on a periodic axis (0 where an interval
    spans half the box or more), from 0 on a clamped one: the kernels'
    ``image_gap``."""
    import torch
    if not periodic:
        return torch.clamp(torch.maximum(lo, -hi), min=0.0)
    kb = torch.round(0.5 * (lo + hi) * (1.0 / boxf)) * boxf
    e = None
    for k in (kb, kb - boxf, kb + boxf):
        g = torch.clamp(torch.maximum(lo - k, k - hi), min=0.0)
        e = g if e is None else torch.minimum(e, g)
    return torch.where(hi - lo < 0.5 * boxf, e, torch.zeros_like(e))


def slab_gravity_walk(args: tuple, cells, ranked=None):
    """Kernel A's slab mode's walk (either mode) over the target cells
    ``cells`` [K] of ``args``: every cell's live slots (row 5 > 0) ranked
    whole by ``glt::rank_by_box``'s key, a warp a chunk of 32 ranks; a warp
    takes the chunks of its stencil's cells on the grid whose box of live
    ranks lies within the cut of its box (per axis by :func:`_image_gap` on
    the axes of the image mask), and of those the sources with m != 0
    within the cut of its box (rcut squared times (1 + 1e-6), clamped to
    the largest float, times CULL_MARGIN2). ``ranked``: the ranking of
    every cell of the grid, :func:`slab_ranked` (made here if None).
    Returns (the ranked targets [K, 3, W, 32], their live mask [K, W, 32],
    the ranked sources of the stencil [K, 3, 27 W 32], the sources each
    warp walks [K, W, 27 W 32])."""
    import numpy as np
    import torch

    from gadget_leicester_tpu_torch.ops.neighbors import per3, stencil_cells
    soa, _, n, box, periodic, _, rcut = args
    f32, dev = torch.float32, soa.device
    xyz_all, m_all, lo_all, hi_all = ranked or slab_ranked(soa)
    w = lo_all.shape[-1]
    pv = per3(periodic)
    ids, _, inside = stencil_cells(n, cells, pv)              # [K, 27]
    up = float(rcut) * float(rcut) * (1.0 + 1e-6)
    cull2 = (torch.tensor(min(up, float(np.finfo(np.float32).max)),
                          dtype=f32)
             * torch.tensor(CULL_MARGIN2, dtype=f32)).to(dev)  # inf at 1e30
    boxf = torch.tensor(box, dtype=f32, device=dev)
    tlo, thi = lo_all[cells], hi_all[cells]                   # [K, 3, W]
    slo = lo_all[ids].transpose(1, 2).flatten(2)              # [K, 3, 27 W]
    shi = hi_all[ids].transpose(1, 2).flatten(2)
    sxyz = xyz_all[ids].transpose(1, 2).flatten(2)            # [K, 3, 27 W 32]
    c2 = s2 = 0.0
    for a in range(3):
        e = _image_gap(tlo[:, a, :, None] - shi[:, None, a],
                       thi[:, a, :, None] - slo[:, None, a], boxf, pv[a])
        c2 = c2 + e * e
        sa = sxyz[:, None, a]
        e = _image_gap(tlo[:, a, :, None] - sa, thi[:, a, :, None] - sa,
                       boxf, pv[a])
        s2 = s2 + e * e
    chunk = (c2 < cull2) & inside.repeat_interleave(w, 1)[:, None, :]
    src = (m_all[ids] != 0).flatten(1)[:, None, :]            # [K, 1, 27 W 32]
    near = chunk.repeat_interleave(32, -1) & (s2 < cull2) & src
    return (xyz_all[cells].unflatten(-1, (w, 32)), _slab_live(soa, cells, w),
            sxyz, near)


def slab_ranked(soa):
    """(ranked coordinates [C, 3, W 32] and masses [C, W 32], zeros past
    the live ranks; each chunk's box lo, hi [C, 3, W]) of every cell of the
    pack ``soa``, as A's slab mode's ranking launch writes them."""
    import torch
    c, _, cap = soa.shape
    out = [], [], [], []
    for c0 in range(0, c, 4096):
        t = soa[c0:c0 + 4096]
        live = t[:, 5] > 0
        order, xyz, lvr, lo, hi = _ranked_by_box(t[:, :3], live, whole=True)
        k, _, w, _ = xyz.shape
        lv = lvr.flatten(1)
        m = torch.nn.functional.pad(t[:, 3], (0, 32 * w - cap)).gather(
            1, order)
        out[0].append(torch.where(lv[:, None], xyz.flatten(2), 0.0))
        out[1].append(torch.where(lv, m, 0.0))
        out[2].append(lo)
        out[3].append(hi)
    return tuple(torch.cat(o) for o in out)


def _slab_live(soa, cells, w: int):
    """[K, W, 32]: the ranks of cells ``cells`` that hold a live slot (the
    first ones: parked slots rank last)."""
    import torch
    n_in = (soa[cells, 5] > 0).sum(-1)
    r = torch.arange(32 * w, device=soa.device)
    return (r[None] < n_in[:, None]).view(len(cells), w, 32)


def slab_evaluated_pairs(args: tuple) -> int:
    """The pairs of a live target and a source that kernel A's slab mode
    (either mode) tests for the cut on ``args``: each near source of a
    warp's walk (:func:`slab_gravity_walk`) against each of its live
    lanes, the cheap part; the dear part then takes only the pairs inside
    the cut's square."""
    import torch
    cells = torch.nonzero(args[1] > 0).flatten()
    ranked = slab_ranked(args[0])
    total = 0
    for k0 in range(0, cells.numel(), 64):
        _, lv, _, near = slab_gravity_walk(args, cells[k0:k0 + 64], ranked)
        total += int((near.sum(-1) * lv.sum(-1)).sum())
    return total


def gravity_cells_evaluated_pairs(args: tuple) -> int:
    """The pairs of a live target and a source that kernel M evaluates on
    ``args``."""
    import torch
    cells = torch.nonzero((args[0][:, 5] > 0).any(-1)).flatten()
    total = 0
    for k0 in range(0, cells.numel(), 64):
        _, lv, _, near = gravity_cells_walk(args, cells[k0:k0 + 64])
        total += int((near.sum(-1) * lv.sum(-1)).sum())
    return total


EVALUATED = {"shortrange_gravity": gravity_evaluated_pairs,
             "shortrange_gravity_entries": entries_gravity_evaluated_pairs,
             "shortrange_potential_entries": entries_gravity_evaluated_pairs,
             "shortrange_gravity_cells": gravity_cells_evaluated_pairs,
             "shortrange_potential": gravity_evaluated_pairs,
             "sph_cells_density": cells_density_evaluated_pairs,
             "sph_cells_hydro": cells_hydro_evaluated_pairs,
             "sph_density_entries": functools.partial(
                 entries_evaluated_pairs, entries_density_walk, 3),
             "sph_density_entries_abs": functools.partial(
                 entries_evaluated_pairs, entries_density_walk, 3),
             "sph_hydro_entries": functools.partial(
                 entries_evaluated_pairs, entries_hydro_walk, 4),
             "sph_hydro_entries_abs": functools.partial(
                 entries_evaluated_pairs, entries_hydro_walk, 4),
             "sph_density": density_evaluated_pairs,
             "sph_density_abs": density_evaluated_pairs,
             "sph_hydro": hydro_evaluated_pairs,
             "sph_hydro_abs": hydro_evaluated_pairs,
             **{n: slab_evaluated_pairs for n in (
                 "shortrange_gravity_slab", "shortrange_gravity_slab_pot",
                 "shortrange_gravity_slab_vacuum",
                 "shortrange_gravity_slab_pot_vacuum")}}

# the times of kernels C, H, I/J, K, F, G, B, E and M in their earlier
# designs (one thread a target walking every staged source of its
# stencil, M also; F, G and E one warp an entry walking every slot; B one
# thread a slot with 8 global atomics), on the same paths' arguments, on
# an NVIDIA H100 80GB HBM3 at 700 W as PERF.md records them: C's relative
# mode and B on the main path's last full-active sync point (phase 6),
# C's absolute mode on the vacuum cloud at 64 slots a subcell (phase 12b),
# H on the step with sinks (phase 14), I/J and K on the cells path (phase
# 8b), E and F's and G's relative mode at the near-idle sync point (phase
# 8), E's potential mode at the near-idle sync point with sinks (phase
# 14), M on the fresh list of phase 12, F's and G's absolute mode on the
# vacuum cloud at 1% active (phase 12b) and on the disc's own arguments at
# the sync point of the most live lanes of phase 15's run()
# (:func:`busiest_entries`)
EARLIER_MS = {"sph_density": 8.665, "sph_density_abs": 12.776,
              "shortrange_potential": 29.156, "sph_cells_density": 10.689,
              "sph_cells_hydro": 14.880, "sph_density_entries": 0.266,
              "sph_density_entries_abs": 0.316,
              "sph_density_entries_abs_disc": 1.988,
              "sph_hydro_entries": 0.376, "sph_hydro_entries_abs": 0.385,
              "sph_hydro_entries_abs_disc": 2.091,
              "pm_deposit": 0.281, "shortrange_gravity_entries": 0.595,
              "shortrange_potential_entries": 0.763,
              "shortrange_gravity_cells": 25.849,
              # A's slab mode on M's kernel: phases 18 and 19; with the
              # potential in vacuum, on no path, timed first in turns with
              # its redesign (PERF.md section 6)
              "shortrange_gravity_slab": 33.746,
              "shortrange_gravity_slab_pot": 53.271,
              "shortrange_gravity_slab_vacuum": 36.064,
              "shortrange_gravity_slab_pot_vacuum": 60.640}
# the fragment of each kernel's mangled name in nvcc's -Xptxas=-v output
# (:func:`ptxas_registers`)
PTXAS_NAME = {"shortrange_gravity": "shortrange_gravity_kernelILb0E",
              "shortrange_potential": "shortrange_gravity_kernelILb1E",
              "sph_density": "sph_density_kernelILb0ELb0E",
              "sph_density_abs": "sph_density_kernelILb1ELb0E",
              "sph_density_aniso": "sph_density_kernelILb0ELb1E",
              "sph_cells_density": "sph_cells_density_kernel",
              "sph_cells_hydro": "sph_cells_hydro_kernel",
              "sph_density_entries": "sph_density_entries_kernelILb0E",
              "sph_density_entries_abs": "sph_density_entries_kernelILb1E",
              "sph_density_entries_abs_disc":
                  "sph_density_entries_kernelILb1E",
              "sph_hydro_entries": "sph_hydro_entries_kernelILb0E",
              "sph_hydro_entries_abs": "sph_hydro_entries_kernelILb1E",
              "sph_hydro_entries_abs_disc": "sph_hydro_entries_kernelILb1E",
              "pm_deposit": "pm_deposit_kernel",
              "shortrange_gravity_entries":
                  "shortrange_gravity_entries_kernelILb0E",
              "shortrange_potential_entries":
                  "shortrange_gravity_entries_kernelILb1E",
              "shortrange_gravity_cells": "shortrange_gravity_cells_kernel",
              "shortrange_gravity_slab": "slab_gravity_kernelILi6ELb0E",
              "shortrange_gravity_slab_pot": "slab_gravity_kernelILi6ELb1E",
              "shortrange_gravity_slab_vacuum":
                  "slab_gravity_kernelILi0ELb0E",
              "shortrange_gravity_slab_pot_vacuum":
                  "slab_gravity_kernelILi0ELb1E",
              "slab_rank": "slab_rank_kernel"}


def ptxas_registers(fragment: str) -> list:
    """[(entry function, registers)] of the kernels whose mangled name
    holds ``fragment``, from nvcc's ``-Xptxas=-v`` output of this run's
    build."""
    from gadget_leicester_tpu_torch import kernels
    out, name = [], None
    for line in kernels.build_info.get("log", "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line and "Used" in line and name is not None:
            if fragment in name:
                out.append((name, int(line.split("Used")[1].split()[0])))
            name = None
    return out


def say_against_earlier(phase: str, results: dict, name: str,
                        card: str) -> None:
    """A kernel's time in ``results`` beside :data:`EARLIER_MS` and its
    bound, the share of its stencil pairs that the model of its walk
    evaluates, and its registers."""
    r = results[name]
    regs = [n for _, n in ptxas_registers(PTXAS_NAME[name])]
    walk = ""
    if "evaluated" in r:
        walk = (f"; the model of its walk evaluates "
                f"{100 * r['evaluated'] / max(r['pairs'], 1):.1f}% of the "
                "stencil pairs")
    say(phase, f"{name} {r['ms']:.3f} ms against the earlier design's "
        f"{EARLIER_MS[name]:.3f} ms (NVIDIA H100 80GB HBM3, 700 W, as "
        f"PERF.md records it): {r['ms'] / EARLIER_MS[name]:.2f}x; bound "
        f"{r['bound_ms']:.3f} ms, {100 * r['bound_ms'] / r['ms']:.1f}% of "
        f"the time (was {100 * r['bound_ms'] / EARLIER_MS[name]:.1f}%)"
        f"{walk}; registers {regs} ({card})")


# for each SPH entries kernel: which argument is its source pack, and how
# many of the pack's rows it reads for a source slot (F: x, y, z, m, vx,
# vy, vz; G: rows 0-12); E: :func:`gravity_entries_bytes`
ENTRY_SOURCES = {"sph_density_entries": (0, 7), "sph_hydro_entries": (2, 13)}


def gravity_entries_bytes(args: tuple) -> int:
    """The bytes kernel E (either mode) must read of ``args``: of the
    cells its switched-on entries reach, the mass (row 3) of every slot,
    x, y, z (rows 0-2) of the slots with m != 0, and soft and 1/soft (rows
    4, 6) of those within rcut (0 < r2 < rcut^2) of a live lane of an
    entry that reaches them, each once; entry_cell and tgt whole."""
    import torch

    from gadget_leicester_tpu_torch.ops import gravity_short as gs
    soa, entry_cell, tgt, n, box, _, rcut = args
    cap, size = soa.shape[2], soa.element_size()
    e_on = torch.nonzero(entry_cell >= 0).flatten()
    ids_all = gs.stencil_sources(n, entry_cell[e_on].long())[0]
    reached = torch.unique(ids_all)
    packed = int((soa[reached, 3] != 0).sum())
    needed = torch.zeros(soa.shape[0] * cap, dtype=torch.bool,
                         device=soa.device)
    slots = torch.arange(cap, device=soa.device)
    for k0 in range(0, e_on.numel(), 64):
        e = e_on[k0:k0 + 64]
        ids, offs = gs.stencil_sources(n, entry_cell[e].long())
        shift = offs.to(soa.dtype) * (box / n)
        t, s = tgt[e], soa[ids]
        d2 = 0.0
        for a in range(3):
            sa = (s[:, :, a] + shift[None, :, a, None]).flatten(1)
            d = t[:, a, :, None] - sa[:, None, :]
            d2 = d2 + d * d
        near = ((d2 < rcut * rcut) & (d2 > 0.0)
                & (t[:, 5] > 0)[:, :, None]).any(1) \
            & (s[:, :, 3] != 0).flatten(1)                    # [E, 27 cap]
        flat = (ids.long()[:, :, None] * cap + slots).flatten(1)
        needed[flat[near]] = True
    return (reached.numel() * cap + 3 * packed + 2 * int(needed.sum())) \
        * size + sum(a.numel() * a.element_size() for a in (entry_cell, tgt))


def entries_bytes(name: str, args: tuple) -> int:
    """The bytes an entries kernel (E, F, G, either mode) must read of
    ``args``: E's by :func:`gravity_entries_bytes`; for F and G the rows
    they read of each source block that their switched-on entries reach,
    each once (for G in relative mode also their particle indices), and
    their other tensor arguments whole (G in absolute mode reads no
    particle index)."""
    import torch

    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    absolute = name.endswith("_abs")
    base = name.removesuffix("_abs")
    if base.startswith("shortrange"):
        return gravity_entries_bytes(args)
    where = _targets(name, args)[2]
    nb = args[4] if base == "sph_density_entries" else args[6]
    ids = sb.odd_sources(nb, where, not absolute)[0]
    reached = torch.unique(ids).numel()
    src, rows = ENTRY_SOURCES[base]
    lanes = args[src].shape[2]
    nbytes = reached * rows * lanes * args[src].element_size()
    skip = {src}
    if base == "sph_hydro_entries":     # tidx 1, idx_o 3
        skip |= {1, 3} if absolute else {3}
        if not absolute:
            nbytes += reached * lanes * args[3].element_size()
    return nbytes + sum(a.numel() * a.element_size()
                        for i, a in enumerate(args)
                        if torch.is_tensor(a) and i not in skip)


def gather_bytes(args: tuple) -> int:
    """Bytes kernel L must read: the positions, and once each mesh cell
    that some particle's 8 corners name (a vacuum mesh's particles fill
    one octant of it, the zoom's fine mesh a part of that)."""
    import torch
    field, pos, box, n = args
    i0 = torch.remainder(torch.floor(pos * (n / box)).long(), n)
    ids = torch.cat([((i0[:, 0] + dx) % n * n + (i0[:, 1] + dy) % n) * n
                     + (i0[:, 2] + dz) % n for dx in (0, 1)
                     for dy in (0, 1) for dz in (0, 1)])
    cells = torch.unique(ids).numel()
    return pos.numel() * pos.element_size() \
        + cells * field.shape[-1] * field.element_size()


def deposit_bytes(args: tuple) -> int:
    """The bytes kernel B must read of its pack ``args[0]`` [C, 8, cap]:
    the mass (row 3) of every slot, and x, y, z and the packed flag (rows
    0-2, 5) of the slots with m != 0, each once."""
    soa = args[0]
    packed = int((soa[:, 3] != 0).sum())
    return (soa.shape[0] * soa.shape[2] + 4 * packed) * soa.element_size()


def cells_bytes(name: str, args: tuple) -> int:
    """The bytes kernel I/J or K (either mode) must move for ``args``: of
    the cells it sums (those its flags switch on; K without flags, all)
    and the cells of their 27-cell stencils on the grid, the rows it reads
    of each live slot (I/J: x, y, z, m, vx, vy, vz, with m > 0; K: rows
    0-12, with valid > 0), each once; the smoothing length of each live
    slot it sums (I/J's h_slots; K's is in its rows), the flags and K's two
    parameters; and the output rows of each live slot it sums (I/J 6, K
    5). Parked slots and cells that no summed cell reaches are neither
    read nor written for the function: a slab's coarse cells hold ~21 gas
    in 112 slots, and a vacuum grid's cells beyond the cloud are empty."""
    import torch

    from gadget_leicester_tpu_torch.ops.neighbors import stencil_cells
    if name.removesuffix(VACUUM).startswith("sph_cells_density"):
        soa, h_slots, flags, n, _, periodic = args
        live_row, rows, out_rows = 3, 7, 6
        extra = h_slots.element_size()
        side = flags.numel() * flags.element_size()
    else:
        soa, params, n, _, periodic = args[:5]
        flags = args[6] if len(args) > 6 else None
        live_row, rows, out_rows, extra = 12, 13, 5, 0
        side = params.numel() * params.element_size() + (
            0 if flags is None else flags.numel() * flags.element_size())
    summed = torch.arange(soa.shape[0], device=soa.device) if flags is None \
        else torch.nonzero(flags > 0).flatten()
    live = soa[:, live_row] > 0                            # [C, cap]
    reached = torch.zeros(soa.shape[0], dtype=torch.bool, device=soa.device)
    for k0 in range(0, summed.numel(), 4096):
        ids, _, inside = stencil_cells(n, summed[k0:k0 + 4096], periodic)
        reached[ids[inside]] = True
    n_src, n_tgt = int(live[reached].sum()), int(live[summed].sum())
    return (rows * n_src + out_rows * n_tgt) * soa.element_size() \
        + extra * n_tgt + side


def kernel_bound(name: str, args: tuple, out) -> dict:
    """The least time the card could take for what a kernel computes on
    ``args`` (into ``out``), by the rule at PEAK_FLOPS; an entries kernel
    counts only the sources its switched-on entries reach
    (:func:`entries_bytes`), kernel B only the rows of its pack that it
    must read (:func:`deposit_bytes`), kernel L only the mesh cells its
    particles' corners name (:func:`gather_bytes`), kernels I/J and K,
    either mode, only the live slots they read and write
    (:func:`cells_bytes`, their output included)."""
    import torch
    stencil, in_cut = pair_count(name, args)
    if name.removesuffix(VACUUM) in CELLS + SLAB_CELLS:
        nbytes = cells_bytes(name, args)
    else:
        if name in ENTRIES + POTENTIAL_ENTRIES + ABS_ENTRIES:
            nbytes = entries_bytes(name, args)
        elif name == "pm_deposit":
            nbytes = deposit_bytes(args)
        elif name == "pm_gather":
            nbytes = gather_bytes(args)
        else:
            nbytes = sum(a.numel() * a.element_size() for a in args
                         if torch.is_tensor(a))
        nbytes += out.numel() * out.element_size()
    if name == "pm_deposit":
        ops = stencil * OPS_PER_DEPOSIT
    elif name == "pm_gather":
        ops = stencil * (15 + 8 * (2 + 2 * args[0].shape[-1]))
    elif name == "shortrange_gravity_cells":
        periodic, asmth = args[3], args[4]
        ops = in_cut * (OPS_PER_PAIR["shortrange_gravity"] + 2
                        + (MIN_IMAGE_OPS if periodic else 0)
                        - (0 if asmth > 0 else TRUNC_OPS))
    elif name.removesuffix(VACUUM) in ("shortrange_gravity_slab",
                                       "shortrange_gravity_slab_pot"):
        periodic, asmth = args[4], args[5]
        pot = (OPS_PER_PAIR["shortrange_potential"]
               - OPS_PER_PAIR["shortrange_gravity"]
               if name.removesuffix(VACUUM) == "shortrange_gravity_slab_pot"
               else 0)
        ops = in_cut * (OPS_PER_PAIR["shortrange_gravity"] + 2 + pot
                        + MIN_IMAGE_OPS // 3 * sum(periodic)
                        - (0 if asmth > 0 else TRUNC_OPS))
    else:
        ops = in_cut * OPS_PER_PAIR[name.removesuffix(VACUUM)]
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return {"pairs": stencil, "in_cut": in_cut, "ops": ops, "bytes": nbytes,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def thinned(name: str, args: tuple, every: int) -> tuple:
    """``args`` with only every ``every``-th tile or entry left on."""
    i = FLAGS_ARG[name]
    x = args[i].clone()
    keep = x[::every].clone()
    x.fill_(-1 if name in ENTRIES + POTENTIAL_ENTRIES + ABS_ENTRIES else 0)
    x[::every] = keep
    return args[:i] + (x,) + args[i + 1:]


def check_kernels(recorded: dict, where: str, results: dict, names,
                  timed: bool = False, every: int = 1,
                  n_cases: int | None = None) -> None:
    """Each kernel of ``names`` against its plain version on the arguments
    the path gave its wrapper (``recorded``), in every case of
    :func:`cases`, by :func:`compare`; with ``timed``, each one's time
    beside its plain version's in the first case (all tiles or entries).
    With ``every`` > 1 the comparisons switch on only every ``every``-th
    tile or entry of each case (the timing keeps them all), where the
    float64 plain version of the whole would take minutes. ``n_cases``:
    the first cases of :func:`cases` only."""
    pairs = kernel_pairs()
    for name in names:
        if name not in recorded:
            raise AssertionError(f"the path never called kernel {name}")
        kern, plain = pairs[name]
        r = results.setdefault(name, {})
        r.setdefault("max_abs_err", 0.0)
        for n, (case, args) in enumerate(cases(name, recorded)[:n_cases]):
            if timed and n == 0:
                r["ms"], got = time_ms(lambda: kern(*args), reps=5)
                # a plain version of seconds a call needs no warm-up
                r["plain_ms"], want = time_ms(lambda: plain(*args), reps=1,
                                              warmup=every == 1)
                r.update(kernel_bound(name, args, got))
                if name in EVALUATED:
                    r["evaluated"] = EVALUATED[name](args)
            if every > 1:
                case, args = f"{case}, every {every}th", thinned(name, args,
                                                                  every)
            if every > 1 or not (timed and n == 0):
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
                f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.3f} ms by "
                f"{r['bound_by']} ({r['pairs']} stencil pairs or slots, "
                f"{r['in_cut']} inside the cut, {r['ops']:.4g} operations, "
                f"{r['bytes']} bytes): bound / kernel time "
                f"{100 * r['bound_ms'] / r['ms']:.1f}%")
            if "evaluated" in r:
                share = 100 * r["evaluated"] / max(r["pairs"], 1)
                say("kernels", f"{name} {where}: the mirror of its walk "
                    f"evaluates {r['evaluated']} pairs, {share:.1f}% of the "
                    "stencil pairs")


def check_potential_forces(recorded: dict, where: str) -> None:
    """Kernel H's force rows against kernel A on H's arguments: H's
    distance from A's plain version in float64 within A's bound of
    :func:`compare`."""
    pairs = kernel_pairs()
    args = recorded["shortrange_potential"]
    h = pairs["shortrange_potential"][0](*args)[:, :3]
    a_kern, a_plain = pairs["shortrange_gravity"]
    diff = float((h - a_kern(*args)).abs().max())
    _, k, p, used = compare("shortrange_gravity", h, a_plain(*args),
                            a_plain(*as_float64(args)))
    say("kernels", f"shortrange_potential rows 0-2 vs shortrange_gravity "
        f"{where}: max |H - A| {diff:.3e}; from A's float64 plain version: "
        f"H {k:.2e}, plain float32 {p:.2e} of the largest value "
        f"{'ok' if used <= 1.0 else 'FAIL'}")
    if used > 1.0:
        raise AssertionError(f"kernel H's forces disagree with kernel A "
                             f"({where})")


def record_idle_sinks(device, n_side: int) -> tuple:
    """The arguments the step gives E's potential mode and kernel H with
    the in-step potential (sinks on): the lcdm_gas box at ``n_side`` after
    ``set_ics`` and one sync point, made near-idle (:func:`make_near_idle`),
    then one sync point through the entries tier and one with the tier
    forced dense (the step's cached pack and its gated tile flags).
    Returns (entries recording, dense recording)."""
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg, opts, (pos, vel, mass, ptype, u) = setup(n_side, sinks=True)
    sim = Simulation(cfg, opts, device)
    sim.set_ics(pos, vel, mass, ptype, u=u)
    sim.step()
    idle = make_near_idle(sim.state, IDLE_FRAC_SMALL, IDLE_SEED)
    out = []
    for force, name in ((None, "shortrange_potential_entries"),
                        (False, "shortrange_potential")):
        sim.state = copy.deepcopy(idle)
        with recorded_inputs() as rec, tier(force) as log:
            sim.step()
        if log[0][3] != (force is None) or name not in rec:
            raise AssertionError(f"the near-idle sync point with sinks did "
                                 f"not call {name}")
        out.append(dict(rec))
    return tuple(out)


def check_step_potential_forces(recorded: dict, where: str) -> None:
    """Kernel H's force rows equal kernel A's bit for bit on the arguments
    a step gave H: with the step's own tile flags, and with every tile
    on."""
    import torch
    pairs = kernel_pairs()
    h_kern, a_kern = (pairs[n][0] for n in ("shortrange_potential",
                                            "shortrange_gravity"))
    step_args = recorded["shortrange_potential"]
    for label, args in (("the step's tile flags", step_args),
                        ("all tiles", cases("shortrange_potential",
                                            recorded)[0][1])):
        h, a = h_kern(*args)[:, :3], a_kern(*args)
        same = torch.equal(h, a)
        say("kernels", f"shortrange_potential rows 0-2 vs shortrange_gravity "
            f"{where}, {label}: max |H - A| {float((h - a).abs().max()):.3e}"
            f", bit for bit {'yes' if same else 'NO'}")
        if not same:
            raise AssertionError(f"kernel H's forces are not kernel A's bit "
                                 f"for bit ({where}, {label})")


def phase_kernels(results: dict, device="cuda", n_small=N_SIDE_SMALL):
    recorded = record_init(n_small, device)
    check_kernels(recorded, f"n_side={n_small}", results, DENSE + POTENTIAL)
    check_potential_forces(recorded, f"n_side={n_small}")
    # I/J and K: the small box under the coarse-cell backend (periodic)
    # and a vacuum blob, each at both capacities
    for grid, cap in SMALL_CELL_GRIDS:
        recorded = record_init(n_small, device, sph_backend="cells",
                               sph_grid=grid, sph_capacity=cap)
        check_kernels(recorded, f"n_side={n_small} periodic {grid}^3 cells "
                      f"x {cap}", results, CELLS)
        recorded = record_vacuum_blob(device, grid, cap)
        check_kernels(recorded, f"vacuum blob {grid}^3 cells x {cap}",
                      results, CELLS)
    # L: 3 and 4 components, fresh and drifted positions
    for k in (3, 4):
        for drifted in (False, True):
            recorded = record_gather_small(device, n_small, k, drifted)
            check_kernels(recorded, f"n_side={n_small} K={k} "
                          f"{'drifted' if drifted else 'fresh'}", results,
                          GATHER)
    # M: periodic with the truncation, vacuum without
    for periodic in (True, False):
        recorded = record_gravity_cells_small(device, n_small, periodic)
        check_kernels(recorded, f"n_side={n_small} periodic" if periodic
                      else "vacuum blob 4^3 cells x 256", results,
                      GRAVITY_CELLS)
    # C, D, F, G in absolute mode: the vacuum blob through block SPH on
    # its clamped grid, the entries on a seeded 3% of its gas
    nb, subcap = VACUUM_BLOCKS
    recorded, _ = record_vacuum_blocks(device, nb, subcap,
                                       *vacuum_blob(device), VACUUM_IDLE_FRAC)
    check_kernels(recorded, f"vacuum blob {nb}^3 blocks x {subcap}", results,
                  ABS)
    # E's potential mode and H on a step's own arguments (sinks on)
    rec_e, rec_h = record_idle_sinks(device, n_small)
    check_kernels(rec_e, f"n_side={n_small} near-idle, sinks", results,
                  POTENTIAL_ENTRIES)
    check_kernels(rec_h, f"n_side={n_small} near-idle step forced dense, "
                  "sinks", results, POTENTIAL)
    check_step_potential_forces(rec_h, f"n_side={n_small} step")


def report_close(phase: str, what: str, res: dict) -> None:
    """One line on an :func:`assert_states_close` result."""
    from gadget_leicester_tpu_torch.core.state import CLOSE_TOL, MAX_EXCLUDED
    worst = max(res, key=lambda f: res[f][0])
    say(phase, f"{what}: timeline fields equal; worst {worst} "
        f"{res[worst][0]:.2e} of its largest value, "
        f"{sum(n for _, n in res.values())} rows beyond {CLOSE_TOL} (at "
        f"most {MAX_EXCLUDED} per field)")


def phase_slice(device="cuda", n_small=N_SIDE_SMALL, steps=SLICE_STEPS,
                potential=True, phase="slice", card="", **opt_overrides):
    """``steps`` sync points of the small box (options as :func:`setup`
    gives them) on the card against the CPU, and with ``potential`` the
    full potential after 1 of them; the card's ``set_ics`` and sync points
    timed (synced). Returns the card's state after 1 sync point."""
    from gadget_leicester_tpu_torch.core.state import (CLOSE_FIELDS,
                                                       assert_states_close,
                                                       from_numpy, to_numpy)
    from gadget_leicester_tpu_torch.models.forces import (compute_potential,
                                                          in_step_potential)
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg, opts, ics = setup(n_small, **opt_overrides)
    pos, vel, mass, ptype, u = ics
    runs = {}
    for dev in (device, "cpu"):
        sim = Simulation(cfg, opts, dev)
        sync(dev)
        t0 = time.perf_counter()
        sim.set_ics(pos, vel, mass, ptype, u=u)
        sync(dev)
        secs = [time.perf_counter() - t0]
        runs[dev] = [to_numpy(sim.state)]
        for _ in range(steps):
            t0 = time.perf_counter()
            sim.step()
            sync(dev)
            secs.append(time.perf_counter() - t0)
            if dev == device and len(runs[dev]) == 1:
                after_one = sim.state
            runs[dev].append(to_numpy(sim.state))
        say(phase, f"2x{n_small}^3, {opts_label(opts)}: set_ics "
            f"{secs[0]:.3f} s, sync points "
            + ", ".join(f"{t:.3f}" for t in secs[1:])
            + f" s on {dev}" + (f" ({card})" if dev == device and card
                                else ""))
    fields = CLOSE_FIELDS + (("p.pot",) if in_step_potential(opts) else ())
    for i, (g, c) in enumerate(zip(runs[device], runs["cpu"])):
        report_close(phase, f"sph_backend {opts.sph_backend}"
                     f"{', sinks' if opts.sinks else ''}, after {i} "
                     f"steps, ti_current {int(g['ti_current'])}",
                     assert_states_close(g, c, fields=fields))
    if not potential:
        return after_one
    # the full potential (kernel H on the card) of one state on both
    one = to_numpy(after_one)
    pots = {dev: to_numpy(compute_potential(from_numpy(one, dev), cfg, opts))
            for dev in (device, "cpu")}
    report_close(phase, "full potential after 1 step, card vs CPU",
                 assert_states_close(pots[device], pots["cpu"],
                                     fields=("p.pot",)))
    return after_one


def opts_label(opts) -> str:
    """The options that differ from :func:`setup`'s, as text."""
    import dataclasses

    from gadget_leicester_tpu_torch.core.config import SimOptions
    ref = SimOptions(periodic=True, pmgrid=opts.pmgrid, gravity_mode="treepm",
                     sph_backend="blocks")
    diff = [f"{f.name}={getattr(opts, f.name)!r}"
            for f in dataclasses.fields(opts)
            if getattr(opts, f.name) != getattr(ref, f.name)]
    return ", ".join(diff) or "the main path's options"


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


SPH_FIELDS = ("density", "hsml", "hydro_acc", "dt_entropy")
# which kernels a full-active main path launches, by SPH backend
PATH_KERNELS = {
    "auto": DENSE + GATHER,
    "cells": ("shortrange_gravity", "pm_deposit") + GATHER + CELLS,
}


@contextlib.contextmanager
def pm_passes():
    """Within the body, the step's PM force passes
    (``models/forces.py``'s calls of ``pm_forces_periodic``) and the full
    potential's mesh potentials (its calls of ``pm_potential_periodic``)
    are counted in the dict this yields, by name; each gathers once
    through kernel L."""
    from gadget_leicester_tpu_torch.models import forces
    calls = {"pm_forces_periodic": 0, "pm_potential_periodic": 0}
    real = {name: getattr(forces, name) for name in calls}

    def spy(name):
        def call(*args, **kw):
            calls[name] += 1
            return real[name](*args, **kw)
        return call

    for name in calls:
        setattr(forces, name, spy(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(forces, name, fn)


def check_gather_launches(phase: str, counts: dict, passes: dict) -> None:
    """Kernel L launched once per PM force pass and mesh potential of
    ``passes`` (:func:`pm_passes`), and no more."""
    want = sum(passes.values())
    say(phase, f"kernel L: {counts['pm_gather']} launches over "
        f"{passes['pm_forces_periodic']} PM force passes and "
        f"{passes['pm_potential_periodic']} mesh potentials")
    if counts["pm_gather"] != want:
        raise AssertionError(f"{phase}: kernel L launched "
                             f"{counts['pm_gather']} times for {want} PM "
                             "gathers")


# per-step seconds of each full-active path that :func:`phase_main` drove
STEP_SECONDS: dict = {}


def phase_main(results: dict, card: str, device="cuda",
               n_side=N_SIDE_MAIN, sph_backend="auto", phase="main"):
    """The full-active main path under ``sph_backend``: ``set_ics`` and
    ``MAIN_STEPS`` sync points, the launch counts set to 0 just before and
    read just after. Returns the simulation, the arguments each kernel
    wrapper got last, the SPH fields ``set_ics`` left, and the launch
    counts."""
    import torch

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.core import timeline
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    # bench.py's options: sph_backend "auto" resolves to blocks at 2x128^3
    cfg, opts, ics = setup(n_side, sph_backend=sph_backend)
    pos, vel, mass, ptype, u = ics
    sim = Simulation(cfg, opts, device)
    step_s, updates = [], 0
    with recorded_inputs() as rec, pm_passes() as passes:
        kernels.reset_launches()
        t0 = time.time()
        sim.set_ics(pos, vel, mass, ptype, u=u)
        sync(device)
        init_s = time.time() - t0
        init_sph = {f: getattr(sim.state.gas, f).clone() for f in SPH_FIELDS}
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
    say(phase, f"sph_backend {sph_backend}, pmgrid {opts.pmgrid}, "
        f"{st.n_max} slots, init {init_s:.3f} s"
        f" ({card})")
    say(phase, "per-step seconds " + ", ".join(f"{s:.3f}" for s in step_s)
        + f" ({card})")
    STEP_SECONDS[phase] = step_s
    say(phase, f"{updates} particle updates in {sum(step_s):.3f} s: "
        f"{updates / sum(step_s):.1f} updates/s ({card})")
    say(phase, f"Newton sweeps per density pass: "
        f"{sim.stats.get('density_iters')}")
    say(phase, f"launches {counts}; ti_current {int(st.ti_current)}, "
        f"overflow_flags {int(st.overflow_flags)}")
    check_gather_launches(phase, counts, passes)
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
    # every sync point from the ICs is full-active: the dense tier, and
    # the SPH kernels of this backend alone
    for name, n in counts.items():
        if name in PATH_KERNELS[sph_backend]:
            if n <= 0:
                raise AssertionError(f"kernel {name} was not launched on "
                                     f"the {sph_backend} main path")
            # A and B keep the count of the first path that ran them
            results.setdefault(name, {}).setdefault("launches", n)
        elif n != 0:
            raise AssertionError(f"kernel {name} was launched {n} times on "
                                 f"the full-active {sph_backend} main path")
    return sim, recorded, init_sph, counts


@contextlib.contextmanager
def phase_timer(device="cuda", timed_fns=TIMED):
    """Within the body, each function of ``timed_fns`` runs with a device
    sync on both sides and adds its seconds, calls and the caching
    allocator's ``cudaMalloc`` calls to the dict this yields (label ->
    [seconds, calls, mallocs, the seconds of each call]; nested phases add
    their syncs to their parents')."""
    import importlib

    import torch
    totals = {label: [0.0, 0, 0, []] for _, _, label in timed_fns}

    def mallocs():
        if device != "cuda":
            return 0
        return torch.cuda.memory_stats().get("num_device_alloc", 0)

    def timed(label, fn):
        def run(*args, **kwargs):
            sync(device)
            m0 = mallocs()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(device)
            dt = time.perf_counter() - t0
            totals[label][0] += dt
            totals[label][1] += 1
            totals[label][2] += mallocs() - m0
            totals[label][3].append(dt)
            return out
        return run

    saved = []
    for mod_name, attr, label in timed_fns:
        mod = importlib.import_module(mod_name)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, timed(label, getattr(mod, attr)))
    try:
        yield totals
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def say_phases(phase: str, totals: dict, steps: int,
               timed_fns=TIMED) -> None:
    """The phases that ran, in ms per step."""
    for _, _, label in timed_fns:
        s, n, m, _ = totals[label]
        if n:
            say(phase, f"  {label:<28s} {1e3 * s / steps:9.3f} ms/step "
                f"({n} calls{f', {m} cudaMalloc' if m else ''})")


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
        tier log, seconds, PM passes)."""
        sim.state = copy.deepcopy(idle)
        with tier(force) as log, pm_passes() as passes:
            kernels.reset_launches()
            sync(device)
            t0 = time.perf_counter()
            sim.step()
            sync(device)
            dt = time.perf_counter() - t0
            counts = dict(kernels.launches)
        return sim.state, counts, log, dt, passes

    with recorded_inputs() as rec:
        st_a, counts_a, log_a, _, passes_a = run(None)
    recorded = dict(rec)
    say_tiers("idle", log_a)
    say("idle", f"2x{n_side}^3 entries tier launches {counts_a}")
    check_tier_launches(counts_a, entries=True)
    check_gather_launches("idle", counts_a, passes_a)
    for name in ENTRIES:
        results.setdefault(name, {})["launches"] = counts_a[name]
    st_b, counts_b, log_b, _, passes_b = run(False)
    say("idle", f"2x{n_side}^3 dense tier launches {counts_b}")
    check_tier_launches(counts_b, entries=False)
    check_gather_launches("idle", counts_b, passes_b)
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
    for name in ENTRIES:
        say_against_earlier("idle", results, name, card)


def fullest_cell(pos, alive, box: float, n_cells: int) -> tuple:
    """(largest, mean) particle count per cell of a fresh n_cells^3 cell
    list over the box, as the full potential builds it, counted past its
    128-slot capacity."""
    from gadget_leicester_tpu_torch.ops.neighbors import build_cell_list
    counts = build_cell_list(pos, alive, 0.0, box, n_cells, 128).counts
    return int(counts.max()), float(counts.float().mean())


def phase_potential(results: dict, state, card: str, device="cuda",
                    n_side=N_SIDE_MAIN) -> None:
    """The full potential of ``state`` at full width, as the run loop
    computes it at each statistics time: its launches, its result, the
    fullest cell of its fresh cell list, the pass timed whole and by parts
    (:data:`POTENTIAL_TIMED`) beside the energy statistics, and kernel H
    replayed on its arguments."""
    import dataclasses

    import torch

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.models.forces import compute_potential
    from gadget_leicester_tpu_torch.utils.diagnostics import \
        energy_statistics
    cfg, opts, _ = setup(n_side)
    opts = dataclasses.replace(opts, sph_backend="auto")
    with recorded_inputs() as rec:
        kernels.reset_launches()
        st = compute_potential(state, cfg, opts)
        sync(device)
        counts = dict(kernels.launches)
    recorded = dict(rec)
    say("potential", f"launches {counts}")
    if counts["shortrange_potential"] != 1 or counts["pm_gather"] != 1 or \
            sum(counts.values()) != 2:
        raise AssertionError("the potential pass did not launch kernels H "
                             "and L once each and nothing else")
    results.setdefault("shortrange_potential", {})["launches"] = 1
    pot = st.p.pot[st.p.alive]
    if not bool(torch.isfinite(pot).all()):
        raise AssertionError("p.pot is not finite")
    if int(st.overflow_flags) != 0:
        raise AssertionError(f"overflow_flags {int(st.overflow_flags)} after "
                             "the potential pass")
    soa, _, n_cells = recorded["shortrange_potential"][:3]
    most, mean = fullest_cell(state.p.pos, state.p.alive, cfg.box_size,
                              n_cells)
    say("potential", f"fresh cell list {n_cells}^3 cells x {soa.shape[2]} "
        f"slots: fullest cell {most}, mean {mean:.1f}; p.pot in "
        f"[{float(pot.min()):.6g}, {float(pot.max()):.6g}]")
    es = energy_statistics(st, cfg, opts)
    say("potential", f"Epot {float(es.potential):.6g}, Ekin "
        f"{float(es.kinetic):.6g}, Eint {float(es.internal):.6g}")
    del st, es
    walls = []
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        st = compute_potential(state, cfg, opts)
        sync(device)
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        energy_statistics(st, cfg, opts)
        sync(device)
        walls.append(time.perf_counter() - t0)
        del st
    say("potential", "full potential " + ", ".join(
        f"{1e3 * t:.3f}" for t in walls[0::2]) + " ms; energy statistics "
        + ", ".join(f"{1e3 * t:.3f}" for t in walls[1::2]) + f" ms ({card})")
    with phase_timer(device, POTENTIAL_TIMED) as totals:
        compute_potential(state, cfg, opts)
    say("potential", "a device sync around each part:")
    say_phases("potential", totals, 1, POTENTIAL_TIMED)
    check_kernels(recorded, f"2x{n_side}^3 potential", results, POTENTIAL,
                  timed=True, every=FULL_EVERY)
    say_against_earlier("potential", results, "shortrange_potential", card)
    check_potential_forces(recorded, f"2x{n_side}^3")


# phase 8b: cells against blocks after ``set_ics`` on the same ICs, per
# field as a share of its largest value, on the gas whose h is under both
# backends' caps. Two decompositions and two kernels sum the same pairs in
# another order; cells sees absolute float32 coordinates (a rounding of
# 4e-3 kpc/h at 50 Mpc/h against h ~ 780 kpc/h) where blocks sees
# block-relative ones, and the near-uniform ICs' pressure forces cancel to
# a few percent of their pair terms, so the hydro rows get the wider bound.
# A gas particle whose Newton solve stops a sweep apart (|N_eff - 33| < 2
# lets h differ by 2%) falls outside: at most CELLS_VS_BLOCKS_OUT of the
# compared gas may. A fault is O(1) on most rows.
CELLS_VS_BLOCKS = {"density": 1e-4, "hsml": 1e-4, "hydro_acc": 2e-3,
                   "dt_entropy": 2e-3}
CELLS_VS_BLOCKS_OUT = 1e-4
# the parts of an SPH pass under the coarse-cell backend, timed as in TIMED
CELLS_TIMED = (
    (f"{_PKG}.models.forces", "compute_sph", "SPH"),
    (f"{_PKG}.models.forces", "density_adaptive_cells", "  density"),
    (f"{_PKG}.ops.sph_cells", "build_cell_list", "    cell list"),
    (f"{_PKG}.ops.sph_cells", "pack_sph_soa", "    pack"),
    (f"{_PKG}.ops.sph_cells", "density_sums_cells", "    kernel I/J"),
    (f"{_PKG}.models.forces", "hydro_force_cells", "  hydro"),
    (f"{_PKG}.ops.sph_cells", "pack_hydro_cells", "    pack, 16 rows"),
    (f"{_PKG}.ops.sph_cells", "hydro_sums_cells", "    kernel K"),
    (f"{_PKG}.ops.sph_cells", "merge_rows", "    merge"),
)


def compare_sph_fields(phase: str, what: str, got: dict, want: dict, keep,
                       bounds: dict, out_share: float) -> None:
    """Hold the SPH fields ``got`` to ``want`` on the rows ``keep``: per
    field, the rows farther apart than ``bounds[field]`` of the field's
    largest |want| are at most ``out_share`` of the kept rows."""
    import torch
    n = int(keep.sum())
    for f, tol in bounds.items():
        g, w = got[f][keep].double(), want[f][keep].double()
        d = (g - w).abs().reshape(n, -1).amax(-1)
        scale = float(w.abs().max()) or 1.0
        n_out = int((d > tol * scale).sum())
        say(phase, f"{what}: {f} median {float(d.median()) / scale:.2e}, "
            f"largest {float(d.max()) / scale:.2e} of the largest value; "
            f"{n_out} of {n} rows beyond {tol:g} (at most "
            f"{int(out_share * n)})")
        if not bool(torch.isfinite(d).all()) or n_out > out_share * n:
            raise AssertionError(f"{what}: {f} disagrees")


def phase_cells(results: dict, blocks_init: dict, card: str, device="cuda",
                n_side=N_SIDE_MAIN) -> None:
    """The coarse-cell SPH backend at full width (phase 8b)."""
    import torch

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.models.grids import (KAPPA_SPH,
                                                         sph_blocks_geometry,
                                                         sph_cells_geometry)
    sim, recorded, cells_init, _ = phase_main(
        results, card, device, n_side, sph_backend="cells", phase="cells")
    cfg, opts = sim.cfg, sim.opts
    st = sim.state
    ng = st.n_gas_max
    n_cells, cap = sph_cells_geometry(cfg, opts, ng)
    gas_mask = st.p.alive[:ng] & (st.p.ptype[:ng] == 0)
    most, mean = fullest_cell(st.p.pos[:ng], gas_mask, cfg.box_size, n_cells)
    cap_c = cfg.box_size / n_cells
    at_cap = int((st.gas.hsml[gas_mask] >= 0.999 * cap_c).sum())
    say("cells", f"SPH cell list {n_cells}^3 cells x {cap} slots: fullest "
        f"cell {most}, mean {mean:.1f}; h cap {cap_c:.1f}, {at_cap} gas at "
        f"it, mean h {float(st.gas.hsml[gas_mask].mean()):.1f}")
    iters = sim.stats["density_iters"]
    if kernels.launches["sph_cells_density"] != len(iters) + sum(iters) or \
            kernels.launches["sph_cells_hydro"] != len(iters):
        raise AssertionError("kernels I/J and K were not launched once per "
                             "Newton sweep and once per SPH pass")
    # two decompositions, two kernels, one answer
    n_blocks, _ = sph_blocks_geometry(cfg, setup(n_side)[1], ng)
    cap_b = (1.0 - 2.0 * KAPPA_SPH) * cfg.box_size / (2 * n_blocks)
    keep = gas_mask & (blocks_init["hsml"] < 0.999 * cap_b) \
        & (cells_init["hsml"] < 0.999 * cap_c)
    say("cells", f"after set_ics, cells vs blocks on {int(keep.sum())} of "
        f"{int(gas_mask.sum())} gas with h under both caps (blocks "
        f"{cap_b:.1f}, cells {cap_c:.1f})")
    compare_sph_fields("cells", "cells vs blocks", cells_init, blocks_init,
                       keep, CELLS_VS_BLOCKS, CELLS_VS_BLOCKS_OUT)
    del cells_init
    check_kernels(recorded, f"2x{n_side}^3", results, CELLS, timed=True)
    say_against_earlier("cells", results, "sph_cells_density", card)
    say_against_earlier("cells", results, "sph_cells_hydro", card)
    del recorded
    kernels.recorded.clear()
    with phase_timer(device, CELLS_TIMED) as totals:
        sim.step(2)
    say("cells", f"SPH pass under cells, a device sync around each part, 2 "
        f"sync points ({card}):")
    say_phases("cells", totals, 2, CELLS_TIMED)
    # a near-idle sync point: gravity takes its entries tier, this backend
    # sweeps all gas all the same
    idle = make_near_idle(sim.state, IDLE_FRAC_MAIN, IDLE_SEED)
    times = []
    for _ in range(IDLE_REPS):
        sim.state = copy.deepcopy(idle)
        kernels.reset_launches()
        sync(device)
        t0 = time.perf_counter()
        sim.step()
        sync(device)
        times.append(time.perf_counter() - t0)
    say("cells", "near-idle sync point under cells (no gate on the SPH "
        "sweep): " + ", ".join(f"{1e3 * t:.3f}" for t in times)
        + f" ms; launches {dict(kernels.launches)} ({card})")
    with phase_timer(device, CELLS_TIMED) as totals:
        sim.state = copy.deepcopy(idle)
        sim.step()
    say_phases("cells", totals, 1, CELLS_TIMED)
    if not bool(torch.isfinite(sim.state.gas.density).all()):
        raise AssertionError("gas.density is not finite after the near-idle "
                             "sync point")


# phase 10: the bounds of tests/test_gassphere_e2e.py
GASSPHERE_T_END = 0.5
GASSPHERE_DRIFT = 0.02       # max |E_tot - E_tot(0)| over energy.txt's rows
GASSPHERE_MOMENTUM = 5e-4    # each component of the final momentum
# the vacuum cells pass against the all-pairs pass on the run's last
# state, per field as a share of its largest value: the same pairs summed
# in another order through other code; no row may fall outside (the
# all-pairs pass solves from the h the cells pass converged to, so no
# Newton solve stops apart)
VACUUM_VS_DENSE = {"density": 1e-4, "hsml": 1e-4, "hydro_acc": 1e-4,
                   "dt_entropy": 1e-4}


def write_gassphere_ics(path: str) -> int:
    """``gassphere_ics()`` (the stock 1472-particle Evrard sphere) as a
    format-1 GADGET IC file; returns the particle count."""
    import numpy as np

    from gadget_leicester_tpu_torch.io.snapshot import (Header, SnapshotData,
                                                        write_snapshot)
    from gadget_leicester_tpu_torch.models.ics import gassphere_ics
    pos, vel, mass, _, u = gassphere_ics(mode="grid")
    n = len(pos)
    h = Header()
    h.npart[0] = n
    h.npart_total = h.npart.copy()
    write_snapshot(path, SnapshotData(
        header=h, pos=pos.astype(np.float32), vel=vel.astype(np.float32),
        ids=np.arange(1, n + 1, dtype=np.uint32),
        mass=mass.astype(np.float32), u=u.astype(np.float32)), fmt=1)
    return n


def stock_param_text(name: str, ics: str, outdir: str, t_end: float,
                     **replace) -> str:
    """``parameterfiles/<name>.param`` with its IC file, output directory
    and TimeMax set, and any further ``key=value`` of ``replace``."""
    root = Path(__file__).resolve().parent
    values = dict(replace, InitCondFile=ics, OutputDir=outdir, TimeMax=t_end)
    out = []
    for line in (root / "parameterfiles" / f"{name}.param").read_text() \
            .splitlines():
        key = line.split()[0] if line.split() else ""
        out.append(f"{key}  {values[key]}" if key in values else line)
    return "\n".join(out) + "\n"


def gassphere_param_text(ics: str, outdir: str, t_end: float) -> str:
    """``parameterfiles/gassphere.param`` with its IC file, output
    directory and TimeMax set, and a restart dump after every sync point
    (the last one is the run's final state)."""
    return stock_param_text("gassphere", ics, outdir, t_end,
                            CpuTimeBetRestartFile=0.0)


def tree_ics(which: str, n: int = 20000):
    """(pos, vel, mass, ptype) of the stock collisionless workloads at
    ``n`` particles, as ``parameterfiles/make_ics.py`` makes them:
    ``galaxy``, two Plummer spheres on a collision orbit; ``cluster``, one
    Plummer sphere of 1e13 Msun/h and 500 kpc/h, off the origin, for the
    comoving run with vacuum boundaries."""
    from gadget_leicester_tpu_torch.models import ics
    if which == "galaxy":
        return ics.galaxy_collision_ics(n_each=n // 2)[:4]
    pos, vel, mass, ptype, _ = ics.plummer_ics(n, total_mass=1000.0, a=500.0,
                                               g=43007.1)
    return pos + 25000.0, vel, mass, ptype


def write_tree_ics(path: str, which: str, n: int = 20000) -> int:
    """:func:`tree_ics` as a format-1 GADGET IC file, types in file order;
    returns the particle count."""
    import numpy as np

    from gadget_leicester_tpu_torch.io.snapshot import (Header, SnapshotData,
                                                        write_snapshot)
    pos, vel, mass, ptype = tree_ics(which, n)
    order = np.argsort(ptype, kind="stable")
    h = Header()
    for t in range(6):
        h.npart[t] = int((ptype == t).sum())
    h.npart_total = h.npart.copy()
    write_snapshot(path, SnapshotData(
        header=h, pos=pos[order].astype(np.float32),
        vel=vel[order].astype(np.float32),
        ids=np.arange(1, len(pos) + 1, dtype=np.uint32),
        mass=mass[order].astype(np.float32), u=None), fmt=1)
    return len(pos)


def vacuum_cells_vs_dense(phase: str, state, cfg, opts, n_cells: int,
                          cap: int) -> None:
    """One SPH pass of ``state`` through the coarse-cell backend in vacuum
    mode (kernels I/J and K on a CUDA state) held against the all-pairs
    pass from the same h, by :data:`VACUUM_VS_DENSE`."""
    import dataclasses

    import torch

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.models.forces import (gas_bounding_grid,
                                                          comoving_factors,
                                                          compute_sph)
    ng = state.n_gas_max
    active = state.p.alive[:ng].clone()
    fac = comoving_factors(cfg, state.ti_current)
    state = dataclasses.replace(state, overflow_flags=torch.zeros_like(
        state.overflow_flags))
    o_cells = dataclasses.replace(opts, sph_backend="cells", sph_grid=n_cells,
                                  sph_capacity=cap)
    kernels.reset_launches()
    got = compute_sph(state, cfg, o_cells, fac, active)
    counts = dict(kernels.launches)
    if int(got.overflow_flags) != 0:
        raise AssertionError(f"{n_cells}^3 cells x {cap} overflowed")
    gas_mask = active & (state.p.ptype[:ng] == 0)
    edge = float(gas_bounding_grid(state.p.pos[:ng], gas_mask)[1]) / n_cells
    h_cap = float(got.gas.hsml[active].max())
    if h_cap >= 0.999 * edge:
        raise AssertionError(f"h reaches the cell edge {edge:.4f}: the "
                             "all-pairs pass has no such cap")
    # the all-pairs pass starts from the converged h: both solves then stop
    # at the seed sweep unless they disagree
    start = dataclasses.replace(state, gas=dataclasses.replace(
        state.gas, hsml=got.gas.hsml))
    want = compute_sph(start, cfg,
                       dataclasses.replace(opts, sph_backend="dense"), fac,
                       active)
    again = compute_sph(start, cfg, o_cells, fac, active)
    say(phase, f"vacuum cells pass {n_cells}^3 cells x {cap} slots on "
        f"{int(active.sum())} gas: launches {counts}, largest h "
        f"{h_cap:.4f} under the cell edge {edge:.4f}")
    fields = {f: getattr(again.gas, f) for f in SPH_FIELDS}
    compare_sph_fields(phase, "vacuum cells vs all-pairs", fields,
                       {f: getattr(want.gas, f) for f in SPH_FIELDS}, active,
                       VACUUM_VS_DENSE, 0.0)


def phase_gassphere(card: str, device="cuda") -> None:
    """The vacuum gas run (phase 10). The run's directory is deleted at
    the end."""
    import numpy as np

    from gadget_leicester_tpu_torch.core.config import (options_from_config,
                                                        read_parameter_file)
    from gadget_leicester_tpu_torch.io.restart import load_restart
    from gadget_leicester_tpu_torch.utils.diagnostics import \
        energy_statistics
    root = Path(__file__).resolve().parent
    work = root / "build" / "gassphere_run"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        out = work / "out"
        n = write_gassphere_ics(str(work / "gassphere_ics.dat"))
        param = work / "gassphere.param"
        param.write_text(gassphere_param_text(
            str(work / "gassphere_ics.dat"), str(out), GASSPHERE_T_END))
        proc, wall = _cli(root, param, 0, "--device", device)
        rows = np.loadtxt(out / "energy.txt", ndmin=2)
        if rows.shape[1] != 28 or not np.isfinite(rows).all():
            raise AssertionError("energy.txt: wrong columns or not finite")
        e_tot = rows[:, 1] + rows[:, 2] + rows[:, 3]
        drift = float(np.abs(e_tot - e_tot[0]).max())
        step_s = [float(line.split("t=")[1].split("s")[0]) for line in
                  (out / "timings.txt").read_text().splitlines()
                  if line.startswith("Step=")]
        say("gassphere", f"{n} gas, {len(step_s)} sync points to t = "
            f"{_done_time(proc):g} in {wall:.1f} s wall with start-up, "
            f"{1e3 * sum(step_s) / len(step_s):.2f} ms per sync point "
            f"({card})")
        say("gassphere", f"energy.txt {len(rows)} rows: t=0 Eint "
            f"{rows[0, 1]:.5f} Epot {rows[0, 2]:.5f} Ekin {rows[0, 3]:.2e}; "
            f"t={rows[-1, 0]:g} Eint {rows[-1, 1]:.5f} Epot "
            f"{rows[-1, 2]:.5f} Ekin {rows[-1, 3]:.5f}; largest "
            f"|E - E(0)| {drift:.3e} (bound {GASSPHERE_DRIFT})")
        cfg = read_parameter_file(str(param))
        state, _ = load_restart(str(out / "restart"), device)
        opts = options_from_config(cfg, n_particles=n)
        es = energy_statistics(state, cfg, opts)
        mom = [float(x) for x in es.momentum]
        say("gassphere", f"final state t = {rows[-1, 0]:g}: momentum "
            f"{mom} (bound {GASSPHERE_MOMENTUM} each), mass "
            f"{float(es.mass):.7f}")
        if _done_time(proc) < GASSPHERE_T_END or \
                rows[-1, 0] < GASSPHERE_T_END - 0.05:
            raise AssertionError("the run did not reach t = 0.5")
        if drift >= GASSPHERE_DRIFT:
            raise AssertionError(f"energy drift {drift:.3e}")
        if max(abs(x) for x in mom) >= GASSPHERE_MOMENTUM:
            raise AssertionError(f"momentum {mom}")
        # the collapse proceeds: Epot falls, Ekin grows
        if not (rows[-1, 2] < rows[0, 2] - 0.05 and rows[-1, 3] > 0.01):
            raise AssertionError("the sphere did not collapse")
        for grid, cap in ((4, 256), (3, 512)):
            vacuum_cells_vs_dense("gassphere", state, cfg, opts, grid, cap)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _main_gravity_inputs(state, n_side: int):
    """(cfg, opts, box, force softening [N]) of the 2x``n_side``^3 state,
    as ``compute_forces`` takes them."""
    from gadget_leicester_tpu_torch.models.forces import (comoving_factors,
                                                          softening_table)
    from gadget_leicester_tpu_torch.ops.softening import SOFTFAC
    cfg, opts, _ = setup(n_side)
    fac = comoving_factors(cfg, state.ti_current)
    soft = SOFTFAC * softening_table(cfg, fac.atime)[state.p.ptype.long()]
    return cfg, opts, float(cfg.box_size), soft


def gather_timings(phase: str, field, posw, alive, box: float, g: int,
                   card: str, reps: int = 5) -> dict:
    """Kernel L (``cic_gather_vec``), its plain version (the row gather)
    and ``torch.nn.functional.grid_sample`` on one mesh stack ``field``
    at the wrapped positions ``posw``, each timed (ms by CUDA events) and
    its alive rows held to the plain version's: L bit for bit (raises
    otherwise), grid_sample as a share of the largest value. Returns the
    times by name."""
    import torch
    import torch.nn.functional as F

    from gadget_leicester_tpu_torch.ops.pm import (cic_gather_vec,
                                                   cic_gather_vec_plain)
    k = field.shape[-1]
    kern_ms, got = time_ms(lambda: cic_gather_vec(field, posw, box, g), reps)
    plain_ms, want = time_ms(lambda: cic_gather_vec_plain(field, posw, box,
                                                          g), reps)
    check_gather_equal(phase, f"K={k}, {posw.shape[0]} particles, pmgrid "
                       f"{g}", got, want)
    # one PyTorch call for the same function: trilinear grid_sample on the
    # mesh padded by one periodic plane a side (index = u + 1; the grid's
    # x is the mesh's last axis); the padded mesh and the grid are made
    # outside the timing
    pad = field.permute(3, 0, 1, 2)
    for dim in (1, 2, 3):
        pad = torch.cat([pad.narrow(dim, g - 1, 1), pad,
                         pad.narrow(dim, 0, 1)], dim)
    pad = pad[None].contiguous()
    u = posw * (g / box)
    grid = (2.0 * (u + 1.0) / (g + 1) - 1.0).flip(-1)[None, :, None, None, :]
    grid = grid.contiguous()
    lib_ms, lib = time_ms(lambda: F.grid_sample(
        pad, grid, mode="bilinear", padding_mode="border",
        align_corners=True), reps)
    lib = lib[0, :, :, 0, 0].t()
    keep = alive[:, None]
    zero = torch.zeros_like(want)
    lib_err = float((torch.where(keep, lib, zero)
                     - torch.where(keep, want, zero)).abs().max()) \
        / float(torch.where(keep, want, zero).abs().max())
    say(phase, f"K={k}, {posw.shape[0]} particles, pmgrid {g}: kernel L "
        f"{kern_ms:.3f} ms, plain version (row gather) {plain_ms:.3f} ms, "
        f"grid_sample {lib_ms:.3f} ms (within {lib_err:.1e} of the row "
        f"gather): L / grid_sample {kern_ms / lib_ms:.2f} ({card})")
    return {"ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms}


def phase_gather(results: dict, state, main_counts: dict, card: str,
                 device="cuda", n_side=N_SIDE_MAIN) -> None:
    """Kernel L at full width (phase 11): the main path's launches of L;
    the mesh stack of one PM step of ``state`` with 3 and 4 components,
    gathered by L and by its plain version, equal bit for bit, and through
    ``pm_gather_tiles`` over the cached gravity cell list; L replayed
    against its float64 plain version and timed beside the plain version,
    its bound and ``grid_sample``."""
    import torch

    from gadget_leicester_tpu_torch.models.grids import grav_grid_geometry
    from gadget_leicester_tpu_torch.ops.cells import pack_cells_soa
    from gadget_leicester_tpu_torch.ops.pm import (cic_gather_vec,
                                                   cic_gather_vec_plain,
                                                   pm_forces_periodic)
    from gadget_leicester_tpu_torch.ops.pm_tiles import (pm_deposit_tiles,
                                                         pm_gather_tiles)
    cfg, opts, box, soft = _main_gravity_inputs(state, n_side)
    p = state.p
    g = opts.pmgrid
    n_cells, _, margin = grav_grid_geometry(cfg, opts, p.n_max)
    cl = state.grids.grav
    if cl is None or cl.n_cells != n_cells:
        raise AssertionError("the state carries no cached gravity cell list")
    say("gather", f"the main path's launches of kernel L: "
        f"{main_counts['pm_gather']}, one per PM force pass (phase main)")
    # one PM step's mesh, as the step makes it: kernel B's deposit of the
    # step's pack and the FFTs, the stack returned before its gather
    soa = pack_cells_soa(cl, p.pos, p.mass, soft, p.alive)
    rho = pm_deposit_tiles(soa, n_cells, box, g)
    fields = {k: pm_forces_periodic(p.pos, p.mass, p.alive, box, g,
                                    rho_grid=rho, return_field=True,
                                    with_potential=k == 4) for k in (3, 4)}
    del soa, rho
    posw = torch.remainder(p.pos, box)
    times = {}
    for k in (4, 3):
        field = fields[k]
        # the cell-list entry: L, then the mask of the dead and cell-less
        got = pm_gather_tiles(field, cl, p.pos, p.alive, box, g, n_cells,
                              margin * g / box)
        want = cic_gather_vec_plain(field, posw, box, g)
        keep = (p.alive & (cl.gslot >= 0))[:, None]
        check_gather_equal("gather", f"pm_gather_tiles 2x{n_side}^3 K={k}, "
                           "cached list", got, torch.where(
                               keep, want, torch.zeros_like(want)))
        del got, want
        with recorded_inputs() as rec:
            cic_gather_vec(field, posw, box, g)
        check_kernels(dict(rec), f"2x{n_side}^3 K={k}", results, GATHER,
                      timed=True)
        times[k] = gather_timings("gather", field, posw, p.alive, box, g,
                                  card)
    # the kernels line keeps the step's gather: K = 3, the plain version
    # and grid_sample timed beside L in gather_timings
    results["pm_gather"].update(times[3])
    say("gather", f"kernel L at 2x{n_side}^3, pmgrid {g}: K=3 "
        f"{times[3]['ms']:.3f} ms, K=4 {times[4]['ms']:.3f} ms; bound "
        f"{results['pm_gather']['bound_ms']:.3f} ms ({card})")


# kernel M against kernel H's force rows on one fresh cell list: the same
# pairs and the same pair function, from absolute float32 coordinates
# (0.004 kpc/h at 50 Mpc/h) against cell-relative ones, summed where the
# net short-range force cancels; as shares of the largest |acc|
M_VS_H_MAX = 5e-3
M_VS_H_MEDIAN = 1e-4


def phase_gravity_cells(results: dict, state, main_counts: dict, card: str,
                        device="cuda", n_side=N_SIDE_MAIN) -> None:
    """Kernel M at full width (phase 12): ``shortrange_gravity_fresh`` on
    ``state`` with the TreePM asmth and rcut on the potential pass's
    grid, the launch counts set to 0 just before and read just after."""
    import torch

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.ops.cells import (
        pack_cells_soa, shortrange_potential_tiles)
    from gadget_leicester_tpu_torch.ops.gravity_short import \
        shortrange_gravity_fresh
    from gadget_leicester_tpu_torch.ops.neighbors import (build_cell_list,
                                                          merge_rows)
    from gadget_leicester_tpu_torch.ops.pm import ASMTH, RCUT
    cfg, opts, box, soft = _main_gravity_inputs(state, n_side)
    p = state.p
    asmth = ASMTH * box / opts.pmgrid
    rcut = RCUT * asmth
    n_cells = max(3, int(box / rcut))
    cap = max(128, (((opts.sr_capacity or 128) + 127) // 128) * 128)
    if main_counts["shortrange_gravity_cells"] != 0:
        raise AssertionError("the main path launched kernel M")
    say("gravity_cells", "the main path's own launches of "
        "shortrange_gravity_cells: 0 (nothing in the step calls it, as in "
        "the reference)")
    with recorded_inputs() as rec:
        kernels.reset_launches()
        acc, ovf = shortrange_gravity_fresh(
            p.pos, p.mass, soft, p.alive, box, n_cells, capacity=cap,
            asmth=asmth, rcut=rcut, periodic=True)
        sync(device)
        counts = dict(kernels.launches)
    recorded = dict(rec)
    say("gravity_cells", f"fresh {n_cells}^3 cells x {cap} slots, asmth "
        f"{asmth:.2f}, rcut {rcut:.2f} kpc/h: launches {counts}")
    if counts["shortrange_gravity_cells"] != 1 or sum(counts.values()) != 1:
        raise AssertionError("shortrange_gravity_fresh did not launch kernel "
                             "M once and nothing else")
    if bool(ovf) or not bool(torch.isfinite(acc).all()):
        raise AssertionError("kernel M overflowed or is not finite")
    results.setdefault("shortrange_gravity_cells", {})["launches"] = 1
    # kernel H's force rows on the same fresh list (its relative pack)
    cl = build_cell_list(p.pos, p.alive, 0.0, box, n_cells=n_cells,
                         capacity=cap)
    soa = pack_cells_soa(cl, p.pos, p.mass, soft, p.alive)
    flags = torch.ones(n_cells ** 3, dtype=torch.int32, device=soa.device)
    acc_h = merge_rows(shortrange_potential_tiles(soa, flags, n_cells, box,
                                                  asmth, rcut), cl, 3)
    del soa, cl
    scale = float(acc_h.abs().max())
    d = (acc - acc_h).abs().amax(-1) / scale
    worst, median = float(d.max()), float(d.median())
    ok = worst <= M_VS_H_MAX and median <= M_VS_H_MEDIAN
    say("gravity_cells", f"M vs kernel H's force rows on the same fresh "
        f"list: largest |M - H| {worst:.2e}, median {median:.2e} of the "
        f"largest |acc| (bounds {M_VS_H_MAX:g}, {M_VS_H_MEDIAN:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("kernel M disagrees with kernel H's forces")
    del acc, acc_h, d
    check_kernels(recorded, f"2x{n_side}^3", results, GRAVITY_CELLS,
                  timed=True)
    say_against_earlier("gravity_cells", results, "shortrange_gravity_cells",
                        card)
    say("gravity_cells", f"kernel M "
        f"{results['shortrange_gravity_cells']['ms']:.3f} ms beside A "
        f"{results['shortrange_gravity']['ms']:.3f} and H "
        f"{results['shortrange_potential']['ms']:.3f} ms ({card})")


# phase 13: the stock collisionless runs, TimeMax cut to fit; the bounds
# of tests/test_galaxy_cluster_e2e.py (G = M = 1 units for the galaxy run,
# as in the test) and of tests/test_tree.py
def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


# the block grid of phase 12b: the periodic path's 22 blocks an axis; its
# kernels are held to their float64 plain versions on every 13th tile or
# entry (on an H100 the float32 plain versions of the whole take 7.5 and
# 13.4 s for C and D)
VACUUM_MAIN_BLOCKS = 22
VACUUM_MAIN_EVERY = 13


# phase 12b: C, D, F, G in absolute mode at the main path's width, on
# the gas of phase 5's state as a vacuum cloud, at the periodic path's 22^3
# blocks; its 1% near-idle pass gives F's and G's launch counts (the
# disc's capacity raises leave it 2^3 blocks, and it takes the entries
# tier only at the few sync points whose entries fit their 16)
def vacuum_cloud_pass(state, active, subcap: int, device="cuda"):
    """One ``compute_sph`` pass over the gas of the 2x128^3 ``state`` as a
    vacuum cloud (``periodic=False``, fresh lists over its bounding cube,
    ``VACUUM_MAIN_BLOCKS``^3 blocks of ``subcap`` slots a subcell), the
    launch counts set to 0 before and read after. Returns (its output
    state, the wrappers' arguments, the launch counts, its seconds, its
    Newton sweeps)."""
    import dataclasses

    import torch

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.models.forces import (comoving_factors,
                                                          compute_sph)
    from gadget_leicester_tpu_torch.models.grids import make_grid_cache
    cfg, opts, _ = setup(N_SIDE_MAIN)
    fac = comoving_factors(cfg, state.ti_current)
    st = dataclasses.replace(
        state, grids=make_grid_cache(state.p.pos.device),
        overflow_flags=torch.zeros_like(state.overflow_flags))
    o = dataclasses.replace(opts, periodic=False, sph_backend="blocks",
                            sph_grid=2 * VACUUM_MAIN_BLOCKS,
                            sph_capacity=subcap)
    stats: dict = {}
    with recorded_inputs() as rec:
        kernels.reset_launches()
        sync(device)
        t0 = time.perf_counter()
        out = compute_sph(st, cfg, o, fac, active, stats=stats)
        sync(device)
        dt = time.perf_counter() - t0
        counts = dict(kernels.launches)
    return out, dict(rec), counts, dt, stats["density_iters"]


def vacuum_cloud_gas(state):
    """The alive gas mask [n_gas_max] of ``state``."""
    p, ng = state.p, state.n_gas_max
    return p.alive[:ng] & (p.ptype[:ng] == 0)


def phase_vacuum_blocks(results: dict, state, card: str,
                        device="cuda") -> None:
    """Kernels C, D, F and G in their absolute mode at full width (phase
    12b): the gas of ``state`` (2,097,152 particles) as a vacuum cloud
    (:func:`vacuum_cloud_pass`; the slots a subcell doubled from 32 until
    nothing overflows), once with all the gas active and once with a
    seeded 1% (the entries tier); each kernel replayed against its plain
    version and timed beside its relative mode's time on the periodic path
    (phases 6 and 8) and its bound. A timing of the kernels, not a physics
    claim."""
    import torch

    gas = vacuum_cloud_gas(state)
    subcap = 32
    while True:
        dense, rec, counts, dt, sweeps = vacuum_cloud_pass(state, gas,
                                                           subcap, device)
        if int(dense.overflow_flags) == 0:
            break
        subcap *= 2
    say("vacuum", f"{int(gas.sum())} gas as a vacuum cloud on "
        f"{VACUUM_MAIN_BLOCKS}^3 blocks x {subcap} slots a subcell (the "
        f"fewest of 32 x 2^k that overflow no subcell): all active, "
        f"{dt:.3f} s, Newton sweeps {sweeps}, launches "
        f"{_nonzero(counts)} ({card})")
    check_launches("vacuum", counts, ABS_DENSE, "the dense vacuum pass")
    recorded = seed_sweep_args(rec, dense.grids.sph[0], dense.gas.hsml)
    gen = torch.Generator().manual_seed(IDLE_SEED)
    idle = (torch.rand(gas.shape[0], generator=gen) < IDLE_FRAC_MAIN).to(
        gas.device) & gas
    _, rec, counts, dt, sweeps = vacuum_cloud_pass(state, idle, subcap,
                                                   device)
    say("vacuum", f"{int(idle.sum())} active ({IDLE_FRAC_MAIN:.0%}): "
        f"{dt:.3f} s, Newton sweeps {sweeps}, launches {_nonzero(counts)} "
        f"({card})")
    check_launches("vacuum", counts, ABS_ENTRIES, "the near-idle vacuum pass")
    for name in ABS_ENTRIES:
        results.setdefault(name, {})["launches"] = counts[name]
    recorded.update({k: rec[k] for k in ABS_ENTRIES})
    check_kernels(recorded, f"2x{N_SIDE_MAIN}^3 gas as a vacuum cloud",
                  results, ABS, timed=True, every=VACUUM_MAIN_EVERY)
    say_against_earlier("vacuum", results, "sph_density_abs", card)
    say_against_earlier("vacuum", results, "sph_density_entries_abs", card)
    say_against_earlier("vacuum", results, "sph_hydro_entries_abs", card)
    for name in ABS:
        rel = name.removesuffix("_abs")
        a, r = results[name], results[rel]
        say("vacuum", f"{name} {a['ms']:.3f} ms ({a['pairs']} stencil pairs,"
            f" bound / time {100 * a['bound_ms'] / a['ms']:.1f}%) against the "
            f"relative mode's {r['ms']:.3f} ms ({r['pairs']} stencil pairs, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}%) on the periodic path: "
            f"{a['ms'] / r['ms']:.2f}x ({card})")


GALAXY_T_END = 0.5
GALAXY_DRIFT = 0.02          # |E - E(0)| / |E(0)| over energy.txt's rows
GALAXY_MOMENTUM = 1e-3       # each component, final minus initial
CLUSTER_A_END = 0.201
CLUSTER_RADIUS = 1.2         # comoving half-mass radius, end over start
TREE_VS_DIRECT = (2e-3, 1e-2)   # median and 99th percentile of |da| / |a|
EWALD_VS_EXACT = (5e-3, 2e-2)   # median and 95th percentile of |da| / max|a|


def _half_mass_radius(pos, mass) -> float:
    import numpy as np
    com = (mass[:, None] * pos).sum(0) / mass.sum()
    r = np.linalg.norm(pos - com, axis=1)
    order = np.argsort(r)
    csum = np.cumsum(mass[order])
    return float(r[order][np.searchsorted(csum, 0.5 * mass.sum())])


def run_tree_workload(which: str, t_end: float, card: str, device="cuda"):
    """``parameterfiles/<which>.param`` on its 20,000-particle ICs through
    the command line in a child process to ``t_end``: (energy.txt rows,
    final state on ``device``, cfg, opts, IC arrays, the time reached).
    The run's directory is deleted at the end."""
    import numpy as np

    from gadget_leicester_tpu_torch.core.config import (options_from_config,
                                                        read_parameter_file)
    from gadget_leicester_tpu_torch.io.restart import load_restart
    root = Path(__file__).resolve().parent
    work = root / "build" / f"{which}_run"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        out = work / "out"
        n = write_tree_ics(str(work / "ics.dat"), which)
        param = work / f"{which}.param"
        param.write_text(stock_param_text(
            which, str(work / "ics.dat"), str(out), t_end,
            CpuTimeBetRestartFile=0.0))
        proc, wall = _cli(root, param, 0, "--device", device)
        rows = np.loadtxt(out / "energy.txt", ndmin=2)
        if rows.shape[1] != 28 or not np.isfinite(rows).all():
            raise AssertionError("energy.txt: wrong columns or not finite")
        step_s = [float(line.split("t=")[1].split("s")[0]) for line in
                  (out / "timings.txt").read_text().splitlines()
                  if line.startswith("Step=")]
        cpu = [line.split("#")[0].split() for line in
               (out / "cpu.txt").read_text().splitlines()
               if not line.startswith("Step")]
        pot_s = [float(c[5]) for c in cpu if float(c[5]) > 0]
        if "gravity=auto, pmgrid=0" not in proc.stdout:
            raise AssertionError("the parameter file did not select the "
                                 "tree by itself")
        say("tree", f"{which}: {n} particles, {len(step_s)} sync points to t "
            f"= {_done_time(proc):g} in {wall:.1f} s wall with start-up, "
            f"{1e3 * sum(step_s) / len(step_s):.2f} ms per sync point, "
            f"{len(pot_s)} potential passes of "
            f"{1e3 * sum(pot_s) / max(len(pot_s), 1):.2f} ms with the energy "
            f"statistics ({card})")
        if _done_time(proc) < t_end * (1 - 1e-6):
            raise AssertionError(f"{which} did not reach TimeMax {t_end}")
        cfg = read_parameter_file(str(param))
        state, _ = load_restart(str(out / "restart"), device)
        opts = options_from_config(cfg, n_particles=n)
        return rows, state, cfg, opts, tree_ics(which), _done_time(proc)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_tree(card: str, device="cuda") -> None:
    """The tree-gravity path (phase 13)."""
    import numpy as np
    import torch

    from gadget_leicester_tpu_torch.models.grids import resolve_gravity_mode
    from gadget_leicester_tpu_torch.ops.ewald import direct_periodic_forces
    from gadget_leicester_tpu_torch.ops.gravity_direct import direct_gravity
    from gadget_leicester_tpu_torch.ops.tree import tree_gravity
    from gadget_leicester_tpu_torch.utils.diagnostics import \
        energy_statistics
    # galaxy: energy and momentum
    rows, state, cfg, opts, (pos, vel, mass, _), _ = run_tree_workload(
        "galaxy", GALAXY_T_END, card, device)
    if resolve_gravity_mode(opts, state.n_max) != "tree":
        raise AssertionError("the galaxy run did not take the tree")
    e_tot = rows[:, 1] + rows[:, 2] + rows[:, 3]
    drift = float(np.abs(e_tot - e_tot[0]).max() / abs(e_tot[0]))
    es = energy_statistics(state, cfg, opts)
    mom0 = (mass[:, None] * vel).sum(0)
    dmom = [float(x) - float(m0) for x, m0 in zip(es.momentum, mom0)]
    say("tree", f"galaxy energy.txt {len(rows)} rows: t=0 Epot "
        f"{rows[0, 2]:.5f} Ekin {rows[0, 3]:.5f}; t={rows[-1, 0]:g} Epot "
        f"{rows[-1, 2]:.5f} Ekin {rows[-1, 3]:.5f}; largest |E - E(0)| / "
        f"|E(0)| {drift:.3e} (bound {GALAXY_DRIFT}); momentum change {dmom} "
        f"(bound {GALAXY_MOMENTUM} each)")
    if drift >= GALAXY_DRIFT:
        raise AssertionError(f"galaxy energy drift {drift:.3e}")
    if max(abs(x) for x in dmom) >= GALAXY_MOMENTUM:
        raise AssertionError(f"galaxy momentum change {dmom}")
    if not bool(torch.isfinite(state.p.pos).all()):
        raise AssertionError("galaxy positions not finite")
    del state
    # cluster: finite, at its TimeMax, bound in comoving coordinates
    rows, state, cfg, opts, (pos_c, _, mass_c, _), a_end = run_tree_workload(
        "cluster", CLUSTER_A_END, card, device)
    alive = state.p.alive.cpu().numpy()
    x = state.p.pos.cpu().numpy()[alive]
    if not np.isfinite(x).all() or \
            not bool(torch.isfinite(state.p.vel).all()):
        raise AssertionError("cluster state not finite")
    r0 = _half_mass_radius(pos_c, mass_c)
    r1 = _half_mass_radius(x.astype(np.float64),
                           state.p.mass.cpu().numpy()[alive].astype(np.float64))
    say("tree", f"cluster a {cfg.time_begin:g} -> {a_end:g}: comoving "
        f"half-mass radius {r0:.2f} -> {r1:.2f} kpc/h (at most "
        f"{CLUSTER_RADIUS} times its start)")
    if not r1 < CLUSTER_RADIUS * r0:
        raise AssertionError(f"cluster half-mass radius {r0} -> {r1}")
    del state
    # one force computation of the galaxy ICs against the direct sum

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype).to(device)

    n = len(pos)
    args = (dev(pos), dev(mass), torch.full((n,), 0.28, device=device),
            torch.ones(n, dtype=torch.bool, device=device))
    direct_ms, (acc_d, pot_d) = time_ms(lambda: direct_gravity(*args), 2)
    old_acc = acc_d.norm(dim=-1)
    for opening in (0, 1):
        tree_ms, (acc_t, pot_t) = time_ms(lambda: tree_gravity(
            *args, theta=0.5, opening=opening, old_acc=old_acc), 3)
        err = (acc_t - acc_d).norm(dim=-1) / acc_d.norm(dim=-1).clamp_min(1e-10)
        med, q99 = float(err.median()), float(err.quantile(0.99))
        perr = float(((pot_t - pot_d).abs() / pot_d.abs().max())
                     .quantile(0.99))
        say("tree", f"galaxy ICs, {n} particles, opening criterion "
            f"{opening}: tree {tree_ms:.2f} ms per force computation, "
            f"direct sum {direct_ms:.2f} ms; |da| / |a| median {med:.2e}, "
            f"99th percentile {q99:.2e} (bounds {TREE_VS_DIRECT}); potential "
            f"99th percentile {perr:.2e} of the largest ({card})")
        if med >= TREE_VS_DIRECT[0] or q99 >= TREE_VS_DIRECT[1] or \
                perr >= TREE_VS_DIRECT[1]:
            raise AssertionError("the tree disagrees with the direct sum")
    # a small periodic box through the Ewald tree against the exact sum
    rng = np.random.default_rng(6)
    n, box = 160, 1.0
    pos_p = rng.uniform(0, box, (n, 3)).astype(np.float32)
    mass_p = rng.uniform(0.5, 1.5, n)
    acc_t, _ = tree_gravity(dev(pos_p), dev(mass_p),
                            torch.full((n,), 0.004, device=device),
                            torch.ones(n, dtype=torch.bool, device=device),
                            theta=0.3, opening=0, depth=6, periodic=True,
                            box=box)
    oracle = direct_periodic_forces(pos_p.astype(np.float64), mass_p, box)
    err = np.linalg.norm(acc_t.cpu().numpy() - oracle, axis=1) \
        / np.abs(oracle).max()
    med, q95 = float(np.median(err)), float(np.quantile(err, 0.95))
    say("tree", f"periodic box of {n} through the Ewald tree vs the exact "
        f"periodic sum: |da| / max |a| median {med:.2e}, 95th percentile "
        f"{q95:.2e} (bounds {EWALD_VS_EXACT})")
    if med >= EWALD_VS_EXACT[0] or q95 >= EWALD_VS_EXACT[1]:
        raise AssertionError("the Ewald tree disagrees with the exact "
                             "periodic sum")


def li_reference() -> list:
    """(a, T, W, U, drift) rows of the JAX package's 2x128^3 run, from the
    table of ``docs/li_gate_128.md``."""
    doc = Path(__file__).resolve().parent / "docs" / "li_gate_128.md"
    rows = []
    for line in doc.read_text().splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) == 5 and cells[0].startswith("0."):
            rows.append(tuple(float(c) for c in cells))
    return rows


def _cli(root: Path, *args, timeout: int = 600, phase: str = "cli",
         counts_file: Path | None = None):
    """``python -m gadget_leicester_tpu_torch *args`` from the checkout at
    ``root``, or through :data:`CLI_COUNTED` with ``counts_file``:
    (completed process, seconds)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(root))
    how = ["-m", "gadget_leicester_tpu_torch"] if counts_file is None \
        else ["-c", CLI_COUNTED, str(counts_file)]
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, *how, *map(str, args)], cwd=root, env=env,
        capture_output=True, text=True, timeout=timeout)
    for line in proc.stdout.splitlines():
        say(phase, f"  {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the CLI exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    return proc, time.time() - t0


def _done_time(proc) -> float:
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("done:")]
    if not line:
        raise AssertionError("the CLI printed no 'done:' line")
    return float(line[0].split("t=")[1].split(",")[0])


def phase_cli(card: str, device="cuda", n_side=N_SIDE_MAIN) -> None:
    """The command line at full width (phase 9): IC file, parameter file
    and sidecar written here, the run in a child process (it loads the
    kernels this process built), its outputs checked and its energy.txt
    held to the Layzer-Irvine gate, then a resume from its restart dump.
    The run's directory is deleted at the end."""
    import types

    import numpy as np
    import torch

    from gadget_leicester_tpu_torch.core.config import auto_pmgrid
    from gadget_leicester_tpu_torch.io.snapshot import read_snapshot
    from gadget_leicester_tpu_torch.ops.pm import (ASMTH, RCUT,
                                                   pm_forces_periodic)
    from gadget_leicester_tpu_torch.utils.diagnostics import \
        LayzerIrvineTracker
    root = Path(__file__).resolve().parent
    work = root / "build" / "cli_run"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        out = work / "out"
        t0 = time.time()
        n = write_ics(str(work / "ics.dat"), n_side)
        say("cli", f"IC file of {n} particles written in "
            f"{time.time() - t0:.1f} s")
        param = work / "run.param"
        param.write_text(run_param_text(n_side, str(work / "ics.dat"),
                                        str(out), CLI_CADENCE))
        (work / "run.param.opts").write_text(
            "OPT += -DPERIODIC -DOUTPUTPOTENTIAL\n")
        first, wall = _cli(root, param, 0, "--max-steps", CLI_STEPS)
        rows = np.loadtxt(out / "energy.txt", ndmin=2)
        if rows.shape[1] != 28 or not np.isfinite(rows).all():
            raise AssertionError(f"energy.txt: {rows.shape[1]} columns or "
                                 "values not finite")
        snap = read_snapshot(str(out / "snapshot_000"))
        if int(snap.header.npart.sum()) != n or snap.pot is None or \
                not np.isfinite(snap.pot).all():
            raise AssertionError("snapshot_000: wrong count or no finite "
                                 "POT block")
        for name in ("timings.txt", "info.txt", "cpu.txt"):
            if not (out / name).exists():
                raise AssertionError(f"{name} missing")
        pos = torch.from_numpy(snap.pos).to(device)
        box = float(snap.header.box_size)
        rcut = RCUT * ASMTH * box / auto_pmgrid(n)
        most, mean = fullest_cell(
            pos, torch.ones(n, dtype=torch.bool, device=pos.device), box,
            max(3, int(box / rcut)))
        say("cli", f"snapshot_000 at a = {snap.header.time:.4f}: the fresh "
            f"cell list's fullest cell {most} (mean {mean:.1f}; 128 slots)")
        # kernel L on the run's late state: the mesh stack of the
        # snapshot's positions, the particles in the order the run keeps
        g = auto_pmgrid(n)
        every = torch.ones(n, dtype=torch.bool, device=pos.device)
        field = pm_forces_periodic(pos, torch.from_numpy(snap.mass).to(
            device), every, box, g, return_field=True)
        gather_timings("cli", field, torch.remainder(pos, box), every, box,
                       g, card)
        del pos, field, every
        for line in (out / "info.txt").read_text().splitlines():
            if "overflow" in line:
                say("cli", f"overflow bump: {line.strip()}")
        step_s = [float(line.split("t=")[1].split("s")[0]) for line in
                  (out / "timings.txt").read_text().splitlines()
                  if line.startswith("Step=")]
        cpu = [line.split("#")[0].split() for line in
               (out / "cpu.txt").read_text().splitlines()
               if not line.startswith("Step")]
        pot_s = [float(c[5]) for c in cpu if float(c[5]) > 0]
        snap_s = [float(c[7]) for c in cpu if float(c[7]) > 0]
        dump_s = [float(c[8]) for c in cpu if float(c[8]) > 0]
        say("cli", f"{len(step_s)} sync points, a {rows[0, 0]:.4f} -> "
            f"{_done_time(first):.4f}, {wall:.1f} s wall with start-up: "
            f"{1e3 * sum(step_s) / len(step_s):.1f} ms per sync point, "
            f"{len(pot_s)} potential passes of "
            f"{1e3 * sum(pot_s) / max(len(pot_s), 1):.1f} ms with the "
            f"energy statistics, {len(snap_s)} snapshot(s) "
            f"{sum(snap_s):.2f} s, {len(dump_s)} restart dump(s) "
            f"{sum(dump_s):.2f} s ({card})")
        # the Layzer-Irvine gate on energy.txt's rows: T = Ekin / a^2,
        # W = Epot / a, U = Eint
        tracker = LayzerIrvineTracker()
        drift = [tracker.update(r[0], types.SimpleNamespace(
            kinetic=r[3], potential=r[2], internal=r[1])) for r in rows]
        for a_ref, t_ref, w_ref, u_ref, d_ref in li_reference():
            i = int(np.abs(rows[:, 0] - a_ref).argmin())
            a = rows[i, 0]
            say("cli", f"LI a {a:.4f} T {rows[i, 3] / a ** 2:.4e} W "
                f"{rows[i, 2] / a:.4e} U {rows[i, 1]:.4e} drift "
                f"{drift[i]:.3e} | reference a {a_ref:.4f} T {t_ref:.4e} W "
                f"{w_ref:.4e} U {u_ref:.4e} drift {d_ref:.3e}")
        worst = max(drift)
        say("cli", f"Layzer-Irvine: {len(rows)} rows to a = "
            f"{rows[-1, 0]:.4f}, largest |dE_LI|/|W| {worst:.3e}, last "
            f"{drift[-1]:.3e} (gate {LI_GATE:g} to a >= {LI_A_END}; "
            f"{card})")
        if rows[-1, 0] < LI_A_END:
            raise AssertionError(f"the run stopped at a = {rows[-1, 0]:.4f} "
                                 f"< {LI_A_END}")
        if worst >= LI_GATE:
            raise AssertionError(f"Layzer-Irvine drift {worst:.3e} >= "
                                 f"{LI_GATE}")
        if not dump_s:
            raise AssertionError("the run wrote no restart dump to resume "
                                 "from")
        resumed, wall = _cli(root, param, 1, "--max-steps", 2)
        more = np.loadtxt(out / "energy.txt", ndmin=2)
        if _done_time(resumed) <= _done_time(first) and \
                len(more) <= len(rows):
            raise AssertionError("the resumed run did not go on")
        say("cli", f"restart flag 1: exit 0 in {wall:.1f} s, t "
            f"{_done_time(resumed):.4f}, energy.txt {len(rows)} -> "
            f"{len(more)} rows")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# phase 4: the small Leicester disc of tests/test_torch_disc.py, card
# against CPU: tests/test_features.py:117-138's settings (disc_ics(n_gas=
# 400, r_in=0.2), SinkAccretionRadius 0.35, SofteningBndry 0.05,
# MaxSizeTimestep 0.01) with beta cooling (CoolingBeta 1.0), the star
# registered as a sink, velocities given a seeded 2% scatter: on exact
# circular orbits the sign of dv . dx that decides accretion is a rounding
# residue, and two devices that round apart would accrete different gas
DISC_SMALL_STEPS = 20
DISC_SCATTER = 0.02
DISC_EXACT = ("sinks.slot", "sinks.n_accreted")
DISC_FIELDS = ("p.mass", "sinks.acc_mass")


def disc_small_param_text() -> str:
    return stock_param_text("gassphere", "x", "y", 3.0, SofteningBndry=0.05,
                            MaxSizeTimestep=0.01) \
        + "SinkAccretionRadius 0.35\nCoolingBeta 1.0\n"


def disc_small_ics():
    import numpy as np

    from gadget_leicester_tpu_torch.models.ics import disc_ics
    pos, vel, mass, ptype, u = disc_ics(n_gas=400, r_in=0.2)
    rng = np.random.default_rng(11)
    vel = vel + DISC_SCATTER * rng.standard_normal(vel.shape) \
        * np.linalg.norm(vel, axis=1, keepdims=True)
    return pos, vel, mass, ptype, u


def phase_disc_small(device="cuda") -> None:
    """The small disc for DISC_SMALL_STEPS sync points on the card and on
    the CPU, held to each other after every one; at least one particle
    accreted."""
    from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                        parse_parameter_text)
    from gadget_leicester_tpu_torch.core.state import (CLOSE_FIELDS,
                                                       EXACT_FIELDS,
                                                       assert_states_close,
                                                       to_numpy)
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    from gadget_leicester_tpu_torch.models.sinks import \
        register_sinks_from_types
    cfg = parse_parameter_text(disc_small_param_text())
    opts = SimOptions(periodic=False, cooling="beta", sinks=True)
    pos, vel, mass, ptype, u = disc_small_ics()
    runs = {}
    for dev in (device, "cpu"):
        sim = Simulation(cfg, opts, dev)
        sim.set_ics(pos, vel, mass, ptype, u=u)
        sim.state = register_sinks_from_types(sim.state)
        runs[dev] = [to_numpy(sim.state)]
        for _ in range(DISC_SMALL_STEPS):
            sim.step()
            runs[dev].append(to_numpy(sim.state))
    worst = {}
    for g, c in zip(runs[device], runs["cpu"]):
        res = assert_states_close(g, c, fields=CLOSE_FIELDS + DISC_FIELDS,
                                  exact=EXACT_FIELDS + DISC_EXACT)
        for k, v in res.items():
            worst[k] = max(worst.get(k, (0.0, 0)), v)
    last = runs[device][-1]
    n_acc = int(last["sinks.n_accreted"].sum())
    report_close("slice", f"disc of 400 gas, beta cooling and sinks, "
                 f"{DISC_SMALL_STEPS} sync points, card vs CPU after each "
                 f"(sink slots and tallies equal; {n_acc} accreted)", worst)
    if n_acc == 0:
        raise AssertionError("the small disc accreted nothing")


# phase 14: lcdm_gas 2x128^3 with sinks. SinkAccretionRadius is 2.8 times
# SofteningGas (the force softening h of a gas particle); a sink is type 5,
# so SofteningBndry takes the gas softening too (a sink is born from a gas
# particle; 0 would leave its force unsoftened). SinkFormationDensity
# sits at this percentile of the gas density after set_ics, so that
# formation is exercised within the run.
SINK_RADIUS_PER_SOFT = 2.8
SINK_DENSITY_PERCENTILE = 99.999
# gates: the in-step potential after set_ics against compute_potential
# (tests/test_instep_potential.py's bound), alive mass and momentum across
# the fork's physics (sink formation moves nothing; accretion moves mass
# and momentum from gas to sink exactly, up to float32 rounding), and the
# entries tier's potential against the dense tier's on one near-idle sync
# point (as shares of the largest value)
SINK_INSTEP_TOL = 2e-4
SINK_MASS_TOL = 1e-5
SINK_MOMENTUM_TOL = 1e-5
SINK_TIER_POT_TOL = 2e-5
# which kernels the full-active path with the in-step potential launches
SINK_PATH = ("shortrange_potential", "pm_deposit", "sph_density",
             "sph_hydro", "pm_gather")


def sink_param_lines(n_side: int, box: float = 50000.0) -> str:
    soft = float(f"{box / n_side / 30:.3f}")      # param_text's softening
    return (f"SofteningBndry {soft}\nSofteningBndryMaxPhys {soft}\n"
            f"SinkAccretionRadius {SINK_RADIUS_PER_SOFT * soft:.4f}\n")


@contextlib.contextmanager
def fork_bookkeeping():
    """Within the body, each call of ``models.simulation.fork_physics``
    (cooling, sink formation, accretion) appends to the list this yields
    the alive mass and momentum before and after it, as float64 device
    tensors (read after the body, so no host sync is added)."""
    import torch

    from gadget_leicester_tpu_torch.models import simulation
    real = simulation.fork_physics
    log = []

    def totals(state):
        p = state.p
        m = torch.where(p.alive, p.mass, torch.zeros_like(p.mass)).double()
        return torch.cat([m.sum()[None], (m[:, None] * p.vel.double()).sum(0),
                          (m[:, None] * p.vel.double()).abs().sum()[None]])

    def spy(state, cfg, opts):
        before = totals(state)
        state = real(state, cfg, opts)
        log.append((before, totals(state)))
        return state

    simulation.fork_physics = spy
    try:
        yield log
    finally:
        simulation.fork_physics = real


def check_fork_bookkeeping(phase: str, log: list) -> None:
    """Hold the alive mass and momentum across each fork-physics call to
    SINK_MASS_TOL (relative) and SINK_MOMENTUM_TOL (of sum |m v|)."""
    dm = dp = 0.0
    for before, after in log:
        b, a = before.cpu().tolist(), after.cpu().tolist()
        dm = max(dm, abs(a[0] - b[0]) / b[0])
        dp = max(dp, max(abs(a[k] - b[k]) for k in (1, 2, 3)) / b[4])
    ok = dm <= SINK_MASS_TOL and dp <= SINK_MOMENTUM_TOL
    say(phase, f"across {len(log)} calls of cooling and sinks: alive mass "
        f"changed by at most {dm:.2e} of itself (bound {SINK_MASS_TOL:g}), "
        f"momentum by {dp:.2e} of sum |m v| (bound {SINK_MOMENTUM_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("mass or momentum not conserved across the "
                             "fork's physics")


def check_finite(phase: str, state) -> None:
    import torch
    for name, t in (("p.pos", state.p.pos), ("p.vel", state.p.vel),
                    ("p.acc", state.p.acc), ("p.acc_pm", state.p.acc_pm),
                    ("p.pot", state.p.pot), ("p.mass", state.p.mass),
                    ("gas.density", state.gas.density),
                    ("gas.hsml", state.gas.hsml),
                    ("gas.entropy", state.gas.entropy),
                    ("sinks.acc_mass", state.sinks.acc_mass)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{phase}: {name} is not finite")
    if int(state.overflow_flags) != 0:
        raise AssertionError(f"{phase}: overflow_flags "
                             f"{int(state.overflow_flags)}")


def check_launches(phase: str, counts: dict, used, what: str) -> None:
    """The kernels of ``used`` launched, and no other."""
    for name, n in counts.items():
        if (n > 0) != (name in used):
            raise AssertionError(f"{phase}: kernel {name} launched {n} times "
                                 f"in {what}")


def phase_sinks(results: dict, card: str, device="cuda",
                n_side=N_SIDE_MAIN) -> None:
    """lcdm_gas 2x128^3 with sinks (phase 14): the in-step potential
    through kernel H and E's potential mode, sink formation and accretion
    at full width."""
    import dataclasses

    import numpy as np
    import torch

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.core.state import (assert_states_close,
                                                       to_numpy)
    from gadget_leicester_tpu_torch.models import cooling, sinks
    from gadget_leicester_tpu_torch.models.forces import (comoving_factors,
                                                          compute_potential,
                                                          softening_table)
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    from gadget_leicester_tpu_torch.ops.cells import pack_cells_soa
    from gadget_leicester_tpu_torch.ops.pm import (cic_gather_vec,
                                                   pm_forces_periodic,
                                                   pm_potential_periodic)
    from gadget_leicester_tpu_torch.ops.pm_tiles import pm_deposit_tiles
    from gadget_leicester_tpu_torch.ops.softening import SOFTFAC
    cfg, opts, (pos, vel, mass, ptype, u) = setup(
        n_side, param_extra=sink_param_lines(n_side), sinks=True)
    sim = Simulation(cfg, opts, device)
    ng = None
    step_s, formed = [], []
    with recorded_inputs() as rec, fork_bookkeeping() as book, \
            pm_passes() as passes:
        kernels.reset_launches()
        t0 = time.time()
        sim.set_ics(pos, vel, mass, ptype, u=u)
        sync(device)
        init_s = time.time() - t0
        init = sim.state
        ng = init.n_gas_max
        gas = init.p.alive[:ng] & (init.p.ptype[:ng] == 0)
        thr = float(np.percentile(init.gas.density[gas].cpu().numpy(),
                                  SINK_DENSITY_PERCENTILE))
        sim.cfg = cfg = cfg.replace(sink_formation_density=thr)
        for _ in range(MAIN_STEPS):
            t0 = time.time()
            sim.step()
            sync(device)
            step_s.append(time.time() - t0)
            formed.append(int((sim.state.sinks.slot >= 0).sum()))
        counts = dict(kernels.launches)
    recorded = dict(rec)
    st = sim.state
    say("sinks", f"2x{n_side}^3, pmgrid {opts.pmgrid}, block SPH, sinks: "
        f"SofteningGas {cfg.softening_gas:g}, SofteningBndry "
        f"{cfg.softening_bndry:g}, SinkAccretionRadius "
        f"{cfg.sink_accretion_radius:g} kpc/h (2.8 x SofteningGas), "
        f"SinkFormationDensity {thr:.6g} (the {SINK_DENSITY_PERCENTILE}th "
        f"percentile of the gas density after set_ics)")
    say("sinks", f"init {init_s:.3f} s; per-step seconds "
        + ", ".join(f"{t:.3f}" for t in step_s) + " (without sinks, phase "
        "5: " + ", ".join(f"{t:.3f}" for t in STEP_SECONDS.get("main", []))
        + f") ({card})")
    say("sinks", f"launches {counts}; used sink slots after each sync "
        f"point {formed}; accreted {int(st.sinks.n_accreted.sum())}, "
        f"acc_mass {float(st.sinks.acc_mass.sum()):.6g}")
    check_launches("sinks", counts, SINK_PATH, "the full-active path with "
                   "sinks (kernel H, not A)")
    check_gather_launches("sinks", counts, passes)
    k_last = recorded["pm_gather"][0].shape[-1]
    say("sinks", f"kernel L's last gather on the step: K = {k_last} (the "
        "force and the mesh potential)")
    if k_last != 4:
        raise AssertionError("the PM step with the in-step potential did "
                             "not gather 4 components at once")
    results["shortrange_potential"]["launches"] = counts["shortrange_potential"]
    check_finite("sinks", st)
    check_fork_bookkeeping("sinks", book)
    if formed[-1] < 1:
        raise AssertionError("no sink formed at 2x128^3")
    # gate 1: the in-step potential after set_ics is the full potential.
    # The reference is compute_potential's (with the capacities set_ics
    # settled on) with its mesh piece taken in float64: the float32 CIC
    # weights of a 192^3 mesh resolve a position to ~1e-5 of a cell, which
    # moves the mesh potential by ~0.07 of its ~600 (2x32^3 and 2x64^3 on
    # the CPU alike), so two float32 mesh pieces from two deposits (kernel
    # B on the cell-relative pack, the point deposit on absolute
    # positions) differ by about twice that
    alive = init.p.alive
    box = float(cfg.box_size)
    ref = compute_potential(init, cfg, sim.opts).p.pot
    pm = [pm_potential_periodic(init.p.pos.to(d), init.p.mass.to(d), alive,
                                box, opts.pmgrid).double() * cfg.grav_internal
          for d in (torch.float32, torch.float64)]
    exact = ref.double() - pm[0] + pm[1]
    scale = float(exact[alive].abs().max())
    err = float((init.p.pot - exact)[alive].abs().max()) / scale
    err_pass = float((ref - exact)[alive].abs().max()) / scale
    err_f32 = float((init.p.pot - ref)[alive].abs().max()) / scale
    err_sr = float(((init.p.pot - init.p.pot_pm).double() - ref.double()
                    + pm[0])[alive].abs().max()) / scale
    say("sinks", f"after set_ics, in-step p.pot vs the full potential "
        f"(compute_potential, its mesh piece in float64): largest "
        f"difference {err:.2e} of max |pot| {scale:.6g} (bound "
        f"{SINK_INSTEP_TOL:g}) {'ok' if err <= SINK_INSTEP_TOL else 'FAIL'}"
        f"; compute_potential in float32 {err_pass:.2e} of it; the two "
        f"float32 potentials {err_f32:.2e}, their short-range and self "
        f"parts {err_sr:.2e}")
    if err > SINK_INSTEP_TOL:
        raise AssertionError("the in-step potential is not the full one")
    del ref, pm, exact, init
    # kernel H on the step's arguments, against its plain version, A's
    # force rows bit for bit, timed beside A (phase 6) and E (phase 8)
    check_kernels(recorded, f"2x{n_side}^3 step with sinks", results,
                  POTENTIAL, timed=True, every=FULL_EVERY)
    say_against_earlier("sinks", results, "shortrange_potential", card)
    check_step_potential_forces(recorded, f"2x{n_side}^3 step")
    del recorded
    kernels.recorded.clear()
    six = st
    # the fourth PM component: the PM pass with and without the potential
    # on the step's own deposit
    fac = comoving_factors(cfg, six.ti_current)
    soft = SOFTFAC * softening_table(cfg, fac.atime)[six.p.ptype.long()]
    cl = six.grids.grav
    n_cells = cl.n_cells
    soa = pack_cells_soa(cl, six.p.pos, six.p.mass, soft, six.p.alive)
    rho = pm_deposit_tiles(soa, n_cells, box, opts.pmgrid)
    del soa
    pm_ms = {}
    for k in (False, True):
        pm_ms[k], _ = time_ms(lambda: pm_forces_periodic(
            six.p.pos, six.p.mass, six.p.alive, box, opts.pmgrid,
            rho_grid=rho, with_potential=k), 3)
    # kernel L's gather (ops/pm.py :: cic_gather_vec) of the mesh stack
    # with K components, at the step's positions: the mesh potential
    # alone (the full potential's), the force, both (this path's step)
    field = pm_forces_periodic(six.p.pos, six.p.mass, six.p.alive, box,
                               opts.pmgrid, rho_grid=rho,
                               with_potential=True, return_field=True)
    posw = torch.remainder(six.p.pos, box)
    gather_ms = {}
    for k in (1, 3, 4):
        part = field[..., 4 - k:].contiguous()
        gather_ms[k], _ = time_ms(lambda: cic_gather_vec(
            part, posw, box, opts.pmgrid), 3)
    del rho, field, part, posw
    # cooling and sinks on this state, each with a device sync around it
    costs = {}
    for mode in ("beta", "stamatellos"):
        o = dataclasses.replace(opts, cooling=mode)
        costs[f"apply_cooling {mode}"], _ = time_ms(
            lambda: cooling.apply_cooling(six, cfg, o), 3)
    costs["create_sinks"], _ = time_ms(
        lambda: sinks.create_sinks(six, cfg, opts), 3)
    costs["accrete_onto_sinks"], _ = time_ms(
        lambda: sinks.accrete_onto_sinks(six, cfg, opts), 3)
    say("sinks", f"PM pass on the step's deposit: forces "
        f"{pm_ms[False]:.3f} ms, with the potential {pm_ms[True]:.3f} ms "
        f"(kernel L's gather of K = 1, 3, 4 mesh components "
        + ", ".join(f"{gather_ms[k]:.3f}" for k in (1, 3, 4)) + " ms); "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in costs.items())
        + f" (at 2x{n_side}^3, {formed[-1]} sink slots used) ({card})")
    with phase_timer(device) as totals:
        sim.step(2)
    say("sinks", f"2 more sync points with sinks, a device sync around each "
        f"phase ({card}):")
    say_phases("sinks", totals, 2)
    # a near-idle sync point through each tier, from the state after 6
    idle = make_near_idle(six, IDLE_FRAC_MAIN, IDLE_SEED)
    del six, st

    def run(force):
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

    # each tier's first run pays the allocator for its shapes: a second
    # run, whose state is dropped, times it warm
    with recorded_inputs() as rec:
        st_a, counts_a, log_a, dt_a = run(None)
    recorded = dict(rec)
    warm_a = run(None)[3]
    say_tiers("sinks", log_a)
    say("sinks", f"near-idle entries tier launches {counts_a}, "
        f"{1e3 * dt_a:.3f} ms, again {1e3 * warm_a:.3f} ms ({card})")
    check_launches("sinks", counts_a, POTENTIAL_ENTRIES
                   + ENTRIES[1:], "an entries-tier sync point with sinks")
    results.setdefault("shortrange_potential_entries", {})["launches"] = \
        counts_a["shortrange_potential_entries"]
    st_b, counts_b, _, dt_b = run(False)
    warm_b = run(False)[3]
    say("sinks", f"near-idle dense tier launches {counts_b}, "
        f"{1e3 * dt_b:.3f} ms, again {1e3 * warm_b:.3f} ms ({card})")
    check_launches("sinks", counts_b, ("shortrange_potential", "sph_density",
                                       "sph_hydro"),
                   "a dense-tier sync point with sinks")
    report_close("sinks", f"2x{n_side}^3 near-idle sync point with sinks, "
                 "entries vs dense tier", assert_states_close(
                     to_numpy(st_a), to_numpy(st_b)))
    alive = st_b.p.alive
    scale = float(st_b.p.pot[alive].abs().max())
    err = float((st_a.p.pot - st_b.p.pot)[alive].abs().max()) / scale
    say("sinks", f"near-idle p.pot, entries vs dense tier: largest "
        f"difference {err:.2e} of max |pot| (bound {SINK_TIER_POT_TOL:g}) "
        f"{'ok' if err <= SINK_TIER_POT_TOL else 'FAIL'}")
    if err > SINK_TIER_POT_TOL:
        raise AssertionError("the tiers disagree on the in-step potential")
    del st_a, st_b, idle
    check_kernels(recorded, f"2x{n_side}^3 near-idle, sinks", results,
                  POTENTIAL_ENTRIES, timed=True)
    say_against_earlier("sinks", results, "shortrange_potential_entries",
                        card)
    say("sinks", f"kernel H on the step {results['shortrange_potential']['ms']:.3f}"
        f" ms beside A {results['shortrange_gravity']['ms']:.3f} ms; E's "
        f"potential mode {results['shortrange_potential_entries']['ms']:.3f}"
        f" ms beside E {results['shortrange_gravity_entries']['ms']:.3f} ms "
        f"({card})")


# phase 15: parameterfiles/disc.param on the 20,000-gas disc that
# parameterfiles/make_ics.py writes, block SPH on its vacuum grid (auto
# resolves to blocks above 4,096 gas, as on the JAX package's
# accelerator): (a) through the CLI, ``--cooling beta --sinks``, in a
# child process, to DISC_T_END or DISC_CLI_STEPS sync points; (b) through
# the Python API with the star registered as a sink (the CLI never
# registers it: ROADMAP queue 3, fork fault (a)), to DISC_T_END or
# DISC_MAX_STEPS, for the accretion gate; one SPH pass of (b)'s last state
# under blocks against one under cells (CELLS_VS_BLOCKS, on the gas whose
# h is under both backends' caps); apply_cooling card vs CPU on it within
# COOLING_TOL of the largest |dcool| (tests/test_torch_cooling.py's bound)
DISC_N_GAS = 20000
DISC_T_END = 0.3
DISC_CLI_STEPS = 150
DISC_MAX_STEPS = 8
DISC_MASS_TOL = 1e-5
COOLING_TOL = 1e-5
# the disc's SPH kernels: the absolute modes of the block backend, and
# none of the periodic modes or of the coarse-cell backend
DISC_NOT = ("sph_density", "sph_hydro", "sph_density_entries",
            "sph_hydro_entries", "sph_cells_density", "sph_cells_hydro")
# runs the CLI's entry point as ``python -m`` does, and writes the
# kernels' launch counts to the file named by the first argument on exit
CLI_COUNTED = """
import json, runpy, sys
from gadget_leicester_tpu_torch import kernels
out, sys.argv = sys.argv[1], ["gadget_leicester_tpu_torch"] + sys.argv[2:]
try:
    runpy.run_module("gadget_leicester_tpu_torch", run_name="__main__",
                     alter_sys=True)
finally:
    with open(out, "w") as fh:
        json.dump(kernels.launches, fh)
"""


def write_disc_ics(path: str, n_gas: int = DISC_N_GAS) -> int:
    """``disc_ics(n_gas)`` as a format-1 GADGET IC file (gas, then the
    star as type 5), as ``parameterfiles/make_ics.py disc`` writes it;
    returns the particle count."""
    import numpy as np

    from gadget_leicester_tpu_torch.io.snapshot import (Header, SnapshotData,
                                                        write_snapshot)
    from gadget_leicester_tpu_torch.models.ics import disc_ics
    pos, vel, mass, ptype, u = disc_ics(n_gas=n_gas)
    h = Header()
    for t in range(6):
        h.npart[t] = int((ptype == t).sum())
    h.npart_total = h.npart.copy()
    write_snapshot(path, SnapshotData(
        header=h, pos=pos.astype(np.float32), vel=vel.astype(np.float32),
        ids=np.arange(1, len(pos) + 1, dtype=np.uint32),
        mass=mass.astype(np.float32), u=u.astype(np.float32)), fmt=1)
    return len(pos)


def check_disc_launches(what: str, counts: dict) -> None:
    """C and D launched in their absolute mode, no periodic or coarse-cell
    SPH kernel."""
    for name in ABS_DENSE:
        if counts[name] <= 0:
            raise AssertionError(f"{what} did not launch {name}")
    for name in DISC_NOT:
        if counts[name] != 0:
            raise AssertionError(f"{what} launched {name} {counts[name]} "
                                 "times")


def phase_disc_cli(results: dict, card: str) -> dict:
    """(a) of phase 15: the IC file and ``disc.param`` written under
    ``build/disc_cli/``, the run through the CLI in a child process, its
    launch counts (the main path's counts of C, D, F and G in their
    absolute mode; F and G run only where a sync point's entries fit
    2 nb^3, 16 at the 2^3 blocks the disc's capacity raises leave), its
    timings and the capacity raises of ``set_ics`` in info.txt, the
    snapshot at TimeMax (its first) held to the ICs' mass. The run's
    directory is deleted at the end. Returns the launch counts."""
    import numpy as np

    from gadget_leicester_tpu_torch.io.snapshot import read_snapshot
    root = Path(__file__).resolve().parent
    work = root / "build" / "disc_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        out = work / "out"
        n = write_disc_ics(str(work / "disc_ics.dat"))
        param = work / "disc.param"
        param.write_text(stock_param_text(
            "disc", str(work / "disc_ics.dat"), str(out), DISC_T_END,
            TimeOfFirstSnapshot=DISC_T_END))
        proc, wall = _cli(root, param, 0, "--cooling", "beta", "--sinks",
                          "--max-steps", DISC_CLI_STEPS, timeout=900,
                          phase="disc", counts_file=work / "launches.json")
        counts = json.loads((work / "launches.json").read_text())
        steps = [line.split() for line in
                 (out / "timings.txt").read_text().splitlines()
                 if line.startswith("Step=")]
        step_s = [float(c[3].rstrip("s")) for c in steps]
        active = [int(c[5]) for c in steps]
        notes = [line.strip() for line in
                 (out / "info.txt").read_text().splitlines()
                 if "overflow" in line]
        say("disc", f"CLI: disc.param on disc_ics(n_gas={DISC_N_GAS}) "
            f"({n} particles), --cooling beta --sinks: {len(step_s)} sync "
            f"points to t = {_done_time(proc):.4f} in {wall:.1f} s with "
            f"start-up; {1e3 * sum(step_s) / len(step_s):.1f} ms per sync "
            f"point (median {1e3 * float(np.median(step_s)):.1f} ms, "
            f"{sum(a < DISC_N_GAS // 10 for a in active)} sync points with "
            f"under 10% of the gas active) ({card})")
        say("disc", f"CLI: set_ics capacity raises {notes}")
        say("disc", "CLI: launches " + ", ".join(
            f"{k} {v}" for k, v in counts.items() if v or k in ABS))
        check_disc_launches("the disc through the CLI", counts)
        for name in ABS_DENSE:
            results.setdefault(name, {})["launches"] = counts[name]
        if _done_time(proc) < DISC_T_END * (1 - 1e-6):
            raise AssertionError("the disc through the CLI stopped early")
        snap = read_snapshot(str(out / "snapshot_000"))
        m0 = float(np.float64(
            read_snapshot(str(work / "disc_ics.dat")).mass).sum())
        m1 = float(snap.mass.astype(np.float64).sum())
        say("disc", f"CLI: snapshot_000 at t = {snap.header.time:.4f}: "
            f"{int(snap.header.npart.sum())} particles, mass {m0:.7f} -> "
            f"{m1:.7f} ({abs(m1 - m0) / m0:.2e}, bound {DISC_MASS_TOL:g})")
        if not (np.isfinite(snap.pos).all() and np.isfinite(snap.vel).all()
                and snap.hsml is not None and np.isfinite(snap.hsml).all()):
            raise AssertionError("the CLI's snapshot is not finite")
        if abs(m1 - m0) > DISC_MASS_TOL * m0:
            raise AssertionError("the disc through the CLI lost or gained "
                                 "mass")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counts


def disc_blocks_vs_cells(state, cfg, opts) -> None:
    """One SPH pass of the disc's ``state`` under blocks against one under
    cells (phase 15): blocks from the state's h, then both from the h it
    converged to (both solves then stop at the seed sweep unless they
    disagree), on fresh lists; the cells' capacity doubled until nothing
    overflows. Held to each other by CELLS_VS_BLOCKS on the gas whose h is
    under both backends' caps."""
    import dataclasses

    import torch

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.models.forces import (comoving_factors,
                                                          compute_sph,
                                                          gas_bounding_grid)
    from gadget_leicester_tpu_torch.models.grids import (KAPPA_SPH,
                                                         make_grid_cache,
                                                         sph_cells_geometry)
    ng = state.n_gas_max
    p = state.p
    gas = p.alive[:ng] & (p.ptype[:ng] == 0)
    fac = comoving_factors(cfg, state.ti_current)

    def fresh(st, **opt):
        st = dataclasses.replace(
            st, grids=make_grid_cache(p.pos.device),
            overflow_flags=torch.zeros_like(st.overflow_flags))
        kernels.reset_launches()
        out = compute_sph(st, cfg, dataclasses.replace(opts, **opt), fac,
                          gas)
        return out, {k: v for k, v in kernels.launches.items() if v}

    blocks, _ = fresh(state, sph_backend="blocks")
    start = dataclasses.replace(state, gas=dataclasses.replace(
        state.gas, hsml=blocks.gas.hsml))
    again, counts_b = fresh(start, sph_backend="blocks")
    cap_b = (1.0 - 2.0 * KAPPA_SPH) / float(again.grids.sph[0].inv_cell[0])
    n_cells, cap = sph_cells_geometry(cfg, opts.replace(sph_capacity=0), ng)
    while True:
        cells, counts_c = fresh(start, sph_backend="cells", sph_capacity=cap)
        if int(cells.overflow_flags) == 0:
            break
        cap *= 2
    cap_c = float(gas_bounding_grid(p.pos[:ng], gas)[1]) / n_cells
    h_b, h_c = again.gas.hsml, cells.gas.hsml
    under_b = h_b < cap_b * (1 - 1e-6)
    keep = gas & under_b & (h_c < cap_c * (1 - 1e-6))
    say("disc", f"blocks vs cells on the last state: blocks launches "
        f"{counts_b}, h cap {cap_b:.4f}, {int((gas & ~under_b).sum())} gas "
        f"at it; cells {n_cells}^3 x {cap} slots, launches {counts_c}, "
        f"h cap {cap_c:.4f}; {int(keep.sum())} of {int(gas.sum())} gas "
        f"under both caps")
    if int(again.overflow_flags) != 0:
        raise AssertionError("the blocks pass overflowed")
    compare_sph_fields("disc", "blocks vs cells",
                       {f: getattr(again.gas, f) for f in SPH_FIELDS},
                       {f: getattr(cells.gas, f) for f in SPH_FIELDS}, keep,
                       CELLS_VS_BLOCKS, CELLS_VS_BLOCKS_OUT)


@contextlib.contextmanager
def busiest_entries(density: str = "sph_density_entries_abs",
                    hydro: str = "sph_hydro_entries_abs"):
    """Within the body, kernels F's and G's arguments (``density``,
    ``hydro``: the names of one mode) at the entries-tier sync point whose
    entries hold the most live lanes (the first of equals): F's first call
    of that sync point (its first Newton sweep) and G's, cloned, as
    ``kept["args"]`` {name: arguments}; the live lanes of each entries-tier
    sync point in ``kept["lanes"]``. Each G call reads its count of live
    lanes from the card."""
    import torch

    from gadget_leicester_tpu_torch import kernels
    real = kernels.note_call
    kept: dict = {"args": None, "lanes": []}
    first: list = []

    def clone(args):
        return tuple(a.clone() if torch.is_tensor(a) else a for a in args)

    def spy(name, args):
        real(name, args)
        if name == density and not first:
            first.append(clone(args))
        elif name == hydro:
            tgt16, blk = args[0], args[4]
            lanes = int(((tgt16[:, 12] > 0) & (blk[:, None] >= 0)).sum())
            if not kept["lanes"] or lanes > max(kept["lanes"]):
                kept["args"] = {density: first[0], hydro: clone(args)}
            kept["lanes"].append(lanes)
            first.clear()

    kernels.note_call = spy
    try:
        yield kept
    finally:
        kernels.note_call = real


def device_split(fn, reps: int = 20) -> dict:
    """{device kernel: (mean ms a launch, launches seen)} over ``reps``
    calls of ``fn`` (after a warm-up call), by torch.profiler. The mean
    is over the launches the profiler saw, which may be fewer than
    ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = seen.get(e.name, (0.0, 0))
            seen[e.name] = (t + 1e-3 * (e.time_range.end - e.time_range.start),
                            n + 1)
    return {k: (t / n, n) for k, (t, n) in seen.items()}


def phase_disc(results: dict, card: str, device="cuda") -> None:
    """The Leicester disc (phase 15): (a) :func:`phase_disc_cli`; (b) the
    Python API: ``Simulation``, ``set_ics``, ``register_sinks_from_types``,
    then ``Simulation.run()`` with its overflow recovery, the accretion
    and mass gates; :func:`disc_blocks_vs_cells` and ``apply_cooling``
    card vs CPU on its last state. The run's directory is deleted at the
    end."""
    import dataclasses

    import torch

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                        parse_parameter_text)
    from gadget_leicester_tpu_torch.core.state import from_numpy, to_numpy
    from gadget_leicester_tpu_torch.models.cooling import apply_cooling
    from gadget_leicester_tpu_torch.models.grids import (KAPPA_SPH,
                                                         resolve_gravity_mode,
                                                         resolve_sph_backend,
                                                         sph_blocks_geometry)
    from gadget_leicester_tpu_torch.models.ics import disc_ics
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    from gadget_leicester_tpu_torch.models.sinks import \
        register_sinks_from_types
    cli_counts = phase_disc_cli(results, card)
    root = Path(__file__).resolve().parent
    work = root / "build" / "disc_run"
    shutil.rmtree(work, ignore_errors=True)
    try:
        cfg = parse_parameter_text(stock_param_text(
            "disc", str(work / "disc_ics.dat"), str(work / "out"),
            DISC_T_END))
        opts = SimOptions(periodic=False, cooling="beta", sinks=True)
        sim = Simulation(cfg, opts, device)
        pos, vel, mass, ptype, u = disc_ics(n_gas=DISC_N_GAS)
        t0 = time.time()
        sim.set_ics(pos, vel, mass, ptype, u=u)
        sim.state = register_sinks_from_types(sim.state)
        sync(device)
        init_s = time.time() - t0
        p = sim.state.p
        m0 = float(p.mass[p.alive].double().sum())
        n0 = int(p.alive.sum())
        backend = resolve_sph_backend(opts, sim.state.n_gas_max)
        caps = [sph_blocks_geometry(cfg, o, sim.state.n_gas_max)
                for o in (opts, sim.opts)]
        kernels.reset_launches()
        with busiest_entries() as busy, tier() as log:
            t0 = time.time()
            sim.run(max_steps=DISC_MAX_STEPS)
            sync(device)
            wall = time.time() - t0
        counts = dict(kernels.launches)
        st = sim.state
        p = st.p
        m1 = float(p.mass[p.alive].double().sum())
        n1 = int(p.alive.sum())
        n_acc = int(st.sinks.n_accreted.sum())
        notes = [line.strip() for line in
                 (work / "out" / "info.txt").read_text().splitlines()
                 if "overflow" in line]
        ng = st.n_gas_max
        gas = p.alive[:ng] & (p.ptype[:ng] == 0)
        h_cap = (1.0 - 2.0 * KAPPA_SPH) / float(st.grids.sph[0].inv_cell[0])
        at_cap = int((gas & (st.gas.hsml >= h_cap * (1 - 1e-6))).sum())
        say("disc", f"API: gravity {resolve_gravity_mode(opts, st.n_max)}, "
            f"SPH {backend}, beta cooling, sinks, the star registered; init "
            f"{init_s:.2f} s; {sim.step_count} sync points to t = "
            f"{sim.time:.4f} in {wall:.2f} s, "
            f"{1e3 * wall / max(sim.step_count, 1):.2f} ms per sync point "
            f"with the run loop ({card})")
        caps.append(sph_blocks_geometry(cfg, sim.opts, st.n_gas_max))
        say("disc", "API: launches " + ", ".join(
            f"{k} {v}" for k, v in counts.items() if v)
            + f"; blocks x slots a subcell: asked {caps[0]}, after set_ics "
            f"{caps[1]}, after the run {caps[2]}; info.txt overflow notes "
            f"{notes}; {at_cap} of {int(gas.sum())} gas at the h cap "
            f"{h_cap:.4f}")
        say("disc", f"API: accreted {n_acc} gas (alive {n0} -> {n1}), star "
            f"mass {float(p.mass[int(st.sinks.slot[0])]):.6f}, alive mass "
            f"{m0:.7f} -> {m1:.7f} ({abs(m1 - m0) / m0:.2e}, bound "
            f"{DISC_MASS_TOL:g})")
        if backend != "blocks":
            raise AssertionError(f"auto resolved to {backend}, not blocks")
        if not (sim.time >= DISC_T_END * (1 - 1e-6)
                or sim.step_count >= DISC_MAX_STEPS):
            raise AssertionError("the disc run stopped early")
        check_disc_launches("the disc through the Python API", counts)
        check_finite("disc", st)
        if abs(m1 - m0) > DISC_MASS_TOL * m0:
            raise AssertionError("the disc lost or gained mass")
        if n0 - n1 != n_acc:
            raise AssertionError(f"{n0 - n1} particles died, the tally says "
                                 f"{n_acc}")
        # kernels F and G on the disc's own arguments, at its busiest
        # entries-tier sync point
        if busy["args"] is None:
            raise AssertionError(f"the disc run took the entries tier at "
                                 f"none of its sync points: {log}")
        disc: dict = {}
        for name, what in (("sph_density_entries_abs", "F"),
                           ("sph_hydro_entries_abs", "G")):
            check_kernels(busy["args"], f"the disc (the entries-tier sync "
                          f"point of the most live lanes, "
                          f"{max(busy['lanes'])}; all: {busy['lanes']})",
                          disc, (name,), timed=True)
            results[f"{name}_disc"] = disc[name]
            say_against_earlier("disc", results, f"{name}_disc", card)
            args = cases(name, busy["args"])[0][1]
            split = device_split(lambda: kernel_pairs()[name][0](*args))
            say("disc", f"kernel {what} on those arguments under "
                "torch.profiler, ms a launch (launches seen of 20): "
                + ", ".join(f"{k[:40]} {t:.4f} ({n})"
                            for k, (t, n) in split.items())
                + f"; all {sum(t for t, _ in split.values()):.4f} of "
                f"{disc[name]['ms']:.4f} a call by CUDA events ({card})")
            say("disc", f"kernel {what} (absolute mode) launches: CLI "
                f"{cli_counts[name]}, API {counts[name]}; the API run took "
                f"the entries tier at {sum(took for *_, took in log)} of "
                f"its {len(log)} SPH passes ({card})")
        del busy, args
        disc_blocks_vs_cells(st, cfg, sim.opts)
        # apply_cooling on the last state, card against CPU (in disc.param's
        # units of 1 cm, 1 g and 1 cm/s the gas is at the 1 K floor, so the
        # Stamatellos rate is read toward backgrounds of 10 K and 1e7 K)
        host = from_numpy(to_numpy(st), "cpu")
        for mode, tbg in (("beta", None), ("stamatellos", 10.0),
                          ("stamatellos", 1e7)):
            o = dataclasses.replace(opts, cooling=mode)
            c = cfg if tbg is None else cfg.replace(cooling_tbg=tbg)
            got = (apply_cooling(st, c, o).gas.dt_entropy
                   - st.gas.dt_entropy).cpu()
            want = apply_cooling(host, c, o).gas.dt_entropy \
                - host.gas.dt_entropy
            scale = float(want.abs().max())
            err = float((got - want).abs().max()) / (scale or 1.0)
            ok = scale > 0 and bool(torch.isfinite(got).all()) \
                and err <= COOLING_TOL
            say("disc", f"apply_cooling {mode}"
                f"{'' if tbg is None else f' (CoolingTbg {tbg:g})'} on the "
                f"last state, card vs CPU: {err:.2e} of the largest |dcool| "
                f"{scale:.4g} (bound {COOLING_TOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"apply_cooling {mode}: card and CPU "
                                     "disagree")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# phase 16: the zoom at full width. parameterfiles/cluster.param's
# configuration (comoving, vacuum, from a = 0.2; kpc/h, 1e10 Msun/h, km/s)
# on a cube of ZOOM_BOX: 64^3 type-1 particles on a lattice jittered by a
# tenth of its spacing over the central cube of side ZOOM_BOX / 2, a 32^3
# lattice of type-2 particles, 8 times heavier, over the rest; the mean
# density the critical density of Einstein-de Sitter, as in
# tests/test_zeldovich.py
ZOOM_BOX = 10000.0
ZOOM_HR_SIDE = 64
ZOOM_LR_SIDE = 32
ZOOM_MASS_RATIO = 8.0
ZOOM_JITTER = 0.1
ZOOM_SEED = 16
ZOOM_STEPS = 4
ZOOM_TARGETS = 4096
ZOOM_OPTS = dict(periodic=False, pmgrid=128, hr_pmgrid=128, hr_types=0b10,
                 gravity_mode="zoom", sr_capacity=256)
# tests/test_zoom.py's bounds against the direct sum: rms relative force
# error over the HR targets and over all, rms relative potential error over
# the HR targets
ZOOM_BOUNDS = {"HR force": 0.01, "all force": 0.02, "HR potential": 0.02}
# the parts of one zoom force pass (models/forces.py :: _zoom_gravity),
# timed as TIMED's
ZOOM_TIMED = (
    (f"{_PKG}.models.forces", "pm_forces_nonperiodic", "coarse PM (vacuum)"),
    (f"{_PKG}.models.forces", "pm_forces_diff", "fine PM (band-pass)"),
    (f"{_PKG}.ops.pm", "cic_gather_vec", "  kernel L (each mesh)"),
    (f"{_PKG}.models.forces", "build_cell_list", "cell lists (coarse, fine)"),
    (f"{_PKG}.models.forces", "zoom_shortrange", "pair passes (A, then B)"),
)


def zoom_config():
    """cfg of ``parameterfiles/cluster.param``."""
    from gadget_leicester_tpu_torch.core.config import parse_parameter_text
    root = Path(__file__).resolve().parent
    return parse_parameter_text(
        (root / "parameterfiles" / "cluster.param").read_text())


def zoom_ics(cfg, seed: int = ZOOM_SEED, hr_side: int = ZOOM_HR_SIDE,
             lr_side: int = ZOOM_LR_SIDE, box: float = ZOOM_BOX):
    """(pos, vel, mass, ptype) of phase 16's zoom cube, at rest."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def lattice(n, lo, side):
        g = lo + (np.arange(n) + 0.5) * side / n
        return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(
            -1, 3)

    hr = lattice(hr_side, box / 4, box / 2)
    hr += rng.uniform(-ZOOM_JITTER, ZOOM_JITTER, hr.shape) * box / 2 / hr_side
    lr = lattice(lr_side, 0.0, box)
    lr = lr[~(np.abs(lr - box / 2) < box / 4).all(1)]
    h0 = cfg.hubble_internal
    rho_crit = 3.0 * h0 ** 2 / (8.0 * np.pi * cfg.grav_internal)
    m_hr = rho_crit * box ** 3 / (len(hr) + ZOOM_MASS_RATIO * len(lr))
    pos = np.concatenate([hr, lr]).astype(np.float32)
    mass = np.concatenate([np.full(len(hr), m_hr),
                           np.full(len(lr), ZOOM_MASS_RATIO * m_hr)])
    ptype = np.concatenate([np.ones(len(hr)), np.full(len(lr), 2)])
    return (pos, np.zeros_like(pos), mass.astype(np.float32),
            ptype.astype(np.int32))


def direct_at(pos, mass, soft, alive, targets, block: int = 32):
    """float64 (acc [T, 3], pot [T]) without G at the particles
    ``targets`` from every alive particle: the softened pair sum with
    max(h_i, h_j), no self-pair."""
    import torch

    from gadget_leicester_tpu_torch.ops.softening import grav_fac, grav_pot
    pos64, s64 = pos.double(), soft.double()
    m64 = torch.where(alive, mass, torch.zeros_like(mass)).double()
    accs, pots = [], []
    for i in range(0, targets.numel(), block):
        t = targets[i:i + block]
        dx = pos64[t, None, :] - pos64[None]
        r = torch.sqrt((dx * dx).sum(-1))
        h = torch.maximum(s64[t, None], s64[None])
        accs.append(-((m64[None] * grav_fac(r, h))[..., None] * dx).sum(1))
        pw = torch.where(r > 0, grav_pot(r, h), torch.zeros_like(r))
        pots.append((m64[None] * pw).sum(1))
    return torch.cat(accs), torch.cat(pots)


@contextlib.contextmanager
def kernel_history():
    """Within the body, every kernel wrapper's (name, arguments) is
    appended to the list this yields."""
    from gadget_leicester_tpu_torch import kernels
    kernels.history = []
    try:
        yield kernels.history
    finally:
        kernels.history = None


def zoom_hr_pairs(state, opts, targets) -> dict:
    """For the particles ``targets``: their candidates in pass A's cell
    list (the coarse cube, as ``_zoom_gravity`` fits it), those within
    rcut_c, and the HR-HR pairs among each, which pass A evaluates and
    multiplies by 0."""
    import torch

    from gadget_leicester_tpu_torch.models.forces import _bounding_cube
    from gadget_leicester_tpu_torch.ops.neighbors import (build_cell_list,
                                                          candidate_indices)
    from gadget_leicester_tpu_torch.ops.pm import ASMTH, RCUT
    p = state.p
    origin, extent = _bounding_cube(p.pos, p.alive, 0.01)
    hr_sel = p.alive & (((opts.hr_types >> p.ptype.clamp(0, 5)) & 1) == 1)
    origin_h, extent_h = _bounding_cube(p.pos, hr_sel, 0.05)
    ext, ext_h = float(extent), float(extent_h)
    asmth = ASMTH * ext / opts.pmgrid
    # the HR region as the band-pass mesh finds it (ops/pm.py ::
    # pm_forces_diff)
    rel = p.pos - origin_h
    in_hr = ((rel >= 0) & (rel < ext_h)).all(dim=-1) & p.alive
    n_cells = max(3, int(opts.pmgrid / (RCUT * ASMTH)))
    cl = build_cell_list(p.pos, p.alive, origin, ext, n_cells=n_cells,
                         capacity=opts.sr_capacity, periodic=False)
    out = {"candidates": 0, "within rcut": 0, "HR-HR candidates": 0,
           "HR-HR within rcut": 0, "stencil slots": 0}
    for i in range(0, targets.numel(), 256):
        t = targets[i:i + 256]
        cand = candidate_indices(cl, p.pos[t])
        ok = cand >= 0
        ci = cand.clamp_min(0).long()
        d = p.pos[t][:, None, :] - p.pos[ci]
        near = ok & ((d * d).sum(-1) < (RCUT * asmth) ** 2)
        both = ok & in_hr[t][:, None] & in_hr[ci]
        out["stencil slots"] += cand.numel()
        out["candidates"] += int(ok.sum())
        out["within rcut"] += int(near.sum())
        out["HR-HR candidates"] += int(both.sum())
        out["HR-HR within rcut"] += int((both & near).sum())
    return out


def phase_zoom(card: str, device="cuda") -> None:
    """The zoom at full width (phase 16): ``Simulation(...,
    gravity_mode="zoom")`` on :func:`zoom_ics`, ``set_ics`` and
    ``ZOOM_STEPS`` sync points, the launches of that run (kernel L twice a
    force pass, no other kernel); gates: finite, no overflow; one force
    pass with every particle active, its parts timed (:data:`ZOOM_TIMED`),
    and the full potential, held to the float64 direct sum on seeded HR
    and all-particle targets by tests/test_zoom.py's bounds; kernel L's
    gathers of both meshes against its plain version, bit for bit and
    against its float64 plain version, timed beside the plain version, its
    bound and ``grid_sample``; the share of pass A's candidate pairs that
    are HR-HR pairs it masks out."""
    import dataclasses

    import torch

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.core.config import SimOptions
    from gadget_leicester_tpu_torch.models.forces import (compute_forces,
                                                          compute_potential,
                                                          gravity_softening,
                                                          comoving_factors)
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg = zoom_config()
    opts = SimOptions(**ZOOM_OPTS)
    pos, vel, mass, ptype = zoom_ics(cfg)
    n = len(pos)
    say("zoom", f"cluster.param, {n} particles ({(ptype == 1).sum()} HR of "
        f"type 1, {(ptype == 2).sum()} of type 2, 8x heavier) in a cube of "
        f"{ZOOM_BOX:g} kpc/h, a = {cfg.time_begin:g}; {opts_label(opts)}")
    sim = Simulation(cfg, opts, device)
    kernels.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    sim.set_ics(pos, vel, mass, ptype)
    sync(device)
    t_init = time.perf_counter() - t0
    step_s = []
    for _ in range(ZOOM_STEPS):
        t0 = time.perf_counter()
        sim.step()
        sync(device)
        step_s.append(time.perf_counter() - t0)
    counts = dict(kernels.launches)
    st, opts = sim.state, sim.opts    # the capacities after set_ics
    passes = 1 + len(sim.init_notes) + ZOOM_STEPS
    say("zoom", f"set_ics {t_init:.3f} s (capacity raises: "
        f"{sim.init_notes or 'none'}), sync points "
        + ", ".join(f"{t:.3f}" for t in step_s)
        + f" s to a = {sim.time:.6f}; kernel L {counts['pm_gather']} launches"
        f" over {passes} force passes ({card})")
    check_launches("zoom", counts, ("pm_gather",), "the zoom run")
    if counts["pm_gather"] != 2 * passes:
        raise AssertionError(f"zoom: kernel L launched {counts['pm_gather']}"
                             f" times over {passes} force passes, not 2 each")
    check_finite("zoom", st)

    # one force pass with every particle active, timed by parts, and the
    # full potential; then the direct sum at seeded targets
    p = st.p
    full = dataclasses.replace(st, p=dataclasses.replace(
        p, ti_endstep=torch.full_like(p.ti_endstep, int(st.ti_current))))
    with kernel_history() as calls, phase_timer(device, ZOOM_TIMED) as tot:
        sync(device)
        t0 = time.perf_counter()
        forced = compute_forces(full, cfg, opts, do_sph=False)
        sync(device)
        t_pass = time.perf_counter() - t0
    say("zoom", f"one force pass, every particle active, a device sync "
        f"around each part: {1e3 * t_pass:.1f} ms ({card})")
    say_phases("zoom", tot, 1, ZOOM_TIMED)
    for label, what in (("pair passes (A, then B)", ("pass A", "pass B")),
                        ("cell lists (coarse, fine)", ("coarse", "fine")),
                        ("  kernel L (each mesh)", ("coarse", "fine"))):
        say("zoom", f"  {label.strip()}: " + ", ".join(
            f"{w} {1e3 * t:.3f} ms" for w, t in zip(what, tot[label][3])))
    t0 = time.perf_counter()
    pot_state = compute_potential(st, cfg, opts)
    sync(device)
    say("zoom", f"compute_potential {1e3 * (time.perf_counter() - t0):.1f} "
        f"ms ({card})")
    check_finite("zoom", forced)
    check_finite("zoom", pot_state)

    gen = torch.Generator().manual_seed(ZOOM_SEED)
    alive = p.alive.cpu()
    hr = torch.nonzero(alive & (p.ptype.cpu() == 1)).flatten()
    every = torch.nonzero(alive).flatten()
    t_hr = hr[torch.randperm(hr.numel(), generator=gen)[:ZOOM_TARGETS]]
    t_all = every[torch.randperm(every.numel(), generator=gen)[:ZOOM_TARGETS]]
    fac = comoving_factors(cfg, st.ti_current)
    soft = gravity_softening(st, cfg, opts, fac.atime)
    g = cfg.grav_internal
    corr = 0.5 * cfg.omega0 * cfg.hubble_internal ** 2
    errs = {}
    t0 = time.perf_counter()
    for what, t in (("HR", t_hr), ("all", t_all)):
        t = t.to(p.pos.device)
        acc_d, pot_d = direct_at(p.pos, p.mass, soft, p.alive, t)
        # compute_forces adds the comoving vacuum background term to acc
        got = (forced.p.acc[t] + forced.p.acc_pm[t]).double() \
            - corr * p.pos[t].double()
        ref = g * acc_d
        rel = ((got - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30))
        errs[f"{what} force"] = float(rel.pow(2).mean().sqrt())
        if what == "HR":
            pref = g * pot_d
            perr = (pot_state.p.pot[t].double() - pref).abs() \
                / pref.abs().clamp_min(1e-30)
            errs["HR potential"] = float(perr.pow(2).mean().sqrt())
    say("zoom", f"against the float64 direct sum at {ZOOM_TARGETS} seeded HR "
        f"and {ZOOM_TARGETS} seeded targets ({time.perf_counter() - t0:.1f} "
        "s): " + ", ".join(f"{k} rms {v:.4%} (bound {ZOOM_BOUNDS[k]:.0%})"
                           for k, v in errs.items()))
    for k, v in errs.items():
        if not v < ZOOM_BOUNDS[k]:
            raise AssertionError(f"zoom: {k} rms error {v:.4%} beyond "
                                 f"{ZOOM_BOUNDS[k]:.0%}")

    # kernel L on the two meshes of that pass
    gathers = [args for name, args in calls if name == "pm_gather"]
    if len(gathers) != 2:
        raise AssertionError(f"zoom: {len(gathers)} gathers in one force "
                             "pass, not 2")
    res: dict = {}
    for what, args in zip(("coarse", "fine"), gathers):
        field, posw, box, m = args
        check_kernels({"pm_gather": args}, f"zoom {what} mesh {m}^3 "
                      f"K={field.shape[-1]}", res, GATHER, timed=True)
        times = gather_timings("zoom", field, posw, p.alive, box, m, card)
        say("zoom", f"kernel L on the {what} mesh ({m}^3, box "
            f"{box:.2f} kpc/h, K={field.shape[-1]}): {times['ms']:.3f} ms, "
            f"plain {times['plain_ms']:.3f} ms, grid_sample "
            f"{times['library_ms']:.3f} ms, bound "
            f"{res['pm_gather']['bound_ms']:.4f} ms by "
            f"{res['pm_gather']['bound_by']} ({card})")
    del calls, gathers, field, posw, res

    share = zoom_hr_pairs(st, opts, t_all.to(p.pos.device))
    say("zoom", f"pass A at {ZOOM_TARGETS} seeded targets: "
        f"{share['stencil slots']} stencil slots, {share['candidates']} "
        f"candidates ({share['HR-HR candidates']} HR-HR, "
        f"{share['HR-HR candidates'] / share['candidates']:.1%}), "
        f"{share['within rcut']} within rcut_c ({share['HR-HR within rcut']}"
        f" HR-HR, {share['HR-HR within rcut'] / share['within rcut']:.1%}): "
        "pass A evaluates every candidate and multiplies the HR-HR ones by 0")


# phase 17: the small switches on phase 4's box, card against CPU; the
# glass through the CLI; the Zel'dovich pancake
SWITCH_RUNS = (("nogravity", False), ("adaptive_gravsoft_forgas", True),
               ("isotherm_eqs", False))
GLASS_SIDE = 64
GLASS_RESIDUAL = 0.5     # tests/test_features.py::test_make_glass
GLASS_CONTRAST = 0.6
# tests/test_zeldovich.py: a plane wave in an EdS box, 16^3 particles,
# pmgrid 32, from a = 0.05 to 0.2 (shell crossing at 0.5)
ZEL_N_SIDE, ZEL_BOX = 16, 100.0
ZEL_A_I, ZEL_A_CROSS, ZEL_A_F = 0.05, 0.5, 0.2
ZEL_BOUNDS = {"rms": 0.05, "max": 0.15, "transverse": 0.02}


def zeldovich_param_text() -> str:
    """tests/test_zeldovich.py's parameter text."""
    soft = ZEL_BOX / ZEL_N_SIDE / 30
    return f"""
InitCondFile x
OutputDir /tmp/zel
TimeBegin {ZEL_A_I}
TimeMax   {ZEL_A_F}
ComovingIntegrationOn 1
PeriodicBoundariesOn 1
BoxSize   {ZEL_BOX}
Omega0    1.0
OmegaLambda 0.0
HubbleParam 1.0
GravityConstantInternal 43007.1
UnitLength_in_cm         3.085678e21
UnitMass_in_g            1.989e43
UnitVelocity_in_cm_per_s 1e5
MaxSizeTimestep 0.02
SofteningHalo {soft}
SofteningHaloMaxPhys {soft}
"""


def pancake_ics(cfg):
    """The plane wave of tests/test_zeldovich.py at a_i, crossing at
    ZEL_A_CROSS: (Lagrangian q, pos, vel in the file convention v_pec /
    sqrt(a), mass at the critical density, psi_i)."""
    import numpy as np
    k = 2 * np.pi / ZEL_BOX
    amp = (ZEL_A_I / ZEL_A_CROSS) / k
    g = (np.arange(ZEL_N_SIDE) + 0.5) / ZEL_N_SIDE * ZEL_BOX
    q = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    psi = amp * np.sin(k * q[:, 0])
    pos = q.copy()
    pos[:, 0] = np.mod(q[:, 0] + psi, ZEL_BOX)
    n = len(pos)
    h0 = cfg.hubble_internal
    rho_crit = 3.0 * h0 ** 2 / (8.0 * np.pi * cfg.grav_internal)
    mass = np.full(n, rho_crit * ZEL_BOX ** 3 / n)
    vel = np.zeros((n, 3))
    # v_pec = a H(a) f psi with f = 1 (EdS)
    vel[:, 0] = ZEL_A_I * h0 * ZEL_A_I ** -1.5 * psi / np.sqrt(ZEL_A_I)
    return q, pos, vel, mass, psi


def zeldovich_errors(sim, q, psi_i) -> dict:
    """The displacement errors of :func:`pancake_ics`'s run ``sim``, as
    shares of the analytic amplitude at its time."""
    import numpy as np
    n = len(q)
    a_now = sim.time
    psi_now = psi_i * (a_now / ZEL_A_I)
    x_exact = np.mod(q[:, 0] + psi_now, ZEL_BOX)
    p = sim.state.p
    order = np.argsort(p.pid.cpu().numpy()[:n])
    pos = p.pos.cpu().numpy()[:n][order]
    dx = pos[:, 0] - x_exact
    dx -= ZEL_BOX * np.round(dx / ZEL_BOX)
    yz = pos[:, 1:] - q[:, 1:]
    yz -= ZEL_BOX * np.round(yz / ZEL_BOX)
    amp = np.abs(psi_now).max()
    return {"rms": float(np.sqrt((dx ** 2).mean()) / amp),
            "max": float(np.abs(dx).max() / amp),
            "transverse": float(np.abs(yz).max() / amp)}


def phase_glass(card: str, device="cuda", side: int = GLASS_SIDE) -> None:
    """``python -m gadget_leicester_tpu_torch glass.param 0 --makeglass
    64`` in a child process (through :data:`CLI_COUNTED`): kernel L once a
    relaxation step; the glass.dat it writes held to test_make_glass's
    checks: in the box, the residual force below half the first, the CIC
    density contrast on 64^3 cells below 0.6 of the Poisson start's."""
    import numpy as np
    import torch

    from gadget_leicester_tpu_torch.io.snapshot import read_snapshot
    from gadget_leicester_tpu_torch.ops.pm import cic_deposit
    root = Path(__file__).resolve().parent
    work = root / "build" / "glass_run"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        param = work / "glass.param"
        param.write_text(stock_param_text("gassphere", "unused",
                                          str(work / "out"), 1.0))
        proc, wall = _cli(root, param, 0, "--makeglass", side, "--device",
                          device, phase="glass",
                          counts_file=work / "launches.json")
        counts = json.loads((work / "launches.json").read_text())
        ratio = float(proc.stdout.split("residual force ratio ")[1]
                      .split(")")[0])
        snap = read_snapshot(str(work / "out" / "glass.dat"))
        n = side ** 3
        box = float(snap.header.box_size)

        def contrast(pos):
            t = torch.as_tensor(pos, dtype=torch.float32, device=device)
            return float(cic_deposit(t, torch.ones(len(t), device=device),
                                     box, side).std())
        poisson = np.random.default_rng(4).uniform(0, box, (n, 3))
        c_glass, c_poisson = contrast(snap.pos), contrast(poisson)
        say("glass", f"{n} particles in {wall:.1f} s wall with start-up; "
            f"kernel L {counts['pm_gather']} launches; residual force ratio "
            f"{ratio:.3f} (bound {GLASS_RESIDUAL}); CIC density contrast "
            f"{c_glass:.4f} against the Poisson start's {c_poisson:.4f} "
            f"({c_glass / c_poisson:.3f}, bound {GLASS_CONTRAST}) ({card})")
        if device == "cuda":
            check_launches("glass", counts, ("pm_gather",), "--makeglass")
        if snap.pos.shape != (n, 3) or list(snap.header.npart) != \
                [0, n, 0, 0, 0, 0]:
            raise AssertionError("glass.dat: wrong particle count")
        if not ((snap.pos >= 0) & (snap.pos < box)).all():
            raise AssertionError("glass.dat: a position outside the box")
        if not ratio < GLASS_RESIDUAL:
            raise AssertionError(f"glass: residual force ratio {ratio}")
        if not c_glass < GLASS_CONTRAST * c_poisson:
            raise AssertionError("glass: no more uniform than Poisson")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_zeldovich(card: str, device="cuda") -> None:
    """The Zel'dovich pancake on the card (tests/test_zeldovich.py):
    16^3 particles, TreePM with pmgrid 32, a = 0.05 to 0.2 through
    ``run_until``, its displacements against the growing mode."""
    import numpy as np

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                        parse_parameter_text)
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg = parse_parameter_text(zeldovich_param_text())
    opts = SimOptions(periodic=True, pmgrid=2 * ZEL_N_SIDE,
                      gravity_mode="treepm")
    q, pos, vel, mass, psi = pancake_ics(cfg)
    sim = Simulation(cfg, opts, device)
    kernels.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    sim.set_ics(pos, vel, mass, np.ones(len(pos), np.int32))
    sim.run_until(ZEL_A_F, max_steps=500)
    sync(device)
    wall = time.perf_counter() - t0
    errs = zeldovich_errors(sim, q, psi)
    say("zeldovich", f"{len(pos)} particles, {sim.step_count} sync points "
        f"to a = {sim.time:.6f} in {wall:.2f} s ({card}); launches "
        f"{_nonzero(kernels.launches)}; displacement errors "
        + ", ".join(f"{k} {v:.4f} (bound {ZEL_BOUNDS[k]})"
                    for k, v in errs.items()))
    check_finite("zeldovich", sim.state)
    if sim.time < ZEL_A_F * 0.999:
        raise AssertionError("zeldovich: the run stopped early")
    for k, v in errs.items():
        if not v < ZEL_BOUNDS[k]:
            raise AssertionError(f"zeldovich: {k} error {v} beyond "
                                 f"{ZEL_BOUNDS[k]}")


def phase_switches(card: str, device="cuda") -> None:
    """Phase 17: 2 sync points of phase 4's small box under each switch,
    card against CPU (the full potential too with the adaptive gas
    softening); the glass (:func:`phase_glass`); the Zel'dovich pancake
    (:func:`phase_zeldovich`)."""
    for switch, potential in SWITCH_RUNS:
        phase_slice(device, potential=potential, phase="switches", card=card,
                    **{switch: True})
    phase_glass(card, device)
    phase_zeldovich(card, device)


# phase 18: the slab step on a ring of one (parallel/), held to the
# single-device run by tests/test_spmd_step.py's bounds: position as a
# share of the mean spacing, velocity and acc (and, for the CLI,
# energy.txt's columns) of their largest value
SLAB_STEPS = 8
SLAB_BOUND = 5e-4
# particles whose timestep bins (ti_begstep, ti_endstep) differ between the
# two runs: a step quantised on the other side of a power of two by a
# float32 difference of the sums, after which the kicks differ; they are
# counted, held to this share of the particles, and left out of the bound
SLAB_FLIP_SHARE = 1e-2
# the slab modes are held to their float64 plain versions on every 8th
# tile or block, every tile on (the float32 plain version of A's slab mode
# alone takes 26 s on an H100 at 2x128^3); the timings keep them all
SLAB_EVERY = 8
SLAB_CLI_STEPS = 2
# the full-width comparisons of A, C, D (phase 6) and H (phases 6 and 14)
# with their float64 plain versions switch on every 4th tile (the timings
# keep them all), so that the whole script keeps to its run's time limit
# with phase 19 in it
FULL_EVERY = 4
SLAB_CLI_CADENCE = """
TimeBetStatistics 0.00001
TimeOfFirstSnapshot 0.0
TimeBetSnapshot 100.0
CpuTimeBetRestartFile 1e9
"""
# the parts of the slab PM (parallel/pm_sharded.py :: pm_local_forces),
# each timed as in TIMED; its reduce-scatter and all-gather are timed on
# the ring itself
SLAB_PM_TIMED = (
    (f"{_PKG}.parallel.pm_sharded", "cic_deposit", "deposit (point CIC)"),
    (f"{_PKG}.parallel.pm_sharded", "_pencil_rfft3",
     "forward FFT (with all_to_all)"),
    (f"{_PKG}.parallel.pm_sharded", "_pencil_irfft3",
     "inverse FFTs (with all_to_all)"),
    (f"{_PKG}.parallel.pm_sharded", "cic_gather_vec", "gather (kernel L)"),
)


def hold_slab(phase: str, what: str, got: dict, want: dict, box: float,
              spacing: float, rcut: float = 0.0) -> None:
    """Two runs by pid (``parallel/launch.py :: _by_pid`` dicts) within
    SLAB_BOUND: position over the mean spacing (periodic), velocity and
    acc of their largest value, on the particles whose timestep bins
    agree; those whose bins differ (or, without bins, whose velocity is
    beyond the bound) counted, at most SLAB_FLIP_SHARE of all, with the
    share of them within ``rcut`` of the slab's faces x = 0 and x = box."""
    import numpy as np
    if not np.array_equal(got["pid"], want["pid"]):
        raise AssertionError(f"{phase}: {what}: the particles differ")
    dpos = got["pos"] - want["pos"]
    dpos -= box * np.round(dpos / box)
    if "ti_endstep" in got:
        same = (got["ti_begstep"] == want["ti_begstep"]) \
            & (got["ti_endstep"] == want["ti_endstep"])
    else:
        same = np.abs(got["vel"] - want["vel"]).max(1) \
            < SLAB_BOUND * np.abs(want["vel"]).max()
    errs = {"pos": float(np.abs(dpos[same]).max()) / spacing}
    for f in ("vel", "acc"):
        if f in got:
            errs[f] = float(np.abs(got[f][same] - want[f][same]).max()
                            / max(np.abs(want[f]).max(), 1e-30))
    n_flip = int((~same).sum())
    x = np.mod(want["pos"][~same, 0], box)
    near = float(((x < rcut) | (x > box - rcut)).mean()) if n_flip else 0.0
    if "acc" in got:
        bad = same & (np.abs(got["acc"] - want["acc"]).max(1)
                      > SLAB_BOUND * np.abs(want["acc"]).max())
        xb = np.mod(want["pos"][bad, 0], box)
        say(phase, f"{what}: {int(bad.sum())} particles with acc beyond the "
            f"bound, {int(((xb < rcut) | (xb > box - rcut)).sum())} of them "
            "within rcut of x = 0 or the box")
    say(phase, f"{what}: " + ", ".join(f"{k} {v:.2e}"
                                       for k, v in errs.items())
        + f" (bound {SLAB_BOUND:g}) on {int(same.sum())} particles; "
        f"{n_flip} ({n_flip / len(same):.2e}) in other timestep bins (or "
        f"velocities), {100 * near:.1f}% of them within rcut of x = 0 or "
        f"the box (the whole: {200 * rcut / box:.1f}%)")
    if not all(v < SLAB_BOUND for v in errs.values()) \
            or n_flip > SLAB_FLIP_SHARE * len(same):
        raise AssertionError(f"{phase}: {what} beyond {SLAB_BOUND}")


@contextlib.contextmanager
def slab_pm_passes():
    """Within the body, the slab step's PM passes (its calls of
    ``pm_local_forces``) are counted in the dict this yields; each
    gathers once through kernel L."""
    from gadget_leicester_tpu_torch.parallel import spmd
    calls = {"pm_local_forces": 0}
    real = spmd.pm_local_forces

    def spy(*args, **kw):
        calls["pm_local_forces"] += 1
        return real(*args, **kw)

    spmd.pm_local_forces = spy
    try:
        yield calls
    finally:
        spmd.pm_local_forces = real


@contextlib.contextmanager
def ring_timer(ring, device="cuda"):
    """Within the body, the ring's reduce-scatter and all-gather run with a
    device sync on both sides; the dict this yields gets their seconds."""
    totals = {"reduce_scatter": 0.0, "all_gather": 0.0}

    def timed(name, fn):
        def run(*args):
            sync(device)
            t0 = time.perf_counter()
            out = fn(*args)
            sync(device)
            totals[name] += time.perf_counter() - t0
            return out
        return run

    for name in totals:
        setattr(ring, name, timed(name, getattr(ring, name)))
    try:
        yield totals
    finally:
        for name in totals:
            delattr(ring, name)


def phase_slab(results: dict, card: str, device="cuda",
               n_side=N_SIDE_MAIN, steps=SLAB_STEPS) -> None:
    """The slab step at full width (phase 18): phase 5's configuration on
    a ring of one, ``Simulation(..., mesh=1)``; see the module docstring."""
    import torch

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    from gadget_leicester_tpu_torch.ops import pm
    from gadget_leicester_tpu_torch.parallel.launch import _by_pid
    from gadget_leicester_tpu_torch.parallel.pm_sharded import \
        pm_local_forces
    cfg, opts, ics = setup(n_side)
    pos, vel, mass, ptype, u = ics
    box, spacing = float(cfg.box_size), float(cfg.box_size) / n_side

    def run_steps(sim, first):
        secs = []
        for i in range(steps):
            t0 = time.time()
            sim.step()
            sync(device)
            secs.append(time.time() - t0)
            if i == 0:
                # every particle active at the first sync point
                first.append(_by_pid(sim.canonical_state()))
        return secs

    firsts = []
    one = Simulation(cfg, opts, device)
    one.set_ics(pos, vel, mass, ptype, u=u)
    one_s = run_steps(one, firsts)
    want = _by_pid(one.state)
    del one
    gc.collect()
    torch.cuda.empty_cache()

    ring = Simulation(cfg, opts, device, mesh=1)
    with recorded_inputs() as rec:
        kernels.reset_launches()
        t0 = time.time()
        ring.set_ics(pos, vel, mass, ptype, u=u)
        sync(device)
        init_s = time.time() - t0
        init_counts = _nonzero(kernels.launches)
        kernels.reset_launches()
        with slab_pm_passes() as passes:
            ring_s = run_steps(ring, firsts)
        counts = dict(kernels.launches)
    n_pm = passes["pm_local_forces"]
    recorded = dict(rec)
    st = ring.state
    say("slab", f"ring of {ring.mesh.size} rank (NCCL), slab edges "
        f"{ring.spmd_edges.tolist()}, chunk (gas, other) {ring.spmd_caps}; "
        f"set_ics {init_s:.3f} s, its launches {init_counts}")
    say("slab", f"per-step seconds, ring of one: "
        + ", ".join(f"{x:.3f}" for x in ring_s) + "; one device: "
        + ", ".join(f"{x:.3f}" for x in one_s)
        + f"; phase 5: {', '.join(f'{x:.3f}' for x in STEP_SECONDS.get('main', []))}"
        + f" ({card})")
    say("slab", f"launches over {steps} sync points ({n_pm} PM steps): "
        f"{_nonzero(counts)}; ti_current {int(st.ti_current)}, overflow "
        f"{int(st.overflow_flags)}")
    check_launches("slab", counts, SLAB_FORCE + GATHER, "the slab steps")
    if counts["pm_gather"] != n_pm:
        raise AssertionError(f"slab: kernel L launched {counts['pm_gather']}"
                             f" times over {n_pm} slab PM passes")
    for name in SLAB_FORCE:
        results.setdefault(name, {})["launches"] = counts[name]
    cst = ring.canonical_state()
    check_finite("slab", cst)
    check_kernels(recorded, f"slab 2x{n_side}^3", results, SLAB_FORCE,
                  timed=True, every=SLAB_EVERY, n_cases=1)
    say_against_earlier("kernels", results, "shortrange_gravity_slab", card)
    rcut = ring._spmd_step.rcut
    hold_slab("slab", "ring of one against one device after the first sync "
              "point", firsts[1], firsts[0], box, spacing, rcut)
    hold_slab("slab", f"ring of one against one device after {steps} sync "
              "points", _by_pid(cst), want, box, spacing, rcut)
    del cst, want, firsts

    say("kernels", "registers: A's slab mode, C's and D's anisotropic mode "
        + str([n for name in ("shortrange_gravity_slab", "sph_density_aniso")
               for _, n in ptxas_registers(PTXAS_NAME[name])]
              + [n for _, n in ptxas_registers("sph_hydro_kernelILb0ELb1E")]))
    args = recorded["pm_gather"]
    check_gather_equal("slab", "L on the slab PM's all-gathered mesh "
                       f"{tuple(args[0].shape)}", pm.cic_gather_vec(*args),
                       pm.cic_gather_vec_plain(*args))
    l_ms, _ = time_ms(lambda: pm.cic_gather_vec(*args), reps=20)
    say("slab", f"L on the slab PM: {l_ms:.3f} ms, {counts['pm_gather']} "
        f"launches ({card})")
    del recorded, rec, args
    kernels.recorded.clear()

    # a sync point by parts, and one slab PM pass by parts
    step = ring._spmd_step
    step.times = {}
    ring.step()
    sync(device)
    parts, step.times = step.times, None
    say("slab", "a sync point by parts (ms): " + ", ".join(
        f"{k} {1e3 * v:.3f}" for k, v in parts.items()) + f" ({card})")
    p = ring.state.p
    with phase_timer(device, SLAB_PM_TIMED) as totals, \
            ring_timer(ring.mesh, device) as coll:
        sync(device)
        t0 = time.perf_counter()
        pm_local_forces(ring.mesh, p.pos, p.mass, p.alive, box, opts.pmgrid)
        sync(device)
        pm_s = time.perf_counter() - t0
    say("slab", f"a slab PM pass {1e3 * pm_s:.3f} ms: " + ", ".join(
        f"{label} {1e3 * totals[label][0]:.3f}"
        for _, _, label in SLAB_PM_TIMED) + ", " + ", ".join(
        f"{k} {1e3 * v:.3f}" for k, v in coll.items()) + f" ({card})")
    del ring, st, p
    gc.collect()
    torch.cuda.empty_cache()
    phase_slab_cli(card, device, n_side)


def phase_slab_cli(card: str, device="cuda", n_side=N_SIDE_MAIN) -> None:
    """Phase 18's command line: the 2x128^3 run for SLAB_CLI_STEPS sync
    points with ``--devices 1`` and without, in child processes, held to
    each other (energy.txt and the last snapshot); ``--devices 2`` on a
    machine with fewer cards stops, counting them."""
    import numpy as np
    import torch

    from gadget_leicester_tpu_torch.io.snapshot import read_snapshot
    root = Path(__file__).resolve().parent
    work = root / "build" / "slab_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        n = write_ics(str(work / "ics.dat"), n_side)
        runs = {}
        for label, extra in (("one device", ()), ("--devices 1",
                                                  ("--devices", 1))):
            out = out_dir = work / f"out{len(runs)}"
            param = work / f"run{len(runs)}.param"
            param.write_text(run_param_text(n_side, str(work / "ics.dat"),
                                            str(out), SLAB_CLI_CADENCE))
            _, wall = _cli(root, param, 0, "--max-steps", SLAB_CLI_STEPS,
                           "--device", device, *extra, phase="slab")
            rows = np.loadtxt(out / "energy.txt", ndmin=2)
            snaps = sorted(out.glob("snapshot_*"))
            snap = read_snapshot(str(snaps[-1]))
            order = np.argsort(snap.ids)
            runs[label] = (rows, snap, order, len(snaps))
            say("slab", f"CLI {label}: {wall:.1f} s, {len(rows)} energy rows,"
                f" {len(snaps)} snapshots, {int(snap.header.npart.sum())} "
                "particles")
        (r1, s1, o1, k1), (r2, s2, o2, k2) = runs.values()
        if r1.shape != r2.shape or k1 != k2 or \
                int(s2.header.npart.sum()) != n:
            raise AssertionError("slab CLI: the two runs wrote different "
                                 "outputs")
        e_err = float(np.abs(r2 - r1).max() / np.abs(r1).max())
        say("slab", f"CLI energy.txt, --devices 1 against one device: "
            f"{e_err:.2e} of the largest value (bound {SLAB_BOUND:g})")
        if not e_err < SLAB_BOUND:
            raise AssertionError("slab CLI: energy.txt beyond the bound")
        hold_slab("slab", "CLI last snapshot, --devices 1 against one "
                  "device", {"pid": s2.ids[o2], "pos": s2.pos[o2],
                             "vel": s2.vel[o2]},
                  {"pid": s1.ids[o1], "pos": s1.pos[o1], "vel": s1.vel[o1]},
                  float(s1.header.box_size), float(s1.header.box_size)
                  / n_side)
        for line in (out_dir / "info.txt").read_text().splitlines():
            if "slab lists" in line or "overflow" in line:
                say("slab", f"CLI --devices 1 info.txt: {line.strip()}")
        if device == "cuda" and torch.cuda.device_count() < 2:
            import os
            env = dict(os.environ, PYTHONPATH=str(root))
            proc = subprocess.run(
                [sys.executable, "-m", "gadget_leicester_tpu_torch",
                 str(work / "run0.param"), "--devices", "2"], cwd=root,
                env=env, capture_output=True, text=True, timeout=300)
            msg = proc.stderr.strip().splitlines()[-1:] or [""]
            say("slab", f"--devices 2 on {torch.cuda.device_count()} card: "
                f"exit {proc.returncode}, {msg[0]!r}")
            if proc.returncode == 0 or \
                    f"{torch.cuda.device_count()} visible" not in proc.stderr:
                raise AssertionError("slab CLI: --devices 2 did not stop "
                                     "counting the cards")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# phase 19: the slab step's fork physics and vacuum geometry on a ring of
# one (parallel/): (a) phase 14's configuration with sinks through
# Simulation(mesh=1) for SLAB_SINK_STEPS sync points, held by pid to the
# single-device run of the same ICs (hold_slab), the registry, the
# conservation across the sinks and the in-step potential (SINK_INSTEP_TOL
# of max |pot|, on the particles active at the first sync point, all of
# them); (b) A's slab mode with the potential on (a)'s arguments; (c) the
# lcdm ICs in vacuum (PeriodicBoundariesOn 0, comoving) for
# SLAB_VACUUM_STEPS sync points, the first sync point's gravity against the
# dense split of the same TreePM on SLAB_VACUUM_TARGETS seeded targets
# (SLAB_VACUUM_TOL of the largest value, test_spmd_vacuum.py's bound), A's,
# C's and D's vacuum modes; (d) Stamatellos cooling with the sinks, one
# sync point on (a)'s states; (e) a sync point of each by parts
SLAB_SINK_STEPS = 8
# phase 19 holds A's slab mode with the potential to its float64 plain
# version on every SLAB_EVERY-th tile and the vacuum modes on every 31st,
# each with every tile on, as phase 18 holds its modes (every other tile
# gated off is the same kernel code, which tests/test_torch_cuda.py runs):
# the plain versions' timings at full width take some 140 s of the phase,
# and the whole script keeps to the run's time limit. The stride is prime:
# a multiple of the grid's cells along z keeps every compared cell at one z
# index, in vacuum perhaps the empty face z = 0 (at every 32nd, A's vacuum
# mode compared only empty cells, and its error read 0)
SLAB_FORK_EVERY = 31
SLAB_VACUUM_STEPS = 4
SLAB_VACUUM_TARGETS = 4096
SLAB_VACUUM_TOL = 2e-3
SLAB_VACUUM_SEED = 19
SLAB_POT_PATH = SLAB_POT + SLAB_FORCE[1:] + GATHER


@contextlib.contextmanager
def ring_fork_bookkeeping(step):
    """Within the body, each call of the slab step's ``sinks`` appends the
    alive mass and momentum of the ring before and after it (a ring of
    one: the rank's), as :func:`fork_bookkeeping` does for one device."""
    import torch
    real = step.sinks
    log = []

    def totals(state):
        p = state.p
        m = torch.where(p.alive, p.mass, torch.zeros_like(p.mass)).double()
        mv = m[:, None] * p.vel.double()
        return torch.cat([m.sum()[None], mv.sum(0), mv.abs().sum()[None]])

    def spy(state):
        before = totals(state)
        state = real(state)
        log.append((before, totals(state)))
        return state

    step.sinks = spy
    try:
        yield log
    finally:
        del step.sinks


def registry_by_slot(state) -> list:
    """[(slot, pid of its sink, acc_mass, n_accreted)] of the used slots of
    a canonical state."""
    import numpy as np
    slot = state.sinks.slot.cpu().numpy()
    pid = state.p.pid.cpu().numpy()
    return [(int(k), int(pid[slot[k]]), float(state.sinks.acc_mass[k]),
             int(state.sinks.n_accreted[k]))
            for k in np.flatnonzero(slot >= 0)]


def vacuum_dense_split(st, cfg, domain, pmgrid: int, targets,
                       block: int = 8):
    """The vacuum TreePM of a state by one device, densely, at the alive
    particles ``targets``: the free-space mesh over ``domain``
    (``ops/pm.py :: pm_forces_nonperiodic``) plus the erfc-truncated
    softened pair sum of every source within rcut, in float64, plus the
    comoving background term; times G (test_spmd_vacuum.py's oracle)."""
    import math

    import torch

    from gadget_leicester_tpu_torch.models.forces import (comoving_factors,
                                                          softening_table)
    from gadget_leicester_tpu_torch.ops.gravity_direct import \
        shortrange_trunc
    from gadget_leicester_tpu_torch.ops.pm import (ASMTH, RCUT,
                                                   pm_forces_nonperiodic)
    from gadget_leicester_tpu_torch.ops.softening import SOFTFAC, grav_fac
    p = st.p
    origin, extent = domain[:2]
    asmth = ASMTH * float(extent) / pmgrid
    rcut = RCUT * asmth
    acc_pm = pm_forces_nonperiodic(p.pos, p.mass, p.alive,
                                   torch.as_tensor(origin, device=p.pos.device),
                                   float(extent), pmgrid)[targets].double()
    fac = comoving_factors(cfg, st.ti_current)
    soft = (SOFTFAC * softening_table(cfg, fac.atime)[p.ptype.long()]).double()
    src = torch.nonzero(p.alive).flatten()
    spos, smass, ssoft = p.pos[src].double(), p.mass[src].double(), soft[src]
    out = []
    for b0 in range(0, targets.numel(), block):
        t = targets[b0:b0 + block]
        dx = p.pos[t].double()[:, None, :] - spos[None, :, :]
        r = torch.sqrt((dx * dx).sum(-1))
        h = torch.maximum(soft[t][:, None], ssoft[None, :])
        f = grav_fac(r, h) * shortrange_trunc(r, asmth)
        f = torch.where((r < rcut) & (r > 0), f, torch.zeros_like(f))
        out.append(-(f[:, :, None] * dx * smass[None, :, None]).sum(1))
    acc = (torch.cat(out) + acc_pm) * cfg.grav_internal
    if cfg.comoving_integration_on:
        acc = acc + 0.5 * cfg.omega0 * cfg.hubble_internal ** 2 \
            * p.pos[targets].double()
    return acc


def step_through_overflow(sim, phase: str) -> int:
    """One sync point of ``sim``; where it sets an overflow bit, the
    capacities raised as the run loop raises them
    (``Simulation._bump_capacities``: ``raised_capacities`` on one
    device, ``raised_slab_capacities`` and a new decomposition on a ring,
    which also refits a vacuum domain after bit 4) and the sync point
    taken again from the state before it. Returns the number of raises."""
    import dataclasses

    import torch

    from gadget_leicester_tpu_torch.models.grids import make_grid_cache
    from gadget_leicester_tpu_torch.models.simulation import (
        MAX_INIT_BUMPS, raised_capacities)
    from gadget_leicester_tpu_torch.parallel.spmd import \
        raised_slab_capacities
    before = sim.state
    for n in range(MAX_INIT_BUMPS):
        sim.step()
        ovf = int(sim.state.overflow_flags)
        if not ovf:
            return n
        clear = dataclasses.replace(before, overflow_flags=torch.zeros_like(
            before.overflow_flags))
        sim.step_count -= 1
        if sim.mesh is None:
            sim.opts = raised_capacities(sim.opts, ovf, before.n_gas_max)
            sim.state = dataclasses.replace(
                clear, grids=make_grid_cache(sim.device))
        else:
            sim.opts = raised_slab_capacities(
                sim.opts, ovf, sim._spmd_step.geometry(before))
            sim.state = clear
            sim._decompose()
        where = "on one device" if sim.mesh is None else "on the ring"
        say(phase, f"overflow {ovf} {where} at step {sim.step_count + 1}: "
            f"capacities raised (sr {sim.opts.sr_capacity}, sph "
            f"{sim.opts.sph_capacity}, ghost {sim.opts.spmd_ghost_frac})"
            + (f", domain refitted to {sim.spmd_domain[1]:.6g}"
               if sim.spmd_domain is not None else "")
            + ", the sync point taken again")
    sim.step()
    return MAX_INIT_BUMPS


def phase_slab_fork(results: dict, card: str, device="cuda",
                    n_side=N_SIDE_MAIN) -> None:
    """Phase 19 (see the module docstring): sinks, the in-step potential,
    Stamatellos cooling and vacuum TreePM on a ring of one at full
    width."""
    import dataclasses

    import numpy as np
    import torch

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.core.config import parse_parameter_text
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    from gadget_leicester_tpu_torch.ops import cells
    from gadget_leicester_tpu_torch.parallel.launch import _by_pid

    # (a) sinks on slabs, against one device
    cfg, opts, (pos, vel, mass, ptype, u) = setup(
        n_side, param_extra=sink_param_lines(n_side), sinks=True)
    box, spacing = float(cfg.box_size), float(cfg.box_size) / n_side
    one = Simulation(cfg, opts, device)
    one.set_ics(pos, vel, mass, ptype, u=u)
    ng = one.state.n_gas_max
    gas = one.state.p.alive[:ng] & (one.state.p.ptype[:ng] == 0)
    thr = float(np.percentile(one.state.gas.density[gas].cpu().numpy(),
                              SINK_DENSITY_PERCENTILE))
    one.cfg = cfg = cfg.replace(sink_formation_density=thr)
    firsts, formed = [], {"one": [], "ring": []}
    for i in range(SLAB_SINK_STEPS):
        one.step()
        if i == 0:
            firsts.append(_by_pid(one.state))
            first_one = one.state
        formed["one"].append(int((one.state.sinks.slot >= 0).sum()))
    sync(device)
    want = _by_pid(one.state)
    want_reg = registry_by_slot(one.state)
    ring = Simulation(cfg, opts, device, mesh=1)
    ring.set_ics(pos, vel, mass, ptype, u=u)
    step = ring._spmd_step
    ring_s = []
    with recorded_inputs() as rec, ring_fork_bookkeeping(step) as book:
        kernels.reset_launches()
        for i in range(SLAB_SINK_STEPS):
            t0 = time.time()
            ring.step()
            sync(device)
            ring_s.append(time.time() - t0)
            if i == 0:
                first_ring = ring.canonical_state()
                firsts.append(_by_pid(first_ring))
            formed["ring"].append(int((ring.state.sinks.slot >= 0).sum()))
        counts = dict(kernels.launches)
    recorded = dict(rec)
    cst = ring.canonical_state()
    got_reg = registry_by_slot(cst)
    say("slab fork", f"2x{n_side}^3 with sinks on a ring of one (NCCL): "
        f"SinkFormationDensity {thr:.6g}, per-step seconds "
        + ", ".join(f"{x:.3f}" for x in ring_s) + f" ({card}); used slots "
        f"after each sync point: ring {formed['ring']}, one device "
        f"{formed['one']}; launches {_nonzero(counts)}")
    check_launches("slab fork", counts, SLAB_POT_PATH, "the slab steps with "
                   "sinks (A's slab mode with the potential, not without)")
    results.setdefault("shortrange_gravity_slab_pot", {})["launches"] = \
        counts["shortrange_gravity_slab_pot"]
    check_finite("slab fork", cst)
    check_fork_bookkeeping("slab fork", book)
    say("slab fork", f"registry (slot, pid, acc_mass, n_accreted): ring "
        f"{got_reg}; one device {want_reg}")
    if [r[1] for r in got_reg] != [r[1] for r in want_reg]:
        dens = {}
        for label, res in (("ring", _by_pid(cst)), ("one device", want)):
            by = dict(zip(res["gas.pid"], res["gas.density"]))
            dens[label] = {q: float(by.get(q, float("nan")))
                           for q in {r[1] for r in got_reg + want_reg}}
        say("slab fork", f"FINDING: the sinks formed on other particles; "
            f"the candidates' densities {dens}")
        raise AssertionError("slab fork: sinks formed on other particles in "
                             "the two runs")
    for (_, q, m1, n1), (_, _, m2, n2) in zip(got_reg, want_reg):
        if n1 != n2 or abs(m1 - m2) > SINK_MASS_TOL * max(abs(m2), 1e-30):
            raise AssertionError(f"slab fork: sink {q} tallies ({m1}, {n1}) "
                                 f"against ({m2}, {n2})")
    if formed["ring"][-1] < 1:
        raise AssertionError("slab fork: no sink formed at 2x128^3")
    rcut = step.rcut
    hold_slab("slab fork", "sinks, ring of one against one device after "
              "the first sync point", firsts[1], firsts[0], box, spacing,
              rcut)
    hold_slab("slab fork", f"sinks, ring of one against one device after "
              f"{SLAB_SINK_STEPS} sync points", _by_pid(cst), want, box,
              spacing, rcut)
    # the in-step potential after the first sync point (every particle
    # active) against the full potential with its mesh piece in float64, as
    # phase 14 holds it: one device's mesh piece (kernel B's deposit) and
    # the slab's (the point deposit) are two float32 meshes, ~1e-4 of max
    # |pot| from the float64 one each, and apart by about twice that
    from gadget_leicester_tpu_torch.ops.pm import pm_potential_periodic

    def pid_order(st):
        rows = torch.nonzero(st.p.alive).flatten()
        return rows[torch.argsort(st.p.pid[rows])]
    o1, o2 = pid_order(first_one), pid_order(first_ring)
    if not torch.equal(first_one.p.pid[o1], first_ring.p.pid[o2]):
        raise AssertionError("slab fork: the particles differ after the "
                             "first sync point")
    p1, p2 = first_one.p, first_ring.p
    pm64 = pm_potential_periodic(p1.pos.double(), p1.mass.double(),
                                 p1.alive, box, opts.pmgrid) \
        * cfg.grav_internal
    exact = (p1.pot.double() - p1.pot_pm.double() + pm64)[o1]
    scale = float(exact.abs().max())
    err = float((p2.pot[o2].double() - exact).abs().max()) / scale
    err_one = float((p1.pot[o1].double() - exact).abs().max()) / scale
    err_pair = float((p2.pot[o2] - p1.pot[o1]).abs().max()) / scale
    err_sr = float(((p2.pot - p2.pot_pm)[o2] - (p1.pot - p1.pot_pm)[o1])
                   .abs().max()) / scale
    say("slab fork", f"the in-step potential after the first sync point "
        f"(every particle active) against the full potential with its mesh "
        f"piece in float64: ring {err:.2e} of max |pot| {scale:.6g} (bound "
        f"{SINK_INSTEP_TOL:g}), one device {err_one:.2e}; ring against one "
        f"device {err_pair:.2e}, their short-range and self parts "
        f"{err_sr:.2e}")
    if not err <= SINK_INSTEP_TOL:
        raise AssertionError("slab fork: the in-step potential differs")
    del firsts, first_one, first_ring, p1, p2, pm64, exact, o1, o2

    # (b) A's slab mode with the potential on (a)'s arguments
    check_kernels(recorded, f"slab 2x{n_side}^3 with sinks", results,
                  SLAB_POT, timed=True, every=SLAB_EVERY, n_cases=1)
    say_against_earlier("kernels", results, "shortrange_gravity_slab_pot",
                        card)
    args = recorded["shortrange_gravity_slab_pot"]
    pot4 = cells.shortrange_gravity_slab(*args, with_potential=True)
    force = cells.shortrange_gravity_slab(*args)
    same = bool(torch.equal(pot4[:, :3], force))
    f_ms, _ = time_ms(lambda: cells.shortrange_gravity_slab(*args), reps=5)
    r = results["shortrange_gravity_slab_pot"]
    say("kernels", f"shortrange_gravity_slab_pot: rows 0-2 equal to the "
        f"force-only mode's bit for bit: {same}; {r['ms']:.3f} ms beside "
        f"the force-only mode's {f_ms:.3f} ms on the same arguments; "
        f"registers {ptxas_registers(PTXAS_NAME['shortrange_gravity_slab_pot'])}"
        f" ({card})")
    if not same:
        raise AssertionError("A's slab mode with the potential: rows 0-2 "
                             "differ from the force-only mode's")
    del recorded, rec, args, pot4, force
    kernels.recorded.clear()

    # (d) Stamatellos cooling with the sinks. The cooling term alone on
    # (a)'s ring state: the slab step's (the point-mass term over the
    # ring's sinks, gathered by PID) against the single-device function on
    # the same state gathered (rows in its registry), within COOLING_TOL of
    # the largest; then one sync point of each run, held by pid
    # (hold_slab), a capacity raise answered as the run loop answers it
    from gadget_leicester_tpu_torch.models.cooling import apply_cooling
    cool = dataclasses.replace(opts, cooling="stamatellos")
    local = ring.state
    step.opts = cool
    ring_dcool = step.cool(local).gas.dt_entropy - local.gas.dt_entropy
    cst = ring.canonical_state()
    one_dcool = apply_cooling(cst, cfg, cool).gas.dt_entropy \
        - cst.gas.dt_entropy
    gmask = cst.p.alive[:cst.n_gas_max] & (cst.p.ptype[:cst.n_gas_max] == 0)
    cool_err = float((ring_dcool - one_dcool)[gmask].abs().max()
                     / one_dcool[gmask].abs().max())
    say("slab fork", f"the Stamatellos term on the ring ({int(gmask.sum())} "
        f"gas, {formed['ring'][-1]} sinks) against the single-device "
        f"function on the same state: {cool_err:.2e} of the largest |dA/dt| "
        f"(bound {COOLING_TOL:g})")
    cooling_ok = cool_err <= COOLING_TOL
    one.opts = dataclasses.replace(one.opts, cooling="stamatellos")
    ring.opts = step.opts = dataclasses.replace(ring.opts,
                                                cooling="stamatellos")
    step_through_overflow(one, "slab fork")
    step_through_overflow(ring, "slab fork")
    step = ring._spmd_step
    sync(device)
    w, g = _by_pid(one.state), _by_pid(ring.canonical_state())
    hold_slab("slab fork", "Stamatellos with sinks, ring of one against one "
              "device after one more sync point", g, w, box, spacing, rcut)
    ti = int(one.state.ti_current)
    # the gas both runs kicked at this sync point (cooling adds to the
    # dt_entropy of every gas particle, the hydro term only to the active)
    act = np.isin(w["gas.pid"], np.intersect1d(
        w["pid"][w["ti_begstep"] == ti], g["pid"][g["ti_begstep"] == ti])) \
        & np.isin(w["gas.pid"], g["gas.pid"])
    gi = np.searchsorted(g["gas.pid"], w["gas.pid"][act])
    err = float(np.abs(g["gas.dt_entropy"][gi] - w["gas.dt_entropy"][act])
                .max() / np.abs(w["gas.dt_entropy"][act]).max())
    say("slab fork", f"Stamatellos with sinks, one sync point, ring against "
        f"one device on the {int(act.sum())} gas active in both: dt_entropy "
        f"{err:.2e} of the largest (the two mesh potentials, from two "
        "float32 deposits, differ by ~3e-4 of max |pot|, and the rate "
        "scales as 1/|psi| where |psi| is smallest)")
    check_finite("slab fork", ring.canonical_state())
    check_finite("slab fork", one.state)
    del local, ring_dcool, one_dcool, gmask

    # (e) a sync point with sinks by parts
    step.times = {}
    ring.step()
    sync(device)
    parts, step.times = step.times, None
    say("slab fork", "a slab sync point with sinks and Stamatellos by parts "
        "(ms): " + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in parts.items())
        + f" ({card})")
    del one, ring, step, cst, want, w, g
    gc.collect()
    torch.cuda.empty_cache()

    # (c) vacuum TreePM on slabs: the lcdm ICs, PeriodicBoundariesOn 0
    vcfg = parse_parameter_text(param_text(n_side).replace(
        "PeriodicBoundariesOn 1", "PeriodicBoundariesOn 0"))
    vopts = dataclasses.replace(opts, periodic=False, sinks=False,
                                cooling="none")
    vac = Simulation(vcfg, vopts, device, mesh=1)
    t0 = time.time()
    vac.set_ics(pos, vel, mass, ptype, u=u)
    sync(device)
    init_s = time.time() - t0
    vac_s, raises = [], 0
    with recorded_inputs() as rec:
        kernels.reset_launches()
        for i in range(SLAB_VACUUM_STEPS):
            t0 = time.time()
            raises += step_through_overflow(vac, "slab vacuum")
            sync(device)
            vac_s.append(time.time() - t0)
            if i == 0:
                first = vac.canonical_state()
                dom = vac.spmd_domain
        counts = dict(kernels.launches)
    step = vac._spmd_step
    recorded = {n + VACUUM: a for n, a in rec.items()}
    say("slab vacuum", f"2x{n_side}^3 lcdm ICs in vacuum (comoving) on a "
        f"ring of one: domain origin {np.asarray(dom[0]).tolist()}, extent "
        f"{dom[1]:.6g}, occupied share {dom[2]:.3f}, pmgrid "
        f"{vac.opts.pmgrid}; set_ics {init_s:.3f} s, "
        "per-step seconds " + ", ".join(f"{x:.3f}" for x in vac_s)
        + f" ({card}); capacity raises {raises}; launches "
        f"{_nonzero(counts)}")
    check_launches("slab vacuum", counts, SLAB_FORCE + GATHER,
                   "the vacuum slab steps")
    for n in SLAB_FORCE:
        results.setdefault(n + VACUUM, {})["launches"] = counts[n]
    check_finite("slab vacuum", vac.canonical_state())
    gen = torch.Generator(device="cpu").manual_seed(SLAB_VACUUM_SEED)
    alive_rows = torch.nonzero(first.p.alive).flatten().cpu()
    pick = alive_rows[torch.randperm(alive_rows.numel(), generator=gen)[
        :SLAB_VACUUM_TARGETS]].to(first.p.pos.device)
    t0 = time.time()
    oracle = vacuum_dense_split(first, vcfg, dom, vac.opts.pmgrid, pick)
    got = (first.p.acc + first.p.acc_pm)[pick].double()
    err = float((got - oracle).abs().max() / oracle.abs().max())
    say("slab vacuum", f"first sync point's gravity against the dense split "
        f"on {pick.numel()} seeded targets: {err:.2e} of the largest value "
        f"(bound {SLAB_VACUUM_TOL:g}; the oracle took "
        f"{time.time() - t0:.1f} s)")
    if not err < SLAB_VACUUM_TOL:
        raise AssertionError("slab vacuum: gravity differs from the dense "
                             "split")
    del first, oracle, got
    check_kernels(recorded, f"vacuum slab 2x{n_side}^3", results,
                  SLAB_VACUUM, timed=True, every=SLAB_FORK_EVERY, n_cases=1)
    # A's slab mode with the potential in vacuum, on no path: held and
    # timed on the force-only mode's arguments, its rows 0-2 equal to that
    # mode's bit for bit
    (pot_v,) = SLAB_POT_VACUUM
    recorded[pot_v] = recorded["shortrange_gravity_slab" + VACUUM]
    check_kernels(recorded, f"vacuum slab 2x{n_side}^3", results,
                  SLAB_POT_VACUUM, timed=True, every=SLAB_FORK_EVERY,
                  n_cases=1)
    results[pot_v]["launches"] = 0
    for n in ("shortrange_gravity_slab" + VACUUM, pot_v):
        say_against_earlier("kernels", results, n, card)
    args = cases(pot_v, recorded)[0][1]
    same = bool(torch.equal(
        cells.shortrange_gravity_slab(*args, with_potential=True)[:, :3],
        cells.shortrange_gravity_slab(*args)))
    say("kernels", f"{pot_v}: rows 0-2 equal to the force-only mode's bit "
        f"for bit: {same}; {results[pot_v]['ms']:.3f} ms beside the "
        f"force-only mode's {results['shortrange_gravity_slab' + VACUUM]['ms']:.3f}"
        f" ms on the same arguments ({card})")
    if not same:
        raise AssertionError("A's slab mode with the potential in vacuum: "
                             "rows 0-2 differ from the force-only mode's")
    say("kernels", "registers: A's slab mode in vacuum, with the potential "
        "in vacuum, the ranking launch " + str(
            [ptxas_registers(PTXAS_NAME[n]) for n in (
                "shortrange_gravity_slab_vacuum",
                "shortrange_gravity_slab_pot_vacuum", "slab_rank")]))
    del recorded, rec
    kernels.recorded.clear()
    step.times = {}
    vac.step()
    sync(device)
    parts, step.times = step.times, None
    say("slab vacuum", "a vacuum slab sync point by parts (ms): " + ", ".join(
        f"{k} {1e3 * v:.3f}" for k, v in parts.items()) + f" ({card})")
    del vac, step
    gc.collect()
    torch.cuda.empty_cache()
    if not cooling_ok:
        raise AssertionError("slab fork: Stamatellos cooling on the ring "
                             "differs from one device")


# phase 20: the slab step's coarse-cell SPH. The comparisons switch on
# every SLAB_CELLS_EVERY-th target cell (the float64 plain version of all
# of them would take minutes; 59 shares no factor with the grids' sides,
# so the cells it keeps wander through z); the force test's subset at phase 9's
# statistics cadence (CLI_CADENCE) on the small box: the reference's force
# test is a host sum (the Ewald lattice sum of 343 images and 342 waves a
# pair in a periodic box), which at 2x128^3 would take hours
SLAB_CELLS_STEPS = 3
SLAB_CELLS_EVERY = 59
FORCETEST_TARGETS = 16
# the TreePM force (short-range plus PM) against the exact periodic sum
# after the first sync point of the small box (pmgrid 32): in a box this
# close to uniform the net force is a small remainder of its pair terms,
# and the port's run on the CPU gave a median of 2.4e-2 and a largest of
# 0.28 on a subset of 32 (utils/forcetest.py); a force missing its PM part
# gave a median of 0.31 and a largest of 2.7
FORCETEST_MEDIAN = 5e-2
FORCETEST_MAX = 1.0


def phase_forcetest(card: str, device="cuda", n_side=N_SIDE_SMALL) -> None:
    """Phase 20 (d): ``Simulation.run`` of the lcdm_gas box at ``n_side``
    with the force test on (``SimOptions.forcetest``: FORCETEST_TARGETS
    particles), phase 9's cadence lines, one sync point: the force test
    runs once, at the statistics time, and its forcetest.txt is held to
    the bounds above."""
    import numpy as np

    from gadget_leicester_tpu_torch.core.config import parse_parameter_text
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    _, opts, (pos, vel, mass, ptype, u) = setup(n_side)
    work = Path(__file__).resolve().parent / "build" / "forcetest"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        cfg = parse_parameter_text(run_param_text(n_side, "x", str(work),
                                                  CLI_CADENCE))
        opts = opts.replace(forcetest=(FORCETEST_TARGETS + 0.5) / len(pos))
        sim = Simulation(cfg, opts, device)
        sim.set_ics(pos, vel, mass, ptype, u=u)
        t0 = time.time()
        sim.run(max_steps=1)
        secs = time.time() - t0
        rows = np.loadtxt(work / "forcetest.txt", ndmin=2)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    err = rows[:, 9]
    say("forcetest", f"2x{n_side}^3 TreePM, one sync point through run() "
        f"with the force test at the statistics time: {rows.shape[0]} "
        f"particles, {rows.shape[1]} columns, relative error of the code's "
        f"force from the exact periodic sum median {np.median(err):.3e}, "
        f"largest {err.max():.3e} (bounds {FORCETEST_MEDIAN:g}, "
        f"{FORCETEST_MAX:g}); the run {secs:.1f} s ({card})")
    if rows.shape != (FORCETEST_TARGETS, 10) or not np.isfinite(rows).all():
        raise AssertionError("forcetest: forcetest.txt is malformed")
    if not (np.median(err) < FORCETEST_MEDIAN and err.max() < FORCETEST_MAX):
        raise AssertionError("forcetest: the force errors are beyond the "
                             "bounds")


def phase_slab_cells(results: dict, card: str, device="cuda",
                     n_side=N_SIDE_MAIN, steps=SLAB_CELLS_STEPS) -> None:
    """Phase 20 (see the module docstring): the slab step's coarse-cell
    SPH on a ring of one against one device, kernels I/J and K's
    ghost-row mode, periodic and in vacuum, and the force test."""
    import dataclasses

    import torch

    from gadget_leicester_tpu_torch import kernels
    from gadget_leicester_tpu_torch.core.config import parse_parameter_text
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    from gadget_leicester_tpu_torch.parallel.launch import _by_pid
    cfg, opts, (pos, vel, mass, ptype, u) = setup(n_side,
                                                  sph_backend="cells")
    box, spacing = float(cfg.box_size), float(cfg.box_size) / n_side
    firsts = []
    one = Simulation(cfg, opts, device)
    one.set_ics(pos, vel, mass, ptype, u=u)
    for i in range(steps):
        one.step()
        if i == 0:
            firsts.append(_by_pid(one.state))
    sync(device)
    want = _by_pid(one.state)
    del one
    gc.collect()
    torch.cuda.empty_cache()

    ring = Simulation(cfg, opts, device, mesh=1)
    t0 = time.time()
    ring.set_ics(pos, vel, mass, ptype, u=u)
    sync(device)
    init_s = time.time() - t0
    secs = []
    with recorded_inputs() as rec:
        kernels.reset_launches()
        for i in range(steps):
            t0 = time.time()
            ring.step()
            sync(device)
            secs.append(time.time() - t0)
            if i == 0:
                firsts.append(_by_pid(ring.canonical_state()))
        counts = dict(kernels.launches)
    recorded = dict(rec)
    step = ring._spmd_step
    geo = step.geometry(ring.state)
    say("slab cells", f"2x{n_side}^3 under sph_backend=\"cells\" on a ring "
        f"of one (NCCL): coarse cells {geo['nx_c']} x {geo['n_c']} x "
        f"{geo['n_c']} of edge {geo['cell_c']:.6g} (the h cap and the "
        f"ghosts' reach), {geo['cap_c']} slots a cell, ghost buffers "
        f"{geo['gcap_c']} a side; set_ics {init_s:.3f} s, per-step seconds "
        + ", ".join(f"{x:.3f}" for x in secs) + f" ({card}); launches over "
        f"{steps} sync points {_nonzero(counts)}")
    check_launches("slab cells", counts,
                   SLAB_CELLS + ("shortrange_gravity_slab", "pm_gather"),
                   "the slab steps under the coarse cells")
    for name in SLAB_CELLS:
        results.setdefault(name, {})["launches"] = counts[name]
    cst = ring.canonical_state()
    check_finite("slab cells", cst)
    check_kernels(recorded, f"slab cells 2x{n_side}^3", results, SLAB_CELLS,
                  timed=True, every=SLAB_CELLS_EVERY, n_cases=1)
    rcut = step.rcut
    hold_slab("slab cells", "coarse cells, ring of one against one device "
              "after the first sync point", firsts[1], firsts[0], box,
              spacing, rcut)
    hold_slab("slab cells", f"coarse cells, ring of one against one device "
              f"after {steps} sync points", _by_pid(cst), want, box, spacing,
              rcut)
    say("kernels", "registers: I/J's and K's ghost-row mode, periodic and in "
        "vacuum " + str([n for frag in (
            "sph_cells_density_kernelILi6E", "sph_cells_density_kernelILi0E",
            "sph_cells_hydro_kernelILi6ELb1E",
            "sph_cells_hydro_kernelILi0ELb1E")
            for _, n in ptxas_registers(frag)]))
    del cst, want, firsts, recorded, rec
    kernels.recorded.clear()
    step.times = {}
    ring.step()
    sync(device)
    parts, step.times = step.times, None
    say("slab cells", "a coarse-cell slab sync point by parts (ms): "
        + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in parts.items())
        + f" ({card})")
    del ring, step
    gc.collect()
    torch.cuda.empty_cache()

    # the vacuum mode: the same ICs with PeriodicBoundariesOn 0, one sync
    # point (a capacity raise answered as the run loop answers it)
    vcfg = parse_parameter_text(param_text(n_side).replace(
        "PeriodicBoundariesOn 1", "PeriodicBoundariesOn 0"))
    vac = Simulation(vcfg, dataclasses.replace(opts, periodic=False), device,
                     mesh=1)
    t0 = time.time()
    vac.set_ics(pos, vel, mass, ptype, u=u)
    sync(device)
    init_s = time.time() - t0
    with recorded_inputs() as rec:
        kernels.reset_launches()
        t0 = time.time()
        raises = step_through_overflow(vac, "slab cells vacuum")
        sync(device)
        vac_s = time.time() - t0
        counts = dict(kernels.launches)
    recorded = {n + VACUUM: a for n, a in rec.items()}
    geo = vac._spmd_step.geometry(vac.state)
    say("slab cells vacuum", f"2x{n_side}^3 in vacuum on a ring of one: "
        f"occupied share {vac.spmd_domain[2]:.3f}, coarse cells "
        f"{geo['nx_c']} x {geo['n_c']} x {geo['n_c']} of edge "
        f"{geo['cell_c']:.6g}, {geo['cap_c']} slots; set_ics {init_s:.3f} s, "
        f"the sync point {vac_s:.3f} s ({card}), capacity raises {raises}; "
        f"launches {_nonzero(counts)}")
    check_launches("slab cells vacuum", counts,
                   SLAB_CELLS + ("shortrange_gravity_slab", "pm_gather"),
                   "the vacuum slab sync point under the coarse cells")
    for name in SLAB_CELLS:
        results.setdefault(name + VACUUM, {})["launches"] = counts[name]
    check_finite("slab cells vacuum", vac.canonical_state())
    check_kernels(recorded, f"vacuum slab cells 2x{n_side}^3", results,
                  SLAB_CELLS_VACUUM, timed=True, every=SLAB_CELLS_EVERY,
                  n_cases=1)
    del vac, recorded, rec
    kernels.recorded.clear()
    gc.collect()
    torch.cuda.empty_cache()
    phase_forcetest(card, device)


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
    t_start = time.time()
    phase_kernels(results)
    phase_idle_small(results, phase_slice())
    grid, cap = SMALL_CELL_GRIDS[0]
    phase_slice(steps=1, potential=False, sph_backend="cells", sph_grid=grid,
                sph_capacity=cap)
    phase_slice(potential=False, sinks=True)
    phase_disc_small()
    sim, recorded, blocks_init, main_counts = phase_main(results, card)
    main_state = sim.state
    # B has no tile flags to thin: all of its arguments
    check_kernels(recorded, f"2x{N_SIDE_MAIN}^3", results,
                  tuple(n for n in DENSE if n != "pm_deposit"), timed=True,
                  every=FULL_EVERY)
    check_kernels(recorded, f"2x{N_SIDE_MAIN}^3", results, ("pm_deposit",),
                  timed=True)
    say_against_earlier("kernels", results, "sph_density", card)
    say_against_earlier("kernels", results, "pm_deposit", card)
    say("kernels", "registers: " + "; ".join(
        f"{what} {[n for _, n in ptxas_registers(fragment)]}"
        for what, fragment in (
            ("kernel D (relative, absolute mode)", "sph_hydro_kernel"),
            ("A", PTXAS_NAME["shortrange_gravity"]),
            ("H", PTXAS_NAME["shortrange_potential"]),
            ("I/J (vacuum, periodic grid)", PTXAS_NAME["sph_cells_density"]),
            ("K (vacuum, periodic grid)", PTXAS_NAME["sph_cells_hydro"]),
            ("F (absolute, relative mode)", "sph_density_entries_kernel"),
            ("G (absolute, relative mode)", "sph_hydro_entries_kernel"),
            ("the need words of F and G", "entries_need_kernel"),
            ("B", PTXAS_NAME["pm_deposit"]),
            ("the box kernels of C, D, F, G, I/J and K",
             "subcell_boxes_kernel"))))
    del recorded
    kernels.recorded.clear()
    phase_potential(results, main_state, card)
    kernels.recorded.clear()
    phase_profile(sim, card)
    del sim
    phase_idle_main(results, main_state, card)
    kernels.recorded.clear()
    phase_gather(results, main_state, main_counts, card)
    phase_gravity_cells(results, main_state, main_counts, card)
    kernels.recorded.clear()
    phase_vacuum_blocks(results, main_state, card)
    del main_state
    kernels.recorded.clear()
    gc.collect()
    torch.cuda.empty_cache()
    phase_cells(results, blocks_init, card)
    del blocks_init
    kernels.recorded.clear()
    gc.collect()
    torch.cuda.empty_cache()
    phase_cli(card)
    phase_gassphere(card)
    phase_tree(card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_sinks(results, card)
    kernels.recorded.clear()
    gc.collect()
    torch.cuda.empty_cache()
    phase_disc(results, card)
    say("time", f"phases 1-15 done at {time.time() - t_start:.0f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phase_zoom(card)
    say("time", f"phase 16 done at {time.time() - t_start:.0f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phase_switches(card)
    say("time", f"phase 17 done at {time.time() - t_start:.0f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phase_slab(results, card)
    say("time", f"phase 18 done at {time.time() - t_start:.0f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phase_slab_fork(results, card)
    say("time", f"phase 19 done at {time.time() - t_start:.0f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phase_slab_cells(results, card)
    say("time", f"phase 20 done at {time.time() - t_start:.0f} s")

    # no single PyTorch call computes an erfc-truncated softened pair sum,
    # an SPH kernel sum over a cell or block stencil or the CIC deposit of
    # a cell pack: library_ms is null, except for kernel L (grid_sample)
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": results[name]["launches"],
             "max_abs_err": results[name]["max_abs_err"],
             "ms": results[name]["ms"],
             "plain_ms": results[name]["plain_ms"],
             "bound_ms": results[name]["bound_ms"],
             "bound_by": results[name]["bound_by"],
             "library_ms": results[name].get("library_ms")}
            for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
