"""The Zel'dovich pancake through the port on the CPU, after
tests/test_zeldovich.py::test_zeldovich_growth: a plane wave in an
Einstein-de Sitter box, 16^3 particles, TreePM with pmgrid 32, from a =
0.05 to 0.2 (before shell crossing at 0.5) through ``Simulation.run_until``;
the displacements held to the analytic growing mode D(a) = a by the
reference's bounds. Any error in the comoving drift and kick factors, the
PM and short-range split or the velocity convention shows as a wrong
growth rate. The ICs, parameters and errors are chip_smoke.py's, whose
phase 17 runs the same on the card.

Marked slow, as the reference's test is: on the CPU the run takes 129
sync points at 2.4-3.3 s each in kernel A's plain version (its 4^3 cells
of 128 slots hold 64 particles each), 361-407 s in all on two threads."""

import numpy as np
import pytest
import torch

import chip_smoke
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.models.simulation import Simulation


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.slow
def test_zeldovich_growth():
    """The rms displacement error below 5% and the largest below 15% of
    the amplitude, the transverse displacements below 2% of it; no
    overflow."""
    cfg = parse_parameter_text(chip_smoke.zeldovich_param_text())
    opts = SimOptions(periodic=True, pmgrid=2 * chip_smoke.ZEL_N_SIDE,
                      gravity_mode="treepm")
    q, pos, vel, mass, psi = chip_smoke.pancake_ics(cfg)
    sim = Simulation(cfg, opts, "cpu")
    sim.set_ics(pos, vel, mass, np.ones(len(pos), np.int32))
    sim.run_until(chip_smoke.ZEL_A_F, max_steps=500)
    assert sim.time >= chip_smoke.ZEL_A_F * 0.999
    assert int(sim.state.overflow_flags) == 0
    errs = chip_smoke.zeldovich_errors(sim, q, psi)
    assert errs["rms"] < 0.05
    assert errs["max"] < 0.15
    assert errs["transverse"] < 0.02
    assert chip_smoke.ZEL_BOUNDS == {"rms": 0.05, "max": 0.15,
                                     "transverse": 0.02}
