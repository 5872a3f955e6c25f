"""The port's command line as a user runs it, in a child process where jax
cannot be imported: ``python -m gadget_leicester_tpu_torch param.txt
[0|1] --device cpu`` on an lcdm_gas 2x17^3 IC file (5,120 gas slots, so
sph_backend "auto" resolves to blocks with no flag), then a resume from
its restart dump; without ``--device`` it asks for the card and stops
here; ``--devices 2`` runs the slab step on two gloo processes and
matches the single-device run's energy.txt; so does the gassphere, a
vacuum run, on two ranks (``slow``); a run the slab step does not take
stops with its ROADMAP item (``--makeglass`` runs:
tests/test_torch_glass.py)."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parent.parent
N_SIDE = 17
# the CLI run with jax made unimportable (the card's machine has none)
CODE = ("import runpy, sys; sys.modules['jax'] = None; "
        "sys.modules['jaxlib'] = None; "
        "sys.argv = ['gadget_leicester_tpu_torch'] + sys.argv[1:]; "
        "runpy.run_module('gadget_leicester_tpu_torch', run_name='__main__', "
        "alter_sys=True)")
# statistics at the first sync point only, a restart dump after every one
CADENCE = """
TimeBetStatistics 1.0
TimeOfFirstSnapshot 2.0
TimeBetSnapshot 2.0
CpuTimeBetRestartFile 0.0
"""


def cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", CODE, *map(str, args)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    ics, out = tmp / "ics.dat", tmp / "out"
    n = chip_smoke.write_ics(str(ics), N_SIDE)
    param = tmp / "run.param"
    param.write_text(chip_smoke.run_param_text(N_SIDE, str(ics), str(out),
                                               CADENCE))
    first = cli(param, 0, "--device", "cpu", "--max-steps", 1)
    rows_first = np.loadtxt(out / "energy.txt", ndmin=2) \
        if (out / "energy.txt").exists() else None
    resumed = cli(param, 1, "--device", "cpu", "--max-steps", 1)
    # the same run on a ring of two gloo ranks, into its own OutputDir
    out2 = tmp / "out_ring"
    param2 = tmp / "ring.param"
    param2.write_text(chip_smoke.run_param_text(N_SIDE, str(ics), str(out2),
                                                CADENCE))
    # two processes of one thread each, slower than the runs above on a
    # loaded machine: a longer limit
    ring = cli(param2, 0, "--device", "cpu", "--devices", 2, "--max-steps",
               1, timeout=600)
    return dict(n=n, param=param, out=out, first=first,
                rows_first=rows_first, resumed=resumed, ring=ring,
                out_ring=out2)


def test_cli_runs_on_cpu_without_jax(runs):
    """Exit 0; the "particles" and "done:" lines; a 28-column energy.txt
    row, info.txt, timings.txt and a restart dump."""
    proc = runs["first"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"N={runs['n']} particles on cpu" in proc.stdout
    assert "done: 1 steps" in proc.stdout
    rows = runs["rows_first"]
    assert rows.shape == (1, 28) and np.isfinite(rows).all()
    for name in ("info.txt", "timings.txt", "cpu.txt", "restart.npz"):
        assert (runs["out"] / name).exists(), name


def test_cli_restart_flag_1_resumes(runs):
    """Restart flag 1 loads the dump of step 1 and goes on: exit 0, the
    step count and the time go on from the dump's, and energy.txt gains the
    resumed run's row."""
    proc = runs["resumed"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "done: 2 steps" in proc.stdout
    assert chip_smoke._done_time(proc) > chip_smoke._done_time(runs["first"])
    rows = np.loadtxt(runs["out"] / "energy.txt", ndmin=2)
    assert rows.shape == (2, 28) and rows[1, 0] > rows[0, 0]
    info = (runs["out"] / "info.txt").read_text()
    assert info.count("Begin Step") == 2


def test_cli_defaults_to_the_card(runs):
    """With no --device the run asks for CUDA; where there is none it stops
    with a message naming it, exit code not 0, and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default run would go to it")
    proc = cli(runs["param"], 0)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "--device cpu" in proc.stderr


@pytest.mark.parametrize("flag,item", [(("--devices", "2", "--cooling",
                                        "beta"), "queue 3")])
def test_cli_refuses_what_is_not_ported(runs, flag, item):
    """Beta cooling on slabs (each slab's own central mass in the JAX
    slab step) stops, naming the reference's fault and its item, before
    any rank starts."""
    proc = cli(runs["param"], 0, "--device", "cpu", *flag)
    assert proc.returncode != 0
    assert f"ROADMAP {item}" in proc.stderr
    assert "beta" in proc.stderr


# the slab run against the single-device one: each column of energy.txt's
# row within 5e-4 of the row's largest |value| (test_spmd_step.py's bound)
RING_ENERGY_TOL = 5e-4


def test_cli_devices_2_matches_one_device(runs):
    """``--device cpu --devices 2``: exit 0, the ring named in the
    "particles" line, one sync point, and its energy.txt row held to the
    single-device run's."""
    proc = runs["ring"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"N={runs['n']} particles on cpu x 2 ranks" in proc.stdout
    assert "done: 1 steps" in proc.stdout
    got = np.loadtxt(runs["out_ring"] / "energy.txt", ndmin=2)
    want = runs["rows_first"]
    assert got.shape == want.shape == (1, 28)
    assert got[0, 0] == want[0, 0]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=RING_ENERGY_TOL * scale,
                               rtol=0)
    for name in ("info.txt", "cpu.txt", "restart.npz"):
        assert (runs["out_ring"] / name).exists(), name


@pytest.mark.slow
def test_cli_gassphere_devices_2_matches_one_device(tmp_path):
    """The gassphere, a vacuum run, with ``--device cpu --devices 2``: the
    slab step's vacuum TreePM on the mesh ``auto_pmgrid`` picks (named in
    the "particles" line), one sync point, its energy.txt row held to the
    single-device run's (direct gravity, all-pairs SPH) within
    RING_ENERGY_TOL of the row's largest |value|. ``slow``: the ring's
    one sync point takes some two minutes of two processes through the
    plain block SPH (the Evrard centre packs 256 gas into a subcell)."""
    vac_ics = tmp_path / "sphere.dat"
    chip_smoke.write_gassphere_ics(str(vac_ics))
    rows, procs = {}, {}
    for d in (2, None):
        out = tmp_path / f"out_sphere{d or 0}"
        vparam = tmp_path / f"sphere{d or 0}.param"
        vparam.write_text(chip_smoke.gassphere_param_text(str(vac_ics),
                                                          str(out), 0.1))
        ring_args = ("--devices", d) if d else ()
        proc = procs[d] = cli(vparam, 0, "--device", "cpu", *ring_args,
                              "--max-steps", 1, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "done: 1 steps" in proc.stdout
        rows[d] = np.loadtxt(out / "energy.txt", ndmin=2)
    assert "x 2 ranks" in procs[2].stdout and "pmgrid=24" in procs[2].stdout
    got, want = rows[2], rows[None]
    assert got.shape == want.shape == (1, 28) and np.isfinite(got).all()
    assert got[0, 0] == want[0, 0]
    np.testing.assert_allclose(got, want,
                               atol=RING_ENERGY_TOL * np.abs(want).max(),
                               rtol=0)
