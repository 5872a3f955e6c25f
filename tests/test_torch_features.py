"""The port's counterparts of tests/test_features.py's force test and
output-list run and of tests/test_parallel.py's placed step, and the
tracing hooks of the run loop: ``utils/forcetest.py`` against the JAX
package's on the same state, subset and seed; the force test, the
``GLT_CPU_DETAIL`` probes and the ``GLT_PROFILE_*`` trace at the
statistics cadence of ``Simulation.run``; ``utils/logfiles.py ::
profile_steps``; ``OutputListOn``; ``parallel/step.py ::
make_sharded_step``: every tensor of the state placed on the device asked
for, and the placed step against the single-device trajectory. All on the
subsampled Evrard sphere with G = 1 (direct gravity, all-pairs SPH)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.config import \
    parse_parameter_text as j_parse
from gadget_leicester_tpu.models.ics import gassphere_ics
from gadget_leicester_tpu.models.simulation import init_state as j_init
from gadget_leicester_tpu.utils.forcetest import \
    run_forcetest as j_run_forcetest
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.models.simulation import (Simulation,
                                                          init_state,
                                                          sync_point_step)
from gadget_leicester_tpu_torch.parallel.step import make_sharded_step
from gadget_leicester_tpu_torch.utils.forcetest import (run_forcetest,
                                                        write_forcetest_file)
from gadget_leicester_tpu_torch.utils.logfiles import profile_steps
from tests.test_config import GASSPHERE_PARAM


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _text(**repl):
    """test_features.py's configuration: the gassphere with G = 1."""
    txt = GASSPHERE_PARAM.replace("GravityConstantInternal  0",
                                  "GravityConstantInternal  1.0")
    for k, v in repl.items():
        txt += f"\n{k} {v}\n"
    return txt


def _ics(every):
    pos, vel, mass, ptype, u = gassphere_ics(mode="grid")
    keep = np.arange(0, len(pos), every)
    return (pos[keep], vel[keep], mass[keep] * len(pos) / len(keep),
            ptype[keep], u[keep])


def _trace_files(path):
    return [f for _, _, fs in os.walk(path) for f in fs
            if f.endswith(".pt.trace.json")]


def test_forcetest_mode(tmp_path):
    """test_features.py's case: the same subset from the same seed, the
    exact forces within 1e-6 of the JAX package's, the relative errors
    within its bounds (median 1e-4, max 1e-2; the code's force is the
    direct sum) and within 1e-5 of its own, and forcetest.txt's ten
    columns."""
    text = _text(OutputDir=str(tmp_path))
    cfg = parse_parameter_text(text)
    ics = _ics(8)
    st = init_state(cfg, SimOptions(forcetest=0.2), *ics[:4], "cpu",
                    u=ics[4])
    res = run_forcetest(st, cfg, SimOptions(forcetest=0.2))
    jst = j_init(j_parse(text), JOptions(forcetest=0.2), *ics[:4], u=ics[4])
    want = j_run_forcetest(jst, j_parse(text), JOptions(forcetest=0.2))
    np.testing.assert_array_equal(res["subset"], want["subset"])
    scale = np.abs(want["acc_exact"]).max()
    np.testing.assert_allclose(res["acc_exact"], want["acc_exact"], rtol=0,
                               atol=1e-6 * scale)
    assert np.median(res["rel_err"]) < 1e-4
    assert np.max(res["rel_err"]) < 1e-2
    np.testing.assert_allclose(res["rel_err"], want["rel_err"], rtol=0,
                               atol=1e-5)
    path = write_forcetest_file(res, st, cfg)
    assert path == os.path.join(str(tmp_path), "forcetest.txt")
    lines = open(path).read().splitlines()
    assert len(lines) == len(res["subset"])
    assert all(len(line.split()) == 10 for line in lines)


def test_run_hooks_at_the_statistics_cadence(tmp_path, monkeypatch):
    """``Simulation.run`` with the force test on, ``GLT_CPU_DETAIL=1`` and
    ``GLT_PROFILE_DIR`` (start 0, one sync point): forcetest.txt gains the
    subset at each statistics time, cpu.txt's sampled columns (gravity,
    hydro, drift, kick) are above 0 on those rows, and the trace lands in
    the directory."""
    trace = tmp_path / "trace"
    monkeypatch.setenv("GLT_CPU_DETAIL", "1")
    monkeypatch.setenv("GLT_PROFILE_DIR", str(trace))
    monkeypatch.setenv("GLT_PROFILE_START", "0")
    monkeypatch.setenv("GLT_PROFILE_STEPS", "1")
    cfg = parse_parameter_text(_text(OutputDir=str(tmp_path)))
    sim = Simulation(cfg, SimOptions(forcetest=0.2), "cpu")
    ics = _ics(8)
    sim.set_ics(*ics[:4], u=ics[4])
    sim.run(max_steps=2)
    lines = open(tmp_path / "forcetest.txt").read().splitlines()
    n_test = int(sim.state.p.alive.sum() * 0.2)
    assert len(lines) > 0 and len(lines) % n_test == 0
    assert all(len(line.split()) == 10 for line in lines)
    rows = [line.split("#")[0].split() for line in
            open(tmp_path / "cpu.txt").read().splitlines()
            if "#" in line]
    assert len(rows) == 2
    sampled = [[float(r[k]) for k in (1, 2, 3, 4)] for r in rows]
    assert all(v > 0 for v in sampled[0])
    assert len(_trace_files(trace)) == 1


def test_profile_steps_writes_a_trace(tmp_path):
    """``profile_steps``: a torch.profiler trace of n sync points in the
    directory, the steps taken."""
    cfg = parse_parameter_text(_text(OutputDir=str(tmp_path)))
    sim = Simulation(cfg, SimOptions(), "cpu")
    ics = _ics(8)
    sim.set_ics(*ics[:4], u=ics[4])
    ti0 = int(sim.state.ti_current)
    out = profile_steps(sim, n_steps=2, trace_dir=str(tmp_path / "tr"))
    assert out == str(tmp_path / "tr")
    assert sim.step_count == 2 and int(sim.state.ti_current) > ti0
    assert len(_trace_files(out)) == 1


def test_output_list_run(tmp_path):
    """test_features.py's case: OutputListOn with two times before TimeMax
    writes two snapshots."""
    ol = tmp_path / "outputs.txt"
    ol.write_text("0.05\n0.11\n")
    cfg = parse_parameter_text(_text(
        OutputDir=str(tmp_path), OutputListOn=1, OutputListFilename=str(ol),
        TimeMax=0.15, TimeBetSnapshot=0.0))
    sim = Simulation(cfg, SimOptions(), "cpu")
    ics = _ics(8)
    sim.set_ics(*ics[:4], u=ics[4])
    sim.run(max_steps=100)
    snaps = sorted(f for f in os.listdir(tmp_path)
                   if f.startswith("snapshot"))
    assert len(snaps) == 2, snaps


def test_sharded_step_matches_single_device():
    """test_parallel.py's case and tolerances: the placed step's trajectory
    (three sync points) against the single-device one; and every tensor of
    a state that went through a sync point (its grid cache too) placed on
    the device asked for (``meta``, which no tensor of it is on)."""
    cfg = parse_parameter_text(_text())
    opts = SimOptions()
    ics = _ics(4)
    state = init_state(cfg, opts, *ics[:4], "cpu", u=ics[4])
    s1 = state
    for _ in range(3):
        s1 = sync_point_step(s1, cfg, opts)
    step, s8 = make_sharded_step(state, cfg, opts, "cpu")
    for _ in range(3):
        s8 = step(s8)
    np.testing.assert_allclose(s1.p.pos.numpy(), s8.p.pos.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s1.p.vel.numpy(), s8.p.vel.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s1.gas.entropy.numpy(),
                               s8.gas.entropy.numpy(), rtol=1e-4, atol=1e-6)
    assert int(s1.ti_current) == int(s8.ti_current)
    _, placed = make_sharded_step(s1, cfg, opts, "meta")
    devices = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            devices.append(node.device)
        elif dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name))
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)

    walk(placed)
    assert len(devices) > 20 and set(devices) == {torch.device("meta")}
    assert s1.p.pos.device == torch.device("cpu")
