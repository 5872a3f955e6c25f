"""The energy diagnostics and log files against the JAX package's, on the
CPU: energy_statistics on one state carried into both, the
Layzer-Irvine tracker on one sequence, and the lines RunLogs writes."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.config import \
    parse_parameter_text as j_parse
from gadget_leicester_tpu.core.state import from_arrays as j_from_arrays
from gadget_leicester_tpu.models.ics import lcdm_gas_ics
from gadget_leicester_tpu.utils import diagnostics as jdiag
from gadget_leicester_tpu.utils.logfiles import RunLogs as JRunLogs
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.core.state import from_numpy, to_numpy
from gadget_leicester_tpu_torch.utils import diagnostics as diag
from gadget_leicester_tpu_torch.utils.logfiles import RunLogs
from tests.test_torch_slice import OPTS, PARAM, _jax_dict


def _filled_state(seed):
    """An lcdm_gas 2x8^3 layout with every field energy_statistics reads
    filled from a seeded numpy stream: (numpy dict, JAX state)."""
    cfg = j_parse(PARAM)
    pos, vel, mass, ptype, _ = lcdm_gas_ics(
        n_side=8, box=cfg.box_size, omega0=0.3, omega_b=0.04,
        hubble=cfg.hubble_internal, g=cfg.grav_internal)
    jopts = JOptions(use_pallas="off", **OPTS)
    jst = j_from_arrays(pos, vel, mass, ptype, np.arange(1, len(pos) + 1),
                        jopts)
    d = to_numpy(from_numpy(_jax_dict(jst), "cpu"))
    rng = np.random.default_rng(seed)
    n, ng = d["p.pos"].shape[0], d["gas.entropy"].shape[0]
    f32 = np.float32
    for k, scale in (("p.vel", 30.0), ("p.acc", 5.0), ("p.acc_pm", 2.0),
                     ("gas.hydro_acc", 3.0)):
        d[k] = (scale * rng.normal(size=d[k].shape)).astype(f32)
    d["p.pot"] = (-1e4 * (1.0 + rng.random(n))).astype(f32)
    d["gas.entropy"] = (1e3 * (1.0 + rng.random(ng))).astype(f32)
    d["gas.dt_entropy"] = (50.0 * rng.normal(size=ng)).astype(f32)
    d["gas.density"] = np.where(rng.random(ng) < 0.9,
                                1e-6 * (1.0 + rng.random(ng)), 0.0).astype(f32)
    ti_now = 4096
    steps = 2 ** rng.integers(8, 12, size=n)
    d["p.ti_begstep"] = (ti_now - steps // 2 * rng.integers(0, 2, n)).astype(
        np.int32)
    d["p.ti_endstep"] = (d["p.ti_begstep"] + steps).astype(np.int32)
    d["ti_current"] = np.int32(ti_now)
    d["pm_ti_begstep"] = np.int32(ti_now - 512)
    d["pm_ti_endstep"] = np.int32(ti_now + 512)
    d["p.alive"][rng.random(n) < 0.05] = False
    return d, _to_jax(jst, d)


def _to_jax(jst, d):
    """The JAX state ``jst`` with every field replaced from ``d``."""
    groups = {}
    for g in ("p", "gas"):
        sub = getattr(jst, g)
        groups[g] = dataclasses.replace(sub, **{
            f.name: jnp.asarray(d[f"{g}.{f.name}"])
            for f in dataclasses.fields(sub)})
    scalars = {k: jnp.int32(int(d[k])) for k in
               ("ti_current", "pm_ti_endstep", "pm_ti_begstep")}
    return dataclasses.replace(jst, **groups, **scalars)


def test_energy_statistics_matches_jax():
    """Every field of EnergyStats. float32 sums over ~1k particles in
    another order: 1e-5 of each field's scale (its largest |component|;
    for the momenta, which cancel, the sum of |m v| and of |m x||v|)."""
    d, jst = _filled_state(1)
    cfg, opts = parse_parameter_text(PARAM), SimOptions(**OPTS)
    got = diag.energy_statistics(from_numpy(d, "cpu"), cfg, opts)
    want = jdiag.energy_statistics(jst, j_parse(PARAM),
                                   JOptions(use_pallas="off", **OPTS))
    m = np.where(d["p.alive"], d["p.mass"], 0.0)
    speed = np.linalg.norm(d["p.vel"], axis=1)
    scales = {"momentum": (m * speed).sum(),
              "ang_mom": (m * speed * np.linalg.norm(d["p.pos"], axis=1)
                          ).sum()}
    assert got._fields == want._fields
    for name in got._fields:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        scale = scales.get(name, np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)
    assert float(got.internal) > 0 and float(got.kinetic) > 0


def _sequence(seed, n=25):
    """A run's (a, EnergyStats) rows: T ~ a, W ~ 1/a, U ~ a^-2, noise."""
    rng = np.random.default_rng(seed)
    a = np.sort(0.09 + 0.2 * rng.random(n))
    rows = []
    for ai in a:
        vals = dict(kinetic=6e6 * ai / 0.09 * ai ** 2,
                    potential=-2e9 * 0.09 / ai * (1 + 1e-3 * rng.normal()),
                    internal=1.2e7 * (0.09 / ai) ** 2)
        # float32, as the energies are: both sides read the same values
        rows.append((float(ai), {k: np.float32(v) for k, v in vals.items()}))
    return rows


def _stats(cls, vals, conv):
    zero3, zero6 = conv(np.zeros(3)), conv(np.zeros(6))
    total = vals["kinetic"] + vals["potential"] + vals["internal"]
    return cls(kinetic=conv(vals["kinetic"]), internal=conv(vals["internal"]),
               potential=conv(vals["potential"]), total=conv(total),
               momentum=zero3, ang_mom=zero3, mass=conv(1.0),
               kinetic_comp=zero6, internal_comp=zero6, potential_comp=zero6,
               mass_comp=zero6)


def test_layzer_irvine_tracker_equal_to_jax():
    """Plain Python on both sides: the same drifts, to the last bit."""
    mine, theirs = diag.LayzerIrvineTracker(), jdiag.LayzerIrvineTracker()
    drifts = []
    for a, vals in _sequence(2):
        got = mine.update(a, _stats(diag.EnergyStats, vals, torch.tensor))
        want = theirs.update(a, _stats(jdiag.EnergyStats, vals, jnp.asarray))
        assert got == want
        drifts.append(got)
    assert drifts[0] == 0.0 and max(drifts) > 0


def _log_all(logs_cls, stats, outdir):
    cfg = parse_parameter_text(PARAM.replace(
        "OutputDir  /tmp/grid_cache_test", f"OutputDir  {outdir}"))
    logs = logs_cls(cfg)
    logs.log_energy(0.0931415926535, stats)
    logs.log_info(7, 0.0931415926535, 0.00123456789, note="overflow 3: x")
    logs.log_timings(7, 12345, 0.0812345, pm=True)
    logs.log_cpu(7, 0.0931415926535, {"total": 0.08123, "potential": 1.5,
                                      "probe": 0.25})
    logs.close()
    return {f: (outdir / f).read_text()
            for f in ("energy.txt", "info.txt", "timings.txt", "cpu.txt")}


@pytest.mark.parametrize("seed", [3, 4])
def test_run_logs_write_the_jax_lines(tmp_path, seed):
    """The same stats (float32 values) give the same 28-column energy.txt
    line, and the same info.txt, timings.txt and cpu.txt lines."""
    rng = np.random.default_rng(seed)
    vals = {f: rng.normal(size=s).astype(np.float32) * 1e6
            for f, s in (("kinetic", ()), ("internal", ()),
                         ("potential", ()), ("total", ()),
                         ("momentum", 3), ("ang_mom", 3), ("mass", ()),
                         ("kinetic_comp", 6), ("internal_comp", 6),
                         ("potential_comp", 6), ("mass_comp", 6))}
    got = _log_all(RunLogs, diag.EnergyStats(
        **{k: torch.from_numpy(np.asarray(v)) for k, v in vals.items()}),
        tmp_path / "port")
    want = _log_all(JRunLogs, jdiag.EnergyStats(
        **{k: jnp.asarray(v) for k, v in vals.items()}), tmp_path / "jax")
    assert got == want
    assert len(got["energy.txt"].split()) == 28
