"""The PyTorch port's core modules against the JAX package: parameter
parsing, timeline, cosmology factors, the numpy state bridge and the
lcdm_gas initial conditions. Inputs are seeded numpy arrays fed to both."""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.core import config as jconfig
from gadget_leicester_tpu.core import cosmology as jcosmo
from gadget_leicester_tpu.core import state as jstate
from gadget_leicester_tpu.core import timeline as jtimeline
from gadget_leicester_tpu.models.ics import lcdm_gas_ics as j_lcdm_gas_ics
from gadget_leicester_tpu_torch.core import config as tconfig
from gadget_leicester_tpu_torch.core import cosmology as tcosmo
from gadget_leicester_tpu_torch.core import state as tstate
from gadget_leicester_tpu_torch.core import timeline as ttimeline
from gadget_leicester_tpu_torch.models.ics import lcdm_gas_ics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_FILES = sorted(glob.glob(os.path.join(REPO, "parameterfiles",
                                            "*.param")))

BENCH_PARAM = """
InitCondFile x
OutputDir  /tmp/bench_out
TimeBegin  0.090909
TimeMax    1.0
ComovingIntegrationOn 1
PeriodicBoundariesOn 1
BoxSize    50000.0
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
SofteningGas  13.021
SofteningHalo 13.021
SofteningGasMaxPhys  13.021
SofteningHaloMaxPhys 13.021
MinGasHsmlFractional 0.1
"""


def _cfgs(text):
    return (jconfig.parse_parameter_text(text),
            tconfig.parse_parameter_text(text))


@pytest.mark.parametrize("path", PARAM_FILES,
                         ids=[os.path.basename(p) for p in PARAM_FILES])
def test_param_files_parse_equal(path):
    """Every stock parameter file parses to the same fields (exact)."""
    with open(path) as fh:
        jc, tc = _cfgs(fh.read())
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert jc.softenings == tc.softenings


def test_bench_param_parses_equal_and_options():
    jc, tc = _cfgs(BENCH_PARAM)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    n = 2 * 128 ** 3
    jo = dataclasses.asdict(jconfig.options_from_config(jc, n_particles=n))
    to = dataclasses.asdict(tconfig.options_from_config(tc, n_particles=n))
    assert jo.pop("use_pallas") == "auto"
    assert jo == to
    assert tconfig.auto_pmgrid(n) == jconfig.auto_pmgrid(n) == 192
    for k in (1000, 8192, 10 ** 5, 10 ** 6, 10 ** 8):
        assert tconfig.auto_pmgrid(k) == jconfig.auto_pmgrid(k)
    text = "OPT += -DPERIODIC -DPMGRID=128\nSINKS\n"
    assert (tconfig.parse_makefile_options(text)
            == jconfig.parse_makefile_options(text))


def test_missing_tag_raises_in_both():
    text = "OutputDir x\nTimeBegin 0\nTimeMax 1\n"
    with pytest.raises(ValueError, match="InitCondFile"):
        jconfig.parse_parameter_text(text)
    with pytest.raises(ValueError, match="InitCondFile"):
        tconfig.parse_parameter_text(text)


def test_quantize_and_active_match():
    """Power-of-two quantisation, next sync point and active mask: exact
    integer agreement over a sweep of step lengths and sync times."""
    rng = np.random.default_rng(5)
    steps = np.exp(rng.uniform(0.0, np.log(2.0 ** 28), 2000)).astype(
        np.float32)
    steps[:6] = [0.5, 1.0, 2.0, 3.0, 2.0 ** 20, 2.0 ** 28 + 5]
    for ti in (0, 1, 2, 96, 2 ** 20, 3 * 2 ** 21, 2 ** 27):
        want = np.asarray(jtimeline.quantize_timestep(jnp.asarray(steps), ti))
        got = ttimeline.quantize_timestep(
            torch.from_numpy(steps), torch.tensor(ti, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), want)
    ti_end = rng.integers(0, 2 ** 28, 500).astype(np.int32)
    alive = rng.uniform(size=500) > 0.2
    want = int(jtimeline.min_active_ti_end(jnp.asarray(ti_end),
                                           jnp.asarray(alive)))
    got = int(ttimeline.min_active_ti_end(torch.from_numpy(ti_end),
                                          torch.from_numpy(alive)))
    assert got == want
    ti_end[::7] = want
    np.testing.assert_array_equal(
        ttimeline.active_mask(torch.from_numpy(ti_end),
                              torch.tensor(want, dtype=torch.int32),
                              torch.from_numpy(alive)).numpy(),
        np.asarray(jtimeline.active_mask(jnp.asarray(ti_end), want,
                                         jnp.asarray(alive))))


@pytest.mark.parametrize("comoving", [1, 0])
def test_cosmology_factors_match(comoving):
    """Drift and kick factors over per-particle intervals: float32 GL3 in
    both; 2e-6 relative covers the exp/pow rounding of two libraries."""
    jc, tc = _cfgs(BENCH_PARAM.replace("ComovingIntegrationOn 1",
                                       f"ComovingIntegrationOn {comoving}"))
    rng = np.random.default_rng(9)
    ti0 = rng.integers(0, 2 ** 27, 300).astype(np.int32)
    ti1 = (ti0 + rng.integers(1, 2 ** 22, 300)).astype(np.int32)
    for jf, tf in ((jcosmo.drift_factor, tcosmo.drift_factor),
                   (jcosmo.gravkick_factor, tcosmo.gravkick_factor),
                   (jcosmo.hydrokick_factor, tcosmo.hydrokick_factor)):
        want = np.asarray(jf(None, jc, jnp.asarray(ti0), jnp.asarray(ti1)))
        got = tf(tc, torch.from_numpy(ti0), torch.from_numpy(ti1)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    a = np.linspace(0.09, 1.0, 50).astype(np.float32)
    np.testing.assert_allclose(
        tcosmo.hubble_function(torch.from_numpy(a), 0.3, 0.7, 0.1).numpy(),
        np.asarray(jcosmo.hubble_function(jnp.asarray(a), 0.3, 0.7, 0.1)),
        rtol=1e-6)


def _jax_state_to_numpy(st):
    out = {}
    for g in ("p", "gas", "sinks"):
        sub = getattr(st, g)
        for f in dataclasses.fields(sub):
            out[f"{g}.{f.name}"] = np.asarray(getattr(sub, f.name))
    for k in ("ti_current", "pm_ti_endstep", "pm_ti_begstep",
              "overflow_flags", "rng_key"):
        out[k] = np.asarray(getattr(st, k))
    return out


def test_numpy_bridge_round_trip():
    """JAX state -> numpy -> port -> numpy: every field equal, dtypes
    kept; the rng_key is dropped."""
    rng = np.random.default_rng(2)
    n = 300
    ptype = np.where(rng.uniform(size=n) < 0.5, 0, 1).astype(np.int32)
    opts = jconfig.SimOptions(periodic=True)
    jst = jstate.from_arrays(rng.uniform(0, 10, (n, 3)),
                             rng.normal(size=(n, 3)), rng.uniform(1, 2, n),
                             ptype, np.arange(1, n + 1), opts,
                             u=rng.uniform(size=n))
    d = _jax_state_to_numpy(jst)
    d["ti_current"] = np.int32(123456)
    d["overflow_flags"] = np.int32(3)
    st = tstate.from_numpy(d, "cpu")
    back = tstate.to_numpy(st)
    assert set(back) == set(d) - {"rng_key"}
    for k, v in back.items():
        assert v.dtype == d[k].dtype, k
        np.testing.assert_array_equal(v, d[k], err_msg=k)
    assert st.n_max == jst.n_max and st.n_gas_max == jst.n_gas_max


def test_from_arrays_matches_jax_layout():
    """Same IC arrays -> same padded gas-first layout, field by field."""
    rng = np.random.default_rng(4)
    n = 700
    ptype = rng.integers(0, 2, n).astype(np.int32)
    args = (rng.uniform(0, 10, (n, 3)), rng.normal(size=(n, 3)),
            rng.uniform(1, 2, n), ptype, np.arange(1, n + 1))
    u = rng.uniform(size=n)
    want = _jax_state_to_numpy(jstate.from_arrays(
        *args, jconfig.SimOptions(periodic=True), u=u))
    got = tstate.to_numpy(tstate.from_arrays(
        *args, tconfig.SimOptions(periodic=True), "cpu", u=u))
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_lcdm_gas_ics_identical():
    kw = dict(n_side=6, box=50000.0, omega0=0.3, omega_b=0.04, hubble=0.1,
              g=43007.1)
    for a, b in zip(lcdm_gas_ics(**kw), j_lcdm_gas_ics(**kw)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(lcdm_gas_ics(n_side=4, with_gas=False, seed=3),
                    j_lcdm_gas_ics(n_side=4, with_gas=False, seed=3)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
