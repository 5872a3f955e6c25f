"""The small gravity and EOS switches of the port against the JAX package
on the CPU: ``nogravity``, ``adaptive_gravsoft_forgas`` and
``isotherm_eqs``, each through ``set_ics`` and 3 sync points of a small
periodic lcdm_gas box (2x6^3, TreePM with pmgrid 24, all-pairs SPH;
tests/test_torch_slice.py's parameters, JAX with its kernels off), state
by state by core/state.py's bounds; the full potential with the adaptive
gas softening; and ``--isothermal`` through the port's command line on
the subsampled Evrard sphere of tests/test_torch_gassphere.py, its
energy.txt and restart dump against the JAX package's run of the same
parameter file."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.config import \
    parse_parameter_text as j_parse
from gadget_leicester_tpu.models.ics import lcdm_gas_ics
from gadget_leicester_tpu.models.simulation import Simulation as JSimulation
from gadget_leicester_tpu.models.simulation import \
    potential_pass as j_potential_pass
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.core.state import (CLOSE_FIELDS,
                                                   assert_states_close,
                                                   to_numpy)
from gadget_leicester_tpu_torch.io.restart import load_restart
from gadget_leicester_tpu_torch.io.snapshot import (Header, SnapshotData,
                                                    write_snapshot)
from gadget_leicester_tpu_torch.models.forces import (compute_forces,
                                                      gravity_softening)
from gadget_leicester_tpu_torch.models.simulation import (Simulation,
                                                          potential_pass)
from tests.test_torch_cli import cli
from tests.test_torch_gassphere import PARAM as GAS_PARAM
from tests.test_torch_gassphere import _ics as gas_ics
from tests.test_torch_slice import BOX, _jax_dict
from tests.test_torch_slice import PARAM as BOX_PARAM

N_SIDE = 6
N_STEPS = 3
BOX_OPTS = dict(periodic=True, pmgrid=24, gravity_mode="treepm")
SWITCHES = ("nogravity", "adaptive_gravsoft_forgas", "isotherm_eqs")
# p.acc: kernel A's plain version takes the truncation as the TPU kernel's
# degree-10 polynomial (6.5e-6 of it at most), the JAX package's CPU path
# the exact erfc; on this box the two short-range sums differ by 2.6e-5 of
# the largest acc with or without a switch (measured at set_ics), beyond
# core/state.py's 2e-5 on up to 10 rows. Every other field by its bounds.
ACC_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """Per switch: the JAX and the port trajectories (numpy dicts) from
    the same ICs, and the last states."""
    cfg, jcfg = parse_parameter_text(BOX_PARAM), j_parse(BOX_PARAM)
    pos, vel, mass, ptype, u = lcdm_gas_ics(
        n_side=N_SIDE, box=BOX, omega0=0.3, omega_b=0.04,
        hubble=cfg.hubble_internal, g=cfg.grav_internal)
    out = {}
    for switch in SWITCHES:
        jopts = JOptions(use_pallas="off", **BOX_OPTS, **{switch: True})
        opts = SimOptions(**BOX_OPTS, **{switch: True})
        jsim = JSimulation(jcfg, jopts)
        jsim.set_ics(pos, vel, mass, ptype, u=u)
        sim = Simulation(cfg, opts, "cpu")
        sim.set_ics(pos, vel, mass, ptype, u=u)
        jax_traj, port_traj = [_jax_dict(jsim.state)], [to_numpy(sim.state)]
        for _ in range(N_STEPS):
            jsim.step()
            sim.step()
            jax_traj.append(_jax_dict(jsim.state))
            port_traj.append(to_numpy(sim.state))
        out[switch] = dict(jax=jax_traj, port=port_traj, sim=sim, jsim=jsim,
                           cfg=cfg, opts=opts, u0=np.asarray(u))
    return out


@pytest.mark.parametrize("step", range(N_STEPS + 1))
@pytest.mark.parametrize("switch", SWITCHES)
def test_switch_matches_jax_state_by_state(runs, switch, step):
    """Every float field but p.acc within 2e-5 of its largest value on all
    but 3 rows, the timeline fields equal (the slice's bounds); p.acc
    within ``ACC_TOL`` of its largest; ``set_ics`` is step 0."""
    got, want = runs[switch]["port"][step], runs[switch]["jax"][step]
    assert_states_close(got, want, fields=tuple(
        f for f in CLOSE_FIELDS if f != "p.acc"))
    scale = max(np.abs(want["p.acc"]).max(), 1e-30)
    assert np.abs(got["p.acc"] - want["p.acc"]).max() <= ACC_TOL * scale


def test_nogravity_has_no_gravity_and_no_pm_step(runs):
    """No force, potential or PM step; the gas still moves by its
    pressure; the full potential leaves the state as it is."""
    r = runs["nogravity"]
    st = r["sim"].state
    for name in ("acc", "acc_pm", "pot", "pot_pm", "old_acc"):
        assert not getattr(st.p, name).any(), name
    assert int(st.pm_ti_endstep) == 0 and st.grids.grav is None
    assert st.gas.hydro_acc.abs().max() > 0
    assert potential_pass(st, r["cfg"], r["opts"]) is st


def test_adaptive_softening_follows_h(runs):
    """Gas softening max(h, 2.8 eps_gas), the dark matter's unchanged; at
    least some gas above the floor, so the switch is exercised; the full
    potential with it against the JAX package's (2e-5 of the largest)."""
    r = runs["adaptive_gravsoft_forgas"]
    st, cfg, opts = r["sim"].state, r["cfg"], r["opts"]
    atime = torch.tensor(0.1, dtype=torch.float32)
    soft = gravity_softening(st, cfg, opts, atime)
    plain = gravity_softening(st, cfg, dataclasses.replace(
        opts, adaptive_gravsoft_forgas=False), atime)
    ng = st.n_gas_max
    gas = st.p.ptype[:ng] == 0
    assert torch.equal(soft[ng:], plain[ng:])
    assert torch.equal(soft[:ng][gas],
                       torch.maximum(st.gas.hsml[gas], plain[:ng][gas]))
    assert (soft[:ng][gas] > plain[:ng][gas]).any()
    got = potential_pass(st, cfg, opts).p.pot.numpy()
    jsim = r["jsim"]
    want = np.asarray(j_potential_pass(jsim.state, jsim.cfg,
                                       jsim.opts).p.pot)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_isothermal_keeps_the_sound_speed(runs):
    """After ``set_ics``: c_s^2 = (gamma - 1) u in the entropy slot and P =
    c_s^2 rho; dt_entropy stays 0 through the steps."""
    r = runs["isotherm_eqs"]
    st = r["sim"].state
    gas = ((st.p.ptype[:st.n_gas_max] == 0)
           & st.p.alive[:st.n_gas_max]).numpy()
    init = r["port"][0]
    u = np.zeros_like(init["gas.entropy"])
    u[:len(r["u0"])] = r["u0"]
    np.testing.assert_allclose(init["gas.entropy"][gas], (2 / 3) * u[gas],
                               rtol=1e-6)
    cs2_rho = init["gas.entropy"] * init["gas.density"]
    np.testing.assert_allclose(init["gas.pressure"][gas], cs2_rho[gas],
                               rtol=1e-6)
    for step in r["port"]:
        assert not step["gas.dt_entropy"].any()


def test_nogravity_force_pass_zeroes_gravity_of_any_state(runs):
    """``compute_forces`` under nogravity on a state with gravity in it
    (the adaptive run's) leaves no acceleration or potential."""
    r = runs["adaptive_gravsoft_forgas"]
    st = r["sim"].state
    opts = dataclasses.replace(r["opts"], adaptive_gravsoft_forgas=False,
                               nogravity=True)
    out = compute_forces(st, r["cfg"], opts, do_sph=False)
    assert st.p.acc.any() and not out.p.acc.any() and not out.p.pot.any()


CLI_STEPS = 3
CLI_CADENCE = "CpuTimeBetRestartFile 0.0\n"


def _write_gas_ics(path):
    pos, vel, mass, ptype, u = gas_ics()
    n = len(pos)
    h = Header()
    h.npart[0] = n
    h.npart_total = h.npart.copy()
    write_snapshot(str(path), SnapshotData(
        header=h, pos=pos.astype(np.float32), vel=vel.astype(np.float32),
        ids=np.arange(1, n + 1, dtype=np.uint32),
        mass=mass.astype(np.float32), u=u.astype(np.float32)), fmt=1)


@pytest.fixture(scope="module")
def isothermal_cli(tmp_path_factory):
    """``python -m gadget_leicester_tpu_torch gas.param 0 --device cpu
    --isothermal --max-steps 3`` in a child process without jax, and the
    JAX package's run of the same parameter file with ``isotherm_eqs``
    (its own output directory)."""
    tmp = tmp_path_factory.mktemp("iso")
    ics = tmp / "ics.dat"
    _write_gas_ics(ics)
    text = {}
    for who in ("port", "jax"):
        text[who] = (GAS_PARAM
                     .replace("./gassphere_littleendian.dat", str(ics))
                     .replace("OutputDir           ./out",
                              f"OutputDir           {tmp / who}")
                     + CLI_CADENCE)
        (tmp / f"{who}.param").write_text(text[who])
    proc = cli(tmp / "port.param", 0, "--device", "cpu", "--isothermal",
               "--max-steps", CLI_STEPS)
    jsim = JSimulation.from_param_file(
        str(tmp / "jax.param"), None, opt_overrides={"isotherm_eqs": True})
    jsim.run(max_steps=CLI_STEPS)
    return dict(proc=proc, tmp=tmp, jsim=jsim)


def test_isothermal_cli_matches_jax(isothermal_cli):
    """The CLI exits 0 after 3 sync points; its energy.txt rows match the
    JAX package's run to 2e-5 of the largest energy (the kinetic energy of
    a sphere at rest is float noise of 1e-20), its last restart dump by
    the slice's bounds; the entropy slot holds the one c_s^2 of the
    sphere's one u."""
    r = isothermal_cli
    proc = r["proc"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"done: {CLI_STEPS} steps" in proc.stdout
    got = np.loadtxt(r["tmp"] / "port" / "energy.txt", ndmin=2)
    want = np.loadtxt(r["tmp"] / "jax" / "energy.txt", ndmin=2)
    assert got.shape == want.shape and got.shape[1] == 28
    assert np.array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want[:, 1:]).max())
    state, meta = load_restart(str(r["tmp"] / "port" / "restart"), "cpu")
    assert meta["step_count"] == CLI_STEPS
    assert_states_close(to_numpy(state), _jax_dict(r["jsim"].state))
    assert not state.gas.dt_entropy.any()
    ng = state.n_gas_max
    ent = state.gas.entropy[(state.p.ptype[:ng] == 0) & state.p.alive[:ng]]
    assert torch.equal(ent, torch.full_like(ent, float(ent[0])))
    assert chip_smoke._done_time(proc) > 0
