"""The run loop on the CPU against the JAX package's: the same parameter
file and IC file (lcdm_gas 2x12^3, test_torch_slice's configuration, with
OUTPUTPOTENTIAL), the options given explicitly to both (JAX: use_pallas
off), Simulation.from_param_file(...).run() for 2 sync points with the
statistics at every one, then a sticky overflow bit forced on both and one
more sync point: energy.txt, info.txt (with the overflow bump's note), the
bumped capacities and the snapshots."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.io.snapshot import read_snapshot as j_read
from gadget_leicester_tpu.models.simulation import Simulation as JSimulation
from gadget_leicester_tpu_torch.core.config import SimOptions
from gadget_leicester_tpu_torch.models.simulation import Simulation
from tests.test_torch_slice import OPTS, PARAM

RUN = """
TimeBetStatistics 1e-6
TimeOfFirstSnapshot 0.0925
TimeBetSnapshot 1.05
CpuTimeBetRestartFile 1e9
"""


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def param_file(tmp_path, name, ics, extra=RUN):
    out = tmp_path / name
    text = PARAM.replace("InitCondFile x", f"InitCondFile {ics}").replace(
        "OutputDir  /tmp/grid_cache_test", f"OutputDir  {out}") + extra
    path = tmp_path / f"{name}.param"
    path.write_text(text)
    return str(path), out


def _force_overflow(sim, make):
    sim.state = dataclasses.replace(sim.state, overflow_flags=make(3))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("run")
    ics = tmp / "ics.dat"
    chip_smoke.write_ics(str(ics), 12)
    out = {}
    for name in ("port", "jax"):
        path, outdir = param_file(tmp, name, ics)
        if name == "port":
            sim = Simulation.from_param_file(
                path, SimOptions(output_potential=True, **OPTS),
                device="cpu")
            make = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
        else:
            sim = JSimulation.from_param_file(
                path, JOptions(use_pallas="off", output_potential=True,
                               **OPTS))
            make = jnp.int32
        sim.run(max_steps=2)
        _force_overflow(sim, make)
        sim.run(max_steps=1)
        sim.logs.close()
        out[name] = dict(sim=sim, dir=outdir)
    return out


def _rows(d):
    return np.loadtxt(d / "energy.txt", ndmin=2)


def test_energy_rows_match_jax(runs):
    """A row at each of the 3 sync points, 28 columns, finite. The JAX
    package takes the time in float32, where TimeBegin 0.090909 rounds
    below itself, so it skips the row at TimeBegin (a fault of the
    reference, ROADMAP queue 3); the port, in float64, writes it. The
    rows both write: the time within 1e-6 relative, the energies within
    1e-4 of each column's largest |value| (the trajectories agree to 2e-5,
    test_torch_slice; the potential comes from kernel H's plain version and
    from the JAX package's exact-erfc cell sum, both summed in float32)."""
    got, want = _rows(runs["port"]["dir"]), _rows(runs["jax"]["dir"])
    assert got.shape == (3, 28) and want.shape == (2, 28)
    assert np.isfinite(got).all()
    assert got[0, 0] == runs["port"]["sim"].cfg.time_begin
    got = got[1:]
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6)
    scale = np.abs(want[:, 1:]).max(axis=0)
    err = np.abs(got[:, 1:] - want[:, 1:]).max(axis=0)
    assert (err <= 1e-4 * scale).all(), err / np.maximum(scale, 1e-30)
    assert (got[:, 2] < 0).all() and (got[:, 3] > 0).all()


def _info(d):
    return [line.strip() for line in (d / "info.txt").read_text().splitlines()
            if line.strip()]


def test_info_steps_times_and_overflow_note_match_jax(runs):
    got, want = _info(runs["port"]["dir"]), _info(runs["jax"]["dir"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.startswith("Begin Step"):
            gs, ws = g.replace(",", "").split(), w.replace(",", "").split()
            assert gs[2] == ws[2]                               # step
            assert float(gs[4]) == pytest.approx(float(ws[4]), rel=1e-5)
        else:
            assert g == w      # the overflow bump's note
    assert any(line.startswith("overflow 3: capacities -> sph=128 sr=256")
               for line in got)


def test_overflow_bump_matches_jax(runs):
    """The sticky bits 1 | 2: SPH capacity doubled (64 -> 128), SR
    capacity + 128 (-> 256), the bits cleared, the grid cache rebuilt (the
    bump came after the last step, so no grid is built yet)."""
    sim, jsim = runs["port"]["sim"], runs["jax"]["sim"]
    for s in (sim, jsim):
        assert (s.opts.sph_capacity, s.opts.sr_capacity) == (128, 256)
        assert int(s.state.overflow_flags) == 0
    assert sim.state.grids.grav is None and sim.state.grids.sph is None
    assert sim.step_count == jsim.step_count == 3


def test_snapshot_readable_by_jax_with_potential(runs):
    """The port's snapshot reads with the JAX reader, with the POT block of
    OUTPUTPOTENTIAL; it holds what the JAX run's holds, within the bounds
    of the trajectories (positions 2e-5 of the box scale, the potential
    1e-4 of its largest |value|)."""
    got = j_read(str(runs["port"]["dir"] / "snapshot_000"))
    want = j_read(str(runs["jax"]["dir"] / "snapshot_000"))
    assert got.pot is not None and np.isfinite(got.pot).all()
    np.testing.assert_array_equal(got.header.npart, want.header.npart)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.pos, want.pos, rtol=0,
                               atol=2e-5 * np.abs(want.pos).max())
    np.testing.assert_allclose(got.pot, want.pot, rtol=0,
                               atol=1e-4 * np.abs(want.pot).max())
    assert runs["port"]["sim"].snapshot_count == 1


def test_set_ics_raises_capacities_until_nothing_overflows(tmp_path):
    """Gas that a full cell drops in set_ics would keep density 0 and an
    entropy taken at density 1, and turn the hydro sums NaN once a later
    capacity bump lists it again (ROADMAP queue 3): the port's set_ics
    raises the capacity as the run loop does and starts over. 2x10^3 under
    block SPH with 8 slots a subcell on 2^3 blocks: raised until nothing
    overflows, every gas density > 0, the notes in info.txt."""
    from gadget_leicester_tpu_torch.core.config import parse_parameter_text
    from gadget_leicester_tpu_torch.models.ics import lcdm_gas_ics
    cfg = parse_parameter_text(PARAM.replace(
        "OutputDir  /tmp/grid_cache_test", f"OutputDir  {tmp_path}"))
    opts = SimOptions(**dict(OPTS, sph_capacity=8, sph_grid=4))
    pos, vel, mass, ptype, u = lcdm_gas_ics(
        n_side=10, box=cfg.box_size, omega0=0.3, omega_b=0.04,
        hubble=cfg.hubble_internal, g=cfg.grav_internal)
    sim = Simulation(cfg, opts, "cpu")
    sim.set_ics(pos, vel, mass, ptype, u=u)
    st = sim.state
    caps = [int(n.split("sph=")[1].split()[0]) for n in sim.init_notes]
    assert caps and caps == [8 * 2 ** (k + 1) for k in range(len(caps))]
    assert int(st.overflow_flags) == 0 and sim.opts.sph_capacity == caps[-1]
    ng = st.n_gas_max
    gas = st.p.alive[:ng] & (st.p.ptype[:ng] == 0)
    assert bool((st.gas.density[gas] > 0).all())
    sim.run(max_steps=1)
    sim.logs.close()
    info = (tmp_path / "info.txt").read_text()
    assert info.count("set_ics: overflow 2: capacities -> sph=") == len(caps)
    assert torch.isfinite(sim.state.p.vel).all()
