"""The port's I/O on the CPU: its copy of io/snapshot.py against the JAX
package's (byte-identical files, equal reads, the same errors),
snapshot_from_state against the JAX package's on one state, and restart
dumps (bit-identical save and load, a resumed run that continues bit for
bit, a refused layout)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from gadget_leicester_tpu.io import snapshot as jsnap
from gadget_leicester_tpu.io.state_io import \
    snapshot_from_state as j_snapshot_from_state
from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.config import \
    parse_parameter_text as j_parse
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.core.state import (field_manifest,
                                                   from_numpy, to_numpy)
from gadget_leicester_tpu_torch.io import snapshot as snap
from gadget_leicester_tpu_torch.io.restart import load_restart, save_restart
from gadget_leicester_tpu_torch.io.state_io import (ic_arrays_from_snapshot,
                                                    snapshot_from_state)
from gadget_leicester_tpu_torch.models.ics import lcdm_gas_ics
from gadget_leicester_tpu_torch.models.simulation import Simulation
from tests.test_torch_diagnostics import _filled_state
from tests.test_torch_slice import OPTS, PARAM

FIELDS = ("pos", "vel", "ids", "mass", "u", "rho", "hsml", "pot")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data(mod, seed, n_gas=40, n_dm=60, gas=True, pot=True):
    """The same contents as ``mod``'s SnapshotData: two types, per-particle
    masses, optional gas blocks and potential."""
    rng = np.random.default_rng(seed)
    n = n_gas + n_dm
    h = mod.Header()
    h.npart = np.array([n_gas, n_dm, 0, 0, 0, 0], np.uint32)
    h.npart_total = h.npart.copy()
    h.time, h.redshift, h.box_size = 0.25, 3.0, 50000.0
    h.omega0, h.omega_lambda, h.hubble_param = 0.3, 0.7, 0.7
    f32 = np.float32
    return mod.SnapshotData(
        header=h, pos=rng.random((n, 3)).astype(f32),
        vel=rng.normal(size=(n, 3)).astype(f32),
        ids=np.arange(1, n + 1, dtype=np.uint32),
        mass=rng.random(n).astype(f32),
        u=rng.random(n_gas).astype(f32) if gas else None,
        rho=rng.random(n_gas).astype(f32) if gas else None,
        hsml=rng.random(n_gas).astype(f32) if gas else None,
        pot=rng.normal(size=n).astype(f32) if pot else None)


def _same(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            np.testing.assert_array_equal(g, w, err_msg=f)
    for f in dataclasses.fields(want.header):
        np.testing.assert_array_equal(getattr(got.header, f.name),
                                      getattr(want.header, f.name),
                                      err_msg=f.name)


@pytest.mark.parametrize("fmt", [1, 2])
@pytest.mark.parametrize("gas,pot", [(True, True), (False, False)])
def test_writer_byte_identical_and_reads_equal(tmp_path, fmt, gas, pot):
    """The copied writer makes the JAX writer's bytes; each reader reads
    the other's file to the same contents."""
    mine = tmp_path / "port.dat"
    theirs = tmp_path / "jax.dat"
    snap.write_snapshot(str(mine), _data(snap, 1, gas=gas, pot=pot), fmt=fmt)
    jsnap.write_snapshot(str(theirs), _data(jsnap, 1, gas=gas, pot=pot),
                         fmt=fmt)
    assert mine.read_bytes() == theirs.read_bytes()
    _same(snap.read_snapshot(str(theirs)), jsnap.read_snapshot(str(theirs)))


def test_big_endian_and_multi_file_sets(tmp_path):
    """A big-endian fmt-2 file reads the same; a set of 3 files is
    byte-identical file by file and reads back equal."""
    be = tmp_path / "be.dat"
    jsnap.write_snapshot(str(be), _data(jsnap, 2), fmt=2, endian=">")
    _same(snap.read_snapshot(str(be)), jsnap.read_snapshot(str(be)))
    snap.write_snapshot_set(str(tmp_path / "p"), _data(snap, 3), 3, fmt=1)
    jsnap.write_snapshot_set(str(tmp_path / "j"), _data(jsnap, 3), 3, fmt=1)
    for i in range(3):
        assert (tmp_path / f"p.{i}").read_bytes() == \
            (tmp_path / f"j.{i}").read_bytes()
    _same(snap.read_snapshot_set(str(tmp_path / "p")),
          jsnap.read_snapshot_set(str(tmp_path / "j")))


@pytest.mark.parametrize("cut", [3, 200, -10])
def test_truncated_file_raises_as_jax(tmp_path, cut):
    """A file cut short raises, the same exception type as the JAX
    reader's, never a short read."""
    full = tmp_path / "full.dat"
    snap.write_snapshot(str(full), _data(snap, 4), fmt=1)
    raw = full.read_bytes()
    short = tmp_path / "short.dat"
    short.write_bytes(raw[:cut])
    with pytest.raises(Exception) as theirs:
        jsnap.read_snapshot(str(short))
    with pytest.raises(type(theirs.value)):
        snap.read_snapshot(str(short))


def test_hdf5_as_jax(tmp_path):
    """Format 3 (HDF5) imports h5py lazily: where it is missing both raise
    the same error; where it is there both read the same contents."""
    try:
        jsnap.write_snapshot(str(tmp_path / "j.hdf5"), _data(jsnap, 5),
                             fmt=3)
    except Exception as exc:   # noqa: BLE001 -- compared with the port's
        with pytest.raises(type(exc)):
            snap.write_snapshot(str(tmp_path / "p.hdf5"), _data(snap, 5),
                                fmt=3)
        return
    snap.write_snapshot(str(tmp_path / "p.hdf5"), _data(snap, 5), fmt=3)
    _same(snap.read_snapshot(str(tmp_path / "p.hdf5")),
          jsnap.read_snapshot(str(tmp_path / "j.hdf5")))


def test_snapshot_from_state_matches_jax(tmp_path):
    """One state carried into both: types in file order, velocities to the
    file convention, u from the entropy at the physical density, the
    potential block. The port takes a in float64 where the JAX package
    takes it in float32: velocities and u within 1e-6 relative."""
    d, jst = _filled_state(6)
    cfg, opts = parse_parameter_text(PARAM), SimOptions(**OPTS)
    got = snapshot_from_state(from_numpy(d, "cpu"), cfg, opts,
                              with_potential=True)
    want = j_snapshot_from_state(jst, j_parse(PARAM),
                                 JOptions(use_pallas="off", **OPTS),
                                 with_potential=True)
    for f in ("pos", "ids", "mass", "rho", "hsml", "pot"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in ("vel", "u"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-6, err_msg=f)
    np.testing.assert_array_equal(got.header.npart, want.header.npart)
    assert got.header.time == pytest.approx(float(want.header.time), 1e-6)
    # and back: the IC arrays of the written file
    snap.write_snapshot(str(tmp_path / "s"), got, fmt=2)
    pos, vel, mass, ptype, u = ic_arrays_from_snapshot(
        snap.read_snapshot(str(tmp_path / "s")), cfg)
    np.testing.assert_array_equal(pos, got.pos.astype(np.float64))
    np.testing.assert_array_equal(ptype, np.repeat(
        np.arange(6), got.header.npart.astype(np.int64)))
    np.testing.assert_array_equal(u, got.u)


def _small_sim(tmp_path):
    """lcdm_gas 2x10^3 under the slice's options, initialised: a resumed
    run's equality bit for bit does not depend on the box's size."""
    cfg = parse_parameter_text(PARAM.replace(
        "OutputDir  /tmp/grid_cache_test", f"OutputDir  {tmp_path}"))
    pos, vel, mass, ptype, u = lcdm_gas_ics(
        n_side=10, box=cfg.box_size, omega0=0.3, omega_b=0.04,
        hubble=cfg.hubble_internal, g=cfg.grav_internal)
    sim = Simulation(cfg, SimOptions(**OPTS), "cpu")
    sim.set_ics(pos, vel, mass, ptype, u=u)
    return sim


def test_restart_resumes_bit_for_bit(tmp_path):
    """k = 2 sync points, a dump, then m = 2 more: a run resumed from the
    dump (restart flag 1) is equal, bit for bit in every field, to the run
    that dumped and went on; the dump itself loads back bit-identical."""
    sim = _small_sim(tmp_path)
    sim.step(2)
    sim.snapshot_count = 3
    sim.write_restart()
    dumped = to_numpy(sim.state)
    back, meta = load_restart(str(tmp_path / "restart"), "cpu")
    assert meta["step_count"] == 2 and meta["snapshot_count"] == 3
    for k, v in to_numpy(back).items():
        assert v.dtype == dumped[k].dtype and np.array_equal(v, dumped[k]), k
    sim.step(2)
    param = tmp_path / "run.param"
    param.write_text(PARAM.replace("OutputDir  /tmp/grid_cache_test",
                                   f"OutputDir  {tmp_path}"))
    resumed = Simulation.from_param_file(str(param), SimOptions(**OPTS),
                                         restart_flag=1, device="cpu")
    assert resumed.step_count == 2 and resumed.snapshot_count == 3
    resumed.step(2)
    want, got = to_numpy(sim.state), to_numpy(resumed.state)
    assert int(got["ti_current"]) > int(dumped["ti_current"])
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_restart_refuses_another_layout(tmp_path):
    """A dump whose field manifest is not the current state layout raises
    with the fields that differ."""
    d, _ = _filled_state(7)
    path = str(tmp_path / "dump")
    save_restart(path, from_numpy(d, "cpu"), step_count=5)
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    assert meta["field_manifest"] == field_manifest()
    meta["field_manifest"] = meta["field_manifest"][:-1] + ["p.spin"]
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="p.spin"):
        load_restart(path, "cpu")


def test_restart_carries_the_sinks(tmp_path):
    """A dump written after accretion and a sink flipped from gas restores
    the sink slots, acc_mass, n_accreted, the flipped type and the dead
    particles exactly, and the resumed disc run (beta cooling, sinks)
    goes on bit for bit like the run that dumped."""
    from gadget_leicester_tpu_torch.models.ics import disc_ics
    from gadget_leicester_tpu_torch.models.sinks import \
        register_sinks_from_types
    from tests.test_config import GASSPHERE_PARAM
    text = GASSPHERE_PARAM.replace("GravityConstantInternal  0",
                                   "GravityConstantInternal  1.0") \
        .replace("./out", str(tmp_path))
    for k, v in dict(SofteningBndry=0.05, SinkAccretionRadius=0.35,
                     MaxSizeTimestep=0.01, CoolingBeta=1.0).items():
        text += f"\n{k} {v}\n"
    param = tmp_path / "disc.param"
    param.write_text(text)
    opts = SimOptions(cooling="beta", sinks=True)
    sim = Simulation(parse_parameter_text(text), opts, "cpu")
    pos, vel, mass, ptype, u = disc_ics(n_gas=200, r_in=0.2)
    sim.set_ics(pos, vel, mass, ptype, u=u)
    sim.state = register_sinks_from_types(sim.state)
    sim.step(6)
    # a second sink, formed in place from a gas particle far out
    p, sinks = sim.state.p, sim.state.sinks
    k = int(p.pos[:200].norm(dim=1).argmax())
    p.ptype[k] = 5
    sinks.slot[1] = k
    sim.write_restart()
    dumped = to_numpy(sim.state)
    assert int(dumped["sinks.n_accreted"].sum()) > 0
    assert (~dumped["p.alive"][:200]).sum() == dumped["sinks.n_accreted"].sum()
    back, _ = load_restart(str(tmp_path / "restart"), "cpu")
    back = to_numpy(back)
    for key in ("sinks.slot", "sinks.acc_mass", "sinks.n_accreted",
                "p.ptype", "p.alive"):
        assert back[key].dtype == dumped[key].dtype, key
        np.testing.assert_array_equal(back[key], dumped[key], err_msg=key)
    assert back["p.ptype"][k] == 5 and back["sinks.slot"][1] == k
    sim.step(3)
    resumed = Simulation.from_param_file(str(param), opts, restart_flag=1,
                                         device="cpu")
    resumed.step(3)
    want, got = to_numpy(sim.state), to_numpy(resumed.state)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
