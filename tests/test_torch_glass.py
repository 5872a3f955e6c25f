"""The glass of the port (``models/glass.py``) against the JAX package on
the CPU: the first relaxation step from the same Poisson start;
tests/test_features.py::test_make_glass's checks on the port's glass,
with the port's ``ops/pm.py::cic_deposit`` in place of the JAX package's
host CIC; and ``--makeglass 8`` through the port's command line in a child
process without jax, its glass.dat read back by the port's reader with the
header the JAX package's reader gives."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.io.snapshot import read_snapshot as j_read
from gadget_leicester_tpu.models.glass import _glass_relax as j_glass_relax
from gadget_leicester_tpu_torch.io.snapshot import read_snapshot
from gadget_leicester_tpu_torch.models.glass import _glass_relax, make_glass
from gadget_leicester_tpu_torch.ops.pm import cic_deposit
from tests.test_config import GASSPHERE_PARAM
from tests.test_torch_cli import cli

N_SIDE = 8


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _density(pos):
    """CIC mass mesh of unit masses on 8^3 cells of the unit box."""
    p = torch.from_numpy(np.ascontiguousarray(pos, np.float32))
    return cic_deposit(p, torch.ones(len(p)), 1.0, N_SIDE).numpy()


def test_first_relaxation_step_matches_jax():
    """One step from the same seeded start: the largest |acc| to 1e-5 of
    itself (float32 FFTs of two libraries), every displacement to 1e-5 of
    the step (0.15 spacings), across the periodic wrap."""
    pos0 = np.random.default_rng(4).uniform(0, 1.0, (N_SIDE ** 3, 3)
                                            ).astype(np.float32)
    step = 0.15 / N_SIDE
    got, g_amax = _glass_relax(torch.from_numpy(pos0), 1.0, 16, 1, step)
    want, w_amax = j_glass_relax(jnp.asarray(pos0), 1.0, 16, 1, step)
    np.testing.assert_allclose(g_amax.numpy(), np.asarray(w_amax),
                               rtol=1e-5)
    d = got.numpy() - np.asarray(want)
    d -= np.round(d)
    assert np.abs(d).max() <= 1e-5 * step
    moved = got.numpy() - pos0
    moved -= np.round(moved)
    assert np.abs(moved).max() > 0.5 * step


def test_make_glass_passes_the_reference_checks():
    """test_make_glass: 512 positions in [0, 1), the residual force below
    half the first, and a CIC density contrast below 0.6 of the Poisson
    start's."""
    pos, amax = make_glass(n_side=N_SIDE, box=1.0, n_steps=40, device="cpu")
    assert pos.shape == (512, 3) and pos.dtype == np.float32
    assert np.all((pos >= 0) & (pos < 1.0))
    assert amax.shape == (40,) and amax[-1] < 0.5 * amax[0]
    poisson = np.random.default_rng(4).uniform(0, 1.0, (512, 3))
    assert _density(pos).std() < 0.6 * _density(poisson).std()


def test_cli_makeglass_writes_a_glass_file(tmp_path):
    """``--makeglass 8`` exits 0 and writes OutputDir/glass.dat: 512 type-1
    particles of mass 1/512 in the unit box (BoxSize 0), ids 1..512, at
    rest; the port's reader gives the header the JAX package's reader
    gives, and the positions pass the uniformity check."""
    out = tmp_path / "out"
    param = tmp_path / "glass.param"
    param.write_text(GASSPHERE_PARAM.replace("OutputDir           ./out",
                                             f"OutputDir           {out}"))
    proc = cli(param, 0, "--device", "cpu", "--makeglass", N_SIDE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"glass written: {out / 'glass.dat'} (N=512" in proc.stdout
    snap = read_snapshot(str(out / "glass.dat"))
    jsnap = j_read(str(out / "glass.dat"))
    for name in ("npart", "npart_total", "mass"):
        assert np.array_equal(getattr(snap.header, name),
                              getattr(jsnap.header, name)), name
    assert snap.header.box_size == jsnap.header.box_size == 1.0
    assert list(snap.header.npart) == [0, 512, 0, 0, 0, 0]
    assert snap.header.mass[1] == pytest.approx(1.0 / 512)
    assert np.array_equal(snap.ids, np.arange(1, 513))
    assert not snap.vel.any()
    np.testing.assert_array_equal(snap.pos, jsnap.pos)
    assert np.all((snap.pos >= 0) & (snap.pos < 1.0))
    poisson = np.random.default_rng(4).uniform(0, 1.0, (512, 3))
    assert _density(snap.pos).std() < 0.6 * _density(poisson).std()
