"""Kernels A-G on the card against their plain versions on the same CUDA
tensors (marked ``cuda``: they skip where there is no card; on the H100
run ``python -m pytest --noconftest tests/test_torch_cuda.py``). A-D get
the arguments the path gives each wrapper while it initialises a 2x12^3
box; E-G those of a near-idle sync point of that box
(``chip_smoke.make_near_idle``). chip_smoke.py runs the same comparisons
and the main path; these keep them in the test suite."""

import pytest
import torch

import chip_smoke
from gadget_leicester_tpu_torch import kernels

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")


@pytest.fixture(scope="module")
def recorded():
    _need_card()
    return chip_smoke.record_init(12, "cuda")


@pytest.fixture(scope="module")
def recorded_idle():
    """The wrappers' arguments in a near-idle sync point of the 2x12^3
    box, 3% of its particles active."""
    _need_card()
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg, opts, (pos, vel, mass, ptype, u) = chip_smoke.setup(12)
    sim = Simulation(cfg, opts, "cuda")
    sim.set_ics(pos, vel, mass, ptype, u=u)
    sim.step()
    sim.state = chip_smoke.make_near_idle(sim.state, 0.03, 7)
    with chip_smoke.recorded_inputs() as rec, chip_smoke.tier() as log:
        sim.step()
    assert [took for *_, took in log] == [True, True]
    return dict(rec)


def _check(recorded, name, case):
    """Per output row, the kernel's distance from the plain version in
    float64 is within TOL of the largest value or F32_FACTOR times the
    float32 plain version's own distance (chip_smoke.TOL states why)."""
    kern, plain = chip_smoke.kernel_pairs()[name]
    _, args = chip_smoke.cases(name, recorded)[case]
    before = kernels.launches[name]
    got = kern(*args)
    assert kernels.launches[name] == before + 1
    want = plain(*args)
    exact = plain(*chip_smoke.as_float64(args))
    assert kernels.launches[name] == before + 1   # plain launches nothing
    torch.cuda.synchronize()
    *_, used = chip_smoke.compare(name, got, want, exact)
    assert used <= 1.0


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("name", sorted(chip_smoke.DENSE))
def test_kernel_matches_plain_on_card(recorded, name, gated):
    _check(recorded, name, -1 if gated else 0)


@pytest.mark.parametrize("off", [False, True])
@pytest.mark.parametrize("name", sorted(chip_smoke.ENTRIES))
def test_entry_kernel_matches_plain_on_card(recorded_idle, name, off):
    """All entries, and every other entry switched off (-1)."""
    _check(recorded_idle, name, 1 if off else 0)
