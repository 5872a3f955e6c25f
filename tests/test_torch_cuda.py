"""Kernels A-D on the card against their plain versions on the same CUDA
tensors: the arguments the path gives each wrapper while it initialises a
2x12^3 box, replayed (marked ``cuda``: they skip where there is no card;
on the H100 run ``python -m pytest tests/test_torch_cuda.py``).
chip_smoke.py runs the same comparison and the main path; these keep it in
the test suite."""

import pytest
import torch

import chip_smoke
from gadget_leicester_tpu_torch import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def recorded():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return chip_smoke.record_init(12, "cuda")


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("name", sorted(chip_smoke.TOL))
def test_kernel_matches_plain_on_card(recorded, name, gated):
    """Per output row, the kernel's distance from the plain version in
    float64 is within TOL of the largest value or F32_FACTOR times the
    float32 plain version's own distance (chip_smoke.TOL states why)."""
    kern, plain = chip_smoke.kernel_pairs()[name]
    cases = chip_smoke.cases(name, recorded[name])
    _, args = cases[-1] if gated else cases[0]
    before = kernels.launches[name]
    got = kern(*args)
    assert kernels.launches[name] == before + 1
    want = plain(*args)
    exact = plain(*chip_smoke.as_float64(args))
    assert kernels.launches[name] == before + 1   # plain launches nothing
    torch.cuda.synchronize()
    *_, used = chip_smoke.compare(name, got, want, exact)
    assert used <= 1.0
