"""Kernels A-M on the card against their plain versions on the same CUDA
tensors (marked ``cuda``: they skip where there is no card; on the H100
run ``python -m pytest --noconftest tests/test_torch_cuda.py``). A-D get
the arguments the path gives each wrapper while it initialises a 2x12^3
box, H those of the full potential of the initialised box; E-G those of a
near-idle sync point of that box (``chip_smoke.make_near_idle``); E's
potential mode and H those of a near-idle sync point of the box with
sinks, through each tier.
I/J and K get those of a 2x12^3 box initialised with
``sph_backend="cells"`` (periodic) and of a vacuum blob, at capacities
128 and 256. L gets those of ``pm_gather_tiles`` on the 2x12^3 box's
mesh stack (3 and 4 components, fresh and drifted positions), M those of
``shortrange_gravity_fresh`` on that box (periodic, truncated) and on a
vacuum blob. C, D, F and G in their absolute mode get those of the vacuum
blob through block SPH on its clamped grid. chip_smoke.py runs the same
comparisons and the main path; these keep them in the test suite."""

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


@pytest.mark.parametrize("gated", [False, True])
def test_potential_kernel_matches_plain_on_card(recorded, gated):
    """Kernel H, all tiles and every other tile gated off."""
    _check(recorded, "shortrange_potential", -1 if gated else 0)


def test_potential_kernel_forces_match_kernel_a(recorded):
    """H's rows 0-2 against kernel A on H's arguments, within A's bound
    (chip_smoke.check_potential_forces raises outside it)."""
    chip_smoke.check_potential_forces(recorded, "n_side=12")


@pytest.fixture(scope="module")
def recorded_sinks():
    """(entries, dense) recordings of a near-idle sync point of the
    2x12^3 box with sinks: E's potential mode, and H on the step's cached
    pack and gated flags."""
    _need_card()
    return chip_smoke.record_idle_sinks("cuda", 12)


@pytest.mark.parametrize("off", [False, True])
def test_potential_entry_kernel_matches_plain_on_card(recorded_sinks, off):
    """E's potential mode: all entries, and every other entry off."""
    _check(recorded_sinks[0], "shortrange_potential_entries", 1 if off else 0)


@pytest.mark.parametrize("gated", [False, True])
def test_potential_kernel_on_step_arguments_matches_plain_on_card(
        recorded_sinks, gated):
    _check(recorded_sinks[1], "shortrange_potential", -1 if gated else 0)


def test_potential_kernel_forces_equal_kernel_a_on_step_arguments(
        recorded_sinks):
    """H's rows 0-2 equal kernel A's bit for bit on the step's arguments
    (chip_smoke.check_step_potential_forces raises otherwise)."""
    chip_smoke.check_step_potential_forces(recorded_sinks[1],
                                           "n_side=12 step")


CELL_CASES = [("periodic", 4, 128), ("periodic", 3, 256),
              ("vacuum", 4, 128), ("vacuum", 3, 256)]


@pytest.fixture(scope="module")
def recorded_cells():
    """{(mode, cells per axis, capacity): the wrappers' arguments} of
    kernels I/J and K."""
    _need_card()
    return {(mode, grid, cap): (
        chip_smoke.record_init(12, "cuda", sph_backend="cells",
                               sph_grid=grid, sph_capacity=cap)
        if mode == "periodic" else
        chip_smoke.record_vacuum_blob("cuda", grid, cap))
        for mode, grid, cap in CELL_CASES}


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("mode,grid,cap", CELL_CASES)
@pytest.mark.parametrize("name", sorted(chip_smoke.CELLS))
def test_cells_kernel_matches_plain_on_card(recorded_cells, name, mode, grid,
                                            cap, case):
    """I/J: all cells, and every other cell gated off; K: with and without
    the Hubble-flow term."""
    _check(recorded_cells[mode, grid, cap], name, case)


def test_cells_backend_needs_a_card_on_cuda_tensors():
    """On CUDA tensors the wrappers launch their kernels: the launch
    counts grow and the plain versions are not what answered."""
    _need_card()
    rec = chip_smoke.record_vacuum_blob("cuda", 4, 128)
    kern, _ = chip_smoke.kernel_pairs()["sph_cells_hydro"]
    before = kernels.launches["sph_cells_hydro"]
    out = kern(*rec["sph_cells_hydro"])
    assert out.is_cuda and kernels.launches["sph_cells_hydro"] == before + 1


@pytest.mark.parametrize("drifted", [False, True])
@pytest.mark.parametrize("k", [3, 4])
def test_gather_kernel_matches_plain_on_card(k, drifted):
    """Kernel L on the small box's mesh stack: ``record_gather_small``
    holds the gathered values to the row gather and raises outside
    ``GATHER_VS_ROWS``; the kernel then against its plain version. The
    drifted case moves 1% of the particles out of every window."""
    _need_card()
    before = kernels.launches["pm_gather"]
    rec = chip_smoke.record_gather_small("cuda", 12, k, drifted)
    assert kernels.launches["pm_gather"] == before + 1
    assert rec["pm_gather"][1].shape[-1] == k
    _check(rec, "pm_gather", 0)


@pytest.mark.parametrize("periodic", [True, False])
def test_gravity_cells_kernel_matches_plain_on_card(periodic):
    """Kernel M: periodic with the TreePM truncation and the per-pair
    minimum image, and on a clamped grid with plain softened gravity."""
    _need_card()
    before = kernels.launches["shortrange_gravity_cells"]
    rec = chip_smoke.record_gravity_cells_small("cuda", 12, periodic)
    assert kernels.launches["shortrange_gravity_cells"] == before + 1
    _check(rec, "shortrange_gravity_cells", 0)


def test_gravity_cells_keeps_the_particle_on_the_box_edge_on_card():
    """A float32 coordinate equal to the box: kernel M's per-pair minimum
    image finds the neighbours across the seam, as the direct sum does."""
    _need_card()
    import numpy as np

    from gadget_leicester_tpu_torch.ops.gravity_direct import direct_gravity
    from gadget_leicester_tpu_torch.ops.gravity_short import \
        shortrange_gravity_fresh
    rng = np.random.default_rng(9)
    box, n = 10.0, 900
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    pos[:3] = [[box, 1.0, 1.0], [0.0, box, 0.5], [box, box, box]]
    args = [torch.as_tensor(a, dtype=torch.float32).cuda() for a in (
        pos, rng.uniform(0.5, 1.5, n), rng.uniform(0.05, 0.3, n))]
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    got, ovf = shortrange_gravity_fresh(*args, alive, box, 3, asmth=0.7,
                                        rcut=3.15)
    want, _ = direct_gravity(*args, alive, box=box, asmth=0.7, rcut=3.15,
                             periodic=True, with_potential=False)
    assert not bool(ovf)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert float(got[:3].abs().amax(-1).min()) > 1e-3 * scale


@pytest.fixture(scope="module")
def recorded_vacuum_blocks():
    """The wrappers' arguments of C, D, F and G in their absolute mode:
    the vacuum blob through block SPH on its clamped grid, the entries on
    a seeded 3% of its gas (chip_smoke.record_vacuum_blocks)."""
    _need_card()
    nb, subcap = chip_smoke.VACUUM_BLOCKS
    return chip_smoke.record_vacuum_blocks(
        "cuda", nb, subcap, *chip_smoke.vacuum_blob("cuda"),
        chip_smoke.VACUUM_IDLE_FRAC)[0]


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("name", sorted(chip_smoke.ABS))
def test_absolute_kernel_matches_plain_on_card(recorded_vacuum_blocks, name,
                                               case):
    """C and D: all tiles, and every other tile gated off; F and G: all
    entries, and every other entry switched off."""
    _check(recorded_vacuum_blocks, name, case)
