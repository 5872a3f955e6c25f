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
comparisons and the main path; these keep them in the test suite. The
last tests build inputs by hand: L at the edges of its positions (mesh
planes, u == n, a coordinate equal to the box, positions far outside the
box or not finite), held to its plain version bit for bit; and at the
edges of the rules by which A culls sources (a warp's box), and C and D
skip source subcells (the boxes of the subcells), in both of C's and D's
modes; the entries kernels F and G at the edges of their chunk walks (the
reach across the periodic wrap, all-parked chunks, switched-off entries,
the Leicester disc's subcells); and B where its slab is tight (slots
beyond their cells by the grid cache's margin and by more than a mesh
cell, the mesh wrap, a slab that takes the whole axis, a mesh side that
is not a multiple of 4, cells too large for any slab). The slab step's
modes (A's slab mode, C's and D's anisotropic mode) get the arguments of
two slab sync points of a 2x16^3 box on a ring of one, a slab frame with
heavy sources at rcut (1 -+ 1e-5) across the y and z seams and beyond the
clamped x faces (3 and 40 cells along x by 34 x 34; with A's slab mode's
layouts: a full cell, a warp across the seam, one or all lanes in the
cut, gated tiles, the vacuum faces), and an anisotropic
block grid with empty trailing x blocks. I/J's and K's ghost-row mode
(the slab step's coarse cells) get the arguments of two such sync points
under ``sph_backend="cells"`` and a slab frame of 4 x 5 x 5 coarse cells
with ghosts, periodic and in vacuum, at capacities 40 and 160."""

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
    assert rec["pm_gather"][0].shape[-1] == k
    _check(rec, "pm_gather", 0)


G_N, G_BOX = 24, 60.0           # kernel L's edge cases: mesh side, box


def _gather_positions(dtype):
    """[N, 3] wrapped positions for kernel L: random, on exact mesh
    planes, on the last plane, at u == n (a coordinate whose product with
    the scale rounds to n) and at a coordinate equal to the box."""
    import numpy as np
    rng = np.random.default_rng(31)
    cell = G_BOX / G_N
    pos = rng.uniform(0, G_BOX, (3000, 3))
    pos[:200] = rng.integers(0, G_N, (200, 3)) * cell
    pos[200:300, 0] = (G_N - 1) * cell
    pos[300:400] = G_BOX
    pos[400:500, 2] = G_BOX
    pos = torch.tensor(pos, dtype=dtype, device="cuda")
    scale = torch.tensor(G_N / G_BOX, dtype=dtype)
    assert bool((pos[300:400].cpu() * scale == G_N).all())
    return pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_gather_kernel_equals_plain_on_card(k, dtype):
    """Kernel L equals its plain version (the row gather) bit for bit for
    K = 1 to 4, at mesh planes, at u == n and at a coordinate equal to the
    box (both read index 0 with frac 0)."""
    _need_card()
    from gadget_leicester_tpu_torch.ops import pm
    gen = torch.Generator(device="cuda").manual_seed(k)
    field = torch.randn(G_N, G_N, G_N, k, generator=gen, device="cuda",
                        dtype=dtype)
    pos = _gather_positions(dtype)
    before = kernels.launches["pm_gather"]
    got = pm.cic_gather_vec(field, pos, G_BOX, G_N)
    assert kernels.launches["pm_gather"] == before + 1
    want = pm.cic_gather_vec_plain(field, pos, G_BOX, G_N)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[300:400], field[0, 0, 0].expand(100, k))


def test_gather_kernel_reads_nothing_out_of_range_on_card():
    """The mesh sits inside a buffer whose cells on either side hold NaN:
    positions far outside the box (a caller that did not wrap them) read
    in range and equal the plain version; positions that are not finite
    fault nothing and touch no other row; through ``pm_gather_tiles`` a
    dead particle with a non-finite position gets 0."""
    _need_card()
    from gadget_leicester_tpu_torch.ops import pm, pm_tiles
    from gadget_leicester_tpu_torch.ops.neighbors import build_cell_list
    k, cells = 3, G_N ** 3
    buf = torch.full((cells * k * 3,), float("nan"), device="cuda")
    field = buf[cells * k:2 * cells * k].view(G_N, G_N, G_N, k)
    field.copy_(torch.randn(G_N, G_N, G_N, k, device="cuda"))
    pos = _gather_positions(torch.float32)
    far = pos[500:700]
    far[:100] -= 1e3 * G_BOX
    far[100:] += 3.5 * G_BOX
    bad = pos[700:706]
    bad.copy_(torch.tensor([[float("nan"), 1.0, 1.0],
                            [float("inf"), 1.0, 1.0],
                            [1.0, float("-inf"), 1.0],
                            [1.0, 1.0, 1e30], [-1e30, 1.0, 1.0],
                            [float("nan")] * 3], device="cuda"))
    got = pm.cic_gather_vec(field, pos, G_BOX, G_N)
    want = pm.cic_gather_vec_plain(field, pos, G_BOX, G_N)
    torch.cuda.synchronize()
    ok = torch.ones(len(pos), dtype=torch.bool, device="cuda")
    ok[700:706] = False
    assert torch.equal(got[ok], want[ok])
    assert bool(torch.isfinite(got[ok]).all())
    # 1e30 and -1e30 lie beyond int64: index 0, frac 0, a value of the mesh
    assert bool(torch.isfinite(got[703:705]).all())
    alive = ok.clone()
    wrapped = torch.remainder(pos, G_BOX)
    wrapped[700:706] = bad
    cl = build_cell_list(torch.where(ok[:, None], wrapped, 0.0), alive,
                         0.0, G_BOX, n_cells=3, capacity=512)
    rows = pm_tiles.pm_gather_tiles(field, cl, wrapped, alive, G_BOX, G_N, 3,
                                    1.0)
    torch.cuda.synchronize()
    assert bool((rows[700:706] == 0).all())
    assert torch.equal(rows[ok], pm.cic_gather_vec_plain(
        field, torch.remainder(wrapped, G_BOX), G_BOX, G_N)[ok])


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


# The culling edges of kernels A and D (csrc/shortrange_gravity.cu,
# csrc/sph_hydro.cu): inputs built by hand where a skipped pair, or a kept
# one, sits at the edge of the rule that skips it. Each case holds the
# kernel to its float64 plain version (chip_smoke.compare); A's rows also
# to kernel H's bit for bit.
A_EDGE, A_N = 10.0, 3            # cell edge and cells per axis
A_RCUT = 0.95 * A_EDGE
A_ASMTH = A_RCUT / 4.5


def _gravity_soa(kind: str, sign: int = 0):
    """A [27, 8, 128] cell-relative pack (rows x, y, z, m, soft, 1,
    1/soft, 0; parked slots at -7 cells, m = 0) of random cells around a
    centre cell 13 built for ``kind``: "corner", 32 live targets (one
    warp) in a small box whose corner target has a heavy source beyond
    the box corner at rcut (1 + sign 1e-6) in the cell (+1, +1, +1);
    "octant", 128 live targets in one octant; "single", one live slot."""
    import numpy as np
    rng = np.random.default_rng({"corner": 11, "octant": 12,
                                 "single": 13}[kind] + sign)
    cap = 128
    soa = np.zeros((A_N ** 3, 8, cap), np.float64)
    soa[:, :3] = -7.0 * A_EDGE

    def fill(c, xyz, m=None):
        k = xyz.shape[0]
        soa[c, :3, :k] = xyz.T
        soa[c, 3, :k] = rng.uniform(0.5, 1.5, k) if m is None else m
        soa[c, 4, :k] = rng.uniform(0.05, 0.3, k)
        soa[c, 5, :k] = 1.0
        soa[c, 6, :k] = 1.0 / soa[c, 4, :k]

    half = A_EDGE / 2
    for c in range(A_N ** 3):
        fill(c, rng.uniform(-half, half, (rng.integers(60, 110), 3)))
    if kind == "corner":
        a = 0.3 * half
        box = rng.uniform(a - 1.5, a, (32, 3))
        box[0] = a                                    # the box's corner
        soa[13] = 0.0
        soa[13, :3] = -7.0 * A_EDGE
        fill(13, box)
        d = A_RCUT * (1.0 + sign * 1e-6) / np.sqrt(3.0)
        src = a + d - A_EDGE                          # in cell (+1, +1, +1)
        c = A_N ** 3 - 1
        k = int((soa[c, 5] > 0).sum())
        soa[c, :3, k] = src
        soa[c, 3, k] = 1e6
        soa[c, 4, k], soa[c, 5, k], soa[c, 6, k] = 0.1, 1.0, 10.0
        f32 = np.float32
        r2 = sum((f32(a) - (f32(src) + f32(A_EDGE))) ** 2 for _ in range(3))
        assert (r2 < f32(A_RCUT) ** 2) == (sign < 0)
    elif kind == "octant":
        fill(13, rng.uniform(0.0, half, (cap, 3)))
    else:
        soa[13] = 0.0
        soa[13, :3] = -7.0 * A_EDGE
        fill(13, rng.uniform(-half, half, (1, 3)))
    return torch.tensor(soa, dtype=torch.float32, device="cuda")


@pytest.mark.parametrize("kind,sign", [("corner", -1), ("corner", 1),
                                       ("octant", 0), ("single", 0)])
def test_gravity_kernel_culling_edges_on_card(kind, sign):
    """Kernel A where its warp-box culling is tight: a source at rcut (1 -
    1e-6) of a warp's corner target must be kept, one at rcut (1 + 1e-6)
    adds nothing; a cell full in one octant; a cell of one live slot."""
    _need_card()
    from gadget_leicester_tpu_torch.ops import cells, gravity_short
    soa = _gravity_soa(kind, sign)
    flags = torch.ones(A_N ** 3, dtype=torch.int32, device="cuda")
    args = (soa, flags, A_N, A_N * A_EDGE, A_ASMTH, A_RCUT)
    got = cells.shortrange_gravity_tiles(*args)
    want = gravity_short.shortrange_gravity_tiles_plain(*args)
    exact = gravity_short.shortrange_gravity_tiles_plain(
        *chip_smoke.as_float64(args))
    torch.cuda.synchronize()
    *_, used = chip_smoke.compare("shortrange_gravity", got, want, exact)
    assert used <= 1.0
    assert torch.equal(cells.shortrange_potential_tiles(*args)[:, :3], got)
    if kind == "corner":
        # the heavy source dominates the corner target's pull (about 100),
        # or adds nothing
        ax = float(exact[13, 0, 0])
        assert (ax > 20.0) == (sign < 0)


def _entries_case(where: str, sign: int):
    """Kernel E's arguments (soa, entry_cell, tgt, n, box, asmth, rcut)
    on a cell-relative [27, 8, 128] pack of random cells: 32 targets of
    cell tc in a small box whose corner target has a heavy source at rcut
    (1 + sign 1e-6) along the diagonal, in the stencil's centre cell
    ("centre": tc = 13, the source in cell 13 along x alone) or across
    the periodic wrap ("wrap": tc = 0, the source in cell 26 at offset
    (-1, -1, -1)), cell 5 all parked; "isolated": one live slot in the
    whole pack. The entries: 8 live lanes of tc (the corner first), the
    corner alone (1 live lane), a padded entry (-1), and one of 8 lanes
    of cell 7. Each target row equals its pack slot."""
    import numpy as np
    rng = np.random.default_rng({"centre": 21, "wrap": 22,
                                 "isolated": 23}[where] + sign)
    cap, half = 128, A_EDGE / 2
    soa = np.zeros((A_N ** 3, 8, cap), np.float64)
    soa[:, :3] = -7.0 * A_EDGE

    def fill(c, xyz, m=None):
        k = xyz.shape[0]
        soa[c, :3, :k] = xyz.T
        soa[c, 3, :k] = rng.uniform(0.5, 1.5, k) if m is None else m
        soa[c, 4, :k] = rng.uniform(0.05, 0.3, k)
        soa[c, 5, :k] = 1.0
        soa[c, 6, :k] = 1.0 / soa[c, 4, :k]

    tc = 0 if where == "wrap" else 13
    if where == "isolated":
        fill(tc, rng.uniform(-half, half, (1, 3)))
    else:
        for c in range(A_N ** 3):
            if c != 5:
                fill(c, rng.uniform(-half, half, (rng.integers(60, 110), 3)))
        soa[tc, :, :] = 0.0
        soa[tc, :3] = -7.0 * A_EDGE
        f32 = np.float32
        if where == "centre":
            a = -half + 0.4                      # the box's +x face
            box = rng.uniform(0.0, 1.0, (32, 3)) * [0.3, 1.5, 1.5] \
                + [a - 0.3, -0.7, -0.7]
            box[0] = [a, 0.0, 0.0]
            src, sc = [a + A_RCUT * (1.0 + sign * 1e-6), 0.0, 0.0], tc
            r2 = (f32(a) - f32(src[0])) ** 2
        else:
            a = -0.3 * half                      # the box's low corner
            box = rng.uniform(a, a + 1.5, (32, 3))
            box[0] = a
            d = A_RCUT * (1.0 + sign * 1e-6) / np.sqrt(3.0)
            src, sc = [a - d + A_EDGE] * 3, A_N ** 3 - 1
            r2 = sum((f32(a) - (f32(src[0]) - f32(A_EDGE))) ** 2
                     for _ in range(3))
        assert (r2 < f32(A_RCUT) ** 2) == (sign < 0)
        fill(tc, box)
        k = int((soa[sc, 5] > 0).sum())
        soa[sc, :3, k] = src
        soa[sc, 3, k] = 1e6
        soa[sc, 4, k], soa[sc, 5, k], soa[sc, 6, k] = 0.1, 1.0, 10.0
    lanes = 8
    ec = np.array([tc, tc, -1, 7], np.int32)
    slots = [list(range(8)), [0], [], list(range(8))]
    if where == "isolated":
        ec[[0, 3]] = [tc, -1]
        slots = [[0], [0], [], []]
    tgt = np.zeros((len(ec), 8, lanes))
    for e, (c, sl) in enumerate(zip(ec, slots)):
        for lane, k in enumerate(sl):
            tgt[e, :, lane] = soa[c, :, k]
    dev = "cuda"
    return (torch.tensor(soa, dtype=torch.float32, device=dev),
            torch.tensor(ec, device=dev),
            torch.tensor(tgt, dtype=torch.float32, device=dev), A_N,
            A_N * A_EDGE, A_ASMTH, A_RCUT)


@pytest.mark.parametrize("with_potential", [False, True])
@pytest.mark.parametrize("where,sign", [("centre", -1), ("centre", 1),
                                        ("wrap", -1), ("wrap", 1),
                                        ("isolated", 0)])
def test_entries_gravity_kernel_culling_edges_on_card(where, sign,
                                                      with_potential):
    """Kernel E (either mode) where its culling against the box of an
    entry's live lanes is tight: a source at rcut (1 - 1e-6) of the
    corner lane is kept, one at rcut (1 + 1e-6) adds nothing, in the
    stencil's centre cell and across the periodic wrap; entries of 8 live
    lanes and of 1; a stencil cell all parked; padded entries, and every
    other entry switched off; the isolated target (zero force and
    potential). Each case within E's bound of its float64 plain
    version."""
    _need_card()
    from gadget_leicester_tpu_torch.ops import cells, gravity_short
    name = ("shortrange_potential_entries" if with_potential
            else "shortrange_gravity_entries")
    args = _entries_case(where, sign)
    off = torch.where(torch.arange(4, device="cuda") % 2 == 1, -1,
                      args[1]).to(torch.int32)
    for ec in (args[1], off):
        a = args[:1] + (ec,) + args[2:]
        got = cells.shortrange_gravity_entries(*a, with_potential)
        want = gravity_short.shortrange_gravity_entries_plain(
            *a, with_potential)
        exact = gravity_short.shortrange_gravity_entries_plain(
            *chip_smoke.as_float64(a), with_potential)
        torch.cuda.synchronize()
        *_, used = chip_smoke.compare(name, got, want, exact)
        assert used <= 1.0
        assert not bool(got[ec < 0].any())            # padded or off
        assert not bool(got[1, :, 1:].any())          # dead lanes
        if where == "isolated":
            assert not bool(got.any())
        elif ec is args[1]:
            # the heavy source's share of the corner lane's pull, in the
            # 8-lane and the 1-lane entry alike: large, or nothing
            a64 = chip_smoke.as_float64(a)
            light = a64[0].clone()
            c, k = torch.nonzero(light[:, 3] == 1e6, as_tuple=True)
            light[c, 3, k] = 0.0
            share = exact - gravity_short.shortrange_gravity_entries_plain(
                light, *a64[1:], with_potential)
            for e in (0, 1):
                assert (abs(float(share[e, 0, 0])) > 20.0) == (sign < 0)
            # each lane adds the earlier design's terms in its order, less
            # only those that add nothing: the corner lane's sums do not
            # depend on the other lanes of its entry
            assert torch.equal(got[0, :, 0], got[1, :, 0])


def _fresh_case(kind: str, sign: int):
    """Kernel M's arguments from ``shortrange_gravity_fresh``: "seam", a
    periodic box of 30 on 3^3 cells of 256 slots, 32 targets of cell (2,
    1, 1) in a small box whose corner (29.7, 12, 12) has a heavy source
    at rcut (1 + sign 1e-6) along the diagonal across x = box, random
    particles in the other cells and 200 in cell (0, 0, 0) (two passes
    of 128 targets); "blob", the vacuum blob on a clamped 4^3 grid with
    asmth = 0 and rcut = 1e30."""
    import numpy as np

    from gadget_leicester_tpu_torch.ops.gravity_short import \
        shortrange_gravity_fresh
    if kind == "blob":
        rng = np.random.default_rng(5)
        x = rng.normal(size=(3000, 3))
        x *= (rng.uniform(size=3000) ** (1 / 3)
              / np.linalg.norm(x, axis=1))[:, None]
        pos, box, n_cells = 0.5 + 0.45 * x, 1.0, 4
        mass = rng.uniform(0.5, 1.5, 3000) / 3000
        soft = rng.uniform(0.01, 0.05, 3000)
        asmth, rcut, periodic = 0.0, 1e30, False
        corner_at = None
    else:
        rng = np.random.default_rng(31 + sign)
        box, n_cells, edge = 30.0, 3, 10.0
        rcut, asmth, periodic = 0.95 * edge, 0.95 * edge / 4.5, True
        bg = rng.uniform(0.0, box, (2400, 3))
        cell = np.floor(bg / edge).astype(int)
        # cell (2, 1, 1) holds the targets alone, cell (0, 0, 0) the clump
        bg = bg[~(cell == [2, 1, 1]).all(1) & ~(cell == 0).all(1)]
        clump = rng.uniform(0.5, 9.5, (200, 3))
        corner = np.array([29.7, 12.0, 12.0])
        tg = corner - rng.uniform(0.0, 1.5, (32, 3))
        tg[0] = corner
        d = rcut * (1.0 + sign * 1e-6) / np.sqrt(3.0)
        src = corner + d
        src[0] -= box
        f32 = np.float32
        dx = [f32(corner[a]) - f32(src[a]) for a in range(3)]
        dx[0] = dx[0] - f32(box) * np.round(dx[0] * (f32(1.0) / f32(box)))
        r = np.sqrt(sum(f32(v) ** 2 for v in dx))
        assert (r < rcut) == (sign < 0)
        pos = np.concatenate([bg, clump, tg, src[None]])
        corner_at = len(bg) + len(clump)
        n = len(pos)
        mass = rng.uniform(0.5, 1.5, n)
        mass[-1] = 1e6
        soft = rng.uniform(0.05, 0.3, n)
        soft[-1] = 0.1

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device="cuda")

    alive = torch.ones(len(pos), dtype=torch.bool, device="cuda")
    with chip_smoke.recorded_inputs() as rec:
        acc, ovf = shortrange_gravity_fresh(
            t(pos), t(mass), t(soft), alive, box, n_cells, capacity=256,
            asmth=asmth, rcut=rcut, periodic=periodic)
    assert not bool(ovf) and bool(torch.isfinite(acc).all())
    return rec["shortrange_gravity_cells"], acc, corner_at


@pytest.mark.parametrize("kind,sign", [("seam", -1), ("seam", 1),
                                       ("blob", 0)])
def test_gravity_cells_kernel_culling_edges_on_card(kind, sign):
    """Kernel M where its torus-aware warp-box culling is tight: a source
    at rcut (1 - 1e-6) of a warp's corner target across the periodic seam
    is kept, one at rcut (1 + 1e-6) adds nothing; a cell of 200 live
    slots (two passes of 128 targets); the clamped blob with asmth = 0
    and rcut = 1e30, where nothing may be culled or turn NaN. Each case
    within M's bound of its float64 plain version."""
    _need_card()
    from gadget_leicester_tpu_torch.ops import cells, gravity_short
    args, acc, corner_at = _fresh_case(kind, sign)
    got = cells.shortrange_gravity_cells(*args)
    want = gravity_short.shortrange_gravity_cells_plain(*args)
    exact = gravity_short.shortrange_gravity_cells_plain(
        *chip_smoke.as_float64(args))
    torch.cuda.synchronize()
    *_, used = chip_smoke.compare("shortrange_gravity_cells", got, want,
                                  exact)
    assert used <= 1.0
    if kind == "seam":
        assert int((args[0][:, 5] > 0).sum(1).max()) > 128
        # the heavy source dominates the corner target's pull towards +x,
        # or adds nothing
        ax = float(acc[corner_at, 0])
        assert (ax > 20.0) == (sign < 0)


D_NB, D_LF = 3, 1.0              # blocks per axis, fine-cell edge


def _gas_layout(periodic: bool, subcap: int):
    """Gas binned at x0 and packed at x = x0 + d, |d|_inf <= kappa Lf, h
    up to (1 - 2 kappa) Lf: a random background, and pairs at h = (1 - 2
    kappa) Lf displaced by kappa Lf towards each other across one
    fine-cell boundary ("kept", on a periodic grid also across the seam)
    or across the fine cell between theirs ("zero": r = h + 2^-18 Lf),
    each pair at least 1.2 Lf from other gas; and isolated pairs at h (1
    -+ 1e-6) across the corner of two diagonal fine cells ("edge_in",
    "edge_out"). On a clamped grid some background gas is binned beyond
    its edge. Returns (x0, x, h, {label: particle indices}, the generator
    that made them)."""
    import numpy as np

    from gadget_leicester_tpu_torch.models.grids import KAPPA_SPH
    rng = np.random.default_rng(subcap + (0 if periodic else 1))
    box = 2 * D_NB * D_LF
    kap, hcap = KAPPA_SPH * D_LF, (1.0 - 2.0 * KAPPA_SPH) * D_LF
    eps = 2.0 ** -18
    x0, x, h = [], [], []
    pairs = {"kept": [], "zero": [], "edge_in": [], "edge_out": []}

    def add(label, p0, p):
        pairs[label].append(len(x0))
        x0.append(tuple(p0))
        x.append(tuple(p))
        h.append(hcap)

    def pair(label, a0, b0, y, z):
        for p0, d in ((a0, kap), (b0, -kap)):
            add(label, (p0, y, z), (p0 + d, y, z))

    def diagonal(label, corner, sign):
        # across the corner of two diagonal fine cells, r = h (1 + sign
        # 1e-6): the edge of the warps' box test
        a = np.asarray(corner) - 0.2
        b = a + hcap * (1.0 + sign * 1e-6) / np.sqrt(3.0)
        add(label, a, a)
        add(label, b, b)

    pair("kept", 3.0 - 0.02, 3.0 + 0.02, 1.5, 1.5)
    pair("zero", 2.0 - eps, 3.0, 4.5, 4.5)
    pair("zero", 4.0 - eps, 5.0, 1.5, 4.5)
    if periodic:
        pair("kept", box - 0.02, 0.02, 4.5, 1.5)
    else:
        pair("kept", 1.0 - 0.02, 1.0 + 0.02, 4.5, 1.5)
    diagonal("edge_in", (4.0, 3.0, 3.0), -1)
    diagonal("edge_out", (2.0, 3.0, 5.0), 1)
    keep_out = np.array(x)
    bg = rng.uniform(0.0, box, (216 * 14, 3))
    if not periodic:
        bg[:40, 0] = rng.uniform(-0.4, 0.0, 40)    # clamped into cell 0
    d = bg[:, None] - keep_out[None]
    if periodic:
        d -= box * np.round(d / box)
    far = np.sqrt((d ** 2).sum(-1)).min(1)
    bg = bg[far > 1.2 + kap * np.sqrt(3.0)]
    for p0 in bg:
        x0.append(tuple(p0))
        x.append(tuple(p0 + rng.uniform(-kap, kap, 3)))
        h.append(hcap if rng.uniform() < 0.1 else rng.uniform(0.5, 1.0) * hcap)
    x0, x = np.array(x0), np.array(x)
    if periodic:
        x = np.mod(x, box)
    return x0, x, np.array(h), pairs, rng


def _hydro_args(periodic: bool, subcap: int):
    """Kernel D's arguments (either mode) for the gas of
    :func:`_gas_layout`. Returns (arguments, gslot, {label: particle
    indices})."""
    import numpy as np

    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    x0, x, h, pairs, rng = _gas_layout(periodic, subcap)
    box = 2 * D_NB * D_LF
    n = len(x0)
    dev = "cuda"

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    mask = torch.ones(n, dtype=torch.bool, device=dev)
    cls = sb.build_block_lists(t(x0), mask, 0.0, box, D_NB, subcap,
                               periodic=periodic)
    assert not bool(cls[0].overflow)
    rho = t(rng.uniform(0.5, 2.0, n))
    packs = sb.pack_hydro_blocks(
        cls, t(x), t(rng.normal(0.0, 1.0, (n, 3))), t(rng.uniform(
            0.5, 1.5, n)), t(h), rho, 0.05 * rho ** (5.0 / 3.0),
        t(rng.uniform(0.8, 1.2, n)), t(rng.normal(0.0, 1.0, n)),
        t(rng.uniform(0.0, 1.0, n)), mask, box, 0.1, 1.0)
    args = packs + (D_NB, D_LF if periodic else None, 0.8)
    return args, cls[0].gslot, pairs


@pytest.mark.parametrize("subcap", [32, 64, 40])
@pytest.mark.parametrize("periodic", [True, False])
def test_hydro_kernel_skip_edges_on_card(periodic, subcap):
    """Kernel D's subcell skip where the caller's invariants put a pair
    at its edge, and its warps' box test at r = h (1 -+ 1e-6), in both modes, with a warp one
    subcell (32), half a subcell (64) and across two (40): the kept pairs
    pull, the pairs one fine cell apart give exactly zero, the pair just
    inside h has its signal velocity, the pair just outside nothing, and
    every row agrees with the float64 plain version."""
    _need_card()
    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    args, gslot, pairs = _hydro_args(periodic, subcap)
    name = "sph_hydro" if periodic else "sph_hydro_abs"
    before = kernels.launches[name]
    got = sb.hydro_sums_blocks(*args)
    assert kernels.launches[name] == before + 1
    want = sb.hydro_sums_blocks_plain(*args)
    exact = sb.hydro_sums_blocks_plain(*chip_smoke.as_float64(args))
    torch.cuda.synchronize()
    *_, used = chip_smoke.compare(name, got, want, exact)
    assert used <= 1.0
    rows = got.transpose(1, 2).reshape(-1, 5)
    idx = torch.tensor(pairs["kept"], device="cuda").long()
    assert bool((rows[gslot[idx].long(), 0].abs() > 0).all())
    idx = torch.tensor(pairs["zero"], device="cuda").long()
    assert bool((rows[gslot[idx].long()] == 0).all())
    # r = h (1 - 1e-6): inside, so it sets the signal velocity; r = h (1 +
    # 1e-6): nothing
    idx = torch.tensor(pairs["edge_in"], device="cuda").long()
    assert bool((rows[gslot[idx].long(), 4] > 0).all())
    idx = torch.tensor(pairs["edge_out"], device="cuda").long()
    assert bool((rows[gslot[idx].long()] == 0).all())


@pytest.mark.parametrize("periodic", [True, False])
def test_hydro_kernel_keeps_a_source_with_h_above_the_cap_on_card(periodic):
    """A partly active pass in which an inactive source keeps an h above
    (1 - 2 kappa) Lf, as the stored h of inactive gas may on a vacuum grid
    re-fitted since their last density pass: the only neighbour of an
    active target is that source, two fine cells away (within the 4^3
    window of the target's block) inside its h. Kernel
    D must add the pair, agree with its float64 plain version, and agree
    with kernel G (the entries twin) on the active gas."""
    _need_card()
    import numpy as np

    from gadget_leicester_tpu_torch.models.grids import KAPPA_SPH
    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    from gadget_leicester_tpu_torch.ops.cells import (ENTRY_LANES,
                                                      build_active_entries)
    rng = np.random.default_rng(11 if periodic else 12)
    box = 2 * D_NB * D_LF
    hcap = (1.0 - 2.0 * KAPPA_SPH) * D_LF
    # fine cells 0 and 2 on x: both in the target's 4^3 window
    target, source = np.array([0.5, 1.5, 1.5]), np.array([2.5, 1.5, 1.5])
    bg = rng.uniform(0.0, box, (216 * 12, 3))
    bg = bg[np.sqrt(((bg - target) ** 2).sum(-1)) > 1.05 * hcap]
    x = np.concatenate([target[None], source[None], bg])
    h = np.concatenate([[0.5 * hcap, 2.5 * D_LF],
                        rng.uniform(0.5, 1.0, len(bg)) * hcap])
    n = len(x)
    active_np = rng.uniform(size=n) < 0.1
    active_np[:2] = (True, False)
    dev = "cuda"

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    mask = torch.ones(n, dtype=torch.bool, device=dev)
    active = torch.tensor(active_np, device=dev)
    cls = sb.build_block_lists(t(x), mask, 0.0, box, D_NB, 32,
                               periodic=periodic)
    assert not bool(cls[0].overflow)
    rho = t(rng.uniform(0.5, 2.0, n))
    fields = (t(x), t(rng.normal(0.0, 1.0, (n, 3))),
              t(rng.uniform(0.5, 1.5, n)), t(h), rho,
              0.05 * rho ** (5.0 / 3.0), t(rng.uniform(0.8, 1.2, n)),
              t(rng.normal(0.0, 1.0, n)), t(rng.uniform(0.0, 1.0, n)), mask)
    packs = sb.pack_hydro_blocks(cls, *fields, box, 0.1, 1.0, active=active)
    args = packs + (D_NB, D_LF if periodic else None, 0.8)
    name = "sph_hydro" if periodic else "sph_hydro_abs"
    before = kernels.launches[name]
    got = sb.hydro_sums_blocks(*args)
    assert kernels.launches[name] == before + 1
    want = sb.hydro_sums_blocks_plain(*args)
    exact = sb.hydro_sums_blocks_plain(*chip_smoke.as_float64(args))
    torch.cuda.synchronize()
    *_, used = chip_smoke.compare(name, got, want, exact)
    assert used <= 1.0
    rows = got.transpose(1, 2).reshape(-1, 5)
    slot = cls[0].gslot[0].long()
    assert float(rows[slot, 0]) != 0.0 and float(rows[slot, 4]) > 0.0
    # kernel G on the active entries
    kw = dict(visc_const=0.8, box=box, hubble_a2_flow=0.1,
              hubble_a2_norm=1.0, fac_mu=1.0)
    dense = sb.hydro_force_blocks(cls, *fields, active=active, **kw)
    entry_blk, entry_slot = build_active_entries(cls[0], active, ENTRY_LANES,
                                                 2 * D_NB ** 3)[:2]
    entries = sb.hydro_force_blocks_entries(cls, *fields, entry_blk,
                                            entry_slot, **kw)
    a_d, a_g = dense.acc[active], entries.acc[active]
    scale = float(a_d.abs().max())
    assert float((a_d - a_g).abs().max()) <= 1e-5 * scale
    assert float(dense.max_signal_vel[0]) == float(entries.max_signal_vel[0])


# Kernel C (csrc/sph_density.cu) at the edges of its subcell skip and warp
# box, whose reach is the target's h alone; in relative mode the parked
# lanes (m = 0) are summed too, with the h the caller gives them
C_PARKED_H = 9.5 * D_LF   # reaches real gas from -7 fine cells


def _density_args(x0, x, h, periodic: bool, subcap: int, rng):
    """Kernel C's arguments (either mode) for gas binned at ``x0`` and
    packed at ``x`` with smoothing lengths ``h``, as the Newton loop's
    first sweep passes them: valid slots their h, invalid ones
    ``C_PARKED_H`` in relative mode and 0 in absolute mode. Returns
    (arguments, gslot)."""
    import numpy as np

    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    box = 2 * D_NB * D_LF
    n = len(x0)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device="cuda")

    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    cls = sb.build_block_lists(t(x0), mask, 0.0, box, D_NB, subcap,
                               periodic=periodic)
    assert not bool(cls[0].overflow)
    lf = D_LF if periodic else None
    vel, mass = t(rng.normal(0.0, 1.0, (n, 3))), t(rng.uniform(0.5, 1.5, n))
    ones = torch.ones(n, device="cuda")
    soa_e, soa_o = (sb.pack_sph_soa(cl, t(x), vel, mass, ones, mask,
                                    sb._centers(cl, parity, lf), box)
                    for cl, parity in zip(cls, ("even", "odd")))
    cells = cls[0].cells
    h_slots = torch.where(cells >= 0, t(h)[cells.clamp_min(0).long()],
                          torch.tensor(C_PARKED_H if periodic else 0.0,
                                       device="cuda"))
    flags = torch.ones(D_NB ** 3, dtype=torch.int32, device="cuda")
    return (soa_e, soa_o, h_slots.contiguous(), flags, D_NB, lf), \
        cls[0].gslot


def _density_check(args):
    """Kernel C on ``args`` against its float64 plain version; returns
    its output [B, 6, lanes]."""
    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    name = "sph_density" if args[-1] is not None else "sph_density_abs"
    before = kernels.launches[name]
    got = sb.density_sums_blocks(*args)
    assert kernels.launches[name] == before + 1
    want = sb.density_sums_blocks_plain(*args)
    exact = sb.density_sums_blocks_plain(*chip_smoke.as_float64(args))
    torch.cuda.synchronize()
    *_, used = chip_smoke.compare(name, got, want, exact)
    assert used <= 1.0
    return got, want, exact


@pytest.mark.parametrize("subcap", [32, 64, 40])
@pytest.mark.parametrize("periodic", [True, False])
def test_density_kernel_culling_edges_on_card(periodic, subcap):
    """Kernel C on the gas of D's skip-edge test, in both modes, with a
    warp one subcell (32), half a subcell (64) and across two (40): every
    row agrees with the float64 plain version; the kept pairs add to each
    other's div v, the pairs across the fine cell between them (r = h +
    2^-18 Lf) and at r = h (1 + 1e-6) across a diagonal corner add
    nothing (div v and rot v exactly 0: the self-pair adds none), the
    pair at r = h (1 - 1e-6) adds; relative mode: the parked lanes, given
    an h that reaches the gas, sum as the plain version does; absolute
    mode: they and the lanes with h = 0 write zeros."""
    _need_card()
    x0, x, h, pairs, rng = _gas_layout(periodic, subcap)
    args, gslot = _density_args(x0, x, h, periodic, subcap, rng)
    got, want, exact = _density_check(args)
    rows = got.transpose(1, 2).reshape(-1, 6)

    def sel(label):
        return gslot[torch.tensor(pairs[label], device="cuda").long()].long()

    assert bool((rows[sel("kept"), 2] != 0).all())
    for label in ("zero", "edge_out"):
        assert bool((rows[sel(label), 2:] == 0).all())
    assert bool((rows[sel("edge_in"), 2] != 0).all())
    soa_e, h_slots = args[0], args[2]
    parked = (soa_e[:, 3] == 0)[:, None, :].expand_as(got)
    if periodic:
        # the parked rows against the float64 plain version, and some of
        # them reach gas
        p_got, p_want, p_exact = (o.transpose(1, 2)[parked.transpose(1, 2)]
                                  .view(-1, 6) for o in (got, want, exact))
        *_, used = chip_smoke.compare("sph_density", p_got, p_want, p_exact)
        assert used <= 1.0 and bool((p_got[:, 0] > 0).any())
    else:
        assert bool((got[parked] == 0).all())
        # the Newton loop's later sweeps pass h = 0 for solved slots
        h0 = h_slots.clone()
        h0[:, 1::2] = 0.0
        again = _density_check(args[:2] + (h0,) + args[3:])[0]
        assert bool((again.transpose(1, 2)[h0 == 0] == 0).all())


@pytest.mark.parametrize("periodic", [True, False])
def test_density_kernel_reaches_two_fine_cells_above_the_cap_on_card(
        periodic):
    """A target with h = 2.5 Lf, above the (1 - 2 kappa) Lf cap, whose
    only neighbour is a source two fine cells away (within the 4^3 window
    of its block) inside its h: kernel C adds the pair (div v not 0) and
    agrees with its float64 plain version, in both modes."""
    _need_card()
    import numpy as np

    from gadget_leicester_tpu_torch.models.grids import KAPPA_SPH
    rng = np.random.default_rng(21 if periodic else 22)
    box = 2 * D_NB * D_LF
    hcap = (1.0 - 2.0 * KAPPA_SPH) * D_LF
    target, source = np.array([0.5, 1.5, 1.5]), np.array([2.5, 1.5, 1.5])
    bg = rng.uniform(0.0, box, (216 * 12, 3))
    d = bg - target
    if periodic:
        d -= box * np.round(d / box)
    bg = bg[np.sqrt((d ** 2).sum(-1)) > 2.6 * D_LF]
    x = np.concatenate([target[None], source[None], bg])
    h = np.concatenate([[2.5 * D_LF, 0.5 * hcap],
                        rng.uniform(0.5, 1.0, len(bg)) * hcap])
    args, gslot = _density_args(x, x, h, periodic, 32, rng)
    got = _density_check(args)[0]
    rows = got.transpose(1, 2).reshape(-1, 6)
    assert float(rows[gslot[0].long(), 2]) != 0.0


# Kernel H (csrc/shortrange_gravity.cu with the potential row, kPot): A's
# walk on a cell of more than 128 live slots (two passes of 128 targets),
# a source just inside or outside rcut across the periodic wrap, and an
# isolated particle. Each case holds H to its float64 plain version and
# its rows 0-2 to kernel A bit for bit.
H_BOX, H_N, H_SOFT = 1.0, 5, 0.02    # cell edge 0.2
H_ASMTH, H_RCUT = 0.04, 0.18


def _potential_check(pos, mass, alive, cap):
    """Kernels H and A on the relative pack of ``pos`` (numpy, float64)
    over an H_N^3 list of ``cap`` slots: H against its float64 plain
    version, its rows 0-2 against A bit for bit. Returns (H's rows [N, 4]
    by particle, the float64 plain version's, the pack)."""
    from gadget_leicester_tpu_torch.ops import cells, gravity_short
    from gadget_leicester_tpu_torch.ops.neighbors import (build_cell_list,
                                                          merge_rows)
    t = [torch.tensor(a, device="cuda") for a in (
        pos.astype("float32"), mass.astype("float32"),
        (0 * mass + H_SOFT).astype("float32"), alive)]
    cl = build_cell_list(t[0], t[3], 0.0, H_BOX, H_N, cap)
    assert not bool(cl.overflow)
    soa = cells.pack_cells_soa(cl, *t)
    flags = torch.ones(H_N ** 3, dtype=torch.int32, device="cuda")
    args = (soa, flags, H_N, H_BOX, H_ASMTH, H_RCUT)
    before = kernels.launches["shortrange_potential"]
    got = cells.shortrange_potential_tiles(*args)
    assert kernels.launches["shortrange_potential"] == before + 1
    want = gravity_short.shortrange_potential_tiles_plain(*args)
    exact = gravity_short.shortrange_potential_tiles_plain(
        *chip_smoke.as_float64(args))
    torch.cuda.synchronize()
    *_, used = chip_smoke.compare("shortrange_potential", got, want, exact)
    assert used <= 1.0
    assert torch.equal(got[:, :3], cells.shortrange_gravity_tiles(*args))
    return merge_rows(got, cl, 4), merge_rows(exact, cl, 4), soa


def test_potential_kernel_two_passes_of_targets_on_card():
    """A clump puts more than 128 live slots in one cell of a 256-slot
    list: H ranks and sums each pass of 128 targets on its own."""
    _need_card()
    import numpy as np
    rng = np.random.default_rng(31)
    pos = rng.random((1400, 3))
    pos[:160] = 0.08 + 0.12 * rng.random((160, 3))    # in cell 0
    pos[-40:, 0] = rng.random(40) * 0.01              # at x = 0
    alive = np.ones(1400, bool)
    alive[-7:] = False
    _, _, soa = _potential_check(pos, rng.random(1400) + 0.5, alive, 256)
    assert int((soa[:, 5] > 0).sum(1).max()) > 128


@pytest.mark.parametrize("sign", [-1, 1])
def test_potential_kernel_source_across_the_wrap_on_card(sign):
    """A heavy source at rcut (1 + sign 1e-4) from a target, across the
    periodic wrap in x, the rest of the gas beyond 1.2 rcut of the
    target: inside, the source's pull and potential make the target's
    row; outside, the row is 0 bit for bit."""
    _need_card()
    import numpy as np
    rng = np.random.default_rng(32 + sign)
    target = np.array([0.01, 0.5, 0.5])
    source = target - [H_RCUT * (1.0 + sign * 1e-4), 0.0, 0.0]
    source[0] += H_BOX
    bg = rng.random((600, 3))
    d = bg - target
    d -= H_BOX * np.round(d / H_BOX)
    bg = bg[np.sqrt((d ** 2).sum(1)) > 1.2 * H_RCUT]
    pos = np.concatenate([target[None], source[None], bg])
    mass = np.concatenate([[1.0, 1e4], 0.5 + rng.random(len(bg))])
    rows, exact, _ = _potential_check(pos, mass, np.ones(len(pos), bool), 128)
    if sign < 0:   # pulled towards -x; erfc(2.25) ~ 1.5e-3 of -m / r
        assert float(exact[0, 0]) < -1e3 and float(exact[0, 3]) < -10.0
        assert float(rows[0, 0]) < -1e3 and float(rows[0, 3]) < -10.0
    else:
        assert not bool(rows[0].any())


@pytest.mark.parametrize("x", [0.5, 0.0, 0.9999])
def test_potential_kernel_isolated_particle_on_card(x):
    """The self-pair (grav_pot(0, h) = -2.8/h) adds nothing on the card
    either: a lone live particle's row is 0 bit for bit, in the cell
    interior and at either side of the periodic wrap."""
    _need_card()
    import numpy as np
    pos = np.array([[x, 0.31, 0.77], [0.2, 0.7, 0.2]])
    rows, _, _ = _potential_check(pos, np.array([2.0, 1.0]),
                                  np.array([True, False]), 8)
    assert not bool(rows[0].any())


# Kernel I/J (csrc/sph_cells_density.cu) at the edges of its chunk skip
# and warp boxes, in periodic and vacuum modes: coordinates equal to the
# box in float32, h at the cell edge (the cap), a cell whose live targets
# all lie in one warp with parked lanes around them, live targets with h
# = 0. Each case holds the kernel to its float64 plain version.
IJ_BOX, IJ_N = 3.0, 3                # cell edge 1


def _cells_density_args(case: str, periodic: bool):
    """Kernel I/J's arguments for seeded gas built for ``case``, on an
    IJ_N^3 list of 128 slots over [0, IJ_BOX)."""
    import numpy as np

    from gadget_leicester_tpu_torch.ops import sph_cells as sc
    from gadget_leicester_tpu_torch.ops.neighbors import build_cell_list
    rng = np.random.default_rng(["box_edge", "h_edge", "one_warp",
                                 "h_zero"].index(case) + 10 * periodic)
    pos = rng.uniform(0.0, IJ_BOX, (1200, 3))
    if case == "one_warp":
        # 20 gas in cell (1, 1, 1), whose other 108 slots stay parked
        inner = np.all((pos >= 1.0) & (pos < 2.0), axis=1)
        pos = np.concatenate([pos[~inner], rng.uniform(1.2, 1.8, (20, 3))])
    if case == "box_edge":
        pos[:3] = [[IJ_BOX, 1.0, 1.0], [0.0, IJ_BOX, 0.5],
                   [IJ_BOX, IJ_BOX, IJ_BOX]]
    n = len(pos)
    h = rng.uniform(0.3, 0.6, n)
    if case == "h_edge":
        h[::2] = IJ_BOX / IJ_N
    if case == "h_zero":
        h[::7] = 0.0

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device="cuda")

    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    cl = build_cell_list(t(pos), mask, 0.0, IJ_BOX, IJ_N, 128, periodic)
    assert not bool(cl.overflow)
    soa = sc.pack_sph_soa(cl, t(pos), t(rng.normal(0.0, 1.0, (n, 3))),
                          t(rng.uniform(0.5, 1.5, n)), t(np.ones(n)), mask,
                          IJ_BOX)
    cells = cl.cells
    h_slots = torch.where(cells >= 0, t(h)[cells.clamp_min(0).long()],
                          torch.ones((), device="cuda"))
    flags = torch.ones(IJ_N ** 3, dtype=torch.int32, device="cuda")
    return (soa, h_slots.contiguous(), flags, IJ_N, IJ_BOX, periodic), cl


@pytest.mark.parametrize("case", ["box_edge", "h_edge", "one_warp",
                                  "h_zero"])
@pytest.mark.parametrize("periodic", [True, False])
def test_cells_density_kernel_edges_on_card(periodic, case):
    """Kernel I/J against its float64 plain version; parked slots and live
    targets with h = 0 write zeros; the gas at the box edge and in the
    one-warp cell has its neighbours (div v not 0)."""
    _need_card()
    from gadget_leicester_tpu_torch.ops import sph_cells as sc
    from gadget_leicester_tpu_torch.ops.neighbors import merge_rows
    args, cl = _cells_density_args(case, periodic)
    before = kernels.launches["sph_cells_density"]
    got = sc.density_sums_cells(*args)
    assert kernels.launches["sph_cells_density"] == before + 1
    want = sc.density_sums_cells_plain(*args)
    exact = sc.density_sums_cells_plain(*chip_smoke.as_float64(args))
    torch.cuda.synchronize()
    *_, used = chip_smoke.compare("sph_cells_density", got, want, exact)
    assert used <= 1.0
    soa, h_slots = args[0], args[1]
    assert bool((got.transpose(1, 2)[soa[:, 3] == 0] == 0).all())
    rows = merge_rows(got, cl, 6)
    if case == "h_zero":
        assert bool((got.transpose(1, 2)[h_slots == 0] == 0).all())
        assert bool((rows[0::7] == 0).all()) and bool((rows[1] != 0).any())
    elif case == "box_edge":
        assert bool((rows[:3, 2] != 0).all()) and bool((rows[:3, 0] > 0).all())
    elif case == "one_warp":
        assert int((soa[13, 3] > 0).sum()) == 20
        assert bool((rows[-20:, 2] != 0).all())


# Kernels K and F at the edges of their culling (csrc/sph_cells_hydro.cu,
# csrc/sph_density_entries.cu): a source at max(h_i, h_j) (1 -+ 1e-5) from
# a warp's box across the periodic wrap in both signs, more than 128 live
# slots in a cell, an isolated particle; F in both modes, with entries
# switched off (-1), chunks that are all parked and the disc's 4,096-slot
# subcells. Each case holds the kernel to its float64 plain version. These
# tests do not hold K and F to their earlier designs, which the tree no
# longer holds: that bit equality (both builds with -fmad=false) is checked
# only by building an earlier commit's kernel sources beside these on the
# card and comparing the outputs with torch.equal.
EDGE = 1e-5


def _cuda(a):
    import numpy as np
    return torch.tensor(np.asarray(a), dtype=torch.float32, device="cuda")


def _cells_hydro_check(pos, h, periodic: bool, cap: int, seed: int):
    """Kernel K on seeded gas at ``pos`` with smoothing lengths ``h`` on
    an IJ_N^3 list of ``cap`` slots over [0, IJ_BOX), against its float64
    plain version; parked slots write zeros. Returns (its rows per
    particle [N, 5], the pack)."""
    import numpy as np

    from gadget_leicester_tpu_torch.ops import sph_cells as sc
    from gadget_leicester_tpu_torch.ops.neighbors import (build_cell_list,
                                                          merge_rows)
    rng = np.random.default_rng(seed)
    n = len(pos)
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    cl = build_cell_list(_cuda(pos), mask, 0.0, IJ_BOX, IJ_N, cap, periodic)
    assert not bool(cl.overflow)
    rho = _cuda(rng.uniform(0.8, 1.2, n))
    soa16 = sc.pack_hydro_cells(
        cl, _cuda(pos), _cuda(rng.normal(0.0, 1.0, (n, 3))),
        _cuda(rng.uniform(0.5, 1.5, n) / n), _cuda(h), rho,
        0.5 * rho ** (5.0 / 3.0), _cuda(rng.uniform(0.9, 1.1, n)),
        _cuda(rng.normal(size=n)), _cuda(rng.uniform(0.0, 1.0, n)), mask,
        torch.tensor(0.9, device="cuda"), IJ_BOX)
    args = (soa16, _cuda([0.1, 0.9]), IJ_N, IJ_BOX, periodic, 0.8)
    before = kernels.launches["sph_cells_hydro"]
    got = sc.hydro_sums_cells(*args)
    assert kernels.launches["sph_cells_hydro"] == before + 1
    want = sc.hydro_sums_cells_plain(*args)
    exact = sc.hydro_sums_cells_plain(*chip_smoke.as_float64(args))
    torch.cuda.synchronize()
    *_, used = chip_smoke.compare("sph_cells_hydro", got, want, exact)
    assert used <= 1.0
    assert bool((got.transpose(1, 2)[soa16[:, 12] == 0] == 0).all())
    return merge_rows(got, cl, 5), soa16


@pytest.mark.parametrize("sign", [-1, 1])
def test_cells_hydro_kernel_culling_edges_on_card(sign):
    """Kernel K on four pairs across the periodic wrap (the source below x
    = 0, sign -1, or above x = IJ_BOX, sign 1), each alone in its cells:
    at max(h_i, h_j) (1 - 1e-5) apart, which add, and (1 + 1e-5), which
    add nothing, with the reach from the source's h (chunk and source
    reach) and from the target's. Both particles of a pair inside have a
    force and a signal velocity; those of a pair outside write zeros."""
    _need_card()
    lo, hi = 0.3, 0.6
    layout = [(0.5, 0.5, True, (lo, hi)), (1.5, 0.5, False, (lo, hi)),
              (2.5, 0.5, True, (hi, lo)), (0.5, 1.5, False, (hi, lo))]
    pos, h = [], []
    for y, z, inside, (ht, hs) in layout:
        d = max(ht, hs) * (1.0 - EDGE if inside else 1.0 + EDGE)
        xt = 0.05 if sign < 0 else IJ_BOX - 0.05
        pos += [[xt, y, z], [(xt + sign * d) % IJ_BOX, y, z]]
        h += [ht, hs]
    rows, _ = _cells_hydro_check(pos, h, True, 128, 30 + sign)
    for i, (*_, inside, _) in enumerate(layout):
        pair = rows[2 * i:2 * i + 2]
        if inside:
            assert bool((pair[:, 0] != 0).all()) and bool((pair[:, 4] > 0).all())
        else:
            assert bool((pair == 0).all())


def test_cells_hydro_kernel_above_128_live_slots_on_card():
    """Kernel K on a cell of more than 128 live slots (two blocks of 128
    targets ranked apart), cap 256: every clump particle has neighbours
    (a signal velocity)."""
    _need_card()
    import numpy as np
    rng = np.random.default_rng(41)
    pos = np.concatenate([rng.uniform(0.0, IJ_BOX, (800, 3)),
                          rng.uniform(1.1, 1.9, (200, 3))])
    rows, soa16 = _cells_hydro_check(pos, rng.uniform(0.2, 0.45, 1000), True,
                                     256, 41)
    assert int((soa16[:, 12] > 0).sum(1).max()) > 128
    assert bool((rows[800:, 4] > 0).all())


@pytest.mark.parametrize("periodic", [True, False])
def test_cells_hydro_kernel_isolated_particle_on_card(periodic):
    """Two particles 0.9 apart with h = 0.3 have zero force and zero
    signal velocity (the self-pair adds nothing); a pair 0.2 apart
    interacts."""
    _need_card()
    pos = [[0.5, 0.5, 0.5], [1.4, 0.5, 0.5], [2.2, 2.2, 2.2],
           [2.4, 2.2, 2.2]]
    rows, _ = _cells_hydro_check(pos, [0.3] * 4, periodic, 128, 7)
    assert bool((rows[:2] == 0).all())
    assert bool((rows[2:, 0] != 0).all()) and bool((rows[2:, 4] > 0).all())


def _entries_check(pos, h, active, periodic: bool, subcap: int, seed: int,
                   nb: int = 2, box: float = 2.0):
    """Kernel F on the entries of the ``active`` gas at ``pos`` (smoothing
    lengths ``h``) on an nb^3 block grid of ``subcap`` slots a subcell
    over [0, box), periodic (relative mode) or clamped (absolute), against
    its float64 plain version; switched-off entries and dead lanes write
    zeros. Returns (its output [K, 6, 8], the lanes' particles [K, 8],
    their validity, the arguments)."""
    import numpy as np

    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    from gadget_leicester_tpu_torch.ops.cells import (ENTRY_LANES,
                                                      build_active_entries,
                                                      entry_particles)
    rng = np.random.default_rng(seed)
    n = len(pos)
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    p = _cuda(pos)
    cls = sb.build_block_lists(p, mask, 0.0, box, nb, subcap,
                               periodic=periodic)
    assert not bool(cls[0].overflow)
    lf = box / (2 * nb) if periodic else None
    vel, mass = _cuda(rng.normal(0.0, 1.0, (n, 3))), _cuda(
        rng.uniform(0.5, 1.5, n) / n)
    ones = torch.ones(n, device="cuda")
    ec, es, total = build_active_entries(
        cls[0], torch.tensor(np.asarray(active), device="cuda"), ENTRY_LANES,
        2 * nb ** 3)
    assert int(total) <= 2 * nb ** 3 and bool((ec < 0).any())
    soa_o = sb.pack_sph_soa(cls[1], p, vel, mass, ones, mask,
                            sb._centers(cls[1], "odd", lf), box)
    pidx, valid = entry_particles(cls[0], ec, es, mask)
    tgt = sb._sph_rows(cls[0], pidx, valid, sb._entry_centers(cls[0], ec, lf),
                       box, p, vel, mass, ones).transpose(1, 2).contiguous()
    hl = torch.where(valid, _cuda(h)[pidx.clamp_min(0).long()],
                     torch.zeros((), device="cuda")).contiguous()
    args = (soa_o, tgt, hl, ec, nb, lf)
    name = "sph_density_entries" if periodic else "sph_density_entries_abs"
    before = kernels.launches[name]
    got = sb.density_sums_blocks_entries(*args)
    assert kernels.launches[name] == before + 1
    want = sb.density_sums_blocks_entries_plain(*args)
    exact = sb.density_sums_blocks_entries_plain(*chip_smoke.as_float64(args))
    torch.cuda.synchronize()
    *_, used = chip_smoke.compare(name, got, want, exact)
    assert used <= 1.0
    assert bool((got[ec < 0] == 0).all())
    assert bool((got.transpose(1, 2)[~valid] == 0).all())
    return got, pidx, valid, args


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("periodic", [True, False])
def test_entries_density_kernel_culling_edges_on_card(periodic, sign):
    """Kernel F, both modes, on four active targets, each with one source
    at h (1 - 1e-5), which adds, or h (1 + 1e-5), which adds nothing:
    across the periodic wrap (relative mode; the source below x = 0, sign
    -1, or above x = 2, sign 1) or inside the clamped grid (absolute mode),
    on 2^3 blocks of 64 slots a subcell, whose chunks of slots 32-63 are
    all parked; the padded entries are switched off (-1). A target with
    its source inside has div v; one without has only its own self-pair
    (rho > 0, div v and rot v 0)."""
    _need_card()
    import numpy as np
    ht = 0.4
    layout = [(0.25, 0.25, True), (1.25, 0.25, False), (0.25, 1.25, True),
              (1.25, 1.25, False)]
    pos, h = [], []
    for y, z, inside in layout:
        d = ht * (1.0 - EDGE if inside else 1.0 + EDGE)
        if periodic:
            xt = 0.05 if sign < 0 else 1.95
            xs = (xt + sign * d) % 2.0
        else:
            xt = 0.7 if sign < 0 else 1.3
            xs = xt + sign * d
        pos += [[xt, y, z], [xs, y, z]]
        h += [ht, 0.3]
    active = np.arange(len(pos)) % 2 == 0
    got, pidx, valid, args = _entries_check(pos, h, active, periodic, 64,
                                            50 + sign + 2 * periodic)
    soa_o = args[0]
    assert not bool((soa_o[:, 3].reshape(soa_o.shape[0], -1, 32) > 0)
                    .any(-1).all())
    rows = got.transpose(1, 2)[valid]                         # [targets, 6]
    who = pidx[valid].long() // 2
    for i, (*_, inside) in enumerate(layout):
        r = rows[who == i]
        assert r.shape[0] == 1 and float(r[0, 0]) > 0
        if inside:
            assert float(r[0, 2]) != 0.0
        else:
            assert bool((r[0, 2:] == 0).all())


def test_entries_density_kernel_on_disc_subcells_on_card():
    """Kernel F in absolute mode on the Leicester disc's geometry: 2^3
    blocks of 4,096 slots a subcell (262,144 source slots an entry, most
    of them parked), a dense clump at the centre in a sparse cloud, 1% of
    the gas active: every live lane has its density."""
    _need_card()
    import numpy as np
    rng = np.random.default_rng(5)
    pos = np.concatenate([rng.uniform(0.0, 2.0, (3000, 3)),
                          rng.normal(1.0, 0.1, (3000, 3)).clip(0.01, 1.99)])
    h = np.where(np.arange(6000) < 3000, 0.3, 0.08)
    active = rng.uniform(size=6000) < 0.01
    got, _, valid, args = _entries_check(pos, h, active, False, 4096, 5)
    assert args[0].shape[2] == 8 * 4096
    assert bool((got[:, 0][valid] > 0).all())


def _entries_hydro_check(pos, h, active, periodic: bool, subcap: int,
                         seed: int, nb: int = 2, box: float = 2.0):
    """Kernel G on the entries of the ``active`` gas at ``pos`` (smoothing
    lengths ``h``) on an nb^3 block grid of ``subcap`` slots a subcell
    over [0, box), periodic (relative mode) or clamped (absolute), with
    seeded gas fields, against its float64 plain version, with all entries
    on and with every other one switched off; switched-off entries and
    dead lanes write zeros. Returns (its output [K, 5, 8] with all
    entries on, the lanes' particles [K, 8], their validity, the
    arguments)."""
    import numpy as np

    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    from gadget_leicester_tpu_torch.ops.cells import (ENTRY_LANES,
                                                      build_active_entries,
                                                      entry_particles)
    rng = np.random.default_rng(seed)
    n = len(pos)
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    p = _cuda(pos)
    cls = sb.build_block_lists(p, mask, 0.0, box, nb, subcap,
                               periodic=periodic)
    assert not bool(cls[0].overflow)
    ec, es, total = build_active_entries(
        cls[0], torch.tensor(np.asarray(active), device="cuda"), ENTRY_LANES,
        2 * nb ** 3)
    assert int(total) <= 2 * nb ** 3 and bool((ec < 0).any())
    rho = _cuda(rng.uniform(0.5, 2.0, n))
    name = "sph_hydro_entries" if periodic else "sph_hydro_entries_abs"
    with chip_smoke.recorded_inputs() as rec:
        sb.hydro_force_blocks_entries(
            cls, p, _cuda(rng.normal(0.0, 1.0, (n, 3))),
            _cuda(rng.uniform(0.5, 1.5, n) / n), _cuda(h), rho,
            0.05 * rho ** (5.0 / 3.0), _cuda(rng.uniform(0.8, 1.2, n)),
            _cuda(rng.normal(0.0, 1.0, n)), _cuda(rng.uniform(0.0, 1.0, n)),
            mask, ec, es, 0.8, box, 0.1, 1.0, 1.0)
    args = rec[name]
    pidx, valid = entry_particles(cls[0], ec, es, mask)
    outs = []
    for _, case in chip_smoke.cases(name, {name: args}):
        before = kernels.launches[name]
        got = sb.hydro_sums_blocks_entries(*case)
        assert kernels.launches[name] == before + 1
        want = sb.hydro_sums_blocks_entries_plain(*case)
        exact = sb.hydro_sums_blocks_entries_plain(
            *chip_smoke.as_float64(case))
        torch.cuda.synchronize()
        *_, used = chip_smoke.compare(name, got, want, exact)
        assert used <= 1.0
        blk = case[4]
        assert bool((got[blk < 0] == 0).all())
        assert bool((got.transpose(1, 2)[~valid] == 0).all())
        outs.append(got)
    return outs[0], pidx, valid, args


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("periodic", [True, False])
def test_entries_hydro_kernel_culling_edges_on_card(periodic, sign):
    """Kernel G, both modes, on four active targets, each with one
    inactive source at r = (1 - 1e-5) of the larger h, which adds, or (1 +
    1e-5), which adds nothing: across the periodic wrap (relative mode;
    the source below x = 0, sign -1, or above x = 2, sign 1) or inside the
    clamped grid (absolute mode). Two targets reach by the source's h (h_j
    0.4 against h_i 0.1: the reach of hydro, not of the target's h), two
    by their own (0.4 against 0.1); on 2^3 blocks of 64 slots a subcell,
    whose chunks of slots 32-63 are all parked; the padded entries and,
    in a second case, every other entry switched off. A target with its
    source inside has a force and a signal velocity; one without, zeros."""
    _need_card()
    import numpy as np
    layout = [(0.25, 0.25, True, "source"), (1.25, 0.25, False, "source"),
              (0.25, 1.25, True, "target"), (1.25, 1.25, False, "target")]
    pos, h = [], []
    for y, z, inside, reach in layout:
        d = 0.4 * (1.0 - EDGE if inside else 1.0 + EDGE)
        if periodic:
            xt = 0.05 if sign < 0 else 1.95
            xs = (xt + sign * d) % 2.0
        else:
            xt = 0.7 if sign < 0 else 1.3
            xs = xt + sign * d
        pos += [[xt, y, z], [xs, y, z]]
        h += [0.1, 0.4] if reach == "source" else [0.4, 0.1]
    active = np.arange(len(pos)) % 2 == 0
    got, pidx, valid, args = _entries_hydro_check(
        pos, h, active, periodic, 64, 60 + sign + 2 * periodic)
    src16 = args[2]
    assert not bool((src16[:, 12].reshape(src16.shape[0], -1, 32) > 0)
                    .any(-1).all())
    rows = got.transpose(1, 2)[valid]                         # [targets, 5]
    who = pidx[valid].long() // 2
    for i, (*_, inside, _) in enumerate(layout):
        r = rows[who == i]
        assert r.shape[0] == 1
        if inside:
            assert float(r[0, 4]) > 0 and float(r[0, 0]) != 0.0
        else:
            assert bool((r[0] == 0).all())


def test_entries_hydro_kernel_on_disc_subcells_on_card():
    """Kernel G in absolute mode on the Leicester disc's geometry: 2^3
    blocks of 4,096 slots a subcell (262,144 source slots an entry, most
    of them parked), a dense clump at the centre in a sparse cloud, 1% of
    the gas active: every live lane has its signal velocity."""
    _need_card()
    import numpy as np
    rng = np.random.default_rng(7)
    pos = np.concatenate([rng.uniform(0.0, 2.0, (3000, 3)),
                          rng.normal(1.0, 0.1, (3000, 3)).clip(0.01, 1.99)])
    h = np.where(np.arange(6000) < 3000, 0.3, 0.08)
    active = rng.uniform(size=6000) < 0.01
    got, _, valid, args = _entries_hydro_check(pos, h, active, False, 4096, 7)
    assert args[2].shape[2] == 8 * 4096
    assert bool((got[:, 4][valid] > 0).all())


@pytest.mark.parametrize("n_cells,n_pm,n,stale", [
    (34, 192, 200_000, 0.45), (34, 192, 200_000, 1.5), (3, 16, 5000, 0.5),
    (3, 4, 5000, 0.5), (5, 22, 5000, 0.5), (5, 256, 5000, 0.5)])
def test_deposit_kernel_matches_plain_on_card(n_cells, n_pm, n, stale):
    """Kernel B against its float64 plain version (chip_smoke.compare, per
    plane of the mesh), on a pack built at positions then moved by up to
    ``stale`` mesh cells per axis: the 2x128^3 geometry (34^3 cells on a
    192 mesh) with slots up to the grid cache's margin (0.45 mesh cells)
    beyond their cells, and staler than a mesh cell (corners outside the
    block's slab, added straight into the mesh); a small box (3^3 cells
    on a 16 mesh); a mesh of 4 cells a side, whose slab takes the whole
    axis; a mesh side that is not a multiple of 4 (no vector flush); cells
    of 51 mesh cells (no slab fits: every slot straight into the mesh). Particles sit on the mesh wrap (a coordinate
    equal to the box, u just below n_pm); the mesh keeps the alive mass."""
    _need_card()
    import numpy as np

    from gadget_leicester_tpu_torch.ops import pm_tiles
    from gadget_leicester_tpu_torch.ops.cells import pack_cells_soa
    from gadget_leicester_tpu_torch.ops.neighbors import build_cell_list
    box = 100.0
    rng = np.random.default_rng(n_pm + n_cells)
    pos = rng.uniform(0.0, box, (n, 3))
    alive = rng.uniform(size=n) > 0.05
    mass = rng.uniform(0.5, 2.0, n)
    now = pos + rng.uniform(-stale, stale, (n, 3)) * (box / n_pm)
    now[:3] = [[box, 0.5 * box, 0.5 * box], [0.0, box, box],
               [box * (1 - 1e-7), 1.0, box]]
    pos[:3] = np.mod(now[:3], box)
    alive[:3] = True
    cap = 128 * -(-int(2.0 * n / n_cells ** 3) // 128)
    cl = build_cell_list(_cuda(pos), torch.tensor(alive, device="cuda"),
                         0.0, box, n_cells, cap)
    assert not bool(cl.overflow)
    m = _cuda(mass)
    soa = pack_cells_soa(cl, _cuda(now), m, torch.ones_like(m),
                         torch.tensor(alive, device="cuda"))
    args = (soa, n_cells, box, n_pm)
    before = kernels.launches["pm_deposit"]
    got = pm_tiles.pm_deposit_tiles(*args)
    assert kernels.launches["pm_deposit"] == before + 1
    want = pm_tiles.pm_deposit_tiles_plain(*args)
    exact = pm_tiles.pm_deposit_tiles_plain(*chip_smoke.as_float64(args))
    torch.cuda.synchronize()
    *_, used = chip_smoke.compare("pm_deposit", got, want, exact)
    assert used <= 1.0
    total = float(np.where(alive, mass.astype(np.float32), 0.0).sum())
    assert abs(float(got.double().sum()) - total) <= 1e-5 * total


# --------------------------------------------------------------------------
# the slab step's modes: A's slab mode, C's and D's anisotropic mode
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def recorded_slab():
    """The wrappers' arguments in two slab sync points of the 2x16^3 box on
    a ring of one (``Simulation(..., mesh=1)``, NCCL), and A's slab mode
    with the potential in two more with sinks (the in-step potential)."""
    _need_card()
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg, opts, (pos, vel, mass, ptype, u) = chip_smoke.setup(16)
    sim = Simulation(cfg, opts, "cuda", mesh=1)
    sim.set_ics(pos, vel, mass, ptype, u=u)
    with chip_smoke.recorded_inputs() as rec:
        sim.step(2)
    assert int(sim.state.overflow_flags) == 0
    out = dict(rec)
    sim.opts = sim._spmd_step.opts = opts.replace(sinks=True)
    sim._spmd_step.want_pot = True
    with chip_smoke.recorded_inputs() as rec:
        sim.step(2)
    out.update(rec)
    return out


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("name", chip_smoke.SLAB)
def test_slab_modes_on_the_path_on_card(recorded_slab, name, case):
    """Each mode on the arguments the slab step gave it, all tiles and
    every other tile gated off (an inactive tile writes zeros)."""
    _check(recorded_slab, name, case)


@pytest.fixture(scope="module")
def recorded_slab_cells():
    """The wrappers' arguments in two slab sync points of the 2x16^3 box
    under ``sph_backend="cells"`` on a ring of one (NCCL): I/J's and K's
    ghost-row mode."""
    _need_card()
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    cfg, opts, (pos, vel, mass, ptype, u) = chip_smoke.setup(
        16, sph_backend="cells")
    sim = Simulation(cfg, opts, "cuda", mesh=1)
    sim.set_ics(pos, vel, mass, ptype, u=u)
    with chip_smoke.recorded_inputs() as rec:
        sim.step(2)
    assert int(sim.state.overflow_flags) == 0
    return dict(rec)


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("name", chip_smoke.SLAB_CELLS)
def test_slab_cells_modes_on_the_path_on_card(recorded_slab_cells, name,
                                              case):
    """Each ghost-row mode on the arguments the slab step gave it, on the
    cells that hold a target and on every other one of them (a cell
    flagged off writes zeros)."""
    _check(recorded_slab_cells, name, case)


def _slab_cells_case(periodic: bool, cap: int, seed: int):
    """A slab frame as the slab step builds it: targets in [1, 3) x [0,
    5)^2 (one on the face at float32 x == 3, one at y == 5 on a periodic
    box), ghosts in the strips [0, 1) and [3, 4), a grid of 4 x 5 x 5
    cells of edge 1 clamped in x (and in y and z in vacuum), ``cap`` slots
    a cell; each mode's arguments with the cells that hold a target
    flagged, the list, and the target-cell flags."""
    import numpy as np

    from gadget_leicester_tpu_torch.ops import sph_cells as sc
    from gadget_leicester_tpu_torch.ops.neighbors import build_cell_list
    rng = np.random.default_rng(seed)
    nt, ng = 900, 360
    tgt = np.column_stack([rng.uniform(1.0, 3.0, nt),
                           rng.uniform(0.0, 5.0, (nt, 2))])
    tgt[0, 0] = 3.0
    if periodic:
        tgt[1, 1] = 5.0
    gx = np.where(rng.uniform(size=ng) < 0.5, rng.uniform(0.0, 1.0, ng),
                  rng.uniform(3.0, 4.0, ng))
    ghost = np.column_stack([gx, rng.uniform(0.0, 5.0, (ng, 2))])
    n = nt + ng
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    mask[nt - 3:nt] = False
    pos = _cuda(np.concatenate([tgt, ghost]))
    per = (False, periodic, periodic)
    n3 = (4, 5, 5)
    cl = build_cell_list(pos, mask, _cuda([0.0, 0.0, 0.0]),
                         _cuda([4.0, 5.0, 5.0]), n3, cap, per)
    assert not bool(cl.overflow)
    vel, mass = _cuda(rng.normal(size=(n, 3))), _cuda(rng.uniform(0.5, 1.5,
                                                                  n) / n)
    h = _cuda(rng.uniform(0.4, 1.0, n))
    idx = cl.cells.clamp_min(0).long()
    flags = ((cl.cells >= 0) & mask[idx] & (idx < nt)).any(1).to(torch.int32)
    soa = sc.pack_sph_soa(cl, pos, vel, mass, torch.ones_like(mass), mask,
                          5.0)
    h_slots = torch.where(cl.cells >= 0, h[idx], torch.ones_like(h[idx]))
    dens = (soa, h_slots.contiguous(), flags, n3, 5.0, per)
    rho = _cuda(rng.uniform(0.8, 1.2, n))
    soa16 = sc.pack_hydro_cells(
        cl, pos, vel, mass, h, rho, 0.5 * rho ** (5.0 / 3.0),
        _cuda(rng.uniform(0.9, 1.1, n)), _cuda(rng.normal(size=n)),
        _cuda(rng.uniform(0.0, 1.0, n)), mask,
        torch.tensor(0.9, device="cuda"), 5.0)
    hyd = (soa16, _cuda([0.1, 0.9]), n3, 5.0, per, 0.8, flags)
    return dens, hyd, cl, flags


@pytest.mark.parametrize("cap", [40, 160])
@pytest.mark.parametrize("periodic", [True, False])
def test_slab_cells_kernels_edges_on_card(periodic, cap):
    """I/J's and K's ghost-row mode against their float64 plain versions
    on a slab frame: a capacity that is no multiple of 32 (40, the slab
    step's formula rounds to 8) and one of two thread blocks a cell (160),
    nx != ny, a target on the face x == x1, parked slots at -7 cells on
    the clamped axis; a cell that holds ghosts alone writes zeros, and the
    target on the face has its neighbours."""
    _need_card()
    from gadget_leicester_tpu_torch.ops import sph_cells as sc
    from gadget_leicester_tpu_torch.ops.neighbors import merge_rows
    dens, hyd, cl, flags = _slab_cells_case(periodic, cap, cap + periodic)
    off = flags == 0
    assert bool(off.any())
    for name, fn, plain, args in (
            ("sph_cells_density_slab", sc.density_sums_cells,
             sc.density_sums_cells_plain, dens),
            ("sph_cells_hydro_slab", sc.hydro_sums_cells,
             sc.hydro_sums_cells_plain, hyd)):
        before = kernels.launches[name]
        got = fn(*args, ghost_rows=True)
        assert kernels.launches[name] == before + 1
        want = plain(*args)
        exact = plain(*chip_smoke.as_float64(args))
        torch.cuda.synchronize()
        *_, used = chip_smoke.compare(name, got, want, exact)
        assert used <= 1.0, name
        assert not bool(got[off].any()), name
        rows = merge_rows(got, cl, got.shape[1])
        assert bool((rows[0] != 0).all()), name


SLAB_BOX, SLAB_NYZ, SLAB_RCUT = 34.0, 34, 0.95
# the layouts of A's slab-mode edge cases beside the heavy pairs across the
# seams and faces (every layout keeps them): "seams" those alone; "full"
# one cell holding 384 live slots (the slab grid's capacity after its
# first raise, 12 chunks of 32 ranks); "straddle" a cell whose slots lie
# at y = 0, y = box (float32, filed in cell 0) and either side of the y
# seam, so that its warps' boxes span the wrap; "lanes" a tight clump of
# 64 (every lane of a batch inside the cut) and a row of 32 targets with a
# clump of sources within the cut of its last one alone (one lane of a
# batch); "gated" the full cell switched off while its slots stay sources,
# with every third tile; "faces" sources and targets on the grid's six
# faces and beyond the clamped x faces (image mask 0)
SLAB_LAYOUTS = ("seams", "full", "straddle", "lanes", "gated", "faces")
SLAB_FULL_CELL = (1, 5, 5)


def _slab_gravity_case(nx: int, sign: int, layout: str = "seams"):
    """A slab frame of ``nx`` clamped cells of edge 1 along x (the slab
    [rcut, nx - rcut), its ghost strips one cell wide where nx = 3) by
    34 x 34 periodic cells of a box of 34: a light background reaching
    0.2 beyond the clamped faces, and heavy sources at rcut (1 + sign
    1e-5) of a target across the y seam, across the z seam and beyond
    each clamped face; about a fifth of the tiles gated off; and the
    particles of ``layout`` (:data:`SLAB_LAYOUTS`). Returns the wrapper's
    arguments (periodic in y and z; clamped on every axis for "faces"),
    the cell list and the targets' rows."""
    import numpy as np

    from gadget_leicester_tpu_torch.ops.cells import (grav_tile_flags,
                                                      pack_cells_abs)
    from gadget_leicester_tpu_torch.ops.neighbors import build_cell_list
    rng = np.random.default_rng(nx * 2 + (sign > 0)
                                + 10 * SLAB_LAYOUTS.index(layout))
    box, rc = SLAB_BOX, SLAB_RCUT
    ext = float(nx)
    r = rc * (1.0 + sign * 1e-5)
    n_bg = 4000 if nx > 3 else 1500
    pts = np.stack([rng.uniform(-0.2, ext + 0.2, n_bg),
                    rng.uniform(0, box, n_bg), rng.uniform(0, box, n_bg)], 1)
    cap = 128
    full = np.asarray(SLAB_FULL_CELL, float)
    if layout in ("full", "gated"):
        cap = 384
        inside = np.all(np.floor(pts) == full, axis=1)
        pts = np.concatenate([pts[~inside],
                              full + rng.uniform(0, 1, (cap, 3))])
    extra = np.zeros((0, 3))
    if layout == "straddle":
        y = np.concatenate([np.full(8, box), np.zeros(8),
                            box - rng.uniform(0, 0.3, 16),
                            rng.uniform(0, 0.3, 16)])
        extra = np.stack([1.5 + rng.uniform(-0.4, 0.4, 48), y,
                          11.5 + rng.uniform(-0.4, 0.4, 48)], 1)
    elif layout == "lanes":
        clump = np.asarray([1.5, 17.5, 17.5]) + rng.uniform(-0.05, 0.05,
                                                            (64, 3))
        row = np.stack([1.05 + 0.03 * np.arange(32), np.full(32, 25.5),
                        np.full(32, 25.5)], 1)
        far = np.asarray([1.05 + 0.03 * 31 + 0.94, 25.5, 25.5]) \
            + rng.uniform(-1e-3, 1e-3, (40, 3))
        extra = np.concatenate([clump, row, far])
    elif layout == "faces":
        k = 12
        u = rng.uniform(0.5, box - 0.5, (6, k, 2))
        extra = np.concatenate([
            np.stack([np.full(k, -0.2), u[0, :, 0], u[0, :, 1]], 1),
            np.stack([np.full(k, ext + 0.2), u[1, :, 0], u[1, :, 1]], 1),
            np.stack([ext * u[2, :, 0] / box, np.zeros(k), u[2, :, 1]], 1),
            np.stack([ext * u[3, :, 0] / box, np.full(k, box), u[3, :, 1]],
                     1),
            np.stack([ext * u[4, :, 0] / box, u[4, :, 1], np.zeros(k)], 1),
            np.stack([ext * u[5, :, 0] / box, u[5, :, 1], np.full(k, box)],
                     1)])
    pts = np.concatenate([pts, extra])
    mass = list(np.ones(len(pts)))
    targets, planted = [], []
    for t, s in (((1.5, 0.3, 7.0), (1.5, 0.3 - r + box, 7.0)),
                 ((1.5, 9.0, box - 0.2), (1.5, 9.0, r - 0.2)),
                 ((0.5 * rc, 15.0, 15.0), (0.5 * rc - r, 15.0, 15.0)),
                 ((ext - 0.5 * rc, 21.0, 21.0),
                  (ext - 0.5 * rc + r, 21.0, 21.0))):
        targets.append(len(mass) + len(planted))
        planted += [t, s]
    pts = np.concatenate([pts, np.asarray(planted)]).astype(np.float32)
    mass = np.asarray(mass + [1.0, 1e3] * 4, np.float32)
    dev = "cuda"
    pos = torch.from_numpy(pts).to(dev)
    m = torch.from_numpy(mass).to(dev)
    soft = torch.full_like(m, 0.05)
    alive = torch.ones_like(m, dtype=torch.bool)
    per = (False, False, False) if layout == "faces" else (False, True, True)
    n3 = (nx, SLAB_NYZ, SLAB_NYZ)
    cl = build_cell_list(pos, alive, torch.tensor([0.0, 0.0, 0.0], device=dev),
                         torch.tensor([ext, box, box], device=dev),
                         n_cells=n3, capacity=cap, periodic=per)
    assert not bool(cl.overflow)
    soa = pack_cells_abs(cl, pos, m, soft, alive)
    active = torch.from_numpy(rng.uniform(size=len(m)) < 0.8).to(dev)
    active[targets] = True
    flags = grav_tile_flags(cl, active)
    c_full = (int(full[0]) * SLAB_NYZ + int(full[1])) * SLAB_NYZ \
        + int(full[2])
    if layout in ("full", "gated"):
        assert int((soa[c_full, 5] > 0).sum()) == cap
    if layout == "gated":
        flags[::3] = 0
        flags[cl.cell_of[targets].long()] = 1
        flags[c_full] = 0
    args = (soa, flags, n3, box, per, rc / 4.5, rc)
    return args, cl, targets


SLAB_EDGE_CASES = [(nx, sign, "seams") for nx in (3, 40) for sign in (-1, 1)] \
    + [(3, -1, layout) for layout in SLAB_LAYOUTS[1:]]


@pytest.mark.parametrize("nx,sign,layout", SLAB_EDGE_CASES)
def test_slab_gravity_kernel_edges_on_card(nx, sign, layout):
    """A's slab mode where its culling and its stencil are tight: heavy
    sources at rcut (1 - 1e-5) of a target across the y and z seams and
    beyond each clamped face pull it, at rcut (1 + 1e-5) add nothing (in
    vacuum, "faces", no image: the seams' sources add nothing either);
    and the layouts of :data:`SLAB_LAYOUTS`; within the bound of its
    float64 plain version, gated tiles zero."""
    _need_card()
    from gadget_leicester_tpu_torch.ops import cells, gravity_short
    from gadget_leicester_tpu_torch.ops.neighbors import merge_rows
    args, cl, targets = _slab_gravity_case(nx, sign, layout)
    got = cells.shortrange_gravity_slab(*args)
    want = gravity_short.shortrange_gravity_slab_plain(*args)
    exact = gravity_short.shortrange_gravity_slab_plain(
        *chip_smoke.as_float64(args))
    torch.cuda.synchronize()
    *_, used = chip_smoke.compare("shortrange_gravity_slab", got, want,
                                  exact)
    assert used <= 1.0
    assert not bool(got[args[1] == 0].any())
    acc = merge_rows(got, cl, 3)[targets].abs().amax(1)
    # a heavy pull at rcut is ~20 (G = 1); the background's is below 1
    pulled = torch.tensor([sign < 0] * 4, device=acc.device)
    if layout == "faces":
        pulled[:2] = False
    assert bool(((acc > 5.0) == pulled).all()), acc


SLAB_POT_EDGE_CASES = [
    (nx, sign, "seams", per) for nx in (3, 40) for sign in (-1, 1)
    for per in ((False, True, True), (False, False, False))] \
    + [(3, -1, layout, per) for layout in SLAB_LAYOUTS[1:-1]
       for per in ((False, True, True), (False, False, False))] \
    + [(3, -1, "faces", (False, False, False))]


@pytest.mark.parametrize("nx,sign,layout,per", SLAB_POT_EDGE_CASES)
def test_slab_potential_kernel_edges_on_card(nx, sign, layout, per):
    """A's slab mode with the potential on the edge cases of
    test_slab_gravity_kernel_edges_on_card (periodic in y and z, and
    clamped on every axis): within the bound of its float64 plain
    version, rows 0-2 equal to the force-only mode's bit for bit, gated
    tiles zero."""
    _need_card()
    from gadget_leicester_tpu_torch.ops import cells, gravity_short
    args, _, _ = _slab_gravity_case(nx, sign, layout)
    args = args[:4] + (per,) + args[5:]
    got = cells.shortrange_gravity_slab(*args, with_potential=True)
    force = cells.shortrange_gravity_slab(*args)
    want = gravity_short.shortrange_gravity_slab_plain(*args,
                                                       with_potential=True)
    exact = gravity_short.shortrange_gravity_slab_plain(
        *chip_smoke.as_float64(args), with_potential=True)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :3], force)
    *_, used = chip_smoke.compare("shortrange_gravity_slab_pot", got, want,
                                  exact)
    assert used <= 1.0
    assert not bool(got[args[1] == 0].any())


@pytest.fixture(scope="module")
def recorded_aniso():
    """C's and D's arguments on an anisotropic grid on the card: gas in x
    over [0.2, 0.8] of a grid clamped over [0.1, 3.1] (3 blocks of 2 fine
    cells of 0.5: the trailing blocks empty), periodic over a box of 2 in
    y and z, as tests/test_sph_blocks_aniso.py lays it out."""
    _need_card()
    import numpy as np

    from gadget_leicester_tpu_torch.ops import sph_blocks as sb
    rng = np.random.default_rng(41)
    n, box, fine = 2500, 2.0, 0.5
    pos = np.stack([rng.uniform(0.2, 0.8, n), rng.uniform(0, box, n),
                    rng.uniform(0, box, n)], -1).astype(np.float32)
    t = [torch.from_numpy(a).cuda() for a in (
        pos, rng.normal(size=(n, 3)).astype(np.float32),
        np.full(n, 1.0 / n, np.float32))]
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    mask[-5:] = False
    active = torch.from_numpy(rng.uniform(size=n) < 0.7).cuda()
    cls = sb.build_block_lists(t[0], mask, torch.tensor([0.1, 0.0, 0.0]).cuda(),
                               torch.tensor([3.0, box, box]).cuda(),
                               n_blocks=(3, 2, 2), subcap=256,
                               periodic=(False, True, True))
    cap = 0.9 * fine
    with chip_smoke.recorded_inputs() as rec:
        # every gas particle solved, so that the hydro pass's inactive
        # ones have a density too (a step keeps their last one)
        dres, _ = sb.density_adaptive_blocks(
            *t, torch.full((n,), 0.2, device="cuda"), mask, 33.0, 2.0, box,
            cls, cap, fine_edge=fine)
        rho = torch.where(mask, dres.rho, torch.ones_like(dres.rho))
        sb.hydro_force_blocks(cls, *t, dres.hsml, rho, 0.8 * rho ** (5 / 3),
                              dres.dhsml_factor, dres.div_vel, dres.curl_vel,
                              mask, 0.8, box, 0.1, 1.0, 1.0, active=active,
                              fine_edge=fine)
    return dict(rec)


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("name", ["sph_density_aniso", "sph_hydro_aniso"])
def test_aniso_sph_kernels_edges_on_card(recorded_aniso, name, case):
    """C and D on an anisotropic grid with empty trailing x blocks, gas
    across the y and z seams and inactive tiles, within their bound."""
    _check(recorded_aniso, name, case)
