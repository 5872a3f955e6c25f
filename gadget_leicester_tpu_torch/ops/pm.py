"""Particle-mesh long-range gravity: the periodic mesh [G2: pm_periodic.c
:: pmforce_periodic()], the vacuum mesh and the two-level zoom mesh
[G2: pm_nonperiodic.c, with PLACEHIGHRESREGION].

Counterpart of ``gadget_leicester_tpu/ops/pm.py`` (``cic_deposit``,
``cic_gather``, ``cic_gather_vec``, ``greens_function``,
``pm_forces_periodic``, ``pm_potential_periodic``; the vacuum functions
``_freespace_kernel_k``, ``vacuum_field``, ``pm_forces_nonperiodic``,
``_freespace_diff_kernel_k``, ``pm_forces_diff``). Periodic:

  CIC deposit -> rfftn -> Green's function
  (-4 pi / k^2) exp(-k^2 asmth^2) CIC-deconvolution -> FD4 gradient as
  its k-space multiplier -> irfftn -> CIC gather.

Vacuum (Hockney and Eastwood): the region [origin, origin + extent) is
deposited into the first octant of a zero-padded mesh of 2n cells a side
(side 2 extent), convolved with the FFT of the free-space long-range
Green's function -erf(r / (2 asmth)) / r, or for the zoom's fine mesh the
band-pass -(erf(r / (2 a_hi)) - erf(r / (2 a_lo))) / r, then the FD4
gradient and one CIC gather of force and potential (kernel L, K = 4). The
region's extent is a Python float here: the caller reads the fitted
regions from the device once per force pass (``models/forces.py ::
_zoom_gravity``), so no gather waits on the device.

The FFTs are ``torch.fft`` (cuFFT on the card), as the JAX package leaves
them to ``jnp.fft``. Every CIC gather goes through kernel L
(``csrc/pm_gather.cu``, :func:`cic_gather_vec`): one thread a particle
reading its 8 corners from the mesh, operation for operation the row
gather :func:`cic_gather_vec_plain`, which CPU tensors take; the JAX
package's step keeps the row gather, because on the TPU its tile gather
lost. The deposit on the main path is kernel B (``ops/pm_tiles.py``);
:func:`cic_deposit` is the point-scatter form, kept as an independent
check of it, and the deposit of :func:`pm_potential_periodic`, as in the
JAX package.

Asmth/Rcut convention [G2: allvars.h ASMTH=1.25, RCUT=4.5]: the long/short
split scale is asmth = 1.25 mesh cells; the short-range force is cut at
rcut = 4.5 asmth.
"""

from __future__ import annotations

import math

import torch

from gadget_leicester_tpu_torch import kernels

ASMTH = 1.25  # in units of mesh cells [G2: allvars.h]
RCUT = 4.5    # in units of asmth


def _cic_base(pos, box: float, n: int):
    """Base cell [N, 3] (wrapped) and fractions [N, 3]."""
    u = pos * (n / box)
    i0f = torch.floor(u)
    frac = u - i0f
    return torch.remainder(i0f.to(torch.int64), n), frac


def cic_deposit(pos, weight, box: float, n: int) -> torch.Tensor:
    """Cloud-in-cell assignment of ``weight`` onto an [n, n, n] periodic
    mesh by eight point scatter-adds."""
    i0, frac = _cic_base(pos, box, n)
    grid = torch.zeros(n ** 3, dtype=pos.dtype, device=pos.device)
    for dx in (0, 1):
        wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
        ix = (i0[:, 0] + dx) % n
        for dy in (0, 1):
            wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
            iy = (i0[:, 1] + dy) % n
            for dz in (0, 1):
                wz = frac[:, 2] if dz else 1.0 - frac[:, 2]
                iz = (i0[:, 2] + dz) % n
                grid.index_add_(0, (ix * n + iy) * n + iz,
                                weight * wx * wy * wz)
    return grid.reshape(n, n, n)


def cic_gather(field, pos, box: float, n: int) -> torch.Tensor:
    """CIC interpolation of a scalar mesh field [n, n, n] to [N]."""
    return cic_gather_vec(field[..., None], pos, box, n)[:, 0]


# the largest mesh side whose cell index (ix n + iy) n + iz fits kernel
# L's int32
MAX_GATHER_MESH = 1290


def cic_gather_vec(field, pos, box: float, n: int) -> torch.Tensor:
    """Kernel L: CIC interpolation of a vector mesh field [n, n, n, K] (K
    = 1 to 4) to the positions ``pos`` [N, 3], wrapped into [0, box]
    (``torch.remainder``): [N, K], float32, or float64 where a check
    takes the mesh potential in float64 on the card. CPU tensors take the
    plain version; CUDA tensors launch the kernel, which equals it bit
    for bit."""
    if field.dim() != 4 or tuple(field.shape[:3]) != (n, n, n) \
            or not 1 <= field.shape[-1] <= 4:
        raise ValueError(f"field shape {tuple(field.shape)} is not "
                         f"[{n}, {n}, {n}, K] with K of 1 to 4")
    if n > MAX_GATHER_MESH:
        raise ValueError(f"a mesh of {n} cells a side is beyond kernel L's "
                         f"int32 cell index (at most {MAX_GATHER_MESH})")
    if field.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"field: expected float32 or float64, got "
                        f"{field.dtype}")
    k = field.shape[-1]
    kernels.check(field, "field", field.dtype)
    kernels.check(pos, "pos", field.dtype, (pos.shape[0], 3), field.device)
    kernels.note_call("pm_gather", (field, pos, box, n))
    if not kernels.on_cuda(field, pos):
        return cic_gather_vec_plain(field, pos, box, n)
    out = torch.empty(pos.shape[0], k, dtype=field.dtype,
                      device=field.device)
    kernels.launch("pm_gather", pos.data_ptr(), field.data_ptr(),
                   out.data_ptr(), pos.shape[0], n, k, n / box,
                   int(field.dtype == torch.float64))
    return out


def cic_gather_vec_plain(field, pos, box: float, n: int) -> torch.Tensor:
    """Plain PyTorch version of kernel L: the row gather, 8 indexed reads
    of the mesh, [N, K]."""
    k = field.shape[-1]
    i0, frac = _cic_base(pos, box, n)
    flat = field.reshape(-1, k)
    out = torch.zeros(pos.shape[0], k, dtype=field.dtype, device=field.device)
    for dx in (0, 1):
        wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
        ix = (i0[:, 0] + dx) % n
        for dy in (0, 1):
            wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
            iy = (i0[:, 1] + dy) % n
            for dz in (0, 1):
                wz = frac[:, 2] if dz else 1.0 - frac[:, 2]
                iz = (i0[:, 2] + dz) % n
                out += flat[(ix * n + iy) * n + iz] * (wx * wy * wz)[:, None]
    return out


def _wavenumbers(n: int, box: float, device):
    """kx (full axis) and kz (half axis of rfftn), float32."""
    kf = 2.0 * math.pi / box
    kx = torch.fft.fftfreq(n, 1.0 / n, device=device,
                           dtype=torch.float32) * kf
    kz = torch.arange(n // 2 + 1, device=device, dtype=torch.float32) * kf
    return kx, kz


def _sinc(x):
    x = x.abs()
    ok = x > 1e-8
    return torch.where(ok, torch.sin(x) / torch.where(ok, x, 1.0), 1.0)


def greens_function(n: int, box: float, device) -> torch.Tensor:
    """k-space multiplier -4 pi / k^2 exp(-k^2 asmth^2) / W_cic(k)^2,
    shaped for rfftn output [n, n, n//2+1] (G applied by the caller)."""
    kx, kz = _wavenumbers(n, box, device)
    KX, KY, KZ = torch.meshgrid(kx, kx, kz, indexing="ij")
    k2 = KX ** 2 + KY ** 2 + KZ ** 2
    asmth_len = ASMTH * box / n
    h = box / n
    w = (_sinc(KX * h / 2) * _sinc(KY * h / 2) * _sinc(KZ * h / 2)) ** 2
    deconv = 1.0 / w.clamp_min(1e-8) ** 2
    k2_safe = torch.where(k2 > 0, k2, 1.0)
    g = -4.0 * math.pi / k2_safe * torch.exp(-k2 * asmth_len ** 2) * deconv
    return torch.where(k2 > 0, g, 0.0)


def pm_forces_periodic(pos, mass, alive, box: float, n: int,
                       rho_grid: torch.Tensor | None = None,
                       with_potential: bool = False,
                       return_field: bool = False):
    """Long-range accelerations [N, 3] (no G factor), periodic box, with
    the 4-point finite-difference gradient of the reference applied as its
    exact k-space multiplier D4(k) = i (8 sin(kh) - sin(2kh)) / (6h).
    ``rho_grid``: the mass mesh when the caller deposited it already
    (kernel B); otherwise the alive particles are deposited here.
    ``with_potential``: the mesh potential rides as a fourth component of
    the stack, and (acc, pot [N]) comes back. ``return_field``: no
    per-particle gather; the mesh force stack [n, n, n, 3 (+1)] comes back
    for ``ops/pm_tiles.py :: pm_gather_tiles``."""
    posw = torch.remainder(pos, box)
    if rho_grid is None:
        m = torch.where(alive, mass, torch.zeros_like(mass))
        rho_grid = cic_deposit(posw, m, box, n)
    rho_k = torch.fft.rfftn(rho_grid)
    g_k = greens_function(n, box, pos.device)
    cell_vol = (box / n) ** 3
    phi_k = g_k * rho_k / cell_vol
    h = box / n
    kx, kz = _wavenumbers(n, box, pos.device)
    comp = []
    for k in (kx[:, None, None], kx[None, :, None], kz[None, None, :]):
        d4 = (8.0 * torch.sin(k * h) - torch.sin(2.0 * k * h)) / (6.0 * h)
        comp.append(torch.fft.irfftn(-1j * d4 * phi_k, s=(n, n, n)))
    if with_potential:
        comp.append(torch.fft.irfftn(phi_k, s=(n, n, n)))
    stack = torch.stack(comp, dim=-1)
    if return_field:
        return stack
    # one gather of the force, or of the force and the potential together
    rows = cic_gather_vec(stack, posw, box, n)
    rows = torch.where(alive[:, None], rows, torch.zeros_like(rows))
    if not with_potential:
        return rows
    return rows[:, :3], rows[:, 3]


def pm_potential_periodic(pos, mass, alive, box: float,
                          n: int) -> torch.Tensor:
    """Long-range potential [N] at the particle positions (no G), for the
    energy diagnostics and the TreePM potential: the point deposit
    (:func:`cic_deposit`, not kernel B, as in the JAX package), the
    Green's function and a CIC gather of the mesh potential (kernel L,
    K = 1)."""
    m = torch.where(alive, mass, torch.zeros_like(mass))
    posw = torch.remainder(pos, box)
    rho = cic_deposit(posw, m, box, n)
    g_k = greens_function(n, box, pos.device)
    phi = torch.fft.irfftn(g_k * torch.fft.rfftn(rho) / (box / n) ** 3,
                           s=(n, n, n))
    return cic_gather(phi, posw, box, n)


# ---------------------------------------------------------------------------
# Vacuum boundaries [G2: pm_nonperiodic.c]
# ---------------------------------------------------------------------------
def _padded_axis(n: int, cell: float, device) -> torch.Tensor:
    """Signed distances (float32) of the 2n cells of a padded axis, in FFT
    order: 0, 1, ..., n - 1, -n, ..., -1 cells."""
    m = 2 * n
    i = torch.arange(m, device=device)
    return torch.where(i < n, i, i - m).to(torch.float32) * cell


def _deconvolved_rfft(g: torch.Tensor, n: int, cell: float) -> torch.Tensor:
    """rfftn of a real-space kernel on the padded mesh, divided by the CIC
    window squared (deposit and gather) [G2: pm_nonperiodic.c ff*ff]."""
    kx, kz = _wavenumbers(2 * n, 2 * n * cell, g.device)
    w = (_sinc(kx[:, None, None] * cell / 2) * _sinc(kx[None, :, None]
                                                     * cell / 2)
         * _sinc(kz[None, None, :] * cell / 2)) ** 2
    return torch.fft.rfftn(g) / w.clamp_min(1e-8) ** 2


def _padded_radius(n: int, cell: float, device) -> torch.Tensor:
    ax = _padded_axis(n, cell, device)
    return torch.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                      + ax[None, None, :] ** 2)


def _freespace_kernel_k(n: int, cell: float, asmth_len: float,
                        device) -> torch.Tensor:
    """FFT [2n, 2n, n + 1] of the long-range free-space Green's function
    g(x) = -erf(|x| / (2 asmth)) / |x| (-1 / (asmth sqrt(pi)) at 0) on the
    zero-padded mesh, CIC-deconvolved: the PM part of the TreePM split,
    whose short-range remainder is the erfc pair sum."""
    r = _padded_radius(n, cell, device)
    r_safe = r.clamp_min(1e-30)
    g = -torch.erf(r_safe / (2.0 * asmth_len)) / r_safe
    g = torch.where(r > 0, g, -1.0 / (asmth_len * math.sqrt(math.pi)))
    return _deconvolved_rfft(g, n, cell)


def _freespace_diff_kernel_k(n: int, cell: float, asmth_hi: float,
                             asmth_lo: float, device) -> torch.Tensor:
    """FFT of the band-pass kernel -(erf(|x| / (2 a_hi)) - erf(|x| / (2
    a_lo))) / |x| on the padded mesh, CIC-deconvolved: the force between
    the fine mesh's smoothing a_hi and the coarse mesh's a_lo, which the
    zoom's fine mesh adds inside the high-resolution region."""
    r = _padded_radius(n, cell, device)
    r_safe = r.clamp_min(1e-30)
    g = -(torch.erf(r_safe / (2.0 * asmth_hi))
          - torch.erf(r_safe / (2.0 * asmth_lo))) / r_safe
    g0 = -(1.0 / asmth_hi - 1.0 / asmth_lo) / math.sqrt(math.pi)
    g = torch.where(r > 0, g, g0)
    return _deconvolved_rfft(g, n, cell)


def _padded_stack(phi_k: torch.Tensor, n: int, cell: float,
                  with_potential: bool = True) -> torch.Tensor:
    """Mesh stack [2n, 2n, 2n, 3 (+1)]: the FD4 gradient of the potential
    (as its k-space multiplier), then the potential itself."""
    m = 2 * n
    kx, kz = _wavenumbers(m, m * cell, phi_k.device)
    comp = []
    for k in (kx[:, None, None], kx[None, :, None], kz[None, None, :]):
        d4 = (8.0 * torch.sin(k * cell) - torch.sin(2.0 * k * cell)) \
            / (6.0 * cell)
        comp.append(torch.fft.irfftn(-1j * d4 * phi_k, s=(m, m, m)))
    if with_potential:
        comp.append(torch.fft.irfftn(phi_k, s=(m, m, m)))
    return torch.stack(comp, dim=-1)


def _vacuum_stack(grid: torch.Tensor, n: int, cell: float, asmth_len: float,
                  with_potential: bool = True) -> torch.Tensor:
    phi_k = torch.fft.rfftn(grid) * _freespace_kernel_k(n, cell, asmth_len,
                                                        grid.device)
    return _padded_stack(phi_k, n, cell, with_potential)


def vacuum_field(grid: torch.Tensor, n: int, cell: float, asmth_len: float):
    """Free-space solve of the mass mesh ``grid`` [2n, 2n, 2n] (the region
    deposited into its first octant): (force [2n, 2n, 2n, 3], phi [2n, 2n,
    2n]), no G, both views of one stack."""
    stack = _vacuum_stack(grid, n, cell, asmth_len)
    return stack[..., :3], stack[..., 3]


def _region_positions(pos, origin, extent: float):
    """Positions relative to ``origin`` [3] (or a scalar), clamped into
    [0, extent), and the unclamped relative positions."""
    rel = pos - torch.as_tensor(origin, dtype=pos.dtype, device=pos.device)
    return rel.clamp(0.0, extent * 0.9999999), rel


def pm_forces_nonperiodic(pos, mass, alive, origin, extent: float, n: int,
                          with_potential: bool = False):
    """Vacuum-boundary long-range accelerations [N, 3] (no G) from the
    zero-padded mesh of 2n cells over [origin, origin + extent): the
    alive particles deposited (the point CIC, :func:`cic_deposit`), the
    free-space solve (:func:`vacuum_field`) and one gather of the force,
    or of force and potential together (kernel L, K = 3 or 4). With
    ``with_potential``, (acc, pot [N]).
    Pair with the erfc short-range force at asmth = 1.25 extent / n."""
    cell = extent / n
    m = 2 * n
    posw, _ = _region_positions(pos, origin, extent)
    msrc = torch.where(alive, mass, torch.zeros_like(mass))
    grid = cic_deposit(posw, msrc, 2.0 * extent, m)
    rows = cic_gather_vec(_vacuum_stack(grid, n, cell, ASMTH * cell,
                                        with_potential),
                          posw, 2.0 * extent, m)
    rows = torch.where(alive[:, None], rows, torch.zeros_like(rows))
    if with_potential:
        return rows[:, :3], rows[:, 3]
    return rows[:, :3]


def pm_forces_diff(pos, mass, alive, origin, extent: float, n: int,
                   asmth_lo: float, with_potential: bool = False):
    """The zoom's band-pass mesh over [origin, origin + extent): the force
    at the fine smoothing (1.25 extent / n) less the content the coarse
    mesh supplies at ``asmth_lo``; sources and targets are the alive
    particles inside the region (others get zeros). Returns (acc, in_reg)
    or, with ``with_potential``, (acc, pot, in_reg); no G."""
    cell = extent / n
    m = 2 * n
    posw, rel = _region_positions(pos, origin, extent)
    in_reg = ((rel >= 0) & (rel < extent)).all(dim=-1) & alive
    msrc = torch.where(in_reg, mass, torch.zeros_like(mass))
    grid = cic_deposit(posw, msrc, 2.0 * extent, m)
    phi_k = torch.fft.rfftn(grid) * _freespace_diff_kernel_k(
        n, cell, ASMTH * cell, asmth_lo, pos.device)
    rows = cic_gather_vec(_padded_stack(phi_k, n, cell, with_potential),
                          posw, 2.0 * extent, m)
    rows = torch.where(in_reg[:, None], rows, torch.zeros_like(rows))
    if with_potential:
        return rows[:, :3], rows[:, 3], in_reg
    return rows[:, :3], in_reg
