"""Periodic particle-mesh long-range gravity [G2: pm_periodic.c ::
pmforce_periodic()].

Counterpart of ``gadget_leicester_tpu/ops/pm.py:31-197, 301-312``
(``cic_deposit``, ``cic_gather``, ``cic_gather_vec``, ``greens_function``,
``pm_forces_periodic``, ``pm_potential_periodic``):

  CIC deposit -> rfftn -> Green's function
  (-4 pi / k^2) exp(-k^2 asmth^2) CIC-deconvolution -> FD4 gradient as
  its k-space multiplier -> irfftn -> CIC gather.

The FFTs are ``torch.fft`` (cuFFT on the card), as the JAX package leaves
them to ``jnp.fft``; the gather of the main path is a plain row gather, as
the reference's step keeps it (the cell-window gather, kernel L, takes
the mesh stack of ``return_field``). The deposit on the main path is
kernel B (``ops/pm_tiles.py``); :func:`cic_deposit` is the
point-scatter form, kept as an independent check of it, and the deposit
of :func:`pm_potential_periodic`, as in the JAX package.

Asmth/Rcut convention [G2: allvars.h ASMTH=1.25, RCUT=4.5]: the long/short
split scale is asmth = 1.25 mesh cells; the short-range force is cut at
rcut = 4.5 asmth.
"""

from __future__ import annotations

import math

import torch

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


def cic_gather_vec(field, pos, box: float, n: int) -> torch.Tensor:
    """CIC interpolation of a vector mesh field [n, n, n, K] to [N, K]."""
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


def greens_function(n: int, box: float, device) -> torch.Tensor:
    """k-space multiplier -4 pi / k^2 exp(-k^2 asmth^2) / W_cic(k)^2,
    shaped for rfftn output [n, n, n//2+1] (G applied by the caller)."""
    kx, kz = _wavenumbers(n, box, device)
    KX, KY, KZ = torch.meshgrid(kx, kx, kz, indexing="ij")
    k2 = KX ** 2 + KY ** 2 + KZ ** 2
    asmth_len = ASMTH * box / n

    def sinc(x):
        x = x.abs()
        ok = x > 1e-8
        return torch.where(ok, torch.sin(x) / torch.where(ok, x, 1.0), 1.0)

    h = box / n
    w = (sinc(KX * h / 2) * sinc(KY * h / 2) * sinc(KZ * h / 2)) ** 2
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
    for the cell-window gather (kernel L, ``ops/pm_tiles.py ::
    pm_gather_tiles``)."""
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
    force = torch.stack(comp, dim=-1)
    if return_field:
        return force
    out = cic_gather_vec(force, posw, box, n)
    out = torch.where(alive[:, None], out, torch.zeros_like(out))
    if with_potential:
        return out[:, :3], out[:, 3]
    return out


def pm_potential_periodic(pos, mass, alive, box: float,
                          n: int) -> torch.Tensor:
    """Long-range potential [N] at the particle positions (no G), for the
    energy diagnostics and the TreePM potential: the point deposit
    (:func:`cic_deposit`, not kernel B, as in the JAX package), the
    Green's function and a CIC gather of the mesh potential."""
    m = torch.where(alive, mass, torch.zeros_like(mass))
    posw = torch.remainder(pos, box)
    rho = cic_deposit(posw, m, box, n)
    g_k = greens_function(n, box, pos.device)
    phi = torch.fft.irfftn(g_k * torch.fft.rfftn(rho) / (box / n) ** 3,
                           s=(n, n, n))
    return cic_gather(phi, posw, box, n)
