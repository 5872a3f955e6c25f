"""Particle-mesh gravity across the slab ring [G2: pm_periodic.c ::
pmforce_periodic(), slabs_per_task; pm_nonperiodic.c under MPI].

Counterpart of ``gadget_leicester_tpu/parallel/pm_sharded.py`` (``_kvec``
:39, ``_pencil_rfft3`` :44, ``_pencil_irfft3`` :69, ``pm_local_forces`` :78,
``pm_local_forces_vacuum`` :137 and ``make_pm_sharded`` :171). The
periodic mesh, :func:`pm_local_forces`; each rank:

* deposits its own particles onto a full local mesh by point CIC
  (``ops/pm.py :: cic_deposit``, as the reference does: not kernel B);
* ``reduce_scatter_tensor`` leaves it the sum over the ranks of its x-slab;
* a pencil FFT: full FFTs along z and y of the slab, one
  ``all_to_all_single`` that trades x-slabs for kz-pencils, the FFT along
  x. The full (not real) FFT keeps every axis divisible by the ring
  (``n % size == 0``);
* the Green's function and the FD4 gradient on its kz range, and the
  inverse transforms in the mirror order;
* ``all_gather_into_tensor`` of the force slab [n/size, n, n, 3 (+1)],
  and the CIC gather at its particles through ``ops/pm.py ::
  cic_gather_vec``, which is kernel L on the card.

The vacuum mesh of the slab step, :func:`pm_local_forces_vacuum`: each
rank deposits its own particles into the first octant of the zero-padded
mesh of 2n cells a side over the domain cube; one ``all_reduce`` sums the
(n+1)^3 octant, the only part a particle reaches; then every rank runs the
free-space solve of ``ops/pm.py :: vacuum_field`` whole (replicated: no
further collective) and gathers force and potential at its own particles
through kernel L.
"""

from __future__ import annotations

import math

import torch

from gadget_leicester_tpu_torch.ops.pm import (ASMTH, _region_positions,
                                               _sinc, _vacuum_stack,
                                               cic_deposit, cic_gather_vec)


def _kvec(n: int, box: float, device) -> torch.Tensor:
    """The wavenumbers of a full FFT axis, float32."""
    return torch.fft.fftfreq(n, 1.0 / n, device=device,
                             dtype=torch.float32) * (2.0 * math.pi / box)


def _pencil_rfft3(ring, slab: torch.Tensor) -> torch.Tensor:
    """Forward 3-D FFT of an x-slab-sharded real mesh: [n/d, n, n] real ->
    [n, n, n/d] complex, kz-pencil-sharded (kx whole on every rank)."""
    d = ring.size
    nd, n, _ = slab.shape
    f = torch.fft.fft(torch.fft.fft(slab.to(torch.complex64), dim=2), dim=1)
    # chunk j of kz goes to rank j; the x-slab of rank j comes back
    chunks = f.reshape(nd, n, d, n // d).permute(2, 0, 1, 3)
    got = torch.view_as_complex(ring.all_to_all(torch.view_as_real(
        chunks.contiguous())))                         # [d, n/d, n, n/d]
    return torch.fft.fft(got.reshape(n, n, n // d), dim=0)


def _pencil_irfft3(ring, fk: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pencil_rfft3`: [n, n, n/d] complex -> [n/d, n, n]
    real."""
    d = ring.size
    n, _, nd = fk.shape
    f = torch.fft.ifft(fk, dim=0)
    chunks = f.reshape(d, n // d, n, nd)              # x-slab j to rank j
    got = torch.view_as_complex(ring.all_to_all(torch.view_as_real(
        chunks.contiguous())))                         # [d, n/d, n, n/d]
    f = got.permute(1, 2, 0, 3).reshape(n // d, n, n)  # kz chunk j from j
    return torch.fft.ifft(torch.fft.ifft(f, dim=1), dim=2).real


def pm_local_forces(ring, pos, mass, alive, box: float, n: int,
                    asmth_grid: float = ASMTH,
                    with_potential: bool = False):
    """PM accelerations [N, 3] (no G) of this rank's particles, every rank
    calling it with its own (``ring``: :class:`parallel.mesh.Ring`); with
    ``with_potential``, (acc, pot [N]). Needs ``n % ring.size == 0``."""
    d = ring.size
    if n % d:
        raise ValueError(f"pm mesh n={n} must divide the {d}-rank ring")
    h = box / n
    asmth_len = asmth_grid * h
    posw = torch.remainder(pos, box)
    m = torch.where(alive, mass, torch.zeros_like(mass))
    grid = cic_deposit(posw, m, box, n)                # [n, n, n]
    slab = ring.reduce_scatter(grid)                   # [n/d, n, n]
    fk = _pencil_rfft3(ring, slab)                     # [n, n, n/d]

    kx = _kvec(n, box, pos.device)
    kz = kx[ring.rank * (n // d):(ring.rank + 1) * (n // d)]
    KX, KY, KZ = torch.meshgrid(kx, kx, kz, indexing="ij")
    k2 = KX ** 2 + KY ** 2 + KZ ** 2
    w = (_sinc(KX * h / 2) * _sinc(KY * h / 2) * _sinc(KZ * h / 2)) ** 2
    deconv = 1.0 / w.clamp_min(1e-8) ** 2
    k2_safe = torch.where(k2 > 0, k2, torch.ones_like(k2))
    gk = -4.0 * math.pi / k2_safe * torch.exp(-k2 * asmth_len ** 2) * deconv
    gk = torch.where(k2 > 0, gk, torch.zeros_like(gk))
    phi_k = fk * (gk / h ** 3)

    comps = []
    for kv in (KX, KY, KZ):
        mult = -1j * (8.0 * torch.sin(kv * h) - torch.sin(2.0 * kv * h)) \
            / (6.0 * h)
        comps.append(_pencil_irfft3(ring, mult * phi_k))
    if with_potential:
        comps.append(_pencil_irfft3(ring, phi_k))
    field_slab = torch.stack(comps, dim=-1)            # [n/d, n, n, C]
    field = ring.all_gather(field_slab)                # [n, n, n, C]
    out = cic_gather_vec(field.contiguous(), posw, box, n)
    acc = torch.where(alive[:, None], out[:, :3], torch.zeros_like(out[:, :3]))
    if with_potential:
        return acc, torch.where(alive, out[:, 3], torch.zeros_like(out[:, 3]))
    return acc


def pm_local_forces_vacuum(ring, pos, mass, alive, origin, extent: float,
                           n: int, asmth_grid: float = ASMTH,
                           with_potential: bool = False):
    """Vacuum-boundary PM accelerations [N, 3] (no G) of this rank's
    particles over the domain cube [origin, origin + extent), every rank
    calling it with its own; with ``with_potential``, (acc, pot [N]). The
    ring's sum of the deposited octant replaces the single device's
    deposit of all particles (``ops/pm.py :: pm_forces_nonperiodic``);
    the rest is that function's, run on every rank."""
    cell = extent / n
    m = 2 * n
    rel, _ = _region_positions(pos, origin, extent)
    msrc = torch.where(alive, mass, torch.zeros_like(mass))
    grid = cic_deposit(rel, msrc, 2.0 * extent, m)
    octant = ring.psum(grid[:n + 1, :n + 1, :n + 1].contiguous())
    grid = torch.zeros_like(grid)
    grid[:n + 1, :n + 1, :n + 1] = octant
    stack = _vacuum_stack(grid, n, cell, asmth_grid * cell, with_potential)
    rows = cic_gather_vec(stack.contiguous(), rel, 2.0 * extent, m)
    rows = torch.where(alive[:, None], rows, torch.zeros_like(rows))
    if with_potential:
        return rows[:, :3], rows[:, 3]
    return rows[:, :3]
