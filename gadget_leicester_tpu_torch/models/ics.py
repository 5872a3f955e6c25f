"""Initial conditions of the lcdm_gas workload.

Counterpart of ``gadget_leicester_tpu/models/ics.py:109-170``
(``lcdm_gas_ics``): the same numpy code, copied so that the port needs no
JAX package, and so that the same seed gives bit-identical arrays. The
other generators of that module (gassphere, galaxy, cluster, disc) belong
to workloads not yet ported (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import numpy as np


def lcdm_gas_ics(n_side: int = 32, box: float = 50000.0, z_init: float = 10.0,
                 omega0: float = 0.3, omega_b: float = 0.04, hubble: float = 0.1,
                 g: float = 43007.1, amp: float = 0.1, seed: int = 17,
                 with_gas: bool = True):
    """Periodic LCDM-style box: DM (+gas) on offset grids with a random
    Gaussian Zeldovich displacement field — the TreePM+SPH benchmark
    workload. Units: kpc/h, 1e10 Msun/h, km/s (GADGET defaults).

    Returns comoving positions at a_init = 1/(1+z_init) and GADGET-internal
    velocities. `amp` sets the rms displacement in units of the mean
    interparticle spacing.
    """
    rng = np.random.default_rng(seed)
    a_init = 1.0 / (1.0 + z_init)
    n = n_side**3
    gspace = box / n_side
    idx = np.indices((n_side, n_side, n_side)).reshape(3, -1).T
    grid = (idx + 0.5) * gspace

    # Gaussian random displacement field with P(k) ~ k^-1 flavour, built in
    # Fourier space for periodicity
    def disp_field():
        kfreq = np.fft.fftfreq(n_side) * n_side * 2 * np.pi / box
        kx, ky, kz = np.meshgrid(kfreq, kfreq, kfreq, indexing="ij")
        k2 = kx**2 + ky**2 + kz**2
        k2[0, 0, 0] = 1.0
        phase = rng.normal(size=(n_side, n_side, n_side)) + 1j * rng.normal(
            size=(n_side, n_side, n_side))
        pk = k2 ** (-1.25)
        pk[0, 0, 0] = 0.0
        phi_k = phase * np.sqrt(pk)
        d = []
        for kk in (kx, ky, kz):
            comp = np.fft.ifftn(1j * kk * phi_k).real
            d.append(comp.reshape(-1))
        d = np.stack(d, -1)
        rms = np.sqrt((d**2).sum(-1).mean())
        return d / max(rms, 1e-30)

    disp = disp_field() * amp * gspace
    pos_dm = np.mod(grid + disp, box)
    # Zeldovich velocities: v_pec = a H(a) f * disp; use f ~ Omega^0.6
    h_a = hubble * np.sqrt(omega0 / a_init**3 + (1 - omega0) )
    f_growth = omega0**0.6
    vel_pec = disp * (a_init * h_a * f_growth)
    # GADGET internal velocity u = v_pec / sqrt(a) (snapshot convention)
    vel_dm = vel_pec / np.sqrt(a_init)

    rho_crit = 3.0 * hubble**2 / (8.0 * np.pi * g)
    m_tot = omega0 * rho_crit * box**3
    if with_gas:
        pos_gas = np.mod(grid + disp + 0.5 * gspace, box)
        m_dm = (omega0 - omega_b) * rho_crit * box**3 / n
        m_gas = omega_b * rho_crit * box**3 / n
        pos = np.concatenate([pos_gas, pos_dm])
        vel = np.concatenate([vel_dm, vel_dm])
        mass = np.concatenate([np.full(n, m_gas), np.full(n, m_dm)])
        ptype = np.concatenate([np.zeros(n, np.int32), np.ones(n, np.int32)])
        u = np.concatenate([np.full(n, 1000.0 * a_init)])  # ~1e4 K scale
        return pos, vel, mass, ptype, u
    mass = np.full(n, m_tot / n)
    return pos_dm, vel_dm, mass, np.ones(n, np.int32), None
