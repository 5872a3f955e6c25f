"""Initial conditions of the lcdm_gas, gassphere, galaxy, cluster and
Leicester disc workloads.

Counterpart of ``gadget_leicester_tpu/models/ics.py:30-211``
(``gassphere_ics``, ``plummer_ics``, ``galaxy_collision_ics``,
``lcdm_gas_ics``, ``disc_ics``): the same numpy code, copied so that the
port needs no JAX package, and so that the same seed gives bit-identical
arrays.
"""

from __future__ import annotations

import numpy as np


def _random_directions(n: int, rng: np.random.Generator) -> np.ndarray:
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def gassphere_ics(n_gas: int = 1472, seed: int = 7, mode: str = "grid"):
    """Evrard collapse: rho(r) = M/(2 pi R^2 r), M=R=1, u=0.05.

    mode="grid": deterministic stretched lattice (matches how the stock IC
    was built: a uniform grid mapped r -> r_new so M(<r) ~ r^2);
    mode="random": equal-mass radius sampling r = R*sqrt(xi).
    """
    if mode == "grid":
        # cubic lattice inside unit sphere, then stretch radii:
        # uniform density has M(<r) ~ r^3; target profile needs M(<r) ~ r^2,
        # so r_new = r_old^{3/2} (unit sphere).
        side = int(np.ceil((n_gas * 6 / np.pi) ** (1 / 3)))
        g = (np.arange(side) + 0.5) / side * 2.0 - 1.0
        xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        r = np.linalg.norm(xyz, axis=1)
        inside = r < 1.0
        xyz, r = xyz[inside], r[inside]
        r_safe = np.maximum(r, 1e-10)
        xyz = xyz * (r_safe[:, None] ** 0.5)  # r_new = r^{3/2} => scale r^{1/2}
        n = len(xyz)
    else:
        rng = np.random.default_rng(seed)
        xi = rng.uniform(size=n_gas)
        r = np.sqrt(xi)
        xyz = _random_directions(n_gas, rng) * r[:, None]
        n = n_gas
    pos = xyz
    vel = np.zeros_like(pos)
    mass = np.full(n, 1.0 / n)
    ptype = np.zeros(n, np.int32)
    u = np.full(n, 0.05)
    return pos, vel, mass, ptype, u


def plummer_ics(n: int = 2000, total_mass: float = 1.0, a: float = 1.0,
                seed: int = 11, g: float = 1.0):
    """Isotropic Plummer sphere with equilibrium velocities (Aarseth et al.
    1974 rejection sampling) — collisionless tree-gravity workload."""
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(size=n)
    r = a / np.sqrt(x1 ** (-2.0 / 3.0) - 1.0)
    r = np.minimum(r, 20.0 * a)
    pos = _random_directions(n, rng) * r[:, None]
    # velocity sampling: q = v/v_esc, f(q) ~ q^2 (1-q^2)^{7/2}
    q = np.zeros(n)
    todo = np.ones(n, bool)
    while todo.any():
        k = int(todo.sum())
        qq = rng.uniform(size=k)
        yy = rng.uniform(size=k) * 0.1
        ok = yy < qq**2 * (1.0 - qq**2) ** 3.5
        idx = np.where(todo)[0][ok]
        q[idx] = qq[ok]
        todo[idx] = False
    v_esc = np.sqrt(2.0 * g * total_mass) * (r**2 + a**2) ** (-0.25)
    vel = _random_directions(n, rng) * (q * v_esc)[:, None]
    mass = np.full(n, total_mass / n)
    ptype = np.ones(n, np.int32)
    return pos, vel, mass, ptype, None


def galaxy_collision_ics(n_each: int = 1500, sep: float = 5.0,
                         vrel: float = 0.3, seed: int = 13):
    """Two Plummer spheres on a head-on collision orbit — the 'galaxy'
    workload analog (pure collisionless gravity, multiple softenings)."""
    p1 = plummer_ics(n_each, seed=seed)
    p2 = plummer_ics(n_each, seed=seed + 1)
    pos = np.concatenate([p1[0] - [sep / 2, 0, 0], p2[0] + [sep / 2, 0, 0]])
    vel = np.concatenate([p1[1] + [vrel / 2, 0, 0], p2[1] - [vrel / 2, 0, 0]])
    mass = np.concatenate([p1[2], p2[2]])
    ptype = np.concatenate([np.ones(n_each, np.int32), 2 * np.ones(n_each, np.int32)])
    return pos, vel, mass, ptype, None


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


def disc_ics(n_gas: int = 4000, m_star: float = 1.0, m_disc: float = 0.1,
             r_in: float = 0.25, r_out: float = 2.5, h_over_r: float = 0.05,
             seed: int = 23, g: float = 1.0):
    """Self-gravitating protoplanetary disc around a central star: Sigma ~
    1/r, near-Keplerian rotation, the sound speed from the aspect ratio.
    The star is type 5 at the origin, last in the arrays (to be
    registered as a sink); ``u`` holds the gas's only."""
    rng = np.random.default_rng(seed)
    # Sigma ~ 1/r => M(<r) ~ r => r = r_in + xi (r_out - r_in)
    r = r_in + rng.uniform(size=n_gas) * (r_out - r_in)
    phi = rng.uniform(size=n_gas) * 2 * np.pi
    z = rng.normal(size=n_gas) * (h_over_r * r)
    pos_g = np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)
    vk = np.sqrt(g * m_star / r)
    vel_g = np.stack([-vk * np.sin(phi), vk * np.cos(phi), np.zeros(n_gas)],
                     -1)
    mass_g = np.full(n_gas, m_disc / n_gas)
    # cs = (h/r) vk -> u = cs^2 / (gamma - 1)
    cs2 = (h_over_r * vk) ** 2
    u = cs2 / (2.0 / 3.0)
    pos = np.concatenate([pos_g, np.zeros((1, 3))])
    vel = np.concatenate([vel_g, np.zeros((1, 3))])
    mass = np.concatenate([mass_g, [m_star]])
    ptype = np.concatenate([np.zeros(n_gas, np.int32), [np.int32(5)]])
    return pos, vel, mass, ptype, u
