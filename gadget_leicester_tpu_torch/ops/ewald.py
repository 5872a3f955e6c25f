"""Ewald summation for exactly periodic gravity [G2: forcetree.c ::
ewald_init() / ewald_force(); gravtree_forcetest.c].

Counterpart of ``gadget_leicester_tpu/ops/ewald.py``. The numpy part
(``ewald_pair_force``, ``ewald_pair_potential``, ``ewald_correction_table``,
``direct_periodic_forces``) is that module's code, copied so that the port
needs no JAX package: the lattice sums of Hernquist, Bouchet & Suto (1991)
on the host, the oracle of the periodic tree and the source of its
correction table. :func:`ewald_correction` is the torch counterpart of
``ewald_correction_jnp`` (:132-168): the trilinear interpolation of the
tabulated correction, on the device of its argument. The table is cached
on disk under ``build/ewald/`` at the root of the checkout (the JAX
package keeps its own beside its module; the port never reads that one).
"""

from __future__ import annotations

import itertools
import os
from pathlib import Path

import numpy as np
import torch
from scipy.special import erfc

CACHE_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "ewald"


def ewald_pair_force(r: np.ndarray, box: float, alpha: float | None = None,
                     nmax: int = 4, kmax: int = 4) -> np.ndarray:
    """f(r) [M,3] such that acc_i = sum_j m_j f(x_i - x_j).

    alpha defaults to 2/box [G2: forcetree.c ewald_init()].
    """
    r = np.atleast_2d(np.asarray(r, np.float64))
    if alpha is None:
        alpha = 2.0 / box
    f = np.zeros_like(r)
    # real-space lattice sum
    for n in itertools.product(range(-nmax, nmax + 1), repeat=3):
        u = r + np.asarray(n, np.float64) * box
        d = np.linalg.norm(u, axis=1)
        ok = d > 0
        du = np.where(ok, d, 1.0)
        scr = erfc(alpha * du) + 2.0 * alpha * du / np.sqrt(np.pi) * np.exp(
            -(alpha * du) ** 2)
        f -= np.where(ok[:, None], u / du[:, None] ** 3 * scr[:, None], 0.0)
    # k-space sum
    kf = 2.0 * np.pi / box
    for m in itertools.product(range(-kmax, kmax + 1), repeat=3):
        if m == (0, 0, 0):
            continue
        k = np.asarray(m, np.float64) * kf
        k2 = k @ k
        coef = 4.0 * np.pi / (box**3) * np.exp(-k2 / (4.0 * alpha**2)) / k2
        f -= coef * np.sin(r @ k)[:, None] * k[None, :]
    return f


def ewald_pair_potential(r: np.ndarray, box: float, alpha: float | None = None,
                         nmax: int = 4, kmax: int = 4) -> np.ndarray:
    """phi(r) [M] with phi -> -1/|r| as r -> 0 (plus the constant lattice
    background terms, matching [G2: ewald_psi()] up to the same constant)."""
    r = np.atleast_2d(np.asarray(r, np.float64))
    if alpha is None:
        alpha = 2.0 / box
    phi = np.zeros(r.shape[0])
    for n in itertools.product(range(-nmax, nmax + 1), repeat=3):
        u = r + np.asarray(n, np.float64) * box
        d = np.linalg.norm(u, axis=1)
        ok = d > 0
        du = np.where(ok, d, 1.0)
        phi -= np.where(ok, erfc(alpha * du) / du, 0.0)
    kf = 2.0 * np.pi / box
    for m in itertools.product(range(-kmax, kmax + 1), repeat=3):
        if m == (0, 0, 0):
            continue
        k = np.asarray(m, np.float64) * kf
        k2 = k @ k
        phi -= 4.0 * np.pi / (box**3) * np.exp(-k2 / (4.0 * alpha**2)) / k2 * \
            np.cos(r @ k)
    phi += np.pi / (alpha**2 * box**3)  # charge-neutralising background
    return phi


# ---------------------------------------------------------------------------
# Tabulated Ewald correction for the periodic tree walk
# [G2: forcetree.c :: ewald_init()/ewald_force(), cached ewald_spc_table]
# ---------------------------------------------------------------------------
_EWALD_CACHE = {}


def ewald_correction_table(res: int = 32, cache_dir: str | None = None):
    """Build (or load) the correction tables on a res^3 grid over the
    symmetric octant x/L in [0, 0.5]^3:

        f_corr(x) = f_ewald(x) + x/|x|^3      (periodic minus Newtonian)
        phi_corr(x) = phi_ewald(x) + 1/|x|

    Units of box = 1; scale-free (forces scale as L^-2, potential L^-1).
    Cached to disk, as the reference caches its table.
    """
    key = res
    if key in _EWALD_CACHE:
        return _EWALD_CACHE[key]
    cache_dir = cache_dir or str(CACHE_DIR)
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"ewald_table_{res}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            out = (z["force"], z["pot"])
        _EWALD_CACHE[key] = out
        return out
    g = np.linspace(0.0, 0.5, res)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)
    f_ew = ewald_pair_force(pts, 1.0, nmax=4, kmax=4)
    p_ew = ewald_pair_potential(pts, 1.0, nmax=4, kmax=4)
    d = np.linalg.norm(pts, axis=1)
    ok = d > 0
    du = np.where(ok, d, 1.0)
    newton_f = -pts / du[:, None] ** 3
    newton_p = -1.0 / du
    f_corr = f_ew - np.where(ok[:, None], newton_f, 0.0)
    p_corr = p_ew - np.where(ok, newton_p, 0.0)
    # r=0: correction finite (self-image force cancels; potential = const)
    f_corr[~ok] = 0.0
    force = f_corr.reshape(res, res, res, 3).astype(np.float32)
    pot = p_corr.reshape(res, res, res).astype(np.float32)
    tmp = f"{path[:-4]}.{os.getpid()}.npz"   # np.savez keeps a .npz name
    np.savez(tmp, force=force, pot=pot)
    os.replace(tmp, path)
    _EWALD_CACHE[key] = (force, pot)
    return force, pot


_DEVICE_TABLES: dict = {}


def device_table(res: int, device):
    """The correction table (force [res, res, res, 3], pot [res, res,
    res]) as float32 tensors on ``device``, kept per (res, device)."""
    key = (res, str(device))
    if key not in _DEVICE_TABLES:
        force, pot = ewald_correction_table(res)
        _DEVICE_TABLES[key] = (torch.from_numpy(force).to(device),
                               torch.from_numpy(pot).to(device))
    return _DEVICE_TABLES[key]


def ewald_correction(dx: torch.Tensor, box: float, table):
    """Trilinear interpolation of the correction acc / pot for the
    displacements ``dx`` [..., 3] (any real offsets, folded into the
    symmetric octant). Returns (acc_corr [..., 3], pot_corr [...]) with
    the box units applied: acc ~ 1 / L^2, pot ~ 1 / L."""
    force_t, pot_t = table
    res = pot_t.shape[0]
    u = dx / box
    u = u - torch.round(u)                      # [-0.5, 0.5]
    sign = torch.sign(u)
    a = u.abs() * (2.0 * (res - 1))             # [0, res - 1]
    i0 = torch.floor(a).to(torch.int64).clamp(0, res - 2)
    fr = a - i0
    flat_f = force_t.reshape(-1, 3)
    flat_p = pot_t.reshape(-1)
    acc = torch.zeros_like(dx)
    pot = torch.zeros_like(dx[..., 0])
    for cx in (0, 1):
        wx = fr[..., 0] if cx else 1 - fr[..., 0]
        for cy in (0, 1):
            wy = fr[..., 1] if cy else 1 - fr[..., 1]
            for cz in (0, 1):
                wz = fr[..., 2] if cz else 1 - fr[..., 2]
                w = wx * wy * wz
                idx = ((i0[..., 0] + cx) * res + i0[..., 1] + cy) * res \
                    + i0[..., 2] + cz
                acc = acc + w[..., None] * flat_f[idx]
                pot = pot + w * flat_p[idx]
    return acc * sign / box ** 2, pot / box


def direct_periodic_forces(pos: np.ndarray, mass: np.ndarray, box: float,
                           nmax: int = 4, kmax: int = 4) -> np.ndarray:
    """O(N^2) exactly-periodic accelerations (no G) — the forcetest oracle
    [G2: gravity_forcetest()]. Point masses, no softening."""
    n = len(pos)
    acc = np.zeros((n, 3))
    for i in range(n):
        r = pos[i] - pos  # [N,3]
        f = ewald_pair_force(r, box, nmax=nmax, kmax=kmax)
        f[i] = 0.0  # self images cancel by symmetry; avoid 0/0
        acc[i] = (mass[:, None] * f).sum(axis=0)
    return acc
