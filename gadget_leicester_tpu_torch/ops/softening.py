"""Spline-softened gravity kernels [G2: forcetree.c softening branch].

Counterpart of ``gadget_leicester_tpu/ops/softening.py`` (``SOFTFAC``,
``grav_fac``, ``grav_pot``). Force softening length h = 2.8 epsilon; for
r >= h the force is Newtonian. ``grav_fac(r, h)`` returns g(r) with
acc_i = -G m_j g(r) (x_i - x_j).

Also holds the division-free forms the short-range kernels use
(:func:`grav_fac_nodiv` and :func:`grav_pot_nodiv`, counterparts of
``ops/pallas_cells.py::_grav_fac_nodiv``, ``_grav_pot_nodiv``) and the
erfc polynomial of the potential truncation (:data:`ERFC_P10`,
:func:`erfc_trunc`; ``pallas_cells.py:162-174``).
"""

from __future__ import annotations

import torch

SOFTFAC = 2.8  # h = 2.8 epsilon [G2: gravtree.c :: set_softenings()]


def grav_fac(r: torch.Tensor, h_soft) -> torch.Tensor:
    """Softened 1/r^3 force factor; ``h_soft`` is the force softening."""
    h_soft = torch.as_tensor(h_soft, dtype=r.dtype, device=r.device)
    safe_r = torch.where(r > 0, r, torch.ones_like(r))
    rinv = 1.0 / safe_r
    hinv = torch.where(h_soft > 0, 1.0 / h_soft.clamp_min(1e-37),
                       torch.zeros_like(h_soft))
    u = torch.where(r > 0, r * hinv, torch.zeros_like(r))
    h3inv = hinv * hinv * hinv
    uinv = torch.where(u > 0, 1.0 / u.clamp_min(1e-37), torch.zeros_like(u))
    uinv3 = uinv * uinv * uinv
    inner = h3inv * (10.666666666667 + u * u * (32.0 * u - 38.4))
    outer = h3inv * (21.333333333333 - 48.0 * u + 38.4 * u * u
                     - 10.666666666667 * (u * u * u) - 0.066666666667 * uinv3)
    newton = rinv * rinv * rinv
    fac = torch.where(u < 0.5, inner, torch.where(u < 1.0, outer, newton))
    return torch.where(r > 0, fac, torch.zeros_like(fac))


def grav_pot(r: torch.Tensor, h_soft) -> torch.Tensor:
    """Softened potential factor: phi = G m grav_pot(r, h); -1/r outside
    the kernel, finite (-2.8/h) at r = 0."""
    h_soft = torch.as_tensor(h_soft, dtype=r.dtype, device=r.device)
    safe_r = torch.where(r > 0, r, torch.ones_like(r))
    rinv = 1.0 / safe_r
    hinv = torch.where(h_soft > 0, 1.0 / h_soft.clamp_min(1e-37),
                       torch.zeros_like(h_soft))
    u = r * hinv
    uinv = torch.where(u > 0, 1.0 / u.clamp_min(1e-37), torch.zeros_like(u))
    wp_inner = -2.8 + u * u * (5.333333333333 + u * u * (6.4 * u - 9.6))
    wp_outer = (-3.2 + 0.066666666667 * uinv
                + u * u * (10.666666666667
                           + u * (-16.0 + u * (9.6 - 2.133333333333 * u))))
    pot = torch.where(u < 0.5, hinv * wp_inner,
                      torch.where(u < 1.0, hinv * wp_outer, -rinv))
    return torch.where(r > 0, pot, -2.8 * hinv)


def grav_fac_nodiv(r, rinv, h, hinv):
    """grav_fac with no divisions: the caller supplies rinv (rsqrt) and
    the pair's hinv = min of the two inverse softenings."""
    u = r * hinv
    hinv3 = hinv * hinv * hinv
    rinv3 = rinv * rinv * rinv
    uinv3 = h * h * h * rinv3
    inner = hinv3 * (10.666666666667 + u * u * (32.0 * u - 38.4))
    outer = hinv3 * (21.333333333333 - 48.0 * u + 38.4 * u * u
                     - 10.666666666667 * (u * u * u)
                     - 0.066666666667 * uinv3)
    return torch.where(u < 0.5, inner, torch.where(u < 1.0, outer, rinv3))


def grav_pot_nodiv(r, rinv, h, hinv):
    """grav_pot with no divisions (phi / (G m)): the softened branch
    inside h, -1/r outside; the caller excludes r = 0."""
    u = r * hinv
    uinv = h * rinv
    wp_inner = -2.8 + u * u * (5.333333333333 + u * u * (6.4 * u - 9.6))
    wp_outer = (-3.2 + 0.066666666667 * uinv
                + u * u * (10.666666666667
                           + u * (-16.0 + u * (9.6 - 2.133333333333 * u))))
    return torch.where(u < 0.5, hinv * wp_inner,
                       torch.where(u < 1.0, hinv * wp_outer, -rinv))


# erfc(x) as a degree-10 polynomial on x in [0, 2.25] (max |err| 5.2e-7):
# the JAX package's _ERFC_P10, written out again in csrc/glt_common.cuh
ERFC_P10 = (0.999999923, -1.1283663, -0.000326738866, 0.379212313,
            -0.0145173017, -0.0737919465, -0.0643211737, 0.0932881235,
            -0.0418223107, 0.0086528472, -0.000708430614)


def erfc_trunc(r, asmth: float):
    """erfc(r / (2 asmth)) by :data:`ERFC_P10`, x clamped to 2.25; the
    caller masks r >= rcut, so x never leaves the fitted range."""
    x = torch.clamp(r * (0.5 / asmth), max=2.25)
    p = torch.full_like(x, ERFC_P10[-1])
    for c in ERFC_P10[-2::-1]:
        p = p * x + c
    return p
