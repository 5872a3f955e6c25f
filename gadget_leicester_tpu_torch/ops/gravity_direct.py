"""Direct-summation O(N^2) gravity [G2: gravtree_forcetest.c ::
gravity_forcetest()].

Counterpart of ``gadget_leicester_tpu/ops/gravity_direct.py``
(``shortrange_trunc``, ``shortrange_trunc_pot``, ``direct_gravity``): the
gravity of small runs (the gassphere workload, where brute force beats any
tree) and the accuracy oracle of the short-range kernels. Row-blocked
all-pairs: ``block`` targets at a time against all N sources, so peak
memory is ``block * N``. The softening is the spline of
``ops/softening.py``, symmetrised with max(h_i, h_j) [G2: forcetree.c
UNEQUALSOFTENINGS]. Plain PyTorch, as the reference is plain ``jnp``; no
kernel.

With ``asmth > 0`` the same sum is the TreePM short-range force
[G2: forcetree.c :: force_treeevaluate_shortrange()], with the exact erfc
where kernels A, E and H use their polynomial fits.
"""

from __future__ import annotations

import math

import torch

from gadget_leicester_tpu_torch.ops.softening import grav_fac, grav_pot


def _min_image(dx, box: float):
    """Periodic minimum-image convention [G2: NEAREST macro]."""
    return dx - box * torch.round(dx / box)


def shortrange_trunc(r, asmth: float):
    """TreePM short-range truncation of the force [G2: forcetree.c
    shortrange_table; Springel 2005 eq. 17]: erfc(r / (2 asmth))
    + r / (asmth sqrt(pi)) exp(-r^2 / (4 asmth^2))."""
    x = r / (2.0 * asmth)
    return torch.erfc(x) + (2.0 * x / math.sqrt(math.pi)) * torch.exp(-x * x)


def shortrange_trunc_pot(r, asmth: float):
    """Truncation of the potential: phi_short = -(m / r) erfc(r / (2
    asmth))."""
    return torch.erfc(r / (2.0 * asmth))


def direct_gravity(pos, mass, soft, alive, box: float = 0.0,
                   asmth: float = 0.0, rcut: float = 0.0, block: int = 1024,
                   periodic: bool = False, with_potential: bool = True):
    """(acc [N, 3], pot [N]) without the factor G (the caller applies it
    once, as [G2: gravtree.c] does). ``soft`` is the per-particle force
    softening h = 2.8 eps; ``asmth > 0`` switches the erfc short-range
    truncation on and ``rcut > 0`` also zeroes the force beyond rcut. Dead
    particles source nothing and get zeros."""
    n = pos.shape[0]
    zero1 = torch.zeros_like(mass)
    src_mass = torch.where(alive, mass, zero1)[None, :]
    accs, pots = [], []
    for i0 in range(0, n, block):
        dx = pos[i0:i0 + block, None, :] - pos[None, :, :]
        if periodic:
            dx = _min_image(dx, box)
        r = torch.sqrt((dx * dx).sum(-1))
        h = torch.maximum(soft[i0:i0 + block, None], soft[None, :])
        fac = grav_fac(r, h)                       # ~1/r^3, 0 at r = 0
        if asmth > 0.0:
            fac = fac * shortrange_trunc(r, asmth)
        if rcut > 0.0:
            fac = torch.where(r < rcut, fac, torch.zeros_like(fac))
        w = src_mass * fac
        accs.append(-(w[:, :, None] * dx).sum(1))
        if with_potential:
            pw = grav_pot(r, h)
            if asmth > 0.0:
                # outside the softening kernel the truncated -erfc / r;
                # inside, the softened form (h << asmth in practice)
                pw_trunc = -shortrange_trunc_pot(r, asmth) \
                    / r.clamp_min(1e-37)
                pw = torch.where(r >= h, pw_trunc, pw)
            # no self term (the r == 0 diagonal)
            pw = torch.where(r > 0, pw, torch.zeros_like(pw))
            pots.append((src_mass * pw).sum(-1))
    acc = torch.cat(accs)
    pot = torch.cat(pots) if with_potential else zero1
    return (torch.where(alive[:, None], acc, torch.zeros_like(acc)),
            torch.where(alive, pot, zero1))
