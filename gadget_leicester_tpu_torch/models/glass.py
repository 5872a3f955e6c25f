"""Glass files [G2: Makefile -DMAKEGLASS=n, with gravity's sign reversed].

Counterpart of ``gadget_leicester_tpu/models/glass.py`` (``_glass_relax``,
``make_glass``). A glass is a uniform particle distribution without the
shot noise of a random one: Poisson positions relaxed under gravity of the
opposite sign (particles repel), with every step's velocity thrown away
(the limit of heavy friction), until the residual force is small; the low
noise ICs of cosmological runs start from one. The force is the periodic
PM mesh alone (``ops/pm.py::pm_forces_periodic``: the point CIC deposit,
cuFFT and kernel L's gather on the card), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from gadget_leicester_tpu_torch.ops.pm import pm_forces_periodic


def _glass_relax(pos: torch.Tensor, box: float, grid_n: int, n_steps: int,
                 step_fac: float):
    """``n_steps`` displacement steps of at most ``step_fac`` 0.96^j along
    the reversed PM force, wrapped into the box: (positions, the largest
    |acc| of each step [n_steps]). The history stays on the device, so no
    step waits on the host."""
    n = pos.shape[0]
    mass = torch.ones(n, dtype=pos.dtype, device=pos.device)
    alive = torch.ones(n, dtype=torch.bool, device=pos.device)
    amax_hist = []
    for j in range(n_steps):
        acc = pm_forces_periodic(pos, mass, alive, box, grid_n)
        amax = torch.sqrt((acc * acc).sum(-1)).max()
        # the step shrinks geometrically so that the relaxation settles
        # instead of bouncing at a fixed amplitude
        step = step_fac * 0.96 ** j
        disp = -acc / amax.clamp_min(1e-30) * step
        pos = torch.remainder(pos + disp, box)
        amax_hist.append(amax)
    return pos, torch.stack(amax_hist)


def make_glass(n_side: int, box: float = 1.0, seed: int = 4,
               n_steps: int = 60, grid_n: int | None = None,
               device="cuda"):
    """[n_side^3, 3] glass positions (numpy float32) in a periodic box of
    side ``box``, and the largest |acc| of each relaxation step; from
    seeded uniform positions, on a PM mesh of max(16, 2 n_side) cells a
    side unless ``grid_n`` is given."""
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(0, box, (n_side ** 3, 3)),
                          dtype=torch.float32, device=device)
    g = grid_n or max(16, 2 * n_side)
    pos, amax = _glass_relax(pos, box, g, n_steps, 0.15 * box / n_side)
    return pos.cpu().numpy(), amax.cpu().numpy()
