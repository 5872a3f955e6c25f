"""Comoving drift/kick factors [G2: driftfac.c].

Counterpart of ``gadget_leicester_tpu/core/cosmology.py``
(``hubble_function``, ``drift_factor``, ``gravkick_factor``,
``hydrokick_factor``). Like the JAX package, each interval integral is
evaluated directly with 3-point Gauss-Legendre quadrature in log(a):
differencing a cumulative table cancels catastrophically in float32 for
small steps. The reference tables (``DriftTables``) are not carried over:
nothing on the integration path reads them.

Everything is float32 on the device of the tick tensors, in the same
operation order as the JAX package.
"""

from __future__ import annotations

import math

import torch

from gadget_leicester_tpu_torch.core.config import GAMMA, SimConfig

# 3-point Gauss-Legendre nodes and weights on [0, 1]
_GL = (
    (0.1127016653792583, 0.2777777777777778),
    (0.5, 0.4444444444444444),
    (0.8872983346207417, 0.2777777777777778),
)


def hubble_function(a, omega0: float, omega_lambda: float, hubble: float):
    """H(a) = Hubble * sqrt(Omega0/a^3 + (1-Omega0-OmegaLambda)/a^2
    + OmegaLambda), for a tensor or a float ``a``."""
    omega_k = 1.0 - omega0 - omega_lambda
    inner = omega0 / a**3 + omega_k / a**2 + omega_lambda
    if isinstance(inner, torch.Tensor):
        return hubble * torch.sqrt(inner)
    return hubble * math.sqrt(inner)


def _interval_quad(cfg: SimConfig, ti0: torch.Tensor, ti1: torch.Tensor,
                   power: float) -> torch.Tensor:
    """int_{a0}^{a1} da / (H(a) a^power) over each tick interval, as
    int f dloga with f = 1/(H(a) a^(power-1))."""
    ti0, ti1 = torch.broadcast_tensors(ti0, ti1)
    la0 = ti0.to(torch.float32) * cfg.timebase_interval \
        + math.log(cfg.time_begin)
    dla = (ti1 - ti0).to(torch.float32) * cfg.timebase_interval
    total = torch.zeros_like(la0)
    for x, w in _GL:
        a = torch.exp(la0 + dla * x)
        f = 1.0 / (hubble_function(a, cfg.omega0, cfg.omega_lambda,
                                   cfg.hubble_internal) * a ** (power - 1.0))
        total = total + w * f
    return dla * total


def _linear(cfg: SimConfig, ti0, ti1) -> torch.Tensor:
    return (ti1 - ti0).to(torch.float32) * cfg.timebase_interval


def drift_factor(cfg: SimConfig, ti0, ti1) -> torch.Tensor:
    """int dt/a^2 over [ti0, ti1] (vectorises over particle intervals)."""
    if cfg.comoving_integration_on:
        return _interval_quad(cfg, ti0, ti1, 3.0)
    return _linear(cfg, ti0, ti1)


def gravkick_factor(cfg: SimConfig, ti0, ti1) -> torch.Tensor:
    """int dt/a over [ti0, ti1]."""
    if cfg.comoving_integration_on:
        return _interval_quad(cfg, ti0, ti1, 2.0)
    return _linear(cfg, ti0, ti1)


def hydrokick_factor(cfg: SimConfig, ti0, ti1) -> torch.Tensor:
    """int dt/a^{3(gamma-1)+1} over [ti0, ti1] (entropy-form hydro kick)."""
    if cfg.comoving_integration_on:
        return _interval_quad(cfg, ti0, ti1, 3.0 * (GAMMA - 1.0) + 1.0)
    return _linear(cfg, ti0, ti1)
