"""W4 cubic-spline SPH kernel, GADGET convention (support radius h).

Counterpart of ``gadget_leicester_tpu/ops/sph_kernels.py`` (``kernel_w``,
``kernel_dw_dr``, ``kernel_w_and_dwdh``); the same constants are written
out in ``csrc/glt_common.cuh`` for the CUDA kernels. With u = r/h:

    W(u) = 8/(pi h^3) (1 - 6u^2 + 6u^3)     0 <= u < 1/2
         = 8/(pi h^3) 2 (1-u)^3             1/2 <= u < 1
         = 0                                u >= 1
"""

from __future__ import annotations

import math

import torch

NORM_3D = 8.0 / math.pi  # KERNEL_COEFF_1


def _hinv(h):
    return torch.where(h > 0, 1.0 / h, torch.zeros_like(h))


def _wu(u):
    one_m = 1.0 - u
    w_inner = 1.0 - 6.0 * u * u + 6.0 * u * u * u
    w_outer = 2.0 * one_m * one_m * one_m
    zero = torch.zeros_like(u)
    return torch.where(u < 0.5, w_inner, torch.where(u < 1.0, w_outer, zero))


def _du(u):
    one_m = 1.0 - u
    d_inner = u * (18.0 * u - 12.0)
    d_outer = -6.0 * one_m * one_m
    zero = torch.zeros_like(u)
    return torch.where(u < 0.5, d_inner, torch.where(u < 1.0, d_outer, zero))


def kernel_w(r, h):
    """W(r, h); zero outside the support and at h == 0."""
    hinv = _hinv(h)
    return NORM_3D * hinv * hinv * hinv * _wu(r * hinv)


def kernel_dw_dr(r, h):
    """dW/dr."""
    hinv = _hinv(h)
    hinv2 = hinv * hinv
    return NORM_3D * hinv2 * hinv2 * _du(r * hinv)


def kernel_w_and_dwdh(r, h):
    """(W, dW/dh) with dW/dh = -(1/h)(3 W + u dW/du)
    [G2: density.c :: density_evaluate()]."""
    hinv = _hinv(h)
    u = r * hinv
    wu = _wu(u)
    du = _du(u)
    hinv3 = hinv * hinv * hinv
    w = NORM_3D * hinv3 * wu
    dwdh = -NORM_3D * hinv3 * hinv * (3.0 * wu + u * du)
    return w, dwdh
