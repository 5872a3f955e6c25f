"""Integer timeline utilities [G2: allvars.h TIMEBASE, timestep.c, run.c].

Counterpart of ``gadget_leicester_tpu/core/timeline.py``
(``ti_to_time``, ``quantize_timestep``, ``min_active_ti_end``,
``active_mask``).

The run interval [TimeBegin, TimeMax] maps onto an integer timeline of
2^28 ticks; per-particle timesteps are power-of-two numbers of ticks so
that particle steps nest and sync points are exact integers. Comoving runs
use log(a) spacing, physical runs linear t spacing [G2: begrun.c].

Ticks are int32 tensors, as in the JAX package (2^28 fits, and the JAX
state carries its timeline fields as int32).
"""

from __future__ import annotations

import math

import torch

from gadget_leicester_tpu_torch.core.config import TIMEBASE, SimConfig


def ti_to_time(ti: int, cfg: SimConfig) -> float:
    """Integer tick -> scale factor a (comoving) or time t (physical)."""
    if cfg.comoving_integration_on:
        return cfg.time_begin * math.exp(ti * cfg.timebase_interval)
    return cfg.time_begin + ti * cfg.timebase_interval


def quantize_timestep(ti_step_f: torch.Tensor, ti_current: torch.Tensor,
                      ti_end_max: int = TIMEBASE) -> torch.Tensor:
    """Round a tick count down to a power of two that the current time
    subdivides [G2: timestep.c :: advance_and_find_timesteps()].

    A particle at ``ti_current`` may only take a step of 2^k ticks if
    ti_current is a multiple of 2^k. Returns the int32 step (>= 1)."""
    ti_step_f = ti_step_f.clamp(1.0, float(ti_end_max))
    k = torch.floor(torch.log2(ti_step_f)).to(torch.int32)
    step = torch.bitwise_left_shift(torch.ones_like(k), k)
    ti = ti_current.to(torch.int32)
    # largest power-of-two divisor of ti is ti & -ti; ti == 0 allows any
    max_div = torch.where(ti == 0, torch.full_like(ti, ti_end_max), ti & -ti)
    step = torch.minimum(step, max_div)
    return step.clamp_min(1).to(torch.int32)


def min_active_ti_end(ti_endstep: torch.Tensor,
                      alive: torch.Tensor) -> torch.Tensor:
    """Next global sync point = min over alive particles of ti_endstep
    [G2: run.c :: find_next_sync_point_and_drift()]. 0-d int32."""
    big = torch.full_like(ti_endstep, 2 * TIMEBASE)
    return torch.where(alive, ti_endstep, big).min()


def active_mask(ti_endstep: torch.Tensor, ti_current: torch.Tensor,
                alive: torch.Tensor) -> torch.Tensor:
    """Particles whose step ends exactly now are 'active'."""
    return (ti_endstep == ti_current) & alive
