"""SoA particle state as dataclasses of tensors [G2: allvars.h particle
structs].

Counterpart of ``gadget_leicester_tpu/core/state.py`` (``ParticleState``,
``GasState``, ``SinkState``, ``SimState``, ``allocate``, ``from_arrays``),
plus the bridge the JAX package has no need for: :func:`from_numpy` and
:func:`to_numpy` carry a state across as a dict of numpy arrays keyed by
the JAX ``SimState`` field paths (``"p.pos"``, ``"gas.density"``,
``"ti_current"`` ...). The JAX ``rng_key`` has no counterpart here and is
not carried; the grid cache is derived data and is not carried either (a
state without one builds its grids fresh on every force pass).

Layout as in the JAX package: fixed capacity rounded up to
``PAD_MULTIPLE``, dead slots masked by ``alive``, gas in slots
``[0, n_gas)`` with its SPH fields in a parallel :class:`GasState`. The
timeline fields and ``pid`` are int32, exactly as the JAX package keeps
them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gadget_leicester_tpu_torch.core.config import SimOptions

PAD_MULTIPLE = 256  # capacity rounding, the same as the JAX package
N_SINKS_MAX = 64    # sink slots, the same as the JAX package


def _round_up(n: int, m: int = PAD_MULTIPLE) -> int:
    return max(m, ((n + m - 1) // m) * m)


@dataclass
class ParticleState:
    """All-particle fields [G2: allvars.h struct particle_data]."""

    pos: torch.Tensor        # [N,3]
    vel: torch.Tensor        # [N,3] internal velocity variable
    mass: torch.Tensor       # [N]
    ptype: torch.Tensor      # [N] int32, 0..5
    pid: torch.Tensor        # [N] int32
    acc: torch.Tensor        # [N,3] short-range gravitational acceleration
    acc_pm: torch.Tensor     # [N,3] long-range PM acceleration (frozen
                             # between PM steps)
    pot: torch.Tensor        # [N]
    pot_pm: torch.Tensor     # [N] PM potential piece (frozen like acc_pm)
    old_acc: torch.Tensor    # [N] |acc| of the previous step
    ti_begstep: torch.Tensor  # [N] int32
    ti_endstep: torch.Tensor  # [N] int32
    alive: torch.Tensor      # [N] bool

    @property
    def n_max(self) -> int:
        return self.pos.shape[0]


@dataclass
class GasState:
    """SPH fields, parallel to P[0:n_gas] [G2: struct sph_particle_data]."""

    entropy: torch.Tensor
    dt_entropy: torch.Tensor
    density: torch.Tensor
    hsml: torch.Tensor
    pressure: torch.Tensor
    vel_pred: torch.Tensor           # [Ng,3]
    div_vel: torch.Tensor
    curl_vel: torch.Tensor
    dhsml_density_factor: torch.Tensor
    max_signal_vel: torch.Tensor
    num_ngb: torch.Tensor
    hydro_acc: torch.Tensor          # [Ng,3]
    entropy_pred: torch.Tensor

    @property
    def n_gas_max(self) -> int:
        return self.entropy.shape[0]


@dataclass
class SinkState:
    """Sink bookkeeping (``models/sinks.py``): the particle index of each
    sink slot, the mass each sink accreted and the gas particles it
    took."""

    slot: torch.Tensor        # [S] int32 (-1 = unused)
    acc_mass: torch.Tensor    # [S]
    n_accreted: torch.Tensor  # [S] int32


@dataclass
class SimState:
    """Full dynamical state."""

    p: ParticleState
    gas: GasState
    sinks: SinkState
    ti_current: torch.Tensor     # 0-d int32
    pm_ti_endstep: torch.Tensor  # 0-d int32
    pm_ti_begstep: torch.Tensor  # 0-d int32
    overflow_flags: torch.Tensor  # 0-d int32: 1 = SR cells over capacity,
                                  # 2 = SPH cells over capacity (sticky)
    grids: object = None         # models.grids.GridCache | None

    @property
    def n_max(self) -> int:
        return self.p.n_max

    @property
    def n_gas_max(self) -> int:
        return self.gas.n_gas_max

    @property
    def device(self) -> torch.device:
        return self.p.pos.device


def _float_dtype(opts: SimOptions) -> torch.dtype:
    return torch.float64 if opts.dtype == "f64" else torch.float32


def allocate(n: int, n_gas: int, opts: SimOptions, device) -> SimState:
    """Fixed-capacity allocation [G2: allocate.c :: allocate_memory()]."""
    f = _float_dtype(opts)
    nm = _round_up(n)
    ngm = _round_up(max(n_gas, 1))

    def z(*shape, dtype=f):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32 = torch.int32
    p = ParticleState(
        pos=z(nm, 3), vel=z(nm, 3), mass=z(nm), ptype=z(nm, dtype=i32),
        pid=z(nm, dtype=i32), acc=z(nm, 3), acc_pm=z(nm, 3), pot=z(nm),
        pot_pm=z(nm), old_acc=z(nm), ti_begstep=z(nm, dtype=i32),
        ti_endstep=z(nm, dtype=i32), alive=z(nm, dtype=torch.bool))
    gas = GasState(
        entropy=z(ngm), dt_entropy=z(ngm), density=z(ngm), hsml=z(ngm),
        pressure=z(ngm), vel_pred=z(ngm, 3), div_vel=z(ngm),
        curl_vel=z(ngm),
        dhsml_density_factor=torch.ones(ngm, dtype=f, device=device),
        max_signal_vel=z(ngm), num_ngb=z(ngm), hydro_acc=z(ngm, 3),
        entropy_pred=z(ngm))
    sinks = SinkState(
        slot=torch.full((N_SINKS_MAX,), -1, dtype=i32, device=device),
        acc_mass=z(N_SINKS_MAX), n_accreted=z(N_SINKS_MAX, dtype=i32))
    return SimState(p=p, gas=gas, sinks=sinks, ti_current=z(dtype=i32),
                    pm_ti_endstep=z(dtype=i32), pm_ti_begstep=z(dtype=i32),
                    overflow_flags=z(dtype=i32))


def from_arrays(pos, vel, mass, ptype, pid, opts: SimOptions, device,
                u: Optional[np.ndarray] = None) -> SimState:
    """Build a state from host IC arrays (gas first, GADGET type order).
    ``u`` (specific internal energy of the gas) is stashed in the entropy
    slot until init converts it [G2: init.c :: init()]."""
    n = int(pos.shape[0])
    order = np.argsort(ptype, kind="stable")  # gas (type 0) first
    pos, vel, mass = pos[order], vel[order], mass[order]
    ptype, pid = ptype[order], pid[order]
    n_gas = int(np.sum(ptype == 0))
    st = allocate(n, n_gas, opts, device)
    f = st.p.pos.dtype

    def put(dst, src, dtype=f):
        dst[:n] = torch.as_tensor(np.asarray(src), dtype=dtype).to(device)

    put(st.p.pos, pos)
    put(st.p.vel, vel)
    put(st.p.mass, mass)
    put(st.p.ptype, ptype, torch.int32)
    put(st.p.pid, pid, torch.int32)
    st.p.alive[:n] = True
    if u is not None and n_gas:
        st.gas.entropy[:n_gas] = torch.as_tensor(
            np.asarray(u[:n_gas]), dtype=f).to(device)
    return st


# ---------------------------------------------------------------------------
# The numpy bridge
# ---------------------------------------------------------------------------
_GROUPS = {"p": ParticleState, "gas": GasState, "sinks": SinkState}
_SCALARS = ("ti_current", "pm_ti_endstep", "pm_ti_begstep",
            "overflow_flags")


def to_numpy(state: SimState) -> dict:
    """Flatten to ``{"p.pos": ndarray, ..., "ti_current": ndarray}``."""
    out = {}
    for g in _GROUPS:
        sub = getattr(state, g)
        for fld in dataclasses.fields(sub):
            out[f"{g}.{fld.name}"] = getattr(sub, fld.name).cpu().numpy()
    for k in _SCALARS:
        out[k] = getattr(state, k).cpu().numpy()
    return out


def field_manifest() -> list:
    """The keys of :func:`to_numpy`, in its order: the layout tag of a
    restart dump."""
    return [f"{g}.{fld.name}" for g, cls in _GROUPS.items()
            for fld in dataclasses.fields(cls)] + list(_SCALARS)


def from_numpy(arrays: dict, device) -> SimState:
    """Build a state from a dict keyed like :func:`to_numpy`'s output.
    Keys outside the state's fields (a JAX ``rng_key``) are ignored; a
    missing field raises ``KeyError``. Integer and bool fields keep their
    values exactly; floats keep their dtype."""
    groups = {}
    for g, cls in _GROUPS.items():
        kw = {}
        for fld in dataclasses.fields(cls):
            # a copy: arrays handed over from JAX are read-only views
            kw[fld.name] = torch.from_numpy(
                np.array(arrays[f"{g}.{fld.name}"], copy=True)).to(device)
        groups[g] = cls(**kw)
    scalars = {k: torch.tensor(int(arrays[k]), dtype=torch.int32,
                               device=device)
               for k in _SCALARS}
    return SimState(**groups, **scalars)


# How far two runs of the slice may differ: the port against the JAX
# package on the CPU (tests/test_torch_slice.py), the card against the CPU
# (chip_smoke.py). EXACT_FIELDS are equal; each of CLOSE_FIELDS is within
# CLOSE_TOL of its largest value (the tolerance of tests/test_grid_cache.py)
# on all rows but at most MAX_EXCLUDED: a particle whose Newton solve stops
# one sweep apart, or whose timestep bin flips at a quantisation boundary.
CLOSE_TOL = 2e-5
MAX_EXCLUDED = 3
CLOSE_FIELDS = ("p.pos", "p.vel", "p.acc", "p.acc_pm", "gas.density",
                "gas.hsml", "gas.entropy", "gas.pressure", "gas.dt_entropy",
                "gas.hydro_acc", "gas.max_signal_vel",
                "gas.dhsml_density_factor")
EXACT_FIELDS = ("p.ti_begstep", "p.ti_endstep", "p.alive", "p.ptype",
                "ti_current", "pm_ti_endstep", "pm_ti_begstep",
                "overflow_flags")


def assert_states_close(got: dict, want: dict, fields=CLOSE_FIELDS,
                        exact=EXACT_FIELDS) -> dict:
    """Hold two :func:`to_numpy` dicts to the bounds above; raise
    ``AssertionError`` outside them. Returns, per float field, (max
    |got - want| / max |want|, rows beyond ``CLOSE_TOL`` of it)."""
    for k in exact:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{k} differs")
    out = {}
    for k in fields:
        g = np.asarray(got[k], np.float64)
        w = np.asarray(want[k], np.float64)
        scale = max(np.abs(w).max(), 1e-30)
        d = np.abs(g - w).reshape(len(w), -1).max(-1)
        n_out = int((d > CLOSE_TOL * scale).sum())
        out[k] = (float(d.max() / scale), n_out)
        if not np.isfinite(d).all() or n_out > MAX_EXCLUDED:
            raise AssertionError(
                f"{k}: {n_out} rows beyond {CLOSE_TOL} of its largest value "
                f"(at most {MAX_EXCLUDED}), worst {d.max() / scale:.3e}")
    return out
