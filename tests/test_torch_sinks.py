"""The fork's sinks on the CPU: ``register_sinks_from_types``,
``accrete_onto_sinks`` and ``create_sinks`` of the port against the JAX
package's on the same carried states. Slots, ``n_accreted``, ``alive`` and
``ptype`` are equal; masses and velocities within 1e-6 of their largest
value. Plus the periodic minimum image, two equidistant sinks (the lower
slot takes the gas, as ``argmin`` gives it) and two equally dense
candidates (the first index forms, as ``argmax`` gives it)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.core.config import SimOptions as JOptions
from gadget_leicester_tpu.core.state import from_arrays as j_from_arrays
from gadget_leicester_tpu.models import sinks as jsinks
from gadget_leicester_tpu.models.ics import disc_ics
from gadget_leicester_tpu.models.simulation import Simulation as JSimulation
from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                    parse_parameter_text)
from gadget_leicester_tpu_torch.core.state import from_numpy, to_numpy
from gadget_leicester_tpu_torch.models import sinks
from tests.test_config import GASSPHERE_PARAM
from tests.test_features import _cfg as j_cfg
from tests.test_torch_slice import _jax_dict

EXACT = ("sinks.slot", "sinks.n_accreted", "p.alive", "p.ptype")
CLOSE = ("p.mass", "p.vel", "sinks.acc_mass")
REL = 1e-6


def port_cfg(**repl):
    """tests/test_features.py's ``_cfg`` (the gassphere parameters with G
    = 1 and the lines ``repl``) through the port's parser."""
    txt = GASSPHERE_PARAM.replace("GravityConstantInternal  0",
                                  "GravityConstantInternal  1.0")
    for k, v in repl.items():
        txt += f"\n{k} {v}\n"
    return parse_parameter_text(txt)


def assert_same(got: dict, want: dict):
    for k in EXACT:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in CLOSE:
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=REL * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


def _both(jst, **extra):
    """(JAX state, port state carried from it, JAX cfg, port cfg)."""
    return (jst, from_numpy(_jax_dict(jst), "cpu"), j_cfg(**extra),
            port_cfg(**extra))


DISC = dict(SofteningBndry=0.05, SinkAccretionRadius=0.35,
            MaxSizeTimestep=0.01)


@pytest.fixture(scope="module")
def disc():
    """disc_ics(n_gas=400, r_in=0.2) initialised by the JAX package with
    sinks on (direct gravity, all-pairs SPH), velocities given a seeded
    2% scatter: on exact circular orbits the sign of dv . dx, which decides
    ``approaching``, is a rounding residue."""
    pos, vel, mass, ptype, u = disc_ics(n_gas=400, r_in=0.2)
    rng = np.random.default_rng(11)
    vel = vel + 0.02 * rng.standard_normal(vel.shape) \
        * np.linalg.norm(vel, axis=1, keepdims=True)
    jsim = JSimulation(j_cfg(**DISC), JOptions(sinks=True))
    jsim.set_ics(pos, vel, mass, ptype, u=u)
    return jsim.state


def test_register_sinks_from_types_matches_jax(disc):
    jst, st, _, _ = _both(disc, **DISC)
    got = to_numpy(sinks.register_sinks_from_types(st))
    want = _jax_dict(jsinks.register_sinks_from_types(jst))
    assert_same(got, want)
    # the star, last of the 400 gas and itself
    assert got["sinks.slot"][0] == 400 and (got["sinks.slot"][1:] == -1).all()


def test_accretion_onto_the_star_matches_jax(disc):
    jst, st, jcfg, cfg = _both(jsinks.register_sinks_from_types(disc), **DISC)
    want = _jax_dict(jsinks.accrete_onto_sinks(jst, jcfg,
                                               JOptions(sinks=True)))
    out = sinks.accrete_onto_sinks(st, cfg, SimOptions(sinks=True))
    got = to_numpy(out)
    assert_same(got, want)
    n_acc = int(got["sinks.n_accreted"].sum())
    assert n_acc > 0
    assert int(st.p.alive.sum()) - int(out.p.alive.sum()) == n_acc
    m0 = float(st.p.mass[st.p.alive].double().sum())
    m1 = float(out.p.mass[out.p.alive].double().sum())
    assert m1 == pytest.approx(m0, rel=1e-6)
    mom = [(s.p.mass[s.p.alive, None].double()
            * s.p.vel[s.p.alive].double()).sum(0) for s in (st, out)]
    scale = float((st.p.mass[:, None] * st.p.vel).abs().sum())
    assert float((mom[1] - mom[0]).abs().max()) <= 1e-6 * scale


def _with_formed_sinks(jst, idx, mass=0.05):
    """``jst`` with the gas particles ``idx`` turned into type-5 sinks of
    ``mass`` each and every type-5 particle registered, in index order
    (the star last)."""
    ptype = np.asarray(jst.p.ptype).copy()
    ptype[idx] = 5
    m = np.asarray(jst.p.mass).copy()
    m[idx] = mass
    jst = dataclasses.replace(jst, p=dataclasses.replace(
        jst.p, ptype=jnp.asarray(ptype), mass=jnp.asarray(m)))
    return jsinks.register_sinks_from_types(jst)


def test_accretion_onto_several_sinks_matches_jax(disc):
    """Three sinks among the gas as well as the star: each gas particle
    goes to the nearest claiming sink, slots and tallies as in JAX."""
    r = np.linalg.norm(np.asarray(disc.p.pos)[:400], axis=1)
    idx = np.argsort(np.abs(r - 1.0))[:3]
    jst, st, jcfg, cfg = _both(_with_formed_sinks(disc, idx), **DISC)
    assert int((st.sinks.slot >= 0).sum()) == 4
    want = _jax_dict(jsinks.accrete_onto_sinks(jst, jcfg,
                                               JOptions(sinks=True)))
    got = to_numpy(sinks.accrete_onto_sinks(st, cfg, SimOptions(sinks=True)))
    assert_same(got, want)
    assert (got["sinks.n_accreted"][:4] > 0).sum() >= 2


def _tiny(pos, vel, mass, ptype, periodic=False, slot=None):
    """A hand-made JAX state (no gas density yet, so u = 0) and its port
    twin; ``slot`` replaces the registered sink slots."""
    pos, vel = np.asarray(pos, float), np.asarray(vel, float)
    jst = j_from_arrays(pos, vel, np.asarray(mass, float),
                        np.asarray(ptype, np.int32),
                        np.arange(1, len(pos) + 1),
                        JOptions(periodic=periodic))
    jst = jsinks.register_sinks_from_types(jst)
    if slot is not None:
        s = np.full(jst.sinks.slot.shape, -1, np.int32)
        s[:len(slot)] = slot
        jst = dataclasses.replace(jst, sinks=dataclasses.replace(
            jst.sinks, slot=jnp.asarray(s)))
    return jst, from_numpy(_jax_dict(jst), "cpu")


def test_equidistant_sinks_give_the_gas_to_the_lower_slot():
    """A gas particle midway between two equal sinks that both approach
    it: the lower slot takes it, as the reference's argmin does, although
    that slot holds the higher particle index."""
    pos = [[0, 0, 0], [0.1, 0, 0], [-0.1, 0, 0]]
    vel = [[0, 0, 0], [-0.1, 0, 0], [0.1, 0, 0]]
    jst, st = _tiny(pos, vel, [0.01, 1.0, 1.0], [0, 5, 5], slot=[2, 1])
    extra = dict(SofteningBndry=0.05, SinkAccretionRadius=0.2)
    jcfg, cfg = j_cfg(**extra), port_cfg(**extra)
    want = _jax_dict(jsinks.accrete_onto_sinks(jst, jcfg,
                                               JOptions(sinks=True)))
    got = to_numpy(sinks.accrete_onto_sinks(st, cfg, SimOptions(sinks=True)))
    assert_same(got, want)
    assert got["sinks.n_accreted"][:2].tolist() == [1, 0]
    assert got["p.mass"][2] == pytest.approx(1.01) and got["p.mass"][1] == 1.0
    assert not got["p.alive"][0]


@pytest.mark.parametrize("periodic", [True, False])
def test_accretion_takes_the_minimum_image(periodic):
    """A sink at x = 0.99 of a unit periodic box and a gas particle at
    0.01 moving toward it across the boundary: 0.02 apart by the minimum
    image, accreted; in vacuum they are 0.98 apart and nothing happens."""
    pos = [[0.01, 0.5, 0.5], [0.99, 0.5, 0.5]]
    vel = [[-0.1, 0, 0], [0, 0, 0]]
    jst, st = _tiny(pos, vel, [0.01, 1.0], [0, 5], periodic=periodic)
    extra = dict(SofteningBndry=0.05, SinkAccretionRadius=0.05,
                 BoxSize=1.0, PeriodicBoundariesOn=int(periodic))
    jcfg, cfg = j_cfg(**extra), port_cfg(**extra)
    want = _jax_dict(jsinks.accrete_onto_sinks(
        jst, jcfg, JOptions(sinks=True, periodic=periodic)))
    got = to_numpy(sinks.accrete_onto_sinks(
        st, cfg, SimOptions(sinks=True, periodic=periodic)))
    assert_same(got, want)
    assert int(got["sinks.n_accreted"].sum()) == int(periodic)


FORM = dict(SofteningBndry=0.05, SinkAccretionRadius=0.03)


def _formation_state(disc, seed=3, tie=False):
    """The disc with a seeded sign for div v (converging where negative)
    and the formation threshold at the 95th percentile of the density;
    with ``tie``, the two densest converging gas particles share the
    largest density. Returns (JAX state, threshold)."""
    ng = disc.gas.density.shape[0]      # 400 gas, padded
    rng = np.random.default_rng(seed)
    div = np.where(rng.uniform(size=ng) < 0.6, -1.0, 1.0).astype(np.float32)
    rho = np.asarray(disc.gas.density).copy()
    if tie:
        conv = np.flatnonzero(div < 0)
        top = conv[np.argsort(rho[conv])[-2:]]
        rho[top] = rho.max() * 1.5
    gas = dataclasses.replace(disc.gas, div_vel=jnp.asarray(div),
                              density=jnp.asarray(rho))
    return dataclasses.replace(disc, gas=gas), float(np.quantile(rho, 0.95))


@pytest.mark.parametrize("tie", [False, True])
def test_create_sinks_matches_jax(disc, tie):
    """Four calls in turn: at most one sink a call, the densest candidate
    that is the potential minimum within the accretion radius, in the
    first free slot; the type flips to 5 in place. Slots and types equal
    to JAX after every call; with ``tie`` the first of two equally dense
    candidates forms."""
    jst, thr = _formation_state(disc, tie=tie)
    jst = jsinks.register_sinks_from_types(jst)
    extra = dict(FORM, SinkFormationDensity=thr)
    jst, st, jcfg, cfg = _both(jst, **extra)
    formed = []
    for _ in range(4):
        jst = jsinks.create_sinks(jst, jcfg, JOptions(sinks=True))
        st = sinks.create_sinks(st, cfg, SimOptions(sinks=True))
        got, want = to_numpy(st), _jax_dict(jst)
        assert_same(got, want)
        formed.append(int((got["sinks.slot"] >= 0).sum()))
    assert formed[-1] > 1 and all(b - a <= 1 for a, b in
                                  zip([1] + formed, formed))
    if tie:
        rho = st.gas.density.numpy()
        ties = np.flatnonzero(rho == rho.max())
        assert len(ties) == 2 and got["sinks.slot"][1] == ties[0]


def test_create_sinks_refuses_a_candidate_that_is_no_potential_minimum(disc):
    """A gas neighbour within the accretion radius with a deeper potential
    blocks formation, in both packages."""
    jst, thr = _formation_state(disc)
    extra = dict(FORM, SinkFormationDensity=thr)
    jst, st, jcfg, cfg = _both(jst, **extra)
    ng = st.n_gas_max
    best = sinks.first_argmax(torch.where(
        (st.gas.density > thr) & (st.gas.div_vel < 0)
        & (st.p.ptype[:ng] == 0) & st.p.alive[:ng], st.gas.density,
        torch.full_like(st.gas.density, -1.0)))
    pos = st.p.pos.numpy()
    d = np.linalg.norm(pos[:400] - pos[int(best)], axis=1)
    d[int(best)] = np.inf
    nb = int(np.argmin(d))
    pot = np.asarray(jst.p.pot).copy()
    pot[nb] = pot[int(best)] - 1.0
    extra["SinkAccretionRadius"] = 1.01 * d[nb]
    jst = dataclasses.replace(jst, p=dataclasses.replace(
        jst.p, pot=jnp.asarray(pot)))
    jst, st, jcfg, cfg = _both(jst, **extra)
    want = _jax_dict(jsinks.create_sinks(jst, jcfg, JOptions(sinks=True)))
    got = to_numpy(sinks.create_sinks(st, cfg, SimOptions(sinks=True)))
    assert_same(got, want)
    assert (got["sinks.slot"] == -1).all()


def test_no_threshold_or_radius_leaves_the_state(disc):
    st = from_numpy(_jax_dict(disc), "cpu")
    cfg = port_cfg(SofteningBndry=0.05)
    opts = SimOptions(sinks=True)
    assert sinks.create_sinks(st, cfg, opts) is st
    assert sinks.accrete_onto_sinks(st, cfg, opts) is st
