"""PM across a ring of gloo processes (``parallel/pm_sharded.py ::
pm_local_forces``: point deposit, reduce-scatter to x-slabs, the pencil
FFT with all-to-all, all-gather of the force slab, the CIC gather) on 2
and 4 ranks, against the port's single-device ``pm_forces_periodic`` and
the JAX package's ``make_pm_sharded`` on its 8 virtual devices, at
test_pm_sharded.py's bounds (2e-5 of the largest value, rtol 2e-4), with
and without the potential; the vacuum mesh (``pm_local_forces_vacuum``:
the padded deposit, one sum of its octant, the free-space solve on every
rank) on 2 ranks against the port's ``pm_forces_nonperiodic`` and the
JAX package's ``pm_local_forces_vacuum`` on 4 virtual devices, at
test_spmd_vacuum.py's bounds (the same)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.parallel.mesh import AXIS, make_mesh
from gadget_leicester_tpu.parallel.pm_sharded import (make_pm_sharded,
                                                      pm_local_forces_vacuum)
from gadget_leicester_tpu_torch.ops.pm import (pm_forces_nonperiodic,
                                               pm_forces_periodic)
from gadget_leicester_tpu_torch.parallel import launch

BOX, N, NPART = 4.0, 32, 4096
ATOL, RTOL = 2e-5, 2e-4


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(31)
    pos = rng.uniform(0, BOX, (NPART, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, NPART).astype(np.float32)
    alive = np.ones(NPART, bool)
    alive[::13] = False
    ring = {d: launch.spawn(launch.pm_probe, d,
                            (pos, mass, alive, BOX, N), timeout=900)
            for d in (2, 4)}
    got = {d: {k: np.concatenate([r[k] for r in res]) for k in res[0]}
           for d, res in ring.items()}
    single = pm_forces_periodic(torch.from_numpy(pos),
                                torch.from_numpy(mass),
                                torch.from_numpy(alive), BOX, N,
                                with_potential=True)
    mesh = make_mesh(8)
    jax_acc = jax.jit(make_pm_sharded(mesh, BOX, N))(
        *(jnp.asarray(a) for a in (pos, mass, alive)))
    jax_p = jax.jit(make_pm_sharded(mesh, BOX, N, with_potential=True))(
        *(jnp.asarray(a) for a in (pos, mass, alive)))
    want = {"port": {"acc": single[0].numpy(), "acc_p": single[0].numpy(),
                     "pot": single[1].numpy()},
            "jax": {"acc": np.asarray(jax_acc), "acc_p": np.asarray(jax_p[0]),
                    "pot": np.asarray(jax_p[1])}}
    return got, want


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("with_potential", [False, True])
def test_pm_local_forces_matches(case, d, ref, with_potential):
    got, want = case
    got, want = got[d], want[ref]
    keys = ("acc_p", "pot") if with_potential else ("acc",)
    for k in keys:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], atol=ATOL * scale,
                                   rtol=RTOL, err_msg=k)


# test_spmd_vacuum.py::test_vacuum_pm_sharded_matches_dense's case
V_EXTENT, V_N, V_NPART = 2.2, 16, 512
V_ORIGIN = np.array([-1.1, -1.1, -1.1], np.float32)


@pytest.fixture(scope="module")
def vacuum_case():
    rng = np.random.default_rng(5)
    pos = rng.uniform(-1.0, 1.0, (V_NPART, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, V_NPART).astype(np.float32)
    alive = np.ones(V_NPART, bool)
    alive[::11] = False
    res = launch.spawn(launch.pm_vacuum_probe, 2,
                       (pos, mass, alive, V_ORIGIN, V_EXTENT, V_N),
                       timeout=900)
    got = {k: np.concatenate([r[k] for r in res]) for k in res[0]}
    t = [torch.from_numpy(a) for a in (pos, mass, alive)]
    single = pm_forces_nonperiodic(*t, torch.from_numpy(V_ORIGIN), V_EXTENT,
                                   V_N, with_potential=True)
    mesh = make_mesh(4)
    spec = jax.sharding.PartitionSpec(AXIS)

    def jax_fn(with_potential):
        return jax.jit(jax.shard_map(
            lambda p, m, a: pm_local_forces_vacuum(
                p, m, a, jnp.asarray(V_ORIGIN), V_EXTENT, V_N,
                with_potential=with_potential),
            mesh=mesh, in_specs=(spec, spec, spec),
            out_specs=(spec, spec) if with_potential else spec))

    j = [jnp.asarray(a) for a in (pos, mass, alive)]
    jax_acc = jax_fn(False)(*j)
    jax_p = jax_fn(True)(*j)
    want = {"port": {"acc": single[0].numpy(), "acc_p": single[0].numpy(),
                     "pot": single[1].numpy()},
            "jax": {"acc": np.asarray(jax_acc), "acc_p": np.asarray(jax_p[0]),
                    "pot": np.asarray(jax_p[1])}}
    return got, want


@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("with_potential", [False, True])
def test_pm_local_forces_vacuum_matches(vacuum_case, ref, with_potential):
    """The vacuum mesh across a ring of two against one device and the
    JAX package's sharded vacuum mesh."""
    got, want = vacuum_case
    want = want[ref]
    keys = ("acc_p", "pot") if with_potential else ("acc",)
    for k in keys:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], atol=ATOL * scale,
                                   rtol=RTOL, err_msg=k)
