"""PM across a ring of gloo processes (``parallel/pm_sharded.py ::
pm_local_forces``: point deposit, reduce-scatter to x-slabs, the pencil
FFT with all-to-all, all-gather of the force slab, the CIC gather) on 2
and 4 ranks, against the port's single-device ``pm_forces_periodic`` and
the JAX package's ``make_pm_sharded`` on its 8 virtual devices, at
test_pm_sharded.py's bounds (2e-5 of the largest value, rtol 2e-4), with
and without the potential."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gadget_leicester_tpu.parallel.mesh import make_mesh
from gadget_leicester_tpu.parallel.pm_sharded import make_pm_sharded
from gadget_leicester_tpu_torch.ops.pm import pm_forces_periodic
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
