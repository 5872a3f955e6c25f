"""The port's host helpers (``utils/native.py``): the pure-numpy bodies of
the JAX package's native fallbacks, on ``tests/test_native.py``'s cases
(the Peano-Hilbert curve's bijection, continuity and locality, the host
CIC against the mesh deposit) and against the JAX package's own fallback
key for key; without a C extension of its own, ``have_native`` is False
and the record scan answers None, as the reference does without one."""

import numpy as np
import pytest
import torch

from gadget_leicester_tpu.utils import native as jnative
from gadget_leicester_tpu_torch.ops.pm import cic_deposit
from gadget_leicester_tpu_torch.utils import native


def _all_coords(bits):
    n = 1 << bits
    return np.indices((n, n, n)).reshape(3, -1).T.astype(np.uint32)


@pytest.mark.parametrize("bits", [1, 2, 3])
def test_hilbert_bijective(bits):
    keys = native._hilbert_keys_py(_all_coords(bits), bits)
    n3 = (1 << bits) ** 3
    assert len(np.unique(keys)) == n3
    assert keys.min() == 0 and keys.max() == n3 - 1


@pytest.mark.parametrize("bits", [1, 2, 3])
def test_hilbert_continuity(bits):
    """Consecutive keys are face-adjacent cells."""
    coords = _all_coords(bits)
    order = np.argsort(native._hilbert_keys_py(coords, bits))
    step = np.abs(np.diff(coords[order].astype(np.int64), axis=0))
    assert np.all(step.sum(axis=1) == 1)


def test_keys_equal_the_jax_fallback():
    """Keys and order equal the JAX package's numpy fallback bit for bit
    (its C extension, where built, equals that fallback:
    test_native.py)."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 1, (500, 3))
    np.testing.assert_array_equal(
        native.peano_hilbert_keys(pos, 0.0, 1.0, bits=10),
        jnative._hilbert_keys_py(np.clip((pos * (1 << 10)).astype(np.int64),
                                         0, (1 << 10) - 1).astype(np.uint32),
                                 10))
    np.testing.assert_array_equal(
        native.peano_hilbert_order(pos, 0.0, 1.0, bits=18),
        np.argsort(jnative._hilbert_keys_py(
            np.clip((pos * (1 << 18)).astype(np.int64), 0,
                    (1 << 18) - 1).astype(np.uint32), 18), kind="stable"))


def test_ph_order_locality(rng):
    pos = rng.uniform(0, 1, (2000, 3))
    order = native.peano_hilbert_order(pos, 0.0, 1.0, bits=10)
    d_sorted = np.linalg.norm(np.diff(pos[order], axis=0), axis=1)
    d_random = np.linalg.norm(np.diff(pos, axis=0), axis=1)
    assert np.median(d_sorted) < 0.25 * np.median(d_random)


def test_no_extension_and_no_record_scan():
    assert native.have_native() is False
    assert native.scan_f77_records(b"\x00" * 16) is None


def test_host_cic_matches_device(rng):
    """test_native.py's tolerance against the port's mesh deposit; the
    JAX package's host deposit to float32 rounding."""
    n, g, box = 300, 8, 2.0
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    host = native.cic_deposit_host(pos, mass, g, box)
    dev = cic_deposit(torch.from_numpy(pos), torch.from_numpy(mass), box,
                      g).numpy()
    np.testing.assert_allclose(host, dev, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(host, jnative.cic_deposit_host(pos, mass, g,
                                                              box),
                               rtol=1e-6, atol=1e-7)
