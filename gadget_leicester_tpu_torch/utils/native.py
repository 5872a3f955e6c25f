"""Host helpers with the pure-numpy bodies of the JAX package's native
fallbacks: Peano-Hilbert keys and order [G2: peano.c], the Fortran record
scan of a snapshot, and a host CIC deposit for analysis tools.

Counterpart of ``gadget_leicester_tpu/utils/native.py`` (``have_native``,
``_hilbert_keys_py``, ``peano_hilbert_keys``, ``peano_hilbert_order``,
``scan_f77_records``, ``cic_deposit_host``) without its C extension: the
extension (``native/gadget_native.c``) stays the JAX package's, so
:func:`have_native` is False here and every function takes the numpy body
the reference falls back to, with the same results. The device-side tree
orders by Morton keys (``ops/tree.py``); the Peano-Hilbert curve serves
host-side orderings and analysis.
"""

from __future__ import annotations

import numpy as np


def have_native() -> bool:
    """False: the port builds no C extension of its own."""
    return False


# ---------------------------------------------------------------------------
# Peano-Hilbert keys
# ---------------------------------------------------------------------------
def _hilbert_keys_py(coords: np.ndarray, bits: int) -> np.ndarray:
    """Pure-numpy Skilling transpose algorithm (vectorised)."""
    X = [coords[:, 0].astype(np.uint32).copy(),
         coords[:, 1].astype(np.uint32).copy(),
         coords[:, 2].astype(np.uint32).copy()]
    M = np.uint32(1 << (bits - 1))
    Q = int(M)
    while Q > 1:
        P = np.uint32(Q - 1)
        for i in range(3):
            hasq = (X[i] & np.uint32(Q)) != 0
            X[0] = np.where(hasq, X[0] ^ P, X[0])
            t = np.where(~hasq, (X[0] ^ X[i]) & P, 0).astype(np.uint32)
            X[0] ^= t
            X[i] ^= t
        Q >>= 1
    for i in range(1, 3):
        X[i] ^= X[i - 1]
    t = np.zeros_like(X[0])
    Q = int(M)
    while Q > 1:
        t = np.where((X[2] & np.uint32(Q)) != 0, t ^ np.uint32(Q - 1), t)
        Q >>= 1
    for i in range(3):
        X[i] ^= t
    key = np.zeros(len(coords), np.uint64)
    for b in range(bits - 1, -1, -1):
        for i in range(3):
            key = (key << np.uint64(1)) | ((X[i] >> np.uint32(b)) & np.uint32(1)).astype(np.uint64)
    return key


def peano_hilbert_keys(pos: np.ndarray, origin, extent,
                       bits: int = 18) -> np.ndarray:
    """Keys of positions in [origin, origin+extent), 3*bits bits
    [G2: peano.c BITS_PER_DIMENSION=18]."""
    pos = np.asarray(pos)
    scale = (1 << bits) / np.asarray(extent, np.float64)
    coords = np.clip(((pos - origin) * scale).astype(np.int64), 0,
                     (1 << bits) - 1).astype(np.uint32)
    return _hilbert_keys_py(coords, bits)


def peano_hilbert_order(pos: np.ndarray, origin, extent,
                        bits: int = 18) -> np.ndarray:
    """argsort by PH key — [G2: peano.c :: peano_hilbert_order()]."""
    return np.argsort(peano_hilbert_keys(pos, origin, extent, bits),
                      kind="stable")


# ---------------------------------------------------------------------------
# F77 record scan (fast snapshot pre-pass)
# ---------------------------------------------------------------------------
def scan_f77_records(data: bytes):
    """(is_little_endian, [(payload_offset, size), ...]) from the native
    module; None here, as the reference gives without it (the snapshot
    reader walks the records itself)."""
    return None


def cic_deposit_host(pos: np.ndarray, mass: np.ndarray, grid_n: int,
                     box: float) -> np.ndarray:
    """Host-side CIC (analysis tooling); numpy fallback."""
    pos32 = np.ascontiguousarray(np.mod(pos, box), np.float32)
    m32 = np.ascontiguousarray(mass, np.float32)
    grid = np.zeros((grid_n, grid_n, grid_n), np.float32)
    u = pos32 * (grid_n / box)
    i0 = np.floor(u).astype(np.int64)
    fr = u - i0
    for dx in (0, 1):
        wx = fr[:, 0] if dx else 1 - fr[:, 0]
        ix = (i0[:, 0] + dx) % grid_n
        for dy in (0, 1):
            wy = fr[:, 1] if dy else 1 - fr[:, 1]
            iy = (i0[:, 1] + dy) % grid_n
            for dz in (0, 1):
                wz = fr[:, 2] if dz else 1 - fr[:, 2]
                iz = (i0[:, 2] + dz) % grid_n
                np.add.at(grid, (ix, iy, iz), m32 * wx * wy * wz)
    return grid
