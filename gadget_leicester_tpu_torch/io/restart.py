"""Restart dumps [G2: restart.c].

Counterpart of ``gadget_leicester_tpu/io/restart.py:25-88``
(``save_restart``, ``load_restart``). A dump is one npz of
``core/state.py :: to_numpy(state)`` (the arrays keyed by their field
paths, ``"p.pos"`` ...) with the step bookkeeping and the field manifest
as JSON meta. The grid cache is derived data and is not stored: a resumed
run builds its grids fresh (``Simulation`` resets its own cache when it
dumps, so the run that dumped and a run resumed from the dump continue
from the same data). Arrays round-trip through npz unchanged, so a resumed
run continues bit for bit on the same device.
"""

from __future__ import annotations

import json

import numpy as np

from gadget_leicester_tpu_torch.core.state import (SimState, field_manifest,
                                                   from_numpy, to_numpy)

_META = "__meta__"


def save_restart(path: str, state: SimState, step_count: int = 0,
                 extra_meta: dict | None = None) -> None:
    """Write ``state`` to ``path`` (``.npz`` is appended when missing)."""
    arrays = to_numpy(state)
    meta = {"step_count": step_count, "field_manifest": list(arrays)}
    if extra_meta:
        meta.update(extra_meta)
    arrays[_META] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_restart(path: str, device) -> tuple[SimState, dict]:
    """(state on ``device``, meta) from a dump; raises ``ValueError`` when
    the dump's field manifest is not the current state layout."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        meta = json.loads(bytes(z[_META]).decode())
        stored = meta.get("field_manifest")
        current = field_manifest()
        if stored != current:
            missing = [f for f in stored or () if f not in current]
            added = [f for f in current if f not in (stored or ())]
            raise ValueError(
                "restart dump layout does not match the current SimState "
                f"definition (dump fields missing now: {missing}; fields "
                f"added since the dump: {added}). Start from a snapshot "
                "(restart flag 2) instead [G2: restart.c version check].")
        arrays = {k: z[k] for k in current}
    return from_numpy(arrays, device), meta
