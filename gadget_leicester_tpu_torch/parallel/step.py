"""The placed step: the single-device sync point on one device.

Counterpart of ``gadget_leicester_tpu/parallel/step.py``
(``make_sharded_step`` :20), which is ``jax.jit`` of ``sync_point_step``
with the particle axis sharded over a device mesh (GSPMD), and so gives
the single-device step's outputs. PyTorch has no GSPMD: here the state is
moved to one device and the step is ``models/simulation.py ::
sync_point_step`` there, output for output the single-device step. No
sharding is added that the reference lacks, and the reference's
placement helpers (``parallel/mesh.py :: state_shardings``,
``shard_state``, ``replicate_state``) have no counterpart. The port's
path across devices is the slab step (``parallel/spmd.py``,
``Simulation(mesh=K)``, ``--devices K``): one process and one slab a
rank, the counterpart of the reference's ``make_spmd_step``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from gadget_leicester_tpu_torch.core.config import SimConfig, SimOptions
from gadget_leicester_tpu_torch.core.state import SimState
from gadget_leicester_tpu_torch.models.simulation import sync_point_step
from gadget_leicester_tpu_torch.parallel.mesh import Ring


def _moved(node, device: torch.device):
    """``node`` with every tensor on ``device``: dataclasses (SimState, its
    parts, the grid cache and its cell lists), tuples and lists are
    walked; anything else is kept."""
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{
            f.name: _moved(getattr(node, f.name), device)
            for f in dataclasses.fields(node) if f.init})
    if isinstance(node, (tuple, list)):
        return type(node)(_moved(v, device) for v in node)
    return node


def make_sharded_step(state: SimState, cfg: SimConfig, opts: SimOptions,
                      mesh=None):
    """(step, state): ``step(state) -> state`` one sync point of
    ``sync_point_step``, and ``state`` with every tensor on the device of
    ``mesh``: a device or its name, a :class:`Ring` (its device), or None
    (``cuda``: the entry points run on the card unless the caller asks
    for the CPU)."""
    device = mesh.device if isinstance(mesh, Ring) else \
        torch.device("cuda" if mesh is None else mesh)
    step = functools.partial(sync_point_step, cfg=cfg, opts=opts)
    return step, _moved(state, device)
