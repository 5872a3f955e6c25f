"""The slab step's process group: one process a rank, on
``torch.distributed`` (NCCL for CUDA tensors, gloo for CPU ones).

Counterpart of ``gadget_leicester_tpu/parallel/mesh.py`` (``AXIS``,
``make_mesh`` :14) and of the collectives the JAX package's slab step
calls inside ``shard_map`` (``parallel/spmd.py``: ``lax.pmin``,
``lax.pmax``, ``lax.psum``, the OR of the overflow bits, and ``_ring`` :431, a
``ppermute`` one hop around the slab ring). The reference's single
controller over a device mesh becomes K processes, each owning one slab;
:class:`Ring` is the handle they pass around.

The reference's placement of a state over its mesh (``state_shardings``,
``shard_state``, ``replicate_state`` :38-50) has no counterpart here:
PyTorch has no GSPMD, no partitioning of one program's arrays across
devices, so a state lives on one device (``parallel/step.py ::
make_sharded_step`` puts it there). The slab step (``parallel/spmd.py``)
is the port's way across devices: one process and one slab a rank.

A ring of one takes the identity for its one-hop exchange (a ``ppermute``
to itself is the identity); its reductions and the PM's collectives still
go through the backend. Every collective is called by all ranks in the
same order: a branch that holds one is decided on all ranks alike, from a
value :func:`Ring.any` or :func:`Ring.psum` reduced first.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile

import torch
import torch.distributed as dist

AXIS = "shard"   # the name of the reference's mesh axis

# seconds a rank waits in init_process_group and in a collective before it
# raises, so a rank that hangs fails its caller rather than blocking it
TIMEOUT_S = 600


def backend_for(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    """A free TCP port on localhost, for a group's store."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_group(rank: int, world: int, device, init_method: str | None = None,
               timeout_s: float = TIMEOUT_S) -> None:
    """Start or join the default process group: ``init_method`` a
    ``file://`` store or a ``tcp://localhost:<port>`` address (a fresh
    FileStore under the temporary directory for a group of one)."""
    if init_method is None:
        if world != 1:
            raise ValueError("a group of more than one rank needs the "
                             "address its ranks share")
        fd, path = tempfile.mkstemp(prefix="glt_group_")
        os.close(fd)
        os.unlink(path)
        init_method = f"file://{path}"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend_for(dev), init_method=init_method, rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


class Ring:
    """The slab ring: the process group, this rank and the world size,
    and the collectives of the slab step on tensors of ``device``."""

    def __init__(self, group=None, device="cpu"):
        self.group = group
        self.device = torch.device(device)
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def _peer(self, shift: int) -> int:
        """The global rank ``shift`` hops along the ring."""
        r = (self.rank + shift) % self.size
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    # -- reductions -------------------------------------------------------
    def psum(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return t

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def any(self, flag) -> bool:
        """A host boolean every rank agrees on: True where any rank's
        ``flag`` is (the reference ``psum``s a predicate before its
        ``lax.cond``)."""
        t = torch.as_tensor(flag, device=self.device).to(torch.int32)
        dist.all_reduce(t.reshape(1), op=dist.ReduceOp.MAX,
                        group=self.group)
        return bool(t)

    def or_bits(self, flags: torch.Tensor, n_bits: int = 4) -> torch.Tensor:
        """The OR over the ranks of the low ``n_bits`` overflow bits of
        the 0-d int32 ``flags`` (a MAX per bit: NCCL has no bitwise
        reduction)."""
        k = torch.arange(n_bits, device=flags.device, dtype=torch.int32)
        bits = (flags >> k) & 1
        dist.all_reduce(bits, op=dist.ReduceOp.MAX, group=self.group)
        return (bits << k).sum().to(torch.int32)

    # -- the one-hop exchange --------------------------------------------
    def ring(self, bufs: list, direction: int) -> list:
        """``_ring``: each tensor of ``bufs`` moves one hop around the
        ring, to the right neighbour (i -> i+1) for ``direction`` +1, to
        the left for -1; returns what arrived from the other side. Every
        rank passes tensors of the same shapes. A ring of one returns
        copies."""
        if self.size == 1:
            return [b.clone() for b in bufs]
        dst, src = self._peer(direction), self._peer(-direction)
        recv = [torch.empty_like(b) for b in bufs]
        ops = []
        for b, r in zip(bufs, recv):
            b = b.contiguous()
            if b.dtype == torch.bool:
                # no backend sends bool: as uint8, converted back below
                b = b.to(torch.uint8)
            ops.append(dist.P2POp(dist.isend, b, dst, self.group))
        wire = [torch.empty_like(r, dtype=torch.uint8)
                if r.dtype == torch.bool else r for r in recv]
        for w in wire:
            ops.append(dist.P2POp(dist.irecv, w, src, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [w.to(torch.bool) if r.dtype == torch.bool else w
                for w, r in zip(wire, recv)]

    # -- the PM's collectives ----------------------------------------------
    def reduce_scatter(self, full: torch.Tensor) -> torch.Tensor:
        """The rank's 1/size of ``full`` along dim 0, summed over the
        ranks (``psum_scatter``)."""
        out = full.new_empty((full.shape[0] // self.size,) + full.shape[1:])
        dist.reduce_scatter_tensor(out, full.contiguous(),
                                   op=dist.ReduceOp.SUM, group=self.group)
        return out

    def all_gather(self, part: torch.Tensor) -> torch.Tensor:
        """The ranks' ``part`` concatenated along dim 0."""
        out = part.new_empty((part.shape[0] * self.size,) + part.shape[1:])
        dist.all_gather_into_tensor(out, part.contiguous(), group=self.group)
        return out

    def all_to_all(self, chunks: torch.Tensor) -> torch.Tensor:
        """``chunks`` [size, ...]: chunk j goes to rank j; returns [size,
        ...] with chunk j from rank j."""
        out = torch.empty_like(chunks)
        dist.all_to_all_single(out, chunks.contiguous(), group=self.group)
        return out


def join(mesh, device) -> Ring:
    """The :class:`Ring` of ``Simulation(mesh=...)``: a process group, or
    an int world size. ``mesh=1`` in a process outside any group starts a
    group of one; a larger int needs a group its ranks joined already (the
    CLI's launcher, ``parallel/launch.py``, or the tests start them)."""
    if isinstance(mesh, dist.ProcessGroup):
        return Ring(mesh, device)
    k = int(mesh)
    if k < 1:
        raise ValueError(f"mesh={mesh!r}: a slab ring needs at least one "
                         "rank")
    if not dist.is_initialized():
        if k != 1:
            raise RuntimeError(
                f"mesh={k}: the {k} ranks of a slab ring are started by "
                "the CLI (--devices) or parallel/launch.py, one process a "
                "rank; in a single process only mesh=1 starts its group")
        init_group(0, 1, device)
    if dist.get_world_size() != k:
        raise RuntimeError(f"mesh={k}, but the process group has "
                           f"{dist.get_world_size()} ranks")
    return Ring(None, device)
