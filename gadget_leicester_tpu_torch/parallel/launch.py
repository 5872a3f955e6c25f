"""Start the ranks of a slab ring, one process each, and the rank workers
the CLI and the tests give them.

The reference runs one controller over a device mesh; the port runs K
processes, started here with the ``spawn`` method (a fresh interpreter:
no state of the parent, whose threads ``fork`` would copy half-way). Each
rank takes one thread, joins the group through a ``FileStore`` in a fresh
directory (no port to collide on between concurrent runs), runs its
worker, writes the worker's return value for the parent and leaves the
group. :func:`spawn` raises when a rank fails or outlives ``timeout``,
after ending every rank it started.

The workers below import the port only: a spawned child imports the
module of its target, and nothing of the JAX package or of a test module
may come with it.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch

from gadget_leicester_tpu_torch.parallel.mesh import TIMEOUT_S


def _rank_main(fn, rank: int, world: int, init_method: str, device: str,
               args: tuple, out_path: str, timeout_s: float) -> None:
    import torch.distributed as dist

    from gadget_leicester_tpu_torch.parallel.mesh import init_group
    torch.set_num_threads(1)
    try:
        init_group(rank, world, device, init_method, timeout_s)
        res = fn(rank, world, *args)
        with open(out_path, "wb") as fh:
            pickle.dump(("ok", res), fh)
    except BaseException:   # the parent reads the trace
        with open(out_path, "wb") as fh:
            pickle.dump(("error", traceback.format_exc()), fh)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), device: str = "cpu",
          timeout: float | None = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks, each its own
    process joined to one process group (gloo on the CPU, NCCL on the
    card, a card a rank); returns the ranks' return values in rank order.
    ``fn`` must be a module-level function of the port. ``timeout`` None
    waits for the ranks however long they run (a command-line run); a
    rank stuck in a collective still raises after the group's own
    timeout (``parallel/mesh.py :: TIMEOUT_S``)."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="glt_ranks_")
    init = f"file://{os.path.join(tmp, 'store')}"
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init, device, args, outs[r],
                               timeout or TIMEOUT_S), daemon=True)
             for r in range(world)]
    try:
        for proc in procs:
            proc.start()
        deadline = None if timeout is None else time.time() + timeout
        for proc in procs:
            proc.join(None if deadline is None
                      else max(0.0, deadline - time.time()))
        hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
        results, errors = [], []
        for r, path in enumerate(outs):
            if not os.path.exists(path):
                errors.append(f"rank {r}: no result (exit code "
                              f"{procs[r].exitcode})")
                continue
            with open(path, "rb") as fh:
                kind, val = pickle.load(fh)
            if kind != "ok":
                errors.append(f"rank {r}:\n{val}")
            results.append(val)
        if hung:
            errors.insert(0, f"ranks {hung} still running after {timeout} s")
        if errors:
            raise RuntimeError("slab ring failed:\n" + "\n".join(errors))
        return results
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Rank workers
# ---------------------------------------------------------------------------
def cli_rank(rank: int, world: int, argv: list) -> int:
    """One rank of ``python -m gadget_leicester_tpu_torch ... --devices
    K``: the CLI's run on the group this process joined."""
    from gadget_leicester_tpu_torch.__main__ import run_main
    return run_main(argv, mesh=world, rank=rank)


def _by_pid(state) -> dict:
    """The alive particles of a canonical state, ordered by pid, as host
    arrays."""
    alive = state.p.alive.cpu().numpy()
    pid = state.p.pid.cpu().numpy()[alive]
    order = pid.argsort(kind="stable")
    out = {"pid": pid[order]}
    for f in ("pos", "vel", "acc", "acc_pm", "mass", "ti_begstep",
              "ti_endstep"):
        out[f] = getattr(state.p, f).cpu().numpy()[alive][order]
    ng = state.n_gas_max
    galive = alive[:ng] & (state.p.ptype.cpu().numpy()[:ng] == 0)
    gpid = state.p.pid.cpu().numpy()[:ng][galive]
    gorder = gpid.argsort(kind="stable")
    for f in ("density", "hsml", "hydro_acc"):
        out[f"gas.{f}"] = getattr(state.gas, f).cpu().numpy()[galive][gorder]
    return out


def _ring_sim(world: int, param_text: str, opts_kw: dict, state: dict,
              device: str):
    """A ``Simulation`` on the ring this process joined, its state the
    canonical ``state`` (a dict of ``core/state.py :: to_numpy``)
    decomposed into slabs."""
    from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                        parse_parameter_text)
    from gadget_leicester_tpu_torch.core.state import from_numpy
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    sim = Simulation(parse_parameter_text(param_text), SimOptions(**opts_kw),
                     device, mesh=world)
    sim.state = from_numpy(state, sim.device)
    sim._decompose()
    return sim


def slab_run(rank: int, world: int, param_text: str, opts_kw: dict,
             state: dict, n_steps: int, device: str = "cpu") -> dict:
    """``n_steps`` slab sync points from the canonical ``state``; returns,
    on rank 0, the canonical result by pid with the run's overflow bits,
    ti_current, slab edges and chunk capacities (None elsewhere)."""
    sim = _ring_sim(world, param_text, opts_kw, state, device)
    sim.step(n_steps)
    cst = sim.canonical_state()
    if rank != 0:
        return None
    out = _by_pid(cst)
    out.update(overflow=int(sim.state.overflow_flags),
               ti_current=int(sim.state.ti_current),
               edges=sim.spmd_edges, caps=sim.spmd_caps)
    return out


def migrate_probe(rank: int, world: int, param_text: str, opts_kw: dict,
                  state: dict, moves: dict) -> dict:
    """The slab step's migration alone: the particles of ``moves`` (pid ->
    new x) are moved by the rank that holds them, then one ``migrate``.
    Returns, on every rank, the pids each rank holds before and after,
    and the overflow bits the ring sees."""
    import torch

    from gadget_leicester_tpu_torch.parallel.spmd import gather_chunks
    sim = _ring_sim(world, param_text, opts_kw, state, device="cpu")
    st = sim.state

    def held(s):
        full = gather_chunks(sim.mesh, s)
        stride = sum(sim.spmd_caps)
        pid = full.p.pid.numpy().reshape(world, stride)
        alive = full.p.alive.numpy().reshape(world, stride)
        return [sorted(pid[r][alive[r]].tolist()) for r in range(world)]

    before = held(st)
    pos = st.p.pos.clone()
    for pid, x in moves.items():
        pos[(st.p.pid == pid) & st.p.alive, 0] = x
    st = dataclasses.replace(st, p=dataclasses.replace(st.p, pos=pos))
    st = sim._spmd_step.migrate(st)
    flags = int(sim.mesh.or_bits(st.overflow_flags))
    return {"before": before, "after": held(st), "overflow": flags,
            "n_threads": torch.get_num_threads()}


def pm_probe(rank: int, world: int, pos, mass, alive, box: float,
             n: int) -> dict:
    """``parallel/pm_sharded.py :: pm_local_forces`` on this rank's block
    of the particles (rows [rank N / world, (rank + 1) N / world)), with
    and without the potential; returns that block's rows of each."""
    from gadget_leicester_tpu_torch.parallel.mesh import Ring
    from gadget_leicester_tpu_torch.parallel.pm_sharded import \
        pm_local_forces
    ring = Ring(None, "cpu")
    k = pos.shape[0] // world
    sl = slice(rank * k, (rank + 1) * k)
    args = [torch.as_tensor(a[sl]) for a in (pos, mass, alive)]
    acc = pm_local_forces(ring, *args, box, n)
    acc_p, pot = pm_local_forces(ring, *args, box, n, with_potential=True)
    return {"acc": acc.numpy(), "acc_p": acc_p.numpy(), "pot": pot.numpy()}
