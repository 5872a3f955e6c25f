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

import numpy as np
import torch

from gadget_leicester_tpu_torch.parallel.mesh import TIMEOUT_S


def _rank_main(fn, rank: int, world: int, init_method: str, device: str,
               args: tuple, out_path: str, timeout_s: float,
               threads: int = 1) -> None:
    import torch.distributed as dist

    from gadget_leicester_tpu_torch.parallel.mesh import init_group
    torch.set_num_threads(threads)
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
          timeout: float | None = 600.0, threads: int = 1) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks, each its own
    process joined to one process group (gloo on the CPU, NCCL on the
    card, a card a rank) with ``threads`` intra-op threads; returns the
    ranks' return values in rank order. ``fn`` must be a module-level
    function of the port. ``timeout`` None waits for the ranks however
    long they run (a command-line run); a rank stuck in a collective
    still raises after the group's own timeout (``parallel/mesh.py ::
    TIMEOUT_S``)."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="glt_ranks_")
    init = f"file://{os.path.join(tmp, 'store')}"
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init, device, args, outs[r],
                               timeout or TIMEOUT_S, threads), daemon=True)
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
    arrays; the gas fields by the gas's pid; ``sinks``: {used slot: (the
    pid of its sink, acc_mass, n_accreted)}."""
    alive = state.p.alive.cpu().numpy()
    pid_all = state.p.pid.cpu().numpy()
    pid = pid_all[alive]
    order = pid.argsort(kind="stable")
    out = {"pid": pid[order]}
    for f in ("pos", "vel", "acc", "acc_pm", "mass", "ptype", "pot",
              "ti_begstep", "ti_endstep"):
        out[f] = getattr(state.p, f).cpu().numpy()[alive][order]
    ng = state.n_gas_max
    galive = alive[:ng] & (state.p.ptype.cpu().numpy()[:ng] == 0)
    gpid = pid_all[:ng][galive]
    gorder = gpid.argsort(kind="stable")
    out["gas.pid"] = gpid[gorder]
    for f in ("density", "hsml", "hydro_acc", "entropy", "dt_entropy"):
        out[f"gas.{f}"] = getattr(state.gas, f).cpu().numpy()[galive][gorder]
    slot = state.sinks.slot.cpu().numpy()
    used = np.flatnonzero(slot >= 0)
    out["sinks"] = {int(k): (int(pid_all[slot[k]]),
                             float(state.sinks.acc_mass[k]),
                             int(state.sinks.n_accreted[k])) for k in used}
    return out


def _ring_sim(world: int, param_text: str, opts_kw: dict, state: dict,
              device: str, edges=None):
    """A ``Simulation`` on the ring this process joined, its state the
    canonical ``state`` (a dict of ``core/state.py :: to_numpy``)
    decomposed into slabs (at ``edges`` where given)."""
    from gadget_leicester_tpu_torch.core.config import (SimOptions,
                                                        parse_parameter_text)
    from gadget_leicester_tpu_torch.core.state import from_numpy
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    sim = Simulation(parse_parameter_text(param_text), SimOptions(**opts_kw),
                     device, mesh=world)
    sim.state = from_numpy(state, sim.device)
    sim._decompose(edges)
    return sim


def slab_run(rank: int, world: int, param_text: str, opts_kw: dict,
             state: dict, n_steps: int, device: str = "cpu", edges=None,
             cfg_kw: dict | None = None, snapshots: bool = False) -> dict:
    """``n_steps`` slab sync points from the canonical ``state`` (slab
    edges ``edges`` where given, the config's fields ``cfg_kw`` replaced);
    returns, on rank 0, the canonical result by pid with the run's
    overflow bits, ti_current, slab edges, chunk capacities, domain,
    pmgrid and the registry of the slab layout (PIDs); with
    ``snapshots``, ``steps``: the result by pid after each sync point
    (None elsewhere)."""
    sim = _ring_sim(world, param_text, opts_kw, state, device, edges)
    if cfg_kw:
        sim.cfg = sim.cfg.replace(**cfg_kw)
        sim._spmd_step.cfg = sim.cfg
    steps = []
    for _ in range(n_steps):
        sim.step()
        if snapshots:
            steps.append(_by_pid(sim.canonical_state()))
    cst = sim.canonical_state()
    if rank != 0:
        return None
    out = _by_pid(cst)
    if snapshots:
        out["steps"] = steps
    dom = sim.spmd_domain
    out.update(overflow=int(sim.state.overflow_flags),
               ti_current=int(sim.state.ti_current),
               edges=sim.spmd_edges, caps=sim.spmd_caps,
               domain=None if dom is None else (np.asarray(dom[0]),
                                                float(dom[1])),
               pmgrid=sim.opts.pmgrid,
               slot_pids=sim.state.sinks.slot.cpu().numpy())
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


def pm_vacuum_probe(rank: int, world: int, pos, mass, alive, origin,
                    extent: float, n: int) -> dict:
    """``parallel/pm_sharded.py :: pm_local_forces_vacuum`` on this
    rank's block of the particles, as :func:`pm_probe` takes them, with
    and without the potential."""
    from gadget_leicester_tpu_torch.parallel.mesh import Ring
    from gadget_leicester_tpu_torch.parallel.pm_sharded import \
        pm_local_forces_vacuum
    ring = Ring(None, "cpu")
    k = pos.shape[0] // world
    sl = slice(rank * k, (rank + 1) * k)
    args = [torch.as_tensor(a[sl]) for a in (pos, mass, alive)]
    org = torch.as_tensor(origin)
    acc = pm_local_forces_vacuum(ring, *args, org, extent, n)
    acc_p, pot = pm_local_forces_vacuum(ring, *args, org, extent, n,
                                        with_potential=True)
    return {"acc": acc.numpy(), "acc_p": acc_p.numpy(), "pot": pot.numpy()}


def cooling_probe(rank: int, world: int, param_text: str, opts_kw: dict,
                  state: dict, edges) -> dict:
    """The Stamatellos point-mass term of this rank's gas on a ring from
    the canonical ``state``: over the ring's registered sinks
    (``SpmdStep.ring_sinks``), and over the sinks this rank holds alone;
    with the gas pids and the PIDs of the sinks this rank holds."""
    from gadget_leicester_tpu_torch.models.cooling import \
        sink_potential_correction
    sim = _ring_sim(world, param_text, opts_kw, state, "cpu", edges)
    st, step = sim.state, sim._spmd_step
    p, ng = st.p, st.n_gas_max
    gas = (p.alive[:ng] & (p.ptype[:ng] == 0)).numpy()
    slot = st.sinks.slot
    used = slot[slot >= 0]
    held = (p.pid[:, None] == used[None, :].to(p.pid.dtype)) \
        & p.alive[:, None]
    rows = held.any(1)
    ring = sink_potential_correction(st, sim.cfg, sim.opts, ng,
                                     step.ring_sinks(st))
    own = sink_potential_correction(st, sim.cfg, sim.opts, ng,
                                    (p.pos[rows], p.mass[rows]))
    return {"gas_pid": p.pid[:ng].numpy()[gas], "ring": ring.numpy()[gas],
            "own": own.numpy()[gas], "held": p.pid[rows].numpy()}
