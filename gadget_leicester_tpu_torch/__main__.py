"""The command line: ``python -m gadget_leicester_tpu_torch param.txt
[restartflag]``, as ``Gadget2 param.txt [restartflag]`` [G2: main.c].

Counterpart of ``gadget_leicester_tpu/__main__.py:12-88``. restartflag: 0
(default) starts from InitCondFile, 1 resumes from the restart dump, 2
starts from a snapshot named by InitCondFile. ``--device`` (``cuda``, the
default, or ``cpu``) is the one flag the JAX CLI lacks; asked for CUDA
where there is none, the run stops with a message and a non-zero exit.
``--makeglass NSIDE`` writes an NSIDE^3 glass (``models/glass.py``) as
``glass.dat`` into OutputDir, in SnapFormat, and exits. ``--devices K``
runs the slab step on a ring of K ranks, one process and one card each
(``parallel/``; with ``--device cpu``, K gloo processes): K = 1 runs in
this process on a ring of one, a larger K starts its ranks with
``parallel/launch.py``; it stops with a message counting the cards where
fewer than K are visible. The slab step runs TreePM in a periodic box or
in vacuum (``PeriodicBoundariesOn 0``: on a mesh of ``auto_pmgrid`` cells
where ``--pmgrid`` is not given), with ``--sinks`` and ``--cooling
stamatellos``, its SPH on the blocks (the coarse cells through the Python
API's ``SimOptions(sph_backend="cells")``: no flag selects a backend, as
in the JAX CLI); a run it does not take (the zoom, ``nogravity``,
adaptive gas softening, ``--cooling beta``, a periodic box without a
mesh) stops with a message that names its reason before any rank
starts. ``-DFORCETEST=frac`` in the ``.opts`` sidecar writes
forcetest.txt at the statistics cadence, and the ``GLT_PROFILE_*`` and
``GLT_CPU_DETAIL`` variables trace the run as in the reference.
``--isothermal`` runs the isothermal EOS. ``--cooling`` and ``--sinks``
run the fork's physics. As
in the JAX CLI, no sink is registered from the particle types: a run
through the CLI forms sinks only by ``SinkFormationDensity``, and the star
of ``parameterfiles/disc.param`` never accretes (the Python API's
``models.sinks.register_sinks_from_types`` does that; ROADMAP queue 3).
"""

import argparse
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="gadget_leicester_tpu_torch",
        description="GADGET on one NVIDIA GPU: TreePM N-body + SPH "
                    "(PyTorch and CUDA)")
    ap.add_argument("paramfile", help="GADGET parameter file")
    ap.add_argument("restartflag", nargs="?", type=int, default=0,
                    choices=[0, 1, 2])
    ap.add_argument("--max-steps", type=int, default=1000000)
    ap.add_argument("--pmgrid", type=int, default=None,
                    help="PM mesh size (the -DPMGRID compile flag analog); "
                         "default: auto-derived for periodic boxes (TreePM)")
    ap.add_argument("--cooling", default=None,
                    choices=["none", "beta", "stamatellos"])
    ap.add_argument("--sinks", action="store_true", default=None)
    ap.add_argument("--isothermal", action="store_true", default=None)
    ap.add_argument("--makeglass", type=int, default=0, metavar="NSIDE",
                    help="MAKEGLASS mode: generate an NSIDE^3 glass file "
                         "into OutputDir and exit [G2: -DMAKEGLASS]")
    ap.add_argument("--devices", type=int, default=None, metavar="K",
                    help="the slab step over K ranks, one card each (gloo "
                         "processes with --device cpu)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run goes: cuda (default, the kernels) "
                         "or cpu (their plain PyTorch versions)")
    return ap


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    args = _parser().parse_args(argv)
    from gadget_leicester_tpu_torch.models.simulation import resolve_device
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"gadget_leicester_tpu_torch: {exc}", file=sys.stderr)
        return 1
    if args.makeglass:
        return write_glass(args.paramfile, args.makeglass, args.device)
    k = args.devices
    if k is None:
        return run_main(argv)
    if k < 1:
        print(f"--devices {k}: a ring needs at least one rank",
              file=sys.stderr)
        return 2
    refusal = slab_refusal(args)
    if refusal:
        print(f"gadget_leicester_tpu_torch: {refusal}", file=sys.stderr)
        return 2
    if args.device == "cuda":
        import torch
        n = torch.cuda.device_count()
        if n < k:
            print(f"gadget_leicester_tpu_torch: --devices {k} needs {k} "
                  f"CUDA devices, one a rank; {n} visible", file=sys.stderr)
            return 2
    if k == 1:
        return run_main(argv, mesh=1)
    import torch

    from gadget_leicester_tpu_torch.parallel.launch import cli_rank, spawn
    # the intra-op threads of this process, shared among the ranks
    return spawn(cli_rank, k, (argv,), device=args.device, timeout=None,
                 threads=max(1, torch.get_num_threads() // k))[0]


def _overrides(args) -> dict:
    """Only explicitly given flags override the config and the sidecar."""
    overrides = {}
    if args.pmgrid is not None:
        overrides["pmgrid"] = args.pmgrid
        overrides["gravity_mode"] = "treepm" if args.pmgrid else "auto"
    if args.cooling is not None:
        overrides["cooling"] = args.cooling
    if args.sinks is not None:
        overrides["sinks"] = args.sinks
    if args.isothermal is not None:
        overrides["isotherm_eqs"] = args.isothermal
    return overrides


def slab_refusal(args) -> str:
    """Why the slab step would refuse this run ('' where it takes it),
    from the options the run would resolve (a periodic box takes its
    automatic PM mesh, as from_param_file gives it)."""
    import os

    from gadget_leicester_tpu_torch.core.config import (
        options_from_config, options_sidecar_path, parse_makefile_options,
        read_parameter_file)
    from gadget_leicester_tpu_torch.parallel.spmd import check_slab_supported
    cfg = read_parameter_file(args.paramfile)
    side_kw = {}
    sidecar = options_sidecar_path(args.paramfile)
    if os.path.exists(sidecar):
        with open(sidecar) as fh:
            side_kw = parse_makefile_options(fh.read())
    side_kw.update(_overrides(args))
    try:
        check_slab_supported(options_from_config(cfg, n_particles=1,
                                                 **side_kw))
    except NotImplementedError as exc:
        return str(exc)
    return ""


def run_main(argv=None, mesh=None, rank: int = 0) -> int:
    """The run of the command line: from the parameter file to TimeMax
    (or ``--max-steps``), on a ring ``mesh`` when given (this process its
    rank ``rank``; only rank 0 prints)."""
    args = _parser().parse_args(argv)
    from gadget_leicester_tpu_torch.models.simulation import Simulation
    sim = Simulation.from_param_file(args.paramfile, None,
                                     restart_flag=args.restartflag,
                                     opt_overrides=_overrides(args),
                                     device=args.device, mesh=mesh)
    cfg, opts = sim.cfg, sim.opts
    where = f"{sim.device}" if mesh is None else \
        f"{sim.device} x {sim.mesh.size} ranks"
    n = sim.state.p.alive.sum()
    n = int(n if sim.mesh is None else sim.mesh.psum(n))
    if rank == 0:
        print(f"N={n} particles on {where}; "
              f"t={sim.time:g} -> {cfg.time_max:g}; "
              f"gravity={opts.gravity_mode}, pmgrid={opts.pmgrid}",
              flush=True)
    sim.run(max_steps=args.max_steps)
    sim.logs.close()
    if rank == 0:
        print(f"done: {sim.step_count} steps, t={sim.time:g}, "
              f"{sim.snapshot_count} snapshots in {cfg.output_dir}",
              flush=True)
    return 0


def write_glass(paramfile: str, n_side: int, device: str) -> int:
    """``--makeglass``: an n_side^3 glass of unit total mass in a box of
    BoxSize (1 where it is 0), written as type 1 to OutputDir/glass.dat."""
    import os

    import numpy as np

    from gadget_leicester_tpu_torch.core.config import read_parameter_file
    from gadget_leicester_tpu_torch.io.snapshot import (Header, SnapshotData,
                                                        write_snapshot)
    from gadget_leicester_tpu_torch.models.glass import make_glass
    cfg = read_parameter_file(paramfile)
    box = cfg.box_size or 1.0
    pos, amax = make_glass(n_side, box=box, device=device)
    n = len(pos)
    h = Header()
    h.npart = np.array([0, n, 0, 0, 0, 0], np.uint32)
    h.npart_total = h.npart.copy()
    h.box_size = box
    h.mass[1] = 1.0 / n
    snap = SnapshotData(header=h, pos=pos.astype(np.float32),
                        vel=np.zeros((n, 3), np.float32),
                        ids=np.arange(1, n + 1, dtype=np.uint32),
                        mass=np.full(n, 1.0 / n, np.float32))
    os.makedirs(cfg.output_dir, exist_ok=True)
    out = os.path.join(cfg.output_dir, "glass.dat")
    write_snapshot(out, snap, fmt=cfg.snap_format)
    print(f"glass written: {out} (N={n}, residual force ratio "
          f"{float(amax[-1] / amax[0]):.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
