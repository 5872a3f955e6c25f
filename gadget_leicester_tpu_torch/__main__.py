"""The command line: ``python -m gadget_leicester_tpu_torch param.txt
[restartflag]``, as ``Gadget2 param.txt [restartflag]`` [G2: main.c].

Counterpart of ``gadget_leicester_tpu/__main__.py:12-88``. restartflag: 0
(default) starts from InitCondFile, 1 resumes from the restart dump, 2
starts from a snapshot named by InitCondFile. ``--device`` (``cuda``, the
default, or ``cpu``) is the one flag the JAX CLI lacks; asked for CUDA
where there is none, the run stops with a message and a non-zero exit.
``--makeglass NSIDE`` writes an NSIDE^3 glass (``models/glass.py``) as
``glass.dat`` into OutputDir, in SnapFormat, and exits. ``--devices`` is
not ported (ROADMAP queue 1 item 14) and exits non-zero.
``--isothermal`` runs the isothermal EOS. ``--cooling`` and ``--sinks``
run the fork's physics. As
in the JAX CLI, no sink is registered from the particle types: a run
through the CLI forms sinks only by ``SinkFormationDensity``, and the star
of ``parameterfiles/disc.param`` never accretes (the Python API's
``models.sinks.register_sinks_from_types`` does that; ROADMAP queue 3).
"""

import argparse
import sys


def main(argv=None):
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
                    help="domain decomposition over K devices (not ported: "
                         "ROADMAP queue 1 item 14)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run goes: cuda (default, the kernels) "
                         "or cpu (their plain PyTorch versions)")
    args = ap.parse_args(argv)

    if args.devices:
        print("--devices is not ported yet (ROADMAP queue 1 item 14)",
              file=sys.stderr)
        return 2

    from gadget_leicester_tpu_torch.models.simulation import (Simulation,
                                                              resolve_device)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"gadget_leicester_tpu_torch: {exc}", file=sys.stderr)
        return 1
    if args.makeglass:
        return write_glass(args.paramfile, args.makeglass, args.device)
    # only explicitly given flags override the config and the sidecar
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
    sim = Simulation.from_param_file(args.paramfile, None,
                                     restart_flag=args.restartflag,
                                     opt_overrides=overrides,
                                     device=args.device)
    cfg, opts = sim.cfg, sim.opts
    print(f"N={int(sim.state.p.alive.sum())} particles on {sim.device}; "
          f"t={sim.time:g} -> {cfg.time_max:g}; "
          f"gravity={opts.gravity_mode}, pmgrid={opts.pmgrid}")
    sim.run(max_steps=args.max_steps)
    sim.logs.close()
    print(f"done: {sim.step_count} steps, t={sim.time:g}, "
          f"{sim.snapshot_count} snapshots in {cfg.output_dir}")
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
