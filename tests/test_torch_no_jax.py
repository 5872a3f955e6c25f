"""The port must run where jax is not installed (the machine with the
card has none): with jax made unimportable, every module of the port
(the run loop's I/O, diagnostics and CLI modules among them) and
chip_smoke.py import, and one sync point of a 2x10^3 box runs on the CPU."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "gadget_leicester_tpu_torch"

CODE = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["jaxlib"] = None
import importlib, pkgutil
import gadget_leicester_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
new = {"__main__", "io.restart", "io.snapshot", "io.state_io",
       "utils.diagnostics", "utils.logfiles"}
assert {pkg.__name__ + "." + m for m in new} <= set(names), names
import chip_smoke
from gadget_leicester_tpu_torch.core.config import SimOptions, parse_parameter_text
from gadget_leicester_tpu_torch.models.ics import lcdm_gas_ics
from gadget_leicester_tpu_torch.models.simulation import Simulation
cfg = parse_parameter_text(chip_smoke.param_text(10))
opts = SimOptions(periodic=True, pmgrid=16, gravity_mode="treepm",
                  sph_backend="blocks")
pos, vel, mass, ptype, u = lcdm_gas_ics(n_side=10, box=cfg.box_size,
                                        hubble=cfg.hubble_internal,
                                        g=cfg.grav_internal)
sim = Simulation(cfg, opts, "cpu")
sim.set_ics(pos, vel, mass, ptype, u=u)
sim.step()
import torch
assert torch.isfinite(sim.state.p.pos).all()
assert int(sim.state.overflow_flags) == 0
leaked = sorted(m for m in sys.modules
                if m == "gadget_leicester_tpu" or m.startswith("gadget_leicester_tpu."))
assert not leaked, leaked
print("modules", len(names), "ti", int(sim.state.ti_current))
"""


def test_port_imports_and_steps_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_modules = int(proc.stdout.split()[1])
    assert n_modules >= 30


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits
