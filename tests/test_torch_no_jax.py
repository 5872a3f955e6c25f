"""The port must run where jax is not installed (the machine with the
card has none): with jax made unimportable, every module of the port
(the run loop's I/O, diagnostics and CLI modules among them) and
chip_smoke.py import, and on the CPU one sync point of a 2x10^3 box runs
under the block and the coarse-cell SPH backend (the latter with sinks
and Stamatellos cooling), two of a small Evrard sphere under direct
gravity and all-pairs SPH, three of a small Leicester disc with beta
cooling and sinks and two of it under block SPH on its vacuum grid, and
one of a Plummer sphere under the tree, with a periodic tree force
through the Ewald table; the force test, the placed step and the host
helpers of utils/native.py run on the sphere."""

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
       "utils.diagnostics", "utils.logfiles", "ops.sph_cells",
       "ops.gravity_direct", "ops.sph_dense", "ops.tree", "ops.ewald",
       "models.cooling", "models.sinks", "parallel.step", "utils.forcetest",
       "utils.native"}
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
# the coarse-cell backend with the in-step potential (sinks, Stamatellos
# cooling), and the vacuum gas path (direct gravity, all-pairs SPH)
sim = Simulation(cfg, opts.replace(sph_backend="cells", sinks=True,
                                   cooling="stamatellos"), "cpu")
sim.set_ics(pos, vel, mass, ptype, u=u)
sim.step()
assert torch.isfinite(sim.state.gas.density).all()
assert torch.isfinite(sim.state.p.pot).all()
assert int(sim.state.overflow_flags) == 0
# the Leicester disc: beta cooling and accretion onto the star
from gadget_leicester_tpu_torch.models.ics import disc_ics
from gadget_leicester_tpu_torch.models.sinks import register_sinks_from_types
dcfg = parse_parameter_text(chip_smoke.gassphere_param_text("x", "y", 0.5)
                            + "\nSinkAccretionRadius 0.35\nCoolingBeta 1.0\n")
pos_d, vel_d, mass_d, ptype_d, u_d = disc_ics(n_gas=200, r_in=0.2)
dsim = Simulation(dcfg, SimOptions(periodic=False, cooling="beta", sinks=True),
                  "cpu")
dsim.set_ics(pos_d, vel_d, mass_d, ptype_d, u=u_d)
dsim.state = register_sinks_from_types(dsim.state)
dsim.step(3)
assert torch.isfinite(dsim.state.p.vel).all()
# the same disc under block SPH on its vacuum grid (the absolute mode)
bsim = Simulation(dcfg, SimOptions(periodic=False, cooling="beta", sinks=True,
                                   sph_backend="blocks"), "cpu")
bsim.set_ics(pos_d, vel_d, mass_d, ptype_d, u=u_d)
bsim.step(2)
assert torch.isfinite(bsim.state.gas.density).all()
assert bsim.state.grids.sph[1].periodic is False
from gadget_leicester_tpu_torch.models.ics import gassphere_ics
gcfg = parse_parameter_text(chip_smoke.gassphere_param_text("x", "y", 0.5))
pos, vel, mass, ptype, u = gassphere_ics(n_gas=200)
gsim = Simulation(gcfg, SimOptions(periodic=False), "cpu")
gsim.set_ics(pos, vel, mass, ptype, u=u)
gsim.step(2)
assert torch.isfinite(gsim.state.p.vel).all() and int(gsim.state.ti_current) > 0
# the force test, the placed step and the host helpers
from gadget_leicester_tpu_torch.utils.forcetest import run_forcetest
assert run_forcetest(gsim.state, gcfg, SimOptions(forcetest=0.1))["rel_err"].max() < 1e-2
from gadget_leicester_tpu_torch.parallel.step import make_sharded_step
pstep, pst = make_sharded_step(gsim.state, gcfg, SimOptions(periodic=False), "cpu")
assert int(pstep(pst).ti_current) > int(gsim.state.ti_current)
from gadget_leicester_tpu_torch.utils import native
import numpy as np
assert len(native.peano_hilbert_order(np.random.rand(50, 3), 0.0, 1.0)) == 50
# the tree path: a Plummer sphere through the tree, a periodic box through
# the Ewald correction (its table is built under build/ewald/)
from gadget_leicester_tpu_torch.models.ics import plummer_ics
pos, vel, mass, ptype, _ = plummer_ics(300)
tsim = Simulation(gcfg, SimOptions(periodic=False, gravity_mode="tree"), "cpu")
tsim.set_ics(pos, vel, mass, ptype)
tsim.step()
assert torch.isfinite(tsim.state.p.acc).all() and tsim.state.p.acc.any()
from gadget_leicester_tpu_torch.ops.tree import tree_gravity
acc, pot = tree_gravity(torch.rand(64, 3), torch.ones(64), torch.full((64,), 0.01),
                        torch.ones(64, dtype=torch.bool), opening=0, depth=4,
                        periodic=True, box=1.0)
assert torch.isfinite(acc).all()
leaked = sorted(m for m in sys.modules
                if m == "gadget_leicester_tpu" or m.startswith("gadget_leicester_tpu."))
assert not leaked, leaked
print("modules", len(names), "ti", int(sim.state.ti_current))
"""


def test_port_imports_and_steps_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
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
