"""Build, bind and count the hand-written CUDA kernels of ``csrc/``.

The kernels, eleven sources (A short-range gravity and, in the same
source, H short-range gravity with the potential, B PM deposit, C SPH
density, D SPH hydro, the active-entry twins E, F, G of A, C, D, with E
in two modes, the force and the force with the potential, and C, D, F, G
each in two, block-relative on a periodic grid and absolute on a clamped
one (the ``_abs`` entries), the coarse-cell SPH density I/J and hydro K,
L the CIC gather of the PM mesh, and M short-range gravity in absolute
coordinates with the per-pair minimum image; the slab step's modes are A's
slab mode, in M's source, with and without the potential row, and C's and
D's relative mode on per-axis block grids, the ``_aniso`` entries, and
I/J's and K's ghost-row mode on the slab's coarse cells, which launch
the cube's C entry and are counted apart, :data:`MODES`) are compiled
on first use with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all
started together, and linked into one shared library with a plain C
interface, written under ``build/torch_kernels/<hash of the sources and
flags>/`` at the root of the checkout, and loaded with ``ctypes``. Every C
entry returns ``cudaGetLastError()`` after its launch; :func:`launch`
raises when that is not 0. A failed build raises with nvcc's output.

``launches`` counts, per kernel, the launches its wrapper made; only the
wrappers add to it, and only where they launch the kernel (a CPU tensor
takes the plain version and counts nothing).

While ``recording`` is True, each wrapper keeps the arguments of its last
call in ``recorded[name]`` (:func:`note_call`), so the inputs the main
path gave a kernel can be replayed against its plain version at the
path's own shapes (``chip_smoke.py``); while ``history`` is a list, every
call's (name, arguments) is appended to it as well, for a path that calls
one wrapper on several inputs (the zoom's two meshes).

Nothing here runs at import: the module is imported on machines without
``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
SOURCES = ("shortrange_gravity.cu", "pm_deposit.cu", "sph_density.cu",
           "sph_hydro.cu", "shortrange_gravity_entries.cu",
           "sph_density_entries.cu", "sph_hydro_entries.cu",
           "sph_cells_density.cu", "sph_cells_hydro.cu", "pm_gather.cu",
           "shortrange_gravity_cells.cu")
HEADERS = ("glt_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
# C entry -> argument types (every entry ends with the stream)
SIGNATURES = {
    "shortrange_gravity": (_P, _P, _P, _I, _I, _F, _F, _F, _P),
    "pm_deposit": (_P, _P, _I, _I, _I, _F, _F, _P),
    "sph_density": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    "sph_hydro": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P),
    "shortrange_gravity_entries": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                                   _F, _P),
    "sph_density_entries": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                            _P),
    "sph_hydro_entries": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _F, _F, _P),
    "shortrange_potential": (_P, _P, _P, _I, _I, _F, _F, _F, _P),
    # I/J and K, either mode: per-axis cells, an image mask, cell flags
    # (K's nullable: the cube sums every cell)
    "sph_cells_density": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "sph_cells_hydro": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
    "pm_gather": (_P, _P, _P, _I, _I, _I, _D, _I, _P),
    "shortrange_gravity_cells": (_P, _P, _I, _I, _F, _I, _F, _F, _P),
    "shortrange_potential_entries": (_P, _P, _P, _P, _P, _I, _I, _I, _F,
                                     _F, _F, _P),
    # the absolute-coordinate modes of C, D, F, G (clamped vacuum grids)
    "sph_density_abs": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    "sph_hydro_abs": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    "sph_density_entries_abs": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _P),
    "sph_hydro_entries_abs": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                              _P),
    # the slab step's modes: A's in M's source (per-axis cells, an image
    # mask, tile flags, a workspace), C's and D's relative mode on per-axis
    # blocks
    "shortrange_gravity_slab": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                                _F, _P),
    # A's slab mode with the potential row (the in-step potential on slabs)
    "shortrange_gravity_slab_pot": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                    _F, _F, _P),
    "sph_density_aniso": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                          _P),
    "sph_hydro_aniso": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _F, _F, _P),
}
# modes counted apart from the C entry they launch: I/J's and K's ghost-row
# mode (the slab step's coarse cells, the cells that hold a target flagged)
MODES = {"sph_cells_density_slab": "sph_cells_density",
         "sph_cells_hydro_slab": "sph_cells_hydro"}

launches = {name: 0 for name in (*SIGNATURES, *MODES)}
recording = False
recorded: dict = {}   # kernel -> argument tuple of its wrapper's last call
history = None        # a list: (kernel, arguments) of every call

_lib = None
build_info = {}   # seconds, library path and nvcc's output of the library


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def note_call(name: str, args: tuple) -> None:
    """Keep a wrapper's arguments while ``recording`` is on, and append
    them to ``history`` while it is a list."""
    if recording:
        recorded[name] = args
    if history is not None:
        history.append((name, args))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    nvcc = _nvcc()
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libglt_kernels.so"
    # nvcc's output (-Xptxas=-v: registers, shared memory, spills) is kept
    # beside the library, so a cached build still reports it
    log_path = out_dir / "nvcc.log"
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else "(cached)"
        build_info.update(seconds=0.0, path=str(lib_path), log=log)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [out_dir / f"{Path(src).stem}.{tag}.o" for src in SOURCES]
    t0 = time.time()
    # one nvcc per source, all started together, then one link
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)]
    try:
        # every pipe is drained before any result is judged, so no nvcc
        # is left blocked on a full pipe
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, out in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} "
                                   f"({proc.returncode}):\n{out}")
        tmp = out_dir / f"libglt_kernels.{tag}.so"
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        log_path.write_text("".join(logs))
        os.replace(tmp, lib_path)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_info.update(seconds=time.time() - t0, path=str(lib_path),
                      log="".join(logs))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, f"glt_{name}")
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.glt_error_string.argtypes = [ctypes.c_int]
        lib.glt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry ``glt_<name>`` (of a mode of :data:`MODES`, its
    kernel's) on the current stream; count it as ``name``."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, f"glt_{MODES.get(name, name)}")(*args, stream)
    if rc != 0:
        msg = lib.glt_error_string(rc).decode()
        raise RuntimeError(f"kernel {name} failed to launch: {msg} ({rc})")
    launches[name] += 1


def check(t: torch.Tensor, what: str, dtype: torch.dtype, shape=None,
          device=None) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` (and of
    ``shape`` and on ``device`` when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when every one is
    on the CPU; raises on a mix or another device type."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")
