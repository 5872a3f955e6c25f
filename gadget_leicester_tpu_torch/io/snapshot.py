"""GADGET snapshot / IC file formats 1, 2, and HDF5 — bit-compatible.

Rebuild of [G2: io.c :: savepositions()/write_file()/fill_write_buffer()]
and [G2: read_ic.c :: read_ic()/read_file()]:

* 256-byte header struct (npart[6], mass[6], time, redshift, flag_sfr,
  flag_feedback, npartTotal[6], flag_cooling, num_files, BoxSize, Omega0,
  OmegaLambda, HubbleParam, flag_stellarage, flag_metals,
  npartTotalHighWord[6], flag_entropy, fill) [G2: allvars.h io_header]
* Format 1: F77 unformatted records — each block framed by int32
  byte-count markers.
* Format 2: same, plus a leading 4-char label record per block
  ("HEAD", "POS ", "VEL ", "ID  ", "MASS", "U   ", "RHO ", "HSML", ...).
* Format 3: HDF5 (/Header attributes, /PartType{0..5}/Coordinates, ...).
* Endianness-tolerant reads (record markers detect byte order)
  [G2: read_ic.c swap handling].

Block order [G2: io.c enum iofields]: POS VEL ID MASS U RHO HSML
(POT ACCEL DTENTR TSTP optional on output). Mass block contains only
particles of types whose header mass[] entry is 0.

Counterpart of ``gadget_leicester_tpu/io/snapshot.py``, copied: it holds
no JAX code, but importing any module of the JAX package imports jax, and
the port runs where jax is not installed. tests/test_torch_io.py holds
the copy equal to the original (byte-identical files, equal reads).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

HEADER_SIZE = 256
_HEADER_FMT = "<6I6dddii6iiidddd ii6Iii"  # see pack/unpack below

N_TYPES = 6


@dataclass
class Header:
    """[G2: allvars.h struct io_header] — field-for-field."""

    npart: np.ndarray = field(default_factory=lambda: np.zeros(6, np.uint32))
    mass: np.ndarray = field(default_factory=lambda: np.zeros(6, np.float64))
    time: float = 0.0
    redshift: float = 0.0
    flag_sfr: int = 0
    flag_feedback: int = 0
    npart_total: np.ndarray = field(default_factory=lambda: np.zeros(6, np.uint32))
    flag_cooling: int = 0
    num_files: int = 1
    box_size: float = 0.0
    omega0: float = 0.0
    omega_lambda: float = 0.0
    hubble_param: float = 0.0
    flag_stellarage: int = 0
    flag_metals: int = 0
    npart_total_highword: np.ndarray = field(
        default_factory=lambda: np.zeros(6, np.uint32))
    flag_entropy_instead_u: int = 0

    def pack(self, endian: str = "<") -> bytes:
        buf = b""
        buf += np.asarray(self.npart, np.uint32).astype(endian + "u4").tobytes()
        buf += np.asarray(self.mass, np.float64).astype(endian + "f8").tobytes()
        buf += struct.pack(endian + "ddii", self.time, self.redshift,
                           self.flag_sfr, self.flag_feedback)
        buf += np.asarray(self.npart_total, np.uint32).astype(endian + "u4").tobytes()
        buf += struct.pack(endian + "ii", self.flag_cooling, self.num_files)
        buf += struct.pack(endian + "dddd", self.box_size, self.omega0,
                           self.omega_lambda, self.hubble_param)
        buf += struct.pack(endian + "ii", self.flag_stellarage, self.flag_metals)
        buf += np.asarray(self.npart_total_highword, np.uint32).astype(
            endian + "u4").tobytes()
        buf += struct.pack(endian + "i", self.flag_entropy_instead_u)
        buf += b"\x00" * (HEADER_SIZE - len(buf))
        assert len(buf) == HEADER_SIZE
        return buf

    @classmethod
    def unpack(cls, raw: bytes, endian: str = "<") -> "Header":
        assert len(raw) >= HEADER_SIZE
        off = 0

        def take(n):
            nonlocal off
            b = raw[off:off + n]
            off += n
            return b

        h = cls()
        h.npart = np.frombuffer(take(24), endian + "u4").copy()
        h.mass = np.frombuffer(take(48), endian + "f8").copy()
        h.time, h.redshift, h.flag_sfr, h.flag_feedback = struct.unpack(
            endian + "ddii", take(24))
        h.npart_total = np.frombuffer(take(24), endian + "u4").copy()
        h.flag_cooling, h.num_files = struct.unpack(endian + "ii", take(8))
        h.box_size, h.omega0, h.omega_lambda, h.hubble_param = struct.unpack(
            endian + "dddd", take(32))
        h.flag_stellarage, h.flag_metals = struct.unpack(endian + "ii", take(8))
        h.npart_total_highword = np.frombuffer(take(24), endian + "u4").copy()
        (h.flag_entropy_instead_u,) = struct.unpack(endian + "i", take(4))
        return h


@dataclass
class SnapshotData:
    """Host-side snapshot contents in file order (types concatenated 0..5)."""

    header: Header
    pos: np.ndarray              # [N,3] f32
    vel: np.ndarray              # [N,3] f32
    ids: np.ndarray              # [N] u32 (or u64)
    mass: np.ndarray             # [N] f32 — always densified on read
    u: Optional[np.ndarray] = None       # [Ngas]
    rho: Optional[np.ndarray] = None     # [Ngas]
    hsml: Optional[np.ndarray] = None    # [Ngas]
    pot: Optional[np.ndarray] = None     # [N]
    extra: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def ptype(self) -> np.ndarray:
        out = np.zeros(int(self.header.npart.sum()), np.int32)
        o = 0
        for t in range(N_TYPES):
            n = int(self.header.npart[t])
            out[o:o + n] = t
            o += n
        return out


# ---------------------------------------------------------------------------
# F77 record framing
# ---------------------------------------------------------------------------
class _RecordReader:
    def __init__(self, fh, endian: str):
        self.fh = fh
        self.endian = endian

    def read_record(self) -> bytes:
        raw = self.fh.read(4)
        if len(raw) < 4:
            raise EOFError("end of file")
        (n,) = struct.unpack(self.endian + "i", raw)
        data = self.fh.read(n)
        (n2,) = struct.unpack(self.endian + "i", self.fh.read(4))
        if n2 != n:
            raise IOError(f"record marker mismatch: {n} vs {n2}")
        return data

    def skip_record(self) -> int:
        raw = self.fh.read(4)
        if len(raw) < 4:
            raise EOFError("end of file")
        (n,) = struct.unpack(self.endian + "i", raw)
        self.fh.seek(n + 4, 1)
        return n


def _write_record(fh, data: bytes, endian: str):
    fh.write(struct.pack(endian + "i", len(data)))
    fh.write(data)
    fh.write(struct.pack(endian + "i", len(data)))


def _detect_endian_and_format(fh):
    """Peek the first record marker: fmt2's label record is 8 bytes; fmt1's
    header record is 256. Detects byte order too [G2: read_ic.c]."""
    raw = fh.read(4)
    fh.seek(0)
    if len(raw) < 4:
        raise IOError("empty file")
    for endian in ("<", ">"):
        (n,) = struct.unpack(endian + "i", raw)
        if n == 8:
            return endian, 2
        if n == 256:
            return endian, 1
    raise IOError("not a GADGET fmt 1/2 file (first marker %r)" % raw)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------
def read_snapshot(path: str) -> SnapshotData:
    """Read a GADGET format 1/2/HDF5 snapshot or IC file (single file)."""
    if _is_hdf5(path):
        return _read_hdf5(path)
    with open(path, "rb") as fh:
        endian, fmt = _detect_endian_and_format(fh)
        rr = _RecordReader(fh, endian)

        def next_block(expected_label=None):
            """fmt 2: read the next label record. With an expected label,
            SKIP unknown labelled blocks (ACCE/TSTP/... from other builds)
            until it appears — labels make the format self-describing, so
            honour them [ADVICE r1]. fmt 1: positional, return expected."""
            if fmt != 2:
                return expected_label
            while True:
                lab = rr.read_record()
                label = lab[:4].decode("ascii", "replace")
                if expected_label is None or label.strip() == expected_label.strip():
                    return label
                rr.skip_record()  # unknown block's payload

        next_block("HEAD")
        header = Header.unpack(rr.read_record(), endian)
        n = int(header.npart.sum())
        ngas = int(header.npart[0])

        # mass block present iff any type has npart>0 and header mass==0
        nmass = sum(int(header.npart[t]) for t in range(N_TYPES)
                    if header.npart[t] > 0 and header.mass[t] == 0)

        snap = SnapshotData(
            header=header,
            pos=np.zeros((n, 3), np.float32),
            vel=np.zeros((n, 3), np.float32),
            ids=np.zeros(n, np.uint32),
            mass=np.zeros(n, np.float32),
        )

        def read_f32(count):
            return np.frombuffer(rr.read_record(), endian + "f4",
                                 count=count).copy()

        # POS, VEL, ID mandatory
        next_block("POS ")
        snap.pos = read_f32(3 * n).reshape(n, 3)
        next_block("VEL ")
        snap.vel = read_f32(3 * n).reshape(n, 3)
        next_block("ID  ")
        id_rec = rr.read_record()
        if len(id_rec) == 8 * n:
            snap.ids = np.frombuffer(id_rec, endian + "u8").copy()
        else:
            snap.ids = np.frombuffer(id_rec, endian + "u4").copy()
        if nmass > 0:
            next_block("MASS")
            mass_read = read_f32(nmass)
        else:
            mass_read = np.zeros(0, np.float32)
        # densify masses
        o = 0
        mo = 0
        for t in range(N_TYPES):
            nt = int(header.npart[t])
            if nt == 0:
                continue
            if header.mass[t] == 0:
                snap.mass[o:o + nt] = mass_read[mo:mo + nt]
                mo += nt
            else:
                snap.mass[o:o + nt] = header.mass[t]
            o += nt

        # optional blocks: U, RHO, HSML (gas-sized), POT (all particles).
        # fmt 2 is label-driven: unknown labels (ACCE/TSTP/DTEN from other
        # builds) are SKIPPED, never misread into a known attribute.
        known = {"U": ("u", "gas"), "RHO": ("rho", "gas"),
                 "HSML": ("hsml", "gas"), "POT": ("pot", "all")}
        if fmt == 2:
            while True:
                try:
                    name = next_block().strip()
                except EOFError:
                    break
                if name in known and (ngas or known[name][1] == "all"):
                    attr, scope = known[name]
                    count = n if scope == "all" else ngas
                    try:
                        setattr(snap, attr, read_f32(count))
                    except (EOFError, IOError):
                        break
                else:
                    try:
                        rr.skip_record()
                    except (EOFError, IOError):
                        break
        else:
            # fmt 1 has no labels: blocks are positional in stock order
            opt_order = (["U", "RHO", "HSML"] if ngas else []) + ["POT"]
            for name in opt_order:
                attr, scope = known[name]
                count = n if scope == "all" else ngas
                try:
                    setattr(snap, attr, read_f32(count))
                except (EOFError, IOError):
                    break
        return snap


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------
def write_snapshot(path: str, snap: SnapshotData, fmt: int = 1,
                   endian: str = "<") -> None:
    """Write format 1/2/HDF5, matching stock block order and framing."""
    if fmt == 3:
        _write_hdf5(path, snap)
        return
    header = snap.header
    ngas = int(header.npart[0])

    def write_block(fh, name, payload: bytes):
        if fmt == 2:
            # label record: 4-char tag + int32 = framed size of next block
            # (payload + its two markers) [G2: io.c SnapFormat==2 path]
            _write_record(
                fh,
                name.encode("ascii").ljust(4)[:4]
                + struct.pack(endian + "i", len(payload) + 8),
                endian,
            )
        _write_record(fh, payload, endian)

    with open(path, "wb") as fh:
        write_block(fh, "HEAD", header.pack(endian))
        write_block(fh, "POS ", np.asarray(snap.pos, np.float32).astype(
            endian + "f4").tobytes())
        write_block(fh, "VEL ", np.asarray(snap.vel, np.float32).astype(
            endian + "f4").tobytes())
        ids = np.asarray(snap.ids)
        idt = endian + ("u8" if ids.dtype.itemsize == 8 else "u4")
        write_block(fh, "ID  ", ids.astype(idt).tobytes())
        # sparse mass block
        mass_out = []
        o = 0
        for t in range(N_TYPES):
            nt = int(header.npart[t])
            if nt and header.mass[t] == 0:
                mass_out.append(np.asarray(snap.mass[o:o + nt], np.float32))
            o += nt
        if mass_out:
            write_block(fh, "MASS", np.concatenate(mass_out).astype(
                endian + "f4").tobytes())
        if ngas:
            for name, arr in (("U   ", snap.u), ("RHO ", snap.rho),
                              ("HSML", snap.hsml)):
                if arr is None:
                    continue
                write_block(fh, name, np.asarray(arr[:ngas], np.float32)
                            .astype(endian + "f4").tobytes())
        if snap.pot is not None:  # [G2: OUTPUTPOTENTIAL block, all types]
            write_block(fh, "POT ", np.asarray(snap.pot, np.float32)
                        .astype(endian + "f4").tobytes())


# ---------------------------------------------------------------------------
# Multi-file snapshot sets [G2: io.c NumFilesPerSnapshot > 1]
# ---------------------------------------------------------------------------
def write_snapshot_set(path_base: str, snap: SnapshotData, num_files: int = 1,
                       fmt: int = 1, endian: str = "<") -> None:
    """Split the snapshot across `num_files` files ``path_base.K``
    (single-file sets keep the bare path, matching the reference)."""
    if num_files <= 1:
        write_snapshot(path_base, snap, fmt=fmt, endian=endian)
        return
    n = int(snap.header.npart.sum())
    bounds = np.linspace(0, n, num_files + 1).astype(int)
    ptype = snap.ptype
    ngas_total = int(snap.header.npart[0])
    for k in range(num_files):
        lo, hi = bounds[k], bounds[k + 1]
        h = Header()
        for t in range(N_TYPES):
            h.npart[t] = int(((ptype[lo:hi]) == t).sum())
        h.mass = snap.header.mass.copy()
        h.npart_total = snap.header.npart_total.copy()
        h.time = snap.header.time
        h.redshift = snap.header.redshift
        h.box_size = snap.header.box_size
        h.omega0 = snap.header.omega0
        h.omega_lambda = snap.header.omega_lambda
        h.hubble_param = snap.header.hubble_param
        h.num_files = num_files
        gas_lo, gas_hi = min(lo, ngas_total), min(hi, ngas_total)
        part = SnapshotData(
            header=h,
            pos=snap.pos[lo:hi], vel=snap.vel[lo:hi],
            ids=snap.ids[lo:hi], mass=snap.mass[lo:hi],
            u=None if snap.u is None else snap.u[gas_lo:gas_hi],
            rho=None if snap.rho is None else snap.rho[gas_lo:gas_hi],
            hsml=None if snap.hsml is None else snap.hsml[gas_lo:gas_hi],
        )
        write_snapshot(f"{path_base}.{k}", part, fmt=fmt, endian=endian)


def read_snapshot_set(path_base: str) -> SnapshotData:
    """Read a snapshot regardless of single/multi-file layout
    [G2: read_ic.c file-group handling]."""
    import os
    if os.path.exists(path_base):
        snap = read_snapshot(path_base)
        if snap.header.num_files <= 1:
            return snap
    parts = []
    k = 0
    while os.path.exists(f"{path_base}.{k}"):
        parts.append(read_snapshot(f"{path_base}.{k}"))
        k += 1
    if not parts:
        raise FileNotFoundError(f"no snapshot at {path_base}(.K)")
    # concatenate in type order: gather per type across files
    h = Header()
    h.npart = sum(p.header.npart for p in parts).astype(np.uint32)
    h.npart_total = parts[0].header.npart_total.copy()
    h.mass = parts[0].header.mass.copy()
    h.time = parts[0].header.time
    h.redshift = parts[0].header.redshift
    h.box_size = parts[0].header.box_size
    h.omega0 = parts[0].header.omega0
    h.omega_lambda = parts[0].header.omega_lambda
    h.hubble_param = parts[0].header.hubble_param
    pos, vel, ids, mass, u, rho, hsml = [], [], [], [], [], [], []
    for t in range(N_TYPES):
        for p in parts:
            tm = p.ptype == t
            if not tm.any():
                continue
            pos.append(p.pos[tm]); vel.append(p.vel[tm])
            ids.append(p.ids[tm]); mass.append(p.mass[tm])
            if t == 0:
                ng = int(tm[:len(p.u) if p.u is not None else 0].sum())
                if p.u is not None:
                    u.append(p.u)
                if p.rho is not None:
                    rho.append(p.rho)
                if p.hsml is not None:
                    hsml.append(p.hsml)
    return SnapshotData(
        header=h,
        pos=np.concatenate(pos), vel=np.concatenate(vel),
        ids=np.concatenate(ids), mass=np.concatenate(mass),
        u=np.concatenate(u) if u else None,
        rho=np.concatenate(rho) if rho else None,
        hsml=np.concatenate(hsml) if hsml else None,
    )


# ---------------------------------------------------------------------------
# HDF5 (format 3)
# ---------------------------------------------------------------------------
def _is_hdf5(path: str) -> bool:
    try:
        with open(path, "rb") as fh:
            return fh.read(8) == b"\x89HDF\r\n\x1a\n"
    except OSError:
        return False


_H5_HEADER_ATTRS = [
    ("NumPart_ThisFile", "npart"), ("MassTable", "mass"), ("Time", "time"),
    ("Redshift", "redshift"), ("Flag_Sfr", "flag_sfr"),
    ("Flag_Feedback", "flag_feedback"), ("NumPart_Total", "npart_total"),
    ("Flag_Cooling", "flag_cooling"), ("NumFilesPerSnapshot", "num_files"),
    ("BoxSize", "box_size"), ("Omega0", "omega0"),
    ("OmegaLambda", "omega_lambda"), ("HubbleParam", "hubble_param"),
]


def _write_hdf5(path: str, snap: SnapshotData) -> None:
    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("format 3 requires h5py") from e
    header = snap.header
    with h5py.File(path, "w") as f:
        g = f.create_group("Header")
        for aname, fname in _H5_HEADER_ATTRS:
            g.attrs[aname] = getattr(header, fname)
        o = 0
        for t in range(N_TYPES):
            nt = int(header.npart[t])
            if nt == 0:
                continue
            pg = f.create_group(f"PartType{t}")
            pg.create_dataset("Coordinates", data=snap.pos[o:o + nt])
            pg.create_dataset("Velocities", data=snap.vel[o:o + nt])
            pg.create_dataset("ParticleIDs", data=snap.ids[o:o + nt])
            pg.create_dataset("Masses", data=snap.mass[o:o + nt])
            if t == 0:
                if snap.u is not None:
                    pg.create_dataset("InternalEnergy", data=snap.u[:nt])
                if snap.rho is not None:
                    pg.create_dataset("Density", data=snap.rho[:nt])
                if snap.hsml is not None:
                    pg.create_dataset("SmoothingLength", data=snap.hsml[:nt])
            o += nt


def _read_hdf5(path: str) -> SnapshotData:
    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("HDF5 snapshot requires h5py") from e
    with h5py.File(path, "r") as f:
        h = Header()
        g = f["Header"]
        for aname, fname in _H5_HEADER_ATTRS:
            if aname in g.attrs:
                setattr(h, fname, g.attrs[aname])
        n = int(np.sum(h.npart))
        snap = SnapshotData(
            header=h,
            pos=np.zeros((n, 3), np.float32),
            vel=np.zeros((n, 3), np.float32),
            ids=np.zeros(n, np.uint32),
            mass=np.zeros(n, np.float32),
        )
        o = 0
        for t in range(N_TYPES):
            nt = int(h.npart[t])
            if nt == 0:
                continue
            pg = f[f"PartType{t}"]
            snap.pos[o:o + nt] = pg["Coordinates"][:]
            snap.vel[o:o + nt] = pg["Velocities"][:]
            snap.ids[o:o + nt] = pg["ParticleIDs"][:]
            if "Masses" in pg:
                snap.mass[o:o + nt] = pg["Masses"][:]
            else:
                snap.mass[o:o + nt] = h.mass[t]
            if t == 0:
                if "InternalEnergy" in pg:
                    snap.u = np.asarray(pg["InternalEnergy"][:], np.float32)
                if "Density" in pg:
                    snap.rho = np.asarray(pg["Density"][:], np.float32)
                if "SmoothingLength" in pg:
                    snap.hsml = np.asarray(pg["SmoothingLength"][:], np.float32)
            o += nt
        return snap
