"""LAMMPS data files for `atom_style atomic`, `charge`, `bond`,
`molecular`, `full` and `adress`.

The port's own copy of `DataFile`, `read_data` and `write_data` of
`obmd_tpu/io/lammps_data.py` (read_data.cpp / write_data.cpp for the
sections the OBMD workloads use): the header (atoms, atom types, box
bounds; bond, angle, dihedral and improper counts are read from their
sections), Masses, Atoms (`atomic`: id type x y z; `charge`: id type q x y
z; `bond`, `molecular` and `adress`: id mol type x y z; `full`: id mol
type q x y z), Velocities, Bonds, Angles, Dihedrals and Impropers.
`read_data` reads through the native reader of io/native.py
(csrc/obmdio.cpp) where its library loads, as the JAX package's does,
and through the same pure-Python parser (`_read_data_py`) for
`atom_style bond`, where the library is unavailable, or where the native
reader refuses the file.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..geometry import Box

STYLES = ("atomic", "charge", "bond", "molecular", "full", "adress")
_SECTIONS = ("Masses", "Atoms", "Velocities", "Bonds", "Angles", "Dihedrals",
             "Impropers", "Pair Coeffs", "PairIJ Coeffs", "Bond Coeffs")


@dataclasses.dataclass
class DataFile:
    natoms: int
    ntypes: int
    box_lo: np.ndarray          # [3]
    box_hi: np.ndarray          # [3]
    masses: np.ndarray          # [ntypes] (index 0 = type 1 in the file)
    x: np.ndarray               # [n,3]
    types: np.ndarray           # [n] 0-based
    tags: np.ndarray            # [n] original ids
    v: Optional[np.ndarray] = None
    q: Optional[np.ndarray] = None      # [n] charges (atom_style charge)
    mol: Optional[np.ndarray] = None
    bonds: Optional[np.ndarray] = None  # [nb, 2] atom-tag pairs
    angles: Optional[np.ndarray] = None     # [na, 4] (type, a1, a2, a3)
    dihedrals: Optional[np.ndarray] = None  # [nd, 5] (type, a1..a4)
    impropers: Optional[np.ndarray] = None  # [ni, 5] (type, i1..i4)

    def box(self, periodic=(False, True, True)) -> Box:
        return Box(tuple(float(v) for v in self.box_lo),
                   tuple(float(v) for v in self.box_hi),
                   tuple(periodic))


def _check_style(atom_style: str) -> None:
    if atom_style not in STYLES:
        raise NotImplementedError(
            f"atom_style {atom_style!r} is not ported (only {STYLES})")


def _tokens(line: str):
    if "#" in line:
        line = line[:line.index("#")]
    return line.split()


def _skip_blank(lines, i):
    while i < len(lines) and not _tokens(lines[i]):
        i += 1
    return i


def _read_rows(lines, i, first: int, last: int):
    """The rows of a topology section from line i: columns first..last-1
    of each line up to the next blank one, as int64 [n, last - first]."""
    i = _skip_blank(lines, i)
    rows = []
    while i < len(lines) and _tokens(lines[i]):
        rows.append([int(v) for v in _tokens(lines[i])[first:last]])
        i += 1
    return i, np.asarray(rows, dtype=np.int64)


def read_data(path: str, atom_style: str = "atomic",
              prefer_native: bool = True) -> DataFile:
    """Parse a data file of `atom_style` atomic, charge, bond, molecular,
    full or adress: natively where `prefer_native` and the library loads
    (io/native.py's `available()`), else, and for `bond`, or where the
    native reader refuses the file, in Python."""
    _check_style(atom_style)
    if prefer_native and atom_style != "bond":
        from . import native
        try:
            df = native.read_data_native(path, atom_style)
        except OSError:
            df = None   # the pure-Python parser reads or refuses it
        if df is not None:
            return df
    return _read_data_py(path, atom_style)


def _read_data_py(path: str, atom_style: str = "atomic") -> DataFile:
    """The pure-Python parser."""
    _check_style(atom_style)
    with open(path) as fh:
        lines = fh.readlines()

    natoms = ntypes = 0
    lo = np.zeros(3)
    hi = np.zeros(3)
    i = 1  # skip the title line
    n = len(lines)
    while i < n:
        t = _tokens(lines[i])
        if not t:
            i += 1
            continue
        if lines[i].strip() in _SECTIONS:
            break
        joined = " ".join(t)
        if joined.endswith("atoms"):
            natoms = int(t[0])
        elif joined.endswith("atom types"):
            ntypes = int(t[0])
        elif joined.endswith("xlo xhi"):
            lo[0], hi[0] = float(t[0]), float(t[1])
        elif joined.endswith("ylo yhi"):
            lo[1], hi[1] = float(t[0]), float(t[1])
        elif joined.endswith("zlo zhi"):
            lo[2], hi[2] = float(t[0]), float(t[1])
        i += 1

    masses = np.ones(max(ntypes, 1))
    x = np.zeros((natoms, 3))
    v = q = mol = bonds = angles = dihedrals = impropers = None
    types = np.zeros(natoms, np.int32)
    tags = np.zeros(natoms, np.int32)
    need = {"atomic": 5, "charge": 6, "bond": 6, "molecular": 6,
            "adress": 6, "full": 7}[atom_style]

    while i < n:
        header = lines[i].strip().split("#")[0].strip()
        i += 1
        if not header:
            continue
        if header == "Masses":
            i = _skip_blank(lines, i)
            for _ in range(ntypes):
                t = _tokens(lines[i])
                masses[int(t[0]) - 1] = float(t[1])
                i += 1
        elif header.startswith("Atoms"):
            i = _skip_blank(lines, i)
            for k in range(natoms):
                t = _tokens(lines[i])
                if len(t) < need:
                    # read_data.cpp refuses the same way: reading on would
                    # shift every coordinate
                    raise ValueError(
                        f"Atoms line {k + 1} has {len(t)} columns; "
                        f"atom_style '{atom_style}' expects {need} — the "
                        "data file format does not match the atom_style")
                tags[k] = int(t[0])
                if atom_style == "atomic":
                    types[k] = int(t[1]) - 1
                    x[k] = [float(t[2]), float(t[3]), float(t[4])]
                elif atom_style == "charge":
                    if q is None:
                        q = np.zeros(natoms)
                    types[k] = int(t[1]) - 1
                    q[k] = float(t[2])
                    x[k] = [float(t[3]), float(t[4]), float(t[5])]
                elif atom_style == "full":
                    if mol is None:
                        mol = np.zeros(natoms, np.int32)
                    if q is None:
                        q = np.zeros(natoms)
                    mol[k] = int(t[1])
                    types[k] = int(t[2]) - 1
                    q[k] = float(t[3])
                    x[k] = [float(t[4]), float(t[5]), float(t[6])]
                else:
                    if mol is None:
                        mol = np.zeros(natoms, np.int32)
                    mol[k] = int(t[1])
                    types[k] = int(t[2]) - 1
                    x[k] = [float(t[3]), float(t[4]), float(t[5])]
                i += 1
        elif header == "Bonds":
            i, bonds = _read_rows(lines, i, 2, 4)
        elif header == "Angles":
            i, angles = _read_rows(lines, i, 1, 5)
        elif header == "Dihedrals":
            i, dihedrals = _read_rows(lines, i, 1, 6)
        elif header == "Impropers":
            i, impropers = _read_rows(lines, i, 1, 6)
        elif header == "Velocities":
            i = _skip_blank(lines, i)
            v = np.zeros((natoms, 3))
            id2row = {int(t): k for k, t in enumerate(tags)}
            for _ in range(natoms):
                t = _tokens(lines[i])
                v[id2row[int(t[0])]] = [float(t[1]), float(t[2]),
                                        float(t[3])]
                i += 1
        else:
            # skip an unknown section up to the next blank-delimited header
            i = _skip_blank(lines, i)
            while i < n and _tokens(lines[i]):
                i += 1

    return DataFile(natoms=natoms, ntypes=ntypes, box_lo=lo, box_hi=hi,
                    masses=masses, x=x, types=types, tags=tags, v=v, q=q,
                    mol=mol, bonds=bonds, angles=angles,
                    dihedrals=dihedrals, impropers=impropers)


def write_data(path: str, df: DataFile, atom_style: str = "atomic"):
    """Write `df` in the format read_data reads (and the JAX package's
    write_data writes)."""
    _check_style(atom_style)
    with open(path, "w") as fh:
        fh.write("LAMMPS data file (obmd_tpu)\n\n")
        fh.write(f"{df.natoms} atoms\n{df.ntypes} atom types\n")
        if df.bonds is not None and len(df.bonds):
            fh.write(f"{len(df.bonds)} bonds\n1 bond types\n")
        for rows, what in ((df.angles, "angle"), (df.dihedrals, "dihedral"),
                           (df.impropers, "improper")):
            if rows is not None and len(rows):
                ntyp = int(max(int(r[0]) for r in rows))
                fh.write(f"{len(rows)} {what}s\n{ntyp} {what} types\n")
        fh.write("\n")
        fh.write(f"{df.box_lo[0]} {df.box_hi[0]} xlo xhi\n")
        fh.write(f"{df.box_lo[1]} {df.box_hi[1]} ylo yhi\n")
        fh.write(f"{df.box_lo[2]} {df.box_hi[2]} zlo zhi\n\n")
        fh.write("Masses\n\n")
        for t in range(df.ntypes):
            fh.write(f"{t + 1} {df.masses[t]}\n")
        fh.write("\nAtoms\n\n")
        for k in range(df.natoms):
            pos = f"{df.x[k, 0]} {df.x[k, 1]} {df.x[k, 2]}"
            if atom_style == "atomic":
                fh.write(f"{df.tags[k]} {df.types[k] + 1} {pos}\n")
            elif atom_style == "charge":
                fh.write(f"{df.tags[k]} {df.types[k] + 1} {df.q[k]} {pos}\n")
            elif atom_style == "full":
                fh.write(f"{df.tags[k]} {df.mol[k]} {df.types[k] + 1} "
                         f"{df.q[k]} {pos}\n")
            else:
                mol_k = df.mol[k] if df.mol is not None else 0
                fh.write(f"{df.tags[k]} {mol_k} {df.types[k] + 1} {pos}\n")
        if df.v is not None:
            fh.write("\nVelocities\n\n")
            for k in range(df.natoms):
                fh.write(f"{df.tags[k]} {df.v[k, 0]} {df.v[k, 1]} "
                         f"{df.v[k, 2]}\n")
        if df.bonds is not None and len(df.bonds):
            fh.write("\nBonds\n\n")
            for i, (b1, b2) in enumerate(df.bonds):
                fh.write(f"{i + 1} 1 {int(b1)} {int(b2)}\n")
        for rows, name in ((df.angles, "Angles"), (df.dihedrals, "Dihedrals"),
                           (df.impropers, "Impropers")):
            if rows is not None and len(rows):
                fh.write(f"\n{name}\n\n")
                for i, r in enumerate(rows):
                    cols = " ".join(str(int(v)) for v in r)
                    fh.write(f"{i + 1} {cols}\n")
