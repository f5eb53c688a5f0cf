"""LAMMPS molecule-template files (molecule.cpp's format) for molecule-mode
insertion.

Counterpart of `obmd_tpu/io/molecule.py`: `MoleculeTemplate` and
`read_molecule` take the header counts and the Coords, Types, Charges,
Masses, Bonds, Angles, Dihedrals and Impropers sections (any other section
is skipped); `write_molecule` writes a template in the same format, so a
scene can hand its template to the reader as a user's deck would.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

SECTIONS = ("Coords", "Types", "Charges", "Masses", "Bonds", "Angles",
            "Dihedrals", "Impropers", "Special")
# the header keyword of each counted topology section
COUNTS = (("bonds", "Bonds"), ("angles", "Angles"),
          ("dihedrals", "Dihedrals"), ("impropers", "Impropers"))


@dataclasses.dataclass
class MoleculeTemplate:
    natoms: int
    x: np.ndarray             # [n, 3] coordinates relative to the file origin
    types: np.ndarray         # [n] 0-based
    q: Optional[np.ndarray] = None
    masses: Optional[np.ndarray] = None     # [n] per-atom masses
    bonds: Optional[np.ndarray] = None      # [nb, 3] (type, a1, a2), 1-based
    angles: Optional[np.ndarray] = None     # [na, 4] (type, a1, a2, a3)
    dihedrals: Optional[np.ndarray] = None  # [nd, 5] (type, a1..a4)
    impropers: Optional[np.ndarray] = None  # [ni, 5] (type, i1..i4), i2
    #                                          the center
    rep_atom: Optional[int] = None          # representative atom (1-based)

    @property
    def center(self) -> np.ndarray:
        """The geometric center (Molecule::compute_center): the insertion
        anchor (fix_obmd_merged.cpp:216)."""
        return self.x.mean(axis=0)

    @property
    def dx(self) -> np.ndarray:
        """Each atom's displacement from the center."""
        return self.x - self.center


def _clean(line: str) -> str:
    return line.split("#")[0].strip()


def read_molecule(path: str) -> MoleculeTemplate:
    """The template of a molecule file: a title line, the header counts
    (`N atoms`, `N bonds`, ...), then the sections by name."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    n = len(lines)
    counts = dict(atoms=0, bonds=0, angles=0, dihedrals=0, impropers=0)
    i = 1                                   # the title
    while i < n:
        s = _clean(lines[i])
        if s:
            t = s.split()
            if t[0] in SECTIONS:
                break
            for key in counts:
                if s.endswith(key):
                    counts[key] = int(t[0])
        i += 1
    natoms = counts["atoms"]
    out = MoleculeTemplate(natoms=natoms, x=np.zeros((natoms, 3)),
                           types=np.zeros(natoms, np.int32))

    def read_rows(count, width):
        nonlocal i
        while i < n and not _clean(lines[i]):
            i += 1
        rows = []
        for _ in range(count):
            rows.append([float(v) for v in _clean(lines[i]).split()[:width]])
            i += 1
        return np.asarray(rows).reshape(count, width)

    def per_atom(width):
        r = read_rows(natoms, width)
        return (r[:, 0] - 1).astype(int), r

    while i < n:
        header = _clean(lines[i])
        i += 1
        if not header:
            continue
        if header == "Coords":
            row, r = per_atom(4)
            out.x[row] = r[:, 1:4]
        elif header == "Types":
            row, r = per_atom(2)
            out.types[row] = r[:, 1].astype(int) - 1
        elif header in ("Charges", "Masses"):
            row, r = per_atom(2)
            col = np.zeros(natoms)
            col[row] = r[:, 1]
            setattr(out, "q" if header == "Charges" else "masses", col)
        elif header in dict(COUNTS).values():
            key = {v: k for k, v in COUNTS}[header]
            width = {"bonds": 3, "angles": 4, "dihedrals": 5,
                     "impropers": 5}[key]
            r = read_rows(counts[key], width + 1)
            setattr(out, key, r[:, 1:].astype(np.int32))
        else:
            while i < n and _clean(lines[i]):
                i += 1
    return out


def write_molecule(path: str, tpl: MoleculeTemplate,
                   title: str = "molecule template") -> None:
    """Write `tpl` as a molecule file that read_molecule reads back (types
    written 1-based; a topology section for each of bonds, angles,
    dihedrals and impropers that is not None)."""
    lines = [title, "", f"{tpl.natoms} atoms"]
    topo = [(key, head, getattr(tpl, key)) for key, head in COUNTS
            if getattr(tpl, key) is not None]
    lines += [f"{len(rows)} {key}" for key, _h, rows in topo]
    lines += ["", "Coords", ""]
    lines += [f"{k + 1} {x:.17g} {y:.17g} {z:.17g}"
              for k, (x, y, z) in enumerate(np.asarray(tpl.x, np.float64))]
    lines += ["", "Types", ""]
    lines += [f"{k + 1} {int(t) + 1}" for k, t in enumerate(tpl.types)]
    for head, col in (("Charges", tpl.q), ("Masses", tpl.masses)):
        if col is not None:
            lines += ["", head, ""]
            lines += [f"{k + 1} {float(v):.17g}" for k, v in enumerate(col)]
    for _key, head, rows in topo:
        lines += ["", head, ""]
        lines += [" ".join(str(int(v)) for v in (k + 1, *row))
                  for k, row in enumerate(np.asarray(rows))]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
