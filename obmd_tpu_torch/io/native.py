"""ctypes bindings to the port's host I/O library (csrc/obmdio.cpp): the
LAMMPS data-file reader (read_data.cpp) and the custom and xyz dump
writers (dump_custom.cpp, dump_xyz.cpp) in C++.

The port's own copy of the JAX package's io/native.py: the same names,
ctypes signatures and atom-style codes.  The library is built at first use
by `_build.HOST_LIBRARIES["obmdio"]` into csrc/build/ (never into
native/).  Where no C++ compiler is found, `available()` is False and the
callers in io/lammps_data.py and io/dump.py take their Python paths; a
failed build or load of the port's own source raises, with the compiler's
output, rather than send them to Python unseen.
The writers take the port's State: each column they need is copied off
the device once (float32 x, v and f, int32 tag and type, the alive rows)
before the C call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_lib = None
_tried = False

_STYLES = {"atomic": 0, "charge": 1, "molecular": 2, "adress": 2, "full": 3}


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    from .._build import HOST_LIBRARIES, cxx_path
    record = HOST_LIBRARIES["obmdio"]
    if not record.library_path().exists():
        try:
            cxx_path()
        except RuntimeError:
            _tried = True   # no C++ compiler: the library cannot be had
            return None
    # a failed build of csrc/obmdio.cpp raises with the compiler's output,
    # at every call, and no caller takes its Python path in its place
    lib = ctypes.CDLL(str(record.path()))
    _tried = True
    lib.obmdio_read_data.restype = ctypes.c_void_p
    lib.obmdio_read_data.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.obmdio_error.restype = ctypes.c_char_p
    lib.obmdio_error.argtypes = [ctypes.c_void_p]
    lib.obmdio_natoms.restype = ctypes.c_int64
    lib.obmdio_natoms.argtypes = [ctypes.c_void_p]
    for name in ("obmdio_ntypes", "obmdio_has_v", "obmdio_has_q",
                 "obmdio_has_mol"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    lib.obmdio_box.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p]
    lib.obmdio_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
    for name in ("obmdio_nbonds", "obmdio_nangles", "obmdio_ndihedrals",
                 "obmdio_nimpropers"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.obmdio_fill_topology.argtypes = [ctypes.c_void_p] \
        + [ctypes.c_void_p] * 3
    lib.obmdio_fill_impropers.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.obmdio_free.argtypes = [ctypes.c_void_p]
    lib.obmdio_write_dump_custom.restype = ctypes.c_int
    lib.obmdio_write_dump_custom.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.obmdio_write_xyz.restype = ctypes.c_int
    lib.obmdio_write_xyz.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the library loads, so that read_data of a style it reads
    and the routed frames go through it."""
    return _load() is not None


def read_data_native(path: str, atom_style: str = "atomic"):
    """Native data-file read; returns an io.lammps_data.DataFile, or None
    when the library is unavailable.  Raises OSError with the library's
    message on a file it refuses."""
    lib = _load()
    if lib is None:
        return None
    from . import lammps_data
    h = lib.obmdio_read_data(path.encode(), _STYLES.get(atom_style, 0))
    try:
        err = lib.obmdio_error(h)
        if err:
            raise OSError(err.decode())
        n = lib.obmdio_natoms(h)
        ntypes = lib.obmdio_ntypes(h)
        lo = np.zeros(3)
        hi = np.zeros(3)
        lib.obmdio_box(h, lo.ctypes.data, hi.ctypes.data)
        x = np.zeros((n, 3))
        v = np.zeros((n, 3))
        q = np.zeros(n)
        typ = np.zeros(n, np.int32)
        tag = np.zeros(n, np.int32)
        mol = np.zeros(n, np.int32)
        masses = np.ones(max(ntypes, 1))
        lib.obmdio_fill(h, x.ctypes.data, v.ctypes.data, q.ctypes.data,
                        typ.ctypes.data, tag.ctypes.data, mol.ctypes.data,
                        masses.ctypes.data)
        nb = int(lib.obmdio_nbonds(h))
        na = int(lib.obmdio_nangles(h))
        nd = int(lib.obmdio_ndihedrals(h))
        ni = int(lib.obmdio_nimpropers(h))
        bonds = np.zeros((nb, 2), np.int64) if nb else None
        angles = np.zeros((na, 4), np.int64) if na else None
        dihedrals = np.zeros((nd, 5), np.int64) if nd else None
        impropers = np.zeros((ni, 5), np.int64) if ni else None
        if nb or na or nd:
            lib.obmdio_fill_topology(
                h, bonds.ctypes.data if nb else None,
                angles.ctypes.data if na else None,
                dihedrals.ctypes.data if nd else None)
        if ni:
            lib.obmdio_fill_impropers(h, impropers.ctypes.data)
        return lammps_data.DataFile(
            natoms=int(n), ntypes=int(ntypes), box_lo=lo, box_hi=hi,
            masses=masses, x=x, types=typ, tags=tag,
            v=v if lib.obmdio_has_v(h) else None,
            q=q if lib.obmdio_has_q(h) else None,
            mol=mol if lib.obmdio_has_mol(h) else None,
            bonds=bonds, angles=angles, dihedrals=dihedrals,
            impropers=impropers)
    finally:
        lib.obmdio_free(h)


def _alive_columns(state, *names, dtype):
    """The alive rows of the state's columns `names`, each copied off the
    device once, as C-contiguous numpy of `dtype`."""
    alive = state.alive.detach().cpu().numpy()
    return [np.ascontiguousarray(
        getattr(state, n).detach().cpu().numpy()[alive], dtype)
        for n in names]


def write_dump_custom_native(path: str, cfg, state,
                             append: bool = True) -> bool:
    """One `dump custom` frame of the columns id type x y z vx vy vz fx fy
    fz (box bounds as %.9g, floats as %.6f); False when the library is
    unavailable or the file cannot be opened."""
    lib = _load()
    if lib is None:
        return False
    x, v, f = _alive_columns(state, "x", "v", "f", dtype=np.float32)
    tag, typ = _alive_columns(state, "tag", "type", dtype=np.int32)
    lo = np.asarray(cfg.box.lo, np.float64)
    hi = np.asarray(cfg.box.hi, np.float64)
    bflags = " ".join("pp" if p else "ff" for p in cfg.box.periodic)
    rc = lib.obmdio_write_dump_custom(
        path.encode(), int(append), int(state.step), len(x),
        lo.ctypes.data, hi.ctypes.data, bflags.encode(),
        tag.ctypes.data, typ.ctypes.data, x.ctypes.data, v.ctypes.data,
        f.ctypes.data)
    return rc == 0


def write_xyz_native(path: str, state, append: bool = True) -> bool:
    """One `dump xyz` frame; False when the library is unavailable or the
    file cannot be opened."""
    lib = _load()
    if lib is None:
        return False
    (x,) = _alive_columns(state, "x", dtype=np.float32)
    (typ,) = _alive_columns(state, "type", dtype=np.int32)
    rc = lib.obmdio_write_xyz(path.encode(), int(append), int(state.step),
                              len(x), typ.ctypes.data, x.ctypes.data)
    return rc == 0
