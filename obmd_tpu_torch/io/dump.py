"""Trajectory dump writers: `dump ID group xyz N file` and `dump ID group
custom N file cols...` (dump.cpp, dump_custom.cpp).

The port's own copy of the JAX package's writers.  An xyz frame, and a
custom frame of exactly the columns id type x y z vx vy vz fx fy fz, go
through the native writers of io/native.py where its library loads (the
JAX package's condition); every other frame, or any frame where the
library is unavailable, is written in Python.  Each column is copied to
the host as numpy of the state's own dtype (float32 positions, int32
tags) before it is formatted, so a Python frame is the same bytes as the
JAX package's Python writers give for the same state, and a native frame
the same bytes as its native writers (which print the 11-column frame's
floats as %.6f, its box as %.9g: not the Python frame's bytes).
"""
from __future__ import annotations

import numpy as np

from ..config import SceneConfig
from ..state import State
from . import native

# the custom frame's columns that the native writer writes
NATIVE_CUSTOM_COLS = ("id", "type", "x", "y", "z", "vx", "vy", "vz", "fx",
                      "fy", "fz")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def write_xyz_frame(path: str, cfg: SceneConfig, state: State,
                    append: bool = True):
    """`dump xyz` frame, natively where the library loads."""
    if not native.write_xyz_native(path, state, append):
        _write_xyz_frame_py(path, cfg, state, append)


def _write_xyz_frame_py(path: str, cfg: SceneConfig, state: State,
                        append: bool = True):
    alive = _host(state.alive)
    x = _host(state.x)[alive]
    t = _host(state.type)[alive]
    mode = "a" if append else "w"
    with open(path, mode) as fh:
        fh.write(f"{len(x)}\n")
        fh.write(f"step {int(state.step)}\n")
        for k in range(len(x)):
            fh.write(f"{t[k] + 1} {x[k, 0]:.6f} {x[k, 1]:.6f} {x[k, 2]:.6f}\n")


def write_custom_frame(path: str, cfg: SceneConfig, state: State,
                       cols=("id", "type", "x", "y", "z", "vx", "vy", "vz"),
                       append: bool = True, extra=None):
    """`dump custom` frame: ITEM: headers and per-atom columns, natively
    for NATIVE_CUSTOM_COLS.  `extra`: {name: per-ALIVE-atom numpy array}
    for the v_<name> columns of atom-style variables."""
    if tuple(cols) == NATIVE_CUSTOM_COLS and native.write_dump_custom_native(
            path, cfg, state, append):
        return
    _write_custom_frame_py(path, cfg, state, cols, append, extra)


def _write_custom_frame_py(path: str, cfg: SceneConfig, state: State,
                           cols=("id", "type", "x", "y", "z", "vx", "vy",
                                 "vz"),
                           append: bool = True, extra=None):
    alive = _host(state.alive)
    x = _host(state.x)[alive]
    v = _host(state.v)[alive]
    f = _host(state.f)[alive]
    cms = _host(state.cms_mol)[alive]
    vcms = _host(state.vcms_mol)[alive]
    data = {"id": _host(state.tag)[alive], "type": _host(state.type)[alive] + 1,
            "x": x[:, 0], "y": x[:, 1], "z": x[:, 2],
            "vx": v[:, 0], "vy": v[:, 1], "vz": v[:, 2],
            "fx": f[:, 0], "fy": f[:, 1], "fz": f[:, 2],
            "q": _host(state.q)[alive],
            # AdResS columns (atom_vec_adress.cpp per-atom fields)
            "mol": _host(state.mol)[alive],
            "lambdaF": _host(state.lambdaF)[alive],
            "rep_atom": _host(state.rep_atom)[alive],
            "cms_x": cms[:, 0], "cms_y": cms[:, 1], "cms_z": cms[:, 2],
            "vcms_x": vcms[:, 0], "vcms_y": vcms[:, 1],
            "vcms_z": vcms[:, 2]}
    if extra:
        data.update(extra)
    lo, hi = cfg.box.lo, cfg.box.hi
    mode = "a" if append else "w"
    with open(path, mode) as fh:
        fh.write("ITEM: TIMESTEP\n%d\n" % int(state.step))
        fh.write("ITEM: NUMBER OF ATOMS\n%d\n" % len(x))
        bflags = " ".join("pp" if p else "ff" for p in cfg.box.periodic)
        fh.write(f"ITEM: BOX BOUNDS {bflags}\n")
        for d in range(3):
            fh.write(f"{lo[d]} {hi[d]}\n")
        fh.write("ITEM: ATOMS " + " ".join(cols) + "\n")
        for k in range(len(x)):
            fh.write(" ".join(str(data[c][k]) for c in cols) + "\n")
