"""The session behind the port's C library API (csrc/obmdc_torch.cpp, the
reference's library.cpp analogue): the C and Fortran symbols obmd_command,
obmd_file, obmd_get_natoms, obmd_get_thermo, obmd_gather, obmd_gather_int
and obmd_scatter call the methods of one `Session`, which drives the deck
front end (io/script.Interpreter) as native/obmdc.cpp's bootstrap drives
the JAX package's.

The device comes from the environment variable OBMD_PLATFORM, the one the
JAX package's C API reads: unset (or empty), `cuda` or `gpu` run on the
card, `cpu` on the plain PyTorch versions.  Unset on a machine without a
GPU, `open_session` raises, and obmd_open leaves that message for
obmd_last_error: the C API never runs on the CPU unasked.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .io.script import Interpreter

PLATFORM_ENV = "OBMD_PLATFORM"
_DEVICES = {"": "cuda", "cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def platform_device(value: Optional[str]) -> str:
    """The torch device type an OBMD_PLATFORM value asks for."""
    key = (value or "").strip().lower()
    if key not in _DEVICES:
        raise ValueError(f"{PLATFORM_ENV}={value!r}: expected cpu, cuda or "
                         "gpu (unset runs on the GPU)")
    return _DEVICES[key]


def open_session() -> "Session":
    """obmd_open: a Session on OBMD_PLATFORM's device."""
    value = os.environ.get(PLATFORM_ENV)
    device = platform_device(value)
    if device == "cuda" and not torch.cuda.is_available():
        how = "is unset" if not value else f"is {value!r}"
        raise RuntimeError(
            f"no GPU: {PLATFORM_ENV} {how}, so the engine runs on the GPU, "
            "but torch.cuda.is_available() is False; set "
            f"{PLATFORM_ENV}=cpu to run the plain PyTorch versions")
    return Session(device)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class Session:
    """One Interpreter (its thermo lines dropped) and the per-atom views
    of its state in ascending-tag order."""

    def __init__(self, device: str):
        self.it = Interpreter(device=device, log_fn=lambda *a: None)

    def command(self, line: str) -> None:
        self.it.one(line)

    def file(self, path: str) -> None:
        self.it.run_file(path)

    def natoms(self) -> int:
        if self.it.state is None:
            return 0
        return int(self.it.state.natoms)

    def thermo(self, what: str) -> float:
        """step, temp, natoms, pe, ke or press of the current state."""
        if self.it.cfg is None:
            raise RuntimeError("no system built yet (run a deck first)")
        from .observe import make_thermo_fn
        th = make_thermo_fn(self.it.cfg)(self.it.state)
        return float({"step": th.step, "temp": th.temp, "natoms": th.natoms,
                      "pe": th.pe, "ke": th.ke, "press": th.pressure}[what])

    def _tag_order(self):
        """(alive mask, the alive rows' tags, their ascending-tag order)."""
        st = self.it.state
        alive = _host(st.alive)
        tags = _host(st.tag)[alive]
        return alive, tags, np.argsort(tags)

    def gather(self, name: str) -> bytes:
        """A [natoms, 3] field (x, v or f) as float64 bytes in tag order:
        lammps_gather_atoms."""
        alive, _, order = self._tag_order()
        arr = {"x": self.it.state.x, "v": self.it.state.v,
               "f": self.it.state.f}[name]
        out = _host(arr)[alive][order]
        return np.ascontiguousarray(out, dtype=np.float64).tobytes()

    def gather_int(self, name: str) -> bytes:
        """id, type (1-based, as the reference's per-atom type array) or
        mol as int64 bytes in tag order."""
        alive, tags, order = self._tag_order()
        st = self.it.state
        if name == "id":
            out = tags[order]
        elif name == "type":
            out = _host(st.type)[alive][order] + 1
        elif name == "mol":
            out = _host(st.mol)[alive][order]
        else:
            raise KeyError(name)
        return np.ascontiguousarray(out, dtype=np.int64).tobytes()

    def scatter(self, name: str, buf: bytes) -> None:
        """Write a tag-ordered [natoms, 3] float64 field (x, v or f) back
        into the alive rows: lammps_scatter_atoms.  New positions rebuild
        the layout (integrate.rebuild_neighbors, as read_restart does)."""
        if name not in ("x", "v", "f"):
            raise KeyError(name)
        st = self.it.state
        alive, _, order = self._tag_order()
        rows = np.nonzero(alive)[0][order]
        vals = np.frombuffer(buf, dtype=np.float64).reshape(-1, 3)
        if vals.shape[0] != rows.shape[0]:
            raise ValueError(f"scatter {name}: got {vals.shape[0]} rows, "
                             f"system has {rows.shape[0]} atoms")
        full = _host(getattr(st, name)).copy()
        full[rows] = vals.astype(full.dtype)
        self.it.state = st.replace(**{name: torch.from_numpy(full).to(
            st.device)})
        if name == "x":
            from .integrate import rebuild_neighbors
            self.it.state = rebuild_neighbors(self.it.cfg, self.it.state)
