"""Binary DCD trajectory writer: `dump ID group dcd N file.dcd`.

The port's own copy of the JAX package's writer, byte for byte.  CHARMM
DCD as the reference's EXTRA-DUMP writer emits it (dump_dcd.cpp):
Fortran-unformatted records (int32 byte-count framing), a "CORD" header
whose frame and step counters are patched in place as frames append
(dump_dcd.cpp:272-292), one 6-double unit-cell record a frame (XTLABC
lower-triangle order: a, cos(gamma), b, cos(beta), cos(alpha), c —
:206-226), then the X, Y and Z float32 records.

As in the reference (dump_dcd.cpp:93, :140) frames are written in
ascending tag order and a changed atom count raises: open-boundary decks
with insertion or deletion use `dump custom` instead.
"""
from __future__ import annotations

import os
import struct

import numpy as np

_HDR_BYTES = 4 + 84 + 4          # record 1: "CORD" + 20 int32 icntrl


def _rec(f, payload: bytes):
    f.write(struct.pack("<i", len(payload)))
    f.write(payload)
    f.write(struct.pack("<i", len(payload)))


def _write_header(f, n: int, step: int, nevery: int, dt: float):
    icntrl = [0] * 20
    icntrl[0] = 0                 # nframes (patched per frame)
    icntrl[1] = step              # first timestep
    icntrl[2] = nevery            # save interval
    icntrl[3] = 0                 # last timestep (patched per frame)
    icntrl[9] = struct.unpack("<i", struct.pack("<f", dt))[0]
    icntrl[10] = 1                # unit-cell record present
    icntrl[19] = 24               # CHARMM version convention
    _rec(f, b"CORD" + struct.pack("<20i", *icntrl))
    title = b"Created by obmd_tpu".ljust(80)[:80]
    _rec(f, struct.pack("<i", 1) + title)
    _rec(f, struct.pack("<i", n))


def write_dcd_frame(fname: str, cfg, state, nevery: int = 1,
                    append: bool = True):
    """Append one frame (creating the file + header on first call)."""
    alive = state.alive.cpu().numpy()
    tags = state.tag.cpu().numpy()[alive]
    x = state.x.cpu().numpy()[alive][np.argsort(tags)].astype(np.float32)
    n = x.shape[0]
    step = int(state.step)

    fresh = not (append and os.path.exists(fname)
                 and os.path.getsize(fname) > 0)
    mode = "r+b" if not fresh else "wb"
    with open(fname, mode) as f:
        if fresh:
            _write_header(f, n, step, nevery, float(cfg.dt))
            nframes = 0
        else:
            f.seek(8)
            hdr = struct.unpack("<20i", f.read(80))
            nframes = hdr[0]
            f.seek(_HDR_BYTES)
            tlen = struct.unpack("<i", f.read(4))[0]
            f.seek(_HDR_BYTES + 8 + tlen)
            n_hdr = struct.unpack("<ii", f.read(8))[1]
            if n_hdr != n:
                raise ValueError(
                    f"dump dcd: atom count changed ({n_hdr} -> {n}); "
                    "DCD requires a constant count (dump_dcd.cpp:140) — "
                    "use dump custom for open-boundary decks")
        # unit cell, XTLABC lower-triangle order (orthogonal box)
        lx, ly, lz = (float(h - l) for l, h in zip(cfg.box.lo, cfg.box.hi))
        f.seek(0, os.SEEK_END)
        _rec(f, struct.pack("<6d", lx, 0.0, ly, 0.0, 0.0, lz))
        for c in range(3):
            _rec(f, x[:, c].tobytes())
        # patch nframes / last step in the header (dump_dcd.cpp:272-292)
        f.seek(8)
        f.write(struct.pack("<i", nframes + 1))
        f.seek(8 + 12)
        f.write(struct.pack("<i", step))


def read_dcd(fname: str):
    """Minimal reader for round-trip tests: returns (steps, cells [F,3],
    frames [F, n, 3])."""
    with open(fname, "rb") as f:
        raw = f.read()
    off = 0

    def rec():
        nonlocal off
        (ln,) = struct.unpack_from("<i", raw, off)
        payload = raw[off + 4: off + 4 + ln]
        off += 8 + ln
        return payload
    hdr = rec()
    assert hdr[:4] == b"CORD"
    icntrl = struct.unpack("<20i", hdr[4:84])
    nframes = icntrl[0]
    rec()                                     # title
    (n,) = struct.unpack("<i", rec())
    cells, frames = [], []
    for _ in range(nframes):
        c = struct.unpack("<6d", rec())
        cells.append((c[0], c[2], c[5]))
        xyz = [np.frombuffer(rec(), np.float32) for _ in range(3)]
        frames.append(np.stack(xyz, axis=1))
    return icntrl, np.asarray(cells), np.asarray(frames)
