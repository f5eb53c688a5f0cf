"""DPD pair forces over the padded cell-major layout.

Counterpart of `obmd_tpu/forces/pallas_dpd.py`: `PadGeometry` (the slot =
(block, rank, lane) layout, a lane being a cell) and `make_pair_kernel`.
The TPU file has two bodies of one function — the big-tile body
(`kernel_bigtile`, fill cap <= 20) and the rank-looped body (`kernel`) —
which the Hopper kernel `csrc/pair_kernel.cu` replaces with one kernel that
takes any capacity.  Beside it, `pair_forces_plain` is the same function in
PyTorch: the CPU tests run it, and `chip_smoke.py` holds the kernel against
it on the card.

The function: for every live slot i, F_i = sum_j F_ij over the atoms j filed
in the 27 cells around i's FILED cell (never `cell_of(x)`: atoms drift up to
half a skin inside an epoch, which the cut + skin cell width absorbs), with

    F_ij = [a0*wd - gamma*wd^2*(rhat . dv) + sigma*wd*xi/sqrt(dt)] * rhat,
    wd = 1 - r/rc,   xi = sqrt(3)*(2u - 1),
    u = top 24 bits of fmix32((lo*0x9E3779B9) ^ (hi*0x85EBCA77) ^ salt) / 2^24

(lo, hi = smaller and larger tag of the pair), counted only for
1e-10 < r < rc, with the minimum image on the periodic y/z axes.  Dead slots
carry x = BIG and drop out of the cutoff test.

Scope of this slice: single-type DPD, uniform noise, open x, periodic y/z
with >= 3 cells each, and a layout whose x-slabs tile the 128 lanes
(p >= 2).  Every other configuration of the TPU kernel (lj, lj/rf, 2-4
types, bonded exclusion, the dpd/tstat ramp, gaussian noise, periodic x,
p == 1 layouts) raises `NotImplementedError`.
"""
from __future__ import annotations

import functools
import itertools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import _build
from ..config import DPDParams
from ..geometry import const_like
from ..rng import pair_bits, uniform01

EPS = 1.0e-10
SQRT3 = float(np.sqrt(3.0))
NF = 6   # x, y, z, vx, vy, vz


class PadGeometry(NamedTuple):
    """Static geometry of the padded cell-major layout (pallas_dpd.py:36).

    cap is the STORAGE rank count; fill_cap <= cap is the FILING capacity.
    Capacity 15 stores 16 ranks and files 15; rows fill_cap..cap-1 are
    never filed."""

    dims: Tuple[int, int, int]
    cell_size: Tuple[float, float, float]
    lo: Tuple[float, float, float]
    s: int                           # ny*nz (cells per x-slab)
    p: int                           # x-slabs per block
    lanes: int
    n_blocks: int
    cap: int
    periodic_x: bool = False
    periodic_yz: Tuple[bool, bool] = (True, True)
    fill_cap: int = 0                # 0 -> == cap

    @property
    def fcap(self) -> int:
        return self.fill_cap or self.cap

    @property
    def n_slots(self) -> int:
        return self.n_blocks * self.cap * self.lanes

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz

    @staticmethod
    def create(box, cutoff: float, cap: int) -> "PadGeometry":
        periodic_x = bool(box.periodic[0])
        dims = []
        csize = []
        for L, per in zip(box.lengths, box.periodic):
            n = max(1, int(np.floor(L / cutoff)))
            if per and n < 3:
                n = 1
            dims.append(n)
            csize.append(L / n)
        nx, ny, nz = dims
        if ny == 2 or nz == 2:
            raise ValueError("periodic axis with exactly 2 cells unsupported")
        if periodic_x and nx < 3:
            raise ValueError("periodic x needs >= 3 cells on the cellpad path")
        s = ny * nz
        if s <= 128 and 128 % s == 0:
            p = 128 // s
            lanes = 128
        else:
            p = 1
            lanes = ((s + 127) // 128) * 128
        if periodic_x:
            while p > 1 and nx % p != 0:
                p //= 2
            lanes = p * s if p * s == 128 else ((s + 127) // 128) * 128
            if p == 1:
                lanes = ((s + 127) // 128) * 128
        n_blocks = (nx + p - 1) // p
        fill = cap
        store = cap
        if cap <= 20 and (cap * cap) % 8 != 0:
            while (fill * store) % 8 != 0:
                store += 1
        return PadGeometry(dims=tuple(dims), cell_size=tuple(csize),
                           lo=box.lo, s=s, p=p, lanes=lanes,
                           n_blocks=n_blocks, cap=store,
                           periodic_x=periodic_x,
                           periodic_yz=(bool(box.periodic[1]),
                                        bool(box.periodic[2])),
                           fill_cap=fill)

    def cell_of(self, x: torch.Tensor) -> torch.Tensor:
        """Linear cell id (int32) of [..., 3] positions, clipped to the grid."""
        lo = const_like(self.lo, x)
        cs = const_like(self.cell_size, x)
        top = const_like([d - 1 for d in self.dims], x, torch.int32)
        c = torch.floor((x - lo) / cs).to(torch.int32)
        c = torch.minimum(torch.clamp(c, min=0), top)
        nx, ny, nz = self.dims
        return (c[..., 0] * ny + c[..., 1]) * nz + c[..., 2]

    def slot_of_cell(self, cell):
        """(block, lane) of a linear cell id."""
        slab = cell // self.s
        within = cell % self.s
        if self.p == 1:
            return slab, within
        block = slab // self.p
        lane = (slab % self.p) * self.s + within
        return block, lane


def check_supported(geom: PadGeometry, params) -> None:
    """Raise for every configuration of the TPU kernel this port does not
    cover yet (ROADMAP.md lists them)."""
    if not isinstance(params, DPDParams):
        raise NotImplementedError(
            f"pair kernel: only the DPD law is ported, not {type(params).__name__}")
    if params.ntypes != 1:
        raise NotImplementedError("pair kernel: only single-type DPD is ported")
    if params.gaussian_noise:
        raise NotImplementedError("pair kernel: gaussian pair noise is not ported")
    if geom.periodic_x:
        raise NotImplementedError("pair kernel: periodic x is not ported")
    if geom.periodic_yz != (True, True) or min(geom.dims[1:]) < 3:
        raise NotImplementedError(
            "pair kernel: y and z must be periodic with >= 3 cells each")
    if geom.p < 2 or geom.p * geom.s != geom.lanes:
        raise NotImplementedError(
            "pair kernel: p == 1 (lane-padded) layouts are not ported")


class DPDCoef(NamedTuple):
    """Scalar law constants, each rounded to float32 where it is used."""

    a0: float
    gamma: float
    sigma: float
    cut: float
    inv_cut: float
    dtinvsqrt: float
    ly: float
    lz: float
    inv_ly: float
    inv_lz: float

    @staticmethod
    def create(geom: PadGeometry, params: DPDParams, dt: float) -> "DPDCoef":
        ly = float(geom.dims[1] * geom.cell_size[1])
        lz = float(geom.dims[2] * geom.cell_size[2])
        cut = float(params.cut[0][0])
        return DPDCoef(a0=float(params.a0[0][0]),
                       gamma=float(params.gamma[0][0]),
                       sigma=float(params.sigma[0][0]), cut=cut,
                       inv_cut=1.0 / cut,
                       dtinvsqrt=float(1.0 / np.sqrt(dt)),
                       ly=ly, lz=lz, inv_ly=1.0 / ly, inv_lz=1.0 / lz)


@functools.lru_cache(maxsize=16)
def _neighbor_columns(geom: PadGeometry, device: torch.device):
    """For each of the 27 cell offsets: the flat (block, lane) column of the
    neighbour cell of every (block, lane), and whether it exists (open x;
    y/z wrap).  Columns index the [nb * lanes] cell axis."""
    nx, ny, nz = geom.dims
    s, p, lanes, nb = geom.s, geom.p, geom.lanes, geom.n_blocks
    lane = np.arange(lanes)
    slab = np.arange(nb)[:, None] * p + (lane // s)[None, :]
    real = (lane < p * s)[None, :] & (slab < nx)
    within = lane % s
    cy = (within // nz)[None, :]
    cz = (within % nz)[None, :]
    cols, oks = [], []
    for ox, oy, oz in itertools.product((-1, 0, 1), repeat=3):
        jx = slab + ox
        ok = real & (jx >= 0) & (jx < nx)
        jy = (cy + oy) % ny
        jz = (cz + oz) % nz
        col = (jx // p) * lanes + (jx % p) * s + jy * nz + jz
        cols.append(np.where(ok, col, 0).reshape(-1))
        oks.append(ok.reshape(-1))
    cols = torch.from_numpy(np.stack(cols)).to(device)
    oks = torch.from_numpy(np.stack(oks)).to(device)
    return cols, oks


def pair_forces_plain(geom: PadGeometry, coef: DPDCoef, fld: torch.Tensor,
                      tag: torch.Tensor, salt: int) -> torch.Tensor:
    """The kernel's function in PyTorch: fld f32[nb, 6, cap, lanes], tag
    i32[nb, cap, lanes] -> f32[nb, 3, cap, lanes].  Newton-off: each slot
    sums over the 27 cells around its column, all ranks of each."""
    nb, nf, cap, lanes = fld.shape
    c = nb * lanes
    fl = fld.permute(0, 3, 1, 2).reshape(c, nf, cap)
    tl = tag.permute(0, 2, 1).reshape(c, cap)
    cols, oks = _neighbor_columns(geom, fld.device)
    xi = fl[:, :, :, None]                           # [C, NF, cap_i, 1]
    ti = tl[:, :, None]                              # [C, cap_i, 1]
    not_self = ~torch.eye(cap, dtype=torch.bool, device=fld.device)
    f = torch.zeros((c, 3, cap), dtype=torch.float32, device=fld.device)
    for o in range(cols.shape[0]):
        xj = fl[cols[o]][:, :, None, :]              # [C, NF, 1, cap_j]
        tj = tl[cols[o]][:, None, :]                 # [C, 1, cap_j]
        dx = xi[:, 0] - xj[:, 0]
        dy = xi[:, 1] - xj[:, 1]
        dz = xi[:, 2] - xj[:, 2]
        dy = dy - coef.ly * torch.round(dy * coef.inv_ly)
        dz = dz - coef.lz * torch.round(dz * coef.inv_lz)
        rsq = dx * dx + dy * dy + dz * dz
        ok = oks[o][:, None, None] & (rsq < coef.cut * coef.cut) \
            & (rsq > EPS * EPS)
        if o == 13:                                  # the (0, 0, 0) offset
            ok = ok & not_self
        rinv = torch.rsqrt(torch.clamp(rsq, min=EPS * EPS))
        wd = 1.0 - (rsq * rinv) * coef.inv_cut
        dot = (dx * (xi[:, 3] - xj[:, 3]) + dy * (xi[:, 4] - xj[:, 4])
               + dz * (xi[:, 5] - xj[:, 5]))
        u01 = uniform01(pair_bits(salt, ti, tj))
        noise = SQRT3 * (2.0 * u01 - 1.0)
        fpair = coef.a0 * wd
        fpair = fpair - coef.gamma * wd * wd * dot * rinv
        fpair = fpair + coef.sigma * wd * noise * coef.dtinvsqrt
        fpair = torch.where(ok, fpair * rinv, 0.0)
        f[:, 0] += (fpair * dx).sum(-1)
        f[:, 1] += (fpair * dy).sum(-1)
        f[:, 2] += (fpair * dz).sum(-1)
    return f.reshape(nb, lanes, 3, cap).permute(0, 2, 3, 1).contiguous()


def _launch(geom: PadGeometry, coef: DPDCoef, fld, tag, salt: int, occ):
    kern = _build.KERNELS["dpd_pair"]
    fn = kern.function()
    nb, _, cap, lanes = fld.shape
    nx, ny, nz = geom.dims
    out = torch.empty((nb, 3, cap, lanes), dtype=torch.float32,
                      device=fld.device)
    with torch.cuda.device(fld.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(fld.data_ptr(), tag.data_ptr(), occ.data_ptr(),
                out.data_ptr(), nb, cap, lanes, nx, ny, nz, geom.s, geom.p,
                coef.ly, coef.lz, coef.inv_ly, coef.inv_lz, coef.a0,
                coef.gamma, coef.sigma, coef.cut, coef.inv_cut,
                coef.dtinvsqrt, salt & 0xFFFFFFFF, stream)
    _build.check(rc, kern)
    kern.count(f"cap{geom.fcap}")
    return out


def make_pair_kernel(geom: PadGeometry, params: DPDParams, dt: float):
    """Build pair_forces(fld, tag, salt, occ) -> f32[nb, 3, cap, lanes]:
    fld f32[nb, 6, cap, lanes] (x, y, z, vx, vy, vz; dead slots at x = BIG),
    tag i32[nb, cap, lanes], salt a uint32 python int, occ i32[nb] (per
    block highest occupied rank + 1; stale-high is safe, stale-low is not).

    A CUDA tensor goes to the Hopper kernel; a CPU tensor to the plain
    version.  There is no fallback between them."""
    check_supported(geom, params)
    coef = DPDCoef.create(geom, params, dt)
    shape = (geom.n_blocks, NF, geom.cap, geom.lanes)

    def pair_forces(fld: torch.Tensor, tag: torch.Tensor, salt: int,
                    occ: torch.Tensor) -> torch.Tensor:
        if tuple(fld.shape) != shape or fld.dtype != torch.float32:
            raise ValueError(f"fld must be float32{list(shape)}, got "
                             f"{fld.dtype}{list(fld.shape)}")
        if tuple(tag.shape) != (shape[0],) + shape[2:] \
                or tag.dtype != torch.int32:
            raise ValueError("tag must be int32[nb, cap, lanes]")
        if tuple(occ.shape) != (shape[0],) or occ.dtype != torch.int32:
            raise ValueError("occ must be int32[nb]")
        if not (fld.device == tag.device == occ.device):
            raise ValueError("fld, tag and occ must share one device")
        if fld.device.type == "cpu":
            return pair_forces_plain(geom, coef, fld, tag, salt)
        if fld.device.type != "cuda":
            raise ValueError(f"unsupported device {fld.device}")
        return _launch(geom, coef, fld.contiguous(), tag.contiguous(), salt,
                       occ.contiguous())

    return pair_forces
