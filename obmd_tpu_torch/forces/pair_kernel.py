"""Pair forces over the padded cell-major layout.

Counterpart of `obmd_tpu/forces/pallas_dpd.py`: `PadGeometry` (the slot =
(block, rank, lane) layout, a lane being a cell), `make_pair_kernel` and
`make_dpd_kernel`.  The TPU file has three kernels of one function: the
big-tile body of make_pair_kernel (`kernel_bigtile`, fill cap <= 20), its
rank-looped body (`kernel`, fill cap > 20), both Newton half stencils, and
the legacy full-stencil make_dpd_kernel.  The Hopper kernel source
`csrc/pair_kernel.cu` replaces them with one Newton-off kernel that takes any
capacity, behind two C entry points: `obmd_pair` (make_pair_kernel) and
`obmd_dpd_full` (make_dpd_kernel, with that kernel's own r and cutoff
arithmetic).  `TilePlan.of(geom, kind)` picks one of two bodies from the
fill cap and the launch: the tiled body (a CUDA block a tile of cells,
each live atom of the tile's stencil staged once in shared memory, one
thread a live atom of the tile) or, where a cell's fill cap exceeds a
block's threads and the dense body is built for the launch, the dense
body (cell-major records compacted first, `dense_records_plain`, then a
block a cell streaming its stencil's records through shared memory).
Beside them, `pair_forces_plain` is the same function in PyTorch: the CPU
tests run it, and `chip_smoke.py` holds each kernel against it on the
card.

The function: for every live slot i, F_i = sum_j fpair_ij * d_ij over the
live atoms j filed in the cells around i's FILED cell (the 27 of the
stencil on a grid of >= 3 cells per axis; never `cell_of(x)`: atoms drift
up to half a skin inside an epoch, which the cut + skin cell width
absorbs), d_ij = x_i - x_j with the minimum image on every periodic axis, counted only for 1e-10 < r < rc, with the law

    dpd:  fpair = [a0*wd - gamma*wd^2*(rhat . dv) + sigma*wd*xi/sqrt(dt)] / r,
          wd = 1 - r/rc,   xi = sqrt(3)*(2u - 1),
          u = top 24 bits of h / 2^24,
          h = fmix32((lo*0x9E3779B9) ^ (hi*0x85EBCA77) ^ salt)
              (lo, hi = smaller and larger tag of the pair);
          with gaussian noise xi = sqrt(-2 ln max(u, 1e-12)) cos(2 pi u2),
          u2 from fmix32(h ^ 0x7F4A7C15) (pallas_dpd.py:431-443: another
          stream and clamp than rng.pair_noise's, ROADMAP Queue 3);
    dpd/tstat: the dpd law with a0 = 0; under a temperature ramp the noise
          term is multiplied by the runtime scalar sig_scale =
          sqrt(T(step)/t_start) (pallas_dpd.py:449-451);
    lj:   fpair = r6inv*(lj1*r6inv - lj2)*r2inv,  r2inv = 1/r^2,
          lj1 = 48 eps sig^12,  lj2 = 24 eps sig^6;
    ljrf: the lj force for r < rc, plus for r < rc_coul (its own cutoff) the
          reaction field qq*qi*qj*(r^-3 - c_rf/rc_coul^3),
          c_rf = 2(eps_rf - 1)/(2 eps_rf + 1)   (pallas_dpd.py:398-409).

With 2-4 types every coefficient (the cutoff, 1/cut, a0, gamma, sigma,
lj1, lj2, c_rf) is a per-type-pair table, rounded to float32 as the TPU
kernel rounds it (`pair_tables`), and the field layout gains channels:
fld is f32[nb, NF, cap, lanes] with x, y, z, vx, vy, vz, then the charge q
for the ljrf law, then the type as a float with 2-4 types (NF = 6, 7 or 8,
pallas_dpd.py:273-276).

Dead slots carry x = y = z = BIG and are skipped by an explicit test, not
by distance alone: on a periodic x axis the minimum image folds BIG back
into the box; a dead slot's q and type are never read.  With bonded
exclusion (1-2 pairs out of the pair style) a pair is also dropped when
j's tag is one of i's partner tags, pbond i32[nb, n_excl, cap, lanes] (-2
for no partner; n_excl = 2 for chains, 4 for branched topologies,
pallas_dpd.py:380-381 and :625-643); the partner lists are symmetric, so
the Newton-off sum drops each 1-2 pair from both ends.

Scope: 1-4 types, the dpd, dpd/tstat, lj and ljrf laws (ljrf, 2-4 types,
dpd/tstat and gaussian noise through make_pair_kernel only, as
make_dpd_kernel has none of them), uniform or gaussian noise, the
dpd/tstat ramp, open or periodic x (>= 3 cells), y and z each periodic
with >= 3 cells, periodic with one cell (the stencil takes the offset 0 on
that axis and the minimum image; the axis must be at least twice the
cutoff long, else ValueError) or open (no image; make_pair_kernel only, as
make_dpd_kernel has no open y/z), any layout (x-slabs tiling the lanes,
p >= 2, or one slab per block in lanes padded to a multiple of 128, p ==
1), any capacity, bonded exclusion with 2 channels, and with 4 channels
(branched topologies) every law, type count, noise variant and y/z
geometry of make_pair_kernel (make_dpd_kernel has two; `check_channels`).
More than 4 types and other channel counts raise `NotImplementedError`.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import _build
from ..cells import BIG
from ..config import DPDParams, DPDTstatParams, LJCutParams, LJCutRFParams
from ..geometry import cell_index
from ..rng import box_muller, pair_bits, uniform01

EPS = 1.0e-10
SQRT3 = float(np.sqrt(3.0))
NF = 6   # x, y, z, vx, vy, vz: the channels of a neutral one-type layout
N_EXCL = 2  # partner-tag channels of the bonded exclusion on chains
N_EXCL_BRANCHED = 4   # ... and on branched topologies (<= 4 bonds/atom)
MAX_TYPES = 4
LAWS = ("dpd", "lj", "ljrf")       # the C entry points' law index
# the rows of the per-type-pair tables, in the C kernel's TabRow order
TABLE_ROWS = ("cut2", "inv_cut", "a0", "gamma", "sigma", "lj1", "lj2", "c_rf")


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
        """Linear cell id (int32) of [..., 3] positions, clipped to the
        grid (geometry.cell_index)."""
        return cell_index(x, self.lo, self.cell_size, self.dims)

    def slot_of_cell(self, cell):
        """(block, lane) of a linear cell id."""
        slab = cell // self.s
        within = cell % self.s
        if self.p == 1:
            return slab, within
        block = slab // self.p
        lane = (slab % self.p) * self.s + within
        return block, lane


def check_geometry(geom: PadGeometry, cutoff: float,
                   legacy: bool = False) -> None:
    """Raise for the layouts the kernels do not cover: open y or z in the
    full-stencil kernel (make_dpd_kernel always takes the minimum image
    on y and z, pallas_dpd.py:1015-1016), and a single-cell periodic y or
    z axis shorter than twice the largest cutoff, where the minimum image
    would miss a pair's second image within the cutoff (ValueError)."""
    if legacy and geom.periodic_yz != (True, True):
        raise NotImplementedError(
            "full-stencil kernel: y and z must be periodic, as in "
            "make_dpd_kernel")
    for axis in (1, 2):
        if geom.periodic_yz[axis - 1] and geom.dims[axis] == 1 \
                and geom.cell_size[axis] < 2.0 * cutoff:
            raise ValueError(
                f"pair kernel: the single-cell periodic axis {'xyz'[axis]} "
                f"is {geom.cell_size[axis]} long, less than twice the "
                f"cutoff {cutoff}: the minimum image would miss pairs")


def check_supported(geom: PadGeometry, params) -> None:
    """Raise for every configuration of the TPU kernel this port does not
    cover yet (ROADMAP.md lists them)."""
    if not isinstance(params, (DPDParams, DPDTstatParams, LJCutParams,
                               LJCutRFParams)):
        raise NotImplementedError(
            f"pair kernel: the {type(params).__name__} law is not ported")
    if not 1 <= params.ntypes <= MAX_TYPES:
        raise NotImplementedError(
            f"pair kernel: {params.ntypes} types (1-{MAX_TYPES} are ported)")
    check_geometry(geom, params.max_cut)


def _f32(v) -> float:
    return float(np.float32(v))


def pair_tables(params) -> tuple:
    """The float32 values the kernels read for a config law, as
    make_pair_kernel rounds them (pallas_dpd.py:278-314): the largest
    squared cutoff, qq, rc_coul^2 and 1/rc_coul^3, then the TABLE_ROWS rows
    of ntypes^2 values each, indexed by ti * ntypes + tj.  With one type a
    coefficient is a host float that the TPU kernel folds in as a float32
    constant (cut^2 rounded from float64); with 2-4 types each is a float32
    table entry (cut^2 and 1/cut computed in float32)."""
    multi = params.ntypes > 1
    cut = np.asarray(params.cut, np.float64)
    if multi:
        c32 = cut.astype(np.float32)
        cut2 = c32 * c32
        inv_cut = np.float32(1.0) / c32
    else:
        cut2 = (cut * cut).astype(np.float32)
        inv_cut = (1.0 / cut).astype(np.float32)
    zero = np.zeros_like(cut)
    a0 = gamma = sigma = lj1 = lj2 = c_rf = zero
    qq = cut_coul2 = inv_rc3 = 0.0
    if isinstance(params, (DPDParams, DPDTstatParams)):
        # dpd/tstat: the dpd law with a0 = 0 (pallas_dpd.py:243-248)
        if isinstance(params, DPDParams):
            a0 = np.asarray(params.a0, np.float64)
        gamma = np.asarray(params.gamma, np.float64)
        sigma = np.asarray(params.sigma, np.float64)
    else:
        eps = np.asarray(params.epsilon, np.float64)
        s6 = np.asarray(params.sigma, np.float64) ** 6
        lj1, lj2 = 48.0 * eps * s6 * s6, 24.0 * eps * s6
    if isinstance(params, LJCutRFParams):
        erf = np.asarray(params.eps_rf, np.float64)
        c_rf = 2.0 * (erf - 1.0) / (2.0 * erf + 1.0)
        rc = float(params.cut_coul)
        qq, cut_coul2, inv_rc3 = (_f32(params.qqrd2e), _f32(rc * rc),
                                  _f32(1.0 / rc ** 3))
    rows = (cut2, inv_cut, a0, gamma, sigma, lj1, lj2, c_rf)
    cut2_max = _f32(max(float(np.max(cut2)), cut_coul2))
    return (cut2_max, qq, cut_coul2, inv_rc3) + tuple(
        _f32(v) for r in rows for v in np.asarray(r, np.float32).reshape(-1))


class PairCoef(NamedTuple):
    """The law and its scalar constants, each rounded to float32 where it
    is used, the box lengths of the minimum image, with 2-4 types or the
    ljrf law the per-type-pair tables (`pair_tables`), and the DPD law's
    noise variants: gaussian draws, and a dpd/tstat ramp's runtime noise
    scale."""

    law: str
    a0: float
    gamma: float
    sigma: float
    cut: float
    inv_cut: float
    dtinvsqrt: float
    lj1: float
    lj2: float
    periodic_x: bool
    lx: float
    ly: float
    lz: float
    inv_lx: float
    inv_ly: float
    inv_lz: float
    ntypes: int = 1
    tables: Tuple[float, ...] = ()
    gaussian: bool = False
    ramp: bool = False

    @property
    def typed(self) -> bool:
        """The kernel reads its coefficients from the tables."""
        return self.ntypes > 1 or self.law == "ljrf"

    @property
    def n_channels(self) -> int:
        return NF + (self.law == "ljrf") + (self.ntypes > 1)

    @staticmethod
    def create(geom: PadGeometry, law: str, *, a0: float = 0.0,
               gamma: float = 0.0, sigma: float = 0.0, cut: float = 1.0,
               dt: float = 0.01, lj_eps: float = 1.0,
               lj_sig: float = 1.0) -> "PairCoef":
        if law not in ("dpd", "lj"):
            raise NotImplementedError(
                f"pair law {law!r} takes no scalar coefficients")
        lx, ly, lz = (float(n * c) for n, c in zip(geom.dims,
                                                    geom.cell_size))
        s6 = float(lj_sig) ** 6
        return PairCoef(law=law, a0=float(a0), gamma=float(gamma),
                        sigma=float(sigma), cut=float(cut),
                        inv_cut=1.0 / float(cut),
                        dtinvsqrt=float(1.0 / np.sqrt(dt)),
                        lj1=48.0 * float(lj_eps) * s6 * s6,
                        lj2=24.0 * float(lj_eps) * s6,
                        periodic_x=bool(geom.periodic_x), lx=lx, ly=ly,
                        lz=lz, inv_lx=1.0 / lx, inv_ly=1.0 / ly,
                        inv_lz=1.0 / lz)

    @staticmethod
    def of(geom: PadGeometry, params, dt: float) -> "PairCoef":
        """make_pair_kernel's constants for a config law: the scalar ones
        of a neutral one-type law, the tables otherwise, and the noise
        variants."""
        check_supported(geom, params)
        variants = dict(
            gaussian=bool(getattr(params, "gaussian_noise", False)),
            ramp=isinstance(params, DPDTstatParams) and params.is_ramp)
        if params.ntypes == 1 and not isinstance(params, LJCutRFParams):
            return PairCoef.create(geom, **_scalar_kwargs(params, dt)) \
                ._replace(**variants)
        law = "ljrf" if isinstance(params, LJCutRFParams) else (
            "lj" if isinstance(params, LJCutParams) else "dpd")
        base = PairCoef.create(geom, "lj" if law == "ljrf" else law, dt=dt,
                               cut=params.max_cut)
        return base._replace(law=law, ntypes=params.ntypes,
                             tables=pair_tables(params), **variants)


def _scalar_kwargs(params, dt: float) -> dict:
    """PairCoef.create's keyword arguments for a single-type neutral law
    (dpd/tstat: the dpd law with a0 = 0)."""
    if isinstance(params, (DPDParams, DPDTstatParams)):
        a0 = params.a0[0][0] if isinstance(params, DPDParams) else 0.0
        return dict(a0=a0, gamma=params.gamma[0][0],
                    sigma=params.sigma[0][0], cut=params.cut[0][0], dt=dt,
                    law="dpd")
    if isinstance(params, LJCutParams):
        return dict(cut=params.cut[0][0], dt=dt, law="lj",
                    lj_eps=params.epsilon[0][0], lj_sig=params.sigma[0][0])
    raise NotImplementedError(
        f"pair kernel: the {type(params).__name__} law is not ported")


def legacy_kwargs(params, dt: float) -> dict:
    """make_dpd_kernel's keyword arguments for a single-type config law:
    dpd or lj with uniform noise (pallas_dpd.py:877-907 takes neither
    dpd/tstat nor gaussian noise)."""
    if isinstance(params, DPDTstatParams) or getattr(
            params, "gaussian_noise", False):
        raise NotImplementedError(
            "the full-stencil kernel takes neither dpd/tstat nor gaussian "
            "noise")
    return _scalar_kwargs(params, dt)


def neighbor_offsets(geom: PadGeometry):
    """The (ox, oy, oz) cell offsets of the stencil: -1, 0, 1 on every axis
    but a single-cell y or z axis, which has 0 only (its one cell is its
    own neighbour on both sides; the minimum image finds the pair's nearest
    image, pallas_dpd.py:316-322)."""
    ys = (0,) if geom.dims[1] == 1 else (-1, 0, 1)
    zs = (0,) if geom.dims[2] == 1 else (-1, 0, 1)
    return list(itertools.product((-1, 0, 1), ys, zs))


@functools.lru_cache(maxsize=16)
def _neighbor_columns(geom: PadGeometry, device: torch.device):
    """The real (block, lane) columns (cells) of the layout, flat over the
    [nb * lanes] cell axis, and for each stencil offset (neighbor_offsets)
    the column of each one's neighbour cell and whether it exists (open
    axes end at the grid; periodic axes wrap).  Returns (icol [R], cols
    [O, R], oks [O, R])."""
    nx, ny, nz = geom.dims
    s, p, lanes, nb = geom.s, geom.p, geom.lanes, geom.n_blocks
    per_y, per_z = geom.periodic_yz
    lane = np.arange(lanes)
    slab = np.arange(nb)[:, None] * p + (lane // s)[None, :]
    real = ((lane < p * s)[None, :] & (slab < nx)).reshape(-1)
    icol = np.flatnonzero(real)
    slab = slab.reshape(-1)[icol]
    within = np.broadcast_to(lane % s, (nb, lanes)).reshape(-1)[icol]
    cy = within // nz
    cz = within % nz
    cols, oks = [], []
    for ox, oy, oz in neighbor_offsets(geom):
        jx = slab + ox
        if geom.periodic_x:
            jx = jx % nx
        jy, jz = cy + oy, cz + oz
        ok = (jx >= 0) & (jx < nx)
        if per_y:
            jy = jy % ny
        else:
            ok = ok & (jy >= 0) & (jy < ny)
        if per_z:
            jz = jz % nz
        else:
            ok = ok & (jz >= 0) & (jz < nz)
        col = (jx // p) * lanes + (jx % p) * s + jy * nz + jz
        cols.append(np.where(ok, col, 0))
        oks.append(ok)
    return (torch.from_numpy(icol).to(device),
            torch.from_numpy(np.stack(cols)).to(device),
            torch.from_numpy(np.stack(oks)).to(device))


def _span(t0: int, t: int, n: int, periodic: bool):
    """The grid cells one axis of a tile's staged stencil holds, in the
    kernel's order (csrc/pair_kernel.cu span_of): the tile's cells t0 ..
    t0 + t - 1 and one more on each side, the whole axis where those would
    wrap onto themselves on a periodic axis, clipped to the grid on an open
    one."""
    te = min(t, n - t0)
    if periodic:
        if te + 2 >= n:
            return list(range(n))
        return [(t0 - 1 + k) % n for k in range(te + 2)]
    return list(range(max(t0 - 1, 0), min(t0 + te + 1, n)))


class TilePlan(NamedTuple):
    """How the Hopper pair kernel cuts the cell grid, and which of its two
    bodies runs.  `TilePlan.of(geom, kind)` picks from the geometry and the
    launch's kind (`launch_kind`): the dense body where a cell's fill cap
    exceeds THREADS and the body is built for the kind and the axes
    (`dense_built`), the tiled body everywhere else.

    The tiled body: one CUDA block (or `split` blocks, each taking
    every split-th 32-atom chunk) per tile of tile = (tx, ty, tz) cells,
    whose stencil it stages in shared memory.  The tile: among the tiles of
    at most as many cells as the block's THREADS threads hold atoms at half
    the fill cap per cell, whose worst-case stencil (every cell at the
    storage cap) fits SMEM_BUDGET and whose z length divides nz, the
    longest along z (a warp's atoms then sit in neighbouring z cells, whose
    stencils overlap: the fastest shape of those timed on the card, PERF.md
    §6), then the one that stages the fewest cells over the grid
    (`staged_total`), then the longest along y.  Where the grid has fewer
    than two tiles per SM, split spreads each tile's atoms over more
    blocks.  Bound by its candidate loop: a warp runs the law for every
    candidate that any of its threads finds within the cutoff.

    The dense body (`dense`: a cell's fill cap above THREADS, where a tile
    would be one cell staging 27 cells at the storage cap, 3 blocks an SM:
    path I's and K's water, ~100 atoms a cell at cap 150; every other
    launch at such a cap keeps the one-cell tile).  A first pass
    compacts the layout into cell-major records (`dense_records_plain`,
    `scratch_bytes` of device memory); then one block a cell (tile 1 x 1 x
    1, split 1) streams its stencil's record runs through a ring of
    DENSE_RING runs (`smem_bytes`), tests a run's candidates into per-thread
    masks and runs the law on each thread's own hits, so a warp takes the
    law as often as its busiest thread has pairs.  Bound by its candidate
    loop: each atom's tests of 27 cells of ~100 atoms, and the law on each
    thread's hits."""

    geom: PadGeometry
    tile: Tuple[int, int, int]
    split: int = 1
    dense: bool = False

    @staticmethod
    def of(geom: PadGeometry, kind: tuple = ()) -> "TilePlan":
        return _tile_plan(geom, kind)

    @property
    def periodic(self) -> Tuple[bool, bool, bool]:
        return (self.geom.periodic_x,) + tuple(self.geom.periodic_yz)

    @property
    def n_tiles(self) -> Tuple[int, int, int]:
        return tuple(-(-n // t) for n, t in zip(self.geom.dims, self.tile))

    @property
    def n_blocks(self) -> int:
        return int(np.prod(self.n_tiles)) * self.split

    @property
    def staged_max(self) -> int:
        return int(np.prod([min(t + 2, n)
                            for t, n in zip(self.tile, self.geom.dims)]))

    @property
    def staged_total(self) -> int:
        """The cells all tiles stage together (each tile stages a box, so
        the total is the product of the axes' sums)."""
        return int(np.prod([
            sum(len(_span(k * t, t, n, per)) for k in range(-(-n // t)))
            for t, n, per in zip(self.tile, self.geom.dims, self.periodic)]))

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block (csrc/pair_kernel.cu
        smem_bytes and dense_smem).  Tiled: per staged cell cap float4s,
        five ints and ceil(cap / 32) live-mask words; the tile's prefix of
        (cells + 1) ints.  Dense: the ring's DENSE_RING record runs of
        `run` 32-byte records, each thread's ceil(run / 32) mask words, and
        the cell's z and order by z (8 bytes an atom of a run)."""
        cap = self.geom.cap
        if self.dense:
            run = dense_run(cap)
            return (DENSE_RING * run * 32 + -(-run // 32) * THREADS * 4
                    + run * 8)
        cells = self.staged_max
        words = -(-cap // 32)
        return (cells * cap * 16 + cells * 5 * 4 + cells * words * 4
                + (int(np.prod(self.tile)) + 1) * 4)

    @property
    def scratch_bytes(self) -> int:
        """Device memory the dense body's records take: a run of
        dense_run(cap) 32-byte records a cell, then an int count a cell
        (0 for the tiled body)."""
        if not self.dense:
            return 0
        return self.geom.n_cells * (dense_run(self.geom.cap) * 32 + 4)

    def tiles(self):
        """Each tile's origin cell, in the kernel's block order (z
        fastest)."""
        return [tuple(k * t for k, t in zip(ks, self.tile))
                for ks in itertools.product(*(range(n)
                                              for n in self.n_tiles))]

    def tile_cells(self, origin):
        """The (cx, cy, cz) cells of the tile at `origin`."""
        return list(itertools.product(*(
            range(o, min(o + t, n))
            for o, t, n in zip(origin, self.tile, self.geom.dims))))

    def staged_cells(self, origin):
        """The (cx, cy, cz) cells the tile at `origin` stages, in the
        kernel's order."""
        return list(itertools.product(*(
            _span(o, t, n, per) for o, t, n, per in zip(
                origin, self.tile, self.geom.dims, self.periodic))))


THREADS = 128                  # a block's threads (kThreads in the kernel)
SMEM_BUDGET = 100 * 1024       # a block's shared memory: two fit an SM
SMEM_MAX = 232448 - 1024       # one block's most on an H100 (kSmemMax)
N_SMS = 132                    # an H100 SXM's multiprocessors
DENSE_RING = 3                 # the dense body's record runs in flight


def dense_run(cap: int) -> int:
    """A cell's record run in the dense body: cap rounded up to 8."""
    return -(-cap // 8) * 8


# The launch kinds the dense body is instantiated for (csrc/pair_kernel.cu
# part 11): path I's and K's water (launch_kind)
DENSE_BUILT = (("ljrf", True, N_EXCL, False, False, False),)


def launch_kind(coef: "PairCoef", n_excl: int, legacy: bool = False) -> tuple:
    """What of a launch, beside its geometry, decides its body: (law, more
    than one type, exclusion channels, gaussian noise, ramp, the
    full-stencil entry point)."""
    return (coef.law, coef.ntypes > 1, n_excl, bool(coef.gaussian),
            bool(coef.ramp), legacy)


def dense_built(geom: PadGeometry, kind: tuple) -> bool:
    """Whether the dense body is built for a launch: its kind in
    DENSE_BUILT, y and z periodic with >= 3 cells each (the body visits
    the full 3 x 3 stencil on them) and x open or periodic with >= 3."""
    return (kind in DENSE_BUILT and tuple(geom.periodic_yz) == (True, True)
            and min(geom.dims[1:]) >= 3
            and (not geom.periodic_x or geom.dims[0] >= 3))


@functools.lru_cache(maxsize=32)
def _tile_plan(geom: PadGeometry, kind: tuple) -> TilePlan:
    dims = geom.dims
    if geom.fcap > THREADS and dense_built(geom, kind):
        plan = TilePlan(geom, (1, 1, 1), dense=True)
        if plan.smem_bytes > SMEM_BUDGET:
            raise NotImplementedError(
                f"pair kernel: the dense body's ring at cap {geom.cap} needs "
                f"{plan.smem_bytes} bytes of shared memory (at most "
                f"{SMEM_BUDGET})")
        return plan
    target = max(1, 2 * THREADS // geom.fcap)
    best = None
    for tile in itertools.product(*(range(1, min(n, target) + 1)
                                    for n in dims)):
        cells = int(np.prod(tile))
        if (cells > target or dims[2] % tile[2]) and cells > 1:
            continue
        plan = TilePlan(geom, tile)
        if plan.smem_bytes > SMEM_BUDGET and cells > 1:
            continue
        key = (tile[2], -plan.staged_total, tile[1])
        if best is None or key > best[0]:
            best = (key, plan)
    plan = best[1]
    if plan.smem_bytes > SMEM_MAX:
        raise NotImplementedError(
            f"pair kernel: one cell's stencil at cap {geom.cap} needs "
            f"{plan.smem_bytes} bytes of shared memory (at most {SMEM_MAX})")
    tiles = int(np.prod(plan.n_tiles))
    if tiles < 2 * N_SMS:
        chunks = -(-int(np.prod(plan.tile)) * geom.fcap // 32)
        plan = plan._replace(split=max(1, min(chunks, -(-2 * N_SMS // tiles))))
    return plan


def _min_image(d, length: float, inv_length: float):
    return d - length * torch.round(d * inv_length)


def _table_tensor(coef: PairCoef, device) -> torch.Tensor:
    """The TABLE_ROWS rows as f32[rows, ntypes^2]."""
    t = coef.ntypes
    return torch.tensor(coef.tables[4:], dtype=torch.float32,
                        device=device).reshape(len(TABLE_ROWS), t * t)


def pair_forces_plain(geom: PadGeometry, coef: PairCoef, fld: torch.Tensor,
                      tag: torch.Tensor, salt: int, legacy: bool = False,
                      pbond=None, sig_scale=None) -> torch.Tensor:
    """The kernels' function in PyTorch: fld f32[nb, NF, cap, lanes], tag
    i32[nb, cap, lanes], optional pbond i32[nb, n_excl, cap, lanes] (2 or
    4 partner-tag channels) -> f32[nb,
    3, cap, lanes].  Newton-off: each slot of a real column sums over the
    stencil's cells around its column (neighbor_offsets), all ranks of
    each, less the pairs whose j tag is one of its partner tags.
    legacy=True takes make_dpd_kernel's arithmetic (r = sqrt(r^2), r >
    1e-10), else make_pair_kernel's (r = r^2 / r, r^2 > 1e-20).  A typed law (2-4 types, or ljrf) reads
    its coefficients from the tables, as the kernel does: the pair is
    tested against the largest cutoff, then each term against its own.
    A ramp law multiplies the noise term by sig_scale (None: 1)."""
    nb, nf, cap, lanes = fld.shape
    dev = fld.device
    fl = fld.permute(0, 3, 1, 2).reshape(nb * lanes, nf, cap)
    tl = tag.permute(0, 2, 1).reshape(nb * lanes, cap)
    icol, cols, oks = _neighbor_columns(geom, dev)
    self_o = neighbor_offsets(geom).index((0, 0, 0))
    per_y, per_z = geom.periodic_yz
    pb_i = None
    if pbond is not None:                            # [R, n_excl, cap_i, 1]
        pb_i = pbond.permute(0, 3, 1, 2).reshape(
            nb * lanes, pbond.shape[1], cap)[icol][..., None]
    fi = fl[icol]                                    # [R, NF, cap_i]
    xi = fi[:, :, :, None]                           # [R, NF, cap_i, 1]
    ti = tl[icol][:, :, None]                        # [R, cap_i, 1]
    live_i = (fi[:, 0] < 0.5 * BIG)[:, :, None]
    not_self = ~torch.eye(cap, dtype=torch.bool, device=dev)
    typed = coef.typed
    if typed:
        tab = _table_tensor(coef, dev)
        row = {name: tab[k] for k, name in enumerate(TABLE_ROWS)}
        cut2, qq, cut_coul2, inv_rc3 = coef.tables[:4]
        multi = coef.ntypes > 1
        nt = coef.ntypes
        # a dead slot's type is never read as a coefficient index
        tbase = (torch.clamp(xi[:, nf - 1].long(), 0, nt - 1) * nt) \
            if multi else None
    else:
        cut2 = coef.cut * coef.cut
    f = torch.zeros((icol.shape[0], 3, cap), dtype=torch.float32, device=dev)
    for o in range(cols.shape[0]):
        fj = fl[cols[o]]
        xj = fj[:, :, None, :]                       # [R, NF, 1, cap_j]
        dx = xi[:, 0] - xj[:, 0]
        dy = xi[:, 1] - xj[:, 1]
        dz = xi[:, 2] - xj[:, 2]
        if coef.periodic_x:
            dx = _min_image(dx, coef.lx, coef.inv_lx)
        if per_y:
            dy = _min_image(dy, coef.ly, coef.inv_ly)
        if per_z:
            dz = _min_image(dz, coef.lz, coef.inv_lz)
        rsq = dx * dx + dy * dy + dz * dz
        ok = oks[o][:, None, None] & live_i \
            & (fj[:, 0] < 0.5 * BIG)[:, None, :] & (rsq < cut2)
        if legacy:
            r = torch.sqrt(rsq)
            ok = ok & (r > EPS)
        else:
            ok = ok & (rsq > EPS * EPS)
        if o == self_o:
            ok = ok & not_self
        if pb_i is not None:
            tj = tl[cols[o]][:, None, :]
            for c in range(pb_i.shape[1]):
                ok = ok & (tj != pb_i[:, c])
        if typed:
            # the pair's table column ti * T + tj, or 0 with one type
            tp = (tbase + torch.clamp(xj[:, nf - 1].long(), 0, nt - 1)) \
                if multi else None

            def c(name):
                v = row[name]
                return v[tp] if multi else v[0]
        if coef.law in ("lj", "ljrf"):
            r2inv = 1.0 / torch.clamp(rsq, min=EPS * EPS)
            r6inv = r2inv * r2inv * r2inv
            if typed:
                fpair = torch.where(
                    rsq < c("cut2"),
                    r6inv * (c("lj1") * r6inv - c("lj2")) * r2inv, 0.0)
            else:
                fpair = r6inv * (coef.lj1 * r6inv - coef.lj2) * r2inv
            if coef.law == "ljrf":
                rinv = torch.rsqrt(torch.clamp(rsq, min=EPS * EPS))
                r2i = rinv * rinv
                qprod = qq * xi[:, 6] * xj[:, 6]
                fcoul = qprod * (r2i * rinv - inv_rc3 * c("c_rf"))
                fpair = fpair + torch.where(rsq < cut_coul2, fcoul, 0.0)
        else:
            a0, gamma, sigma, inv_cut = coef.a0, coef.gamma, coef.sigma, \
                coef.inv_cut
            if typed:
                ok = ok & (rsq < c("cut2"))
                a0, gamma, sigma, inv_cut = (c("a0"), c("gamma"), c("sigma"),
                                             c("inv_cut"))
            rinv = torch.rsqrt(torch.clamp(rsq, min=EPS * EPS))
            if not legacy:
                r = rsq * rinv
            wd = 1.0 - r * inv_cut
            dot = (dx * (xi[:, 3] - xj[:, 3]) + dy * (xi[:, 4] - xj[:, 4])
                   + dz * (xi[:, 5] - xj[:, 5]))
            bits = pair_bits(salt, ti, tl[cols[o]][:, None, :])
            if coef.gaussian:
                noise = box_muller(bits, 0x7F4A7C15, 1e-12)
            else:
                noise = SQRT3 * (2.0 * uniform01(bits) - 1.0)
            fpair = a0 * wd
            fpair = fpair - gamma * wd * wd * dot * rinv
            term = sigma * wd * noise * coef.dtinvsqrt
            if coef.ramp:
                term = term * (1.0 if sig_scale is None else sig_scale)
            fpair = fpair + term
            fpair = fpair * rinv
        fpair = torch.where(ok, fpair, 0.0)
        f[:, 0] += (fpair * dx).sum(-1)
        f[:, 1] += (fpair * dy).sum(-1)
        f[:, 2] += (fpair * dz).sum(-1)
    out = torch.zeros((nb * lanes, 3, cap), dtype=torch.float32, device=dev)
    out[icol] = f
    return out.reshape(nb, lanes, 3, cap).permute(0, 2, 3, 1).contiguous()


def launch_key(geom: PadGeometry, coef: PairCoef, n_excl: int) -> str:
    """A launch's count key: law, types, noise variants, exclusion
    channels, the y/z geometry variants (a single-cell axis, an open axis),
    filing cap ("lj-excl2-cap18", "ljrf-t2-cap44", "dpd-gauss-cap15",
    "dpd-ramp-cap28", "dpd-1cell-cap112", "dpd-1cell-openyz-cap32")."""
    types = f"-t{coef.ntypes}" if coef.ntypes > 1 else ""
    noise = ("-gauss" if coef.gaussian else "") + ("-ramp" if coef.ramp
                                                   else "")
    excl = f"-excl{n_excl}" if n_excl else ""
    axes = ("-1cell" if min(geom.dims[1:]) == 1 else "") + (
        "-openyz" if geom.periodic_yz != (True, True) else "")
    return f"{coef.law}{types}{noise}{excl}{axes}-cap{geom.fcap}"


def dense_records_plain(geom: PadGeometry, coef: PairCoef, fld: torch.Tensor,
                        tag: torch.Tensor, occ: torch.Tensor):
    """The dense body's first pass in PyTorch: the pad layout as cell-major
    record runs.  Cell (linear id, cells x slowest) c's run holds its live
    atoms (rank below min(occ of its block, cap), x below BIG/2) in
    ascending rank, dense_run(cap) records long: pos f32[cells, run, 4] (x,
    y, z in the cell's frame on each periodic axis, and q for the ljrf law,
    else 0), aux i32[cells, run, 4] (tag, type (0 with one type), rank, 0),
    zero past the count; count i32[cells].  The cell's frame: a coordinate
    less the box length times the nearest integer to its distance from the
    cell's centre over the box length, so an atom that a run wrapped
    across a face since its last relayout lies beside its filed cell."""
    nf, cap = fld.shape[1:3]
    dev = fld.device
    cell = torch.arange(geom.n_cells, device=dev)
    b, lane = geom.slot_of_cell(cell)
    fl = fld[b, :, :, lane]                          # [cells, NF, cap]
    rank = torch.arange(cap, device=dev)
    live = (rank[None, :] < torch.clamp(occ.long()[b], max=cap)[:, None]) \
        & (fl[:, 0] < 0.5 * BIG)
    q = fl[:, 6] if coef.law == "ljrf" else torch.zeros_like(fl[:, 0])
    ty = fl[:, nf - 1].int() if coef.ntypes > 1 \
        else torch.zeros_like(fl[:, 0], dtype=torch.int32)
    _, ny, nz = geom.dims
    index = (cell // (ny * nz), cell // nz % ny, cell % nz)
    xyz = []
    for a, per in enumerate((geom.periodic_x,) + tuple(geom.periodic_yz)):
        v = fl[:, a]
        if per:
            length = geom.dims[a] * geom.cell_size[a]
            centre = geom.lo[a] + (index[a] + 0.5) * geom.cell_size[a]
            v = v - length * torch.round((v - centre[:, None].float())
                                         / length)
        xyz.append(v)
    pos_all = torch.stack((*xyz, q), -1)
    aux_all = torch.stack((tag[b, :, lane], ty,
                           rank.int().expand(geom.n_cells, cap),
                           torch.zeros_like(ty)), -1)
    # a live rank's place in its run: the live ranks below it
    place = torch.cumsum(live.int(), 1) - 1
    run = dense_run(cap)
    pos = torch.zeros((geom.n_cells, run, 4), dtype=torch.float32,
                      device=dev)
    aux = torch.zeros((geom.n_cells, run, 4), dtype=torch.int32, device=dev)
    ci, ri = live.nonzero(as_tuple=True)
    pos[ci, place[ci, ri]] = pos_all[ci, ri]
    aux[ci, place[ci, ri]] = aux_all[ci, ri]
    return pos, aux, live.sum(1).int()


def _launch(name: str, geom: PadGeometry, coef: PairCoef, tables, fld, tag,
            salt: int, occ, pbond, sig_scale: float):
    kern = _build.KERNELS[name]
    fn = kern.function()
    nb, _, cap, lanes = fld.shape
    nx, ny, nz = geom.dims
    n_excl = 0 if pbond is None else pbond.shape[1]
    plan = TilePlan.of(geom, launch_kind(coef, n_excl, name == "dpd_full"))
    out = torch.empty((nb, 3, cap, lanes), dtype=torch.float32,
                      device=fld.device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=fld.device) if plan.dense else None
    with torch.cuda.device(fld.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(fld.data_ptr(), tag.data_ptr(), occ.data_ptr(),
                None if pbond is None else pbond.data_ptr(),
                out.data_ptr(), nb, cap, lanes, nx, ny, nz, geom.s, geom.p,
                int(coef.periodic_x), int(geom.periodic_yz[0]),
                int(geom.periodic_yz[1]), LAWS.index(coef.law), n_excl,
                coef.lx, coef.ly, coef.lz, coef.inv_lx, coef.inv_ly,
                coef.inv_lz, coef.a0, coef.gamma, coef.sigma, coef.cut,
                coef.inv_cut, coef.dtinvsqrt, coef.lj1, coef.lj2,
                salt & 0xFFFFFFFF,
                tables, coef.ntypes, int(coef.gaussian), int(coef.ramp),
                sig_scale, *plan.tile, plan.split, plan.smem_bytes,
                int(plan.dense),
                None if scratch is None else scratch.data_ptr(),
                *map(float, geom.lo),
                stream)
    _build.check(rc, kern)
    kern.count(launch_key(geom, coef, n_excl))
    return out


def dense_resident(plan: TilePlan) -> int:
    """The dense body's blocks an SM at the plan's shared memory
    (obmd_pair_dense_resident: cudaOccupancyMaxActiveBlocksPerMultiprocessor
    of its instantiation); needs the card."""
    kern = _build.KERNELS["pair"]
    kern.function()                        # builds and loads the library
    fn = ctypes.CDLL(str(kern.library_path())).obmd_pair_dense_resident
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    _build.check(fn(plan.smem_bytes, ctypes.byref(n)), kern)
    return n.value


def _wrapper(name: str, geom: PadGeometry, coef: PairCoef, legacy: bool,
             exclude_bonded: bool, n_excl: int = N_EXCL):
    """The kernel's calling convention: checks, then a CUDA tensor goes to
    the Hopper kernel and a CPU tensor to the plain version.  There is no
    fallback between them.  With exclude_bonded, pbond (n_excl channels)
    is required.
    sig_scale is a ramp law's noise scale of the step (None: 1); a law
    without a ramp ignores it, as make_pair_kernel does."""
    shape = (geom.n_blocks, coef.n_channels, geom.cap, geom.lanes)
    pshape = (geom.n_blocks, n_excl, geom.cap, geom.lanes)
    # the tables live on the host: the C entry point copies them into the
    # launch's parameters
    tables = ((ctypes.c_float * len(coef.tables))(*coef.tables)
              if coef.typed else None)

    def forces(fld: torch.Tensor, tag: torch.Tensor, salt: int,
               occ: torch.Tensor, pbond=None, sig_scale=None) -> torch.Tensor:
        if tuple(fld.shape) != shape or fld.dtype != torch.float32:
            raise ValueError(f"fld must be float32{list(shape)}, got "
                             f"{fld.dtype}{list(fld.shape)}")
        if tuple(tag.shape) != (shape[0],) + shape[2:] \
                or tag.dtype != torch.int32:
            raise ValueError("tag must be int32[nb, cap, lanes]")
        if tuple(occ.shape) != (shape[0],) or occ.dtype != torch.int32:
            raise ValueError("occ must be int32[nb]")
        if exclude_bonded != (pbond is not None):
            raise ValueError("pbond is required with bonded exclusion and "
                             "refused without it")
        if pbond is not None and (tuple(pbond.shape) != pshape
                                  or pbond.dtype != torch.int32):
            raise ValueError(f"pbond must be int32{list(pshape)}")
        if not (fld.device == tag.device == occ.device) or (
                pbond is not None and pbond.device != fld.device):
            raise ValueError("fld, tag, occ and pbond must share one device")
        if fld.device.type == "cpu":
            return pair_forces_plain(geom, coef, fld, tag, salt, legacy,
                                     pbond, sig_scale)
        if fld.device.type != "cuda":
            raise ValueError(f"unsupported device {fld.device}")
        return _launch(name, geom, coef, tables, fld.contiguous(),
                       tag.contiguous(), salt, occ.contiguous(),
                       None if pbond is None else pbond.contiguous(),
                       1.0 if sig_scale is None else float(sig_scale))

    return forces


def make_pair_kernel(geom: PadGeometry, params, dt: float,
                     exclude_bonded: bool = False, n_excl: int = N_EXCL):
    """Build pair_forces(fld, tag, salt, occ, pbond=None, sig_scale=None)
    -> f32[nb, 3, cap, lanes]: fld f32[nb, NF, cap, lanes] (x, y, z, vx,
    vy, vz, [q], [type]; dead slots at BIG; NF = 6, 7 or 8), tag i32[nb,
    cap, lanes], salt a uint32 python int, occ i32[nb] (per block highest
    occupied rank + 1; stale-high is safe, stale-low is not), with
    exclude_bonded pbond i32[nb, n_excl, cap, lanes] (partner tags, -2 for
    none; n_excl 2 for chains, 4 for branched topologies), sig_scale a
    dpd/tstat ramp's noise scale of the step (a python float; None is 1).
    The law, its tables and its noise variants come from `params`
    (DPDParams, DPDTstatParams, LJCutParams or LJCutRFParams, 1-4
    types)."""
    coef = PairCoef.of(geom, params, dt)
    if exclude_bonded:
        check_channels(geom, coef, n_excl)
    return _wrapper("pair", geom, coef, legacy=False,
                    exclude_bonded=exclude_bonded, n_excl=n_excl)


def check_channels(geom: PadGeometry, coef: PairCoef, n_excl: int) -> None:
    """Raise for an exclusion channel count the Hopper kernel is not built
    for: csrc/pair_kernel.cu instantiates 2 channels (chains) and 4
    (branched topologies) for every law, type count, noise variant and
    y/z geometry of make_pair_kernel; the JAX engines build only those two
    counts (obmd_tpu/engine_cellpad.py:75-78)."""
    if n_excl not in (N_EXCL, N_EXCL_BRANCHED):
        raise NotImplementedError(
            f"pair kernel: {n_excl} exclusion channels (2 for chains, 4 for "
            "branched topologies, as obmd_tpu/engine_cellpad.py:75-78)")


def make_dpd_kernel(geom: PadGeometry, *, a0: float = 0.0,
                    gamma: float = 0.0, sigma: float = 0.0, cut: float = 1.0,
                    dt: float = 0.01, law: str = "dpd",
                    lj_eps: float = 1.0, lj_sig: float = 1.0,
                    exclude_bonded: bool = False):
    """Build dpd_forces(fld, tag, salt, occ, pbond=None), the counterpart of
    the legacy full-stencil kernel (pallas_dpd.py:877): the calling
    convention of make_pair_kernel's function on a 6-channel layout, law
    "dpd" or "lj" from scalar coefficients (one type, as the TPU kernel),
    with exclude_bonded the 2-channel pbond."""
    check_geometry(geom, cut, legacy=True)
    return _wrapper("dpd_full", geom, PairCoef.create(
        geom, law, a0=a0, gamma=gamma, sigma=sigma, cut=cut, dt=dt,
        lj_eps=lj_eps, lj_sig=lj_sig), legacy=True,
        exclude_bonded=exclude_bonded)
