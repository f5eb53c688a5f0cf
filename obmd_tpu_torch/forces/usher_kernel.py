"""The whole USHER steered-insertion search in one C call.

Counterpart of `obmd_tpu/forces/pallas_usher.py` (`usher_law`, its DPD,
dpd/ext and LJ-family branches, and `usher_search_pallas`).  The Hopper
kernels in `csrc/usher_kernel.cu` replace `make_usher_kernel`, with one C
entry point per law (`obmd_usher_search` for DPD and the dpd/ext rows,
`obmd_usher_search_lj` for lj/cut and the neutral lj/cut/rf rows), each law
with its own launch count (`usher_search`, `usher_search_dpdext`,
`usher_search_lj`, `usher_search_ljrf`); their plain
version is `obmd.subset.usher_search_subset_batch`, whose arithmetic the
kernel follows (it is also what the JAX engine runs off the TPU).  A CUDA
tensor goes to the kernel, a CPU tensor to the plain version; the choice
is the tensors' device, never an environment variable.

A float64 scene's subsets go to the float64 instantiation of each law
(`obmd_usher_search_f64`, `obmd_usher_search_lj_f64`; launch keys
`usher_search_f64`, `usher_search_dpdext_f64`, `usher_search_lj_f64`,
`usher_search_ljrf_f64`), the counterpart of the float64 search the JAX
nlist engine runs (its XLA usher_search_subset at x64): `launch` picks the
instantiation from the subset's dtype, with the grid, the bounds, the
coefficients and the step parameters in that dtype, and refuses inputs of
mixed dtypes.

The kernel bins each side's valid subset rows on a cell grid
(`UsherGrid`: x spans the insertion region widened by pad = max_cut +
skin, y and z the box; every cell side at least the law's largest cut
against the trial type), then runs one warp per candidate over the 27
cells around it.  `usher_energy_binned_plain` and
`usher_search_binned_plain` are that algorithm in PyTorch, for the tests.

The laws take coefficients against the fix's single trial type, looked up
by the subset atom's type: DPD E = 0.5*a0*rc*wd^2 (a0, cut), which is
dpd/ext's conservative energy too (its transverse terms have none, and
dpd/ext/tstat has no kernel law, pallas_usher.py:48-56); lj/cut
E = r^-6 (lj3 r^-6 - lj4) - eshift (lj3, lj4, cut, eshift).  lj/cut/rf
takes the lj rows with eshift = 0: an ATOM-mode trial atom is neutral
(q = 0), so the reaction field adds nothing to its energy or force
(pallas_usher.py:57-75).
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import _build
from ..config import DPDExtParams, DPDParams, LJCutParams, LJCutRFParams
from ..geometry import Box, RegionBlock, const_like, real_type, reciprocals
from ..obmd.subset import (EPSILON, Subset, _batched_energy_force,
                           usher_search_subset_batch)

MAX_TYPES = 4        # kMaxTypes: rows of the coefficient table
N_COEF = 4           # kCoef: coefficients per row
# kMaxCells: the scan's copy of one side's counts in the default 48 KB of
# shared memory, less the kBinStatic bytes kept for bin_count's own arrays
MAX_CELLS = (48 * 1024 - 1024) // 4
# a cell side exceeds the cut by this share, so that float32 rounding of
# the cell index never puts a pair within the cutoff two cells apart
CELL_MARGIN = 1e-3
# the launch keys' suffix of each dtype's instantiation
SUFFIX = {torch.float32: "", torch.float64: "_f64"}


def usher_law(pair, ct: int, dtype: torch.dtype = torch.float32):
    """(kernel name, coefficient table [MAX_TYPES, N_COEF] in `dtype`, the
    cut column) of a pair style against trial type ct: row tj holds the
    law's coefficients for a subset atom of type tj (dpd: a0, cut, 0, 0;
    lj/cut and lj/cut/rf: lj3, lj4, cut, eshift), rows past ntypes zero;
    None when this port has no kernel law for the style (dpd/ext/tstat, as
    JAX has it, and dpd/tstat).  dpd/ext takes the DPD table of its a0 and
    cut, counted under its own name; a float64 table's name ends in
    _f64."""
    if isinstance(pair, DPDExtParams) and pair.tstat_only:
        return None
    if isinstance(pair, (DPDParams, DPDExtParams)):
        cols = [np.asarray(pair.a0, np.float64)[ct],
                np.asarray(pair.cut, np.float64)[ct]]
        name = ("usher_search" if isinstance(pair, DPDParams)
                else "usher_search_dpdext")
        cut_col = 1
    elif isinstance(pair, (LJCutParams, LJCutRFParams)):
        eps = np.asarray(pair.epsilon, np.float64)[ct]
        sig = np.asarray(pair.sigma, np.float64)[ct]
        cut = np.asarray(pair.cut, np.float64)[ct]
        s6 = sig ** 6
        lj3 = 4.0 * eps * s6 * s6
        lj4 = 4.0 * eps * s6
        if isinstance(pair, LJCutParams) and pair.shift:
            rc6 = (1.0 / cut ** 2) ** 3
            eshift = rc6 * (lj3 * rc6 - lj4)
        else:
            eshift = np.zeros_like(lj3)
        cols = [lj3, lj4, cut, eshift]
        name = ("usher_search_lj" if isinstance(pair, LJCutParams)
                else "usher_search_ljrf")
        cut_col = 2
    else:
        return None
    nt = len(cols[0])
    if nt > MAX_TYPES:
        raise NotImplementedError(
            f"USHER kernel: {nt} types (at most {MAX_TYPES})")
    real = real_type(dtype)
    table = np.zeros((MAX_TYPES, N_COEF), real)
    for c, col in enumerate(cols):
        table[:nt, c] = col.astype(real)
    return name + SUFFIX[dtype], table, cut_col


def _kernel_law(pair, ct: int, dtype: torch.dtype = torch.float32):
    """usher_law's (name, table) and the largest cut of the table, which
    sizes the grid's cells; raises for a style without a kernel law."""
    law = usher_law(pair, ct, dtype)
    if law is None:
        raise NotImplementedError(
            f"USHER kernel: no law for {type(pair).__name__}")
    name, table, cut_col = law
    return name, table, float(table[:, cut_col].max())


class UsherGrid(NamedTuple):
    """One buffer side's cell grid: `cells` per axis from `lo`, each cell
    `side` long (at least the cut), `inv` its reciprocal (the kernel files
    a position with floor((v - lo) * inv)); lo and inv are rounded to the
    dtype of the rows it files (float32, or float64 for the float64
    instantiation), so the plain binning and the kernel's agree; x is open
    and spans the insertion region widened by pad, y and z span the box
    and wrap where it is periodic."""

    lo: Tuple[float, float, float]
    cells: Tuple[int, int, int]
    side: Tuple[float, float, float]
    inv: Tuple[float, float, float]
    periodic: Tuple[bool, bool, bool]

    @staticmethod
    def of(cfg, region: RegionBlock, pad: float,
           dtype: torch.dtype = torch.float32) -> "UsherGrid":
        _, _, cut = _kernel_law(cfg.pair, int(cfg.obmd.ntype), dtype)
        return _grid(cfg.box, cut, region, float(pad), dtype)

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.cells))

    def stencil(self, axis: int, c: int):
        """The cells of one axis around cell c, each once: c - 1 .. c + 1
        wrapped on a periodic axis (all of a periodic axis of fewer than 3
        cells), clipped to the grid on an open one."""
        n = self.cells[axis]
        if self.periodic[axis]:
            return sorted({(c + o) % n for o in (-1, 0, 1)})
        return [c + o for o in (-1, 0, 1) if 0 <= c + o < n]

    def cell3(self, x: torch.Tensor) -> torch.Tensor:
        """[..., 3] positions of the grid's dtype -> [..., 3] int64 cells
        per axis (the kernel's axis_cell)."""
        f = torch.floor((x - const_like(self.lo, x))
                        * const_like(self.inv, x))
        # fminf(fmaxf(f, -1e6), 1e6): a NaN coordinate files as -1e6
        f = torch.nan_to_num(f, nan=-1e6)
        c = torch.clamp(f, -1e6, 1e6).to(torch.int64)
        n = torch.tensor(self.cells, device=x.device)
        per = torch.tensor(self.periodic, device=x.device)
        return torch.where(per, torch.remainder(c, n),
                           torch.minimum(torch.clamp(c, min=0), n - 1))

    def cell_id(self, c3: torch.Tensor) -> torch.Tensor:
        """Linear cell ids, x fastest."""
        nx, ny, _ = self.cells
        return (c3[..., 2] * ny + c3[..., 1]) * nx + c3[..., 0]

    def stencil_cells(self, c3) -> list:
        """The linear ids of the cells the kernel visits around cell c3
        (three ints): 9 (y, z) runs of x cells."""
        nx, ny, _ = self.cells
        xs = self.stencil(0, int(c3[0]))
        return [(z * ny + y) * nx + x
                for y in self.stencil(1, int(c3[1]))
                for z in self.stencil(2, int(c3[2])) for x in xs]


@functools.lru_cache(maxsize=32)
def _grid(box: Box, cut: float, region: RegionBlock, pad: float,
          dtype: torch.dtype = torch.float32) -> UsherGrid:
    if box.periodic[0]:
        raise NotImplementedError("USHER kernel: x must be open (the "
                                  "OBMD buffers' axis)")
    lo = [region.lo[0] - pad, box.lo[1], box.lo[2]]
    span = [region.hi[0] - region.lo[0] + 2 * pad, box.lengths[1],
            box.lengths[2]]
    cells = [max(1, int(s // (cut * (1 + CELL_MARGIN)))) for s in span]
    while int(np.prod(cells)) > MAX_CELLS:
        cells[int(np.argmax(cells))] -= 1
    side = [s / n for s, n in zip(span, cells)]
    real = real_type(dtype)
    return UsherGrid(lo=tuple(float(real(v)) for v in lo),
                     cells=tuple(cells), side=tuple(side),
                     inv=tuple(reciprocals(side, dtype)),
                     periodic=(False,) + tuple(box.periodic[1:]))


def _align4(n: int) -> int:
    return (n + 3) & ~3


def scratch_words(grids, b_l: int, b_r: int,
                  dtype: torch.dtype = torch.float32) -> int:
    """int32 words of scratch the kernel takes (usher_kernel.cu side_words):
    per side each cell's count and start, each row's cell, the scattered
    row indices and the sorted rows, four reals each (4 words a row in
    float32, 8 in float64: as many words as a real has bytes)."""
    return sum(2 * _align4(g.n_cells + 1) + 2 * _align4(b)
               + dtype.itemsize * b
               for g, b in zip(grids, (b_l, b_r)))


class UsherPlan(NamedTuple):
    """Both sides' grids and the C entry point's host arrays, made once per
    configuration and dtype."""

    name: str
    grids: Tuple[UsherGrid, UsherGrid]
    cells: object      # ctypes int32[6]
    grid: object       # ctypes real[12]: origin, inverse side per side
    bounds: object     # ctypes real[12]: region lo, hi per side
    coef: object       # ctypes real[16]
    ntypes: int

    @staticmethod
    def of(cfg, region_l: RegionBlock, region_r: RegionBlock,
           dtype: torch.dtype = torch.float32) -> "UsherPlan":
        return _plan(cfg.box, cfg.pair, int(cfg.obmd.ntype), cfg.ntypes,
                     region_l, region_r, float(cfg.pair.max_cut + cfg.skin),
                     dtype)


@functools.lru_cache(maxsize=32)
def _plan(box, pair, ct, ntypes, region_l, region_r, pad,
          dtype) -> UsherPlan:
    name, table, cut = _kernel_law(pair, ct, dtype)
    grids = tuple(_grid(box, cut, r, pad, dtype)
                  for r in (region_l, region_r))
    real = ctypes.c_double if dtype == torch.float64 else ctypes.c_float

    def arr(ctype, values):
        values = list(values)
        return (ctype * len(values))(*values)
    return UsherPlan(
        name=name, grids=grids,
        cells=arr(ctypes.c_int, itertools.chain(*(g.cells for g in grids))),
        grid=arr(real, itertools.chain(*(g.lo + g.inv for g in grids))),
        bounds=arr(real, itertools.chain(
            *(r.lo + r.hi for r in (region_l, region_r)))),
        coef=arr(real, table.reshape(-1).tolist()),
        ntypes=int(ntypes))


def _check(arg, t, dtype, shape, dev):
    if (tuple(t.shape) != shape or t.dtype != dtype
            or not t.is_contiguous() or t.device != dev
            or t.device.type != "cuda"):
        raise ValueError(f"USHER kernel: {arg} must be contiguous "
                         f"{dtype}{list(shape)} on the card, got "
                         f"{t.dtype}{list(t.shape)} on {t.device}")


def launch(cfg, sub_l: Subset, sub_r: Subset, cand_l, cand_r, region_l,
           region_r):
    """Bin both subsets and run both buffers' searches on the card: each
    Subset's x real[B, 3], type i32[B] and valid bool[B] as they are (B
    may differ between the sides), candidates real[K, 3], all contiguous
    on one CUDA device, real float32 or float64 alike on every input (the
    left candidates' dtype picks the instantiation; a mix raises).
    Returns (pos real[2, K, 3], accepted [2, K], iters [2, K])."""
    dtype = cand_l.dtype
    if dtype not in SUFFIX:
        raise ValueError(f"USHER kernel: no {dtype} instantiation (float32 "
                         f"or float64)")
    plan = UsherPlan.of(cfg, region_l, region_r, dtype)
    dev = cand_l.device
    k = cand_l.shape[0]
    for side, sub in (("left", sub_l), ("right", sub_r)):
        b = sub.x.shape[0]
        _check(f"{side} x", sub.x, dtype, (b, 3), dev)
        _check(f"{side} type", sub.type, torch.int32, (b,), dev)
        _check(f"{side} valid", sub.valid, torch.bool, (b,), dev)
    _check("left candidates", cand_l, dtype, (k, 3), dev)
    _check("right candidates", cand_r, dtype, (k, 3), dev)
    b_l, b_r = sub_l.x.shape[0], sub_r.x.shape[0]
    kern = _build.KERNELS[plan.name]
    fn = kern.function()
    u = cfg.obmd.usher
    per = cfg.box.periodic
    ly = float(cfg.box.lengths[1]) if per[1] else 0.0
    lz = float(cfg.box.lengths[2]) if per[2] else 0.0
    words = scratch_words(plan.grids, b_l, b_r, dtype)
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    pos = torch.empty((2, k, 3), dtype=dtype, device=dev)
    acc = torch.empty((2, k), dtype=torch.bool, device=dev)
    iters = torch.empty((2, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(sub_l.x.data_ptr(), sub_l.type.data_ptr(),
                sub_l.valid.data_ptr(), b_l, sub_r.x.data_ptr(),
                sub_r.type.data_ptr(), sub_r.valid.data_ptr(), b_r,
                cand_l.data_ptr(), cand_r.data_ptr(), k, scratch.data_ptr(),
                words, pos.data_ptr(), acc.data_ptr(), iters.data_ptr(),
                plan.cells, plan.grid, plan.bounds, plan.coef, plan.ntypes,
                int(u.nattempt), ly, lz, float(u.etarget + EPSILON),
                float(u.etarget), float(u.ds0), float(u.uovlp),
                float(u.dsovlp), float(4.0 * u.eps), EPSILON, stream)
    _build.check(rc, kern)
    kern.count(f"B{b_l},{b_r}")
    return pos, acc, iters


def usher_search(cfg, sub_l: Subset, sub_r: Subset, cand_l, cand_r,
                 region_l, region_r):
    """Both buffers' searches: (pos [2,K,3], accepted [2,K], iters [2,K]).
    A thermostat-only law (dpd/tstat, dpd/ext/tstat) has no kernel law: it
    searches with usher_search_subset_batch's PyTorch operations on every
    device, which is the JAX package's own path for it (its XLA search,
    obmd_tpu/engine_cellpad.py:566-577 and obmd/stage.py:419-421, at E = 0
    accepts every candidate at iteration 0), not a stand-in for a kernel."""
    no_law = usher_law(cfg.pair, int(cfg.obmd.ntype)) is None
    if cand_l.device.type == "cpu" or no_law:
        ctype = torch.full((cand_l.shape[0],), int(cfg.obmd.ntype),
                           dtype=torch.int32, device=cand_l.device)
        return usher_search_subset_batch(cfg, sub_l, sub_r, cand_l, cand_r,
                                         ctype, region_l, region_r)
    if cand_l.device.type != "cuda":
        raise ValueError(f"unsupported device {cand_l.device}")
    return launch(cfg, sub_l, sub_r, cand_l, cand_r, region_l, region_r)


# ---- the binned algorithm in PyTorch, for the tests (never on the main path)

def bin_rows(grid: UsherGrid, sub: Subset):
    """The kernel's binning: (valid row indices sorted by cell, ascending
    within a cell; each cell's start, [n_cells + 1])."""
    idx = torch.nonzero(sub.valid).flatten()
    cell = grid.cell_id(grid.cell3(sub.x[idx]))
    cell, order = torch.sort(cell, stable=True)
    start = torch.searchsorted(cell, torch.arange(grid.n_cells + 1,
                                                  device=cell.device))
    return idx[order], start


def usher_energy_binned_plain(cfg, grid: UsherGrid, sub: Subset, pos):
    """E [K], F [K, 3] of trial positions pos [K, 3] against the valid
    subset atoms in the cells the kernel visits (the 27-cell stencil of
    each position's cell, each cell once), through the plain law
    (obmd.subset._batched_energy_force)."""
    rows, start = bin_rows(grid, sub)
    ct = torch.full((1, 1), int(cfg.obmd.ntype), dtype=torch.int32,
                    device=pos.device)
    es, fs = [], []
    for p, c3 in zip(pos, grid.cell3(pos)):
        sel = torch.cat([rows[start[c]:start[c + 1]]
                         for c in grid.stencil_cells(c3.tolist())])
        ok = torch.ones((1, sel.shape[0]), dtype=torch.bool,
                        device=pos.device)
        e, f = _batched_energy_force(cfg.pair, sub.x[sel][None],
                                     sub.type[sel][None], ok, p[None, None],
                                     ct, box=cfg.box)
        es.append(e[0, 0])
        fs.append(f[0, 0])
    return torch.stack(es), torch.stack(fs)


def usher_search_binned_plain(cfg, sub_l: Subset, sub_r: Subset, cand_l,
                              cand_r, region_l, region_r):
    """usher_search_subset_batch's step rule over usher_energy_binned_plain:
    (pos [2,K,3], accepted [2,K], iters [2,K] i32)."""
    u = cfg.obmd.usher
    grids = UsherPlan.of(cfg, region_l, region_r, cand_l.dtype).grids
    subs = (sub_l, sub_r)
    pos = torch.stack([cand_l, cand_r])
    dtype = pos.dtype
    lo = torch.tensor([region_l.lo, region_r.lo], dtype=dtype)[:, None, :]
    hi = torch.tensor([region_l.hi, region_r.hi], dtype=dtype)[:, None, :]
    k = cand_l.shape[0]
    active = torch.ones((2, k), dtype=torch.bool)
    accepted = torch.zeros((2, k), dtype=torch.bool)
    iters = torch.zeros((2, k), dtype=torch.int32)

    rows = max(sub_l.x.shape[0], sub_r.x.shape[0]) > 0

    def energy(pos):
        ef = [usher_energy_binned_plain(cfg, grids[s], subs[s], pos[s])
              for s in range(2)]
        f = torch.stack([f for _, f in ef])
        # the kernel's force of a non-finite candidate: NaN, as the plain
        # version's 0 x inf over the padded rows gives
        bad = ~torch.isfinite(pos).all(-1)[..., None] & rows
        return (torch.stack([e for e, _ in ef]),
                torch.where(bad, torch.nan, f))
    for _ in range(u.nattempt):
        if not bool(active.any()):
            break
        E, F = energy(pos)
        ok = E < u.etarget + EPSILON
        newly = active & ok
        fabs = torch.sqrt((F * F).sum(-1))
        degen = fabs < EPSILON
        ds_ovlp = u.dsovlp - (4.0 * u.eps
                              / torch.clamp(E, min=EPSILON)) ** (1.0 / 12.0)
        ds_norm = torch.clamp((E - u.etarget) / torch.clamp(fabs, min=EPSILON),
                              max=u.ds0)
        ds = torch.where(E > u.uovlp, ds_ovlp, ds_norm)
        moved = pos + F / torch.clamp(fabs, min=EPSILON)[..., None] \
            * ds[..., None]
        ins = torch.all((moved >= lo) & (moved <= hi), dim=-1)
        move_now = active & ~ok & ~degen
        pos = torch.where(move_now[..., None], moved, pos)
        stopped = newly | (active & degen) | (move_now & ~ins)
        active = active & ~stopped
        accepted = accepted | newly
        iters = iters + active.to(torch.int32)
    E, _ = energy(pos)
    accepted = accepted | (active & (E < u.etarget + EPSILON))
    return pos, accepted, iters
