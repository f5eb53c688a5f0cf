"""Cell-grid binning for the pair sweep (the semantics reference path).

Counterpart of `obmd_tpu/cells.py`: atoms are binned into a dense
[n_cells + 1, capacity] table of slot indices (the last row is the trash
row, sentinel N marks an empty entry), built as stable sort + rank in cell +
scatter so every shape is static.  The sweep over this table
(`forces/pairs.pair_sweep`) is what thermo and profiles run on, and what the
cellpad kernels are held against.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .geometry import Box, cell_index

# Sentinel coordinate for empty slots: large but finite, so padded-vs-real
# displacements stay finite and drop out of every cutoff test.
BIG = 1.0e8


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static cell-grid geometry derived from (box, cutoff)."""

    dims: Tuple[int, int, int]
    cell_size: Tuple[float, float, float]
    lo: Tuple[float, float, float]
    periodic: Tuple[bool, bool, bool]
    capacity: int

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz

    @staticmethod
    def create(box: Box, cutoff: float, capacity: int) -> "GridSpec":
        dims = []
        csize = []
        for L in box.lengths:
            # a periodic axis of 2 cells is kept: stencil_neighbors dedupes
            n = max(1, int(np.floor(L / cutoff)))
            dims.append(n)
            csize.append(L / n)
        return GridSpec(dims=tuple(dims), cell_size=tuple(csize),
                        lo=box.lo, periodic=box.periodic, capacity=capacity)

    def stencil_neighbors(self) -> np.ndarray:
        """[27, n_cells] int32: linear cell id of each stencil neighbour of
        each cell; `n_cells` marks a neighbour outside an open axis.  Two
        offsets that reach the same cell (a periodic axis of < 3 cells) keep
        one copy, the central offset (index 13) first, since the sweep masks
        self pairs on that offset only."""
        nx, ny, nz = self.dims
        n_cells = self.n_cells
        cx, cy, cz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                 indexing="ij")
        cx, cy, cz = cx.ravel(), cy.ravel(), cz.ravel()
        offs = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for dz in (-1, 0, 1)]
        out = np.empty((len(offs), n_cells), dtype=np.int32)
        for k, (dx, dy, dz) in enumerate(offs):
            ids = []
            invalid = np.zeros(n_cells, dtype=bool)
            for d, c, n, per in ((dx, cx, nx, self.periodic[0]),
                                 (dy, cy, ny, self.periodic[1]),
                                 (dz, cz, nz, self.periodic[2])):
                nc = c + d
                if per:
                    nc = nc % n
                else:
                    invalid |= (nc < 0) | (nc >= n)
                ids.append(nc)
            ix, iy, iz = ids
            out[k] = np.where(invalid, n_cells, (ix * ny + iy) * nz + iz)
        order = [13] + [k for k in range(len(offs)) if k != 13]
        for pos, k in enumerate(order):
            for kk in order[:pos]:
                dup = (out[k] == out[kk]) & (out[k] != n_cells)
                out[k] = np.where(dup, n_cells, out[k])
        return out

    def cell_of(self, x: torch.Tensor) -> torch.Tensor:
        """Linear cell id (int32) of [..., 3] positions, clipped to the
        grid (geometry.cell_index)."""
        return cell_index(x, self.lo, self.cell_size, self.dims)


@dataclasses.dataclass
class CellTable:
    """table[c, r] in [0, N]: slot of the r-th atom of cell c, or N (empty).
    overflow counts atoms that did not fit their cell."""

    table: torch.Tensor      # [n_cells + 1, capacity] i32 (last row = trash)
    overflow: torch.Tensor   # i32 scalar


def build_cells(spec: GridSpec, x: torch.Tensor,
                alive: torch.Tensor) -> CellTable:
    """Bin atoms by position; dead atoms go to the trash row."""
    n = x.shape[0]
    n_cells = spec.n_cells
    cap = spec.capacity
    dev = x.device
    cell = torch.where(alive, spec.cell_of(x), n_cells)
    order = torch.sort(cell, stable=True).indices
    sorted_cell = cell[order].contiguous()
    start = torch.searchsorted(sorted_cell, sorted_cell, side="left")
    rank = torch.arange(n, dtype=torch.int64, device=dev) - start
    in_grid = sorted_cell < n_cells
    fits = rank < cap
    overflow = (in_grid & ~fits).sum(dtype=torch.int32)
    keep = in_grid & fits
    dest_cell = torch.where(keep, sorted_cell.long(), n_cells)
    dest_rank = torch.where(keep, rank, cap - 1)
    table = torch.full(((n_cells + 1) * cap,), n, dtype=torch.int32,
                       device=dev)
    table[dest_cell * cap + dest_rank] = order.to(torch.int32)
    table = table.reshape(n_cells + 1, cap)
    table[n_cells] = n
    return CellTable(table=table, overflow=overflow)


def gather_padded(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """Rows of `arr` [N, ...] at `idx` (values in [0, N]; N -> `fill`)."""
    pad = torch.full((1,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([arr, pad], dim=0)[idx.long()]
