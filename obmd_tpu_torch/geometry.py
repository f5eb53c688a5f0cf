"""Box geometry, periodic wrapping, minimum image and axis-aligned regions.

PyTorch counterpart of `obmd_tpu/geometry.py` (`Box`, `RegionBlock`), kept
as its own copy so the port never imports the JAX package.  The formulas are
the reference's op for op, so positions wrap and fold bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def const(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small read-only constant tensor, made once per (values, dtype,
    device): the hot path would otherwise copy it host-to-device on every
    call."""
    return torch.tensor(values, dtype=dtype, device=device)


def const_like(values, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return const(tuple(values), dtype or like.dtype, like.device)


def cell_index(x: torch.Tensor, lo, cell_size, dims) -> torch.Tensor:
    """Linear cell id (int32) of [..., 3] positions on a grid of `dims`
    cells of `cell_size` from `lo`, clipped to the grid.  The division by
    the cell size is a multiplication by its float32 reciprocal, as the
    reference's compiled code computes it (XLA turns a division by a
    float32 constant into one), so an atom within rounding of a cell face
    is filed alike."""
    inv = [float(np.float32(1.0) / np.float32(c)) for c in cell_size]
    top = const_like([d - 1 for d in dims], x, torch.int32)
    c = torch.floor((x - const_like(lo, x)) * const_like(inv, x))
    c = torch.minimum(torch.clamp(c.to(torch.int32), min=0), top)
    nx, ny, nz = dims
    return (c[..., 0] * ny + c[..., 1]) * nz + c[..., 2]


@dataclasses.dataclass(frozen=True)
class Box:
    """Orthogonal box; OBMD runs (False, True, True): open x, periodic y/z."""

    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]
    periodic: Tuple[bool, bool, bool] = (False, True, True)

    @property
    def lengths(self) -> Tuple[float, float, float]:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    @property
    def volume(self) -> float:
        lx, ly, lz = self.lengths
        return lx * ly * lz

    @property
    def cross_area(self) -> float:
        """Area of the x-normal face (Ly*Lz)."""
        _, ly, lz = self.lengths
        return ly * lz

    def wrap(self, x: torch.Tensor) -> torch.Tensor:
        """Wrap [..., 3] positions into the box along periodic axes only."""
        lo = const_like(self.lo, x)
        length = const_like(self.lengths, x)
        per = const_like(self.periodic, x, torch.bool)
        wrapped = lo + torch.remainder(x - lo, length)
        return torch.where(per, wrapped, x)

    def min_image(self, d: torch.Tensor) -> torch.Tensor:
        """Minimum image of [..., 3] displacements on periodic axes."""
        length = const_like(self.lengths, d)
        per = const_like(self.periodic, d, torch.bool)
        folded = d - length * torch.round(d / length)
        return torch.where(per, folded, d)


@dataclasses.dataclass(frozen=True)
class RegionBlock:
    """Axis-aligned block with inclusive bounds (region_block.cpp:289)."""

    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]

    def match(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., 3] -> bool[...]."""
        lo = const_like(self.lo, x)
        hi = const_like(self.hi, x)
        return torch.all((x >= lo) & (x <= hi), dim=-1)

    def sample_uniform(self, u: torch.Tensor) -> torch.Tensor:
        """Map uniform [0, 1) triples [..., 3] into the block."""
        lo = const_like(self.lo, u)
        hi = const_like(self.hi, u)
        return lo + u * (hi - lo)
