"""Box geometry, periodic wrapping, minimum image and axis-aligned regions.

PyTorch counterpart of `obmd_tpu/geometry.py` (`Box`, `RegionBlock`,
`RegionSphere`, `RegionCylinder`), kept as its own copy so the port never
imports the JAX package.  The formulas are
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


# the numpy scalar type of each float dtype a scene may take
# (SceneConfig.dtype: "float32" or "float64")
_REAL = {torch.float32: np.float32, torch.float64: np.float64}


def real_type(dtype: torch.dtype) -> type:
    """The numpy scalar type of a scene's float dtype."""
    return _REAL[dtype]


def rounded(v, dtype: torch.dtype) -> float:
    """The host value v rounded to `dtype`, as a python float: the constant
    the JAX package builds with `dtype(v)` in a state of that dtype."""
    return float(_REAL[dtype](v))


def reciprocals(values, dtype: torch.dtype) -> list:
    """1 / v of each value, computed in `dtype` (the reciprocal XLA
    multiplies by where the JAX package divides by a constant of the
    array's dtype), as python floats."""
    real = _REAL[dtype]
    return [float(real(1.0) / real(v)) for v in values]


def cell_index(x: torch.Tensor, lo, cell_size, dims) -> torch.Tensor:
    """Linear cell id (int32) of [..., 3] positions on a grid of `dims`
    cells of `cell_size` from `lo`, clipped to the grid.  The division by
    the cell size is a multiplication by its reciprocal in x's dtype, as
    the reference's compiled code computes it (XLA turns a division by a
    constant of the array's dtype into one), so an atom within rounding of
    a cell face is filed alike at float32 and at float64."""
    inv = reciprocals(cell_size, x.dtype)
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


@dataclasses.dataclass(frozen=True)
class RegionSphere:
    """`region ID sphere x y z R` (region_sphere.cpp::inside): a point
    matches when its distance from the center is <= R, inclusive like
    every LAMMPS region.  The deck front end fills it with create_atoms;
    fix obmd's six regions stay blocks."""

    center: Tuple[float, float, float]
    radius: float

    def match(self, x: torch.Tensor) -> torch.Tensor:
        d = x - const_like(self.center, x)
        r2 = torch.full((), self.radius * self.radius, dtype=x.dtype,
                        device=x.device)
        return torch.sum(d * d, dim=-1) <= r2

    @property
    def lo(self) -> Tuple[float, float, float]:
        return tuple(c - self.radius for c in self.center)

    @property
    def hi(self) -> Tuple[float, float, float]:
        return tuple(c + self.radius for c in self.center)

    @property
    def volume(self) -> float:
        return 4.0 / 3.0 * np.pi * self.radius ** 3


@dataclasses.dataclass(frozen=True)
class RegionCylinder:
    """`region ID cylinder dim c1 c2 radius lo hi`
    (region_cylinder.cpp::inside): a cylinder along `axis` ('x', 'y' or
    'z'); (c1, c2) is the center in the other two dimensions in x, y, z
    order, LAMMPS' argument convention.  Inclusive bounds."""

    axis: str
    c1: float
    c2: float
    radius: float
    lo_axis: float
    hi_axis: float

    def __post_init__(self):
        if self.axis not in ("x", "y", "z"):
            raise ValueError("cylinder axis must be x, y or z")

    def _dims(self):
        ax = "xyz".index(self.axis)
        return ax, [d for d in range(3) if d != ax]

    def match(self, x: torch.Tensor) -> torch.Tensor:
        ax, (d1, d2) = self._dims()

        def c(v):
            return torch.full((), v, dtype=x.dtype, device=x.device)
        e1 = x[..., d1] - c(self.c1)
        e2 = x[..., d2] - c(self.c2)
        a = x[..., ax]
        return ((e1 * e1 + e2 * e2 <= c(self.radius * self.radius))
                & (a >= c(self.lo_axis)) & (a <= c(self.hi_axis)))

    def _bounds(self, axis_value: float, sign: float):
        ax, (d1, d2) = self._dims()
        out = [0.0, 0.0, 0.0]
        out[ax] = axis_value
        out[d1] = self.c1 + sign * self.radius
        out[d2] = self.c2 + sign * self.radius
        return tuple(out)

    @property
    def lo(self) -> Tuple[float, float, float]:
        return self._bounds(self.lo_axis, -1.0)

    @property
    def hi(self) -> Tuple[float, float, float]:
        return self._bounds(self.hi_axis, 1.0)

    @property
    def volume(self) -> float:
        return np.pi * self.radius ** 2 * max(self.hi_axis - self.lo_axis,
                                              0.0)
