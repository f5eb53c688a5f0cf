"""The stencil gather of the neighbor-list engine.

Counterpart of `neighbor_slots` in `obmd_tpu/forces/gathered.py`: the slot
ids of every atom filed in the (up to 27) distinct stencil cells around a
position, the candidates the Verlet list is built from
(neighbors.candidate_slots).  `forces_for_subset`, the multi-device force
path, is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cells import CellTable, GridSpec
from ..geometry import const_like


def _axis_offsets(n: int, periodic: bool):
    """The distinct stencil offsets along one axis: a periodic axis of
    fewer than 3 cells would visit one cell twice under the modulo
    (obmd_tpu/forces/gathered.py:22-33); an open axis is masked by range
    instead."""
    if periodic and n == 1:
        return (0,)
    if periodic and n == 2:
        return (0, 1)
    return (-1, 0, 1)


def stencil_offsets(spec: GridSpec):
    """[(dx, dy, dz)] of the stencil, x slowest."""
    dims, per = spec.dims, spec.periodic
    return [(a, b, c) for a in _axis_offsets(dims[0], per[0])
            for b in _axis_offsets(dims[1], per[1])
            for c in _axis_offsets(dims[2], per[2])]


def neighbor_slots(spec: GridSpec, ctab: CellTable,
                   pos: torch.Tensor) -> torch.Tensor:
    """[P, S * cap] slot ids of the atoms in the S distinct stencil cells
    around each position pos [P, 3] (N for an empty entry), cell by cell
    in stencil order.  A position files into its cell by the float32
    reciprocal of the cell side, clipped to the grid, as
    cells.GridSpec.cell_of files atoms."""
    dims = spec.dims
    inv = [float(np.float32(1.0) / np.float32(c)) for c in spec.cell_size]
    nd = const_like(dims, pos, torch.int64)
    cc = torch.floor((pos - const_like(spec.lo, pos))
                     * const_like(inv, pos)).to(torch.int64)
    cc = torch.minimum(torch.clamp(cc, min=0), nd - 1)
    offs = const_like([v for o in stencil_offsets(spec) for v in o], pos,
                      torch.int64).reshape(-1, 3)
    nb = cc[:, None, :] + offs[None, :, :]
    per = const_like(spec.periodic, pos, torch.bool)
    ok = torch.all(per | ((nb >= 0) & (nb < nd)), dim=-1)
    nb = torch.where(per, torch.remainder(nb, nd), nb)
    lin = (nb[..., 0] * dims[1] + nb[..., 1]) * dims[2] + nb[..., 2]
    lin = torch.where(ok, lin, spec.n_cells)
    return ctab.table[lin].reshape(pos.shape[0], -1)
