"""The stencil gather and the per-atom neighbour-gather force path.

Counterpart of `obmd_tpu/forces/gathered.py`: `neighbor_slots`, the slot
ids of every atom filed in the (up to 27) distinct stencil cells around a
position (the candidates the Verlet list is built from,
neighbors.candidate_slots), and `forces_for_subset`, the forces on a subset
of atoms against the whole system through the cell table, the force path
of the multi-device steps (parallel/atom_decomp.py, parallel/slab_decomp.py:
each device computes the forces on the atoms it owns, both sides of every
pair, so no reverse pass is needed).  The JAX function packs its gathered
columns into one float32 row with the integer columns exponent-biased
(obmd_tpu/forces/gathered.py:91-104), since the TPU flushes denormals in
transit; here each column is gathered as it is, with the same result.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..cells import BIG, CellTable, GridSpec
from ..config import LJCutRFParams
from ..geometry import const_like, reciprocals
from .pairs import apply_pair_law, make_pair_law

# rows of the subset gathered at a time: bounds the [rows, S * cap]
# temporaries of a full-width slab (S * cap ~ 730 columns)
_ROWS = 16384


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
    in stencil order.  A position files into its cell by the reciprocal of
    the cell side in its dtype, clipped to the grid, as
    cells.GridSpec.cell_of files atoms."""
    dims = spec.dims
    inv = reciprocals(spec.cell_size, pos.dtype)
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


def forces_for_subset(params, box, spec: GridSpec, ctab: CellTable,
                      full_x, full_v, full_type, full_tag, full_q, my_slot,
                      my_x, my_v, my_type, my_tag, my_q, salt: int, *,
                      dt: float, my_pb: Optional[torch.Tensor] = None,
                      bond=None, sig_scale: Optional[float] = None):
    """Forces f [K, 3] and energies pe [K] (half of each counted pair's) on
    `my` K atoms, whose slots among the full arrays are my_slot [K],
    against the full system (full_* [N, ...], filed in ctab on spec):
    the pair law on every stencil neighbour but the atom itself (by slot),
    with the noise of the step's salt and, for a dpd/tstat ramp, sig_scale.

    my_pb [K, P]: the partner TAGS of my atoms (-1 for none; P = 2 on
    chains, 4 on branched topologies).  A neighbour whose tag is a partner
    tag is a 1-2 pair: left out of the pair law and, when `bond` is given,
    counted with the bond force instead (the slab path finds partners by
    position among owned and halo atoms, so a bond across a slab face
    needs no slot)."""
    charged = isinstance(params, LJCutRFParams)
    pair_fn = make_pair_law(params, dt, full_x.dtype, full_x.device)
    near2 = (params.max_cut * 1.001) ** 2
    n_full = full_x.shape[0]
    f_parts, pe_parts = [my_x.new_zeros((0, 3))], [my_x.new_zeros((0,))]
    for a in range(0, my_x.shape[0], _ROWS):
        rows = slice(a, a + _ROWS)
        jdx = neighbor_slots(spec, ctab, my_x[rows])          # [K, M]
        shape = jdx.shape
        # the filled entries only (an empty entry holds N): each pair's
        # columns gathered once, the law on the pairs within (a hair over)
        # the largest cut (zero beyond its own), the results laid back on
        # the [K, M] grid so that each row sums its columns in order,
        # zeros included
        ii, cc = (jdx < n_full).nonzero(as_tuple=True)
        j = jdx[ii, cc].long()
        i = ii + a
        xj = full_x[j]
        d = box.min_image(my_x[i] - xj)
        rsq = (d * d).sum(-1)
        valid = (xj[:, 0] < BIG * 0.5) & (j != my_slot[i])
        gj = full_tag[j]
        isb = None
        valid_pair = valid
        if my_pb is not None:
            isb = torch.zeros_like(valid)
            for c in range(my_pb.shape[1]):
                isb = isb | (gj == my_pb[i, c])
            isb = valid & isb
            valid_pair = valid & ~isb
        k = (valid_pair & (rsq < near2)).nonzero(as_tuple=True)[0]
        kw = {}
        if charged:
            kw = dict(qi=my_q[i[k]], qj=full_q[j[k]])
        if sig_scale is not None:
            kw["sig_scale"] = sig_scale
        fv, ev = apply_pair_law(params, pair_fn, rsq[k], d[k],
                                my_v[i[k]] - full_v[j[k]], my_type[i[k]],
                                full_type[j[k]], my_tag[i[k]], gj[k], salt,
                                **kw)
        fvec = torch.zeros(shape + (3,), dtype=d.dtype, device=d.device)
        fvec[ii[k], cc[k]] = fv
        e = torch.zeros(shape, dtype=d.dtype, device=d.device)
        e[ii[k], cc[k]] = ev
        f = fvec.sum(1)
        pe = 0.5 * e.sum(1)
        if isb is not None and bond is not None:
            from .bonded import bond_pair_fvec
            b = isb.nonzero(as_tuple=True)[0]
            fb = torch.zeros(shape + (3,), dtype=d.dtype, device=d.device)
            fb[ii[b], cc[b]] = bond_pair_fvec(bond, rsq[b], d[b])
            f = f + fb.sum(1)
        f_parts.append(f)
        pe_parts.append(pe)
    return torch.cat(f_parts), torch.cat(pe_parts)
