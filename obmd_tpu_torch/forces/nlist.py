"""The [N, K] Verlet-list force of the nlist engine.

Counterpart of `nlist_sweep` in `obmd_tpu/forces/nlist.py`: each slot sums
the forces of the pairs in its row (both halves of every pair are computed,
so there is no scatter; Newton's third law holds through the pair-symmetric
noise).  A neighbour that died since the build is masked by `alive`, a pair
beyond the force cutoff by the law, and on a bonded scene the 1-2 pairs by
the partner slots.  It is array code in the JAX package too (no TPU
kernel), so it runs as these PyTorch operations on every device: the
neighbour columns are gathered in two passes (x and v as one float row,
tag and type | alive << 29 as two ints), then the law runs on [N, K]
arrays.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..cells import BIG
from ..config import LJCutRFParams
from ..geometry import Box
from .pairs import PairFields, apply_pair_law, make_pair_law

_PAIRS6 = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def _gather_rows(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """arr [N, C] rows at idx [N, K] (N -> fill): [N, K, C]."""
    pad = torch.full((1, arr.shape[1]), fill, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([arr, pad])[idx.long()]


def nlist_sweep(params, box: Box, nlist, x, v, types, tag, q, alive, salt, *,
                dt: float, bond1=None, bond2=None, more_bonds=(),
                sig_scale: Optional[float] = None,
                compute_energy: bool = False,
                compute_virial: bool = False,
                compute_virial_atom: bool = False) -> PairFields:
    """Forces (and optionally per-atom pe, the global virial and per-atom
    virial shares, as forces.pairs.pair_sweep gives them) from the list
    nlist [N, K].  bond1, bond2 and more_bonds hold partner slots: their
    pairs are left out (`special_bonds` 1-2 exclusion)."""
    n = x.shape[0]
    pair_fn = make_pair_law(params, dt, x.dtype, x.device)
    idx = nlist.long()
    g = _gather_rows(torch.cat([x, v], dim=1), idx, 0.0)
    inside = idx < n
    xj = torch.where(inside[..., None], g[..., 0:3], BIG)
    vj = g[..., 3:6]
    ints = _gather_rows(torch.stack(
        [tag, types.to(torch.int32) | (alive.to(torch.int32) << 29)], dim=1),
        idx, 0)
    gj, meta = ints[..., 0], ints[..., 1]
    tj = meta & 0xFFFF
    aj = ((meta >> 29) & 1) > 0

    d = box.min_image(x[:, None, :] - xj)
    dv = v[:, None, :] - vj
    rsq = (d * d).sum(-1)
    valid = aj & alive[:, None] & inside
    if bond1 is not None:
        for b in (bond1, bond2) + tuple(more_bonds):
            valid = valid & (nlist != b[:, None])
    kw = {}
    if isinstance(params, LJCutRFParams):
        qj = _gather_rows(q[:, None], idx, 0.0)[..., 0]
        kw = dict(qi=q[:, None], qj=qj)
    if sig_scale is not None:
        kw["sig_scale"] = sig_scale
    fvec, e = apply_pair_law(params, pair_fn, rsq, d, dv, types[:, None], tj,
                             tag[:, None], gj, salt, **kw)
    fvec = torch.where(valid[..., None], fvec, 0.0)
    pe = w = wa = None
    if compute_energy:
        pe = 0.5 * torch.where(valid, e, 0.0).sum(1)
    if compute_virial:
        w = 0.5 * torch.stack([(d[..., a] * fvec[..., b]).sum()
                               for a, b in _PAIRS6])
    if compute_virial_atom:
        wa = 0.5 * torch.stack([(d[..., a] * fvec[..., b]).sum(1)
                                for a, b in _PAIRS6], dim=-1)
    return PairFields(f=fvec.sum(1), pe=pe, virial=w, virial_atom=wa)
