"""Buffer subsets, the batched USHER search and the `near` check in
PyTorch.

Counterpart of `obmd_tpu/obmd/subset.py` for ATOM-mode insertion: `Subset`,
`expand_region`, the DPD, lj/cut and lj/cut/rf branches of
`_batched_energy_force` (`conservative_energy_force`; ATOM-mode trials are
neutral, so lj/cut/rf's reaction field adds nothing to a trial's energy),
`usher_search_subset_batch` and `near_check_subset`, op for op.  Candidates only ever sit inside an
insertion region, so the atoms that can contribute are those within
cut + skin of it; the search runs brute force against that subset.  This is
the plain version of the USHER kernel (forces/usher_kernel.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..cells import BIG
from ..config import DPDParams, LJCutParams, LJCutRFParams, SceneConfig
from ..forces.pairs import make_pair_law
from ..geometry import RegionBlock, const_like

EPSILON = 1.0e-6


class Subset(NamedTuple):
    x: torch.Tensor         # [B,3] (BIG for padding)
    type: torch.Tensor      # [B] i32
    valid: torch.Tensor     # [B] bool
    overflow: torch.Tensor  # 0-dim bool: more region atoms than B
    q: Optional[torch.Tensor] = None   # [B] charges (None: a neutral scene)


def expand_region(region: RegionBlock, pad: float) -> RegionBlock:
    return RegionBlock(tuple(l - pad for l in region.lo),
                       tuple(h + pad for h in region.hi))


def _batched_energy_force(pair, sub_x, sub_type, sub_valid, pos, cand_type,
                          box=None, sub_q=None):
    """sub_* [S,B,...], pos [S,K,3], cand_type [S,K] -> E [S,K], F [S,K,3]
    (DPD: E = 0.5*a0*rc*wd^2, F = a0*wd*rhat; lj/cut and lj/cut/rf: the
    pair law of forces/pairs.make_pair_law, the trials neutral against the
    subset's charges sub_q [S,B], zero when None)."""
    d = pos[:, :, None, :] - sub_x[:, None, :, :]          # [S,K,B,3]
    if box is not None:
        d = box.min_image(d)
    rsq = (d * d).sum(-1)
    ok = sub_valid[:, None, :]
    if isinstance(pair, DPDParams):
        a0 = const_like([v for row in pair.a0 for v in row], pos)
        cut = const_like([v for row in pair.cut for v in row], pos)
        if a0.shape[0] == 1:
            a0v, cutv = a0[0], cut[0]
        else:
            nt = pair.ntypes
            flat = (cand_type[:, :, None] * nt + sub_type[:, None, :]).long()
            a0v, cutv = a0[flat], cut[flat]
        r = torch.sqrt(rsq)
        rinv = torch.where(r > 1e-10, 1.0 / torch.clamp(r, min=1e-10), 0.0)
        wd = 1.0 - r / cutv
        inr = ok & (rsq < cutv * cutv) & (r > 1e-10)
        e = torch.where(inr, 0.5 * a0v * cutv * wd * wd, 0.0)
        fp = torch.where(inr, a0v * wd * rinv, 0.0)
    elif isinstance(pair, (LJCutParams, LJCutRFParams)):
        pair_fn = make_pair_law(pair, 1.0, pos.dtype, pos.device)
        kw = {}
        if isinstance(pair, LJCutRFParams):
            qj = torch.zeros_like(sub_x[..., 0]) if sub_q is None else sub_q
            kw = dict(qi=torch.zeros_like(pos[:, :, None, 0]),
                      qj=qj[:, None, :])
        zero = torch.zeros((), dtype=torch.int32, device=pos.device)
        fp, e = pair_fn(rsq, d, torch.zeros_like(d), cand_type[:, :, None],
                        sub_type[:, None, :], zero, zero, 0, **kw)
        fp = torch.where(ok, fp, 0.0)
        e = torch.where(ok, e, 0.0)
    else:
        raise NotImplementedError(
            f"USHER: the {type(pair).__name__} law is not ported")
    return e.sum(-1), (fp[..., None] * d).sum(2)


def pad_subset(sub: Subset, b: int) -> Subset:
    """Pad a subset to b rows (slice-derived subsets can differ by a
    block)."""
    pad = b - sub.x.shape[0]
    if pad == 0:
        return sub
    dev = sub.x.device
    return Subset(
        x=torch.cat([sub.x, torch.full((pad, 3), BIG, dtype=sub.x.dtype,
                                       device=dev)]),
        type=torch.cat([sub.type, torch.zeros((pad,), dtype=sub.type.dtype,
                                              device=dev)]),
        valid=torch.cat([sub.valid, torch.zeros((pad,), dtype=torch.bool,
                                                device=dev)]),
        overflow=sub.overflow,
        q=None if sub.q is None else torch.cat([
            sub.q, torch.zeros((pad,), dtype=sub.q.dtype, device=dev)]))


def usher_search_subset_batch(cfg: SceneConfig, sub_l: Subset, sub_r: Subset,
                              cand_l, cand_r, cand_type,
                              region_l: RegionBlock, region_r: RegionBlock):
    """USHER over both buffers at once (ref fix_obmd_merged.cpp:1518-1616):
    E < etarget + eps accepts; E > uovlp takes the overlap step, else
    ds = min((E - etarget)/|F|, ds0); leaving the region or a degenerate
    force rejects; a post-loop energy check accepts candidates still below
    target.  Returns (pos [2,K,3], accepted [2,K], iters [2,K] i32)."""
    u = cfg.obmd.usher
    dtype = cand_l.dtype
    b = max(sub_l.x.shape[0], sub_r.x.shape[0])
    sub_l, sub_r = pad_subset(sub_l, b), pad_subset(sub_r, b)
    sub_x = torch.stack([sub_l.x, sub_r.x])
    sub_t = torch.stack([sub_l.type, sub_r.type])
    sub_v = torch.stack([sub_l.valid, sub_r.valid])
    sub_q = (None if sub_l.q is None or sub_r.q is None
             else torch.stack([sub_l.q, sub_r.q]))
    pos = torch.stack([cand_l, cand_r])
    ct = torch.stack([cand_type, cand_type])
    lo = torch.tensor([region_l.lo, region_r.lo], dtype=dtype,
                      device=pos.device)[:, None, :]
    hi = torch.tensor([region_l.hi, region_r.hi], dtype=dtype,
                      device=pos.device)[:, None, :]
    k = cand_l.shape[0]
    active = torch.ones((2, k), dtype=torch.bool, device=pos.device)
    accepted = torch.zeros((2, k), dtype=torch.bool, device=pos.device)
    iters = torch.zeros((2, k), dtype=torch.int32, device=pos.device)
    for _ in range(u.nattempt):
        E, F = _batched_energy_force(cfg.pair, sub_x, sub_t, sub_v, pos, ct,
                                     box=cfg.box, sub_q=sub_q)
        ok = E < u.etarget + EPSILON
        newly = active & ok
        fabs = torch.sqrt((F * F).sum(-1))
        degen = fabs < EPSILON
        ds_ovlp = u.dsovlp - (4.0 * u.eps
                              / torch.clamp(E, min=EPSILON)) ** (1.0 / 12.0)
        ds_norm = torch.clamp((E - u.etarget) / torch.clamp(fabs, min=EPSILON),
                              max=u.ds0)
        ds = torch.where(E > u.uovlp, ds_ovlp, ds_norm)
        unit = F / torch.clamp(fabs, min=EPSILON)[..., None]
        moved = pos + unit * ds[..., None]
        ins = torch.all((moved >= lo) & (moved <= hi), dim=-1)
        move_now = active & ~ok & ~degen
        pos = torch.where(move_now[..., None], moved, pos)
        stopped = newly | (active & degen) | (move_now & ~ins)
        active = active & ~stopped
        accepted = accepted | newly
        iters = iters + active.to(torch.int32)
    E, _ = _batched_energy_force(cfg.pair, sub_x, sub_t, sub_v, pos, ct,
                                 box=cfg.box, sub_q=sub_q)
    accepted = accepted | (active & (E < u.etarget + EPSILON))
    return pos, accepted, iters


def near_squared(cfg: SceneConfig) -> float:
    """The `near` distance squared as the float32 value a float32 distance
    is compared with (JAX compares with the weakly typed python float
    near**2, which it rounds to float32)."""
    return float(np.float32(cfg.obmd.near ** 2))


def near_check_subset(cfg: SceneConfig, sub: Subset, cand_x):
    """`near` insertion's check (ref fix_obmd_merged.cpp near branch): a
    candidate is ok when its minimum-image distance to every valid subset
    atom is at least `near`.  cand_x [K, 3] -> ok [K] bool."""
    d = cfg.box.min_image(cand_x[:, None, :] - sub.x[None, :, :])
    rsq = (d * d).sum(-1)
    min_rsq = torch.where(sub.valid[None, :], rsq, torch.inf).min(-1).values
    return min_rsq >= near_squared(cfg)
