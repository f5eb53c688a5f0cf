"""Pieces of the OBMD open-boundary stage used by the cellpad engine.

Counterpart of the uniform-candidate part of `obmd_tpu/obmd/stage.py`:
`delete_outside` (the full-store deletion with MOLECULE mode's doom
propagation), `feedback_count`, `smooth_weight`, `_sequential_accept`
(USHER's energy criterion or `near`'s distance), `draw_candidates`,
`rounds_of` and `insertion_tag_base`.  Inserted atoms are at rest (the
reference's `draw_inserted_velocities` without velocity keywords, ref
:1076-1078).
"""
from __future__ import annotations

import math

import torch

from ..config import DPDParams, LJCutParams, LJCutRFParams, SceneConfig
from ..geometry import const, const_like
from .subset import near_squared

EPSILON = 1.0e-6  # reference EPSILON (fix_obmd_merged.cpp:62)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A parameter as a float32 scalar tensor on `like`'s device (cached, so
    no host-to-device copy per call; a tensor, not a python number, so that
    a division by it is a true division on the card too, where PyTorch
    turns division by a host scalar into multiplication by its
    reciprocal)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return const((float(v),), torch.float32, like.device)[0]


def delete_outside(cfg: SceneConfig, state):
    """Delete every alive atom beyond the open x faces over the whole store
    and tally sum(m v) by side (left when x < the box's x middle, ref
    :827-833).  In MOLECULE mode the doom spreads along the bond-partner
    slot columns for mol_natoms_max - 1 rounds, so a molecule with any atom
    outside goes whole (ref :709-821).  Dead slots keep v = 0 and tag -1;
    their partner columns are left as they were."""
    from ..state import per_atom_mass
    box = cfg.box
    x0 = state.x[:, 0]
    doomed = state.alive & ((x0 < box.lo[0]) | (x0 > box.hi[0]))
    if cfg.obmd is not None and cfg.obmd.mol is not None:
        n = state.capacity
        for _ in range(max(cfg.obmd.mol_natoms_max - 1, 1)):
            for partner in state.bond_partners:
                ps = torch.clamp(partner.long(), 0, n - 1)
                doomed = doomed | (state.alive & (partner >= 0) & doomed[ps])
    left = doomed & (x0 < 0.5 * (box.lo[0] + box.hi[0]))
    right = doomed & ~left
    mv = per_atom_mass(cfg, state)[:, None] * state.v
    vnewl = torch.where(left[:, None], mv, 0.0).sum(0)
    vnewr = torch.where(right[:, None], mv, 0.0).sum(0)
    state = state.replace(
        alive=state.alive & ~doomed,
        tag=torch.where(doomed, -1, state.tag),
        v=torch.where(doomed[:, None], 0.0, state.v),
        obmd=state.obmd.replace(ndeleted=state.obmd.ndeleted
                                + doomed.sum(dtype=torch.int32)))
    return state, vnewl, vnewr


def feedback_count(cnt: torch.Tensor, mol_len, alpha, nbuf, dt, tau):
    """ninsert = -(int)((cnt/mol_len - alpha*nbuf) * dt/tau), C truncation
    toward zero (ref :586-589), in float32 like the reference port, with its
    5-ulp-relative nudge so a result landing on an integer is not cut a hair
    below it."""
    val = (cnt.to(torch.float32) / mol_len - _f32(alpha * nbuf, cnt)) \
        * _f32(dt, cnt) / _f32(tau, cnt)
    adj = -val * _f32(1.0 + 5.0e-6, cnt)
    return torch.trunc(adj).to(torch.int32)


def smooth_weight(cfg: SceneConfig, x0: torch.Tensor, mass: torch.Tensor):
    """g_par weight (ref :1312-1340): plateau `m` deep in the buffer,
    half-cosine rolloff of width g_fac*buffer near the inner edge."""
    obmd = cfg.obmd
    lower, upper = cfg.box.lo[0], cfg.box.hi[0]
    b = obmd.buffer_size
    gf = obmd.g_fac
    pi = math.pi
    in_left = x0 < lower + b
    left_plateau = x0 < lower + (1.0 - gf) * b
    carg_l = (1.0 / gf) * pi * (x0 - b - lower) / (-b) - pi
    g_left = torch.where(left_plateau, mass,
                         0.5 * (1.0 + torch.cos(carg_l)) * mass)
    in_right = x0 > upper - b
    right_plateau = x0 > upper - (1.0 - gf) * b
    carg_r = (1.0 / gf) * pi * (x0 - upper + b) / b - pi
    g_right = torch.where(right_plateau, mass,
                          0.5 * (1.0 + torch.cos(carg_r)) * mass)
    return torch.where(in_left, g_left, torch.where(in_right, g_right, 0.0))


def _pair_energy(p, rsq, cand_type, like):
    """The pair energy of two candidates that USHER's acceptance tests:
    the DPD energy 0.5*a0*rc*wd^2, or for the LJ family the reference's
    conservative stand-in (infinite closer than the largest cutoff, zero
    beyond)."""
    if isinstance(p, DPDParams):
        nt = p.ntypes
        ct = cand_type.long()
        pair_idx = ct[:, None] * nt + ct[None, :]
        a0 = const_like([v for row in p.a0 for v in row], like)[pair_idx]
        cut = const_like([v for row in p.cut for v in row], like)[pair_idx]
        r = torch.sqrt(rsq)
        wd = torch.clamp(1.0 - r / cut, min=0.0)
        return 0.5 * a0 * cut * wd * wd
    if isinstance(p, (LJCutParams, LJCutRFParams)):
        return torch.where(rsq < p.max_cut ** 2, torch.inf, 0.0)
    raise NotImplementedError(
        f"acceptance: the {type(p).__name__} law is not ported")


def _sequential_accept(cfg: SceneConfig, cand_x, cand_type, cand_ok, budget):
    """Greedy in-order acceptance with candidate-candidate visibility: in
    candidate order, take a candidate when it is ok, conflicts with no
    earlier taken one and the budget is not spent (ref :914 sequential
    insertion).  Under `near` insertion two candidates conflict when they
    are closer than `near`; under USHER when their pair energy
    (`_pair_energy`) exceeds etarget + eps (so with a negative etarget, as
    in any LJ liquid, every two candidates conflict and one per call is
    taken)."""
    obmd = cfg.obmd
    k = cand_x.shape[0]
    d = cfg.box.min_image(cand_x[:, None, :] - cand_x[None, :, :])
    rsq = (d * d).sum(-1)
    if obmd.near is not None:
        conflict = rsq < near_squared(cfg)
    else:
        conflict = _pair_energy(cfg.pair, rsq, cand_type, cand_x) \
            > obmd.usher.etarget + EPSILON
    conflict = conflict & ~torch.eye(k, dtype=torch.bool,
                                     device=cand_x.device)
    accepted = torch.zeros((k,), dtype=torch.bool, device=cand_x.device)
    count = torch.zeros((), dtype=torch.int32, device=cand_x.device)
    for kk in range(k):
        clash = (conflict[kk] & accepted).any()
        take = cand_ok[kk] & ~clash & (count < budget)
        accepted[kk] = take
        count = count + take.to(torch.int32)
    return accepted, count


def draw_candidates(u: torch.Tensor, region) -> torch.Tensor:
    """Uniform candidates in the insertion region (ref :921-927) from
    uniform [0, 1) triples `u` [K, 3] (the draw seam: the engine's own
    generator in production, injected draws in parity tests).  The gaussian
    and deposit keywords are not part of this slice."""
    return region.sample_uniform(u)


def insertion_tag_base(cfg: SceneConfig, state):
    """`id next` counts up from the running maximum; `id max` recomputes it
    over alive atoms (ref find_maxid :1860-1868)."""
    if cfg.obmd.id_policy == "max":
        return torch.where(state.alive, state.tag, 0).max()
    return state.maxtag


def rounds_of(cfg: SceneConfig) -> int:
    """Candidate rounds per stage call (`maxattempt`, ref :913-935)."""
    return max(1, int(cfg.obmd.maxattempt))
