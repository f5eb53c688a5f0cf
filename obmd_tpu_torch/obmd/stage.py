"""The OBMD open-boundary stage.

Counterpart of `obmd_tpu/obmd/stage.py` in ATOM mode: `delete_outside`
(the full-store deletion with MOLECULE mode's doom propagation),
`region_count`, `feedback_count`, `smooth_weight`, `_sequential_accept`
(USHER's energy criterion or `near`'s distance), `draw_candidates` (uniform
or `gaussian` draws, then the deposit keywords `rate`, `global` and
`local` on z), `draw_inserted_velocities` (`vx`/`vy`/`vz` and `target`),
`rounds_of`, `_append_subset` and `insertion_tag_base`, which the cellpad
engine uses; and for the nlist and sweep engines
`insert_particles_subset` (`maxattempt` rounds), `pre_exchange` and
`apply_boundary_force`; for the atom decomposition (parallel/
atom_decomp.py) `_usher_search` and `_near_check`, the search and the
`near` test over the cell table of the gathered state
(forces.pairs.trial_energy_force).  Inserted atoms are at rest unless a velocity
keyword is set; their momentum then enters the setpoints' tally.

Random numbers come from the draw seam (`Draws`, handed out by an
engine's `Draw`), and the search runs only when a buffer needs atoms: the
reference's stage searches on every call, which on a call that needs none
inserts nothing and changes nothing but its USHER iteration counter; so
`usher_iters` counts the iterations of the calls that need atoms only (as
in the cellpad engine, whose reference gates its search the same way).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..cells import BIG
from ..config import (DPDExtParams, DPDParams, DPDTstatParams, LJCutParams,
                      LJCutRFParams, SceneConfig, eval_param)
from ..geometry import const, const_like, reciprocals, rounded
from .subset import Subset, near_check_subset, near_squared, region_subset

EPSILON = 1.0e-6  # reference EPSILON (fix_obmd_merged.cpp:62)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A parameter as a scalar tensor of `like`'s float dtype (the state's:
    float32 or float64, as the JAX stage builds its constants in the
    state's dtype) on `like`'s device (cached, so no host-to-device copy
    per call; a tensor, not a python number, so that a division by it is a
    true division on the card too, where PyTorch turns division by a host
    scalar into multiplication by its reciprocal)."""
    if isinstance(v, torch.Tensor):
        return v.to(like.dtype)
    return const((float(v),), like.dtype, like.device)[0]


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


def region_count(state, region, group_types=None) -> torch.Tensor:
    """The live atoms inside the region (of the census group's types when
    given), i32."""
    m = state.alive & region.match(state.x)
    if group_types is not None:
        gm = torch.zeros_like(m)
        for t in group_types:
            gm = gm | (state.type == int(t))
        m = m & gm
    return m.sum(dtype=torch.int32)


def feedback_count(cnt: torch.Tensor, mol_len, alpha, nbuf, dt, tau):
    """ninsert = -(int)((cnt/mol_len - alpha*nbuf) * dt/tau), C truncation
    toward zero (ref :586-589), as the reference port computes it, with its
    5-ulp-relative nudge so a result landing on an integer is not cut a hair
    below it: cnt / mol_len - alpha nbuf in float32, the rest in dt's dtype
    (the state's; the JAX port's float32 head times its dtype(dt), which
    x64 promotes to float64; a dt given as a number is float32)."""
    head = cnt.to(torch.float32) / mol_len \
        - const((float(alpha * nbuf),), torch.float32, cnt.device)[0]
    if not isinstance(dt, torch.Tensor):
        dt = const((float(dt),), torch.float32, cnt.device)[0]
    val = head.to(dt.dtype) * dt / _scalar(tau, dt)
    adj = -val * _scalar(1.0 + 5.0e-6, dt)
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
    the DPD energy 0.5*a0*rc*wd^2 (zero under dpd/ext/tstat), or for the
    LJ family and dpd/tstat the reference's conservative stand-in
    (infinite closer than the largest cutoff, zero beyond)."""
    if isinstance(p, DPDExtParams) and p.tstat_only:
        return torch.zeros_like(rsq)
    if isinstance(p, (DPDParams, DPDExtParams)):
        nt = p.ntypes
        ct = cand_type.long()
        pair_idx = ct[:, None] * nt + ct[None, :]
        a0 = const_like([v for row in p.a0 for v in row], like)[pair_idx]
        cut = const_like([v for row in p.cut for v in row], like)[pair_idx]
        r = torch.sqrt(rsq)
        wd = torch.clamp(1.0 - r / cut, min=0.0)
        return 0.5 * a0 * cut * wd * wd
    if isinstance(p, (LJCutParams, LJCutRFParams, DPDTstatParams)):
        # dpd/tstat takes this branch in the reference too
        # (obmd_tpu/obmd/stage.py:241-244): within the cut, two candidates
        # conflict
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


def _usher_search(cfg: SceneConfig, spec, ctab, state, cand_x, cand_type,
                  region):
    """USHER over the cell table (obmd_tpu/obmd/stage.py:118-171), the
    search of the atom decomposition on its gathered state: the K
    candidates' search (subset.usher_steps) with the trial energies of
    forces.pairs.trial_energy_force.  Returns (positions [K, 3], accepted
    [K], iterations [K] i32, final E [K])."""
    from ..forces.pairs import trial_energy_force
    from .subset import usher_steps

    def energy(pos):
        return trial_energy_force(cfg.pair, cfg.box, spec, ctab, state.x,
                                  state.type, state.q, pos, cand_type)
    return usher_steps(cfg.obmd.usher, energy, cand_x,
                       const_like(region.lo, cand_x),
                       const_like(region.hi, cand_x))


def _near_check(cfg: SceneConfig, spec, ctab, state, cand_x, cand_type):
    """`near` insertion's test over the cell table (obmd_tpu/obmd/stage.py:
    174-204): a candidate is ok when no live atom of the 27 cells around
    it lies closer than `near`.  Returns (ok [K], the trial energies E
    [K], which the JAX function computes beside it)."""
    from ..cells import gather_padded
    from ..forces.pairs import trial_energy_force
    E, _ = trial_energy_force(cfg.pair, cfg.box, spec, ctab, state.x,
                              state.type, state.q, cand_x, cand_type)
    dims = spec.dims
    dev = cand_x.device
    inv = reciprocals(spec.cell_size, cand_x.dtype)
    nd = torch.tensor(dims, dtype=torch.int64, device=dev)
    cc = torch.floor((cand_x - const_like(spec.lo, cand_x))
                     * const_like(inv, cand_x)).to(torch.int64)
    cc = torch.minimum(torch.clamp(cc, min=0), nd - 1)
    offs = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                         for c in (-1, 0, 1)], dtype=torch.int64, device=dev)
    nb = cc[:, None, :] + offs[None, :, :]
    per = torch.tensor(spec.periodic, dtype=torch.bool, device=dev)
    nb_ok = torch.all(per | ((nb >= 0) & (nb < nd)), dim=-1)
    nb = torch.where(per, torch.remainder(nb, nd), nb)
    lin = (nb[..., 0] * dims[1] + nb[..., 1]) * dims[2] + nb[..., 2]
    lin = torch.where(nb_ok, lin, spec.n_cells)
    jdx = ctab.table[lin].reshape(cand_x.shape[0], -1)
    xj = gather_padded(state.x, jdx, BIG)
    d = cfg.box.min_image(cand_x[:, None, :] - xj)
    rsq = (d * d).sum(-1)
    min_rsq = torch.where(xj[..., 0] < BIG * 0.5, rsq, torch.inf) \
        .min(-1).values
    return min_rsq >= near_squared(cfg), E


class Draws(NamedTuple):
    """The random numbers of one stage call, from an engine's draw seam
    (the state's generator in production, the JAX engine's own draws in
    parity tests).  pos [2, rounds, K, D] (side-major): uniform [0, 1)
    draws, or standard normals under `gaussian`; D = 3 in ATOM mode (the
    position), 7 in MOLECULE mode (the center, the rotation axis's cube
    draw, the rotation angle's draw).  z [2, rounds, K]: the uniform that
    places z under `global` / `local` (else None).  vel [3, 2 rounds K]:
    one uniform per velocity component and candidate in draw order (left
    rounds, then right), under a velocity keyword (else None).  tpl [2,
    rounds, K] i32: each MOLECULE-mode trial's template index, drawn by
    `molfrac` where there are several templates (else None: template
    0)."""

    pos: torch.Tensor
    z: Optional[torch.Tensor] = None
    vel: Optional[torch.Tensor] = None
    tpl: Optional[torch.Tensor] = None


def deposit_z(obmd) -> bool:
    """The deposit keyword that draws z anew (`global` or `local`) is
    set."""
    return obmd.deposit_global is not None or obmd.deposit_local is not None


def has_velocity(obmd) -> bool:
    """An inserted-velocity keyword is set (`target` alone is not one: it
    only redirects drawn velocities, ref :1081-1093)."""
    return any(v is not None for v in (obmd.vx, obmd.vy, obmd.vz))


def draw_shapes(cfg: SceneConfig, rounds: int, k: int, dim: int) -> dict:
    """The shapes of one stage call's Draws fields (None: not drawn)."""
    o = cfg.obmd
    return dict(pos=(2, rounds, k, dim),
                z=(2, rounds, k) if deposit_z(o) else None,
                vel=(3, 2 * rounds * k) if has_velocity(o) else None,
                tpl=(2, rounds, k) if o.mol is not None
                and len(o.templates) > 1 else None)


def draw_candidates(cfg: SceneConfig, u, uz, region, state, comm=None):
    """Candidate positions [K, 3] and their initial validity [K] (ref
    :921-985, obmd_tpu/obmd/stage.py:263-313): uniform in the insertion
    region from uniform draws u [K, 3], or under `gaussian` normal draws u
    around its point (a draw outside the region is invalid); then `rate`
    moves z by rate * sim_time, or `global` / `local` put it at zmax + lo
    + uz (hi - lo) from the uniforms uz [K], zmax the highest z of the
    alive atoms (under `local` those within lateral minimum-image distance
    delta of the candidate; the box's lower z face when none is).  Under
    the slab decomposition `comm` (parallel.comm.Comm) completes zmax with
    its maximum over the ranks, so that every rank draws the same
    candidates (obmd_tpu/obmd/stage.py:301-302, `axis_name`)."""
    obmd = cfg.obmd
    if obmd.gaussian is not None:
        xm, ym, zm, sg = (float(v) for v in obmd.gaussian)
        cand = const_like((xm, ym, zm), u) + _scalar(sg, u) * u
        ok = region.match(cand)
    else:
        cand = region.sample_uniform(u)
        ok = torch.ones(u.shape[:1], dtype=torch.bool, device=u.device)
    if obmd.rate is None and not deposit_z(obmd):
        return cand, ok
    z = cand[:, 2]
    if obmd.rate is not None:
        z = z + _scalar(obmd.rate, u) * state.sim_time
    dep = obmd.deposit_global or obmd.deposit_local
    if dep is not None:
        lo, hi = float(dep[0]), float(dep[1])
        zs = state.x[:, 2]
        floor = _scalar(cfg.box.lo[2], u)
        if obmd.deposit_local is not None:
            delta = float(obmd.deposit_local[2])
            d = cfg.box.min_image(cand[:, None, :] - state.x[None, :, :])
            lat2 = d[..., 0] ** 2 + d[..., 1] ** 2
            sel = state.alive[None, :] & (lat2 <= _scalar(delta * delta, u))
            zmax = torch.where(sel, zs[None, :], floor).max(dim=1).values
        else:
            zmax = torch.where(state.alive, zs, floor).max()
        if comm is not None:
            zmax = comm.max(zmax)
        z = zmax + _scalar(lo, u) + uz * _scalar(hi - lo, u)
    return torch.cat([cand[:, :2], z[:, None]], dim=1), ok


def draw_inserted_velocities(cfg: SceneConfig, uv, pos):
    """The inserted atoms' velocities [M, 3] at candidate positions pos
    [M, 3] (obmd_tpu/obmd/stage.py:316-347): each component with a `vx`,
    `vy` or `vz lo hi` keyword lo + u (hi - lo) from its uniforms uv[c]
    [M], the others 0; then `target` points each velocity at the target,
    keeping its magnitude (ref :1081-1093).  None when no velocity keyword
    is set (insertion at rest, the reference's :1076-1078).  The uniform is
    scaled as the reference's uniform(minval=lo, maxval=hi) scales it:
    u (hi - lo) + lo, clipped below at lo."""
    obmd = cfg.obmd
    if not has_velocity(obmd):
        return None
    cols = []
    for c, rng_range in enumerate((obmd.vx, obmd.vy, obmd.vz)):
        if rng_range is None:
            cols.append(torch.zeros_like(pos[:, 0]))
        else:
            lo, hi = _scalar(rng_range[0], pos), _scalar(rng_range[1], pos)
            cols.append(torch.maximum(lo, uv[c] * (hi - lo) + lo))
    v = torch.stack(cols, dim=1)
    if obmd.target is not None:
        vel = torch.sqrt((v * v).sum(1))
        d = const_like(tuple(float(t) for t in obmd.target), pos)[None, :] \
            - pos
        rsq = (d * d).sum(1)
        rinv = torch.where(rsq > 0.0,
                           1.0 / torch.sqrt(torch.clamp(rsq, min=1e-30)), 0.0)
        v = torch.where((rsq > 0.0)[:, None], d * (rinv * vel)[:, None], v)
    return v


def inserted_momenta(cfg: SceneConfig, vnew, landed):
    """(pins_l, pins_r): mass x v of the landed atoms of each side's block
    (the first half of the candidates left, the rest right), zero without
    velocities."""
    if vnew is None:
        z = torch.zeros((3,), dtype=getattr(torch, cfg.dtype),
                        device=landed.device)
        return z, z
    mass = _scalar(cfg.masses[cfg.obmd.ntype], vnew)
    mv = mass * torch.where(landed[:, None], vnew, 0.0)
    half = vnew.shape[0] // 2
    return mv[:half].sum(0), mv[half:].sum(0)


def _append_subset(sub: Subset, pos, acc, ctype, n: int) -> Subset:
    """This round's candidates appended to the subset, valid where
    accepted, so later rounds' searches and distance checks see them
    (obmd_tpu/obmd/stage.py:367-380; the reference inserts sequentially,
    so attempt m sees insertions 0..m-1).  The appended rows take x BIG
    where not accepted, the trial type, charge 0 and slot n."""
    k = pos.shape[0]
    dev = pos.device
    return Subset(
        x=torch.cat([sub.x, torch.where(acc[:, None], pos, BIG)]),
        type=torch.cat([sub.type, ctype.to(sub.type.dtype)]),
        valid=torch.cat([sub.valid, acc]),
        overflow=sub.overflow,
        q=None if sub.q is None else torch.cat(
            [sub.q, torch.zeros((k,), dtype=sub.q.dtype, device=dev)]),
        idx=None if sub.idx is None else torch.cat(
            [sub.idx, torch.full((k,), n, dtype=sub.idx.dtype,
                                 device=dev)]))


def search_rounds(cfg: SceneConfig, state, nins_l, nins_r, sub_l, sub_r,
                  draws: Draws, n_pad: int):
    """`maxattempt` rounds of both buffers' candidates (the loop of
    obmd_tpu/engine_cellpad.py:551-603 and obmd/stage.py:410-433): per
    round fresh candidates per side (`draw_candidates`), one search of
    both sides on the round's subsets (forces/usher_kernel.usher_search,
    every round even when the budget left is zero, as the reference
    searches), or `near`'s check; greedy in-order acceptance within the
    budget left (each side's clipped to rounds x K at the start); with
    rounds > 1 the round's candidates appended to the subsets (slot
    n_pad).  Returns (pos [2M, 3], accepted [2M], usher iterations), M =
    rounds x K, the left side's rounds first."""
    from ..forces.usher_kernel import usher_search
    obmd = cfg.obmd
    k = obmd.insert_kmax
    rounds = rounds_of(cfg)
    dev = state.device
    ctype = torch.full((k,), obmd.ntype, dtype=torch.int32, device=dev)
    rem = [torch.clamp(b, 0, rounds * k) for b in (nins_l, nins_r)]
    subs = [sub_l, sub_r]
    regions = (obmd.region5, obmd.region6)
    poss, accs = ([], []), ([], [])
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    for r in range(rounds):
        cands = [draw_candidates(cfg, draws.pos[s, r],
                                 None if draws.z is None else draws.z[s, r],
                                 regions[s], state) for s in (0, 1)]
        if obmd.usher is not None:
            pos2, ok2, it2 = usher_search(cfg, subs[0], subs[1],
                                          cands[0][0], cands[1][0],
                                          *regions)
            iters = iters + it2.sum(dtype=torch.int32)
        else:
            pos2 = torch.stack([cands[0][0], cands[1][0]])
            ok2 = torch.stack([near_check_subset(cfg, subs[s], cands[s][0])
                               for s in (0, 1)])
        for s in (0, 1):
            acc, cnt = _sequential_accept(cfg, pos2[s], ctype,
                                          ok2[s] & cands[s][1],
                                          torch.clamp(rem[s], max=k))
            rem[s] = rem[s] - cnt
            if rounds > 1:
                subs[s] = _append_subset(subs[s], pos2[s], acc, ctype, n_pad)
            poss[s].append(pos2[s])
            accs[s].append(acc)
    pos = torch.cat(poss[0] + poss[1])
    accepted = torch.cat(accs[0] + accs[1])
    return pos, accepted, iters


def insertion_tag_base(cfg: SceneConfig, state):
    """`id next` counts up from the running maximum; `id max` recomputes it
    over alive atoms (ref find_maxid :1860-1868)."""
    if cfg.obmd.id_policy == "max":
        return torch.where(state.alive, state.tag, 0).max()
    return state.maxtag


def rounds_of(cfg: SceneConfig) -> int:
    """Candidate rounds per stage call (`maxattempt`, ref :913-935)."""
    return max(1, int(cfg.obmd.maxattempt))


def insert_particles_subset(cfg: SceneConfig, state, ninsert_left,
                            ninsert_right, sub_l, sub_r, draws: Draws):
    """ATOM-mode insertion on both buffers against their subsets
    (obmd_tpu/obmd/stage.py:383-503): `search_rounds` over the draws;
    the j-th accepted candidate takes the j-th free slot (state.alive
    marks the taken ones) with its drawn velocity (at rest without a
    velocity keyword), type ntype, charge 0, no bonds, the tag base + 1 +
    j.  Returns (state, new_slots [2M]: left block then right, N where
    nothing landed, the inserted momenta by side)."""
    from ..cellpad import compact_indices, scatter_rows
    obmd = cfg.obmd
    n = state.capacity
    dev = state.device
    pos, accepted, iters = search_rounds(cfg, state, ninsert_left,
                                         ninsert_right, sub_l, sub_r, draws,
                                         n)
    m2 = pos.shape[0]
    free = compact_indices(~state.alive, m2, n)
    order = torch.cumsum(accepted.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(accepted,
                       free[torch.clamp(order, 0, m2 - 1).long()], n)
    landed = accepted & (slot < n)
    base = insertion_tag_base(cfg, state)
    new_tag = base + 1 + order
    vnew = draw_inserted_velocities(cfg, draws.vel, pos)
    pins_l, pins_r = inserted_momenta(cfg, vnew, landed)
    z3 = torch.zeros_like(pos)
    z1 = z3[:, 0]
    zi = torch.zeros((m2,), dtype=torch.int32, device=dev)
    ctype = torch.full((m2,), obmd.ntype, dtype=torch.int32, device=dev)

    def put(arr, vals):
        return scatter_rows(arr, slot, vals)
    n_landed = landed.sum(dtype=torch.int32)
    want = torch.clamp(ninsert_left, min=0) + torch.clamp(ninsert_right,
                                                          min=0)
    sc = state.obmd
    state = state.replace(
        x=put(state.x, pos), v=put(state.v, z3 if vnew is None else vnew),
        f=put(state.f, z3),
        type=put(state.type, ctype), tag=put(state.tag, new_tag),
        q=put(state.q, z1), mol=put(state.mol, zi),
        lambdaF=put(state.lambdaF, z1), cms_mol=put(state.cms_mol, z3),
        vcms_mol=put(state.vcms_mol, z3), rep_atom=put(state.rep_atom, zi),
        bond1=put(state.bond1, zi - 1), bond2=put(state.bond2, zi - 1),
        alive=put(state.alive, torch.ones_like(landed)),
        maxtag=base + n_landed,
        obmd=sc.replace(
            ninserted=sc.ninserted + n_landed,
            insert_fail=sc.insert_fail + torch.clamp(want - n_landed, min=0),
            usher_iters=sc.usher_iters + iters))
    return state, torch.where(landed, slot, n), pins_l, pins_r


def stage_params(cfg: SceneConfig, state) -> dict:
    """The fix's equal-style parameters at the state's time (ref :563-572),
    and dt and the face area as scalars of the state's dtype on the device
    (a division by a host scalar would become a multiplication by its
    reciprocal on the card)."""
    obmd = cfg.obmd
    t = state.sim_time
    out = {name: eval_param(getattr(obmd, name), t)
           for name in ("pxx", "pxy", "pxz", "dpxx", "freq", "alpha", "tau",
                        "nbuf")}
    out["dt"] = const((rounded(cfg.dt, state.dtype),), state.dtype,
                      state.device)[0]
    out["area"] = const((cfg.box.cross_area,), state.dtype, state.device)[0]
    return out


def insertion_budgets(cfg: SceneConfig, state, prm: dict):
    """(ninsert_left, ninsert_right): the feedback law on the census of
    region1 and region2."""
    obmd = cfg.obmd
    return tuple(feedback_count(region_count(state, r, obmd.group_types),
                                obmd.mol_len, prm["alpha"], prm["nbuf"],
                                prm["dt"], prm["tau"])
                 for r in (obmd.region1, obmd.region2))


def insertion_subsets(cfg: SceneConfig, state):
    """Both insertion regions' subsets, widened by cut + skin, of
    insert_region_max rows (n_max // 2 when 0)."""
    b_max = cfg.capacity.insert_region_max or (cfg.capacity.n_max // 2)
    pad = cfg.pair.max_cut + cfg.skin
    return tuple(region_subset(cfg, state, r, pad, b_max)
                 for r in (cfg.obmd.region5, cfg.obmd.region6))


def skipped_insertion(cfg: SceneConfig, state):
    """The state after an insertion that placed nothing: under `id max`
    the running maximum tag is recomputed, as the reference's insertion
    recomputes it on every call."""
    if cfg.obmd.id_policy == "max":
        state = state.replace(maxtag=insertion_tag_base(cfg, state))
    return state


def setpoints(cfg: SceneConfig, state, prm: dict, vnewl, vnewr):
    """The stage's boundary-force setpoints (ref :600-633) from the
    momenta vnewl, vnewr carried out of each face, and the advanced
    sim_time."""
    dt, area, pxx = prm["dt"], prm["area"], prm["pxx"]
    sim_time = state.sim_time + dt
    factor = pxx + prm["dpxx"] * torch.sin(2.0 * np.pi * prm["freq"]
                                           * sim_time)
    mfl = torch.stack([vnewl[0] / dt + factor * area, vnewl[1] / dt,
                       vnewl[2] / dt])
    mfr = torch.stack([vnewr[0] / dt - pxx * area, vnewr[1] / dt,
                       vnewr[2] / dt])
    sfl = torch.stack([torch.zeros_like(area), prm["pxy"] * area,
                       prm["pxz"] * area])
    return state.replace(sim_time=sim_time, obmd=state.obmd.replace(
        momentum_force_left=mfl, momentum_force_right=mfr,
        shear_force_left=sfl, shear_force_right=-sfl))


def pre_exchange(cfg: SceneConfig, state, draw):
    """The full stage of the sweep engine and of the nlist engine's setup
    (ref :550-633): delete beyond the faces, census, feedback law, the
    buffer subsets and the insertion when a buffer needs atoms (one
    device-to-host read), a second deletion pass (a no-op for ATOM-mode
    insertion inside the box, ref :596-597), the setpoints."""
    prm = stage_params(cfg, state)
    state, vnewl, vnewr = delete_outside(cfg, state)
    nins_l, nins_r = insertion_budgets(cfg, state, prm)
    need = bool(((nins_l > 0) | (nins_r > 0)).item())
    u = draw(state, need)
    if need:
        sub_l, sub_r = insertion_subsets(cfg, state)
        state, _, pins_l, pins_r = insert_particles_subset(
            cfg, state, nins_l, nins_r, sub_l, sub_r, u)
        vnewl, vnewr = vnewl - pins_l, vnewr - pins_r
    else:
        state = skipped_insertion(cfg, state)
    state, vnewl2, vnewr2 = delete_outside(cfg, state)
    return setpoints(cfg, state, prm, vnewl + vnewl2, vnewr + vnewr2)


def apply_boundary_force(cfg: SceneConfig, state, f):
    """f plus the setpoint forces spread over each region's live atoms,
    f_i += F g_i / sum(g) (ref :1414-1516): smooth weights (smooth_weight,
    one profile over both buffers) in region1 and region2, mass weights in
    the shear sub-regions.  The four scaled forces are summed elementwise
    into one update, never as a matrix product
    (obmd_tpu/obmd/stage.py:631-644)."""
    from ..state import per_atom_mass
    obmd = cfg.obmd
    m = per_atom_mass(cfg, state)
    sc = state.obmd
    g_smooth = smooth_weight(cfg, state.x[:, 0], m)
    df = torch.zeros_like(f)
    for region, force, smooth in (
            (obmd.region1, sc.momentum_force_left, True),
            (obmd.region2, sc.momentum_force_right, True),
            (obmd.region3, sc.shear_force_left, False),
            (obmd.region4, sc.shear_force_right, False)):
        if region is None:
            continue
        member = state.alive & region.match(state.x)
        g = torch.where(member, g_smooth if smooth else m, 0.0)
        gsum = g.sum()
        scale = torch.where(gsum > 0.0, g / torch.clamp(gsum, min=1e-30),
                            0.0)
        df = df + scale[:, None] * force
    return f + df
