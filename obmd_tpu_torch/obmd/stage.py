"""The OBMD open-boundary stage.

Counterpart of the uniform-candidate part of `obmd_tpu/obmd/stage.py`:
`delete_outside` (the full-store deletion with MOLECULE mode's doom
propagation), `region_count`, `feedback_count`, `smooth_weight`,
`_sequential_accept` (USHER's energy criterion or `near`'s distance),
`draw_candidates`, `rounds_of` and `insertion_tag_base`, which the cellpad
engine uses; and for the nlist and sweep engines, in ATOM mode with one
candidate round, `insert_particles_subset`, `pre_exchange` and
`apply_boundary_force`.  Inserted atoms are at rest (the reference's
`draw_inserted_velocities` without velocity keywords, ref :1076-1078).

Candidates come from the draw seam (`engine_cellpad.Draw`), and the
search runs only when a buffer needs atoms: the reference's stage searches
on every call, which on a call that needs none inserts nothing and changes
nothing but its USHER iteration counter; so `usher_iters` counts the
iterations of the calls that need atoms only (as in the cellpad engine,
whose reference gates its search the same way).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import (DPDExtParams, DPDParams, LJCutParams, LJCutRFParams,
                      SceneConfig, eval_param)
from ..geometry import const, const_like
from .subset import near_check_subset, near_squared, region_subset

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


def insert_particles_subset(cfg: SceneConfig, state, ninsert_left,
                            ninsert_right, sub_l, sub_r, u):
    """ATOM-mode insertion on both buffers against their subsets, one round
    (obmd_tpu/obmd/stage.py:383-503 at maxattempt 1): K uniform candidates
    per insertion region from the draws u [2, 1, K, 3], the USHER search
    of both sides at once (forces/usher_kernel.usher_search) or `near`'s
    check, greedy in-order acceptance within each side's budget; the j-th
    accepted candidate takes the j-th free slot (state.alive marks the
    taken ones) at rest, type ntype, charge 0, no bonds, the tag base + 1 +
    j.  Returns (state, new_slots [2K]: left block then right, N where
    nothing landed, the inserted momenta by side (zero: at rest))."""
    from ..cellpad import compact_indices, scatter_rows
    from ..forces.usher_kernel import usher_search
    obmd = cfg.obmd
    k = obmd.insert_kmax
    n = state.capacity
    dev = state.device
    ctype = torch.full((k,), obmd.ntype, dtype=torch.int32, device=dev)
    cand_l = draw_candidates(u[0, 0], obmd.region5)
    cand_r = draw_candidates(u[1, 0], obmd.region6)
    if obmd.usher is not None:
        pos2, ok2, iters = usher_search(cfg, sub_l, sub_r, cand_l, cand_r,
                                        obmd.region5, obmd.region6)
    else:
        pos2 = torch.stack([cand_l, cand_r])
        ok2 = torch.stack([near_check_subset(cfg, sub_l, cand_l),
                           near_check_subset(cfg, sub_r, cand_r)])
        iters = torch.zeros((2, k), dtype=torch.int32, device=dev)
    acc_l, _ = _sequential_accept(cfg, pos2[0], ctype, ok2[0],
                                  torch.clamp(ninsert_left, 0, k))
    acc_r, _ = _sequential_accept(cfg, pos2[1], ctype, ok2[1],
                                  torch.clamp(ninsert_right, 0, k))
    pos = pos2.reshape(2 * k, 3)
    accepted = torch.cat([acc_l, acc_r])
    free = compact_indices(~state.alive, 2 * k, n)
    order = torch.cumsum(accepted.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(accepted,
                       free[torch.clamp(order, 0, 2 * k - 1).long()], n)
    landed = accepted & (slot < n)
    base = insertion_tag_base(cfg, state)
    new_tag = base + 1 + order
    z3 = torch.zeros_like(pos)
    z1 = z3[:, 0]
    zi = torch.zeros((2 * k,), dtype=torch.int32, device=dev)

    def put(arr, vals):
        return scatter_rows(arr, slot, vals)
    n_landed = landed.sum(dtype=torch.int32)
    want = torch.clamp(ninsert_left, min=0) + torch.clamp(ninsert_right,
                                                          min=0)
    sc = state.obmd
    state = state.replace(
        x=put(state.x, pos), v=put(state.v, z3), f=put(state.f, z3),
        type=put(state.type, ctype.repeat(2)), tag=put(state.tag, new_tag),
        q=put(state.q, z1), mol=put(state.mol, zi),
        lambdaF=put(state.lambdaF, z1), cms_mol=put(state.cms_mol, z3),
        vcms_mol=put(state.vcms_mol, z3), rep_atom=put(state.rep_atom, zi),
        bond1=put(state.bond1, zi - 1), bond2=put(state.bond2, zi - 1),
        alive=put(state.alive, torch.ones_like(landed)),
        maxtag=base + n_landed,
        obmd=sc.replace(
            ninserted=sc.ninserted + n_landed,
            insert_fail=sc.insert_fail + torch.clamp(want - n_landed, min=0),
            usher_iters=sc.usher_iters + iters.sum(dtype=torch.int32)))
    zero = torch.zeros((3,), dtype=state.dtype, device=dev)
    return state, torch.where(landed, slot, n), zero, zero


def stage_params(cfg: SceneConfig, state) -> dict:
    """The fix's equal-style parameters at the state's time (ref :563-572),
    and dt and the face area as float32 scalars on the device (a division
    by a host scalar would become a multiplication by its reciprocal on
    the card)."""
    obmd = cfg.obmd
    t = state.sim_time
    out = {name: eval_param(getattr(obmd, name), t)
           for name in ("pxx", "pxy", "pxz", "dpxx", "freq", "alpha", "tau",
                        "nbuf")}
    out["dt"] = const((float(np.float32(cfg.dt)),), state.dtype,
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
