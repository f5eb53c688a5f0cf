"""Buffer subsets, the batched USHER search and the `near` check in
PyTorch.

Counterpart of `obmd_tpu/obmd/subset.py`, op for op: `Subset`,
`expand_region`, `region_subset` and `subset_rows` (the nlist engine's
buffer subsets and the new atoms' Verlet rows), the DPD (dpd/ext's
conservative term is DPD's; dpd/tstat and dpd/ext/tstat have none),
lj/cut and
lj/cut/rf branches of `_batched_energy_force` and
`conservative_energy_force` (ATOM-mode trials are neutral; under
MOLECULE mode's `charged 1` a trial's atoms carry the template charges,
`cand_q` / `mol_q`, against the subset's), `usher_search_subset_batch` and `near_check_subset` for ATOM
mode, and for MOLECULE mode `random_rotations`, `mol_candidates_sel`,
`mol_energy_force`, `_axis_angle_rotate`, `usher_search_subset_mol`,
`near_check_subset_mol` and `mol_sequential_accept`.  The subset holds the
atoms within cut + skin of an insertion region, and the search runs brute
force against it, wherever a candidate lies (a `gaussian` draw or a z set
by the deposit keywords can lie outside the region or the box: such a
candidate is searched all the same and masked afterwards).  The ATOM-mode
search is the plain version of the USHER kernel (forces/usher_kernel.py);
under a thermostat-only law (dpd/tstat, dpd/ext/tstat), which has no
kernel law, and in MOLECULE mode the search runs as these PyTorch
operations on the card too, as the JAX package runs them as XLA array code
(obmd_tpu/forces/pallas_usher.py:22-26, :48-49).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..cells import BIG
from ..config import (DPDExtParams, DPDParams, DPDTstatParams, LJCutParams,
                      LJCutRFParams, SceneConfig)
from ..forces.pairs import make_pair_law
from ..geometry import RegionBlock, const_like, rounded

EPSILON = 1.0e-6


class Subset(NamedTuple):
    x: torch.Tensor         # [B,3] (BIG for padding)
    type: torch.Tensor      # [B] i32
    valid: torch.Tensor     # [B] bool
    overflow: torch.Tensor  # 0-dim bool: more region atoms than B
    q: Optional[torch.Tensor] = None   # [B] charges (None: a neutral scene)
    idx: Optional[torch.Tensor] = None  # [B] i64 slots (N for padding)


def expand_region(region: RegionBlock, pad: float) -> RegionBlock:
    return RegionBlock(tuple(l - pad for l in region.lo),
                       tuple(h + pad for h in region.hi))


def region_subset(cfg: SceneConfig, state, region: RegionBlock, pad: float,
                  b_max: int) -> Subset:
    """The live atoms inside the region widened by pad, compacted in slot
    order into b_max rows (x BIG, type 0 and q 0 on padding; more atoms
    than b_max are counted as overflow and dropped)."""
    from ..cellpad import compact_indices
    from ..cells import gather_padded
    n = state.capacity
    mask = state.alive & expand_region(region, pad).match(state.x)
    idx = compact_indices(mask, b_max, n)
    return Subset(
        x=gather_padded(state.x, idx, BIG),
        type=gather_padded(state.type, idx, 0),
        valid=idx < n,
        overflow=mask.sum() > b_max,
        q=gather_padded(state.q, idx, 0.0),
        idx=idx)


def subset_rows(p, box, sub: Subset, pos, new_slots, act):
    """Verlet rows (within cut + skin) of M new atoms at pos [M, 3], slots
    new_slots [M], active act [M]: their candidates are the pre-insertion
    subset's atoms and the other new atoms (so a new-new pair is in both
    fresh rows), the first K of them by the list's key.  Returns (row [M,
    K] slots, row_ok [M, K], overflow)."""
    from ..neighbors import first_k_rows
    m = pos.shape[0]
    cand_idx = torch.cat([sub.idx, new_slots.long()])
    cand_x = torch.cat([sub.x, torch.where(act[:, None], pos, BIG)])
    cand_valid = torch.cat([sub.valid, act])
    d = box.min_image(pos[:, None, :] - cand_x[None, :, :])
    rsq = (d * d).sum(-1)
    ok = (rsq < p.rlist2(rsq.dtype)) & cand_valid[None, :] & act[:, None]
    b = sub.x.shape[0]
    ok[:, b:] &= ~torch.eye(m, dtype=torch.bool, device=pos.device)
    n_cand = cand_idx.shape[0]
    row, row_ok, over = first_k_rows(p, cand_idx.expand(m, n_cand), ok, rsq,
                              n_cand)
    return row, row_ok, over


def _batched_energy_force(pair, sub_x, sub_type, sub_valid, pos, cand_type,
                          box=None, sub_q=None, cand_q=None):
    """sub_* [S,B,...], pos [S,K,3], cand_type [S,K] -> E [S,K], F [S,K,3]
    (DPD and dpd/ext: E = 0.5*a0*rc*wd^2, F = a0*wd*rhat; dpd/tstat and
    dpd/ext/tstat: zero; lj/cut and lj/cut/rf: the pair law of
    forces/pairs.make_pair_law, the trials' charges cand_q [S,K] against
    the subset's sub_q [S,B], each zero when None)."""
    d = pos[:, :, None, :] - sub_x[:, None, :, :]          # [S,K,B,3]
    if box is not None:
        d = box.min_image(d)
    rsq = (d * d).sum(-1)
    ok = sub_valid[:, None, :]
    if isinstance(pair, DPDTstatParams) or (
            isinstance(pair, DPDExtParams) and pair.tstat_only):
        return torch.zeros_like(pos[..., 0]), torch.zeros_like(pos)
    if isinstance(pair, (DPDParams, DPDExtParams)):
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
            qi = torch.zeros_like(pos[..., 0]) if cand_q is None else cand_q
            kw = dict(qi=qi[:, :, None], qj=qj[:, None, :])
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


def usher_steps(u, energy, pos, lo, hi):
    """The USHER search of candidates pos [..., K, 3] in the regions [lo,
    hi] (broadcast against pos; ref fix_obmd_merged.cpp:1518-1616), the
    energies and forces from energy(pos) -> (E [..., K], F [..., K, 3]):
    nattempt iterations in which E < etarget + eps accepts, E > uovlp takes
    the overlap step dsovlp - (4 eps / E)^(1/12), else ds = min((E -
    etarget)/|F|, ds0), along F/|F|; leaving the region or a degenerate
    force rejects; then a candidate still searching is accepted when its
    final E is below target.  Returns (pos, accepted, iters i32, final
    E)."""
    dev = pos.device
    shape = pos.shape[:-1]
    active = torch.ones(shape, dtype=torch.bool, device=dev)
    accepted = torch.zeros(shape, dtype=torch.bool, device=dev)
    iters = torch.zeros(shape, dtype=torch.int32, device=dev)
    for _ in range(u.nattempt):
        E, F = energy(pos)
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
    E, _ = energy(pos)
    accepted = accepted | (active & (E < u.etarget + EPSILON))
    return pos, accepted, iters, E


def usher_search_subset_batch(cfg: SceneConfig, sub_l: Subset, sub_r: Subset,
                              cand_l, cand_r, cand_type,
                              region_l: RegionBlock, region_r: RegionBlock,
                              reduce=None):
    """USHER over both buffers at once (`usher_steps`), each candidate's
    energy and force brute force against its side's subset.  reduce(E, F)
    -> (E, F), when given, completes them (the slab decomposition's sums
    over the ranks of each rank's partial energies).  Returns (pos
    [2,K,3], accepted [2,K], iters [2,K] i32)."""
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

    def energy(p):
        E, F = _batched_energy_force(cfg.pair, sub_x, sub_t, sub_v, p, ct,
                                     box=cfg.box, sub_q=sub_q)
        return (E, F) if reduce is None else reduce(E, F)
    return usher_steps(cfg.obmd.usher, energy, pos, lo, hi)[:3]


def near_squared(cfg: SceneConfig) -> float:
    """The `near` distance squared rounded to the scene's dtype, the value
    a distance of that dtype is compared with (JAX compares with the weakly
    typed python float near**2, which it rounds to float32 in a float32
    state and keeps whole in a float64 one, obmd_tpu/obmd/subset.py:161)."""
    return rounded(cfg.obmd.near ** 2, getattr(torch, cfg.dtype))


def near_check_subset(cfg: SceneConfig, sub: Subset, cand_x):
    """`near` insertion's check (ref fix_obmd_merged.cpp near branch): a
    candidate is ok when its minimum-image distance to every valid subset
    atom is at least `near`.  cand_x [K, 3] -> ok [K] bool."""
    d = cfg.box.min_image(cand_x[:, None, :] - sub.x[None, :, :])
    rsq = (d * d).sum(-1)
    min_rsq = torch.where(sub.valid[None, :], rsq, torch.inf).min(-1).values
    return min_rsq >= near_squared(cfg)


def conservative_energy_force(pair, sub: Subset, box, cand_x, cand_type,
                              cand_q=None):
    """The conservative energy E [K] and force F [K, 3] of K trial
    particles cand_x [K, 3] of types cand_type [K] and charges cand_q [K]
    (neutral when None) against one subset (`_batched_energy_force` over a
    single side; obmd_tpu/obmd/subset.py:65-111)."""
    q = None if sub.q is None else sub.q[None]
    e, f = _batched_energy_force(
        pair, sub.x[None], sub.type[None], sub.valid[None], cand_x[None],
        cand_type[None], box=box, sub_q=q,
        cand_q=None if cand_q is None else cand_q[None])
    return e[0], f[0]


# --------------------------------------------------------------------------
# MOLECULE-mode insertion (ref try_inserting's MOLECULE branch :989-1026
# and the USHER molecule steps :1536-1605)
# --------------------------------------------------------------------------

def random_rotations(u_axis, u_angle, axis=None):
    """K rotation matrices [K, 3, 3] by the reference's scheme (ref
    :1001-1024): the axis a uniform cube draw u_axis [K, 3] less 0.5,
    normalized (or the fixed `orient` axis), the angle 2 pi u_angle [K],
    axis-angle to matrix.  The uniforms come from the draw seam."""
    k = u_angle.shape[0]
    if axis is not None:
        ax = torch.as_tensor(axis, dtype=u_angle.dtype,
                             device=u_angle.device).expand(k, 3)
    else:
        ax = u_axis - 0.5
    ax = ax / torch.linalg.norm(ax, dim=-1, keepdim=True)
    theta = u_angle * (2.0 * np.pi)
    c = torch.cos(theta)[:, None, None]
    s = torch.sin(theta)[:, None, None]
    outer = ax[:, :, None] * ax[:, None, :]
    eye = torch.eye(3, dtype=ax.dtype, device=ax.device)[None]
    zero = torch.zeros_like(ax[:, 0])
    sk = torch.stack([
        torch.stack([zero, -ax[:, 2], ax[:, 1]], -1),
        torch.stack([ax[:, 2], zero, -ax[:, 0]], -1),
        torch.stack([-ax[:, 1], ax[:, 0], zero], -1)], 1)
    return c * eye + s * sk + (1.0 - c[:, 0, 0])[:, None, None] * outer


def mol_candidates_sel(dx_sel, amask, centers, rots):
    """Trial coordinates [K, m, 3] = center + R dx of each candidate's
    template displacements dx_sel [K, m, 3]; rows of pad atoms (amask [K,
    m] false) at BIG."""
    pos = centers[:, None, :] + torch.einsum("kab,kmb->kma", rots, dx_sel)
    return torch.where(amask[:, :, None], pos, BIG)


def mol_energy_force(cfg, sub: Subset, coords, mol_types,
                     per_atom: bool = False, mol_q=None):
    """Each K-molecule trial's total conservative energy [K] and net force
    [K, 3] against the subset, and with per_atom its atoms' forces [K, m,
    3]; coords [K, m, 3], mol_types [m] or [K, m], and under `charged 1`
    the trials' charges mol_q [m] or [K, m] (obmd_tpu/obmd/subset.py:
    241-259; None: neutral trials)."""
    k, m, _ = coords.shape
    types = (mol_types.repeat(k) if mol_types.dim() == 1
             else mol_types.reshape(k * m))
    cq = None if mol_q is None else (
        mol_q.repeat(k) if mol_q.dim() == 1 else mol_q.reshape(k * m))
    e, f = conservative_energy_force(cfg.pair, sub, cfg.box,
                                     coords.reshape(k * m, 3), types,
                                     cand_q=cq)
    fa = f.reshape(k, m, 3)
    e = e.reshape(k, m).sum(1)
    if per_atom:
        return e, fa.sum(1), fa
    return e, fa.sum(1)


def _axis_angle_rotate(coords, com, axis, angle):
    """Rotate coords [K, m, 3] about each candidate's com [K, 3] by its
    axis [K, 3] and angle [K] (Rodrigues)."""
    rel = coords - com[:, None, :]
    c = torch.cos(angle)[:, None, None]
    s = torch.sin(angle)[:, None, None]
    ax = axis[:, None, :]
    cross = torch.cross(ax.expand(rel.shape), rel, dim=-1)
    dot = (ax * rel).sum(-1, keepdim=True)
    return com[:, None, :] + (rel * c + cross * s + ax * dot * (1.0 - c))


def usher_search_subset_mol(cfg, sub: Subset, coords, mol_types, region,
                            mol_q=None, amask=None, reduce=None):
    """Molecule USHER (ref fix_obmd_merged.cpp:1586-1605): each iteration
    translates a molecule along its net force as ATOM mode moves an atom,
    then rotates it about its center of mass along the torque, dtheta =
    min((E - etarget) / |tau|, dtheta0).  The torque is the all-atom sum
    tau = sum_a (x_a - com) x F_a, as the JAX package has it (the
    reference's calc_torque keeps only the last atom).  E < etarget + eps
    accepts; a degenerate force or a step that takes a real atom out of the
    region rejects; a post-loop check accepts a molecule still below
    target.  mol_q: the trials' charges under `charged 1` (None:
    neutral).  reduce(E, F, Fa) -> (E, F, Fa), when given, completes each
    iteration's energies, net forces and per-atom forces (the slab
    decomposition's sums over the ranks of each rank's partials, one
    all-reduce an iteration), and reduce(E, None, None) the final
    energies.  Returns (coords [K, m, 3], accepted [K], iters [K] i32)."""
    u = cfg.obmd.usher
    dtheta0 = float(getattr(u, "dtheta0", 0.0) or 0.0)
    kk, mm = coords.shape[:2]
    dev = coords.device
    mt2 = (mol_types if mol_types.dim() == 2
           else mol_types[None, :].expand(kk, mm))
    am = (torch.ones((kk, mm), dtype=torch.bool, device=dev) if amask is None
          else amask.expand(kk, mm))
    masses = torch.where(am, const_like(cfg.masses, coords)[mt2.long()], 0.0)
    wsum = masses.sum(1)
    pos = coords
    active = torch.ones((kk,), dtype=torch.bool, device=dev)
    accepted = torch.zeros((kk,), dtype=torch.bool, device=dev)
    iters = torch.zeros((kk,), dtype=torch.int32, device=dev)
    for _ in range(u.nattempt):
        e, f, fa = mol_energy_force(cfg, sub, pos, mol_types, per_atom=True,
                                    mol_q=mol_q)
        if reduce is not None:
            e, f, fa = reduce(e, f, fa)
        ok = e < u.etarget + EPSILON
        newly = active & ok
        fabs = torch.sqrt((f * f).sum(-1))
        degen = fabs < EPSILON
        ds_ovlp = u.dsovlp - (4.0 * u.eps
                              / torch.clamp(e, min=EPSILON)) ** (1.0 / 12.0)
        ds_norm = torch.clamp((e - u.etarget) / torch.clamp(fabs, min=EPSILON),
                              max=u.ds0)
        ds = torch.where(e > u.uovlp, ds_ovlp, ds_norm)
        unit = f / torch.clamp(fabs, min=EPSILON)[:, None]
        moved = pos + (unit * ds[:, None])[:, None, :]
        if dtheta0 > 0.0:
            com = (masses[:, :, None] * moved).sum(1) / wsum[:, None]
            tau = torch.cross(moved - com[:, None, :], fa, dim=-1).sum(1)
            tabs = torch.sqrt((tau * tau).sum(-1))
            dth = torch.clamp((e - u.etarget)
                              / torch.clamp(tabs, min=EPSILON), max=dtheta0)
            axis = tau / torch.clamp(tabs, min=EPSILON)[:, None]
            rotated = _axis_angle_rotate(moved, com, axis, dth)
            moved = torch.where((tabs > EPSILON)[:, None, None], rotated,
                                moved)
        inside = torch.all(region.match(moved) | ~am, dim=1)
        move_now = active & ~ok & ~degen
        pos = torch.where(move_now[:, None, None], moved, pos)
        stopped = newly | (active & degen) | (move_now & ~inside)
        active = active & ~stopped
        accepted = accepted | newly
        iters = iters + active.to(torch.int32)
    e = mol_energy_force(cfg, sub, pos, mol_types, mol_q=mol_q)[0]
    if reduce is not None:
        e = reduce(e, None, None)[0]
    accepted = accepted | (active & (e < u.etarget + EPSILON))
    return pos, accepted, iters


def near_check_subset_mol(cfg, sub: Subset, coords, reduce_min=None):
    """`near` insertion's molecule check (ref :1036-1049): every atom of a
    trial at least `near` from every valid subset atom.  coords [K, m, 3]
    -> ok [K].  reduce_min, when given, completes each atom's least
    squared distance (the slab decomposition's minimum over the ranks,
    obmd_tpu/parallel/slab_decomp.py:1141-1149)."""
    k, m, _ = coords.shape
    d = cfg.box.min_image(coords.reshape(k * m, 1, 3) - sub.x[None, :, :])
    rsq = (d * d).sum(-1)
    min_rsq = torch.where(sub.valid[None, :], rsq, torch.inf).min(-1).values
    if reduce_min is not None:
        min_rsq = reduce_min(min_rsq)
    return torch.all(min_rsq.reshape(k, m) >= near_squared(cfg), dim=1)


def mol_sequential_accept(cfg, coords, mol_types, ok, budget):
    """Greedy in-order acceptance of K molecule trials coords [K, m, 3]
    (mol_types, the trials' atom types, are not read, as in the JAX
    function):
    take a trial when it is ok, the budget is not spent and, under USHER,
    no trial was taken before it or its summed pair energy with those
    stays at most etarget + eps (`near`: no such pair energy above zero).
    The JAX function compares the empty sum too, so at a negative etarget
    (a liquid's, path I's water) it refuses every trial and MOLECULE mode
    never inserts (ROADMAP Queue 3); the port takes the first ok trial, as
    ATOM mode's acceptance does (obmd_tpu/obmd/stage.py:207-262), and at
    etarget >= 0 both agree.  The pair
    energy is the DPD energy at the law's first coefficients a0[0][0] and
    cut[0][0], as the JAX package reads them, or for the LJ family
    infinite when any two atoms are within the largest cutoff.  Returns
    (accepted [K], count)."""
    obmd = cfg.obmd
    k = coords.shape[0]
    d = cfg.box.min_image(coords[:, None, :, None, :]
                          - coords[None, :, None, :, :])     # [K, K, m, m, 3]
    rsq = (d * d).sum(-1)
    p = cfg.pair
    if isinstance(p, DPDParams):
        a0, cut = float(p.a0[0][0]), float(p.cut[0][0])
        wd = torch.clamp(1.0 - torch.sqrt(rsq) / cut, min=0.0)
        epair = (0.5 * a0 * cut * wd * wd).sum((2, 3))
    else:
        epair = torch.where((rsq < p.max_cut ** 2).any(3).any(2),
                            torch.inf, 0.0)
    thresh = (obmd.usher.etarget if obmd.usher is not None else 0.0) \
        + EPSILON
    accepted = torch.zeros((k,), dtype=torch.bool, device=coords.device)
    count = torch.zeros((), dtype=torch.int32, device=coords.device)
    for kk in range(k):
        if obmd.near is not None:
            clash = ((epair[kk] > 0.0) & accepted).any()
        else:
            clash = accepted.any() & (
                torch.where(accepted, epair[kk], 0.0).sum() > thresh)
        take = ok[kk] & ~clash & (count < budget)
        accepted[kk] = take
        count = count + take.to(torch.int32)
    return accepted, count
