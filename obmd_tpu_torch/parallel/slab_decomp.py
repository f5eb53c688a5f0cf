"""The multi-device step by x-slab decomposition, over torch.distributed.

Counterpart of `obmd_tpu/parallel/slab_decomp.py`.  The box is cut into
`world` x-slabs; rank r owns the atoms whose x lies in slab r, in its own
`State` of n_loc slots (the JAX package's shard r).  Each step:
  * the half kick and the drift with the y/z wrap, locally; rigid bodies
    moved whole (`_rigid_drift_slab`) and SHAKE after the drift
    (`_shake_slab`), each on the owned plus halo view;
  * the OBMD stage (`_pre_exchange_slab`): deletion beyond the faces (in
    MOLECULE mode the doom spread over the faces along the partner tags,
    so a molecule goes whole), the momentum tallies and the buffer census
    summed over the ranks; the insertion search on every rank from the
    same draws, each rank scanning only its own atoms near the buffers and
    the candidates' partial energies and forces summed over the ranks
    every USHER iteration (the reference's three MPI_Allreduce an
    iteration, fix_obmd_merged.cpp:1561-1563), so every rank steps the
    same trajectory and reaches the same verdicts; the slab that contains
    an accepted candidate (a molecule's centre of mass) writes it, a
    molecule whole, its partners as tags (`_insert_mol_slab`);
  * migration (`_migrate`): atoms that crossed a slab face move to the
    neighbour's free slots with their partner and improper tags
    (comm_brick.cpp:652 exchange());
  * the halo (`_halo_arrays`): atoms within the halo width of a face are
    copied to the neighbour with their velocities (borders() and
    forward_comm(), comm_brick.cpp:771/:538), on a bonded scene with their
    partner tags, molecule ids and improper tags and the view's positions
    in the global frame (`HaloView`); partners are found by tag among the
    owned and halo rows (`_resolve_rows`);
  * forces on the owned atoms from owned plus halo atoms in the slab's own
    frame: `force_impl="gathered"` through the slab's cell grid
    (`forces.gathered.forces_for_subset`, 1-2 pairs by partner tag), or
    `"kernel"` through the pair kernel (`forces.pair_kernel.
    make_pair_kernel`, obmd_pair on the card, 2 or 4 partner-tag channels
    of exclusion under a bond style) on the slab's padded cell-major
    layout (`SlabGeom.pad_geom`), owned and halo atoms filed into it every
    step and the forces on halo slots dropped (their owner computes the
    same pairs: the tag-keyed pair noise is symmetric, so Newton's third
    law holds across ranks with no reverse pass); then the bond, angle,
    dihedral and improper forces in the global frame over the resolved
    rows, each atom computing its own share;
  * the boundary force with its weights' sums over the ranks, the second
    half kick, the rigid bodies' projection (`_rigid_project_slab`) or
    RATTLE (`_rattle_slab`).
Every value a host-side `if` reads before a collective (the demand gate,
the step for `nfreq` and `balance_every`) is the same on every rank.  The
Langevin thermostat, which the JAX slab step leaves out, and dihedrals on
a branched topology raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..cellpad import _center, compact_indices, scatter_rows, slot_index
from ..cells import BIG, GridSpec, build_cells
from ..config import LJCutRFParams, SceneConfig, template_stacks
from ..engine_cellpad import (_mol_rounds, _templates, check_scene,
                              mol_com, mol_mode, own_draws, pair_salt,
                              stage_every, step_times)
from ..forces.bonded import (angle_forces, bond_forces, dihedral_forces,
                             improper_forces)
from ..forces.gathered import forces_for_subset
from ..forces.pair_kernel import (N_EXCL, N_EXCL_BRANCHED, PadGeometry,
                                  make_pair_kernel)
from ..forces.pairs import sig_scale_of
from ..geometry import Box, const_like, rounded
from ..obmd.stage import (_append_subset, _sequential_accept,
                          draw_candidates, draw_inserted_velocities,
                          feedback_count, rounds_of, setpoints, stage_params)
from ..obmd.subset import (Subset, expand_region, near_squared,
                           usher_search_subset_batch)
from ..rigid import (_cross, _rounds, _solve_omega, body_moments,
                     check_bodies, rigid_kinematics)
from ..shake import rattle_velocities, shake_positions
from ..state import State, per_atom_mass
from .atom_decomp import boundary_force_psum
from .comm import Comm

I32 = torch.int32
I32_MAX = torch.iinfo(torch.int32).max
PARTNER_NAMES = ("bond1", "bond2", "bond3", "bond4")


@dataclasses.dataclass(frozen=True)
class SlabGeom:
    """Static geometry of the x-slab decomposition."""

    ndev: int
    n_loc: int            # slots a rank holds
    slab_w: float         # the widest slab (the grids are sized for it)
    x0: float             # box.lo[0]
    h_max: int            # halo rows a face
    m_max: int            # migration rows a face and step
    b_max: int            # a rank's insertion-subset rows
    spec_local: GridSpec  # the slab's cell grid in the slab frame
    halo_w: float         # the halo width (the pair cutoff, or a bonded
                          # reach)
    pad_geom: object = None   # the slab's PadGeometry; None when none fits
    # the cuts [ndev + 1] (the `balance` command's static cuts, uniform by
    # default; with make_slab_step(balance_every > 0) the rebalancer's
    # initial cuts, and slab_w must leave room: make_slab_geom's grow)
    boundaries: Tuple[float, ...] = ()

    @property
    def capacity(self) -> int:
        return self.ndev * self.n_loc


def make_slab_geom(cfg: SceneConfig, ndev: int, *, n_loc: int = 0,
                   h_max: int = 0, m_max: int = 0, b_max: int = 0,
                   boundaries=None, grow: float = 1.0) -> SlabGeom:
    """The decomposition's geometry (obmd_tpu/parallel/slab_decomp.py:
    90-211), field for field: uniform cuts unless `boundaries` are given;
    the halo as wide as the pair cutoff or a bonded term's reach (an
    angle's 2 bond hops, a dihedral's 3, a SHAKE cluster, a rigid
    template's span); the slab's cell grid and padded layout with pad
    cells for the halo; grow > 1 sizes them for slabs up to grow x the
    widest (the room dynamic balancing needs).  Periodic x and a slab
    narrower than the halo raise ValueError."""
    cfg = cfg.finalize()
    box = cfg.box
    if box.periodic[0]:
        raise ValueError("slab decomposition requires open (non-periodic) x")
    cut = float(cfg.pair.max_cut)
    lx_full = box.lengths[0]
    if boundaries is None:
        boundaries = tuple(box.lo[0] + lx_full * i / ndev
                           for i in range(ndev + 1))
    else:
        boundaries = tuple(float(b) for b in boundaries)
        if len(boundaries) != ndev + 1:
            raise ValueError("boundaries must have ndev+1 cuts")
        if abs(boundaries[0] - box.lo[0]) > 1e-9 or \
                abs(boundaries[-1] - box.hi[0]) > 1e-9:
            raise ValueError("boundaries must span the box")
        widths = np.diff(boundaries)
        if (widths < cut).any():
            raise ValueError(
                f"balanced slab width {widths.min():.3g} < cutoff {cut:.3g}")
    max_bond = 0.0
    span = 0.0
    if cfg.bond is not None:
        max_bond = max(max_bond, float(getattr(cfg.bond, "r0", 0.0)) * 1.3)
    if cfg.obmd is not None:
        for tpl in cfg.obmd.templates:
            dx = np.asarray(tpl.dx)
            for a, b in tpl.bonds:
                max_bond = max(
                    max_bond, float(np.linalg.norm(dx[a] - dx[b])) * 1.3)
            if tpl.natoms > 1:
                d2 = np.sum((dx[:, None, :] - dx[None, :, :]) ** 2, axis=-1)
                span = max(span, float(np.sqrt(d2.max())) * 1.1)
    hops = 3 if cfg.dihedral is not None else (
        2 if cfg.angle is not None else 1)
    if cfg.improper is not None:
        hops = max(hops, 2)
    reach = hops * max_bond
    if cfg.shake is not None:
        d0_max = float(np.max(np.asarray(cfg.shake.d0)))
        reach = max(reach, 2 * max_bond, 2.3 * d0_max)
    if cfg.rigid or cfg.shake is not None:
        reach = max(reach, span)
    halo_w = max(cut, reach)
    slab_w = float(np.max(np.diff(boundaries))) * float(grow)
    slab_w = min(slab_w, lx_full)
    min_w = float(np.min(np.diff(boundaries)))
    if min_w < halo_w:
        raise ValueError(
            f"slab width {min_w:.3g} < halo width {halo_w:.3g} "
            f"(cutoff {cut:.3g}, bonded reach {reach:.3g}): halos only "
            "reach the ADJACENT device — use fewer devices")
    n_max = cfg.capacity.n_max
    if n_loc <= 0:
        n_loc = -(-n_max // ndev)
    gs = GridSpec.create(box, cut + cfg.skin, cfg.capacity.cell_capacity)
    csx_in = cut + cfg.skin
    n_in = max(1, int(np.floor(slab_w / csx_in)))
    cs_x = slab_w / n_in
    n_pad = max(1, int(np.ceil(halo_w / cs_x)))
    # the slab's x cells are wider than the global grid's, so a cell holds
    # more atoms: scale the capacity by the volume ratio
    vol_ratio = cs_x / gs.cell_size[0]
    cap_local = int(np.ceil(cfg.capacity.cell_capacity * vol_ratio)) + 2
    spec_local = GridSpec(
        dims=(n_in + 2 * n_pad, gs.dims[1], gs.dims[2]),
        cell_size=(cs_x, gs.cell_size[1], gs.cell_size[2]),
        lo=(-n_pad * cs_x, box.lo[1], box.lo[2]),
        periodic=(False, box.periodic[1], box.periodic[2]),
        capacity=cap_local)
    if h_max <= 0:
        h_max = max(64, int(4 * n_loc * halo_w / slab_w))
    if m_max <= 0:
        m_max = max(32, n_loc // 8)
    if b_max <= 0:
        b_max = min(n_loc, cfg.capacity.insert_region_max or n_loc)
    # the slab plus n_pad pad bands of cut + skin a face, in the slab frame
    pad_w = n_pad * csx_in
    box_local = Box((-pad_w, box.lo[1], box.lo[2]),
                    (slab_w + pad_w, box.hi[1], box.hi[2]),
                    (False, box.periodic[1], box.periodic[2]))
    try:
        pad_geom = PadGeometry.create(box_local, csx_in, cap_local)
    except (ValueError, NotImplementedError):
        pad_geom = None
    return SlabGeom(ndev=ndev, n_loc=n_loc, slab_w=slab_w, x0=box.lo[0],
                    h_max=h_max, m_max=m_max, b_max=b_max,
                    spec_local=spec_local, halo_w=halo_w, pad_geom=pad_geom,
                    boundaries=boundaries)


@dataclasses.dataclass
class SlabCuts:
    """The live cuts [ndev + 1] of dynamic balancing, carried in
    State.nbrs (the same on every rank; fix_balance.cpp's analogue)."""

    cuts: torch.Tensor


def with_balance_cuts(geom: SlabGeom, state: State) -> State:
    """The state with the geometry's cuts installed as the live cuts of a
    balance_every > 0 step."""
    return state.replace(nbrs=SlabCuts(cuts=torch.tensor(
        geom.boundaries, dtype=state.dtype, device=state.device)))


def _rebalanced_cuts(cfg: SceneConfig, geom: SlabGeom, comm: Comm,
                     state: State, cuts: torch.Tensor) -> torch.Tensor:
    """One rebalance (obmd_tpu/parallel/slab_decomp.py:233-278): the live
    atoms' x histogram summed over the ranks, equal-count quantile cuts
    with linear interpolation in the crossing bin (fix_balance.cpp:375's
    shift() in one pass), each cut moved at most 0.9 halo widths, every
    slab width kept in [halo_w, slab_w] by a left-to-right then a
    right-to-left clamp."""
    ndev = geom.ndev
    dtype = state.dtype
    dev = state.device
    x0, x1 = float(cfg.box.lo[0]), float(cfg.box.hi[0])
    nbins = max(64, 16 * ndev)
    w = (x1 - x0) / nbins
    w32 = torch.tensor(w, dtype=dtype, device=dev)
    xb = torch.clamp(((state.x[:, 0] - x0) / w32).to(I32), 0, nbins - 1)
    hist = torch.zeros((nbins,), dtype=I32, device=dev).index_add_(
        0, xb.long(), state.alive.to(I32))
    hist = comm.sum(hist)
    csum = torch.cumsum(hist, 0).to(dtype)
    total = csum[-1]
    targets = total * torch.arange(1, ndev, dtype=dtype, device=dev) / ndev
    idx = torch.clamp(torch.searchsorted(csum, targets), 0, nbins - 1)
    prev = torch.where(idx > 0, csum[torch.clamp(idx - 1, min=0)], 0.0)
    frac = torch.where(csum[idx] > prev,
                       (targets - prev) / torch.clamp(csum[idx] - prev,
                                                      min=1e-9), 0.5)
    want = x0 + (idx.to(dtype) + frac) * rounded(w, dtype)
    step_max = rounded(0.9 * geom.halo_w, dtype)
    inner = torch.minimum(torch.maximum(want, cuts[1:-1] - step_max),
                          cuts[1:-1] + step_max)
    wmin = rounded(geom.halo_w, dtype)
    wmax = rounded(geom.slab_w, dtype)
    vals = [cuts[0]] + [inner[i] for i in range(ndev - 1)] + [cuts[-1]]

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)
    for i in range(1, ndev):
        vals[i] = clip(vals[i], vals[i - 1] + wmin, vals[i - 1] + wmax)
    for i in range(ndev - 1, 0, -1):
        vals[i] = clip(vals[i], vals[i + 1] - wmax, vals[i + 1] - wmin)
    return torch.stack(vals)


def balanced_boundaries(cfg: SceneConfig, state: State,
                        ndev: int) -> Tuple[float, ...]:
    """Position-quantile cuts of equal live-atom counts a slab, on the
    host (the `balance` command; obmd_tpu/parallel/slab_decomp.py:281-300),
    every slab at least a pair cutoff wide."""
    lo, hi = cfg.box.lo[0], cfg.box.hi[0]
    cut = float(cfg.pair.max_cut)
    x = state.x[:, 0][state.alive].cpu().numpy()
    cuts = np.asarray(np.quantile(x, np.linspace(0.0, 1.0, ndev + 1)),
                      dtype=np.float64)
    cuts[0], cuts[-1] = lo, hi
    for i in range(1, ndev + 1):
        cuts[i] = max(cuts[i], cuts[i - 1] + cut)
    for i in range(ndev - 1, -1, -1):
        cuts[i] = min(cuts[i], cuts[i + 1] - cut)
    if cuts[0] < lo - 1e-9:
        raise ValueError("box too narrow for ndev cutoff-wide slabs")
    cuts[0], cuts[-1] = lo, hi
    return tuple(float(c) for c in cuts)


def shard_by_slab(cfg: SceneConfig, geom: SlabGeom, state: State,
                  rank: int) -> State:
    """Rank `rank`'s State of n_loc slots from a global state
    (obmd_tpu/parallel/slab_decomp.py:303-383): the live atoms whose x
    lies in slab `rank` (by the float64 cuts) in slot order, then dead
    slots at the box centre; the partner and improper columns as TAGS
    (slots are a rank's own and change on migration); lambdaF and the
    molecule centres zero.  A slab of more than n_loc atoms raises, and
    under `rigid` a body the rigid integrator cannot sum
    (rigid.check_bodies: a cycle, or a body deeper than its rounds)."""
    if cfg.rigid:
        check_bodies(cfg.finalize(), state)
    ndev, n_loc = geom.ndev, geom.n_loc
    dev = state.device
    x0 = state.x[:, 0].double()
    bnd = torch.tensor(geom.boundaries, dtype=torch.float64, device=dev)
    slab = torch.clamp(torch.searchsorted(bnd, x0, right=True) - 1, 0,
                       ndev - 1)
    counts = torch.bincount(slab[state.alive], minlength=ndev)
    over = (counts > n_loc).nonzero()
    if over.numel():
        raise ValueError(f"slab {int(over[0])} holds more than "
                         f"n_loc={n_loc} atoms")
    idx = (state.alive & (slab == rank)).nonzero()[:, 0]
    rows = torch.arange(idx.shape[0], device=dev)
    n = state.capacity

    def take(arr, fill):
        out = torch.full((n_loc,) + tuple(arr.shape[1:]), fill,
                         dtype=arr.dtype, device=dev)
        out[rows] = arr[idx]
        return out

    def tags_of(col):
        t = torch.where(col >= 0, state.tag[torch.clamp(col.long(), 0,
                                                        n - 1)], -1)
        return take(t, -1)

    x = take(state.x, 0.0)
    x[idx.shape[0]:] = _center(cfg.box, x)
    zf = torch.zeros((n_loc,), dtype=state.dtype, device=dev)
    extra = {}
    if state.bond3 is not None:
        extra.update(bond3=tags_of(state.bond3), bond4=tags_of(state.bond4))
    if state.impr is not None:
        extra["impr"] = tags_of(state.impr)
    return state.replace(
        x=x, v=take(state.v, 0.0), f=take(state.f, 0.0),
        type=take(state.type, 0), tag=take(state.tag, -1),
        alive=take(state.alive, False), q=take(state.q, 0.0),
        mol=take(state.mol, 0), lambdaF=zf,
        cms_mol=torch.zeros((n_loc, 3), dtype=state.dtype, device=dev),
        vcms_mol=torch.zeros((n_loc, 3), dtype=state.dtype, device=dev),
        rep_atom=take(state.rep_atom, 0), bond1=tags_of(state.bond1),
        bond2=tags_of(state.bond2), nbrs=None, **extra)


def check_slab_scene(cfg: SceneConfig) -> None:
    """Raise for a scene the slab step does not run: the Langevin
    thermostat (the JAX slab step leaves it out), rigid bodies without an
    insertion template (make_slab_geom widens the halo to a template's
    span, so that each owner sees its whole body; the JAX slab step runs
    them on a cutoff-wide halo), dihedrals on a branched topology (as the
    JAX slab step, slab_decomp.py:910-913), a molecule template whose types
    the scene lacks, and the refusals every engine shares
    (engine_cellpad.check_scene).  A float64 scene runs in float64
    throughout, as the JAX slab step runs it under x64 (on the kernel path
    with float32 kernel fields, `file_slab`)."""
    if cfg.langevin is not None:
        raise NotImplementedError(
            "the multi-device steps have no Langevin thermostat (the JAX "
            "steps leave it out)")
    if cfg.rigid and not mol_mode(cfg):
        raise NotImplementedError(
            "rigid bodies on the slab need the fix's molecule template: "
            "the halo is widened to its span so that each owner sees its "
            "whole body")
    if cfg.dihedral is not None and cfg.branched_topology:
        raise NotImplementedError(
            "dihedrals on branched topologies (>2 bonds/atom) are not "
            "supported by the center-bond dihedral storage")
    check_scene(cfg)
    if mol_mode(cfg):
        top = int(template_stacks(cfg.obmd).types.max())
        if top >= cfg.ntypes:
            raise ValueError(f"the insertion template reaches type "
                             f"{top + 1} of a {cfg.ntypes}-type scene")


def _pack_rows(mask, cap: int, *arrays, n: int):
    """The rows selected by mask compacted in slot order into cap rows:
    (idx [cap], n marking padding; valid [cap]; the arrays' rows, zero on
    padding; the selected rows that did not fit)."""
    idx = compact_indices(mask, cap, n)
    valid = idx < n
    safe = torch.clamp(idx, 0, n - 1)
    packed = [torch.where(valid if a.dim() == 1 else valid[:, None],
                          a[safe], torch.zeros_like(a[safe]))
              for a in arrays]
    missed = mask.sum(dtype=I32) - valid.sum(dtype=I32)
    return idx, valid, packed, missed


def _migrate(cfg: SceneConfig, geom: SlabGeom, comm: Comm, state: State,
             lo_d, hi_d) -> State:
    """Atoms whose x left the slab move to the neighbour's free slots
    (obmd_tpu/parallel/slab_decomp.py:566-646), in one exchange with both
    neighbours; atoms beyond the open box faces stay with the edge ranks
    until the stage deletes them.  Arrivals that find no free slot and
    movers beyond the m_max rows are counted in cell_overflow."""
    n_loc, m_max = geom.n_loc, geom.m_max
    x0 = state.x[:, 0]
    go_l = state.alive & (x0 < lo_d) & (comm.rank > 0)
    go_r = state.alive & (x0 >= hi_d) & (comm.rank < comm.world - 1)
    partners = state.bond_partners

    def pack(mask):
        idx, valid, (px, pv, pq, plam), missed = _pack_rows(
            mask, m_max, state.x, state.v, state.q, state.lambdaF, n=n_loc)
        safe = torch.clamp(idx, 0, n_loc - 1)
        cols = [torch.where(valid, c[safe], 0) for c in
                (state.type, state.tag, state.mol, state.rep_atom)]
        cols.append(valid.to(I32))
        cols += [torch.where(valid, p[safe], -1) for p in partners]
        if state.impr is not None:
            cols += [torch.where(valid, state.impr[safe, c], -1)
                     for c in range(3)]
        return [px, pv, torch.stack([pq, plam], 1),
                torch.stack(cols, 1)], missed

    out_l, miss_l = pack(go_l)
    out_r, miss_r = pack(go_r)
    gone = go_l | go_r
    alive = state.alive & ~gone
    tag = torch.where(gone, -1, state.tag)
    from_r, from_l = comm.exchange(out_l, out_r)
    ax, av, aq, ai = (torch.cat([a, b]) for a, b in zip(from_r, from_l))
    avalid = ai[:, 4] > 0
    m2 = 2 * m_max
    free = compact_indices(~alive, m2, n_loc)
    order = torch.cumsum(avalid.to(I32), 0, dtype=I32) - 1
    slot = torch.where(avalid, free[torch.clamp(order, 0, m2 - 1).long()],
                       n_loc)
    landed = avalid & (slot < n_loc)
    lost = (avalid.sum(dtype=I32) - landed.sum(dtype=I32) + miss_l + miss_r)

    def put(arr, vals):
        return scatter_rows(arr, slot, vals)
    upd = {}
    names = ("bond1", "bond2", "bond3", "bond4")
    for k in range(len(partners)):
        upd[names[k]] = put(torch.where(gone, -1, partners[k]), ai[:, 5 + k])
    if state.impr is not None:
        p = len(partners)
        upd["impr"] = put(torch.where(gone[:, None], -1, state.impr),
                          ai[:, 5 + p:8 + p])
    return state.replace(
        x=put(state.x, ax), v=put(state.v, av), q=put(state.q, aq[:, 0]),
        lambdaF=put(state.lambdaF, aq[:, 1]), type=put(state.type, ai[:, 0]),
        tag=put(tag, ai[:, 1]), mol=put(state.mol, ai[:, 2]),
        rep_atom=put(state.rep_atom, ai[:, 3]), alive=put(alive, landed),
        cell_overflow=state.cell_overflow + comm.sum(lost), **upd)


class HaloView(NamedTuple):
    """The payloads of the owned plus halo view that bonded terms,
    constraints and rigid bodies read (obmd_tpu/parallel/slab_decomp.py:
    648-656)."""

    x_glob: torch.Tensor                 # [n_full, 3] global frame, BIG dead
    btags: Tuple[torch.Tensor, ...]      # the partner TAG columns (2 or 4)
    mol: torch.Tensor                    # [n_full] molecule ids
    impr: Optional[torch.Tensor]         # [n_full, 3] improper end TAGS
    vecs: Tuple[torch.Tensor, ...]       # the vec_extra payloads [n_full, 3]


def _bonded_view(cfg: SceneConfig) -> bool:
    """The halo carries the molecule payloads (a bond, angle or dihedral
    style, rigid bodies, SHAKE or MOLECULE-mode insertion)."""
    return (cfg.bond is not None or cfg.angle is not None
            or cfg.dihedral is not None or cfg.rigid
            or cfg.shake is not None or mol_mode(cfg))


def _halo_arrays(cfg: SceneConfig, geom: SlabGeom, comm: Comm,
                 state: State, lo_d, hi_d, vec_extra=()):
    """(xs_full, v_full, t_full, g_full, q_full, valid_full, missed,
    extras): the owned rows, then the left halo (the left neighbour's
    atoms within the halo width of our face), then the right halo,
    positions in the slab frame x' = x - lo_d and BIG where not live; one
    exchange with both neighbours, every tensor of a direction in one
    buffer (obmd_tpu/parallel/slab_decomp.py:659-766).  On a bonded scene
    each halo row also carries its partner tags, molecule id and improper
    tags and the [n_loc, 3] payloads vec_extra, and extras is their
    HaloView with the positions in the global frame (two ranks that see
    one molecule then compute the same displacements; the slab frames
    differ by a rounded lo_d); else extras is None.  missed counts the
    face atoms beyond the h_max rows."""
    n_loc, h_max = geom.n_loc, geom.h_max
    w = rounded(geom.halo_w, state.dtype)
    x0 = state.x[:, 0]
    near_lo = state.alive & (x0 < lo_d + w)
    near_hi = state.alive & (x0 >= hi_d - w)
    bonded = _bonded_view(cfg)
    partners = state.bond_partners if bonded else ()
    has_impr = bonded and state.impr is not None

    def pack(mask):
        idx, valid, packed, missed = _pack_rows(mask, h_max, state.x,
                                                state.v, *vec_extra, n=n_loc)
        safe = torch.clamp(idx, 0, n_loc - 1)
        pq = torch.where(valid, state.q[safe], 0.0)
        cols = [torch.where(valid, state.type[safe], 0),
                torch.where(valid, state.tag[safe], 0), valid.to(I32)]
        if bonded:
            cols += [torch.where(valid, p[safe], -1) for p in partners]
            cols.append(torch.where(valid, state.mol[safe], 0))
            if has_impr:
                cols += [torch.where(valid, state.impr[safe, c], -1)
                         for c in range(3)]
        return [packed[0], packed[1], pq, torch.stack(cols, 1)] \
            + packed[2:], missed

    low, miss_l = pack(near_lo)
    high, miss_r = pack(near_hi)
    # my lower-face batch goes left, my upper-face batch right: my right
    # halo is the right neighbour's lower batch, my left halo the left
    # neighbour's upper batch
    from_r, from_l = comm.exchange(low, high)
    (hr_x, hr_v, hr_q, hr_i), hr_ex = from_r[:4], from_r[4:]
    (hl_x, hl_v, hl_q, hl_i), hl_ex = from_l[:4], from_l[4:]
    shift = torch.stack([lo_d, torch.zeros_like(lo_d), torch.zeros_like(lo_d)])

    def frame(xs, valid):
        return torch.where(valid[:, None], xs - shift[None, :], BIG)

    valid_l = hl_i[:, 2] > 0
    valid_r = hr_i[:, 2] > 0
    xs_full = torch.cat([frame(state.x, state.alive), frame(hl_x, valid_l),
                         frame(hr_x, valid_r)])
    valid_full = torch.cat([state.alive, valid_l, valid_r])
    extras = None
    if bonded:
        p = len(partners)

        def col(own, k):
            return torch.cat([own, hl_i[:, k], hr_i[:, k]])
        extras = HaloView(
            x_glob=torch.where(valid_full[:, None],
                               torch.cat([state.x, hl_x, hr_x]), BIG),
            btags=tuple(col(partners[k], 3 + k) for k in range(p)),
            mol=col(state.mol, 3 + p),
            impr=torch.stack([col(state.impr[:, c], 4 + p + c)
                              for c in range(3)], 1) if has_impr else None,
            vecs=tuple(torch.cat([a, b, c]) for a, b, c in
                       zip(vec_extra, hl_ex, hr_ex)))
    return (xs_full, torch.cat([state.v, hl_v, hr_v]),
            torch.cat([state.type, hl_i[:, 0], hr_i[:, 0]]),
            torch.cat([state.tag, hl_i[:, 1], hr_i[:, 1]]),
            torch.cat([state.q, hl_q, hr_q]), valid_full, miss_l + miss_r,
            extras)


def _tag_index(g_full, valid_full):
    """The live rows' tags sorted (the int32 maximum for the others) and
    the sorting order: the table `_resolve_rows` searches."""
    key = torch.where(valid_full & (g_full > 0), g_full, I32_MAX)
    return torch.sort(key.to(I32))


def _resolve_rows(g_full, valid_full, ptags, index=None):
    """The row of each partner TAG among the owned and halo rows, -1 where
    the tag is absent (dead, or beyond the halo, which make_slab_geom's
    halo width rules out for a live partner): a sorted search
    (obmd_tpu/parallel/slab_decomp.py:769-782; tags are unique and each
    atom has one owner).  index: `_tag_index`'s table, when already
    built."""
    sk, order = index if index is not None else _tag_index(g_full,
                                                           valid_full)
    pt = ptags.to(I32).contiguous()
    pos = torch.clamp(torch.searchsorted(sk, pt), 0, sk.shape[0] - 1)
    return torch.where((pt > 0) & (sk[pos] == pt), order[pos], -1)


def _resolve_partner_rows(extras: HaloView, g_full, valid_full):
    """Every partner TAG column resolved to rows of the owned and halo
    view, one sort for all (obmd_tpu/parallel/slab_decomp.py:837-841)."""
    index = _tag_index(g_full, valid_full)
    return tuple(_resolve_rows(g_full, valid_full, bt, index)
                 for bt in extras.btags)


def _inverse_mass(cfg: SceneConfig, t_full, like):
    return 1.0 / const_like(cfg.masses, like)[t_full.long()]


def _shake_slab(cfg: SceneConfig, geom: SlabGeom, comm: Comm, state: State,
                x_new, v, lo_d, hi_d):
    """SHAKE after the drift on the slab (obmd_tpu/parallel/
    slab_decomp.py:844-869): one halo exchange ships the post-drift x and v
    and the pre-drift x (state.x), partners resolve by tag, and the Jacobi
    sweeps run on the owned and halo view in the global frame (the halo
    covers a whole constraint cluster: make_slab_geom's SHAKE reach), so
    each owner computes the correction the single-device step computes.
    Returns (x, v, the halo rows that did not fit, summed over the
    ranks)."""
    n_loc = geom.n_loc
    _, v_full, t_full, g_full, _, valid_full, miss, extras = _halo_arrays(
        cfg, geom, comm, state.replace(x=x_new, v=v), lo_d, hi_d,
        vec_extra=(state.x,))
    rows = _resolve_partner_rows(extras, g_full, valid_full)
    xs, vs = shake_positions(cfg, extras.vecs[0], extras.x_glob, v_full,
                             t_full, rows[0], rows[1], valid_full,
                             _inverse_mass(cfg, t_full, x_new),
                             more_partners=rows[2:])
    own = state.alive[:, None]
    return (torch.where(own, xs[:n_loc], x_new),
            torch.where(own, vs[:n_loc], v), comm.sum(miss))


def _rattle_slab(cfg: SceneConfig, geom: SlabGeom, comm: Comm, state: State,
                 v, lo_d, hi_d):
    """RATTLE's velocity projection on the owned and halo view after the
    second half kick (obmd_tpu/parallel/slab_decomp.py:872-888): the halo
    rows carry their owners' kicked velocities.  Returns (v, the halo rows
    that did not fit, summed over the ranks)."""
    n_loc = geom.n_loc
    _, v_full, t_full, g_full, _, valid_full, miss, extras = _halo_arrays(
        cfg, geom, comm, state.replace(v=v), lo_d, hi_d)
    rows = _resolve_partner_rows(extras, g_full, valid_full)
    vs = rattle_velocities(cfg, extras.x_glob, v_full, t_full, rows[0],
                           rows[1], valid_full,
                           _inverse_mass(cfg, t_full, v),
                           more_partners=rows[2:])
    return torch.where(state.alive[:, None], vs[:n_loc], v), comm.sum(miss)


def _rigid_view(cfg: SceneConfig, geom: SlabGeom, comm: Comm, state: State,
                v, lo_d, hi_d):
    """The owned and halo arrays of the rigid bodies (obmd_tpu/parallel/
    slab_decomp.py:785-800): the halo covers a template's span, so each
    owned member sees its whole body; (x_glob, v_full, mass, partner rows,
    member)."""
    _, v_full, t_full, g_full, _, valid_full, _, extras = _halo_arrays(
        cfg, geom, comm, state.replace(v=v), lo_d, hi_d)
    rows = _resolve_partner_rows(extras, g_full, valid_full)
    mass = const_like(cfg.masses, extras.x_glob)[t_full.long()]
    return (extras.x_glob, v_full, mass, rows,
            valid_full & (extras.mol != 0))


def _rigid_drift_slab(cfg: SceneConfig, geom: SlabGeom, comm: Comm,
                      state: State, v, lo_d, hi_d, dt: float):
    """The drift with the rigid bodies moved whole (obmd_tpu/parallel/
    slab_decomp.py:803-819) by the port's rigid.rigid_kinematics (the turn
    about the half-step orientation's omega); (x, v) unwrapped."""
    n_loc = geom.n_loc
    x_glob, v_full, mass, rows, member = _rigid_view(cfg, geom, comm, state,
                                                     v, lo_d, hi_d)
    x_rig, v_rig = rigid_kinematics(cfg.box, x_glob, v_full, mass, rows[0],
                                    rows[1], member, _rounds(cfg), dt,
                                    more_partners=rows[2:])
    mem = member[:n_loc, None]
    x = torch.where(mem, x_rig[:n_loc],
                    torch.where(state.alive[:, None], state.x + dt * v,
                                state.x))
    return x, torch.where(mem, v_rig[:n_loc], v)


def _rigid_project_slab(cfg: SceneConfig, geom: SlabGeom, comm: Comm,
                        state: State, v, lo_d, hi_d):
    """The second kick's velocities projected onto each body's rigid field
    (obmd_tpu/parallel/slab_decomp.py:822-834)."""
    n_loc = geom.n_loc
    x_glob, v_full, mass, rows, member = _rigid_view(cfg, geom, comm, state,
                                                     v, lo_d, hi_d)
    _, rbar, V, L, I6 = body_moments(cfg.box, x_glob, v_full, mass, rows[0],
                                     rows[1], member, _rounds(cfg),
                                     more_partners=rows[2:])
    v_rigid = V + _cross(_solve_omega(I6, L), -rbar)
    return torch.where(member[:n_loc, None], v_rigid[:n_loc], v)


def _kick_drift_slab(cfg: SceneConfig, geom: SlabGeom, comm: Comm,
                     state: State, lo_d, hi_d, dt: float,
                     dtf: float) -> State:
    """The first half kick and the drift with the y/z wrap, live atoms
    only, rigid bodies moved whole; then SHAKE, its halo misses in
    cell_overflow (obmd_tpu/parallel/slab_decomp.py:500-511)."""
    a3 = state.alive[:, None]
    v = torch.where(a3, state.v + dtf * state.f
                    / per_atom_mass(cfg, state)[:, None], state.v)
    if cfg.rigid:
        x, v = _rigid_drift_slab(cfg, geom, comm, state, v, lo_d, hi_d, dt)
        x = cfg.box.wrap(x)
    else:
        x = cfg.box.wrap(torch.where(a3, state.x + dt * v, state.x))
    if cfg.shake is not None:
        x, v, miss = _shake_slab(cfg, geom, comm, state, x, v, lo_d, hi_d)
        state = state.replace(cell_overflow=state.cell_overflow + miss)
    return state.replace(x=x, v=v)


def _kick_slab(cfg: SceneConfig, geom: SlabGeom, comm: Comm, state: State,
               f, lo_d, hi_d, dtf: float) -> State:
    """The second half kick, live atoms only, then the rigid bodies'
    projection or RATTLE, its halo misses in cell_overflow
    (obmd_tpu/parallel/slab_decomp.py:539-547)."""
    v = torch.where(state.alive[:, None], state.v + dtf * f
                    / per_atom_mass(cfg, state)[:, None], state.v)
    if cfg.rigid:
        v = _rigid_project_slab(cfg, geom, comm, state, v, lo_d, hi_d)
    if cfg.shake is not None:
        v, miss = _rattle_slab(cfg, geom, comm, state, v, lo_d, hi_d)
        state = state.replace(cell_overflow=state.cell_overflow + miss)
    return state.replace(v=v)


def _bonded_extra_forces(cfg: SceneConfig, n_loc: int, extras: HaloView,
                         rows, t_full, g_full, valid_full):
    """The angle, dihedral and improper forces on the owned rows over the
    owned and halo view in the global frame, each atom its own share
    (obmd_tpu/parallel/slab_decomp.py:891-925); rows: the resolved partner
    rows.  [n_loc, 3]."""
    x = extras.x_glob
    more = rows[2:]
    f = torch.zeros_like(x)
    if cfg.angle is not None:
        f = f + angle_forces(cfg.angle, cfg.box, x, rows[0], rows[1],
                             t_full, valid_full, more_partners=more)[0]
    if cfg.dihedral is not None:
        f = f + dihedral_forces(cfg.dihedral, cfg.box, x, rows[0], rows[1],
                                valid_full)[0]
    if cfg.improper is not None and extras.impr is not None:
        index = _tag_index(g_full, valid_full)
        impr_rows = torch.stack([_resolve_rows(g_full, valid_full,
                                               extras.impr[:, c], index)
                                 for c in range(3)], 1)
        f = f + improper_forces(cfg.improper, cfg.box, x, rows, impr_rows,
                                t_full, valid_full)[0]
    return f[:n_loc]


def _has_extra_terms(cfg: SceneConfig) -> bool:
    return any(t is not None for t in (cfg.angle, cfg.dihedral,
                                       cfg.improper))


def _forces_slab(cfg: SceneConfig, geom: SlabGeom, comm: Comm,
                 state: State, lo_d, hi_d):
    """Forces on the owned atoms from owned and halo atoms through the
    slab's cell grid (obmd_tpu/parallel/slab_decomp.py:928-958): the pair
    law, its 1-2 pairs (by partner tag, on a scene with a bond style or
    MOLECULE-mode insertion) left out and given the bond force instead,
    then the angle, dihedral and improper forces; (f [n_loc, 3], the halo
    rows and cell-table entries that did not fit, summed over the
    ranks)."""
    spec = geom.spec_local
    xs, v, t, g, q, valid, halo_miss, extras = _halo_arrays(
        cfg, geom, comm, state, lo_d, hi_d)
    ctab = build_cells(spec, xs, valid)
    n_loc = geom.n_loc
    my_pb = (torch.stack(state.bond_partners, 1)
             if cfg.bond is not None or mol_mode(cfg) else None)
    f, _ = forces_for_subset(
        cfg.pair, cfg.box, spec, ctab, xs, v, t, g, q,
        torch.arange(n_loc, device=state.device), xs[:n_loc], state.v,
        state.type, state.tag, state.q, pair_salt(cfg, state.step),
        dt=cfg.dt, my_pb=my_pb, bond=cfg.bond,
        sig_scale=sig_scale_of(cfg.pair, state.step, state.dtype))
    if extras is not None and _has_extra_terms(cfg):
        f = f + _bonded_extra_forces(
            cfg, n_loc, extras, _resolve_partner_rows(extras, g, valid), t,
            g, valid)
    return f, comm.sum(halo_miss + ctab.overflow)


def file_slab(cfg: SceneConfig, pg: PadGeometry, xs, v, t, g, q, valid,
              ptags=None):
    """Owned and halo rows filed into the slab's padded cell-major layout
    (obmd_tpu/parallel/slab_decomp.py:981-1031): rows sorted by cell,
    stable, each taking its rank in its cell (those beyond the cap are
    counted), then (fld f32[nb, NF, cap, lanes], tag i32[nb, cap, lanes],
    occ i32[nb], pbond i32[nb, n_excl, cap, lanes] of the rows' partner
    tags ptags (n_excl columns; -2 for none and on empty slots) or None,
    the slot of each row (n_slots where not filed), the rows that did not
    fit).  The fields are float32 whatever the rows' dtype: a float64 view
    is rounded into them, as engine_cellpad.pack_fields packs the
    single-device kernel's (the JAX slab step packs them in the state's
    dtype, obmd_tpu/parallel/slab_decomp.py:997-1008, which its float32
    kernel refuses under x64)."""
    n_full = xs.shape[0]
    dev = xs.device
    n_slots, n_cells, cap = pg.n_slots, pg.n_cells, pg.cap
    nb, lanes = pg.n_blocks, pg.lanes
    cell = torch.where(valid, pg.cell_of(xs), n_cells).long()
    order = torch.sort(cell, stable=True).indices
    sc = cell[order].contiguous()
    start = torch.searchsorted(sc, sc, side="left")
    rank = torch.arange(n_full, device=dev) - start
    ok = (sc < n_cells) & (rank < cap)
    overflow = ((sc < n_cells) & (rank >= cap)).sum(dtype=I32)
    dest = torch.where(ok, slot_index(pg, torch.clamp(sc, max=n_cells - 1),
                                      rank), n_slots)
    chans = [torch.where(valid[:, None], xs, BIG), v]
    if isinstance(cfg.pair, LJCutRFParams):
        chans.append(q[:, None])
    if cfg.ntypes > 1:
        chans.append(t[:, None])
    f32 = torch.float32
    flat = torch.cat([c.to(f32) for c in chans], 1)[order]
    nf = flat.shape[1]
    base = torch.cat([torch.full((n_slots, 3), BIG, dtype=f32, device=dev),
                      torch.zeros((n_slots, nf - 3), dtype=f32,
                                  device=dev)], 1)
    fld = scatter_rows(base, dest, flat).reshape(nb, cap, lanes, nf) \
        .permute(0, 3, 1, 2).contiguous()
    tag = scatter_rows(torch.full((n_slots,), -1, dtype=I32, device=dev),
                       dest, g[order]).reshape(nb, cap, lanes)
    pbond = None
    if ptags is not None:
        pb = torch.stack([torch.where(p >= 0, p, -2) for p in ptags], 1)
        pbond = scatter_rows(
            torch.full((n_slots, pb.shape[1]), -2, dtype=I32, device=dev),
            dest, pb[order]).reshape(nb, cap, lanes, -1) \
            .permute(0, 3, 1, 2).contiguous()
    filled = scatter_rows(torch.zeros((n_slots,), dtype=torch.bool,
                                      device=dev), dest, ok)
    ranks = torch.arange(cap, dtype=I32, device=dev)[None, :, None]
    occ = (torch.where(filled.reshape(nb, cap, lanes), ranks, -1)
           .amax(dim=(1, 2)) + 1).to(I32)
    slot_of_row = torch.empty((n_full,), dtype=torch.int64, device=dev)
    slot_of_row[order] = dest
    return fld, tag, occ, pbond, slot_of_row, overflow


def _forces_slab_kernel(cfg: SceneConfig, geom: SlabGeom, comm: Comm,
                        kern, state: State, lo_d, hi_d):
    """Forces on the owned atoms through the pair kernel on the slab's
    padded layout (obmd_tpu/parallel/slab_decomp.py:962-1056): the owned
    and halo rows filed every step (`file_slab`, with their partner tags
    under a bond style for the kernel's 1-2 exclusion), the kernel, the
    owned rows' forces read back (halo slots dropped) and cast to the
    state's dtype; then the bond forces over the resolved rows in the
    global frame and the angle, dihedral and improper forces; (f, the halo
    rows, cells and owned rows that did not fit, summed over the
    ranks)."""
    pg = geom.pad_geom
    n_loc = geom.n_loc
    xs, v, t, g, q, valid, halo_miss, extras = _halo_arrays(
        cfg, geom, comm, state, lo_d, hi_d)
    fld, tag, occ, pbond, slot_of_row, overflow = file_slab(
        cfg, pg, xs, v, t, g, q, valid,
        extras.btags if cfg.bond is not None else None)
    fpad = kern(fld, tag, pair_salt(cfg, state.step), occ, pbond,
                sig_scale=sig_scale_of(cfg.pair, state.step))
    f_all = torch.cat([fpad.permute(0, 2, 3, 1).reshape(-1, 3),
                       torch.zeros((1, 3), dtype=fpad.dtype,
                                   device=fpad.device)]).to(state.dtype)
    mine = slot_of_row[:n_loc]
    dropped = (valid[:n_loc] & (mine >= pg.n_slots)).sum(dtype=I32)
    f = f_all[mine]
    if extras is not None and (cfg.bond is not None
                               or _has_extra_terms(cfg)):
        rows = _resolve_partner_rows(extras, g, valid)
        if cfg.bond is not None:
            f = f + bond_forces(cfg.bond, cfg.box, extras.x_glob, rows[0],
                                rows[1], valid,
                                more_partners=rows[2:])[0][:n_loc]
        if _has_extra_terms(cfg):
            f = f + _bonded_extra_forces(cfg, n_loc, extras, rows, t, g,
                                         valid)
    return f, comm.sum(halo_miss + overflow + dropped)


def _local_region_subset(cfg: SceneConfig, geom: SlabGeom, state: State,
                         region, pad: float) -> Subset:
    """This rank's live atoms within `pad` of the region, compacted into
    b_max rows (obmd_tpu/parallel/slab_decomp.py:1059-1077): a candidate's
    energy is the sum over the ranks of its partial energies against
    these rows.  overflow: this rank's region atoms beyond b_max."""
    n_loc = geom.n_loc
    mask = state.alive & expand_region(region, pad).match(state.x)
    idx, valid, (px,), missed = _pack_rows(mask, geom.b_max, state.x,
                                           n=n_loc)
    safe = torch.clamp(idx, 0, n_loc - 1)
    return Subset(x=torch.where(valid[:, None], px, BIG),
                  type=torch.where(valid, state.type[safe], 0),
                  valid=valid, overflow=missed > 0,
                  q=torch.where(valid, state.q[safe], 0.0), idx=idx)


def _sum_energy_force(comm: Comm):
    """reduce(E, F) for subset.usher_search_subset_batch: both sides'
    partial energies and forces summed over the ranks in one all-reduce
    (obmd_tpu/parallel/slab_decomp.py:1080-1085), so that every rank steps
    the same search."""
    def reduce(E, F):
        ef = comm.sum(torch.cat([E[..., None], F], -1))
        return ef[..., 0], ef[..., 1:]
    return reduce


def _near_check_psum(cfg: SceneConfig, comm: Comm, subs, cands):
    """`near`'s test on both sides, with each candidate's least distance
    the minimum over the ranks (obmd_tpu/parallel/slab_decomp.py:
    1130-1137).  Returns ok [2, K]."""
    mins = []
    for sub, cand in zip(subs, cands):
        d = cfg.box.min_image(cand[:, None, :] - sub.x[None, :, :])
        rsq = (d * d).sum(-1)
        mins.append(torch.where(sub.valid[None, :], rsq, torch.inf)
                    .min(-1).values)
    return comm.min(torch.stack(mins)) >= near_squared(cfg)


def _doom_molecules(cfg: SceneConfig, geom: SlabGeom, comm: Comm,
                    state: State, doomed):
    """Whole-molecule deletion over the faces (obmd_tpu/parallel/
    slab_decomp.py:1400-1424): max(mol_natoms_max - 1, 1) rounds, each
    sending this rank's doomed tags (m_max of them) to both neighbours and
    dooming the live atoms with a partner tag among its own and the
    received lists.  Returns (doomed, the doomed atoms beyond the lists'
    m_max rows, summed over the rounds)."""
    n_loc = geom.n_loc
    missed = torch.zeros((), dtype=I32, device=state.device)
    for _ in range(max(cfg.obmd.mol_natoms_max - 1, 1)):
        idx, valid, _, miss = _pack_rows(doomed, geom.m_max, n=n_loc)
        dtags = torch.where(valid, state.tag[torch.clamp(idx, 0, n_loc - 1)],
                            -2)
        from_r, from_l = comm.exchange([dtags], [dtags])
        known = torch.cat([dtags, from_l[0], from_r[0]])
        hit = torch.zeros_like(doomed)
        for p in state.bond_partners:
            hit = hit | ((p >= 0) & torch.isin(p, known))
        doomed = doomed | (state.alive & hit)
        missed = missed + miss
    return doomed, missed


def _insert_mol_slab(cfg: SceneConfig, geom: SlabGeom, comm: Comm,
                     state: State, lo_d, hi_d, nins_l, nins_r, u, base):
    """MOLECULE-mode insertion on the slab (obmd_tpu/parallel/
    slab_decomp.py:1152-1373): each buffer's rounds of trials on every
    rank from the same draws (engine_cellpad._mol_rounds), the molecule
    USHER's sums and `near`'s minimum over the ranks, a round's accepted
    molecules appended to the subsets of the rank whose slab holds their
    centre only; then the rank that holds a molecule's centre (the edge
    ranks any centre beyond the box's faces) writes all its atoms into
    its free slots, whole or not at all, its partners and improper ends
    as tags.  The tags form one consecutive block per accepted molecule
    from `base`, the same layout on every rank, and maxtag advances by the
    accepted atoms; the velocity keywords' momentum and the counters are
    summed over the ranks, usher_iters divided by the world.  Returns
    (state, the inserted momenta [6], left then right)."""
    obmd = cfg.obmd
    n_loc = geom.n_loc
    dev = state.device
    tpl = _templates(obmd, dev, state.dtype)
    m = tpl["dx"].shape[1]
    pad = cfg.pair.max_cut + cfg.skin

    def visible(acc, pos, amask):
        cx = mol_com(pos, amask)[:, 0]
        return acc & (cx >= lo_d) & (cx < hi_d)
    sides = [_mol_rounds(cfg, state, s, region, budget,
                         _local_region_subset(cfg, geom, state, region, pad),
                         u, tpl, comm=comm, visible=visible)
             for s, region, budget in ((0, obmd.region5, nins_l),
                                       (1, obmd.region6, nins_r))]
    pos, accepted, tsel = (torch.cat([sides[0][i], sides[1][i]])
                           for i in range(3))
    iters = sides[0][3] + sides[1][3]
    km = pos.shape[0]
    am_k = tpl["amask"][tsel]
    nat_k = tpl["natoms"][tsel]
    com = mol_com(pos, am_k)
    cx = com[:, 0]
    mine = accepted & (cx >= lo_d) & (cx < hi_d)
    if comm.rank == 0:
        mine = mine | (accepted & (cx < lo_d))
    if comm.rank == comm.world - 1:
        mine = mine | (accepted & (cx >= hi_d))
    placed = torch.where(accepted, nat_k, 0)
    tag_base = base + torch.cumsum(placed, 0, dtype=I32) - placed
    tb_flat = tag_base.repeat_interleave(m)
    new_tag = tb_flat + torch.arange(m, dtype=I32, device=dev).repeat(km) + 1
    am_flat = am_k.reshape(km * m)
    rows = mine.repeat_interleave(m) & am_flat
    free = compact_indices(~state.alive, km * m, n_loc)
    lrank = torch.cumsum(rows.to(I32), 0, dtype=I32) - 1
    slot = torch.where(rows, free[torch.clamp(lrank, 0, km * m - 1).long()],
                       n_loc)
    landed = rows & (slot < n_loc)
    landed_mol = (landed.reshape(km, m) | ~am_k).all(1) & mine
    act = landed_mol.repeat_interleave(m) & am_flat
    slot = torch.where(act, slot, n_loc)

    def ptag(p_idx):
        p = p_idx.reshape(km * m)
        return torch.where((p >= 0) & act, tb_flat + p + 1, -1)

    def put(arr, vals):
        return scatter_rows(arr, slot, vals)
    upd = {}
    pidx, iidx = tpl["pidx"][tsel], tpl["iidx"][tsel]
    for c in range(len(state.bond_partners)):
        upd[PARTNER_NAMES[c]] = put(getattr(state, PARTNER_NAMES[c]),
                                    ptag(pidx[:, :, c]))
    if state.impr is not None:
        upd["impr"] = put(state.impr, torch.stack(
            [ptag(iidx[:, :, c]) for c in range(3)], 1))
    apos = pos.reshape(km * m, 3)
    z3 = torch.zeros_like(apos)
    types_k = tpl["types"][tsel]
    vnew = draw_inserted_velocities(cfg, u.vel, com)
    if vnew is None:
        av = z3
        pins = torch.zeros((6,), dtype=state.dtype, device=dev)
    else:
        av = vnew.repeat_interleave(m, dim=0)
        mol_mass = torch.where(am_k, const_like(cfg.masses, pos)[
            types_k.long()], 0.0).sum(1)
        mv = mol_mass[:, None] * torch.where(landed_mol[:, None], vnew, 0.0)
        pins = comm.sum(torch.cat([mv[:km // 2].sum(0),
                                   mv[km // 2:].sum(0)]))
    tot = comm.sum(torch.stack([torch.where(landed_mol, nat_k, 0)
                                .sum(dtype=I32),
                                landed_mol.sum(dtype=I32), iters]))
    want = torch.clamp(nins_l, min=0) + torch.clamp(nins_r, min=0)
    sc = state.obmd
    return state.replace(
        x=put(state.x, apos), v=put(state.v, av), f=put(state.f, z3),
        type=put(state.type, types_k.reshape(-1)), tag=put(state.tag, new_tag),
        q=put(state.q, tpl["q"][tsel].reshape(-1)),
        mol=put(state.mol, (tag_base + 1).repeat_interleave(m)),
        rep_atom=put(state.rep_atom, tpl["rep"][tsel].reshape(-1)),
        lambdaF=put(state.lambdaF, z3[:, 0]),
        alive=put(state.alive, torch.ones_like(act)),
        maxtag=base + placed.sum(dtype=I32), **upd,
        obmd=sc.replace(
            ninserted=sc.ninserted + tot[0],
            insert_fail=sc.insert_fail + torch.clamp(want - tot[1], min=0),
            usher_iters=sc.usher_iters + tot[2] // comm.world)), pins


def _pre_exchange_slab(cfg: SceneConfig, geom: SlabGeom, comm: Comm,
                       state: State, lo_d, hi_d, draw) -> State:
    """The OBMD stage on the slab (obmd_tpu/parallel/slab_decomp.py:
    1376-1595): local deletion (in MOLECULE mode whole molecules,
    `_doom_molecules`), the momentum tallies and census summed over the
    ranks; when a buffer needs atoms (the same verdict on every rank), in
    MOLECULE mode `_insert_mol_slab`, in ATOM mode `maxattempt` rounds of
    candidates from the same draws on every rank against each rank's
    buffer subsets, a round's accepted candidates appended to the subsets
    of their owner only; the owner by position writes each accepted
    candidate into its free slots, with the tag base + 1 + its rank among
    the accepted, its drawn velocity and their momentum summed into the
    tallies; the setpoints.  The tag base is the running maximum, under
    `id max` the largest live tag over the ranks.  Deleted atoms keep
    their velocity, as in the JAX slab step."""
    obmd = cfg.obmd
    box = cfg.box
    n_loc = geom.n_loc
    dev = state.device
    prm = stage_params(cfg, state)

    x0 = state.x[:, 0]
    doomed = state.alive & ((x0 < box.lo[0]) | (x0 > box.hi[0]))
    doom_missed = torch.zeros((), dtype=I32, device=dev)
    if mol_mode(cfg):
        doomed, doom_missed = _doom_molecules(cfg, geom, comm, state,
                                              doomed)
    left = doomed & (x0 < 0.5 * (box.lo[0] + box.hi[0]))
    mv = per_atom_mass(cfg, state)[:, None] * state.v
    alive = state.alive & ~doomed

    def census(region):
        m = alive & region.match(state.x)
        if obmd.group_types is not None:
            gm = torch.zeros_like(m)
            for ty in obmd.group_types:
                gm = gm | (state.type == int(ty))
            m = m & gm
        return m.sum(dtype=I32)
    counts = comm.sum(torch.stack([doomed.sum(dtype=I32),
                                   census(obmd.region1),
                                   census(obmd.region2), doom_missed]))
    tally = comm.sum(torch.cat([torch.where(left[:, None], mv, 0.0).sum(0),
                                torch.where((doomed & ~left)[:, None], mv,
                                            0.0).sum(0)]))
    vnewl, vnewr = tally[:3], tally[3:]
    clear = {k: torch.where(doomed, -1, getattr(state, k))
             for k in PARTNER_NAMES if getattr(state, k) is not None}
    if state.impr is not None:
        clear["impr"] = torch.where(doomed[:, None], -1, state.impr)
    state = state.replace(
        alive=alive, tag=torch.where(doomed, -1, state.tag), **clear,
        cell_overflow=state.cell_overflow + counts[3],
        obmd=state.obmd.replace(ndeleted=state.obmd.ndeleted + counts[0]))
    nins_l, nins_r = (feedback_count(c, obmd.mol_len, prm["alpha"],
                                     prm["nbuf"], prm["dt"], prm["tau"])
                      for c in counts[1:3])
    need = bool(((nins_l > 0) | (nins_r > 0)).item())
    u = draw(state, need)

    if obmd.id_policy == "max":
        base = comm.max(torch.where(state.alive, state.tag, 0).max())
    else:
        base = state.maxtag
    if not need:
        # nothing to insert: the running maximum tag as the insertion would
        # leave it (the reference searches on every call, and such a call
        # changes nothing but its iteration count)
        return setpoints(cfg, state.replace(maxtag=base), prm, vnewl, vnewr)
    if mol_mode(cfg):
        state, pins = _insert_mol_slab(cfg, geom, comm, state, lo_d, hi_d,
                                       nins_l, nins_r, u, base)
        return setpoints(cfg, state, prm, vnewl - pins[:3],
                         vnewr - pins[3:])

    k = obmd.insert_kmax
    rounds = rounds_of(cfg)
    mm = rounds * k
    pad = cfg.pair.max_cut + cfg.skin
    regions = (obmd.region5, obmd.region6)
    subs = [_local_region_subset(cfg, geom, state, r, pad) for r in regions]
    ctype = torch.full((k,), obmd.ntype, dtype=I32, device=dev)
    rem = [torch.clamp(b, 0, mm) for b in (nins_l, nins_r)]
    poss, accs = ([], []), ([], [])
    iters = torch.zeros((), dtype=I32, device=dev)
    for r in range(rounds):
        cands = [draw_candidates(cfg, u.pos[s, r],
                                 None if u.z is None else u.z[s, r],
                                 regions[s], state, comm=comm)
                 for s in (0, 1)]
        if obmd.usher is not None:
            pos2, ok2, it2 = usher_search_subset_batch(
                cfg, subs[0], subs[1], cands[0][0], cands[1][0], ctype,
                *regions, reduce=_sum_energy_force(comm))
            iters = iters + it2.sum(dtype=I32)
        else:
            pos2 = torch.stack([c[0] for c in cands])
            ok2 = _near_check_psum(cfg, comm, subs, [c[0] for c in cands])
        for s in (0, 1):
            acc, cnt = _sequential_accept(cfg, pos2[s], ctype,
                                          ok2[s] & cands[s][1],
                                          torch.clamp(rem[s], max=k))
            rem[s] = rem[s] - cnt
            if rounds > 1:
                # visible to later rounds on the owner only: the partial
                # sums over the ranks must count it once
                owner = acc & (pos2[s][:, 0] >= lo_d) & (pos2[s][:, 0] < hi_d)
                subs[s] = _append_subset(subs[s], pos2[s], owner, ctype,
                                         n_loc)
            poss[s].append(pos2[s])
            accs[s].append(acc)
    pos = torch.cat(poss[0] + poss[1])
    accepted = torch.cat(accs[0] + accs[1])

    px = pos[:, 0]
    mine = accepted & (px >= lo_d) & (px < hi_d)
    # the edge ranks own what lies beyond the box's faces
    if comm.rank == 0:
        mine = mine | (accepted & (px < lo_d))
    if comm.rank == comm.world - 1:
        mine = mine | (accepted & (px >= hi_d))
    m2 = 2 * mm
    free = compact_indices(~state.alive, m2, n_loc)
    lrank = torch.cumsum(mine.to(I32), 0, dtype=I32) - 1
    slot = torch.where(mine, free[torch.clamp(lrank, 0, m2 - 1).long()],
                       n_loc)
    landed = mine & (slot < n_loc)
    order = torch.cumsum(accepted.to(I32), 0, dtype=I32) - 1
    new_tag = base + 1 + order
    vnew = draw_inserted_velocities(cfg, u.vel, pos)
    z3 = torch.zeros_like(pos)
    if vnew is not None:
        mass = rounded(cfg.masses[obmd.ntype], state.dtype)
        mv_ins = mass * torch.where(landed[:, None], vnew, 0.0)
        pins = comm.sum(torch.cat([mv_ins[:mm].sum(0), mv_ins[mm:].sum(0)]))
        vnewl, vnewr = vnewl - pins[:3], vnewr - pins[3:]

    def put(arr, vals):
        return scatter_rows(arr, slot, vals)
    n_landed = comm.sum(landed.sum(dtype=I32))
    want = torch.clamp(nins_l, min=0) + torch.clamp(nins_r, min=0)
    sc = state.obmd
    state = state.replace(
        x=put(state.x, pos), v=put(state.v, z3 if vnew is None else vnew),
        f=put(state.f, z3), type=put(state.type, ctype.repeat(2 * rounds)),
        tag=put(state.tag, new_tag), q=put(state.q, z3[:, 0]),
        lambdaF=put(state.lambdaF, z3[:, 0]), alive=put(state.alive, landed),
        maxtag=base + n_landed,
        obmd=sc.replace(
            ninserted=sc.ninserted + n_landed,
            insert_fail=sc.insert_fail + torch.clamp(want - n_landed, min=0),
            usher_iters=sc.usher_iters + iters))
    return setpoints(cfg, state, prm, vnewl, vnewr)


def make_slab_step(cfg: SceneConfig, comm: Comm,
                   geom: Optional[SlabGeom] = None,
                   force_impl: str = "gathered", balance_every: int = 0,
                   draw=None):
    """The step of one rank's state (shard_by_slab's), with the semantics
    of integrate.make_step on the global state (obmd_tpu/parallel/
    slab_decomp.py:423-563).  force_impl: "gathered" (forces_for_subset on
    the slab's cell grid) or "kernel" (the pair kernel on the slab's
    padded layout, with 1-2 exclusion over 2 partner-tag channels, 4 on a
    branched topology, under a bond style).  balance_every > 0: every
    balance_every steps the cuts are recomputed from the live atoms' x
    histogram (`_rebalanced_cuts`); the live cuts ride in State.nbrs
    (`with_balance_cuts` installs them).  draw: the stage's draw seam
    (engine_cellpad.own_draws by default: the state's generator, seeded
    alike on every rank)."""
    cfg = cfg.finalize()
    check_slab_scene(cfg)
    if geom is None:
        geom = make_slab_geom(cfg, comm.world)
    if geom.ndev != comm.world:
        raise ValueError("geom/mesh device count mismatch")
    kern = None
    if force_impl == "kernel":
        if geom.pad_geom is None:
            raise ValueError("no per-slab PadGeometry for this box")
        kern = make_pair_kernel(
            geom.pad_geom, cfg.pair, cfg.dt,
            exclude_bonded=cfg.bond is not None,
            n_excl=N_EXCL_BRANCHED if cfg.branched_topology else N_EXCL)
    elif force_impl != "gathered":
        raise ValueError(f"unknown force_impl {force_impl}")
    draw = draw or own_draws(cfg)
    dt, dtf = step_times(cfg)
    nfreq = stage_every(cfg)
    bnd = torch.tensor(geom.boundaries, dtype=getattr(torch, cfg.dtype),
                       device=comm.device)

    def step(state: State) -> State:
        cuts = bnd
        if balance_every > 0:
            if not isinstance(state.nbrs, SlabCuts):
                raise ValueError(
                    "balance_every > 0 needs live cuts in state.nbrs — "
                    "pass the state through with_balance_cuts(geom, state)")
            cuts = state.nbrs.cuts
            if state.step % balance_every == 0:
                cuts = _rebalanced_cuts(cfg, geom, comm, state, cuts)
                state = state.replace(nbrs=SlabCuts(cuts=cuts))
        lo_d, hi_d = cuts[comm.rank], cuts[comm.rank + 1]
        state = _kick_drift_slab(cfg, geom, comm, state, lo_d, hi_d, dt, dtf)
        if cfg.obmd is not None and state.step % nfreq == 0:
            state = _pre_exchange_slab(cfg, geom, comm, state, lo_d, hi_d,
                                       draw)
        state = _migrate(cfg, geom, comm, state, lo_d, hi_d)
        if kern is not None:
            f, miss = _forces_slab_kernel(cfg, geom, comm, kern, state,
                                          lo_d, hi_d)
        else:
            f, miss = _forces_slab(cfg, geom, comm, state, lo_d, hi_d)
        state = state.replace(cell_overflow=state.cell_overflow + miss)
        if cfg.obmd is not None:
            f = boundary_force_psum(cfg, comm, state, f)
        f = torch.where(state.alive[:, None], f, 0.0)
        state = _kick_slab(cfg, geom, comm, state, f, lo_d, hi_d, dtf)
        return state.replace(f=f, step=state.step + 1)

    return step
