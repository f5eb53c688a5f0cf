"""The multi-device step by x-slab decomposition, over torch.distributed.

Counterpart of `obmd_tpu/parallel/slab_decomp.py` in ATOM mode.  The box
is cut into `world` x-slabs; rank r owns the atoms whose x lies in slab r,
in its own `State` of n_loc slots (the JAX package's shard r).  Each step:
  * the half kick, the drift and the y/z wrap, locally;
  * the OBMD stage (`_pre_exchange_slab`): deletion beyond the faces, the
    momentum tallies and the buffer census summed over the ranks; the
    insertion search on every rank from the same draws, each rank
    scanning only its own atoms near the buffers and the candidates'
    partial energies and forces summed over the ranks every USHER
    iteration (the reference's three MPI_Allreduce an iteration,
    fix_obmd_merged.cpp:1561-1563), so every rank steps the same
    trajectory and reaches the same verdicts; the slab that contains an
    accepted candidate writes it;
  * migration (`_migrate`): atoms that crossed a slab face move to the
    neighbour's free slots (comm_brick.cpp:652 exchange());
  * the halo (`_halo_arrays`): atoms within the halo width of a face are
    copied to the neighbour with their velocities (borders() and
    forward_comm(), comm_brick.cpp:771/:538);
  * forces on the owned atoms from owned plus halo atoms in the slab's own
    frame: `force_impl="gathered"` through the slab's cell grid
    (`forces.gathered.forces_for_subset`), or `"kernel"` through the pair
    kernel (`forces.pair_kernel.make_pair_kernel`, obmd_pair on the card)
    on the slab's padded cell-major layout (`SlabGeom.pad_geom`), owned
    and halo atoms filed into it every step and the forces on halo slots
    dropped (their owner computes the same pairs: the tag-keyed pair noise
    is symmetric, so Newton's third law holds across ranks with no
    reverse pass);
  * the boundary force with its weights' sums over the ranks, the second
    half kick.
Every value a host-side `if` reads before a collective (the demand gate,
the step for `nfreq` and `balance_every`) is the same on every rank.  A
scene with bonds, angles, dihedrals, impropers, SHAKE, rigid bodies or
MOLECULE-mode insertion raises NotImplementedError (the slab path's
MOLECULE mode stands in ROADMAP.md, Queue 1); so does the Langevin
thermostat, which the JAX slab step leaves out.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..cellpad import _center, compact_indices, scatter_rows, slot_index
from ..cells import BIG, GridSpec, build_cells
from ..config import LJCutRFParams, SceneConfig
from ..engine_cellpad import (check_scene, kick, kick_drift, own_draws,
                              pair_salt, stage_every)
from ..forces.gathered import forces_for_subset
from ..forces.pair_kernel import PadGeometry, make_pair_kernel
from ..forces.pairs import sig_scale_of
from ..obmd.stage import (_append_subset, _sequential_accept,
                          draw_candidates, draw_inserted_velocities,
                          feedback_count, rounds_of, setpoints, stage_params)
from ..obmd.subset import (Subset, expand_region, near_squared,
                           usher_search_subset_batch)
from ..geometry import Box
from ..state import State, per_atom_mass
from .atom_decomp import boundary_force_psum
from .comm import Comm

I32 = torch.int32


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
    want = x0 + (idx.to(dtype) + frac) * float(np.float32(w))
    step_max = float(np.float32(0.9 * geom.halo_w))
    inner = torch.minimum(torch.maximum(want, cuts[1:-1] - step_max),
                          cuts[1:-1] + step_max)
    wmin = float(np.float32(geom.halo_w))
    wmax = float(np.float32(geom.slab_w))
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
    molecule centres zero.  A slab of more than n_loc atoms raises."""
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
    """Raise for a scene the slab step does not run: MOLECULE mode and
    the molecule terms (not ported on the slab path: ROADMAP.md, Queue 1),
    the Langevin thermostat (the JAX slab step leaves it out), then the
    refusals every engine shares (engine_cellpad.check_scene)."""
    mol = cfg.obmd is not None and cfg.obmd.mol is not None
    if mol or cfg.shake is not None or cfg.rigid or any(
            t is not None for t in (cfg.bond, cfg.angle, cfg.dihedral,
                                    cfg.improper)):
        raise NotImplementedError(
            "the slab decomposition runs ATOM mode: bonds, angles, "
            "dihedrals, impropers, SHAKE, rigid bodies and molecule "
            "insertion on the slab path are not ported yet (ROADMAP.md, "
            "Queue 1: the slab's MOLECULE mode)")
    if cfg.langevin is not None:
        raise NotImplementedError(
            "the multi-device steps have no Langevin thermostat (the JAX "
            "steps leave it out)")
    check_scene(cfg)


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


def _halo_arrays(geom: SlabGeom, comm: Comm, state: State, lo_d, hi_d):
    """(xs_full, v_full, t_full, g_full, q_full, valid_full, missed): the
    owned rows, then the left halo (the left neighbour's atoms within the
    halo width of our face), then the right halo, positions in the slab
    frame x' = x - lo_d and BIG where not live; one exchange with both
    neighbours (obmd_tpu/parallel/slab_decomp.py:659-766, its ATOM
    payloads).  missed counts the face atoms beyond the h_max rows."""
    n_loc, h_max = geom.n_loc, geom.h_max
    w = float(np.float32(geom.halo_w))
    x0 = state.x[:, 0]
    near_lo = state.alive & (x0 < lo_d + w)
    near_hi = state.alive & (x0 >= hi_d - w)

    def pack(mask):
        idx, valid, (px, pv), missed = _pack_rows(mask, h_max, state.x,
                                                  state.v, n=n_loc)
        safe = torch.clamp(idx, 0, n_loc - 1)
        pq = torch.where(valid, state.q[safe], 0.0)
        ints = torch.stack([torch.where(valid, state.type[safe], 0),
                            torch.where(valid, state.tag[safe], 0),
                            valid.to(I32)], 1)
        return [px, pv, pq, ints], missed

    low, miss_l = pack(near_lo)
    high, miss_r = pack(near_hi)
    # my lower-face batch goes left, my upper-face batch right: my right
    # halo is the right neighbour's lower batch, my left halo the left
    # neighbour's upper batch
    (hr_x, hr_v, hr_q, hr_i), (hl_x, hl_v, hl_q, hl_i) = \
        comm.exchange(low, high)
    shift = torch.stack([lo_d, torch.zeros_like(lo_d), torch.zeros_like(lo_d)])

    def frame(xs, valid):
        return torch.where(valid[:, None], xs - shift[None, :], BIG)

    valid_l = hl_i[:, 2] > 0
    valid_r = hr_i[:, 2] > 0
    xs_full = torch.cat([frame(state.x, state.alive), frame(hl_x, valid_l),
                         frame(hr_x, valid_r)])
    return (xs_full, torch.cat([state.v, hl_v, hr_v]),
            torch.cat([state.type, hl_i[:, 0], hr_i[:, 0]]),
            torch.cat([state.tag, hl_i[:, 1], hr_i[:, 1]]),
            torch.cat([state.q, hl_q, hr_q]),
            torch.cat([state.alive, valid_l, valid_r]), miss_l + miss_r)


def _forces_slab(cfg: SceneConfig, geom: SlabGeom, comm: Comm,
                 state: State, lo_d, hi_d):
    """Pair forces on the owned atoms from owned and halo atoms through
    the slab's cell grid (obmd_tpu/parallel/slab_decomp.py:928-958):
    (f [n_loc, 3], the halo rows and cell-table entries that did not fit,
    summed over the ranks)."""
    spec = geom.spec_local
    xs, v, t, g, q, valid, halo_miss = _halo_arrays(geom, comm, state,
                                                    lo_d, hi_d)
    ctab = build_cells(spec, xs, valid)
    n_loc = geom.n_loc
    f, _ = forces_for_subset(
        cfg.pair, cfg.box, spec, ctab, xs, v, t, g, q,
        torch.arange(n_loc, device=state.device), xs[:n_loc], state.v,
        state.type, state.tag, state.q, pair_salt(cfg, state.step),
        dt=cfg.dt, sig_scale=sig_scale_of(cfg.pair, state.step))
    return f, comm.sum(halo_miss + ctab.overflow)


def file_slab(cfg: SceneConfig, pg: PadGeometry, xs, v, t, g, q, valid):
    """Owned and halo rows filed into the slab's padded cell-major layout
    (obmd_tpu/parallel/slab_decomp.py:981-1017): rows sorted by cell,
    stable, each taking its rank in its cell (those beyond the cap are
    counted), then (fld f32[nb, NF, cap, lanes], tag i32[nb, cap, lanes],
    occ i32[nb], the slot of each row (n_slots where not filed), the
    rows that did not fit)."""
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
        chans.append(t.to(xs.dtype)[:, None])
    flat = torch.cat(chans, 1)[order]
    nf = flat.shape[1]
    base = torch.cat([torch.full((n_slots, 3), BIG, dtype=xs.dtype,
                                 device=dev),
                      torch.zeros((n_slots, nf - 3), dtype=xs.dtype,
                                  device=dev)], 1)
    fld = scatter_rows(base, dest, flat).reshape(nb, cap, lanes, nf) \
        .permute(0, 3, 1, 2).contiguous()
    tag = scatter_rows(torch.full((n_slots,), -1, dtype=I32, device=dev),
                       dest, g[order]).reshape(nb, cap, lanes)
    filled = scatter_rows(torch.zeros((n_slots,), dtype=torch.bool,
                                      device=dev), dest, ok)
    ranks = torch.arange(cap, dtype=I32, device=dev)[None, :, None]
    occ = (torch.where(filled.reshape(nb, cap, lanes), ranks, -1)
           .amax(dim=(1, 2)) + 1).to(I32)
    slot_of_row = torch.empty((n_full,), dtype=torch.int64, device=dev)
    slot_of_row[order] = dest
    return fld, tag, occ, slot_of_row, overflow


def _forces_slab_kernel(cfg: SceneConfig, geom: SlabGeom, comm: Comm,
                        kern, state: State, lo_d, hi_d):
    """Pair forces on the owned atoms through the pair kernel on the
    slab's padded layout (obmd_tpu/parallel/slab_decomp.py:962-1056): the
    owned and halo rows filed every step (`file_slab`), the kernel, the
    owned rows' forces read back (halo slots dropped); (f, the halo rows,
    cells and owned rows that did not fit, summed over the ranks)."""
    pg = geom.pad_geom
    n_loc = geom.n_loc
    xs, v, t, g, q, valid, halo_miss = _halo_arrays(geom, comm, state,
                                                    lo_d, hi_d)
    fld, tag, occ, slot_of_row, overflow = file_slab(cfg, pg, xs, v, t, g,
                                                     q, valid)
    fpad = kern(fld, tag, pair_salt(cfg, state.step), occ,
                sig_scale=sig_scale_of(cfg.pair, state.step))
    f_all = torch.cat([fpad.permute(0, 2, 3, 1).reshape(-1, 3),
                       torch.zeros((1, 3), dtype=fpad.dtype,
                                   device=fpad.device)])
    mine = slot_of_row[:n_loc]
    dropped = (valid[:n_loc] & (mine >= pg.n_slots)).sum(dtype=I32)
    return f_all[mine], comm.sum(halo_miss + overflow + dropped)


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


def _pre_exchange_slab(cfg: SceneConfig, geom: SlabGeom, comm: Comm,
                       state: State, lo_d, hi_d, draw) -> State:
    """The OBMD stage on the slab (obmd_tpu/parallel/slab_decomp.py:
    1376-1595, ATOM mode): local deletion, the momentum tallies and census
    summed over the ranks; when a buffer needs atoms (the same verdict on
    every rank), `maxattempt` rounds of candidates from the same draws on
    every rank against each rank's buffer subsets, a round's accepted
    candidates appended to the subsets of their owner only; the owner by
    position writes each accepted candidate into its free slots, with the
    tag base + 1 + its rank among the accepted (`id max`: the largest
    live tag over the ranks), its drawn velocity and their momentum
    summed into the tallies; the setpoints.  Deleted atoms keep their
    velocity, as in the JAX slab step."""
    obmd = cfg.obmd
    box = cfg.box
    n_loc = geom.n_loc
    dev = state.device
    prm = stage_params(cfg, state)

    x0 = state.x[:, 0]
    doomed = state.alive & ((x0 < box.lo[0]) | (x0 > box.hi[0]))
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
                                   census(obmd.region2)]))
    tally = comm.sum(torch.cat([torch.where(left[:, None], mv, 0.0).sum(0),
                                torch.where((doomed & ~left)[:, None], mv,
                                            0.0).sum(0)]))
    vnewl, vnewr = tally[:3], tally[3:]
    clear = {k: torch.where(doomed, -1, getattr(state, k))
             for k in ("bond1", "bond2", "bond3", "bond4")
             if getattr(state, k) is not None}
    if state.impr is not None:
        clear["impr"] = torch.where(doomed[:, None], -1, state.impr)
    state = state.replace(
        alive=alive, tag=torch.where(doomed, -1, state.tag), **clear,
        obmd=state.obmd.replace(ndeleted=state.obmd.ndeleted + counts[0]))
    nins_l, nins_r = (feedback_count(c, obmd.mol_len, prm["alpha"],
                                     prm["nbuf"], prm["dt"], prm["tau"])
                      for c in counts[1:])
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
        mass = float(np.float32(cfg.masses[obmd.ntype]))
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
    padded layout).  balance_every > 0: every balance_every steps the cuts
    are recomputed from the live atoms' x histogram (`_rebalanced_cuts`);
    the live cuts ride in State.nbrs (`with_balance_cuts` installs them).
    draw: the stage's draw seam (engine_cellpad.own_draws by default:
    the state's generator, seeded alike on every rank)."""
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
        kern = make_pair_kernel(geom.pad_geom, cfg.pair, cfg.dt)
    elif force_impl != "gathered":
        raise ValueError(f"unknown force_impl {force_impl}")
    draw = draw or own_draws(cfg)
    dt = float(np.float32(cfg.dt))
    dtf = float(np.float32(0.5 * cfg.dt))
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
        state = kick_drift(cfg, state, dt, dtf)
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
        return state.replace(v=kick(cfg, state, f, dtf), f=f,
                             step=state.step + 1)

    return step
