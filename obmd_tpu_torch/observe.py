"""Observables: thermo quantities, x-resolved profiles, OBMD counters and
run audits.

Counterpart of `obmd_tpu/observe.py`.  Thermo and profiles run the pair
sweep (`forces/pairs.pair_sweep` over a fresh `cells.build_cells` table),
independent of the cellpad layout and its kernels.  Pressure convention
(LAMMPS): P_ab V = sum m v_a v_b + W_ab.  Under lj/cut/rf E_pair, pe and
the virial hold the reaction-field terms (evdwl + ecoul, as LAMMPS's
thermo pe).  Under dpd/tstat E_pair is zero (the law has no conservative
term), and the sweep runs without the ramp's noise scale, as the JAX
package's thermo does (obmd_tpu/observe.py:64-66): the pressure carries
the t_start noise amplitude (ROADMAP Queue 3); the temperature is
kinetic.  On a bonded scene E_bond, E_angle, E_dihed and E_imp are the
bond (FENE or harmonic), angle, dihedral and improper energies, and pe =
E_pair + E_bond + E_angle + E_dihed + E_imp (obmd_tpu/observe.py:85-115);
E_pair comes from the pair sweep, which has no 1-2 exclusion, so it holds
the bonded pairs' pair energy that the step leaves out (the JAX package's
convention, kept for parity; ROADMAP Queue 3).  The pressure omits the
bonded virial, as the JAX package's does.
"""
from __future__ import annotations

from typing import NamedTuple

__all__ = ("Thermo", "Profiles", "make_thermo_fn", "bonded_energies",
           "make_profile_fn", "profile_temperature", "make_obmd_metrics_fn",
           "molecule_census", "molecule_sizes", "molecule_report",
           "molecular_pxx", "rigid_error", "Bins",
           "bond_stats", "charge_census", "constraint_error",
           "ill_conditioned_impropers", "check_invariants")

import numpy as np
import torch

from .cells import build_cells
from .config import SceneConfig
from .forces.bonded import (angle_forces, bond_forces, dihedral_forces,
                            improper_forces)
from .forces.pairs import pair_sweep
from .integrate import _salt, make_grid_spec
from .shake import constraint_error
from .state import State, per_atom_mass, temperature


class Thermo(NamedTuple):
    step: int
    natoms: torch.Tensor
    temp: torch.Tensor
    pe: torch.Tensor          # total potential energy (epair + bonded)
    ke: torch.Tensor
    pressure: torch.Tensor    # (W_xx + W_yy + W_zz + sum m v^2) / (3V)
    pxx: torch.Tensor
    press_tensor: torch.Tensor   # pxx pyy pzz pxy pxz pyz
    epair: torch.Tensor
    ebond: torch.Tensor
    eangle: torch.Tensor
    edihed: torch.Tensor
    eimp: torch.Tensor
    fmax: torch.Tensor
    fnorm: torch.Tensor


class Profiles(NamedTuple):
    """x-binned profiles, each [nbins]."""

    x_centers: torch.Tensor
    density: torch.Tensor      # number density
    vx: torch.Tensor           # mean x velocity
    temp: torch.Tensor         # local temperature
    pxx: torch.Tensor          # local P_xx (kinetic + virial share)
    count: torch.Tensor


class Bins:
    """Sums of rows into bins in a fixed order, where index_add would run
    as float atomics on CUDA (two evaluations on one state could differ in
    their last digits): the rows stably sorted by bin, each put at (bin,
    rank in its bin) of a zero-padded [nbins, most rows a bin, ...] table,
    summed over the rank axis.  The same bins and rows give the same bytes
    on every call."""

    def __init__(self, idx: torch.Tensor, nbins: int):
        idx = idx.long()
        self.nbins = nbins
        self.order = torch.sort(idx, stable=True).indices
        self.bin = idx[self.order]
        count = torch.bincount(idx, minlength=nbins)
        first = torch.cumsum(count, 0) - count
        self.rank = torch.arange(idx.numel(), device=idx.device) \
            - first[self.bin]
        self.width = int(count.max()) if idx.numel() else 0

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        """[nbins, ...] sums of vals [rows, ...] by bin."""
        table = torch.zeros((self.nbins, self.width) + vals.shape[1:],
                            dtype=vals.dtype, device=vals.device)
        table[self.bin, self.rank] = vals[self.order]
        return table.sum(1)


def _sweep(cfg: SceneConfig, spec, state: State, **kw):
    ctab = build_cells(spec, state.x, state.alive)
    return pair_sweep(cfg.pair, cfg.box, spec, ctab, state.x, state.v,
                      state.type, state.tag, _salt(cfg, state.step),
                      dt=cfg.dt, q=state.q, **kw)


def make_thermo_fn(cfg: SceneConfig):
    """thermo(state) -> Thermo, the `thermo_style` quantities of one
    state."""
    cfg = cfg.finalize()
    spec = make_grid_spec(cfg)
    vol = cfg.box.volume

    def thermo(state: State) -> Thermo:
        pf = _sweep(cfg, spec, state, compute_energy=True,
                    compute_virial=True)
        m = per_atom_mass(cfg, state)
        alive = state.alive
        mv2 = torch.where(alive[:, None], m[:, None] * state.v ** 2, 0.0)
        w = pf.virial
        pressure = (mv2.sum() + w[0] + w[1] + w[2]) / (3.0 * vol)
        pxx = (mv2[:, 0].sum() + w[0]) / vol
        v_ = torch.where(alive[:, None], state.v, 0.0)
        mvv = torch.stack([
            mv2[:, 0].sum(), mv2[:, 1].sum(), mv2[:, 2].sum(),
            (m * v_[:, 0] * v_[:, 1]).sum(), (m * v_[:, 0] * v_[:, 2]).sum(),
            (m * v_[:, 1] * v_[:, 2]).sum()])
        epair = torch.where(alive, pf.pe, 0.0).sum()
        ebond, eangle, edihed, eimp = bonded_energies(cfg, state)
        fa = torch.where(alive[:, None], state.f, 0.0)
        return Thermo(step=state.step, natoms=state.natoms,
                      temp=temperature(cfg, state),
                      pe=epair + ebond + eangle + edihed + eimp,
                      ke=0.5 * mv2.sum(), pressure=pressure, pxx=pxx,
                      press_tensor=(mvv + w) / vol, epair=epair, ebond=ebond,
                      eangle=eangle, edihed=edihed, eimp=eimp,
                      fmax=fa.abs().max(), fnorm=torch.sqrt((fa * fa).sum()))

    return thermo


def bonded_energies(cfg: SceneConfig, state: State):
    """(E_bond, E_angle, E_dihed, E_imp) of a state over its alive atoms,
    0-dim tensors (zero for a term the scene lacks)."""
    x, alive, more = state.x, state.alive, state.bond_partners[2:]
    zero = torch.zeros((), dtype=state.dtype, device=state.device)
    out = [zero] * 4
    terms = (
        (cfg.bond, lambda: bond_forces(
            cfg.bond, cfg.box, x, state.bond1, state.bond2, alive,
            compute_energy=True, more_partners=more)),
        (cfg.angle, lambda: angle_forces(
            cfg.angle, cfg.box, x, state.bond1, state.bond2, state.type,
            alive, compute_energy=True, more_partners=more)),
        (cfg.dihedral, lambda: dihedral_forces(
            cfg.dihedral, cfg.box, x, state.bond1, state.bond2, alive,
            compute_energy=True)),
        (cfg.improper if state.impr is not None else None,
         lambda: improper_forces(cfg.improper, cfg.box, x,
                                 state.bond_partners, state.impr, state.type,
                                 alive, compute_energy=True)))
    for k, (params, energy) in enumerate(terms):
        if params is not None:
            out[k] = torch.where(alive, energy()[1], 0.0).sum()
    return tuple(out)


def make_profile_fn(cfg: SceneConfig, nbins: int = 64):
    """Instantaneous profile snapshot along x; average over calls on the
    host."""
    cfg = cfg.finalize()
    spec = make_grid_spec(cfg)
    xlo, xhi = cfg.box.lo[0], cfg.box.hi[0]
    dx = (xhi - xlo) / nbins
    ly, lz = cfg.box.lengths[1], cfg.box.lengths[2]
    bin_vol = dx * ly * lz

    def profiles(state: State) -> Profiles:
        dtype = state.dtype
        pf = _sweep(cfg, spec, state, compute_virial_atom=True)
        alive = state.alive
        m = per_atom_mass(cfg, state)
        b = torch.clamp(((state.x[:, 0] - xlo) / dx).to(torch.int32), 0,
                        nbins - 1).long()
        bins = Bins(b[alive], nbins)

        def binsum(vals):
            return bins.sum(vals[alive])

        cnt = binsum(torch.ones_like(m))
        safe = torch.clamp(cnt, min=1.0)
        mvx2 = m * state.v[:, 0] ** 2
        mv2 = m * (state.v ** 2).sum(-1)
        return Profiles(
            x_centers=xlo + (torch.arange(nbins, dtype=dtype,
                                          device=state.device) + 0.5) * dx,
            density=cnt / bin_vol,
            vx=binsum(state.v[:, 0]) / safe,
            temp=binsum(mv2) / (3.0 * safe),
            pxx=(binsum(mvx2) + binsum(pf.virial_atom[:, 0])) / bin_vol,
            count=cnt)

    return profiles


def profile_temperature(cfg: SceneConfig, state: State,
                        nbins: int) -> torch.Tensor:
    """The thermal temperature under a flow along x, as LAMMPS' `compute
    temp/profile 1 1 1 x nbins`: each atom's velocity less its x-bin's
    mass-weighted mean velocity, over 3N - 3 - 3 * nbins degrees of
    freedom (kB = 1).  `temperature` (state.py) counts such a flow as
    heat."""
    xlo, xhi = cfg.box.lo[0], cfg.box.hi[0]
    alive = state.alive
    m = torch.where(alive, per_atom_mass(cfg, state), 0.0)
    b = torch.clamp(((state.x[:, 0] - xlo) * (nbins / (xhi - xlo)))
                    .to(torch.int64), 0, nbins - 1)
    mv = torch.where(alive[:, None], m[:, None] * state.v, 0.0)
    sums = Bins(b[alive], nbins).sum(torch.cat([m[:, None], mv], dim=1)[alive])
    msum, mvsum = sums[:, 0], sums[:, 1:]
    vbin = mvsum / torch.clamp(msum, min=1e-30)[:, None]
    dv = state.v - vbin[b]
    ke2 = torch.where(alive[:, None], m[:, None] * dv ** 2, 0.0).sum()
    dof = torch.clamp(3 * state.natoms - 3 - 3 * nbins, min=1).to(m.dtype)
    return ke2 / dof


class ObmdMetrics(NamedTuple):
    step: int
    nbuf_left: torch.Tensor
    nbuf_right: torch.Tensor
    ninserted: torch.Tensor
    ndeleted: torch.Tensor
    insert_fail: torch.Tensor
    usher_iters: torch.Tensor
    momentum_force_left: torch.Tensor
    momentum_force_right: torch.Tensor


def make_obmd_metrics_fn(cfg: SceneConfig):
    cfg = cfg.finalize()
    if cfg.obmd is None:
        raise ValueError("scene has no OBMD stage")
    r1, r2 = cfg.obmd.region1, cfg.obmd.region2

    def metrics(state: State) -> ObmdMetrics:
        def count(region):
            return (state.alive & region.match(state.x)).sum(dtype=torch.int32)
        sc = state.obmd
        return ObmdMetrics(
            step=state.step, nbuf_left=count(r1), nbuf_right=count(r2),
            ninserted=sc.ninserted, ndeleted=sc.ndeleted,
            insert_fail=sc.insert_fail, usher_iters=sc.usher_iters,
            momentum_force_left=sc.momentum_force_left,
            momentum_force_right=sc.momentum_force_right)

    return metrics


def molecule_census(cfg: SceneConfig, state: State, templates=None):
    """(molecules, broken) of a MOLECULE-mode scene whose molecules all
    follow one of its insertion templates: the live molecule ids (mol !=
    0), and those not whole: a count of live atoms and a bond-partner
    count that are not some template's natoms and twice its bonds, or an
    atom with a partner slot that is dead, of another molecule or does not
    name it back.  `templates`: those of the stage when None."""
    n = state.capacity
    member = state.alive & (state.mol != 0)
    ids = torch.where(member, state.mol, 0).long()
    size = int(ids.max()) + 1
    count = torch.bincount(ids[member], minlength=size)
    me = torch.arange(n, device=state.device)
    deg = torch.zeros((n,), dtype=torch.int64, device=state.device)
    bad = torch.zeros((n,), dtype=torch.bool, device=state.device)
    cols = state.bond_partners
    for col in cols:
        has = member & (col >= 0)
        p = torch.clamp(col.long(), 0, n - 1)
        back = torch.zeros_like(bad)
        for other in cols:
            back = back | (other[p].long() == me)
        bad = bad | (has & ~(state.alive[p] & (state.mol[p] == state.mol)
                             & back))
        deg = deg + has.long()
    degsum = torch.bincount(ids[member], weights=deg[member].double(),
                            minlength=size)
    shapes = {(t.natoms, 2 * len(t.bonds))
              for t in templates or cfg.obmd.templates}
    broken = torch.ones_like(count, dtype=torch.bool)
    for natoms, degs in shapes:
        broken = broken & ~((count == natoms) & (degsum == degs))
    broken[ids[member & bad]] = True
    live = count > 0
    live[0] = False
    return int(live.sum()), int((broken & live).sum())


def bond_stats(cfg: SceneConfig, state: State, limit=None):
    """(longest bond, bonds at or beyond `limit`, bonds) of a bonded state,
    each bond counted once.  The limit is r0 when None: FENE clamps a bond
    at r >= r0 without an error (the reference warns), so a blow-up shows
    only here and as a hot melt; a harmonic melt passes its own limit."""
    n = state.capacity
    own = torch.arange(n, device=state.device)
    longest = torch.zeros((), dtype=state.dtype, device=state.device)
    over = count = 0
    for partner in state.bond_partners:
        j = torch.clamp(partner.long(), 0, n - 1)
        once = state.alive & (partner >= 0) & state.alive[j] & (j > own)
        d = cfg.box.min_image(state.x - state.x[j])
        r = torch.where(once, torch.sqrt((d * d).sum(-1)), 0.0)
        longest = torch.maximum(longest, r.max())
        over = over + (r >= (cfg.bond.r0 if limit is None else limit)).sum()
        count = count + once.sum()
    return float(longest), int(over), int(count)


def charge_census(state: State):
    """(net charge, charged atoms) over the alive atoms: an open charged
    fluid loses ions at its faces and inserts neutral solvent, so both
    drift (the reference's ATOM mode does the same)."""
    q = torch.where(state.alive, state.q, 0.0)
    return float(q.sum()), int((q != 0.0).sum())


def molecule_sizes(state: State) -> torch.Tensor:
    """The census of the molecules: i64 [max mol id + 1], each molecule
    id's live atoms (0 for an id no live atom carries; index 0 counts the
    atoms outside any molecule)."""
    ids = torch.where(state.alive, state.mol, 0).long()
    return torch.bincount(ids[state.alive], minlength=1)


def molecule_report(cfg: SceneConfig, state: State, templates=None) -> dict:
    """A molecule path's audit figures: the live molecules and those not
    whole (molecule_census), the molecules by atom count (from
    molecule_sizes: {atoms: molecules}), the net charge over the live
    atoms and, under SHAKE, the largest constraint error (nm in the
    water scenes; shake.constraint_error); `templates` as
    molecule_census's."""
    n, broken = molecule_census(cfg, state, templates)
    sizes = molecule_sizes(state)[1:]
    by = torch.bincount(sizes[sizes > 0])
    out = dict(molecules=n, broken=broken,
               atoms_per_molecule={int(k): int(c) for k, c in enumerate(by)
                                   if c > 0},
               net_charge=charge_census(state)[0])
    if cfg.shake is not None:
        out["constraint_error"] = float(constraint_error(cfg, state))
    if cfg.rigid:
        out["rigid_error"] = rigid_error(cfg, state, templates)
    return out


def rigid_error(cfg: SceneConfig, state: State, templates=None) -> float:
    """The rigid bodies' largest distance error against their template
    (nm in the water scenes): over every live molecule whose atoms, in tag
    order, have a template's count and types (insertion and the water
    lattice write a molecule in template order), the largest |r_ij -
    r_ij(template)| over all its pairs, bonded or not (a water's H-H
    too).  `templates`: those of the stage when None; 0.0 without
    any."""
    if templates is None:
        templates = cfg.obmd.templates if cfg.obmd is not None else ()
    member = state.alive & (state.mol != 0)
    err = 0.0
    if not templates or not bool(member.any()):
        return err
    rows = torch.nonzero(member).flatten()
    key = state.mol[rows].long() * (int(state.tag.max()) + 1) \
        + state.tag[rows].long()
    rows = rows[torch.argsort(key)]
    _, count = torch.unique_consecutive(state.mol[rows], return_counts=True)
    first = torch.cumsum(count, 0) - count
    for t in templates:
        m = t.natoms
        start = first[count == m]
        if start.numel() == 0:
            continue
        idx = rows[start[:, None] + torch.arange(m, device=rows.device)]
        types = torch.as_tensor(t.types, device=rows.device)
        idx = idx[(state.type[idx] == types).all(1)]
        d = cfg.box.min_image(state.x[idx] - state.x[idx[:, :1]]).double()
        dx = torch.as_tensor(t.dx, dtype=torch.float64, device=rows.device)
        got = (d[:, :, None] - d[:, None]).norm(dim=-1)
        want = (dx[:, None] - dx[None]).norm(dim=-1)
        if got.numel():
            err = max(err, float((got - want).abs().max()))
    return err


def molecular_pxx(cfg: SceneConfig, state: State, k_max: int = 640,
                  cell_capacity: int = 0):
    """The molecular P_xx of a molecule scene whose intramolecular pairs
    are all excluded (a bond style on, every pair of a molecule bonded:
    path I's rigid water), and the atomic one thermo would read with the
    exclusion: (P_xx molecular, P_xx atomic).  V P_xx,mol = sum_mol M
    V_x^2 + W_xx - sum_a (r_a - R_mol(a))_x f_a,x, with W the pair virial
    0.5 sum d (x) F over the intermolecular pairs (nlist_sweep on a fresh
    Verlet list of k_max rows, 1-2 pairs out), f_a each atom's pair force
    alone (no Langevin term), V_com the molecules' centre-of-mass
    velocities and r_a - R_mol(a) taken by minimum image from one atom of
    the molecule; atoms of mol 0 are molecules of one.  A SHAKE scene's
    constraint forces are internal to a molecule and do no molecular
    virial, which is why this form holds where thermo's atomic one (no
    constraint virial, obmd_tpu/observe.py:56-72) does not."""
    from .cells import GridSpec
    from .forces.nlist import nlist_sweep
    from .neighbors import NeighborParams, full_rebuild
    box = cfg.box
    n = state.capacity
    dev = state.device
    spec = GridSpec.create(box, cfg.pair.max_cut + cfg.skin,
                           cell_capacity or cfg.capacity.cell_capacity)
    p = NeighborParams(spec=spec, k_max=k_max, cutoff=cfg.pair.max_cut,
                       skin=cfg.skin)
    x, v, alive = state.x, state.v, state.alive
    nb = full_rebuild(p, box, x, alive)
    if int(nb.overflow):
        raise RuntimeError(f"molecular_pxx: the Verlet list dropped "
                           f"{int(nb.overflow)} candidates (raise k_max or "
                           "cell_capacity)")
    more = state.bond_partners[2:]
    pf = nlist_sweep(cfg.pair, box, nb.nlist, x, v, state.type, state.tag,
                     state.q, alive, 0, dt=cfg.dt, bond1=state.bond1,
                     bond2=state.bond2, more_bonds=more,
                     compute_virial=True)
    f = torch.where(alive[:, None], pf.f, 0.0).double()
    m = torch.where(alive, per_atom_mass(cfg, state), 0.0).double()
    slot = torch.arange(n, device=dev)
    key = torch.where(alive & (state.mol != 0), state.mol.long(),
                      -1 - slot)
    _, mid = torch.unique(key, return_inverse=True)
    n_mol = int(mid.max()) + 1
    # each molecule's lowest slot as its reference atom (an index_put of
    # every slot would keep an arbitrary one on CUDA, and the frame of
    # the sums with it)
    ref = torch.full((n_mol,), n, dtype=torch.long, device=dev)
    ref = ref.scatter_reduce(0, mid, slot, reduce="amin")
    d = box.min_image(x - x[ref[mid]]).double()
    mols = Bins(mid, n_mol)
    msum = mols.sum(m)
    safe = torch.clamp(msum, min=1e-30)[:, None]
    dcom = mols.sum(m[:, None] * d) / safe
    vcom = mols.sum(m[:, None] * v.double()) / safe
    rel = d - dcom[mid]
    kin_mol = (msum * vcom[:, 0] ** 2).sum()
    kin_atom = (m * v[:, 0].double() ** 2).sum()
    w = float(pf.virial[0])
    inner = (rel[:, 0] * f[:, 0]).sum()
    vol = float(np.prod(box.lengths))
    return (float(kin_mol + w - inner) / vol, float(kin_atom + w) / vol)


def ill_conditioned_impropers(cfg: SceneConfig, state: State,
                              s_min: float = 0.05) -> torch.Tensor:
    """bool [N]: the slots (center and its three ends) of every improper
    whose float32 force carries amplified rounding: sin(chi) below s_min
    (chi near 0 or pi, the acos derivative) or 1 - c^2 below s_min for
    either of its two bond-angle cosines c1, c2 (arms near collinear,
    where improper_harmonic.cpp's 1 / (1 - c^2) grows to its cap 1 /
    SMALL), each taken in float64 as improper_harmonic.cpp constructs it.
    There two correct float32 evaluations in another operation order
    differ by far more than elsewhere (validation/run_improper_golden.py
    :142-150)."""
    out = torch.zeros_like(state.alive)
    if cfg.improper is None or state.impr is None:
        return out
    x = state.x.double()
    n = x.shape[0]
    impr = state.impr.long()
    k_t = torch.tensor(cfg.improper.k, dtype=torch.float64, device=x.device)
    ok = state.alive & (k_t[state.type.long().clamp(0, len(k_t) - 1)] > 0)
    ok = ok & (impr >= 0).all(dim=1)
    ends = impr.clamp(0, n - 1)
    x1, x3, x4 = (x[ends[:, c]] for c in range(3))
    vb1 = cfg.box.min_image(x1 - x)
    vb2 = cfg.box.min_image(x3 - x)
    vb3 = cfg.box.min_image(x4 - x3)
    r1, r2, r3 = (torch.rsqrt(torch.clamp((v * v).sum(-1), min=1e-24))
                  for v in (vb1, vb2, vb3))
    c0 = (vb1 * vb3).sum(-1) * r1 * r3
    c1 = (vb1 * vb2).sum(-1) * r1 * r2
    c2 = -(vb3 * vb2).sum(-1) * r3 * r2
    s1, s2 = 1.0 - c1 * c1, 1.0 - c2 * c2
    c = torch.clamp((c1 * c2 + c0) * torch.rsqrt(
        torch.clamp(s1 * s2, min=1e-24)), -1.0, 1.0)
    bad = ok & ((torch.sqrt(1.0 - c * c) < s_min) | (s1 < s_min)
                | (s2 < s_min))
    out = out | bad
    for col in range(3):
        out[ends[bad, col]] = True
    return out


def check_invariants(cfg: SceneConfig, state: State) -> dict:
    """Host-side audit of a finished run's validity counters: nonzero cell
    overflow, layout overflow (on the nlist and sweep engines the cell
    table's and the Verlet list's dropped candidates) or half-skin trips
    (the cellpad layout's; a Verlet list rebuilds instead) mean pair
    interactions were dropped or stale.  Under `rigid` with insertion
    templates it reports the bodies' largest distance error against them
    (`rigid_error`, a figure, not a gate).  Returns the counters; raises
    RuntimeError on a violation."""
    tel = {"cell_overflow": int(state.cell_overflow)}
    nbrs = state.nbrs
    if nbrs is not None:
        tel["layout_overflow"] = int(nbrs.overflow)
        if hasattr(nbrs, "skin_trips"):
            tel["skin_trips"] = int(nbrs.skin_trips)
        tel["rebuilds"] = int(nbrs.rebuilds)
    if cfg.rigid and cfg.obmd is not None and cfg.obmd.templates:
        tel["rigid_error"] = rigid_error(cfg, state)
    if cfg.obmd is not None:
        tel["ninserted"] = int(state.obmd.ninserted)
        tel["ndeleted"] = int(state.obmd.ndeleted)
        tel["insert_fail"] = int(state.obmd.insert_fail)
        tel["usher_iters"] = int(state.obmd.usher_iters)
    bad = {k: tel[k] for k in ("cell_overflow", "layout_overflow",
                               "skin_trips") if tel.get(k)}
    if bad:
        raise RuntimeError(
            f"run invariants violated: {bad} — pair interactions were "
            f"dropped or stale (raise Capacity.cell_capacity or "
            f"max_neighbors, or lower rebuild_every). Full telemetry: {tel}")
    return tel
