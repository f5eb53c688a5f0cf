"""The cellpad engine: the step over the padded cell-major layout.

Counterpart of `obmd_tpu/engine_cellpad.py` for DPD (uniform or gaussian
noise), lj/cut or lj/cut/rf with 1-4 atom types, in an open-x box with
ATOM-mode USHER or `near` insertion (OBMD_DPD, the open LJ fluid, the open
charged two-type LJ fluid) or MOLECULE-mode insertion of one or several
templates with their bonds, angles, impropers and charges (the open
star-polymer melt, the open SPC/E water: `_insert_mol` with every keyword
of the fix, whole-molecule deletion, the molecules' centers of mass after
every step), with SHAKE/RATTLE constraints (`shake.py`) or rigid bodies
(`rigid.py`: the bodies moved whole in the drift, their velocities
projected after the second half kick),
or a closed box without the OBMD stage (the LJ
melt; with FENE chains, the chain melt; with harmonic bonds, angles,
dihedrals on chains and impropers on branched topologies of up to four
bonds per atom, the star-polymer melt), with or without the Langevin
thermostat; and dpd/tstat, with or without its temperature ramp (under
the OBMD stage its insertion search is the plain one: USHER has no
energy to steer by).  The JAX cellpad engine refuses dpd/tstat and runs
it on its nlist and slab engines through the same TPU kernel; the port
runs it here, the ramp's noise scale computed on the host per step
beside the noise salt (`forces.pairs.sig_scale_of`).  Per-atom charges
and types follow every relayout on a scene that has them
(`relayout_flags`); masses are per type.  Step order mirrors
Verlet::run: half kick, drift + wrap, the epoch relayout on an epoch's
first step, the OBMD stage (face deletion, buffer census, feedback
law, demand-gated subset compaction and insertion, boundary-force
setpoints), the pair kernel (1-2 pairs excluded on a bonded scene, 4
exclusion channels on a branched topology) plus the boundary force plus
the bond, angle, dihedral and improper forces plus the Langevin force,
half kick.

The pair kernel is make_pair_kernel's (`kernel="pair"`, the default) or the
legacy full-stencil make_dpd_kernel's (`kernel="full"`); both compute the
same forces.

ATOM-mode insertion runs `maxattempt` candidate rounds per stage call,
each round's accepted candidates appended to the subsets the next round
searches, with the fix deposit's candidate keywords (`gaussian`, `rate`,
`global`, `local`) and inserted velocities (`vx`/`vy`/`vz`, `target`)
whose momentum enters the setpoints' tally; the census may count a group
of types (`group_types`); the stage may run every `nfreq` steps.

Random numbers go through a draw seam: `draw(state, need)` is called
once per stage call and returns the call's `obmd.stage.Draws` when `need`
is true, else None.  `own_draws` uses the state's generator; a parity
test passes a function that replays the JAX engine's own random draws.

The demand gate (the reference's `lax.cond` on "either buffer needs
atoms") is a host-side `if`: one device-to-host read per stage call.  The
skip branch leaves the state as the reference's skip branch does: no
subset-overflow count, no USHER iterations, no insertion, and under `id
max` the running maximum tag recomputed.  In MOLECULE
mode the JAX engine runs its search on the skip branch's empty subsets
too; there every trial's energy is 0 and its force 0, so each stops at
iteration 0 (accepted below a positive etarget, degenerate otherwise) and
none is taken (the budget is 0): the counters come out the same.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from . import rng
from .cellpad import (PadAux, layout_build, maybe_rebuild, note_skin_check,
                      patch_kernel_caches, place_insertions,
                      relayout_incremental, scatter_rows, slab_slice_bounds,
                      compact_indices)
from .cells import BIG
from .config import (DTYPES, DPDTstatParams, LJCutRFParams, SceneConfig,
                     template_stacks)
from .geometry import const, const_like, rounded
from .rigid import check_bodies, rigid_drift, rigid_project
from .shake import rattle_velocities, shake_positions
from .forces.bonded import (angle_forces, bond_forces, dihedral_forces,
                            improper_forces, langevin_force)
from .forces.pair_kernel import (N_EXCL, N_EXCL_BRANCHED, PadGeometry,
                                 check_supported as kernel_check_supported,
                                 legacy_kwargs, make_dpd_kernel,
                                 make_pair_kernel)
from .forces.pairs import sig_scale_of
from .obmd.stage import (Draws, delete_outside, draw_candidates,
                         draw_inserted_velocities, draw_shapes,
                         feedback_count, insertion_tag_base,
                         inserted_momenta, rounds_of, search_rounds,
                         setpoints, skipped_insertion, smooth_weight,
                         stage_params)
from .obmd.subset import (Subset, expand_region, mol_candidates_sel,
                          mol_sequential_accept, near_check_subset_mol,
                          random_rotations, usher_search_subset_mol)
from .adress import update_mol_com
from .state import State, per_atom_mass

PURPOSE_PAIR_NOISE = 1

Draw = Callable[[State, bool], Optional[torch.Tensor]]


def mol_mode(cfg: SceneConfig) -> bool:
    """The OBMD stage inserts molecules (the fix's `mol` keyword)."""
    return cfg.obmd is not None and cfg.obmd.mol is not None


def own_draws(cfg: SceneConfig) -> Draw:
    """Production draws from the state's generator, only when needed:
    normal positions' draws under `gaussian`, else uniform ones (in
    MOLECULE mode the rotation's draws uniform either way), the template
    of each trial by `molfrac` with several templates, and the uniforms of
    the deposit z and the velocities where their keywords are set."""
    if cfg.obmd is None:
        return lambda state, need: None
    mol = mol_mode(cfg)
    shapes = draw_shapes(cfg, rounds_of(cfg), cfg.obmd.insert_kmax,
                         7 if mol else 3)
    gauss = cfg.obmd.gaussian is not None
    frac = template_stacks(cfg.obmd).frac if mol else None

    def draw(state: State, need: bool):
        if not need:
            return None
        kw = dict(generator=state.gen, dtype=state.dtype,
                  device=state.device)
        pos = (torch.randn if gauss else torch.rand)(shapes["pos"], **kw)
        if mol and gauss:
            pos[..., 3:] = torch.rand(pos[..., 3:].shape, **kw)
        z, vel = (None if shapes[f] is None else torch.rand(shapes[f], **kw)
                  for f in ("z", "vel"))
        tpl = None
        if shapes["tpl"] is not None:
            p = const(tuple(float(f) for f in frac), torch.float32,
                      state.device)
            n = int(np.prod(shapes["tpl"][:-1]))
            tpl = torch.multinomial(p.expand(n, -1), shapes["tpl"][-1],
                                    replacement=True, generator=state.gen
                                    ).reshape(shapes["tpl"]).to(torch.int32)
        return Draws(pos, z, vel, tpl)
    return draw


# why no single-device engine runs a float64 scene with MOLECULE-mode
# insertion
FLOAT64_MOL = (
    "MOLECULE-mode insertion at float64 runs on the slab decomposition "
    "(parallel.slab_decomp.make_slab_step, on one rank or more); no "
    "single-device engine runs it, as none of the JAX package's does: its "
    "nlist and sweep engines refuse molecule insertion "
    "(obmd_tpu/integrate.py:282-285) and its cellpad engine fails under "
    "x64 with any stage, the lax.cond in its _insert having branches "
    "whose iteration counts differ in type (obmd_tpu/engine_cellpad.py:539 "
    "int64 from _rounds_body, :616 int32 from _skip_rounds)")


def check_float64(cfg: SceneConfig) -> None:
    """Raise for a float64 scene with MOLECULE-mode insertion on a
    single-device engine (FLOAT64_MOL).  Every other float64 scene of
    config.DTYPES, bonded terms, SHAKE/RATTLE and rigid bodies included,
    runs on the single-device engines (tests/test_torch_float64_bonded.py,
    test_torch_float64_rigid.py), and the slab decomposition runs
    molecule insertion at float64 too (test_torch_float64_parallel.py)."""
    if cfg.dtype == "float64" and mol_mode(cfg):
        raise NotImplementedError(FLOAT64_MOL)


def check_scene(cfg: SceneConfig) -> None:
    """The refusals every engine shares: a dtype of config.DTYPES (float32
    or float64), as many masses as the pair law has types, and an OBMD
    stage only on an open x axis, without bonded terms in ATOM mode (where
    the JAX engines bond a survivor of a deleted partner to the next atom
    inserted into its slot)."""
    if cfg.dtype not in DTYPES:
        raise NotImplementedError(f"dtype {cfg.dtype!r}: scenes run in "
                                  f"{' or '.join(DTYPES)}")
    if cfg.ntypes != cfg.pair.ntypes:
        raise ValueError(f"{cfg.ntypes} masses for a pair law of "
                         f"{cfg.pair.ntypes} types")
    o = cfg.obmd
    if o is None:
        return
    if cfg.box.periodic[0]:
        raise ValueError("open boundaries require an open x axis")
    if not mol_mode(cfg) and any(t is not None for t in (
            cfg.bond, cfg.angle, cfg.dihedral, cfg.improper)):
        # the JAX engines run this case: ATOM-mode deletion takes single
        # atoms, a survivor's partner column stays on the dead slot, and the
        # next insertion there bonds the survivor to a stranger; LAMMPS
        # stops ("Bond atoms missing"), and so does the port
        raise NotImplementedError(
            "bonded terms with ATOM-mode insertion are refused: deletion at "
            "a face takes single atoms, and a bonded survivor would keep its "
            "dead partner's slot, which an insertion refills with a "
            "stranger (tests/test_torch_atom_bonded.py; the reference stops "
            "with 'Bond atoms missing'); insert molecules with the `mol` "
            "keyword")


# why the cellpad engine refuses a float64 scene with an OBMD stage
FLOAT64_STAGE = (
    "a float64 scene with an OBMD stage runs on the nlist engine "
    "(force_path='nlist'), in float64 throughout; the cellpad engine "
    "refuses it, as the JAX cellpad engine fails on it under x64: the "
    "lax.cond in its _insert has branches whose iteration counts differ "
    "in type (obmd_tpu/engine_cellpad.py:539 int64 from _rounds_body, "
    ":616 int32 from _skip_rounds)")


def check_supported(cfg: SceneConfig) -> None:
    """Raise for a configuration the port's cellpad engine cannot run yet:
    open boxes with ATOM-mode USHER or `near` insertion or MOLECULE-mode
    insertion (any maxattempt and nfreq, the deposit and inserted-velocity
    keywords, a census of `group_types`; in MOLECULE mode several
    templates by `molfrac`, `charged 1`, `orient` and `shake`) and closed
    boxes without the OBMD stage, each DPD, lj/cut or lj/cut/rf with 1-4
    types (as many masses as the pair law has types), with or without the
    Langevin thermostat and SHAKE/RATTLE constraints; dpd/tstat; FENE or
    harmonic bonds, harmonic angles, dihedrals (chains only, as
    obmd_tpu/engine_cellpad.py:149-154) and impropers, on chains or
    branched topologies (the pair kernel's 4-channel exclusion); rigid
    bodies, whose trees setup checks (rigid.check_bodies; check_scene's
    refusals first).  At float64 the state is float64 and the kernel
    fields float32, as the JAX engine runs it; a float64 scene with an
    OBMD stage is refused (FLOAT64_MOL in MOLECULE mode, else
    FLOAT64_STAGE)."""
    check_scene(cfg)
    check_float64(cfg)
    if cfg.dtype == "float64" and cfg.obmd is not None:
        raise NotImplementedError(FLOAT64_STAGE)
    if mol_mode(cfg):
        top = int(template_stacks(cfg.obmd).types.max())
        if top >= cfg.ntypes:
            raise ValueError(f"the insertion template reaches type "
                             f"{top + 1} of a {cfg.ntypes}-type scene")
    if cfg.dihedral is not None and cfg.branched_topology:
        raise NotImplementedError(
            "dihedrals on branched topologies (>2 bonds/atom) are not "
            "supported by the center-bond dihedral storage")
    kernel_check_supported(make_geometry(cfg), cfg.pair)
    if cfg.branched_topology and cfg.bond is not None:
        _make_kernel(cfg, make_geometry(cfg))


def supports(cfg: SceneConfig) -> bool:
    """True when the port's cellpad engine runs this configuration."""
    try:
        check_supported(cfg.finalize())
    except (ValueError, NotImplementedError):
        return False
    return True


def make_geometry(cfg: SceneConfig) -> PadGeometry:
    return PadGeometry.create(cfg.box, cfg.pair.max_cut + cfg.skin,
                              cfg.capacity.cell_capacity)


def relayout_flags(cfg: SceneConfig) -> dict:
    """Which optional per-atom columns must follow relayout row-moves: a
    column constant over the scene (no bonds, no molecules, no charges, one
    type) skips its moves (obmd_tpu/engine_cellpad.py:52-72 for the ported
    columns).  has_bonds moves the partner columns (two or four) and the
    improper triplets, on a scene with a bond style, SHAKE or rigid
    bodies (both read the partner columns, rigid bodies the molecule ids
    too); MOLECULE-mode insertion turns on bonds, molecules
    and charges (the template's q), and has_mol_com, the molecule columns
    only it writes (lambdaF, cms_mol, vcms_mol, rep_atom; the JAX engine
    moves them with has_mol, zeros on every other scene)."""
    mol = mol_mode(cfg)
    has_bonds = (cfg.bond is not None or mol or cfg.shake is not None
                 or cfg.rigid)
    has_mol = has_bonds or cfg.angle is not None or cfg.dihedral is not None
    return dict(has_bonds=has_bonds, has_mol=has_mol,
                has_charge=isinstance(cfg.pair, LJCutRFParams) or mol,
                has_types=cfg.ntypes > 1, has_mol_com=mol)


def _make_kernel(cfg: SceneConfig, geom: PadGeometry, kernel: str = "pair"):
    """The step's pair kernel; on a bonded scene with 1-2 exclusion over 2
    partner channels, or 4 on a branched topology
    (obmd_tpu/engine_cellpad.py:75-78)."""
    excl = cfg.bond is not None
    if kernel == "pair":
        return make_pair_kernel(
            geom, cfg.pair, cfg.dt, exclude_bonded=excl,
            n_excl=N_EXCL_BRANCHED if cfg.branched_topology else N_EXCL)
    if kernel == "full":
        if cfg.ntypes > 1 or isinstance(cfg.pair, LJCutRFParams):
            # make_dpd_kernel has one type and no charges
            # (pallas_dpd.py:877-907)
            raise NotImplementedError(
                "the full-stencil kernel takes one neutral type")
        if excl and cfg.branched_topology:
            # make_dpd_kernel's exclusion has two channels (:968-971)
            raise NotImplementedError(
                "the full-stencil kernel excludes over two partner "
                "channels: a branched topology needs four")
        return make_dpd_kernel(geom, **legacy_kwargs(cfg.pair, cfg.dt),
                               exclude_bonded=excl)
    raise ValueError(f'kernel must be "pair" or "full", not {kernel!r}')


def pair_salt(cfg: SceneConfig, step: int) -> int:
    """The pair noise's uint32 salt of a step (0 seed for a law without
    noise)."""
    return rng.step_salt(getattr(cfg.pair, "seed", 0), step,
                         PURPOSE_PAIR_NOISE)


def partner_tags(geom, state: State) -> torch.Tensor:
    """pbond i32[nb, n_excl, cap, lanes]: each slot's bond partners as tags,
    -2 for none, one gather per partner column (2, or 4 on a branched
    topology; the kernel compares j tags)."""
    n = state.capacity
    chans = [torch.where(b >= 0, state.tag[torch.clamp(b.long(), 0, n - 1)],
                         -2).reshape(geom.n_blocks, geom.cap, geom.lanes)
             for b in state.bond_partners]
    return torch.stack(chans, dim=1)


def pack_fields(cfg, geom, state: State):
    """The pair kernel's inputs: (fld f32[nb, NF, cap, lanes] = x (BIG at
    dead slots), v, then q for lj/cut/rf, then the type as a float with 2-4
    types (obmd_tpu/engine_cellpad.py:81-101); tag3d; the step's noise
    salt; occ; on a bonded scene the partner tags pbond, else None).  The
    fields are float32 whatever the state's dtype: a float64 state is
    rounded into them, as the JAX engine packs them (:94-99)."""
    nb, cap, lanes = geom.n_blocks, geom.cap, geom.lanes
    chans = [torch.where(state.alive[:, None], state.x, BIG), state.v]
    if isinstance(cfg.pair, LJCutRFParams):
        chans.append(state.q[:, None])
    if cfg.ntypes > 1:
        chans.append(state.type[:, None])
    fld = torch.cat([c.to(torch.float32) for c in chans], dim=1) \
        .reshape(nb, cap, lanes, -1) \
        .permute(0, 3, 1, 2).contiguous()
    aux: PadAux = state.nbrs
    pbond = partner_tags(geom, state) if cfg.bond is not None else None
    return fld, aux.tag3d, pair_salt(cfg, state.step), aux.occ, pbond


def _forces(cfg, geom, kern, state: State) -> torch.Tensor:
    """Pair kernel on the packed fields (with a dpd/tstat ramp's noise
    scale of the salt's step, obmd_tpu/integrate.py:51-53), its float32
    force cast to the state's dtype (obmd_tpu/engine_cellpad.py:130), then
    the boundary force, the bond, angle, dihedral and improper forces and
    the Langevin force, in the JAX engine's order
    (obmd_tpu/engine_cellpad.py:131-166)."""
    fpad = kern(*pack_fields(cfg, geom, state),
                sig_scale=sig_scale_of(cfg.pair, state.step))
    f = fpad.permute(0, 2, 3, 1).reshape(-1, 3).to(state.dtype)
    if cfg.obmd is not None:
        f = _boundary_force_sliced(cfg, geom, state, f)
    f = add_bonded_forces(cfg, state, f)
    if cfg.langevin is not None:
        f = f + langevin_force(cfg.langevin, cfg, state)
    return torch.where(state.alive[:, None], f, 0.0)


def add_bonded_forces(cfg, state: State, f) -> torch.Tensor:
    """f plus the bond, angle, dihedral and improper forces of the state,
    added in that order (f itself on a scene without them)."""
    x, alive, more = state.x, state.alive, state.bond_partners[2:]
    if cfg.bond is not None:
        f = f + bond_forces(cfg.bond, cfg.box, x, state.bond1, state.bond2,
                            alive, more_partners=more)[0]
    if cfg.angle is not None:
        f = f + angle_forces(cfg.angle, cfg.box, x, state.bond1, state.bond2,
                             state.type, alive, more_partners=more)[0]
    if cfg.dihedral is not None:
        if more:
            raise NotImplementedError(
                "dihedrals on branched topologies (>2 bonds/atom) are not "
                "supported by the center-bond dihedral storage")
        f = f + dihedral_forces(cfg.dihedral, cfg.box, x, state.bond1,
                                state.bond2, alive)[0]
    if cfg.improper is not None and state.impr is not None:
        f = f + improper_forces(cfg.improper, cfg.box, x, state.bond_partners,
                                state.impr, state.type, alive)[0]
    return f


def _boundary_force_sliced(cfg, geom, state: State, f):
    """f_i += F * g_i / sum(g) over each region's contiguous slot slice
    (ref :1414-1516): smooth weights in the buffers, mass weights in the
    shear sub-regions, each atom's mass that of its type.  Elementwise
    scale*F adds only, never a matmul."""
    obmd = cfg.obmd
    sc = state.obmd
    f = f.clone()
    for region, F, smooth in (
            (obmd.region1, sc.momentum_force_left, True),
            (obmd.region2, sc.momentum_force_right, True),
            (obmd.region3, sc.shear_force_left, False),
            (obmd.region4, sc.shear_force_right, False)):
        if region is None or region.hi[0] <= region.lo[0]:
            continue
        a, b = slab_slice_bounds(geom, cfg.box, region.lo[0], region.hi[0])
        xs = state.x[a:b]
        m = _slice_mass(cfg, state, a, b)
        member = state.alive[a:b] & region.match(xs)
        g = torch.where(member, smooth_weight(cfg, xs[:, 0], m) if smooth
                        else m, 0.0)
        gsum = g.sum()
        scale = torch.where(gsum > 0.0, g / torch.clamp(gsum, min=1e-30), 0.0)
        f[a:b] = f[a:b] + scale[:, None] * F
    return f


def _slice_mass(cfg, state: State, a: int, b: int) -> torch.Tensor:
    """The masses of slots [a, b): masses[type] (one value with one
    type)."""
    if cfg.ntypes == 1:
        return torch.full((b - a,), float(cfg.masses[0]), dtype=state.dtype,
                          device=state.device)
    return const_like(cfg.masses, state.x)[state.type[a:b].long()]


def _region_count_sliced(cfg, geom, state: State, region) -> torch.Tensor:
    """stage.region_count over the region's contiguous slot slice: the
    live atoms inside it, of the census group's types when `group_types`
    is set (obmd_tpu/engine_cellpad.py:212-225)."""
    a, b = slab_slice_bounds(geom, cfg.box, region.lo[0], region.hi[0])
    m = state.alive[a:b] & region.match(state.x[a:b])
    gt = cfg.obmd.group_types
    if gt is not None:
        ty = state.type[a:b]
        gm = torch.zeros_like(m)
        for t in gt:
            gm = gm | (ty == int(t))
        m = m & gm
    return m.sum(dtype=torch.int32)


def _subset_bounds(cfg, geom, region, pad):
    a, b = slab_slice_bounds(geom, cfg.box, region.lo[0] - pad,
                             region.hi[0] + pad)
    n = b - a
    return a, b, min(n, int(0.45 * n) + 256)


def _subset_slice(cfg, geom, state, region, pad) -> Subset:
    """Buffer subset: a contiguous slot slice compacted to its live rows
    (at most b_max = min(n, 0.45 n + 256); more is counted as overflow),
    with the rows' types and charges on a scene that has them (type 0 and
    no charges otherwise)."""
    a, b, b_max = _subset_bounds(cfg, geom, region, pad)
    n = b - a
    xs = state.x[a:b]
    valid = state.alive[a:b] & expand_region(region, pad).match(xs)
    sel = compact_indices(valid, b_max, n)
    ok = sel < n
    safe = torch.clamp(sel, 0, n - 1)
    flags = relayout_flags(cfg)
    if flags["has_types"]:
        ty = torch.where(ok, state.type[a:b][safe], 0)
    else:
        ty = torch.zeros((b_max,), dtype=torch.int32, device=xs.device)
    q = torch.where(ok, state.q[a:b][safe], 0.0) \
        if flags["has_charge"] else None
    return Subset(
        x=torch.where(ok[:, None], xs[safe], BIG),
        type=ty,
        valid=ok,
        overflow=valid.sum() > b_max,
        q=q)


def _insert(cfg, geom, state: State, nins_l, nins_r, sub_l, sub_r, u):
    """ATOM-mode insertion (obmd_tpu/engine_cellpad.py:513-697):
    `maxattempt` rounds of up to K candidates per buffer
    (stage.search_rounds: the candidate draws, USHER or, under `near`
    insertion, the distance check of the unmoved candidates, greedy
    in-order acceptance within the budget left, the round appended to the
    subsets), then free-rank placement of all 2 x rounds x K candidates,
    the kernel-cache patch, and the drawn velocities written where a
    velocity keyword is set (a dead slot's v is 0, so at rest the column
    is left alone).  Inserted atoms take type ntype and charge 0 where the
    scene has those columns.  Only called when a buffer needs atoms; `u`
    holds the call's draws.  Returns (state, pins_l, pins_r), the inserted
    momenta by side."""
    obmd = cfg.obmd
    n_slots = geom.n_slots
    pos, accepted, iters = search_rounds(cfg, state, nins_l, nins_r, sub_l,
                                         sub_r, u, n_slots)
    m2 = pos.shape[0]
    slot, landed = place_insertions(geom, state, pos, accepted)
    vnew = draw_inserted_velocities(cfg, u.vel, pos)
    pins_l, pins_r = inserted_momenta(cfg, vnew, landed)
    order = torch.cumsum(landed.to(torch.int32), 0, dtype=torch.int32) - 1
    base = insertion_tag_base(cfg, state)
    new_tag = base + 1 + order
    aux: PadAux = state.nbrs
    aux = aux.replace(xref=scatter_rows(aux.xref, slot, pos))
    aux = patch_kernel_caches(geom, aux, slot, new_tag, n_slots)
    n_landed = landed.sum(dtype=torch.int32)
    want = torch.clamp(nins_l, min=0) + torch.clamp(nins_r, min=0)
    sc = state.obmd
    flags = relayout_flags(cfg)
    upd = {}
    if vnew is not None:
        upd["v"] = scatter_rows(state.v, slot, vnew)
    if flags["has_types"] or obmd.ntype != 0:
        upd["type"] = scatter_rows(state.type, slot, torch.full(
            (m2,), obmd.ntype, dtype=torch.int32, device=state.device))
    if flags["has_charge"]:
        upd["q"] = scatter_rows(state.q, slot, torch.zeros_like(pos[:, 0]))
    return state.replace(
        x=scatter_rows(state.x, slot, pos),
        tag=scatter_rows(state.tag, slot, new_tag),
        alive=scatter_rows(state.alive, slot, torch.ones_like(landed)),
        nbrs=aux, maxtag=base + n_landed, **upd,
        obmd=sc.replace(
            ninserted=sc.ninserted + n_landed,
            insert_fail=sc.insert_fail + torch.clamp(want - n_landed, min=0),
            usher_iters=sc.usher_iters + iters)), pins_l, pins_r


@functools.lru_cache(maxsize=8)
def _templates(obmd, device, real):
    """The insertion templates' stacks as tensors on `device`, padded to the
    largest template's m atoms (config.template_stacks): dx [T, m, 3], amask
    [T, m], types [T, m], q [T, m], rep [T, m], natoms [T], pidx [T, m, 4],
    iidx [T, m, 3]; dx and q in `real`, the state's dtype (as
    obmd_tpu/obmd/subset.py:221 and :299 take the centers')."""
    ts = template_stacks(obmd)

    def t(a, dtype):
        return torch.tensor(a, dtype=dtype, device=device)
    return dict(dx=t(ts.dx, real), amask=t(ts.amask, torch.bool),
                types=t(ts.types, torch.int32), q=t(ts.q, real),
                rep=t(ts.rep, torch.int32), natoms=t(ts.natoms, torch.int32),
                pidx=t(ts.pidx, torch.int64), iidx=t(ts.iidx, torch.int64))


def _append_mol(sub: Subset, pos, acc, types_k, q_k, am_k) -> Subset:
    """This round's molecule trials appended to the subset, their real
    atoms valid where accepted (x BIG elsewhere), so later rounds see them
    (obmd_tpu/engine_cellpad.py:336-354)."""
    kk, m = am_k.shape
    accr = acc.repeat_interleave(m) & am_k.reshape(kk * m)
    return Subset(
        x=torch.cat([sub.x, torch.where(accr[:, None],
                                        pos.reshape(kk * m, 3), BIG)]),
        type=torch.cat([sub.type, types_k.reshape(kk * m)]),
        valid=torch.cat([sub.valid, accr]),
        overflow=sub.overflow,
        q=None if sub.q is None else torch.cat([sub.q,
                                                q_k.reshape(kk * m)]))


def mol_com(pos, amask):
    """Each trial's geometric centre [K, 3] over its real atoms (amask [K,
    m]) of pos [K, m, 3]."""
    ones = torch.ones_like(amask, dtype=pos.dtype)
    return (torch.where(amask[:, :, None], pos, 0.0).sum(1)
            / torch.clamp(torch.where(amask, ones, 0.0).sum(1),
                          min=1.0)[:, None])


def _rank_sums(comm):
    """reduce(E, F, Fa) for subset.usher_search_subset_mol: a molecule's
    partial energies, net forces and per-atom forces summed over the ranks
    in one all-reduce (obmd_tpu/parallel/slab_decomp.py:1239-1243); with
    F None, the energies alone."""
    def reduce(e, f, fa):
        if f is None:
            return comm.sum(e), None, None
        k = e.shape[0]
        buf = comm.sum(torch.cat([e[:, None], f, fa.reshape(k, -1)], 1))
        return buf[:, 0], buf[:, 1:4], buf[:, 4:].reshape(fa.shape)
    return reduce


def _mol_rounds(cfg, state, side, region, budget, sub, u, tpl, comm=None,
                visible=None):
    """One buffer's `maxattempt` rounds (obmd_tpu/engine_cellpad.py:356-399):
    per round K trials, each of the template u.tpl picks (template 0 where
    None) at the candidate draw (`draw_candidates`: uniform, `gaussian`,
    `rate`, `global`, `local`) with the rotation of the axis and angle
    uniforms (the axis draws unread under `orient`), the molecule USHER
    search (with the template charges under `charged 1`) or the `near`
    check, every real atom inside the region, greedy in-order acceptance
    within the budget left; with rounds > 1 the round's accepted molecules
    appended to the subset.  Under the slab decomposition (obmd_tpu/
    parallel/slab_decomp.py:1217-1263) `comm` completes the deposit's
    zmax, the search's partial sums (`_rank_sums`) and `near`'s distances
    over the ranks, and visible(acc, pos, amask) picks the accepted
    molecules this rank appends.  Returns (pos [M, m, 3], accepted [M],
    tsel [M], usher iterations)."""
    obmd = cfg.obmd
    k = obmd.insert_kmax
    rounds = rounds_of(cfg)
    dev = state.device
    rem = torch.clamp(budget, 0, rounds * k)
    poss, accs, tsels = [], [], []
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    for r in range(rounds):
        us = u.pos[side, r]
        tsel = (torch.zeros((k,), dtype=torch.int64, device=dev)
                if u.tpl is None else u.tpl[side, r].long())
        centers, ok0 = draw_candidates(
            cfg, us[:, 0:3], None if u.z is None else u.z[side, r], region,
            state, comm=comm)
        rots = random_rotations(us[:, 3:6], us[:, 6], axis=obmd.orient)
        am_k = tpl["amask"][tsel]
        types_k = tpl["types"][tsel]
        q_k = tpl["q"][tsel]
        coords = mol_candidates_sel(tpl["dx"][tsel], am_k, centers, rots)
        if obmd.usher is not None:
            pos, ok, it = usher_search_subset_mol(
                cfg, sub, coords, types_k, region,
                mol_q=q_k if obmd.charged else None, amask=am_k,
                reduce=None if comm is None else _rank_sums(comm))
            iters = iters + it.sum(dtype=torch.int32)
        else:
            pos, ok = coords, near_check_subset_mol(
                cfg, sub, coords,
                reduce_min=None if comm is None else comm.min)
        ok = ok & ok0 & torch.all(region.match(pos) | ~am_k, dim=1)
        acc, cnt = mol_sequential_accept(cfg, pos, types_k, ok,
                                         torch.clamp(rem, max=k))
        rem = rem - cnt
        if rounds > 1:
            sub = _append_mol(sub, pos, acc if visible is None
                              else visible(acc, pos, am_k), types_k, q_k,
                              am_k)
        poss.append(pos)
        accs.append(acc)
        tsels.append(tsel)
    return torch.cat(poss), torch.cat(accs), torch.cat(tsels), iters


def _insert_mol(cfg, geom, state: State, nins_l, nins_r, sub_l, sub_r, u):
    """MOLECULE-mode insertion (obmd_tpu/engine_cellpad.py:288-510): each
    buffer's rounds of trials (`_mol_rounds`), then free ranks for all
    accepted atoms, and a molecule placed whole or not at all.  Placed
    atoms take consecutive tags in candidate order (left rounds, then
    right), the molecule id of the first atom's tag, their template's
    types, charges and rep_atom flags, lambdaF 0, centers of mass 0 until
    the step's end, and partner and improper slots resolved from the
    template's graph; a template's pad rows are masked out.  Without a
    velocity keyword a molecule is inserted at rest; with one, every atom
    of a molecule takes the velocity drawn at its trial's geometric
    center (`draw_inserted_velocities`, `target` pointing from there), and
    the molecules' momenta, by the masses of the template's types, are
    returned per side for the tally.  `u` holds the call's Draws.  Returns
    (state, pins_l, pins_r)."""
    obmd = cfg.obmd
    n_slots = geom.n_slots
    dev = state.device
    tpl = _templates(obmd, dev, state.dtype)
    m = tpl["dx"].shape[1]
    pos_l, acc_l, ts_l, it_l = _mol_rounds(cfg, state, 0, obmd.region5,
                                           nins_l, sub_l, u, tpl)
    pos_r, acc_r, ts_r, it_r = _mol_rounds(cfg, state, 1, obmd.region6,
                                           nins_r, sub_r, u, tpl)
    pos = torch.cat([pos_l, pos_r])                         # [2M, m, 3]
    accepted = torch.cat([acc_l, acc_r])                    # [2M]
    tsel = torch.cat([ts_l, ts_r])                          # [2M]
    km = pos.shape[0]
    am_k = tpl["amask"][tsel]                               # [2M, m]
    am_flat = am_k.reshape(km * m)
    apos = pos.reshape(km * m, 3)
    slot, landed = place_insertions(
        geom, state, apos, accepted.repeat_interleave(m) & am_flat)
    landed_mol = (landed.reshape(km, m) | ~am_k).all(1) & accepted
    act = landed_mol.repeat_interleave(m) & am_flat
    slot = torch.where(act, slot, n_slots)                  # atomic commit

    base = insertion_tag_base(cfg, state)
    placed = torch.where(landed_mol, tpl["natoms"][tsel], 0)
    tag_base = base + torch.cumsum(placed, 0, dtype=torch.int32) - placed
    atom_idx = torch.arange(m, dtype=torch.int32, device=dev).repeat(km)
    new_tag = tag_base.repeat_interleave(m) + atom_idx + 1
    mol_id = (tag_base + 1).repeat_interleave(m)
    base_flat = torch.arange(km * m, device=dev) // m * m

    def pslot(p_idx):
        """Each placed atom's partner of template index p_idx [2M, m] as a
        slot (-1 for none)."""
        p = p_idx.reshape(km * m)
        pf = torch.clamp(base_flat + p, 0, km * m - 1)
        return torch.where((p >= 0) & act, slot[pf], -1)

    upd = {}
    pidx, iidx = tpl["pidx"][tsel], tpl["iidx"][tsel]
    for c, name in enumerate(("bond1", "bond2", "bond3", "bond4")):
        if getattr(state, name) is not None:
            upd[name] = scatter_rows(getattr(state, name), slot,
                                     pslot(pidx[:, :, c]))
    if state.impr is not None:
        upd["impr"] = scatter_rows(state.impr, slot, torch.stack(
            [pslot(iidx[:, :, c]) for c in range(3)], dim=1))
    zeros3 = torch.zeros_like(apos)
    vnew = draw_inserted_velocities(cfg, u.vel, mol_com(pos, am_k))
    if vnew is None:
        av = zeros3
        pins_l = pins_r = torch.zeros((3,), dtype=state.dtype, device=dev)
    else:
        av = vnew.repeat_interleave(m, dim=0)
        types_k = tpl["types"][tsel]
        mol_mass = torch.where(am_k, const_like(cfg.masses, pos)[
            types_k.long()], 0.0).sum(1)
        mv = mol_mass[:, None] * torch.where(landed_mol[:, None], vnew, 0.0)
        half = km // 2
        pins_l, pins_r = mv[:half].sum(0), mv[half:].sum(0)
    aux: PadAux = state.nbrs
    aux = aux.replace(xref=scatter_rows(aux.xref, slot, apos))
    aux = patch_kernel_caches(geom, aux, slot, new_tag, n_slots)
    n_mols = landed_mol.sum(dtype=torch.int32)
    n_atoms = placed.sum(dtype=torch.int32)
    want = torch.clamp(nins_l, min=0) + torch.clamp(nins_r, min=0)
    sc = state.obmd
    return state.replace(
        x=scatter_rows(state.x, slot, apos),
        v=scatter_rows(state.v, slot, av),
        f=scatter_rows(state.f, slot, zeros3),
        type=scatter_rows(state.type, slot, tpl["types"][tsel].reshape(-1)),
        tag=scatter_rows(state.tag, slot, new_tag),
        q=scatter_rows(state.q, slot, tpl["q"][tsel].reshape(-1)),
        mol=scatter_rows(state.mol, slot, mol_id),
        rep_atom=scatter_rows(state.rep_atom, slot,
                              tpl["rep"][tsel].reshape(-1)),
        lambdaF=scatter_rows(state.lambdaF, slot, zeros3[:, 0]),
        cms_mol=scatter_rows(state.cms_mol, slot, zeros3),
        vcms_mol=scatter_rows(state.vcms_mol, slot, zeros3),
        alive=scatter_rows(state.alive, slot, torch.ones_like(act)),
        nbrs=aux, maxtag=base + n_atoms, **upd,
        obmd=sc.replace(
            ninserted=sc.ninserted + n_atoms,
            insert_fail=sc.insert_fail + torch.clamp(want - n_mols, min=0),
            usher_iters=sc.usher_iters + it_l + it_r)), pins_l, pins_r


def _delete_outside_sliced(cfg, geom, state: State):
    """Delete atoms beyond the open x faces, touching only the two face
    blocks (an atom beyond a face was filed in that face's cell column),
    and tally the deleted momentum per side."""
    box = cfg.box
    csx = geom.cell_size[0]
    alive, tag, v = state.alive.clone(), state.tag.clone(), state.v.clone()
    vnew = []
    ndel = torch.zeros((), dtype=torch.int32, device=state.device)
    for lo_face in (True, False):
        if lo_face:
            a, b = slab_slice_bounds(geom, box, box.lo[0] - 1.0,
                                     box.lo[0] + csx)
        else:
            a, b = slab_slice_bounds(geom, box, box.hi[0] - csx,
                                     box.hi[0] + 1.0)
        x0 = state.x[a:b, 0]
        al = alive[a:b]
        doomed = al & ((x0 < box.lo[0]) if lo_face else (x0 > box.hi[0]))
        vs = v[a:b]
        mv = _slice_mass(cfg, state, a, b)[:, None] * vs
        vnew.append(torch.where(doomed[:, None], mv, 0.0).sum(0))
        ndel = ndel + doomed.sum(dtype=torch.int32)
        alive[a:b] = al & ~doomed
        tag[a:b] = torch.where(doomed, -1, tag[a:b])
        v[a:b] = torch.where(doomed[:, None], 0.0, vs)
    state = state.replace(alive=alive, tag=tag, v=v, obmd=state.obmd.replace(
        ndeleted=state.obmd.ndeleted + ndel))
    return state, vnew[0], vnew[1]


def _obmd_stage(cfg, geom, state: State, draw: Draw,
                with_rebuild: bool = True) -> State:
    """The stage (obmd_tpu/engine_cellpad.py:750-831): face deletion with
    the momentum tally, the relayout test when with_rebuild, the census
    and the feedback law, then, when a buffer needs atoms, the subsets and
    the insertion, else the skipped insertion (the running maximum tag
    recomputed under `id max`); the inserted momentum leaves the tally
    before the setpoints."""
    obmd = cfg.obmd
    box = cfg.box
    prm = stage_params(cfg, state)
    if mol_mode(cfg):
        # doom spreads along bonds beyond the face band: the whole store
        state, vnewl, vnewr = delete_outside(cfg, state)
    else:
        state, vnewl, vnewr = _delete_outside_sliced(cfg, geom, state)
    if with_rebuild:
        state = maybe_rebuild(geom, box, cfg.skin, state,
                              **relayout_flags(cfg))

    nins_l, nins_r = (
        feedback_count(_region_count_sliced(cfg, geom, state, r),
                       obmd.mol_len, prm["alpha"], prm["nbuf"], prm["dt"],
                       prm["tau"]) for r in (obmd.region1, obmd.region2))
    need = bool(((nins_l > 0) | (nins_r > 0)).item())
    u = draw(state, need)
    if need:
        pad = cfg.pair.max_cut + cfg.skin
        sub_l = _subset_slice(cfg, geom, state, obmd.region5, pad)
        sub_r = _subset_slice(cfg, geom, state, obmd.region6, pad)
        state = state.replace(cell_overflow=state.cell_overflow
                              + sub_l.overflow.to(torch.int32)
                              + sub_r.overflow.to(torch.int32))
        insert = _insert_mol if mol_mode(cfg) else _insert
        state, pins_l, pins_r = insert(cfg, geom, state, nins_l, nins_r,
                                       sub_l, sub_r, u)
        # inserted momentum enters the tally with the opposite sign to a
        # deletion's (obmd_tpu/engine_cellpad.py:814-818)
        vnewl, vnewr = vnewl - pins_l, vnewr - pins_r
    else:
        state = skipped_insertion(cfg, state)
    return setpoints(cfg, state, prm, vnewl, vnewr)


def setup_cellpad(cfg: SceneConfig, state: State,
                  draw: Optional[Draw] = None, kernel: str = "pair") -> State:
    """Pack into the cellpad layout, run the OBMD stage and the initial
    force evaluation.  Raises if the initial filing drops atoms: the atom
    count after, less this stage call's insertions, plus its deletions,
    below the count before.  (The JAX engine adds the running counters
    instead, obmd_tpu/engine_cellpad.py:855-857, which after an earlier
    run's insertions reports atoms lost that were not, and after its
    deletions hides atoms that were: ROADMAP Queue 3.)"""
    cfg = cfg.finalize()
    check_supported(cfg)
    draw = draw or own_draws(cfg)
    geom = make_geometry(cfg)
    kern = _make_kernel(cfg, geom, kernel)
    if cfg.rigid:
        check_bodies(cfg, state)
    n_before = int(state.alive.sum())
    lost = n_before
    if cfg.obmd is not None:
        lost += int(state.obmd.ndeleted) - int(state.obmd.ninserted)
    state = state.replace(x=cfg.box.wrap(state.x))
    state = layout_build(geom, cfg.box, state)
    if cfg.obmd is not None:
        state = _obmd_stage(cfg, geom, state, draw)
    out = state.replace(f=_forces(cfg, geom, kern, state))
    lost -= int(out.alive.sum())
    if cfg.obmd is not None:
        lost += int(out.obmd.ninserted) - int(out.obmd.ndeleted)
    if lost > 0:
        raise ValueError(
            f"cellpad initial filing dropped {lost} atoms: cell occupancy "
            f"exceeds Capacity.cell_capacity={geom.cap} "
            f"(grid {geom.dims}, {n_before} atoms). Raise "
            f"cell_capacity or enlarge the box.")
    return out


def _plain_step(cfg, geom, kern, state: State, draw: Draw,
                relayout: bool = False, with_stage: bool = True) -> State:
    """One step; relayout=True runs the epoch relayout between the drift
    and the force pass (f is dead there and skips the move); with_stage
    False leaves out the OBMD stage (a step between two of an nfreq
    group's stages)."""
    dt, dtf = step_times(cfg)
    state = kick_drift(cfg, state, dt, dtf)
    if relayout:
        if cfg.skin > 0:
            state = note_skin_check(cfg.box, float(cfg.skin), state)
        state = relayout_incremental(geom, cfg.box, state, move_f=False,
                                     **relayout_flags(cfg))
    if cfg.obmd is not None and with_stage:
        state = _obmd_stage(cfg, geom, state, draw, with_rebuild=False)
    return _finish_step(cfg, geom, kern, state)


def step_times(cfg: SceneConfig):
    """(dt, dt / 2) rounded to the scene's dtype, as python floats: the
    JAX step's dtype(cfg.dt) and dtype(0.5 * dt) (obmd_tpu/integrate.py:
    296-299)."""
    real = getattr(torch, cfg.dtype)
    return rounded(cfg.dt, real), rounded(0.5 * cfg.dt, real)


def kick_drift(cfg, state: State, dt: float, dtf: float) -> State:
    """The first half kick and the drift with the periodic wrap, live atoms
    only (rigid bodies moved and turned whole by rigid.rigid_drift), then
    under SHAKE the position constraints (the pre-drift positions giving
    the bonds' directions, the more partner columns of a branched topology
    included).  Every engine's step drifts here."""
    m = per_atom_mass(cfg, state)[:, None]
    a3 = state.alive[:, None]
    v = torch.where(a3, state.v + dtf * state.f / m, state.v)
    if cfg.rigid:
        x, v = rigid_drift(cfg, state, v)
    else:
        x = cfg.box.wrap(torch.where(a3, state.x + dt * v, state.x))
    if cfg.shake is not None:
        x, v = shake_positions(cfg, state.x, x, v, state.type, state.bond1,
                               state.bond2, state.alive, 1.0 / m[:, 0],
                               more_partners=state.bond_partners[2:])
    return state.replace(x=x, v=v)


def kick(cfg, state: State, f, dtf: float) -> torch.Tensor:
    """The second half kick's velocities from the forces f, live atoms
    only, then rigid bodies' velocities projected onto their rigid field
    (rigid.rigid_project) or under SHAKE the RATTLE velocity constraints.
    Every engine's step kicks here."""
    m = per_atom_mass(cfg, state)[:, None]
    v = torch.where(state.alive[:, None], state.v + dtf * f / m, state.v)
    if cfg.rigid:
        v = rigid_project(cfg, state, v)
    if cfg.shake is not None:
        v = rattle_velocities(cfg, state.x, v, state.type, state.bond1,
                              state.bond2, state.alive, 1.0 / m[:, 0],
                              more_partners=state.bond_partners[2:])
    return v


def _finish_step(cfg, geom, kern, state: State) -> State:
    """The force pass and the second half kick (and the molecules'
    centers of mass in MOLECULE mode)."""
    _, dtf = step_times(cfg)
    f = _forces(cfg, geom, kern, state)
    state = state.replace(v=kick(cfg, state, f, dtf), f=f,
                          step=state.step + 1)
    if mol_mode(cfg):
        state = update_mol_com(cfg, state)
    return state


def stage_every(cfg: SceneConfig) -> int:
    """Steps per OBMD stage call (`nfreq`; 1 without the stage)."""
    return max(1, int(cfg.obmd.nfreq)) if cfg.obmd is not None else 1


def make_step_cellpad(cfg: SceneConfig, draw: Optional[Draw] = None):
    """The per-step runner (obmd_tpu/engine_cellpad.py:867-926): half kick,
    drift and wrap, then on an OBMD scene the stage when step % nfreq ==
    0 (with the half-skin relayout test inside it, read on the host), and
    nothing on its other steps (the reference runs no relayout test
    there), or without the stage the relayout test every step
    (cellpad.maybe_rebuild); the force pass and the second half kick.
    The step is the state's host int, so the cadence reads nothing from
    the device."""
    cfg = cfg.finalize()
    check_supported(cfg)
    draw = draw or own_draws(cfg)
    geom = make_geometry(cfg)
    kern = _make_kernel(cfg, geom)
    nfreq = stage_every(cfg)
    dt, dtf = step_times(cfg)

    def step(state: State) -> State:
        state = kick_drift(cfg, state, dt, dtf)
        if cfg.obmd is not None:
            if state.step % nfreq == 0:
                state = _obmd_stage(cfg, geom, state, draw)
        else:
            state = maybe_rebuild(geom, cfg.box, cfg.skin, state,
                                  **relayout_flags(cfg))
        return _finish_step(cfg, geom, kern, state)

    return step


def auto_rebuild_every(cfg: SceneConfig) -> int:
    """Static relayout period from the half-skin budget (the reference's
    calibration: the fastest atom drifts ~9 sqrt(T/m) per unit time, T the
    highest temperature of the pair law and the Langevin thermostat, at
    least 1).  A dpd/tstat ramp counts its hotter end, max(t_start,
    t_stop): the JAX function reads only t_start, and the JAX cellpad
    engine never meets a ramp."""
    if cfg.rebuild_every > 0:
        return cfg.rebuild_every
    if cfg.skin <= 0.0:
        return 1
    t_max = 1.0
    for src in (cfg.pair, cfg.langevin):
        t = getattr(src, "temp", None)
        if t is not None:
            t_max = max(t_max, float(t))
    if isinstance(cfg.pair, DPDTstatParams) and cfg.pair.is_ramp:
        t_max = max(t_max, float(cfg.pair.t_stop))
    m_min = min(cfg.masses)
    v_fast = 9.0 * float(np.sqrt(t_max / m_min))
    r = int(0.45 * cfg.skin / (v_fast * cfg.dt))
    return max(1, min(r, 40))


def make_run_cellpad(cfg: SceneConfig, nsteps: int,
                     draw: Optional[Draw] = None, kernel: str = "pair"):
    """Runner of nsteps on a static relayout schedule: every
    auto_rebuild_every steps an epoch starts with a relayout; the half-skin
    criterion is telemetry (PadAux.skin_trips), not a trigger.  Under
    nfreq > 1 the period is rounded down to a multiple of nfreq, and the
    stage runs on the first step of each group of nfreq counted from the
    run's start, the final remainder keeping the group phase
    (obmd_tpu/engine_cellpad.py:1030-1073): the loop index decides, on the
    host."""
    cfg = cfg.finalize()
    check_supported(cfg)
    draw = draw or own_draws(cfg)
    geom = make_geometry(cfg)
    kern = _make_kernel(cfg, geom, kernel)
    nfreq = stage_every(cfg)
    r_every = auto_rebuild_every(cfg)
    if nfreq > 1:
        r_every = max(1, r_every // nfreq) * nfreq

    def run(state: State) -> State:
        for i in range(nsteps):
            state = _plain_step(cfg, geom, kern, state, draw,
                                relayout=(i % r_every == 0),
                                with_stage=(i % nfreq == 0))
        return state

    return run
