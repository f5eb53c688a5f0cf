"""The multi-device step by atom decomposition, over torch.distributed.

Counterpart of `obmd_tpu/parallel/atom_decomp.py`.  The state is split by
slot: rank r holds block r of the [world * n_loc] global arrays (the JAX
package's shard r) as its own `State` of n_loc slots.  Each step:
  * the half kick and the drift, locally;
  * the OBMD stage (`_pre_exchange_spmd`): deletion beyond the faces with
    the momentum tallies and the buffer census summed over the ranks; the
    insertion search replicated on every rank over the gathered state and
    its cell table (`obmd.stage._usher_search` or `_near_check`) from the
    same draws, so that every rank reaches the same verdicts; accepted
    candidate j is written by the rank that owns the free slot of global
    rank j (no communication);
  * the wrap, one all-gather of positions, velocities, types, tags,
    liveness and charges, the cell table of the whole box, and the forces
    on the owned slots (`forces.gathered.forces_for_subset`: both sides of
    every pair, so no reverse pass);
  * the boundary force with its weights' sums over the ranks, the second
    half kick.
It runs the JAX function's scope: one candidate round of uniform draws,
the stage on every step.  The keywords that function passes over
(`maxattempt` > 1, `nfreq` > 1, `gaussian`, `rate`, `global`, `local`,
the velocity keywords, `group_types`, `id max`), MOLECULE mode, bonded
terms and the Langevin thermostat raise NotImplementedError here rather
than run with another meaning.  Unlike the JAX function (which leaves it
out), a dpd/tstat ramp's noise scale is applied.
"""
from __future__ import annotations

import torch

from ..cellpad import compact_indices, scatter_rows
from ..cells import build_cells
from ..config import SceneConfig
from ..engine_cellpad import (check_scene, own_draws, pair_salt,
                              step_times)
from ..forces.gathered import forces_for_subset
from ..forces.pairs import sig_scale_of
from ..integrate import make_grid_spec
from ..obmd.stage import (_near_check, _sequential_accept, _usher_search,
                          draw_candidates, feedback_count, setpoints,
                          smooth_weight, stage_params)
from ..state import State, per_atom_mass
from .comm import Comm

# the per-atom fields of a State, split by slot across the ranks
PER_ATOM = ("x", "v", "f", "type", "tag", "q", "alive", "mol", "lambdaF",
            "cms_mol", "vcms_mol", "rep_atom", "bond1", "bond2", "bond3",
            "bond4", "impr")


def shard_state(state: State, world: int, rank: int) -> State:
    """Rank `rank`'s block of a global state: slots [rank * n_loc, (rank +
    1) * n_loc) of every per-atom field, the scalars as they are, no
    neighbour structure."""
    n = state.capacity
    if n % world:
        raise ValueError(f"capacity {n} must divide the world size {world}")
    n_loc = n // world
    part = slice(rank * n_loc, (rank + 1) * n_loc)
    cut = {k: getattr(state, k)[part] for k in PER_ATOM
           if getattr(state, k) is not None}
    return state.replace(nbrs=None, **cut)


def gather_state(comm: Comm, state: State) -> State:
    """The global state on every rank: each per-atom field of the ranks'
    states concatenated in rank order (the JAX package's global arrays),
    the scalars as they are (replicated)."""
    cut = {k: comm.all_gather(getattr(state, k)) for k in PER_ATOM
           if getattr(state, k) is not None}
    return state.replace(**cut)


def check_atom_decomp(cfg: SceneConfig) -> None:
    """Raise for what the atom decomposition does not run (the module's
    docstring).  A float64 scene runs in float64 throughout, as the JAX
    atom step runs it under x64."""
    check_scene(cfg)
    if any(t is not None for t in (cfg.bond, cfg.angle, cfg.dihedral,
                                   cfg.improper, cfg.shake)) or cfg.rigid:
        raise NotImplementedError(
            "the atom decomposition runs pair forces only (as "
            "obmd_tpu/parallel/atom_decomp.py): no bonded terms, SHAKE or "
            "rigid bodies")
    if cfg.langevin is not None:
        raise NotImplementedError(
            "the multi-device steps have no Langevin thermostat (the JAX "
            "steps leave it out)")
    o = cfg.obmd
    if o is None:
        return
    unsupported = {
        "mol": o.mol is not None, "maxattempt > 1": o.maxattempt > 1,
        "nfreq > 1": o.nfreq > 1, "gaussian": o.gaussian is not None,
        "rate": o.rate is not None,
        "global/local": (o.deposit_global is not None
                         or o.deposit_local is not None),
        "vx/vy/vz": any(v is not None for v in (o.vx, o.vy, o.vz)),
        "group_types": o.group_types is not None,
        "id max": o.id_policy == "max"}
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"the atom decomposition's stage takes one round of uniform "
            f"candidates every step (obmd_tpu/parallel/atom_decomp.py:"
            f"145-256); not {', '.join(bad)}: run the slab decomposition")


def boundary_force_psum(cfg: SceneConfig, comm: Comm, state: State, f):
    """f plus the setpoint forces spread over each region's live atoms,
    f_i += F g_i / sum(g) with the weights' sums over the ranks (the
    MPI_Allreduce at fix_obmd_merged.cpp:1305/1378; obmd_tpu/parallel/
    atom_decomp.py:292-321): smooth weights in region1 and region2, mass
    weights in the shear sub-regions, added region by region."""
    obmd = cfg.obmd
    m = per_atom_mass(cfg, state)
    x0 = state.x[:, 0]
    sc = state.obmd
    parts = []
    for region, force, smooth in (
            (obmd.region1, sc.momentum_force_left, True),
            (obmd.region2, sc.momentum_force_right, True),
            (obmd.region3, sc.shear_force_left, False),
            (obmd.region4, sc.shear_force_right, False)):
        if region is None:         # a zero-extent shear sub-region
            continue
        member = state.alive & region.match(state.x)
        g = smooth_weight(cfg, x0, m) if smooth else m
        parts.append((torch.where(member, g, 0.0), force))
    gsum = comm.sum(torch.stack([g.sum() for g, _ in parts]))
    for (g, force), s in zip(parts, gsum):
        scale = torch.where(s > 0.0, g / torch.clamp(s, min=1e-30), 0.0)
        f = f + scale[:, None] * force[None, :]
    return f


def _gathered(comm: Comm, state: State, fields=("x", "v", "q")):
    """(float columns [N, C], ints [N, 3]: type, tag, alive) of the global
    state, in two all-gathers."""
    floats = torch.cat([getattr(state, k).reshape(state.capacity, -1)
                        for k in fields], dim=1)
    ints = torch.stack([state.type, state.tag, state.alive.to(torch.int32)],
                       dim=1)
    return comm.all_gather(floats), comm.all_gather(ints)


def _pre_exchange_spmd(cfg: SceneConfig, spec, comm: Comm, state: State,
                       draw):
    """The OBMD stage of the atom decomposition
    (obmd_tpu/parallel/atom_decomp.py:145-289): local deletion and census
    with their sums over the ranks, the search replicated on the gathered
    state, each accepted candidate placed by the owner of the free slot of
    its global rank."""
    obmd = cfg.obmd
    box = cfg.box
    n_loc = state.capacity
    dev = state.device
    prm = stage_params(cfg, state)

    x0 = state.x[:, 0]
    doomed = state.alive & ((x0 < box.lo[0]) | (x0 > box.hi[0]))
    left = doomed & (x0 < 0.5 * (box.lo[0] + box.hi[0]))
    mv = per_atom_mass(cfg, state)[:, None] * state.v
    alive = state.alive & ~doomed
    counts = torch.stack([doomed.sum(dtype=torch.int32)] + [
        (alive & r.match(state.x)).sum(dtype=torch.int32)
        for r in (obmd.region1, obmd.region2)])
    tally = comm.sum(torch.cat([torch.where(left[:, None], mv, 0.0).sum(0),
                                torch.where((doomed & ~left)[:, None], mv,
                                            0.0).sum(0)]))
    counts = comm.sum(counts)
    vnewl, vnewr = tally[:3], tally[3:]
    state = state.replace(
        alive=alive, tag=torch.where(doomed, -1, state.tag),
        obmd=state.obmd.replace(ndeleted=state.obmd.ndeleted + counts[0]))
    nins_l, nins_r = (feedback_count(c, obmd.mol_len, prm["alpha"],
                                     prm["nbuf"], prm["dt"], prm["tau"])
                      for c in counts[1:])

    k = obmd.insert_kmax
    floats, ints = _gathered(comm, state, ("x", "q"))
    full_x, full_q = floats[:, :3], floats[:, 3]
    full_t, full_a = ints[:, 0], ints[:, 2] > 0
    ctab = build_cells(spec, full_x, full_a)
    gathered = state.replace(x=full_x, type=full_t, alive=full_a, q=full_q)
    u = draw(state, True)
    ctype = torch.full((k,), obmd.ntype, dtype=torch.int32, device=dev)
    poss, accs, iters = [], [], []
    for s, (region, budget) in enumerate(((obmd.region5, nins_l),
                                          (obmd.region6, nins_r))):
        cand, _ = draw_candidates(cfg, u.pos[s, 0], None, region, state)
        if obmd.usher is not None:
            pos, ok, it, _ = _usher_search(cfg, spec, ctab, gathered, cand,
                                           ctype, region)
        else:
            ok, _ = _near_check(cfg, spec, ctab, gathered, cand, ctype)
            pos, it = cand, torch.zeros((k,), dtype=torch.int32, device=dev)
        acc, _ = _sequential_accept(cfg, pos, ctype, ok,
                                    torch.clamp(budget, 0, k))
        poss.append(pos)
        accs.append(acc)
        iters.append(it.sum(dtype=torch.int32))
    pos = torch.cat(poss)
    accepted = torch.cat(accs)

    # the accepted candidate of global rank j takes the free slot of
    # global rank j: the free slots of the lower ranks come first
    m2 = 2 * k
    my_free = compact_indices(~state.alive, m2, n_loc)
    my_nfree = (~state.alive).sum(dtype=torch.int32)
    all_nfree = comm.all_gather(my_nfree)
    before = torch.where(torch.arange(comm.world, device=dev) < comm.rank,
                         all_nfree, 0).sum(dtype=torch.int32)
    order = torch.cumsum(accepted.to(torch.int32), 0,
                         dtype=torch.int32) - 1
    mine = accepted & (order >= before) \
        & (order < before + torch.clamp(my_nfree, max=m2))
    local = torch.clamp(order - before, 0, m2 - 1).long()
    slot = torch.where(mine, my_free[local], n_loc)
    n_acc = comm.sum(mine.sum(dtype=torch.int32))
    new_tag = state.maxtag + 1 + order
    z3 = torch.zeros_like(pos)
    none = torch.full((m2,), -1, dtype=torch.int32, device=dev)

    def put(arr, vals):
        return scatter_rows(arr, slot, vals)
    cols = {"bond1": put(state.bond1, none), "bond2": put(state.bond2, none)}
    if state.bond3 is not None:
        cols.update(bond3=put(state.bond3, none), bond4=put(state.bond4, none))
    if state.impr is not None:
        cols["impr"] = put(state.impr, none[:, None].expand(m2, 3))
    want = torch.clamp(nins_l, min=0) + torch.clamp(nins_r, min=0)
    sc = state.obmd
    state = state.replace(
        x=put(state.x, pos), v=put(state.v, z3), f=put(state.f, z3),
        type=put(state.type, ctype.repeat(2)), tag=put(state.tag, new_tag),
        q=put(state.q, z3[:, 0]), alive=put(state.alive, torch.ones_like(
            accepted)), maxtag=state.maxtag + n_acc, **cols,
        obmd=sc.replace(
            ninserted=sc.ninserted + n_acc,
            insert_fail=sc.insert_fail + torch.clamp(want - n_acc, min=0),
            usher_iters=sc.usher_iters + iters[0] + iters[1]))
    return setpoints(cfg, state, prm, vnewl, vnewr)


def make_sharded_step(cfg: SceneConfig, comm: Comm, draw=None):
    """The step of one rank's state (shard_state's block), with the
    semantics of integrate.make_step on the global state: the stage's
    draws from `draw` (the seam of engine_cellpad; by default the state's
    generator, seeded alike on every rank), one candidate round a side
    every step."""
    cfg = cfg.finalize()
    check_atom_decomp(cfg)
    n_max = cfg.capacity.n_max
    if n_max % comm.world != 0:
        raise ValueError(
            f"n_max={n_max} must divide the mesh size {comm.world}")
    spec = make_grid_spec(cfg)
    draw = draw or own_draws(cfg)
    dt, dtf = step_times(cfg)
    n_loc = n_max // comm.world

    def step(state: State) -> State:
        m = per_atom_mass(cfg, state)[:, None]
        a3 = state.alive[:, None]
        v = torch.where(a3, state.v + dtf * state.f / m, state.v)
        x = torch.where(a3, state.x + dt * v, state.x)
        state = state.replace(x=x, v=v)
        if cfg.obmd is not None:
            state = _pre_exchange_spmd(cfg, spec, comm, state, draw)
        state = state.replace(x=cfg.box.wrap(state.x))
        floats, ints = _gathered(comm, state)
        full_x, full_v, full_q = floats[:, :3], floats[:, 3:6], floats[:, 6]
        full_a = ints[:, 2] > 0
        ctab = build_cells(spec, full_x, full_a)
        my_slot = comm.rank * n_loc + torch.arange(n_loc, device=state.device)
        f, _ = forces_for_subset(
            cfg.pair, cfg.box, spec, ctab, full_x, full_v, ints[:, 0],
            ints[:, 1], full_q, my_slot, state.x, state.v, state.type,
            state.tag, state.q, pair_salt(cfg, state.step), dt=cfg.dt,
            sig_scale=sig_scale_of(cfg.pair, state.step, state.dtype))
        if cfg.obmd is not None:
            f = boundary_force_psum(cfg, comm, state, f)
        f = torch.where(state.alive[:, None], f, 0.0)
        m = per_atom_mass(cfg, state)[:, None]
        v = torch.where(state.alive[:, None], state.v + dtf * f / m, state.v)
        return state.replace(v=v, f=f, step=state.step + 1,
                             cell_overflow=state.cell_overflow
                             + ctab.overflow)

    return step
