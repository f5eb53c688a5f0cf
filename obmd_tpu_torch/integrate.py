"""Entry points of a run: setup, the step, the multi-step runner,
equilibration and the host-driven loop, and the stateless sweep force
evaluation.

Counterpart of `obmd_tpu/integrate.py`.  Three engines, by
`cfg.force_path`:
  * "cellpad" (engine_cellpad): the padded cell-major layout and the pair
    kernel, relaid out on a static schedule by make_run, or on the
    half-skin test by the per-step runner make_step;
  * "nlist": a persistent cell table and [N, K] Verlet list
    (neighbors.py), rebuilt when an atom has moved half the skin, forces
    by forces/nlist.nlist_sweep, and the OBMD stage against the persistent
    structures (`_obmd_stage_fast`: insertions patch the list, deletions
    tombstone their slots);
  * "sweep": a fresh cell table and the pair sweep every step
    (`compute_forces`), the full OBMD stage (obmd.stage.pre_exchange).
The nlist and sweep steps mirror Verlet::run: half kick, drift and wrap,
the OBMD stage, neighbour maintenance, the pair force plus the boundary,
bonded and Langevin forces, half kick.  Their data-dependent decisions are
host-side `if`s: on the nlist engine the rebuild test and the OBMD stage's
demand gate are read in one device-to-host copy per step (a step without
the stage reads the rebuild test alone), on the sweep engine the demand
gate.  Each function runs on the device its state lives on.
"""
from __future__ import annotations

from typing import Optional

import torch

from .cells import GridSpec, build_cells
from .cellpad import layout_build
from .config import SceneConfig
from .engine_cellpad import (Draw, add_bonded_forces, check_float64,
                             check_scene, kick, kick_drift, make_geometry,
                             make_run_cellpad, make_step_cellpad, mol_mode,
                             own_draws, setup_cellpad, stage_every,
                             step_times)
from .engine_cellpad import pair_salt as _salt
from .forces.bonded import langevin_force
from .forces.nlist import nlist_sweep
from .forces.pairs import pair_sweep, sig_scale_of
from .neighbors import (NeighborParams, apply_new_rows, full_rebuild,
                        maybe_rebuild, rebuild_needed)
from .obmd.stage import (apply_boundary_force, delete_outside,
                         insert_particles_subset, insertion_budgets,
                         insertion_subsets, pre_exchange, rounds_of,
                         setpoints, skipped_insertion, stage_params)
from .obmd.subset import expand_region, subset_rows
from .rigid import check_bodies
from .state import State, temperature

I32 = torch.int32


def make_grid_spec(cfg: SceneConfig) -> GridSpec:
    return GridSpec.create(cfg.box, cfg.pair.max_cut + cfg.skin,
                           cfg.capacity.cell_capacity)


def make_neighbor_params(cfg: SceneConfig) -> NeighborParams:
    return NeighborParams(spec=make_grid_spec(cfg),
                          k_max=cfg.capacity.max_neighbors,
                          movers_max=cfg.capacity.movers_max,
                          cutoff=cfg.pair.max_cut, skin=cfg.skin)


def check_supported(cfg: SceneConfig) -> None:
    """Raise for a configuration the port's nlist and sweep engines cannot
    run: engine_cellpad.check_scene's refusals, then molecule-mode
    insertion, which runs on the cellpad engine (as
    obmd_tpu/integrate.py:282-285 has it), and bonded terms on the sweep,
    which has no 1-2 exclusion.  A float64 scene with molecule insertion
    is refused first with the reason (engine_cellpad.FLOAT64_MOL)."""
    check_scene(cfg)
    check_float64(cfg)
    if cfg.force_path == "sweep" and cfg.bond is not None:
        raise NotImplementedError(
            "the sweep path has no special-bonds 1-2 exclusion; bonded "
            "scenes run on nlist or cellpad")
    if mol_mode(cfg):
        raise NotImplementedError(
            "molecule-mode insertion is implemented on the cellpad engine "
            "(force_path='cellpad')")


def _extra_forces(cfg: SceneConfig, state: State, f):
    """The post-pair forces in the reference's Modify::post_force order:
    the OBMD boundary force, the bond, angle, dihedral and improper
    forces, the Langevin force."""
    if cfg.obmd is not None:
        f = apply_boundary_force(cfg, state, f)
    f = add_bonded_forces(cfg, state, f)
    if cfg.langevin is not None:
        f = f + langevin_force(cfg.langevin, cfg, state)
    return f


def compute_forces(cfg: SceneConfig, spec: GridSpec, state: State, *,
                   compute_energy: bool = False,
                   compute_virial: bool = False,
                   compute_virial_atom: bool = False):
    """Stateless force evaluation of the sweep path: cell rebuild, pair
    sweep (a dpd/tstat ramp's noise scale of the state's step), then the
    OBMD boundary force and the Langevin force.  Returns (PairFields with
    the total force, CellTable).  A bonded scene raises: the sweep has no
    1-2 exclusion (obmd_tpu/integrate.py:290-293)."""
    if cfg.bond is not None:
        raise NotImplementedError(
            "compute_forces: the pair sweep has no special-bonds 1-2 "
            "exclusion; bonded scenes run on the cellpad engine")
    ctab = build_cells(spec, state.x, state.alive)
    pf = pair_sweep(cfg.pair, cfg.box, spec, ctab, state.x, state.v,
                    state.type, state.tag, _salt(cfg, state.step),
                    dt=cfg.dt, q=state.q,
                    sig_scale=sig_scale_of(cfg.pair, state.step, state.dtype),
                    compute_energy=compute_energy,
                    compute_virial=compute_virial,
                    compute_virial_atom=compute_virial_atom)
    return pf._replace(f=_extra_forces(cfg, state, pf.f)), ctab


def _nlist_forces(cfg: SceneConfig, state: State) -> torch.Tensor:
    """The list's pair forces (1-2 pairs left out on a bonded scene) plus
    the post-pair forces."""
    bonded = cfg.bond is not None
    pf = nlist_sweep(cfg.pair, cfg.box, state.nbrs.nlist, state.x, state.v,
                     state.type, state.tag, state.q, state.alive,
                     _salt(cfg, state.step), dt=cfg.dt,
                     bond1=state.bond1 if bonded else None,
                     bond2=state.bond2 if bonded else None,
                     more_bonds=state.bond_partners[2:] if bonded else (),
                     sig_scale=sig_scale_of(cfg.pair, state.step,
                                             state.dtype))
    return _extra_forces(cfg, state, pf.f)


def _pair_kernel_only(cfg: SceneConfig, kernel: str) -> None:
    if cfg.force_path != "cellpad" and kernel != "pair":
        raise ValueError(f"kernel={kernel!r} picks a cellpad pair kernel; "
                         f"the {cfg.force_path} engine has none")


def setup(cfg: SceneConfig, state: State, draw: Optional[Draw] = None,
          kernel: str = "pair") -> State:
    """Initial layout or neighbour build, OBMD stage and force evaluation
    before the first step (Verlet::setup; the stage runs first like
    setup_pre_exchange).  `kernel` picks the cellpad engine's pair kernel:
    "pair" (make_pair_kernel's) or "full" (the legacy full-stencil
    make_dpd_kernel's)."""
    cfg = cfg.finalize()
    if cfg.force_path == "cellpad":
        return setup_cellpad(cfg, state, draw, kernel)
    _pair_kernel_only(cfg, kernel)
    check_supported(cfg)
    if cfg.rigid:
        check_bodies(cfg, state)
    if cfg.obmd is not None:
        state = pre_exchange(cfg, state, draw or own_draws(cfg))
    state = state.replace(x=cfg.box.wrap(state.x))
    state = state.replace(nbrs=full_rebuild(make_neighbor_params(cfg),
                                            cfg.box, state.x, state.alive))
    if cfg.force_path == "nlist":
        f = _nlist_forces(cfg, state)
    else:
        f = compute_forces(cfg, make_grid_spec(cfg), state)[0].f
    return state.replace(f=torch.where(state.alive[:, None], f, 0.0))


def rebuild_neighbors(cfg: SceneConfig, state: State) -> State:
    """(Re)build the neighbour structures without touching the physics:
    the restart path, and the way onto another engine."""
    cfg = cfg.finalize()
    if cfg.force_path == "cellpad":
        return layout_build(make_geometry(cfg), cfg.box, state)
    return state.replace(nbrs=full_rebuild(make_neighbor_params(cfg),
                                           cfg.box, state.x, state.alive))


def _subset_overflow(cfg: SceneConfig, state: State) -> torch.Tensor:
    """Whether either insertion subset would overflow its rows (what the
    reference's ungated stage adds to force_rebuild)."""
    b_max = cfg.capacity.insert_region_max or (cfg.capacity.n_max // 2)
    pad = cfg.pair.max_cut + cfg.skin
    over = [(state.alive & expand_region(r, pad).match(state.x)).sum()
            > b_max for r in (cfg.obmd.region5, cfg.obmd.region6)]
    return over[0] | over[1]


def _obmd_stage_fast(cfg: SceneConfig, nparams: NeighborParams,
                     state: State, draw: Draw) -> State:
    """The OBMD stage against the persistent structures
    (obmd_tpu/integrate.py:178-273): delete beyond the faces and tombstone
    the freed slots, rebuild when due, census and feedback law, then, when
    a buffer needs atoms, insertion (`maxattempt` rounds) against the
    buffer subsets into free slots that are not tombstoned, the new atoms'
    rows from the subsets appended to the list (each side's block of
    rounds x K rows); the inserted momentum out of the tally; the
    setpoints.  The rebuild test and the demand gate are read on the host
    in one copy."""
    box = cfg.box
    n = state.capacity
    prm = stage_params(cfg, state)
    prev_alive = state.alive
    state, vnewl, vnewr = delete_outside(cfg, state)
    nbrs = state.nbrs
    nbrs = nbrs.replace(tombstone=nbrs.tombstone | (prev_alive & ~state.alive))
    nins_l, nins_r = insertion_budgets(cfg, state, prm)
    trip = rebuild_needed(nparams, box, nbrs, state.x, state.alive)
    rebuild, need_l, need_r = torch.stack(
        [trip.to(I32), nins_l, nins_r]).tolist()
    nbrs = maybe_rebuild(nparams, box, nbrs, state.x, state.alive,
                         need=bool(rebuild))
    state = state.replace(nbrs=nbrs)
    need = need_l > 0 or need_r > 0
    u = draw(state, need)
    if need:
        sub_l, sub_r = insertion_subsets(cfg, state)
        masked = state.alive | nbrs.tombstone
        ins, new_slots, pins_l, pins_r = insert_particles_subset(
            cfg, state.replace(alive=masked), nins_l, nins_r, sub_l, sub_r,
            u)
        added = torch.zeros((n + 1,), dtype=torch.bool, device=state.device)
        added[new_slots] = True
        state = ins.replace(alive=state.alive | added[:n])
        m = rounds_of(cfg) * cfg.obmd.insert_kmax
        act = new_slots < n
        pos = state.x[torch.clamp(new_slots, 0, n - 1)]
        rows = [subset_rows(nparams, box, sub, pos[s], new_slots[s], act[s])
                for sub, s in ((sub_l, slice(0, m)), (sub_r, slice(m, None)))]
        nbrs = apply_new_rows(nparams, state.nbrs, state.x, new_slots,
                              torch.cat([rows[0][0], rows[1][0]]),
                              torch.cat([rows[0][1], rows[1][1]]),
                              rows[0][2] + rows[1][2])
        nbrs = nbrs.replace(force_rebuild=nbrs.force_rebuild
                            | sub_l.overflow | sub_r.overflow)
        vnewl, vnewr = vnewl - pins_l, vnewr - pins_r
    else:
        state = skipped_insertion(cfg, state)
        nbrs = nbrs.replace(force_rebuild=nbrs.force_rebuild
                            | _subset_overflow(cfg, state))
    state = state.replace(nbrs=nbrs)
    return setpoints(cfg, state, prm, vnewl, vnewr)


def make_step(cfg: SceneConfig, draw: Optional[Draw] = None):
    """The one-step function: the cellpad engine's per-step runner
    (engine_cellpad.make_step_cellpad), or the nlist or sweep engine's
    step.  On an OBMD scene the stage runs when step %
    nfreq == 0; on the nlist engine its other steps run no rebuild test
    (obmd_tpu/integrate.py:318-336 tests only without the stage)."""
    cfg = cfg.finalize()
    if cfg.force_path == "cellpad":
        return make_step_cellpad(cfg, draw)
    check_supported(cfg)
    draw = draw or own_draws(cfg)
    spec = make_grid_spec(cfg)
    nparams = make_neighbor_params(cfg)
    fast = cfg.force_path == "nlist"
    nfreq = stage_every(cfg)
    dt, dtf = step_times(cfg)

    def step(state: State) -> State:
        state = kick_drift(cfg, state, dt, dtf)
        if cfg.obmd is not None and state.step % nfreq == 0:
            state = (_obmd_stage_fast(cfg, nparams, state, draw) if fast
                     else pre_exchange(cfg, state, draw))
        if fast:
            if cfg.obmd is None:
                state = state.replace(nbrs=maybe_rebuild(
                    nparams, cfg.box, state.nbrs, state.x, state.alive))
            f = _nlist_forces(cfg, state)
        else:
            pf, ctab = compute_forces(cfg, spec, state)
            f = pf.f
            state = state.replace(
                cell_overflow=state.cell_overflow + ctab.overflow)
        f = torch.where(state.alive[:, None], f, 0.0)
        return state.replace(v=kick(cfg, state, f, dtf), f=f,
                             step=state.step + 1)

    return step


def make_run(cfg: SceneConfig, nsteps: int, draw: Optional[Draw] = None,
             kernel: str = "pair"):
    """Runner of nsteps steps: the cellpad engine's on its static relayout
    schedule (`kernel` as in setup), else a loop over make_step."""
    cfg = cfg.finalize()
    if cfg.force_path == "cellpad":
        return make_run_cellpad(cfg, nsteps, draw, kernel)
    _pair_kernel_only(cfg, kernel)
    step = make_step(cfg, draw)

    def run(state: State) -> State:
        for _ in range(nsteps):
            state = step(state)
        return state

    return run


def equilibrate(cfg: SceneConfig, state: State, nsteps: int,
                temp: float = 1.0, rescale_every: int = 25,
                draw: Optional[Draw] = None) -> State:
    """Tame the startup transient of a freshly drawn configuration with
    velocity rescaling to `temp` every `rescale_every` steps, then clear the
    cellpad layout's half-skin staleness counter (a Verlet list has none;
    overflow counters are never cleared)."""
    cfg = cfg.finalize()
    run = make_run(cfg, rescale_every, draw)
    for _ in range(max(1, nsteps // rescale_every)):
        state = run(state)
        t_now = temperature(cfg, state)
        scale = torch.sqrt(temp / torch.clamp(t_now, min=1e-6))
        state = state.replace(v=torch.where(state.alive[:, None],
                                            state.v * scale, state.v))
    if hasattr(state.nbrs, "skin_trips"):
        state = state.replace(nbrs=state.nbrs.replace(
            skin_trips=torch.zeros_like(state.nbrs.skin_trips)))
    return state


def run_loop(cfg: SceneConfig, state: State, nsteps: int, callback=None,
             callback_every: int = 0, draw: Optional[Draw] = None) -> State:
    """Host-driven loop of nsteps steps through make_step (on the cellpad
    engine its per-step runner, whose relayout test runs with the stage)
    with callback(state) after every callback_every of them (the thermo
    and dump path, output.cpp; obmd_tpu/integrate.py run_loop)."""
    step = make_step(cfg, draw)
    for i in range(nsteps):
        state = step(state)
        if callback is not None and callback_every \
                and (i + 1) % callback_every == 0:
            callback(state)
    return state
