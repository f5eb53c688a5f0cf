"""Entry points of a run: setup, the multi-step runner and equilibration,
and the stateless sweep force evaluation.

Counterpart of the cellpad branches of `obmd_tpu/integrate.py` (`setup`,
`make_run`, `equilibrate`) and of its `make_grid_spec`, `_salt` and
`compute_forces`.  The other step engines ("nlist", "sweep") are not ported
yet and raise.  Each function runs on the device its state lives on.
"""
from __future__ import annotations

from typing import Optional

import torch

from .cells import GridSpec, build_cells
from .config import SceneConfig
from .engine_cellpad import Draw, make_run_cellpad, setup_cellpad
from .engine_cellpad import pair_salt as _salt
from .forces.pairs import pair_sweep, sig_scale_of
from .state import State, temperature


def make_grid_spec(cfg: SceneConfig) -> GridSpec:
    return GridSpec.create(cfg.box, cfg.pair.max_cut + cfg.skin,
                           cfg.capacity.cell_capacity)


def compute_forces(cfg: SceneConfig, spec: GridSpec, state: State, *,
                   compute_energy: bool = False,
                   compute_virial: bool = False,
                   compute_virial_atom: bool = False):
    """Stateless force evaluation of the sweep path: cell rebuild + pair
    sweep (a dpd/tstat ramp's noise scale of the state's step).  Returns
    (PairFields, CellTable).  The OBMD boundary force and
    bonded terms of the reference's version are not ported, so a scene with
    an OBMD stage raises; so does a bonded scene, since the sweep has no
    1-2 exclusion (obmd_tpu/integrate.py:290-293)."""
    if cfg.obmd is not None:
        raise NotImplementedError(
            "compute_forces: the OBMD boundary force is not ported")
    if cfg.bond is not None:
        raise NotImplementedError(
            "compute_forces: the pair sweep has no special-bonds 1-2 "
            "exclusion; bonded scenes run on the cellpad engine")
    ctab = build_cells(spec, state.x, state.alive)
    pf = pair_sweep(cfg.pair, cfg.box, spec, ctab, state.x, state.v,
                    state.type, state.tag, _salt(cfg, state.step),
                    dt=cfg.dt, q=state.q,
                    sig_scale=sig_scale_of(cfg.pair, state.step),
                    compute_energy=compute_energy,
                    compute_virial=compute_virial,
                    compute_virial_atom=compute_virial_atom)
    return pf, ctab


def _require_cellpad(cfg: SceneConfig) -> None:
    if cfg.force_path != "cellpad":
        raise NotImplementedError(
            f"force_path={cfg.force_path!r}: only the cellpad engine is ported")


def setup(cfg: SceneConfig, state: State, draw: Optional[Draw] = None,
          kernel: str = "pair") -> State:
    """Initial layout, OBMD stage and force evaluation before the first
    step (Verlet::setup; the stage runs first like setup_pre_exchange).
    `kernel` picks the pair kernel: "pair" (make_pair_kernel's) or "full"
    (the legacy full-stencil make_dpd_kernel's)."""
    cfg = cfg.finalize()
    _require_cellpad(cfg)
    return setup_cellpad(cfg, state, draw, kernel)


def make_run(cfg: SceneConfig, nsteps: int, draw: Optional[Draw] = None,
             kernel: str = "pair"):
    """Runner of nsteps steps on the static relayout schedule."""
    cfg = cfg.finalize()
    _require_cellpad(cfg)
    return make_run_cellpad(cfg, nsteps, draw, kernel)


def equilibrate(cfg: SceneConfig, state: State, nsteps: int,
                temp: float = 1.0, rescale_every: int = 25,
                draw: Optional[Draw] = None) -> State:
    """Tame the startup transient of a freshly drawn configuration with
    velocity rescaling to `temp` every `rescale_every` steps, then clear the
    half-skin staleness counter (overflow counters are never cleared)."""
    cfg = cfg.finalize()
    run = make_run(cfg, rescale_every, draw)
    for _ in range(max(1, nsteps // rescale_every)):
        state = run(state)
        t_now = temperature(cfg, state)
        scale = torch.sqrt(temp / torch.clamp(t_now, min=1e-6))
        state = state.replace(v=torch.where(state.alive[:, None],
                                            state.v * scale, state.v))
    if state.nbrs is not None:
        state = state.replace(nbrs=state.nbrs.replace(
            skin_trips=torch.zeros_like(state.nbrs.skin_trips)))
    return state
