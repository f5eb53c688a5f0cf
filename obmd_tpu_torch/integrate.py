"""Entry points of a run: setup, the multi-step runner and equilibration.

Counterpart of the cellpad branches of `obmd_tpu/integrate.py` (`setup`,
`make_run`, `equilibrate`).  The other force paths ("nlist", "sweep") are
not part of this slice and raise.  Each function runs on the device its
state lives on.
"""
from __future__ import annotations

from typing import Optional

import torch

from .config import SceneConfig
from .engine_cellpad import Draw, make_run_cellpad, setup_cellpad
from .state import State, temperature


def _require_cellpad(cfg: SceneConfig) -> None:
    if cfg.force_path != "cellpad":
        raise NotImplementedError(
            f"force_path={cfg.force_path!r}: only the cellpad engine is ported")


def setup(cfg: SceneConfig, state: State, draw: Optional[Draw] = None) -> State:
    """Initial layout, OBMD stage and force evaluation before the first
    step (Verlet::setup; the stage runs first like setup_pre_exchange)."""
    cfg = cfg.finalize()
    _require_cellpad(cfg)
    return setup_cellpad(cfg, state, draw)


def make_run(cfg: SceneConfig, nsteps: int, draw: Optional[Draw] = None):
    """Runner of nsteps steps on the static relayout schedule."""
    cfg = cfg.finalize()
    _require_cellpad(cfg)
    return make_run_cellpad(cfg, nsteps, draw)


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
