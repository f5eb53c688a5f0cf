"""Run audits and OBMD counters.

Counterpart of `check_invariants` and `make_obmd_metrics_fn` in
`obmd_tpu/observe.py`; both read only the state's counters.  The thermo and
profile functions need the pair sweep engine and are not part of this
slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import SceneConfig
from .state import State


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


def check_invariants(cfg: SceneConfig, state: State) -> dict:
    """Host-side audit of a finished run's validity counters: nonzero cell
    overflow, layout overflow or half-skin trips mean pair interactions were
    dropped or stale.  Returns the counters; raises RuntimeError on a
    violation."""
    tel = {"cell_overflow": int(state.cell_overflow)}
    nbrs = state.nbrs
    if nbrs is not None:
        tel["layout_overflow"] = int(nbrs.overflow)
        tel["skin_trips"] = int(nbrs.skin_trips)
        tel["rebuilds"] = int(nbrs.rebuilds)
    if cfg.obmd is not None:
        tel["ninserted"] = int(state.obmd.ninserted)
        tel["ndeleted"] = int(state.obmd.ndeleted)
        tel["insert_fail"] = int(state.obmd.insert_fail)
    bad = {k: tel[k] for k in ("cell_overflow", "layout_overflow",
                               "skin_trips") if tel.get(k)}
    if bad:
        raise RuntimeError(
            f"run invariants violated: {bad} — pair interactions were "
            f"dropped or stale (raise Capacity.cell_capacity or lower "
            f"rebuild_every). Full telemetry: {tel}")
    return tel
