"""The star-polymer melt's step-size and filing-cap probe, on the card.

    python3 -m obmd_tpu_torch.star_probe [--steps 1200]
        [--dt 0.01 0.0075 0.005 0.004 0.0025] [--caps 14 15]

From scenes.star_melt_scene() (100,000 beads) it runs, for each time step
dt, star_warm_up at that dt and then `steps` steps at the production cap
(scenes.STAR_PROD_CAP) with a relayout every step, and at dt 0.005 once
more on the auto relayout schedule (engine_cellpad.auto_rebuild_every);
it samples the longest bond every 5 steps.  Then, at scenes.STAR_DT, it
runs `steps` steps from the warmed melt at each filing cap of --caps.
Each run prints one JSON line: the longest bond and its step, T at three
marks, the half-skin trips, the layout and cell overflow, the fullest
cell.  scenes.STAR_DT, STAR_REBUILD_EVERY and STAR_PROD_CAP are read from
these lines.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from . import scenes
from .engine_cellpad import auto_rebuild_every, make_geometry
from .integrate import make_run, setup
from .observe import bond_stats
from .state import temperature

SAMPLE = 5


def _fullest(geom, state) -> int:
    cell = geom.cell_of(state.x[state.alive]).long()
    return int(torch.bincount(cell, minlength=geom.n_cells).max())


def probe(cfg, state, steps: int, label: str) -> dict:
    """setup at cfg, then `steps` steps; the figures of the run."""
    t0 = time.perf_counter()
    st = setup(cfg, state)
    run = make_run(cfg, SAMPLE)
    longest, at, temps = 0.0, 0, []
    for k in range(steps // SAMPLE):
        st = run(st)
        lb = bond_stats(cfg, st)[0]
        if lb > longest:
            longest, at = lb, st.step
        if (k + 1) % (steps // SAMPLE // 3) == 0:
            temps.append(float(temperature(cfg, st)))
    torch.cuda.synchronize()
    return dict(run=label, dt=cfg.dt, cap=cfg.capacity.cell_capacity,
                relayout_every=auto_rebuild_every(cfg), steps=steps,
                longest_bond=longest, longest_at_step=at, temps=temps,
                skin_trips=int(st.nbrs.skin_trips),
                layout_overflow=int(st.nbrs.overflow),
                cell_overflow=int(st.cell_overflow),
                fullest_cell=_fullest(make_geometry(cfg), st),
                wall_s=time.perf_counter() - t0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--dt", type=float, nargs="*",
                    default=[0.01, 0.0075, 0.005, 0.004, 0.0025])
    ap.add_argument("--caps", type=int, nargs="*", default=[14, 15])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("star_probe runs on the card")
    sc = scenes.star_melt_scene()
    prod = scenes.with_cap(sc.cfg, scenes.STAR_PROD_CAP)
    for dt in args.dt:
        cfg = dataclasses.replace(sc.cfg, dt=dt)
        warm = scenes.star_warm_up(cfg, sc.state)
        runs = [(dataclasses.replace(prod, dt=dt), "every step")]
        if dt == 0.005:
            runs.append((dataclasses.replace(prod, dt=dt, rebuild_every=0),
                         "auto schedule"))
        for c, label in runs:
            print(json.dumps(probe(c, warm, args.steps, label)), flush=True)
    warm = scenes.star_warm_up(sc.cfg, sc.state)
    for cap in args.caps:
        print(json.dumps(probe(scenes.with_cap(sc.cfg, cap), warm,
                               args.steps, f"cap {cap}")), flush=True)


if __name__ == "__main__":
    main()
