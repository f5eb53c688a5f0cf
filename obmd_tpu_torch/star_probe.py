"""The star-polymer melt's step-size and filing-cap probe, and the open
star melt's state point, on the card.

    python3 -m obmd_tpu_torch.star_probe [--steps 1200]
        [--dt 0.01 0.0075 0.005 0.004 0.0025] [--caps 14 15]
    python3 -m obmd_tpu_torch.star_probe --open [--steps 400]

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

With --open (`open_state_point`): the closed melt warmed up (star_warm_up),
then `steps` steps at STAR_PROD_CAP with thermo every 20 steps over the
second half (T, the pressure and P_xx, kinetic plus pair virial); the
median of the trial energies of 256 stars of the ended melt (numpy seed
0), each taken out and tested against the rest (subset.mol_energy_force);
then the open melt (scenes.open_star_scene at that P_xx and etarget, nbuf
the start's buffer census in molecules) warmed up under the stage, its
buffer census, and `steps` production steps at STAR_PROD_CAP (inserted,
deleted, failed, whole molecules, the fullest cell).  Each phase prints
one JSON line; scenes.OPEN_STAR_PXX, OPEN_STAR_ETARGET and
OPEN_STAR_CENSUS are read from them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
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


def census(cfg, state) -> float:
    """The mean of the two buffers' atom counts, in molecules."""
    o = cfg.obmd
    n = [int((state.alive & r.match(state.x)).sum()) for r in (o.region1,
                                                               o.region2)]
    return 0.5 * (n[0] + n[1]) / o.mol_len


def trial_energies(cfg, state, n_stars: int = 256, seed: int = 0):
    """The energy of each of n_stars random stars of `state` (by molecule
    id) against every other alive atom, through mol_energy_force."""
    from .obmd.subset import Subset, mol_energy_force
    ids = torch.unique(state.mol[state.alive & (state.mol != 0)])
    pick = ids[torch.from_numpy(np.random.default_rng(seed).choice(
        len(ids), n_stars, replace=False)).to(ids.device)]
    out = []
    for mid in pick.tolist():
        own = state.alive & (state.mol == mid)
        order = torch.argsort(state.tag[own])
        coords = state.x[own][order][None]
        sub = Subset(x=state.x, type=state.type, valid=state.alive & ~own,
                     overflow=torch.zeros((), dtype=torch.bool,
                                          device=state.device), q=None)
        out.append(float(mol_energy_force(cfg, sub, coords,
                                          state.type[own][order])[0][0]))
    return out


def open_state_point(steps: int) -> None:
    """The --open readings (module docstring), one JSON line a phase."""
    from .observe import (check_invariants, make_thermo_fn,
                          molecule_census)
    t0 = time.perf_counter()
    sc = scenes.star_melt_scene()
    warm = scenes.star_warm_up(sc.cfg, sc.state)
    cfg = scenes.with_cap(sc.cfg, scenes.STAR_PROD_CAP)
    st = setup(cfg, warm)
    thermo = make_thermo_fn(cfg)
    run = make_run(cfg, 20)
    marks = []
    for k in range(steps // 20):
        st = run(st)
        if k >= steps // 40:
            t = thermo(st)
            marks.append((float(t.temp), float(t.pressure), float(t.pxx)))
    m = np.asarray(marks)
    e = trial_energies(cfg, st)
    print(json.dumps(dict(
        run="closed melt", steps=st.step, marks=len(marks),
        temp=float(m[:, 0].mean()), pressure=float(m[:, 1].mean()),
        pxx=float(m[:, 2].mean()), pxx_sd=float(m[:, 2].std()),
        etarget_median=float(np.median(e)),
        trial_energy_quartiles=np.percentile(e, [25, 50, 75]).tolist(),
        wall_s=time.perf_counter() - t0)), flush=True)
    pxx, etarget = float(m[:, 2].mean()), float(np.median(e))
    del sc, warm, st
    t0 = time.perf_counter()
    probe_sc = scenes.open_star_scene(pxx=pxx, etarget=etarget)
    nbuf = census(probe_sc.cfg, probe_sc.state)
    sc = scenes.open_star_scene(pxx=pxx, etarget=etarget, nbuf=nbuf)
    st = scenes.star_warm_up(sc.cfg, sc.state)
    warmed = census(sc.cfg, st)
    tel_w = check_invariants(scenes.with_cap(sc.cfg, scenes.STAR_WARM_CAP),
                             st)
    print(json.dumps(dict(
        run="open melt warm-up", start_census=nbuf, warmed_census=warmed,
        natoms=int(st.natoms), molecules=molecule_census(sc.cfg, st),
        temp=float(temperature(sc.cfg, st)), telemetry=tel_w,
        wall_s=time.perf_counter() - t0)), flush=True)
    t0 = time.perf_counter()
    cfg = scenes.with_cap(sc.cfg, scenes.STAR_PROD_CAP)
    st = make_run(cfg, steps)(setup(cfg, st))
    torch.cuda.synchronize()
    print(json.dumps(dict(
        run="open melt production", steps=steps, census=census(cfg, st),
        natoms=int(st.natoms), molecules=molecule_census(cfg, st),
        temp=float(temperature(cfg, st)),
        telemetry=check_invariants(cfg, st),
        fullest_cell=_fullest(make_geometry(cfg), st),
        wall_s=time.perf_counter() - t0)), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--open", action="store_true",
                    help="the open star melt's state point instead")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--dt", type=float, nargs="*",
                    default=[0.01, 0.0075, 0.005, 0.004, 0.0025])
    ap.add_argument("--caps", type=int, nargs="*", default=[14, 15])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("star_probe runs on the card")
    if args.open:
        open_state_point(args.steps)
        return
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
