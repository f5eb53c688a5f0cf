"""Path I's state point, filing cap and USHER setting, on the card.

    python3 -m obmd_tpu_torch.water_probe [--steps 2000] [--warm 500]

Closed box (`closed`): scenes.closed_water_scene() (7,220 SPC/E waters in
a periodic 6.009 x 6 x 6 nm box) melted by scenes.water_warm_up, then
`steps` steps under the Langevin thermostat at kT 2.4943; over the second
half every 20 steps thermo's T and the molecular and atomic P_xx
(observe.molecular_pxx); at the end the energy of 256 waters (numpy seed
0), each taken out and tested against the rest with its charges
(subset.mol_energy_force(..., mol_q=q)), their median and quartiles.

Open box (`open`): scenes.open_water_scene() at that P_xx and etarget,
nbuf the start's buffer census in molecules, melted by water_warm_up
under the stage; the warmed census, the fullest cell, and `steps` // 4
production steps (inserted, deleted, whole molecules, T, the constraint
error, the net charge).

USHER (`usher`): on the warmed open box, a quarter of each buffer's atoms
taken out, one stage call's searches of 4 K trials a side
(uniform centers and rotations, `usher_search_subset_mol` with the
charges) at the scene's USHER setting and at the LJ-unit setting
converted to nm (dsovlp 1.5 sigma, eps eps_OO sigma^12): the share of
searches that succeed and their iterations.

Each phase prints one JSON line; scenes.OPEN_WATER_ETARGET,
OPEN_WATER_PXX, OPEN_WATER_CENSUS and WATER_CAP are read from them, with
the card's name and power limit (the first line).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from . import scenes
from .engine_cellpad import make_geometry
from .integrate import make_run, setup
from .observe import (check_invariants, make_thermo_fn, molecular_pxx,
                      molecule_report)
from .star_probe import _fullest, census


def trial_energies(cfg, state, n_mols: int = 256, seed: int = 0):
    """The energy of each of n_mols random molecules of `state` (by
    molecule id), with its charges, against every other alive atom."""
    from .obmd.subset import Subset, mol_energy_force
    ids = torch.unique(state.mol[state.alive & (state.mol != 0)])
    pick = ids[torch.from_numpy(np.random.default_rng(seed).choice(
        len(ids), n_mols, replace=False)).to(ids.device)]
    out = []
    for mid in pick.tolist():
        own = state.alive & (state.mol == mid)
        order = torch.argsort(state.tag[own])
        sub = Subset(x=state.x, type=state.type, valid=state.alive & ~own,
                     overflow=torch.zeros((), dtype=torch.bool,
                                          device=state.device), q=state.q)
        out.append(float(mol_energy_force(
            cfg, sub, state.x[own][order][None], state.type[own][order],
            mol_q=state.q[own][order])[0][0]))
    return out


def closed_state_point(steps: int, warm: int) -> tuple:
    t0 = time.perf_counter()
    sc = scenes.closed_water_scene()
    cfg = sc.cfg
    st = scenes.water_warm_up(cfg, sc.state, warm)
    st = setup(cfg, st)
    thermo = make_thermo_fn(cfg)
    run = make_run(cfg, 20)
    marks = []
    for k in range(steps // 20):
        st = run(st)
        if k >= steps // 40:
            pm, pa = molecular_pxx(cfg, st)
            marks.append((float(thermo(st).temp), pm, pa))
    m = np.asarray(marks)
    e = trial_energies(cfg, st)
    out = dict(run="closed", waters=int(st.natoms) // 3, steps=st.step,
               marks=len(marks), thermo_temp=float(m[:, 0].mean()),
               pxx_molecular=float(m[:, 1].mean()),
               pxx_molecular_sd=float(m[:, 1].std()),
               pxx_atomic=float(m[:, 2].mean()),
               etarget_median=float(np.median(e)),
               trial_energy_quartiles=np.percentile(e, [25, 50, 75]).tolist(),
               fullest_cell=_fullest(make_geometry(cfg), st),
               report=molecule_report(cfg, st, (scenes.water_template(),)),
               telemetry=check_invariants(cfg, st),
               wall_s=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    return out["pxx_molecular"], out["etarget_median"]


def search_share(cfg, state, k_trials: int, seed: int = 3) -> dict:
    """One stage call's molecule searches, 4 K trials a side at the
    buffers of `state`: the share accepted and the iterations."""
    from .engine_cellpad import _subset_slice, _templates
    from .obmd.stage import draw_candidates
    from .obmd.subset import (mol_candidates_sel, random_rotations,
                              usher_search_subset_mol)
    o = cfg.obmd
    geom = make_geometry(cfg)
    g = torch.Generator(device=state.device)
    g.manual_seed(seed)
    k = k_trials
    cfg_k = dataclasses.replace(cfg, obmd=dataclasses.replace(
        o, insert_kmax=k))
    u = torch.rand((2, k, 7), generator=g, device=state.device)
    tpl = _templates(o, state.device, state.dtype)
    out = {}
    for side, region in ((0, o.region5), (1, o.region6)):
        sub = _subset_slice(cfg, geom, state, region,
                            cfg.pair.max_cut + cfg.skin)
        us = u[side]
        centers = draw_candidates(cfg_k, us[:, :3], None, region, state)[0]
        rots = random_rotations(us[:, 3:6], us[:, 6])
        t0 = tpl["types"][0].expand(k, -1)
        coords = mol_candidates_sel(tpl["dx"][0].expand(k, -1, -1),
                                    tpl["amask"][0].expand(k, -1), centers,
                                    rots)
        pos, ok, it = usher_search_subset_mol(
            cfg_k, sub, coords, t0, region,
            mol_q=tpl["q"][0].expand(k, -1))
        out[side] = dict(accepted=int(ok.sum()), trials=k,
                         mean_iters=float(it.float().mean()))
    return out


def open_box(pxx: float, etarget: float, steps: int, warm: int) -> None:
    t0 = time.perf_counter()
    probe = scenes.open_water_scene(pxx=pxx, etarget=etarget,
                                    device="cpu")
    nbuf = census(probe.cfg, probe.state)
    del probe
    sc = scenes.open_water_scene(pxx=pxx, etarget=etarget, nbuf=nbuf)
    cfg = sc.cfg
    st = scenes.water_warm_up(cfg, sc.state, warm)
    warmed = census(cfg, st)
    print(json.dumps(dict(
        run="open warm-up", start_census=nbuf, warmed_census=warmed,
        natoms=int(st.natoms), fullest_cell=_fullest(make_geometry(cfg), st),
        report=molecule_report(cfg, st), telemetry=check_invariants(cfg, st),
        wall_s=time.perf_counter() - t0)), flush=True)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, nbuf=warmed)).finalize()
    st = setup(cfg, st)
    thermo = make_thermo_fn(cfg)
    run = make_run(cfg, steps // 4)
    st = run(st)
    torch.cuda.synchronize()
    print(json.dumps(dict(
        run="open production", steps=steps // 4, census=census(cfg, st),
        natoms=int(st.natoms), thermo_temp=float(thermo(st).temp),
        fullest_cell=_fullest(make_geometry(cfg), st),
        report=molecule_report(cfg, st), telemetry=check_invariants(cfg, st),
        wall_s=time.perf_counter() - t0)), flush=True)
    o = cfg.obmd
    sigma = scenes.WATER_SIGMA
    converted = dataclasses.replace(o.usher, dsovlp=1.5 * sigma,
                                    eps=scenes.WATER_EPS * sigma ** 12)
    g = torch.Generator(device=st.device)
    g.manual_seed(7)
    band = st.alive & (o.region1.match(st.x) | o.region2.match(st.x))
    out_mol = torch.unique(st.mol[band & (torch.rand(
        band.shape, generator=g, device=st.device) < 0.25)])
    gone = torch.isin(st.mol, out_mol) & st.alive
    drained = st.replace(alive=st.alive & ~gone,
                         tag=torch.where(gone, -1, st.tag))
    shares = {}
    for name, u in (("scene", o.usher), ("converted", converted)):
        c = dataclasses.replace(cfg, obmd=dataclasses.replace(o, usher=u))
        shares[name] = dict(usher=dataclasses.asdict(u),
                            sides=search_share(c, drained,
                                               4 * o.insert_kmax))
    print(json.dumps(dict(run="usher", searches=shares)), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--warm", type=int, default=scenes.WATER_WARM_STEPS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("water_probe runs on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps(dict(card=smi.stdout.strip())), flush=True)
    pxx, etarget = closed_state_point(args.steps, args.warm)
    open_box(pxx, etarget, args.steps, args.warm)


if __name__ == "__main__":
    main()
