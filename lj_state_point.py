#!/usr/bin/env python3
"""The open LJ fluids' state points on one NVIDIA GPU: the readings behind
obmd_tpu_torch.scenes.OBMD_LJ_ETARGET and OBMD_LJ_PXX (the open LJ fluid)
and OBMD_LJRF_ETARGET and OBMD_LJRF_PXX (the open charged two-type fluid).

    python3 lj_state_point.py [lj | ljrf]     (no argument: both)

1. The bulk liquid: lj_melt_scene(nx=20) (in.lj, 32,000 atoms, periodic)
   under the open fluid's Langevin thermostat (T* = 0.722, damp 1): setup,
   the open path's melt (equilibrate MELT steps at T = 1.44), SETTLE steps,
   then thermo every 20 steps over the last READ steps.  Prints the means of
   T, E_pair/N and the pressure, and the 400-step block means before them
   (the drift the reading has left).
2. The OBMD_DPD deck's own convention: a periodic cube of the deck's fluid
   (11.198^3 at rho = 3, a0 = 209.6, its dt and thermostat), equilibrated
   from a uniform gas, E_pair/N and the pressure beside the deck's etarget
   31.03 and pxx 188.
3. USHER acceptance on the ended bulk liquid: K uniform candidates in each
   of two 8-wide slabs through the middle of the box (all 32,000 atoms the
   subset), the plain search on the card at etarget = E_pair/N and at
   2 E_pair/N, with the fix's default steps (ds0 1, dsovlp 1.5, 40
   iterations) and with shorter or longer ones.
4. The charged fluid's bulk (ljrf): scenes.ljrf_bulk_scene(nx=20), 32,000
   atoms of the open charged fluid's composition (10% ions at +-0.5, the
   two-type lj/cut/rf law) in the LJ melt's periodic box under the same
   thermostat, the same melt, settling and reading: the mean per-atom pair
   energy of the neutral type-0 solvent (half of each incident pair's
   energy; the USHER target of neutral type-0 trials), E_pair/N and the
   pressure (the reaction-field virial included), then USHER acceptance on
   its ended state at etarget = the solvent's mean energy.

Prints one JSON line; exits non-zero without a GPU.
"""
import dataclasses
import json
import subprocess
import sys

import numpy as np

MELT, SETTLE, READ, EVERY = 400, 3600, 400, 20
DPD_EQUIL, DPD_READ = 1000, 600
K = 128
STEPS = ((1.0, 1.5, 40), (0.2, 1.5, 40), (0.2, 1.0, 40), (1.0, 1.5, 100))


def solvent_energy(cfg, st):
    """Mean per-atom pair energy of the alive type-0 atoms."""
    import torch
    from obmd_tpu_torch.integrate import compute_forces, make_grid_spec
    pf, _ = compute_forces(cfg, make_grid_spec(cfg), st, compute_energy=True)
    solvent = st.alive & (st.type == 0)
    return float(torch.where(solvent, pf.pe, 0.0).sum()) / int(solvent.sum())


def marks(cfg, thermo, st):
    """(T, E_pair/N, pressure, type-0 mean pair energy) of one state."""
    t = thermo(st)
    return (float(t.temp), float(t.epair) / int(t.natoms), float(t.pressure),
            solvent_energy(cfg, st))


def thermo_means(cfg, thermo, run, st, nsteps, every):
    rows = []
    for _ in range(nsteps // every):
        st = run(st)
        rows.append(marks(cfg, thermo, st))
    return st, np.asarray(rows).mean(0).tolist()


def bulk(cfg, state):
    """Melt, settle and read one periodic bulk liquid (steps 1 and 4)."""
    from obmd_tpu_torch.integrate import equilibrate, make_run, setup
    from obmd_tpu_torch.observe import make_thermo_fn
    thermo = make_thermo_fn(cfg)
    st = equilibrate(cfg, setup(cfg, state), MELT, temp=1.44)
    blocks = []
    run400 = make_run(cfg, 400)
    for _ in range(SETTLE // 400):
        st = run400(st)
        blocks.append([st.step, *marks(cfg, thermo, st)])
    st, (temp, epair, press, e0) = thermo_means(
        cfg, thermo, make_run(cfg, EVERY), st, READ, EVERY)
    return st, dict(temp=temp, epair_per_atom=epair, pressure=press,
                    type0_pair_energy_per_atom=e0, settle_marks=blocks)


def bulk_lj(dev):
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.config import LangevinParams
    sc = scenes.lj_melt_scene(nx=20, device=dev)
    cfg = dataclasses.replace(sc.cfg, langevin=LangevinParams(
        temp=scenes.OBMD_LJ_TEMP, damp=1.0))
    st, out = bulk(cfg, sc.state)
    return cfg, st, out


def bulk_ljrf(dev):
    from obmd_tpu_torch import scenes
    sc = scenes.ljrf_bulk_scene(nx=20, device=dev)
    st, out = bulk(sc.cfg, sc.state)
    return sc.cfg, st, out


def dpd_deck(dev):
    from obmd_tpu_torch.config import Capacity, DPDParams, SceneConfig
    from obmd_tpu_torch.geometry import Box
    from obmd_tpu_torch.integrate import equilibrate, make_run, setup
    from obmd_tpu_torch.observe import make_thermo_fn
    from obmd_tpu_torch.state import init_state
    L = 11.198
    pair = DPDParams.create(temp=1.0, cutoff=1.0, seed=2349852, a0=209.6,
                            gamma=4.5)
    n = int(3.0 * L ** 3)
    cfg = SceneConfig(box=Box((0.0, 0.0, 0.0), (L, L, L), (True, True, True)),
                      masses=(1.0,), pair=pair, dt=0.001464,
                      capacity=Capacity(n_max=n, cell_capacity=24), skin=0.39)
    r = np.random.default_rng(1)
    st = init_state(cfg, r.uniform(0.0, L, (n, 3)), v=r.normal(0, 1, (n, 3)),
                    device=dev)
    st = equilibrate(cfg, setup(cfg, st), DPD_EQUIL)
    _, (temp, epair, press) = thermo_means(make_thermo_fn(cfg),
                                           make_run(cfg, EVERY), st, DPD_READ,
                                           EVERY)
    return dict(atoms=n, temp=temp, epair_per_atom=epair, pressure=press,
                deck_etarget=31.03, deck_pxx=188.0)


def acceptance(cfg, st, etarget, ds0, dsovlp, nattempt):
    """Accepted of 2K candidates, and how many started above uovlp."""
    import torch
    from obmd_tpu_torch.config import ObmdParams, UsherParams
    from obmd_tpu_torch.geometry import RegionBlock
    from obmd_tpu_torch.obmd.subset import (Subset, _batched_energy_force,
                                            usher_search_subset_batch)
    L = cfg.box.lengths
    mid = 0.5 * L[0]
    r_l = RegionBlock((mid - 8.0, 0.0, 0.0), (mid, L[1], L[2]))
    r_r = RegionBlock((mid, 0.0, 0.0), (mid + 8.0, L[1], L[2]))
    ob = ObmdParams(ntype=0, nfreq=1, seed=1, pxx=0.0, region1=r_l,
                    region2=r_r, region5=r_l, region6=r_r, insert_kmax=K,
                    usher=UsherParams(etarget=etarget, ds0=ds0,
                                      dsovlp=dsovlp, nattempt=nattempt))
    cfg = dataclasses.replace(cfg, obmd=ob)
    x = st.x[st.alive]
    b = x.shape[0]
    dev = x.device
    sub = Subset(x=x, type=st.type[st.alive],
                 valid=torch.ones((b,), dtype=torch.bool, device=dev),
                 overflow=torch.zeros((), dtype=torch.bool, device=dev),
                 q=st.q[st.alive])
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    u = torch.rand((2, K, 3), generator=g, device=dev)
    cl, cr = r_l.sample_uniform(u[0]), r_r.sample_uniform(u[1])
    ct = torch.zeros((K,), dtype=torch.int32, device=dev)
    e0, _ = _batched_energy_force(
        cfg.pair, torch.stack([x, x]), torch.stack([sub.type, sub.type]),
        torch.stack([sub.valid, sub.valid]), torch.stack([cl, cr]),
        torch.stack([ct, ct]), box=cfg.box, sub_q=torch.stack([sub.q, sub.q]))
    _, acc, iters = usher_search_subset_batch(cfg, sub, sub, cl, cr, ct, r_l,
                                              r_r)
    return dict(etarget=etarget, ds0=ds0, dsovlp=dsovlp, nattempt=nattempt,
                accepted=int(acc.sum()), candidates=2 * K,
                started_above_uovlp=int((e0 > 1e4).sum()),
                mean_iters=float(iters.float().mean()))


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("lj_state_point: FAIL: this reading needs a GPU")
    which = sys.argv[1:] or ["lj", "ljrf"]
    if not set(which) <= {"lj", "ljrf"}:
        sys.exit(f"lj_state_point: unknown reading {which}; use lj or ljrf")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = dict(card=card)
    if "lj" in which:
        cfg, st, lj = bulk_lj("cuda")
        print(f"bulk LJ: {lj}", file=sys.stderr, flush=True)
        dpd = dpd_deck("cuda")
        print(f"OBMD_DPD deck fluid: {dpd}", file=sys.stderr, flush=True)
        e = lj["epair_per_atom"]
        usher = [acceptance(cfg, st, et, *steps)
                 for et in (e, 2.0 * e) for steps in STEPS]
        for u in usher:
            print(f"usher: {u}", file=sys.stderr, flush=True)
        out.update(bulk_lj=lj, dpd_deck=dpd, usher_acceptance=usher)
    if "ljrf" in which:
        cfg, st, rf = bulk_ljrf("cuda")
        print(f"bulk charged two-type fluid: {rf}", file=sys.stderr,
              flush=True)
        e0 = rf["type0_pair_energy_per_atom"]
        usher = [acceptance(cfg, st, e0, *STEPS[0])]
        print(f"usher: {usher}", file=sys.stderr, flush=True)
        out.update(bulk_ljrf=rf, ljrf_usher_acceptance=usher)
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
