#!/usr/bin/env python3
"""The OBMD_DPD deck's x-profiles on the PyTorch + CUDA port, against the
reference LAMMPS binary's own run (validation/run_ref/profile_ref.out, or
with `--insertion near` validation/run_ref_near/profile_ref_near.out).

    python3 profile_torch.py [--noise gaussian|uniform] [--insertion usher|near]
                             [--steps N] [--out profile_torch.npz]

The port's copy of validation/run_ours.py with the reference deck's
settings (validation/run_ref/in.obmd): `pair_style dpd 1.0 1.0 8893`,
`pair_coeff * * 209.6 4.5 1.0`, dt 0.001464, `fix obmd` seed 777, pxx 188,
alpha 0.7, tau 0.005, nbuf 1327, `usher 31.03 1.0 0.02 1e4 1.5 1.0 40`,
60,000 steps, 50 bins in x, with the gaussian pair noise of LAMMPS'
`pair dpd` (random->gaussian()).  `--insertion near` takes the reference's
other deck (validation/run_ref_near/in.obmd_near: `near 1 0.35` in place of
`usher`, 50,000 steps); `--noise uniform` the JAX package's default
uniform pair noise (validation/run_ours.py's law), to split the noise law
from the rest.  The reference runs start from their equilibrated data
file, which is not in the repository; this run starts from
obmd_tpu_torch.scenes.obmd_dpd_scene(scale=1, seed=7) (the same box and
atom count, a uniform gas), tames its start-up transient with 1,500 steps
of integrate.equilibrate, and then runs the deck's steps.  Profiles
(observe.make_profile_fn) are sampled every 50 steps and averaged after
step 10,000 of the deck, as validation/compare_profiles.py averages the
reference's; the comparison is that script's: density RMSE/mean, vx RMSE,
T RMSE/mean over all bins and over the bulk bins (reference density >
0.5), with the outermost two bins of each side beside the reference's and
the deleted and inserted counts.  The gate is validation/REPORT.md's:
density RMSE/mean <= 1%.  Prints the figures as one JSON line; exits 1
when the gate is missed.  Runs on the GPU and raises without one.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# the reference binary's profiles and its run's length, per insertion
REF = {"usher": (os.path.join(ROOT, "validation", "run_ref",
                              "profile_ref.out"), 60000),
       "near": (os.path.join(ROOT, "validation", "run_ref_near",
                             "profile_ref_near.out"), 50000)}
EQUIL, SAMPLE_EVERY, WARM, NBINS = 1500, 50, 10000, 50


def load_ref(path, skip_until=WARM):
    """validation/compare_profiles.py's reader: the `fix ave/chunk` blocks
    (step, chunks, count, then one row per chunk: chunk, coord, count,
    density, vx, temp) after `skip_until`, averaged."""
    lines = open(path).read().splitlines()
    windows = []
    i = 0
    while i < len(lines):
        if lines[i].startswith("#"):
            i += 1
            continue
        t = lines[i].split()
        if len(t) == 3:
            step, nch = int(t[0]), int(t[1])
            rows = [[float(v) for v in lines[i + 1 + k].split()]
                    for k in range(nch)]
            i += nch
            windows.append((step, np.asarray(rows)))
        i += 1
    return np.mean([w for s, w in windows if s > skip_until], axis=0)


def compare(ref, ours):
    """compare_profiles.py's figures of two averaged profiles."""
    dr, vr, tr = ref[:, 3], ref[:, 4], ref[:, 5]
    do, vo, to = ours["density"], ours["vx"], ours["temp"]

    def rmse(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)))
    bulk = dr > 0.5
    return dict(
        density_ref_mean=float(dr.mean()), density_mean=float(do.mean()),
        density_rmse_over_mean=rmse(dr, do) / float(dr.mean()),
        vx_rmse=rmse(vr, vo),
        temp_ref_mean=float(tr.mean()), temp_mean=float(to.mean()),
        temp_rmse_over_mean=rmse(tr, to) / float(tr.mean()),
        temp_bulk_rmse_over_mean=rmse(tr[bulk], to[bulk])
        / float(tr[bulk].mean()))


def deck_config(cfg, noise="gaussian"):
    """The reference deck's seeds and pair noise law (gaussian, or the JAX
    package's default uniform) on the scene's configuration (every other
    setting is already the deck's)."""
    return dataclasses.replace(
        cfg, pair=dataclasses.replace(cfg.pair, seed=8893,
                                      gaussian_noise=noise == "gaussian"),
        obmd=dataclasses.replace(cfg.obmd, seed=777)).finalize()


def outer_bins(density):
    """The outermost two bins of each side: bins 0, 1, n-2, n-1."""
    return [float(density[i]) for i in (0, 1, -2, -1)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--noise", choices=("gaussian", "uniform"),
                    default="gaussian")
    ap.add_argument("--insertion", choices=("usher", "near"),
                    default="usher")
    ap.add_argument("--steps", type=int, default=None,
                    help="the deck's own length by default")
    ap.add_argument("--out", default=os.path.join(ROOT, "profile_torch.npz"))
    a = ap.parse_args()
    ref_path, ref_steps = REF[a.insertion]
    steps = ref_steps if a.steps is None else a.steps
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch.py needs a GPU: "
                           "torch.cuda.is_available() is False")
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.integrate import equilibrate, make_run, setup
    from obmd_tpu_torch.observe import (check_invariants, make_profile_fn,
                                        make_thermo_fn)

    sc = scenes.obmd_dpd_scene(scale=1.0, seed=7, device="cuda",
                               usher=a.insertion == "usher")
    cfg = deck_config(sc.cfg, a.noise)
    o = cfg.obmd
    assert (cfg.pair.a0[0][0], cfg.pair.gamma[0][0], cfg.dt, o.pxx, o.alpha,
            o.tau, o.nbuf) == (209.6, 4.5, 0.001464, 188.0, 0.7, 0.005,
                               1327.0)
    assert (o.usher.etarget if a.insertion == "usher" else o.near) == \
        (31.03 if a.insertion == "usher" else 0.35)
    t0 = time.perf_counter()
    state = equilibrate(cfg, setup(cfg, sc.state), EQUIL)
    step0 = state.step
    counts0 = (int(state.natoms), int(state.obmd.ndeleted),
               int(state.obmd.ninserted))
    run = make_run(cfg, SAMPLE_EVERY)
    profile = make_profile_fn(cfg, nbins=NBINS)
    thermo = make_thermo_fn(cfg)
    series, natoms = [], []
    for c in range(steps // SAMPLE_EVERY):
        state = run(state)
        natoms.append(int(state.natoms))
        if (c + 1) * SAMPLE_EVERY > WARM:
            p = profile(state)
            series.append({k: getattr(p, k).double().cpu().numpy()
                           for k in ("density", "vx", "temp")})
        if (c + 1) % 40 == 0:
            th = thermo(state)
            print(f"step {state.step - step0} T {float(th.temp):.4f} N "
                  f"{int(th.natoms)} P {float(th.pressure):.2f} ins "
                  f"{int(state.obmd.ninserted)} del "
                  f"{int(state.obmd.ndeleted)} fail "
                  f"{int(state.obmd.insert_fail)}", file=sys.stderr,
                  flush=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tel = check_invariants(cfg, state)
    ours = {k: np.mean([s[k] for s in series], axis=0) for k in series[0]}
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    np.savez(a.out, nsamp=len(series), natoms=np.asarray(natoms), **ours,
             **{f"series_{k}": np.stack([s[k] for s in series])
                for k in series[0]})
    ref = load_ref(ref_path)
    figures = compare(ref, ours)
    ok = figures["density_rmse_over_mean"] <= 0.01
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), noise=a.noise,
        insertion=a.insertion, reference=os.path.relpath(ref_path, ROOT),
        steps=steps, equilibrate_steps=EQUIL, samples=len(series),
        wall_s=wall, natoms_after_equilibrate=counts0[0],
        natoms=int(state.natoms),
        natoms_at=dict((s, natoms[s // SAMPLE_EVERY - 1]) for s in (
            1000, 2000, 3000, 5000, 10000, steps) if s <= steps),
        deleted=int(state.obmd.ndeleted), inserted=int(state.obmd.ninserted),
        deleted_in_equilibrate=counts0[1],
        inserted_in_equilibrate=counts0[2],
        outer_bins=outer_bins(ours["density"]),
        outer_bins_ref=outer_bins(ref[:, 3]), telemetry=tel,
        gate_density_1pct=ok, **figures)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
