#!/usr/bin/env python3
"""The OBMD_DPD deck's x-profiles on the PyTorch + CUDA port, against the
reference LAMMPS binary's own run (validation/run_ref/profile_ref.out, or
with `--insertion near` validation/run_ref_near/profile_ref_near.out).

    python3 profile_torch.py [--noise gaussian|uniform] [--insertion usher|near]
                             [--steps N] [--out profile_torch.npz]
    python3 profile_torch.py --against ENGINE [--out profile_torch.npz]

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

`--against ENGINE` holds the port to another engine's run of the same
deck from the same start, saved in validation/profile_ENGINE_samestart.npz
with its settings (the JAX nlist engine's: tests/test_torch_gate_split.py
--save, ~1.7 h on 8 CPU cores): the port runs that start, seeds, noise,
insertion, equilibration and length and samples the same series
(deck_series): the atoms alive every SAMPLE_EVERY steps, the kinetic T and
the thermal T (thermal_temperature, one numpy yardstick for both engines)
up to deck step T_UNTIL, the profiles after WARM.  The figures
(against_run): compare()'s with the density gate of 1%, the thermal T in
T_WINDOW-step windows with the gate that every window mean lies within
0.03 of the other engine's, and the atom plateaus with the deleted and
inserted counts.  A conflicting --noise, --insertion or --steps is
refused; exits 1 when a gate is missed.
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
# another engine's run of the deck from the port's start (`--against
# ENGINE`; the JAX nlist engine's is made by tests/test_torch_gate_split.py
# --save)
SAMESTART = os.path.join(ROOT, "validation", "profile_{}_samestart.npz")
EQUIL, SAMPLE_EVERY, WARM, NBINS = 1500, 50, 10000, 50
# the temperature series of the same-start comparison: sampled every
# SAMPLE_EVERY steps up to deck step T_UNTIL, compared in T_WINDOW-step
# windows; the profiles also kept as BLOCKS block means
T_UNTIL, T_WINDOW, BLOCKS = 5000, 250, 10
# the x bins whose mean velocity the thermal T takes out: the reference
# deck's chunks (50 at scale 1)
T_BIN = 33.594 / NBINS


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


def kinetic_temperature(v, alive, mass):
    """`compute temp` of numpy arrays: sum(m v^2) / (3N - 3), kB = 1
    (state.temperature's rule), in float64."""
    m = np.broadcast_to(np.asarray(mass, np.float64), alive.shape)[alive]
    ke2 = float(np.sum(m[:, None] * np.asarray(v, np.float64)[alive] ** 2))
    return ke2 / max(3 * int(alive.sum()) - 3, 1)


def thermal_temperature(x, v, alive, mass, xlo, xhi, nbins):
    """The thermal temperature under a flow along x, of numpy arrays
    (observe.profile_temperature's rules, LAMMPS' `compute temp/profile 1
    1 1 x nbins`): each atom's velocity less the mass-weighted mean
    velocity of its x bin, over 3N - 3 - 3 nbins degrees of freedom.  The
    bin index is taken in float32 as the port's is; the sums in float64.
    One yardstick for any engine whose state reads out as numpy."""
    m = np.broadcast_to(np.asarray(mass, np.float64), alive.shape)[alive]
    x0 = np.asarray(x, np.float32)[alive, 0]
    b = np.clip(((x0 - np.float32(xlo)) * np.float32(nbins / (xhi - xlo)))
                .astype(np.int64), 0, nbins - 1)
    va = np.asarray(v, np.float64)[alive]
    msum = np.bincount(b, weights=m, minlength=nbins)
    vbin = np.stack([np.bincount(b, weights=m * va[:, k], minlength=nbins)
                     for k in range(3)], axis=1) / np.maximum(msum, 1e-30)[
                         :, None]
    ke2 = float(np.sum(m[:, None] * (va - vbin[b]) ** 2))
    return ke2 / max(3 * len(m) - 3 - 3 * nbins, 1)


def deck_series(state, run, profile, arrays, xlo, xhi, steps,
                every=SAMPLE_EVERY, warm=WARM, t_until=T_UNTIL,
                t_nbins=NBINS, log=None):
    """Drive `run` (every steps a call) `steps // every` times from the
    equilibrated `state` and sample the series the same-start comparison
    holds, as numpy: the atoms alive after each call; the kinetic and the
    thermal T (thermal_temperature over `t_nbins` x bins) at deck step 0
    and after each call up to step `t_until`; the profiles (`profile(state)`
    -> dict of density, vx, temp arrays) after each call past step
    `warm`.  `arrays(state)` -> (x, v, alive, per-atom mass).  Returns the
    last state and the series."""
    def temps(st):
        x, v, alive, mass = arrays(st)
        return (kinetic_temperature(v, alive, mass),
                thermal_temperature(x, v, alive, mass, xlo, xhi, t_nbins),
                int(alive.sum()))
    t_steps, t_kin, t_th, natoms, prof = [0], [], [], [], []
    tk, tt, _ = temps(state)
    t_kin.append(tk)
    t_th.append(tt)
    for c in range(1, steps // every + 1):
        state = run(state)
        s = c * every
        if s <= t_until:
            tk, tt, n = temps(state)
            t_steps.append(s)
            t_kin.append(tk)
            t_th.append(tt)
        else:
            n = int(np.asarray(arrays(state)[2]).sum())
        natoms.append(n)
        if s > warm:
            prof.append(profile(state))
        if log is not None and c % 40 == 0:
            log(state, s)
    return state, dict(
        natoms_steps=np.arange(1, len(natoms) + 1) * every,
        natoms=np.asarray(natoms, np.int32),
        t_steps=np.asarray(t_steps, np.int32),
        t_kinetic=np.asarray(t_kin), t_thermal=np.asarray(t_th),
        **{k: np.mean([p[k] for p in prof], axis=0) for k in prof[0]},
        **{f"series_{k}": np.stack([p[k] for p in prof]) for k in prof[0]},
        nsamp=len(prof))


def blocks(series, n=BLOCKS):
    """The means of `n` consecutive blocks of a [samples, bins] series."""
    return np.stack([np.mean(b, axis=0)
                     for b in np.array_split(series, min(n, len(series)))])


def as_ref(d):
    """A same-start profile (density, vx, temp) as compare()'s reference
    array: the reference binary's columns, 3-5 filled."""
    ref = np.zeros((len(d["density"]), 6))
    ref[:, 3], ref[:, 4], ref[:, 5] = d["density"], d["vx"], d["temp"]
    return ref


def first_window(means, level=0.95):
    """The 1-based index of the first window whose mean reaches `level`,
    or None."""
    hit = np.flatnonzero(np.asarray(means) >= level)
    return int(hit[0]) + 1 if len(hit) else None


def against_run(ref, ours, gate_density=0.01, gate_thermal=0.03):
    """The same-start comparison of the port's deck_series `ours` with
    another engine's saved run `ref` (both dicts of numpy arrays, with
    natoms, the temperature series and the averaged profiles): compare()'s
    figures with the density gate; the thermal and kinetic T means of each
    T_WINDOW-step window over deck steps (0, T_UNTIL], with the gate that
    every thermal-T window mean lies within `gate_thermal` of the
    reference engine's, and the window where each engine's thermal T
    first reaches 0.95; and the atom counts: the plateau (mean, min and
    max of the atoms alive after WARM), the atoms at the checkpoints, and
    the deleted and inserted counts."""
    figures = compare(as_ref(ref), ours)
    per = T_WINDOW // SAMPLE_EVERY
    win = {}
    for key in ("t_thermal", "t_kinetic"):
        for name, d in (("ref", ref), ("port", ours)):
            t = np.asarray(d[key])[1:]              # step 0 apart
            win[f"{key}_{name}"] = t[:len(t) // per * per].reshape(
                -1, per).mean(axis=1)
    dth = win["t_thermal_port"] - win["t_thermal_ref"]
    counts = {}
    for name, d in (("ref", ref), ("port", ours)):
        steps, n = np.asarray(d["natoms_steps"]), np.asarray(d["natoms"])
        late = n[steps > WARM]
        counts[name] = dict(
            plateau_mean=float(late.mean()), plateau_min=int(late.min()),
            plateau_max=int(late.max()),
            natoms_at={int(s): int(n[steps == s][0]) for s in (
                1000, 2000, 3000, 5000, 10000, int(steps[-1]))
                if s in steps},
            after_equilibrate=[int(c) for c in d["counts_after_equilibrate"]],
            end=[int(c) for c in d["counts_end"]])
    ok_d = figures["density_rmse_over_mean"] <= gate_density
    ok_t = bool(np.all(np.abs(dth) <= gate_thermal))
    return dict(
        **figures, outer_bins=outer_bins(ours["density"]),
        outer_bins_ref=outer_bins(ref["density"]),
        t_window_steps=T_WINDOW,
        t_thermal_at_0=[float(ref["t_thermal"][0]),
                        float(ours["t_thermal"][0])],
        t_kinetic_at_0=[float(ref["t_kinetic"][0]),
                        float(ours["t_kinetic"][0])],
        **{k: [float(x) for x in v] for k, v in win.items()},
        t_thermal_max_abs_diff=float(np.abs(dth).max()),
        t_thermal_first_095_window={
            "ref": first_window(win["t_thermal_ref"]),
            "port": first_window(win["t_thermal_port"])},
        counts=counts, gate_density_1pct=bool(ok_d),
        gate_thermal_003=ok_t, ok=bool(ok_d and ok_t))


def load_samestart(path):
    """A saved same-start run: (its arrays, its settings)."""
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    return d, json.loads(str(d.pop("meta")))


def card():
    """nvidia-smi's name and power limit of the cards, or None."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def port_series(cfg, state, steps, log=None):
    """deck_series of the port's run from `state` on its cellpad engine
    (make_run, make_profile_fn; every SAMPLE_EVERY steps a call)."""
    import torch
    from obmd_tpu_torch.integrate import make_run
    from obmd_tpu_torch.observe import make_profile_fn
    masses = np.asarray(cfg.masses, np.float64)
    prof = make_profile_fn(cfg, nbins=NBINS)
    lx = cfg.box.lengths[0]

    def arrays(st):
        return (st.x.cpu().numpy(), st.v.cpu().numpy(),
                st.alive.cpu().numpy(), masses[st.type.cpu().numpy()])

    def profile(st):
        p = prof(st)
        return {k: getattr(p, k).to(torch.float64).cpu().numpy()
                for k in ("density", "vx", "temp")}
    return deck_series(state, make_run(cfg, SAMPLE_EVERY), profile, arrays,
                       cfg.box.lo[0], cfg.box.hi[0], steps,
                       t_nbins=round(lx / T_BIN), log=log)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", default="ref", metavar="ENGINE",
                    help="the reference binary's profiles (ref, the "
                         "default), or the named engine's saved run from "
                         "the same start (validation/profile_ENGINE_"
                         "samestart.npz), with that run's settings")
    ap.add_argument("--noise", choices=("gaussian", "uniform"), default=None,
                    help="gaussian by default (the saved run's with "
                         "--against ENGINE)")
    ap.add_argument("--insertion", choices=("usher", "near"), default=None,
                    help="usher by default (the saved run's with "
                         "--against ENGINE)")
    ap.add_argument("--steps", type=int, default=None,
                    help="the deck's own length by default")
    ap.add_argument("--out", default=os.path.join(ROOT, "profile_torch.npz"))
    a = ap.parse_args()
    sref = meta = None
    if a.against != "ref":
        saved = SAMESTART.format(a.against)
        if not os.path.exists(saved):
            ap.error(f"no saved run {saved}")
        sref, meta = load_samestart(saved)
        if meta["engine"] != a.against:
            ap.error(f"{saved} is {meta['engine']}'s run")
        for k, want in (("noise", meta["noise"]),
                        ("insertion", meta["insertion"]),
                        ("steps", meta["steps"])):
            if getattr(a, k) not in (None, want):
                ap.error(f"--{k} {getattr(a, k)} conflicts with the saved "
                         f"run's {want}")
        a.noise, a.insertion, a.steps = (meta["noise"], meta["insertion"],
                                         meta["steps"])
    a.noise = a.noise or "gaussian"
    a.insertion = a.insertion or "usher"
    ref_path, ref_steps = REF[a.insertion]
    steps = ref_steps if a.steps is None else a.steps
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch.py needs a GPU: "
                           "torch.cuda.is_available() is False")
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.integrate import equilibrate, setup
    from obmd_tpu_torch.observe import check_invariants, make_thermo_fn

    sc = scenes.obmd_dpd_scene(
        scale=1.0 if meta is None else meta["scale"],
        seed=7 if meta is None else meta["scene_seed"], device="cuda",
        usher=a.insertion == "usher")
    cfg = deck_config(sc.cfg, a.noise)
    o = cfg.obmd
    assert (cfg.pair.a0[0][0], cfg.pair.gamma[0][0], cfg.dt, o.pxx, o.alpha,
            o.tau, o.nbuf) == (209.6, 4.5, 0.001464, 188.0, 0.7, 0.005,
                               1327.0)
    assert (o.usher.etarget if a.insertion == "usher" else o.near) == \
        (31.03 if a.insertion == "usher" else 0.35)
    equil = EQUIL
    if meta is not None:
        assert (cfg.pair.seed, o.seed, SAMPLE_EVERY, WARM, NBINS, T_UNTIL,
                round(cfg.box.lengths[0] / T_BIN)) \
            == (meta["pair_seed"], meta["obmd_seed"], meta["sample_every"],
                meta["warm"], meta["nbins"], meta["t_until"],
                meta["t_nbins"]), meta
        equil = meta["equil"]
    thermo = make_thermo_fn(cfg)

    def log(st, s):
        th = thermo(st)
        print(f"step {s} T {float(th.temp):.4f} N {int(th.natoms)} P "
              f"{float(th.pressure):.2f} ins {int(st.obmd.ninserted)} del "
              f"{int(st.obmd.ndeleted)} fail {int(st.obmd.insert_fail)}",
              file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    state = equilibrate(cfg, setup(cfg, sc.state), equil)
    counts0 = (int(state.natoms), int(state.obmd.ndeleted),
               int(state.obmd.ninserted))
    state, ours = port_series(cfg, state, steps, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tel = check_invariants(cfg, state)
    ours["counts_after_equilibrate"] = np.asarray(counts0, np.int64)
    ours["counts_end"] = np.asarray([int(state.natoms),
                                     int(state.obmd.ndeleted),
                                     int(state.obmd.ninserted)], np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    np.savez(a.out, **ours)
    head = dict(device=torch.cuda.get_device_name(0), card=card(),
                noise=a.noise, insertion=a.insertion, steps=steps,
                equilibrate_steps=equil, samples=int(ours["nsamp"]),
                wall_s=wall, telemetry=tel)
    if sref is not None:
        figures = against_run(sref, ours)
        print(json.dumps(dict(
            head, against=a.against, reference=os.path.relpath(saved, ROOT),
            reference_engine=f"{meta['engine']} {meta['force_path']}",
            **figures)))
        return 0 if figures["ok"] else 1
    ref = load_ref(ref_path)
    figures = compare(ref, ours)
    ok = figures["density_rmse_over_mean"] <= 0.01
    natoms = ours["natoms"]
    print(json.dumps(dict(
        head, reference=os.path.relpath(ref_path, ROOT),
        natoms_after_equilibrate=counts0[0], natoms=int(state.natoms),
        natoms_at=dict((s, int(natoms[s // SAMPLE_EVERY - 1])) for s in (
            1000, 2000, 3000, 5000, 10000, steps) if s <= steps),
        deleted=int(state.obmd.ndeleted), inserted=int(state.obmd.ninserted),
        deleted_in_equilibrate=counts0[1],
        inserted_in_equilibrate=counts0[2],
        outer_bins=outer_bins(ours["density"]),
        outer_bins_ref=outer_bins(ref[:, 3]),
        gate_density_1pct=ok, **figures)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
