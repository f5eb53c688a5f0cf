#!/usr/bin/env python3
"""The pressure wave and the Couette shear of the OBMD_DPD deck (BASELINE
configs 2 and 3) on the PyTorch + CUDA port, held statistically.

    python3 shear_torch.py [--out PATH.json]

Each runs the protocol of the JAX package's script through obmd_tpu_torch
on one GPU (the card unless --device cpu), and prints one JSON line:

- wave (validation/run_wave.py): obmd_dpd_scene(scale=1, seed=4) with the
  left buffer's load pxx + dpxx sin(2 pi freq t), dpxx 60, freq 2; setup,
  800 steps of equilibrate, then 24,000 steps sampling every 20 the mean
  vx of the atoms in 12 < x < 22.  Gate: the response's amplitude at the
  drive frequency (its two quadratures) above 3x the amplitude at 2.7x
  the frequency.  Beside it the JAX run's amplitude in
  validation/wave.npz (0.0198).
- Couette (validation/run_couette.py): obmd_dpd_scene(scale=1, seed=11)
  with pxy 2 on the buffers (region3 = region1, region4 = region2); setup,
  600 steps of equilibrate, then 40,000 steps, averaging the vy profile
  over 40 x bins every 50 steps after the first 15,000.  Gate: the
  correlation r of vy against x over bins 8-31 below -0.99.  Beside it
  the JAX run's slope in validation/couette.npz (-0.1814).

The error bars are the run's own: the series split into BLOCKS
consecutive blocks, the figure computed on each, their standard
deviation over sqrt(BLOCKS).  Nothing is written under validation/; the
process exits 1 when a gate is missed.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

BLOCKS = 5
HERE = os.path.dirname(os.path.abspath(__file__))


def _amplitude(t, vx, freq):
    """The amplitude of vx's component at freq (two quadratures)."""
    a = 2 * np.mean(vx * np.sin(2 * np.pi * freq * t))
    b = 2 * np.mean(vx * np.cos(2 * np.pi * freq * t))
    return float(np.hypot(a, b))


def _blocks(fn, *series):
    """(mean, standard error) of fn over BLOCKS consecutive blocks."""
    vals = [fn(*(np.array_split(s, BLOCKS)[i] for s in series))
            for i in range(BLOCKS)]
    return float(np.mean(vals)), float(np.std(vals, ddof=1)
                                       / np.sqrt(BLOCKS))


def wave(device, dpxx=60.0, freq=2.0, total=24000, every=20):
    import torch
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.integrate import equilibrate, make_run, setup
    sc = scenes.obmd_dpd_scene(scale=1.0, seed=4, device=device)
    cfg = dataclasses.replace(sc.cfg, obmd=dataclasses.replace(
        sc.cfg.obmd, dpxx=float(dpxx), freq=float(freq))).finalize()
    state = equilibrate(cfg, setup(cfg, sc.state), 800)
    run = make_run(cfg, every)
    ts, vxs = [], []
    t0 = time.perf_counter()
    for _ in range(total // every):
        state = run(state)
        x0 = state.x[:, 0]
        m = state.alive & (x0 > 12.0) & (x0 < 22.0)
        ts.append(state.sim_time)
        vxs.append(state.v[:, 0][m].mean())
    t = torch.stack(ts).cpu().numpy().astype(np.float64)
    vx = torch.stack(vxs).cpu().numpy().astype(np.float64)
    wall = time.perf_counter() - t0
    vx = vx - vx.mean()
    amp = _amplitude(t, vx, freq)
    amp_off = _amplitude(t, vx, 2.7 * freq)
    _, amp_err = _blocks(lambda tt, vv: _amplitude(tt, vv - vv.mean(), freq),
                         t, vx)
    ref = np.load(os.path.join(HERE, "validation", "wave.npz"))
    return dict(amplitude=amp, amplitude_err=amp_err, off_frequency=amp_off,
                gate=bool(amp > 3 * amp_off),
                jax_amplitude=float(ref["amp"]),
                jax_off_frequency=float(ref["amp_off"]),
                steps=total, wall_s=wall, ms_per_step=wall / total * 1e3,
                atoms=int(state.natoms))


def couette(device, pxy=2.0, total=40000, warm=15000, every=50, nbins=40):
    import torch
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.integrate import equilibrate, make_run, setup
    sc = scenes.obmd_dpd_scene(scale=1.0, seed=11, device=device)
    ob = sc.cfg.obmd
    cfg = dataclasses.replace(sc.cfg, obmd=dataclasses.replace(
        ob, region3=ob.region1, region4=ob.region2,
        pxy=float(pxy))).finalize()
    state = equilibrate(cfg, setup(cfg, sc.state), 600)
    run = make_run(cfg, every)
    width = cfg.box.hi[0] / nbins
    x = (np.arange(nbins) + 0.5) * width
    profiles = []
    t0 = time.perf_counter()
    for c in range(total // every):
        state = run(state)
        if c * every < warm:
            continue
        b = torch.clamp((state.x[:, 0] / width).to(torch.int64), 0,
                        nbins - 1)
        b = torch.where(state.alive, b, nbins)
        zero = torch.zeros((nbins + 1,), dtype=state.dtype,
                           device=state.device)
        cnt = zero.index_add(0, b, torch.ones_like(state.v[:, 1]))
        vy = zero.index_add(0, b, state.v[:, 1])
        profiles.append((vy / cnt.clamp(min=1e-9))[:nbins])
    vy = torch.stack(profiles).cpu().numpy().astype(np.float64)
    wall = time.perf_counter() - t0
    sl = slice(8, 32)

    def fit(p):
        mean = p.mean(0)
        return np.polyfit(x[sl], mean[sl], 1)[0]
    mean = vy.mean(0)
    slope = float(np.polyfit(x[sl], mean[sl], 1)[0])
    r = float(np.corrcoef(x[sl], mean[sl])[0, 1])
    _, slope_err = _blocks(fit, vy)
    ref = np.load(os.path.join(HERE, "validation", "couette.npz"))
    return dict(slope=slope, slope_err=slope_err, r=r, gate=bool(r < -0.99),
                jax_slope=float(ref["slope"]), jax_r=float(ref["r"]),
                samples=len(profiles), vy_left=float(mean[8]),
                vy_right=float(mean[31]), steps=total, wall_s=wall,
                ms_per_step=wall / total * 1e3, atoms=int(state.natoms))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON line to this file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    card = None
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    out = dict(card=card, wave=wave(args.device),
               couette=couette(args.device))
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if not (out["wave"]["gate"] and out["couette"]["gate"]):
        sys.exit(1)


if __name__ == "__main__":
    main()
