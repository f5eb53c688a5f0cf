#!/usr/bin/env python3
"""bench_lj.py's workload on the PyTorch + CUDA port, on one NVIDIA GPU:
steps/s of the reference's LJ melt (code/bench/in.lj, 32,000 atoms).

    python3 bench_lj_torch.py

The steps are bench_lj.py's: obmd_tpu_torch.scenes.lj_melt_scene(nx=20)
(fcc at rho* = 0.8442, T0 = 1.44, lj/cut 2.5, dt 0.005, NVE), setup, and
make_run(400) once to settle; then, as bench_torch.py times its windows
(bench_torch.production), the best of two timed 400-step windows (the host
clock around work that ends in torch.cuda.synchronize()), then
observe.check_invariants, which voids the number on any cell or layout
overflow or half-skin trip.  Prints one JSON line: metric (naming the
GPU), value in steps/s, unit, vs_baseline = value / 44.212 (the
reference's published one-core figure, as bench_lj.py) and
mparticle_steps_per_s.  It needs a GPU and raises without one; it defines
no benchmark cell.  chip_smoke.py's LJ melt phase drives the same
functions.
"""
import json

import bench_torch

# bench_lj.py's lattice (4 NX^3 atoms) and window
NX = 20
# the reference's published steps/s on one core (log.6Oct16.lj.fixed.icc.1)
REFERENCE_STEPS_S = 44.212


def scene(device="cuda"):
    """The LJ melt after setup: (cfg, state)."""
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.integrate import setup
    sc = scenes.lj_melt_scene(nx=NX, device=device)
    return sc.cfg, setup(sc.cfg, sc.state)


# bench_torch.py's settle and timed windows: (state, windows, probes)
production = bench_torch.production


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("bench_lj_torch.py needs a GPU: "
                           "torch.cuda.is_available() is False")
    from obmd_tpu_torch.observe import check_invariants

    cfg, state = scene()
    state, windows, _ = production(cfg, state)
    check_invariants(cfg, state)
    wall, steps = min(windows)
    natoms = int(state.natoms)
    steps_s = steps / wall
    print(json.dumps({
        "metric": "LJ melt steps/s (1 %s, %dk atoms, obmd_tpu_torch)"
                  % (torch.cuda.get_device_name(0), natoms // 1000),
        "value": round(steps_s, 2),
        "unit": "steps/s",
        "vs_baseline": round(steps_s / REFERENCE_STEPS_S, 3),
        "mparticle_steps_per_s": round(steps_s * natoms / 1e6, 3),
    }))


if __name__ == "__main__":
    main()
