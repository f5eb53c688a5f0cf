#!/usr/bin/env python3
"""bench.py's workload on the PyTorch + CUDA port, on one NVIDIA GPU:
Mparticle-steps/s of the ~107k-atom OBMD_DPD open-boundary run.

    python3 bench_torch.py

The steps are bench.py's: obmd_tpu_torch.scenes.obmd_dpd_scene(scale=9,
seed=7), setup, 1,500 steps of equilibrate, a repack to filing cap 15,
make_run(400) once to settle, the best of two timed 400-step windows (the
host clock around work that ends in torch.cuda.synchronize()), then
observe.check_invariants, which voids the number on any cell or layout
overflow or half-skin trip.  Prints one JSON line: metric (naming the
GPU), value, unit and vs_baseline = value / 50 (bench.py's north-star
target).  It needs a GPU and raises without one; it defines no benchmark
cell.  chip_smoke.py's OBMD_DPD phase drives the same functions.
"""
import dataclasses
import json
import time

# bench.py's scene, equilibration, production filing cap and windows
SCALE, SEED, EQUIL, PROD_CAP, NSTEPS = 9.0, 7, 1500, 15, 400


def equilibrated(device="cuda"):
    """The scene, setup and EQUIL steps of equilibrate: (cfg, state)."""
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.integrate import equilibrate, setup
    sc = scenes.obmd_dpd_scene(scale=SCALE, seed=SEED, device=device)
    return sc.cfg, equilibrate(sc.cfg, setup(sc.cfg, sc.state), EQUIL)


def repack(cfg, state, cap):
    """bench.py's repack: a fresh layout at another filing capacity.
    Returns (cfg, geometry, state)."""
    from obmd_tpu_torch.cellpad import layout_build
    from obmd_tpu_torch.engine_cellpad import make_geometry
    cfg = dataclasses.replace(cfg, capacity=dataclasses.replace(
        cfg.capacity, cell_capacity=cap)).finalize()
    geom = make_geometry(cfg)
    return cfg, geom, layout_build(geom, cfg.box, state)


def production(cfg, state, probe=None):
    """make_run(NSTEPS) once to settle, then two timed NSTEPS windows.
    probe(state), if given, is called after the settle and after each
    window, outside the timing.  Returns (state, [(seconds, steps)] of the
    windows, the probes' results).  bench_lj_torch.py and
    bench_chain_torch.py time their windows through it too."""
    import torch
    from obmd_tpu_torch.integrate import make_run
    run = make_run(cfg, NSTEPS)
    state = run(state)
    torch.cuda.synchronize()
    probes = [probe(state)] if probe else []
    windows = []
    for _ in range(2):
        s0 = state.step
        t0 = time.perf_counter()
        state = run(state)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0, state.step - s0))
        if probe:
            probes.append(probe(state))
    return state, windows, probes


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch.py needs a GPU: "
                           "torch.cuda.is_available() is False")
    from obmd_tpu_torch.observe import check_invariants

    cfg, state = equilibrated()
    cfg, _, state = repack(cfg, state, PROD_CAP)
    state, windows, _ = production(cfg, state)
    check_invariants(cfg, state)
    wall, steps = min(windows)
    natoms = int(state.natoms)
    mps = steps / wall * natoms / 1e6
    print(json.dumps({
        "metric": "OBMD_DPD Mparticle-steps/s (1 %s, %dk atoms, "
                  "obmd_tpu_torch)" % (torch.cuda.get_device_name(0),
                                       natoms // 1000),
        "value": round(mps, 3),
        "unit": "Mparticle-steps/s",
        "vs_baseline": round(mps / 50.0, 4),
    }))


if __name__ == "__main__":
    main()
