#!/usr/bin/env python3
"""bench_chain.py's workload on the PyTorch + CUDA port, on one NVIDIA
GPU: steps/s of the reference's FENE bead-spring melt (code/bench/in.chain,
32,000 beads in 320 chains of 100).

    python3 bench_chain_torch.py [DATA_FILE]

bench_chain.py reads its start from the reference's bench/data.chain,
which this repository does not hold.  Without DATA_FILE the start is
obmd_tpu_torch.scenes.chain_scene()'s generated melt (the chains threaded
through the nx = 20 fcc lattice) after scenes.chain_warm_up, as
chip_smoke.py's chain melt path runs it; with DATA_FILE (an `atom_style
bond` file such as data.chain) that file's atoms, as bench_chain.py reads
them, with no warm-up.  Then setup at in.chain's settings (lj/cut 1.12
shifted with the 1-2 pairs excluded, fene 30/1.5/1/1, Langevin T = 1 damp
10, dt 0.012, filing cap 18), make_run(400) once to settle and, as
bench_torch.py times its windows (bench_torch.production), the best of
two timed 400-step windows (the host clock around work that ends in
torch.cuda.synchronize()), then observe.check_invariants, which voids
the number on any cell or layout overflow or half-skin trip.  Prints one
JSON line: metric (naming the GPU and the start), value in steps/s, unit,
vs_baseline = value / 102.286 (the reference's published one-core
figure, as bench_chain.py) and mparticle_steps_per_s.  It needs a GPU and
raises without one; it defines no benchmark cell.  chip_smoke.py's chain
melt phase drives the same functions.
"""
import json
import sys

import bench_torch

# the generated start's lattice (4 NX^3 beads)
NX = 20
# the reference's published steps/s on one core
# (log.6Oct16.chain.fixed.icc.1)
REFERENCE_STEPS_S = 102.286


def start(data_path=None, device="cuda"):
    """The melt before setup: (cfg, state) of data_path's file, or of the
    generated start after chain_warm_up (laid out in the warm-up's
    geometry; setup files it at the scene's own capacity)."""
    from obmd_tpu_torch import scenes
    sc = scenes.chain_scene(data_path=data_path, nx=NX, device=device)
    if data_path is not None:
        return sc.cfg, sc.state
    return sc.cfg, scenes.chain_warm_up(sc.cfg, sc.state)


# bench_torch.py's settle and timed windows: (state, windows, probes)
production = bench_torch.production


def main(data_path=None):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("bench_chain_torch.py needs a GPU: "
                           "torch.cuda.is_available() is False")
    from obmd_tpu_torch.integrate import setup
    from obmd_tpu_torch.observe import check_invariants

    cfg, state = start(data_path)
    state, windows, _ = production(cfg, setup(cfg, state))
    check_invariants(cfg, state)
    wall, steps = min(windows)
    natoms = int(state.natoms)
    steps_s = steps / wall
    print(json.dumps({
        "metric": "FENE chain steps/s (1 %s, %dk beads, %s, obmd_tpu_torch)"
                  % (torch.cuda.get_device_name(0), natoms // 1000,
                     "generated start" if data_path is None
                     else "start from " + data_path),
        "value": round(steps_s, 2),
        "unit": "steps/s",
        "vs_baseline": round(steps_s / REFERENCE_STEPS_S, 3),
        "mparticle_steps_per_s": round(steps_s * natoms / 1e6, 3),
    }))


if __name__ == "__main__":
    main(*sys.argv[1:2])
