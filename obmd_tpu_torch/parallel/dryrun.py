"""A dry run of the multi-device steps: one step of each on tiny shapes.

    python -m obmd_tpu_torch.parallel.dryrun [--world N] [--backend nccl|gloo]
                                             [--device cuda|cpu]

Paths 1 and 2 of the JAX package's dry run (__graft_entry__.py:53-74,
:160-176): the slab step on OBMD_DPD (scale max(0.35, 0.05 N), the sweep
engine's setup), once through the slab's cell grid and once through the
pair kernel on the slab's padded layout; then the atom decomposition on
OBMD_DPD at scale 0.1 (n_max a multiple of N).  It prints the JAX dry
run's line.  The default is NCCL on the card, one rank a card; several
ranks on one card take gloo (`--backend gloo`: every collective goes
through the host), the CPU takes `--backend gloo --device cpu`.
"""
from __future__ import annotations

import argparse

import torch

from .. import convert
from .comm import spawn


def _dry_rank(comm, slab_cfg, slab_arrays, atom_cfg, atom_arrays):
    from .atom_decomp import make_sharded_step, shard_state
    from .slab_decomp import make_slab_geom, make_slab_step, shard_by_slab
    state = convert.from_arrays(slab_arrays, seed=0, device=comm.device)
    geom = make_slab_geom(slab_cfg, comm.world)
    local = shard_by_slab(slab_cfg, geom, state, comm.rank)
    local = make_slab_step(slab_cfg, comm, geom)(local)
    n_slab = int(comm.sum(local.natoms))
    if n_slab <= 0:
        raise RuntimeError("slab step lost all atoms")
    local = make_slab_step(slab_cfg, comm, geom, force_impl="kernel")(local)
    if int(comm.sum(local.natoms)) <= 0:
        raise RuntimeError("kernel slab step lost all atoms")
    state = convert.from_arrays(atom_arrays, seed=0, device=comm.device)
    local = shard_state(state, comm.world, comm.rank)
    local = make_sharded_step(atom_cfg, comm)(local)
    n_atom = int(comm.sum(local.natoms))
    if n_atom <= 0:
        raise RuntimeError("sharded step lost all atoms")
    return n_slab, n_atom, local.step


def dryrun_multichip(world: int, backend: str = "nccl",
                     device: str = "cuda", timeout_s: float = 600.0) -> str:
    """One slab step through each force path and one atom-decomposition
    step on `world` ranks; returns (and prints) the JAX dry run's line."""
    from .. import _build, scenes
    from ..integrate import setup
    from .comm import check_launch
    check_launch(world, backend, device)
    if torch.device(device).type == "cuda":
        # the ranks only load the built library: building it in each at
        # once would race
        _build.build_all([_build.KERNELS["pair"]])
    slab_scale = max(0.35, 0.05 * world)
    sc = scenes.obmd_dpd_scene(scale=slab_scale, seed=0, insert_kmax=4,
                               cell_capacity=28, force_path="sweep",
                               device=device)
    slab_state = convert.to_arrays(setup(sc.cfg, sc.state))
    n_max = ((1800 + world - 1) // world) * world
    sa = scenes.obmd_dpd_scene(scale=0.1, seed=0, n_max=n_max,
                               insert_kmax=4, cell_capacity=16,
                               force_path="nlist", device=device)
    atom_state = convert.to_arrays(setup(sa.cfg, sa.state))
    atom_state = {k: v for k, v in atom_state.items()
                  if k not in ("nlist", "xref")}
    out = spawn(_dry_rank, world, backend, device, timeout_s,
                sc.cfg.finalize(), slab_state, sa.cfg.finalize(), atom_state)
    n_slab, n_atom, step = out[0]
    line = (f"dryrun_multichip({world}): ok, slab natoms={n_slab}, "
            f"atom-decomp natoms={n_atom}, step={step}")
    print(line)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    dryrun_multichip(a.world, a.backend, a.device, a.timeout)


if __name__ == "__main__":
    main()
