"""A dry run of the multi-device steps: one step of each on tiny shapes.

    python -m obmd_tpu_torch.parallel.dryrun [--world N] [--backend nccl|gloo]
                                             [--device cuda|cpu]

The four paths of the JAX package's dry run (__graft_entry__.py:53-176):
  1. the slab step on OBMD_DPD (scale max(0.35, 0.05 N), the sweep engine's
     setup), once through the slab's cell grid and once through the pair
     kernel on the slab's padded layout;
  1b. MOLECULE mode on the slab: 40 harmonic dimers in an open max(16, 2N)
     x 4 x 4 box, `near` insertion of dimers with vz, one step (its forces
     set up on the nlist engine without the stage: JAX's nlist setup runs
     the ATOM-mode stage on this molecule scene, which no engine of the
     port runs);
  1c. SHAKE water on the slab, 30 waters in an open max(16, 3.5 N) x 4 x
     4 box, the cuts rebalanced every step (grow 1.5, balance_every 1);
  2. the atom decomposition on OBMD_DPD at scale 0.1 (n_max a multiple of
     N).
It prints the JAX dry run's line.  The default is NCCL on the card, one
rank a card; several ranks on one card take gloo (`--backend gloo`: every
collective goes through the host), the CPU takes `--backend gloo --device
cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .. import convert
from .comm import spawn


def mol_scenes(world: int):
    """Paths 1b and 1c's configurations and init_state arguments (x, v,
    types, bonds, mol), as __graft_entry__.py:76-158 builds them (one numpy
    generator, seed 5, drawn in that order)."""
    from ..config import (BondHarmonicParams, Capacity, DPDParams,
                          MolTemplate, ObmdParams, SceneConfig,
                          shake_table_from_templates)
    from ..geometry import Box, RegionBlock
    dimer = MolTemplate(dx=((-0.3, 0.0, 0.0), (0.3, 0.0, 0.0)),
                        types=(0, 0), q=(0.0, 0.0), bonds=((0, 1),))
    lx = max(16.0, 2.0 * world)
    box = Box((0.0, 0.0, 0.0), (lx, 4.0, 4.0), (False, True, True))
    b = 2.0
    r1 = RegionBlock((0.0, 0.0, 0.0), (b, 4.0, 4.0))
    r2 = RegionBlock((lx - b, 0.0, 0.0), (lx, 4.0, 4.0))
    obmd = ObmdParams(
        ntype=0, nfreq=1, seed=11, pxx=2.0, alpha=0.5, tau=0.01, nbuf=40.0,
        region1=r1, region2=r2, region5=r1, region6=r2, buffer_size=b,
        usher=None, near=0.4, mol=dimer, mol_len=2, insert_kmax=4,
        vz=(0.2, 0.2))
    mcfg = SceneConfig(
        box=box, masses=(1.0,), dt=0.004,
        pair=DPDParams.create(temp=0.4, cutoff=1.0, seed=9, a0=15.0,
                              gamma=2.0),
        bond=BondHarmonicParams(k=40.0, r0=0.6),
        capacity=Capacity(n_max=1024, cell_capacity=16),
        obmd=obmd, skin=0.3, force_path="nlist").finalize()
    r = np.random.default_rng(5)
    nm = 40
    cx = np.c_[r.uniform(0.6, lx - 0.6, nm), r.uniform(0.4, 3.6, (nm, 2))]
    xm = np.zeros((2 * nm, 3))
    xm[0::2] = cx - [0.3, 0.0, 0.0]
    xm[1::2] = cx + [0.3, 0.0, 0.0]
    bonds = np.stack([np.arange(1, 2 * nm, 2), np.arange(2, 2 * nm + 1, 2)],
                     axis=1)
    mol = dict(x=xm, v=r.normal(0, 0.4, (2 * nm, 3)), bonds=bonds,
               mol=np.repeat(np.arange(1, nm + 1), 2))
    water = MolTemplate(
        dx=((0.0, 0.2667, 0.0), (-0.6, -0.2333, 0.0), (0.6, -0.2333, 0.0)),
        types=(0, 1, 1), q=(0.0, 0.0, 0.0),
        bonds=((0, 1), (0, 2), (1, 2)))
    lxs = max(16.0, 3.5 * world)
    sbox = Box((0.0, 0.0, 0.0), (lxs, 4.0, 4.0), (False, True, True))
    scfg = SceneConfig(
        box=sbox, masses=(16.0, 1.0), dt=0.004,
        pair=DPDParams.create(temp=0.4, cutoff=1.0, seed=7, a0=10.0,
                              gamma=2.0, ntypes=2),
        capacity=Capacity(n_max=1024, cell_capacity=16),
        shake=shake_table_from_templates([water], 2),
        skin=0.3, force_path="nlist").finalize()
    nmw = 30
    cw = np.c_[r.uniform(1.0, lxs - 1.0, nmw), r.uniform(0.4, 3.6, (nmw, 2))]
    xw = (np.asarray(water.dx)[None, :, :] + cw[:, None, :]).reshape(
        3 * nmw, 3)
    wbonds = np.concatenate([np.asarray(water.bonds) + 3 * k + 1
                             for k in range(nmw)])
    water = dict(x=xw, v=r.normal(0, 0.2, (3 * nmw, 3)),
                 types=np.tile([0, 1, 1], nmw), bonds=wbonds,
                 mol=np.repeat(np.arange(1, nmw + 1), 3))
    return (mcfg, mol), (scfg, water)


def dry_rank(comm, slab_cfg, slab_arrays, atom_cfg, atom_arrays, mol_cfg,
              mol_arrays, mol_draws, water_cfg, water_arrays):
    from .atom_decomp import make_sharded_step, shard_state
    from .ranks import ReplayDraws
    from .slab_decomp import (make_slab_geom, make_slab_step, shard_by_slab,
                              with_balance_cuts)
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
    # path 1b: MOLECULE mode (bonds by tag over the halo, molecule
    # insertion and whole-molecule deletion over the ranks)
    state = convert.from_arrays(mol_arrays, seed=0, device=comm.device)
    geom = make_slab_geom(mol_cfg, comm.world)
    local = shard_by_slab(mol_cfg, geom, state, comm.rank)
    draw = ReplayDraws(mol_draws) if mol_draws is not None else None
    local = make_slab_step(mol_cfg, comm, geom, draw=draw)(local)
    n_mol = int(comm.sum(local.natoms))
    if n_mol <= 0:
        raise RuntimeError("molecule-mode slab step lost all atoms")
    # path 1c: SHAKE with the cuts rebalanced every step
    state = convert.from_arrays(water_arrays, seed=0, device=comm.device)
    geom = make_slab_geom(water_cfg, comm.world, grow=1.5)
    local = with_balance_cuts(geom, shard_by_slab(water_cfg, geom, state,
                                                  comm.rank))
    local = make_slab_step(water_cfg, comm, geom, balance_every=1)(local)
    n_water = int(comm.sum(local.natoms))
    if n_water != int(water_arrays["alive"].sum()):
        raise RuntimeError("SHAKE slab step lost atoms")
    state = convert.from_arrays(atom_arrays, seed=0, device=comm.device)
    local = shard_state(state, comm.world, comm.rank)
    local = make_sharded_step(atom_cfg, comm)(local)
    n_atom = int(comm.sum(local.natoms))
    if n_atom <= 0:
        raise RuntimeError("sharded step lost all atoms")
    return dict(slab=n_slab, mol=n_mol, water=n_water, atom=n_atom,
                step=local.step)


def dry_inputs(world: int, device: str, mol_draws=None) -> tuple:
    """The arguments of `dry_rank` after the world's ranks: each path's
    configuration and its set-up start (paths 1 and 2 set up on the sweep
    and nlist engines, 1b's forces without the stage, 1c's on the nlist
    engine) and 1b's draws (ranks.ReplayDraws entries, None for the
    state's generator)."""
    from .. import scenes
    from ..integrate import setup
    from ..state import init_state
    slab_scale = max(0.35, 0.05 * world)
    sc = scenes.obmd_dpd_scene(scale=slab_scale, seed=0, insert_kmax=4,
                               cell_capacity=28, force_path="sweep",
                               device=device)
    slab_state = convert.to_arrays(setup(sc.cfg, sc.state))
    n_max = ((1800 + world - 1) // world) * world
    sa = scenes.obmd_dpd_scene(scale=0.1, seed=0, n_max=n_max,
                               insert_kmax=4, cell_capacity=16,
                               force_path="nlist", device=device)
    (mcfg, mol), (wcfg, water) = mol_scenes(world)
    atom_state, mol_arrays, water_arrays = (
        {k: v for k, v in convert.to_arrays(setup(cfg, st)).items()
         if k not in ("nlist", "xref")}
        for cfg, st in ((sa.cfg, sa.state),
                        (dataclasses.replace(mcfg, obmd=None),
                         init_state(mcfg, device=device, **mol)),
                        (wcfg, init_state(wcfg, device=device, **water))))
    return (sc.cfg.finalize(), slab_state, sa.cfg.finalize(), atom_state,
            mcfg, mol_arrays, mol_draws, wcfg, water_arrays)


def dry_line(world: int, out: dict) -> str:
    """The JAX dry run's line from dry_rank's result."""
    return (f"dryrun_multichip({world}): ok, slab natoms={out['slab']}, "
            f"atom-decomp natoms={out['atom']}, step={out['step']}")


def dryrun_multichip(world: int, backend: str = "nccl",
                     device: str = "cuda", timeout_s: float = 600.0) -> str:
    """Each path on `world` ranks; returns (and prints) the JAX dry run's
    line."""
    from .. import _build
    from .comm import check_launch
    check_launch(world, backend, device)
    if torch.device(device).type == "cuda":
        # the ranks only load the built library: building it in each at
        # once would race
        _build.build_all([_build.KERNELS["pair"]])
    line = dry_line(world, spawn(dry_rank, world, backend, device,
                                 timeout_s, *dry_inputs(world, device))[0])
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
