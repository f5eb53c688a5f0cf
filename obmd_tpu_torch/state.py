"""Fixed-capacity, validity-masked SoA particle state.

Counterpart of `obmd_tpu/state.py` for scenes of 1-4 types, with per-atom
charges and at most two bonds per atom: dead slots have alive = False,
tag = -1 and v = 0; particle counts change by mask flips and masked writes
under fixed shapes.  Bonds are
stored per atom as partner SLOTS (`bond1`, `bond2`, -1 for none), remapped by
every relayout.  The JAX PRNG key becomes a `torch.Generator` (the cold
path's candidate draws); the step counter is a host int, so the pair-noise
salt is computed on the host.  The AdResS and molecule-insertion columns
(lambdaF, cms_mol, vcms_mol, rep_atom) and the branched topology's bond3,
bond4 and impr are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import SceneConfig
from .geometry import const_like


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks for
    the CPU.  Asking for the card on a machine without one raises — the
    port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev


@dataclasses.dataclass
class ObmdScalars:
    """Per-step OBMD stage products + running counters (0-dim tensors)."""

    momentum_force_left: torch.Tensor   # [3]
    momentum_force_right: torch.Tensor  # [3]
    shear_force_left: torch.Tensor      # [3]
    shear_force_right: torch.Tensor     # [3]
    ndeleted: torch.Tensor              # i32
    ninserted: torch.Tensor             # i32
    insert_fail: torch.Tensor           # i32
    usher_iters: torch.Tensor           # i32

    @staticmethod
    def zeros(device, dtype=torch.float32) -> "ObmdScalars":
        z3 = torch.zeros((3,), dtype=dtype, device=device)
        zi = torch.zeros((), dtype=torch.int32, device=device)
        return ObmdScalars(z3, z3, z3, z3, zi, zi, zi, zi)

    def replace(self, **kw) -> "ObmdScalars":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class State:
    """SoA particle store, capacity N = x.shape[0]."""

    x: torch.Tensor        # [N,3]
    v: torch.Tensor        # [N,3]
    f: torch.Tensor        # [N,3] forces of the previous evaluation
    type: torch.Tensor     # [N] i32
    tag: torch.Tensor      # [N] i32 global id, -1 for dead slots
    q: torch.Tensor        # [N] per-atom charge (0 on a neutral scene)
    alive: torch.Tensor    # [N] bool
    mol: torch.Tensor      # [N] i32 molecule id (0 = not in a molecule)
    bond1: torch.Tensor    # [N] i32 slot of the 1st bond partner (-1 = none)
    bond2: torch.Tensor    # [N] i32 slot of the 2nd bond partner (-1 = none)
    step: int
    sim_time: torch.Tensor  # 0-dim, advanced in the OBMD stage
    maxtag: torch.Tensor   # 0-dim i32
    gen: torch.Generator   # candidate draws
    obmd: ObmdScalars
    cell_overflow: torch.Tensor  # 0-dim i32
    nbrs: Optional[object] = None  # cellpad.PadAux once laid out

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def bond_partners(self) -> tuple:
        """The bond-partner slot columns, the iteration unit of every bonded
        pass."""
        return (self.bond1, self.bond2)

    @property
    def natoms(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


def make_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def bond_columns(n_max: int, tags, bonds) -> tuple:
    """The partner-slot columns of [nb, 2] 1-based tag pairs, filled in the
    reference's order (obmd_tpu/state.py:171-185): each bond (a, b) puts b
    in a's first free column, then a in b's."""
    cols = [np.full((n_max,), -1, dtype=np.int32) for _ in range(2)]
    if bonds is None:
        return tuple(cols)
    tag2row = {int(t): i for i, t in enumerate(tags)}
    for a, b in np.asarray(bonds, dtype=np.int64).reshape(-1, 2):
        for me, other in ((int(a), int(b)), (int(b), int(a))):
            row, orow = tag2row[me], tag2row[other]
            for col in cols:
                if col[row] < 0:
                    col[row] = orow
                    break
            else:
                raise NotImplementedError(
                    f"atom tag {me} has more than two bonds: the branched "
                    "topology's bond3/bond4 columns are not ported")
    return tuple(cols)


def init_state(cfg: SceneConfig, x, v=None, types=None, seed: int = 0,
               tags=None, q=None, mol=None, bonds=None,
               device="cuda") -> State:
    """Build a State from host arrays of n <= n_max real atoms; dead slots
    are parked at the box center with tag -1 and v = 0.  types: 0-based
    atom types; q: charges (0 when None); mol: molecule ids;
    bonds: [nb, 2] 1-based atom-tag pairs, at most two per atom, stored as
    partner slots."""
    cfg = cfg.finalize()
    if cfg.branched_topology:
        raise NotImplementedError("branched topologies are not ported")
    dev = resolve_device(device)
    npdt = np.dtype(cfg.dtype)
    tdt = getattr(torch, cfg.dtype)
    n_max = cfg.capacity.n_max
    x = np.asarray(x, dtype=npdt)
    n = x.shape[0]
    if n > n_max:
        raise ValueError(f"{n} atoms > capacity {n_max}")
    center = np.asarray([(l + h) * 0.5 for l, h in zip(cfg.box.lo, cfg.box.hi)],
                        dtype=npdt)
    xp = np.tile(center, (n_max, 1))
    xp[:n] = x
    vp = np.zeros((n_max, 3), dtype=npdt)
    if v is not None:
        vp[:n] = np.asarray(v, dtype=npdt)
    tp = np.zeros((n_max,), dtype=np.int32)
    if types is not None:
        tp[:n] = np.asarray(types, dtype=np.int32)
    qp = np.zeros((n_max,), dtype=npdt)
    if q is not None:
        qp[:n] = np.asarray(q, dtype=npdt)
    tagp = np.full((n_max,), -1, dtype=np.int32)
    tagp[:n] = (np.asarray(tags, dtype=np.int32) if tags is not None
                else np.arange(1, n + 1, dtype=np.int32))
    alive = np.zeros((n_max,), dtype=bool)
    alive[:n] = True
    molp = np.zeros((n_max,), dtype=np.int32)
    if mol is not None:
        molp[:n] = np.asarray(mol, dtype=np.int32)
    bond1, bond2 = bond_columns(n_max, tagp[:n], bonds)

    def t(a):
        return torch.from_numpy(a).to(dev)

    zi = torch.zeros((), dtype=torch.int32, device=dev)
    return State(
        x=t(xp), v=t(vp), f=torch.zeros((n_max, 3), dtype=tdt, device=dev),
        type=t(tp), tag=t(tagp), q=t(qp), alive=t(alive), mol=t(molp),
        bond1=t(bond1), bond2=t(bond2), step=0,
        sim_time=torch.zeros((), dtype=tdt, device=dev),
        maxtag=torch.tensor(int(tagp.max(initial=0)), dtype=torch.int32,
                            device=dev),
        gen=make_generator(seed, dev), obmd=ObmdScalars.zeros(dev, tdt),
        cell_overflow=zi)


def per_atom_mass(cfg: SceneConfig, state: State) -> torch.Tensor:
    if cfg.ntypes == 1:
        return torch.full((state.capacity,), float(cfg.masses[0]),
                          dtype=state.dtype, device=state.device)
    return const_like(cfg.masses, state.x)[state.type.long()]


def temperature(cfg: SceneConfig, state: State) -> torch.Tensor:
    """`compute temp`: T = sum(m v^2) / (3N - 3) (kB = 1)."""
    m = per_atom_mass(cfg, state)
    ke2 = torch.where(state.alive[:, None], m[:, None] * state.v ** 2,
                      0.0).sum()
    dof = torch.clamp(3 * state.natoms - 3, min=1).to(state.dtype)
    return ke2 / dof


def kinetic_energy(cfg: SceneConfig, state: State) -> torch.Tensor:
    m = per_atom_mass(cfg, state)
    return 0.5 * torch.where(state.alive[:, None], m[:, None] * state.v ** 2,
                             0.0).sum()


def momentum(cfg: SceneConfig, state: State) -> torch.Tensor:
    m = per_atom_mass(cfg, state)
    return torch.where(state.alive[:, None], m[:, None] * state.v,
                       0.0).sum(dim=0)
