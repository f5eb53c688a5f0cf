"""Fixed-capacity, validity-masked SoA particle state.

Counterpart of `obmd_tpu/state.py` for scenes of 1-4 types, with per-atom
charges and at most four bonds per atom: dead slots have alive = False,
tag = -1 and v = 0; particle counts change by mask flips and masked writes
under fixed shapes.  Bonds are stored per atom as partner SLOTS (`bond1`,
`bond2`, and on a branched topology `bond3`, `bond4`; -1 for none), and an
improper per center atom as the slots of its three ends (`impr`, [N, 3]);
every relayout remaps them.  The molecule columns of molecule-mode
insertion and AdResS (lambdaF, cms_mol, vcms_mol, rep_atom) follow the
reference's layout; only molecule-mode insertion and `adress.update_mol_com`
write them here.  The JAX PRNG key becomes a `torch.Generator` (the cold
path's candidate draws); the step counter is a host int, so the pair-noise
salt is computed on the host.
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
    lambdaF: torch.Tensor  # [N] AdResS resolution parameter
    cms_mol: torch.Tensor  # [N,3] the molecule's center of mass
    vcms_mol: torch.Tensor  # [N,3] the molecule's center-of-mass velocity
    rep_atom: torch.Tensor  # [N] i32 representative-atom flag (template)
    bond1: torch.Tensor    # [N] i32 slot of the 1st bond partner (-1 = none)
    bond2: torch.Tensor    # [N] i32 slot of the 2nd bond partner (-1 = none)
    step: int
    sim_time: torch.Tensor  # 0-dim, advanced in the OBMD stage
    maxtag: torch.Tensor   # 0-dim i32
    gen: torch.Generator   # candidate draws
    obmd: ObmdScalars
    cell_overflow: torch.Tensor  # 0-dim i32
    # cellpad.PadAux once laid out, or on the nlist and sweep engines a
    # neighbors.NeighborState
    nbrs: Optional[object] = None
    bond3: Optional[torch.Tensor] = None  # [N] i32, branched topologies
    bond4: Optional[torch.Tensor] = None  # [N] i32, branched topologies
    impr: Optional[torch.Tensor] = None   # [N, 3] i32 slots of (i1, i3, i4)

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
        """The bond-partner slot columns (2 for chains, 4 for branched
        topologies), the iteration unit of every bonded pass."""
        more = tuple(c for c in (self.bond3, self.bond4) if c is not None)
        return (self.bond1, self.bond2) + more

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
    """The four partner-slot columns of [nb, 2] 1-based tag pairs, filled
    in the reference's order (obmd_tpu/state.py:171-185): each bond (a, b)
    puts b in a's first free column, then a in b's.  A fifth bond on an
    atom raises ValueError."""
    cols = [np.full((n_max,), -1, dtype=np.int32) for _ in range(4)]
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
                raise ValueError(
                    f"atom tag {me} has more than four bonds; the "
                    "per-atom partner-slot storage holds <= 4")
    return tuple(cols)


def improper_column(n_max: int, tags, impropers, cols) -> np.ndarray:
    """The [n_max, 3] impr column of [ni, 4] 1-based tag quadruples (i1,
    i2, i3, i4), i2 the center (a leading type column is dropped): the
    slots of (i1, i3, i4) on the center's row.  An end the center is not
    bonded to, or a second improper on one center, raises ValueError."""
    impr = np.full((n_max, 3), -1, dtype=np.int32)
    tag2row = {int(t): i for i, t in enumerate(tags)}
    for quad in np.asarray(impropers, dtype=np.int64):
        i1, i2, i3, i4 = (int(v) for v in quad[-4:])
        c = tag2row[i2]
        ends = [tag2row[i1], tag2row[i3], tag2row[i4]]
        bonded = {int(col[c]) for col in cols if col[c] >= 0}
        for e, t in zip(ends, (i1, i3, i4)):
            if e not in bonded:
                raise ValueError(
                    f"improper ({i1},{i2},{i3},{i4}): center {i2} is not "
                    f"bonded to {t} — only the out-of-plane convention "
                    "(center bonded to all three ends) is stored per-center")
        if impr[c, 0] >= 0:
            raise ValueError(f"atom tag {i2} is the center of two impropers; "
                             "the per-center storage holds one")
        impr[c] = ends
    return impr


def init_state(cfg: SceneConfig, x, v=None, types=None, seed: int = 0,
               tags=None, q=None, mol=None, bonds=None, lambdaF=None,
               rep_atom=None, impropers=None, device="cuda") -> State:
    """Build a State from host arrays of n <= n_max real atoms; dead slots
    are parked at the box center with tag -1 and v = 0.  types: 0-based
    atom types; q: charges (0 when None); mol: molecule ids; bonds: [nb,
    2] 1-based atom-tag pairs, at most four per atom, stored as partner
    slots (bond3 and bond4 exist when some atom has more than two partners
    or cfg.branched_topology is set, so chain scenes keep two columns);
    impropers: [ni, 4] 1-based tag quadruples (i1, i2, i3, i4) in
    improper_harmonic.cpp's order, i2 the center, bonded to the three
    others, stored per center in impr (which exists with
    cfg.improper on a branched topology, or when impropers are given);
    lambdaF and rep_atom: per-atom values (0 when None; cms_mol and
    vcms_mol start at 0)."""
    cfg = cfg.finalize()
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
    lamp = np.zeros((n_max,), dtype=npdt)
    if lambdaF is not None:
        lamp[:n] = np.asarray(lambdaF, dtype=npdt)
    repp = np.zeros((n_max,), dtype=np.int32)
    if rep_atom is not None:
        repp[:n] = np.asarray(rep_atom, dtype=np.int32)
    cols = bond_columns(n_max, tagp[:n], bonds)
    branched = bool((cols[2] >= 0).any()) or cfg.branched_topology
    has_impr = impropers is not None and len(impropers) > 0
    if has_impr and not branched:
        raise ValueError("impropers require the center to carry >= 3 bonds")
    imprp = None
    if has_impr or (cfg.improper is not None and cfg.branched_topology):
        imprp = improper_column(n_max, tagp[:n],
                                impropers if has_impr else [], cols)

    def t(a):
        return torch.from_numpy(a).to(dev)

    zi = torch.zeros((), dtype=torch.int32, device=dev)
    return State(
        x=t(xp), v=t(vp), f=torch.zeros((n_max, 3), dtype=tdt, device=dev),
        type=t(tp), tag=t(tagp), q=t(qp), alive=t(alive), mol=t(molp),
        lambdaF=t(lamp), cms_mol=torch.zeros_like(t(vp)),
        vcms_mol=torch.zeros_like(t(vp)), rep_atom=t(repp),
        bond1=t(cols[0]), bond2=t(cols[1]), step=0,
        sim_time=torch.zeros((), dtype=tdt, device=dev),
        maxtag=torch.tensor(int(tagp.max(initial=0)), dtype=torch.int32,
                            device=dev),
        gen=make_generator(seed, dev), obmd=ObmdScalars.zeros(dev, tdt),
        cell_overflow=zi,
        bond3=t(cols[2]) if branched else None,
        bond4=t(cols[3]) if branched else None,
        impr=t(imprp) if imprp is not None else None)


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
