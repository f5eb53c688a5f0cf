"""The ported scenes: OBMD_DPD (examples/OBMD_DPD/input.py:17-124), the LJ
melt (the reference's code/bench/in.lj), the open-boundary LJ fluid, the
open-boundary charged two-type LJ fluid, the FENE chain melt
(code/bench/in.chain) and a dpd/tstat heating ramp.

Counterpart of `obmd_tpu/scenes.py` `obmd_dpd_config`, `obmd_dpd_scene`,
`lj_melt_scene` and `chain_scene`.  OBMD_DPD: DPD fluid at rho = 3, T = 1
with open x boundaries, constant normal load pxx on both buffers and USHER
insertion; `scale` stretches the box in x (scale 9 is the ~107k-atom bench
size).  LJ melt: an fcc lattice in a fully periodic box, NVE.  Initial states are drawn
with the same numpy generators as the reference, so both packages start from
the same positions and velocities.  The open LJ fluid (`obmd_lj_config`,
`obmd_lj_scene`) assembles configuration objects both packages have: the
LJ melt's law and lattice in OBMD_DPD's open-x buffer layout under a
Langevin thermostat; the charged fluid (`obmd_ljrf_config`,
`obmd_ljrf_scene`) puts lj/cut/rf ions into that solvent.  The chain melt reads a data file as the JAX scene
does, or builds its start in the repository: chains threaded through the
LJ melt's fcc lattice (`chain_lattice`), warmed up by `chain_warm_up`.
The dpd/tstat ramp (`dpd_tstat_config`, `dpd_tstat_scene`) is the JAX
package's own ramp test (tests/test_dpd_variants.py:212-253) in a 100k-atom
box; `closed_dpd_scene` is the JAX package's closed periodic DPD box
(Milestone A).  The `near` box (`near_box_config`, `near_box_scene`) is
the JAX package's momentum-conservation box (tests/test_conservation.py:34-55):
`near` insertion on a 7 x 1 x 1 cell grid, single-cell periodic y and z.
The DPD film (`dpd_film_config`, `dpd_film_scene`) is a thin slab of the
OBMD_DPD fluid whose z axis is one cell, and with `y_open` whose y axis is
open.  Path G (`obmd_dpdext_config`, `obmd_dpdext_scene`) is the
OBMD_DPD deck under dpd/ext on the nlist engine.  Path H
(`obmd_dpd_keywords_config`, `obmd_dpd_keywords_scene`) is the OBMD_DPD
deck with the fix's `maxattempt 4`, `nfreq 2`, `vx`/`vy`/`vz` and `id
max`.  The star-polymer melt
(`star_melt_config`, `star_melt_scene`) is a
closed melt of the JAX package's 4-arm star (tests/test_branched.py:27-33)
in a DPD solvent-free box at rho 3, read through an `atom_style molecular`
data file (`write_star_data`) and warmed up by `star_warm_up`.  Path F
(`open_star_config`, `open_star_scene`) is that melt in an open box under
shear, with molecule-mode insertion; path I (`open_water_config`,
`open_water_scene`, `closed_water_scene` for its state point,
`water_warm_up`) is BASELINE config 5's open SPC/E water under SHAKE;
path K (`open_water_config(rigid=True)`, `open_water_scene(rigid=True)`,
`rigid_water_start` from path I's warmed state) the same water as rigid
bodies on the tree template.  `rigid_golden_scene` is
validation/rigid_golden's box of rigid trimers.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from .config import (AngleHarmonicParams, BondFENEParams, BondHarmonicParams,
                     Capacity, DPDExtParams, DPDParams, DPDTstatParams,
                     ImproperHarmonicParams, LangevinParams, LJCutParams,
                     LJCutRFParams, ObmdParams, SceneConfig, UsherParams,
                     derive_center_angle_table, derive_center_improper_table,
                     shake_table_from_templates)
from .geometry import Box, RegionBlock
from .state import State, init_state


@dataclasses.dataclass
class Scene:
    cfg: SceneConfig
    state: State


def obmd_dpd_config(scale: float = 1.0, n_max: Optional[int] = None,
                    nbuf: Optional[float] = None, usher: bool = True,
                    dtype: str = "float32",
                    cell_capacity: int = 24,
                    insert_kmax: int = 16,
                    skin: float = 0.39,
                    force_path: str = "cellpad") -> SceneConfig:
    """The OBMD_DPD deck (input.py values), box stretched `scale`x in x."""
    xhi = 33.594 * scale
    yhi = zhi = 11.198
    rho = 3.0
    buffer_size = 0.15 * 33.594 * scale
    n_expected = int(rho * xhi * yhi * zhi)
    if n_max is None:
        n_max = int(n_expected * 1.25)
    if nbuf is None:
        nbuf = 1327.0 * scale

    box = Box((0.0, 0.0, 0.0), (xhi, yhi, zhi), (False, True, True))
    r1 = RegionBlock((0.0, 0.0, 0.0), (buffer_size, yhi, zhi))
    r2 = RegionBlock((xhi - buffer_size, 0.0, 0.0), (xhi, yhi, zhi))
    degenerate = RegionBlock((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    r5 = RegionBlock((0.0, 0.0, 0.0), (buffer_size, yhi, zhi))
    r6 = RegionBlock((xhi - buffer_size, 0.0, 0.0), (xhi, yhi, zhi))

    pair = DPDParams.create(temp=1.0, cutoff=1.0, seed=2349852,
                            a0=209.6, gamma=4.5, ntypes=1)
    obmd = ObmdParams(
        ntype=0, nfreq=1, seed=872634,
        pxx=188.0, pxy=0.0, pxz=0.0, dpxx=0.0, freq=0.0,
        alpha=0.7, tau=0.005, nbuf=float(nbuf),
        region1=r1, region2=r2, region3=degenerate, region4=degenerate,
        region5=r5, region6=r6,
        buffer_size=buffer_size, g_fac=0.25,
        maxattempt=1,
        usher=UsherParams(etarget=31.03, ds0=1.0, dtheta0=0.02, uovlp=1e4,
                          dsovlp=1.5, eps=1.0, nattempt=40) if usher else None,
        near=None if usher else 0.35,
        insert_kmax=insert_kmax,
    )
    return SceneConfig(
        box=box, masses=(1.0,), pair=pair, dt=0.001464,
        # max_neighbors: rho 3 within cut + skin = 1.39 averages ~34
        # neighbours; 72 clears the tail (obmd_tpu/scenes.py:76-79)
        capacity=Capacity(n_max=n_max, cell_capacity=cell_capacity,
                          max_neighbors=72),
        obmd=obmd, dtype=dtype, force_path=force_path, skin=skin,
    ).finalize()


# path G's dpd/ext coefficients beyond the deck's a0, gamma, cut, T and
# seed: the only gammaT, ws and wsT the repository holds against the
# reference binary (validation/dpdext_golden/in.dpdext)
DPDEXT_GAMMA_T, DPDEXT_WS, DPDEXT_WS_T = 2.5, 0.8, 1.3


def dpdext_pair(pair: DPDParams) -> DPDExtParams:
    """dpd/ext with a DPD law's T, cut, seed, a0 and gamma and the
    golden's transverse coefficients."""
    return DPDExtParams.create(
        temp=pair.temp, cutoff=pair.cutoff, seed=pair.seed,
        a0=pair.a0[0][0], gamma=pair.gamma[0][0], gammaT=DPDEXT_GAMMA_T,
        ws=DPDEXT_WS, wsT=DPDEXT_WS_T)


def obmd_dpdext_config(scale: float = 9.0, force_path: str = "nlist",
                       **kwargs) -> SceneConfig:
    """Path G: the OBMD_DPD deck (obmd_dpd_config, scale 9 by default:
    302.346 x 11.198 x 11.198, ~113,700 atoms) under `pair_style dpd/ext`
    on the nlist engine.  The conservative term is the deck's, so USHER's
    etarget and the load pxx stay valid."""
    cfg = obmd_dpd_config(scale=scale, force_path=force_path, **kwargs)
    return dataclasses.replace(cfg, pair=dpdext_pair(cfg.pair)).finalize()


def obmd_dpdext_scene(scale: float = 9.0, seed: int = 12345,
                      temp: float = 1.0, device="cuda", **kwargs) -> Scene:
    """obmd_dpdext_config with obmd_dpd_scene's uniform gas at rho = 3."""
    sc = obmd_dpd_scene(scale=scale, seed=seed, temp=temp, device=device,
                        **kwargs)
    return Scene(cfg=dataclasses.replace(sc.cfg, pair=dpdext_pair(
        sc.cfg.pair)).finalize(), state=sc.state)


# path H's inserted-velocity range: a uniform draw on [-V, V] has variance
# V^2 / 3 = 1, the fluid's T = 1 per component at mass 1
PATH_H_V = 1.732


def obmd_dpd_keywords_config(scale: float = 9.0, maxattempt: int = 4,
                             nfreq: int = 2, **kwargs) -> SceneConfig:
    """Path H: the OBMD_DPD deck (obmd_dpd_config, scale 9 by default:
    302.346 x 11.198 x 11.198, ~106k atoms once equilibrated) with the
    fix's keywords `maxattempt 4` (four candidate rounds per stage call,
    each round's accepted candidates seen by the next), `nfreq 2` (the
    stage every second step), `vx`, `vy` and `vz -1.732 1.732` (inserted
    atoms drawn at the fluid's T = 1 rather than at rest, their momentum
    in the setpoints' tally) and `id max` (tags from the largest alive
    tag, recomputed every stage call); USHER, pxx 188, the regions and K
    are the deck's."""
    cfg = obmd_dpd_config(scale=scale, **kwargs)
    v = (-PATH_H_V, PATH_H_V)
    return dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, maxattempt=maxattempt, nfreq=nfreq, vx=v, vy=v, vz=v,
        id_policy="max")).finalize()


def obmd_dpd_keywords_scene(scale: float = 9.0, seed: int = 12345,
                            temp: float = 1.0, device="cuda",
                            **kwargs) -> Scene:
    """obmd_dpd_keywords_config with obmd_dpd_scene's uniform gas."""
    sc = obmd_dpd_scene(scale=scale, seed=seed, temp=temp, device=device)
    return Scene(cfg=obmd_dpd_keywords_config(scale=scale, **kwargs),
                 state=sc.state)


def obmd_dpd_scene(scale: float = 1.0, seed: int = 12345,
                   temp: float = 1.0, device="cuda", **kwargs) -> Scene:
    """Config + a uniform gas at rho = 3 with Maxwell-Boltzmann velocities
    at `temp`, on `device`."""
    cfg = obmd_dpd_config(scale=scale, **kwargs)
    rng = np.random.default_rng(seed)
    lo = np.asarray(cfg.box.lo)
    hi = np.asarray(cfg.box.hi)
    n = int(3.0 * cfg.box.volume)
    x = rng.uniform(lo, hi, (n, 3))
    v = rng.normal(0.0, np.sqrt(temp), (n, 3))
    v -= v.mean(axis=0)
    state = init_state(cfg, x, v=v, seed=seed, device=device)
    return Scene(cfg=cfg, state=state)


def fcc_lattice(cells, a: float, offset=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Positions of an fcc lattice of cells[0] x cells[1] x cells[2] unit
    cells of edge a, shifted by `offset`."""
    basis = np.asarray([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                        [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(*(np.arange(n) for n in cells),
                                indexing="ij"), axis=-1).reshape(-1, 1, 3)
    return ((grid + basis[None, :, :]) * a).reshape(-1, 3) + np.asarray(offset)


def lj_melt_scene(nx: int = 20, dtype: str = "float32",
                  force_path: str = "cellpad", skin: float = 0.55,
                  cell_capacity: int = 36, rebuild_every: int = 0,
                  device="cuda") -> Scene:
    """The LJ melt (code/bench/in.lj): fcc lattice at rho* = 0.8442,
    4 nx^3 atoms (nx = 20 -> 32,000), T0 = 1.44, lj/cut rc = 2.5,
    dt = 0.005, NVE, fully periodic, on `device`.  Skin 0.55 keeps the
    reference's cell grid (cells are floor(L / (rc + skin)) wide either
    way) with twice its half-skin drift budget."""
    rho = 0.8442
    a = (4.0 / rho) ** (1.0 / 3.0)          # fcc lattice constant
    L = nx * a
    box = Box((0.0, 0.0, 0.0), (L, L, L), (True, True, True))
    x = fcc_lattice((nx, nx, nx), a)
    n = len(x)
    rng = np.random.default_rng(87287)
    v = rng.normal(0.0, np.sqrt(1.44), (n, 3))
    v -= v.mean(axis=0)
    pair = LJCutParams.create(cutoff=2.5, epsilon=1.0, sigma=1.0)
    cfg = SceneConfig(box=box, masses=(1.0,), pair=pair, dt=0.005,
                      capacity=Capacity(n_max=n,
                                        cell_capacity=cell_capacity),
                      obmd=None, skin=skin, dtype=dtype,
                      rebuild_every=rebuild_every,
                      force_path=force_path)
    return Scene(cfg=cfg, state=init_state(cfg, x, v=v, device=device))


# The open LJ fluid's state point: rho* = 0.8442 (in.lj), T* = 0.722.
# OBMD_LJ_ETARGET is E_pair/N and OBMD_LJ_PXX the mean pressure of the bulk
# liquid there, read once with lj_state_point.py (at the root of the
# repository) on an NVIDIA H100 80GB HBM3 at 700 W: a periodic
# lj_melt_scene(nx=20) melted at T = 1.44 and run under this scene's
# Langevin thermostat, thermo over its last 400 of 4,000 steps: T 0.7277,
# E_pair/N -5.6354, pressure 0.9273.  E_pair/N, not twice it, is the
# OBMD_DPD deck's own convention: its etarget 31.03 and pxx 188 sit at
# E_pair/N 31.49 and pressure 188.16 of its bulk fluid (the same reading);
# at 2 E_pair/N the steered search accepted none of 256 bulk candidates.
OBMD_LJ_RHO, OBMD_LJ_TEMP = 0.8442, 0.722
OBMD_LJ_ETARGET = -5.6354
OBMD_LJ_PXX = 0.9273


def obmd_lj_config(nx: int = 128, ny: int = 14,
                   nbuf: Optional[float] = None) -> SceneConfig:
    """The open-boundary LJ fluid (BASELINE.json config 2: USHER insertion
    and deletion at a fixed normal load, Delgado-Buscalioni and Coveney,
    J. Chem. Phys. 119, 978 (2003)): in.lj's lj/cut law (eps = sigma = 1,
    rc = 2.5, no shift) and dt = 0.005 at rho* = 0.8442 in a box of
    nx x ny x ny fcc cells (128 x 14 x 14: 100,352 atoms, 215.0 x 23.51 x
    23.51), x open, y and z periodic; USHER's target energy and the normal
    load at the bulk liquid's E_pair/N = -5.6354 and pressure 0.9273
    (OBMD_LJ_ETARGET, OBMD_LJ_PXX: the reading above); OBMD_DPD's regions
    (buffers of 0.15 Lx at each end, insertion regions = buffers,
    degenerate shear regions, g_fac 0.25); the stage at ntype 0, nfreq 1,
    maxattempt 1, K = 16, alpha 0.7, the deck's dt/tau (tau = dt / 0.2928)
    and, unless `nbuf` is given, its nbuf rule alpha * rho * V_buf; the
    fix's default USHER steps; Langevin at T* = 0.722, damp 1.  Skin 0.4
    gives 2.94-wide y/z cells (8 per
    axis: 64 cells in 128 lanes, p = 2, OBMD_DPD's layout).  Filing
    capacity 44: a buffer subset holds at most 0.45 n + 256 of its slot
    slice's n slots (engine_cellpad._subset_slice, as the reference), and
    at this density that needs cap >= 41; the most atoms in one cell stays
    far below."""
    pair = LJCutParams.create(cutoff=2.5, epsilon=1.0, sigma=1.0)
    return _open_lj_config(nx, ny, nbuf, pair, (1.0,), OBMD_LJ_ETARGET,
                           OBMD_LJ_PXX)


def _open_lj_config(nx: int, ny: int, nbuf: Optional[float], pair, masses,
                    etarget: float, pxx: float) -> SceneConfig:
    """The open LJ fluid's box, regions, stage, thermostat and layout
    (obmd_lj_config) with a given pair law, masses, USHER target and
    normal load."""
    rho = OBMD_LJ_RHO
    a = (4.0 / rho) ** (1.0 / 3.0)          # fcc lattice constant
    xhi = nx * a
    yhi = zhi = ny * a
    buffer_size = 0.15 * xhi
    alpha = 0.7
    if nbuf is None:
        nbuf = alpha * rho * buffer_size * yhi * zhi
    dt = 0.005
    box = Box((0.0, 0.0, 0.0), (xhi, yhi, zhi), (False, True, True))
    r1 = RegionBlock((0.0, 0.0, 0.0), (buffer_size, yhi, zhi))
    r2 = RegionBlock((xhi - buffer_size, 0.0, 0.0), (xhi, yhi, zhi))
    degenerate = RegionBlock((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    obmd = ObmdParams(
        ntype=0, nfreq=1, seed=872634,
        pxx=pxx, pxy=0.0, pxz=0.0, dpxx=0.0, freq=0.0,
        alpha=alpha, tau=dt * (0.005 / 0.001464), nbuf=float(nbuf),
        region1=r1, region2=r2, region3=degenerate, region4=degenerate,
        region5=r1, region6=r2,
        buffer_size=buffer_size, g_fac=0.25, maxattempt=1,
        usher=UsherParams(etarget=etarget), insert_kmax=16)
    return SceneConfig(
        box=box, masses=tuple(masses), pair=pair, dt=dt,
        capacity=Capacity(n_max=4 * nx * ny * ny, cell_capacity=44),
        obmd=obmd, langevin=LangevinParams(temp=OBMD_LJ_TEMP, damp=1.0),
        skin=0.4, force_path="cellpad").finalize()


def obmd_lj_scene(nx: int = 128, ny: int = 14, nbuf: Optional[float] = None,
                  device="cuda") -> Scene:
    """Config + in.lj's start on `device`: the fcc lattice shifted by a/4
    in x (no atom on an open face) and a/8 in y and z, with normal
    velocities at T0 = 1.44, zero net momentum; the lattice melts under
    `integrate.equilibrate(..., temp=1.44)`.  The y/z shift keeps lattice
    planes off the cell faces: a 2.94-wide cell is 3.5 half-spacings, so
    unshifted planes lie on every other face, and the first relayout would
    move more atoms than its mover budget (cellpad.relayout_incremental's
    m_max, as the reference's)."""
    cfg = obmd_lj_config(nx=nx, ny=ny, nbuf=nbuf)
    x, v = _open_lj_start(nx, ny)
    return Scene(cfg=cfg, state=init_state(cfg, x, v=v, device=device))


def _open_lj_start(nx: int, ny: int):
    """obmd_lj_scene's start: the shifted fcc lattice and normal
    velocities at T0 = 1.44 with zero net momentum."""
    a = (4.0 / OBMD_LJ_RHO) ** (1.0 / 3.0)
    x = fcc_lattice((nx, ny, ny), a, offset=(0.25 * a, 0.125 * a, 0.125 * a))
    rng = np.random.default_rng(87287)
    v = rng.normal(0.0, np.sqrt(1.44), x.shape)
    v -= v.mean(axis=0)
    return x, v


# The open charged two-type LJ fluid (obmd_ljrf_config): the JAX package's
# two-type charged lj/cut/rf law (tests/test_cellpad_multitype.py:76-80),
# eps_rf 80 (validation/ljrf_golden/in.ljrf), ions at q = +-0.5.
# OBMD_LJRF_ETARGET is the mean per-atom pair energy of the neutral type-0
# solvent and OBMD_LJRF_PXX the pressure (reaction-field virial included)
# of the bulk fluid at rho* = 0.8442 and T* = 0.722, read with
# `lj_state_point.py ljrf` on an NVIDIA H100 80GB HBM3 at 700 W: the
# periodic ljrf_bulk_scene(nx=20), 32,000 atoms of this composition, melted
# at T = 1.44 and run under this scene's Langevin thermostat, thermo over
# its last 400 of 4,000 steps: T 0.7232, type-0 pair energy per atom
# -5.4640 (E_pair/N of all atoms -5.2861), pressure 0.6612.
LJRF_EPSILON = ((1.0, 0.8), (0.8, 0.6))
LJRF_SIGMA = ((1.0, 0.95), (0.95, 0.9))
LJRF_MASSES = (1.0, 1.5)
LJRF_EPS_RF, LJRF_Q, LJRF_ION_FRACTION = 80.0, 0.5, 0.1
OBMD_LJRF_ETARGET = -5.4640
OBMD_LJRF_PXX = 0.6612


def ljrf_pair() -> LJCutRFParams:
    """The charged fluid's law: lj/cut/rf 2.5 2.5, two types."""
    return LJCutRFParams.create(cut_lj=2.5, cut_coul=2.5, ntypes=2,
                                epsilon=LJRF_EPSILON, sigma=LJRF_SIGMA,
                                eps_rf=LJRF_EPS_RF)


def ion_sites(n: int):
    """(types [n], q [n]) of n lattice sites: an even number of ions,
    about LJRF_ION_FRACTION of the sites, spread evenly over the site
    order, type 1 with q = +0.5 and -0.5 in turn (net charge 0); the rest
    neutral type-0 solvent."""
    n_ion = 2 * int(round(0.5 * LJRF_ION_FRACTION * n))
    sites = (np.arange(n_ion) * n) // n_ion
    types = np.zeros(n, np.int32)
    q = np.zeros(n)
    types[sites] = 1
    q[sites] = LJRF_Q * np.where(np.arange(n_ion) % 2 == 0, 1.0, -1.0)
    return types, q


def obmd_ljrf_config(nx: int = 128, ny: int = 14,
                     nbuf: Optional[float] = None) -> SceneConfig:
    """The open-boundary charged two-type LJ fluid: obmd_lj_config's box
    (128 x 14 x 14 fcc cells, 215.0 x 23.51 x 23.51, x open, y and z
    periodic), regions, stage (ATOM-mode USHER inserting neutral type-0
    solvent, maxattempt 1, nfreq 1, K = 16), Langevin at T* = 0.722, damp 1,
    dt 0.005, skin 0.4 and filing cap 44, with the two-type lj/cut/rf law
    (ljrf_pair: eps 1.0 / 0.8 / 0.6, sigma 1.0 / 0.95 / 0.9, rc_lj =
    rc_coul = 2.5, eps_rf 80), masses 1.0 and 1.5, USHER's target and the
    normal load at this fluid's own bulk values (OBMD_LJRF_ETARGET,
    OBMD_LJRF_PXX).  max_cut stays 2.5, so the grid is the open LJ fluid's
    (74 x 8 x 8, p = 2, 208,384 slots).

    It carries the electrostatics of BASELINE.json config 5 (open-boundary
    water under reaction field, Papez and Praprotnik, JCTC 2022) in an LJ
    solvent with dissolved ions, under ATOM-mode insertion; config 5
    itself, SPC/E water with SHAKE and MOL-mode insertion, is path I
    (open_water_config, open_water_scene)."""
    return _open_lj_config(nx, ny, nbuf, ljrf_pair(), LJRF_MASSES,
                           OBMD_LJRF_ETARGET, OBMD_LJRF_PXX)


def obmd_ljrf_scene(nx: int = 128, ny: int = 14,
                    nbuf: Optional[float] = None, device="cuda") -> Scene:
    """Config + obmd_lj_scene's start on `device` with ion_sites' types
    and charges (10,036 ions at full size, net charge 0); the lattice
    melts under `integrate.equilibrate(..., temp=1.44)`.  Ions deleted at
    the open faces are not replaced: insertion is neutral solvent."""
    cfg = obmd_ljrf_config(nx=nx, ny=ny, nbuf=nbuf)
    x, v = _open_lj_start(nx, ny)
    types, q = ion_sites(len(x))
    return Scene(cfg=cfg, state=init_state(cfg, x, v=v, types=types, q=q,
                                           device=device))


def ljrf_bulk_scene(nx: int = 20, device="cuda") -> Scene:
    """The charged fluid's bulk: lj_melt_scene(nx)'s periodic box and
    lattice (rho* = 0.8442, T0 = 1.44, cap 36) with ion_sites' composition,
    the two-type lj/cut/rf law and masses, under the open fluid's Langevin
    thermostat (T* = 0.722, damp 1): the state point lj_state_point.py
    reads."""
    sc = lj_melt_scene(nx=nx, device="cpu")
    cfg = dataclasses.replace(
        sc.cfg, pair=ljrf_pair(), masses=LJRF_MASSES,
        langevin=LangevinParams(temp=OBMD_LJ_TEMP, damp=1.0))
    x, v = sc.state.x.numpy(), sc.state.v.numpy()
    types, q = ion_sites(len(x))
    return Scene(cfg=cfg, state=init_state(cfg, x, v=v, types=types, q=q,
                                           device=device))


# the chain melt (code/bench/in.chain): rho* = 0.8442 on the LJ melt's
# lattice, 100-bead chains, and the generated start's warm-up settings
CHAIN_RHO, CHAIN_LEN = 0.8442, 100
WARM_DT, WARM_STEPS, WARM_CAP = 0.003, 1000, 24


def chain_config(box: Box, n_max: int) -> SceneConfig:
    """bench/in.chain's physics in `box`: lj/cut 1.12 shifted (WCA, eps =
    sigma = 1) with 1-2 pairs excluded (`special_bonds fene`), bond fene
    30.0 1.5 1.0 1.0, Langevin T = 1 damp 10 seed 904297, dt 0.012.  Skin
    0.98 and filing cap 18 are the JAX chain_scene's (cap 18 measured
    occupancy-tight on the published melt, cap 17 overflows)."""
    pair = LJCutParams.create(cutoff=1.12, epsilon=1.0, sigma=1.0,
                              shift=True)
    return SceneConfig(
        box=box, masses=(1.0,), pair=pair, dt=0.012,
        capacity=Capacity(n_max=n_max, cell_capacity=18),
        bond=BondFENEParams(k=30.0, r0=1.5, epsilon=1.0, sigma=1.0),
        langevin=LangevinParams(temp=1.0, damp=10.0, seed=904297),
        skin=0.98, force_path="cellpad")


def chain_lattice(nx: int = 20, chain_len: int = CHAIN_LEN):
    """Chains threaded through the fcc lattice of lj_melt_scene(nx) with
    nearest-neighbour steps: (positions [N, 3], mol [N], bonds [N - N /
    chain_len, 2] as 1-based tags), tags 1..N along the chains, mol the
    chain index from 1.

    In half-spacing units a site is (i, j, k) with i + j + k even.  Plane
    k (normal to z) is a checkerboard; in the row index r = (j - k) mod 2n
    it is traversed strip by strip, a strip being rows (2s, 2s + 1) walked
    along i as a zigzag (i, 2s + i % 2), each step a diagonal
    nearest-neighbour bond (the strip-to-strip step wraps i periodically).
    Plane k starts at strip -k mod n, so that its last site lies one
    nearest-neighbour step below the next plane's first.  The path, cut
    into pieces of chain_len, gives every bond the length a / sqrt(2)
    (1.188 at rho* = 0.8442), below FENE's r0 = 1.5, and every non-bonded
    pair at least that far apart, beyond the WCA cut of 1.12.

    The lattice is shifted by a/12 on every axis: at nx = 20 a cell
    (33.59 / 15 wide) spans 8/3 half-spacings, so unshifted planes lie on
    every third cell face and the first relayouts would move more atoms
    than their mover budget; a sixth of a half-spacing keeps every plane
    at least 0.14 from a face."""
    n = nx
    kk, tt, ii = np.meshgrid(np.arange(2 * n), np.arange(n), np.arange(2 * n),
                             indexing="ij")
    strip = (tt - kk) % n
    j = (2 * strip + ii % 2 + kk) % (2 * n)
    grid = np.stack([ii, j, kk], axis=-1).reshape(-1, 3)
    n_sites = len(grid)
    if n_sites % chain_len:
        raise ValueError(f"{n_sites} lattice sites do not make chains of "
                         f"{chain_len}")
    a = (4.0 / CHAIN_RHO) ** (1.0 / 3.0)
    x = (grid + 1.0 / 6.0) * (0.5 * a)
    tags = np.arange(1, n_sites + 1)
    mol = (tags - 1) // chain_len + 1
    inner = tags[:-1][(tags[:-1] % chain_len) != 0]
    bonds = np.stack([inner, inner + 1], axis=1)
    return x, mol.astype(np.int32), bonds


def chain_scene(data_path: Optional[str] = None, nx: int = 20,
                chain_len: int = CHAIN_LEN, device="cuda") -> Scene:
    """The reference's chain headline benchmark (bench/in.chain) on
    `device`: a FENE bead-spring melt of 32,000 beads in 320 chains of 100
    (chain_config's physics).

    With `data_path`, the published start is read from that `atom_style
    bond` data file, as the JAX chain_scene does.  Without it, the start is
    chain_lattice(nx, chain_len) in the lj_melt_scene(nx) box (rho* =
    0.8442, 33.59 on a side at nx = 20, periodic on every axis) with
    normal velocities at T = 1 (numpy seed 87287), zero net momentum.  Its
    bonds sit at 1.188 and relax toward ~0.97 under FENE, which heats the
    melt far above T = 1 in a few steps at dt 0.012: run chain_warm_up
    before setup."""
    if data_path is not None:
        from .io.lammps_data import read_data
        df = read_data(data_path, atom_style="bond")
        cfg = chain_config(df.box(periodic=(True, True, True)), df.natoms)
        return Scene(cfg=cfg, state=init_state(
            cfg, df.x, v=df.v, types=df.types, tags=df.tags, mol=df.mol,
            bonds=df.bonds, device=device))
    x, mol, bonds = chain_lattice(nx, chain_len)
    L = nx * (4.0 / CHAIN_RHO) ** (1.0 / 3.0)
    box = Box((0.0, 0.0, 0.0), (L, L, L), (True, True, True))
    rng = np.random.default_rng(87287)
    v = rng.normal(0.0, 1.0, x.shape)
    v -= v.mean(axis=0)
    cfg = chain_config(box, len(x))
    return Scene(cfg=cfg, state=init_state(cfg, x, v=v, mol=mol,
                                           bonds=bonds, device=device))


def chain_warm_up_config(cfg: SceneConfig) -> SceneConfig:
    """The warm-up's copy of a chain config: dt WARM_DT and filing capacity
    WARM_CAP, roomier for the hot transient."""
    return dataclasses.replace(cfg, dt=WARM_DT, capacity=dataclasses.replace(
        cfg.capacity, cell_capacity=WARM_CAP))


def chain_warm_up(cfg: SceneConfig, state: State,
                  steps: int = WARM_STEPS) -> State:
    """The generated start's warm-up, with means the JAX package has:
    chain_warm_up_config(cfg), setup, then integrate.equilibrate's velocity
    rescale to the thermostat's T every 25 steps.  Returns the state laid
    out in the warm-up config's geometry; `integrate.setup(cfg, state)`
    then files it at the scene's own capacity.  The melt is warm when no
    bond is longer than r0, T is within 10% of the target and
    observe.check_invariants passes."""
    from .integrate import equilibrate, setup
    wcfg = chain_warm_up_config(cfg)
    return equilibrate(wcfg, setup(wcfg, state), steps,
                       temp=cfg.langevin.temp)


# The dpd/tstat heating ramp: tests/test_dpd_variants.py:212-253's ideal
# DPD gas (rho = 1200/512, dt 0.02, gamma 4.5, rc 1, seed 5).
TSTAT_RHO = 1200.0 / 512.0


def dpd_tstat_config(box_l: float = 35.0, t_start: float = 0.4,
                     t_stop: float = 2.0, ramp=(0, 1000)) -> SceneConfig:
    """`pair_style dpd/tstat t_start t_stop 1.0 5`, `pair_coeff * * 4.5`
    in a fully periodic cube of side box_l, dt 0.02, T ramped linearly
    from t_start to t_stop over the step window `ramp`: a DPD thermostat
    with no conservative force, which users run to heat or anneal a system
    while keeping its momentum.

    Skin 0.4, not the JAX test's 0.3: the port relayouts on a static
    schedule, here every step (engine_cellpad.auto_rebuild_every at the
    ramp's hot end), and at T = 2 the fastest of 100k atoms moves about
    0.15 in a step of 0.02, the half-skin at 0.3 (chi tail: ~0.3 half-skin
    trips per step), against ~1e-5 trips per step at half-skin 0.2.  At
    box_l = 35 that gives 25 cells per axis, 1.4 wide, 6.4 atoms per cell
    on average; filing cap 28 leaves the Poisson tail of an ideal gas at
    ~1e-6 overflowing cells per snapshot."""
    box = Box((0.0, 0.0, 0.0), (box_l,) * 3, (True, True, True))
    pair = DPDTstatParams.create(t_start=t_start, t_stop=t_stop, cutoff=1.0,
                                 seed=5, gamma=4.5, ramp=ramp)
    n = int(round(TSTAT_RHO * box_l ** 3))
    return SceneConfig(box=box, masses=(1.0,), pair=pair, dt=0.02,
                       capacity=Capacity(n_max=n, cell_capacity=28),
                       skin=0.4, force_path="cellpad")


def dpd_tstat_scene(box_l: float = 35.0, t_start: float = 0.4,
                    t_stop: float = 2.0, ramp=(0, 1000),
                    device="cuda") -> Scene:
    """Config + the ramp test's start on `device`: round(rho L^3) atoms
    (100,488 at box_l = 35) uniform in the box, normal velocities at
    t_start with zero net momentum, from numpy's generator at seed 1."""
    cfg = dpd_tstat_config(box_l, t_start, t_stop, ramp)
    n = cfg.capacity.n_max
    r = np.random.default_rng(1)
    x = r.uniform(0.0, box_l, (n, 3))
    v = r.normal(0.0, np.sqrt(t_start), (n, 3))
    v -= v.mean(axis=0)
    return Scene(cfg=cfg, state=init_state(cfg, x, v=v, device=device))


def closed_dpd_scene(n: int = 3000, box_l: float = 10.0, seed: int = 0,
                     temp: float = 1.0, n_max: Optional[int] = None,
                     dtype: str = "float32", device="cuda") -> Scene:
    """The closed, fully periodic DPD fluid of Milestone A
    (obmd_tpu/scenes.py closed_dpd_scene): NVE with the DPD thermostat,
    which must hold T at `temp`.  DPD a0 25, gamma 4.5, rc 1, pair seed
    90823, dt 0.04, filing cap 24, no OBMD, on the nlist engine; n atoms
    uniform in the cube of side box_l and normal velocities at `temp` with
    zero net momentum, from numpy's generator at `seed` (the JAX scene's
    draws), on `device`."""
    box = Box((0.0, 0.0, 0.0), (box_l, box_l, box_l), (True, True, True))
    pair = DPDParams.create(temp=temp, cutoff=1.0, seed=90823,
                            a0=25.0, gamma=4.5, ntypes=1)
    cfg = SceneConfig(box=box, masses=(1.0,), pair=pair, dt=0.04,
                      capacity=Capacity(n_max=n_max or n, cell_capacity=24),
                      obmd=None, dtype=dtype, force_path="nlist")
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, box_l, (n, 3))
    v = rng.normal(0, np.sqrt(temp), (n, 3))
    v -= v.mean(axis=0)
    return Scene(cfg=cfg, state=init_state(cfg, x, v=v, seed=seed,
                                           device=device))


def near_box_config() -> SceneConfig:
    """The JAX package's momentum-conservation box
    (tests/test_conservation.py:34-55, its cellpad configuration): a 10 x 4
    x 4 box, x open, DPD a0 25, gamma 4.5, rc 1, T 1, seed 9, dt 0.005,
    skin 0.4; buffers of 1.5 at both ends (also the insertion regions),
    degenerate shear regions, pxx 30, alpha 0.9, tau 0.02, nbuf 72 / 0.9
    (alpha nbuf near the start's buffer census keeps both buffers
    occupied), `near 0.35` insertion of up to 8 candidates, ntype 0, seed
    3.  The 4-long periodic y and z axes hold fewer than 3 cut + skin
    cells, so each is one cell (a 7 x 1 x 1 grid: s = 1, p = 128, one
    block), and a cell column holds ~70 atoms: filing capacity 112."""
    box = Box((0.0, 0.0, 0.0), (10.0, 4.0, 4.0), (False, True, True))
    b = 1.5
    r1 = RegionBlock((0.0, 0.0, 0.0), (b, 4.0, 4.0))
    r2 = RegionBlock((10.0 - b, 0.0, 0.0), (10.0, 4.0, 4.0))
    deg = RegionBlock((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    pair = DPDParams.create(temp=1.0, cutoff=1.0, seed=9, a0=25.0,
                            gamma=4.5)
    obmd = ObmdParams(ntype=0, nfreq=1, seed=3, pxx=30.0, alpha=0.9,
                      tau=0.02, nbuf=72.0 / 0.9, region1=r1, region2=r2,
                      region3=deg, region4=deg, region5=r1, region6=r2,
                      buffer_size=b, near=0.35, insert_kmax=8, maxattempt=1)
    return SceneConfig(box=box, masses=(1.0,), pair=pair, dt=0.005,
                       capacity=Capacity(n_max=1200, cell_capacity=112),
                       obmd=obmd, skin=0.4).finalize()


def near_box_scene(device="cuda") -> Scene:
    """near_box_config with the JAX test's start: a 20 x 5 x 5 grid over
    [0.4, 9.6] x [0.3, 3.7]^2 jittered by uniform(-0.12, 0.12), unit normal
    velocities, both from numpy's default_rng(2)."""
    cfg = near_box_config()
    r = np.random.default_rng(2)
    g = np.stack(np.meshgrid(np.linspace(0.4, 9.6, 20),
                             np.linspace(0.3, 3.7, 5),
                             np.linspace(0.3, 3.7, 5),
                             indexing="ij"), axis=-1).reshape(-1, 3)
    g = g + r.uniform(-0.12, 0.12, g.shape)
    v = r.normal(0.0, 1.0, (g.shape[0], 3))
    return Scene(cfg=cfg, state=init_state(cfg, g, v=v, device=device))


def dpd_film_config(y_open: bool = False) -> SceneConfig:
    """A thin film of the OBMD_DPD deck's DPD fluid (its pair law, dt and
    skin at rho 3) with no OBMD stage: the bench box's x length (9 x the
    deck's, x open), 5 x its width in y (periodic, or open with
    `y_open`), 2.0 in z (periodic).  The z axis is one cut + skin cell
    and exactly twice the cutoff long, the shortest single-cell axis the
    kernels take.  217 x 40 x 1 cells, 101,570 atoms; filing capacity 32
    holds a uniform gas's fullest cell (Poisson of mean 11.7 over 8,680
    cells)."""
    base = obmd_dpd_config(scale=1.0)
    box = Box((0.0, 0.0, 0.0), (33.594 * 9, 11.198 * 5, 2.0),
              (False, not y_open, True))
    n = int(3.0 * box.volume)
    return SceneConfig(box=box, masses=(1.0,), pair=base.pair, dt=base.dt,
                       capacity=Capacity(n_max=n, cell_capacity=32),
                       obmd=None, skin=base.skin).finalize()


def dpd_film_scene(y_open: bool = False, device="cuda") -> Scene:
    """dpd_film_config with a uniform gas at rho 3 and unit normal
    velocities from numpy's default_rng(11)."""
    cfg = dpd_film_config(y_open)
    rng = np.random.default_rng(11)
    n = cfg.capacity.n_max
    x = rng.uniform(np.asarray(cfg.box.lo), np.asarray(cfg.box.hi), (n, 3))
    v = rng.normal(0.0, 1.0, (n, 3))
    return Scene(cfg=cfg, state=init_state(cfg, x, v=v, device=device))


# The star-polymer melt: tests/test_branched.py's 4-arm star (a center of
# type 2 and four arms of type 1 at 0.55, one improper over arms 1-3 around
# the center; 0-based template rows below, the center first), its DPD law
# and bond, the angle coefficients of tests/test_branched.py:238-243 on
# every partner pair of the center, DPD density 3.
STAR_DX = ((0.0, 0.0, 0.0), (0.55, 0.0, 0.0), (-0.55, 0.05, 0.0),
           (0.0, 0.55, 0.05), (0.0, -0.05, 0.55))
STAR_TYPES = (1, 0, 0, 0, 0)
STAR_IMPROPER = (1, 0, 2, 3)          # (i1, i2 = center, i3, i4)
STAR_RHO = 3.0
STAR_ANGLE = (5.0, 109.5)             # K, theta0 (degrees) on the center
STAR_IMP = (8.0, 30.0)                # K, chi0 (degrees) on the center
# dt: a quarter of tests/test_branched.py's 0.01.  Near collinear arms 1
# and 2 the improper's force grows as 1 / (1 - c1^2) (capped at 1 / SMALL
# = 1000, as improper_harmonic.cpp caps it) to |f| ~ 3,000, and the
# integrator then pumps energy into the star.  On 100,000 beads over 1,200
# steps (obmd_tpu_torch.star_probe) the longest bond reached 6.43 at dt
# 0.01 (T 1.08-1.09, a half-skin trip on every step), 5.83 at 0.0075,
# 3.72 at 0.005 (49 trips), 3.21 at 0.004 and 1.49 at 0.0025 (T within
# 1.1% of 1, no trip).
STAR_DT = 0.0025
# a relayout on every step: the auto schedule's period (its 9 sqrt(T / m)
# calibration knows no such kick) let kicked atoms cross the half skin at
# 152 of the 400 relayouts of 1,200 steps at dt 0.005 (period 3)
STAR_REBUILD_EVERY = 1
# filing caps: the random start (its fullest cell held 30 beads at 20,000
# stars), the warm-up's (make_pair_kernel's rank-looped body) and
# production's, the smallest that held (the big-tile body: over 1,200
# steps from the warmed melt cap 14 left 43 atoms unfiled, cap 15 none,
# star_probe); the steps of the two warm-up stages
STAR_START_CAP, STAR_WARM_CAP, STAR_PROD_CAP = 40, 24, 15
STAR_START_STEPS, STAR_WARM_STEPS = 200, 400


def star_melt_config(box_l: float, n_max: int, angle=None, improper=None,
                     cap: int = STAR_WARM_CAP) -> SceneConfig:
    """A closed star-polymer melt in a periodic cube of side box_l:
    tests/test_branched.py:42-43's two-type DPD (a0 25, gamma 4.5, T 1,
    cutoff 1, seed 3), `bond_style harmonic` K 40 r0 0.55 (:53), skin 0.3,
    dt STAR_DT, a relayout every STAR_REBUILD_EVERY steps, a branched
    topology; `angle` and `improper` are the center tables a data file's
    sections give (star_melt_scene derives them)."""
    box = Box((0.0, 0.0, 0.0), (box_l,) * 3, (True, True, True))
    pair = DPDParams.create(temp=1.0, cutoff=1.0, seed=3, a0=25.0, gamma=4.5,
                            ntypes=2)
    return SceneConfig(
        box=box, masses=(1.0, 1.0), pair=pair, dt=STAR_DT,
        capacity=Capacity(n_max=n_max, cell_capacity=cap),
        bond=BondHarmonicParams(k=40.0, r0=0.55), angle=angle,
        improper=improper, skin=0.3, force_path="cellpad",
        rebuild_every=STAR_REBUILD_EVERY, branched_topology=True)


def star_box(n_stars: int) -> float:
    """The side of the cube that holds n_stars stars at STAR_RHO (32.183
    at 20,000 stars: 24 cut + skin cells per axis)."""
    return (len(STAR_DX) * n_stars / STAR_RHO) ** (1.0 / 3.0)


def _rotations(r, n: int) -> np.ndarray:
    """n rotation matrices, uniform over SO(3) (unit quaternions from
    normal draws)."""
    q = r.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1)], axis=1)


def write_star_data(path: str, n_stars: int, seed: int) -> None:
    """The star melt's start as an `atom_style molecular` data file: star
    centers uniform in the star_box(n_stars) cube, each star rotated at
    random, unit normal velocities less their mean (T = 1, zero momentum),
    all from numpy's default_rng(seed); sections Masses, Atoms,
    Velocities, Bonds (the four arms), Angles (all six partner pairs of
    each center, angle type 1) and Impropers (one per center, type 1)."""
    L = star_box(n_stars)
    r = np.random.default_rng(seed)
    centers = r.uniform(0.0, L, (n_stars, 3))
    dx = np.einsum("sij,kj->ski", _rotations(r, n_stars), np.asarray(STAR_DX))
    x = np.mod(centers[:, None, :] + dx, L).reshape(-1, 3)
    _write_stars(path, r, x, np.zeros(3), np.full(3, L))


def _write_stars(path: str, r, x, lo, hi) -> None:
    """Write stars of positions x [5 n_stars, 3] (star by star, the center
    first) in the box lo..hi as an `atom_style molecular` data file: unit
    normal velocities from r less their mean, the four arm bonds, all six
    partner-pair angles of each center and one improper (type 1 each)."""
    from .io.lammps_data import DataFile, write_data
    m = len(STAR_DX)
    n = len(x)
    n_stars = n // m
    v = r.normal(0.0, 1.0, (n, 3))
    v -= v.mean(axis=0)
    base = m * np.arange(n_stars)[:, None] + 1       # each star's center tag
    arms = base + np.arange(1, m)[None, :]
    bonds = np.stack([np.broadcast_to(base, arms.shape), arms],
                     axis=-1).reshape(-1, 2)
    pairs = np.asarray([(a, b) for a in range(1, m) for b in range(a + 1, m)])
    angles = np.stack([np.ones((n_stars, len(pairs)), np.int64),
                       base + pairs[None, :, 0], np.broadcast_to(
                           base, (n_stars, len(pairs))),
                       base + pairs[None, :, 1]], axis=-1).reshape(-1, 4)
    impropers = np.concatenate([np.ones((n_stars, 1), np.int64),
                                base + np.asarray(STAR_IMPROPER)[None, :]],
                               axis=1)
    write_data(path, DataFile(
        natoms=n, ntypes=2, box_lo=lo, box_hi=hi, masses=np.ones(2), x=x,
        types=np.tile(STAR_TYPES, n_stars), tags=np.arange(1, n + 1), v=v,
        mol=np.repeat(np.arange(1, n_stars + 1), m), bonds=bonds,
        angles=angles, impropers=impropers), atom_style="molecular")


def star_melt_scene(n_stars: int = 20_000, seed: int = 2016,
                    device="cuda") -> Scene:
    """The closed star-polymer melt on `device`, through the data-file
    route a user's deck takes: write_star_data into a temporary directory,
    read it back with io.lammps_data.read_data(atom_style="molecular"),
    then derive the center tables from its Angles and Impropers sections
    (STAR_ANGLE and STAR_IMP as the angle and improper coefficients of
    type 1).  20,000 stars are 100,000 beads, 80,000 bonds, 120,000 angles
    and 20,000 impropers in a cube of side 32.183.  The random start
    overlaps beads and files up to ~33 in a cell: run star_warm_up before
    setup."""
    from .io.lammps_data import read_data
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stars.data")
        write_star_data(path, n_stars, seed)
        df = read_data(path, atom_style="molecular")
    types = dict(zip(df.tags.tolist(), df.types.tolist()))
    angle = derive_center_angle_table(df.ntypes, df.angles, types, df.bonds,
                                      {1: STAR_ANGLE})
    improper = derive_center_improper_table(df.ntypes, df.impropers, types,
                                            {1: STAR_IMP})
    cfg = star_melt_config(float(df.box_hi[0] - df.box_lo[0]), df.natoms,
                           angle=angle, improper=improper)
    return Scene(cfg=cfg, state=init_state(
        cfg, df.x, v=df.v, types=df.types, tags=df.tags, mol=df.mol,
        bonds=df.bonds, impropers=df.impropers, device=device))


def with_cap(cfg: SceneConfig, cap: int) -> SceneConfig:
    """cfg at filing capacity `cap`."""
    return dataclasses.replace(
        cfg, capacity=dataclasses.replace(cfg.capacity, cell_capacity=cap))


def star_warm_up(cfg: SceneConfig, state: State,
                 start_steps: int = STAR_START_STEPS,
                 steps: int = STAR_WARM_STEPS) -> State:
    """The random start's warm-up, with means the JAX package has: setup
    and integrate.equilibrate (velocity rescale to T = 1 every 25 steps),
    first start_steps at filing cap STAR_START_CAP (the start's fullest
    cells), then `steps` at STAR_WARM_CAP.  Returns the state laid out at
    the warm-up's cap; `integrate.setup(with_cap(cfg, STAR_PROD_CAP),
    state)` then files it for production."""
    from .integrate import equilibrate, setup
    for cap, n in ((STAR_START_CAP, start_steps), (STAR_WARM_CAP, steps)):
        wcfg = with_cap(cfg, cap)
        state = equilibrate(wcfg, setup(wcfg, state), n, temp=1.0)
    return state


# The open star-polymer melt under shear (path F, BASELINE.json config 4:
# Sablic, Soft Matter 2016): the star melt's law, bonds, angle and improper
# tables, step and layout in an open-x box, molecule-mode insertion of the
# star template read from a LAMMPS molecule file.  The state point, read
# with `python3 -m obmd_tpu_torch.star_probe --open --steps 400` on an
# NVIDIA H100 80GB HBM3 at 700 W: OPEN_STAR_PXX is the warmed closed
# melt's P_xx (kinetic plus pair virial; thermo has no bonded virial),
# the mean of 10 readings over steps 820-1,000 (T 1.0030, sd of P_xx
# 0.121); OPEN_STAR_ETARGET the median energy of 256 stars of that melt
# at step 1,000, each taken out and tested against the rest
# (subset.mol_energy_force; quartiles 17.93 and 24.65);
# OPEN_STAR_CENSUS the open melt's buffer census in molecules after its
# warm-up (the start's 2,886.8; 512 stars left through the faces in the
# warm-up, none was inserted).
OPEN_STAR_LYZ = 18.3          # 14 cells of cut + skin (18.3 / 1.3 = 14.08)
OPEN_STAR_BUFFER = 0.15       # buffers of 0.15 Lx at each end
OPEN_STAR_PXY = 2.0           # validation/run_couette.py's shear
OPEN_STAR_MARGIN = 0.6        # start centers at least an arm inside x
OPEN_STAR_PXX = 23.5411
OPEN_STAR_ETARGET = 20.7785
OPEN_STAR_CENSUS = 2606.9
STAR_BONDS = ((0, 1), (0, 2), (0, 3), (0, 4))


def write_star_molecule(path: str, arm: float = 0.55,
                        types=STAR_TYPES) -> None:
    """The star template as a LAMMPS molecule file: STAR_DX with every
    displacement scaled by arm / 0.55 (arm 0.55: the JAX package's star),
    `types` (0-based; STAR_TYPES), the four center-arm bonds, the six
    partner-pair angles of the center and STAR_IMPROPER, each of type 1."""
    from .io.molecule import MoleculeTemplate, write_molecule
    pairs = [(a, b) for a in range(1, 5) for b in range(a + 1, 5)]
    write_molecule(path, MoleculeTemplate(
        natoms=len(STAR_DX), x=np.asarray(STAR_DX) * (arm / 0.55),
        types=np.asarray(types), q=np.zeros(len(STAR_DX)),
        bonds=np.asarray([(1, a + 1, b + 1) for a, b in STAR_BONDS]),
        angles=np.asarray([(1, a + 1, 1, b + 1) for a, b in pairs]),
        impropers=np.asarray([(1,) + tuple(i + 1 for i in STAR_IMPROPER)])),
        title="4-arm star (tests/test_branched.py STAR)")


def star_template(arm: float = 0.55, types=STAR_TYPES):
    """config.MolTemplate of write_star_molecule's file, read back through
    io.molecule.read_molecule (dx about the template's geometric
    center)."""
    from .config import MolTemplate
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "star.mol")
        write_star_molecule(path, arm, types)
        return MolTemplate.from_file(path)


def open_star_box(n_stars: int) -> float:
    """Lx of the open box that holds n_stars stars at STAR_RHO with Ly = Lz
    = OPEN_STAR_LYZ (99.535 at 20,000 stars)."""
    return len(STAR_DX) * n_stars / STAR_RHO / OPEN_STAR_LYZ ** 2


def open_star_obmd(lx: float, lyz: float, etarget: float, pxx: float,
                   nbuf: float, pxy: float, nattempt: int = 40, **kw):
    """The stage of an open star box: buffers (= insertion and shear
    regions) of OPEN_STAR_BUFFER * lx at each end, the OBMD_DPD deck's
    rules (alpha 0.7, tau 0.005, nfreq 1, maxattempt 1), molecule-mode
    insertion of star_template() (mol_len 5, K = 4) steered by USHER (ds0
    1, dtheta0 0.02, uovlp 1e4, dsovlp 1.5, eps 1), the normal load pxx
    and the shear pxy on the buffers (validation/run_couette.py:19-24).
    `kw` replaces ObmdParams fields."""
    b = OPEN_STAR_BUFFER * lx
    r1 = RegionBlock((0.0, 0.0, 0.0), (b, lyz, lyz))
    r2 = RegionBlock((lx - b, 0.0, 0.0), (lx, lyz, lyz))
    args = dict(
        ntype=0, nfreq=1, seed=2016, pxx=pxx, pxy=pxy, alpha=0.7, tau=0.005,
        nbuf=float(nbuf), region1=r1, region2=r2, region3=r1, region4=r2,
        region5=r1, region6=r2, buffer_size=b, g_fac=0.25, maxattempt=1,
        usher=UsherParams(etarget=etarget, ds0=1.0, dtheta0=0.02,
                          uovlp=1.0e4, dsovlp=1.5, eps=1.0,
                          nattempt=nattempt),
        mol=star_template(), mol_len=len(STAR_DX), insert_kmax=4)
    args.update(kw)
    return ObmdParams(**args)


def open_star_config(lx: float, n_max: int, angle=None, improper=None,
                     cap: int = STAR_WARM_CAP, nbuf: float = OPEN_STAR_CENSUS,
                     etarget: float = OPEN_STAR_ETARGET,
                     pxx: float = OPEN_STAR_PXX,
                     pxy: float = OPEN_STAR_PXY) -> SceneConfig:
    """Path F: star_melt_config's law, bonds, tables, dt, skin and layout
    in an open-x box lx x OPEN_STAR_LYZ x OPEN_STAR_LYZ (y and z periodic,
    14 cells each) under open_star_obmd's stage.  nbuf defaults to the
    warmed open melt's census in molecules (the buffers may drain to alpha
    of it before the stage inserts, as the OBMD_DPD deck's nbuf lets its
    buffers drain)."""
    closed = star_melt_config(1.0, n_max, angle=angle, improper=improper,
                              cap=cap)
    box = Box((0.0, 0.0, 0.0), (lx, OPEN_STAR_LYZ, OPEN_STAR_LYZ),
              (False, True, True))
    return dataclasses.replace(
        closed, box=box, obmd=open_star_obmd(lx, OPEN_STAR_LYZ, etarget,
                                             pxx, nbuf, pxy)).finalize()


def write_open_star_data(path: str, n_stars: int, seed: int,
                         lo=(0.0, 0.0, 0.0), hi=None,
                         margin: float = OPEN_STAR_MARGIN) -> None:
    """write_star_data generalised to a box lo..hi (periodic y and z, open
    x): n_stars star centers uniform with x at least `margin` inside the x
    faces (so no star straddles an open face), each rotated at random;
    unit normal velocities less their mean; the same sections."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    r = np.random.default_rng(seed)
    inset = np.asarray([margin, 0.0, 0.0])
    centers = r.uniform(lo + inset, hi - inset, (n_stars, 3))
    dx = np.einsum("sij,kj->ski", _rotations(r, n_stars), np.asarray(STAR_DX))
    x = centers[:, None, :] + dx
    x[..., 1:] = lo[1:] + np.mod(x[..., 1:] - lo[1:], hi[1:] - lo[1:])
    _write_stars(path, r, x.reshape(-1, 3), lo, hi)


def _star_tables(df):
    """The center angle and improper tables of a star data file's Angles
    and Impropers sections (STAR_ANGLE, STAR_IMP as type 1's
    coefficients)."""
    types = dict(zip(df.tags.tolist(), df.types.tolist()))
    return (derive_center_angle_table(df.ntypes, df.angles, types, df.bonds,
                                      {1: STAR_ANGLE}),
            derive_center_improper_table(df.ntypes, df.impropers, types,
                                         {1: STAR_IMP}))


def open_star_scene(n_stars: int = 20_000, seed: int = 2016,
                    device="cuda", **cfg_kw) -> Scene:
    """Path F on `device`: write_open_star_data for n_stars stars in the
    open_star_box(n_stars) box (20,000 stars: 100,000 beads, Lx 99.535),
    read back with io.lammps_data.read_data(atom_style="molecular"), the
    center tables from its sections, open_star_config (`cfg_kw` passed
    on).  The random start overlaps beads: run star_warm_up (under the
    stage) before setup at STAR_PROD_CAP."""
    from .io.lammps_data import read_data
    lx = open_star_box(n_stars)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "open_stars.data")
        write_open_star_data(path, n_stars, seed,
                             hi=(lx, OPEN_STAR_LYZ, OPEN_STAR_LYZ))
        df = read_data(path, atom_style="molecular")
    angle, improper = _star_tables(df)
    cfg = open_star_config(float(df.box_hi[0] - df.box_lo[0]), df.natoms,
                           angle=angle, improper=improper, **cfg_kw)
    return Scene(cfg=cfg, state=init_state(
        cfg, df.x, v=df.v, types=df.types, tags=df.tags, mol=df.mol,
        bonds=df.bonds, impropers=df.impropers, device=device))


# The small molecule-mode boxes of the CPU tests and the smoke's small
# paths, one per law of the pair kernel's 4-channel rows (MOL_LAWS).  DPD
# ("dpd": the star melt's two types; "dpd1": one type, the star all type
# 0): tests/test_branched.py's star box (_star_cfg: 10 x 4 x 4, stage and
# USHER settings) with y and z of 6 cells (8.0, where JAX's
# make_pair_kernel is right, ROADMAP Queue 3) and n_max and nbuf scaled by
# the volume (x4); the start MOL_BOX_MONOMERS type-0 monomers, uniform,
# and MOL_BOX_STARS stars, the first one with an arm at x = 0.1, its atoms
# moving out of the low x face at MOL_BOX_EXIT_V (it leaves whole).  LJ
# ("lj": two types, "lj1": one; "ljrf": lj/cut/rf, the charged fluid's
# law, with ion_sites' types and charges on the monomers): the open LJ
# fluid's lattice of MOL_LJ_CELLS fcc cells stretched to the density
# MOL_LJ_RHO, where a star with arms of 1.0 fits between the sites, as
# monomers into which the stage inserts stars.
MOL_LAWS = ("dpd", "dpd1", "lj", "lj1", "ljrf")
MOL_BOX = (10.0, 8.0, 8.0)
MOL_BOX_MONOMERS, MOL_BOX_STARS, MOL_BOX_EXIT_V = 1100, 20, -10.0
MOL_LJ_CELLS, MOL_LJ_RHO = (10, 6), 0.1


def _mol_pair(law: str):
    """The pair law of a small molecule-mode box."""
    if law == "dpd":
        return DPDParams.create(temp=1.0, cutoff=1.0, seed=3, a0=25.0,
                                gamma=4.5, ntypes=2)
    if law == "dpd1":
        return DPDParams.create(temp=1.0, cutoff=1.0, seed=3, a0=25.0,
                                gamma=4.5)
    if law == "ljrf":
        return ljrf_pair()
    return LJCutParams.create(cutoff=2.5, epsilon=1.0, sigma=1.0,
                              ntypes=1 if law == "lj1" else 2)


def mol_box_config(law: str = "dpd", nattempt: int = 12,
                   etarget: float = 12.0) -> SceneConfig:
    """The small molecule-mode box of `law` (MOL_LAWS): DPD with
    tests/test_branched.py's stage (pxx 5, alpha 0.5, tau 0.01, nbuf 600,
    buffers of 2.0, K = 4, dt 0.01, skin 0.3, cap 22), or an LJ law (the
    star scaled to arms of 1.0 with harmonic r0 1.0, buffers of 0.15 Lx,
    nbuf 300, K = 16, dt 0.005, skin 0.4, cap 44); harmonic bonds K 40,
    the star's angle and improper tables; with one type the star is all
    type 0."""
    if law not in MOL_LAWS:
        raise ValueError(f"law must be one of {MOL_LAWS}, not {law!r}")
    lj = law.startswith("lj")
    pair = _mol_pair(law)
    if lj:
        a = (4.0 / MOL_LJ_RHO) ** (1.0 / 3.0)
        nx, ny = MOL_LJ_CELLS
        dims = (nx * a, ny * a, ny * a)
    else:
        dims = MOL_BOX
    lx, ly, lz = dims
    b = 0.15 * lx if lj else 2.0
    box = Box((0.0, 0.0, 0.0), dims, (False, True, True))
    r1 = RegionBlock((0.0, 0.0, 0.0), (b, ly, lz))
    r2 = RegionBlock((lx - b, 0.0, 0.0), (lx, ly, lz))
    deg = RegionBlock((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    arm = 1.0 if lj else 0.55
    one = pair.ntypes == 1
    types = (0,) * len(STAR_TYPES) if one else STAR_TYPES
    masses = LJRF_MASSES if law == "ljrf" else (1.0,) * pair.ntypes
    obmd = ObmdParams(
        ntype=0, nfreq=1, seed=11, pxx=5.0, alpha=0.5, tau=0.01,
        nbuf=300.0 if lj else 600.0,
        region1=r1, region2=r2, region3=deg, region4=deg, region5=r1,
        region6=r2, buffer_size=b,
        usher=UsherParams(etarget=etarget, nattempt=nattempt),
        mol=star_template(arm, types), mol_len=5,
        insert_kmax=16 if lj else 4)
    k_c = 0 if one else 1          # the star center's type
    tab = [0.0] * pair.ntypes
    return SceneConfig(
        box=box, masses=masses, pair=pair, dt=0.005 if lj else 0.01,
        capacity=Capacity(n_max=3600, cell_capacity=44 if lj else 22),
        obmd=obmd, bond=BondHarmonicParams(k=40.0, r0=arm),
        angle=AngleHarmonicParams(
            k=_at(tab, k_c, STAR_ANGLE[0]), theta0=_at(tab, k_c,
                                                       STAR_ANGLE[1])),
        improper=ImproperHarmonicParams(
            k=_at(tab, k_c, STAR_IMP[0]), chi0=_at(tab, k_c, STAR_IMP[1])),
        skin=0.4 if lj else 0.3, force_path="cellpad").finalize()


def _at(row, k, v):
    """row (a per-type list) with v at type k, as a tuple."""
    out = list(row)
    out[k] = v
    return tuple(out)


def mol_box_start(cfg: SceneConfig, seed: int = 4):
    """The small box's start as (x, v, types, mol, bonds, impropers): the
    monomers and stars of the comment above, the stars at random rotations
    of the template (the first unrotated, an arm at x = 0.1, moving out),
    everything from numpy's default_rng(seed), positions wrapped on y and
    z."""
    r = np.random.default_rng(seed)
    lo = np.asarray(cfg.box.lo)
    hi = np.asarray(cfg.box.hi)
    dx = np.asarray(cfg.obmd.mol.dx)
    arm = float(np.linalg.norm(dx[1] - dx[0]))
    centers = r.uniform(lo + [1.0 + arm, 0.0, 0.0], hi - [1.0 + arm, 0, 0],
                        (MOL_BOX_STARS, 3))
    rots = _rotations(r, MOL_BOX_STARS)
    rots[0] = np.eye(3)
    centers[0] = (0.1 - dx[2, 0], 0.5 * hi[1], 0.5 * hi[2])
    xs = (centers[:, None, :] + np.einsum("sij,kj->ski", rots, dx)
          ).reshape(-1, 3)
    xm = r.uniform(lo + 0.05, hi - 0.05, (MOL_BOX_MONOMERS, 3))
    x = np.concatenate([xs, xm])
    x[:, 1:] = lo[1:] + np.mod(x[:, 1:] - lo[1:], (hi - lo)[1:])
    v = r.normal(0.0, 1.0, x.shape)
    v[:5] = (MOL_BOX_EXIT_V, 0.0, 0.0)
    m = len(dx)
    star_types = np.asarray(cfg.obmd.mol.types) + cfg.obmd.ntype
    types = np.concatenate([np.tile(star_types, MOL_BOX_STARS),
                            np.zeros(MOL_BOX_MONOMERS, np.int64)])
    mol = np.concatenate([np.repeat(np.arange(1, MOL_BOX_STARS + 1), m),
                          np.zeros(MOL_BOX_MONOMERS, np.int64)])
    base = m * np.arange(MOL_BOX_STARS)[:, None] + 1
    bonds = np.stack([np.broadcast_to(base, (MOL_BOX_STARS, 4)),
                      base + np.arange(1, m)], -1).reshape(-1, 2)
    impropers = base + np.asarray(STAR_IMPROPER)[None, :]
    return x, v, types, mol, bonds, impropers


def mol_box_scene(law: str = "dpd", device="cuda", **cfg_kw) -> Scene:
    """mol_box_config with its start on `device`: mol_box_start's for the
    DPD laws, the stretched lattice for the LJ laws."""
    cfg = mol_box_config(law, **cfg_kw)
    if law.startswith("lj"):
        x, v = _open_lj_start(*MOL_LJ_CELLS)
        x = x * (OBMD_LJ_RHO / MOL_LJ_RHO) ** (1.0 / 3.0)
        types, q = ion_sites(len(x)) if law == "ljrf" else (None, None)
        return Scene(cfg=cfg, state=init_state(cfg, x, v=v, types=types,
                                               q=q, device=device))
    x, v, types, mol, bonds, impropers = mol_box_start(cfg)
    return Scene(cfg=cfg, state=init_state(
        cfg, x, v=v, types=types, mol=mol, bonds=bonds, impropers=impropers,
        device=device))


# Path I: BASELINE.json config 5, open-boundary liquid water under a
# reaction field (Papez and Praprotnik, JCTC 2022): SPC/E water (Berendsen,
# Grigera and Straatsma, J. Phys. Chem. 91, 6269, 1987) in consistent
# GROMACS units (nm, ps, amu, kJ/mol, e; the engine has F = m a with kB =
# 1, so T is given as kT: 2.4943 kJ/mol is 300 K; qqrd2e 138.935458), held
# rigid by SHAKE/RATTLE, MOLECULE-mode insertion with `charged 1`.  O is
# type 0, H type 1; only O-O pairs have LJ (every pair with H has eps 0, its
# sigma the O's so that no table holds a zero sigma).
WATER_KT = 2.4943
WATER_MASSES = (15.9994, 1.008)
WATER_Q = (-0.8476, 0.4238)
WATER_SIGMA, WATER_EPS = 0.316557, 0.650194
WATER_OH, WATER_HOH = 0.1, 109.47     # nm, degrees
WATER_QQRD2E = 138.935458
WATER_RC, WATER_EPS_RF = 0.9, 78.5
WATER_DT, WATER_SKIN, WATER_DAMP = 0.002, 0.1, 1.0
WATER_LYZ, WATER_SITES, WATER_RHO = 6.0, 19, 33.37   # nm, sites, nm^-3
WATER_PLANES, WATER_CLOSED_PLANES = 92, 20
# thermo counts 3 degrees of freedom an atom; a rigid water has 6 of its 9,
# so thermo's T of water at kT reads 6/9 of it
WATER_THERMO_T = WATER_KT * 6.0 / 9.0
# vx, vy, vz of an inserted water's center: uniform in +-WATER_V, whose
# variance WATER_V^2 / 3 is kT / M at 300 K (M = 18.0154)
WATER_V = 0.644
WATER_WARM_STEPS = 500
# Jacobi SHAKE sweeps a step: at the JAX package's 30 the warmed open box
# read a largest constraint error of 9.1e-6 nm (water_probe.py), a hair
# under the 1e-5 nm (1e-4 relative, fix shake's usual tolerance) the runs
# are held to; 10 more cut the residual about tenfold
WATER_SHAKE_ITERS = 40
# The state point, read with `python3 -m obmd_tpu_torch.water_probe
# --steps 2000 --warm 500` on an NVIDIA H100 80GB HBM3 at 700 W (at 30
# SHAKE sweeps, before WATER_SHAKE_ITERS):
# closed_water_scene() (7,220 waters, 6.009 x 6 x 6 nm, periodic), melted
# by water_warm_up, then 2,000 steps under the Langevin thermostat, thermo
# T 1.6818 (2/3 of kT is 1.6629).  OPEN_WATER_PXX (kJ/mol/nm^3; 14.09 is
# 234 bar) is the molecular P_xx, the mean of 50 readings every 20 steps
# over the second half (sd 13.64 a reading):
#     V P_xx = sum_mol M V_com,x^2 + W_xx - sum_a (r_a - R_mol(a))_x f_a,x
# with W the intermolecular pair virial and f_a the pair force alone
# (observe.molecular_pxx); thermo's atomic P_xx read 1775.1, as it has no
# constraint virial.  OPEN_WATER_ETARGET (kJ/mol) is the median energy of
# 256 waters of the ended box, each taken out and tested against the rest
# with its charges (subset.mol_energy_force(..., mol_q=q); quartiles
# -101.72 and -80.90).  OPEN_WATER_CENSUS is the open box's buffer census
# in molecules after water_warm_up (5,054 at the start; 301 waters left
# through the faces in the warm-up, none was inserted).  WATER_CAP: the
# fullest 1.0 nm cell held 116 atoms in the closed box and 123 and 120 in
# the open one after the warm-up and 500 production steps.
OPEN_WATER_ETARGET = -92.0050
OPEN_WATER_PXX = 14.0929
OPEN_WATER_CENSUS = 4838.5
WATER_CAP = 150


def water_template_coords() -> np.ndarray:
    """O, H, H of SPC/E: O-H WATER_OH, H-O-H WATER_HOH (H-H 0.163299)."""
    half = np.radians(WATER_HOH / 2.0)
    return np.asarray([(0.0, 0.0, 0.0),
                       (WATER_OH * np.sin(half), WATER_OH * np.cos(half), 0.0),
                       (-WATER_OH * np.sin(half), WATER_OH * np.cos(half),
                        0.0)])


# a water's bonds as 0-based (O, H1, H2) pairs: the triangle of path I
# (SHAKE's three distances) or the tree of path K (rigid bodies: the
# message passing sums a body exactly only on a tree)
WATER_BONDS = ((0, 1), (0, 2), (1, 2))
WATER_TREE_BONDS = ((0, 1), (0, 2))


def write_water_molecule(path: str, tree: bool = False) -> None:
    """SPC/E water as a LAMMPS molecule file: Coords
    (water_template_coords), Types (O 0, H 1, 0-based), Charges
    (WATER_Q) and Bonds: O-H twice and the H-H bond that closes the
    triangle, as fix shake's angle constraint does, or with `tree` the
    two O-H bonds alone."""
    from .io.molecule import MoleculeTemplate, write_molecule
    bonds = WATER_TREE_BONDS if tree else WATER_BONDS
    write_molecule(path, MoleculeTemplate(
        natoms=3, x=water_template_coords(), types=np.asarray([0, 1, 1]),
        q=np.asarray([WATER_Q[0], WATER_Q[1], WATER_Q[1]]),
        bonds=np.asarray([(1, i + 1, j + 1) for i, j in bonds])),
        title="SPC/E water (Berendsen, Grigera and Straatsma 1987)")


def water_template(tree: bool = False):
    """config.MolTemplate of write_water_molecule's file (`tree` as
    there), read back through io.molecule.read_molecule (dx about the
    template's geometric center)."""
    from .config import MolTemplate
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "water.mol")
        write_water_molecule(path, tree)
        return MolTemplate.from_file(path)


def water_pair() -> LJCutRFParams:
    """lj/cut/rf 0.9 0.9, O-O LJ only, eps_rf 78.5, qqrd2e in kJ/mol nm
    / e^2."""
    return LJCutRFParams.create(
        cut_lj=WATER_RC, cut_coul=WATER_RC, ntypes=2,
        epsilon=((WATER_EPS, 0.0), (0.0, 0.0)), sigma=WATER_SIGMA,
        eps_rf=WATER_EPS_RF, qqrd2e=WATER_QQRD2E)


def water_lattice(planes: int, seed: int, min_dist: float = 0.18):
    """(x [3 n, 3], v [3 n, 3]) of n = planes x WATER_SITES^2 waters: centers
    on a lattice of WATER_SITES^2 sites per x plane (spacing WATER_LYZ /
    WATER_SITES) and `planes` planes at the spacing that gives WATER_RHO,
    the first half a spacing inside x = 0; each water at a random
    orientation, drawn again (numpy default_rng(seed)) while any of its
    atoms lies within min_dist of an atom of a neighbouring site (periodic
    in y and z, and in x across the planes' period); each molecule's atoms
    at one velocity, normal at kT / M per component, less the mean."""
    r = np.random.default_rng(seed)
    a = WATER_LYZ / WATER_SITES
    ax = 1.0 / (WATER_RHO * a * a)
    dims = (planes, WATER_SITES, WATER_SITES)
    period = np.asarray([planes * ax, WATER_LYZ, WATER_LYZ])
    centers = (np.stack(np.meshgrid(*[np.arange(n) for n in dims],
                                    indexing="ij"), -1) + 0.5) \
        * np.asarray([ax, a, a])
    tpl = water_template_coords() - water_template_coords().mean(0)
    rot = _rotations(r, int(np.prod(dims))).reshape(dims + (3, 3))
    offsets = [o for o in np.ndindex(3, 3, 3) if o != (1, 1, 1)]
    for _ in range(200):
        x = centers[..., None, :] + np.einsum("...ij,kj->...ki", rot, tpl)
        bad = np.zeros(dims, bool)
        for o in offsets:
            shift = tuple(k - 1 for k in o)
            other = np.roll(x, shift, axis=(0, 1, 2))
            d = x[..., :, None, :] - other[..., None, :, :]
            d -= period * np.round(d / period)
            bad |= (np.sqrt((d * d).sum(-1)) < min_dist).any((-1, -2))
        if not bad.any():
            break
        rot[bad] = _rotations(r, int(bad.sum()))
    else:
        raise RuntimeError("water_lattice: close contacts remain")
    mass = np.asarray(WATER_MASSES)[[0, 1, 1]].sum()
    vc = r.normal(0.0, np.sqrt(WATER_KT / mass), dims + (3,))
    vc -= vc.reshape(-1, 3).mean(0)
    v = np.broadcast_to(vc[..., None, :], x.shape)
    return x.reshape(-1, 3), np.ascontiguousarray(v).reshape(-1, 3)


def _water_topology(n_w: int, tree: bool = False):
    """(types, q, mol, bonds) of n_w waters in O, H, H order (`tree`: the
    O-H bonds alone)."""
    types = np.tile([0, 1, 1], n_w)
    q = np.tile([WATER_Q[0], WATER_Q[1], WATER_Q[1]], n_w)
    mol = np.repeat(np.arange(1, n_w + 1), 3)
    base = 3 * np.arange(n_w)[:, None] + 1
    pairs = np.asarray(WATER_TREE_BONDS if tree else WATER_BONDS)
    bonds = (base[:, None, :] + pairs[None]).reshape(-1, 2)
    return types, q, mol, bonds


def _water_base(box: Box, n_max: int, cap: int,
                rigid: bool = False) -> SceneConfig:
    """The water law, masses, bond exclusion, SHAKE table (from the
    template, WATER_SHAKE_ITERS sweeps) or with `rigid` rigid bodies in
    its place, dt, skin, thermostat and layout of a box."""
    return SceneConfig(
        shake=None if rigid else shake_table_from_templates(
            [water_template()], 2, iters=WATER_SHAKE_ITERS), rigid=rigid,
        box=box, masses=WATER_MASSES, pair=water_pair(), dt=WATER_DT,
        capacity=Capacity(n_max=n_max, cell_capacity=cap),
        bond=BondHarmonicParams(k=0.0, r0=WATER_OH),
        langevin=LangevinParams(temp=WATER_KT, damp=WATER_DAMP),
        skin=WATER_SKIN, force_path="cellpad")


def open_water_config(planes: int = WATER_PLANES, cap: int = WATER_CAP,
                      etarget: float = OPEN_WATER_ETARGET,
                      pxx: float = OPEN_WATER_PXX,
                      nbuf: float = OPEN_WATER_CENSUS,
                      n_max: Optional[int] = None, rigid: bool = False,
                      **obmd_kw) -> SceneConfig:
    """Path I, BASELINE.json config 5: SPC/E water in an open-x box of
    `planes` lattice planes (92: Lx 27.64 nm) x WATER_LYZ x WATER_LYZ nm
    (y and z periodic).

    The law: lj/cut/rf with rc_lj = rc_coul = 0.9 nm, eps_rf 78.5
    (water_pair).  bond_style zero's part is played by a harmonic bond of
    K = 0 (r0 0.1): it switches on the pair kernel's 1-2 exclusion over
    the bond columns (the JAX engine excludes only with a bond style,
    obmd_tpu/engine_cellpad.py:75-78), so all three intramolecular pairs
    are out of the pair law (SPC/E's special_bonds 0 0 0) and no bond
    force acts; SHAKE holds the three distances (the fix's `shake`, the
    table from the template: (0, 1) 0.1 and (1, 1) 0.163299).  dt 0.002
    ps, skin 0.1 nm (1.0 nm cells: 27 x 6 x 6, ~100 atoms a cell),
    Langevin at kT 2.4943 kJ/mol, damp 1 ps.

    The stage: buffers of 0.15 Lx at each end, also the insertion regions;
    degenerate shear regions, g_fac 0.25; alpha 0.7, tau = dt 0.005 /
    0.001464 (as _open_lj_config); MOLECULE-mode insertion of
    water_template() with mol_len 3, K = 8, `charged 1`, `shake`, and
    `vx`/`vy`/`vz` in +-WATER_V nm/ps; USHER with ds0 0.1 nm, dtheta0 0.1,
    uovlp 1e4, dsovlp 0.05, eps 1.0 and nattempt 40, a first setting in
    these units, kept: on the warmed box with a quarter of the buffers
    taken out 3 of 64 searches succeeded (water_probe.py on the H100),
    and as many with the LJ-unit overlap step converted to nm (dsovlp 1.5
    sigma, eps eps_OO sigma^12), so the overlap branch is not what holds
    the share down;
    etarget and the normal load pxx at the bulk state point, nbuf the
    warmed box's buffer census in molecules (OPEN_WATER_ETARGET,
    OPEN_WATER_PXX, OPEN_WATER_CENSUS).

    The filing cap: WATER_CAP = 150, above the most atoms the warmed state
    put in one cell (123, the comment at OPEN_WATER_ETARGET; the smoke
    reads it again, chip_smoke.max_cell_count) with room for the
    insertions and the density's fluctuations.  n_max: the start's
    atoms and 10% more.  `obmd_kw` replaces ObmdParams fields.

    With `rigid`, path K: rigid bodies in place of SHAKE on SceneConfig
    and ObmdParams, and the tree template (water_template(tree=True), O-H
    twice): the rigid integrator sums a body exactly only on a tree.  The
    K = 0 bond then excludes the two O-H pairs, and the H-H pair (0.163
    nm) is in the pair law: a central force inside one rigid body, so it
    adds no net force or torque to a water, but a constant to thermo's
    E_pair (its reaction-field energy per water).  observe.molecular_pxx
    stays consistent: its W and its f_a come from one list sweep, so the
    H-H pair enters both and cancels."""
    ax = 1.0 / (WATER_RHO * (WATER_LYZ / WATER_SITES) ** 2)
    lx = planes * ax
    b = 0.15 * lx
    r1 = RegionBlock((0.0, 0.0, 0.0), (b, WATER_LYZ, WATER_LYZ))
    r2 = RegionBlock((lx - b, 0.0, 0.0), (lx, WATER_LYZ, WATER_LYZ))
    deg = RegionBlock((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    v = (-WATER_V, WATER_V)
    args = dict(
        ntype=0, nfreq=1, seed=5, pxx=pxx, alpha=0.7,
        tau=WATER_DT * (0.005 / 0.001464), nbuf=float(nbuf),
        region1=r1, region2=r2, region3=deg, region4=deg, region5=r1,
        region6=r2, buffer_size=b, g_fac=0.25, maxattempt=1,
        usher=UsherParams(etarget=etarget, ds0=0.1, dtheta0=0.1,
                          uovlp=1.0e4, dsovlp=0.05, eps=1.0, nattempt=40),
        mol=water_template(tree=rigid), mol_len=3, insert_kmax=8,
        charged=True, shake=not rigid, rigid=rigid, vx=v, vy=v, vz=v)
    args.update(obmd_kw)
    n = 3 * planes * WATER_SITES ** 2
    box = Box((0.0, 0.0, 0.0), (lx, WATER_LYZ, WATER_LYZ),
              (False, True, True))
    return dataclasses.replace(
        _water_base(box, n_max or int(1.1 * n), cap, rigid=rigid),
        obmd=ObmdParams(**args)).finalize()


def open_water_scene(planes: int = WATER_PLANES, seed: int = 1987,
                     device="cuda", **cfg_kw) -> Scene:
    """Path I on `device`: water_lattice(planes) in open_water_config's
    box (92 planes: 33,212 waters, 99,636 atoms), O, H, H with the
    template's types and charges, one molecule id and three bonds a water
    (two with `rigid=True`, path K; `cfg_kw` passed on).  Warm it up with
    water_warm_up, then setup at the production cap."""
    cfg = open_water_config(planes=planes, **cfg_kw)
    x, v = water_lattice(planes, seed)
    types, q, mol, bonds = _water_topology(len(x) // 3, tree=cfg.rigid)
    return Scene(cfg=cfg, state=init_state(cfg, x, v=v, types=types, q=q,
                                           mol=mol, bonds=bonds,
                                           device=device))


def closed_water_scene(planes: int = WATER_CLOSED_PLANES, seed: int = 1987,
                       cap: int = WATER_CAP, device="cuda") -> Scene:
    """The bulk of path I for its state point: open_water_config's law,
    bonds, SHAKE table, dt, skin and thermostat in a periodic box of
    `planes` planes (20: 6.009 x 6 x 6 nm, 6 cells a side, 7,220 waters)
    at the same density."""
    ax = 1.0 / (WATER_RHO * (WATER_LYZ / WATER_SITES) ** 2)
    box = Box((0.0, 0.0, 0.0), (planes * ax, WATER_LYZ, WATER_LYZ),
              (True, True, True))
    x, v = water_lattice(planes, seed)
    n_w = len(x) // 3
    cfg = _water_base(box, len(x), cap).finalize()
    types, q, mol, bonds = _water_topology(n_w)
    return Scene(cfg=cfg, state=init_state(cfg, x, v=v, types=types, q=q,
                                           mol=mol, bonds=bonds,
                                           device=device))


def water_warm_up(cfg: SceneConfig, state: State,
                  steps: int = WATER_WARM_STEPS) -> State:
    """The lattice's melt: setup, then integrate.equilibrate for `steps`
    steps with thermo's T rescaled to WATER_THERMO_T every 25 steps (2/3
    of kT: thermo counts 9 degrees of freedom a water, SHAKE leaves 6),
    under the Langevin thermostat (and on an open box the stage)."""
    from .integrate import equilibrate, setup
    return equilibrate(cfg, setup(cfg, state), steps, temp=WATER_THERMO_T)


def rigid_water_start(cfg: SceneConfig, state: State, device=None) -> State:
    """Path K's state from a water state of path I (SHAKE, the triangle's
    bonds): its live atoms in tag order with their positions, velocities,
    types, charges and molecule ids, and each molecule's two O-H bonds
    (its atoms by tag: O, H, H) in place of three, in cfg's store on
    `device` (the state's when None).  SHAKE and RATTLE leave a water
    moving as a rigid body, so the velocities need no projection."""
    alive = state.alive
    order = torch.argsort(state.tag[alive])

    def host(t):
        return t[alive][order].cpu().numpy()
    tags, mol = host(state.tag), host(state.mol)
    if len(tags) % 3 or np.any(mol[0::3] != mol[2::3]) \
            or np.any(mol[0::3] != mol[1::3]):
        raise ValueError("rigid_water_start: the live atoms are not whole "
                         "waters in tag order")
    t3 = tags.reshape(-1, 3)
    bonds = np.stack([t3[:, list(b)] for b in WATER_TREE_BONDS],
                     1).reshape(-1, 2)
    return init_state(cfg, host(state.x), v=host(state.v),
                      types=host(state.type), tags=tags, q=host(state.q),
                      mol=mol, bonds=bonds,
                      device=state.device if device is None else device)


# validation/rigid_golden (validation/run_rigid_golden.py): 8 bent trimers
# free in a periodic 12^3 box under `pair_style dpd 0.0 1.0 12345`,
# `pair_coeff 1 1 8.0 2.0`, fix rigid/small molecule, dt 0.004, 40 steps,
# skin 0.3; the reference's positions after 40 steps in dump.ref, and in
# dump.rv those and the velocities of the same bodies under `pair_style
# zero` (in.r2)
RIGID_GOLDEN = dict(temp=0.0, cutoff=1.0, seed=12345, a0=8.0, gamma=2.0)
RIGID_GOLDEN_DT, RIGID_GOLDEN_STEPS = 0.004, 40


def rigid_golden_scene(device="cuda", force_path: str = "nlist",
                       free: bool = False, dtype: str = "float32") -> Scene:
    """validation/rigid_golden's trimers.data through the port's read_data
    (atom_style molecular: positions, velocities, molecule ids and the two
    bonds of each trimer) as a scene-level rigid body per molecule under
    RIGID_GOLDEN's DPD law (with `free`, a0 = gamma = 0: in.r2's pair_style
    zero), on `force_path`, in `dtype`.  No bond style: the pair law acts
    inside a body too, where its central forces cancel (the JAX run of
    run_rigid_golden.py does the same)."""
    from .io.lammps_data import read_data
    df = read_data(os.path.join(VALIDATION, "rigid_golden", "trimers.data"),
                   atom_style="molecular")
    law = dict(RIGID_GOLDEN, **(dict(a0=0.0, gamma=0.0) if free else {}))
    cfg = SceneConfig(
        box=df.box(periodic=(True, True, True)), masses=tuple(df.masses),
        pair=DPDParams.create(**law), dt=RIGID_GOLDEN_DT,
        capacity=Capacity(n_max=df.natoms, cell_capacity=24), rigid=True,
        skin=0.3, force_path=force_path, dtype=dtype).finalize()
    return Scene(cfg=cfg, state=init_state(
        cfg, df.x, v=df.v, types=df.types, tags=df.tags, mol=df.mol,
        bonds=df.bonds, device=device))


def golden_dump(folder: str, name: str) -> dict:
    """{atom id: row of floats} of the last frame of validation/<folder>'s
    dump `name` (columns after the id as the dump's ATOMS line lists
    them)."""
    with open(os.path.join(VALIDATION, folder, name)) as fh:
        lines = fh.read().splitlines()
    start = max(i for i, ln in enumerate(lines)
                if ln.startswith("ITEM: ATOMS"))
    rows = {}
    for line in lines[start + 1:]:
        t = line.split()
        if not t or t[0] == "ITEM:":
            break
        rows[int(t[0])] = np.asarray([float(v) for v in t[1:]])
    return rows


# The reference binary's bonded goldens (validation/run_bonded_golden.py,
# validation/run_improper_golden.py): each folder's data file, and its
# bonded styles' coefficients as the decks give them
VALIDATION = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir, "validation")
GOLDENS = {
    "bonded_golden": ("chains.data", dict(
        bond=(60.0, 0.8), angle=(25.0, 110.0), dihedral=(3.0, 1, 2))),
    "improper_golden": ("stars.data", dict(
        bond=(0.0, 0.9), improper=(12.5, 25.0))),
}


def golden_scene(folder: str, device="cuda", dtype: str = "float32") -> Scene:
    """A bonded golden's box through the data-file route: read
    validation/<folder>'s data file with read_data(atom_style="molecular"),
    derive the center tables from its sections, and stand DPD with a0 = 0
    and T = 0 in for `pair_style zero` (validation/run_bonded_golden.py
    :104-128): bonded_golden is 30 4-bead chains with harmonic bonds (K 60,
    r0 0.8), angles (K 25, theta0 110) and dihedrals (K 3, d 1, n 2);
    improper_golden 24 three-arm stars with zero-K bonds and impropers (K
    12.5, chi0 25) on a branched topology.  LAMMPS' forces are in the
    folder's dump.ref (golden_forces)."""
    from .config import DihedralHarmonicParams
    from .io.lammps_data import read_data
    name, coeffs = GOLDENS[folder]
    df = read_data(os.path.join(VALIDATION, folder, name),
                   atom_style="molecular")
    types = dict(zip(df.tags.tolist(), df.types.tolist()))
    kw = dict(bond=BondHarmonicParams(*coeffs["bond"]))
    if "angle" in coeffs:
        kw["angle"] = derive_center_angle_table(
            df.ntypes, df.angles, types, df.bonds, {1: coeffs["angle"]})
    if "dihedral" in coeffs:
        kw["dihedral"] = DihedralHarmonicParams(*coeffs["dihedral"])
    if "improper" in coeffs:
        kw.update(improper=derive_center_improper_table(
            df.ntypes, df.impropers, types, {1: coeffs["improper"]}),
            branched_topology=True)
    cfg = SceneConfig(
        box=df.box(periodic=(True, True, True)), masses=tuple(df.masses),
        pair=DPDParams.create(temp=0.0, cutoff=1.0, seed=1, a0=0.0,
                              gamma=0.0, ntypes=df.ntypes),
        dt=0.002, capacity=Capacity(n_max=df.natoms, cell_capacity=12),
        skin=0.3, dtype=dtype, **kw)
    return Scene(cfg=cfg, state=init_state(
        cfg, df.x, types=df.types, tags=df.tags, mol=df.mol, bonds=df.bonds,
        impropers=df.impropers, device=device))


def golden_forces(folder: str) -> dict:
    """LAMMPS' forces of a golden: {atom id: f [3]} from its dump.ref (one
    frame of `id fx fy fz`)."""
    return golden_dump(folder, "dump.ref")


# the reference binary's dpd/ext forces at T = 0 (validation/
# run_dpdext_golden.py: pair_style dpd/ext 0.0 1.4 48152, pair_coeff 1 1
# 18.0 4.0 2.5 0.8 1.3)
DPDEXT_GOLDEN = dict(temp=0.0, cutoff=1.4, seed=48152, a0=18.0, gamma=4.0,
                     gammaT=2.5, ws=0.8, wsT=1.3)


def dpdext_golden_scene(device="cuda", force_path: str = "nlist") -> Scene:
    """validation/dpdext_golden's box (300 atoms with velocities in a
    periodic 9^3 box) under its dpd/ext law, on `force_path`; LAMMPS'
    forces are in the folder's dump.ref (golden_forces)."""
    from .io.lammps_data import read_data
    df = read_data(os.path.join(VALIDATION, "dpdext_golden", "fluid.data"),
                   atom_style="atomic")
    cfg = SceneConfig(
        box=df.box(periodic=(True, True, True)), masses=tuple(df.masses),
        pair=DPDExtParams.create(**DPDEXT_GOLDEN), dt=0.002,
        capacity=Capacity(n_max=df.natoms, cell_capacity=12), skin=0.3,
        force_path=force_path).finalize()
    return Scene(cfg=cfg, state=init_state(cfg, df.x, v=df.v, types=df.types,
                                           tags=df.tags, device=device))
