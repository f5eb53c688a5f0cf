"""The ported scenes: OBMD_DPD (examples/OBMD_DPD/input.py:17-124) and the
LJ melt (the reference's code/bench/in.lj).

Counterpart of `obmd_tpu/scenes.py` `obmd_dpd_config`, `obmd_dpd_scene` and
`lj_melt_scene`.  OBMD_DPD: DPD fluid at rho = 3, T = 1 with open x
boundaries, constant normal load pxx on both buffers and USHER insertion;
`scale` stretches the box in x (scale 9 is the ~107k-atom bench size).  LJ
melt: an fcc lattice in a fully periodic box, NVE.  Initial states are drawn
with the same numpy generators as the reference, so both packages start from
the same positions and velocities.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .config import (Capacity, DPDParams, LJCutParams, ObmdParams,
                     SceneConfig, UsherParams)
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
        capacity=Capacity(n_max=n_max, cell_capacity=cell_capacity),
        obmd=obmd, dtype=dtype, force_path=force_path, skin=skin,
    ).finalize()


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
    basis = np.asarray([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                        [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(np.arange(nx), np.arange(nx),
                                 np.arange(nx), indexing="ij"),
                     axis=-1).reshape(-1, 1, 3)
    x = ((cells + basis[None, :, :]) * a).reshape(-1, 3)
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
