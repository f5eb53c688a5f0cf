"""Energy minimization: `min_style fire` and `minimize etol ftol maxiter
maxeval` (min.cpp, min_fire.cpp).

The port's counterpart of the JAX package's FIRE minimizer, with its
constants, stopping criteria and `MinResult`: velocity-Verlet steps with
velocity-force mixing, an adaptive timestep and a dead stop on uphill
power, over the conservative force of the pair sweep and the bonded terms
(`integrate._extra_forces`) with zero velocities and a zero temperature.
Each iteration is a handful of tensor operations on the state's device and
one host read of the stop test: the force-infinity norm below `ftol`, or
the relative energy change below `etol`, or `maxiter` iterations.

One departure from the JAX package's minimizer: the drift moves no atom
further than DMAX in an iteration, as the reference's min_fire.cpp limits
it (`min_modify dmax`, 0.1 by default).  Without that limit FIRE's
timestep, grown to TMAX * dt, drives the LJ melt of bench/in.lj into
overlaps whose forces overflow to NaN (258 iterations on the card), and a
NaN force stops the loop as if it had converged.  Where no atom would
move further than DMAX the two minimizers take the same steps.
"""
from __future__ import annotations

import dataclasses

import torch

from .cells import build_cells
from .config import SceneConfig
from .forces.pairs import pair_sweep
from .integrate import _extra_forces, make_grid_spec
from .state import State, per_atom_mass

# FIRE parameters (min_fire.cpp defaults)
DELAYSTEP = 5
DT_GROW = 1.1
DT_SHRINK = 0.5
ALPHA0 = 0.1
ALPHA_SHRINK = 0.99
TMAX = 10.0   # dt ceiling = TMAX * dt0
# the largest distance an atom moves in one iteration (min.cpp's default
# `min_modify dmax 0.1`, applied as min_fire.cpp limits the drift's dt)
DMAX = 0.1


@dataclasses.dataclass
class MinResult:
    state: State
    iters: int
    fmax: float
    energy: float
    converged: bool


def _force_energy_fn(cfg: SceneConfig):
    """state -> (f, pe_total) on the scene's force machinery."""
    spec = make_grid_spec(cfg)
    # conservative-only pair law: zero velocities kill the drag and a
    # zero-temperature copy kills the random force (sigma = sqrt(2 T g))
    pair = cfg.pair
    if hasattr(pair, "temp"):
        pair = dataclasses.replace(pair, temp=0.0)
    cfg_c = dataclasses.replace(cfg, pair=pair, langevin=None)

    def fe(state: State):
        ctab = build_cells(spec, state.x, state.alive)
        pf = pair_sweep(cfg_c.pair, cfg.box, spec, ctab, state.x,
                        torch.zeros_like(state.v), state.type, state.tag, 0,
                        dt=cfg.dt, q=state.q, compute_energy=True)
        f = _extra_forces(cfg_c, state, pf.f)
        f = torch.where(state.alive[:, None], f, 0.0)
        pe = torch.where(state.alive, pf.pe, 0.0).sum()
        return f, pe

    return fe


def minimize(cfg: SceneConfig, state: State, *, ftol: float = 1e-6,
             etol: float = 0.0, maxiter: int = 1000) -> MinResult:
    """FIRE minimization of the conservative energy (the pair law's
    conservative part and the bonded terms; DPD drag and noise and the
    boundary force do not enter a potential).  An OBMD scene raises
    ValueError."""
    cfg = cfg.finalize()
    if cfg.obmd is not None:
        raise ValueError("minimize: open-boundary stages do not define a "
                         "potential; minimize the closed scene")
    fe = _force_energy_fn(cfg)
    m = per_atom_mass(cfg, state)[:, None]
    a3 = state.alive[:, None]

    def scalar(v):
        return torch.full((), v, dtype=state.dtype, device=state.device)
    dt0 = scalar(cfg.dt)
    dt_max = TMAX * dt0
    st = state
    v = torch.zeros_like(state.v)
    f, pe = fe(st)
    pe_prev = pe + 1.0
    dt, alpha = dt0, scalar(ALPHA0)
    n_pos = torch.zeros((), dtype=torch.int32, device=state.device)
    it = 0
    while it < maxiter:
        not_conv = f.abs().max() > ftol
        if etol > 0.0:
            enorm = pe.abs() + pe_prev.abs() + 1e-30
            not_conv = not_conv & ((pe - pe_prev).abs() > etol * 0.5 * enorm)
        if not bool(not_conv):
            break
        # velocity-Verlet with FIRE mixing (min_fire.cpp iterate())
        v = torch.where(a3, v + dt * f / m, 0.0)
        power = (v * f).sum()
        fnorm = torch.sqrt((f * f).sum()) + 1e-30
        vnorm = torch.sqrt((v * v).sum())
        v_mix = (1.0 - alpha) * v + alpha * (f / fnorm) * vnorm
        uphill = power <= 0.0
        v = torch.where(uphill, torch.zeros_like(v), v_mix)
        grow = ~uphill & (n_pos > DELAYSTEP)
        dt = torch.where(grow, torch.minimum(dt * DT_GROW, dt_max),
                         torch.where(uphill, dt * DT_SHRINK, dt))
        alpha = torch.where(grow, alpha * ALPHA_SHRINK,
                            torch.where(uphill, scalar(ALPHA0), alpha))
        n_pos = torch.where(uphill, torch.zeros_like(n_pos), n_pos + 1)
        vmax = v.abs().max()
        dtv = torch.where(dt * vmax > DMAX, DMAX / vmax, dt)
        st = st.replace(x=cfg.box.wrap(torch.where(a3, st.x + dtv * v,
                                                   st.x)))
        pe_prev = pe
        f, pe = fe(st)
        it += 1
    fmax = float(f.abs().max())
    return MinResult(state=st.replace(f=f, v=torch.zeros_like(st.v)),
                     iters=it, fmax=fmax, energy=float(pe),
                     converged=bool(fmax <= ftol or it < maxiter))
