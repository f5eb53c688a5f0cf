"""SHAKE/RATTLE distance constraints over the bond columns.

Counterpart of `obmd_tpu/shake.py` (the fix obmd `shake` keyword,
fix_obmd_merged.cpp:1163-1168, and RIGID/fix_shake.cpp): `shake_positions`
after the drift, `rattle_velocities` after the second half kick, and
`constraint_error`.  The constraints live on the per-atom bond-partner
columns: a bonded pair (i, j) whose types have d0[ti, tj] > 0 in the
`ShakeParams` table is held at that distance.  The reference's array code
runs as PyTorch operations here too (no TPU kernel stands behind it), in
the JAX function's order: fixed numbers of Jacobi sweeps over the partner
columns, each atom computing its own correction from both ends of each of
its constraints (no scatter), per constraint (i, j) and sweep

    g = (d0^2 - |r|^2) / (2 (1/m_i + 1/m_j) <r_ref, r>),   x_i += g/m_i r_ref

with r_ref the pre-drift bond (Ryckaert's scheme), and the velocity sweeps
mu = <v_i - v_j, r> / ((1/m_i + 1/m_j) |r|^2), v_i -= mu/m_i r.

In float32 the corrections are accumulated at their own magnitude
(dx_acc, dv_acc) and added to x and v once: rounding each sweep through a
position of ~|x| would leak about ulp(x)/dt of momentum per step, where
the separate sum keeps m_i dx_i + m_j dx_j = 0.  The denominator's floor
keeps its sign (fix_shake.cpp's determinant guard).  The d0 table and dt
take the positions' dtype, float32 or float64, as JAX's do.
"""
from __future__ import annotations

import torch

from .config import SceneConfig
from .geometry import const, rounded

EPS = 1.0e-12


def _d0_table(cfg: SceneConfig, dtype, device) -> torch.Tensor:
    """The d0 table in the positions' dtype (obmd_tpu/shake.py:39-40)."""
    nt = len(cfg.shake.d0)
    return const(tuple(float(v) for row in cfg.shake.d0 for v in row),
                 dtype, device).reshape(nt, nt)


def _columns(cfg: SceneConfig, type_, alive, partners, dtype):
    """Per partner column (clamped partner index, has [N] bool, d0 [N] in
    `dtype`): has marks a live atom whose live partner's type pair is
    constrained."""
    n = type_.shape[0]
    d0t = _d0_table(cfg, dtype, alive.device)
    nt = d0t.shape[0]
    ti = torch.clamp(type_.long(), 0, nt - 1)
    out = []
    for partner in partners:
        j = torch.clamp(partner.long(), 0, n - 1)
        d0 = d0t[ti, torch.clamp(type_[j].long(), 0, nt - 1)]
        has = alive & (partner >= 0) & alive[j] & (d0 > 0)
        out.append((j, has, d0))
    return out


def _bond(box, x, j, has):
    """x_i - x_j with the minimum image, 0 where not `has`."""
    return torch.where(has[:, None], box.min_image(x - x[j]), 0.0)


def shake_positions(cfg: SceneConfig, x_ref, x, v, type_, bond1, bond2,
                    alive, invm, more_partners=()):
    """Constrain post-drift positions x [N, 3]; returns (x, v), the
    displacement also added to v as dx / dt (the velocity-Verlet SHAKE
    splitting).  x_ref: the pre-drift positions, along whose bonds the
    constraint gradient is taken; invm [N]: 1 / mass."""
    box = cfg.box
    n = x.shape[0]
    eps = EPS
    cols = []
    for j, has, d0 in _columns(cfg, type_, alive,
                               (bond1, bond2) + tuple(more_partners),
                               x.dtype):
        rref = _bond(box, x_ref, j, has)
        two_winv = 2.0 * torch.where(has, invm + invm[j], 1.0)
        cols.append((j, has, d0 * d0, rref, two_winv))
    dx_acc = torch.zeros((n, 3), dtype=x.dtype, device=x.device)
    for _ in range(cfg.shake.iters):
        x_cur = x + dx_acc
        dx = None
        for j, has, d0sq, rref, two_winv in cols:
            r = box.min_image(x_cur - x_cur[j])
            diff = d0sq - (r * r).sum(-1)
            denom = two_winv * (rref * r).sum(-1)
            denom = torch.where(denom.abs() < eps,
                                torch.where(denom < 0, -eps, eps), denom)
            g = torch.where(has, diff / denom, 0.0)
            term = (g * invm)[:, None] * rref
            dx = term if dx is None else dx + term
        dx_acc = dx_acc + dx
    dt = const((rounded(cfg.dt, x.dtype),), x.dtype, x.device)[0]
    return box.wrap(x + dx_acc), v + dx_acc / dt


def rattle_velocities(cfg: SceneConfig, x, v, type_, bond1, bond2, alive,
                      invm, more_partners=()):
    """Project each constrained pair's relative velocity out of its bond
    (RATTLE's velocity stage): after the sweeps <v_i - v_j, r_ij> = 0."""
    box = cfg.box
    cols = []
    for j, has, _ in _columns(cfg, type_, alive,
                              (bond1, bond2) + tuple(more_partners),
                              v.dtype):
        r = _bond(box, x, j, has)
        rsq = torch.clamp((r * r).sum(-1), min=EPS)
        winv = torch.where(has, invm + invm[j], 1.0)
        cols.append((j, has, r, winv * rsq))
    dv_acc = torch.zeros_like(v)
    for _ in range(cfg.shake.vel_iters):
        v_cur = v + dv_acc
        dv = None
        for j, has, r, den in cols:
            mu = torch.where(has, ((v_cur - v_cur[j]) * r).sum(-1) / den,
                             0.0)
            term = -(mu * invm)[:, None] * r
            dv = term if dv is None else dv + term
        dv_acc = dv_acc + dv
    return v + dv_acc


def constraint_error(cfg: SceneConfig, state) -> torch.Tensor:
    """max |r - d0| over the live constraints (0 when there are none)."""
    err = torch.zeros((), dtype=state.x.dtype, device=state.x.device)
    for j, has, d0 in _columns(cfg, state.type, state.alive,
                               state.bond_partners, state.x.dtype):
        r = state.x - state.x[j]
        d = torch.sqrt(torch.clamp((cfg.box.min_image(r) ** 2).sum(-1),
                                   min=EPS))
        err = torch.maximum(err, torch.where(has, (d - d0).abs(), 0.0).max())
    return err
