"""Rigid-body integration of molecules: the fix obmd `rigid` keyword
(fix_obmd_merged.cpp:475-500, 1163-1168: inserted molecules are handed to a
rigid fix) and the scene-level `SceneConfig.rigid` (fix rigid/small
molecule).

Counterpart of `obmd_tpu/rigid.py`, with its names and its scheme: no
persistent per-body state; every half step recomputes each body's mass,
centre of mass, momentum, angular momentum and inertia by directed message
passing over the bond-partner slot columns (the construction of
`adress.update_mol_com`), a 17-channel payload carried in the RECEIVER's
frame (each edge shifts the moment sums by the minimum-imaged partner
displacement, so a body across a periodic face sums alike).  The sums are
exact on trees whose diameter is at most `_rounds(cfg)`; on a cycle every
atom reads a different, wrong body (on SPC/E's triangle each H counts the
body twice), so `check_bodies` refuses such a state at setup and
`config.ObmdParams` a cyclic template, where the JAX package runs them.

Velocity-Verlet split: after the first half kick `rigid_drift` moves the
centre of mass and turns the body by the exact Rodrigues rotation
R(omega dt), the angular momentum L carried through the rotation
(omega' = (R I R^T)^-1 L); one departure from the JAX package: omega is
the half-step orientation's, not the start's (`rigid_kinematics`), since
a turn about the start's omega heats every asymmetric body at second
order in dt; after the second half kick `rigid_project`
puts member velocities back on the rigid field V + omega x r.  omega
solves I omega = L by a cofactor solve with a small diagonal regularizer
(a linear body's I is singular along its axis, where L has no part).

Every product is an explicit elementwise operation in the state's dtype
(float32, or float64 as the JAX package runs rigid bodies under x64):
R I R^T is written out entry by entry, so no batched matrix product
(which the H100 may run in TF32 under the caller's flags) enters the step.
"""
from __future__ import annotations

import torch

from .config import SceneConfig
from .geometry import rounded
from .state import State, per_atom_mass


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=1)


def _shift(msg, s):
    """Re-express a moment payload in a frame displaced by s (receiver =
    sender position + s): delta' = delta + s.

    Channels: [0] W = sum m, [1:4] S = sum m delta, [4:7] P = sum m v,
    [7:10] J = sum m delta x v, [10] Q2 = sum m |delta|^2,
    [11:17] T = sum m delta delta^T (xx, yy, zz, xy, xz, yz)."""
    W = msg[:, 0:1]
    S = msg[:, 1:4]
    P = msg[:, 4:7]
    J = msg[:, 7:10]
    Q2 = msg[:, 10:11]
    T = msg[:, 11:17]
    S2 = S + W * s
    J2 = J + _cross(s, P)
    Q22 = Q2 + 2.0 * (s * S).sum(1, keepdim=True) \
        + W * (s * s).sum(1, keepdim=True)
    sx, sy, sz = s[:, 0:1], s[:, 1:2], s[:, 2:3]
    Sx, Sy, Sz = S[:, 0:1], S[:, 1:2], S[:, 2:3]
    T2 = torch.cat([
        T[:, 0:1] + 2.0 * sx * Sx + W * sx * sx,
        T[:, 1:2] + 2.0 * sy * Sy + W * sy * sy,
        T[:, 2:3] + 2.0 * sz * Sz + W * sz * sz,
        T[:, 3:4] + sx * Sy + sy * Sx + W * sx * sy,
        T[:, 4:5] + sx * Sz + sz * Sx + W * sx * sz,
        T[:, 5:6] + sy * Sz + sz * Sy + W * sy * sz,
    ], dim=1)
    return torch.cat([W, S2, P, J2, Q22, T2], dim=1)


def _passes(a, cols, member, rounds: int, edge):
    """Directed message passing of the per-atom payload a [N, C] over the
    partner columns: after `rounds` rounds, each member atom's own payload
    plus every partner's message toward it.  edge(msg, p, ps) turns a
    message from partner p (clamped ps) into the receiver's frame."""
    n = a.shape[0]
    cols = tuple(c.long() for c in cols)
    ps_all = tuple(torch.where(member, c, -1) for c in cols)
    me = torch.arange(n, device=a.device)

    def incoming(msgs, p):
        ps = torch.clamp(p, 0, n - 1)
        from_p = torch.zeros_like(a)
        for k in range(len(cols)):
            toward_me = (cols[k][ps] == me)[:, None]
            from_p = torch.where(toward_me, msgs[k][ps], from_p)
        return torch.where((p >= 0)[:, None], edge(from_p, p, ps), 0)

    msgs = [torch.zeros_like(a) for _ in cols]
    for _ in range(rounds):
        ins = [incoming(msgs, p) for p in ps_all]
        msgs = [a + sum(ins[j] for j in range(len(cols)) if j != k)
                for k in range(len(cols))]
    return a + sum(incoming(msgs, p) for p in ps_all)


def body_moments(box, x, v, mass, bond1, bond2, member, rounds: int,
                 more_partners=()):
    """Per-atom body moments in each atom's own frame, from raw arrays
    (bond1/bond2 [+ more_partners on a branched topology] are partner ROW
    indices, -1 = none).  Returns (M [N,1], rbar [N,3] = COM - x_me,
    V [N,3], L [N,3] about the COM, I [N,6] about the COM)."""
    n = x.shape[0]
    m = torch.where(member, mass, 0.0)
    zeros3 = torch.zeros_like(x)
    a = torch.cat([m[:, None], zeros3, m[:, None] * v, zeros3,
                   torch.zeros((n, 7), dtype=x.dtype, device=x.device)],
                  dim=1)                                      # [N, 17]

    def edge(msg, p, ps):
        s = box.min_image(torch.where((p >= 0)[:, None], x[ps] - x, 0.0))
        return _shift(msg, s)

    tot = _passes(a, (bond1, bond2) + tuple(more_partners), member, rounds,
                  edge)
    return _moments_from_total(tot)


def _moments_from_total(tot):
    M = torch.clamp(tot[:, 0:1], min=1e-30)
    rbar = tot[:, 1:4] / M
    V = tot[:, 4:7] / M
    J = tot[:, 7:10]
    Q2 = tot[:, 10:11]
    T = tot[:, 11:17]
    L = J - _cross(rbar, M * V)
    # I_com = (Q2 E - T) - M (|rbar|^2 E - rbar rbar^T)
    rb2 = (rbar * rbar).sum(1, keepdim=True)
    d = Q2 - M * rb2
    Ixx = d + (-T[:, 0:1] + M * rbar[:, 0:1] ** 2)
    Iyy = d + (-T[:, 1:2] + M * rbar[:, 1:2] ** 2)
    Izz = d + (-T[:, 2:3] + M * rbar[:, 2:3] ** 2)
    Ixy = -T[:, 3:4] + M * rbar[:, 0:1] * rbar[:, 1:2]
    Ixz = -T[:, 4:5] + M * rbar[:, 0:1] * rbar[:, 2:3]
    Iyz = -T[:, 5:6] + M * rbar[:, 1:2] * rbar[:, 2:3]
    I6 = torch.cat([Ixx, Iyy, Izz, Ixy, Ixz, Iyz], dim=1)
    return M, rbar, V, L, I6


def _body_sums(cfg: SceneConfig, state: State, v, member, rounds: int):
    """State-level wrapper over body_moments (partner SLOT columns)."""
    return body_moments(cfg.box, state.x, v, per_atom_mass(cfg, state),
                        state.bond1, state.bond2, member, rounds,
                        more_partners=state.bond_partners[2:])


def rigid_kinematics(box, x, v, mass, bond1, bond2, member, rounds, dt,
                     more_partners=()):
    """One rigid drift's kinematics from raw arrays: (x_rigid, v_rigid)
    for member rows (garbage elsewhere: mask with `member`).  The body
    turns about the angular velocity of its half-step orientation,
    omega = (R(omega0 dt/2) I R^T)^-1 L, a midpoint rule.  (The JAX
    package turns it about omega0 = I^-1 L, which raises a free body's
    kinetic energy by dt^2/2 (omega0 x L) . I^-1 (omega0 x L) every step:
    SPC/E water at dt 2 fs heats under it, tests/test_torch_rigid.py.)"""
    M, rbar, V, L, I6 = body_moments(box, x, v, mass, bond1, bond2,
                                     member, rounds,
                                     more_partners=more_partners)
    omega = _solve_omega(I6, L)
    omega = _solve_omega(_rotate_inertia(I6, omega, 0.5 * dt), L)
    r_new = _rotate(-rbar, omega, dt)            # my offset from the COM
    x_rigid = x + rbar + dt * V + r_new          # X' + R r
    I6_new = _rotate_inertia(I6, omega, dt)
    omega_new = _solve_omega(I6_new, L)          # L conserved through R
    v_rigid = V + _cross(omega_new, r_new)
    return x_rigid, v_rigid


def _solve_omega(I6, L):
    """omega from I omega = L, the symmetric 3x3 cofactor solve with a
    diagonal regularizer."""
    eps = 1e-6 * torch.clamp(I6[:, 0] + I6[:, 1] + I6[:, 2], min=1e-6)
    a = I6[:, 0] + eps
    b = I6[:, 1] + eps
    c = I6[:, 2] + eps
    d, e, f = I6[:, 3], I6[:, 4], I6[:, 5]   # xy, xz, yz
    # adjugate of [[a, d, e], [d, b, f], [e, f, c]]
    A00 = b * c - f * f
    A01 = e * f - d * c
    A02 = d * f - b * e
    A11 = a * c - e * e
    A12 = d * e - a * f
    A22 = a * b - d * d
    det = a * A00 + d * A01 + e * A02
    det = torch.where(det.abs() > 1e-30, det, 1e-30)
    lx, ly, lz = L[:, 0], L[:, 1], L[:, 2]
    wx = (A00 * lx + A01 * ly + A02 * lz) / det
    wy = (A01 * lx + A11 * ly + A12 * lz) / det
    wz = (A02 * lx + A12 * ly + A22 * lz) / det
    return torch.stack([wx, wy, wz], dim=1)


def _rotate(r, omega, dt):
    """Exact Rodrigues rotation of r by the angle |omega| dt about
    omega."""
    th = torch.linalg.vector_norm(omega, dim=1, keepdim=True) * dt
    small = th < 1e-8
    k = omega * dt / torch.clamp(th, min=1e-30)
    cos = torch.cos(th)
    sin = torch.sin(th)
    rot = (r * cos + _cross(k, r) * sin
           + k * (k * r).sum(1, keepdim=True) * (1.0 - cos))
    return torch.where(small, r, rot)


def _rounds(cfg: SceneConfig) -> int:
    """Message-passing rounds: a template's natoms - 1, else 2."""
    n = cfg.obmd.mol_natoms_max if cfg.obmd is not None else 0
    return max(1, (n - 1) if n else 2)


def _member(cfg: SceneConfig, state: State):
    return state.alive & (state.mol != 0)


def _rotate_inertia(I6, omega, dt):
    """I' = R I R^T for the Rodrigues rotation R(omega dt), per row, each
    entry an explicit sum of products in I6's dtype."""
    th = torch.linalg.vector_norm(omega, dim=1, keepdim=True) * dt
    k = omega * dt / torch.clamp(th, min=1e-30)
    small = (th < 1e-8)[:, 0]
    cos = torch.cos(th)[:, 0]
    sin = torch.sin(th)[:, 0]
    kx, ky, kz = k[:, 0], k[:, 1], k[:, 2]
    one_c = 1.0 - cos
    R = ((cos + kx * kx * one_c, kx * ky * one_c - kz * sin,
          kx * kz * one_c + ky * sin),
         (ky * kx * one_c + kz * sin, cos + ky * ky * one_c,
          ky * kz * one_c - kx * sin),
         (kz * kx * one_c - ky * sin, kz * ky * one_c + kx * sin,
          cos + kz * kz * one_c))
    Im = ((I6[:, 0], I6[:, 3], I6[:, 4]),
          (I6[:, 3], I6[:, 1], I6[:, 5]),
          (I6[:, 4], I6[:, 5], I6[:, 2]))
    RI = [[R[a][0] * Im[0][c] + R[a][1] * Im[1][c] + R[a][2] * Im[2][c]
           for c in range(3)] for a in range(3)]

    def entry(a, c):
        return RI[a][0] * R[c][0] + RI[a][1] * R[c][1] + RI[a][2] * R[c][2]
    out = torch.stack([entry(0, 0), entry(1, 1), entry(2, 2), entry(0, 1),
                       entry(0, 2), entry(1, 2)], dim=-1)
    return torch.where(small[:, None], I6, out)


def rigid_drift(cfg: SceneConfig, state: State, v):
    """The initial_integrate drift with rigid members moved as bodies; `v`
    is the half-kicked velocity.  Returns (x_new, v_new), wrapped.  The
    angular momentum L is carried through the rotation: the new velocity
    field uses omega' = (R I R^T)^-1 L.  dt is rounded to the state's
    dtype (obmd_tpu/rigid.py:238)."""
    dt = rounded(cfg.dt, state.dtype)
    member = _member(cfg, state)
    x_rigid, v_rigid = rigid_kinematics(
        cfg.box, state.x, v, per_atom_mass(cfg, state), state.bond1,
        state.bond2, member, _rounds(cfg), dt,
        more_partners=state.bond_partners[2:])
    a3 = state.alive[:, None]
    mem3 = member[:, None]
    x = torch.where(mem3, x_rigid,
                    torch.where(a3, state.x + dt * v, state.x))
    vout = torch.where(mem3, v_rigid, v)
    return cfg.box.wrap(x), vout


def rigid_project(cfg: SceneConfig, state: State, v):
    """The final_integrate velocity projection: members get the rigid
    field v = V + omega x (x - X)."""
    member = _member(cfg, state)
    M, rbar, V, L, I6 = _body_sums(cfg, state, v, member, _rounds(cfg))
    omega = _solve_omega(I6, L)
    v_rigid = V + _cross(omega, -rbar)
    return torch.where(member[:, None], v_rigid, v)


def body_census(cfg: SceneConfig, state: State, rounds: int):
    """(trees [N] bool, atoms [N] i64) of the member atoms by an integer
    message pass of (1, degree) over `rounds` rounds: an atom's count of
    atoms and sum of degrees within reach.  A body around an atom is a tree
    whose farthest atom lies within `rounds` bonds exactly when the degree
    sum is twice the count less one: a cycle, or an atom beyond, leaves a
    frontier atom whose degree outruns the bonds counted to it."""
    member = _member(cfg, state)
    cols = state.bond_partners
    deg = sum((member & (c >= 0)).long() for c in cols)
    a = torch.stack([member.long(), torch.where(member, deg, 0)], dim=1)
    tot = _passes(a, cols, member, rounds, lambda msg, p, ps: msg)
    return (~member) | (tot[:, 1] == 2 * (tot[:, 0] - 1)), tot[:, 0]


def _labels(member, cols):
    """Each member atom's body as the least slot reachable over the bond
    columns (min-label propagation to its fixed point; n elsewhere)."""
    n = member.shape[0]
    lab = torch.where(member, torch.arange(n, device=member.device), n)
    while True:
        new = lab
        for c in cols:
            ok = member & (c >= 0)
            j = torch.clamp(c.long(), 0, n - 1)
            new = torch.minimum(new, torch.where(ok & member[j], lab[j], n))
        if torch.equal(new, lab):
            return lab
        lab = new


def check_bodies(cfg: SceneConfig, state: State) -> None:
    """Refuse a rigid scene whose bodies the message passing cannot sum:
    a body (a connected set of member atoms over the bond columns) with a
    cycle, or one whose diameter exceeds `_rounds(cfg)`.  The JAX package
    runs both and integrates wrong bodies.  Host-side, once at setup."""
    rounds = _rounds(cfg)
    ok, _ = body_census(cfg, state, rounds)
    if bool(ok.all()):
        return
    member = _member(cfg, state)
    cols = state.bond_partners
    n = member.shape[0]
    lab = _labels(member, cols)
    atoms = torch.bincount(lab[member], minlength=n)
    ends = torch.zeros((n,), dtype=torch.long, device=member.device)
    for c in cols:
        j = torch.clamp(c.long(), 0, n - 1)
        has = member & (c >= 0) & member[j]
        ends = ends + torch.bincount(lab[has], minlength=n)
    cyclic = ends > 2 * (atoms - 1)       # each bond seen from both ends
    bad = torch.nonzero(~ok).flatten()
    on_cycle = bad[cyclic[lab[bad]]]
    if on_cycle.numel():
        raise ValueError(
            f"rigid: the body of atom {int(state.tag[on_cycle[0]])} has a "
            f"cycle in its bonds; the message passing sums a body exactly "
            f"only on a tree (give the molecule a spanning tree of bonds, "
            f"e.g. O-H twice for water)")
    raise ValueError(
        f"rigid: the body of atom {int(state.tag[bad[0]])} spans more than "
        f"{rounds} bonds (the message passing's rounds: a template's atoms "
        f"less one, else 2)")
