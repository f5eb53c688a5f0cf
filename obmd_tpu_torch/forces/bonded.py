"""Bonded forces and the Langevin thermostat fix.

Counterpart of `obmd_tpu/forces/bonded.py`: FENE bonds (bond_fene.cpp, the
reference's bench/in.chain), harmonic bonds (bond_harmonic.cpp), angles
(angle_harmonic.cpp), dihedrals (dihedral_harmonic.cpp) and impropers
(improper_harmonic.cpp), each evaluated from the per-atom partner SLOT
columns (two, or four on a branched topology) and the per-center improper
triplet: every atom sums its own share of each term it takes part in, once
per role (end or center), reaching the other atoms through its partners'
own columns, so there is no scatter-add.  A bond's energy is split half to
each end; an angle's and an improper's sit on the center; a dihedral's
half on each of its two center atoms.  An over-stretched FENE bond (r >=
r0) is clamped to the reference's guard value (rlogarg = 0.1) without an
error; `observe.bond_stats` counts such bonds.  The dihedral force is the
gradient of its energy (torch.autograd, as the JAX package's autodiff),
on linear chains only.

Langevin (fix_langevin.cpp):

    f += -(m/damp) v + sqrt(24 kB T m / (dt damp)) * uniform(-0.5, 0.5)

with counter-based deviates per (atom tag, axis, step), bit for bit the
reference's `rng.hash3` / `uniform01` stream.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import rng
from ..config import (BondFENEParams, BondHarmonicParams, LangevinParams,
                      SceneConfig)
from ..geometry import Box, const_like
from ..state import per_atom_mass

PURPOSE_LANGEVIN = 3
TWO_1_3 = 2.0 ** (1.0 / 3.0)


def _rows(x, j):
    """x[j] with j clamped into range (rows of an absent partner are
    masked by the caller)."""
    return x[torch.clamp(j.long(), 0, x.shape[0] - 1)]


def fene_forces(bond: BondFENEParams, box: Box, x, bond1, bond2, alive,
                compute_energy: bool = False, more_partners=()):
    """Force on every atom from its (up to four) FENE bonds, and with
    compute_energy its per-atom half share of each bond's energy.

    bond_fene.cpp: fbond = -k / (1 - r^2/r0^2) (+ WCA inside 2^(1/6)
    sigma), F_i = fbond * (x_i - x_j); rlogarg = 1 - r^2/r0^2 is clamped
    at 0.1 (the reference's "bad FENE bond" guard)."""
    n = x.shape[0]
    r0sq = bond.r0 * bond.r0
    sig2 = bond.sigma * bond.sigma
    f = torch.zeros_like(x)
    e = torch.zeros_like(x[:, 0]) if compute_energy else None
    for partner in (bond1, bond2) + tuple(more_partners):
        j = torch.clamp(partner.long(), 0, n - 1)
        ok = alive & (partner >= 0) & alive[j]
        d = box.min_image(x - x[j])
        rsq = (d * d).sum(-1)
        rlogarg = torch.clamp(1.0 - rsq / r0sq, min=0.1)
        fbond = -bond.k / rlogarg
        sr2 = torch.where(ok, sig2 / torch.clamp(rsq, min=1e-12), 0.0)
        sr6 = sr2 * sr2 * sr2
        wca = rsq < TWO_1_3 * sig2
        fbond = fbond + torch.where(
            wca, 48.0 * bond.epsilon * sr6 * (sr6 - 0.5)
            / torch.clamp(rsq, min=1e-12), 0.0)
        f = f + torch.where(ok, fbond, 0.0)[:, None] * d
        if compute_energy:
            eb = -0.5 * bond.k * r0sq * torch.log(rlogarg)
            eb = eb + torch.where(
                wca, 4.0 * bond.epsilon * sr6 * (sr6 - 1.0) + bond.epsilon,
                0.0)
            e = e + torch.where(ok, 0.5 * eb, 0.0)
    return f, e


def harmonic_bond_forces(bond: BondHarmonicParams, box: Box, x, bond1, bond2,
                         alive, compute_energy: bool = False,
                         more_partners=()):
    """Force on every atom from its (up to four) harmonic bonds, and with
    compute_energy its half share of each bond's energy.

    bond_harmonic.cpp: E = K (r - r0)^2, fbond = -2 K (r - r0) / r,
    F_i = fbond * (x_i - x_j)."""
    f = torch.zeros_like(x)
    e = torch.zeros_like(x[:, 0]) if compute_energy else None
    n = x.shape[0]
    for partner in (bond1, bond2) + tuple(more_partners):
        j = torch.clamp(partner.long(), 0, n - 1)
        has = alive & (partner >= 0) & alive[j]
        d = box.min_image(x - x[j])
        r = torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-12))
        dr = r - bond.r0
        f = f + torch.where(has, -2.0 * bond.k * dr / r, 0.0)[:, None] * d
        if compute_energy:
            e = e + torch.where(has, 0.5 * bond.k * dr * dr, 0.0)
    return f, e


def bond_pair_fvec(bond, rsq, d):
    """The bond force on atom i for the displacement d = x_i - x_j (any
    leading shape) and its squared length rsq."""
    if isinstance(bond, BondHarmonicParams):
        r = torch.sqrt(torch.clamp(rsq, min=1e-12))
        return (-2.0 * bond.k * (r - bond.r0) / r)[..., None] * d
    if isinstance(bond, BondFENEParams):
        r0sq = bond.r0 * bond.r0
        sig2 = bond.sigma * bond.sigma
        fbond = -bond.k / torch.clamp(1.0 - rsq / r0sq, min=0.1)
        sr2 = sig2 / torch.clamp(rsq, min=1e-12)
        sr6 = sr2 * sr2 * sr2
        fbond = fbond + torch.where(
            rsq < TWO_1_3 * sig2, 48.0 * bond.epsilon * sr6 * (sr6 - 0.5)
            / torch.clamp(rsq, min=1e-12), 0.0)
        return fbond[..., None] * d
    raise NotImplementedError(
        f"bond style {type(bond).__name__} is not ported")


def bond_forces(bond, box: Box, x, bond1, bond2, alive,
                compute_energy: bool = False, more_partners=()):
    """Dispatch on the bond style (FENE or harmonic)."""
    if isinstance(bond, BondFENEParams):
        return fene_forces(bond, box, x, bond1, bond2, alive, compute_energy,
                           more_partners)
    if isinstance(bond, BondHarmonicParams):
        return harmonic_bond_forces(bond, box, x, bond1, bond2, alive,
                                    compute_energy, more_partners)
    raise NotImplementedError(
        f"bond style {type(bond).__name__} is not ported")


def _center_coeffs(k_t, x0_t, type_):
    """A per-center-type table's (K, x0) of each atom of type_."""
    t = torch.clamp(type_.long(), 0, k_t.shape[0] - 1)
    return k_t[t], x0_t[t]


def _angle_end_forces(d1, d2, kc, t0, ok):
    """(f1, f3, energy) of one angle with d1 = end1 - center, d2 = end2 -
    center and the center's (kc, t0): angle_harmonic.cpp::compute's a11,
    a12, a22 construction; zero where not ok."""
    rsq1 = (d1 * d1).sum(-1)
    rsq2 = (d2 * d2).sum(-1)
    r1 = torch.sqrt(torch.clamp(rsq1, min=1e-12))
    r2 = torch.sqrt(torch.clamp(rsq2, min=1e-12))
    c = torch.clamp((d1 * d2).sum(-1) / (r1 * r2), -1.0, 1.0)
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-8))
    dtheta = torch.arccos(c) - t0
    a = torch.where(ok, -2.0 * kc * dtheta / s, 0.0)
    a11 = a * c / torch.clamp(rsq1, min=1e-12)
    a12 = -a / (r1 * r2)
    a22 = a * c / torch.clamp(rsq2, min=1e-12)
    f1 = a11[:, None] * d1 + a12[:, None] * d2
    f3 = a22[:, None] * d2 + a12[:, None] * d1
    en = torch.where(ok, kc * dtheta * dtheta, 0.0)
    return f1, f3, en


def _angle_forces_general(box: Box, x, partners, k_t, t0_t, type_, alive,
                          compute_energy):
    """The angle pass of a branched topology (3-4 partner columns): a
    covered center bends every pair of its partners."""
    n = x.shape[0]
    kc_self, t0_self = _center_coeffs(k_t, t0_t, type_)
    f = torch.zeros_like(x)
    e = torch.zeros_like(x[:, 0]) if compute_energy else None
    # center role: one angle per pair of my partner columns
    for a, b in itertools.combinations(range(len(partners)), 2):
        pa, pb = partners[a], partners[b]
        ok = (alive & (pa >= 0) & (pb >= 0) & _rows(alive, pa)
              & _rows(alive, pb) & (kc_self > 0))
        d1 = box.min_image(_rows(x, pa) - x)
        d2 = box.min_image(_rows(x, pb) - x)
        f1, f3, en = _angle_end_forces(d1, d2, kc_self, t0_self, ok)
        f = f - (f1 + f3)
        if compute_energy:
            e = e + en
    # end role: I am an end of every angle centered at a partner p between
    # me and each of p's other partners
    me = torch.arange(n, device=x.device)
    for p in partners:
        ps = torch.clamp(p.long(), 0, n - 1)
        kc_p, t0_p = _center_coeffs(k_t, t0_t, type_[ps])
        has_p = alive & (p >= 0) & alive[ps] & (kc_p > 0)
        xp = x[ps]
        d_self = box.min_image(x - xp)
        for col in partners:
            oth = col[ps]
            ok = has_p & (oth >= 0) & (oth != me) & _rows(alive, oth)
            d_oth = box.min_image(_rows(x, oth) - xp)
            f1, _, _ = _angle_end_forces(d_self, d_oth, kc_p, t0_p, ok)
            f = f + f1
    return f, e


def angle_forces(angle, box: Box, x, bond1, bond2, type_, alive,
                 compute_energy: bool = False, more_partners=()):
    """Harmonic angles with center-atom storage (config.AngleHarmonicParams):
    an alive atom with two bond partners is the center of one angle
    between them when its type's K > 0; with more partner columns (a
    branched topology) every pair of a covered center's partners bends
    one angle.  Each atom takes its center force f2 = -(f1 + f3) and, per
    bond, its end force f1 of the partner's angle, the third atom found
    through the partner's own columns.  With compute_energy an angle's
    energy sits on its center.

    angle_harmonic.cpp: d1 = x_i - x_j, d2 = x_k - x_j, c = cos(theta),
    a = -2 K (theta - theta0) / sin(theta), f1 = (a c / r1^2) d1 - (a /
    (r1 r2)) d2, f3 likewise."""
    n = x.shape[0]
    k_t = const_like(angle.k, x)
    t0_t = const_like(np.deg2rad(angle.theta0).tolist(), x)
    if more_partners:
        return _angle_forces_general(box, x, (bond1, bond2)
                                     + tuple(more_partners), k_t, t0_t,
                                     type_, alive, compute_energy)
    kc_self, t0_self = _center_coeffs(k_t, t0_t, type_)
    center_ok = (alive & (bond1 >= 0) & (bond2 >= 0) & _rows(alive, bond1)
                 & _rows(alive, bond2) & (kc_self > 0))
    # center role: f2 = -(f1 + f3) of my own angle
    d1 = box.min_image(_rows(x, bond1) - x)
    d2 = box.min_image(_rows(x, bond2) - x)
    f1, f3, en = _angle_end_forces(d1, d2, kc_self, t0_self, center_ok)
    f = -(f1 + f3)
    e = en if compute_energy else None
    # end role: for each partner p that is an angle center
    me = torch.arange(n, device=x.device)
    for partner in (bond1, bond2):
        p = torch.clamp(partner.long(), 0, n - 1)
        pb1, pb2 = bond1[p], bond2[p]
        kc_p, t0_p = _center_coeffs(k_t, t0_t, type_[p])
        other = torch.where(pb1 == me, pb2, pb1)
        ok = (alive & (partner >= 0) & alive[p] & (pb1 >= 0) & (pb2 >= 0)
              & (other >= 0) & _rows(alive, other) & (kc_p > 0))
        xp = x[p]
        d_self = box.min_image(x - xp)
        d_oth = box.min_image(_rows(x, other) - xp)
        f1, _, _ = _angle_end_forces(d_self, d_oth, kc_p, t0_p, ok)
        f = f + f1
    return f, e


def dihedral_forces(dih, box: Box, x, bond1, bond2, alive,
                    compute_energy: bool = False):
    """Harmonic dihedrals with center-bond storage
    (config.DihedralHarmonicParams): every bonded pair (j, k) whose atoms
    both have two partners spans the chain dihedral i-j-k-l.  Each atom
    takes the gradient of every dihedral it is part of, once per role: x2
    per own bond (center role) and x1 through the 2-hop walk me -> j -> k
    -> l (end role); x3 and x4 are the same roles read from the other end.

    dihedral_harmonic.cpp: E = K [1 + d cos(n phi)], phi = atan2((n1 x n2)
    . b2hat, n1 . n2).  Forces are autograd gradients of the energy; rows
    that are not a dihedral take non-degenerate stand-in positions, so
    their (discarded) gradients stay finite."""
    n = x.shape[0]
    K, dsign, nper = float(dih.k), float(dih.d), int(dih.n)

    def e_dihedral(x1, x2, x3, x4):
        b1 = box.min_image(x2 - x1)
        b2 = box.min_image(x3 - x2)
        b3 = box.min_image(x4 - x3)
        n1 = torch.linalg.cross(b1, b2, dim=-1)
        n2 = torch.linalg.cross(b2, b3, dim=-1)
        b2n = torch.sqrt(torch.clamp((b2 * b2).sum(-1), min=1e-12))
        sin_t = (torch.linalg.cross(n1, n2, dim=-1) * b2).sum(-1) / b2n
        cos_t = (n1 * n2).sum(-1)
        phi = torch.atan2(sin_t, cos_t)
        return K * (1.0 + dsign * torch.cos(nper * phi))

    def other(p, me_idx):
        pb1, pb2 = _rows(bond1, p), _rows(bond2, p)
        return (torch.where(pb1 == me_idx, pb2, pb1),
                (p >= 0) & (pb1 >= 0) & (pb2 >= 0))

    me = torch.arange(n, device=x.device)
    f = torch.zeros_like(x)
    e = torch.zeros_like(x[:, 0]) if compute_energy else None
    s1 = const_like((1.0, 0.0, 0.0), x)
    s2 = const_like((1.0, 1.0, 0.0), x)
    s3 = const_like((0.0, 1.0, 1.0), x)

    def stand_in(ok, xa, xb, xc):
        ok3 = ok[:, None]
        return (torch.where(ok3, xa, x + s1), torch.where(ok3, xb, x + s2),
                torch.where(ok3, xc, x + s3))

    def role_force(ok, xa, xb, xc, role):
        """-(d/dx_self) sum E with x_self at `role` (0 = x1, 1 = x2)."""
        a, b, c = stand_in(ok, xa, xb, xc)
        with torch.enable_grad():
            xs = x.detach().requires_grad_(True)
            ev = e_dihedral(xs, a, b, c) if role == 0 \
                else e_dihedral(a, xs, b, c)
            g, = torch.autograd.grad(torch.where(ok, ev, 0.0).sum(), xs)
        return -torch.where(ok[:, None], g, 0.0)

    for partner in (bond1, bond2):
        has_p = alive & (partner >= 0) & _rows(alive, partner)
        # center role: I am x2 of the dihedral over the bond (me, p): i = my
        # other partner, k = p, l = p's other partner
        i_idx = torch.where(bond1 == partner, bond2, bond1)
        l_idx, p_has2 = other(partner, me)
        ok_c = (has_p & (i_idx >= 0) & p_has2 & (l_idx >= 0)
                & _rows(alive, i_idx) & _rows(alive, l_idx))
        xi, xk, xl = _rows(x, i_idx), _rows(x, partner), _rows(x, l_idx)
        f = f + role_force(ok_c, xi, xk, xl, role=1)
        if compute_energy:
            # a dihedral has two center roles: half its energy on each
            a, b, c = stand_in(ok_c, xi, xk, xl)
            e = e + 0.5 * torch.where(ok_c, e_dihedral(a, x, b, c), 0.0)
        # end role: I am x1 of the walk me -> j = p -> k -> l
        k_idx, j_has2 = other(partner, me)
        kb1, kb2 = _rows(bond1, k_idx), _rows(bond2, k_idx)
        l2_idx = torch.where(kb1 == partner, kb2, kb1)
        ok_e = (has_p & j_has2 & (k_idx >= 0) & _rows(alive, k_idx)
                & (kb1 >= 0) & (kb2 >= 0) & (l2_idx >= 0)
                & _rows(alive, l2_idx))
        f = f + role_force(ok_e, _rows(x, partner), _rows(x, k_idx),
                           _rows(x, l2_idx), role=0)
    return f, e


def _improper_quad_forces(box: Box, x1, x2, x3, x4, kc, chi0, ok):
    """(f1, f2, f3, f4, energy) of the harmonic improper over (x1, x2, x3,
    x4): improper_harmonic.cpp::compute's a11..a23 construction with its
    SMALL and clamp guards (E = K (chi - chi0)^2); zero where not ok."""
    small = 0.001
    vb1 = box.min_image(x1 - x2)
    vb2 = box.min_image(x3 - x2)
    vb3 = box.min_image(x4 - x3)
    ss1 = 1.0 / torch.clamp((vb1 * vb1).sum(-1), min=1e-12)
    ss2 = 1.0 / torch.clamp((vb2 * vb2).sum(-1), min=1e-12)
    ss3 = 1.0 / torch.clamp((vb3 * vb3).sum(-1), min=1e-12)
    r1, r2, r3 = torch.sqrt(ss1), torch.sqrt(ss2), torch.sqrt(ss3)
    c0 = (vb1 * vb3).sum(-1) * r1 * r3
    c1 = (vb1 * vb2).sum(-1) * r1 * r2
    c2 = -(vb3 * vb2).sum(-1) * r3 * r2
    s1 = 1.0 / torch.clamp(1.0 - c1 * c1, min=small)
    s2 = 1.0 / torch.clamp(1.0 - c2 * c2, min=small)
    s12 = torch.sqrt(s1 * s2)
    c = torch.clamp((c1 * c2 + c0) * s12, -1.0, 1.0)
    s = torch.clamp(torch.sqrt(1.0 - c * c), min=small)
    domega = torch.arccos(c) - chi0
    a = kc * domega
    en = torch.where(ok, a * domega, 0.0)
    a = torch.where(ok, -2.0 * a / s, 0.0)
    c = c * a
    s12 = s12 * a
    a11 = c * ss1 * s1
    a22 = -ss2 * (2.0 * c0 * s12 - c * (s1 + s2))
    a33 = c * ss3 * s2
    a12 = -r1 * r2 * (c1 * c * s1 + c2 * s12)
    a13 = -r1 * r3 * s12
    a23 = r2 * r3 * (c2 * c * s2 + c1 * s12)
    sv2 = a22[:, None] * vb2 + a23[:, None] * vb3 + a12[:, None] * vb1
    f1 = a12[:, None] * vb2 + a13[:, None] * vb3 + a11[:, None] * vb1
    f2 = -sv2 - f1
    f4 = a23[:, None] * vb2 + a33[:, None] * vb3 + a13[:, None] * vb1
    f3 = sv2 - f4
    return f1, f2, f3, f4, en


def improper_forces(imp, box: Box, x, partners, impr, type_, alive,
                    compute_energy: bool = False):
    """Harmonic impropers with per-center storage
    (config.ImproperHarmonicParams): impr[i2] holds the slots of (i1, i3,
    i4) of the improper centered on i2, its coefficients keyed by i2's
    type.  The center takes its f2 from its own triplet; each end reaches
    the improper through its bond to the center (the center is bonded to
    all three ends) and takes f1, f3 or f4 by finding itself in the
    center's triplet.  With compute_energy the energy sits on the
    center."""
    n = x.shape[0]
    k_t = const_like(imp.k, x)
    chi_t = const_like(np.deg2rad(imp.chi0).tolist(), x)

    def quad_ok(tri, center_alive, kc):
        ok = center_alive & (kc > 0)
        for c in range(3):
            ok = ok & (tri[:, c] >= 0) & _rows(alive, tri[:, c])
        return ok

    # center role (I am i2)
    kc_self, chi_self = _center_coeffs(k_t, chi_t, type_)
    ok_c = quad_ok(impr, alive, kc_self)
    _, f, _, _, en = _improper_quad_forces(
        box, _rows(x, impr[:, 0]), x, _rows(x, impr[:, 1]),
        _rows(x, impr[:, 2]), kc_self, chi_self, ok_c)
    e = en if compute_energy else None
    # end roles (I am i1, i3 or i4 of a partner's improper)
    me = torch.arange(n, device=x.device)
    for p in partners:
        ps = torch.clamp(p.long(), 0, n - 1)
        tri = impr[ps]
        kc_p, chi_p = _center_coeffs(k_t, chi_t, type_[ps])
        sel = [tri[:, c] == me for c in range(3)]
        ok = (alive & (p >= 0) & alive[ps] & quad_ok(tri, alive[ps], kc_p)
              & (sel[0] | sel[1] | sel[2]))
        ends = [torch.where(sel[c][:, None], x, _rows(x, tri[:, c]))
                for c in range(3)]
        f1, _, f3, f4, _ = _improper_quad_forces(
            box, ends[0], x[ps], ends[1], ends[2], kc_p, chi_p, ok)
        mine = (torch.where(sel[0][:, None], f1, 0.0)
                + torch.where(sel[1][:, None], f3, 0.0)
                + torch.where(sel[2][:, None], f4, 0.0))
        f = f + torch.where(ok[:, None], mine, 0.0)
    return f, e


def langevin_uniform(lp: LangevinParams, step: int,
                     tag: torch.Tensor) -> torch.Tensor:
    """The deviates uniform(-0.5, 0.5) [N, 3] of one step: axis a of the
    atom with tag t draws uniform01(hash3(t, a + 1, salt))."""
    salt = rng.step_salt(lp.seed, step, PURPOSE_LANGEVIN)
    axes = const_like((1, 2, 3), tag, torch.int64)
    bits = rng.hash3(tag[:, None], axes[None, :], salt)
    return rng.uniform01(bits) - 0.5


def langevin_force(lp: LangevinParams, cfg: SceneConfig, state):
    """fix langevin drag + random kicks (fix_langevin.cpp gfactor1/2),
    zero on dead slots."""
    m = per_atom_mass(cfg, state)
    gamma = m / lp.damp
    sigma = torch.sqrt(24.0 * lp.temp * m / (cfg.dt * lp.damp))
    u = langevin_uniform(lp, state.step, state.tag)
    f = -gamma[:, None] * state.v + sigma[:, None] * u
    return torch.where(state.alive[:, None], f, 0.0)
