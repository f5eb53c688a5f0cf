"""FENE bonds and the Langevin thermostat fix.

Counterpart of `fene_forces`, `bond_forces` and `langevin_force` in
`obmd_tpu/forces/bonded.py`.  FENE (bond_fene.cpp, the reference's
bench/in.chain) is evaluated symmetrically from the per-atom partner SLOT
columns: each atom sums the pull of its own bonds, so there is no
scatter-add, and each bond's energy is split half to each end.  An
over-stretched bond (r >= r0) is clamped to the reference's guard value
(rlogarg = 0.1) without an error; `observe.bond_stats` counts such bonds.
Harmonic bonds, angles, dihedrals and impropers are not ported yet.

Langevin (fix_langevin.cpp):

    f += -(m/damp) v + sqrt(24 kB T m / (dt damp)) * uniform(-0.5, 0.5)

with counter-based deviates per (atom tag, axis, step), bit for bit the
reference's `rng.hash3` / `uniform01` stream.
"""
from __future__ import annotations

import torch

from .. import rng
from ..config import BondFENEParams, LangevinParams, SceneConfig
from ..geometry import Box, const_like
from ..state import per_atom_mass

PURPOSE_LANGEVIN = 3
TWO_1_3 = 2.0 ** (1.0 / 3.0)


def fene_forces(bond: BondFENEParams, box: Box, x, bond1, bond2, alive,
                compute_energy: bool = False):
    """Force on every atom from its (up to two) FENE bonds, and with
    compute_energy its per-atom half share of each bond's energy.

    bond_fene.cpp: fbond = -k / (1 - r^2/r0^2) (+ WCA inside 2^(1/6)
    sigma), F_i = fbond * (x_i - x_j); rlogarg = 1 - r^2/r0^2 is clamped
    at 0.1 (the reference's "bad FENE bond" guard)."""
    n = x.shape[0]
    r0sq = bond.r0 * bond.r0
    sig2 = bond.sigma * bond.sigma
    f = torch.zeros_like(x)
    e = torch.zeros_like(x[:, 0]) if compute_energy else None
    for partner in (bond1, bond2):
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


def bond_forces(bond, box: Box, x, bond1, bond2, alive,
                compute_energy: bool = False):
    """Dispatch on the bond style: FENE only (harmonic bonds raise)."""
    if isinstance(bond, BondFENEParams):
        return fene_forces(bond, box, x, bond1, bond2, alive, compute_energy)
    raise NotImplementedError(
        f"bond style {type(bond).__name__} is not ported")


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
