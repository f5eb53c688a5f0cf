"""The Langevin thermostat fix.

Counterpart of `langevin_force` in `obmd_tpu/forces/bonded.py` (reference:
fix_langevin.cpp):

    f += -(m/damp) v + sqrt(24 kB T m / (dt damp)) * uniform(-0.5, 0.5)

with counter-based deviates per (atom tag, axis, step), bit for bit the
reference's `rng.hash3` / `uniform01` stream.  The bonded forces of that
module (bonds, angles, dihedrals, impropers) are not ported yet.
"""
from __future__ import annotations

import torch

from .. import rng
from ..config import LangevinParams, SceneConfig
from ..geometry import const_like
from ..state import per_atom_mass

PURPOSE_LANGEVIN = 3


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
