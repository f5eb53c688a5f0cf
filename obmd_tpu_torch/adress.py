"""Molecule center-of-mass columns (cms_mol, vcms_mol).

Counterpart of `mol_com_rounds` and `update_mol_com`, the whole of
`obmd_tpu/adress.py`.  The reference
computes molecule COMs with a scan over all atoms and an MPI reduce
(`mol_center_of_mass`, fix_obmd_merged.cpp:1734-1754); here, as in the JAX
package, by directed message passing over the bond-partner slot graph:
msg(i -> p) carries the mass-weighted sums of the subtree reached from i
away from p, exact on trees after as many rounds as the graph's diameter.
On a cycle (path I's water triangle) both packages count atoms more than
once, so cms_mol and vcms_mol there are not the molecule's centre of mass
(tests/test_torch_rigid.py pins how far they lie from it).
"""
from __future__ import annotations

import torch

from .config import SceneConfig
from .state import State, per_atom_mass


def mol_com_rounds(cfg: SceneConfig) -> int:
    """The graph-diameter bound: a template's natoms - 1, else 2."""
    if cfg.obmd is not None and cfg.obmd.mol is not None:
        return max(1, cfg.obmd.mol_natoms_max - 1)
    return 2


def update_mol_com(cfg: SceneConfig, state: State, rounds: int = 0) -> State:
    """cms_mol and vcms_mol of every alive atom with mol != 0 (0 for the
    others)."""
    if rounds <= 0:
        rounds = mol_com_rounds(cfg)
    n = state.capacity
    m = per_atom_mass(cfg, state)
    member = state.alive & (state.mol != 0)
    w = torch.where(member, m, 0.0)
    # payload per atom: [m x (3), m v (3), m (1)]
    a = torch.cat([w[:, None] * state.x, w[:, None] * state.v, w[:, None]],
                  dim=1)
    cols = [c.long() for c in state.bond_partners]
    k_n = len(cols)
    ps_all = [torch.where(member, c, -1) for c in cols]
    me = torch.arange(n, device=state.device)

    def incoming(msgs, p):
        """The message partner p directs at me: p's message toward its k-th
        partner column, picked by which of p's columns points back."""
        ps = torch.clamp(p, 0, n - 1)
        from_p = torch.zeros_like(a)
        for k in range(k_n):
            toward_me = (cols[k][ps] == me)[:, None]
            from_p = torch.where(toward_me, msgs[k][ps], from_p)
        return torch.where((p >= 0)[:, None], from_p, 0.0)

    msgs = [torch.zeros_like(a) for _ in range(k_n)]
    for _ in range(rounds):
        ins = [incoming(msgs, p) for p in ps_all]
        # toward p_k: me + everything behind every other partner
        msgs = [a + sum(ins[j] for j in range(k_n) if j != k)
                if k_n > 1 else a for k in range(k_n)]
    total = a + sum(incoming(msgs, p) for p in ps_all)
    wt = torch.clamp(total[:, 6:7], min=1e-30)
    return state.replace(
        cms_mol=torch.where(member[:, None], total[:, 0:3] / wt, 0.0),
        vcms_mol=torch.where(member[:, None], total[:, 3:6] / wt, 0.0))
