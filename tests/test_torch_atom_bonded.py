"""Bonded terms under an ATOM-mode OBMD stage: what the JAX cellpad
engine does with a bond whose one end leaves through an open face, and the
port's refusal of the case.

The scene: a small open box (12 x 5 x 5, x open) of a two-type lj/cut
melt of FENE dimers, ATOM-mode `near` insertion of the solvent type 1 at
a high nbuf, and one dimer across the right buffer whose outer atom has
just drifted beyond the face.  One JAX stage call (`_obmd_stage`, the
sliced deletion `_delete_outside_sliced`, then insertion) deletes that
atom alone (no propagation along its bond); the survivor's partner column
still names the dead slot, and the insertion puts a new solvent atom
there: the survivor is bonded to a stranger, whose FENE force the JAX
bond term then computes.  The reference binary stops in this case ("Bond
atoms missing"), so the port refuses bonded terms with an ATOM-mode stage
(engine_cellpad.check_scene), with a message that names this test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from obmd_tpu import engine_cellpad as jec
from obmd_tpu.cellpad import layout_build as j_layout_build
from obmd_tpu.config import (BondFENEParams, Capacity, LJCutParams,
                             ObmdParams, SceneConfig)
from obmd_tpu.forces.bonded import bond_forces as j_bond_forces
from obmd_tpu.geometry import Box, RegionBlock
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import convert
from obmd_tpu_torch.engine_cellpad import check_supported, supports

LX, LYZ = 12.0, 5.0


def _config():
    box = Box((0.0, 0.0, 0.0), (LX, LYZ, LYZ), (False, True, True))
    r1 = RegionBlock((0.0, 0.0, 0.0), (3.0, LYZ, LYZ))
    r2 = RegionBlock((9.0, 0.0, 0.0), (LX, LYZ, LYZ))
    obmd = ObmdParams(
        ntype=1, nfreq=1, seed=11, pxx=1.0, alpha=0.5, tau=0.01, nbuf=400.0,
        region1=r1, region2=r2, region5=r1, region6=r2, buffer_size=3.0,
        near=0.3, insert_kmax=8)
    return SceneConfig(
        box=box, masses=(1.0, 1.0),
        pair=LJCutParams.create(cutoff=2.5, epsilon=1.0, sigma=1.0,
                                ntypes=2),
        dt=0.005, capacity=Capacity(n_max=600, cell_capacity=120),
        obmd=obmd, bond=BondFENEParams(k=30.0, r0=1.5, epsilon=1.0,
                                       sigma=1.0),
        skin=0.3, force_path="cellpad").finalize()


def test_jax_bonds_a_survivor_to_a_stranger():
    cfg = _config()
    cx = np.arange(0.6, 11.0, 1.4)
    cy = np.arange(0.6, LYZ, 1.4)
    c = np.stack(np.meshgrid(cx, cy, cy, indexing="ij"), -1).reshape(-1, 3)
    n = len(c)
    x = np.concatenate([c, c + [0.0, 0.0, 0.97],
                        [[11.95, 2.5, 2.5], [11.3, 2.5, 2.5]]])
    bonds = [(i + 1, i + 1 + n) for i in range(n)] + [(2 * n + 1, 2 * n + 2)]
    gone, survivor = 2 * n + 1, 2 * n + 2
    st = jinit_state(cfg, x, v=np.zeros_like(x),
                     types=np.zeros(len(x), np.int32),
                     bonds=np.asarray(bonds))
    geom = jec.make_geometry(cfg)
    st = j_layout_build(geom, cfg.box, st)
    tag = np.asarray(st.tag)
    a = int(np.nonzero(tag == gone)[0][0])
    b = int(np.nonzero(tag == survivor)[0][0])
    assert int(st.bond1[b]) == a
    # the outer atom's drift beyond the face
    st = st.replace(x=st.x.at[a, 0].set(LX + 0.05))
    st = jax.jit(lambda s: jec._obmd_stage(cfg, geom, s))(st)
    tag, alive = np.asarray(st.tag), np.asarray(st.alive)
    assert gone not in tag[alive]                 # deleted alone
    b = int(np.nonzero(tag == survivor)[0][0])
    p = int(st.bond1[b])
    assert p == a                                 # still the dead slot
    assert int(st.obmd.ninserted) > 0
    assert alive[p] and tag[p] > 2 * n + 2        # now a new atom
    assert int(st.type[p]) == 1 and int(st.bond1[p]) == -1
    # the JAX bond term pulls the survivor toward the stranger
    f, _ = j_bond_forces(cfg.bond, cfg.box, st.x, st.bond1, st.bond2,
                         st.alive, compute_energy=True)
    assert float(jnp.abs(f[b]).max()) > 0.0
    assert float(jnp.abs(f[p]).max()) == 0.0      # no bond the other way


def test_port_refuses_the_case():
    """The same configuration through convert: the port refuses it, with
    the reason and this test's name."""
    pcfg = convert.scene_config(_config())
    assert not supports(pcfg)
    with pytest.raises(NotImplementedError,
                       match="ATOM-mode insertion are refused: .*"
                             "test_torch_atom_bonded"):
        check_supported(pcfg.finalize())
