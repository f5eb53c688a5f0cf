"""SHAKE/RATTLE and rigid bodies on the port's slab decomposition
(obmd_tpu_torch/parallel/slab_decomp.py: `_shake_slab`, `_rattle_slab`,
`_rigid_drift_slab`, `_rigid_project_slab` over the owned and halo view)
against the JAX package's slab step on a 4-device CPU mesh, slot for slot,
and the slab path's refusals.

- SHAKE water straddling the faces with dynamic balancing (grow 1.5,
  balance_every 1): the live cuts bin for bin, the state slot for slot,
  every constraint held;
- rigid trimers under `near` insertion: held to JAX's slab step with
  obmd_tpu.rigid.rigid_kinematics replaced by test_torch_rigid.jax_midpoint
  while JAX traces (the port's drift turns a body about the half-step
  orientation's omega, JAX's about the start's), and by tag to the port's
  single-device cellpad step on the same draws;
- the refusals: the Langevin thermostat, a rigid template whose bonds close
  a cycle, a rigid body deeper than the message passing's rounds, rigid
  bodies without a template (the halo is sized by its span), dihedrals on
  a branched topology, a halo wider than a slab.

Both port cases run in one spawn of 4 gloo ranks on the CPU under a hard
timeout."""
import dataclasses

import jax
import numpy as np
import pytest

import obmd_tpu.rigid as jrigid
from obmd_tpu.config import (Capacity, DPDParams, ObmdParams, SceneConfig,
                             shake_table_from_templates)
from obmd_tpu.geometry import Box, RegionBlock
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.parallel import slab_decomp as jslab
from obmd_tpu.state import init_state as jinit
from obmd_tpu_torch import convert
from obmd_tpu_torch.integrate import make_step as pmake_step
from obmd_tpu_torch.parallel import comm as pcomm
from obmd_tpu_torch.parallel import ranks as pranks
from obmd_tpu_torch.parallel import slab_decomp as pslab

from test_slab_mol import TRIMER, _chain_state
from test_slab_parity import WATER, _scatter_molecules
from test_torch_rigid import jax_midpoint
from test_torch_slab_mol import jax_mol_draws
from test_torch_support import jax_arrays

NDEV = 4
TIMEOUT_S = 120.0
WATER_STEPS = 5
RIGID_STEPS = 3
WATER_GEOM = dict(grow=1.5, n_loc=64, m_max=64)


def _water():
    """JAX's SHAKE water scene (test_slab_parity.py:72-93): 40 waters
    across an open 16 x 4 x 4 box."""
    lx = 16.0
    box = Box((0.0, 0.0, 0.0), (lx, 4.0, 4.0), (False, True, True))
    r = np.random.default_rng(11)
    x, bonds, mols, types, _ = _scatter_molecules(r, WATER, 40, lx)
    v = r.normal(0, 0.4, x.shape)
    cfg = SceneConfig(
        box=box, masses=(16.0, 1.0), dt=0.004,
        pair=DPDParams.create(temp=0.5, cutoff=1.0, seed=5, a0=10.0,
                              gamma=2.0, ntypes=2),
        capacity=Capacity(n_max=x.shape[0], cell_capacity=16),
        shake=shake_table_from_templates([WATER], 2),
        skin=0.3, force_path="nlist").finalize()
    return cfg, jsetup(cfg, jinit(cfg, x, v=v, types=types, bonds=bonds,
                                  mol=mols))


def _rigid():
    """JAX's rigid trimer scene (test_slab_mol.py:253-274): 40 trimers
    under `near` insertion of rigid trimers, set up on the cellpad engine
    (MOLECULE mode's single-device engine)."""
    box = Box((0.0, 0.0, 0.0), (16.0, 4.0, 4.0), (False, True, True))
    b = 2.5
    r1 = RegionBlock((0.0, 0.0, 0.0), (b, 4.0, 4.0))
    r2 = RegionBlock((13.5, 0.0, 0.0), (16.0, 4.0, 4.0))
    obmd = ObmdParams(
        ntype=0, nfreq=1, seed=11, pxx=1.0, alpha=0.5, tau=0.01, nbuf=60.0,
        region1=r1, region2=r2, region5=r1, region6=r2, buffer_size=b,
        usher=None, near=0.45, mol=TRIMER, mol_len=3, insert_kmax=4,
        rigid=True)
    cfg = SceneConfig(
        box=box, masses=(1.0,), dt=0.004,
        pair=DPDParams.create(temp=0.4, cutoff=1.0, seed=9, a0=15.0,
                              gamma=2.0),
        capacity=Capacity(n_max=900, cell_capacity=20),
        obmd=obmd, skin=0.3, force_path="cellpad").finalize()
    return cfg, jsetup(cfg, _chain_state(cfg, TRIMER, 40, spread=0.4))


def _jax_slab(cfg, st, steps, geom_kw, balance_every=0):
    mesh = jslab.make_mesh(NDEV)
    geom = jslab.make_slab_geom(cfg, NDEV, **geom_kw)
    s = jslab.shard_by_slab(cfg, geom, st, mesh)
    if balance_every:
        s = jslab.with_balance_cuts(geom, s)
    step = jslab.make_slab_step(cfg, mesh, geom, balance_every=balance_every)
    for _ in range(steps):
        s = jax.block_until_ready(step(s))
    return s


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both scenes through the JAX slab step and, in one spawn, the
    port's."""
    wcfg, wst = _water()
    jw = _jax_slab(wcfg, wst, WATER_STEPS, WATER_GEOM, balance_every=1)
    rcfg, rst = _rigid()
    slab_rcfg = dataclasses.replace(rcfg, force_path="nlist").finalize()
    draws = jax_mol_draws(rcfg, rst.key, range(int(rst.step),
                                               int(rst.step) + RIGID_STEPS))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrigid, "rigid_kinematics", jax_midpoint)
        jr = _jax_slab(slab_rcfg, rst, RIGID_STEPS, {})
    starts = dict(water=jax_arrays(wst), rigid=jax_arrays(rst))
    port_runs = [
        dict(cfg=convert.scene_config(wcfg).finalize(),
             arrays=starts["water"], seed=7, steps=WATER_STEPS,
             geom=WATER_GEOM, balance_every=1),
        dict(cfg=convert.scene_config(slab_rcfg).finalize(),
             arrays=starts["rigid"], seed=7, steps=RIGID_STEPS,
             draws=draws)]
    res = pcomm.spawn(pranks.slab_runs, NDEV, "gloo", "cpu", TIMEOUT_S,
                      port_runs, store_dir=str(tmp_path_factory.mktemp("fs")))
    return dict(
        jax=dict(water=jax_arrays(jw.replace(nbrs=None)),
                 cuts=np.asarray(jw.nbrs.cuts),
                 rigid=jax_arrays(jr.replace(nbrs=None))),
        port=dict(water=res[0][0]["state"], rigid=res[0][1]["state"]),
        ranks=res, starts=starts, rigid_cfg=convert.scene_config(rcfg),
        draws=draws)


EXACT = ("tag", "alive", "type", "mol", "bond1", "bond2")
COUNTERS = ("step", "maxtag", "cell_overflow", "ndeleted", "ninserted",
            "insert_fail", "usher_iters")


def _same_slots(p, j, x_tol=1e-5, v_tol=1e-4):
    for k in EXACT:
        assert np.array_equal(p[k], j[k]), k
    for k in COUNTERS:
        assert int(p[k]) == int(j[k]), k
    a = j["alive"]
    np.testing.assert_allclose(p["x"][a], j["x"][a], rtol=0, atol=x_tol)
    np.testing.assert_allclose(p["v"][a], j["v"][a], rtol=0, atol=v_tol)


def _by_tag(s, field="x"):
    a = s["alive"]
    return dict(zip(s["tag"][a].tolist(), s[field][a]))


def test_slab_shake_matches_jax(runs):
    """SHAKE water with dynamic balancing: the cuts bin for bin, the state
    slot for slot, no overflow, the atoms inside their slabs."""
    p, j = runs["port"]["water"], runs["jax"]["water"]
    _same_slots(p, j)
    assert int(j["cell_overflow"]) == 0
    assert np.array_equal(runs["ranks"][0][0]["cuts"], runs["jax"]["cuts"])
    assert all(r[0]["outside"] == 0 for r in runs["ranks"])


def test_slab_shake_constraints_hold(runs):
    """Every water's three distances at the template's within 1e-5 after
    the run, by tag (the slab's partner columns are tags)."""
    xm = _by_tag(runs["port"]["water"])
    dx0 = np.asarray(WATER.dx)
    err = 0.0
    for k in range(40):
        for i, j in WATER.bonds:
            d = xm[3 * k + i + 1] - xm[3 * k + j + 1]
            d[1:] -= 4.0 * np.round(d[1:] / 4.0)
            err = max(err, abs(np.linalg.norm(d)
                               - np.linalg.norm(dx0[i] - dx0[j])))
    assert err < 1e-5, err


def test_slab_rigid_matches_jax(runs):
    """Rigid trimers under insertion: slot for slot against JAX's slab
    step with the port's turn, insertions and the partner tags
    included."""
    p, j = runs["port"]["rigid"], runs["jax"]["rigid"]
    _same_slots(p, j)
    assert int(j["ninserted"]) > int(runs["starts"]["rigid"]["ninserted"])
    assert int(j["cell_overflow"]) == 0


def test_slab_rigid_matches_single_device(runs):
    """The same run on the port's single-device cellpad step from the same
    start and draws: the same atoms, positions by tag within 2e-4 (JAX's
    test_slab_rigid_matches_single_chip gate), the bodies at the
    template's arm lengths."""
    state = convert.from_arrays(runs["starts"]["rigid"], seed=7,
                                device="cpu")
    step = pmake_step(runs["rigid_cfg"], pranks.ReplayDraws(runs["draws"]))
    for _ in range(RIGID_STEPS):
        state = step(state)
    ref = convert.to_arrays(state)
    got = runs["port"]["rigid"]
    for k in ("ndeleted", "ninserted", "cell_overflow"):
        assert int(got[k]) == int(ref[k]), k
    m1, m2 = _by_tag(got), _by_tag(ref)
    assert set(m1) == set(m2)
    assert max(np.abs(m1[t] - m2[t]).max() for t in m1) < 2e-4
    arm = float(np.linalg.norm(np.subtract(TRIMER.dx[0], TRIMER.dx[1])))
    mols = got["mol"]
    checked = 0
    for mid in np.unique(mols[got["alive"] & (mols > 0)]):
        rows = np.flatnonzero(got["alive"] & (mols == mid))
        if len(rows) != 3:
            continue
        rows = rows[np.argsort(got["tag"][rows])]
        d = got["x"][rows[0]] - got["x"][rows[1]]
        d[1:] -= 4.0 * np.round(d[1:] / 4.0)
        assert abs(np.linalg.norm(d) - arm) < 5e-4, mid
        checked += 1
    assert checked >= 30


def test_slab_constraint_refusals():
    """The Langevin thermostat, a rigid template with a cycle, a rigid body
    deeper than the rounds (at sharding), rigid bodies without a template,
    dihedrals on a branched topology and a halo wider than a slab raise,
    each with its message."""
    from obmd_tpu_torch.config import (DihedralHarmonicParams,
                                       LangevinParams, MolTemplate)
    from obmd_tpu_torch.state import init_state
    solo = pcomm.Comm.solo("cpu")
    wcfg = convert.scene_config(_water()[0]).finalize()
    with pytest.raises(NotImplementedError, match="Langevin"):
        pslab.make_slab_step(dataclasses.replace(
            wcfg, langevin=LangevinParams(temp=1.0, damp=1.0, seed=1)),
            solo)
    rcfg, _ = _rigid()
    prcfg = convert.scene_config(rcfg)
    tri = prcfg.obmd.mol
    ring = dataclasses.replace(tri, bonds=((0, 1), (1, 2), (0, 2)))
    with pytest.raises(ValueError, match="has a cycle"):
        pslab.make_slab_step(dataclasses.replace(
            prcfg, obmd=dataclasses.replace(prcfg.obmd, mol=ring)), solo)
    # a five-atom chain is deeper than the trimer template's 2 rounds
    prcfg = prcfg.finalize()
    x = np.c_[np.linspace(6.0, 8.0, 5), np.full(5, 2.0), np.full(5, 2.0)]
    deep = init_state(prcfg, x, bonds=np.c_[np.arange(1, 5),
                                            np.arange(2, 6)],
                      mol=np.ones(5, np.int64), device="cpu")
    with pytest.raises(ValueError, match="spans more than 2 bonds"):
        pslab.shard_by_slab(prcfg, pslab.make_slab_geom(prcfg, 2), deep, 0)
    with pytest.raises(NotImplementedError, match="molecule template"):
        pslab.make_slab_step(dataclasses.replace(prcfg, obmd=None), solo)
    star = MolTemplate(
        dx=((0.0, 0.0, 0.0), (0.5, 0.0, 0.0), (0.0, 0.5, 0.0),
            (0.0, 0.0, 0.5)), types=(0, 0, 0, 0),
        bonds=((0, 1), (0, 2), (0, 3)))
    branched = dataclasses.replace(
        prcfg, obmd=dataclasses.replace(prcfg.obmd, mol=star, rigid=False),
        dihedral=DihedralHarmonicParams(k=1.0)).finalize()
    assert branched.branched_topology
    with pytest.raises(NotImplementedError, match="dihedrals"):
        pslab.make_slab_step(branched, solo)
    with pytest.raises(ValueError, match="halo width"):
        pslab.make_slab_geom(wcfg, 8)
