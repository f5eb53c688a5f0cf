"""The slab decomposition's MOLECULE mode (obmd_tpu_torch/parallel/
slab_decomp.py: bonds, angles, dihedrals and impropers over the halo,
molecule insertion and whole-molecule deletion over the ranks) against the
JAX package's slab step on a 4-device CPU mesh, slot for slot.

Every port case runs in one spawn of 4 gloo ranks on the CPU (a hard
timeout kills them); the JAX slab steps run in this process, and their
molecule draws are replayed into the port's ranks (`JaxMolDraws`: the JAX
slab consumes its key chain as the single-device engine does).  The
molecule USHER case searches at nattempt 0 with a raised etarget (an
USHER verdict at the etarget gate hangs on the float32 order of the sums
over the ranks)."""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from obmd_tpu.config import (BondHarmonicParams, Capacity, DPDParams,
                             ImproperHarmonicParams, MolTemplate,
                             SceneConfig, UsherParams)
from obmd_tpu.geometry import Box
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.parallel import slab_decomp as jslab
from obmd_tpu.state import init_state as jinit
from obmd_tpu_torch import convert
from obmd_tpu_torch.parallel import comm as pcomm
from obmd_tpu_torch.parallel import ranks as pranks

from test_slab_mol import CHAIN4, _chain_state, _mol_scene
from test_slab_parity import _S, _scatter_molecules
from test_torch_support import JaxMolDraws, jax_arrays

NDEV = 4
TIMEOUT_S = 150.0
# periodic y and z of 5 cells (7.5 at cut + skin 1.3): JAX's
# make_pair_kernel is not held on 3-cell periodic axes
WIDE = 7.5
# a 4-arm star with tetrahedral arms: JAX's test star (test_slab_parity.py
# :28-33) has two collinear arms, where the float32 improper force carries
# amplified rounding in any two operation orders
# (observe.ill_conditioned_impropers)
_T = _S / np.sqrt(3.0)
STAR = MolTemplate(
    dx=((0.0, 0.0, 0.0), (_T, _T, _T), (_T, -_T, -_T), (-_T, _T, -_T),
        (-_T, -_T, _T)),
    types=(1, 0, 0, 0, 0), q=(0.0,) * 5,
    bonds=((0, 1), (0, 2), (0, 3), (0, 4)),
    impropers=((1, 1, 0, 2, 3),))


def jax_mol_draws(cfg, key, steps):
    """One stage call's draws a step of `steps`, replaying the JAX key
    chain from the state's key (JaxMolDraws), as numpy dicts for
    ranks.ReplayDraws."""
    d = JaxMolDraws(cfg, 0)
    d.key = key
    out = []
    for s in steps:
        u = d(SimpleNamespace(step=s), True)
        out.append({k: None if getattr(u, k) is None
                    else getattr(u, k).numpy()
                    for k in ("pos", "z", "vel", "tpl")})
    return out


def _dimers():
    """JAX's dimer scene (test_slab_mol.py:24-52) in an open 16 x 7.5 x 7.5
    box, 150 dimers straddling the faces, no stage."""
    box = Box((0.0, 0.0, 0.0), (16.0, WIDE, WIDE), (False, True, True))
    r = np.random.default_rng(3)
    nd = 150
    cx = r.uniform(0.6, 15.4, nd)
    cyz = r.uniform(0.2, WIDE - 0.2, (nd, 2))
    axis = r.normal(size=(nd, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    x = np.zeros((2 * nd, 3))
    x[0::2] = np.c_[cx, cyz] - 0.35 * axis
    x[1::2] = np.c_[cx, cyz] + 0.35 * axis
    x[:, 1:] = np.mod(x[:, 1:], WIDE)
    x[:, 0] = np.clip(x[:, 0], 0.05, 15.95)
    v = r.normal(0, 0.3, (2 * nd, 3))
    bonds = np.stack([np.arange(1, 2 * nd, 2), np.arange(2, 2 * nd + 1, 2)],
                     axis=1)
    cfg = SceneConfig(
        box=box, masses=(1.0,), dt=0.004,
        pair=DPDParams.create(temp=0.4, cutoff=1.0, seed=9, a0=20.0,
                              gamma=2.0),
        bond=BondHarmonicParams(k=50.0, r0=0.7),
        capacity=Capacity(n_max=2 * nd, cell_capacity=16),
        skin=0.3, force_path="nlist").finalize()
    return cfg, jsetup(cfg, jinit(cfg, x, v=v, bonds=bonds,
                                  mol=np.repeat(np.arange(1, nd + 1), 2)))


def _chains():
    """JAX's 4-bead chains with angles and dihedrals
    (test_slab_mol.py:217-247), 60 chains in an open 24 x 4 x 4 box."""
    from obmd_tpu.config import AngleHarmonicParams, DihedralHarmonicParams
    box = Box((0.0, 0.0, 0.0), (24.0, 4.0, 4.0), (False, True, True))
    cfg = SceneConfig(
        box=box, masses=(1.0,), dt=0.004,
        pair=DPDParams.create(temp=0.4, cutoff=1.0, seed=9, a0=20.0,
                              gamma=2.0),
        bond=BondHarmonicParams(k=50.0, r0=0.65),
        angle=AngleHarmonicParams(k=(8.0,), theta0=(120.0,)),
        dihedral=DihedralHarmonicParams(k=1.5, d=1, n=2),
        capacity=Capacity(n_max=256, cell_capacity=16),
        skin=0.3, force_path="nlist").finalize()
    return cfg, jsetup(cfg, _chain_state(cfg, CHAIN4, 60, spread=0.3))


def _stars():
    """JAX's 4-arm star scene with an improper each (test_slab_parity.py:
    121-151) on tetrahedral stars (STAR), 60 in an open 16 x 7.5 x 7.5
    box: 4 partner channels."""
    box = Box((0.0, 0.0, 0.0), (16.0, WIDE, WIDE), (False, True, True))
    r = np.random.default_rng(7)
    x, bonds, mols, types, imps = _scatter_molecules(r, STAR, 60, 16.0,
                                                     yz=WIDE)
    v = r.normal(0, 0.5, x.shape)
    cfg = SceneConfig(
        box=box, masses=(1.0, 1.0), dt=0.005,
        pair=DPDParams.create(temp=0.8, cutoff=1.0, seed=3, a0=15.0,
                              gamma=3.0, ntypes=2),
        bond=BondHarmonicParams(k=40.0, r0=_S),
        improper=ImproperHarmonicParams(k=(0.0, 8.0), chi0=(0.0, 30.0)),
        capacity=Capacity(n_max=x.shape[0], cell_capacity=18),
        skin=0.3, force_path="nlist", branched_topology=True).finalize()
    return cfg, jsetup(cfg, jinit(cfg, x, v=v, types=types, bonds=bonds,
                                  mol=mols, impropers=imps))


def _usher():
    """JAX's molecule scene under MOL USHER at nattempt 0 with a raised
    etarget."""
    cfg, st = _mol_scene()
    cfg = dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, near=None, maxattempt=1,
        usher=UsherParams(etarget=40.0, nattempt=0))).finalize()
    return cfg, st


def _velocity():
    """JAX's molecule scene with the velocity keyword vz
    (test_slab_mol.py:335-356)."""
    cfg, st = _mol_scene()
    return dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, vz=(0.4, 0.4))).finalize(), st


# the doom case's cuts: edge slabs 1.2 wide, so that a chain leaving the box
# reaches over the first cut and its doom crosses a slab face
DOOM_CUTS = (0.0, 1.2, 8.0, 14.8, 16.0)


def _doom():
    """JAX's molecule scene on 4-bead chains (CHAIN4, `near` insertion)
    with, at each face, two chains laid along x from 0.02 inside the face
    and moving out at 0.5: in the first step each leaves whole, two of its
    atoms on the edge rank's neighbour (DOOM_CUTS)."""
    cfg, _ = _mol_scene()
    cfg = dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, mol=CHAIN4, mol_len=4, maxattempt=1)).finalize()
    st = _chain_state(cfg, CHAIN4, 40, spread=0.5)
    n = int(np.asarray(st.alive).sum())
    x, v = np.asarray(st.x)[:n], np.asarray(st.v)[:n]
    edge = np.zeros((16, 3))
    for k, (x0, dx, y) in enumerate(((0.02, 0.5, 0.7), (0.02, 0.5, 2.7),
                                     (15.98, -0.5, 1.2), (15.98, -0.5, 3.2))):
        edge[4 * k:4 * k + 4] = [[x0 + i * dx, y + 0.1 * (i % 2), 1.0]
                                 for i in range(4)]
    pos = np.concatenate([x, edge])
    vel = np.concatenate([v, np.repeat(
        [[-0.5, 0.0, 0.0]] * 2 + [[0.5, 0.0, 0.0]] * 2, 4, axis=0)])
    pos[:, 1:] = np.mod(pos[:, 1:], 4.0)
    bonds = np.concatenate([np.asarray(CHAIN4.bonds) + 1 + 4 * i
                            for i in range(n // 4 + 4)])
    mol = np.repeat(np.arange(1, n // 4 + 5), 4)
    return cfg, jsetup(cfg, jinit(cfg, pos, v=vel, bonds=bonds, mol=mol))


CASES = {
    # name: (scene, steps, slab geometry, JAX force_impl, port force_impl)
    "dimers": (_dimers, 3, dict(n_loc=128), "gathered", "gathered"),
    "dimers_kernel": (_dimers, 3, dict(n_loc=128), "pallas", "kernel"),
    "chains": (_chains, 3, dict(n_loc=128), "gathered", "gathered"),
    "stars_kernel": (_stars, 4, dict(n_loc=160), "pallas", "kernel"),
    "mol": (_mol_scene, 10, {}, "gathered", "gathered"),
    "doom": (_doom, 4, dict(boundaries=DOOM_CUTS, n_loc=600),
             "gathered", "gathered"),
    "velocity": (_velocity, 3, {}, "gathered", "gathered"),
    "usher": (_usher, 4, {}, "gathered", "gathered"),
}


def _jax_run(cfg, state, steps, geom_kw, impl):
    mesh = jslab.make_mesh(NDEV)
    geom = jslab.make_slab_geom(cfg, NDEV, **geom_kw)
    s = jslab.shard_by_slab(cfg, geom, state, mesh)
    step = jslab.make_slab_step(cfg, mesh, geom, force_impl=impl)
    for _ in range(steps):
        s = jax.block_until_ready(step(s))
    return s


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case through the JAX slab step and, in one spawn, the
    port's."""
    jax_out, port_runs, starts = {}, [], {}
    for name, (make, steps, geom_kw, jimpl, pimpl) in CASES.items():
        cfg, st = make()
        draws = None
        if cfg.obmd is not None:
            draws = jax_mol_draws(cfg, st.key, range(int(st.step),
                                                     int(st.step) + steps))
        js = _jax_run(cfg, st, steps, geom_kw, jimpl)
        jax_out[name] = jax_arrays(js.replace(nbrs=None))
        starts[name] = jax_arrays(st)
        port_runs.append(dict(
            cfg=convert.scene_config(cfg).finalize(), arrays=starts[name],
            seed=7, steps=steps, geom=geom_kw, force_impl=pimpl,
            draws=draws))
    res = pcomm.spawn(pranks.slab_runs, NDEV, "gloo", "cpu", TIMEOUT_S,
                      port_runs, store_dir=str(tmp_path_factory.mktemp("fs")))
    port = {name: res[0][i]["state"] for i, name in enumerate(CASES)}
    return dict(jax=jax_out, port=port, ranks=res, starts=starts)


EXACT = ("tag", "alive", "type", "mol", "bond1", "bond2", "bond3", "bond4",
         "impr", "rep_atom")
COUNTERS = ("step", "maxtag", "cell_overflow", "ndeleted", "ninserted",
            "insert_fail", "usher_iters")


def _same_slots(p, j, x_tol=1e-5, v_tol=1e-4):
    for k in EXACT:
        if k in j:
            assert np.array_equal(p[k], j[k]), k
    for k in COUNTERS:
        assert int(p[k]) == int(j[k]), k
    a = j["alive"]
    np.testing.assert_allclose(p["x"][a], j["x"][a], rtol=0, atol=x_tol)
    np.testing.assert_allclose(p["v"][a], j["v"][a], rtol=0, atol=v_tol)


def _partners_live(s):
    """Every live atom's partner tags are live tags (molecules whole)."""
    a = s["alive"]
    live = set(s["tag"][a].tolist())
    for k in ("bond1", "bond2", "bond3", "bond4"):
        if k in s:
            p = s[k][a]
            assert set(p[p >= 0].tolist()) <= live, k


@pytest.mark.parametrize("case", ["dimers", "dimers_kernel", "chains",
                                  "stars_kernel"])
def test_slab_bonded_matches_jax(runs, case):
    """Bonds across the faces (2 partner channels, and 4 on the stars),
    angles, dihedrals and impropers on the gathered and the kernel paths,
    slot for slot against JAX's slab step."""
    p, j = runs["port"][case], runs["jax"][case]
    _same_slots(p, j)
    assert int(j["cell_overflow"]) == 0
    _partners_live(p)


@pytest.mark.parametrize("case", ["mol", "doom", "velocity", "usher"])
def test_slab_molecule_stage_matches_jax(runs, case):
    """Molecule insertion (`near` with maxattempt 2 and with vz; MOL USHER
    at nattempt 0) and whole-molecule deletion over the ranks, slot for
    slot against JAX's slab step, the setpoints within float32 of JAX's."""
    p, j = runs["port"][case], runs["jax"][case]
    _same_slots(p, j)
    assert int(j["ninserted"]) > int(runs["starts"][case]["ninserted"])
    assert int(j["cell_overflow"]) == 0
    for k in ("momentum_force_left", "momentum_force_right"):
        np.testing.assert_allclose(p[k], j[k], rtol=1e-5, atol=1e-3)


def test_slab_molecules_whole_and_owned(runs):
    """After the molecule runs no live atom has a dead partner, insertions
    and deletions come in whole molecules (the four chains that left at
    the faces with their atoms on two ranks among them), and each rank's
    live atoms lie inside its slab."""
    for case, size in (("mol", 2), ("doom", 4), ("velocity", 2),
                       ("usher", 2)):
        p, s0 = runs["port"][case], runs["starts"][case]
        _partners_live(p)
        for k in ("ninserted", "ndeleted"):
            assert (int(p[k]) - int(s0[k])) % size == 0, (case, k)
    p, s0 = runs["port"]["doom"], runs["starts"]["doom"]
    assert int(p["ndeleted"]) - int(s0["ndeleted"]) >= 16
    edge = s0["alive"] & (s0["mol"] > s0["mol"].max() - 4)
    assert edge.sum() == 16
    assert not set(s0["tag"][edge].tolist()) & set(p["tag"][p["alive"]]
                                                   .tolist())
    for r in runs["ranks"]:
        assert all(run["outside"] == 0 for run in r)
        assert all(run["same_draws"] for run in r)


def test_slab_inserted_velocities(runs):
    """The vz keyword: the molecules inserted in 3 steps carry about the
    drawn 0.4 (a few steps of forces nudge it), as JAX's
    test_slab_inserted_velocity_keywords holds."""
    p = runs["port"]["velocity"]
    fresh = p["alive"] & (p["tag"] > int(runs["starts"]["velocity"]
                                          ["maxtag"]))
    assert fresh.any()
    assert np.abs(p["v"][fresh, 2] - 0.4).max() < 0.25
