"""Rigid bodies in the port (obmd_tpu_torch/rigid.py, the engines' drift
and kick hooks) against the JAX package (obmd_tpu/rigid.py, its engines).

- body_moments and rigid_kinematics from raw arrays on random chains of
  2-5 atoms, trees (a centre with three arms) and four-partner branched
  bodies, some across a periodic face, with non-member and dead rows, at
  as many rounds as the largest diameter: every output within 1e-5 of its
  largest magnitude, but a dimer's (a linear body: the regularised
  solve amplifies float32 residues along its axis in both packages,
  `_linear`), whose centre of mass and bond length are held instead;
- the port's one departure: its drift turns a body about the angular
  velocity of the half-step orientation, where JAX's turns it about the
  start's, which heats a free water (jax_midpoint is JAX's drift with the
  port's turn, built from JAX's own functions; every comparison of a
  drift below holds the port to it);
- rigid_drift and rigid_project on states of such bodies (the scene-level
  flag, 2 rounds): x and v within 1e-5 of their largest magnitude (a
  dimer's as above);
- tests/test_rigid.py's two scenes: the free tumbling trimer for 1,000
  steps on the nlist engine against the JAX run (positions within 1e-3,
  the trimer's geometry and momentum at that test's gates), and on the
  cellpad engine at the same gates; rigid trimer insertion under a
  force-free DPD law on the cellpad engine, 12 steps with the JAX
  engine's draws injected and zeros standing in for the JAX pair kernel
  (its interpret mode takes minutes a step): slots, tags, alive, mol and
  the partner columns exactly, x and v within 1e-5; then the JAX test's
  own scene (DPD at a0 15) on the port alone at its gates;
- the refusals the JAX package lacks: a template whose bonds close a
  cycle, and at setup a body with a cycle or one across more bonds than
  the message passing's rounds;
- what the JAX package does on path I's water triangle: body_moments
  reads a mass of 20.0314 on the O and 35.0228 on each H (18.0154 on the
  tree), and update_mol_com, the same construction, gives cms_mol and
  vcms_mol that both packages share and that lie off the molecules'
  centres of mass;
- path K's molecular P_xx: on one state, the tree's (H-H in the pair
  law) equals the triangle's (H-H excluded) within 1e-4 of the largest
  term, since the pair enters W and f_a alike.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import adress as jadress
from obmd_tpu import engine_cellpad as jec
from obmd_tpu import rigid as jrigid
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.integrate import make_step as jmake_step
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import adress as padress
from obmd_tpu_torch import convert
from obmd_tpu_torch import rigid as prigid
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.config import (Capacity, DPDParams, MolTemplate,
                                   ObmdParams, SceneConfig, UsherParams)
from obmd_tpu_torch.geometry import Box, RegionBlock
from obmd_tpu_torch.integrate import make_step, setup
from obmd_tpu_torch.observe import molecular_pxx, rigid_error
from obmd_tpu_torch.state import init_state

from test_torch_obmd_lj import to_jax
from test_torch_rounds import _zero_kernel
from test_torch_support import CPU, JaxMolDraws, jax_arrays

L = 4.0


def jax_midpoint(box, x, v, mass, bond1, bond2, member, rounds, dt,
                 more_partners=()):
    """obmd_tpu.rigid.rigid_kinematics with the port's one departure, from
    the JAX package's own functions: the body turns about the angular
    velocity of its half-step orientation, (R(omega0 dt/2) I R^T)^-1 L,
    not about omega0."""
    M, rbar, V, Lm, I6 = jrigid.body_moments(box, x, v, mass, bond1, bond2,
                                             member, rounds,
                                             more_partners=more_partners)
    om = jrigid._solve_omega(I6, Lm)
    om = jrigid._solve_omega(jrigid._rotate_inertia(I6, om, 0.5 * dt), Lm)
    r_new = jrigid._rotate(-rbar, om, dt)
    om2 = jrigid._solve_omega(jrigid._rotate_inertia(I6, om, dt), Lm)
    return x + rbar + dt * V + r_new, V + jnp.cross(om2, r_new)


TRIMER = MolTemplate(
    dx=((-0.5, -0.15, 0.0), (0.0, 0.25, 0.0), (0.5, -0.15, 0.0)),
    types=(0, 0, 0), q=(0.0, 0.0, 0.0), bonds=((0, 1), (1, 2)))


def _rel(got, want):
    """max |got - want| over the largest |want| (1 where it is 0)."""
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


def _bodies(kind, seed=3, n_bodies=12):
    """(x [n, 3], v, types, mol, bonds as 1-based tag pairs, diameter) of
    random bodies of one kind in the periodic L^3 box, the first two
    straddling a face, then two free atoms (mol 0)."""
    r = np.random.default_rng(seed)
    xs, bonds, mol, diam = [], [], [], 1
    for b in range(n_bodies):
        if kind == "chains":
            k = 2 + b % 4                      # 2..5 atoms
            steps = r.normal(0.0, 0.35, (k - 1, 3))
            pts = np.concatenate([np.zeros((1, 3)), np.cumsum(steps, 0)])
            edges = [(i, i + 1) for i in range(k - 1)]
            diam = max(diam, k - 1)
        else:
            arms = 3 if kind == "trees" else 4
            pts = np.concatenate([np.zeros((1, 3)),
                                  r.normal(0.0, 0.4, (arms, 3))])
            edges = [(0, i) for i in range(1, arms + 1)]
            diam = 2
        c = (np.asarray([L - 0.1, 0.05, 2.0]) if b < 2
             else r.uniform(0.5, L - 0.5, 3))
        base = sum(len(p) for p in xs)
        xs.append(pts - pts.mean(0) + c)
        bonds += [(base + i + 1, base + j + 1) for i, j in edges]
        mol += [b + 1] * len(pts)
    xs.append(r.uniform(0.0, L, (2, 3)))
    mol += [0, 0]
    x = np.mod(np.concatenate(xs), L).astype(np.float32)
    v = r.normal(0.0, 1.0, x.shape).astype(np.float32)
    types = (np.arange(len(x)) % 2).astype(np.int32)
    return x, v, types, np.asarray(mol), np.asarray(bonds), diam


def _scene_cfg(branched, n_max):
    return SceneConfig(
        box=Box((0.0,) * 3, (L,) * 3, (True,) * 3), masses=(1.0, 2.5),
        pair=DPDParams.create(temp=0.0, cutoff=1.0, seed=3, a0=0.0,
                              gamma=0.0, ntypes=2),
        dt=0.01, capacity=Capacity(n_max=n_max, cell_capacity=40),
        rigid=True, skin=0.3, branched_topology=branched,
        force_path="nlist").finalize()


def _states(kind):
    x, v, types, mol, bonds, diam = _bodies(kind)
    cfg = _scene_cfg(kind == "branched", len(x) + 6)
    jcfg = to_jax(cfg)
    jst = jinit_state(jcfg, x, v=v, types=types, mol=mol, bonds=bonds)
    pst = convert.from_arrays(jax_arrays(jst), device=CPU)
    return cfg, jcfg, pst, jst, diam


@pytest.mark.parametrize("kind", ["chains", "trees", "branched"])
def test_body_moments_match_jax(kind):
    """M, rbar, V, L, I and the drift's (x, v) from raw arrays, every
    column of a branched topology passed, at the bodies' diameter."""
    cfg, jcfg, pst, jst, diam = _states(kind)
    jbox = JBox(cfg.box.lo, cfg.box.hi, cfg.box.periodic)
    mass = np.asarray((1.0, 2.5), np.float32)[pst.type.numpy()]
    member = (pst.alive & (pst.mol != 0)).numpy()
    cols = [c.numpy() for c in pst.bond_partners]
    args_p = (torch.from_numpy(mass), *[torch.from_numpy(c) for c in cols[:2]],
              torch.from_numpy(member), diam)
    args_j = (jnp.asarray(mass), *[jnp.asarray(c) for c in cols[:2]],
              jnp.asarray(member), diam)
    more_p = tuple(torch.from_numpy(c) for c in cols[2:])
    more_j = tuple(jnp.asarray(c) for c in cols[2:])
    got = prigid.body_moments(cfg.box, pst.x, pst.v, *args_p,
                              more_partners=more_p)
    want = jrigid.body_moments(jbox, jst.x, jst.v, *args_j,
                               more_partners=more_j)
    for g, w in zip(got, want):
        assert _rel(g.numpy()[member], np.asarray(w)[member]) < 1e-5
    assert float(got[0][member].min()) > 1.0    # every body summed whole
    dt = np.float32(0.01)
    got = prigid.rigid_kinematics(cfg.box, pst.x, pst.v, *args_p, float(dt),
                                  more_partners=more_p)
    want = jax_midpoint(jbox, jst.x, jst.v, *args_j, dt,
                        more_partners=more_j)
    solid = member & ~_linear(pst)
    for g, w in zip(got, want):
        assert _rel(g.numpy()[solid], np.asarray(w)[solid]) < 1e-5
    _hold_dimers(cfg, pst, got[0].numpy(), np.asarray(want[0]), mass)


def _linear(pst):
    """bool [N]: the atoms of two-atom bodies.  A dimer is a linear body:
    its inertia is singular along the bond, and the regularised solve
    (1e-6 of the trace) turns the float32 residue of L along the axis into
    an omega component of order 1e3 in both packages, so the axis its
    drift turns about and its new velocities carry rounding amplified to
    1e-4 that no two operation orders share; tests hold its positions'
    invariants (_hold_dimers) and leave its velocities out."""
    mol = pst.mol.numpy()
    member = pst.alive.numpy() & (mol != 0)
    size = np.bincount(mol[member], minlength=mol.max() + 1)[mol]
    return torch.from_numpy(member & (size == 2)).numpy()


def _hold_dimers(cfg, pst, got, want, mass):
    """Each dimer's bond length kept within 1e-5 by both packages, and
    its centre of mass within 1e-3 of JAX's (each atom solves its body's
    ill-conditioned omega in its own frame, so a dimer's two atoms turn
    about axes apart by that amplified rounding, in both packages)."""
    lin = _linear(pst)
    if not lin.any():
        return
    m = mass[lin].reshape(-1, 2, 1)
    x0 = pst.x.numpy()[lin].reshape(-1, 2, 3)
    ends = []
    for x in (got, want):
        pair = x[lin].reshape(-1, 2, 3)
        d = cfg.box.min_image(torch.from_numpy(pair[:, 1] - pair[:, 0]))
        com = pair[:, 0] + (m[:, 1] * d.numpy()) / m.sum(1)
        ends.append(com)
        d0 = cfg.box.min_image(torch.from_numpy(x0[:, 1] - x0[:, 0]))
        assert np.abs(d.norm(dim=1).numpy()
                      - d0.norm(dim=1).numpy()).max() < 1e-5
    assert np.abs(ends[0] - ends[1]).max() < 1e-3


@pytest.mark.parametrize("kind", ["chains", "trees", "branched"])
def test_drift_and_project_match_jax(kind, monkeypatch):
    """The state-level functions on bodies of diameter <= 2 (chains of 2
    and 3 atoms), dead slots and free atoms included (the JAX drift with
    the port's turn, jax_midpoint)."""
    monkeypatch.setattr(jrigid, "rigid_kinematics", jax_midpoint)
    cfg, jcfg, pst, jst, _ = _states(kind)
    if kind == "chains":
        keep = (pst.mol.numpy() % 4 != 0) & (pst.mol.numpy() % 4 != 3)
        keep |= pst.mol.numpy() == 0
        alive = torch.from_numpy(pst.alive.numpy() & keep)
        pst = pst.replace(alive=alive)
        jst = jst.replace(alive=jnp.asarray(alive.numpy()))
    prigid.check_bodies(cfg, pst)
    v = pst.v * 1.1
    px, pv = prigid.rigid_drift(cfg, pst, v)
    jx, jv = jrigid.rigid_drift(jcfg, jst, jnp.asarray(v.numpy()))
    a = pst.alive.numpy()
    solid = a & ~_linear(pst)
    assert _rel(px.numpy()[solid], np.asarray(jx)[solid]) < 1e-5
    assert _rel(pv.numpy()[solid], np.asarray(jv)[solid]) < 1e-5
    mass = np.asarray((1.0, 2.5), np.float32)[pst.type.numpy()]
    _hold_dimers(cfg, pst, px.numpy(), np.asarray(jx), mass)
    got = prigid.rigid_project(cfg, pst, v)
    want = jrigid.rigid_project(jcfg, jst, jnp.asarray(v.numpy()))
    assert _rel(got.numpy()[solid], np.asarray(want)[solid]) < 1e-5


def _geometry(xs, box_y=0.0):
    """(r1, r2, angle in degrees) of a trimer (tests/test_rigid.py)."""
    d1 = xs[0] - xs[1]
    d2 = xs[2] - xs[1]
    if box_y:
        for d in (d1, d2):
            d[1:] -= box_y * np.round(d[1:] / box_y)
    r1, r2 = np.linalg.norm(d1), np.linalg.norm(d2)
    return r1, r2, np.degrees(np.arccos(np.dot(d1, d2) / (r1 * r2)))


def _free_trimer(force_path):
    cfg = SceneConfig(
        box=Box((0.0, 0.0, 0.0), (12.0, 6.0, 6.0), (False, True, True)),
        masses=(1.0,), dt=0.005,
        pair=DPDParams.create(temp=0.0, cutoff=1.0, seed=3, a0=0.0,
                              gamma=0.0),
        capacity=Capacity(n_max=64, cell_capacity=12), rigid=True,
        skin=0.3, force_path=force_path).finalize()
    xs0 = np.asarray(TRIMER.dx) + np.asarray([6.0, 3.0, 3.0])
    com = xs0.mean(axis=0)
    v0 = np.cross([0.0, 0.0, 2.0], xs0 - com) + np.asarray([0.0, 0.3, 0.0])
    args = dict(v=v0, mol=np.array([1, 1, 1]), bonds=np.array([[1, 2],
                                                                [2, 3]]))
    return cfg, xs0, args


@pytest.fixture(scope="module")
def tumbling():
    """The free trimer after 1,000 steps: JAX's nlist engine (with the
    port's turn, jax_midpoint) and the port's nlist and cellpad
    engines."""
    cfg, xs0, args = _free_trimer("nlist")
    jcfg = to_jax(cfg)
    jst = jsetup(jcfg, jinit_state(jcfg, xs0, **args))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrigid, "rigid_kinematics", jax_midpoint)
        step = jax.jit(jmake_step(jcfg))
        for _ in range(1000):
            jst = step(jst)
    out = {"jax": (np.asarray(jst.x)[:3], np.asarray(jst.v)[:3])}
    for path in ("nlist", "cellpad"):
        cfg, xs0, args = _free_trimer(path)
        st = setup(cfg, init_state(cfg, xs0, device=CPU, **args))
        step = make_step(cfg)
        for _ in range(1000):
            st = step(st)
        order = torch.argsort(torch.where(st.alive, st.tag, 1 << 30))[:3]
        out[path] = (st.x[order].numpy(), st.v[order].numpy())
    return xs0, out


@pytest.mark.parametrize("engine", ["nlist", "cellpad"])
def test_free_rigid_body_tumbles_as_jax(tumbling, engine):
    """tests/test_rigid.py's first scene's gates on the port (geometry to
    2e-4, the angle to 0.1 degree, a turned axis, the COM momentum to
    2e-4), and the positions within 1e-3 of the JAX run's."""
    xs0, out = tumbling
    xs, v = out[engine]
    r1a, r2a, anga = _geometry(xs0.copy())
    r1b, r2b, angb = _geometry(xs.copy(), box_y=6.0)
    assert abs(r1b - r1a) < 2e-4 and abs(r2b - r2a) < 2e-4, (r1a, r1b, r2b)
    assert abs(angb - anga) < 0.1, (anga, angb)
    ax0 = (xs0[2] - xs0[0]) / np.linalg.norm(xs0[2] - xs0[0])
    d20 = xs[2] - xs[0]
    d20[1:] -= 6.0 * np.round(d20[1:] / 6.0)
    assert abs(np.dot(ax0, d20 / np.linalg.norm(d20))) < 0.999
    np.testing.assert_allclose(v.mean(axis=0), [0.0, 0.3, 0.0], atol=2e-4)
    d = xs - out["jax"][0]
    d[:, 1:] -= 6.0 * np.round(d[:, 1:] / 6.0)
    assert np.abs(d).max() < 1e-3


def _insert_cfg(a0, gamma, temp, nbuf, n_max, cap):
    """tests/test_rigid.py's insertion scene (near 0.4, K 4, the trimer)
    on the cellpad engine."""
    box = Box((0.0, 0.0, 0.0), (12.0, 6.0, 6.0), (False, True, True))
    r1 = RegionBlock((0.0, 0.0, 0.0), (2.0, 6.0, 6.0))
    r2 = RegionBlock((10.0, 0.0, 0.0), (12.0, 6.0, 6.0))
    obmd = ObmdParams(
        ntype=0, nfreq=1, seed=11, pxx=1.0, alpha=0.5, tau=0.01, nbuf=nbuf,
        region1=r1, region2=r2, region5=r1, region6=r2, buffer_size=2.0,
        near=0.4, mol=TRIMER, mol_len=3, insert_kmax=4, rigid=True)
    return SceneConfig(
        box=box, masses=(1.0,), dt=0.005,
        pair=DPDParams.create(temp=temp, cutoff=1.0, seed=3, a0=a0,
                              gamma=gamma),
        capacity=Capacity(n_max=n_max, cell_capacity=cap), obmd=obmd,
        skin=0.3, force_path="cellpad").finalize()


def _trimers(st):
    """[(r1, r2, angle)] of every whole live trimer, atoms by tag."""
    alive, tags = st.alive.numpy(), st.tag.numpy()
    mols, xs = st.mol.numpy(), st.x.numpy()
    out = []
    for mid in np.unique(mols[alive & (mols > 0)]):
        rows = np.where(alive & (mols == mid))[0]
        if len(rows) == 3:
            rows = rows[np.argsort(tags[rows])]
            out.append(_geometry(xs[rows].astype(np.float64), box_y=6.0))
    return out


def test_rigid_insertion_matches_jax(monkeypatch):
    """12 steps of rigid trimer insertion under a force-free law, the JAX
    engine's draws injected (and the port's turn, jax_midpoint): slot for
    slot."""
    cfg = _insert_cfg(0.0, 0.0, 0.0, 40.0, 700, 22)
    jcfg = to_jax(cfg)
    assert convert.scene_config(jcfg).finalize() == cfg   # rigid crosses
    r = np.random.default_rng(7)
    x = r.uniform([0.05, 0.05, 0.05], [11.95, 5.95, 5.95], (240, 3))
    v = r.normal(0, 0.5, (240, 3))
    j0 = jinit_state(jcfg, x, v=v, seed=5)
    pst = convert.from_arrays(jax_arrays(j0), device=CPU)
    monkeypatch.setattr(jec, "_make_kernel", _zero_kernel)
    monkeypatch.setattr(jrigid, "rigid_kinematics", jax_midpoint)
    jst = jsetup(jcfg, j0)
    jstep = jax.jit(jmake_step(jcfg))
    draws = JaxMolDraws(cfg, 5)
    pst = setup(cfg, pst, draw=draws)
    step = make_step(cfg, draw=draws)
    for _ in range(12):
        jst, pst = jstep(jst), step(pst)
    jd, pd = jax_arrays(jst), convert.to_arrays(pst)
    for k in ("tag", "alive", "mol", "bond1", "bond2", "ninserted",
              "ndeleted"):
        assert np.array_equal(np.asarray(pd[k]), jd[k]), k
    for k in ("x", "v"):
        np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert int(jd["ninserted"]) >= 3 and _trimers(pst)


def test_rigid_insertion_holds_geometry():
    """tests/test_rigid.py's second scene on the port: rigid trimers
    inserted under the feedback law into a live DPD fluid hold the
    template's arms (5e-3) and angle (1 degree) after 150 steps; the
    bodies' largest distance error against the template is reported by
    observe.rigid_error."""
    cfg = _insert_cfg(15.0, 2.0, 0.5, 40.0, 1200, 22)
    r = np.random.default_rng(7)
    x = r.uniform([0.05, 0.05, 0.05], [11.95, 5.95, 5.95], (420, 3))
    v = r.normal(0, 0.5, (420, 3))
    st = setup(cfg, init_state(cfg, x, v=v, device=CPU))
    step = make_step(cfg)
    for _ in range(150):
        st = step(st)
    n_ins = int(st.obmd.ninserted)
    assert n_ins >= 3 and n_ins % 3 == 0, n_ins
    tpl = np.asarray(TRIMER.dx)
    arm = np.linalg.norm(tpl[0] - tpl[1])
    ang_t = _geometry(tpl.copy())[2]
    bodies = _trimers(st)
    assert bodies
    for r1, r2, ang in bodies:
        assert abs(r1 - arm) < 5e-3 and abs(r2 - arm) < 5e-3, (r1, r2)
        assert abs(ang - ang_t) < 1.0, (ang, ang_t)
    assert rigid_error(cfg, st) < 5e-3


def _free_water_energy(kinematics, xp, steps, dt=0.002, spin=14.0):
    """A free SPC/E water turning at `spin` rad/ps an axis (about kT's
    rate), stepped `steps` times by kinematics(box, x, v, mass, b1, b2,
    member, rounds, dt) on numpy-built float32 inputs through `xp` (jnp or
    torch): its kinetic energy at the start and the end."""
    tpl = (pscenes.water_template_coords() + 10.0).astype(np.float32)
    mass = np.asarray(pscenes.WATER_MASSES, np.float32)[[0, 1, 1]]
    w = np.random.default_rng(2).normal(0.0, 1.0, 3) * spin
    com = (mass[:, None] * tpl).sum(0) / mass.sum()
    v = np.cross(w, tpl - com).astype(np.float32)
    b1 = np.asarray([1, 0, 0], np.int32)
    b2 = np.asarray([2, -1, -1], np.int32)
    box = (JBox if xp is jnp else Box)((0.0,) * 3, (20.0,) * 3,
                                      (True,) * 3)
    a = (xp.asarray if xp is jnp else torch.from_numpy)
    args = [a(t) for t in (mass, b1, b2, np.ones(3, bool))] + [2, dt]
    x, vv = a(tpl), a(v)
    e0 = 0.5 * float((mass[:, None] * v ** 2).sum())
    for _ in range(steps):
        x, vv = kinematics(box, x, vv, *args)
    e1 = 0.5 * float((mass[:, None] * np.asarray(vv) ** 2).sum())
    return e0, e1


def test_jax_turn_heats_a_free_water():
    """The one departure from the JAX package: its drift turns a body
    about omega0 = I^-1 L, which raises a free asymmetric body's kinetic
    energy by dt^2/2 (omega0 x L) . I^-1 (omega0 x L) every step; over
    2,000 steps at dt 2 fs a free water at kT's rates gains 16% (the
    reason path K ran 5% hot under JAX's scheme).  The port's midpoint
    turn keeps it within 1% (the solve's 1e-6 regularizer leaks L by
    ~2e-6 a step)."""
    step = jax.jit(jrigid.rigid_kinematics, static_argnums=(0, 7))
    e0, e1 = _free_water_energy(step, jnp, 2000)
    assert e1 > 1.1 * e0, (e0, e1)
    e0, e1 = _free_water_energy(prigid.rigid_kinematics, torch, 2000)
    assert abs(e1 / e0 - 1.0) < 1e-2, (e0, e1)


def test_refusals():
    """A template whose bonds close a cycle (finalize), and at setup a
    scene body with a cycle or across more bonds than 2 rounds reach."""
    cyc = dataclasses.replace(TRIMER, bonds=((0, 1), (1, 2), (0, 2)))
    with pytest.raises(ValueError, match="template 0's bond graph has a "
                                         "cycle"):
        dataclasses.replace(_insert_cfg(0.0, 0.0, 0.0, 40.0, 64, 12),
                            obmd=dataclasses.replace(
                                _insert_cfg(0.0, 0.0, 0.0, 40.0, 64,
                                            12).obmd, mol=cyc)).finalize()
    cfg, xs0, args = _free_trimer("nlist")
    xs = np.concatenate([xs0, xs0[:1] + [0.0, 0.0, 0.5]])
    mol = np.array([1, 1, 1, 1])
    for bonds, word in (([[1, 2], [2, 3], [1, 3]], "has a cycle"),
                        ([[1, 2], [2, 3], [1, 4]], "spans more than 2")):
        for path in ("nlist", "cellpad"):
            c = dataclasses.replace(cfg, force_path=path)
            st = init_state(c, xs, mol=mol, bonds=np.asarray(bonds),
                            device=CPU)
            with pytest.raises(ValueError, match=word):
                setup(c, st)


def _one_water(triangle: bool):
    tpl = pscenes.water_template_coords() + [1.0, 1.0, 1.0]
    bonds = pscenes.WATER_BONDS if triangle else pscenes.WATER_TREE_BONDS
    b1, b2 = -np.ones(3, np.int32), -np.ones(3, np.int32)
    for i, j in bonds:
        for a, b in ((i, j), (j, i)):
            if b1[a] < 0:
                b1[a] = b
            else:
                b2[a] = b
    mass = np.asarray(pscenes.WATER_MASSES, np.float32)[[0, 1, 1]]
    return tpl.astype(np.float32), mass, b1, b2


@pytest.mark.parametrize("triangle", [True, False])
def test_jax_masses_on_the_water(triangle):
    """JAX's body_moments at path I's 2 rounds: on the triangle the O
    reads M = 20.0314 and each H 35.0228 (an H's message comes back round the
    cycle), each atom a different centre of mass; on the tree every atom
    reads 18.0154 and one centre; the port agrees with JAX either way."""
    x, mass, b1, b2 = _one_water(triangle)
    box = JBox((0.0,) * 3, (3.0,) * 3, (True,) * 3)
    v = np.zeros_like(x)
    M, rbar, *_ = jrigid.body_moments(box, x, v, mass, b1, b2,
                                      np.ones(3, bool), 2)
    M, com = np.asarray(M)[:, 0], np.asarray(rbar) + x
    if triangle:
        np.testing.assert_allclose(M, [20.0314, 35.0228, 35.0228],
                                   rtol=1e-5)
        assert np.abs(com - com[0]).max() > 1e-3
    else:
        np.testing.assert_allclose(M, 18.0154, rtol=1e-5)
        assert np.abs(com - com[0]).max() < 1e-6
    pM, *_ = prigid.body_moments(
        Box((0.0,) * 3, (3.0,) * 3, (True,) * 3), torch.from_numpy(x),
        torch.from_numpy(v), torch.from_numpy(mass), torch.from_numpy(b1),
        torch.from_numpy(b2), torch.ones(3, dtype=torch.bool), 2)
    np.testing.assert_allclose(pM.numpy()[:, 0], M, rtol=1e-6)


def test_update_mol_com_on_the_triangle():
    """Both packages' update_mol_com on 40 SPC/E waters (18 across a
    periodic face) give the same cms_mol and vcms_mol (1e-6 nm, 1e-5
    nm/ps).  On path I's triangle they lie off the exact centre of mass by
    0.00516 nm at the O and 0.00277 nm at an H (the cycle counts atoms
    more than once); on the tree they lie on it (1e-5 nm).  Either way a
    water across a periodic face reads a centre off by 0.18-1.48 nm: the
    payload sums absolute positions, with no minimum image."""
    from test_torch_shake import _cfg, _waters
    x, types, q, mol, bonds = _waters(40, 2, spacing=1.6)
    xw = x.reshape(-1, 3, 3).astype(np.float64)
    across = np.abs(xw - xw[:, :1])[..., 1:].max((1, 2)) > L / 2
    assert across.sum() == 18
    d = xw - xw[:, :1]
    d[..., 1:] -= L * np.round(d[..., 1:] / L)
    mw = np.asarray(pscenes.WATER_MASSES)[types].reshape(-1, 3, 1)
    exact = xw[:, :1] + (mw * d).sum(1, keepdims=True) \
        / mw.sum(1, keepdims=True)
    v = np.random.default_rng(1).normal(0.0, 0.5, x.shape)
    for tree in (False, True):
        if tree:
            bonds = pscenes._water_topology(40, tree=True)[3]
        cfg = _cfg(n_max=126)
        jcfg = to_jax(cfg)
        jst = jinit_state(jcfg, x, v=v, types=types, q=q, mol=mol,
                          bonds=bonds)
        pst = convert.from_arrays(jax_arrays(jst), device=CPU)
        jout = jadress.update_mol_com(jcfg, jst)
        pout = padress.update_mol_com(cfg, pst)
        a = pst.alive.numpy()
        np.testing.assert_allclose(pout.cms_mol.numpy()[a],
                                   np.asarray(jout.cms_mol)[a], atol=1e-6)
        np.testing.assert_allclose(pout.vcms_mol.numpy()[a],
                                   np.asarray(jout.vcms_mol)[a], atol=1e-5)
        off = pout.cms_mol.numpy()[:len(x)].reshape(-1, 3, 3) - exact
        off[..., 1:] -= L * np.round(off[..., 1:] / L)
        off = np.linalg.norm(off, axis=-1)
        inner = off[~across]
        if tree:
            assert inner.max() < 1e-5
        else:
            np.testing.assert_allclose(inner[:, 0], 0.00516, atol=1e-5)
            np.testing.assert_allclose(inner[:, 1:], 0.00277, atol=1e-5)
        assert 0.18 < off[across].min() and off[across].max() < 1.48


def test_molecular_pxx_tree_equals_triangle():
    """Path K's H-H pair is in the pair law and path I's is excluded; the
    molecular P_xx of one state agrees (its W and f_a hold the pair
    alike), and the atomic one differs."""
    from test_torch_shake import _cfg, _waters
    x, types, q, mol, bonds = _waters(60, 5, spacing=1.1)
    v = np.random.default_rng(2).normal(0.0, 0.5, x.shape)
    out = []
    for tree in (False, True):
        cfg = _cfg(n_max=200)
        if tree:
            cfg = dataclasses.replace(cfg, shake=None, rigid=True)
            bonds = pscenes._water_topology(60, tree=True)[3]
        st = init_state(cfg, x, v=v, types=types, q=q, mol=mol,
                        bonds=bonds, device=CPU)
        out.append(molecular_pxx(cfg, st, k_max=200))
    (mol_i, atom_i), (mol_k, atom_k) = out
    assert abs(mol_k - mol_i) <= 1e-4 * max(abs(mol_i), abs(atom_i))
    assert abs(atom_k - atom_i) > 1e-3 * abs(atom_i)
