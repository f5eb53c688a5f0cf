"""The rest of molecule-mode insertion against obmd_tpu's cellpad engine:
several templates (`mols`/`molfrac`), `charged 1`, `orient`, `maxattempt`
rounds on appended subsets, `nfreq 2`, the inserted-velocity keywords and
the candidate keywords, each slot for slot with the JAX engine's own draws
injected (test_torch_support.JaxMolDraws: the template indices among them).

- One stage call (`_obmd_stage`, so `_insert_mol` with its rounds) per
  keyword set on a gas of monomers under one-type DPD (10 x 4 x 4, its
  buffers drained) with tests/test_molfrac.py's dimer and trimer, or on a
  dilute SPC/E water box under lj/cut/rf with `charged 1` and `shake`
  (path I's stage at a small size); nattempt 0, so each trial's verdict is
  its initial energy against the gate, which no float32 summation order
  flips: slots, tags, alive, mol, the partner columns, maxtag, the kernel
  caches and every counter exactly; x, v and xref within 1e-5; the
  setpoints, which hold the inserted momentum over dt, within 2e-6
  relative plus 1e-3.
- `charged 1`'s trial energy: the port's mol_energy_force(mol_q=...)
  against JAX's and against the float64 transcription of the reference's
  single_atomistic_obmd (tests/test_charged.py), within 2e-4.
- make_run (5 steps) and make_step (3 steps) at nfreq 2 with two
  templates, two rounds and inserted velocities, after setup, under a
  force-free DPD law: the JAX pair kernel's output is zero, so the test
  stands in zeros for it (its interpret mode takes minutes on the CPU)
  and the port runs its plain version.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from obmd_tpu import engine_cellpad as jec
from obmd_tpu.cellpad import layout_build as j_layout_build
from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import make_step as jmake_step
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.obmd import subset as jsubset
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import convert
from obmd_tpu_torch import engine_cellpad as pec
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.config import (Capacity, DPDParams, MolTemplate,
                                   ObmdParams, SceneConfig, UsherParams)
from obmd_tpu_torch.geometry import Box, RegionBlock
from obmd_tpu_torch.integrate import make_run, make_step, setup
from obmd_tpu_torch.obmd import subset as psubset
from obmd_tpu_torch.observe import molecule_census

from test_charged import _rf_oracle_energy
from test_torch_obmd_lj import to_jax
from test_torch_rounds import _zero_kernel
from test_torch_support import CPU, JaxMolDraws, jax_arrays

EXACT = ("type", "tag", "alive", "mol", "bond1", "bond2", "q", "step",
         "maxtag", "cell_overflow", "ndeleted", "ninserted", "insert_fail",
         "usher_iters", "rebuilds", "overflow", "skin_trips", "tag3d", "occ")
CLOSE = ("x", "v", "xref", "sim_time")
SETPOINTS = ("momentum_force_left", "momentum_force_right",
             "shear_force_left", "shear_force_right")
DIMER = MolTemplate(dx=((-0.45, 0.0, 0.0), (0.45, 0.0, 0.0)),
                    types=(0, 0), q=(0.0, 0.0), bonds=((0, 1),))
TRIMER = MolTemplate(
    dx=((-0.5, -0.15, 0.0), (0.0, 0.25, 0.0), (0.5, -0.15, 0.0)),
    types=(0, 0, 0), q=(0.0, 0.0, 0.0), bonds=((0, 1), (1, 2)))
V = (-1.732, 1.732)
# one stage call's keyword sets on the monomer gas
STAGES = {
    "molfrac-rounds2": dict(mols=(DIMER, TRIMER), molfrac=(0.3, 0.7),
                            maxattempt=2),
    "orient": dict(orient=(0.0, 0.0, 1.0)),
    "rounds3": dict(maxattempt=3, etarget=40.0),
    "velocities-target": dict(vx=V, vy=V, vz=(0.0, 2.0),
                              target=(5.0, 2.0, 2.0)),
    "gaussian-rounds2": dict(gaussian=(1.0, 2.0, 2.0, 0.6), maxattempt=2),
    "global": dict(deposit_global=(-1.5, -0.2)),
    "local-rate": dict(deposit_local=(-2.0, -0.5, 0.9), rate=-1.0),
    "rate-molfrac": dict(rate=3.0, mols=(TRIMER, DIMER)),
}


def gas_config(pair=None, etarget=12.0, nbuf=200.0, **kw):
    """The monomer gas: one-type DPD (or `pair`) in 10 x 4 x 4, x open,
    buffers and insertion regions of 2.0, USHER at nattempt 0, the trimer
    (or kw's templates), K = 6; kw replaces ObmdParams fields."""
    box = Box((0.0, 0.0, 0.0), (10.0, 4.0, 4.0), (False, True, True))
    r1 = RegionBlock((0.0, 0.0, 0.0), (2.0, 4.0, 4.0))
    r2 = RegionBlock((8.0, 0.0, 0.0), (10.0, 4.0, 4.0))
    deg = RegionBlock((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    args = dict(ntype=0, nfreq=1, seed=11, pxx=5.0, alpha=0.5, tau=0.01,
                nbuf=nbuf, region1=r1, region2=r2, region3=deg, region4=deg,
                region5=r1, region6=r2, buffer_size=2.0,
                usher=UsherParams(etarget=etarget, nattempt=0),
                mol=TRIMER, mol_len=2, insert_kmax=6)
    args.update(kw)
    if "mols" in kw:
        args["mol"] = kw["mols"][0]
    pair = pair or DPDParams.create(temp=1.0, cutoff=1.0, seed=3, a0=25.0,
                                    gamma=4.5)
    pcfg = SceneConfig(box=box, masses=(1.0,), pair=pair, dt=0.01,
                       capacity=Capacity(n_max=900, cell_capacity=22),
                       obmd=ObmdParams(**args), skin=0.3,
                       force_path="cellpad").finalize()
    return jax_config(pcfg), pcfg


def jax_config(pcfg):
    """The JAX config of a port config; with several templates the JAX
    ObmdParams takes its own mols[0] as `mol` (its check is by
    identity)."""
    o = pcfg.obmd
    if not o.mols:
        return to_jax(pcfg).finalize()
    j = to_jax(dataclasses.replace(pcfg, obmd=dataclasses.replace(
        o, mols=(), molfrac=None)))
    jm = tuple(to_jax(t) for t in o.mols)
    return dataclasses.replace(j, obmd=dataclasses.replace(
        j.obmd, mol=jm[0], mols=jm, molfrac=o.molfrac)).finalize()


def water_config(**kw):
    """path I's stage on a dilute water box of 33 lattice planes (9.92 x 6
    x 6 nm) at nattempt 0 and etarget 0 kJ/mol (`charged 1`, `shake`,
    the velocity keywords): a neutral trial passes unless an O overlaps,
    a charged one fails on half its dipole orientations."""
    kw = {"usher": UsherParams(etarget=0.0, nattempt=0), **kw}
    pcfg = pscenes.open_water_config(planes=33, cap=24, n_max=1200,
                                     nbuf=60.0, **kw)
    return to_jax(pcfg).finalize(), pcfg


def _laid_out(jcfg, jst):
    return j_layout_build(jec.make_geometry(jcfg), jcfg.box, jst.replace(
        x=jcfg.box.wrap(jst.x)))


@functools.lru_cache(maxsize=None)
def gas_start():
    """The JAX state of 260 uniform monomers (numpy seed 4), sim_time 0.25,
    those of the buffers' outer halves taken out."""
    jcfg, _ = gas_config()
    r = np.random.default_rng(4)
    x = r.uniform([0.05, 0.05, 0.05], [9.95, 3.95, 3.95], (260, 3))
    x = x[(x[:, 0] > 1.0) & (x[:, 0] < 9.0)]
    jst = jinit_state(jcfg, x, v=r.normal(0.0, 1.0, x.shape))
    return _laid_out(jcfg, jst.replace(sim_time=jnp.float32(0.25)))


@functools.lru_cache(maxsize=None)
def water_start():
    """The JAX state of 125 waters at random orientations (numpy seed 6)
    on a 1.1 nm lattice from x = 0.6 (the left buffer holds some)."""
    jcfg, _ = water_config()
    r = np.random.default_rng(6)
    tpl = pscenes.water_template_coords()
    tpl = tpl - tpl.mean(0)
    g = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"),
                 -1).reshape(-1, 3) * 1.1 + [0.6, 0.3, 0.3]
    x = (g[:, None] + np.einsum("sij,kj->ski", pscenes._rotations(r, 125),
                                tpl)).reshape(-1, 3)
    types, q, mol, bonds = pscenes._water_topology(125)
    jst = jinit_state(jcfg, x, v=r.normal(0.0, 0.3, x.shape), types=types,
                      q=q, mol=mol, bonds=bonds)
    return _laid_out(jcfg, jst)


def assert_match(jd, pd, with_f=False):
    for k in EXACT:
        assert np.array_equal(np.asarray(pd[k]), jd[k]), \
            (k, np.argwhere(np.asarray(pd[k]) != jd[k])[:4])
    for k in CLOSE:
        np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    for k in SETPOINTS:
        np.testing.assert_allclose(pd[k], jd[k], rtol=2e-6, atol=1e-3,
                                   err_msg=k)
    if with_f:
        fmax = np.abs(jd["f"]).max()
        assert np.abs(pd["f"] - jd["f"]).max() <= 2e-4 * max(fmax, 1e-30)


def one_stage(jcfg, pcfg, jst):
    """Both engines' _obmd_stage on one state: (JAX arrays, port
    arrays)."""
    jg = jec.make_geometry(jcfg)
    j2 = jax.jit(lambda s: jec._obmd_stage(jcfg, jg, s))(jst)
    pst = convert.from_arrays(jax_arrays(jst), device=CPU)
    p2 = pec._obmd_stage(pcfg, pec.make_geometry(pcfg), pst,
                         JaxMolDraws(pcfg, 0))
    return jax_arrays(j2), convert.to_arrays(p2)


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_matches_jax(name):
    jcfg, pcfg = gas_config(**STAGES[name])
    jst = gas_start()
    jd, pd = one_stage(jcfg, pcfg, jst)
    assert_match(jd, pd)
    o = pcfg.obmd
    base = int(np.asarray(jst.tag).max())
    new = jd["alive"] & (jd["tag"] > base)
    assert new.sum() > 0, name
    if o.maxattempt == 3:
        # the later rounds inserted: more than one round's K molecules
        mols = len(np.unique(jd["mol"][new]))
        assert mols > 2 * o.insert_kmax, mols
    if o.molfrac is not None:
        sizes = np.bincount(jd["mol"][new])
        assert {2, 3} <= set(sizes[sizes > 0].tolist())
    if o.vx is not None:
        assert np.abs(jd["v"][new]).max() > 0.0
        # a molecule's atoms share one velocity
        for m in np.unique(jd["mol"][new])[:5]:
            vs = jd["v"][new & (jd["mol"] == m)]
            assert np.array_equal(vs, np.broadcast_to(vs[0], vs.shape))
    if o.orient is not None:
        # rotations about z: every inserted trimer's plane stays z = const
        for m in np.unique(jd["mol"][new]):
            zs = jd["x"][new & (jd["mol"] == m), 2]
            assert np.ptp(zs) < 1e-5


def test_velocities_enter_the_tally():
    """The inserted molecules' momentum (the template's masses times the
    drawn velocity) leaves the setpoints: the stage with the velocity
    keywords against the same call at rest differs by sum(M v) / dt."""
    jst = gas_start()
    _, pv = gas_config(**STAGES["velocities-target"])
    _, p0 = gas_config()
    out = []
    for pcfg in (pv, p0):
        pst = convert.from_arrays(jax_arrays(jst), device=CPU)
        out.append(pec._obmd_stage(pcfg, pec.make_geometry(pcfg), pst,
                                   JaxMolDraws(pv, 0)))
    sv, s0 = out
    assert int(sv.obmd.ninserted) == int(s0.obmd.ninserted) > 0
    new = sv.alive & (sv.tag > int(np.asarray(jst.tag).max()))
    mv = sv.v[new].sum(0).double()         # masses 1
    left = new & (sv.x[:, 0] < 5.0)
    mvl = sv.v[left].sum(0).double()
    dt = np.float32(pv.dt)
    dl = (s0.obmd.momentum_force_left - sv.obmd.momentum_force_left).double()
    dr = (s0.obmd.momentum_force_right
          - sv.obmd.momentum_force_right).double()
    np.testing.assert_allclose(dl.numpy(), (mvl / dt).numpy(), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose((dl + dr).numpy(), (mv / dt).numpy(),
                               rtol=1e-5, atol=1e-3)


def test_charged_water_stage_matches_jax():
    """Path I's stage (charged 1, shake, vx/vy/vz) on the water box, and
    the same call with charged 0: both match JAX, and the charges change
    the verdicts."""
    jst = water_start()
    got = {}
    for charged in (True, False):
        jcfg, pcfg = water_config(charged=charged)
        assert pcfg.shake is not None and pcfg.obmd.charged == charged
        jd, pd = one_stage(jcfg, pcfg, jst)
        assert_match(jd, pd)
        got[charged] = jd
        n, broken = molecule_census(pcfg, convert.from_arrays(pd,
                                                              device=CPU))
        assert broken == 0 and n > 125
    assert not np.array_equal(got[True]["alive"], got[False]["alive"])


def test_charged_trial_energy():
    """mol_energy_force with the template charges: the port against JAX
    and the float64 oracle (within 2e-4), and neutral trials differ."""
    _, pcfg = water_config()
    jst = water_start()
    pst = convert.from_arrays(jax_arrays(jst), device=CPU)
    geom = pec.make_geometry(pcfg)
    region = pcfg.obmd.region5
    sub = pec._subset_slice(pcfg, geom, pst, dataclasses.replace(
        region, hi=(6.0, 6.0, 6.0)), pcfg.pair.max_cut + pcfg.skin)
    r = np.random.default_rng(8)
    tpl = np.asarray(pcfg.obmd.mol.dx)
    k = 6
    coords = (np.column_stack([r.uniform(2.5, 4.0, k), r.uniform(0, 6, k),
                               r.uniform(0, 6, k)])[:, None, :]
              + tpl[None]).astype(np.float32)
    types = np.asarray([0, 1, 1], np.int32)
    mq = np.asarray(pcfg.obmd.mol.q, np.float32)
    import torch
    e_p, f_p = psubset.mol_energy_force(
        pcfg, sub, torch.from_numpy(coords), torch.from_numpy(types),
        mol_q=torch.from_numpy(mq))
    jcfg = to_jax(pcfg)
    jsub = jsubset.Subset(
        idx=jnp.zeros(sub.x.shape[:1], jnp.int32), x=jnp.asarray(sub.x),
        type=jnp.asarray(sub.type), q=jnp.asarray(sub.q),
        valid=jnp.asarray(sub.valid), overflow=jnp.asarray(False))
    e_j, f_j = jsubset.mol_energy_force(jcfg, jsub, jnp.asarray(coords),
                                        jnp.asarray(types),
                                        mol_q=jnp.asarray(mq))
    np.testing.assert_allclose(e_p.numpy(), np.asarray(e_j), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), rtol=0,
                               atol=2e-4 * np.abs(np.asarray(f_j)).max())
    valid = sub.valid.numpy()
    p = pcfg.pair
    oracle = dataclasses.replace(p, epsilon=((p.epsilon[0][0],),),
                                 sigma=((p.sigma[0][0],),),
                                 cut=((p.cut[0][0],),),
                                 eps_rf=((p.eps_rf[0][0],),))
    # the oracle is single-type: hold the trials' H rows (eps 0) to it by
    # giving them the O's LJ only where both are O
    sx = sub.x.numpy()[valid].astype(np.float64)
    sq = sub.q.numpy()[valid].astype(np.float64)
    so = sub.type.numpy()[valid] == 0
    e_ref = _rf_oracle_energy(sx, sq, coords[:, :1].astype(np.float64),
                              mq[:1].astype(np.float64),
                              np.asarray(pcfg.box.lengths),
                              pcfg.box.periodic, oracle)
    e_ref += _rf_oracle_energy(
        sx, sq, coords[:, 1:].astype(np.float64), mq[1:].astype(np.float64),
        np.asarray(pcfg.box.lengths), pcfg.box.periodic,
        dataclasses.replace(oracle, epsilon=((0.0,),)))
    # the O rows against subset H: LJ off there too
    e_ref -= _rf_oracle_energy(
        sx[~so], np.zeros((~so).sum()), coords[:, :1].astype(np.float64),
        mq[:1].astype(np.float64), np.asarray(pcfg.box.lengths),
        pcfg.box.periodic, oracle)
    np.testing.assert_allclose(e_p.numpy(), e_ref, rtol=2e-4, atol=2e-4)
    e0, _ = psubset.mol_energy_force(pcfg, sub, torch.from_numpy(coords),
                                     torch.from_numpy(types))
    assert np.abs(e0.numpy() - e_p.numpy()).max() > 1.0


def test_convert_carries_the_keywords():
    """convert.scene_config gives back, field for field, the port's
    configuration of each keyword set (several templates, `charged 1`,
    `orient`, `shake` with its table, the candidate and velocity keywords)
    from its JAX counterpart."""
    cases = [gas_config(**kw)[1] for kw in STAGES.values()]
    cases += [water_config()[1], pscenes.open_water_config()]
    for pcfg in cases:
        back = convert.scene_config(jax_config(pcfg))
        assert back == pcfg
        if pcfg.obmd.mols:
            assert back.obmd.mol is back.obmd.mols[0]
    assert back.shake.iters == pscenes.WATER_SHAKE_ITERS


@pytest.mark.parametrize("etarget", [12.0, 0.0, -92.0])
def test_sequential_accept_at_each_sign_of_etarget(etarget):
    """mol_sequential_accept on 8 water trials, two pairs of them within
    the cutoff: at etarget >= 0 the port takes what JAX's takes; at a
    negative etarget JAX's takes none (its empty sum of pair energies
    already exceeds the gate) and the port takes the first ok trial only,
    as ATOM mode's acceptance does."""
    import torch
    _, pcfg = water_config(usher=UsherParams(etarget=etarget, nattempt=0))
    jcfg = to_jax(pcfg)
    r = np.random.default_rng(3)
    tpl = np.asarray(pcfg.obmd.mol.dx)
    centers = np.column_stack([r.uniform(0.3, 1.2, 8), r.uniform(0, 6, 8),
                               r.uniform(0, 6, 8)])
    centers[5] = centers[1] + [0.4, 0.0, 0.0]
    centers[7] = centers[2] + [0.0, 0.5, 0.0]
    coords = (centers[:, None, :] + tpl[None]).astype(np.float32)
    types = np.tile(np.asarray([0, 1, 1], np.int32), (8, 1))
    ok = np.asarray([False, True, True, True, True, True, True, True])
    got, n = psubset.mol_sequential_accept(
        pcfg, torch.from_numpy(coords), torch.from_numpy(types),
        torch.from_numpy(ok), torch.tensor(8))
    want, jn = jsubset.mol_sequential_accept(
        jcfg, jnp.asarray(coords), jnp.asarray(types), jnp.asarray(ok),
        jnp.int32(8))
    got, want = got.numpy(), np.asarray(want)
    if etarget >= 0.0:
        assert np.array_equal(got, want) and int(n) == int(jn)
        assert got.sum() >= 2 and not (got[1] and got[5])
    else:
        assert not want.any()
        assert got.tolist() == [False, True] + [False] * 6 and int(n) == 1


@pytest.fixture(scope="module")
def cadence():
    """(after setup, after make_run(5), after make_step x 3) of both
    engines at nfreq 2 with two templates, two rounds and inserted
    velocities under the force-free law."""
    free = DPDParams.create(temp=0.0, cutoff=1.0, seed=4, a0=0.0, gamma=0.0)
    jcfg, pcfg = gas_config(pair=free, nfreq=2, maxattempt=2, vx=V, vy=V,
                            vz=V, mols=(DIMER, TRIMER), molfrac=(0.5, 0.5),
                            nbuf=300.0)
    r = np.random.default_rng(4)
    x = r.uniform([1.05, 0.05, 0.05], [8.95, 3.95, 3.95], (200, 3))
    v = r.normal(0.0, 1.0, x.shape)
    jst = jinit_state(jcfg, x, v=v, seed=6)
    mp = pytest.MonkeyPatch()
    mp.setattr(jec, "_make_kernel", _zero_kernel)
    try:
        jst = jsetup(jcfg, jst)
        jrun = jax.jit(jmake_run(jcfg, 5))(jst)
        jstep = jax.jit(jmake_step(jcfg))
        js = jst
        for _ in range(3):
            js = jstep(js)
    finally:
        mp.undo()
    draws = JaxMolDraws(pcfg, 6)
    pst = convert.from_arrays(jax_arrays(jinit_state(jcfg, x, v=v, seed=6)),
                              device=CPU)
    pst = setup(pcfg, pst, draw=draws)
    out = [(jax_arrays(jst), convert.to_arrays(pst))]
    for runner in ("run", "step"):
        d = JaxMolDraws(pcfg, 6)
        d.key = draws.key
        if runner == "run":
            ps = make_run(pcfg, 5, draw=d)(pst)
            out.append((jax_arrays(jrun), convert.to_arrays(ps)))
        else:
            step = make_step(pcfg, draw=d)
            ps = pst
            for _ in range(3):
                ps = step(ps)
            out.append((jax_arrays(js), convert.to_arrays(ps)))
    return pcfg, out


@pytest.mark.parametrize("i", range(3))
def test_nfreq_runners_match_jax(cadence, i):
    pcfg, out = cadence
    jd, pd = out[i]
    assert_match(jd, pd, with_f=True)
    assert int(jd["ninserted"]) > 0
    calls = (1, 1 + 3, 1 + 2)[i]
    assert abs(float(jd["sim_time"]) - calls * np.float32(pcfg.dt)) < 1e-6
