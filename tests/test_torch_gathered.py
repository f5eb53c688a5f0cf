"""The neighbour-gather force path and the cell-table insertion search of
the multi-device steps against the JAX package: forces_for_subset
(forces/gathered.py), trial_energy_force (forces/pairs.py), _usher_search
and _near_check (obmd/stage.py).  Inputs come from numpy seeds; both sides
run on the CPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import cells as jcells
from obmd_tpu import config as jconfig
from obmd_tpu import rng as jrng
from obmd_tpu.forces import gathered as jgathered
from obmd_tpu.forces import pairs as jpairs
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.geometry import RegionBlock as JRegion
from obmd_tpu.obmd import stage as jstage
from obmd_tpu_torch import cells as pcells
from obmd_tpu_torch import convert
from obmd_tpu_torch import rng as prng
from obmd_tpu_torch.forces import gathered as pgathered
from obmd_tpu_torch.forces import pairs as ppairs
from obmd_tpu_torch.geometry import Box as PBox
from obmd_tpu_torch.obmd import stage as pstage
from obmd_tpu_torch.state import init_state as pinit

import test_torch_support  # noqa: F401  (one torch thread a worker)

L = (9.0, 6.5, 7.0)
SKIN = 0.3


def _box(cls):
    return cls((0.0, 0.0, 0.0), L, (False, True, True))


def _gas(n, seed, ntypes=1):
    r = np.random.default_rng(seed)
    x = r.uniform([0.0, 0.0, 0.0], L, (n, 3)).astype(np.float32)
    v = r.normal(0, 1, (n, 3)).astype(np.float32)
    t = r.integers(0, ntypes, n).astype(np.int32)
    q = r.choice([-0.5, 0.0, 0.5], n).astype(np.float32)
    tag = (np.arange(n) + 1).astype(np.int32)
    alive = r.uniform(size=n) > 0.1
    x[~alive] = np.asarray(L, np.float32) * 0.5
    tag[~alive] = -1
    return x, v, t, q, tag, alive


LAWS = {
    "dpd": lambda: jconfig.DPDParams.create(temp=1.0, cutoff=1.0, seed=77,
                                            a0=25.0, gamma=4.5),
    "dpd_t2": lambda: jconfig.DPDParams.create(
        temp=1.0, cutoff=1.0, seed=77, a0=((25.0, 30.0), (30.0, 20.0)),
        gamma=4.5, ntypes=2, cut=((1.0, 0.9), (0.9, 1.1))),
    "lj": lambda: jconfig.LJCutParams.create(cutoff=1.3, epsilon=1.0,
                                             sigma=0.6),
    "ljrf": lambda: jconfig.LJCutRFParams.create(
        cut_lj=1.2, epsilon=((1.0, 0.8), (0.8, 0.6)),
        sigma=((0.55, 0.6), (0.6, 0.5)), eps_rf=78.0, ntypes=2),
    "tstat": lambda: jconfig.DPDTstatParams.create(
        t_start=0.5, t_stop=2.0, cutoff=1.0, seed=5, gamma=4.5,
        ramp=(0, 100)),
}


def _grid(jlaw, n=900, seed=3):
    ntypes = jlaw.ntypes
    x, v, t, q, tag, alive = _gas(n, seed, ntypes)
    jbox, pbox = _box(JBox), _box(PBox)
    jspec = jcells.GridSpec.create(jbox, jlaw.max_cut + SKIN, 40)
    pspec = pcells.GridSpec.create(pbox, jlaw.max_cut + SKIN, 40)
    jtab = jcells.build_cells(jspec, jnp.asarray(x), jnp.asarray(alive))
    ptab = pcells.build_cells(pspec, torch.from_numpy(x),
                              torch.from_numpy(alive))
    assert np.array_equal(np.asarray(jtab.table), ptab.table.numpy())
    assert int(jtab.overflow) == int(ptab.overflow) == 0
    return dict(x=x, v=v, t=t, q=q, tag=tag, alive=alive, jbox=jbox,
                pbox=pbox, jspec=jspec, pspec=pspec, jtab=jtab, ptab=ptab)


@pytest.mark.parametrize("law,bonded,step", [
    ("dpd", False, 3), ("dpd_t2", False, 4), ("lj", False, 0),
    ("ljrf", False, 0), ("dpd", True, 5), ("tstat", False, 40)])
def test_forces_for_subset(law, bonded, step):
    jlaw = LAWS[law]()
    plaw = convert.pair_params(jlaw)
    g = _grid(jlaw)
    r = np.random.default_rng(9)
    my = np.sort(r.choice(np.nonzero(g["alive"])[0], 300, replace=False))
    my_slot = my.astype(np.int32)
    salt_j = jrng.step_salt(77, jnp.asarray(step), 1)
    salt_p = prng.step_salt(77, step, 1)
    assert int(salt_j) == int(salt_p)
    kw_j, kw_p = {}, {}
    if bonded:
        # partner TAGS: each subset atom bonded to two random live atoms
        # (their pairs leave the law and take the harmonic bond)
        live_tags = g["tag"][g["alive"]]
        pb = r.choice(live_tags, (len(my), 2)).astype(np.int32)
        pb[::7, 1] = -1
        jb = jconfig.BondHarmonicParams(k=40.0, r0=0.8)
        kw_j = dict(my_pb=jnp.asarray(pb), bond=jb)
        kw_p = dict(my_pb=torch.from_numpy(pb),
                    bond=convert.bonded_params(jb))
    jscale = jpairs.sig_scale_of(jlaw, jnp.asarray(step), jnp.float32)
    pscale = ppairs.sig_scale_of(plaw, step)
    if jscale is not None:
        kw_j["sig_scale"] = jscale
        kw_p["sig_scale"] = pscale
    a = {k: g[k] for k in ("x", "v", "t", "tag", "q")}
    fj, pej = jgathered.forces_for_subset(
        jlaw, g["jbox"], g["jspec"], g["jtab"], *(jnp.asarray(a[k]) for k in
                                                  ("x", "v", "t", "tag", "q")),
        jnp.asarray(my_slot), *(jnp.asarray(a[k][my]) for k in
                                ("x", "v", "t", "tag", "q")),
        salt_j, dt=0.005, **kw_j)
    T = torch.from_numpy
    fp, pep = pgathered.forces_for_subset(
        plaw, g["pbox"], g["pspec"], g["ptab"],
        *(T(a[k]) for k in ("x", "v", "t", "tag", "q")),
        T(my_slot).long(), *(T(a[k][my]) for k in
                             ("x", "v", "t", "tag", "q")),
        salt_p, dt=0.005, **kw_p)
    fj, pej = np.asarray(fj), np.asarray(pej)
    scale = np.abs(fj).max()
    assert scale > 0
    assert np.abs(fp.numpy() - fj).max() <= 2e-4 * scale
    np.testing.assert_allclose(pep.numpy(), pej, rtol=1e-5,
                               atol=1e-5 * max(np.abs(pej).max(), 1e-6))


def _cand(n, seed, region):
    r = np.random.default_rng(seed)
    lo, hi = np.asarray(region.lo), np.asarray(region.hi)
    return r.uniform(lo, hi, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("law", ["dpd", "dpd_t2", "ljrf"])
def test_trial_energy_force(law):
    jlaw = LAWS[law]()
    plaw = convert.pair_params(jlaw)
    g = _grid(jlaw, seed=4)
    cand = _cand(64, 5, JRegion((0.0, 0.0, 0.0), L))
    ct = (np.arange(64) % jlaw.ntypes).astype(np.int32)
    Ej, Fj = jpairs.trial_energy_force(
        jlaw, g["jbox"], g["jspec"], g["jtab"], jnp.asarray(g["x"]),
        jnp.asarray(g["t"]), jnp.asarray(g["q"]), jnp.asarray(cand),
        jnp.asarray(ct))
    Ep, Fp = ppairs.trial_energy_force(
        plaw, g["pbox"], g["pspec"], g["ptab"], torch.from_numpy(g["x"]),
        torch.from_numpy(g["t"]), torch.from_numpy(g["q"]),
        torch.from_numpy(cand), torch.from_numpy(ct))
    Ej, Fj = np.asarray(Ej), np.asarray(Fj)
    np.testing.assert_allclose(Ep.numpy(), Ej, rtol=1e-5,
                               atol=1e-5 * np.abs(Ej).max())
    assert np.abs(Fp.numpy() - Fj).max() <= 2e-4 * np.abs(Fj).max()


def _obmd_cfg(law, near=None, nattempt=40, etarget=None):
    """A JAX scene config around LAWS[law] with an ATOM-mode stage."""
    jlaw = LAWS[law]()
    b = 2.0
    r5 = JRegion((0.0, 0.0, 0.0), (b, L[1], L[2]))
    r6 = JRegion((L[0] - b, 0.0, 0.0), L)
    usher = None
    if near is None:
        usher = jconfig.UsherParams(
            etarget=etarget if etarget is not None else 8.0, ds0=0.1,
            dsovlp=0.5, uovlp=60.0, eps=1.0, nattempt=nattempt)
    obmd = jconfig.ObmdParams(
        ntype=0, nfreq=1, seed=3, pxx=1.0, alpha=0.5, tau=0.01, nbuf=40.0,
        region1=r5, region2=r6, region5=r5, region6=r6, buffer_size=b,
        usher=usher, near=near, insert_kmax=16)
    jcfg = jconfig.SceneConfig(
        box=_box(JBox), masses=(1.0,) * jlaw.ntypes, dt=0.005, pair=jlaw,
        capacity=jconfig.Capacity(n_max=900, cell_capacity=40), obmd=obmd,
        skin=SKIN, force_path="nlist").finalize()
    return jcfg, convert.scene_config(jcfg).finalize()


def _robust(pcfg, spec, ctab, st, cand, ct, region, margin=1e-3):
    """The candidates whose every USHER energy evaluation lies more than
    `margin` from the gate etarget + eps: their verdicts and iteration
    counts do not hang on float32 rounding (a converging search ends at E
    = etarget, where the summation order of two packages decides)."""
    from obmd_tpu_torch.obmd.subset import usher_steps
    gate = pcfg.obmd.usher.etarget + pstage.EPSILON
    gap = torch.full((cand.shape[0],), float("inf"))

    def energy(pos):
        nonlocal gap
        E, F = ppairs.trial_energy_force(pcfg.pair, pcfg.box, spec, ctab,
                                         st.x, st.type, st.q, pos, ct)
        gap = torch.minimum(gap, (E - gate).abs())
        return E, F
    usher_steps(pcfg.obmd.usher, energy, cand,
                torch.tensor(region.lo), torch.tensor(region.hi))
    return gap > margin


@pytest.mark.parametrize("law,nattempt,ds0", [("dpd", 40, 0.1),
                                              ("dpd", 6, 0.03),
                                              ("ljrf", 12, 0.05)])
def test_usher_search(law, nattempt, ds0):
    """Verdicts and iteration counts exact, positions within 1e-5, on the
    margin-robust candidates (at least 8 of 64, both verdicts among
    them)."""
    from obmd_tpu.state import init_state as jinit
    jcfg, pcfg = _obmd_cfg(law, nattempt=nattempt)
    usher = dataclasses.replace(jcfg.obmd.usher, ds0=ds0)
    jcfg = dataclasses.replace(jcfg, obmd=dataclasses.replace(
        jcfg.obmd, usher=usher))
    pcfg = convert.scene_config(jcfg).finalize()
    g = _grid(jcfg.pair, seed=6)
    alive = g["alive"]
    x = g["x"][alive]
    kw = dict(types=g["t"][alive], q=g["q"][alive])
    jst = jinit(jcfg, x, **kw)
    pst = pinit(pcfg, x, device="cpu", **kw)
    jtab = jcells.build_cells(g["jspec"], jst.x, jst.alive)
    ptab = pcells.build_cells(g["pspec"], pst.x, pst.alive)
    region = jcfg.obmd.region5
    cand = _cand(64, 7, region)
    ct = np.zeros(64, np.int32)
    pj, aj, ij, Ej = jstage._usher_search(
        jcfg, g["jspec"], jtab, jst, jnp.asarray(cand), jnp.asarray(ct),
        region)
    pp, ap, ip, Ep = pstage._usher_search(
        pcfg, g["pspec"], ptab, pst, torch.from_numpy(cand),
        torch.from_numpy(ct), pcfg.obmd.region5)
    rob = _robust(pcfg, g["pspec"], ptab, pst, torch.from_numpy(cand),
                  torch.from_numpy(ct), pcfg.obmd.region5).numpy()
    aj = np.asarray(aj)
    assert rob.sum() >= 8 and aj[rob].any() and not aj[rob].all()
    assert np.array_equal(ap.numpy()[rob], aj[rob])
    assert np.array_equal(ip.numpy()[rob], np.asarray(ij)[rob])
    np.testing.assert_allclose(pp.numpy()[rob], np.asarray(pj)[rob], rtol=0,
                               atol=1e-5)


def test_near_check():
    from obmd_tpu.state import init_state as jinit
    jcfg, pcfg = _obmd_cfg("dpd", near=0.45)
    g = _grid(jcfg.pair, seed=8)
    alive = g["alive"]
    x = g["x"][alive]
    jst = jinit(jcfg, x)
    pst = pinit(pcfg, x, device="cpu")
    jtab = jcells.build_cells(g["jspec"], jst.x, jst.alive)
    ptab = pcells.build_cells(g["pspec"], pst.x, pst.alive)
    cand = _cand(200, 9, JRegion((0.0, 0.0, 0.0), L))
    ct = np.zeros(200, np.int32)
    okj, Ej = jstage._near_check(jcfg, g["jspec"], jtab, jst,
                                 jnp.asarray(cand), jnp.asarray(ct))
    okp, Ep = pstage._near_check(pcfg, g["pspec"], ptab, pst,
                                 torch.from_numpy(cand), torch.from_numpy(ct))
    assert np.array_equal(okp.numpy(), np.asarray(okj))
    assert np.asarray(okj).any() and not np.asarray(okj).all()
    np.testing.assert_allclose(Ep.numpy(), np.asarray(Ej), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(Ej)).max())
