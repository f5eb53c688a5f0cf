"""The DPD variants' paths against the JAX package and the reference binary:
the small OBMD_DPD deck with gaussian pair noise against the JAX cellpad
engine, a dpd/tstat temperature ramp through the port's cellpad engine
against the JAX nlist engine (the JAX cellpad engine refuses dpd/tstat),
the reference binary's dpd/tstat forces (validation/dpdtstat_golden), the
gaussian thermostat holding T, and the thermal T under a flow
(observe.profile_temperature) against a float64 oracle.

Tolerances: the gaussian deck as tests/test_torch_slice.py (setup and one
step slot for slot, integers exact, x and v within 1e-4, f within 2e-4 *
max|f|; positions by tag after four steps within 5e-3); the ramp as
tests/test_slab_parity.py holds its slab engine to the nlist engine (x by
tag within 1e-4, v within 1e-3 after six steps); the golden at
validation/run_dpdtstat_golden.py's bar, 5e-5 * max|f|."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from obmd_tpu import scenes as jscenes
from obmd_tpu.config import Capacity as JCapacity
from obmd_tpu.config import DPDTstatParams as JDPDTstatParams
from obmd_tpu.config import SceneConfig as JSceneConfig
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import make_step as jmake_step
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.geometry import Box as PBox
from obmd_tpu_torch.integrate import make_run as pmake_run
from obmd_tpu_torch.integrate import setup as psetup
from obmd_tpu_torch.io.lammps_data import read_data
from obmd_tpu_torch.observe import (check_invariants, make_thermo_fn,
                                    profile_temperature)
from obmd_tpu_torch.state import init_state as pinit_state
from obmd_tpu_torch.state import temperature

from test_torch_support import (CPU, JaxDraws, assert_states_match,
                                jax_arrays, lattice)

SCALE, SEED, NBUF = 0.25, 1, 700.0
GOLDEN = os.path.join(os.path.dirname(__file__), os.pardir, "validation",
                      "dpdtstat_golden")


def _gaussian_deck(cfg):
    """The deck with LAMMPS' gaussian pair noise and nattempt = 0 (no USHER
    verdict at the etarget gate: tests/test_torch_slice.py)."""
    usher = dataclasses.replace(cfg.obmd.usher, nattempt=0)
    return dataclasses.replace(
        cfg, pair=dataclasses.replace(cfg.pair, gaussian_noise=True),
        obmd=dataclasses.replace(cfg.obmd, usher=usher))


def test_gaussian_deck_tracks_jax_cellpad():
    """setup and four steps of the small OBMD_DPD deck (scale 0.25, cap 24,
    nbuf raised so both buffers insert on every step) with gaussian noise,
    the JAX engine's candidate draws injected: setup and the first step
    match slot for slot; after four steps every counter and the atom count
    are equal and positions by tag agree within 5e-3."""
    js = jscenes.obmd_dpd_scene(scale=SCALE, seed=SEED, nbuf=NBUF)
    ps = pscenes.obmd_dpd_scene(scale=SCALE, seed=SEED, nbuf=NBUF,
                                device=CPU)
    jcfg, pcfg = _gaussian_deck(js.cfg), _gaussian_deck(ps.cfg)
    assert jcfg.pair.gaussian_noise and convert.pair_params(jcfg.pair) == \
        pcfg.pair
    draws = JaxDraws(jcfg, SEED)
    jst = jsetup(jcfg, js.state)
    pst = psetup(pcfg, ps.state, draw=draws)
    out = [(jax_arrays(jst), convert.to_arrays(pst))]
    jrun = jax.jit(jmake_run(jcfg, 1))
    prun = pmake_run(pcfg, 1, draw=draws)
    for _ in range(4):
        jst, pst = jrun(jst), prun(pst)
        out.append((jax_arrays(jst), convert.to_arrays(pst)))
    (j0, p0), (j1, p1) = out[:2]
    assert int(j1["ninserted"]) > int(j0["ninserted"]) > 0
    assert_states_match(j0, p0)
    assert_states_match(j1, p1)
    jd, pd = out[4]
    for k in ("ndeleted", "ninserted", "insert_fail", "usher_iters",
              "maxtag", "rebuilds", "overflow", "cell_overflow", "step"):
        assert int(pd[k]) == int(jd[k]), k

    def by_tag(d):
        return {int(t): d["x"][i] for i, t in enumerate(d["tag"])
                if d["alive"][i]}
    mj, mp = by_tag(jd), by_tag(pd)
    assert set(mj) == set(mp)
    assert max(np.abs(mj[t] - mp[t]).max() for t in mj) < 5e-3


def _ramp_box():
    """tests/test_slab_parity.py:154-201's ramp box (x open, 16 long,
    dpd/tstat 1 -> 4 over steps 0-4, dt 0.01, seed 9) widened from 4 to
    6.5 in y and z at its density (1,056 atoms) so that the port's kernel
    has 5 cells on each periodic axis: (JAX nlist config, port cellpad
    config, x, v)."""
    lx, ly = 16.0, 6.5
    n = int(round(400 * ly * ly / 16.0))
    r = np.random.default_rng(19)
    x = r.uniform([0.1, 0.0, 0.0], [lx - 0.1, ly, ly], (n, 3))
    v = r.normal(0, 0.8, (n, 3))
    lo, hi, per = (0.0, 0.0, 0.0), (lx, ly, ly), (False, True, True)
    jcfg = JSceneConfig(
        box=JBox(lo, hi, per), masses=(1.0,), dt=0.01,
        pair=JDPDTstatParams.create(t_start=1.0, t_stop=4.0, cutoff=1.0,
                                    seed=9, gamma=4.5, ramp=(0, 4)),
        capacity=JCapacity(n_max=n, cell_capacity=16),
        skin=0.3, force_path="nlist").finalize()
    pcfg = pconfig.SceneConfig(
        box=PBox(lo, hi, per), masses=(1.0,), dt=0.01,
        pair=convert.pair_params(jcfg.pair),
        capacity=pconfig.Capacity(n_max=n, cell_capacity=16), skin=0.3)
    return jcfg, pcfg, x, v


def _by_tag(tag, alive, a):
    keep = np.asarray(alive)
    order = np.argsort(np.asarray(tag)[keep])
    return np.asarray(a)[keep][order]


def test_tstat_ramp_tracks_jax_nlist():
    """Six steps spanning the ramp window on the port's cellpad engine
    against the JAX nlist engine: x by tag within 1e-4, v within 1e-3; the
    same start under the constant-T law diverges (> 1e-3), so the scale is
    live; no invariant is violated."""
    jcfg, pcfg, x, v = _ramp_box()
    assert jcfg.pair.is_ramp and pcfg.pair.is_ramp
    jst = jsetup(jcfg, jinit_state(jcfg, x, v=v))
    jstep = jax.jit(jmake_step(jcfg))
    for _ in range(6):
        jst = jstep(jst)
    pst = pmake_run(pcfg, 6)(psetup(pcfg, pinit_state(pcfg, x, v=v,
                                                      device=CPU)))
    assert pst.step == int(jst.step) == 6
    check_invariants(pcfg, pst)
    jx = _by_tag(jst.tag, jst.alive, jst.x)
    px = _by_tag(pst.tag, pst.alive, pst.x)
    assert jx.shape == px.shape == (len(x), 3)
    assert np.abs(px - jx).max() < 1e-4
    jv = _by_tag(jst.tag, jst.alive, jst.v)
    pv = _by_tag(pst.tag, pst.alive, pst.v)
    assert np.abs(pv - jv).max() < 1e-3
    const = dataclasses.replace(pcfg, pair=dataclasses.replace(
        pcfg.pair, t_stop=None, ramp=None))
    cst = pmake_run(const, 6)(psetup(const, pinit_state(const, x, v=v,
                                                        device=CPU)))
    cv = _by_tag(cst.tag, cst.alive, cst.v)
    assert np.abs(cv - pv).max() > 1e-3


def test_tstat_golden_matches_lammps():
    """validation/dpdtstat_golden (300 atoms in a periodic 9^3 box,
    `pair_style dpd/tstat 0.0 0.0 1.2 999`, `pair_coeff 1 1 3.5`: at T = 0
    only the drag acts) through the port's setup: every force within 5e-5
    * max|f| of the reference binary's dump.ref."""
    df = read_data(os.path.join(GOLDEN, "fluid.data"), atom_style="atomic")
    ref = {}
    with open(os.path.join(GOLDEN, "dump.ref")) as fh:
        lines = fh.read().splitlines()
    for line in lines[lines.index("ITEM: ATOMS id fx fy fz") + 1:]:
        t = line.split()
        ref[int(t[0])] = np.asarray([float(u) for u in t[1:4]])
    pair = pconfig.DPDTstatParams.create(t_start=0.0, cutoff=1.2, seed=999,
                                         gamma=3.5)
    cfg = pconfig.SceneConfig(
        box=df.box(periodic=(True, True, True)), masses=tuple(df.masses),
        pair=pair, dt=0.01, capacity=pconfig.Capacity(n_max=df.natoms,
                                                      cell_capacity=16),
        skin=0.3)
    st = psetup(cfg, pinit_state(cfg, df.x, v=df.v, tags=df.tags,
                                 device=CPU))
    f = st.f.numpy()
    got = {int(t): f[i] for i, t in enumerate(st.tag.tolist())
           if bool(st.alive[i])}
    assert set(got) == set(ref)
    scale = max(float(np.linalg.norm(w)) for w in ref.values())
    err = max(float(np.abs(got[t] - ref[t]).max()) for t in ref)
    assert scale > 0.1 and err <= 5e-5 * scale, (err, scale)
    # thermo: dpd/tstat has no conservative energy
    assert float(make_thermo_fn(cfg)(st).epair) == 0.0


@pytest.fixture(scope="module")
def thermostat_runs():
    """tests/test_newton_kernel.py:132-165's law (DPD a0 25, gamma 4.5, T
    1, dt 0.02, cap 24) in a periodic 6.5^3 box (5 cells per axis; the JAX
    test's is 8^3) from a jittered rho = 3 lattice with unit normal
    velocities (the JAX test's random gas heats far above T = 1 from its
    overlaps and needs its 300 steps to cool; the lattice starts near T =
    1, so 40 steps show the thermostat) on the port's cellpad engine, with
    uniform and with gaussian noise."""
    box = PBox((0.0, 0.0, 0.0), (6.5, 6.5, 6.5), (True, True, True))
    out = {}
    for g in (False, True):
        pair = pconfig.DPDParams.create(temp=1.0, cutoff=1.0, seed=9,
                                        a0=25.0, gamma=4.5, gaussian_noise=g)
        cfg = pconfig.SceneConfig(box=box, masses=(1.0,), pair=pair, dt=0.02,
                                  capacity=pconfig.Capacity(
                                      n_max=2000, cell_capacity=24), skin=0.3)
        x, v = lattice(cfg, seed=4)
        st = pmake_run(cfg, 40)(psetup(cfg, pinit_state(cfg, x, v=v,
                                                        device=CPU)))
        check_invariants(cfg, st)
        out[g] = (float(temperature(cfg, st)), _by_tag(st.tag, st.alive,
                                                        st.x))
    return out


@pytest.mark.parametrize("gaussian", [False, True])
def test_gaussian_thermostat_holds_temperature(thermostat_runs, gaussian):
    """The DPD thermostat holds T within 0.9-1.1 with either noise law
    (variance-matched), and the gaussian flag changes the draws: the two
    trajectories part by more than 1e-3."""
    t, xs = thermostat_runs[gaussian]
    assert 0.9 < t < 1.1, t
    other = thermostat_runs[not gaussian][1]
    assert np.abs(xs - other).max() > 1e-3


def test_profile_temperature_takes_out_the_flow():
    """profile_temperature matches LAMMPS' compute temp/profile 1 1 1 x
    nbins computed in float64 with numpy (within 1e-5 relative), and a
    flow that is uniform within each x bin leaves it where it was while
    the kinetic T rises."""
    sc = pscenes.obmd_dpd_scene(scale=SCALE, seed=3, device=CPU)
    cfg, st = sc.cfg, sc.state
    nbins = 10
    alive = st.alive.numpy()
    x, v = st.x.numpy()[alive].astype(np.float64), \
        st.v.numpy()[alive].astype(np.float64)
    xlo, xhi = cfg.box.lo[0], cfg.box.hi[0]
    b = np.clip(((x[:, 0] - xlo) * (nbins / (xhi - xlo))).astype(int), 0,
                nbins - 1)

    def oracle(v):
        cnt = np.bincount(b, minlength=nbins)[:, None]
        vbin = np.stack([np.bincount(b, v[:, k], nbins) for k in range(3)],
                        axis=1) / np.maximum(cnt, 1)
        return ((v - vbin[b]) ** 2).sum() / (3 * len(v) - 3 - 3 * nbins)

    got = float(profile_temperature(cfg, st, nbins))
    np.testing.assert_allclose(got, oracle(v), rtol=1e-5)
    flow = np.random.default_rng(8).normal(0.0, 0.5, (nbins, 3))
    vf = st.v.clone()
    vf[st.alive] += torch.as_tensor(flow[b], dtype=vf.dtype)
    flowing = st.replace(v=vf)
    np.testing.assert_allclose(float(profile_temperature(cfg, flowing,
                                                         nbins)),
                               got, rtol=1e-5)
    assert float(temperature(cfg, flowing)) > float(
        temperature(cfg, st)) + 0.1
