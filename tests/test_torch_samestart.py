"""The port's main path held to the JAX engine from one start, and the
closed periodic DPD box of Milestone A.

- validation/profile_jax_samestart.npz, the JAX nlist engine's run of the
  OBMD_DPD deck from the port's start (tests/test_torch_gate_split.py
  --save): its keys, shapes and settings.
- profile_torch.thermal_temperature, the one numpy yardstick of the thermal
  T both engines' series use, against the port's
  observe.profile_temperature on a scale-0.25 deck state with a flow along
  x (kinetic_temperature likewise against state.temperature).
- profile_torch.against_run, the comparison `profile_torch.py --against
  jax` prints: it passes on the saved run's own series and fails on its
  profiles shifted by 2% or its thermal T shifted past the gate.
- scenes.closed_dpd_scene draws the JAX scene's start and configuration,
  and ten make_step steps of both packages' nlist engines from it agree
  (tests/test_torch_rounds_nlist.py's bar)."""
import os

import jax
import numpy as np
import pytest
import torch

import profile_torch as pt
from obmd_tpu import integrate as jint
from obmd_tpu import scenes as jscenes
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.integrate import make_step, setup
from obmd_tpu_torch.observe import profile_temperature
from obmd_tpu_torch.state import temperature

from test_torch_support import CPU, _mirror, jax_arrays

STEPS = pt.REF["usher"][1]
PATH = pt.SAMESTART.format("jax")


@pytest.fixture(scope="module")
def saved():
    return pt.load_samestart(PATH)


def test_saved_reference_keys_shapes_and_settings(saved):
    d, meta = saved
    assert os.path.getsize(PATH) < 1 << 20
    assert {k: meta[k] for k in (
        "engine", "force_path", "scale", "scene_seed", "pair_seed",
        "obmd_seed", "noise", "insertion", "equil", "steps", "sample_every",
        "warm", "nbins", "t_until", "t_nbins", "blocks")} == dict(
        engine="jax", force_path="nlist", scale=1.0, scene_seed=7,
        pair_seed=8893, obmd_seed=777, noise="uniform", insertion="usher",
        equil=pt.EQUIL, steps=STEPS, sample_every=pt.SAMPLE_EVERY,
        warm=pt.WARM, nbins=pt.NBINS, t_until=pt.T_UNTIL, t_nbins=50,
        blocks=pt.BLOCKS)
    assert meta["jax_version"] and len(meta["commit"]) == 40
    every, nb = pt.SAMPLE_EVERY, pt.NBINS
    n_t = pt.T_UNTIL // every + 1
    shapes = dict(density=(nb,), vx=(nb,), temp=(nb,),
                  block_density=(pt.BLOCKS, nb), block_vx=(pt.BLOCKS, nb),
                  block_temp=(pt.BLOCKS, nb), natoms=(STEPS // every,),
                  natoms_steps=(STEPS // every,), t_steps=(n_t,),
                  t_kinetic=(n_t,), t_thermal=(n_t,),
                  counts_after_equilibrate=(3,), counts_end=(3,), nsamp=())
    assert {k: d[k].shape for k in d} == shapes
    assert int(d["nsamp"]) == (STEPS - pt.WARM) // every
    np.testing.assert_array_equal(d["natoms_steps"],
                                  np.arange(1, STEPS // every + 1) * every)
    np.testing.assert_array_equal(d["t_steps"], np.arange(n_t) * every)
    assert all(np.isfinite(d[k]).all() for k in shapes)
    # the block means average to the profile; the last count is the end's
    np.testing.assert_allclose(d["block_density"].mean(axis=0),
                               d["density"], rtol=1e-12)
    assert d["natoms"][-1] == d["counts_end"][0]
    # the rescaled start carries a flow: its thermal T is below its kinetic T
    assert d["t_thermal"][0] < d["t_kinetic"][0]


def test_thermal_temperature_matches_profile_temperature():
    """A scale-0.25 deck state after setup (dead slots among the live
    ones) with a sine flow of amplitude 0.8 along x: the numpy yardstick
    equals the port's profile_temperature within 1e-5 relative, and takes
    the flow out."""
    sc = pscenes.obmd_dpd_scene(scale=0.25, seed=3, device=CPU)
    cfg = pt.deck_config(sc.cfg, "uniform")
    st = setup(cfg, sc.state)
    lx = cfg.box.lengths[0]
    v = st.v.clone()
    v[:, 0] += 0.8 * torch.sin(2 * np.pi * st.x[:, 0] / lx)
    st = st.replace(v=torch.where(st.alive[:, None], v, st.v))
    nbins = round(lx / (33.594 / pt.NBINS))
    x, v, alive = st.x.numpy(), st.v.numpy(), st.alive.numpy()
    assert not alive.all()
    mass = np.asarray(cfg.masses)[st.type.numpy()]
    got = pt.thermal_temperature(x, v, alive, mass, cfg.box.lo[0],
                                 cfg.box.hi[0], nbins)
    want = float(profile_temperature(cfg, st, nbins))
    assert abs(got - want) <= 1e-5 * want
    kin = pt.kinetic_temperature(v, alive, mass)
    assert abs(kin - float(temperature(cfg, st))) <= 1e-5 * kin
    assert kin > got + 0.08    # the flow (0.32 / 3 = 0.107) is heat to it


def test_against_jax_gates(saved):
    d, _ = saved
    same = pt.against_run(d, d)
    assert same["ok"] and same["density_rmse_over_mean"] == 0.0
    assert same["t_thermal_max_abs_diff"] == 0.0
    assert len(same["t_thermal_ref"]) == pt.T_UNTIL // pt.T_WINDOW
    assert same["counts"]["ref"] == same["counts"]["port"]
    rho = d["density"]
    shifted = pt.against_run(d, dict(d, density=rho * 1.02))
    want = 0.02 * np.sqrt(np.mean(rho ** 2)) / rho.mean()
    assert abs(shifted["density_rmse_over_mean"] - want) < 1e-12
    assert not shifted["gate_density_1pct"] and not shifted["ok"]
    assert shifted["gate_thermal_003"]
    hot = pt.against_run(d, dict(d, t_thermal=d["t_thermal"] + 0.031))
    assert hot["gate_density_1pct"] and not hot["gate_thermal_003"]
    assert not hot["ok"]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n=300, box_l=4.7, seed=5, temp=1.3, n_max=360)])
def test_closed_dpd_scene_matches_jax(kw):
    js = jscenes.closed_dpd_scene(**kw)
    ps = pscenes.closed_dpd_scene(**kw, device=CPU)
    _mirror(ps.cfg.finalize(), js.cfg.finalize())
    assert ps.cfg.force_path == "nlist" and ps.cfg.obmd is None
    jd, pd = jax_arrays(js.state), convert.to_arrays(ps.state)
    for k in convert.STATE_FIELDS:
        assert np.array_equal(np.asarray(pd[k]), jd[k]), k


def test_closed_box_steps_match_jax():
    """setup, then ten make_step steps of both nlist engines from
    closed_dpd_scene(n=300, box_l=4.7, seed=5): slots, tags and alive
    equal, x and v within 1e-5, f within 2e-4 x max|f|."""
    kw = dict(n=300, box_l=4.7, seed=5)
    js = jscenes.closed_dpd_scene(**kw)
    ps = pscenes.closed_dpd_scene(**kw, device=CPU)
    jcfg, pcfg = js.cfg.finalize(), ps.cfg.finalize()
    jst, pst = jint.setup(jcfg, js.state), setup(pcfg, ps.state)
    jstep, pstep = jax.jit(jint.make_step(jcfg)), make_step(pcfg)
    for _ in range(10):
        jst, pst = jstep(jst), pstep(pst)
    jd, pd = jax_arrays(jst), convert.to_arrays(pst)
    assert int(jd["step"]) == int(pd["step"]) == 10
    for k in ("tag", "alive", "type"):
        assert np.array_equal(np.asarray(pd[k]), jd[k]), k
    for k in ("x", "v"):
        np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    fmax = np.abs(jd["f"]).max()
    assert np.abs(pd["f"] - jd["f"]).max() <= 2e-4 * fmax
