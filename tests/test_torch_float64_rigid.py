"""Rigid bodies of the port on the single-device engines at float64, the
JAX package under jax_enable_x64 where a test holds the port to it.

validation/rigid_golden's 8 free bent trimers in a periodic 12^3 box
(scenes.rigid_golden_scene at float64):
- on the nlist engine, 40 steps under the golden's DPD law against the
  JAX package's nlist run at x64 with the port's turn
  (test_torch_rigid.jax_midpoint swapped in while JAX traces): x and v
  by tag within 1e-9 x the box length;
- on the cellpad engine (float32 kernel fields from the float64 state,
  the force cast up) against JAX's cellpad engine at x64, its pair kernel
  in interpret mode (seconds a step), set up and one step: tags and alive
  exact, x within 1e-5 and f within 2e-4 x max|f|, the kernel's
  tolerance;
- on the nlist engine against the reference binary's dumps, 40 steps
  with and without the law, at test_torch_rigid_golden.py's gates
  (positions 5e-3, arms 1e-4, velocities 5e-3; the float32 file holds
  the cellpad engine's 40 steps there, a minute a run on the CPU).
Every float leaf of the port's states and of JAX's is float64."""
import jax
import numpy as np
import pytest
import torch

from obmd_tpu import rigid as jrigid
from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import make_step as jmake_step
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.integrate import make_run, make_step, setup

import test_torch_rigid_golden as golden
from test_torch_float64 import port_float_leaves
from test_torch_obmd_lj import to_jax
from test_torch_rigid import jax_midpoint
from test_torch_support import jax_arrays

F64 = "float64"
CELLPAD_STEPS = 1


@pytest.fixture(scope="module", autouse=True)
def x64():
    """jax_enable_x64 on for this module's tests, restored after them."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def _scene(path, free=False):
    return pscenes.rigid_golden_scene(device="cpu", force_path=path,
                                      free=free, dtype=F64)


def _jax_start(sc):
    """The JAX package's config and state of a port scene of trimers."""
    jcfg = to_jax(sc.cfg)
    n = int(sc.state.natoms)
    bonds = []
    for m in range(n // 3):
        bonds += [(3 * m + 1, 3 * m + 2), (3 * m + 2, 3 * m + 3)]
    return jcfg, jinit_state(jcfg, sc.state.x.numpy()[:n],
                             v=sc.state.v.numpy()[:n],
                             tags=sc.state.tag.numpy()[:n],
                             mol=sc.state.mol.numpy()[:n],
                             bonds=np.asarray(bonds))


def _float64(pst, jst=None):
    leaves = port_float_leaves(pst)
    assert {k: t.dtype for k, t in leaves.items()
            if t.dtype != torch.float64} == {}
    if jst is not None:
        d = jax_arrays(jst)
        assert {k: a.dtype for k, a in d.items()
                if np.issubdtype(a.dtype, np.floating)
                and a.dtype != np.float64} == {}


@pytest.fixture(scope="module")
def runs():
    """The port's 40 nlist steps with and without the law, JAX's 40 with
    it, and both cellpad engines' first step."""
    out = {}
    for free in (False, True):
        sc = _scene("nlist", free)
        out[free] = make_run(sc.cfg, pscenes.RIGID_GOLDEN_STEPS)(
            setup(sc.cfg, sc.state))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrigid, "rigid_kinematics", jax_midpoint)
        jcfg, jst = _jax_start(_scene("nlist"))
        out["jax", "nlist"] = jax.jit(jmake_run(
            jcfg, pscenes.RIGID_GOLDEN_STEPS))(jsetup(jcfg, jst))
        sc = _scene("cellpad")
        jcfg, jst = _jax_start(sc)
        jst = jsetup(jcfg, jst)
        jstep = jmake_step(jcfg)
        for _ in range(CELLPAD_STEPS):
            jst = jstep(jst)
        out["jax", "cellpad"] = jst
    st = setup(sc.cfg, sc.state)
    step = make_step(sc.cfg)
    for _ in range(CELLPAD_STEPS):
        st = step(st)
    out["port", "cellpad"] = st
    return out


def test_nlist_float64_matches_jax(runs):
    """40 steps of the golden's trimers under its DPD law on the nlist
    engine: x and v by tag within 1e-9 x L of JAX's at x64."""
    ours, st = golden._by_tag(runs[False]), runs[False]
    ref = golden._by_tag(runs["jax", "nlist"])
    _float64(st, runs["jax", "nlist"])
    assert set(ours) == set(ref) and len(ref) == 24
    dx = max(np.abs(golden._unwrap(ours[t][0] - ref[t][0])).max()
             for t in ref)
    dv = max(np.abs(ours[t][1] - ref[t][1]).max() for t in ref)
    assert dx < 1e-9 * golden.L and dv < 1e-9 * golden.L, (dx, dv)


def test_cellpad_float64_matches_jax(runs):
    """Set-up and one cellpad step against JAX's cellpad engine at x64:
    slots exact, x within 1e-5, f within 2e-4 x max|f| (both pack float32
    kernel fields from the float64 state)."""
    p, j = runs["port", "cellpad"], runs["jax", "cellpad"]
    _float64(p, j)
    jd = jax_arrays(j)
    for k in ("tag", "alive", "mol"):
        assert np.array_equal(getattr(p, k).numpy(), jd[k]), k
    a = jd["alive"]
    np.testing.assert_allclose(p.x.numpy()[a], jd["x"][a], rtol=0,
                               atol=1e-5)
    fmax = np.abs(jd["f"][a]).max()
    assert np.abs(p.f.numpy()[a] - jd["f"][a]).max() <= 2e-4 * fmax


def test_dump_ref_float64(runs):
    """in.rigid at float64: every atom within 5e-3 of dump.ref, every arm
    within 1e-4 of the template's."""
    _float64(runs[False])
    ours = golden._by_tag(runs[False])
    ref = pscenes.golden_dump("rigid_golden", "dump.ref")
    assert set(ref) == set(ours) and len(ref) == 24
    pos = max(np.abs(golden._unwrap(ref[t] - ours[t][0])).max() for t in ref)
    assert pos < golden.POS_GATE, pos
    assert max(golden._arms(ours)) < golden.ARM_GATE


def test_dump_rv_float64(runs):
    """in.r2 (no pair law) at float64: positions and arms as above,
    velocities within 5e-3 of dump.rv."""
    _float64(runs[True])
    ours = golden._by_tag(runs[True])
    ref = pscenes.golden_dump("rigid_golden", "dump.rv")
    assert set(ref) == set(ours)
    pos = max(np.abs(golden._unwrap(ref[t][:3] - ours[t][0])).max()
              for t in ref)
    vel = max(np.abs(ref[t][3:] - ours[t][1]).max() for t in ref)
    assert pos < golden.POS_GATE and vel < golden.VEL_GATE, (pos, vel)
    assert max(golden._arms(ours)) < golden.ARM_GATE
