"""The pressure wave and the Couette shear of the OBMD stage against the JAX
engine: the scale-0.25 OBMD_DPD deck with validation/run_wave.py's drive
(dpxx 60, freq 2: the left buffer's normal load pxx + dpxx sin(2 pi freq
t)) and with validation/run_couette.py's shear (pxy 2.0, region3 and
region4 the buffers: +pxy A on the left, -pxy A on the right), four steps
slot for slot with the JAX engine's draws injected through the port's draw
seam.

As in tests/test_torch_slice.py the deck runs with nattempt = 0 (USHER
verdicts at the etarget gate depend on float32 summation order).
Tolerances: integer and bool fields exact, x and v within 1e-4, the
setpoints within 1e-6 of their largest component (float32 sums of the
deleted momenta in another order), forces within 2e-4 * max|f|, and the
port's sum(f) on its setpoints at 1e-3 * max|f|."""
import dataclasses

import jax
import numpy as np
import pytest

from obmd_tpu import scenes as jscenes
from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.integrate import make_run as pmake_run
from obmd_tpu_torch.integrate import setup as psetup

from test_torch_support import CLOSE, CPU, EXACT, JaxDraws, jax_arrays

SCALE, SEED = 0.25, 4
SETPOINTS = ("momentum_force_left", "momentum_force_right",
             "shear_force_left", "shear_force_right")


def _drive(cfg, kind):
    """run_wave.py's or run_couette.py's settings on a deck config, with
    nattempt = 0."""
    ob = cfg.obmd
    if kind == "wave":
        ob = dataclasses.replace(ob, dpxx=60.0, freq=2.0)
    else:
        ob = dataclasses.replace(ob, region3=ob.region1, region4=ob.region2,
                                 pxy=2.0)
    ob = dataclasses.replace(ob, usher=dataclasses.replace(ob.usher,
                                                           nattempt=0))
    return dataclasses.replace(cfg, obmd=ob).finalize()


@pytest.mark.parametrize("kind", ["wave", "couette"])
def test_drive_matches_jax(kind):
    js = jscenes.obmd_dpd_scene(scale=SCALE, seed=SEED)
    ps = pscenes.obmd_dpd_scene(scale=SCALE, seed=SEED, device=CPU)
    jcfg, pcfg = _drive(js.cfg, kind), _drive(ps.cfg, kind)
    draws = JaxDraws(jcfg, SEED)
    jst = jsetup(jcfg, js.state)
    pst = psetup(pcfg, ps.state, draw=draws)
    jrun = jax.jit(jmake_run(jcfg, 1))
    prun = pmake_run(pcfg, 1, draw=draws)
    area = pcfg.box.cross_area
    for step in range(5):
        if step:
            jst, pst = jrun(jst), prun(pst)
        jd, pd = jax_arrays(jst), convert.to_arrays(pst)
        for k in EXACT:
            assert np.array_equal(np.asarray(pd[k]), jd[k]), (step, k)
        for k in CLOSE:
            atol = 1e-6 * np.abs(jd[k]).max() if k in SETPOINTS else 1e-4
            np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=atol,
                                       err_msg=f"step {step} {k}")
        f = pd["f"][pd["alive"]].astype(np.float64)
        fmax = np.abs(jd["f"]).max()
        assert np.abs(pd["f"] - jd["f"]).max() <= 2e-4 * fmax, step
        mf = sum(np.asarray(pd[k], np.float64) for k in SETPOINTS)
        assert np.abs(f.sum(axis=0) - mf).max() <= 1e-3 * fmax, step
        if kind == "couette":
            np.testing.assert_allclose(pd["shear_force_left"],
                                       [0.0, 2.0 * area, 0.0], rtol=1e-6)
            np.testing.assert_allclose(pd["shear_force_right"],
                                       [0.0, -2.0 * area, 0.0], rtol=1e-6)
        else:
            assert not np.any(pd["shear_force_left"])
