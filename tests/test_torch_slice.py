"""The whole slice — setup, the runner, and the OBMD stage with deletion and
insertion — against the JAX engine on one small OBMD_DPD scene (scale 0.25,
cap 24, nbuf raised so both buffers ask for atoms on every step), with the
JAX engine's candidate draws injected through the port's draw seam.

An USHER verdict is decided at the etarget gate; a candidate that steps
toward it stops within a float32 ulp of etarget + eps, and which side it
lands on depends on the order in which its energy was summed (the two
packages sum in different orders, and each order depends on the CPU's
vector width).  The exact four-step comparisons therefore run the deck
with nattempt = 0: each candidate's verdict is its initial energy against
the gate, which no summation order flips, and slots, tags, alive, the
kernel caches and every counter must then match exactly.  The deck's own
steered search (nattempt = 40) is held against the JAX engine inside
setup and the first step in test_torch_steer.py.

Float tolerances: forces differ by float32 summation order only (the port
sums each slot's 27 neighbour cells, the TPU kernel a Newton half stencil):
2e-4 * max|f|, the bar of tests/test_bigtile.py; positions, velocities and
setpoints, one step on top of that, 1e-4; positions by tag after four steps
5e-3 (tests/test_bigtile.py's trajectory bar)."""
import dataclasses

import jax
import numpy as np
import pytest

from obmd_tpu import scenes as jscenes
from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.integrate import equilibrate as pequilibrate
from obmd_tpu_torch.integrate import make_run as pmake_run
from obmd_tpu_torch.integrate import setup as psetup
from obmd_tpu_torch.observe import check_invariants

from test_torch_support import CPU, JaxDraws, assert_states_match, jax_arrays

SCALE, SEED, NBUF = 0.25, 1, 700.0


def _no_steps(cfg):
    usher = dataclasses.replace(cfg.obmd.usher, nattempt=0)
    return dataclasses.replace(cfg, obmd=dataclasses.replace(cfg.obmd,
                                                             usher=usher))


@pytest.fixture(scope="module")
def trajectories():
    """Both engines from the same gas: after setup, then after each of four
    steps (one compiled one-step runner each; every step starts an
    epoch, so each step relayouts)."""
    js = jscenes.obmd_dpd_scene(scale=SCALE, seed=SEED, nbuf=NBUF)
    ps = pscenes.obmd_dpd_scene(scale=SCALE, seed=SEED, nbuf=NBUF,
                                device=CPU)
    jcfg, pcfg = _no_steps(js.cfg), _no_steps(ps.cfg)
    draws = JaxDraws(jcfg, SEED)
    jst = jsetup(jcfg, js.state)
    pst = psetup(pcfg, ps.state, draw=draws)
    out = [(jax_arrays(jst), convert.to_arrays(pst))]
    jrun = jax.jit(jmake_run(jcfg, 1))
    prun = pmake_run(pcfg, 1, draw=draws)
    for _ in range(4):
        jst, pst = jrun(jst), prun(pst)
        out.append((jax_arrays(jst), convert.to_arrays(pst)))
    return out


def test_setup_and_one_step_match_jax(trajectories):
    (j0, p0), (j1, p1) = trajectories[:2]
    assert int(j0["ninserted"]) > 0
    assert_states_match(j0, p0)
    assert int(j1["ninserted"]) > int(j0["ninserted"])
    assert_states_match(j1, p1)


def test_four_steps_track_jax(trajectories):
    """After four steps (insertions on every step): atom counts and every
    counter equal, positions by tag within 5e-3."""
    jd, pd = trajectories[4]
    for k in ("ndeleted", "ninserted", "insert_fail", "usher_iters",
              "maxtag", "rebuilds", "overflow", "cell_overflow", "step"):
        assert int(pd[k]) == int(jd[k]), k
    assert int(pd["alive"].sum()) == int(jd["alive"].sum())

    def by_tag(d):
        return {int(t): d["x"][i] for i, t in enumerate(d["tag"])
                if d["alive"][i]}
    mj, mp = by_tag(jd), by_tag(pd)
    assert set(mj) == set(mp)
    assert max(np.abs(mj[t] - mp[t]).max() for t in mj) < 5e-3


def test_thirty_steps_own_generator_traffic_and_invariants():
    """Thirty steps of the deck (nattempt = 40) on the port's own
    generator after 50 steps of equilibrate (a uniform gas's start-up
    transient outruns the half-skin budget; equilibrate tames it and clears
    that counter): insertion and deletion traffic both happen, relayouts
    run, atoms are conserved up to the counters, check_invariants is
    clean."""
    ps = pscenes.obmd_dpd_scene(scale=SCALE, seed=SEED + 1, nbuf=NBUF,
                                device=CPU)
    cfg = ps.cfg
    n0 = int(ps.state.natoms)
    st = pequilibrate(cfg, psetup(cfg, ps.state), 50)
    st = pmake_run(cfg, 30)(st)
    tel = check_invariants(cfg, st)
    assert tel["ninserted"] > 0 and tel["ndeleted"] > 0
    assert int(st.obmd.usher_iters) > 0
    assert tel["rebuilds"] > 1
    assert int(st.natoms) == n0 + tel["ninserted"] - tel["ndeleted"]
    assert st.step == 80

