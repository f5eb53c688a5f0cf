"""The cellpad engine's OBMD stage with `maxattempt` rounds, the fix's
candidate and velocity keywords, `id max` and `nfreq`, against obmd_tpu's
cellpad engine on the OBMD_DPD deck at scale 0.25 (8.4 x 11.198 x 11.198,
a jittered rho = 3 lattice of 3,160 atoms laid out at cap 24, a tenth of
them dead), the JAX engine's own draws injected
(test_torch_support.JaxDraws).

- One stage call (`_obmd_stage`, so `_insert` with its rounds) per
  keyword set, nattempt = 0 (each candidate's verdict its initial energy
  against the gate, which no float32 summation order flips), etarget 47,
  K = 4, the buffers drained and nbuf raised so that each side's budget
  outlasts several rounds: slots,
  tags, alive, maxtag, the kernel caches and every counter exactly; x, v
  and xref within 1e-5; the setpoints, which hold the inserted momentum
  over dt, within 2e-6 relative plus 1e-3.
- `id max` over a stage call without demand (the deck's own nbuf): the
  largest tag's atom leaves through a face, and maxtag is recomputed to
  the largest alive tag as the JAX engine recomputes it.
- make_run (5 steps: the stage on steps 0, 2 and 4 of the run) and
  make_step (3 steps: the stage where step % 2 == 0) at nfreq 2 with
  three rounds and inserted velocities, after setup.  These run under a
  force-free DPD law (a0 = gamma = T = 0), so the JAX pair kernel's output
  is zero: the test stands in zeros for it (its interpret mode takes
  minutes on the CPU) and the port runs its own pair kernel's plain
  version.  Every candidate's energy is then 0, all are accepted, and the
  rounds fill each side's budget.  Held as above, f within 2e-4 x max|f|.
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
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch import convert
from obmd_tpu_torch import engine_cellpad as pec
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.integrate import make_run, make_step, setup

from test_torch_obmd_lj import to_jax
from test_torch_support import CPU, JaxDraws, jax_arrays, lattice

EXACT = ("type", "tag", "alive", "step", "maxtag", "cell_overflow",
         "ndeleted", "ninserted", "insert_fail", "usher_iters", "rebuilds",
         "overflow", "skin_trips", "tag3d", "occ")
CLOSE = ("x", "v", "xref", "sim_time")
SETPOINTS = ("momentum_force_left", "momentum_force_right",
             "shear_force_left", "shear_force_right")
V = (-1.732, 1.732)
# USHER's gate: at the deck's 31.03 few unmoved candidates in the lattice
# pass, so the stage tests raise it (a candidate pair still conflicts
# closer than r = 0.33, where 0.5 a0 wd^2 > ETARGET + eps)
ETARGET = 47.0
# one stage call's keyword sets
STAGES = {
    "rounds3-velocities-idmax": dict(maxattempt=3, vx=V, vy=V, vz=V,
                                     id_policy="max"),
    "rounds2-gaussian-target": dict(maxattempt=2, insert_kmax=16,
                                    gaussian=(0.6, 5.6, 5.6, 1.0),
                                    vx=(0.5, 1.5), target=(4.2, 5.6, 5.6)),
    "rounds2-global": dict(maxattempt=2, deposit_global=(-1.5, -0.2)),
    "rounds3-local-rate": dict(maxattempt=3, rate=-1.0,
                               deposit_local=(-2.0, -0.5, 0.9)),
    "rounds2-rate-vz": dict(maxattempt=2, rate=3.0, vz=(0.0, 2.0)),
}


def configs(nbuf=760.0, k=4, pair=None, etarget=ETARGET, **kw):
    """(JAX cfg, port cfg): the deck at scale 0.25, cap 24, nattempt 0,
    K = k, with the fix keywords kw (and the pair law `pair`)."""
    pcfg = pscenes.obmd_dpd_config(scale=0.25, nbuf=nbuf, insert_kmax=k)
    o = pcfg.obmd
    pcfg = dataclasses.replace(
        pcfg, pair=pair or pcfg.pair, obmd=dataclasses.replace(
            o, usher=dataclasses.replace(o.usher, nattempt=0,
                                         etarget=etarget),
            **kw)).finalize()
    return to_jax(pcfg).finalize(), pcfg


@functools.lru_cache(maxsize=None)
def start(top_out: bool = False, drained: bool = True):
    """The JAX state of the jittered lattice, laid out at cap 24, a tenth
    of the atoms dead and with `drained` 55% of the buffers' (so unmoved
    candidates find room there), sim_time 0.25; with top_out the atom of
    the largest tag moved beyond the lower x face."""
    jcfg, _ = configs()
    x, v = lattice(jcfg, seed=21)
    jst = jinit_state(jcfg, x, v=v)
    alive = np.asarray(jst.alive).copy()
    r = np.random.default_rng(5)
    alive[r.choice(np.flatnonzero(alive), alive.sum() // 10,
                   replace=False)] = False
    if drained:
        # the buffers drained: 55% of their atoms gone
        xs = np.asarray(jst.x)[:, 0]
        buf = jcfg.obmd.buffer_size
        band = alive & ((xs < buf) | (xs > jcfg.box.hi[0] - buf))
        alive[np.flatnonzero(band & (r.random(len(xs)) < 0.55))] = False
    jst = jst.replace(alive=jnp.asarray(alive),
                      tag=jnp.where(jnp.asarray(alive), jst.tag, -1),
                      v=jnp.where(jnp.asarray(alive)[:, None], jst.v, 0.0),
                      sim_time=jnp.float32(0.25))
    if top_out:
        i = int(jnp.argmax(jst.tag))
        jst = jst.replace(x=jst.x.at[i, 0].set(-0.05))
    geom = jec.make_geometry(jcfg)
    return j_layout_build(geom, jcfg.box, jst.replace(
        x=jcfg.box.wrap(jst.x)))


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
        assert np.abs(pd["f"] - jd["f"]).max() <= 2e-4 * fmax


def one_stage(jcfg, pcfg, jst):
    """Both engines' _obmd_stage on one state: (JAX arrays, port
    arrays)."""
    jg = jec.make_geometry(jcfg)
    j2 = jax.jit(lambda s: jec._obmd_stage(jcfg, jg, s))(jst)
    pst = convert.from_arrays(jax_arrays(jst), device=CPU)
    p2 = pec._obmd_stage(pcfg, pec.make_geometry(pcfg), pst,
                         JaxDraws(pcfg, 0))
    return jax_arrays(j2), convert.to_arrays(p2)


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_with_rounds_matches_jax(name):
    jcfg, pcfg = configs(**STAGES[name])
    jst = start()
    jd, pd = one_stage(jcfg, pcfg, jst)
    assert_match(jd, pd)
    inserted = int(jd["ninserted"])
    assert inserted > 0
    if pcfg.obmd.maxattempt == 3 and pcfg.obmd.gaussian is None:
        # more than one round's K per side landed: the later rounds
        # inserted
        assert inserted > 2 * pcfg.obmd.insert_kmax, inserted
    if pcfg.obmd.vx is not None:
        born = (jd["tag"] > int(np.asarray(jst.tag).max())) \
            if pcfg.obmd.id_policy == "next" else \
            (jd["alive"] & ~np.isin(jd["tag"], np.asarray(jst.tag)))
        assert np.abs(jd["v"][born]).max() > 0.0


def test_id_max_without_demand():
    """`id max` on a stage call whose buffers need no atoms: the atom of
    the largest tag leaves through the lower face and maxtag becomes the
    largest alive tag, as the JAX engine recomputes it on every call (the
    port left it stale before it called skipped_insertion there)."""
    jcfg, pcfg = configs(nbuf=None, id_policy="max")
    jst = start(top_out=True, drained=False)
    jd, pd = one_stage(jcfg, pcfg, jst)
    assert int(jd["ninserted"]) == 0 and int(jd["ndeleted"]) == 1
    top = int(np.asarray(jst.tag).max())
    assert int(jd["maxtag"]) == int(jd["tag"][jd["alive"]].max()) < top
    assert_match(jd, pd)


def _zero_kernel(cfg, geom):
    """The JAX pair kernel's output under a force-free law: zeros of its
    shape [n_blocks, 3, cap, lanes]."""
    def kern(fld, tag, salt, occ, pbond=None):
        return jnp.zeros((geom.n_blocks, 3, geom.cap, geom.lanes),
                         jnp.float32)
    return kern


@pytest.fixture(scope="module")
def cadence():
    """(after setup, after make_run(5), after make_step x 3) of both
    engines at nfreq 2, three rounds and inserted velocities under the
    force-free law."""
    free = pconfig.DPDParams.create(temp=0.0, cutoff=1.0, seed=4, a0=0.0,
                                    gamma=0.0)
    jcfg, pcfg = configs(nbuf=800.0, pair=free, maxattempt=3, nfreq=2,
                         vx=V, vy=V, vz=V, id_policy="max")
    x, v = lattice(jcfg, seed=21)
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
    draws = JaxDraws(pcfg, 6)
    pst = convert.from_arrays(jax_arrays(jinit_state(jcfg, x, v=v, seed=6)),
                              device=CPU)
    pst = setup(pcfg, pst, draw=draws)
    out = [(jax_arrays(jst), convert.to_arrays(pst))]
    run_draws = JaxDraws(pcfg, 6)
    run_draws.key = draws.key
    prun = make_run(pcfg, 5, draw=run_draws)(pst)
    out.append((jax_arrays(jrun), convert.to_arrays(prun)))
    step_draws = JaxDraws(pcfg, 6)
    step_draws.key = draws.key
    pstep = make_step(pcfg, draw=step_draws)
    ps = pst
    for _ in range(3):
        ps = pstep(ps)
    out.append((jax_arrays(js), convert.to_arrays(ps)))
    return pcfg, out


@pytest.mark.parametrize("i", range(3))
def test_nfreq_runners_match_jax(cadence, i):
    pcfg, out = cadence
    jd, pd = out[i]
    assert_match(jd, pd, with_f=True)
    k = pcfg.obmd.insert_kmax
    if i == 0:
        # one stage call, each side's budget over two rounds
        assert int(jd["ninserted"]) > 4 * k
    # setup's stage, then the stage calls of the run or the steps: sim_time
    # advances on stage calls only
    calls = (1, 1 + 3, 1 + 2)[i]
    assert abs(float(jd["sim_time"]) - calls * np.float32(pcfg.dt)) < 1e-6
