"""The nlist and sweep engines' OBMD stage with `maxattempt` rounds,
inserted velocities, `id max` and `nfreq`, and a thermostat-only law under
the stage, against obmd_tpu's nlist and sweep engines, on
test_torch_rounds.py's drained lattice (the OBMD_DPD deck at scale 0.25,
nattempt 0, etarget 47, K = 4, nbuf 760), the JAX engine's own draws
injected (test_torch_support.JaxDraws).

- One nlist stage call (`_obmd_stage_fast`: three rounds, the new atoms'
  Verlet rows split at rounds x K per side) from the JAX engine's set-up
  state: slots, tags, alive, maxtag, every counter, the cell table, the
  Verlet rows, their counts, the tombstones and the rebuild flag exactly;
  x, v within 1e-5; the setpoints within 2e-6 relative plus 1e-3.
- `id max` over an nlist stage call without demand: maxtag the largest
  alive tag.
- setup, then make_run (5 steps) and make_step (3 steps) at nfreq 2 on the
  nlist and the sweep engine (the stage where step % 2 == 0; on the nlist
  engine's other steps no rebuild test, as obmd_tpu/integrate.py runs
  none): held as above after each, f within 2e-4 x max|f|.
- dpd/tstat under the stage on the nlist engine (setup and two steps):
  USHER has no energy to steer by, so every unconflicted candidate within
  the budget is taken at iteration 0; held as above."""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from obmd_tpu import integrate as jint
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch import convert
from obmd_tpu_torch.integrate import (_obmd_stage_fast, make_neighbor_params,
                                      make_run, make_step, setup)

from test_torch_rounds import SETPOINTS, V, configs, start
from test_torch_support import CPU, JaxDraws, jax_arrays

EXACT = ("type", "tag", "alive", "step", "maxtag", "cell_overflow",
         "ndeleted", "ninserted", "insert_fail", "usher_iters", "table",
         "cell_id", "nlist", "ncount", "tombstone", "force_rebuild",
         "rebuilds", "overflow")
CLOSE = ("x", "v", "xref", "sim_time")
KEYWORDS = dict(maxattempt=3, vx=V, vy=V, vz=V, id_policy="max")


def nlist_configs(path="nlist", **kw):
    jcfg, pcfg = configs(**kw)
    pcfg = dataclasses.replace(pcfg, force_path=path).finalize()
    return dataclasses.replace(jcfg, force_path=path).finalize(), pcfg


def assert_match(jd, pd, with_f=True):
    for k in EXACT:
        if k not in jd:
            continue
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


@functools.lru_cache(maxsize=None)
def set_up(path, drained=True, **kw):
    """(JAX cfg, port cfg, the JAX engine's set-up state) of start()'s
    lattice, its slots as they are."""
    jcfg, pcfg = nlist_configs(path, **kw)
    jst = jint.setup(jcfg, start(drained=drained).replace(nbrs=None))
    return jcfg, pcfg, jst


def _pstate(jst):
    return convert.from_arrays(jax_arrays(jst), device=CPU)


def _draws(pcfg, jst):
    """JaxDraws whose key chain stands where the JAX state's does."""
    d = JaxDraws(pcfg, 0)
    d.key = jst.key
    return d


@pytest.mark.parametrize("demand", ["rounds", "id-max-no-demand"])
def test_nlist_stage_matches_jax(demand):
    """One stage call with three rounds and velocities, or (the deck's
    nbuf, the largest tag leaving) none needed."""
    if demand == "rounds":
        jcfg, pcfg, jst = set_up("nlist", **KEYWORDS)
    else:
        jcfg, pcfg, jst = set_up("nlist", drained=False, nbuf=None,
                                 id_policy="max")
        i = int(np.argmax(np.asarray(jst.tag)))
        jst = jst.replace(x=jst.x.at[i, 0].set(-0.05))
    spec, nparams = jint.make_grid_spec(jcfg), jint.make_neighbor_params(jcfg)
    j2 = jax.jit(lambda s: jint._obmd_stage_fast(jcfg, spec, nparams, s))(
        jst)
    p2 = _obmd_stage_fast(pcfg, make_neighbor_params(pcfg), _pstate(jst),
                          _draws(pcfg, jst))
    jd, pd = jax_arrays(j2), convert.to_arrays(p2)
    assert_match(jd, pd, with_f=False)
    if demand == "rounds":
        assert int(jd["ninserted"]) > 2 * pcfg.obmd.insert_kmax
    else:
        assert int(jd["ninserted"]) == 0 and int(jd["ndeleted"]) == 1
        assert int(jd["maxtag"]) == int(jd["tag"][jd["alive"]].max()) \
            < int(np.asarray(jst.tag).max())


@functools.lru_cache(maxsize=None)
def cadence(path):
    """[(JAX arrays, port arrays)] after setup, make_run(5) and make_step
    x 3 at nfreq 2."""
    jcfg, pcfg, jst = set_up(path, nfreq=2, **KEYWORDS)
    pst = _pstate(jst)
    out = [(jax_arrays(jst), convert.to_arrays(pst))]
    jrun = jax.jit(jint.make_run(jcfg, 5))(jst)
    prun = make_run(pcfg, 5, draw=_draws(pcfg, jst))(pst)
    out.append((jax_arrays(jrun), convert.to_arrays(prun)))
    jstep, pstep = jax.jit(jint.make_step(jcfg)), make_step(
        pcfg, draw=_draws(pcfg, jst))
    js, ps = jst, pst
    for _ in range(3):
        js, ps = jstep(js), pstep(ps)
    out.append((jax_arrays(js), convert.to_arrays(ps)))
    return pcfg, out


@pytest.mark.parametrize("i", range(3))
@pytest.mark.parametrize("path", ["nlist", "sweep"])
def test_nfreq_runners_match_jax(path, i):
    pcfg, out = cadence(path)
    jd, pd = out[i]
    assert_match(jd, pd)
    # sim_time advances on stage calls only: 3 in the run, 2 in the steps
    calls = (0, 3, 2)[i]
    t0 = float(out[0][0]["sim_time"])
    assert abs(float(jd["sim_time"]) - t0 - calls * np.float32(pcfg.dt)) \
        < 2e-6


def test_thermostat_only_law_under_the_stage():
    """dpd/tstat under the stage on the nlist engine: setup and two steps
    against the JAX nlist engine, which runs it; no search iterations,
    and insertions on every call."""
    tstat = pconfig.DPDTstatParams.create(t_start=1.0, cutoff=1.0, seed=9,
                                          gamma=4.5)
    jcfg, pcfg = nlist_configs(pair=tstat)
    pst = setup(pcfg, _pstate(start().replace(nbrs=None)),
                draw=JaxDraws(pcfg, 0))
    jst = jint.setup(jcfg, start().replace(nbrs=None))
    jd, pd = jax_arrays(jst), convert.to_arrays(pst)
    assert_match(jd, pd)
    assert int(jd["ninserted"]) > 0 and int(jd["usher_iters"]) == 0
    jrun = jax.jit(jint.make_run(jcfg, 2))(jst)
    prun = make_run(pcfg, 2, draw=_draws(pcfg, jst))(_pstate(jst))
    jd, pd = jax_arrays(jrun), convert.to_arrays(prun)
    assert_match(jd, pd)
    assert int(jd["ninserted"]) > int(jax_arrays(jst)["ninserted"])
