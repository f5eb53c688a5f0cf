"""The USHER kernel's dpd/ext rows: the port's usher_search under dpd/ext
(its plain version on the CPU) against the JAX package's batched search and
its TPU kernel, usher_search_pallas in interpret mode, under JAX's
DPDExtParams; usher_law's table and launch key for dpd/ext and its refusal
of dpd/ext/tstat; the kernel's scratch at path G's subset size.

dpd/ext's conservative energy is DPD's, so the rows are DPD's a0 and cut
(obmd_tpu/forces/pallas_usher.py:48-56).  Verdicts are held on
margin-robust candidates (|E - etarget| >= 0.3 at both final positions) as
tests/test_torch_usher.py holds them: positions within 1e-4 of the batched
search and 2e-3 of the Pallas kernel, at least 6 candidates checked."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import config as jconfig
from obmd_tpu.forces.pallas_usher import usher_law as j_usher_law
from obmd_tpu.forces.pallas_usher import usher_search_pallas
from obmd_tpu.obmd.subset import usher_search_subset_batch as j_batch
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.forces.usher_kernel import (MAX_CELLS, MAX_TYPES, N_COEF,
                                                UsherPlan,
                                                scratch_words, usher_law,
                                                usher_search)

from test_torch_usher import CASES, _configs, _robust, _subsets

EXT = dict(gammaT=2.5, ws=0.8, wsT=1.3)


def _ext(cfg, cm, **kw):
    """cfg with its DPD law turned into dpd/ext of the same a0, gamma, cut,
    T and seed (config module cm)."""
    p = cfg.pair
    pair = cm.DPDExtParams.create(temp=p.temp, cutoff=p.cutoff, seed=p.seed,
                                  a0=p.a0[0][0], gamma=p.gamma[0][0],
                                  **dict(EXT, **kw))
    return dataclasses.replace(cfg, pair=pair)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_batch_and_pallas(case):
    c = dict(CASES[case])
    b, k, seed = c.pop("b"), c.pop("k"), c.pop("seed")
    lx, l, buf = c.pop("lx", 8.0), c.pop("l", 4.0), c.pop("buf", 1.6)
    jcfg, pcfg = _configs(lx=lx, l=l, buf=buf, k=k, **c)
    jcfg, pcfg = _ext(jcfg, jconfig), _ext(pcfg, pconfig)
    r = np.random.default_rng(seed)
    jl, pl = _subsets(r, b, [0.0, 0.0, 0.0], [buf + 1.0, l, l], 12)
    jr, pr = _subsets(r, b, [lx - buf - 1.0, 0.0, 0.0], [lx, l, l], 12)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    o = jcfg.obmd
    cl = np.array(o.region5.sample_uniform(jax.random.uniform(k1, (k, 3))))
    cr = np.array(o.region6.sample_uniform(jax.random.uniform(k2, (k, 3))))
    ct = jnp.zeros((k,), jnp.int32)
    batch = j_batch(jcfg, jl, jr, jnp.asarray(cl), jnp.asarray(cr), ct,
                    o.region5, o.region6)
    pallas = usher_search_pallas(jcfg, jl, jr, jnp.asarray(cl),
                                 jnp.asarray(cr), o.region5, o.region6)
    po = pcfg.obmd
    pp, pa, pit = (t.numpy() for t in usher_search(
        pcfg, pl, pr, torch.from_numpy(cl), torch.from_numpy(cr),
        po.region5, po.region6))
    for ref, tol in ((batch, 1e-4), (pallas, 2e-3)):
        rp, ra = np.asarray(ref[0]), np.asarray(ref[1])
        checked = accepted = 0
        for side in range(2):
            for kk in range(pp.shape[1]):
                if not _robust(jcfg, (jl, jr), pp, rp, side, kk):
                    continue
                checked += 1
                assert bool(pa[side, kk]) == bool(ra[side, kk]), (side, kk)
                if pa[side, kk]:
                    accepted += 1
                    assert np.abs(pp[side, kk] - rp[side, kk]).max() < tol
        assert checked >= 6 and accepted >= 1, (checked, accepted)
    # dpd/ext steers exactly as DPD of the same a0 and cut
    _, pdpd = _configs(lx=lx, l=l, buf=buf, k=k, **c)
    for a, b_ in zip(usher_search(pdpd, pl, pr, torch.from_numpy(cl),
                                  torch.from_numpy(cr), po.region5,
                                  po.region6), (pp, pa, pit)):
        assert np.array_equal(a.numpy(), b_)


def test_usher_law_dpdext_rows():
    """usher_law gives dpd/ext the DPD table of its a0 and cut against the
    trial type (row tj: a0, cut, 0, 0), under its own launch key
    usher_search_dpdext, with JAX's rows; dpd/ext/tstat has no kernel law
    (None) in both packages; the plan's grids and table are DPD's."""
    jcfg, pcfg = _configs(a0=60.0, etarget=12.0, nattempt=10)
    ext = _ext(pcfg, pconfig)
    name, table, cut_col = usher_law(ext.pair, 0)
    dname, dtable, dcut = usher_law(pcfg.pair, 0)
    assert (name, cut_col) == ("usher_search_dpdext", dcut)
    assert dname == "usher_search" and np.array_equal(table, dtable)
    assert table.shape == (MAX_TYPES, N_COEF)
    np.testing.assert_array_equal(table[0], [60.0, 1.0, 0.0, 0.0])
    jlaw, rows = j_usher_law(_ext(jcfg, jconfig).pair)
    assert jlaw == "dpd"
    got = [float(v[0]) for v in rows(0, jnp.zeros((1,), jnp.int32), None)]
    assert got == [float(table[0, 0]), float(table[0, 1])]
    two = pconfig.DPDExtParams.create(
        temp=1.0, cutoff=1.2, seed=1, ntypes=2,
        a0=((25.0, 40.0), (40.0, 30.0)), gamma=4.5, gammaT=2.5,
        cut=((1.0, 1.1), (1.1, 1.2)))
    t2 = usher_law(two, 1)[1]
    np.testing.assert_array_equal(t2[:2, :2], np.float32([[40.0, 1.1],
                                                          [30.0, 1.2]]))
    for cm, law in ((pconfig, usher_law), (jconfig, None)):
        tstat = cm.DPDExtParams.create(temp=1.0, cutoff=1.0, seed=1, a0=25.0,
                                       gamma=4.5, gammaT=2.5,
                                       tstat_only=True)
        assert (usher_law(tstat, 0) if law else j_usher_law(tstat)) is None
    o = ext.obmd
    plan, dplan = UsherPlan.of(ext, o.region5, o.region6), \
        UsherPlan.of(pcfg, o.region5, o.region6)
    assert plan.name == "usher_search_dpdext" and plan.grids == dplan.grids
    assert list(plan.coef) == list(dplan.coef)


def test_scratch_at_path_g_size():
    """Path G's subsets are insert_region_max or n_max // 2 = 71,086 rows a
    side (the stage's b_max), of which the kernel bins only the valid ones:
    its scratch (usher_kernel.scratch_words, six words a row and two a
    cell per side) is under a million int32 words (4 MB), and each grid
    is within MAX_CELLS."""
    cfg = pscenes.obmd_dpdext_config()
    b_max = cfg.capacity.insert_region_max or cfg.capacity.n_max // 2
    assert b_max == 71086
    o = cfg.obmd
    plan = UsherPlan.of(cfg, o.region5, o.region6)
    assert plan.name == "usher_search_dpdext"
    words = scratch_words(plan.grids, b_max, b_max)
    assert words == sum(2 * ((g.n_cells + 1 + 3) & ~3) for g in plan.grids) \
        + 2 * (2 * ((b_max + 3) & ~3) + 4 * b_max)
    assert words < 1_000_000
    assert all(g.n_cells <= MAX_CELLS for g in plan.grids)
