"""The USHER search's plain PyTorch version (the kernel's reference on the
card) against both JAX searches: obmd_tpu's usher_search_subset_batch (the
same arithmetic) and usher_search_pallas (the TPU kernel, interpret mode).

USHER verdicts are decided at the etarget gate, where a candidate that
converges from above stops within a float32 ulp of etarget + eps; which side
it lands on depends on the summation order of its energy.  So, as
tests/test_pallas_usher.py does, verdicts are compared on margin-robust
candidates (|E - etarget| >= 0.3 at both final positions): positions within
1e-4 against the batch search (same arithmetic) and 2e-3 against the Pallas
kernel (rsqrt and reciprocal-multiply arithmetic), with at least 6
candidates checked."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import config as jconfig
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.geometry import RegionBlock as JRegion
from obmd_tpu.forces.pallas_usher import usher_search_pallas
from obmd_tpu.obmd.subset import Subset as JSubset
from obmd_tpu.obmd.subset import conservative_energy_force
from obmd_tpu.obmd.subset import usher_search_subset_batch as j_batch
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch.forces.usher_kernel import usher_search
from obmd_tpu_torch.geometry import Box as PBox
from obmd_tpu_torch.geometry import RegionBlock as PRegion
from obmd_tpu_torch.obmd.subset import Subset as PSubset


def _configs(a0, etarget, nattempt, lx=8.0, l=4.0, buf=1.6, k=8):
    """The same scene in both packages' config classes."""
    out = []
    for cm, Box, Region in ((jconfig, JBox, JRegion),
                            (pconfig, PBox, PRegion)):
        box = Box((0.0, 0.0, 0.0), (lx, l, l), (False, True, True))
        r5 = Region((0.0, 0.0, 0.0), (buf, l, l))
        r6 = Region((lx - buf, 0.0, 0.0), (lx, l, l))
        deg = Region((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
        pair = cm.DPDParams.create(temp=1.0, cutoff=1.0, seed=1, a0=a0,
                                   gamma=4.5)
        ob = cm.ObmdParams(ntype=0, nfreq=1, seed=2, pxx=1.0, alpha=0.5,
                           tau=0.01, nbuf=50.0, region1=r5, region2=r6,
                           region3=deg, region4=deg, region5=r5, region6=r6,
                           buffer_size=buf,
                           usher=cm.UsherParams(etarget=etarget,
                                                nattempt=nattempt),
                           insert_kmax=k)
        out.append(cm.SceneConfig(box=box, masses=(1.0,), pair=pair,
                                  dt=0.01,
                                  capacity=cm.Capacity(n_max=256,
                                                       cell_capacity=24),
                                  obmd=ob, skin=0.3, force_path="cellpad"))
    return out


def _subsets(r, b, lo, hi, n_invalid):
    xs = r.uniform(lo, hi, (b, 3)).astype(np.float32)
    valid = np.ones(b, bool)
    valid[b - n_invalid:] = False
    j = JSubset(idx=jnp.zeros((b,), jnp.int32), x=jnp.asarray(xs),
                type=jnp.zeros((b,), jnp.int32),
                q=jnp.zeros((b,), jnp.float32), valid=jnp.asarray(valid),
                overflow=jnp.zeros((), bool))
    p = PSubset(x=torch.from_numpy(xs),
                type=torch.zeros((b,), dtype=torch.int32),
                valid=torch.from_numpy(valid),
                overflow=torch.zeros((), dtype=torch.bool))
    return j, p


CASES = {
    # tests/test_pallas_usher.py's toy scene
    "toy": dict(a0=60.0, etarget=12.0, nattempt=10, b=140, k=8, seed=3),
    # the OBMD_DPD law and gate (a0 209.6, etarget 31.03, 40 iterations,
    # K = 16) on a rho = 3 subset of a 11.198^2 cross-section
    "deck": dict(a0=209.6, etarget=31.03, nattempt=40, b=1000, k=16, seed=8,
                 lx=12.0, l=11.198, buf=1.68),
}


def _run(case):
    c = dict(CASES[case])
    b, k, seed = c.pop("b"), c.pop("k"), c.pop("seed")
    lx, l, buf = c.pop("lx", 8.0), c.pop("l", 4.0), c.pop("buf", 1.6)
    jcfg, pcfg = _configs(lx=lx, l=l, buf=buf, k=k, **c)
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
    plain = usher_search(pcfg, pl, pr, torch.from_numpy(cl),
                         torch.from_numpy(cr), po.region5, po.region6)
    return jcfg, (jl, jr), batch, pallas, [t.numpy() for t in plain]


def _robust(jcfg, subs, pos_a, pos_b, side, k):
    ct = jnp.zeros((pos_a.shape[1],), jnp.int32)
    et = float(jcfg.obmd.usher.etarget)
    ea, _ = conservative_energy_force(jcfg.pair, subs[side], jcfg.box,
                                      jnp.asarray(pos_a[side]), ct)
    eb, _ = conservative_energy_force(jcfg.pair, subs[side], jcfg.box,
                                      jnp.asarray(pos_b[side]), ct)
    return abs(float(ea[k]) - et) >= 0.3 and abs(float(eb[k]) - et) >= 0.3


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_batch_and_pallas(case):
    jcfg, subs, batch, pallas, plain = _run(case)
    pp, pa, pit = plain
    for ref, tol in ((batch, 1e-4), (pallas, 2e-3)):
        rp, ra = np.asarray(ref[0]), np.asarray(ref[1])
        checked = accepted = 0
        for side in range(2):
            for k in range(pp.shape[1]):
                if not _robust(jcfg, subs, pp, rp, side, k):
                    continue
                checked += 1
                assert bool(pa[side, k]) == bool(ra[side, k]), (side, k)
                if pa[side, k]:
                    accepted += 1
                    assert np.abs(pp[side, k] - rp[side, k]).max() < tol
        assert checked >= 6 and accepted >= 1, (checked, accepted)
    assert pit.dtype == np.int32 and pit.shape == pa.shape
    assert (pit >= 0).all() and (pit <= jcfg.obmd.usher.nattempt).all()


def test_wrapper_rejects_unported_law():
    """usher_law gives the DPD law's coefficient table against the trial
    type (row tj: a0, cut, 0, 0; rows past ntypes zero); a style without a
    kernel law gives None, and its grid plan raises."""
    import types
    from obmd_tpu_torch.forces.usher_kernel import (MAX_TYPES, N_COEF,
                                                    UsherGrid, usher_law)
    _, pcfg = _configs(a0=60.0, etarget=12.0, nattempt=10)
    name, table, cut_col = usher_law(pcfg.pair, 0)
    assert name == "usher_search" and cut_col == 1
    assert table.shape == (MAX_TYPES, N_COEF) and table.dtype == np.float32
    np.testing.assert_array_equal(table[0], [60.0, 1.0, 0.0, 0.0])
    assert (table[1:] == 0).all()
    assert usher_law(object(), 0) is None
    bare = types.SimpleNamespace(pair=object(), obmd=pcfg.obmd, box=pcfg.box)
    with pytest.raises(NotImplementedError):
        UsherGrid.of(bare, pcfg.obmd.region5, 1.3)


def test_kernel_inputs_and_launch_guards():
    """The kernel takes each side's Subset as it is, with its own length
    (20 and 24 rows here): the plan holds both grids, the regions' bounds
    and the coefficient table on the host, and the scratch is each side's
    cell counts and starts, rows' cells, scattered indices and sorted
    float4 rows;
    launch takes only contiguous tensors on the card, so a CPU tensor
    raises instead of reaching a plain version."""
    from obmd_tpu_torch.forces.usher_kernel import (UsherPlan, launch,
                                                    scratch_words)
    _, pcfg = _configs(a0=60.0, etarget=12.0, nattempt=10)
    r = np.random.default_rng(0)
    _, pl = _subsets(r, 20, [0, 0, 0], [2.6, 4, 4], 3)
    _, pr = _subsets(r, 24, [5.4, 0, 0], [8, 4, 4], 3)
    o = pcfg.obmd
    plan = UsherPlan.of(pcfg, o.region5, o.region6)
    # x: the region (1.6) widened by pad = 1.3 on both sides, 4 cells of
    # 1.05; y and z: the box, 3 cells of 4/3
    assert [g.cells for g in plan.grids] == [(4, 3, 3), (4, 3, 3)]
    assert list(plan.cells) == [4, 3, 3, 4, 3, 3]
    np.testing.assert_array_equal(
        list(plan.bounds), np.float32([*o.region5.lo, *o.region5.hi,
                                       *o.region6.lo, *o.region6.hi]))
    assert list(plan.coef)[:2] == [60.0, 1.0] and plan.ntypes == 1
    # per side: 2 * align4(36 + 1) + 2 * align4(B) + 4 * B
    assert scratch_words(plan.grids, 20, 24) == (80 + 40 + 80) + (80 + 48
                                                                  + 96)
    cand = torch.from_numpy(r.uniform(0, 1, (8, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="on the card"):
        launch(pcfg, pl, pr, cand, cand + 6.0, o.region5, o.region6)
