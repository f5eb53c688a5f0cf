"""The USHER search with the lj/cut law: the port's plain version (the LJ
kernel's reference on the card) against both JAX searches, obmd_tpu's
usher_search_subset_batch (the same arithmetic) and usher_search_pallas
(the TPU kernel, interpret mode), with the energy unshifted and shifted.

Subsets and candidates come from numpy seeds, as tests/test_pallas_usher.py
makes them.  Verdicts are compared on margin-robust candidates (|E -
etarget| >= 0.3 at both final positions: a candidate converging onto the
gate stops within a float32 ulp of it, on a side decided by summation
order); accepted positions within 1e-4 of the batch search and 2e-3 of the
Pallas kernel (its reciprocal-multiply minimum image and r ~ 0 test), with
at least 6 candidates checked.  The dense case is a subset at rho* = 0.8442
where candidates start inside the r^-12 core, far above uovlp = 1e4, so the
overlap step ds = dsovlp - (4 eps / E)^(1/12) runs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import config as jconfig
from obmd_tpu.forces.pallas_usher import usher_search_pallas
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.geometry import RegionBlock as JRegion
from obmd_tpu.obmd.subset import Subset as JSubset
from obmd_tpu.obmd.subset import conservative_energy_force
from obmd_tpu.obmd.subset import usher_search_subset_batch as j_batch
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch.forces.usher_kernel import (UsherPlan, bin_rows, launch,
                                                scratch_words, usher_law,
                                                usher_search)
from obmd_tpu_torch.geometry import Box as PBox
from obmd_tpu_torch.geometry import RegionBlock as PRegion
from obmd_tpu_torch.obmd.subset import Subset as PSubset

LX, L, BUF = 12.0, 6.0, 2.5

CASES = {
    # a moderately dense gas: most searches end in a cavity below target
    "gas": dict(rho=0.45, etarget=-1.5, seed=3),
    # the open LJ fluid's density and target (scenes.OBMD_LJ_ETARGET)
    "dense": dict(rho=0.8442, etarget=-5.6354, seed=5),
}


def _configs(etarget, shift, nattempt=40, k=16):
    """The same LJ scene in both packages' config classes."""
    out = []
    for cm, Box, Region in ((jconfig, JBox, JRegion),
                            (pconfig, PBox, PRegion)):
        box = Box((0.0, 0.0, 0.0), (LX, L, L), (False, True, True))
        r5 = Region((0.0, 0.0, 0.0), (BUF, L, L))
        r6 = Region((LX - BUF, 0.0, 0.0), (LX, L, L))
        deg = Region((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
        pair = cm.LJCutParams.create(cutoff=2.5, epsilon=1.0, sigma=1.0,
                                     shift=shift)
        ob = cm.ObmdParams(ntype=0, nfreq=1, seed=2, pxx=1.0, alpha=0.7,
                           tau=0.02, nbuf=50.0, region1=r5, region2=r6,
                           region3=deg, region4=deg, region5=r5, region6=r6,
                           buffer_size=BUF,
                           usher=cm.UsherParams(etarget=etarget,
                                                nattempt=nattempt),
                           insert_kmax=k)
        out.append(cm.SceneConfig(box=box, masses=(1.0,), pair=pair,
                                  dt=0.005,
                                  capacity=cm.Capacity(n_max=512,
                                                       cell_capacity=44),
                                  obmd=ob, skin=0.4, force_path="cellpad"))
    return out


def _subsets(r, rho, lo, hi, n_invalid):
    """A uniform subset at density rho over [lo, hi) (all of y and z), its
    last n_invalid rows invalid, in both packages' Subset classes."""
    b = int(rho * np.prod(np.subtract(hi, lo))) + n_invalid
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


def _run(case, shift):
    c = CASES[case]
    jcfg, pcfg = _configs(c["etarget"], shift)
    r = np.random.default_rng(c["seed"])
    pad = 2.5 + 0.4
    jl, pl = _subsets(r, c["rho"], [0.0, 0.0, 0.0], [BUF + pad, L, L], 7)
    jr, pr = _subsets(r, c["rho"], [LX - BUF - pad, 0.0, 0.0], [LX, L, L], 7)
    k = jcfg.obmd.insert_kmax
    o = jcfg.obmd
    cl = np.array(o.region5.sample_uniform(
        jnp.asarray(r.random((k, 3), dtype=np.float32))))
    cr = np.array(o.region6.sample_uniform(
        jnp.asarray(r.random((k, 3), dtype=np.float32))))
    ct = jnp.zeros((k,), jnp.int32)
    batch = j_batch(jcfg, jl, jr, jnp.asarray(cl), jnp.asarray(cr), ct,
                    o.region5, o.region6)
    pallas = usher_search_pallas(jcfg, jl, jr, jnp.asarray(cl),
                                 jnp.asarray(cr), o.region5, o.region6)
    po = pcfg.obmd
    plain = usher_search(pcfg, pl, pr, torch.from_numpy(cl),
                         torch.from_numpy(cr), po.region5, po.region6)
    return jcfg, (jl, jr), (cl, cr), batch, pallas, [t.numpy() for t in plain]


def _energy(jcfg, sub, pos):
    ct = jnp.zeros((pos.shape[0],), jnp.int32)
    return np.asarray(conservative_energy_force(jcfg.pair, sub, jcfg.box,
                                                jnp.asarray(pos), ct)[0])


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_lj_matches_batch_and_pallas(case, shift):
    jcfg, subs, cands, batch, pallas, plain = _run(case, shift)
    pp, pa, pit = plain
    et = float(jcfg.obmd.usher.etarget)
    overlap = sum(int((_energy(jcfg, subs[s], cands[s])
                       > jcfg.obmd.usher.uovlp).sum()) for s in (0, 1))
    for ref, tol in ((batch, 1e-4), (pallas, 2e-3)):
        rp, ra, _ = (np.asarray(t) for t in ref)
        checked = accepted = 0
        for side in range(2):
            ea = _energy(jcfg, subs[side], pp[side])
            eb = _energy(jcfg, subs[side], rp[side])
            for k in range(pp.shape[1]):
                if abs(ea[k] - et) < 0.3 or abs(eb[k] - et) < 0.3:
                    continue
                checked += 1
                assert bool(pa[side, k]) == bool(ra[side, k]), (side, k)
                if pa[side, k]:
                    accepted += 1
                    assert np.abs(pp[side, k] - rp[side, k]).max() < tol
        assert checked >= 6, checked
        if case == "gas":
            assert accepted >= 1
    if case == "dense":
        # candidates start inside the core: the overlap step runs
        assert overlap >= 1
    assert pit.dtype == np.int32 and pit.shape == pa.shape
    assert (pit >= 0).all() and (pit <= jcfg.obmd.usher.nattempt).all()


@pytest.mark.parametrize("shift", [False, True])
def test_lj_rows_and_padding(shift):
    """usher_law's lj/cut table against the trial type: lj3, lj4, cut,
    eshift (0 unshifted), rows past ntypes zero; the binning (bin_rows, the
    kernel's) keeps the valid rows only, sorted by cell with x fastest and
    by row index within a cell; the two sides keep their own lengths in the
    scratch; launch refuses CPU tensors."""
    _, pcfg = _configs(-5.6354, shift)
    name, table, cut_col = usher_law(pcfg.pair, 0)
    assert name == "usher_search_lj" and cut_col == 2
    rc6 = (1.0 / 2.5 ** 2) ** 3
    esh = rc6 * (4.0 * rc6 - 4.0) if shift else 0.0
    np.testing.assert_array_equal(
        table[0], np.asarray([4.0, 4.0, 2.5, esh], np.float32))
    assert (table[1:] == 0).all()
    o = pcfg.obmd
    plan = UsherPlan.of(pcfg, o.region5, o.region6)
    grid = plan.grids[0]
    r = np.random.default_rng(0)
    _, p = _subsets(r, 0.5, [0, 0, 0], [5, 6, 6], 9)
    rows, start = bin_rows(grid, p)
    ok = p.valid.numpy()
    assert sorted(rows.tolist()) == np.flatnonzero(ok).tolist()
    cell = grid.cell_id(grid.cell3(p.x[rows])).numpy()
    assert (np.diff(cell) >= 0).all()
    same = np.diff(cell) == 0
    assert (np.diff(rows.numpy())[same] > 0).all()
    assert start[0] == 0 and start[-1] == ok.sum()
    np.testing.assert_array_equal(
        np.diff(start.numpy()), np.bincount(cell, minlength=grid.n_cells))
    _, pr = _subsets(r, 0.5, [9, 0, 0], [12, 2, 2], 3)
    b, b2 = p.x.shape[0], pr.x.shape[0]
    assert b != b2
    n = grid.n_cells
    assert scratch_words(plan.grids, b, b2) == sum(
        2 * ((n + 1 + 3) // 4 * 4) + 2 * ((m + 3) // 4 * 4) + 4 * m
        for m in (b, b2))
    cand = torch.zeros((o.insert_kmax, 3))
    with pytest.raises(ValueError, match="on the card"):
        launch(pcfg, p, pr, cand, cand + 10.0, o.region5, o.region6)
