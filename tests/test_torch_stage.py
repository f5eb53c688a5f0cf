"""The OBMD stage pieces against obmd_tpu's: the feedback law and greedy
acceptance exactly; the face deletion's counts and slot updates exactly and
its momentum tallies at float32 tolerance (1e-5 relative: a sum of a few
hundred float32 terms in another order); the boundary force at float32
tolerance with its total equal to the setpoints."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import engine_cellpad as jec
from obmd_tpu.cellpad import layout_build as j_layout_build
from obmd_tpu.obmd import stage as jstage
from obmd_tpu_torch import convert
from obmd_tpu_torch import engine_cellpad as pec
from obmd_tpu_torch.obmd import stage as pstage

from test_torch_support import jax_arrays, lattice_states


@pytest.mark.parametrize("alpha,nbuf,dt,tau", [
    (0.7, 1327.0 * 0.25, 0.001464, 0.005), (0.7, 700.0, 0.001464, 0.005),
    (0.5, 180.0, 0.01, 0.01), (0.7, 1327.0 * 9, 0.001464, 0.005)])
def test_feedback_count_exact(alpha, nbuf, dt, tau):
    cnt = np.arange(0, 20000, dtype=np.int32)
    want = np.asarray(jstage.feedback_count(jnp.asarray(cnt), 1, alpha, nbuf,
                                            np.float32(dt), tau))
    got = pstage.feedback_count(torch.from_numpy(cnt), 1, alpha, nbuf,
                                np.float32(dt), tau).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sequential_accept_exact(seed):
    jcfg, _, pcfg, _ = lattice_states(scale=0.25, cap=15)
    r = np.random.default_rng(seed)
    k = 16
    base = r.uniform([0.0, 0.0, 0.0], [1.26, 11.198, 11.198], (4, 3))
    cand = (base[r.integers(0, 4, k)] + r.normal(0, 0.3, (k, 3)))
    cand = cand.astype(np.float32)
    ok = r.uniform(size=k) < 0.8
    ct = np.zeros(k, np.int32)
    for budget in (0, 3, 16):
        ja, jc = jstage._sequential_accept(jcfg, jnp.asarray(cand),
                                           jnp.asarray(ct), jnp.asarray(ok),
                                           jnp.int32(budget))
        pa, pc = pstage._sequential_accept(
            pcfg, torch.from_numpy(cand), torch.from_numpy(ct),
            torch.from_numpy(ok), torch.tensor(budget, dtype=torch.int32))
        assert np.array_equal(pa.numpy(), np.asarray(ja))
        assert int(pc) == int(jc)


@pytest.fixture(scope="module")
def laid_out():
    """A laid-out lattice with atoms pushed beyond both open faces."""
    jcfg, jst, pcfg, _ = lattice_states(scale=0.25, cap=15, seed=31)
    geom = jec.make_geometry(jcfg)
    jst = j_layout_build(geom, jcfg.box, jst.replace(x=jcfg.box.wrap(jst.x)))
    x = np.array(jst.x)
    r = np.random.default_rng(1)
    lo_face = np.flatnonzero(np.asarray(jst.alive) & (x[:, 0] < 0.5))
    hi_face = np.flatnonzero(np.asarray(jst.alive) & (x[:, 0] > 7.9))
    x[r.choice(lo_face, 7, replace=False), 0] -= 0.6
    x[r.choice(hi_face, 5, replace=False), 0] += 0.6
    jst = jst.replace(x=jnp.asarray(x))
    sc = jst.obmd.replace(
        momentum_force_left=jnp.asarray([31.0, -2.0, 0.5], jnp.float32),
        momentum_force_right=jnp.asarray([-29.0, 1.5, -0.25], jnp.float32))
    jst = jst.replace(obmd=sc)
    pst = convert.from_arrays(jax_arrays(jst), device="cpu")
    return jcfg, geom, jst, pcfg, pec.make_geometry(pcfg), pst


def test_delete_outside_sliced(laid_out):
    jcfg, jg, jst, pcfg, pg, pst = laid_out
    j2, jl, jr = jec._delete_outside_sliced(jcfg, jg, jst)
    p2, pl, pr = pec._delete_outside_sliced(pcfg, pg, pst)
    jd, pd = jax_arrays(j2), convert.to_arrays(p2)
    assert int(pd["ndeleted"]) == int(jd["ndeleted"]) == 12
    for k in ("alive", "tag", "v"):
        assert np.array_equal(pd[k], jd[k]), k
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)


def test_boundary_force_sliced(laid_out):
    jcfg, jg, jst, pcfg, pg, pst = laid_out
    f = np.random.default_rng(2).normal(0, 30, (jg.n_slots, 3))
    f = f.astype(np.float32)
    jf = np.asarray(jec._boundary_force_sliced(jcfg, jg, jst,
                                               jnp.asarray(f)))
    pf = pec._boundary_force_sliced(pcfg, pg, pst, torch.from_numpy(f))
    pf = pf.numpy()
    np.testing.assert_allclose(pf, jf, rtol=1e-5, atol=1e-4)
    total = (pf - f).astype(np.float64).sum(axis=0)
    want = (np.asarray(pst.obmd.momentum_force_left, np.float64)
            + np.asarray(pst.obmd.momentum_force_right, np.float64))
    np.testing.assert_allclose(total, want, rtol=1e-4, atol=1e-3)


def test_region_count_sliced_exact(laid_out):
    jcfg, jg, jst, pcfg, pg, pst = laid_out
    for jr, pr in ((jcfg.obmd.region1, pcfg.obmd.region1),
                   (jcfg.obmd.region2, pcfg.obmd.region2)):
        assert int(pec._region_count_sliced(pcfg, pg, pst, pr)) == int(
            jec._region_count_sliced(jcfg, jg, jst, jr))
