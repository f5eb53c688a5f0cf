"""The port's checkpoint (obmd_tpu_torch/io/checkpoint.py) and FIRE
minimizer (obmd_tpu_torch/minimize.py).

Checkpoints: the save/load round trip is byte-exact, the candidate
generator's state included; a resumed run equals the continued one, the
checks of tests/test_io.py:67-92 (a closed DPD box) and :186-212 (an open
box mid-OBMD run, per tag within 1e-5) held on the port; a configuration
with a lambda parameter refuses with ValueError.  FIRE: on a jittered fcc
LJ box of 500 atoms against the JAX package's `minimize` — the same
iteration count, the energy within 1e-5 relative, positions within 1e-4;
an OBMD scene refuses in both; and the port's one departure, the drift
cut to DMAX a iteration as the reference's min_fire.cpp cuts it."""
import dataclasses

import numpy as np
import pytest
import torch

from obmd_tpu import config as jconfig
from obmd_tpu import geometry as jgeom
from obmd_tpu.minimize import minimize as jminimize
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.config import (Capacity, DPDParams, LJCutParams,
                                   ObmdParams, SceneConfig, UsherParams)
from obmd_tpu_torch.geometry import Box, RegionBlock
from obmd_tpu_torch.integrate import make_step, rebuild_neighbors, setup
from obmd_tpu_torch.io.checkpoint import (_tensor_fields, load_checkpoint,
                                          save_checkpoint)
from obmd_tpu_torch.minimize import _force_energy_fn
from obmd_tpu_torch.minimize import minimize as pminimize
from obmd_tpu_torch.state import init_state

from tests.test_torch_support import CPU


def _closed_cfg(force_path):
    """tests/test_io.py's closed DPD box (300 atoms, L = 5) on the port."""
    box = Box((0.0, 0.0, 0.0), (5.0, 5.0, 5.0), (True, True, True))
    pair = DPDParams.create(temp=1.0, cutoff=1.0, seed=5, a0=25.0,
                            gamma=4.5)
    return SceneConfig(box=box, masses=(1.0,), pair=pair, dt=0.02,
                       capacity=Capacity(n_max=300, cell_capacity=24),
                       skin=0.3, force_path=force_path).finalize()


def _open_cfg(force_path="cellpad"):
    """tests/test_cellpad.py's _small_cfg(n=540, obmd=True) on the port."""
    box = Box((0.0, 0.0, 0.0), (10.0, 4.0, 4.0), (False, True, True))
    pair = DPDParams.create(temp=1.0, cutoff=1.0, seed=5, a0=25.0, gamma=4.5)
    r1 = RegionBlock((0.0, 0.0, 0.0), (2.0, 4.0, 4.0))
    r2 = RegionBlock((8.0, 0.0, 0.0), (10.0, 4.0, 4.0))
    deg = RegionBlock((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    ob = ObmdParams(ntype=0, nfreq=1, seed=11, pxx=5.0, alpha=0.5,
                    tau=0.01, nbuf=50.0, region1=r1, region2=r2,
                    region3=deg, region4=deg, region5=r1, region6=r2,
                    buffer_size=2.0, usher=UsherParams(etarget=10.0,
                                                       nattempt=10),
                    insert_kmax=4)
    return SceneConfig(box=box, masses=(1.0,), pair=pair, dt=0.01,
                       capacity=Capacity(n_max=540, cell_capacity=22),
                       obmd=ob, skin=0.3, force_path=force_path).finalize()


def _gas(cfg, n, seed):
    r = np.random.default_rng(seed)
    lo, hi = np.asarray(cfg.box.lo), np.asarray(cfg.box.hi)
    return init_state(cfg, r.uniform(lo + 0.05, hi - 0.05, (n, 3)),
                      v=r.normal(0, 1, (n, 3)), seed=seed, device=CPU)


def _assert_same(a, b):
    for name in _tensor_fields(a):
        ta, tb = getattr(a, name), getattr(b, name)
        assert (ta is None) == (tb is None), name
        if ta is not None:
            assert ta.dtype == tb.dtype and torch.equal(ta, tb), name
    for name in _tensor_fields(a.obmd):
        assert torch.equal(getattr(a.obmd, name), getattr(b.obmd, name)), name
    assert a.step == b.step
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


def test_round_trip_byte_exact(tmp_path):
    """Every tensor of the State and ObmdScalars, the step and the
    generator state come back equal to the byte; the layout is dropped;
    the configuration comes back equal."""
    sc = pscenes.obmd_dpd_scene(scale=0.25, seed=3, device=CPU)
    st = setup(sc.cfg, sc.state)
    torch.rand(17, generator=st.gen)             # move the generator on
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, sc.cfg, st)
    cfg2, st2 = load_checkpoint(p, device=CPU)
    assert cfg2 == sc.cfg and st2.nbrs is None
    _assert_same(st, st2)
    # the branched columns survive too
    star = pscenes.star_melt_scene(n_stars=8, device=CPU)
    save_checkpoint(p, star.cfg, star.state)
    cfg3, st3 = load_checkpoint(p, device=CPU)
    assert st3.bond3 is not None and st3.impr is not None
    _assert_same(star.state, st3)
    assert torch.equal(torch.rand(5, generator=st3.gen),
                       torch.rand(5, generator=star.state.gen))


@pytest.mark.parametrize("force_path", ["cellpad", "nlist"])
def test_closed_resume_equals_continued(tmp_path, force_path):
    """tests/test_io.py:67-92 on the port: 10 steps, save, load, rebuild
    the layout; one more step from each: the same atoms, x and v per tag
    within 1e-5 (the rebuilt layout sums forces in another slot order)."""
    cfg = _closed_cfg(force_path)
    st = setup(cfg, _gas(cfg, 300, 5))
    step = make_step(cfg)
    for _ in range(10):
        st = step(st)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, cfg, st)
    cfg2, st2 = load_checkpoint(p, device=CPU)
    assert cfg2.dt == cfg.dt and st2.step == st.step
    assert float(st2.sim_time) == float(st.sim_time)
    a, b = step(st), step(rebuild_neighbors(cfg2, st2))
    _same_by_tag(a, b, 1e-5)


def _same_by_tag(a, b, tol):
    def by_tag(s):
        al = s.alive.numpy()
        return {int(t): (x, v) for t, x, v in zip(
            s.tag.numpy()[al], s.x.numpy()[al], s.v.numpy()[al])}
    ma, mb = by_tag(a), by_tag(b)
    assert set(ma) == set(mb)
    assert max(np.abs(ma[t][0] - mb[t][0]).max() for t in ma) < tol
    assert max(np.abs(ma[t][1] - mb[t][1]).max() for t in ma) < tol


def test_obmd_resume_seamless(tmp_path):
    """tests/test_io.py:186-212 on the port: 3 steps of an open box with
    USHER insertion, save, load (cfg passed), rebuild; one more step from
    each: sim_time and ninserted equal, the same tags, x per tag within
    1e-5 — the saved generator draws the same candidates."""
    cfg = _open_cfg()
    st = setup(cfg, _gas(cfg, 500, 8))
    step = make_step(cfg)
    for _ in range(3):
        st = step(st)
    p = str(tmp_path / "obmd.npz")
    save_checkpoint(p, cfg, st)
    _, st2 = load_checkpoint(p, cfg=cfg, device=CPU)
    st2 = rebuild_neighbors(cfg, st2)
    a, b = step(st), step(st2)
    assert float(a.sim_time) == float(b.sim_time)
    assert int(a.obmd.ninserted) == int(b.obmd.ninserted)
    _same_by_tag(a, b, 1e-5)


def test_lambda_parameter_refused(tmp_path):
    cfg = _open_cfg()
    cfg = dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, pxx=lambda t: 5.0 + 0.0 * t))
    st = _gas(cfg, 50, 1)
    with pytest.raises(ValueError, match="unpicklable"):
        save_checkpoint(str(tmp_path / "x.npz"), cfg, st)


def _fcc(nc=5, a=1.5599):
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                     [0, 0.5, 0.5]])
    pts = [(base + [i, j, k]) * a
           for i in range(nc) for j in range(nc) for k in range(nc)]
    return np.concatenate(pts), nc * a


def test_fire_against_jax():
    """tests/test_minimize.py's jittered fcc (here 5^3 cells, 500 atoms,
    lj/cut 2.0): the same iteration count, energy within 1e-5 relative,
    positions within 1e-4, fmax below ftol in both."""
    x0, L = _fcc()
    x = x0 + np.random.default_rng(0).normal(0, 0.05, x0.shape)
    jcfg = jconfig.SceneConfig(
        box=jgeom.Box((0, 0, 0), (L, L, L), (True, True, True)),
        masses=(1.0,), dt=0.005,
        pair=jconfig.LJCutParams.create(cutoff=2.0, epsilon=1.0, sigma=1.0),
        capacity=jconfig.Capacity(n_max=len(x0), cell_capacity=48),
        skin=0.3)
    pcfg = SceneConfig(
        box=Box((0, 0, 0), (L, L, L), (True, True, True)),
        masses=(1.0,), dt=0.005,
        pair=LJCutParams.create(cutoff=2.0, epsilon=1.0, sigma=1.0),
        capacity=Capacity(n_max=len(x0), cell_capacity=48), skin=0.3)
    want = jminimize(jcfg, jinit_state(jcfg, x), ftol=1e-3, maxiter=800)
    got = pminimize(pcfg, init_state(pcfg, x, device=CPU), ftol=1e-3,
                    maxiter=800)
    assert got.iters == want.iters
    assert abs(got.energy - want.energy) <= 1e-5 * abs(want.energy)
    assert np.abs(got.state.x.numpy() - np.asarray(want.state.x)).max() \
        <= 1e-4
    assert got.fmax < 1e-3 and want.fmax < 1e-3
    assert got.converged and want.converged
    assert torch.count_nonzero(got.state.v) == 0
    f, pe = _force_energy_fn(pcfg)(got.state)
    assert torch.equal(f, got.state.f) and float(pe) == got.energy


def test_fire_refuses_open_boundary():
    sc = pscenes.obmd_dpd_scene(scale=0.1, device=CPU)
    with pytest.raises(ValueError, match="open-boundary"):
        pminimize(sc.cfg, sc.state)


def test_fire_dmax_limits_the_drift():
    """The one departure from the JAX minimizer: two atoms at r = 0.5
    move ~0.39 in the JAX package's first iteration; the port cuts the
    drift's dt so that no coordinate moves more than DMAX = 0.1
    (min_fire.cpp's `min_modify dmax`)."""
    from obmd_tpu_torch.minimize import DMAX
    x0, L = _fcc(nc=3)
    x = x0 + np.random.default_rng(2).normal(0, 0.02, x0.shape)
    x[1] = x[0] + np.asarray([0.5, 0.0, 0.0])
    jcfg = jconfig.SceneConfig(
        box=jgeom.Box((0, 0, 0), (L, L, L), (True, True, True)),
        masses=(1.0,), dt=0.005,
        pair=jconfig.LJCutParams.create(cutoff=1.5, epsilon=1.0, sigma=1.0),
        capacity=jconfig.Capacity(n_max=len(x0), cell_capacity=48),
        skin=0.3)
    pcfg = SceneConfig(
        box=Box((0, 0, 0), (L, L, L), (True, True, True)),
        masses=(1.0,), dt=0.005,
        pair=LJCutParams.create(cutoff=1.5, epsilon=1.0, sigma=1.0),
        capacity=Capacity(n_max=len(x0), cell_capacity=48), skin=0.3)
    want = jminimize(jcfg, jinit_state(jcfg, x), ftol=1e-3, maxiter=1)
    got = pminimize(pcfg, init_state(pcfg, x, device=CPU), ftol=1e-3,
                    maxiter=1)
    x32 = x.astype(np.float32)

    def moved(xe):
        d = xe - x32
        d -= L * np.round(d / L)
        return np.linalg.norm(d, axis=1)
    assert got.iters == want.iters == 1
    assert moved(np.asarray(want.state.x)).max() > 2 * DMAX
    # the fastest atom's largest component moves DMAX
    d = got.state.x.numpy() - x32
    d -= L * np.round(d / L)
    assert abs(np.abs(d).max() - DMAX) <= 1e-3 * DMAX
    assert moved(got.state.x.numpy()).max() <= np.sqrt(3.0) * DMAX
    assert np.isfinite(got.state.x.numpy()).all()
