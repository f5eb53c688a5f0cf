"""The slab decomposition's geometry, cuts and sharding against the JAX
package: make_slab_geom field for field (the slab grid and its padded
layout included), balanced_boundaries and _rebalanced_cuts, and
shard_by_slab slot for slot.  No process group: the port's sums over
the ranks run on a world of one (Comm.solo) where the JAX function runs
on a one-device mesh."""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from obmd_tpu import config as jconfig
from obmd_tpu import scenes as jscenes
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.geometry import RegionBlock as JRegion
from obmd_tpu.parallel import slab_decomp as jslab
from obmd_tpu.state import init_state as jinit
from obmd_tpu_torch import convert
from obmd_tpu_torch.parallel import slab_decomp as pslab
from obmd_tpu_torch.parallel.comm import Comm

from test_torch_support import jax_arrays


def _graft_bonded(n_devices):
    """__graft_entry__.py:76-115's MOLECULE-mode dimer scene (bonds and a
    molecule template: the bonded reach)."""
    dimer = jconfig.MolTemplate(dx=((-0.3, 0.0, 0.0), (0.3, 0.0, 0.0)),
                                types=(0, 0), q=(0.0, 0.0), bonds=((0, 1),))
    lx = max(16.0, 2.0 * n_devices)
    box = JBox((0.0, 0.0, 0.0), (lx, 4.0, 4.0), (False, True, True))
    b = 2.0
    r1 = JRegion((0.0, 0.0, 0.0), (b, 4.0, 4.0))
    r2 = JRegion((lx - b, 0.0, 0.0), (lx, 4.0, 4.0))
    obmd = jconfig.ObmdParams(
        ntype=0, nfreq=1, seed=11, pxx=2.0, alpha=0.5, tau=0.01, nbuf=40.0,
        region1=r1, region2=r2, region5=r1, region6=r2, buffer_size=b,
        usher=None, near=0.4, mol=dimer, mol_len=2, insert_kmax=4,
        vz=(0.2, 0.2))
    return jconfig.SceneConfig(
        box=box, masses=(1.0,), dt=0.004,
        pair=jconfig.DPDParams.create(temp=0.4, cutoff=1.0, seed=9, a0=15.0,
                                      gamma=2.0),
        bond=jconfig.BondHarmonicParams(k=40.0, r0=0.6),
        capacity=jconfig.Capacity(n_max=1024, cell_capacity=16),
        obmd=obmd, skin=0.3, force_path="nlist").finalize()


def _graft_shake(n_devices):
    """__graft_entry__.py:117-158's SHAKE water scene (the constraint
    cluster's reach)."""
    water = jconfig.MolTemplate(
        dx=((0.0, 0.2667, 0.0), (-0.6, -0.2333, 0.0), (0.6, -0.2333, 0.0)),
        types=(0, 1, 1), q=(0.0, 0.0, 0.0),
        bonds=((0, 1), (0, 2), (1, 2)))
    lxs = max(16.0, 3.5 * n_devices)
    box = JBox((0.0, 0.0, 0.0), (lxs, 4.0, 4.0), (False, True, True))
    return jconfig.SceneConfig(
        box=box, masses=(16.0, 1.0), dt=0.004,
        pair=jconfig.DPDParams.create(temp=0.4, cutoff=1.0, seed=7, a0=10.0,
                                      gamma=2.0, ntypes=2),
        capacity=jconfig.Capacity(n_max=1024, cell_capacity=16),
        shake=jconfig.shake_table_from_templates([water], 2),
        skin=0.3, force_path="nlist").finalize()


def _same_geom(pg, jg):
    for f in dataclasses.fields(jg):
        a, b = getattr(pg, f.name), getattr(jg, f.name)
        if f.name == "spec_local":
            for g in dataclasses.fields(b):
                assert getattr(a, g.name) == getattr(b, g.name), g.name
        elif f.name == "pad_geom":
            assert (a is None) == (b is None)
            if b is not None:
                assert a._fields == b._fields
                assert tuple(a) == tuple(b)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("scale", [0.35, 9.0])
@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_make_slab_geom_obmd_dpd(scale, ndev):
    jcfg = jscenes.obmd_dpd_config(scale=scale, force_path="sweep")
    pcfg = convert.scene_config(jcfg)
    _same_geom(pslab.make_slab_geom(pcfg, ndev),
               jslab.make_slab_geom(jcfg, ndev))


def test_make_slab_geom_full_width_table():
    """The geometries the pair kernel runs on at full width (scale 9):
    4 ranks 56 x 8 x 8 cells at cap 27 in 28 blocks, 1 rank 219 x 8 x 8 at
    cap 26 in 110 blocks."""
    pcfg = convert.scene_config(jscenes.obmd_dpd_config(scale=9.0,
                                                        force_path="sweep"))
    for ndev, dims, cap, nb, n_loc in ((4, (56, 8, 8), 27, 28, 35543),
                                       (1, (219, 8, 8), 26, 110, 142172)):
        g = pslab.make_slab_geom(pcfg, ndev)
        assert (g.pad_geom.dims, g.pad_geom.cap, g.pad_geom.n_blocks,
                g.n_loc, g.pad_geom.periodic_x) == (dims, cap, nb, n_loc,
                                                     False)


@pytest.mark.parametrize("kw", [
    dict(boundaries=(0.0, 2.5, 6.0, 9.0, 11.7579)), dict(grow=1.5),
    dict(n_loc=700, h_max=90, m_max=40, b_max=300)])
def test_make_slab_geom_options(kw):
    jcfg = jscenes.obmd_dpd_config(scale=0.35, force_path="sweep")
    pcfg = convert.scene_config(jcfg)
    if "boundaries" in kw:
        kw = dict(boundaries=kw["boundaries"][:-1] + (jcfg.box.hi[0],))
    _same_geom(pslab.make_slab_geom(pcfg, 4, **kw),
               jslab.make_slab_geom(jcfg, 4, **kw))


@pytest.mark.parametrize("make", [_graft_bonded, _graft_shake])
@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_make_slab_geom_bonded(make, ndev):
    jcfg = make(ndev)
    _same_geom(pslab.make_slab_geom(convert.scene_config(jcfg), ndev),
               jslab.make_slab_geom(jcfg, ndev))
    if make is _graft_shake:
        _same_geom(pslab.make_slab_geom(convert.scene_config(jcfg), ndev,
                                        grow=1.5),
                   jslab.make_slab_geom(jcfg, ndev, grow=1.5))


def _skewed(cfg, n, seed):
    """Three quarters of n atoms in the left half of the box."""
    r = np.random.default_rng(seed)
    lo, hi = np.asarray(cfg.box.lo), np.asarray(cfg.box.hi)
    mid = 0.5 * (lo[0] + hi[0])
    a = r.uniform(lo, [mid, hi[1], hi[2]], (3 * n // 4, 3))
    b = r.uniform([mid, lo[1], lo[2]], hi, (n - 3 * n // 4, 3))
    return np.concatenate([a, b])


@pytest.mark.parametrize("scale,ndev", [(0.35, 4), (1.0, 8)])
def test_balanced_boundaries_and_rebalance(scale, ndev):
    """The host quantile cuts and one dynamic rebalance from the uniform
    cuts (the x histogram bin for bin: a box length whose bin width is no
    power of two)."""
    jcfg = jscenes.obmd_dpd_config(scale=scale, force_path="sweep")
    pcfg = convert.scene_config(jcfg)
    x = _skewed(jcfg, 900, 4)
    js = jinit(jcfg, x)
    ps = convert.from_arrays(jax_arrays(js), device="cpu")
    cuts = pslab.balanced_boundaries(pcfg, ps, ndev)
    assert cuts == jslab.balanced_boundaries(jcfg, js, ndev)
    jg = jslab.make_slab_geom(jcfg, ndev, grow=1.5)
    pg = pslab.make_slab_geom(pcfg, ndev, grow=1.5)
    jcuts = jax.numpy.asarray(jg.boundaries, jax.numpy.float32)
    mesh = jslab.make_mesh(1)
    fn = jax.shard_map(
        lambda xx, aa, cc: jslab._rebalanced_cuts(
            jcfg, jg, SimpleNamespace(x=xx, alive=aa), cc),
        mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(), check_vma=False)
    want = np.asarray(jax.jit(fn)(js.x, js.alive, jcuts))
    got = pslab._rebalanced_cuts(pcfg, pg, Comm.solo("cpu"), ps,
                                 torch.tensor(pg.boundaries,
                                              dtype=torch.float32))
    assert np.array_equal(got.numpy(), want)
    assert not np.allclose(want, np.asarray(jg.boundaries, np.float32))


@pytest.mark.parametrize("which", ["obmd", "bonded"])
def test_shard_by_slab(which):
    """Rank r's state equals block r of JAX's sharded global state, slot
    for slot (partner columns as tags)."""
    if which == "obmd":
        sc = jscenes.obmd_dpd_scene(scale=0.35, seed=3, force_path="sweep")
        jcfg, js = sc.cfg, sc.state
        ndev = 4
    else:
        ndev = 2
        jcfg = _graft_bonded(ndev)
        r = np.random.default_rng(5)
        nm = 40
        cx = np.c_[r.uniform(0.6, 15.4, nm), r.uniform(0.4, 3.6, (nm, 2))]
        xm = np.zeros((2 * nm, 3))
        xm[0::2] = cx - [0.3, 0.0, 0.0]
        xm[1::2] = cx + [0.3, 0.0, 0.0]
        bonds = np.stack([np.arange(1, 2 * nm, 2),
                          np.arange(2, 2 * nm + 1, 2)], axis=1)
        js = jinit(jcfg, xm, v=r.normal(0, 0.4, (2 * nm, 3)), bonds=bonds,
                   mol=np.repeat(np.arange(1, nm + 1), 2))
    pcfg = convert.scene_config(jcfg)
    jg = jslab.make_slab_geom(jcfg, ndev)
    pg = pslab.make_slab_geom(pcfg, ndev)
    want = jax_arrays(jslab.shard_by_slab(jcfg, jg, js, jslab.make_mesh(ndev)))
    ps = convert.from_arrays(jax_arrays(js), device="cpu")
    parts = [convert.to_arrays(pslab.shard_by_slab(pcfg, pg, ps, r))
             for r in range(ndev)]
    for k in ("x", "v", "f", "type", "tag", "alive", "q", "mol", "rep_atom",
              "bond1", "bond2", "lambdaF", "cms_mol"):
        got = np.concatenate([p[k] for p in parts])
        assert np.array_equal(got, want[k]), k
    if which == "bonded":
        assert (want["bond1"] > 0).sum() == 80
    with pytest.raises(ValueError, match="holds more than n_loc"):
        pslab.shard_by_slab(pcfg, pslab.make_slab_geom(pcfg, ndev, n_loc=8),
                            ps, 0)
