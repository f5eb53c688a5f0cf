"""SHAKE/RATTLE in the port (obmd_tpu_torch/shake.py, the engines' step
hooks) against the JAX package (obmd_tpu/shake.py, its engines).

- shake_table_from_templates: the same table as JAX's, exactly, and the
  same refusal of two distances on one type pair;
- shake_positions, rattle_velocities and constraint_error on SPC/E water
  clusters, some across a periodic face, with dead rows and dead
  partners: x within 2e-6 nm, v within 1e-5 of max|v| (float32 summation
  order: the corrections are sums of 30 sweeps), the error within 2e-6
  of JAX's and at most 1e-5 nm after the sweeps;
- three steps of a small dilute water box (150 waters, 6 cells a side, x
  open, y and z periodic) on the cellpad engine (the JAX pair kernel in
  interpret mode), the nlist engine and the sweep engine (charges off, as
  the sweep has no 1-2 exclusion), against the JAX engines: x within
  1e-5 nm, v and f within 1e-4 of their largest magnitude; every
  constraint within 2e-6 of its target on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import config as jconfig
from obmd_tpu import shake as jshake
from obmd_tpu.integrate import make_step as jmake_step
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch import shake as pshake
from obmd_tpu_torch.config import (BondHarmonicParams, Capacity, MolTemplate,
                                   SceneConfig, shake_table_from_templates)
from obmd_tpu_torch.geometry import Box
from obmd_tpu_torch.integrate import make_step, setup
from obmd_tpu_torch.state import init_state

from test_torch_obmd_lj import to_jax
from test_torch_support import CPU

L = 6.5


def test_table_matches_jax_exactly():
    """The water template's table (O-H 0.1, H-H 0.163299) and a two-
    template table are JAX's, entry for entry; a type pair with two
    distances raises in both."""
    water = pscenes.water_template()
    dimer = MolTemplate(dx=((0.0, 0.0, 0.0), (0.3, 0.0, 0.0)), types=(2, 2),
                        bonds=((0, 1),))
    for tpls, nt in (((water,), 2), ((water, dimer), 3)):
        got = shake_table_from_templates(tpls, nt)
        want = jconfig.shake_table_from_templates(
            [to_jax(t) for t in tpls], nt)
        assert got.d0 == want.d0
        assert (got.iters, got.vel_iters) == (want.iters, want.vel_iters)
    d0 = np.asarray(shake_table_from_templates((water,), 2).d0)
    assert d0[0, 1] == pytest.approx(0.1, abs=1e-12)
    assert d0[1, 1] == pytest.approx(0.163299, abs=1e-6)
    assert d0[0, 0] == 0.0
    bad = MolTemplate(dx=((0, 0, 0), (1, 0, 0), (2.5, 0, 0)),
                      types=(0, 0, 0), bonds=((0, 1), (1, 2)))
    for fn in (shake_table_from_templates,
               jconfig.shake_table_from_templates):
        with pytest.raises(ValueError, match="two different"):
            fn([bad], 1)


def _waters(n_w, seed, lo_x=0.6, spacing=1.1):
    """n_w waters of the template at random orientations, centers on a
    lattice of `spacing` from x = lo_x, wrapped into the box on y and z
    (some straddle the y and z faces); (x, types, q, mol, bonds)."""
    r = np.random.default_rng(seed)
    tpl = pscenes.water_template_coords()
    tpl = tpl - tpl.mean(0)
    side = int(np.ceil(n_w ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_w] * spacing + [lo_x, 0.02, 0.02]
    x = (g[:, None] + np.einsum("sij,kj->ski", pscenes._rotations(r, n_w),
                                tpl)).reshape(-1, 3)
    x[:, 1:] = np.mod(x[:, 1:], L)
    types, q, mol, bonds = pscenes._water_topology(n_w)
    return x, types, q, mol, bonds


def _cfg(force_path="cellpad", charged=True, cap=16, n_max=None):
    pair = pscenes.water_pair()
    if not charged:
        pair = dataclasses.replace(pair, qqrd2e=0.0)
    return SceneConfig(
        box=Box((0.0,) * 3, (L,) * 3, (False, True, True)),
        masses=pscenes.WATER_MASSES, pair=pair, dt=pscenes.WATER_DT,
        capacity=Capacity(n_max=n_max or 480, cell_capacity=cap,
                          max_neighbors=64),
        bond=BondHarmonicParams(k=0.0, r0=0.1)
        if force_path != "sweep" else None,
        shake=shake_table_from_templates([pscenes.water_template()], 2),
        skin=pscenes.WATER_SKIN, force_path=force_path).finalize()


def test_constraint_functions_match_jax():
    """One SHAKE and one RATTLE call on 40 waters (8 across a y or z face)
    drifted by a large step, with the last water's atoms dead and one
    water's H dead (its constraints off): both packages' results and
    constraint errors agree."""
    cfg = _cfg(n_max=126)
    jcfg = to_jax(cfg)
    x, types, q, mol, bonds = _waters(40, 2, spacing=1.6)
    n = len(x)
    r = np.random.default_rng(9)
    x[:, 1:] = np.mod(x[:, 1:] + [[-0.05, 0.07]], L)
    v = r.normal(0.0, 1.5, (n, 3)).astype(np.float32)
    pst = init_state(cfg, x, v=v, types=types, q=q, mol=mol, bonds=bonds,
                     device=CPU)
    alive = pst.alive.clone()
    alive[n - 3:n] = False
    alive[5] = False                     # an H of water 1: its pairs off
    pst = pst.replace(alive=alive)
    jst = jinit_state(jcfg, x, v=v, types=types, q=q, mol=mol, bonds=bonds)
    jst = jst.replace(alive=jnp.asarray(alive.numpy()))
    m = np.asarray(cfg.masses, np.float32)[pst.type.numpy()]
    invm = (1.0 / m).astype(np.float32)
    x1 = pst.x + 0.002 * pst.v
    x1 = cfg.box.wrap(torch.where(pst.alive[:, None], x1, pst.x))
    args_p = (pst.type, pst.bond1, pst.bond2, pst.alive,
              torch.from_numpy(invm))
    args_j = (jst.type, jst.bond1, jst.bond2, jst.alive, jnp.asarray(invm))
    px, pv = pshake.shake_positions(cfg, pst.x, x1, pst.v, *args_p)
    jx, jv = jshake.shake_positions(jcfg, jst.x, jnp.asarray(x1.numpy()),
                                    jst.v, *args_j)
    a = alive.numpy()
    np.testing.assert_allclose(px.numpy()[a], np.asarray(jx)[a], rtol=0,
                               atol=2e-6)
    vmax = np.abs(np.asarray(jv)).max()
    np.testing.assert_allclose(pv.numpy()[a], np.asarray(jv)[a], rtol=0,
                               atol=1e-5 * vmax)
    pr = pshake.rattle_velocities(cfg, px, pv, *args_p)
    jr = jshake.rattle_velocities(jcfg, jx, jv, *args_j)
    np.testing.assert_allclose(pr.numpy()[a], np.asarray(jr)[a], rtol=0,
                               atol=1e-5 * vmax)
    for xs, st in ((x1, pst), (px, pst)):
        got = float(pshake.constraint_error(cfg, st.replace(x=xs)))
        want = float(jshake.constraint_error(
            jcfg, jst.replace(x=jnp.asarray(xs.numpy()))))
        assert abs(got - want) <= 2e-6, (got, want)
    assert float(pshake.constraint_error(cfg, pst.replace(x=px))) <= 1e-5
    assert float(pshake.constraint_error(cfg, pst.replace(x=x1))) > 1e-3
    # dead rows are left where the drift put them
    for i in (5, n - 1):
        np.testing.assert_array_equal(px.numpy()[i], x1.numpy()[i])


@pytest.mark.parametrize("force_path", ["cellpad", "nlist", "sweep"])
def test_engines_match_jax(force_path):
    """Setup and three steps of the dilute water box on each engine
    against the JAX engine (module docstring)."""
    charged = force_path != "sweep"
    cfg = _cfg(force_path, charged=charged)
    jcfg = to_jax(cfg)
    x, types, q, mol, bonds = _waters(150, 4)
    v = np.random.default_rng(5).normal(0.0, 0.6, x.shape)
    kw = dict(v=v, types=types, q=q, mol=mol, bonds=bonds)
    pst = setup(cfg, init_state(cfg, x, device=CPU, **kw))
    jst = jsetup(jcfg, jinit_state(jcfg, x, **kw))
    step = make_step(cfg)
    jstep = jax.jit(jmake_step(jcfg))
    for _ in range(3):
        pst, jst = step(pst), jstep(jst)
    ptag, jtag = pst.tag.numpy(), np.asarray(jst.tag)
    pa, ja = pst.alive.numpy(), np.asarray(jst.alive)
    po = np.argsort(np.where(pa, ptag, 1 << 30))[:int(pa.sum())]
    jo = np.argsort(np.where(ja, jtag, 1 << 30))[:int(ja.sum())]
    assert np.array_equal(ptag[po], jtag[jo]) and len(po) == 450
    for name, atol in (("x", 1e-5), ("v", None), ("f", None)):
        got = getattr(pst, name).numpy()[po]
        want = np.asarray(getattr(jst, name))[jo]
        tol = atol if atol is not None else 1e-4 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=name)
    assert float(pshake.constraint_error(cfg, pst)) <= 2e-6
    assert float(jshake.constraint_error(jcfg, jst)) <= 2e-6
