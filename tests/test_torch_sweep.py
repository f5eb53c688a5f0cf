"""The sweep engine and the observables against the JAX package:
cells.build_cells, forces/pairs.make_pair_law and pair_sweep (DPD and LJ),
observe.make_thermo_fn and make_profile_fn, and the LJ scene's config and
state through the converter.

Tolerances: pair laws elementwise within 1e-5 relative; sweep forces within
1e-5 * max|f|, energies and virials within 1e-5 relative (float32
summation order of the same pairs); thermo and profiles within 1e-4
relative (the kinetic sums are reduced in different orders)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import observe as jobserve
from obmd_tpu import scenes as jscenes
from obmd_tpu.cells import build_cells as jbuild_cells
from obmd_tpu.forces import pairs as jpairs
from obmd_tpu.integrate import _salt as j_salt
from obmd_tpu.integrate import make_grid_spec as j_make_grid_spec
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch import convert
from obmd_tpu_torch import observe as pobserve
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.cells import build_cells
from obmd_tpu_torch.forces import pairs as ppairs
from obmd_tpu_torch.integrate import _salt, compute_forces, make_grid_spec

from test_torch_support import (CPU, _mirror, jax_arrays, jittered,
                                lattice_states)


def lj_states(nx, cap=36, jitter=True):
    """(jax cfg, jax state, port cfg, port state) of the melt lattice."""
    js = jscenes.lj_melt_scene(nx=nx, cell_capacity=cap)
    ps = pscenes.lj_melt_scene(nx=nx, cell_capacity=cap, device=CPU)
    if jitter:
        x = jittered(js.cfg, js.state.x)
        v = np.asarray(js.state.v)
        return (js.cfg, jinit_state(js.cfg, x, v=v), ps.cfg,
                convert.from_arrays(jax_arrays(jinit_state(js.cfg, x, v=v)),
                                    device=CPU))
    return js.cfg, js.state, ps.cfg, ps.state


def sweeps(jcfg, jst, pcfg, pst, **kw):
    """Both packages' pair_sweep on one state, with every output on."""
    spec = j_make_grid_spec(jcfg)
    tab = jbuild_cells(spec, jst.x, jst.alive)
    jpf = jpairs.pair_sweep(jcfg.pair, jcfg.box, spec, tab, jst.x, jst.v,
                            jst.type, jst.tag, jst.q, j_salt(jcfg, jst.step),
                            dt=jcfg.dt, **kw)
    pspec = make_grid_spec(pcfg)
    ptab = build_cells(pspec, pst.x, pst.alive)
    assert dataclasses.asdict(pspec) == dataclasses.asdict(spec)
    assert np.array_equal(ptab.table.numpy(), np.asarray(tab.table))
    assert int(ptab.overflow) == int(tab.overflow) == 0
    ppf = ppairs.pair_sweep(pcfg.pair, pcfg.box, pspec, ptab, pst.x, pst.v,
                            pst.type, pst.tag, _salt(pcfg, pst.step),
                            dt=pcfg.dt, **kw)
    return jpf, ppf


ALL = dict(compute_energy=True, compute_virial=True, compute_virial_atom=True)


def _check_sweep(jpf, ppf):
    f_j = np.asarray(jpf.f)
    scale = np.abs(f_j).max()
    assert scale > 1.0
    assert np.abs(ppf.f.numpy() - f_j).max() <= 1e-5 * scale
    np.testing.assert_allclose(float(ppf.pe.sum()), float(jnp.sum(jpf.pe)),
                               rtol=1e-5)
    pe_scale = np.abs(np.asarray(jpf.pe)).max()
    assert np.abs(ppf.pe.numpy() - np.asarray(jpf.pe)).max() <= 1e-5 * pe_scale
    w_j = np.asarray(jpf.virial)
    np.testing.assert_allclose(ppf.virial.numpy(), w_j, rtol=0,
                               atol=1e-5 * np.abs(w_j).max())
    wa_j = np.asarray(jpf.virial_atom)
    assert np.abs(ppf.virial_atom.numpy() - wa_j).max() \
        <= 1e-5 * np.abs(wa_j).max()


def test_pair_sweep_lj_matches_jax():
    """LJ on the jittered nx = 6 lattice at cap 48 (3 cells per periodic
    axis, where the sweep's deduped stencil and the minimum image carry the
    whole periodic structure)."""
    _check_sweep(*sweeps(*lj_states(6, cap=48), **ALL))


def test_pair_sweep_dpd_matches_jax():
    """DPD (conservative, drag and the counter-hash noise) on a set-up
    OBMD_DPD lattice (open x)."""
    jcfg, jst, pcfg, pst = lattice_states(scale=0.25, cap=24, seed=21)
    jst = jsetup(jcfg, jst)
    pst = convert.from_arrays(jax_arrays(jst), device=CPU)
    _check_sweep(*sweeps(jcfg, jst, pcfg, pst, **ALL))


@pytest.mark.parametrize("law", ["dpd", "lj", "lj_shift"])
def test_pair_law_matches_jax(law):
    from obmd_tpu import config as jconfig
    if law == "dpd":
        kw = dict(temp=1.0, cutoff=1.0, seed=3, a0=25.0, gamma=4.5)
        jp, pp = jconfig.DPDParams.create(**kw), pconfig.DPDParams.create(**kw)
        rmax = 1.05
    else:
        kw = dict(cutoff=2.5, epsilon=1.0, sigma=1.0, shift=law == "lj_shift")
        jp = jconfig.LJCutParams.create(**kw)
        pp = pconfig.LJCutParams.create(**kw)
        rmax = 2.6
    r = np.random.default_rng(7)
    n = 4096
    d = r.normal(size=(n, 3)).astype(np.float32)
    d *= (r.uniform(0.8 if law != "dpd" else 0.05, rmax, (n, 1))
          / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dv = r.normal(size=(n, 3)).astype(np.float32)
    tags = r.integers(1, 100000, (2, n)).astype(np.int32)
    rsq = (d * d).sum(-1)
    zero = np.zeros(n, np.int32)
    salt = 0x12345679
    fj, ej = jpairs.make_pair_law(jp, 0.01, jnp.float32)(
        jnp.asarray(rsq), jnp.asarray(d), jnp.asarray(dv), jnp.asarray(zero),
        jnp.asarray(zero), jnp.asarray(tags[0]), jnp.asarray(tags[1]),
        jnp.uint32(salt))
    t = torch.from_numpy
    fp, ep = ppairs.make_pair_law(pp, 0.01)(
        t(rsq), t(d), t(dv), t(zero), t(zero), t(tags[0]), t(tags[1]), salt)
    for got, want in ((fp, fj), (ep, ej)):
        want = np.asarray(want)
        assert np.count_nonzero(want) > n // 2
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max() * 1e-2)


def test_unported_laws_raise():
    """A law the port lacks raises in the sweep, and a law the pair kernel
    lacks (dpd/ext) raises on the cellpad engine; dpd/tstat, which has no
    conservative energy for USHER, runs under an OBMD stage there with the
    plain search (as the JAX package's stage runs it)."""
    from obmd_tpu_torch.engine_cellpad import check_supported
    with pytest.raises(NotImplementedError):
        ppairs.make_pair_law(object(), 0.01)
    tstat = pconfig.DPDTstatParams.create(t_start=1.0, cutoff=1.0, seed=1,
                                          gamma=4.5)
    cfg = pscenes.obmd_dpd_config(scale=0.25)
    with pytest.raises(NotImplementedError, match="DPDExtParams"):
        check_supported(pscenes.obmd_dpdext_config(
            scale=0.25, force_path="cellpad"))
    check_supported(dataclasses.replace(cfg, pair=tstat).finalize())


def _thermo_close(pt, jt):
    for k in ("temp", "pe", "ke", "pressure", "pxx", "epair", "fmax",
              "fnorm"):
        np.testing.assert_allclose(float(getattr(pt, k)),
                                   float(getattr(jt, k)), rtol=1e-4,
                                   err_msg=k)
    pt6, jt6 = pt.press_tensor.numpy(), np.asarray(jt.press_tensor)
    np.testing.assert_allclose(pt6, jt6, rtol=0,
                               atol=1e-4 * np.abs(jt6).max())
    assert int(pt.natoms) == int(jt.natoms) and pt.step == int(jt.step)
    for k in ("ebond", "eangle", "edihed", "eimp"):
        assert float(getattr(pt, k)) == 0.0


def _profiles_close(pp, jp):
    for k in pp._fields:
        want = np.asarray(getattr(jp, k))
        got = getattr(pp, k).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-6),
                                   err_msg=k)


def test_thermo_and_profiles_lj_match_jax():
    """Jittered nx = 11 LJ lattice after setup (f from the kernels)."""
    jcfg, jst, pcfg, _ = lj_states(11)
    jst = jsetup(jcfg, jst)
    pst = convert.from_arrays(jax_arrays(jst), device=CPU)
    _thermo_close(pobserve.make_thermo_fn(pcfg)(pst),
                  jobserve.make_thermo_fn(jcfg)(jst))
    _profiles_close(pobserve.make_profile_fn(pcfg, nbins=16)(pst),
                    jobserve.make_profile_fn(jcfg, nbins=16)(jst))


def test_thermo_and_profiles_dpd_match_jax():
    """The OBMD_DPD scene at scale 0.25 after setup (one OBMD stage)."""
    js = jscenes.obmd_dpd_scene(scale=0.25, seed=3)
    jst = jsetup(js.cfg, js.state)
    pcfg = pscenes.obmd_dpd_config(scale=0.25)
    pst = convert.from_arrays(jax_arrays(jst), device=CPU)
    _thermo_close(pobserve.make_thermo_fn(pcfg)(pst),
                  jobserve.make_thermo_fn(js.cfg)(jst))
    _profiles_close(pobserve.make_profile_fn(pcfg)(pst),
                    jobserve.make_profile_fn(js.cfg)(jst))


def test_perfect_lattice_pair_energy():
    """E_pair/N of the perfect nx = 6 fcc lattice at rho* = 0.8442, rc 2.5
    (both packages), and compute_forces' sweep forces vanish there."""
    _, _, pcfg, pst = lj_states(6, cap=48, jitter=False)
    t = pobserve.make_thermo_fn(pcfg)(pst)
    assert abs(float(t.epair) / int(t.natoms) - (-6.77337)) < 1e-5
    pf, ctab = compute_forces(pcfg, make_grid_spec(pcfg), pst)
    assert int(ctab.overflow) == 0 and float(pf.f.abs().max()) < 1e-3


def test_lj_config_and_state_agree():
    """lj_melt_scene builds the same config (field by field) and the same
    initial state in both packages; the converter carries the set-up LJ
    state over bit for bit."""
    for kw in (dict(nx=20), dict(nx=6, cell_capacity=48, skin=0.3)):
        js = jscenes.lj_melt_scene(**kw)
        ps = pscenes.lj_melt_scene(device=CPU, **kw)
        _mirror(ps.cfg, js.cfg)
        jd, pd = jax_arrays(js.state), convert.to_arrays(ps.state)
        for k in convert.STATE_FIELDS + convert.OBMD_FIELDS:
            assert np.array_equal(np.asarray(pd[k]), jd[k]), k
    jst = jsetup(js.cfg, js.state)
    d = jax_arrays(jst)
    back = convert.to_arrays(convert.from_arrays(d, device=CPU))
    for k in d:
        assert np.array_equal(np.asarray(back[k]), d[k]), k
