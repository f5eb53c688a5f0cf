"""The DPD variants against the JAX package: gaussian pair noise and the
dpd/tstat law with its temperature ramp, in the configuration, the noise
scale sig_scale_of, the sweep's pair laws and pair_sweep, and the pair
kernel's plain version against JAX's make_pair_kernel (interpret mode).

Two Box-Muller streams: the TPU kernel takes its second draw from
fmix32(h ^ 0x7F4A7C15) with u1 clamped at 1e-12, rng.pair_noise from
0x6C62272E with 1e-7 (ROADMAP Queue 3).  So the port's kernel is held to
JAX's kernel and the port's sweep to JAX's sweep, never one to the other.

Tolerances are those of tests/test_torch_sweep.py (laws within 1e-5
relative, sweeps within 1e-5 * max|f|) and tests/test_bigtile.py (kernels
within 2e-4 * max|f| over alive slots, |sum f| <= 1e-3 * max|f|).  The
kernel boxes have 8 cells per periodic axis (JAX's make_pair_kernel is
wrong on 3-cell axes, ROADMAP Queue 3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import config as jconfig
from obmd_tpu.engine_cellpad import make_geometry as j_make_geometry
from obmd_tpu.forces import pairs as jpairs
from obmd_tpu.forces.pallas_dpd import make_pair_kernel as j_make_pair_kernel
from obmd_tpu_torch import cellpad as pcp
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.engine_cellpad import (auto_rebuild_every,
                                           make_geometry, pack_fields,
                                           supports)
from obmd_tpu_torch.forces import pairs as ppairs
from obmd_tpu_torch.forces.pair_kernel import (PairCoef, launch_key,
                                               make_pair_kernel)
from obmd_tpu_torch.state import init_state as pinit_state

from test_torch_lj import assert_close
from test_torch_obmd_lj import to_jax
from test_torch_support import CPU, _mirror, lattice_states
from test_torch_sweep import ALL, _check_sweep, sweeps

SALT = 0x9E3779B1
RAMP = (0, 100)                     # the kernel and sweep cases' window
MID = 50                            # a mid-window step


def tstat(**kw):
    """dpd/tstat 1.0 -> 2.0 over RAMP, gamma 4.5, rc 1, seed 5 (a
    keyword overrides)."""
    args = dict(t_start=1.0, t_stop=2.0, cutoff=1.0, seed=5, gamma=4.5,
                ramp=RAMP)
    args.update(kw)
    return args


def test_config_mirrors_jax():
    """DPDTstatParams and the gaussian flag: the port's configuration
    equals JAX's field by field, crosses by convert.pair_params, and keeps
    JAX's refusal of a ramp from t_start = 0; the ramp scene's layout and
    relayout period."""
    for kw in (tstat(), tstat(t_stop=None, ramp=None),
               tstat(gaussian_noise=True, gamma=[[4.5, 2.0], [2.0, 3.0]],
                     cut=[[1.0, 0.9], [0.9, 1.1]], ntypes=2)):
        p = pconfig.DPDTstatParams.create(**kw)
        j = jconfig.DPDTstatParams.create(**kw)
        _mirror(p, j)
        assert (p.is_ramp, p.sigma, p.max_cut) == (j.is_ramp, j.sigma,
                                                    j.max_cut)
        assert convert.pair_params(j) == p
    g = dict(temp=1.0, cutoff=1.0, seed=3, a0=25.0, gamma=4.5,
             gaussian_noise=True)
    assert convert.pair_params(jconfig.DPDParams.create(**g)) == \
        pconfig.DPDParams.create(**g)
    for mod in (pconfig, jconfig):
        with pytest.raises(ValueError, match="t_start > 0"):
            mod.DPDTstatParams.create(**tstat(t_start=0.0))
    cfg = pscenes.dpd_tstat_config()
    _mirror(cfg, to_jax(cfg))
    assert supports(cfg) and cfg.capacity.n_max == 100488
    geom = make_geometry(cfg)
    assert (geom.dims, geom.fcap, geom.p) == ((25, 25, 25), 28, 1)
    # the ramp's hot end sets the period: 1 step here; at dt 0.005 the hot
    # end gives 2 where t_start alone would give 4
    assert auto_rebuild_every(cfg) == 1
    fine = dataclasses.replace(cfg, dt=0.005)
    cold = dataclasses.replace(fine, pair=dataclasses.replace(
        cfg.pair, t_stop=None))
    assert (auto_rebuild_every(fine), auto_rebuild_every(cold)) == (2, 4)


@pytest.mark.parametrize("t0, t1, ramp", [(0.4, 2.0, (0, 1000)),
                                          (1.0, 4.0, (0, 4)),
                                          (1.3, 0.2, (10, 777))])
def test_sig_scale_matches_jax_bitwise(t0, t1, ramp):
    """sig_scale_of equals JAX's float32 value bit for bit at steps before,
    inside and after the window; None for a constant-T or other law."""
    kw = tstat(t_start=t0, t_stop=t1, ramp=ramp)
    p = pconfig.DPDTstatParams.create(**kw)
    j = jconfig.DPDTstatParams.create(**kw)
    steps = list(range(ramp[0] - 3, ramp[0] + 8)) + list(
        range(ramp[1] - 8, ramp[1] + 4)) + [(ramp[0] + ramp[1]) // 2]
    for s in steps:
        want = np.float32(jpairs.sig_scale_of(j, jnp.int32(s), jnp.float32))
        got = np.float32(ppairs.sig_scale_of(p, s))
        assert got.view(np.int32) == want.view(np.int32), (s, got, want)
    assert ppairs.sig_scale_of(pconfig.DPDTstatParams.create(
        **tstat(t_stop=None)), 5) is None
    assert ppairs.sig_scale_of(pconfig.DPDParams.create(
        temp=1.0, cutoff=1.0, seed=1, a0=25.0, gamma=4.5), 5) is None


@pytest.mark.parametrize("law", ["dpd-gauss", "tstat", "tstat-gauss-ramp"])
def test_pair_law_matches_jax(law):
    """The sweep's pair laws against JAX's, elementwise within 1e-5
    relative (rng.pair_noise's gaussian stream in both); the ramp law at a
    mid-window sig_scale."""
    gauss = "gauss" in law
    if law == "dpd-gauss":
        kw = dict(temp=1.0, cutoff=1.0, seed=3, a0=25.0, gamma=4.5,
                  gaussian_noise=True)
        jp, pp = jconfig.DPDParams.create(**kw), pconfig.DPDParams.create(**kw)
    else:
        kw = tstat(gaussian_noise=gauss)
        if "ramp" not in law:
            kw.update(t_stop=None, ramp=None)
        jp = jconfig.DPDTstatParams.create(**kw)
        pp = pconfig.DPDTstatParams.create(**kw)
    ss = ppairs.sig_scale_of(pp, MID)
    r = np.random.default_rng(7)
    n = 4096
    d = r.normal(size=(n, 3)).astype(np.float32)
    d *= (r.uniform(0.05, 1.05, (n, 1))
          / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dv = r.normal(size=(n, 3)).astype(np.float32)
    tags = r.integers(1, 100000, (2, n)).astype(np.int32)
    rsq = (d * d).sum(-1)
    zero = np.zeros(n, np.int32)
    jkw = {} if ss is None else dict(sig_scale=jnp.float32(ss))
    fj, ej = jpairs.make_pair_law(jp, 0.01, jnp.float32)(
        jnp.asarray(rsq), jnp.asarray(d), jnp.asarray(dv), jnp.asarray(zero),
        jnp.asarray(zero), jnp.asarray(tags[0]), jnp.asarray(tags[1]),
        jnp.uint32(SALT), **jkw)
    t = torch.from_numpy
    pkw = {} if ss is None else dict(sig_scale=ss)
    fp, ep = ppairs.make_pair_law(pp, 0.01)(
        t(rsq), t(d), t(dv), t(zero), t(zero), t(tags[0]), t(tags[1]), SALT,
        **pkw)
    want = np.asarray(fj)
    assert np.count_nonzero(want) > n // 2
    np.testing.assert_allclose(fp.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max() * 1e-2)
    if law == "dpd-gauss":
        np.testing.assert_allclose(ep.numpy(), np.asarray(ej), rtol=1e-5)
    else:
        assert not ep.numpy().any() and not np.asarray(ej).any()


@pytest.mark.parametrize("law", ["dpd-gauss", "tstat-ramp"])
def test_pair_sweep_matches_jax(law):
    """pair_sweep with every output on, against JAX's on the jittered
    OBMD_DPD lattice (scale 0.25): gaussian DPD, and the ramp law at a
    mid-window sig_scale."""
    jcfg, jst, pcfg, pst = lattice_states(scale=0.25, cap=24, seed=21)
    if law == "dpd-gauss":
        pp = dataclasses.replace(pcfg.pair, gaussian_noise=True)
        kw = {}
    else:
        pp = pconfig.DPDTstatParams.create(**tstat())
        ss = ppairs.sig_scale_of(pp, MID)
        kw = dict(sig_scale=ss)
    pcfg = dataclasses.replace(pcfg, pair=pp)
    jcfg = dataclasses.replace(jcfg, pair=to_jax(pp))
    if law == "dpd-gauss":
        _check_sweep(*sweeps(jcfg, jst, pcfg, pst, **ALL))
        return
    jpf, ppf = _tstat_sweeps(jcfg, jst, pcfg, pst, kw["sig_scale"])
    f_j = np.asarray(jpf.f)
    scale = np.abs(f_j).max()
    assert scale > 1.0
    assert np.abs(ppf.f.numpy() - f_j).max() <= 1e-5 * scale
    w_j = np.asarray(jpf.virial)
    np.testing.assert_allclose(ppf.virial.numpy(), w_j, rtol=0,
                               atol=1e-5 * np.abs(w_j).max())
    assert float(ppf.pe.abs().max()) == 0.0


def _tstat_sweeps(jcfg, jst, pcfg, pst, ss):
    """Both sweeps of one state with the sig_scale ss."""
    from obmd_tpu.cells import build_cells as jbuild_cells
    from obmd_tpu.integrate import _salt as j_salt
    from obmd_tpu.integrate import make_grid_spec as j_make_grid_spec
    from obmd_tpu_torch.cells import build_cells
    from obmd_tpu_torch.integrate import _salt, make_grid_spec
    spec = j_make_grid_spec(jcfg)
    tab = jbuild_cells(spec, jst.x, jst.alive)
    jpf = jpairs.pair_sweep(jcfg.pair, jcfg.box, spec, tab, jst.x, jst.v,
                            jst.type, jst.tag, jst.q, j_salt(jcfg, jst.step),
                            dt=jcfg.dt, sig_scale=jnp.float32(ss),
                            compute_energy=True, compute_virial=True)
    pspec = make_grid_spec(pcfg)
    ptab = build_cells(pspec, pst.x, pst.alive)
    ppf = ppairs.pair_sweep(pcfg.pair, pcfg.box, pspec, ptab, pst.x, pst.v,
                            pst.type, pst.tag, _salt(pcfg, pst.step),
                            dt=pcfg.dt, sig_scale=ss, compute_energy=True,
                            compute_virial=True)
    return jpf, ppf


def _laid_out(pcfg, pst, types=None):
    """The port's layout of a lattice state and the kernel's inputs."""
    n = int(pst.natoms)
    x, v = pst.x[:n].numpy(), pst.v[:n].numpy()
    geom = make_geometry(pcfg)
    st = pcp.layout_build(geom, pcfg.box, pinit_state(pcfg, x, v=v,
                                                      types=types,
                                                      device=CPU))
    assert int(st.cell_overflow) == 0
    fld, tag3d, _, occ, _ = pack_fields(pcfg, geom, st)
    return geom, st, fld, tag3d, occ


def _two_types(pcfg, n):
    """The two-type gaussian DPD law of tests/test_torch_ljrf.py's two-type
    case (a0, gamma and masses per type pair) and numpy-drawn types."""
    pair = pconfig.DPDParams.create(
        temp=1.0, cutoff=1.0, seed=5, ntypes=2, gaussian_noise=True,
        a0=[[209.6, 150.0], [150.0, 180.0]], gamma=[[4.5, 2.0], [2.0, 6.0]])
    return (dataclasses.replace(pcfg, pair=pair, masses=(1.0, 2.0)),
            np.random.default_rng(6).integers(0, 2, n))


@pytest.mark.parametrize("case", ["gauss-t1-cap15", "gauss-t2-cap24"])
def test_gaussian_plain_matches_tpu_kernel(case):
    """Gaussian DPD: the plain version against JAX's make_pair_kernel, one
    type in its big-tile body (fill cap 15) and two types in its
    rank-looped body (cap 24); the draws differ from the uniform law's."""
    cap = int(case.split("cap")[1])
    _, _, pcfg, pst = lattice_states(scale=0.25, cap=cap)
    types = None
    if "-t2-" in case:
        pcfg, types = _two_types(pcfg, int(pst.natoms))
    else:
        pcfg = dataclasses.replace(pcfg, pair=dataclasses.replace(
            pcfg.pair, gaussian_noise=True))
    geom, st, fld, tag3d, occ = _laid_out(pcfg, pst, types)
    coef = PairCoef.of(geom, pcfg.pair, pcfg.dt)
    assert coef.gaussian and not coef.ramp
    assert launch_key(geom, coef, 0).startswith(
        "dpd-t2-gauss" if types is not None else "dpd-gauss")
    f_port = make_pair_kernel(geom, pcfg.pair, pcfg.dt)(fld, tag3d, SALT,
                                                        occ).numpy()
    jcfg = to_jax(pcfg)
    jg = j_make_geometry(jcfg)
    assert tuple(jg) == tuple(geom) and min(geom.dims[1:]) >= 5
    f_tpu = np.asarray(j_make_pair_kernel(jg, params=jcfg.pair, dt=jcfg.dt)(
        jnp.asarray(fld.numpy()), jnp.asarray(tag3d.numpy()),
        jnp.uint32(SALT), jnp.asarray(occ.numpy()), None))
    d = convert.to_arrays(st)
    assert_close(f_port, f_tpu, d, case)
    uniform = dataclasses.replace(pcfg.pair, gaussian_noise=False)
    f_uni = make_pair_kernel(geom, uniform, pcfg.dt)(fld, tag3d, SALT,
                                                     occ).numpy()
    assert np.abs(f_uni - f_port).max() > 2e-4 * np.abs(f_tpu).max()


def test_tstat_plain_matches_tpu_kernel():
    """dpd/tstat with a ramp at cap 24 (JAX's rank-looped body, the ramp
    path's): the plain version against JAX's make_pair_kernel called with
    sig_scale directly, at sig_scale 1 and at the mid-window value; the
    scale changes the forces, and a constant-T law ignores it."""
    cap = 24
    _, _, pcfg, pst = lattice_states(scale=0.25, cap=cap)
    pcfg = dataclasses.replace(pcfg, obmd=None, pair=(
        pconfig.DPDTstatParams.create(**tstat())))
    geom, st, fld, tag3d, occ = _laid_out(pcfg, pst)
    coef = PairCoef.of(geom, pcfg.pair, pcfg.dt)
    assert coef.ramp and coef.a0 == 0.0
    assert launch_key(geom, coef, 0) == f"dpd-ramp-cap{cap}"
    kern = make_pair_kernel(geom, pcfg.pair, pcfg.dt)
    jcfg = to_jax(pcfg)
    jg = j_make_geometry(jcfg)
    assert tuple(jg) == tuple(geom)
    jkern = jax.jit(j_make_pair_kernel(jg, params=jcfg.pair, dt=jcfg.dt))
    d = convert.to_arrays(st)
    mid = ppairs.sig_scale_of(pcfg.pair, MID)
    assert 1.0 < mid < 1.3
    out = {}
    for ss in (1.0, mid):
        out[ss] = kern(fld, tag3d, SALT, occ, sig_scale=ss).numpy()
        f_tpu = np.asarray(jkern(
            jnp.asarray(fld.numpy()), jnp.asarray(tag3d.numpy()),
            jnp.uint32(SALT), jnp.asarray(occ.numpy()), None,
            jnp.float32(ss)))
        assert_close(out[ss], f_tpu, d, f"tstat cap {cap}, sig_scale {ss}")
    assert np.array_equal(kern(fld, tag3d, SALT, occ).numpy(), out[1.0])
    assert np.abs(out[mid] - out[1.0]).max() > 1e-2 * np.abs(out[1.0]).max()
    const = make_pair_kernel(geom, dataclasses.replace(
        pcfg.pair, t_stop=None, ramp=None), pcfg.dt)
    assert np.array_equal(const(fld, tag3d, SALT, occ, sig_scale=mid)
                          .numpy(), out[1.0])
