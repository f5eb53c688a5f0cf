"""The dpd/ext law against the JAX package and the reference binary: the
configuration, the three transverse noise streams, make_pair_law and
pair_sweep on a 300-atom box with one and two types, the nlist engine's
forces on the reference binary's golden, and the law's special cases.

Tolerances: the law elementwise and the sweeps within 2e-4 * max|f| (the
float32 pow of a non-integer ws may differ by an ulp between the two
packages), energies within 1e-4 relative; the noise bit for bit; the
reference binary's forces (validation/dpdext_golden, T = 0, so the noise
vanishes) within 5e-5 * max|f| (validation/run_dpdext_golden.py's bar)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import config as jconfig
from obmd_tpu import rng as jrng
from obmd_tpu.forces import pairs as jpairs
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch import convert, rng
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.cells import build_cells
from obmd_tpu_torch.forces import pairs as ppairs
from obmd_tpu_torch.geometry import Box
from obmd_tpu_torch.integrate import compute_forces, make_grid_spec, setup

from test_torch_obmd_lj import to_jax
from test_torch_support import CPU, _mirror, jax_arrays
from test_torch_sweep import ALL, sweeps

SALT = 0x9E3779B1
DT = 0.001464
L = 9.0
N_ATOMS = 300


def ext_kw(ntypes=1, **kw):
    """dpd/ext keyword arguments: path G's law with one type; with two,
    per-pair tables (the cross terms between the two)."""
    if ntypes == 1:
        args = dict(temp=1.0, cutoff=1.0, seed=2349852, a0=209.6, gamma=4.5,
                    gammaT=2.5, ws=0.8, wsT=1.3)
    else:
        args = dict(temp=1.0, cutoff=1.2, seed=77, ntypes=2,
                    a0=((25.0, 40.0), (40.0, 30.0)),
                    gamma=((4.5, 3.0), (3.0, 6.0)),
                    gammaT=((2.5, 1.0), (1.0, 3.5)),
                    ws=((0.8, 1.0), (1.0, 0.6)),
                    wsT=((1.3, 0.5), (0.5, 2.0)),
                    cut=((1.0, 1.1), (1.1, 1.2)))
    args.update(kw)
    return args


def box_config(ntypes, **kw):
    """The port's configuration of N_ATOMS atoms in a periodic L^3 box
    under dpd/ext on the nlist engine."""
    return pconfig.SceneConfig(
        box=Box((0.0,) * 3, (L,) * 3, (True,) * 3), masses=(1.0,) * ntypes,
        pair=pconfig.DPDExtParams.create(**ext_kw(ntypes, **kw)), dt=DT,
        capacity=pconfig.Capacity(n_max=N_ATOMS, cell_capacity=16),
        skin=0.3, force_path="nlist").finalize()


def box_states(ntypes, seed=13, **kw):
    """(jax cfg, jax state, port cfg, port state) of N_ATOMS uniform atoms
    with normal velocities and random types in the box of box_config."""
    pcfg = box_config(ntypes, **kw)
    jcfg = to_jax(pcfg)
    r = np.random.default_rng(seed)
    x = r.uniform(0.0, L, (N_ATOMS, 3)).astype(np.float32)
    v = r.normal(0.0, 1.0, (N_ATOMS, 3)).astype(np.float32)
    types = r.integers(0, ntypes, N_ATOMS).astype(np.int32)
    jst = jinit_state(jcfg, x, v=v, types=types)
    return jcfg, jst, pcfg, convert.from_arrays(jax_arrays(jst), device=CPU)


def test_config_mirrors_jax():
    """DPDExtParams (sigma and sigmaT included), the nlist capacities and
    path G's configuration field by field; the converter carries the law
    across."""
    for kw in (ext_kw(1), ext_kw(2), ext_kw(1, tstat_only=True,
                                            gaussian_noise=True)):
        p, j = pconfig.DPDExtParams.create(**kw), \
            jconfig.DPDExtParams.create(**kw)
        _mirror(p, j)
        assert p.sigma == j.sigma and p.sigmaT == j.sigmaT
        assert convert.pair_params(j) == p
    _mirror(pconfig.Capacity(n_max=10), jconfig.Capacity(n_max=10))
    cfg = pscenes.obmd_dpdext_config()
    assert cfg.force_path == "nlist" and cfg.capacity.max_neighbors == 72
    assert cfg.pair == pconfig.DPDExtParams.create(**ext_kw(1))
    base = pscenes.obmd_dpd_config(scale=9.0, force_path="nlist")
    assert dataclasses.replace(cfg, pair=base.pair) == base
    assert int(3.0 * cfg.box.volume) == 113738     # obmd_dpd_scene's gas
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, force_path="slab").finalize()


@pytest.mark.parametrize("gaussian", [False, True])
def test_transverse_noise_bit_for_bit(gaussian):
    """The three transverse streams (salt ^ 0x9E3779B9, 0x85EBCA6B,
    0xC2B2AE35) equal the JAX package's draws bit for bit (uniform), or
    within float32 rounding of its log/cos (gaussian)."""
    r = np.random.default_rng(5)
    ti = r.integers(1, 2 ** 31 - 1, 4096).astype(np.int32)
    tj = r.integers(1, 2 ** 31 - 1, 4096).astype(np.int32)
    salt32 = jnp.uint32(SALT)
    want = np.stack([np.asarray(jrng.pair_noise(
        salt32 ^ jnp.uint32(c), jnp.asarray(ti), jnp.asarray(tj),
        gaussian=gaussian)) for c in rng.TRANSVERSE_STREAMS], -1)
    got = rng.transverse_noise(SALT, torch.from_numpy(ti),
                               torch.from_numpy(tj), gaussian=gaussian)
    if gaussian:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        assert np.array_equal(got.numpy(), want)
    # symmetric under i <-> j
    assert torch.equal(got, rng.transverse_noise(
        SALT, torch.from_numpy(tj), torch.from_numpy(ti), gaussian=gaussian))


@pytest.mark.parametrize("ntypes", [1, 2])
@pytest.mark.parametrize("tstat_only", [False, True])
def test_pair_law_matches_jax(ntypes, tstat_only):
    """make_pair_law's dpd/ext vector force and energy on random pairs
    within and beyond the cut."""
    kw = ext_kw(ntypes, tstat_only=tstat_only)
    jp = jconfig.DPDExtParams.create(**kw)
    pp = pconfig.DPDExtParams.create(**kw)
    r = np.random.default_rng(11)
    n = 4096
    d = r.normal(size=(n, 3)).astype(np.float32)
    d *= (r.uniform(0.05, 1.3, (n, 1))
          / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dv = r.normal(size=(n, 3)).astype(np.float32)
    rsq = (d * d).sum(-1)
    ti = r.integers(0, ntypes, n).astype(np.int32)
    tj = r.integers(0, ntypes, n).astype(np.int32)
    gi = r.integers(1, 100000, n).astype(np.int32)
    gj = r.integers(1, 100000, n).astype(np.int32)
    fj, ej = jpairs.make_pair_law(jp, DT, jnp.float32)(
        *(jnp.asarray(a) for a in (rsq, d, dv, ti, tj, gi, gj)),
        jnp.uint32(SALT))
    t = torch.from_numpy
    assert ppairs.is_vector_law(pp)
    fp, ep = ppairs.make_pair_law(pp, DT)(t(rsq), t(d), t(dv), t(ti), t(tj),
                                          t(gi), t(gj), SALT)
    fj, ej = np.asarray(fj), np.asarray(ej)
    assert fp.shape == (n, 3) and np.count_nonzero(fj[:, 0]) > n // 3
    assert np.abs(fp.numpy() - fj).max() <= 2e-4 * np.abs(fj).max()
    if tstat_only:
        assert not ep.numpy().any() and not ej.any()
    else:
        np.testing.assert_allclose(ep.numpy(), ej, rtol=1e-4,
                                   atol=1e-4 * np.abs(ej).max())


@pytest.mark.parametrize("ntypes", [1, 2])
def test_pair_sweep_matches_jax(ntypes):
    """pair_sweep's vector branch (forces, per-atom energies, the global
    and per-atom virials) on the 300-atom box, one or two types."""
    jpf, ppf = sweeps(*box_states(ntypes), **ALL)
    f_j = np.asarray(jpf.f)
    scale = np.abs(f_j).max()
    assert np.abs(ppf.f.numpy() - f_j).max() <= 2e-4 * scale
    np.testing.assert_allclose(float(ppf.pe.sum()), float(jnp.sum(jpf.pe)),
                               rtol=1e-4)
    w_j = np.asarray(jpf.virial)
    np.testing.assert_allclose(ppf.virial.numpy(), w_j, rtol=0,
                               atol=2e-4 * np.abs(w_j).max())
    wa_j = np.asarray(jpf.virial_atom)
    assert np.abs(ppf.virial_atom.numpy() - wa_j).max() \
        <= 2e-4 * np.abs(wa_j).max()
    # Newton's third law through the antisymmetrized transverse noise
    assert np.abs(ppf.f.numpy().sum(0)).max() <= 1e-3 * scale


def _golden_gap(f, tags, alive, ref):
    got = {int(t): f[i] for i, t in enumerate(tags.tolist()) if alive[i]}
    assert set(got) == set(ref)
    scale = max(float(np.linalg.norm(v)) for v in ref.values())
    return max(float(np.abs(got[t] - ref[t]).max()) for t in ref), scale


def test_golden_matches_reference_binary():
    """validation/dpdext_golden (300 atoms, dpd/ext at T = 0) through the
    nlist engine's setup and through the pair sweep: every force within
    5e-5 * max|f| of the reference binary's dump.ref."""
    sc = pscenes.dpdext_golden_scene(device=CPU)
    ref = pscenes.golden_forces("dpdext_golden")
    st = setup(sc.cfg, sc.state)
    assert int(st.nbrs.overflow) == 0 and int(st.nbrs.rebuilds) == 1
    err, scale = _golden_gap(st.f.numpy(), st.tag, st.alive.numpy(), ref)
    assert scale > 10.0 and err <= 5e-5 * scale, (err, scale)
    pf, _ = compute_forces(sc.cfg, make_grid_spec(sc.cfg), sc.state)
    err, _ = _golden_gap(pf.f.numpy(), sc.state.tag, sc.state.alive.numpy(),
                         ref)
    assert err <= 5e-5 * scale


def port_sweep(law, st):
    """The port's pair_sweep (forces and energies) under `law` on the
    300-atom box's state st at salt SALT."""
    cfg = dataclasses.replace(box_config(1), pair=law, masses=(1.0,))
    spec = make_grid_spec(cfg)
    return ppairs.pair_sweep(law, cfg.box, spec,
                             build_cells(spec, st.x, st.alive), st.x, st.v,
                             st.type, st.tag, SALT, dt=DT,
                             compute_energy=True)


def test_reduces_to_dpd():
    """gammaT = 0 and ws = wsT = 1: dpd/ext is the port's DPD law (force
    and energy) on the same pairs and salt."""
    _, _, _, st = box_states(1)
    fe = port_sweep(pconfig.DPDExtParams.create(
        **ext_kw(1, gammaT=0.0, ws=1.0, wsT=1.0)), st)
    fd = port_sweep(pconfig.DPDParams.create(
        temp=1.0, cutoff=1.0, seed=2349852, a0=209.6, gamma=4.5), st)
    scale = float(fd.f.abs().max())
    assert scale > 10.0
    assert float((fe.f - fd.f).abs().max()) <= 1e-5 * scale
    torch.testing.assert_close(fe.pe, fd.pe, rtol=1e-5, atol=1e-5)


def test_tstat_only_drops_conservative_term():
    """dpd/ext/tstat: the force is dpd/ext's less the conservative a0 wd
    rhat (DPD with gamma 0 at T 0), and the energy is zero."""
    _, _, _, st = box_states(1)
    full = port_sweep(pconfig.DPDExtParams.create(**ext_kw(1)), st)
    tstat = port_sweep(pconfig.DPDExtParams.create(
        **ext_kw(1, tstat_only=True)), st)
    cons = port_sweep(pconfig.DPDParams.create(
        temp=0.0, cutoff=1.0, seed=1, a0=209.6, gamma=0.0), st)
    scale = float(full.f.abs().max())
    assert float((full.f - cons.f - tstat.f).abs().max()) <= 1e-4 * scale
    assert not tstat.pe.any() and float(full.pe.sum()) > 0.0
