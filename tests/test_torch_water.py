"""Path I's water (obmd_tpu_torch/scenes.py, BASELINE config 5) on the CPU:

- the SPC/E molecule file round trip: write_water_molecule read back by
  the port's and the JAX package's readers into equal templates (every
  array exactly, displacements to the last bit), O-H 0.1 nm and H-H
  0.163299 nm (H-O-H 109.47 degrees) within 1e-12, charges summing to 0;
- finalize's SHAKE table: the open box's (from the template, the
  scene's sweeps) and the one JAX's finalize derives from the same fix
  keyword, entry for entry;
- bond exclusion with K = 0: the JAX engine takes a harmonic bond of K =
  0, and its forces on a dilute water box equal (within 2e-4 of the
  largest) a float64 brute-force sum over the intermolecular pairs alone,
  as do the port's (the cellpad kernel's plain version), and differ from
  the forces without the bond style (the intramolecular pairs in);
- the molecular P_xx of observe.molecular_pxx against a float64 numpy
  transcription of its formula (the intermolecular pair virial, the
  molecules' centre-of-mass kinetic term and the intramolecular
  correction from each atom's pair force), within 1e-4 of the largest
  term, and thermo's atomic P_xx with the same exclusion.
"""
import dataclasses
import os

import numpy as np
import pytest

from obmd_tpu import config as jconfig
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.io.molecule import read_molecule as j_read
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.config import MolTemplate
from obmd_tpu_torch.engine_cellpad import make_geometry
from obmd_tpu_torch.integrate import setup
from obmd_tpu_torch.io.molecule import read_molecule
from obmd_tpu_torch.observe import molecular_pxx
from obmd_tpu_torch.state import init_state, per_atom_mass

from test_torch_obmd_lj import to_jax
from test_torch_shake import L, _cfg, _waters
from test_torch_support import CPU


def test_molecule_file_round_trip(tmp_path):
    path = os.path.join(tmp_path, "water.mol")
    pscenes.write_water_molecule(path)
    mine, theirs = read_molecule(path), j_read(path)
    for k in ("x", "types", "q", "bonds"):
        assert np.array_equal(getattr(mine, k), getattr(theirs, k)), k
    assert np.array_equal(mine.dx, theirs.dx)
    tpl = MolTemplate.from_file(path)
    assert tpl == pscenes.water_template()
    assert tpl.types == (0, 1, 1) and tpl.bonds == ((0, 1), (0, 2), (1, 2))
    dx = np.asarray(tpl.dx)
    for (a, b), want in (((0, 1), 0.1), ((0, 2), 0.1), ((1, 2), 0.163299)):
        assert abs(np.linalg.norm(dx[a] - dx[b]) - want) < 1e-6
    assert abs(np.linalg.norm(dx[0] - dx[1]) - 0.1) < 1e-12
    cos = np.dot(dx[1] - dx[0], dx[2] - dx[0]) / 0.01
    assert abs(np.degrees(np.arccos(cos)) - 109.47) < 1e-9
    assert abs(sum(tpl.q)) < 1e-12


def test_finalize_derives_the_table_as_jax():
    """The open box's table is the template's; JAX's finalize derives the
    same from the fix's `shake` keyword (the scene then sets its sweeps)."""
    cfg = pscenes.open_water_config(planes=33, n_max=1200)
    assert cfg.shake.iters == pscenes.WATER_SHAKE_ITERS
    bare = to_jax(dataclasses.replace(cfg, shake=None)).finalize()
    assert bare.shake.d0 == cfg.shake.d0
    d0 = np.asarray(cfg.shake.d0)
    assert d0[0, 0] == 0.0 and abs(d0[0, 1] - 0.1) < 1e-12
    assert abs(d0[1, 1] - 0.163299) < 1e-6
    with pytest.raises(ValueError, match="mutually exclusive"):
        dataclasses.replace(cfg, rigid=True).finalize()
    with pytest.raises(ValueError, match="3 types"):
        dataclasses.replace(cfg, shake=jconfig.shake_table_from_templates(
            [to_jax(pscenes.water_template())], 3)).finalize()


def _inter_forces(x, q, mol, types, box_len, periodic, pair):
    """float64 brute force: each atom's lj/cut/rf force from the atoms of
    other molecules, the pair virial W_xx over those pairs, and the forces
    with every pair in."""
    eps = np.asarray(pair.epsilon)
    sig = np.asarray(pair.sigma)
    rc2 = pair.cut_coul ** 2
    erf = np.asarray(pair.eps_rf)[0, 0]
    c_rf = 2.0 * (erf - 1.0) / (2.0 * erf + 1.0)
    d = x[:, None, :] - x[None, :, :]
    for a in range(3):
        if periodic[a]:
            d[..., a] -= box_len[a] * np.round(d[..., a] / box_len[a])
    rsq = (d * d).sum(-1)
    np.fill_diagonal(rsq, np.inf)
    e = eps[types[:, None], types[None, :]]
    s6 = sig[types[:, None], types[None, :]] ** 6
    r2i = 1.0 / rsq
    r6i = r2i ** 3
    inr = rsq < rc2
    flj = np.where(inr, r6i * (48 * e * s6 * s6 * r6i - 24 * e * s6) * r2i, 0)
    rinv = np.sqrt(r2i)
    fc = np.where(inr, pair.qqrd2e * q[:, None] * q[None, :]
                  * (r2i * rinv - c_rf / pair.cut_coul ** 3), 0.0)
    fp = flj + fc
    inter = mol[:, None] != mol[None, :]
    f_all = (fp[..., None] * d).sum(1)
    fi = np.where(inter, fp, 0.0)
    f_inter = (fi[..., None] * d).sum(1)
    w_xx = 0.5 * (fi * d[..., 0] * d[..., 0]).sum()
    return f_inter, w_xx, f_all


def _box(n_w=150, seed=4):
    cfg = _cfg("cellpad")
    x, types, q, mol, bonds = _waters(n_w, seed)
    v = np.random.default_rng(5).normal(0.0, 0.6, x.shape)
    return cfg, x, v, types, q, mol, bonds


def test_k_zero_bond_excludes_the_molecule():
    cfg, x, v, types, q, mol, bonds = _box()
    n = len(x)
    kw = dict(v=v, types=types, q=q, mol=mol, bonds=bonds)
    f_inter, _, f_all = _inter_forces(
        x.astype(np.float64), q.astype(np.float64), mol, types,
        np.asarray(cfg.box.lengths), cfg.box.periodic, cfg.pair)
    scale = np.abs(f_inter).max()
    jcfg = to_jax(dataclasses.replace(cfg, force_path="nlist"))
    assert jcfg.bond.k == 0.0
    jf = np.asarray(jsetup(jcfg, jinit_state(jcfg, x, **kw)).f)[:n]
    np.testing.assert_allclose(jf, f_inter, rtol=0, atol=2e-4 * scale)
    pf = setup(cfg, init_state(cfg, x, device=CPU, **kw))
    order = np.argsort(np.where(pf.alive.numpy(), pf.tag.numpy(), 1 << 30))
    np.testing.assert_allclose(pf.f.numpy()[order[:n]], f_inter, rtol=0,
                               atol=2e-4 * scale)
    free = to_jax(dataclasses.replace(cfg, force_path="nlist", bond=None))
    jf0 = np.asarray(jsetup(free, jinit_state(free, x, **kw)).f)[:n]
    np.testing.assert_allclose(jf0, f_all, rtol=0,
                               atol=2e-4 * np.abs(f_all).max())
    assert np.abs(jf0 - jf).max() > 10.0 * scale


def test_molecular_pressure_formula():
    cfg, x, v, types, q, mol, bonds = _box()
    st = init_state(cfg, x, v=v, types=types, q=q, mol=mol, bonds=bonds,
                    device=CPU)
    got_mol, got_atom = molecular_pxx(cfg, st, k_max=96, cell_capacity=16)
    x64 = x.astype(np.float64)
    v64 = st.v.numpy()[:len(x)].astype(np.float64)
    f, w_xx, _ = _inter_forces(x64, q.astype(np.float64), mol, types,
                               np.asarray(cfg.box.lengths),
                               cfg.box.periodic, cfg.pair)
    m = per_atom_mass(cfg, st).numpy()[:len(x)].astype(np.float64)
    lyz = np.asarray(cfg.box.lengths)
    kin_mol = inner = 0.0
    for k in np.unique(mol):
        a = np.flatnonzero(mol == k)
        d = x64[a] - x64[a[0]]
        d[:, 1:] -= lyz[1:] * np.round(d[:, 1:] / lyz[1:])
        com = (m[a, None] * d).sum(0) / m[a].sum()
        vcom = (m[a, None] * v64[a]).sum(0) / m[a].sum()
        kin_mol += m[a].sum() * vcom[0] ** 2
        inner += ((d[:, 0] - com[0]) * f[a, 0]).sum()
    vol = float(np.prod(cfg.box.lengths))
    want_mol = (kin_mol + w_xx - inner) / vol
    want_atom = ((m * v64[:, 0] ** 2).sum() + w_xx) / vol
    big = max(abs(w_xx), kin_mol, abs(inner)) / vol
    assert abs(got_mol - want_mol) <= 1e-4 * big, (got_mol, want_mol)
    assert abs(got_atom - want_atom) <= 1e-4 * big, (got_atom, want_atom)
    assert abs(want_mol - want_atom) > 1e-2 * big
    assert make_geometry(cfg).dims == (6, 6, 6) and L == 6.5
