"""The molecule terms against the JAX package: harmonic bonds, angles on two
and four partner columns, dihedrals and impropers (obmd_tpu/forces/
bonded.py), the center-atom table builders, init_state's four partner
columns and improper triplets, the `atom_style molecular` data file, and
the two LAMMPS goldens (validation/bonded_golden, validation/
improper_golden) through the port's reader and setup.

Tolerances: forces and energies of a bonded function within 1e-5 of their
largest value (the same float32 operations, some in another order); the
goldens as validation/run_bonded_golden.py and run_improper_golden.py gate
them against dump.ref: every force within 5e-5 * max|f| (bonded, float32),
1e-6 * max|f| in float64 and 2e-4 * max|f| in float32 (improper: random
near-degenerate stars amplify float32 rounding through the acos
derivative).  Integer columns exact."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import config as jconfig
from obmd_tpu.forces import bonded as jb
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.io import lammps_data as jio
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.forces import bonded as pb
from obmd_tpu_torch.geometry import Box
from obmd_tpu_torch.integrate import setup as psetup
from obmd_tpu_torch.io import lammps_data as pio
from obmd_tpu_torch.state import init_state as pinit_state

from test_torch_support import CPU, _mirror

L = 7.0
STAR_DX = np.asarray([(0.0, 0.0, 0.0), (0.55, 0.0, 0.0), (-0.55, 0.05, 0.0),
                      (0.0, 0.55, 0.05), (0.0, -0.05, 0.55)])


def _chains_and_stars(seed=5, nchain=6, chain_len=6, nstar=5):
    """Chains of `chain_len` beads (bonds 0.7-1.2, random bends) and 4-arm
    stars (arms 0.45-0.7, one improper over arms 1-3) in a periodic L-box,
    wrapped, so that some bonds cross a face; the last atom of the first
    chain is dead.  Returns (x f32[n, 3], types, alive, partner columns
    [4][n] (slots, -1 none), impr [n, 3])."""
    r = np.random.default_rng(seed)
    xs, types, bonds, imps = [], [], [], []
    for c in range(nchain):
        p = [r.uniform(0.0, L, 3)]
        d = r.normal(size=3)
        for _ in range(chain_len - 1):
            d = d / np.linalg.norm(d)
            p.append(p[-1] + r.uniform(0.7, 1.2) * d)
            d = d + 0.8 * r.normal(size=3)
        b = len(xs)
        xs.extend(p)
        types.extend([0] * chain_len)
        bonds += [(b + k, b + k + 1) for k in range(chain_len - 1)]
    for s in range(nstar):
        b = len(xs)
        center = r.uniform(0.0, L, 3)
        xs.append(center)
        types.append(1)
        for k in range(4):
            u = r.normal(size=3)
            xs.append(center + r.uniform(0.45, 0.7) * u / np.linalg.norm(u))
            types.append(0)
            bonds.append((b, b + 1 + k))
        imps.append((b + 1, b, b + 2, b + 3))
    n = len(xs)
    x = np.mod(np.asarray(xs), L).astype(np.float32)
    cols = np.full((4, n), -1, np.int32)
    for a, b in bonds:
        for me, other in ((a, b), (b, a)):
            cols[int(np.argmax(cols[:, me] < 0)), me] = other
    impr = np.full((n, 3), -1, np.int32)
    for i1, i2, i3, i4 in imps:
        impr[i2] = (i1, i3, i4)
    alive = np.ones(n, bool)
    alive[chain_len - 1] = False
    return x, np.asarray(types, np.int32), alive, cols, impr


def _both(x, *arrays):
    return ([jnp.asarray(a) for a in (x,) + arrays],
            [torch.from_numpy(np.asarray(a)) for a in (x,) + arrays])


def _close(got, want, label):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0.1, label
    assert np.abs(got - want).max() <= 1e-5 * scale, (
        label, np.abs(got - want).max(), scale)


JBOX = JBox((0.0,) * 3, (L,) * 3, (True,) * 3)
PBOX = Box((0.0,) * 3, (L,) * 3, (True,) * 3)


@pytest.mark.parametrize("ncols", [2, 4])
def test_harmonic_bonds_and_angles_match_jax(ncols):
    """harmonic_bond_forces, bond_forces and angle_forces on the chains
    (ncols = 2: the chain path) and on chains and stars (ncols = 4:
    _angle_forces_general), forces
    and per-atom energies as JAX's; bond_pair_fvec as JAX's."""
    x, types, alive, cols, _ = _chains_and_stars(
        nstar=0 if ncols == 2 else 5)
    cols = cols[:ncols]
    (jx, ja, jt, *jc), (px, pa, pt, *pc) = _both(x, alive, types, *cols)
    bond = (40.0, 0.55)
    jbond = jconfig.BondHarmonicParams(k=bond[0], r0=bond[1])
    pbond = pconfig.BondHarmonicParams(k=bond[0], r0=bond[1])
    angle = dict(k=(5.0, 8.0), theta0=(109.5, 120.0))
    jang = jconfig.AngleHarmonicParams(**angle)
    pang = pconfig.AngleHarmonicParams(**angle)
    for jfn, pfn, jp, pp, extra in (
            (jb.harmonic_bond_forces, pb.harmonic_bond_forces, jbond, pbond,
             ()),
            (jb.bond_forces, pb.bond_forces, jbond, pbond, ()),
            (jb.angle_forces, pb.angle_forces, jang, pang, ("type",))):
        jargs = (jp, JBOX, jx, jc[0], jc[1]) + ((jt,) if extra else ()) \
            + (ja,)
        pargs = (pp, PBOX, px, pc[0], pc[1]) + ((pt,) if extra else ()) \
            + (pa,)
        jf, je = jfn(*jargs, compute_energy=True, more_partners=tuple(jc[2:]))
        pf, pe = pfn(*pargs, compute_energy=True, more_partners=tuple(pc[2:]))
        _close(pf, jf, f"{jfn.__name__} f")
        _close(pe, je, f"{jfn.__name__} e")
        pf2, pe2 = pfn(*pargs, more_partners=tuple(pc[2:]))
        assert torch.equal(pf2, pf) and pe2 is None
    d = np.random.default_rng(1).normal(size=(40, 3)).astype(np.float32)
    rsq = (d * d).sum(-1)
    for jp, pp in ((jbond, pbond), (jconfig.BondFENEParams(),
                                    pconfig.BondFENEParams())):
        _close(pb.bond_pair_fvec(pp, torch.from_numpy(rsq),
                                 torch.from_numpy(d)),
               jb.bond_pair_fvec(jp, jnp.asarray(rsq), jnp.asarray(d)),
               f"bond_pair_fvec {type(pp).__name__}")


def test_dihedrals_match_jax():
    """dihedral_forces (the autograd gradient of dihedral_harmonic.cpp's
    energy) on the chains: forces and per-atom energies as JAX's, for d =
    +1 and -1 and multiplicities 1-3."""
    x, types, alive, cols, _ = _chains_and_stars(nstar=0)
    (jx, ja, j1, j2), (px, pa, p1, p2) = _both(x, alive, cols[0], cols[1])
    for k, d, n in ((3.0, 1, 2), (1.5, -1, 1), (2.0, 1, 3)):
        jf, je = jb.dihedral_forces(jconfig.DihedralHarmonicParams(k, d, n),
                                    JBOX, jx, j1, j2, ja, compute_energy=True)
        pf, pe = pb.dihedral_forces(pconfig.DihedralHarmonicParams(k, d, n),
                                    PBOX, px, p1, p2, pa, compute_energy=True)
        _close(pf, jf, f"dihedral f {k, d, n}")
        _close(pe, je, f"dihedral e {k, d, n}")
        assert not pf.requires_grad


def test_impropers_match_jax():
    """improper_forces on the stars (per-center triplets, four partner
    columns), forces and per-atom energies as JAX's; the force sums to
    zero over each star."""
    x, types, alive, cols, impr = _chains_and_stars(nchain=0, nstar=9)
    imp = dict(k=(0.0, 8.0), chi0=(0.0, 30.0))
    (jx, ja, jt, ji, *jc), (px, pa, pt, pi, *pc) = _both(
        x, alive, types, impr, *cols)
    jf, je = jb.improper_forces(jconfig.ImproperHarmonicParams(**imp), JBOX,
                                jx, tuple(jc), ji, jt, ja,
                                compute_energy=True)
    pf, pe = pb.improper_forces(pconfig.ImproperHarmonicParams(**imp), PBOX,
                                px, tuple(pc), pi, pt, pa,
                                compute_energy=True)
    _close(pf, jf, "improper f")
    _close(pe, je, "improper e")
    per_star = pf.numpy().reshape(-1, 5, 3).sum(axis=1)
    assert np.abs(per_star).max() <= 1e-4 * np.abs(pf.numpy()).max()


def test_center_tables_and_init_state_match_jax():
    """derive_center_angle_table and derive_center_improper_table as JAX's
    (a partial partner-pair angle set and two coefficient sets on one
    center type refused alike); init_state's four partner columns and impr
    as JAX's on shuffled tags; more than four bonds and an improper end
    the center is not bonded to refused as tests/test_branched.py:217-229
    refuses them."""
    bonds = [(1, 2), (1, 3), (1, 4), (1, 5)]
    atom_types = {i: 1 if i == 1 else 0 for i in range(1, 6)}
    pairs = [(1, 2, 1, 3), (1, 2, 1, 4), (1, 2, 1, 5), (1, 3, 1, 4),
             (1, 3, 1, 5), (1, 4, 1, 5)]
    coeffs = {1: (5.0, 109.5)}
    _mirror(pconfig.derive_center_angle_table(2, pairs, atom_types, bonds,
                                              coeffs),
            jconfig.derive_center_angle_table(2, pairs, atom_types, bonds,
                                              coeffs))
    for mod in (pconfig, jconfig):
        with pytest.raises(ValueError, match="partner-pair"):
            mod.derive_center_angle_table(2, pairs[:3], atom_types, bonds,
                                          coeffs)
        with pytest.raises(ValueError, match="two different"):
            mod.derive_center_improper_table(
                2, [(1, 2, 1, 3, 4), (2, 3, 1, 4, 5)], atom_types,
                {1: (8.0, 30.0), 2: (9.0, 30.0)})
    imps = [(1, 2, 1, 3, 4)]
    _mirror(pconfig.derive_center_improper_table(2, imps, atom_types,
                                                 {1: (8.0, 30.0)}),
            jconfig.derive_center_improper_table(2, imps, atom_types,
                                                 {1: (8.0, 30.0)}))

    r = np.random.default_rng(3)
    nstar = 7
    x = (r.uniform(1.0, 6.0, (nstar, 1, 3)) + STAR_DX[None]).reshape(-1, 3)
    n = len(x)
    tags = r.permutation(np.arange(1, n + 1)) + 50
    star_bonds = [(5 * s + 1, 5 * s + 1 + k) for s in range(nstar)
                  for k in range(1, 5)]
    bonds = tags[np.asarray(star_bonds) - 1][r.permutation(len(star_bonds))]
    quads = tags[np.asarray([(5 * s + 2, 5 * s + 1, 5 * s + 3, 5 * s + 4)
                             for s in range(nstar)]) - 1]
    types = np.tile([1, 0, 0, 0, 0], nstar)
    kw = dict(box=Box((0.0,) * 3, (L,) * 3, (True,) * 3), masses=(1.0, 1.0),
              dt=0.01, bond=pconfig.BondHarmonicParams(k=40.0, r0=0.55),
              improper=pconfig.ImproperHarmonicParams((0.0, 8.0),
                                                      (0.0, 30.0)),
              capacity=pconfig.Capacity(n_max=n + 13, cell_capacity=24),
              branched_topology=True)
    pcfg = pconfig.SceneConfig(pair=pconfig.DPDParams.create(
        1.0, 1.0, 3, 25.0, 4.5, ntypes=2), **kw)
    jcfg = jconfig.SceneConfig(
        pair=jconfig.DPDParams.create(1.0, 1.0, 3, 25.0, 4.5, ntypes=2),
        box=JBox(kw["box"].lo, kw["box"].hi, kw["box"].periodic),
        **{k: v for k, v in kw.items() if k in ("masses", "dt")},
        bond=jconfig.BondHarmonicParams(k=40.0, r0=0.55),
        improper=jconfig.ImproperHarmonicParams((0.0, 8.0), (0.0, 30.0)),
        capacity=jconfig.Capacity(n_max=n + 13, cell_capacity=24),
        branched_topology=True)
    js = jinit_state(jcfg, x, types=types, tags=tags, bonds=bonds,
                     impropers=quads)
    ps = pinit_state(pcfg, x, types=types, tags=tags, bonds=bonds,
                     impropers=quads, device=CPU)
    for k in ("tag", "bond1", "bond2", "bond3", "bond4", "impr"):
        assert np.array_equal(getattr(ps, k).numpy(),
                              np.asarray(getattr(js, k))), k
    assert len(ps.bond_partners) == 4
    assert (ps.impr.numpy()[:n][types == 1] >= 0).all()
    chain_cfg = dataclasses.replace(pcfg, branched_topology=False,
                                    improper=None)
    chain = pinit_state(chain_cfg, x[:3], bonds=[(1, 2), (2, 3)], device=CPU)
    assert chain.bond3 is None and chain.impr is None
    assert len(chain.bond_partners) == 2
    with pytest.raises(ValueError, match="more than four"):
        pinit_state(pcfg, np.zeros((6, 3)) + 1.0,
                    bonds=[(1, k) for k in range(2, 7)], device=CPU)
    with pytest.raises(ValueError, match="not bonded"):
        pinit_state(pcfg, np.zeros((5, 3)) + 1.0,
                    bonds=[(1, 2), (1, 3), (1, 4)],
                    impropers=[(2, 1, 3, 5)], device=CPU)


def test_molecular_data_file_round_trip(tmp_path):
    """An atom_style molecular file with Bonds, Angles, Dihedrals and
    Impropers written by JAX's write_data reads the same through both
    packages; the port's write_data reads back through JAX's reader;
    atom_style full stays refused."""
    r = np.random.default_rng(8)
    n = 10
    jdf = jio.DataFile(
        natoms=n, ntypes=2, box_lo=np.zeros(3), box_hi=np.full(3, 6.0),
        masses=np.asarray([1.0, 2.0]), x=r.uniform(0.0, 6.0, (n, 3)),
        types=np.asarray([1, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.int32),
        tags=np.arange(1, n + 1, dtype=np.int32), v=r.normal(size=(n, 3)),
        mol=np.repeat(np.arange(1, 3, dtype=np.int32), 5),
        bonds=np.asarray([(1, 2), (1, 3), (1, 4), (1, 5), (6, 7), (7, 8),
                          (8, 9), (9, 10)]),
        angles=np.asarray([(1, 2, 1, 3), (2, 6, 7, 8), (2, 7, 8, 9)]),
        dihedrals=np.asarray([(1, 6, 7, 8, 9), (1, 7, 8, 9, 10)]),
        impropers=np.asarray([(1, 2, 1, 3, 4)]))
    path = tmp_path / "mol.data"
    jio.write_data(str(path), jdf, atom_style="molecular")
    want = jio.read_data(str(path), atom_style="molecular")
    got = pio.read_data(str(path), atom_style="molecular")
    for f in dataclasses.fields(got):
        assert np.array_equal(np.asarray(getattr(got, f.name)),
                              np.asarray(getattr(want, f.name))), f.name
    back = tmp_path / "port.data"
    pio.write_data(str(back), got, atom_style="molecular")
    again = jio.read_data(str(back), atom_style="molecular")
    for f in dataclasses.fields(got):
        assert np.array_equal(np.asarray(getattr(again, f.name)),
                              np.asarray(getattr(want, f.name))), f.name
    # `full` is ported: a file of another style's columns is refused as
    # read_data.cpp refuses it
    with pytest.raises(ValueError, match="expects 7"):
        pio.read_data(str(path), atom_style="full")


def _gap(forces_by_tag, ref):
    assert set(forces_by_tag) == set(ref)
    scale = max(float(np.linalg.norm(v)) for v in ref.values())
    err = max(float(np.abs(forces_by_tag[t] - ref[t]).max()) for t in ref)
    return err, scale


@pytest.mark.parametrize("folder,bar", [("bonded_golden", 5e-5),
                                        ("improper_golden", 2e-4)])
def test_goldens_through_setup(folder, bar):
    """Each golden through the port's reader (scenes.golden_scene: the
    center tables derived from the data file's sections, DPD a0 = 0 and T
    = 0 for `pair zero`), init_state and setup (the cellpad engine,
    float32, the pair kernel's plain version at 2 or 4 exclusion
    channels): every force within bar * max|f| of LAMMPS' dump.ref."""
    sc = pscenes.golden_scene(folder, device=CPU)
    st = psetup(sc.cfg, sc.state)
    d = convert.to_arrays(st)
    got = {int(t): d["f"][i] for i, t in enumerate(d["tag"]) if d["alive"][i]}
    err, scale = _gap(got, pscenes.golden_forces(folder))
    assert err <= bar * scale, (folder, err, scale)


def test_improper_golden_in_float64():
    """validation/improper_golden's improper forces in float64
    (improper_forces on a float64 state read through the port): within
    1e-6 * max|f| of dump.ref, as run_improper_golden.py gates them."""
    sc = pscenes.golden_scene("improper_golden", device=CPU, dtype="float64")
    cfg, st = sc.cfg, sc.state
    f, _ = pb.improper_forces(cfg.improper, cfg.box, st.x,
                              st.bond_partners, st.impr, st.type, st.alive)
    got = {int(t): f[i].numpy() for i, t in enumerate(st.tag.tolist())}
    err, scale = _gap(got, pscenes.golden_forces("improper_golden"))
    assert err <= 1e-6 * scale, (err, scale)
