"""The chain melt's modules (bench/in.chain) against the JAX package:
chain_config, FENE bonds, init_state's partner columns, their remapping by
layout_build and relayout_incremental, the pair kernels' plain versions
with 2-channel bonded exclusion, thermo's E_bond, the data-file reader and
writer, the generated 32,000-bead start and what the engine refuses.

Tolerances: integer columns exact; FENE forces and energies within 1e-5 of
their largest value (the same float32 operations in another order); pair
forces within 2e-4 * max|f| with |sum f| <= 1e-3 * max|f|
(tests/test_newton_kernel.py's bar for the Pallas kernels); thermo within
1e-5 of each quantity's scale."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import cellpad as jcp
from obmd_tpu.config import BondFENEParams as JBondFENE
from obmd_tpu.config import BondHarmonicParams as JBondHarmonic
from obmd_tpu.engine_cellpad import make_geometry as j_make_geometry
from obmd_tpu.forces.bonded import fene_forces as j_fene_forces
from obmd_tpu.forces.pallas_dpd import make_dpd_kernel as j_make_dpd_kernel
from obmd_tpu.forces.pallas_dpd import make_pair_kernel as j_make_pair_kernel
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.io import lammps_data as jio
from obmd_tpu.observe import make_thermo_fn as j_make_thermo_fn
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import cellpad as pcp
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.config import BondFENEParams
from obmd_tpu_torch.engine_cellpad import check_supported, make_geometry
from obmd_tpu_torch.engine_cellpad import relayout_flags
from obmd_tpu_torch.forces.bonded import bond_forces, fene_forces
from obmd_tpu_torch.forces.pair_kernel import (NF, make_dpd_kernel,
                                               make_pair_kernel)
from obmd_tpu_torch.geometry import Box
from obmd_tpu_torch.integrate import compute_forces, make_grid_spec
from obmd_tpu_torch.io import lammps_data as pio
from obmd_tpu_torch.observe import bond_stats, make_thermo_fn
from obmd_tpu_torch.state import init_state as pinit_state

from test_torch_support import (CPU, _mirror, chain_states, jax_arrays,
                                jax_chain_config)
from test_torch_lj import legacy_kw

SALT = 0x2545F491
CHAIN_COLS = ("x", "v", "tag", "alive", "mol", "bond1", "bond2", "xref",
              "rebuilds", "overflow", "tag3d", "occ", "cell_overflow")


def _same(jd, pd, keys=CHAIN_COLS):
    for k in keys:
        assert np.array_equal(np.asarray(pd[k]), jd[k]), k


def _bonded_box(seed=4, n=24):
    """Two 12-bead chains in a periodic 6-box with bond lengths 0.8-1.7:
    some past r0 = 1.5 (the guard clamp), some inside 2^(1/6) (the WCA
    part), one across the periodic face."""
    r = np.random.default_rng(seed)
    x = np.zeros((n, 3))
    x[0] = (0.3, 3.0, 3.0)
    x[12] = (0.5, 1.0, 4.5)
    for i in list(range(1, 12)) + list(range(13, 24)):
        u = r.normal(size=3)
        x[i] = x[i - 1] + r.uniform(0.8, 1.7) * u / np.linalg.norm(u)
    x = np.mod(x, 6.0)
    b1 = np.full(n, -1, np.int32)
    b2 = np.full(n, -1, np.int32)
    for c in (0, 12):
        for k in range(c, c + 11):
            b1[k + 1] = k
            b2[k] = k + 1
    return x.astype(np.float32), b1, b2


def test_config_mirrors_jax():
    """chain_config is the JAX chain_scene's configuration field by field
    (a box read from a data file, and the generated start's box)."""
    box = Box((-16.8, -16.8, -16.8), (16.8, 16.8, 16.8), (True,) * 3)
    for pcfg in (pscenes.chain_config(box, 32000),
                 pscenes.chain_scene(nx=6, chain_len=48, device=CPU).cfg):
        _mirror(pcfg, jax_chain_config(pcfg))
    assert relayout_flags(pcfg) == dict(has_bonds=True, has_mol=True,
                                        has_charge=False, has_types=False,
                                        has_mol_com=False)


def test_fene_matches_jax_and_oracle():
    """fene_forces against JAX's (forces and per-atom energies, within 1e-5
    of their largest value) and against bond_fene.cpp in float64 (1e-4),
    with bonds past r0 clamped at rlogarg = 0.1 and dead atoms ignored; a
    bond style object of another package (the JAX class) is refused."""
    x, b1, b2 = _bonded_box()
    alive = np.ones(len(x), bool)
    alive[20] = False
    jbox = JBox((0.0,) * 3, (6.0,) * 3, (True,) * 3)
    box = Box((0.0,) * 3, (6.0,) * 3, (True,) * 3)
    jf, je = j_fene_forces(JBondFENE(), jbox, jnp.asarray(x), jnp.asarray(b1),
                           jnp.asarray(b2), jnp.asarray(alive),
                           compute_energy=True)
    pf, pe = fene_forces(BondFENEParams(), box, torch.from_numpy(x),
                         torch.from_numpy(b1), torch.from_numpy(b2),
                         torch.from_numpy(alive), compute_energy=True)
    jf, je = np.asarray(jf), np.asarray(je)
    assert np.abs(pf.numpy() - jf).max() <= 1e-5 * np.abs(jf).max()
    assert np.abs(pe.numpy() - je).max() <= 1e-5 * np.abs(je).max()
    f = np.zeros((len(x), 3))
    e = np.zeros(len(x))
    clamped = 0
    for i in range(len(x)):
        for j in (b1[i], b2[i]):
            if j < 0 or not (alive[i] and alive[j]):
                continue
            d = x[i].astype(np.float64) - x[j]
            d -= 6.0 * np.round(d / 6.0)
            rsq = d @ d
            arg = 1.0 - rsq / 2.25
            clamped += arg < 0.1
            arg = max(arg, 0.1)
            fb = -30.0 / arg
            eb = -0.5 * 30.0 * 2.25 * np.log(arg)
            if rsq < 2.0 ** (1.0 / 3.0):
                sr6 = rsq ** -3
                fb += 48.0 * sr6 * (sr6 - 0.5) / rsq
                eb += 4.0 * sr6 * (sr6 - 1.0) + 1.0
            f[i] += fb * d
            e[i] += 0.5 * eb
    assert clamped >= 2
    assert np.abs(pf.numpy() - f).max() <= 1e-4 * np.abs(f).max()
    assert np.abs(pe.numpy() - e).max() <= 1e-4 * np.abs(e).max()
    assert np.all(pf.numpy()[20] == 0.0) and pe.numpy()[20] == 0.0
    with pytest.raises(NotImplementedError):
        bond_forces(JBondHarmonic(), box, torch.from_numpy(x),
                    torch.from_numpy(b1), torch.from_numpy(b2),
                    torch.from_numpy(alive))


def test_init_state_partner_columns_match_jax():
    """init_state resolves 1-based tag pairs (shuffled tags, bonds listed in
    random order and direction) into the same partner slots as JAX's; the
    partner lists are symmetric; a third bond on an atom gives the state
    JAX's bond3 and bond4 columns, and a fifth raises ValueError."""
    x, mol, bonds = pscenes.chain_lattice(6, 48)
    r = np.random.default_rng(7)
    n = len(x)
    tags = r.permutation(np.arange(1, n + 1)) + 100
    bonds = tags[bonds - 1][r.permutation(len(bonds))]
    flip = r.uniform(size=len(bonds)) < 0.5
    bonds[flip] = bonds[flip][:, ::-1]
    box = Box((0.0,) * 3, (10.078,) * 3, (True,) * 3)
    pcfg = pscenes.chain_config(box, n + 40)
    jcfg = jax_chain_config(pcfg)
    js = jinit_state(jcfg, x, tags=tags, mol=mol, bonds=bonds)
    ps = pinit_state(pcfg, x, tags=tags, mol=mol, bonds=bonds, device=CPU)
    jd, pd = jax_arrays(js), convert.to_arrays(ps)
    _same(jd, pd, ("tag", "alive", "mol", "bond1", "bond2"))
    b1, b2 = pd["bond1"], pd["bond2"]
    assert (b1[:n] >= 0).all() and ((b2[:n] >= 0).sum() == n - 2 * 18)
    for i in range(n):
        for j in (b1[i], b2[i]):
            if j >= 0:
                assert i in (b1[j], b2[j])
    third = np.concatenate([bonds, [[tags[5], tags[40]]]])
    js3 = jinit_state(jcfg, x, tags=tags, mol=mol, bonds=third)
    ps3 = pinit_state(pcfg, x, tags=tags, mol=mol, bonds=third, device=CPU)
    for k in ("bond1", "bond2", "bond3", "bond4"):
        assert np.array_equal(getattr(ps3, k).numpy(),
                              np.asarray(getattr(js3, k))), k
    assert (ps3.bond3.numpy() >= 0).sum() == 2
    with pytest.raises(ValueError, match="more than four"):
        pinit_state(pcfg, x, tags=tags, bonds=np.concatenate(
            [third] + [[[tags[5], tags[k]]] for k in (41, 42, 43)]),
            device=CPU)


def test_layout_and_relayouts_match_jax():
    """layout_build, then four epochs of drift (random moves up to half a
    cell, some wrapped) each followed by relayout_incremental with the
    bonded flags (the last with a small mover budget, so that movers stay
    put and count): slots, tags, partner columns and mol exactly as the
    JAX package's, and every partner reference names the right atom."""
    jcfg, jst, pcfg, pst = chain_states()
    jg, pg = j_make_geometry(jcfg), make_geometry(pcfg)
    assert tuple(jg) == tuple(pg) and pg.dims == (5, 5, 5)
    jst = jcp.layout_build(jg, jcfg.box, jst)
    pst = pcp.layout_build(pg, pcfg.box, pst)
    _same(jax_arrays(jst), convert.to_arrays(pst))
    r = np.random.default_rng(9)
    for epoch, m_max in enumerate((0, 0, 0, 24)):
        x = np.asarray(jst.x) + r.uniform(-1.2, 1.2, jst.x.shape) \
            * (r.uniform(size=(jst.x.shape[0], 1)) < 0.3)
        x = np.asarray(jcfg.box.wrap(jnp.asarray(x, jnp.float32)))
        jst = jcp.relayout_incremental(
            jg, jcfg.box, jst.replace(x=jnp.asarray(x)), m_max=m_max,
            has_bonds=True, has_mol=True, has_charge=False, has_types=False)
        pst = pcp.relayout_incremental(
            pg, pcfg.box, pst.replace(x=torch.from_numpy(x)), m_max=m_max,
            **relayout_flags(pcfg))
        jd, pd = jax_arrays(jst), convert.to_arrays(pst)
        _same(jd, pd)
    assert int(pst.nbrs.overflow) > 0
    tag, b1, b2 = pd["tag"], pd["bond1"], pd["bond2"]
    chain_len = 49
    for s in np.flatnonzero(pd["alive"]):
        want = {t for t in (tag[s] - 1, tag[s] + 1)
                if (t - 1) // chain_len == (tag[s] - 1) // chain_len
                and 1 <= t <= 1372}
        assert {tag[j] for j in (b1[s], b2[s]) if j >= 0} == want


def _kernel_inputs(cap, jax_setup=True, **box):
    """A set-up state of the jittered chain box at filing cap `cap` (the
    JAX engine's, or with jax_setup=False the port's: the same slots), and
    the kernels' inputs (fld, tag3d, occ, pbond: partner tags, -2 for
    none, as engine_cellpad._forces builds them)."""
    from obmd_tpu_torch.integrate import setup as psetup
    jcfg, jst, pcfg, pst = chain_states(cap=cap, **box)
    d = (jax_arrays(jsetup(jcfg, jst)) if jax_setup
         else convert.to_arrays(psetup(pcfg, pst)))
    geom = j_make_geometry(jcfg)
    nb, cap_s, lanes = geom.n_blocks, geom.cap, geom.lanes
    xm = np.where(d["alive"][:, None], d["x"], np.float32(1e8))
    fld = np.ascontiguousarray(np.concatenate([xm, d["v"]], axis=1)
                               .astype(np.float32)
                               .reshape(nb, cap_s, lanes, NF)
                               .transpose(0, 3, 1, 2))
    pb = np.stack([np.where(d[k] >= 0, d["tag"][np.clip(d[k], 0, None)], -2)
                   .reshape(nb, cap_s, lanes) for k in ("bond1", "bond2")],
                  axis=1).astype(np.int32)
    return jcfg, pcfg, geom, d, fld, pb


def _assert_close(got, want, alive, label):
    g = got.transpose(0, 2, 3, 1).reshape(-1, 3)[alive]
    w = want.transpose(0, 2, 3, 1).reshape(-1, 3)[alive]
    scale = np.abs(w).max()
    assert scale > 10.0, label
    assert np.abs(g - w).max() <= 2e-4 * scale, (label, np.abs(g - w).max())
    assert np.abs(g.sum(axis=0)).max() <= 1e-3 * scale, label


@pytest.mark.parametrize("cap,body", [(18, "bigtile"), (24, "rank-looped")])
def test_pair_plain_with_exclusion_matches_tpu_kernels(cap, body):
    """The plain versions with pbond against JAX's make_pair_kernel
    (exclude_bonded=True, n_excl=2; its big-tile body at fill cap 18, the
    rank-looped one at 24) and make_dpd_kernel(exclude_bonded=True), in
    interpret mode, on the jittered chain box (5 cells per axis).  More
    than zero 1-2 pairs lie inside the cut, and the forces without pbond
    differ on exactly the slots that have one."""
    jcfg, pcfg, geom, d, fld, pb = _kernel_inputs(cap)
    assert geom.fcap == cap and (geom.fcap <= 20) == (body == "bigtile")
    jargs = (jnp.asarray(fld), jnp.asarray(d["tag3d"]), jnp.uint32(SALT),
             jnp.asarray(d["occ"]), jnp.asarray(pb))
    j2 = np.asarray(j_make_pair_kernel(geom, params=jcfg.pair, dt=jcfg.dt,
                                       exclude_bonded=True, n_excl=2)(*jargs))
    j3 = np.asarray(j_make_dpd_kernel(geom, **legacy_kw(jcfg.pair, jcfg.dt),
                                      exclude_bonded=True)(*jargs))
    pgeom = make_geometry(pcfg)
    pargs = (torch.from_numpy(fld), torch.from_numpy(d["tag3d"].copy()), SALT,
             torch.from_numpy(d["occ"].copy()), torch.from_numpy(pb))
    p2 = make_pair_kernel(pgeom, pcfg.pair, pcfg.dt,
                          exclude_bonded=True)(*pargs).numpy()
    p3 = make_dpd_kernel(pgeom, **legacy_kw(pcfg.pair, pcfg.dt),
                         exclude_bonded=True)(*pargs).numpy()
    alive = d["alive"]
    _assert_close(p2, j2, alive, "pair vs make_pair_kernel")
    _assert_close(p3, j3, alive, "dpd_full vs make_dpd_kernel")
    _assert_close(p2, j3, alive, "pair vs make_dpd_kernel")
    # the 1-2 pairs inside the cut, per slot
    x = d["x"]
    near = np.zeros(len(x), bool)
    for k in ("bond1", "bond2"):
        j = d[k]
        dd = x - x[np.clip(j, 0, None)]
        dd -= np.asarray(pcfg.box.lengths) * np.round(
            dd / np.asarray(pcfg.box.lengths))
        near |= alive & (j >= 0) & ((dd * dd).sum(-1) < 1.12 ** 2)
    assert near.sum() > 20
    free = make_pair_kernel(pgeom, pcfg.pair, pcfg.dt)(*pargs[:4]).numpy()
    differs = (free != p2).any(axis=1).reshape(-1)
    assert np.array_equal(differs, near)


def test_jax_pair_kernel_fault_on_a_one_block_box():
    """A reference behaviour (ROADMAP Queue 3), pinned: on the warmed
    nx = 6 chain box (4 cells per axis, laid out p = 4 in a single block)
    JAX's make_pair_kernel puts a force above 1e8 on a live slot, while its
    make_dpd_kernel and the port's plain version agree within 2e-4 *
    max|f|.  The chain tests therefore hold the kernels at nx = 7."""
    jcfg, pcfg, geom, d, fld, pb = _kernel_inputs(
        18, jax_setup=False, nx=6, chain_len=48, warm=300)
    assert (geom.dims, geom.p, geom.n_blocks) == ((4, 4, 4), 4, 1)
    jargs = (jnp.asarray(fld), jnp.asarray(d["tag3d"]), jnp.uint32(SALT),
             jnp.asarray(d["occ"]), jnp.asarray(pb))
    j2 = np.asarray(j_make_pair_kernel(geom, params=jcfg.pair, dt=jcfg.dt,
                                       exclude_bonded=True, n_excl=2)(*jargs))
    j3 = np.asarray(j_make_dpd_kernel(geom, **legacy_kw(jcfg.pair, jcfg.dt),
                                      exclude_bonded=True)(*jargs))
    p2 = make_pair_kernel(make_geometry(pcfg), pcfg.pair, pcfg.dt,
                          exclude_bonded=True)(
        torch.from_numpy(fld), torch.from_numpy(d["tag3d"].copy()), SALT,
        torch.from_numpy(d["occ"].copy()), torch.from_numpy(pb)).numpy()
    alive = d["alive"]
    _assert_close(p2, j3, alive, "pair vs make_dpd_kernel")
    rows = j2.transpose(0, 2, 3, 1).reshape(-1, 3)[alive]
    assert np.abs(rows).max() > 1e8


def test_thermo_ebond_and_epair_match_jax():
    """make_thermo_fn on the set-up chain box: E_bond (the FENE energy),
    E_pair and pe = E_pair + E_bond as JAX's.  E_pair includes the 1-2
    pairs' WCA energy, which the step excludes (the JAX package's
    convention, ROADMAP Queue 3): it equals a float64 all-pairs sum of the
    shifted WCA with the 1-2 pairs counted, and differs from the sum
    without them."""
    from obmd_tpu_torch.integrate import setup as psetup
    jcfg, jst, pcfg, pst = chain_states()
    jst, pst = jsetup(jcfg, jst), psetup(pcfg, pst)
    jt, pt = j_make_thermo_fn(jcfg)(jst), make_thermo_fn(pcfg)(pst)
    for name in ("ebond", "epair", "pe", "temp", "pressure"):
        want, got = float(getattr(jt, name)), float(getattr(pt, name))
        assert abs(got - want) <= 1e-5 * max(abs(want), 1.0), name
    assert float(pt.ebond) > 0.0
    d = convert.to_arrays(pst)
    x = d["x"][d["alive"]].astype(np.float64)
    tag = d["tag"][d["alive"]]
    L = np.asarray(pcfg.box.lengths)
    dd = x[:, None] - x[None]
    dd -= L * np.round(dd / L)
    rsq = (dd * dd).sum(-1)
    inside = (rsq < 1.12 ** 2) & ~np.eye(len(x), dtype=bool)
    sr6 = np.where(inside, 1.0 / np.where(inside, rsq, 1.0) ** 3, 0.0)
    shift = 4.0 * (1.12 ** -12 - 1.12 ** -6)
    e = np.where(inside, 4.0 * sr6 * (sr6 - 1.0) - shift, 0.0)
    bonded = np.abs(tag[:, None] - tag[None]) == 1
    bonded &= ((tag[:, None] - 1) // 49) == ((tag[None] - 1) // 49)
    all_pairs = 0.5 * e.sum()
    excluded = 0.5 * e[~bonded].sum()
    assert abs(float(pt.epair) - all_pairs) <= 1e-4 * abs(all_pairs)
    assert abs(all_pairs - excluded) > 1.0


def test_data_file_matches_jax(tmp_path):
    """An atom_style bond file written by JAX's write_data reads the same
    through both packages; the port's write_data reads back through JAX's
    reader; chain_scene on that file gives JAX chain_scene's configuration
    and state (partner columns exact)."""
    from obmd_tpu import scenes as jscenes
    x, mol, bonds = pscenes.chain_lattice(6, 48)
    r = np.random.default_rng(2)
    n = len(x)
    lo, hi = np.full(3, 0.0), np.full(3, 10.078)
    jdf = jio.DataFile(natoms=n, ntypes=1, box_lo=lo, box_hi=hi,
                       masses=np.ones(1), x=x, types=np.zeros(n, np.int32),
                       tags=np.arange(1, n + 1, dtype=np.int32),
                       v=r.normal(size=(n, 3)), mol=mol, bonds=bonds)
    path = tmp_path / "chain.data"
    jio.write_data(str(path), jdf, atom_style="bond")
    want = jio.read_data(str(path), atom_style="bond")
    got = pio.read_data(str(path), atom_style="bond")
    for f in dataclasses.fields(got):
        assert np.array_equal(np.asarray(getattr(got, f.name)),
                              np.asarray(getattr(want, f.name))), f.name
    back = tmp_path / "port.data"
    pio.write_data(str(back), got, atom_style="bond")
    again = jio.read_data(str(back), atom_style="bond")
    for f in dataclasses.fields(got):
        assert np.array_equal(np.asarray(getattr(again, f.name)),
                              np.asarray(getattr(want, f.name))), f.name
    js = jscenes.chain_scene(data_path=str(path))
    ps = pscenes.chain_scene(data_path=str(path), device=CPU)
    _mirror(ps.cfg, js.cfg)
    jd, pd = jax_arrays(js.state), convert.to_arrays(ps.state)
    _same(jd, pd, ("x", "v", "type", "tag", "alive", "mol", "bond1", "bond2"))
    # `full` is ported: a file of another style's columns is refused as
    # read_data.cpp refuses it
    with pytest.raises(ValueError, match="expects 7"):
        pio.read_data(str(path), atom_style="full")


def test_generated_start_at_full_size():
    """chain_scene()'s start at nx = 20, built on the CPU without stepping:
    32,000 beads on 32,000 distinct fcc sites, 320 chains of 100, 31,680
    bonds each 1.1877 (<= 1.19), no non-bonded pair within the WCA cut of
    1.12, and the warm-up's first epoch (16 steps at dt 0.003 under the
    bonds alone: no pair lies inside the cut at the start) moves fewer
    atoms across cells than the relayout's mover budget (1,728 of 2,880),
    where the lattice without its a/12 shift moves more (5,378)."""
    from scipy.spatial import cKDTree
    sc = pscenes.chain_scene(device=CPU)
    cfg, st = sc.cfg, sc.state
    x = st.x.numpy()
    L = cfg.box.lengths[0]
    assert x.shape == (32000, 3) and x.min() > 0.0 and x.max() < L
    a = (4.0 / 0.8442) ** (1.0 / 3.0)
    sites = np.round(x / (0.5 * a) - 1.0 / 6.0).astype(np.int64)
    assert np.abs(x / (0.5 * a) - 1.0 / 6.0 - sites).max() < 1e-4
    assert len(np.unique(sites, axis=0)) == 32000
    assert (sites.sum(axis=1) % 2 == 0).all()
    mol = st.mol.numpy()
    assert np.array_equal(np.bincount(mol)[1:], np.full(320, 100))
    longest, over, count = bond_stats(cfg, st)
    assert count == 31680 and over == 0 and longest <= 1.19
    pairs = cKDTree(x, boxsize=L).query_pairs(1.19, output_type="ndarray")
    b1, b2 = st.bond1.numpy(), st.bond2.numpy()
    i, j = pairs[:, 0], pairs[:, 1]
    bonded = (b1[i] == j) | (b2[i] == j)
    assert bonded.sum() == 31680
    assert len(cKDTree(x, boxsize=L).query_pairs(1.12)) == 0
    wcfg = pscenes.chain_warm_up_config(cfg)
    assert (wcfg.dt, wcfg.capacity.cell_capacity) == (pscenes.WARM_DT,
                                                      pscenes.WARM_CAP)
    from obmd_tpu_torch.engine_cellpad import auto_rebuild_every
    geom, steps = make_geometry(wcfg), auto_rebuild_every(wcfg)
    assert steps == 16 and geom.dims == (15, 15, 15)
    h = float(np.float32(0.5 * wcfg.dt))

    def movers(x0):
        xs, v = x0.clone(), st.v.clone()
        f, _ = fene_forces(cfg.bond, cfg.box, xs, st.bond1, st.bond2,
                           st.alive)
        for _ in range(steps):
            v = v + h * f
            xs = cfg.box.wrap(xs + float(np.float32(wcfg.dt)) * v)
            f, _ = fene_forces(cfg.bond, cfg.box, xs, st.bond1, st.bond2,
                               st.alive)
            v = v + h * f
        return int((geom.cell_of(xs) != geom.cell_of(x0)).sum())
    budget = max(2048, geom.n_slots // 32)
    assert movers(st.x) < budget < movers(cfg.box.wrap(st.x - a / 12.0))


def test_engine_refuses_what_is_not_ported():
    """check_supported takes FENE and harmonic chains and branched
    topologies on a closed box, also under gaussian pair noise (the pair
    kernel's 4-channel exclusion is built for every noise variant), and
    refuses bonds with an ATOM-mode OBMD stage and dihedrals on a branched
    topology; the full-stencil kernel refuses 4 exclusion channels;
    compute_forces (the sweep, no 1-2 exclusion) refuses a bonded
    scene."""
    from obmd_tpu_torch.config import (BondHarmonicParams, DPDParams,
                                       DihedralHarmonicParams)
    from obmd_tpu_torch.engine_cellpad import _make_kernel
    cfg = pscenes.chain_scene(nx=6, chain_len=48, device=CPU).cfg
    check_supported(cfg)
    check_supported(dataclasses.replace(cfg, bond=BondHarmonicParams()))
    star = pscenes.star_melt_config(8.0, 1535)
    check_supported(star)
    check_supported(dataclasses.replace(star, pair=dataclasses.replace(
        star.pair, gaussian_noise=True)))
    bad = [dataclasses.replace(star, dihedral=DihedralHarmonicParams(k=1.0)),
           dataclasses.replace(pscenes.obmd_dpd_config(scale=0.25),
                               bond=BondFENEParams())]
    for c in bad:
        with pytest.raises(NotImplementedError):
            check_supported(c)
    one_type = dataclasses.replace(star, masses=(1.0,),
                                   pair=DPDParams.create(1.0, 1.0, 3, 25.0,
                                                         4.5))
    with pytest.raises(NotImplementedError, match="four"):
        _make_kernel(one_type, make_geometry(one_type), "full")
    st = pscenes.chain_scene(nx=6, chain_len=48, device=CPU).state
    with pytest.raises(NotImplementedError):
        compute_forces(cfg, make_grid_spec(cfg), st)
