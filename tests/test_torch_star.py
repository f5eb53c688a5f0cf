"""The closed star-polymer melt against the JAX package: its configuration
and data-file start, the pair kernel's plain version at four exclusion
channels against make_pair_kernel(n_excl=4) in interpret mode on both TPU
bodies, relayouts carrying bond3, bond4 and impr, thermo's bonded
energies, and five steps of the cellpad engine against the JAX engine's.

The small melt is star_melt_scene(n_stars=307): 1,535 beads in a periodic
cube of side 8.0 (6 cut + skin cells per axis, laid out p == 1 in 6
blocks: at least 5 cells per periodic axis and more than one block, where
JAX's make_pair_kernel is right, ROADMAP Queue 3).  Its random start files
at most 23 beads in a cell, so the engine runs at the warm-up's filing cap
24 (the rank-looped body); the big-tile check (fill cap 16) takes stars
centred on a jittered 6^3 lattice.  The engine runs start from the same
centres with each star in its relaxed shape (`_relaxed_star`): in the
template, arms 1 and 2 stand at 174.8 degrees, where the improper's
1 / (1 - c1^2) ~ 120 amplifies float32 rounding (validation/
run_improper_golden.py:142-150), so that there the JAX package's jitted
improper force differs from its own eager one by more than 2e-4 * max|f|
(test_jax_improper_conditioning).

Tolerances: integer columns exact; pair forces within 2e-4 * max|f| with
|sum f| <= 1e-3 * max|f| (tests/test_newton_kernel.py's bar for the Pallas
kernels); in the engine runs, each step from the same state, x within
1e-5, v within 1e-4 and forces within 2e-4 * max|f| (float32 summation
order) but at ill-conditioned impropers (test_five_steps_match_jax); thermo
within 1e-5 of each quantity's scale."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import cellpad as jcp
from obmd_tpu import config as jconfig
from obmd_tpu.engine_cellpad import make_geometry as j_make_geometry
from obmd_tpu.forces.pallas_dpd import make_pair_kernel as j_make_pair_kernel
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.io import lammps_data as jio
from obmd_tpu.observe import make_thermo_fn as j_make_thermo_fn
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import cellpad as pcp
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.engine_cellpad import (_make_kernel, check_supported,
                                           make_geometry, pack_fields,
                                           relayout_flags)
from obmd_tpu_torch.forces.pair_kernel import make_pair_kernel
from obmd_tpu_torch.integrate import make_run as pmake_run
from obmd_tpu_torch.integrate import setup as psetup
from obmd_tpu_torch.observe import (bond_stats, make_thermo_fn,
                                    ill_conditioned_impropers)
from obmd_tpu_torch.state import init_state as pinit_state

from test_torch_support import CPU, EXACT, _mirror, jax_arrays

N_STARS, SEED, STEPS = 307, 2016, 5
SALT = 0x2545F491
BRANCHED = ("bond3", "bond4", "impr")


def jax_star_config(pcfg):
    """The JAX package's configuration of a port star_melt_config (the
    same classes, field by field)."""
    j = {f: getattr(jconfig, type(getattr(pcfg, f)).__name__)(
        **dataclasses.asdict(getattr(pcfg, f)))
         for f in ("bond", "angle", "improper")}
    p = pcfg.pair
    return jconfig.SceneConfig(
        box=JBox(pcfg.box.lo, pcfg.box.hi, pcfg.box.periodic),
        masses=pcfg.masses,
        pair=jconfig.DPDParams.create(p.temp, p.cutoff, p.seed, p.a0,
                                      p.gamma, ntypes=p.ntypes),
        dt=pcfg.dt, capacity=jconfig.Capacity(
            n_max=pcfg.capacity.n_max,
            cell_capacity=pcfg.capacity.cell_capacity),
        skin=pcfg.skin, force_path="cellpad",
        rebuild_every=pcfg.rebuild_every, branched_topology=True, **j)


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """(port cfg, port state, JAX cfg, JAX state) of the small melt's
    start: the port's star_melt_scene, and the JAX package's init_state on
    the same data file read by the JAX reader."""
    sc = pscenes.star_melt_scene(n_stars=N_STARS, seed=SEED, device=CPU)
    path = str(tmp_path_factory.mktemp("star") / "stars.data")
    pscenes.write_star_data(path, N_STARS, SEED)
    df = jio.read_data(path, atom_style="molecular")
    jcfg = jax_star_config(sc.cfg)
    types = dict(zip(df.tags.tolist(), df.types.tolist()))
    _mirror(sc.cfg.angle, jconfig.derive_center_angle_table(
        2, df.angles, types, df.bonds, {1: pscenes.STAR_ANGLE}))
    _mirror(sc.cfg.improper, jconfig.derive_center_improper_table(
        2, df.impropers, types, {1: pscenes.STAR_IMP}))
    jst = jinit_state(jcfg, df.x, v=df.v, types=df.types, tags=df.tags,
                      mol=df.mol, bonds=df.bonds, impropers=df.impropers)
    return sc.cfg, sc.state, jcfg, jst, df


def test_scene_and_start_match_jax(start):
    """star_melt_scene: 307 stars of 5 beads, 1,228 bonds, the box of
    side (5 * 307 / 3)^(1/3), every column of the JAX package's init_state
    on the same file (bond3, bond4 and impr included) and the JAX
    configuration's bonded styles through convert.bonded_params; every
    center has
    four partners and an improper triplet, every arm one partner; no bond
    longer than the template's 0.5523; the engine takes the scene."""
    pcfg, pst, jcfg, jst, _ = start
    jd, pd = jax_arrays(jst), convert.to_arrays(pst)
    for k in ("x", "v", "type", "tag", "alive", "mol", "bond1", "bond2") \
            + BRANCHED:
        assert np.array_equal(pd[k], jd[k]), k
    n = N_STARS * 5
    assert int(pst.natoms) == n and pcfg.box.hi[0] == pytest.approx(
        (n / 3.0) ** (1.0 / 3.0))
    center = pd["type"][:n] == 1
    partners = np.stack([pd[k][:n] for k in ("bond1", "bond2", "bond3",
                                             "bond4")])
    assert ((partners >= 0).sum(0) == np.where(center, 4, 1)).all()
    assert (pd["impr"][:n][center] >= 0).all()
    assert (pd["impr"][:n][~center] < 0).all()
    longest, over, count = bond_stats(pcfg, pst, limit=0.553)
    assert count == 4 * N_STARS and over == 0
    for f in ("bond", "angle", "improper"):
        _mirror(convert.bonded_params(getattr(jcfg, f)), getattr(pcfg, f))
    check_supported(pcfg)
    assert relayout_flags(pcfg) == dict(has_bonds=True, has_mol=True,
                                        has_charge=False, has_types=True,
                                        has_mol_com=False)


def _lattice_stars(seed=4, side=6, L=8.0):
    """side^3 stars centred on a jittered cubic lattice in the L-box,
    randomly rotated (scenes._rotations): a start whose fullest cell fits
    fill cap 16.  Returns (x, types, bonds as 1-based tag pairs)."""
    r = np.random.default_rng(seed)
    g = (np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) * (L / side)
    g += r.uniform(-0.15, 0.15, g.shape)
    dx = np.einsum("sij,kj->ski", pscenes._rotations(r, len(g)),
                   np.asarray(pscenes.STAR_DX))
    x = np.mod(g[:, None] + dx, L).reshape(-1, 3)
    base = 5 * np.arange(len(g))[:, None] + 1
    bonds = np.stack([np.broadcast_to(base, (len(g), 4)),
                      base + np.arange(1, 5)], -1).reshape(-1, 2)
    return x, np.tile(pscenes.STAR_TYPES, len(g)), bonds


def _kernel_inputs(pcfg, x, types, bonds, cap):
    """The set-up port state at filing cap `cap` and the kernels' inputs
    (engine_cellpad.pack_fields: 8 channels, pbond of 4 partner-tag
    planes)."""
    cfg = pscenes.with_cap(pcfg, cap)
    cfg = dataclasses.replace(cfg, capacity=dataclasses.replace(
        cfg.capacity, n_max=len(x)))
    st = pcp.layout_build(make_geometry(cfg), cfg.box, pinit_state(
        cfg, x, types=types, bonds=bonds, device=CPU))
    assert int(st.cell_overflow) == 0
    geom = make_geometry(cfg)
    return cfg, geom, st, pack_fields(cfg, geom, st)


@pytest.mark.parametrize("cap,body", [(16, "bigtile"), (24, "rank-looped")])
def test_pair_plain_four_channels_matches_tpu_kernel(start, cap, body):
    """The port's pair kernel (its plain version on the CPU) with 4
    exclusion channels against JAX's make_pair_kernel(exclude_bonded=True,
    n_excl=4) in interpret mode: the big-tile body at fill cap 16 on the
    lattice stars, the rank-looped body at cap 24 on the random start.
    The launch key names the 4 channels; without pbond the forces differ
    on exactly the slots with a 1-2 partner inside the cut (every bonded
    bead here)."""
    pcfg, pst, jcfg, _, _ = start
    if body == "bigtile":
        x, types, bonds = _lattice_stars()
    else:
        n = int(pst.natoms)
        x, types = pst.x[:n].numpy(), pst.type[:n].numpy()
        bonds = np.stack([np.repeat(5 * np.arange(N_STARS) + 1, 4),
                          (5 * np.arange(N_STARS)[:, None] + np.arange(2, 6))
                          .reshape(-1)], -1)
    cfg, geom, st, (fld, tag, _, occ, pbond) = _kernel_inputs(
        pcfg, x, types, bonds, cap)
    assert geom.fcap == cap and geom.dims == (6, 6, 6) and geom.n_blocks == 6
    assert pbond.shape[1] == 4
    kern = _make_kernel(cfg, geom)
    got = kern(fld, tag, SALT, occ, pbond).numpy()
    want = np.asarray(j_make_pair_kernel(
        j_make_geometry(jax_star_config(cfg)), params=jcfg.pair, dt=jcfg.dt,
        exclude_bonded=True, n_excl=4)(
        jnp.asarray(fld.numpy()), jnp.asarray(tag.numpy()), jnp.uint32(SALT),
        jnp.asarray(occ.numpy()), jnp.asarray(pbond.numpy())))
    alive = st.alive.numpy()
    g = got.transpose(0, 2, 3, 1).reshape(-1, 3)[alive]
    w = want.transpose(0, 2, 3, 1).reshape(-1, 3)[alive]
    scale = np.abs(w).max()
    assert scale > 10.0
    assert np.abs(g - w).max() <= 2e-4 * scale, np.abs(g - w).max()
    assert np.abs(g.sum(axis=0)).max() <= 1e-3 * scale
    free = make_pair_kernel(geom, cfg.pair, cfg.dt)(fld, tag, SALT, occ)
    differs = (free.numpy() != got).any(axis=1).reshape(-1)
    assert np.array_equal(differs, alive)


def test_relayouts_carry_branched_columns(start):
    """layout_build, then three epochs of drift (random moves up to a cell,
    some wrapped) each followed by relayout_incremental (the last with a
    mover budget of 24, so that movers stay put and count): slots, tags,
    the four partner columns and impr exactly as the JAX package's, and
    every reference names the same tag as at the start: each center's
    partners are its star's four arms and its impr triplet the tags of
    arms 1, 2 and 3 (template rows 1, 2, 3)."""
    pcfg, pst, jcfg, jst, _ = start
    jg, pg = j_make_geometry(jcfg), make_geometry(pcfg)
    assert tuple(jg) == tuple(pg)
    jst = jcp.layout_build(jg, jcfg.box, jst)
    pst = pcp.layout_build(pg, pcfg.box, pst)
    keys = ("x", "tag", "alive", "mol", "bond1", "bond2") + BRANCHED

    def same():
        jd, pd = jax_arrays(jst), convert.to_arrays(pst)
        for k in keys:
            assert np.array_equal(pd[k], jd[k]), k
        return pd
    same()
    r = np.random.default_rng(9)
    for m_max in (0, 0, 24):
        x = np.asarray(jst.x) + r.uniform(-1.3, 1.3, jst.x.shape) \
            * (r.uniform(size=(jst.x.shape[0], 1)) < 0.3)
        x = np.asarray(jcfg.box.wrap(jnp.asarray(x, jnp.float32)))
        jst = jcp.relayout_incremental(
            jg, jcfg.box, jst.replace(x=jnp.asarray(x)), m_max=m_max,
            has_bonds=True, has_mol=True, has_charge=False, has_types=True)
        pst = pcp.relayout_incremental(
            pg, pcfg.box, pst.replace(x=torch.from_numpy(x.copy())), m_max=m_max,
            **relayout_flags(pcfg))
        pd = same()
    assert int(pst.nbrs.overflow) > 0
    tag = pd["tag"]
    for s in np.flatnonzero(pd["alive"]):
        c = (tag[s] - 1) // 5 * 5 + 1              # the star's center tag
        names = {int(tag[pd[k][s]]) for k in ("bond1", "bond2", "bond3",
                                              "bond4") if pd[k][s] >= 0}
        if tag[s] == c:
            assert names == {c + 1, c + 2, c + 3, c + 4}
            assert [int(tag[j]) for j in pd["impr"][s]] == [c + 1, c + 2,
                                                            c + 3]
        else:
            assert names == {c} and (pd["impr"][s] < 0).all()


def test_jax_improper_conditioning(start):
    """A reference behaviour, pinned: on the template start the JAX
    package's improper_forces jitted and eager differ by more than 2e-4 *
    max|f|, and agree within it on every slot but those of
    observe.ill_conditioned_impropers, where the port's force equals the
    JAX eager one within 1e-5 * max|f| (test_torch_bonded.py's bar)."""
    from obmd_tpu.forces.bonded import improper_forces as j_improper
    from obmd_tpu_torch.forces.bonded import improper_forces as p_improper
    pcfg, pst, jcfg, jst, _ = start

    def jf(s):
        return j_improper(jcfg.improper, jcfg.box, s.x, s.bond_partners,
                          s.impr, s.type, s.alive)[0]
    eager, jit = np.asarray(jf(jst)), np.asarray(jax.jit(jf)(jst))
    port = p_improper(pcfg.improper, pcfg.box, pst.x, pst.bond_partners,
                      pst.impr, pst.type, pst.alive)[0].numpy()
    scale = np.abs(eager).max()
    gap = np.abs(jit - eager).max(axis=1)
    ill = ill_conditioned_impropers(pcfg, pst).numpy()
    assert gap.max() > 2e-4 * scale
    assert gap[~ill].max() <= 2e-4 * scale
    assert np.abs(port - eager).max(axis=1)[~ill].max() <= 1e-5 * scale


def _relaxed_star():
    """The star's relaxed shape: the template (scenes.STAR_DX) moved down
    the float64 gradient of its own bond, angle and improper energy (the
    port's bonded forces) to rest; the center at the origin."""
    from obmd_tpu_torch.forces import bonded as pb
    from obmd_tpu_torch.geometry import Box
    sc = pscenes.star_melt_scene(n_stars=1, seed=0, device=CPU)
    cfg = dataclasses.replace(sc.cfg, dtype="float64")
    st = pinit_state(cfg, np.asarray(pscenes.STAR_DX) + 2.0,
                     types=pscenes.STAR_TYPES,
                     bonds=[(1, k) for k in range(2, 6)],
                     impropers=[np.asarray(pscenes.STAR_IMPROPER) + 1],
                     device=CPU)
    box = Box((0.0,) * 3, (50.0,) * 3, (False,) * 3)
    x = st.x
    for _ in range(500):
        more = (st.bond3, st.bond4)
        f = (pb.bond_forces(cfg.bond, box, x, st.bond1, st.bond2, st.alive,
                            more_partners=more)[0]
             + pb.angle_forces(cfg.angle, box, x, st.bond1, st.bond2,
                               st.type, st.alive, more_partners=more)[0]
             + pb.improper_forces(cfg.improper, box, x, st.bond_partners,
                                  st.impr, st.type, st.alive)[0])
        x = x + 2e-3 * f
    assert float(f.abs().max()) < 1e-6
    return (x - x[0]).numpy()


@pytest.fixture(scope="module")
def runs(start):
    """The JAX engine's setup and 5 steps from the small melt's star
    centres, rotations and velocities (the scene's numpy draws at SEED, in
    write_star_data's order) with each star in its relaxed shape; and the
    port's setup and each of its steps from the JAX state before it,
    handed over through convert.from_arrays, so that every step starts
    from the same state in both engines."""
    pcfg, _, jcfg, _, df = start
    pcfg = pscenes.with_cap(pcfg, pscenes.STAR_WARM_CAP)
    r = np.random.default_rng(SEED)
    L = pcfg.box.hi[0]
    centers = r.uniform(0.0, L, (N_STARS, 3))
    dx = np.einsum("sij,kj->ski", pscenes._rotations(r, N_STARS),
                   _relaxed_star())
    x = np.mod(centers[:, None, :] + dx, L).reshape(-1, 3)
    jst = jinit_state(jcfg, x, v=df.v, types=df.types, tags=df.tags,
                      mol=df.mol, bonds=df.bonds, impropers=df.impropers)
    pst = psetup(pcfg, convert.from_arrays(jax_arrays(jst), device=CPU))
    jst = jsetup(jcfg, jst)
    out = [(jax_arrays(jst), convert.to_arrays(pst),
            ill_conditioned_impropers(pcfg, pst).numpy())]
    jrun = jax.jit(jmake_run(jcfg, 1))
    prun = pmake_run(pcfg, 1)
    for _ in range(STEPS):
        pst = prun(convert.from_arrays(out[-1][0], device=CPU))
        jst = jrun(jst)
        out.append((jax_arrays(jst), convert.to_arrays(pst),
                    ill_conditioned_impropers(pcfg, pst).numpy()))
    return jcfg, pcfg, jst, pst, out


def test_five_steps_match_jax(runs):
    """After setup and each of 5 steps (a relayout every step,
    scenes.STAR_REBUILD_EVERY), each from the same state: slots,
    tags, alive, every partner column, impr, mol, the kernel caches and
    the counters exactly as the JAX engine's; x and xref within 1e-5; v
    within 1e-4 and f within 2e-4 * max|f| on every slot but those of an
    improper with sin(chi) or 1 - c^2 of a bond angle below 0.05
    (observe.ill_conditioned_impropers), where float32 rounding is
    amplified (the random centres'
    overlaps flatten a few stars within 5 steps); at most 8 of the 307
    impropers a step.  Positions by tag agree within 1e-5 at the end."""
    _, pcfg, _, pst, out = runs
    for jd, pd, planar in out:
        for k in EXACT + BRANCHED:
            assert np.array_equal(np.asarray(pd[k]), jd[k]), k
        for k in ("x", "xref"):
            np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        assert planar.sum() <= 8 * 4
        keep = ~planar
        np.testing.assert_allclose(pd["v"][keep], jd["v"][keep], rtol=0,
                                   atol=1e-4)
        fmax = np.abs(jd["f"]).max()
        assert np.abs(pd["f"] - jd["f"])[keep].max() <= 2e-4 * fmax
    jd, pd, _ = out[-1]
    assert int(pd["step"]) == STEPS and int(pd["rebuilds"]) == STEPS + 1

    def by_tag(d):
        keep = d["alive"]
        order = np.argsort(d["tag"][keep])
        return d["tag"][keep][order], d["x"][keep][order]
    (jt, jx), (pt, px) = by_tag(jd), by_tag(pd)
    assert np.array_equal(jt, pt)
    assert np.abs(jx - px).max() <= 1e-5
    assert bond_stats(pcfg, pst, limit=2.0)[1] == 0


def test_thermo_bonded_energies_match_jax(runs):
    """make_thermo_fn on the JAX engine's state after the fifth step,
    handed over: E_bond, E_angle, E_imp (and E_dihed = 0), E_pair, pe and
    T as the JAX package's thermo."""
    jcfg, pcfg, jst, _, out = runs
    pst = convert.from_arrays(out[-1][0], device=CPU)
    jt, pt = j_make_thermo_fn(jcfg)(jst), make_thermo_fn(pcfg)(pst)
    for name in ("ebond", "eangle", "eimp", "edihed", "epair", "pe", "temp"):
        want, got = float(getattr(jt, name)), float(getattr(pt, name))
        assert abs(got - want) <= 1e-5 * max(abs(want), 1.0), name
    assert min(float(pt.ebond), float(pt.eangle), float(pt.eimp)) > 0.0
    assert float(pt.edihed) == 0.0
