"""The lj/cut/rf law and 1-4 atom types in the port against the JAX package
(its Pallas kernels in interpret mode) and against the fork's own LAMMPS
forces (validation/ljrf_golden: 220 charged atoms, `pair_style lj/cut/rf
2.2 2.2`, `pair_coeff 1 1 0.8 1.0 80.0`, a real binary's `run 0`).

Held:
- the law (forces/pairs.make_pair_law) and pair_sweep (forces, per-atom
  energy, virial) on a two-type charged box, to 1e-5 of each quantity's
  scale (float32 summation order);
- the pair kernel's plain version against JAX's make_pair_kernel at 2e-4 *
  max|f| (the bar of tests/test_bigtile.py): ljrf with two types at a fill
  cap > 20 (the rank-looped body) and <= 20 (the big-tile body), two-type
  DPD (the noise is the same hash, bit for bit) and four-type lj with
  per-pair cutoffs, every box with >= 5 cells per periodic axis (ROADMAP
  Queue 3: JAX's kernel is wrong on smaller ones);
- the golden: forces against dump.ref at 5e-5 * max|f|
  (validation/run_ljrf_golden.py's bar, float32 against float64) and the
  pair energy against log.ref's PotEng at 1e-5;
- the USHER search with the lj/cut/rf law on charged two-type subsets: the
  plain version against usher_search_pallas on margin-robust candidates
  (|E - etarget| >= 0.3), positions within 2e-3;
- `q` and `type` through the converter, layout_build and
  relayout_incremental exactly as the JAX package moves them, and through
  `atom_style charge` data files."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import cellpad as jcp
from obmd_tpu import config as jconfig
from obmd_tpu.engine_cellpad import make_geometry as j_make_geometry
from obmd_tpu.engine_cellpad import relayout_flags as j_relayout_flags
from obmd_tpu.forces import pairs as jpairs
from obmd_tpu.forces.pallas_dpd import make_pair_kernel as j_make_pair_kernel
from obmd_tpu.forces.pallas_usher import usher_search_pallas
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.geometry import RegionBlock as JRegion
from obmd_tpu.integrate import make_grid_spec as j_make_grid_spec
from obmd_tpu.io import lammps_data as jio
from obmd_tpu.obmd.subset import Subset as JSubset
from obmd_tpu.obmd.subset import conservative_energy_force
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import cellpad as pcp
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.cells import build_cells
from obmd_tpu_torch.engine_cellpad import (make_geometry, pack_fields,
                                           relayout_flags)
from obmd_tpu_torch.forces import pairs as ppairs
from obmd_tpu_torch.forces.pair_kernel import (PairCoef, make_pair_kernel,
                                               pair_tables)
from obmd_tpu_torch.forces.usher_kernel import usher_law
from obmd_tpu_torch.geometry import Box as PBox
from obmd_tpu_torch.geometry import RegionBlock as PRegion
from obmd_tpu_torch.integrate import compute_forces, make_grid_spec
from obmd_tpu_torch.integrate import setup as psetup
from obmd_tpu_torch.io import lammps_data as pio
from obmd_tpu_torch.obmd.subset import Subset as PSubset
from obmd_tpu_torch.obmd.subset import usher_search_subset_batch
from obmd_tpu_torch.state import init_state as pinit_state

from test_torch_lj import assert_close
from test_torch_obmd_lj import to_jax
from test_torch_support import (CPU, jax_arrays, jittered, lattice_states)

GOLDEN = os.path.join(os.path.dirname(__file__), os.pardir, "validation",
                      "ljrf_golden")
SALT = 0x9E3779B1
SMALL = (16, 9)          # the small open charged box: 9 x 5 x 5 cells


def charged_start(nx=SMALL[0], ny=SMALL[1], keep=1.0, seed=1):
    """The small open charged fluid's lattice start moved by a 0.05 numpy
    jitter (float32), with ion_sites' types and charges; keep < 1 thins it
    to that fraction of the sites first (numpy seed)."""
    pcfg = pscenes.obmd_ljrf_config(nx=nx, ny=ny)
    sc = pscenes.obmd_ljrf_scene(nx=nx, ny=ny, device=CPU)
    n = 4 * nx * ny * ny
    x, v = sc.state.x[:n].numpy(), sc.state.v[:n].numpy()
    if keep < 1.0:
        sel = np.random.default_rng(seed).random(n) < keep
        x, v = x[sel], v[sel]
    types, q = pscenes.ion_sites(len(x))
    return pcfg, jittered(pcfg, x, seed), v, types, q


def laid_out(pcfg, x, v, types=None, q=None):
    """The port's layout of one state (layout_build, no cell overflow) and
    the pair kernel's inputs."""
    geom = make_geometry(pcfg)
    st = pcp.layout_build(geom, pcfg.box, pinit_state(
        pcfg, x, v=v, types=types, q=q, device=CPU))
    assert int(st.cell_overflow) == 0
    fld, tag3d, _, occ, _ = pack_fields(pcfg, geom, st)
    return geom, st, fld, tag3d, occ


def kernels_both(pcfg, x, v, types, q):
    """(port plain forces, JAX make_pair_kernel forces, state arrays) on
    one layout with the salt SALT."""
    geom, st, fld, tag3d, occ = laid_out(pcfg, x, v, types, q)
    assert fld.shape[1] == PairCoef.of(geom, pcfg.pair, pcfg.dt).n_channels
    f_port = make_pair_kernel(geom, pcfg.pair, pcfg.dt)(
        fld, tag3d, SALT, occ).numpy()
    jcfg = to_jax(pcfg)
    jg = j_make_geometry(jcfg)
    assert tuple(jg) == tuple(geom)
    f_tpu = np.asarray(j_make_pair_kernel(jg, params=jcfg.pair, dt=jcfg.dt)(
        jnp.asarray(fld.numpy()), jnp.asarray(tag3d.numpy()),
        jnp.uint32(SALT), jnp.asarray(occ.numpy()), None))
    return f_port, f_tpu, convert.to_arrays(st), geom


def four_type_lj():
    """lj_melt_scene(nx=11)'s box (6 cells per axis, periodic, cap 36) with
    four types drawn by numpy, per-pair epsilon and sigma, and per-pair LJ
    cutoffs 2.5 and 2.2."""
    sc = pscenes.lj_melt_scene(nx=11, device=CPU)
    eps = np.array([[1.0, 0.8, 0.9, 1.1], [0.8, 0.6, 0.7, 0.9],
                    [0.9, 0.7, 1.2, 1.0], [1.1, 0.9, 1.0, 0.5]])
    sig = np.array([[1.0, 0.95, 1.05, 0.9], [0.95, 0.9, 1.0, 0.92],
                    [1.05, 1.0, 1.1, 0.97], [0.9, 0.92, 0.97, 0.85]])
    cut = np.where(np.add.outer(np.arange(4), np.arange(4)) % 2, 2.2, 2.5)
    pair = pconfig.LJCutParams.create(cutoff=2.5, epsilon=eps, sigma=sig,
                                      cut=cut, ntypes=4)
    pcfg = dataclasses.replace(sc.cfg, pair=pair,
                               masses=(1.0, 1.2, 0.8, 2.0))
    x = jittered(pcfg, sc.state.x.numpy(), 3)
    types = np.random.default_rng(4).integers(0, 4, len(x))
    return pcfg, x, sc.state.v.numpy(), types, None


def two_type_dpd(cap):
    """The OBMD_DPD box at scale 0.25 (6 x 8 x 8 cells, p = 2) on a
    jittered rho = 3 lattice with two types drawn by numpy: a0, gamma and
    masses per type pair."""
    _, _, pcfg, pst = lattice_states(scale=0.25, cap=cap)
    pair = pconfig.DPDParams.create(
        temp=1.0, cutoff=1.0, seed=5, ntypes=2,
        a0=[[209.6, 150.0], [150.0, 180.0]], gamma=[[4.5, 2.0], [2.0, 6.0]])
    pcfg = dataclasses.replace(pcfg, pair=pair, masses=(1.0, 2.0))
    n = int(pst.natoms)
    types = np.random.default_rng(6).integers(0, 2, n)
    return pcfg, pst.x[:n].numpy(), pst.v[:n].numpy(), types, None


def thinned_cap20():
    """The small open charged box thinned to 40% of its sites (rho* ~
    0.34), filed at cap 20: JAX's big-tile body."""
    pcfg, x, v, types, q = charged_start(keep=0.4)
    pcfg = dataclasses.replace(pcfg, capacity=dataclasses.replace(
        pcfg.capacity, cell_capacity=20))
    return pcfg, x, v, types, q


CASES = {
    "ljrf-t2-cap44": charged_start,
    "ljrf-t2-cap20": thinned_cap20,
    "dpd-t2-cap15": lambda: two_type_dpd(15),
    "dpd-t2-cap24": lambda: two_type_dpd(24),
    "lj-t4-cap36": four_type_lj,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_plain_matches_tpu_kernel(case):
    """The plain version against JAX's make_pair_kernel: max error <= 2e-4
    * max|f| over alive slots, |sum f| <= 1e-3 * max|f|, zero on dead
    slots; the fill cap picks JAX's body (big-tile at <= 20)."""
    pcfg, x, v, types, q = CASES[case]()
    f_port, f_tpu, d, geom = kernels_both(pcfg, x, v, types, q)
    assert f"-cap{geom.fcap}" in case and (geom.dims[1] >= 5)
    assert_close(f_port, f_tpu, d, case)
    if q is not None:
        assert (d["q"][d["alive"]] != 0.0).sum() > 20


def test_ljrf_coulomb_changes_the_forces():
    """The reaction field reaches the forces: the charged fluid's plain
    forces differ from those with every charge zeroed on exactly the slots
    of ions that have another ion within rc_coul."""
    pcfg, x, v, types, q = charged_start()
    geom, st, fld, tag3d, occ = laid_out(pcfg, x, v, types, q)
    kern = make_pair_kernel(geom, pcfg.pair, pcfg.dt)
    f_q = kern(fld, tag3d, 0, occ)
    fld0 = fld.clone()
    fld0[:, 6] = 0.0
    f_0 = kern(fld0, tag3d, 0, occ)
    differs = (f_q != f_0).any(dim=1).reshape(-1)
    ion = torch.nonzero(st.alive & (st.q != 0.0)).reshape(-1)
    d = pcfg.box.min_image(st.x[ion][:, None] - st.x[ion][None])
    close = (d * d).sum(-1) < 2.5 ** 2
    near_ion = torch.zeros_like(st.alive)
    near_ion[ion] = close.sum(-1) > 1             # itself and another ion
    assert int(near_ion.sum()) > 0
    assert torch.equal(differs, near_ion)


def test_pair_tables_round_like_the_tpu_kernel():
    """pair_tables: one type keeps the host-float constants (cut^2 rounded
    from float64), 2-4 types take float32 table entries; c_rf =
    2(eps_rf - 1)/(2 eps_rf + 1), 1/rc_coul^3 and rc_coul^2 as float32."""
    p1 = pconfig.LJCutRFParams.create(cut_lj=2.2, cut_coul=2.5, epsilon=0.8,
                                      sigma=1.0, eps_rf=80.0)
    t = pair_tables(p1)
    assert t[:4] == (float(np.float32(6.25)), 1.0, float(np.float32(6.25)),
                     float(np.float32(1.0 / 2.5 ** 3)))
    rows = np.asarray(t[4:], np.float32).reshape(8, 1)
    assert rows[0, 0] == np.float32(2.2 * 2.2)
    assert rows[7, 0] == np.float32(2.0 * 79.0 / 161.0)
    assert rows[5, 0] == np.float32(48.0 * 0.8)
    p2 = pscenes.ljrf_pair()
    rows = np.asarray(pair_tables(p2)[4:], np.float32).reshape(8, 4)
    c = np.float32(2.5)
    assert (rows[0] == c * c).all() and (rows[1] == np.float32(1.0) / c).all()
    coef = PairCoef.of(make_geometry(pscenes.obmd_ljrf_config()), p2, 0.005)
    assert (coef.law, coef.ntypes, coef.n_channels, coef.typed) == \
        ("ljrf", 2, 8, True)


def _sweep_both(pcfg, x, v, types, q):
    """pair_sweep of both packages with energies and virials on one state:
    two dicts of numpy arrays (f, pe, virial, virial_atom)."""
    from obmd_tpu.cells import build_cells as j_build_cells
    jcfg = to_jax(pcfg)
    n = len(x)
    arrays = [np.asarray(a, dt) for a, dt in (
        (x, np.float32), (v, np.float32), (types, np.int32),
        (np.arange(1, n + 1), np.int32), (q, np.float32))]
    kw = dict(compute_energy=True, compute_virial=True,
              compute_virial_atom=True)
    jx, jv, jt, jg, jq = (jnp.asarray(a) for a in arrays)
    spec = j_make_grid_spec(jcfg)
    jtab = j_build_cells(spec, jx, jnp.ones(n, bool))
    jpf = jpairs.pair_sweep(jcfg.pair, jcfg.box, spec, jtab, jx, jv, jt, jg,
                            jq, jnp.uint32(0), dt=jcfg.dt, **kw)
    px, pv, pt, pg, pq = (torch.from_numpy(a) for a in arrays)
    spec = make_grid_spec(pcfg)
    ptab = build_cells(spec, px, torch.ones(n, dtype=torch.bool))
    ppf = ppairs.pair_sweep(pcfg.pair, pcfg.box, spec, ptab, px, pv, pt, pg,
                            0, dt=pcfg.dt, q=pq, **kw)
    assert int(jtab.overflow) == 0 and int(ptab.overflow) == 0
    keys = ("f", "pe", "virial", "virial_atom")
    return ({k: np.asarray(getattr(jpf, k)) for k in keys},
            {k: getattr(ppf, k).numpy() for k in keys})


def test_ljrf_sweep_matches_jax():
    """pair_sweep with the two-type lj/cut/rf law on the small open charged
    box: forces, per-atom energy, virial and per-atom virial to 1e-5 of
    each quantity's scale; the reaction field moves the ions' energies and
    leaves every neutral atom's as it was (the same sweep with the charges
    zeroed)."""
    pcfg, x, v, types, q = charged_start()
    jw, pw = _sweep_both(pcfg, x, v, types, q)
    for k in ("f", "pe", "virial", "virial_atom"):
        scale = np.abs(jw[k]).max()
        np.testing.assert_allclose(pw[k], jw[k], rtol=0, atol=1e-5 * scale,
                                   err_msg=k)
    _, p0 = _sweep_both(pcfg, x, v, types, np.zeros_like(q))
    moved = np.abs(p0["pe"] - pw["pe"])
    assert moved[q != 0].max() > 1e-2 and (moved[q == 0] == 0.0).all()


def test_ljrf_law_matches_jax():
    """make_pair_law for lj/cut/rf with its own Coulomb cutoff (rc_lj 2.2
    per pair up to 2.4, rc_coul 2.5) and two types, on numpy-drawn
    separations through both cutoffs: fpair and the pair energy to 1e-5 of
    their scales; beyond rc_coul both are zero."""
    kw = dict(cut_lj=2.2, cut_coul=2.5, ntypes=2, eps_rf=[[80.0, 60.0],
                                                          [60.0, 40.0]],
              epsilon=pscenes.LJRF_EPSILON, sigma=pscenes.LJRF_SIGMA,
              cut=[[2.2, 2.4], [2.4, 2.3]])
    pp = pconfig.LJCutRFParams.create(**kw)
    jp = jconfig.LJCutRFParams.create(**kw)
    r = np.random.default_rng(8)
    n = 4000
    rr = r.uniform(0.85, 2.7, n)
    u = r.normal(size=(n, 3))
    d = (u * (rr / np.linalg.norm(u, axis=1))[:, None]).astype(np.float32)
    rsq = (d * d).sum(-1)
    ti, tj = (r.integers(0, 2, n).astype(np.int32) for _ in range(2))
    qi, qj = (r.uniform(-1, 1, n).astype(np.float32) for _ in range(2))
    zero = np.zeros(n, np.int32)
    fj, ej = jpairs.make_pair_law(jp, 0.005, jnp.float32)(
        jnp.asarray(rsq), jnp.asarray(d), jnp.asarray(d), jnp.asarray(ti),
        jnp.asarray(tj), jnp.asarray(zero), jnp.asarray(zero),
        jnp.uint32(0), qi=jnp.asarray(qi), qj=jnp.asarray(qj))
    t = torch.from_numpy
    fp, ep = ppairs.make_pair_law(pp, 0.005)(
        t(rsq), t(d), t(d), t(ti), t(tj), t(zero), t(zero), 0, qi=t(qi),
        qj=t(qj))
    for got, want in ((fp, fj), (ep, ej)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    out = rsq >= np.float32(2.5) ** 2
    assert out.sum() > 100 and (fp.numpy()[out] == 0).all()
    between = (rsq > np.float32(2.4) ** 2) & ~out
    assert between.sum() > 100 and (fp.numpy()[between] != 0).all()


@pytest.fixture(scope="module")
def golden():
    """validation/ljrf_golden: the data file through the port's reader, the
    reference binary's forces by id and its PotEng."""
    df = pio.read_data(os.path.join(GOLDEN, "charged.data"),
                       atom_style="charge")
    ref = {}
    with open(os.path.join(GOLDEN, "dump.ref")) as fh:
        lines = fh.read().splitlines()
    for line in lines[lines.index("ITEM: ATOMS id fx fy fz") + 1:]:
        t = line.split()
        ref[int(t[0])] = np.asarray([float(v) for v in t[1:4]])
    with open(os.path.join(GOLDEN, "log.ref")) as fh:
        log = fh.read().splitlines()
    row = log[[i for i, s in enumerate(log) if s.split() == ["Step",
                                                            "PotEng"]][0] + 1]
    pe = float(row.split()[1])
    pair = pconfig.LJCutRFParams.create(cut_lj=2.2, cut_coul=2.2,
                                        epsilon=0.8, sigma=1.0, eps_rf=80.0)
    cfg = pconfig.SceneConfig(
        box=df.box(periodic=(True, True, True)), masses=tuple(df.masses),
        pair=pair, dt=0.002,
        capacity=pconfig.Capacity(n_max=df.natoms, cell_capacity=48),
        skin=0.3)
    st = pinit_state(cfg, df.x, types=df.types, tags=df.tags, q=df.q,
                     device=CPU)
    return cfg, st, ref, pe


def test_golden_forces_match_lammps(golden):
    """The 220-atom charged box through the port's setup (the pair kernel's
    plain version on a 3 x 3 x 3 periodic grid): every force within 5e-5
    * max|f| of the fork's binary (validation/run_ljrf_golden.py's bar);
    the pair sweep's forces too."""
    cfg, st, ref, _ = golden
    assert float(st.q.abs().sum()) > 50.0
    out = psetup(cfg, st)
    assert make_geometry(cfg).dims == (3, 3, 3)
    scale = max(np.linalg.norm(f) for f in ref.values())
    pf, _ = compute_forces(cfg, make_grid_spec(cfg), st)
    for f, tag, alive in ((out.f, out.tag, out.alive),
                          (pf.f, st.tag, st.alive)):
        got = {int(t): f[i].numpy() for i, t in enumerate(tag.tolist())
               if bool(alive[i])}
        assert set(got) == set(ref)
        err = max(np.abs(got[t] - ref[t]).max() for t in ref)
        assert err <= 5e-5 * scale, (err, scale)


def test_golden_energy_matches_lammps(golden):
    """Thermo's pe per atom (evdwl + ecoul through the pair sweep) equals
    log.ref's PotEng (thermo normalised per atom in LJ units) within
    1e-5."""
    from obmd_tpu_torch.observe import make_thermo_fn
    cfg, st, _, pe = golden
    t = make_thermo_fn(cfg)(st)
    got = float(t.pe) / int(t.natoms)
    assert abs(got - pe) <= 1e-5 * abs(pe), (got, pe)


def _usher_configs(etarget, nattempt=40, k=16):
    """The charged two-type law in a small open box, both packages."""
    LX, L, BUF = 12.0, 6.0, 2.5
    out = []
    for cm, Box, Region in ((jconfig, JBox, JRegion),
                            (pconfig, PBox, PRegion)):
        box = Box((0.0, 0.0, 0.0), (LX, L, L), (False, True, True))
        r5 = Region((0.0, 0.0, 0.0), (BUF, L, L))
        r6 = Region((LX - BUF, 0.0, 0.0), (LX, L, L))
        deg = Region((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
        pair = cm.LJCutRFParams.create(
            cut_lj=2.5, cut_coul=2.5, ntypes=2,
            epsilon=pscenes.LJRF_EPSILON, sigma=pscenes.LJRF_SIGMA,
            eps_rf=80.0)
        ob = cm.ObmdParams(ntype=0, nfreq=1, seed=2, pxx=1.0, alpha=0.7,
                           tau=0.02, nbuf=50.0, region1=r5, region2=r6,
                           region3=deg, region4=deg, region5=r5, region6=r6,
                           buffer_size=BUF,
                           usher=cm.UsherParams(etarget=etarget,
                                                nattempt=nattempt),
                           insert_kmax=k)
        out.append(cm.SceneConfig(box=box, masses=(1.0, 1.5), pair=pair,
                                  dt=0.005,
                                  capacity=cm.Capacity(n_max=512,
                                                       cell_capacity=44),
                                  obmd=ob, skin=0.4, force_path="cellpad"))
    return out, (LX, L, BUF)


def _charged_subsets(r, rho, lo, hi, n_invalid):
    """A uniform subset at density rho, ion_sites' types and charges, the
    last n_invalid rows invalid, in both packages' Subset classes."""
    b = int(rho * np.prod(np.subtract(hi, lo))) + n_invalid
    xs = r.uniform(lo, hi, (b, 3)).astype(np.float32)
    types, q = pscenes.ion_sites(b)
    q = q.astype(np.float32)
    valid = np.ones(b, bool)
    valid[b - n_invalid:] = False
    j = JSubset(idx=jnp.zeros((b,), jnp.int32), x=jnp.asarray(xs),
                type=jnp.asarray(types), q=jnp.asarray(q),
                valid=jnp.asarray(valid), overflow=jnp.zeros((), bool))
    p = PSubset(x=torch.from_numpy(xs), type=torch.from_numpy(types),
                valid=torch.from_numpy(valid),
                overflow=torch.zeros((), dtype=torch.bool),
                q=torch.from_numpy(q))
    return j, p


@pytest.mark.parametrize("case", ["gas", "dense"])
def test_usher_ljrf_matches_pallas(case):
    """The plain lj/cut/rf search (neutral type-0 trials against charged
    two-type subsets) against usher_search_pallas: verdicts equal on
    margin-robust candidates, accepted positions within 2e-3, >= 6 checked;
    the rows are the lj rows against each subset atom's type, eshift 0,
    under the launch record usher_search_ljrf."""
    rho, etarget, seed = {"gas": (0.45, -1.5, 3),
                          "dense": (0.8442, -5.5, 5)}[case]
    (jcfg, pcfg), (LX, L, BUF) = _usher_configs(etarget)
    r = np.random.default_rng(seed)
    pad = 2.5 + 0.4
    jl, pl = _charged_subsets(r, rho, [0.0, 0.0, 0.0], [BUF + pad, L, L], 7)
    jr, pr = _charged_subsets(r, rho, [LX - BUF - pad, 0.0, 0.0], [LX, L, L],
                              7)
    k = jcfg.obmd.insert_kmax
    o = jcfg.obmd
    cl = np.array(o.region5.sample_uniform(
        jnp.asarray(r.random((k, 3), dtype=np.float32))))
    cr = np.array(o.region6.sample_uniform(
        jnp.asarray(r.random((k, 3), dtype=np.float32))))
    rp, ra, _ = (np.asarray(t) for t in usher_search_pallas(
        jcfg, jl, jr, jnp.asarray(cl), jnp.asarray(cr), o.region5,
        o.region6))
    po = pcfg.obmd
    ct = torch.zeros((k,), dtype=torch.int32)
    pp, pa, pit = (t.numpy() for t in usher_search_subset_batch(
        pcfg, pl, pr, torch.from_numpy(cl), torch.from_numpy(cr), ct,
        po.region5, po.region6))
    et = float(o.usher.etarget)
    checked = 0
    for side, sub in enumerate((jl, jr)):
        def energy(pos):
            return np.asarray(conservative_energy_force(
                jcfg.pair, sub, jcfg.box, jnp.asarray(pos),
                jnp.zeros((k,), jnp.int32))[0])
        ea, eb = energy(pp[side]), energy(rp[side])
        for i in range(k):
            if abs(ea[i] - et) < 0.3 or abs(eb[i] - et) < 0.3:
                continue
            checked += 1
            assert bool(pa[side, i]) == bool(ra[side, i]), (side, i)
            if pa[side, i]:
                assert np.abs(pp[side, i] - rp[side, i]).max() < 2e-3
    assert checked >= 6, checked
    assert (pit >= 0).all() and (pit <= o.usher.nattempt).all()
    name, table, cut_col = usher_law(pcfg.pair, 0)
    assert name == "usher_search_ljrf" and cut_col == 2
    rows = table[pl.type.numpy()]          # the kernel's lookup by type
    ok = pl.valid.numpy()
    t1 = pl.type.numpy() == 1
    s6 = 0.95 ** 6
    np.testing.assert_allclose(rows[ok & t1, 0], np.float32(
        4.0 * 0.8 * s6 * s6))
    np.testing.assert_allclose(rows[ok & ~t1, 0], np.float32(4.0))
    assert (rows[:, 2] == 2.5).all() and (table[:, 3] == 0.0).all()
    assert (table[2:] == 0.0).all()


def test_charge_and_type_through_converter_and_relayout():
    """A two-type charged state: the converter carries q and type both ways
    bit for bit; layout_build and four epochs of relayout_incremental with
    relayout_flags (has_charge, has_types: as the JAX engine's flags;
    has_mol_com, the port's own, off outside molecule mode) give
    JAX's slots, tags, types and charges exactly, the last epoch with a
    small mover budget so that movers stay put."""
    pcfg, x, v, types, q = charged_start()
    jcfg = to_jax(pcfg)
    flags = relayout_flags(pcfg)
    jflags = j_relayout_flags(jcfg)
    assert {k: flags[k] for k in jflags} == jflags
    assert set(flags) - set(jflags) == {"has_mol_com"}
    assert flags["has_charge"] and flags["has_types"]
    assert not flags["has_mol_com"]
    jst = jinit_state(jcfg, x, v=v, types=types, q=q)
    pst = pinit_state(pcfg, x, v=v, types=types, q=q, device=CPU)
    jd = jax_arrays(jst)
    back = convert.to_arrays(convert.from_arrays(jd, device=CPU))
    for k in jd:
        assert np.array_equal(np.asarray(back[k]), jd[k]), k
    jg, pg = j_make_geometry(jcfg), make_geometry(pcfg)
    jst = jcp.layout_build(jg, jcfg.box, jst)
    pst = pcp.layout_build(pg, pcfg.box, pst)
    fields = ("x", "tag", "alive", "type", "q", "v")
    r = np.random.default_rng(9)
    for m_max in (0, 0, 0, 24):
        jd, pd = jax_arrays(jst), convert.to_arrays(pst)
        for k in fields:
            assert np.array_equal(pd[k], jd[k]), k
        x = np.asarray(jst.x) + r.uniform(-1.5, 1.5, jst.x.shape) \
            * (r.uniform(size=(jst.x.shape[0], 1)) < 0.3)
        x = np.array(jcfg.box.wrap(jnp.asarray(x, jnp.float32)))
        x[:, 0] = np.clip(x[:, 0], 0.01, jcfg.box.hi[0] - 0.01)
        jst = jcp.relayout_incremental(
            jg, jcfg.box, jst.replace(x=jnp.asarray(x)), m_max=m_max,
            **j_relayout_flags(jcfg))
        pst = pcp.relayout_incremental(
            pg, pcfg.box, pst.replace(x=torch.from_numpy(x)), m_max=m_max,
            **flags)
    jd, pd = jax_arrays(jst), convert.to_arrays(pst)
    for k in fields:
        assert np.array_equal(pd[k], jd[k]), k
    assert int(pst.nbrs.overflow) > 0
    live = pd["alive"]
    by_tag = dict(zip(pd["tag"][live].tolist(),
                      zip(pd["type"][live].tolist(), pd["q"][live].tolist())))
    want = dict(zip(range(1, len(types) + 1),
                    zip(types.tolist(), np.float32(q).tolist())))
    assert by_tag == want


def test_charge_data_file_round_trip(tmp_path):
    """atom_style charge (id type q x y z): the golden file reads the same
    through both packages; the port's write_data reads back through JAX's
    reader and its own, field for field."""
    path = os.path.join(GOLDEN, "charged.data")
    want = jio.read_data(path, atom_style="charge")
    got = pio.read_data(path, atom_style="charge")
    assert got.q is not None and got.natoms == 220
    for f in dataclasses.fields(got):
        assert np.array_equal(np.asarray(getattr(got, f.name)),
                              np.asarray(getattr(want, f.name))), f.name
    back = tmp_path / "port.data"
    pio.write_data(str(back), got, atom_style="charge")
    for reader in (jio.read_data, pio.read_data):
        again = reader(str(back), atom_style="charge")
        for f in dataclasses.fields(got):
            assert np.array_equal(np.asarray(getattr(again, f.name)),
                                  np.asarray(getattr(want, f.name))), f.name
