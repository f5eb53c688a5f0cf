"""The USHER kernel's cell grid and its binned algorithm on the CPU.

The Hopper kernel (csrc/usher_kernel.cu) bins each buffer subset on a
cell grid (forces/usher_kernel.UsherGrid) and evaluates a candidate
against the atoms of the 27 cells around it.  These tests hold the grid
rule without a card:

- the plan of every configuration the port searches (the four USHER paths
  at full size, and the small scenes of the USHER tests): every cell side
  at least the law's cut, x covering the insertion region widened by pad,
  y and z covering the box, no cell twice in a stencil;
- usher_energy_binned_plain (the algorithm in PyTorch) against the
  all-pairs _batched_energy_force for the dpd, lj, shifted lj and lj/cut/rf
  laws, on random subsets with invalid rows, positions within 0.05 of the
  periodic faces and the region's x ends, periodic axes of 1 and 2 cells
  and a cell crowded to 4x the mean: every atom within the cutoff is
  visited, E within 1e-5 relative (the same pairs summed in another order)
  and F within 1e-4 x max|F|;
- usher_search_binned_plain against the JAX package's usher_search_pallas
  in interpret mode, on margin-robust candidates (|E - etarget| >= 0.3 at
  both final positions, as tests/test_torch_usher.py compares): verdicts
  equal, accepted positions within 2e-3.

Every input comes from a fixed numpy seed."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import config as jconfig
from obmd_tpu.forces.pallas_usher import usher_search_pallas
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.geometry import RegionBlock as JRegion
from obmd_tpu.obmd.subset import Subset as JSubset
from obmd_tpu.obmd.subset import conservative_energy_force
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.forces.usher_kernel import (MAX_CELLS, UsherGrid,
                                                UsherPlan, bin_rows, usher_law,
                                                usher_energy_binned_plain,
                                                usher_search_binned_plain)
from obmd_tpu_torch.geometry import Box as PBox
from obmd_tpu_torch.geometry import RegionBlock as PRegion
from obmd_tpu_torch.obmd.subset import Subset as PSubset
from obmd_tpu_torch.obmd.subset import _batched_energy_force

# per law: the pair style in a package's config module, the box, the
# insertion buffer's width, the skin, the subset density, etarget, masses
LAWS = {
    "dpd": dict(pair=lambda cm, a0=60.0: cm.DPDParams.create(
        temp=1.0, cutoff=1.0, seed=1, a0=a0, gamma=4.5),
        box=(8.0, 4.0, 4.0), thin=(1.5, 2.5), buf=1.6, skin=0.3, rho=3.0,
        etarget=12.0, masses=(1.0,)),
    "lj": dict(pair=lambda cm: cm.LJCutParams.create(
        cutoff=2.5, epsilon=1.0, sigma=1.0),
        box=(12.0, 6.0, 6.0), thin=(3.0, 5.5), buf=2.5, skin=0.4,
        rho=0.8442, etarget=-5.6354, masses=(1.0,)),
    "lj_shift": dict(pair=lambda cm: cm.LJCutParams.create(
        cutoff=2.5, epsilon=1.0, sigma=1.0, shift=True),
        box=(12.0, 6.0, 6.0), thin=(3.0, 5.5), buf=2.5, skin=0.4,
        rho=0.8442, etarget=-5.6354, masses=(1.0,)),
    "ljrf": dict(pair=lambda cm: cm.LJCutRFParams.create(
        cut_lj=2.5, cut_coul=2.5, ntypes=2, epsilon=pscenes.LJRF_EPSILON,
        sigma=pscenes.LJRF_SIGMA, eps_rf=80.0),
        box=(12.0, 6.0, 6.0), thin=(3.0, 5.5), buf=2.5, skin=0.4,
        rho=0.8442, etarget=-5.5, masses=(1.0, 1.5)),
}


def _configs(law, box=None, nattempt=40, k=16, etarget=None, **pair):
    """The law's open scene in both packages' config classes (JAX, port);
    `pair` overrides the law's coefficients (a0 for dpd)."""
    c = LAWS[law]
    etarget = c["etarget"] if etarget is None else etarget
    lx, ly, lz = box or c["box"]
    buf = c["buf"]
    out = []
    for cm, Box, Region in ((jconfig, JBox, JRegion),
                            (pconfig, PBox, PRegion)):
        b = Box((0.0, 0.0, 0.0), (lx, ly, lz), (False, True, True))
        r5 = Region((0.0, 0.0, 0.0), (buf, ly, lz))
        r6 = Region((lx - buf, 0.0, 0.0), (lx, ly, lz))
        deg = Region((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
        ob = cm.ObmdParams(ntype=0, nfreq=1, seed=2, pxx=1.0, alpha=0.7,
                           tau=0.02, nbuf=50.0, region1=r5, region2=r6,
                           region3=deg, region4=deg, region5=r5, region6=r6,
                           buffer_size=buf,
                           usher=cm.UsherParams(etarget=etarget,
                                                nattempt=nattempt),
                           insert_kmax=k)
        out.append(cm.SceneConfig(box=b, masses=c["masses"],
                                  pair=c["pair"](cm, **pair), dt=0.005,
                                  capacity=cm.Capacity(n_max=512,
                                                       cell_capacity=44),
                                  obmd=ob, skin=c["skin"],
                                  force_path="cellpad"))
    return out


def _usher_cut(cfg):
    _, table, cut_col = usher_law(cfg.pair, int(cfg.obmd.ntype))
    return float(table[:, cut_col].max())


def _pad(cfg):
    return cfg.pair.max_cut + cfg.skin


def _gaussian(cfg):
    return dataclasses.replace(cfg, pair=dataclasses.replace(
        cfg.pair, gaussian_noise=True))


GRID_CONFIGS = {
    # the four USHER paths at full size (OBMD_DPD, its gaussian-noise path
    # A, the open LJ and charged fluids), without states
    "obmd_dpd_9": lambda: pscenes.obmd_dpd_config(scale=9),
    "obmd_dpd_9_gaussian": lambda: _gaussian(pscenes.obmd_dpd_config(
        scale=9)),
    "obmd_lj": lambda: pscenes.obmd_lj_config(),
    "obmd_ljrf": lambda: pscenes.obmd_ljrf_config(),
    # the small scenes of tests/test_torch_usher*.py and of this file
    "usher_toy": lambda: _configs("dpd")[1],
    "usher_deck": lambda: _configs("dpd", box=(12.0, 11.198, 11.198))[1],
    "usher_dpd_thin": lambda: _configs("dpd", box=(8.0, 1.5, 2.5))[1],
    "usher_lj": lambda: _configs("lj")[1],
    "usher_lj_thin": lambda: _configs("lj", box=(12.0, 3.0, 5.5))[1],
    "usher_ljrf": lambda: _configs("ljrf")[1],
}


@pytest.mark.parametrize("name", sorted(GRID_CONFIGS))
def test_grid_rule(name):
    """Each side's grid: cell sides at least the cut on every axis, x
    covering the region widened by pad, y and z the box, at most MAX_CELLS
    cells, and every cell's stencil free of repeats (27 cells where each
    axis has 3 or more)."""
    cfg = GRID_CONFIGS[name]()
    o = cfg.obmd
    cut = _usher_cut(cfg)
    pad = _pad(cfg)
    plan = UsherPlan.of(cfg, o.region5, o.region6)
    box = cfg.box
    for region, grid in zip((o.region5, o.region6), plan.grids):
        assert grid == UsherGrid.of(cfg, region, pad)
        assert all(h >= cut for h in grid.side), (grid.side, cut)
        assert grid.n_cells <= MAX_CELLS
        assert grid.periodic == (False, True, True)
        top = [lo + n * h for lo, n, h in zip(grid.lo, grid.cells,
                                              grid.side)]
        tol = 1e-5 * max(box.lengths)
        assert grid.lo[0] <= region.lo[0] - pad + tol
        assert top[0] >= region.hi[0] + pad - tol
        for ax in (1, 2):
            assert grid.lo[ax] == box.lo[ax]
            assert abs(top[ax] - box.hi[ax]) <= tol
        for a in range(3):
            inv = np.float32(grid.inv[a])
            assert abs(float(inv) * grid.side[a] - 1.0) < 1e-6
        per_axis = [min(n, 3) for n in grid.cells]
        for c in range(grid.n_cells):
            c3 = (c % grid.cells[0], (c // grid.cells[0]) % grid.cells[1],
                  c // (grid.cells[0] * grid.cells[1]))
            cells = grid.stencil_cells(c3)
            assert len(set(cells)) == len(cells), (c3, cells)
            assert c in cells
            want = int(np.prod([min(per_axis[0], 1 + (0 < c3[0])
                                    + (c3[0] < grid.cells[0] - 1))]
                               + per_axis[1:]))
            assert len(cells) == want, (c3, len(cells), want)
    if name.startswith("obmd_dpd_9"):
        assert plan.grids[0].cells == (48, 11, 11)
    if name in ("obmd_lj", "obmd_ljrf"):
        assert plan.grids[0].cells == (15, 9, 9)


def _subset(r, cfg, n, n_invalid, ntypes):
    """n atoms uniform over the box (a few within 0.02 outside the
    periodic faces, as atoms drift between wraps), a seeded n_invalid of
    them invalid, types 0/1 at random for two-type laws."""
    lx, ly, lz = cfg.box.lengths
    xs = r.uniform([0.0, 0.0, 0.0], [lx, ly, lz], (n, 3))
    edge = r.choice(n, n // 10, replace=False)
    xs[edge, 1] = np.where(r.random(edge.size) < 0.5,
                           r.uniform(-0.02, 0.05, edge.size),
                           ly - r.uniform(-0.02, 0.05, edge.size))
    valid = np.ones(n, bool)
    valid[r.choice(n, n_invalid, replace=False)] = False
    types = (r.random(n) < 0.3).astype(np.int32) if ntypes > 1 \
        else np.zeros(n, np.int32)
    return xs.astype(np.float32), types, valid


def _psub(xs, types, valid):
    return PSubset(x=torch.from_numpy(xs), type=torch.from_numpy(types),
                   valid=torch.from_numpy(valid),
                   overflow=torch.zeros((), dtype=torch.bool))


def _positions(r, region, k, near_faces):
    lo, hi = np.asarray(region.lo), np.asarray(region.hi)
    if not near_faces:
        return (lo + r.random((k, 3)) * (hi - lo)).astype(np.float32)
    u = r.uniform(0.0, 0.05, (k, 3))
    side = r.random((k, 3)) < 0.5
    return np.where(side, lo + u, hi - u).astype(np.float32)


SCENES = ("random", "faces", "thin", "crowded")


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("law", sorted(LAWS))
def test_binned_energy_matches_all_pairs(law, scene):
    c = LAWS[law]
    box = (c["box"][0],) + c["thin"] if scene == "thin" else None
    cfg = _configs(law, box=box)[1]
    o = cfg.obmd
    ntypes = cfg.pair.ntypes
    cut = _usher_cut(cfg)
    r = np.random.default_rng(11 + SCENES.index(scene))
    n = int(c["rho"] * np.prod(cfg.box.lengths))
    xs, types, valid = _subset(r, cfg, n, n // 3, ntypes)
    checked = 0
    for region in (o.region5, o.region6):
        grid = UsherGrid.of(cfg, region, _pad(cfg))
        pos = _positions(r, region, 16, scene == "faces")
        if scene == "crowded":
            # move 4x the mean count of valid atoms from elsewhere into the
            # first position's cell: it holds at least 4x the mean
            c3 = grid.cell3(torch.from_numpy(pos[:1]))[0].numpy()
            cell_lo = np.asarray(grid.lo) + c3 * np.asarray(grid.side)
            mean = valid.sum() / np.prod(cfg.box.lengths) \
                * np.prod(grid.side)
            far = np.flatnonzero(valid & (np.abs(xs[:, 0] - pos[0, 0])
                                          > 2 * cut))
            move = r.choice(far, int(np.ceil(4 * mean)), replace=False)
            xs[move] = (cell_lo + r.random((move.size, 3))
                        * np.asarray(grid.side)).astype(np.float32)
        sub = _psub(xs, types, valid)
        if scene == "crowded":
            cid = grid.cell_id(grid.cell3(sub.x[sub.valid]))
            crowd = grid.cell_id(grid.cell3(torch.from_numpy(pos[:1])))
            assert int((cid == crowd).sum()) >= 4 * mean
        p = torch.from_numpy(pos)
        eb, fb = usher_energy_binned_plain(cfg, grid, sub, p)
        ct = torch.zeros((1, p.shape[0]), dtype=torch.int32)
        ea, fa = _batched_energy_force(cfg.pair, sub.x[None],
                                       sub.type[None], sub.valid[None],
                                       p[None], ct, box=cfg.box)
        ea, fa = ea[0], fa[0]
        # the grid rule: every valid atom within the cutoff is visited
        d = cfg.box.min_image(p[:, None, :] - sub.x[None, :, :])
        within = sub.valid[None, :] & ((d * d).sum(-1) < cut * cut)
        rows, start = bin_rows(grid, sub)
        for kk, c3 in enumerate(grid.cell3(p)):
            seen = set()
            for cc in grid.stencil_cells(c3.tolist()):
                seen.update(rows[start[cc]:start[cc + 1]].tolist())
            need = set(torch.nonzero(within[kk]).flatten().tolist())
            assert need <= seen, (kk, sorted(need - seen))
            checked += len(need)
        np.testing.assert_allclose(eb.numpy(), ea.numpy(), rtol=1e-5,
                                   atol=1e-5)
        fmax = float(fa.abs().max())
        assert float((fb - fa).abs().max()) <= 1e-4 * fmax, fmax
    assert checked > 0


# the searches against the TPU kernel: (law, box, subset density, K,
# nattempt, seed, overrides); "dpd_deck" is the OBMD_DPD law and gate
# (a0 209.6, etarget 31.03) on a rho = 3 subset of its 11.198^2
# cross-section
SEARCHES = {
    "dpd": ("dpd", None, 3.0, 16, 10, 3, {}),
    "dpd_deck": ("dpd", (12.0, 11.198, 11.198), 3.0, 16, 40, 8,
                 dict(a0=209.6, etarget=31.03)),
    "lj_gas": ("lj", None, 0.45, 16, 40, 3, dict(etarget=-1.5)),
    "lj_dense": ("lj_shift", None, 0.8442, 16, 40, 5, {}),
    "ljrf": ("ljrf", None, 0.45, 16, 40, 3, dict(etarget=-1.5)),
}


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_binned_search_matches_pallas(case):
    law, box, rho, k, nattempt, seed, over = SEARCHES[case]
    jcfg, pcfg = _configs(law, box=box, nattempt=nattempt, k=k, **over)
    r = np.random.default_rng(seed)
    n = int(rho * np.prod(pcfg.box.lengths))
    xs, types, valid = _subset(r, pcfg, n, n // 3, pcfg.pair.ntypes)
    jsub = JSubset(idx=jnp.zeros((n,), jnp.int32), x=jnp.asarray(xs),
                   type=jnp.asarray(types), q=jnp.zeros((n,), jnp.float32),
                   valid=jnp.asarray(valid), overflow=jnp.zeros((), bool))
    psub = _psub(xs, types, valid)
    o = pcfg.obmd
    cl = _positions(r, o.region5, k, False)
    cr = _positions(r, o.region6, k, False)
    jo = jcfg.obmd
    rp, ra, _ = (np.asarray(t) for t in usher_search_pallas(
        jcfg, jsub, jsub, jnp.asarray(cl), jnp.asarray(cr), jo.region5,
        jo.region6))
    pp, pa, pit = (t.numpy() for t in usher_search_binned_plain(
        pcfg, psub, psub, torch.from_numpy(cl), torch.from_numpy(cr),
        o.region5, o.region6))
    et = float(o.usher.etarget)
    ct = jnp.zeros((k,), jnp.int32)
    checked = 0
    for side in range(2):
        ea = np.asarray(conservative_energy_force(
            jcfg.pair, jsub, jcfg.box, jnp.asarray(pp[side]), ct)[0])
        eb = np.asarray(conservative_energy_force(
            jcfg.pair, jsub, jcfg.box, jnp.asarray(rp[side]), ct)[0])
        for i in range(k):
            if abs(ea[i] - et) < 0.3 or abs(eb[i] - et) < 0.3:
                continue
            checked += 1
            assert bool(pa[side, i]) == bool(ra[side, i]), (side, i)
            if pa[side, i]:
                assert np.abs(pp[side, i] - rp[side, i]).max() < 2e-3
    assert checked >= 6, checked
    assert pit.dtype == np.int32
    assert (pit >= 0).all() and (pit <= nattempt).all()


def test_ctypes_signature_matches_the_source():
    """The argtypes bound for every entry point follow the C signature
    (OBMD_USHER_ARGS(real) in csrc/usher_kernel.cu, real float for the
    float32 entry points and double for the _f64 ones): a pointer for each
    pointer, c_int, c_longlong and c_float or c_double for the scalars, in
    order."""
    import ctypes
    import re
    from obmd_tpu_torch import _build
    src = (_build.CSRC / "usher_kernel.cu").read_text()
    body = src[src.index("#define OBMD_USHER_ARGS(real)"):]
    body = body[:body.index("#define OBMD_USHER_CALL")]
    body = body.replace("\\", " ").replace("#define OBMD_USHER_ARGS(real)",
                                            "")
    for real, ctype, names in (
            ("float", ctypes.c_float,
             ("usher_search", "usher_search_lj", "usher_search_ljrf",
              "usher_search_dpdext")),
            ("double", ctypes.c_double,
             ("usher_search_f64", "usher_search_lj_f64",
              "usher_search_ljrf_f64", "usher_search_dpdext_f64"))):
        want = []
        for arg in re.sub(r"\breal\b", real, body).split(","):
            decl = " ".join(arg.split())
            if "*" in decl:
                want.append(ctypes.c_void_p)
            elif re.match(r"long long \w+$", decl):
                want.append(ctypes.c_longlong)
            elif re.match(r"int \w+$", decl):
                want.append(ctypes.c_int)
            elif re.match(rf"{real} \w+$", decl):
                want.append(ctype)
            else:
                raise AssertionError(decl)
        assert len(want) == 32
        for name in names:
            assert list(_build.KERNELS[name].argtypes) == want, name


def test_max_cells_fit_shared_memory():
    """bin_count's copy of one side's counts (MAX_CELLS ints) and its static
    shared arrays (warp_tot, one int per warp, and the last-block flag) fit
    the default 48 KB a block may take without opting in, MAX_CELLS is the
    source's kMaxCells, and a grid too fine for it is coarsened to at most
    MAX_CELLS cells with every side still at least the cut."""
    import re
    from obmd_tpu_torch import _build
    from obmd_tpu_torch.forces.usher_kernel import _grid
    src = (_build.CSRC / "usher_kernel.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    static, threads = int(const("kBinStatic")), int(const("kBinThreads"))
    assert const("kSmemDefault") == "48 * 1024"
    assert const("kMaxCells") == "(kSmemDefault - kBinStatic) / 4"
    assert (48 * 1024 - static) // 4 == MAX_CELLS
    assert 4 * (threads // 32) + 16 <= static
    assert 4 * MAX_CELLS + static <= 48 * 1024
    box = PBox(lo=(0.0, 0.0, 0.0), hi=(40.0, 80.0, 80.0))
    region = PRegion(lo=(5.0, 0.0, 0.0), hi=(35.0, 80.0, 80.0))
    grid = _grid(box, 1.0, region, 1.3)
    assert 32.6 * 80 * 80 > MAX_CELLS >= grid.n_cells
    assert all(h >= 1.0 for h in grid.side)
