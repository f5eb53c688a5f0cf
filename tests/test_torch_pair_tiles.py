"""The Hopper pair kernel's tile plan (forces/pair_kernel.TilePlan) on every
geometry the port runs, at full size, and on the small geometries of the
other tests/test_torch_*.py files.  No state is built: the plan depends on
the layout only.

For each geometry, under the launch the dense body is built for (the
water's): the plan takes the dense body exactly where a cell's fill cap
exceeds a block's threads; every other launch keeps the tiled body; the
tiles cover every real cell exactly
once; each tile's staged (tiled body) or streamed (dense body) stencil holds
every neighbour cell `_neighbor_columns` gives for each of its cells, and no
cell twice; the worst-case shared memory (every staged cell, or every run
of the dense body's ring, at the storage cap) stays within the plan's
budget.  The dense body's first pass, in its plain version, files each
cell's live atoms as a record run in ascending rank."""
import collections
import functools
import os
import tempfile

import numpy as np
import pytest
import torch

from obmd_tpu_torch import scenes
from obmd_tpu_torch.cells import BIG
from obmd_tpu_torch.config import Box
from obmd_tpu_torch.engine_cellpad import make_geometry
from obmd_tpu_torch.forces.pair_kernel import (DENSE_BUILT, DENSE_RING,
                                               N_SMS, SMEM_BUDGET, SMEM_MAX,
                                               THREADS, PadGeometry,
                                               PairCoef, TilePlan,
                                               _neighbor_columns,
                                               dense_records_plain,
                                               dense_run, launch_kind)


def _melt(nx, cap, cut=2.5 + 0.55):
    """lj_melt_scene(nx)'s layout (rho* 0.8442, cut + skin cells)."""
    side = nx * (4.0 / 0.8442) ** (1.0 / 3.0)
    return PadGeometry.create(Box((0.0,) * 3, (side,) * 3, (True,) * 3), cut,
                              cap)


def _capped(cfg, cap):
    return make_geometry(scenes.with_cap(cfg, cap))


def _star(n_stars, cap):
    return _capped(scenes.star_melt_config(scenes.star_box(n_stars),
                                           5 * n_stars), cap)


@functools.lru_cache(maxsize=1)
def _open_star_deck():
    """Path F's config at its production cap, its center tables read from a
    20-star data file in its box (the slab geometry needs only their
    presence)."""
    from obmd_tpu_torch.io.lammps_data import read_data
    lx = scenes.open_star_box(20_000)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stars.data")
        scenes.write_open_star_data(path, 20, 1, hi=(lx, scenes.OPEN_STAR_LYZ,
                                                     scenes.OPEN_STAR_LYZ))
        angle, improper = scenes._star_tables(
            read_data(path, atom_style="molecular"))
    return scenes.open_star_config(lx, 100_000, angle=angle,
                                   improper=improper,
                                   cap=scenes.STAR_PROD_CAP)


def _slab(deck, world):
    """The pad geometry of a `world`-rank slab decomposition (paths L, M)."""
    from obmd_tpu_torch.parallel.slab_decomp import make_slab_geom
    return make_slab_geom(deck, world).pad_geom


GEOMETRIES = {
    # full size: the smoke's paths
    "obmd_dpd_cap24": lambda: make_geometry(scenes.obmd_dpd_config(scale=9)),
    "obmd_dpd_cap15": lambda: _capped(scenes.obmd_dpd_config(scale=9), 15),
    "obmd_dpd_gauss_cap16": lambda: _capped(
        scenes.obmd_dpd_config(scale=9), 16),
    "open_lj_cap44": lambda: make_geometry(scenes.obmd_lj_config()),
    "open_ljrf_cap44": lambda: make_geometry(scenes.obmd_ljrf_config()),
    "film": lambda: make_geometry(scenes.dpd_film_config()),
    "film_y_open": lambda: make_geometry(scenes.dpd_film_config(y_open=True)),
    "star_cap40": lambda: _star(20_000, 40),
    "star_cap24": lambda: _star(20_000, 24),
    "star_cap15": lambda: _star(20_000, 15),
    "tstat_cube_cap28": lambda: make_geometry(scenes.dpd_tstat_config()),
    "near_box_cap112": lambda: make_geometry(scenes.near_box_config()),
    "lj_melt_nx20": lambda: _melt(20, 36),
    "lj_melt_nx40": lambda: _melt(40, 36),
    "chain_nx20": lambda: _melt(20, 18, cut=1.12 + 0.98),
    "open_water_cap150": lambda: make_geometry(scenes.open_water_config()),
    "open_rigid_water_cap150": lambda: make_geometry(
        scenes.open_water_config(rigid=True)),
    "slab_L_4rank_cap27": lambda: _slab(
        scenes.obmd_dpd_config(scale=9, force_path="sweep"), 4),
    "slab_L_1rank_cap26": lambda: _slab(
        scenes.obmd_dpd_config(scale=9, force_path="sweep"), 1),
    "slab_M_4rank_cap17": lambda: _slab(_open_star_deck(), 4),
    "slab_M_1rank_cap17": lambda: _slab(_open_star_deck(), 1),
    # the other tests' small layouts
    "obmd_dpd_scale025_cap15": lambda: _capped(
        scenes.obmd_dpd_config(scale=0.25), 15),
    "obmd_dpd_scale025_cap24": lambda: make_geometry(
        scenes.obmd_dpd_config(scale=0.25)),
    "lj_melt_nx6_cap48": lambda: _melt(6, 48),
    "lj_melt_nx11": lambda: _melt(11, 36),
    "chain_nx7": lambda: _melt(7, 18, cut=1.12 + 0.98),
    "open_lj_small": lambda: make_geometry(scenes.obmd_lj_config(nx=16,
                                                                 ny=9)),
    "star_small_cap15": lambda: _star(307, 15),
    "tstat_small": lambda: make_geometry(scenes.dpd_tstat_config(box_l=6.0)),
}


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def plan(request):
    return TilePlan.of(GEOMETRIES[request.param](), DENSE_BUILT[0])


def _real_cells(geom):
    return set(np.ndindex(*geom.dims))


def _column(geom, cell):
    nx, ny, nz = geom.dims
    b, lane = geom.slot_of_cell((cell[0] * ny + cell[1]) * nz + cell[2])
    return b * geom.lanes + lane


def test_tiles_cover_every_cell_once(plan):
    seen = collections.Counter(c for t in plan.tiles()
                               for c in plan.tile_cells(t))
    assert set(seen) == _real_cells(plan.geom)
    assert set(seen.values()) == {1}
    assert len(plan.tiles()) * plan.split == plan.n_blocks


def test_staged_stencil_holds_every_neighbour_once(plan):
    geom = plan.geom
    icol, cols, oks = _neighbor_columns(geom, torch.device("cpu"))
    row = {int(c): k for k, c in enumerate(icol)}
    cols, oks = cols.numpy(), oks.numpy()
    for t in plan.tiles():
        staged = plan.staged_cells(t)
        assert len(staged) == len(set(staged)) <= plan.staged_max
        have = {_column(geom, c) for c in staged}
        for cell in plan.tile_cells(t):
            k = row[_column(geom, cell)]
            need = set(cols[oks[:, k], k].tolist())
            assert need <= have, (t, cell, sorted(need - have))


def test_shared_memory_within_budget(plan):
    assert plan.smem_bytes <= SMEM_BUDGET
    cap = plan.geom.cap
    if plan.dense:
        # one cell and one block a tile; the ring's record runs of 32 bytes
        # an atom, each thread's mask words of a run, the cell's z and
        # order by z; records and counts in device memory
        run = -(-cap // 8) * 8
        assert plan.tile == (1, 1, 1) and plan.split == 1
        assert plan.n_blocks == plan.geom.n_cells
        assert plan.smem_bytes == (DENSE_RING * run * 32
                                   + -(-run // 32) * THREADS * 4 + run * 8)
        assert plan.scratch_bytes == plan.geom.n_cells * (run * 32 + 4)
        return
    cells = plan.staged_max
    words = -(-cap // 32)
    # a float4 of every staged slot, the per-cell ints and mask words, the
    # tile cells' prefix
    assert plan.smem_bytes == (cells * cap * 16 + cells * 20
                               + cells * words * 4
                               + (int(np.prod(plan.tile)) + 1) * 4)
    assert plan.scratch_bytes == 0


def test_dense_body_where_a_cell_outgrows_the_block(plan):
    """Under the launch it is built for, the plan takes the dense body where
    a cell's fill cap exceeds a block's threads (the water of paths I and
    K), the tiled body elsewhere."""
    assert plan.dense == (plan.geom.fcap > THREADS)


@pytest.mark.parametrize("launch", ["water", "4 channels", "full stencil",
                                    "dpd", "y open"])
def test_dense_body_only_where_built(launch):
    """The water's launch takes the dense body; the same geometry under a
    launch the dense body is not built for (another law or channel count,
    the full-stencil entry point) or with an open y axis keeps the tiled
    body's one-cell tile, which fits an SM and needs no records."""
    cfg = scenes.open_water_config()
    geom = make_geometry(cfg)
    coef = PairCoef.of(geom, cfg.pair, cfg.dt)
    kind = {"water": launch_kind(coef, 2), "4 channels": launch_kind(coef, 4),
            "full stencil": launch_kind(coef, 2, legacy=True),
            "dpd": launch_kind(PairCoef.create(geom, "dpd"), 0),
            "y open": launch_kind(coef, 2)}[launch]
    if launch == "y open":
        geom = geom._replace(periodic_yz=(False, True))
    plan = TilePlan.of(geom, kind)
    assert geom.fcap > THREADS
    assert plan.dense == (launch == "water")
    if launch != "water":
        assert plan.tile == (1, 1, 1) and plan.scratch_bytes == 0
        assert plan.smem_bytes == 27 * geom.cap * 16 + 27 * 20 \
            + 27 * -(-geom.cap // 32) * 4 + 2 * 4
        assert plan.smem_bytes <= SMEM_MAX


def test_dense_records_in_ascending_rank():
    """dense_records_plain on a seeded two-slab layout (p = 8, open x, 2
    types, charges) with dead ranks below occ and a stale-high occ, its
    atoms anywhere in the box as a run leaves atoms wrapped across faces
    between relayouts: each cell's run holds exactly its live ranks below
    min(occ, cap), in ascending rank, with their x, q, tag, type and rank,
    y and z in the cell's frame (within half a box of the cell's centre, a
    whole number of box lengths from the atom's), and zeros past the
    count."""
    r = np.random.default_rng(5)
    geom = PadGeometry.create(Box((0.0,) * 3, (5.0, 4.0, 4.0),
                                  (False, True, True)), 1.0, 40)
    cfg = scenes.open_water_config()
    coef = PairCoef.of(geom, cfg.pair, cfg.dt)
    nb, cap, lanes = geom.n_blocks, geom.cap, geom.lanes
    fld = r.uniform(0.0, 4.0, (nb, coef.n_channels, cap, lanes)) \
        .astype(np.float32)
    fld[:, -1] = r.integers(0, 2, (nb, cap, lanes))
    tag = r.integers(1, 10_000, (nb, cap, lanes)).astype(np.int32)
    dead = r.random((nb, cap, lanes)) < 0.3
    fld[:, 0:3][np.broadcast_to(dead[:, None], fld[:, 0:3].shape)] = BIG
    occ = np.array([30], np.int32)                  # ranks 30.. never read
    pos, aux, count = (t.numpy() for t in dense_records_plain(
        geom, coef, torch.from_numpy(fld), torch.from_numpy(tag),
        torch.from_numpy(occ)))
    run = dense_run(cap)
    assert pos.shape == (geom.n_cells, run, 4) and aux.shape == pos.shape
    for cell in range(geom.n_cells):
        b, lane = geom.slot_of_cell(cell)
        ranks = [k for k in range(min(int(occ[b]), cap))
                 if fld[b, 0, k, lane] < 0.5 * BIG]
        n = len(ranks)
        assert count[cell] == n
        np.testing.assert_array_equal(aux[cell, :n, 2], ranks)
        # (advanced indices apart: the rank axis comes first)
        np.testing.assert_array_equal(pos[cell, :n, 0],
                                      fld[b, 0, ranks, lane])
        for a in (1, 2):
            length = geom.dims[a] * geom.cell_size[a]
            centre = (np.unravel_index(cell, geom.dims)[a] + 0.5) \
                * geom.cell_size[a]
            assert (np.abs(pos[cell, :n, a] - centre) <= length / 2).all()
            turns = (pos[cell, :n, a] - fld[b, a, ranks, lane]) / length
            np.testing.assert_allclose(turns, np.round(turns), atol=1e-6)
        np.testing.assert_array_equal(pos[cell, :n, 3], fld[b, 6, ranks,
                                                              lane])
        np.testing.assert_array_equal(aux[cell, :n, 0], tag[b, ranks, lane])
        np.testing.assert_array_equal(aux[cell, :n, 1],
                                      fld[b, -1, ranks, lane].astype(int))
        assert not pos[cell, n:].any() and not aux[cell, n:].any()


def test_small_grids_spread_over_the_card():
    """The 7 x 1 x 1 box's few tiles split their atoms over several blocks
    each, so that it does not run on a few multiprocessors; a full-size
    grid has tiles enough and is not split."""
    box = TilePlan.of(GEOMETRIES["near_box_cap112"]())
    assert box.split > 1 and box.n_blocks >= 4 * len(box.tiles())
    big = TilePlan.of(GEOMETRIES["obmd_dpd_cap15"]())
    assert big.split == 1 and big.n_blocks >= 2 * N_SMS
