"""The Hopper pair kernel's tile plan (forces/pair_kernel.TilePlan) on every
geometry the port runs, at full size, and on the small geometries of the
other tests/test_torch_*.py files.  No state is built: the plan depends on
the layout only.

For each geometry: the tiles cover every real cell exactly once; each
tile's staged stencil holds every neighbour cell `_neighbor_columns` gives
for each of its cells, and no cell twice; the worst-case shared memory (every
staged cell at the storage cap) stays within the plan's budget."""
import collections

import numpy as np
import pytest
import torch

from obmd_tpu_torch import scenes
from obmd_tpu_torch.config import Box
from obmd_tpu_torch.engine_cellpad import make_geometry
from obmd_tpu_torch.forces.pair_kernel import (N_SMS, SMEM_BUDGET, PadGeometry,
                                               TilePlan, _neighbor_columns)


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
    return TilePlan.of(GEOMETRIES[request.param]())


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
    cells = plan.staged_max
    words = -(-plan.geom.cap // 32)
    # a float4 of every staged slot, the per-cell ints and mask words, the
    # tile cells' prefix
    assert plan.smem_bytes == (cells * plan.geom.cap * 16 + cells * 20
                               + cells * words * 4
                               + (int(np.prod(plan.tile)) + 1) * 4)


def test_small_grids_spread_over_the_card():
    """The 7 x 1 x 1 box's few tiles split their atoms over several blocks
    each, so that it does not run on a few multiprocessors; a full-size
    grid has tiles enough and is not split."""
    box = TilePlan.of(GEOMETRIES["near_box_cap112"]())
    assert box.split > 1 and box.n_blocks >= 4 * len(box.tiles())
    big = TilePlan.of(GEOMETRIES["obmd_dpd_cap15"]())
    assert big.split == 1 and big.n_blocks >= 2 * N_SMS
