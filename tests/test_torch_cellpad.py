"""obmd_tpu_torch.cellpad against obmd_tpu.cellpad on a jittered rho = 3
lattice with random movers: layout_build, relayout_incremental,
place_insertions, compact_indices and patch_kernel_caches give exactly the
same slots, tags, alive, kernel caches and counters (positions are moved,
never recomputed, so they are exact too)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import cellpad as jcp
from obmd_tpu.engine_cellpad import make_geometry as j_make_geometry
from obmd_tpu_torch import cellpad as pcp
from obmd_tpu_torch import convert
from obmd_tpu_torch.engine_cellpad import make_geometry as p_make_geometry

from test_torch_support import jax_arrays, lattice_states

LAYOUT = ("x", "v", "f", "type", "tag", "alive", "cell_overflow", "xref",
          "rebuilds", "overflow", "skin_trips", "tag3d", "occ")


def _same(jst, pst, keys=LAYOUT):
    jd, pd = jax_arrays(jst), convert.to_arrays(pst)
    for k in keys:
        assert np.array_equal(np.asarray(pd[k]), jd[k]), k


@pytest.fixture(scope="module", params=[15, 24])
def built(request):
    """Both packages' states after layout_build at filing cap 15 / 24."""
    jcfg, jst, pcfg, pst = lattice_states(scale=0.25, cap=request.param)
    jg, pg = j_make_geometry(jcfg), p_make_geometry(pcfg)
    jst = jcp.layout_build(jg, jcfg.box, jst.replace(x=jcfg.box.wrap(jst.x)))
    pst = pcp.layout_build(pg, pcfg.box, pst.replace(x=pcfg.box.wrap(pst.x)))
    return jcfg, jg, jst, pcfg, pg, pst


def test_layout_build_exact(built):
    jcfg, jg, jst, pcfg, pg, pst = built
    _same(jst, pst)
    assert int(pst.alive.sum()) == int(jnp.sum(jst.alive))


def test_relayout_incremental_exact(built):
    """Random movers (some across x slabs, some wrapped in y/z), some
    deletions, then the movers-only relayout, with and without moving f."""
    jcfg, jg, jst, pcfg, pg, pst = built
    r = np.random.default_rng(5)
    x = np.asarray(jst.x).copy()
    alive = np.asarray(jst.alive).copy()
    live = np.flatnonzero(alive)
    movers = r.choice(live, size=len(live) // 8, replace=False)
    x[movers] += r.uniform(-0.9, 0.9, (len(movers), 3)).astype(np.float32)
    x = np.array(jcfg.box.wrap(jnp.asarray(x)))
    dead = r.choice(live, size=20, replace=False)
    alive[dead] = False
    f = r.normal(0, 1, x.shape).astype(np.float32)
    jst = jst.replace(x=jnp.asarray(x), alive=jnp.asarray(alive),
                      f=jnp.asarray(f))
    pst = pst.replace(x=torch.from_numpy(x), alive=torch.from_numpy(alive),
                      f=torch.from_numpy(f))
    for move_f in (True, False):
        j2 = jcp.relayout_incremental(jg, jcfg.box, jst, move_f=move_f,
                                      has_bonds=False, has_mol=False,
                                      has_charge=False, has_types=False)
        p2 = pcp.relayout_incremental(pg, pcfg.box, pst, move_f=move_f)
        _same(j2, p2)
    # small m_max: movers beyond it stay put and are counted
    j2 = jcp.relayout_incremental(jg, jcfg.box, jst, m_max=32,
                                  has_bonds=False, has_mol=False,
                                  has_charge=False, has_types=False)
    p2 = pcp.relayout_incremental(pg, pcfg.box, pst, m_max=32)
    _same(j2, p2)
    assert int(p2.nbrs.overflow) > 0


def test_place_insertions_and_patch_exact(built):
    """Candidates clustered in a few cells (several per cell, some into
    full cells), the accepted mask mixed."""
    jcfg, jg, jst, pcfg, pg, pst = built
    r = np.random.default_rng(11)
    lo, hi = np.asarray(pcfg.box.lo), np.asarray(pcfg.box.hi)
    centers = r.uniform(lo, hi, (6, 3))
    pos = (centers[r.integers(0, 6, 48)]
           + r.uniform(-0.3, 0.3, (48, 3))).clip(lo, hi - 1e-3)
    pos = pos.astype(np.float32)
    acc = r.uniform(size=48) < 0.8
    js, jl = jcp.place_insertions(jg, jst, jnp.asarray(pos), jnp.asarray(acc))
    ps, pl = pcp.place_insertions(pg, pst, torch.from_numpy(pos),
                                  torch.from_numpy(acc))
    assert np.array_equal(ps.numpy(), np.asarray(js))
    assert np.array_equal(pl.numpy(), np.asarray(jl))
    tags = np.arange(5000, 5048, dtype=np.int32)
    ja = jcp.patch_kernel_caches(jg, jst.nbrs, js, jnp.asarray(tags),
                                 jg.n_slots)
    pa = pcp.patch_kernel_caches(pg, pst.nbrs, ps, torch.from_numpy(tags),
                                 pg.n_slots)
    assert np.array_equal(pa.tag3d.numpy(), np.asarray(ja.tag3d))
    assert np.array_equal(pa.occ.numpy(), np.asarray(ja.occ))


@pytest.mark.parametrize("n,size", [(3000, 100), (3000, 2000), (700, 900)])
def test_compact_indices_exact(n, size):
    r = np.random.default_rng(n + size)
    mask = r.uniform(size=n) < 0.4
    want = np.asarray(jcp.compact_indices(jnp.asarray(mask), size, n))
    got = pcp.compact_indices(torch.from_numpy(mask), size, n).numpy()
    assert np.array_equal(got, want)


def test_skin_check_exact(built):
    jcfg, jg, jst, pcfg, pg, pst = built
    x = np.asarray(jst.x) + np.float32(0.21)
    jst = jst.replace(x=jnp.asarray(x))
    pst = pst.replace(x=torch.from_numpy(x))
    for skin in (0.39, 0.5):
        assert bool(pcp.half_skin_tripped(pcfg.box, skin, pst)) == bool(
            jcp.half_skin_tripped(jcfg.box, skin, jst))
        assert int(pcp.note_skin_check(pcfg.box, skin, pst).nbrs.skin_trips) \
            == int(jcp.note_skin_check(jcfg.box, skin, jst).nbrs.skin_trips)
