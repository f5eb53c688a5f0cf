"""The nlist engine's neighbor structures against the JAX package's
(obmd_tpu/neighbors.py, obmd_tpu/obmd/subset.py), on an open-x box and a
periodic one of the OBMD_DPD fluid's density with dead slots among the
live: the full rebuild, the incremental table update (with mover and
conflict handling, and the movers overflow that sets force_rebuild), the
new atoms' rows from the buffer subsets appended to the list, the
table-driven insertion patch, and the rebuild decision with its counter.

Every integer output is held exactly: the table, the cells, the Verlet
rows (entry for entry, so as sets too), the counts, the flags and the
overflow counters."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import neighbors as jn
from obmd_tpu.cells import GridSpec as JGridSpec
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.geometry import RegionBlock as JRegion
from obmd_tpu.obmd import subset as jsub
from obmd_tpu_torch import neighbors as pn
from obmd_tpu_torch.cells import GridSpec
from obmd_tpu_torch.geometry import Box, RegionBlock
from obmd_tpu_torch.obmd import subset as psub

CUT, SKIN, CAP, K = 1.0, 0.39, 24, 72
N_MAX = 2600
BOXES = {"open_x": (False, True, True), "periodic": (True, True, True)}
HI = (14.0, 7.0, 7.0)


class _Stub:
    """What region_subset reads of a state."""

    def __init__(self, x, alive, lib):
        self.x, self.alive = x, alive
        n = x.shape[0]
        if lib is torch:
            self.type = torch.zeros((n,), dtype=torch.int32)
            self.q = torch.zeros((n,))
        else:
            self.type = jnp.zeros((n,), jnp.int32)
            self.q = jnp.zeros((n,), jnp.float32)
        self.capacity = n


def params(periodic, movers_max=1024):
    """(JAX, port) NeighborParams of one box."""
    jbox = JBox((0.0, 0.0, 0.0), HI, periodic)
    pbox = Box((0.0, 0.0, 0.0), HI, periodic)
    jp = jn.NeighborParams(spec=JGridSpec.create(jbox, CUT + SKIN, CAP),
                           k_max=K, movers_max=movers_max, cutoff=CUT,
                           skin=SKIN)
    pp = pn.NeighborParams(spec=GridSpec.create(pbox, CUT + SKIN, CAP),
                           k_max=K, movers_max=movers_max, cutoff=CUT,
                           skin=SKIN)
    return jbox, pbox, jp, pp


def start(periodic, seed=3):
    """x [N_MAX, 3] float32 at rho 3 (x strictly inside an open face) and
    alive with a tenth of the slots dead (parked at the box center)."""
    r = np.random.default_rng(seed)
    lo = np.array([0.05 if not periodic[0] else 0.0, 0.0, 0.0])
    hi = np.array(HI) - np.array([0.05 if not periodic[0] else 0.0, 0, 0])
    x = r.uniform(lo, hi, (N_MAX, 3)).astype(np.float32)
    alive = r.uniform(size=N_MAX) > 0.1
    x[~alive] = np.float32(np.array(HI) / 2)
    return x, alive


def both(x, alive):
    return ((jnp.asarray(x), jnp.asarray(alive)),
            (torch.from_numpy(x), torch.from_numpy(alive)))


def assert_same(js, ps, fields=("table", "cell_id", "nlist", "ncount",
                                "tombstone", "force_rebuild", "rebuilds",
                                "overflow", "xref")):
    for k in fields:
        want = np.asarray(getattr(js, k))
        got = getattr(ps, k).numpy()
        if k == "xref":
            assert np.array_equal(got, want), k
            continue
        assert np.array_equal(got, want), (k, np.argwhere(got != want)[:5])
    # the rows as sets, over their valid entries
    for a, b in zip(np.asarray(js.nlist), ps.nlist.numpy()):
        assert set(a[a < N_MAX].tolist()) == set(b[b < N_MAX].tolist())


@pytest.mark.parametrize("box", sorted(BOXES))
def test_full_rebuild_matches_jax(box):
    jbox, pbox, jp, pp = params(BOXES[box])
    x, alive = start(BOXES[box])
    (jx, ja), (px, pa) = both(x, alive)
    js = jn.full_rebuild(jp, jbox, jx, ja)
    ps = pn.full_rebuild(pp, pbox, px, pa)
    assert_same(js, ps)
    nc = ps.ncount.numpy()
    assert nc[alive].min() > 10 and nc.max() <= K and (nc[~alive] == 0).all()
    assert int(ps.overflow) == 0


def test_build_chunks_and_row_overflow():
    """A capacity K below the densest rows drops the farthest-indexed
    candidates alike in both packages and counts them; the chunked build
    (NLIST_CHUNK rows at a time) equals the one-chunk build."""
    jbox, pbox, jp, pp = params(BOXES["open_x"])
    jp = jn.NeighborParams(spec=jp.spec, k_max=24, cutoff=CUT, skin=SKIN)
    pp = pn.NeighborParams(spec=pp.spec, k_max=24, cutoff=CUT, skin=SKIN)
    x, alive = start(BOXES["open_x"])
    (jx, ja), (px, pa) = both(x, alive)
    js = jn.full_rebuild(jp, jbox, jx, ja)
    ps = pn.full_rebuild(pp, pbox, px, pa)
    assert int(ps.overflow) > 0
    assert_same(js, ps)
    old = pn.NLIST_CHUNK
    try:
        pn.NLIST_CHUNK = 700
        chunked = pn.full_rebuild(pp, pbox, px, pa)
    finally:
        pn.NLIST_CHUNK = old
    assert torch.equal(chunked.nlist, ps.nlist)
    assert int(chunked.overflow) == int(ps.overflow)


@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("movers_max", [1024, 16])
def test_update_table_matches_jax(box, movers_max):
    """After a normal displacement of 0.05 (about 200 movers, up to four
    into one cell, so that the conflict rounds resolve them all), eight
    deaths and three births (all into the center cell, where the dead
    slots are parked, so they conflict): the
    table, the cells and force_rebuild equal JAX's; with movers_max 16 the
    movers overflow and force_rebuild is set in both."""
    per = BOXES[box]
    jbox, pbox, jp, pp = params(per, movers_max)
    x, alive = start(per)
    (jx, ja), (px, pa) = both(x, alive)
    js = jn.full_rebuild(jp, jbox, jx, ja)
    ps = pn.full_rebuild(pp, pbox, px, pa)
    r = np.random.default_rng(11)
    x2 = x + r.normal(0.0, 0.05, x.shape).astype(np.float32)
    x2 = np.where(per, np.mod(x2, np.array(HI, np.float32)), x2) \
        .astype(np.float32)
    x2[:, 0] = np.clip(x2[:, 0], 0.01, HI[0] - 0.01)
    alive2 = alive.copy()
    alive2[np.flatnonzero(alive)[:8]] = False
    alive2[np.flatnonzero(~alive)[:3]] = True
    (jx2, ja2), (px2, pa2) = both(x2, alive2)
    ju = jn.update_table(jp, js, jx2, ja2)
    pu = pn.update_table(pp, ps, px2, pa2)
    assert_same(ju, pu, ("table", "cell_id", "force_rebuild"))
    assert bool(pu.force_rebuild) == (movers_max == 16)
    if movers_max == 1024:
        moved = (pu.cell_id != ps.cell_id).sum()
        assert 100 < int(moved) <= 1024
        # every live atom is filed once, in its cell
        t = pu.table[:-1].numpy()
        filed = t[t < N_MAX]
        assert sorted(filed.tolist()) == np.flatnonzero(alive2).tolist()


@pytest.mark.parametrize("box", sorted(BOXES))
def test_insertion_rows_match_jax(box):
    """An insertion of M = 12 atoms into dead slots inside a left buffer
    (4 inactive rows among them): subset_rows from region_subset's buffer
    subset, then apply_new_rows, equal JAX's, with both packages' counts
    and overflow; the table-driven patch_insertions too."""
    per = BOXES[box]
    jbox, pbox, jp, pp = params(per)
    x, alive = start(per)
    (jx, ja), (px, pa) = both(x, alive)
    js = jn.full_rebuild(jp, jbox, jx, ja)
    ps = pn.full_rebuild(pp, pbox, px, pa)
    r = np.random.default_rng(5)
    m, act_n = 12, 8
    region = ((0.0, 0.0, 0.0), (2.5, HI[1], HI[2]))
    dead = np.flatnonzero(~alive)[:act_n]
    pos = r.uniform(region[0], region[1], (m, 3)).astype(np.float32)
    pos[:, 0] = np.clip(pos[:, 0], 0.05, None)
    new_slots = np.full((m,), N_MAX, np.int32)
    new_slots[:act_n] = dead
    x2, alive2 = x.copy(), alive.copy()
    x2[dead] = pos[:act_n]
    alive2[dead] = True
    act = new_slots < N_MAX
    (jx2, ja2), (px2, pa2) = both(x2, alive2)
    # subsets of the pre-insertion state, as the stage takes them
    jsb = jsub.region_subset(None, _Stub(jx, ja, jnp), JRegion(*region),
                             CUT + SKIN, 900)
    psb = psub.region_subset(None, _Stub(px, pa, torch), RegionBlock(*region),
                             CUT + SKIN, 900)
    assert np.array_equal(psb.idx.numpy(), np.asarray(jsb.idx))
    assert np.array_equal(psb.x.numpy(), np.asarray(jsb.x))
    assert bool(psb.overflow) == bool(jsb.overflow) is False
    jr = jsub.subset_rows(jp, jbox, jsb, jnp.asarray(pos),
                          jnp.asarray(new_slots), jnp.asarray(act))
    pr = psub.subset_rows(pp, pbox, psb, torch.from_numpy(pos),
                          torch.from_numpy(new_slots), torch.from_numpy(act))
    row_j = np.where(np.asarray(jr[1]), np.asarray(jr[0]), -1)
    row_p = np.where(pr[1].numpy(), pr[0].numpy(), -1)
    assert np.array_equal(row_p, row_j) and int(pr[2]) == int(jr[2])
    ja_ = jn.apply_new_rows(jp, js, jx2, jnp.asarray(new_slots), *jr)
    pa_ = pn.apply_new_rows(pp, ps, px2, torch.from_numpy(new_slots), *pr)
    assert_same(ja_, pa_, ("nlist", "ncount", "xref", "overflow",
                           "force_rebuild"))
    assert int(pa_.ncount.sum()) > int(ps.ncount.sum())
    jt = jn.patch_insertions(jp, jbox, js, jx2, ja2, jnp.asarray(new_slots))
    pt = pn.patch_insertions(pp, pbox, ps, px2, pa2,
                             torch.from_numpy(new_slots))
    assert_same(jt, pt, ("table", "cell_id", "nlist", "ncount", "xref",
                         "overflow", "force_rebuild"))


@pytest.mark.parametrize("box", sorted(BOXES))
def test_maybe_rebuild_counter_matches_jax(box):
    """Below half the skin nothing is rebuilt; a displacement past it, or
    force_rebuild, rebuilds with rebuilds counted up and the overflow
    carried, alike in both packages; skin 0 rebuilds every call."""
    per = BOXES[box]
    jbox, pbox, jp, pp = params(per)
    x, alive = start(per)
    (jx, ja), (px, pa) = both(x, alive)
    js = jn.full_rebuild(jp, jbox, jx, ja)
    ps = pn.full_rebuild(pp, pbox, px, pa)
    small = x.copy()
    small[alive, 1] += np.float32(0.19)
    big = x.copy()
    big[np.flatnonzero(alive)[3], 2] += np.float32(0.2)
    for xs, flag, want in ((small, False, 1), (big, False, 2),
                           (x, True, 2)):
        if per[1]:
            xs = np.mod(xs, np.array(HI, np.float32)).astype(np.float32)
        (jxs, _), (pxs, _) = both(xs, alive)
        j0 = js.replace(force_rebuild=jnp.asarray(flag))
        p0 = ps.replace(force_rebuild=torch.tensor(flag))
        assert bool(pn.rebuild_needed(pp, pbox, p0, pxs, pa)) == (want == 2)
        jm = jn.maybe_rebuild(jp, jbox, j0, jxs, ja)
        pm = pn.maybe_rebuild(pp, pbox, p0, pxs, pa)
        assert int(pm.rebuilds) == int(jm.rebuilds) == want
        assert_same(jm, pm)
    jz = jn.NeighborParams(spec=jp.spec, k_max=K, cutoff=CUT, skin=0.0)
    pz = pn.NeighborParams(spec=pp.spec, k_max=K, cutoff=CUT, skin=0.0)
    assert int(pn.maybe_rebuild(pz, pbox, ps, px, pa).rebuilds) == \
        int(jn.maybe_rebuild(jz, jbox, js, jx, ja).rebuilds) == 2
