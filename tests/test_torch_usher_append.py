"""The USHER search on appended subsets and on candidates off its grid.

Under `maxattempt` > 1 each round searches the buffer subsets with the
earlier rounds' candidates appended (valid where accepted,
obmd_tpu/obmd/stage.py:367-380); `gaussian` draws and a z set by `rate`,
`global` or `local` can put a candidate anywhere, outside its insertion
region, the kernel's cell grid or the box, and the reference searches it
all the same (its verdict masked afterwards).  The Hopper kernel's
algorithm in PyTorch (forces/usher_kernel.usher_search_binned_plain: the
grid's cells, a candidate off the grid filed into the edge cell of an
open axis and wrapped on a periodic one) is held here, on the CPU, on the
second round of a search whose first round's accepted candidates were
appended, on a candidate set that holds:

- candidates inside their region (the first 12 of 24);
- x up to one cell beyond the grid's either end, and far outside the box;
- y just below the periodic face, z two box lengths and 0.3 beyond it
  (outside the region: the first move that stays outside stops it);
- a NaN and an infinite coordinate;

under the dpd law (etarget > 0) and lj/cut (etarget < 0).

Against the plain version (obmd.subset.usher_search_subset_batch, all
pairs) and the JAX package's own XLA search (usher_search_subset_batch):
accepted flags and iteration counts exactly and positions within 2e-3
(eight steps of float32 summation order under the steep lj law, the bar
of tests/test_torch_usher_grid.py; NaN where the plain version has NaN)
on every candidate whose search is
step-robust (E at least 0.3 from etarget at its start and end position in
both, as tests/test_torch_usher_grid.py compares), and on every candidate
with no atom within the cut (E = 0: taken at iteration 0); and against
the TPU kernel, usher_search_pallas in interpret mode, on the finite
step-robust candidates: verdicts equal, accepted positions within 2e-3.
A thermostat-only law (dpd/tstat) searches with the plain version on any
device and accepts every candidate at iteration 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu.forces.pallas_usher import usher_search_pallas
from obmd_tpu.obmd import subset as jsubset
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch.forces.usher_kernel import (UsherPlan, usher_search,
                                                usher_search_binned_plain)
from obmd_tpu_torch.obmd import stage as pstage
from obmd_tpu_torch.obmd.subset import usher_search_subset_batch

from test_torch_usher_grid import LAWS, _configs, _positions, _psub, _subset

K = 24
ROBUST = 0.3


def off_grid(cfg, grid, region, r):
    """The 12 candidates off the grid, the box or the region."""
    lx, ly, lz = cfg.box.lengths
    top = grid.lo[0] + grid.cells[0] * grid.side[0]
    mid = [0.5 * (a + b) for a, b in zip(region.lo, region.hi)]
    y, z = r.uniform(0.5, ly - 0.5), r.uniform(0.5, lz - 0.5)
    rows = [
        (grid.lo[0] - 0.45 * grid.side[0], y, z),     # within a cell below
        (grid.lo[0] - 0.95 * grid.side[0], y, z),
        (top + 0.3 * grid.side[0], y, z),             # within a cell above
        (top + 0.9 * grid.side[0], y, z),
        (-30.0, y, z), (lx + 40.0, y, z),             # far outside the box
        (mid[0], -0.03, z),                           # below the y face
        (mid[0], y, 2 * lz + z),                      # two periods up
        (mid[0], y, lz + 0.3),                        # outside the region
        (mid[0] + 0.1, y, -0.25),
        (float("nan"), y, z), (mid[0], float("inf"), z)]
    return np.asarray(rows, np.float32)


def jsub_of(sub):
    n = sub.x.shape[0]
    return jsubset.Subset(idx=jnp.zeros((n,), jnp.int32),
                          x=jnp.asarray(sub.x.numpy()),
                          type=jnp.asarray(sub.type.numpy()),
                          q=jnp.zeros((n,), jnp.float32),
                          valid=jnp.asarray(sub.valid.numpy()),
                          overflow=jnp.zeros((), bool))


@pytest.fixture(scope="module", params=["dpd", "lj"])
def second_round(request):
    """(JAX cfg, port cfg, appended subsets, round-two candidates) under
    the dpd law (etarget > 0: a candidate alone is taken) or lj/cut
    (etarget < 0: it is refused)."""
    law = request.param
    jcfg, pcfg = _configs(law, nattempt=8, k=K)
    o = pcfg.obmd
    r = np.random.default_rng(23)
    n = int(LAWS[law]["rho"] * np.prod(pcfg.box.lengths))
    subs = [_psub(*_subset(r, pcfg, n, n // 3, 1)) for _ in range(2)]
    c1 = [torch.from_numpy(_positions(r, reg, K, False))
          for reg in (o.region5, o.region6)]
    _, acc, _ = usher_search_subset_batch(
        pcfg, subs[0], subs[1], c1[0], c1[1],
        torch.zeros((K,), dtype=torch.int32), o.region5, o.region6)
    assert 0 < int(acc.sum()) < 2 * K
    ctype = torch.zeros((K,), dtype=torch.int32)
    subs = [pstage._append_subset(s, c1[i], acc[i], ctype, 10 ** 6)
            for i, s in enumerate(subs)]
    grids = UsherPlan.of(pcfg, o.region5, o.region6).grids
    c2 = [np.concatenate([_positions(r, reg, K // 2, False),
                          off_grid(pcfg, g, reg, r)])
          for reg, g in zip((o.region5, o.region6), grids)]
    return jcfg, pcfg, subs, [torch.from_numpy(c) for c in c2]


def _energies(jcfg, jsub, pos):
    ct = jnp.zeros((pos.shape[0],), jnp.int32)
    return np.asarray(jsubset.conservative_energy_force(
        jcfg.pair, jsub, jcfg.box, jnp.asarray(pos), ct)[0])


def test_binned_search_on_appended_subsets_and_off_grid(second_round):
    jcfg, pcfg, subs, cand = second_round
    o = pcfg.obmd
    bp, ba, bi = usher_search_binned_plain(pcfg, subs[0], subs[1], cand[0],
                                           cand[1], o.region5, o.region6)
    pp, pa, pi = usher_search_subset_batch(
        pcfg, subs[0], subs[1], cand[0], cand[1],
        torch.zeros((K,), dtype=torch.int32), o.region5, o.region6)
    jsubs = [jsub_of(s) for s in subs]
    jp, ja, ji = (np.asarray(t) for t in jsubset.usher_search_subset_batch(
        jcfg, jsubs[0], jsubs[1], jnp.asarray(cand[0].numpy()),
        jnp.asarray(cand[1].numpy()), jnp.zeros((K,), jnp.int32),
        jcfg.obmd.region5, jcfg.obmd.region6))
    et = float(o.usher.etarget)
    checked = {"robust": 0, "alone": 0, "outside": 0}
    for side in range(2):
        e0 = _energies(jcfg, jsubs[side], cand[side].numpy())
        for got_p, got_a, got_i in ((bp, ba, bi), (pp, pa, pi)):
            e1 = _energies(jcfg, jsubs[side], got_p[side].numpy())
            e2 = _energies(jcfg, jsubs[side], jp[side])
            for i in range(K):
                alone = e0[i] == 0.0 \
                    or not np.isfinite(cand[side][i].numpy()).all()
                if not alone and min(abs(e0[i] - et), abs(e1[i] - et),
                                     abs(e2[i] - et)) < ROBUST:
                    continue
                checked["alone" if alone else "robust"] += 1
                assert bool(got_a[side, i]) == bool(ja[side, i]), (side, i)
                assert int(got_i[side, i]) == int(ji[side, i]), (side, i)
                np.testing.assert_allclose(got_p[side, i].numpy(),
                                           jp[side, i], rtol=0, atol=2e-3)
                if i in (K // 2 + 8, K // 2 + 9):
                    checked["outside"] += 1     # started outside its region
    assert checked["robust"] >= 8 and checked["alone"] >= 8, checked
    assert checked["outside"] >= 2, checked
    # a candidate far from every atom stops at iteration 0: taken where
    # it stands below a positive etarget, refused (degenerate) below a
    # negative one; one with a NaN or infinite coordinate too, moved to
    # NaN (its force is NaN) when refused
    far, bad = K // 2 + 4, [K // 2 + 10, K // 2 + 11]
    taken = et > 0
    assert bool(ja[0, far]) == taken and int(ji[0, far]) == 0
    assert (ja[0, bad] == taken).all() and (ji[0, bad] == 0).all()
    assert np.isnan(jp[0, bad]).any(-1).all() != taken


def test_binned_search_matches_pallas_on_appended_subsets(second_round):
    jcfg, pcfg, subs, cand = second_round
    o = pcfg.obmd
    finite = [np.isfinite(c.numpy()).all(1) for c in cand]
    cf = [c[torch.from_numpy(f)] for c, f in zip(cand, finite)]
    k = min(int(f.sum()) for f in finite)
    cf = [c[:k] for c in cf]
    jsubs = [jsub_of(s) for s in subs]
    rp, ra, _ = (np.asarray(t) for t in usher_search_pallas(
        jcfg, jsubs[0], jsubs[1], jnp.asarray(cf[0].numpy()),
        jnp.asarray(cf[1].numpy()), jcfg.obmd.region5, jcfg.obmd.region6))
    bp, ba, _ = (t.numpy() for t in usher_search_binned_plain(
        pcfg, subs[0], subs[1], cf[0], cf[1], o.region5, o.region6))
    et = float(o.usher.etarget)
    checked = 0
    for side in range(2):
        ea = _energies(jcfg, jsubs[side], bp[side])
        eb = _energies(jcfg, jsubs[side], rp[side])
        for i in range(k):
            if abs(ea[i] - et) < ROBUST or abs(eb[i] - et) < ROBUST:
                continue
            checked += 1
            assert bool(ba[side, i]) == bool(ra[side, i]), (side, i)
            if ba[side, i]:
                assert np.abs(bp[side, i] - rp[side, i]).max() < 2e-3
    assert checked >= 16, checked


def test_thermostat_only_law_takes_the_plain_search():
    """dpd/tstat: no kernel law, so usher_search runs the plain version
    (also where the tensors lie on the card) and takes every candidate at
    iteration 0, where it stands."""
    jcfg, pcfg = _configs("dpd", nattempt=8, k=K)
    pcfg = pcfg.__class__(**{**pcfg.__dict__, "pair":
                             pconfig.DPDTstatParams.create(
                                 t_start=1.0, cutoff=1.0, seed=1,
                                 gamma=4.5)})
    o = pcfg.obmd
    r = np.random.default_rng(3)
    n = int(3.0 * np.prod(pcfg.box.lengths))
    sub = _psub(*_subset(r, pcfg, n, n // 3, 1))
    c = [torch.from_numpy(_positions(r, reg, K, False))
         for reg in (o.region5, o.region6)]
    pos, acc, it = usher_search(pcfg, sub, sub, c[0], c[1], o.region5,
                                o.region6)
    assert bool(acc.all()) and int(it.abs().sum()) == 0
    assert torch.equal(pos, torch.stack(c))
