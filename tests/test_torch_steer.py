"""The deck's own steered USHER search (nattempt = 40, the step rule, region
exit) inside the whole slice, against the JAX engine: setup and the first
step of one small OBMD_DPD scene (scale 0.25, cap 24, nbuf raised so both
buffers ask for atoms), the JAX engine's candidate draws injected through
the port's draw seam, every search of both engines recorded candidate by
candidate.

A candidate that steps toward the etarget gate stops within a float32 ulp
of it, and the side it lands on depends on the energy's summation order,
which differs between the engines; once one such verdict differs, the
states part.  So the state is held exactly after setup at STEER_SEED, a
gas whose setup search ends alike in both engines candidate by
candidate, and the first step's search is held per margin-robust
candidate (|E - etarget| >= 0.3 at both final positions, the rule of
tests/test_pallas_usher.py).  Tolerances as in test_torch_slice.py:
positions 1e-4, forces 2e-4 * max|f|."""
import jax
import numpy as np
import pytest
import torch

import obmd_tpu.obmd.subset as jsubset
import obmd_tpu_torch.forces.usher_kernel as pusher
from obmd_tpu import scenes as jscenes
from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.integrate import make_run as pmake_run
from obmd_tpu_torch.integrate import setup as psetup
from obmd_tpu_torch.obmd.subset import _batched_energy_force, pad_subset

from test_torch_support import CPU, JaxDraws, assert_states_match, jax_arrays

SCALE, NBUF = 0.25, 700.0
# at most seeds one of the 32 candidates of the setup search converges
# onto the etarget gate and lands on different sides of it in the two
# engines; seeds that stay alike through the next step as well are rarer
STEER_SEED = 4


@pytest.fixture(scope="module")
def steered():
    """Setup and one step of the deck as it stands (nattempt = 40) in both
    engines from one gas and one stream of draws, every USHER search
    recorded candidate by candidate: ([(jax arrays, port arrays) after
    setup and after the step], [jax (pos, ok, iters) per search], [port
    (pos, ok, iters, subsets) per search])."""
    jrec, prec = [], []
    jsearch = jsubset.usher_search_subset_batch
    psearch = pusher.usher_search

    def jax_recorded(*a, **k):
        out = jsearch(*a, **k)
        jax.debug.callback(
            lambda *r: jrec.append(tuple(np.asarray(t) for t in r)), *out)
        return out

    def port_recorded(cfg, sub_l, sub_r, *a):
        out = psearch(cfg, sub_l, sub_r, *a)
        prec.append(tuple(t.numpy() for t in out) + ((sub_l, sub_r),))
        return out

    js = jscenes.obmd_dpd_scene(scale=SCALE, seed=STEER_SEED, nbuf=NBUF)
    ps = pscenes.obmd_dpd_scene(scale=SCALE, seed=STEER_SEED, nbuf=NBUF,
                                device=CPU)
    assert js.cfg.obmd.usher.nattempt == ps.cfg.obmd.usher.nattempt == 40
    draws = JaxDraws(js.cfg, STEER_SEED)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsubset, "usher_search_subset_batch", jax_recorded)
        mp.setattr(pusher, "usher_search", port_recorded)
        jst = jsetup(js.cfg, js.state)
        pst = psetup(ps.cfg, ps.state, draw=draws)
        out = [(jax_arrays(jst), convert.to_arrays(pst))]
        jst = jax.jit(jmake_run(js.cfg, 1))(jst)
        pst = pmake_run(ps.cfg, 1, draw=draws)(pst)
        out.append((jax_arrays(jst), convert.to_arrays(pst)))
        jax.effects_barrier()
    return out, jrec, prec, ps.cfg


def test_setup_with_steered_usher_matches_jax(steered):
    """Setup's stage with the deck's 40-iteration search: slots, tags,
    alive, caches, every counter (usher_iters among them) exact, the
    inserted positions with the rest of x within 1e-4."""
    (j0, p0), _ = steered[0]
    assert int(j0["ninserted"]) > 0 and int(j0["usher_iters"]) > 0
    assert_states_match(j0, p0)


def test_step_with_steered_usher_tracks_jax(steered):
    """The first step's search inside the step, on inputs that differ
    from the JAX engine's by one step of float32 summation order: each
    engine's usher_iters counter advances by the iterations its search
    reports, and on the margin-robust candidates (|E - etarget| >= 0.3 at
    both final positions, the rule of tests/test_pallas_usher.py) the
    verdicts and iteration counts are equal and the positions within
    1e-4; at least 6 are checked."""
    (j0, p0), (j1, p1) = steered[0]
    jrec, prec, cfg = steered[1], steered[2], steered[3]
    assert len(jrec) == len(prec) == 2
    for d0, d1, rec in ((j0, j1, jrec), (p0, p1, prec)):
        assert int(d0["usher_iters"]) == int(rec[0][2].sum())
        assert int(d1["usher_iters"]) - int(d0["usher_iters"]) \
            == int(rec[1][2].sum()) > 0
    (jp, jo, ji), (pp, po, pi, (sub_l, sub_r)) = jrec[1], prec[1]
    b = max(sub_l.x.shape[0], sub_r.x.shape[0])
    sl, sr = pad_subset(sub_l, b), pad_subset(sub_r, b)
    sx = torch.stack([sl.x, sr.x])
    st = torch.stack([sl.type, sr.type])
    sv = torch.stack([sl.valid, sr.valid])
    ct = torch.full(pi.shape, cfg.obmd.ntype, dtype=torch.int32)
    et = cfg.obmd.usher.etarget
    e = [_batched_energy_force(cfg.pair, sx, st, sv, torch.tensor(pos),
                               ct, box=cfg.box)[0].numpy()
         for pos in (jp, pp)]
    robust = (np.abs(e[0] - et) >= 0.3) & (np.abs(e[1] - et) >= 0.3)
    assert robust.sum() >= 6
    assert np.array_equal(jo[robust], po[robust])
    assert np.array_equal(ji[robust], pi[robust])
    assert np.abs(jp - pp).max(-1)[robust].max() < 1e-4
