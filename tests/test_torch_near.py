"""`near` insertion against the JAX engine: the check of each candidate
against the buffer subset (obmd_tpu/obmd/subset.py near_check_subset), the
near branch of the greedy acceptance (obmd_tpu/obmd/stage.py
_sequential_accept), and four steps of the OBMD_DPD deck with `near 0.35`
(scene usher=False) slot for slot, with the JAX engine's candidate draws
injected through the port's draw seam.

The check and the acceptance compare a float32 squared distance with
float32(near^2) in both packages, so their booleans are held exactly, on
candidates placed within 1e-3 of `near` from an atom or from each other
too.  The steps' tolerances: integer and bool fields exact, forces within
2e-4 * max|f| (tests/test_bigtile.py's bar: float32 summation order),
positions and velocities within 1e-4, the boundary setpoints within 1e-6
of their largest component (a sum of the deleted atoms' momenta over dt,
~2e4 at this scale, in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import scenes as jscenes
from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.obmd import stage as jstage
from obmd_tpu.obmd import subset as jsubset
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.integrate import make_run as pmake_run
from obmd_tpu_torch.integrate import setup as psetup
from obmd_tpu_torch.obmd import stage as pstage
from obmd_tpu_torch.obmd import subset as psubset

from test_torch_support import CLOSE, CPU, EXACT, JaxDraws, jax_arrays

SCALE, SEED, NBUF, K = 0.5, 2, 1400.0, 16


def _configs():
    jcfg = jscenes.obmd_dpd_config(scale=SCALE, nbuf=NBUF, usher=False)
    pcfg = pscenes.obmd_dpd_config(scale=SCALE, nbuf=NBUF, usher=False)
    assert jcfg.obmd.near == pcfg.obmd.near == 0.35
    return jcfg, pcfg


def _near_points(r, anchors, n, near):
    """n points each at a distance within 1e-3 of `near` from a random
    anchor (half of them inside, half outside), and n more at a random
    distance of 0-1."""
    a = anchors[r.integers(0, len(anchors), 2 * n)]
    u = r.normal(size=(2 * n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    dist = np.concatenate([near + r.uniform(-1e-3, 1e-3, n),
                           r.uniform(0.0, 1.0, n)])
    return (a + u * dist[:, None]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_near_check_subset_exact(seed):
    """Candidates within 1e-3 of `near` of a subset atom, across the
    periodic y/z faces too, get the JAX verdicts bit for bit."""
    jcfg, pcfg = _configs()
    r = np.random.default_rng(seed)
    hi = np.asarray(pcfg.box.hi)
    b = 300
    sx = r.uniform([0.0, 0.0, 0.0], [3.0, hi[1], hi[2]], (b, 3))
    sx = sx.astype(np.float32)
    valid = r.uniform(size=b) < 0.9
    sx[~valid] = np.float32(1e8)
    cand = _near_points(r, sx[valid], 2 * K, 0.35)
    cand[:, 1:] = np.mod(cand[:, 1:], hi[1:]).astype(np.float32)
    jsub = jsubset.Subset(idx=jnp.zeros(b, jnp.int32), x=jnp.asarray(sx),
                          type=jnp.zeros(b, jnp.int32),
                          q=jnp.zeros(b, jnp.float32),
                          valid=jnp.asarray(valid),
                          overflow=jnp.asarray(False))
    psub = psubset.Subset(x=torch.from_numpy(sx),
                          type=torch.zeros(b, dtype=torch.int32),
                          valid=torch.from_numpy(valid),
                          overflow=torch.tensor(False))
    want = np.asarray(jsubset.near_check_subset(jcfg, jsub,
                                                jnp.asarray(cand)))
    got = psubset.near_check_subset(pcfg, psub, torch.from_numpy(cand))
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_near_acceptance_exact(seed):
    """The near branch of the greedy acceptance: candidates in pairs within
    1e-3 of `near` of each other, at budgets 0, 3 and K."""
    jcfg, pcfg = _configs()
    r = np.random.default_rng(seed)
    base = r.uniform([0.0, 0.0, 0.0], [2.5, 11.198, 11.198], (K // 2, 3))
    cand = np.concatenate([base, _near_points(r, base, K // 4, 0.35)])
    cand = cand[r.permutation(K)].astype(np.float32)
    ok = r.uniform(size=K) < 0.85
    ct = np.zeros(K, np.int32)
    for budget in (0, 3, K):
        ja, jc = jstage._sequential_accept(jcfg, jnp.asarray(cand),
                                           jnp.asarray(ct), jnp.asarray(ok),
                                           jnp.int32(budget))
        pa, pc = pstage._sequential_accept(
            pcfg, torch.from_numpy(cand), torch.from_numpy(ct),
            torch.from_numpy(ok), torch.tensor(budget, dtype=torch.int32))
        assert np.array_equal(pa.numpy(), np.asarray(ja))
        assert int(pc) == int(jc)


SETPOINTS = ("momentum_force_left", "momentum_force_right",
             "shear_force_left", "shear_force_right")


def assert_near_states_match(jd, pd):
    for k in EXACT:
        assert np.array_equal(np.asarray(pd[k]), jd[k]), k
    for k in CLOSE:
        atol = 1e-6 * np.abs(jd[k]).max() if k in SETPOINTS else 1e-4
        np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=atol,
                                   err_msg=k)
    fmax = np.abs(jd["f"]).max()
    assert np.abs(pd["f"] - jd["f"]).max() <= 2e-4 * fmax


@pytest.fixture(scope="module")
def trajectories():
    """The near deck at scale 0.5 in both engines from the same gas (nbuf
    raised, so both buffers ask for atoms on every step): after setup,
    then after each of four steps."""
    js = jscenes.obmd_dpd_scene(scale=SCALE, seed=SEED, nbuf=NBUF,
                                usher=False)
    ps = pscenes.obmd_dpd_scene(scale=SCALE, seed=SEED, nbuf=NBUF,
                                usher=False, device=CPU)
    draws = JaxDraws(js.cfg, SEED)
    jst = jsetup(js.cfg, js.state)
    pst = psetup(ps.cfg, ps.state, draw=draws)
    out = [(jax_arrays(jst), convert.to_arrays(pst))]
    jrun = jax.jit(jmake_run(js.cfg, 1))
    prun = pmake_run(ps.cfg, 1, draw=draws)
    for _ in range(4):
        jst, pst = jrun(jst), prun(pst)
        out.append((jax_arrays(jst), convert.to_arrays(pst)))
    return out


def test_near_deck_four_steps_match_jax(trajectories):
    """Setup and each of four steps slot for slot; the near deck inserts
    (and rejects some candidates) on every step; USHER's iteration count
    stays 0."""
    for i, (jd, pd) in enumerate(trajectories):
        assert_near_states_match(jd, pd)
        assert int(pd["usher_iters"]) == 0
        if i:
            prev = trajectories[i - 1][0]
            assert int(jd["ninserted"]) > int(prev["ninserted"]), i
    jd = trajectories[-1][0]
    assert int(jd["insert_fail"]) > 0 and int(jd["ndeleted"]) > 0


def test_near_deck_runs_own_generator():
    """Twenty steps of the near deck on the port's own generator: atoms
    are conserved up to the counters, and the stage inserts."""
    from obmd_tpu_torch.observe import check_invariants
    ps = pscenes.obmd_dpd_scene(scale=0.25, seed=SEED, nbuf=700.0,
                                usher=False, device=CPU)
    cfg = ps.cfg
    n0 = int(ps.state.natoms)
    st = pmake_run(cfg, 20)(psetup(cfg, ps.state))
    tel = check_invariants(cfg, st)
    assert tel["ninserted"] > 0 and int(st.obmd.usher_iters) == 0
    assert int(st.natoms) == n0 + tel["ninserted"] - tel["ndeleted"]
