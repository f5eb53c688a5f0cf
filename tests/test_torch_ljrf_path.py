"""The open-boundary charged two-type LJ fluid (scenes.obmd_ljrf_scene)
against the JAX engine on its small box (16 x 9 x 9 fcc cells: a 9 x 5 x 5
cell grid, x open, p == 1 in 128 lanes, cap 44), the JAX configuration
built field for field from the port's.

The small deck's start is the scene's lattice thinned to 70% of its sites
(numpy seed): on the full lattice no uniform candidate lies below the
negative etarget, and on the thinned one some do.  nbuf is raised to 1.05
x the buffer's lattice count / alpha, so that both buffers ask for atoms
on every step.  nattempt = 0 (each verdict is a candidate's initial energy
against the gate, which no summation order flips).

Held: the configuration mirror and the full-size start (100,352 atoms,
10,036 ions at +-0.5, net charge 0); setup and four steps of the whole path
with the JAX engine's candidate draws injected: slots, tags, alive, types,
charges, the kernel caches and every counter exact, x, v and the setpoints
within 1e-4, forces within 2e-4 * max|f| (float32 summation order; the bar
of tests/test_bigtile.py); inserted atoms are type 0 with q = 0; thermo
(with the reaction-field energy and virial) and the charge census on the
ended state."""
import dataclasses

import jax
import numpy as np
import pytest

from obmd_tpu.engine_cellpad import supports as jsupports
from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.engine_cellpad import (auto_rebuild_every, make_geometry,
                                           supports as psupports)
from obmd_tpu_torch.integrate import make_run as pmake_run
from obmd_tpu_torch.integrate import setup as psetup
from obmd_tpu_torch.state import init_state as pinit_state

from test_torch_obmd_lj import to_jax
from test_torch_support import (CPU, JaxDraws, _mirror, assert_states_match,
                                jax_arrays)

NX, NY, SEED, STEPS, KEEP = 16, 9, 2, 4, 0.7


def test_config_mirrors_jax_and_start():
    """Both engines support the charged fluid at full and small size; the
    full size is the open LJ fluid's grid (74 x 8 x 8, p = 2, cap 44,
    208,384 slots) with a relayout every 4 steps; its start holds 100,352
    atoms, 10,036 of them type-1 ions at +0.5 and -0.5 in equal numbers;
    make_run(kernel="full") refuses the scene (make_dpd_kernel has one
    type and no charges)."""
    for kw in (dict(), dict(nx=NX, ny=NY)):
        pcfg = pscenes.obmd_ljrf_config(**kw)
        jcfg = to_jax(pcfg)
        _mirror(pcfg, jcfg)
        assert psupports(pcfg) and jsupports(jcfg)
    pcfg = pscenes.obmd_ljrf_config()
    geom = make_geometry(pcfg)
    assert (geom.dims, geom.p, geom.cap, geom.n_slots) == \
        ((74, 8, 8), 2, 44, 208384)
    assert auto_rebuild_every(pcfg) == 4
    assert pcfg.obmd.ntype == 0 and pcfg.masses == (1.0, 1.5)
    st = pscenes.obmd_ljrf_scene(device=CPU).state
    q = st.q[st.alive].numpy()
    assert int(st.natoms) == 100352
    assert (st.type[st.alive].numpy() == 1).sum() == 10036
    assert (q == 0.5).sum() == (q == -0.5).sum() == 5018
    assert ((q != 0) == (st.type[st.alive].numpy() == 1)).all()
    with pytest.raises(NotImplementedError):
        pmake_run(pcfg, 1, kernel="full")


def small_start():
    """The small scene's lattice thinned to KEEP of its sites (numpy seed
    1), with its types, charges and velocities."""
    sc = pscenes.obmd_ljrf_scene(nx=NX, ny=NY, device=CPU)
    n = int(sc.state.natoms)
    keep = np.random.default_rng(1).random(n) < KEEP
    return tuple(a[:n][keep].numpy() for a in (sc.state.x, sc.state.v,
                                               sc.state.type, sc.state.q))


@pytest.fixture(scope="module")
def trajectories():
    """Both engines from the same start and draws: after setup, then after
    each of four one-step runs (each starts an epoch, so each step
    relayouts)."""
    o = pscenes.obmd_ljrf_config(nx=NX, ny=NY).obmd
    pcfg = pscenes.obmd_ljrf_config(nx=NX, ny=NY,
                                    nbuf=1.05 * o.nbuf / o.alpha ** 2)
    pcfg = dataclasses.replace(pcfg, obmd=dataclasses.replace(
        pcfg.obmd, usher=dataclasses.replace(pcfg.obmd.usher, nattempt=0)))
    jcfg = to_jax(pcfg)
    x, v, types, q = small_start()
    draws = JaxDraws(jcfg, SEED)
    jst = jsetup(jcfg, jinit_state(jcfg, x, v=v, types=types, q=q,
                                   seed=SEED))
    pst = psetup(pcfg, pinit_state(pcfg, x, v=v, types=types, q=q,
                                   device=CPU), draw=draws)
    out = [(jax_arrays(jst), convert.to_arrays(pst))]
    jrun = jax.jit(jmake_run(jcfg, 1))
    prun = pmake_run(pcfg, 1, draw=draws)
    for _ in range(STEPS):
        jst, pst = jrun(jst), prun(pst)
        out.append((jax_arrays(jst), convert.to_arrays(pst)))
    return out, (jcfg, jst), (pcfg, pst), len(x)


@pytest.mark.parametrize("i", range(STEPS + 1))
def test_path_matches_jax(trajectories, i):
    """State i (0 = setup): slots, tags, alive, types, charges, caches and
    every counter exact, x, v and the setpoints within 1e-4, f within
    2e-4 * max|f|."""
    jd, pd = trajectories[0][i]
    assert_states_match(jd, pd)
    assert np.array_equal(pd["q"], jd["q"])


def test_insertions_are_neutral_solvent(trajectories):
    """The first step inserts; every inserted atom (tag above the start's)
    is alive as type 0 with q = 0, in both engines."""
    out, _, _, n0 = trajectories
    assert int(out[1][1]["ninserted"]) > int(out[0][1]["ninserted"])
    for jd, pd in out[1:]:
        for d in (jd, pd):
            new = d["alive"] & (d["tag"] > n0)
            assert new.sum() > 0
            assert (d["type"][new] == 0).all() and (d["q"][new] == 0).all()


def test_observables_match_jax(trajectories):
    """On the ended state: make_thermo_fn (E_pair and pe with the
    reaction-field energy, the pressure with its virial) to 1e-5 of each
    quantity's scale; the charge census against a numpy sum."""
    from obmd_tpu.observe import make_thermo_fn as j_thermo
    from obmd_tpu_torch.observe import charge_census
    from obmd_tpu_torch.observe import make_thermo_fn as p_thermo
    _, (jcfg, jst), (pcfg, pst), _ = trajectories
    jt, pt = j_thermo(jcfg)(jst), p_thermo(pcfg)(pst)
    assert int(pt.natoms) == int(jt.natoms)
    for k in ("temp", "pe", "ke", "pressure", "pxx", "press_tensor",
              "epair", "fmax", "fnorm"):
        want = np.asarray(getattr(jt, k))
        got = getattr(pt, k).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    net, ions = charge_census(pst)
    q = pst.q[pst.alive].numpy()
    assert net == float(q.sum()) and ions == int((q != 0).sum()) > 0
