"""The chain melt's path — chain_scene's generated start (nx = 7: 28
chains of 49 beads, 5 cells per axis at skin 0.98) after the port's
chain_warm_up (WARM steps at dt 0.003 on the CPU; its bonds then lie near
0.97, inside the WCA cut, so the exclusion acts on every one), setup,
three 4-step runners (three relayout epochs at R = 4) under in.chain's
Langevin thermostat at dt 0.012, check_invariants — against the JAX
cellpad engine from the same warmed positions and velocities.

Slots, tags, alive, the partner columns, mol, the kernel caches and every
counter are held exactly; x and v within 1e-4, forces within 2e-4 *
max|f| (float32 summation order: the port sums each slot's 27 cells, the
TPU kernel a Newton half stencil), thermo's E_bond, E_pair and pe within
1e-5 of their scale.  The same path through the full-stencil kernel keeps
the slots and stays within 1e-5 of the default kernel's positions."""
import jax
import numpy as np
import pytest

from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.observe import make_thermo_fn as j_make_thermo_fn
from obmd_tpu_torch import convert
from obmd_tpu_torch.engine_cellpad import auto_rebuild_every, make_geometry
from obmd_tpu_torch.integrate import make_run as pmake_run
from obmd_tpu_torch.integrate import setup as psetup
from obmd_tpu_torch.observe import (bond_stats, check_invariants,
                                    make_thermo_fn)

from test_torch_support import (EXACT, assert_states_match, chain_states,
                                jax_arrays)

STEPS = 4
WARM = 300


@pytest.fixture(scope="module")
def runs():
    jcfg, jst, pcfg, pst = chain_states(warm=WARM)
    jst, pst = jsetup(jcfg, jst), psetup(pcfg, pst)
    out = [(jst, pst)]
    jrun = jax.jit(jmake_run(jcfg, STEPS))
    prun = pmake_run(pcfg, STEPS)
    for _ in range(3):
        jst, pst = jrun(jst), prun(pst)
        out.append((jst, pst))
    return jcfg, pcfg, out


def test_layout_and_period(runs):
    _, pcfg, _ = runs
    geom = make_geometry(pcfg)
    assert (geom.dims, geom.s, geom.p, geom.lanes, geom.fcap) == \
        ((5, 5, 5), 25, 1, 128, 18)
    assert auto_rebuild_every(pcfg) == STEPS


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_states_match_jax(runs, i):
    """After setup and after 4, 8 and 12 steps."""
    _, _, out = runs
    jst, pst = out[i]
    jd, pd = jax_arrays(jst), convert.to_arrays(pst)
    assert_states_match(jd, pd)
    assert int(pst.nbrs.rebuilds) == 1 + i


def test_thermo_matches_jax(runs):
    """thermo on the ended states: E_bond, E_pair, pe, T and the pressure
    within 1e-5 of each quantity's scale."""
    jcfg, pcfg, out = runs
    jthermo, pthermo = j_make_thermo_fn(jcfg), make_thermo_fn(pcfg)
    for jst, pst in (out[0], out[-1]):
        jt, pt = jthermo(jst), pthermo(pst)
        assert float(pt.ebond) > 1000.0
        for name in ("ebond", "epair", "pe", "temp", "pressure"):
            want, got = float(getattr(jt, name)), float(getattr(pt, name))
            assert abs(got - want) <= 1e-5 * max(abs(want), 1.0), name


def test_port_run_invariants(runs):
    """No overflow or half-skin trip; every bond stays below r0."""
    _, pcfg, out = runs
    tel = check_invariants(pcfg, out[-1][1])
    assert tel["rebuilds"] == 4 and tel["layout_overflow"] == 0
    longest, over, count = bond_stats(pcfg, out[-1][1])
    assert count == 1344 and over == 0 and longest < 1.5


def test_full_stencil_kernel_path_matches(runs):
    """The same path through make_dpd_kernel's counterpart (kernel="full",
    exclusion through its 2-channel pbond): the same slots, partner columns
    and counters, positions within 1e-5 of the default kernel's run."""
    _, _, out = runs
    _, _, pcfg, pst = chain_states(warm=WARM)
    st = psetup(pcfg, pst, kernel="full")
    run = pmake_run(pcfg, STEPS, kernel="full")
    for _ in range(3):
        st = run(st)
    got, want = convert.to_arrays(st), convert.to_arrays(out[-1][1])
    for k in EXACT:
        assert np.array_equal(got[k], want[k]), k
    assert np.abs(got["x"] - want["x"]).max() < 1e-5
