"""Molecule-mode OBMD (the star template under two-type DPD with harmonic
bonds, angles and impropers) against the JAX cellpad engine on the small
star box (scenes.mol_box_scene: tests/test_branched.py's star box with y
and z of 6 cells, 7 x 6 x 6 cells, cap 22, the rank-looped body): setup
and STEPS steps, each from the JAX engine's state before it (handed over
through convert.from_arrays), the JAX engine's own draws injected
(test_torch_support.JaxMolDraws), nattempt = 0 (each trial's verdict its
initial energy against the gate, etarget 24 so that about a quarter of
the trials pass; the search itself is held step by step in
test_torch_mol_subset.py).

Held after setup and every step: slots, tags, alive, mol, rep_atom, the
four partner columns, impr, the kernel caches and every counter exactly;
x, xref and cms_mol within 1e-4; the boundary setpoints within 1e-4 plus
1e-6 of their magnitude (a deleted star's momentum over dt reaches
-4,661, where one float32 ulp is 5e-4); v within 1e-4 and f within
2e-4 * max|f| (float32 summation order) on every slot but those of
observe.ill_conditioned_impropers, where the template's near-collinear
arms amplify float32 rounding (tests/test_torch_star.py).  Some step
inserts molecules, and the star that starts moving out of the low face
leaves whole.  Then 30 steps on the port's own generator with the real
search (nattempt 12): molecules inserted, every molecule whole."""
import jax
import numpy as np
import pytest

from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.engine_cellpad import (check_supported, make_geometry,
                                           relayout_flags, supports)
from obmd_tpu_torch.integrate import make_run as pmake_run
from obmd_tpu_torch.integrate import setup as psetup
from obmd_tpu_torch.observe import (ill_conditioned_impropers,
                                    molecule_census)

from test_torch_obmd_lj import to_jax
from test_torch_support import CPU, EXACT, JaxMolDraws, jax_arrays

STEPS, SEED, ETARGET = 4, 0, 24.0
MOLECULE = ("bond3", "bond4", "impr", "rep_atom")
CLOSE = ("x", "xref", "cms_mol", "sim_time")
SETPOINTS = ("momentum_force_left", "momentum_force_right",
             "shear_force_left", "shear_force_right")


@pytest.fixture(scope="module")
def runs():
    """[(JAX arrays, port arrays, ill-conditioned slots)] after setup and
    each step."""
    pcfg = pscenes.mol_box_config("dpd", nattempt=0, etarget=ETARGET)
    jcfg = to_jax(pcfg)
    x, v, types, mol, bonds, impropers = pscenes.mol_box_start(pcfg)
    jst = jinit_state(jcfg, x, v=v, types=types, mol=mol, bonds=bonds,
                      impropers=impropers, seed=SEED)
    draws = JaxMolDraws(pcfg, SEED)
    pst = psetup(pcfg, convert.from_arrays(jax_arrays(jst), device=CPU),
                 draw=draws)
    jst = jsetup(jcfg, jst)
    out = [(jax_arrays(jst), convert.to_arrays(pst),
            ill_conditioned_impropers(pcfg, pst).numpy())]
    jrun = jax.jit(jmake_run(jcfg, 1))
    prun = pmake_run(pcfg, 1, draw=draws)
    for _ in range(STEPS):
        pst = prun(convert.from_arrays(out[-1][0], device=CPU))
        jst = jrun(jst)
        out.append((jax_arrays(jst), convert.to_arrays(pst),
                    ill_conditioned_impropers(pcfg, pst).numpy()))
    return pcfg, out


def test_scene_is_supported():
    """The engine takes the small box and path F (molecule mode, one
    template, branched topology from the template), relayouts move bonds,
    molecule columns and charges; both have 6 or more cells on y and z."""
    for cfg in (pscenes.mol_box_config("dpd"),
                pscenes.open_star_config(pscenes.open_star_box(20_000),
                                         100_000)):
        assert supports(cfg) and cfg.branched_topology
        check_supported(cfg)
        assert relayout_flags(cfg) == dict(has_bonds=True, has_mol=True,
                                           has_charge=True, has_types=True,
                                           has_mol_com=True)
        assert min(make_geometry(cfg).dims[1:]) >= 6


@pytest.mark.parametrize("i", range(STEPS + 1))
def test_path_matches_jax(runs, i):
    """State i (0: after setup) of the port against the JAX engine's."""
    _, out = runs
    jd, pd, ill = out[i]
    for k in EXACT + MOLECULE:
        assert np.array_equal(np.asarray(pd[k]), jd[k]), k
    for k in CLOSE:
        np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    for k in SETPOINTS:
        np.testing.assert_allclose(pd[k], jd[k], rtol=1e-6, atol=1e-4,
                                   err_msg=k)
    keep = ~ill
    np.testing.assert_allclose(pd["v"][keep], jd["v"][keep], rtol=0,
                               atol=1e-4)
    fmax = np.abs(jd["f"]).max()
    assert np.abs(pd["f"] - jd["f"])[keep].max() <= 2e-4 * fmax
    assert ill.sum() <= 0.1 * jd["alive"].sum()


def test_path_inserts_and_deletes_whole(runs):
    """Over the steps some molecules were inserted (in fives, one molecule
    id each, the first atom's tag) and the exiting star went whole; the
    atom count balances."""
    pcfg, out = runs
    first, last = out[0][1], out[-1][1]
    ins = int(last["ninserted"]) - int(first["ninserted"])
    gone = int(last["ndeleted"]) - int(first["ndeleted"])
    assert ins > 0 and ins % 5 == 0
    assert gone >= 5
    assert int(last["alive"].sum()) == int(first["alive"].sum()) + ins - gone
    tags = set(last["tag"][last["alive"]].tolist())
    assert not {1, 2, 3, 4, 5} & tags            # the exiting star
    base = int(first["maxtag"])
    new = last["alive"] & (last["tag"] > base)
    tag = last["tag"][new]
    assert np.array_equal(last["mol"][new],
                          (tag - base - 1) // 5 * 5 + base + 1)


def test_own_generator_keeps_molecules_whole():
    """30 steps on the port's own draws with the real search (nattempt
    12, etarget 12): molecules inserted, USHER iterations counted, every
    live molecule whole (5 live atoms, its partner columns intact), the
    invariants hold."""
    from obmd_tpu_torch.observe import check_invariants
    sc = pscenes.mol_box_scene("dpd", device=CPU)
    st = psetup(sc.cfg, sc.state)
    n0, _ = molecule_census(sc.cfg, st)
    st = pmake_run(sc.cfg, 30)(st)
    n, broken = molecule_census(sc.cfg, st)
    tel = check_invariants(sc.cfg, st)
    assert tel["ninserted"] > 0 and tel["usher_iters"] > 0
    assert broken == 0 and n > n0 - 5
    assert 5 * n == int((st.alive & (st.mol != 0)).sum())
