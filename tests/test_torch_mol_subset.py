"""The molecule-mode pieces of the OBMD stage against the JAX package's:
every function of obmd_tpu_torch/obmd/subset.py's MOLECULE section
(random_rotations, mol_candidates_sel, mol_energy_force,
_axis_angle_rotate, usher_search_subset_mol, near_check_subset_mol,
mol_sequential_accept), template_stacks, delete_outside's doom
propagation and adress.update_mol_com.

The inputs come from numpy's default_rng(SEED) on scenes.mol_box_config's
box (the star template under two-type DPD, and under lj/cut for the LJ
branches).  The rotations' uniforms are JAX's own draws of the key the JAX
function splits.  Tolerances: rotations, coordinates and COMs within 1e-5;
energies and forces within 1e-5 of each quantity's scale (float32
summation order); the search's positions within 1e-4; integer and bool
outputs exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import adress as jadress
from obmd_tpu import config as jconfig
from obmd_tpu.obmd import stage as jstage
from obmd_tpu.obmd import subset as jsub
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import adress as padress
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.cells import BIG
from obmd_tpu_torch.obmd import stage as pstage
from obmd_tpu_torch.obmd import subset as psub
from obmd_tpu_torch.state import init_state as pinit_state

from test_torch_obmd_lj import to_jax
from test_torch_support import CPU

SEED, K, B = 5, 16, 400


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


@pytest.fixture(scope="module", params=["dpd", "lj"])
def case(request):
    """(port cfg, JAX cfg, port Subset, JAX Subset, template arrays) of one
    law: B subset rows uniform in the left insertion region grown by 1.5,
    a fifth of them invalid (at BIG), types 0 and 1."""
    law = request.param
    pcfg = pscenes.mol_box_config(law, nattempt=12,
                                  etarget=12.0 if law == "dpd" else 10.0)
    jcfg = to_jax(pcfg)
    r = np.random.default_rng(SEED)
    reg = pcfg.obmd.region5
    lo = np.asarray(reg.lo) - [1.5, 0.0, 0.0]
    hi = np.asarray(reg.hi) + [1.5, 0.0, 0.0]
    x = r.uniform(lo, hi, (B, 3)).astype(np.float32)
    valid = r.random(B) > 0.2
    x[~valid] = BIG
    types = r.integers(0, 2, B).astype(np.int32)
    q = np.zeros(B, np.float32)
    psub_ = psub.Subset(x=_t(x), type=_t(types, torch.int32),
                        valid=_t(valid, torch.bool),
                        overflow=torch.tensor(False), q=_t(q))
    jsub_ = jsub.Subset(idx=jnp.arange(B, dtype=jnp.int32), x=jnp.asarray(x),
                        type=jnp.asarray(types), q=jnp.asarray(q),
                        valid=jnp.asarray(valid), overflow=jnp.asarray(False))
    ts = pconfig.template_stacks(pcfg.obmd)
    return law, pcfg, jcfg, psub_, jsub_, ts


def _trials(case, seed=SEED):
    """K trial molecules: JAX's rotations of jax.random.PRNGKey(seed) and
    centers uniform in the insertion region (numpy), as (port coords, JAX
    coords, types [K, m], the rotation key's uniforms)."""
    _, pcfg, _, _, _, ts = case
    key = jax.random.PRNGKey(seed)
    ka, kt = jax.random.split(key)
    u_axis = np.asarray(jax.random.uniform(ka, (K, 3), dtype=jnp.float32))
    u_angle = np.asarray(jax.random.uniform(kt, (K,), dtype=jnp.float32))
    r = np.random.default_rng(seed)
    reg = pcfg.obmd.region5
    centers = r.uniform(reg.lo, reg.hi, (K, 3)).astype(np.float32)
    dx = np.broadcast_to(ts.dx[0], (K,) + ts.dx[0].shape).astype(np.float32)
    am = np.ones(dx.shape[:2], bool)
    jrots = jsub.random_rotations(key, K, jnp.float32)
    jc = jsub.mol_candidates_sel(jnp.asarray(dx), jnp.asarray(am),
                                 jnp.asarray(centers), jrots)
    prots = psub.random_rotations(_t(u_axis), _t(u_angle))
    pc = psub.mol_candidates_sel(_t(dx), _t(am, torch.bool), _t(centers),
                                 prots)
    types = np.broadcast_to(ts.types[0], am.shape).astype(np.int32)
    return pc, jc, types, (jrots, prots)


def test_template_stacks_match_jax(case):
    """template_stacks of the star: displacements, mask, types, partner
    and improper indices and fractions as the JAX package's, and the
    branched flag that SceneConfig.finalize turns into branched_topology
    in both packages."""
    _, pcfg, jcfg, _, _, ts = case
    want = jconfig.template_stacks(jcfg.obmd)
    for f in dataclasses.fields(ts):
        assert np.array_equal(getattr(ts, f.name), getattr(want, f.name)), \
            f.name
    assert ts.branched and ts.has_impropers
    assert pcfg.branched_topology and jcfg.finalize().branched_topology


def test_rotations_and_candidates_match_jax(case):
    """random_rotations from the uniforms of the JAX function's own key
    split (and from the fixed `orient` axis), mol_candidates_sel's
    coordinates (pad rows at BIG) and _axis_angle_rotate, within 1e-5."""
    pc, jc, _, (jrots, prots) = _trials(case)
    np.testing.assert_allclose(prots.numpy(), np.asarray(jrots), atol=1e-6)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-5)
    orient = (0.3, -0.2, 0.9)
    key = jax.random.PRNGKey(SEED + 1)
    _, kt = jax.random.split(key)
    u_angle = np.asarray(jax.random.uniform(kt, (K,), dtype=jnp.float32))
    want = jsub.random_rotations(key, K, jnp.float32, axis=orient)
    got = psub.random_rotations(None, _t(u_angle), axis=orient)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    am = np.ones((K, pc.shape[1]), bool)
    am[::3, -1] = False
    dx = pc.numpy() - pc.numpy().mean(1, keepdims=True)
    centers = pc.numpy().mean(1)
    got = psub.mol_candidates_sel(_t(dx), _t(am, torch.bool), _t(centers),
                                  prots).numpy()
    want = np.asarray(jsub.mol_candidates_sel(
        jnp.asarray(dx), jnp.asarray(am), jnp.asarray(centers), jrots))
    assert (got[~am] == BIG).all() and (want[~am] == BIG).all()
    np.testing.assert_allclose(got[am], want[am], atol=1e-5)
    r = np.random.default_rng(SEED)
    axis = r.normal(size=(K, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = r.uniform(-0.5, 0.5, K).astype(np.float32)
    got = psub._axis_angle_rotate(pc, _t(centers), _t(axis), _t(angle))
    want = jsub._axis_angle_rotate(jc, jnp.asarray(centers),
                                   jnp.asarray(axis), jnp.asarray(angle))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mol_energy_force_matches_jax(case):
    """mol_energy_force's energies, net forces and per-atom forces of K
    trials (types [m] and [K, m]) within 1e-5 of each one's largest
    magnitude; some trials overlap the subset (nonzero energy)."""
    _, pcfg, jcfg, ps, js, ts = case
    pc, jc, types, _ = _trials(case)
    for pt, jt in ((_t(types, torch.int32), jnp.asarray(types)),
                   (_t(ts.types[0], torch.int32),
                    jnp.asarray(ts.types[0].astype(np.int32)))):
        e, f, fa = psub.mol_energy_force(pcfg, ps, pc, pt, per_atom=True)
        je, jf, jfa = jsub.mol_energy_force(jcfg, js, jc, jt, per_atom=True)
        for got, want in ((e, je), (f, jf), (fa, jfa)):
            want = np.asarray(want)
            scale = max(np.abs(want).max(), 1.0)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * scale)
        assert (np.asarray(je) != 0.0).sum() >= K // 2


@pytest.mark.parametrize("nattempt", [0, 1, 3, 12])
def test_usher_search_mol_matches_jax(case, nattempt):
    """usher_search_subset_mol at nattempt 0, 1, 3 and 12 (translation
    along the net force and rotation along the all-atom torque each
    iteration) on the same trials: verdicts and iteration counts exact,
    positions within 1e-4; the 12-iteration search moves some trials,
    accepts some and counts iterations."""
    law, pcfg, jcfg, ps, js, _ = case
    pcfg = dataclasses.replace(pcfg, obmd=dataclasses.replace(
        pcfg.obmd, usher=dataclasses.replace(pcfg.obmd.usher,
                                             nattempt=nattempt)))
    jcfg = to_jax(pcfg)
    pc, jc, types, _ = _trials(case)
    region = pcfg.obmd.region5
    pos, acc, it = psub.usher_search_subset_mol(
        pcfg, ps, pc, _t(types, torch.int32), region)
    jpos, jacc, jit = jsub.usher_search_subset_mol(
        jcfg, js, jc, jnp.asarray(types), jcfg.obmd.region5)
    assert np.array_equal(acc.numpy(), np.asarray(jacc))
    assert np.array_equal(it.numpy(), np.asarray(jit))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=1e-4)
    if nattempt == 12:
        moved = np.abs(pos.numpy() - pc.numpy()).max(axis=(1, 2)) > 1e-3
        assert moved.any() and acc.any() and int(it.sum()) > 0


def test_near_check_mol_matches_jax(case):
    """near_check_subset_mol under `near 0.6` (the USHER keyword swapped
    for near): every verdict as the JAX package's, both verdicts seen."""
    _, pcfg, _, ps, js, _ = case
    pcfg = dataclasses.replace(pcfg, obmd=dataclasses.replace(
        pcfg.obmd, usher=None, near=0.6))
    jcfg = to_jax(pcfg)
    pc, jc, _, _ = _trials(case)
    got = psub.near_check_subset_mol(pcfg, ps, pc).numpy()
    want = np.asarray(jsub.near_check_subset_mol(jcfg, js, jc))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("budget", [0, 1, 2, 16])
@pytest.mark.parametrize("near", [False, True])
def test_mol_sequential_accept_matches_jax(case, budget, near):
    """mol_sequential_accept on trials packed into a quarter of the
    insertion region (so that some pairs of trials clash), with every
    third trial not ok: accepted flags and the count exact, under USHER's
    energy rule and under `near`."""
    _, pcfg, _, _, _, ts = case
    if near:
        pcfg = dataclasses.replace(pcfg, obmd=dataclasses.replace(
            pcfg.obmd, usher=None, near=0.6))
    jcfg = to_jax(pcfg)
    r = np.random.default_rng(SEED + budget)
    reg = pcfg.obmd.region5
    hi = np.asarray(reg.lo) + 0.25 * (np.asarray(reg.hi) - reg.lo)
    centers = r.uniform(reg.lo, hi, (K, 3))
    coords = (centers[:, None] + ts.dx[0][None]).astype(np.float32)
    ok = np.arange(K) % 3 != 2
    types = np.broadcast_to(ts.types[0], coords.shape[:2]).astype(np.int32)
    acc, cnt = psub.mol_sequential_accept(
        pcfg, _t(coords), _t(types, torch.int32), _t(ok, torch.bool),
        torch.tensor(budget, dtype=torch.int32))
    jacc, jcnt = jsub.mol_sequential_accept(
        jcfg, jnp.asarray(coords), jnp.asarray(types), jnp.asarray(ok),
        jnp.int32(budget))
    assert np.array_equal(acc.numpy(), np.asarray(jacc))
    assert int(cnt) == int(jcnt) == int(acc.sum())
    if budget == 16:
        assert 0 < int(cnt) < int(ok.sum())


def _star_states(pcfg, jcfg, seed=SEED):
    """Both packages' init_state of mol_box_start's monomers and stars with
    five stars moved to straddle the faces (three across the low face,
    two across the high one) and one molecule id left on a monomer."""
    x, v, types, mol, bonds, impropers = pscenes.mol_box_start(pcfg, seed)
    lx = pcfg.box.hi[0]
    for s, shift in ((1, -0.2), (2, -0.4), (3, 0.0), (4, lx - 0.3),
                     (5, lx + 0.1)):
        rows = slice(5 * s, 5 * s + 5)
        x[rows, 0] += shift - x[5 * s, 0]
    mol = mol.copy()
    mol[-1] = 99
    kw = dict(v=v, types=types, mol=mol, bonds=bonds, impropers=impropers)
    return (pinit_state(pcfg, x, device=CPU, **kw),
            jinit_state(jcfg, x, **kw))


def test_delete_outside_doom_propagation_matches_jax():
    """delete_outside in MOLECULE mode on the full store: every star with
    an atom beyond an x face goes whole (doom spread along the four
    partner columns), alive, tag, v and the deleted count exact, the
    deleted momentum per side within 1e-5; the partner columns stay as
    they were, as in the JAX package."""
    pcfg = pscenes.mol_box_config("dpd")
    jcfg = to_jax(pcfg)
    pst, jst = _star_states(pcfg, jcfg)
    pout, pl, pr = pstage.delete_outside(pcfg, pst)
    jout, jl, jr = jstage.delete_outside(jcfg, jst)
    for k in ("alive", "tag", "v", "bond1", "bond2", "bond3", "bond4"):
        assert np.array_equal(getattr(pout, k).numpy(),
                              np.asarray(getattr(jout, k))), k
    assert int(pout.obmd.ndeleted) == int(jout.obmd.ndeleted)
    gone = (~pout.alive.numpy()) & pst.alive.numpy()
    assert gone.sum() >= 15 and gone.sum() % 5 == 0
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), atol=1e-5)
    assert np.abs(pl.numpy()).sum() > 0 and np.abs(pr.numpy()).sum() > 0


def test_update_mol_com_matches_jax():
    """update_mol_com over the four partner columns (mol_natoms_max - 1 =
    4 rounds): cms_mol and vcms_mol of every alive atom within 1e-5; each
    star's cms the mean of its atoms' positions; zero for monomers."""
    pcfg = pscenes.mol_box_config("dpd")
    jcfg = to_jax(pcfg)
    pst, jst = _star_states(pcfg, jcfg)
    assert padress.mol_com_rounds(pcfg) == jadress.mol_com_rounds(jcfg) == 4
    got = padress.update_mol_com(pcfg, pst)
    want = jadress.update_mol_com(jcfg, jst)
    for k in ("cms_mol", "vcms_mol"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-5,
                                   err_msg=k)
    x = pst.x.numpy()
    cms = got.cms_mol.numpy()
    np.testing.assert_allclose(cms[:5], np.broadcast_to(x[:5].mean(0),
                                                        (5, 3)), atol=1e-5)
    n = int(pst.natoms)
    assert (cms[100:n - 1] == 0.0).all()
