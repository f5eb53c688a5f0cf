"""Float64 scenes with bonded terms and SHAKE/RATTLE against the JAX
package's under jax_enable_x64, on the CPU, from one start per case.

- The FENE chain melt of test_torch_support.chain_states (28 chains of
  49 beads, the Langevin thermostat) with harmonic angles and a harmonic
  dihedral added, on the nlist engine: five make_step steps.
- The small star melt of test_torch_star (307 four-arm stars: harmonic
  bonds, the six angles of each centre and its improper, a branched
  topology), on the nlist engine: four steps.
- The chain melt again on the cellpad engine, the JAX pair kernel in
  interpret mode: setup and one step.
- The dilute SPC/E water box of test_torch_shake (150 waters, SHAKE and
  RATTLE, the reaction field), on the nlist engine: three steps.

On the nlist engine x and v within 1e-9 of the box length and f within
1e-9 x max|f| after every step, the constraint error equal to JAX's
within 1e-12; on the cellpad engine tags, alive and the kernel caches
exact and f within 2e-4 x max|f| (the pair kernel's float32 fields; the
bonded forces are added in float64 on both sides).  Every float leaf of
both states is float64."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from obmd_tpu import config as jconfig
from obmd_tpu import shake as jshake
from obmd_tpu.integrate import make_step as jmake_step
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.io import lammps_data as jio
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch import shake as pshake
from obmd_tpu_torch.integrate import make_step, setup
from obmd_tpu_torch.state import init_state

import test_torch_shake as water
import test_torch_star as star
from test_torch_float64 import port_float_leaves
from test_torch_obmd_lj import to_jax
from test_torch_support import CPU, chain_states, jax_arrays, jittered

F64 = "float64"


@pytest.fixture(scope="module", autouse=True)
def x64():
    """jax_enable_x64 on for this module's tests, restored after them."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def chain(path):
    """(JAX cfg, JAX state, port cfg, port state) of the chain melt with
    angles and a dihedral at float64 on `path`, not set up."""
    jcfg, _, pcfg, _ = chain_states()
    angle = dict(k=(5.0,), theta0=(120.0,))
    dihedral = dict(k=1.5, d=1, n=2)
    jcfg = dataclasses.replace(
        jcfg, dtype=F64, force_path=path,
        angle=jconfig.AngleHarmonicParams(**angle),
        dihedral=jconfig.DihedralHarmonicParams(**dihedral)).finalize()
    pcfg = dataclasses.replace(
        pcfg, dtype=F64, force_path=path,
        angle=pconfig.AngleHarmonicParams(**angle),
        dihedral=pconfig.DihedralHarmonicParams(**dihedral)).finalize()
    x, mol, bonds = pscenes.chain_lattice(7, 49)
    x = jittered(pcfg, x, 3, 0.06).astype(np.float64)
    v = np.random.default_rng(3).normal(0.0, 1.0, x.shape)
    kw = dict(v=v, mol=mol, bonds=bonds)
    return (jcfg, jinit_state(jcfg, x, **kw), pcfg,
            init_state(pcfg, x, device=CPU, **kw))


def star_melt(path, tmp_path):
    """The same for the small star melt (test_torch_star's start)."""
    sc = pscenes.star_melt_scene(n_stars=star.N_STARS, seed=star.SEED,
                                 device=CPU)
    data = str(tmp_path / "stars.data")
    pscenes.write_star_data(data, star.N_STARS, star.SEED)
    df = jio.read_data(data, atom_style="molecular")
    pcfg = pscenes.with_cap(sc.cfg, pscenes.STAR_WARM_CAP)
    jcfg = dataclasses.replace(star.jax_star_config(pcfg), dtype=F64,
                               force_path=path).finalize()
    pcfg = dataclasses.replace(pcfg, dtype=F64, force_path=path).finalize()
    r = np.random.default_rng(star.SEED)
    side = pcfg.box.hi[0]
    centers = r.uniform(0.0, side, (star.N_STARS, 3))
    dx = np.einsum("sij,kj->ski", pscenes._rotations(r, star.N_STARS),
                   star._relaxed_star())
    x = np.mod(centers[:, None, :] + dx, side).reshape(-1, 3)
    jst = jinit_state(jcfg, x, v=df.v, types=df.types, tags=df.tags,
                      mol=df.mol, bonds=df.bonds, impropers=df.impropers)
    return jcfg, jst, pcfg, convert.from_arrays(jax_arrays(jst), device=CPU)


def water_box(path):
    """The same for the dilute water box (test_torch_shake's)."""
    pcfg = dataclasses.replace(water._cfg(path), dtype=F64).finalize()
    jcfg = to_jax(pcfg)
    x, types, q, mol, bonds = water._waters(150, 4)
    v = np.random.default_rng(5).normal(0.0, 0.6, x.shape)
    kw = dict(v=v, types=types, q=q, mol=mol, bonds=bonds)
    return (jcfg, jinit_state(jcfg, x, **kw), pcfg,
            init_state(pcfg, x, device=CPU, **kw))


def run_both(jcfg, jst, pcfg, pst, steps):
    """[(JAX arrays, port arrays)] after setup and each step, both states
    at the end."""
    jst, pst = jsetup(jcfg, jst), setup(pcfg, pst)
    out = [(jax_arrays(jst), convert.to_arrays(pst))]
    jstep, pstep = jax.jit(jmake_step(jcfg)), make_step(pcfg)
    for _ in range(steps):
        jst, pst = jstep(jst), pstep(pst)
        out.append((jax_arrays(jst), convert.to_arrays(pst)))
    return out, jst, pst


def assert_float64(jd, pst):
    for k in ("x", "v", "f", "q", "sim_time"):
        assert jd[k].dtype == np.float64, k
    assert all(t.dtype == torch.float64
               for t in port_float_leaves(pst).values())


CASES = {"chain": (chain, 5), "star": (star_melt, 4), "water": (water_box, 3)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_nlist_float64_matches_jax(case, tmp_path):
    make, steps = CASES[case]
    args = make("nlist", tmp_path) if case == "star" else make("nlist")
    jcfg, pcfg = args[0], args[2]
    out, jst, pst = run_both(*args, steps)
    assert_float64(out[-1][0], pst)
    box = max(pcfg.box.lengths)
    for jd, pd in out:
        for k in ("tag", "alive", "type", "bond1", "bond2"):
            assert np.array_equal(np.asarray(pd[k]), jd[k]), k
        for k in ("x", "v"):
            np.testing.assert_allclose(pd[k], jd[k], rtol=0,
                                       atol=1e-9 * box, err_msg=k)
        fmax = np.abs(jd["f"]).max()
        assert np.abs(pd["f"] - jd["f"]).max() <= 1e-9 * fmax
    if pcfg.shake is not None:
        got = float(pshake.constraint_error(pcfg, pst))
        want = float(jshake.constraint_error(jcfg, jst))
        assert abs(got - want) <= 1e-12 and got <= 1e-6


def test_cellpad_chain_float64_matches_jax():
    out, _, pst = run_both(*chain("cellpad"), 1)
    assert_float64(out[-1][0], pst)
    for jd, pd in out:
        for k in ("tag", "alive", "tag3d", "occ", "bond1", "bond2"):
            assert np.array_equal(np.asarray(pd[k]), jd[k]), k
        fmax = np.abs(jd["f"]).max()
        assert np.abs(pd["f"] - jd["f"]).max() <= 2e-4 * fmax
