"""The open-boundary LJ fluid (scenes.obmd_lj_scene) against the JAX engine
on its 5,184-atom box (16 x 9 x 9 fcc cells: Lx = 16a, Ly = Lz = 9a, a 9 x 5
x 5 cell grid, x open, p == 1 in 128 lanes, cap 44), the JAX configuration
built field for field from the port's.

Held: the configuration mirror; the Langevin thermostat's deviates bit for
bit and its forces to 1e-6 of max|f|; the lj/cut branch of
_sequential_accept exactly; setup and four steps of the whole path at
nattempt = 0 (each candidate's verdict its initial energy against the gate,
which no summation order flips; nbuf raised so that both buffers ask for
atoms) with the JAX engine's candidate draws injected: slots, tags, alive,
the kernel caches and every counter exact, x, v and the setpoints within
1e-4, forces within 2e-4 * max|f| (float32 summation order; the bar of
tests/test_bigtile.py); and the pair kernel's plain version on open-x LJ
against JAX's pair_sweep and make_pair_kernel on a jittered lattice."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import obmd_tpu.config as jconfig
import obmd_tpu.geometry as jgeometry
from obmd_tpu import rng as jrng
from obmd_tpu.engine_cellpad import make_geometry as j_make_geometry
from obmd_tpu.engine_cellpad import supports as jsupports
from obmd_tpu.forces.pallas_dpd import make_pair_kernel as j_make_pair_kernel
from obmd_tpu.forces.bonded import langevin_force as jlangevin_force
from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.obmd.stage import _sequential_accept as j_accept
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.engine_cellpad import (auto_rebuild_every, make_geometry,
                                           pack_fields, supports as psupports)
from obmd_tpu_torch.forces.bonded import langevin_force, langevin_uniform
from obmd_tpu_torch.forces.pair_kernel import make_pair_kernel
from obmd_tpu_torch.integrate import make_run as pmake_run
from obmd_tpu_torch.integrate import setup as psetup
from obmd_tpu_torch.obmd.stage import _sequential_accept as p_accept
from obmd_tpu_torch.state import init_state as pinit_state

from test_torch_lj import assert_close, jax_sweep
from test_torch_support import (CPU, JaxDraws, _mirror, assert_states_match,
                                jax_arrays, jittered)

NX, NY, SEED, STEPS = 16, 9, 2, 4


def to_jax(obj):
    """The JAX package's config object with the port object's fields."""
    if dataclasses.is_dataclass(obj):
        name = type(obj).__name__
        cls = getattr(jconfig, name, None) or getattr(jgeometry, name)
        return cls(**{f.name: to_jax(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj


def configs(**kw):
    pcfg = pscenes.obmd_lj_config(nx=NX, ny=NY, **kw)
    return to_jax(pcfg), pcfg


def start(pcfg):
    """The scene's initial positions and velocities (numpy float32)."""
    sc = pscenes.obmd_lj_scene(nx=NX, ny=NY, device=CPU)
    n = 4 * NX * NY * NY
    return sc.state.x[:n].numpy(), sc.state.v[:n].numpy()


def test_config_mirrors_jax_and_layout():
    """Both engines support the open LJ fluid at full and at small size;
    the full size is OBMD_DPD's layout (8 x 8 y/z cells, 64 cells in 128
    lanes, p = 2) at cap 44, with a relayout every 4 steps."""
    for kw in (dict(), dict(nx=NX, ny=NY)):
        pcfg = pscenes.obmd_lj_config(**kw)
        jcfg = to_jax(pcfg)
        _mirror(pcfg, jcfg)
        assert psupports(pcfg) and jsupports(jcfg)
    geom = make_geometry(pscenes.obmd_lj_config())
    assert (geom.dims, geom.s, geom.p, geom.lanes, geom.cap) == \
        ((74, 8, 8), 64, 2, 128, 44)
    assert auto_rebuild_every(pscenes.obmd_lj_config()) == 4
    small = make_geometry(configs()[1])
    assert (small.dims, small.p, small.lanes) == ((9, 5, 5), 1, 128)


@pytest.mark.parametrize("temp", [0.722, 1.5, 4.0])
def test_rebuild_period_reads_langevin_temp(temp):
    """auto_rebuild_every takes the highest temperature of the pair law
    and the Langevin thermostat, at least 1, as the JAX engine does: a
    thermostat above T = 1 shortens the relayout period."""
    from obmd_tpu.engine_cellpad import auto_rebuild_every as j_every
    from obmd_tpu_torch.config import LangevinParams
    pcfg = dataclasses.replace(pscenes.obmd_lj_config(),
                               langevin=LangevinParams(temp=temp, damp=1.0))
    got = auto_rebuild_every(pcfg)
    assert got == j_every(to_jax(pcfg))
    assert (got == 4) == (temp <= 1.0)


def test_lattice_start_fits_the_relayout():
    """The full-size start: 100,352 atoms inside the box, none on an open
    face, and one epoch (4 steps) of free flight at the start velocities
    moves fewer atoms across cells than the relayout's mover budget
    (n_slots // 32)."""
    sc = pscenes.obmd_lj_scene(device=CPU)
    cfg, x, v = sc.cfg, sc.state.x, sc.state.v
    assert x.shape[0] == 100352
    assert float(x[:, 0].min()) > 0.0 and float(x[:, 0].max()) < \
        cfg.box.hi[0]
    geom = make_geometry(cfg)
    x2 = cfg.box.wrap(x + 4 * cfg.dt * v)
    movers = int((geom.cell_of(x) != geom.cell_of(x2)).sum())
    assert movers < geom.n_slots // 32, movers


def _langevin_states():
    jcfg, pcfg = configs()
    x, v = start(pcfg)
    n = len(x)
    r = np.random.default_rng(4)
    v = r.normal(0.0, 1.0, v.shape).astype(np.float32)
    jst = jinit_state(jcfg, x, v=v)
    pst = pinit_state(pcfg, x, v=v, device=CPU)
    dead = r.choice(n, 40, replace=False)
    alive = np.ones(n, bool)
    alive[dead] = False
    tag = np.where(alive, np.arange(1, n + 1), -1).astype(np.int32)
    jst = jst.replace(alive=jnp.asarray(alive), tag=jnp.asarray(tag),
                      step=jnp.int32(77))
    pst = pst.replace(alive=torch.from_numpy(alive),
                      tag=torch.from_numpy(tag), step=77)
    return jcfg, pcfg, jst, pst


def test_langevin_matches_jax():
    """langevin_force (forces/bonded.py:523-539): the per-(tag, axis,
    step) deviates bit for bit, the forces within 1e-6 of max|f|, zero on
    dead slots."""
    jcfg, pcfg, jst, pst = _langevin_states()
    lp = jcfg.langevin
    salt = jrng.step_salt(lp.seed, jst.step, 3)
    tagu = jst.tag.astype(jnp.uint32)
    want = np.stack([np.asarray(jrng.uniform01(
        jrng.hash3(tagu, jnp.uint32(a + 1), salt)) - 0.5) for a in range(3)],
        axis=-1)
    got = langevin_uniform(pcfg.langevin, pst.step, pst.tag).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    fj = np.asarray(jlangevin_force(lp, jcfg, jst))
    fp = langevin_force(pcfg.langevin, pcfg, pst).numpy()
    scale = np.abs(fj).max()
    assert scale > 10.0
    np.testing.assert_allclose(fp, fj, rtol=0, atol=1e-6 * scale)
    assert (fp[~pst.alive.numpy()] == 0.0).all()


@pytest.mark.parametrize("etarget", [pscenes.OBMD_LJ_ETARGET, 0.5])
@pytest.mark.parametrize("budget", [3, 16])
def test_sequential_accept_lj_matches_jax(budget, etarget):
    """The lj/cut branch (stage.py:241-245), exactly: the pair energy is
    infinite closer than the cutoff and zero beyond, against etarget +
    eps.  At the scene's negative etarget every two candidates conflict,
    so one is taken; at a positive one only candidates closer than the
    cutoff conflict."""
    _, pcfg = configs()
    pcfg = dataclasses.replace(pcfg, obmd=dataclasses.replace(
        pcfg.obmd, usher=dataclasses.replace(pcfg.obmd.usher,
                                             etarget=etarget)))
    jcfg = to_jax(pcfg)
    r = np.random.default_rng(budget)
    k = 16
    cand = r.uniform([0.0, 0.0, 0.0], [4.0, 9.0, 9.0], (k, 3)) \
        .astype(np.float32)
    ok = r.random(k) < 0.8
    ct = np.zeros(k, np.int32)
    ja, jn = j_accept(jcfg, jnp.asarray(cand), jnp.asarray(ct),
                      jnp.asarray(ok), jnp.int32(budget))
    pa, pn = p_accept(pcfg, torch.from_numpy(cand), torch.from_numpy(ct),
                      torch.from_numpy(ok), torch.tensor(budget))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    assert int(pn) == int(jn) <= budget
    taken = pa.numpy()
    if etarget < 0.0:
        assert taken.sum() == 1
        return
    d = cand[:, None] - cand[None]
    lyz = np.asarray(pcfg.box.lengths[1:])
    d[..., 1:] -= lyz * np.round(d[..., 1:] / lyz)
    close = ((d * d).sum(-1) < 2.5 ** 2) & ~np.eye(k, dtype=bool)
    assert not (close & taken[:, None] & taken[None, :]).any()
    assert 1 < taken.sum() < ok.sum()


def _no_steps(cfg):
    o = cfg.obmd
    return dataclasses.replace(cfg, obmd=dataclasses.replace(
        o, usher=dataclasses.replace(o.usher, nattempt=0)))


@pytest.fixture(scope="module")
def trajectories():
    """Both engines from the same lattice and draws: after setup, then
    after each of four one-step runs (each starts an epoch, so each step
    relayouts), nbuf raised to 1.05 x the buffer census / alpha."""
    jcfg, pcfg = configs()
    o = pcfg.obmd
    nbuf = 1.05 * o.nbuf / o.alpha ** 2
    jcfg, pcfg = (_no_steps(c) for c in configs(nbuf=nbuf))
    x, v = start(pcfg)
    draws = JaxDraws(jcfg, SEED)
    jst = jsetup(jcfg, jinit_state(jcfg, x, v=v, seed=SEED))
    pst = psetup(pcfg, pinit_state(pcfg, x, v=v, device=CPU), draw=draws)
    out = [(jax_arrays(jst), convert.to_arrays(pst))]
    jrun = jax.jit(jmake_run(jcfg, 1))
    prun = pmake_run(pcfg, 1, draw=draws)
    for _ in range(STEPS):
        jst, pst = jrun(jst), prun(pst)
        out.append((jax_arrays(jst), convert.to_arrays(pst)))
    return out, (jcfg, jst), (pcfg, pst)


@pytest.mark.parametrize("i", range(STEPS + 1))
def test_path_matches_jax(trajectories, i):
    """State i (0 = setup): slots, tags, alive, caches and every counter
    exact, x, v and the setpoints within 1e-4, f within 2e-4 * max|f|;
    both buffers asked for atoms (insertions were tried and failed)."""
    jd, pd = trajectories[0][i]
    assert int(jd["insert_fail"]) > 0
    assert_states_match(jd, pd)


def test_observables_match_jax(trajectories):
    """On the ended state: make_thermo_fn on the open x axis (to 1e-5 of
    each quantity's scale), make_profile_fn (density exact, the rest to
    1e-4 of each profile's scale) and make_obmd_metrics_fn (exact)."""
    from obmd_tpu.observe import make_obmd_metrics_fn as j_metrics
    from obmd_tpu.observe import make_profile_fn as j_profiles
    from obmd_tpu.observe import make_thermo_fn as j_thermo
    from obmd_tpu_torch.observe import make_obmd_metrics_fn as p_metrics
    from obmd_tpu_torch.observe import make_profile_fn as p_profiles
    from obmd_tpu_torch.observe import make_thermo_fn as p_thermo
    _, (jcfg, jst), (pcfg, pst) = trajectories
    jt, pt = j_thermo(jcfg)(jst), p_thermo(pcfg)(pst)
    assert int(pt.natoms) == int(jt.natoms)
    for k in ("temp", "pe", "ke", "pressure", "pxx", "press_tensor",
              "epair", "fmax", "fnorm"):
        want = np.asarray(getattr(jt, k))
        got = getattr(pt, k).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    jp, pp = j_profiles(jcfg, nbins=16)(jst), p_profiles(pcfg, nbins=16)(pst)
    np.testing.assert_array_equal(pp.count.numpy(), np.asarray(jp.count))
    for k in ("x_centers", "density", "vx", "temp", "pxx"):
        want = np.asarray(getattr(jp, k))
        np.testing.assert_allclose(getattr(pp, k).numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    jm, pm = j_metrics(jcfg)(jst), p_metrics(pcfg)(pst)
    for k in ("nbuf_left", "nbuf_right", "ninserted", "ndeleted",
              "insert_fail", "usher_iters"):
        assert int(getattr(pm, k)) == int(getattr(jm, k)), k
    assert int(pm.nbuf_left) > 0 and int(pm.insert_fail) > 0


def test_pair_plain_open_x_matches_sweep_and_tpu_kernel():
    """The pair kernel's plain version with the LJ law on this open-x box
    (p == 1, cap 44) on a 0.05-jittered lattice laid out by the port's
    setup: against JAX's pair_sweep and its make_pair_kernel (which agree
    on this box: 5 cells per periodic axis) at 2e-4 * max|f|."""
    jcfg, pcfg = configs()
    x, v = start(pcfg)
    st = psetup(pcfg, pinit_state(pcfg, jittered(jcfg, x), v=v, device=CPU))
    d = convert.to_arrays(st)
    geom = make_geometry(pcfg)
    fld, tag3d, _, occ, _ = pack_fields(pcfg, geom, st)
    f_port = make_pair_kernel(geom, pcfg.pair, pcfg.dt)(fld, tag3d, 0,
                                                        occ).numpy()
    f_tpu = np.asarray(j_make_pair_kernel(
        j_make_geometry(jcfg), params=jcfg.pair, dt=jcfg.dt)(
        jnp.asarray(fld.numpy()), jnp.asarray(d["tag3d"]), jnp.uint32(0),
        jnp.asarray(d["occ"]), None))
    f_sweep, overflow = jax_sweep(jcfg, d)
    assert overflow == 0
    assert_close(f_port, f_sweep, d, "pair vs pair_sweep")
    assert_close(f_port, f_tpu, d, "pair vs make_pair_kernel")
