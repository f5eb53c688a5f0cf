"""The x-slab decomposition of the port (obmd_tpu_torch/parallel/
slab_decomp.py) against the JAX package's on a 4-device CPU mesh, slot for
slot, and against the port's own single-device sweep engine by tag.

Every port case runs in one spawn of 4 gloo ranks on the CPU (a hard
timeout kills them); the JAX slab steps run in this process, and their
candidate draws are replayed into the port's ranks.  The exact parities
search with nattempt = 0 (an USHER verdict at the etarget gate hangs on
the float32 order of the sums over the ranks)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from obmd_tpu import config as jconfig
from obmd_tpu import scenes as jscenes
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.parallel import slab_decomp as jslab
from obmd_tpu.state import init_state as jinit
from obmd_tpu_torch import convert
from obmd_tpu_torch.config import ShakeParams
from obmd_tpu_torch.integrate import make_step as pmake_step
from obmd_tpu_torch.parallel import comm as pcomm
from obmd_tpu_torch.parallel import ranks as pranks
from obmd_tpu_torch.parallel import slab_decomp as pslab

from test_torch_support import jax_arrays

NDEV = 4
STEPS = 10
TIMEOUT_S = 150.0


def jax_stage_draws(cfg, key, steps, slab=True):
    """The draws of the JAX stage calls on `steps`, replaying its key
    chain from `key` (the state's key): per call, keys = split(fold_in(key,
    step), 2R + 1), the last carried; the positions' uniform(keys[i], (K,
    3)) (normal under `gaussian`), side-major; the deposit z's
    uniform(fold_in(keys[i], 0x5a), (K,)); the velocities' uniforms from
    split(fold_in(k, 7), 3), k the carried key on the slab step
    (slab_decomp.py:1546) and the step's key on the single-device ones.
    The draws take the scene's dtype, as the JAX stage draws in the
    state's (a float64 scene needs jax_enable_x64 on)."""
    o = cfg.obmd
    real = jnp.dtype(cfg.dtype)
    rounds, k = max(1, int(o.maxattempt)), o.insert_kmax
    draw = jax.random.normal if o.gaussian is not None \
        else jax.random.uniform
    seq = []
    for s in steps:
        step_key = jax.random.fold_in(key, jnp.uint32(s))
        keys = jax.random.split(step_key, 2 * rounds + 1)
        key = keys[-1]
        d = dict(pos=np.stack([np.asarray(draw(keys[i], (k, 3),
                                               dtype=real))
                               for i in range(2 * rounds)])
                 .reshape(2, rounds, k, 3))
        if o.deposit_global is not None or o.deposit_local is not None:
            d["z"] = np.stack([np.asarray(jax.random.uniform(
                jax.random.fold_in(keys[i], 0x5a), (k,), dtype=real))
                for i in range(2 * rounds)]).reshape(2, rounds, k)
        if any(v is not None for v in (o.vx, o.vy, o.vz)):
            kv = jax.random.split(jax.random.fold_in(
                keys[-1] if slab else step_key, 7), 3)
            d["vel"] = np.stack([np.asarray(jax.random.uniform(
                kc, (2 * rounds * k,), dtype=real)) for kc in kv])
        seq.append(d)
    return seq


def _obmd(scale=0.35, nbuf=1000.0, **obmd_kw):
    """OBMD_DPD at `scale` (seed 3, cap 28, the sweep engine) with nbuf
    raised so that both faces insert, USHER at nattempt 0 with etarget 47
    (unmoved candidates pass in the gas), and the fix keywords given."""
    sc = jscenes.obmd_dpd_scene(scale=scale, seed=3, insert_kmax=4,
                                cell_capacity=28, force_path="sweep",
                                nbuf=nbuf)
    usher = dataclasses.replace(sc.cfg.obmd.usher, nattempt=0, etarget=47.0)
    if obmd_kw.get("near") is not None:
        usher = None
    cfg = dataclasses.replace(sc.cfg, obmd=dataclasses.replace(
        sc.cfg.obmd, usher=usher, **obmd_kw)).finalize()
    return cfg, jsetup(cfg, sc.state)


def _open_box(temp, n=600, seed=11):
    """JAX's kernel-parity box (test_slab.py:166-208) with y and z of 5
    cells (7.5 at cut + skin 1.3): no stage, DPD at `temp`."""
    box = JBox((0.0, 0.0, 0.0), (16.0, 7.5, 7.5), (False, True, True))
    r = np.random.default_rng(seed)
    x = r.uniform([0.05, 0.05, 0.05], [15.95, 7.45, 7.45], (n, 3))
    v = r.normal(0, 0.5, (n, 3))
    cfg = jconfig.SceneConfig(
        box=box, masses=(1.0,), dt=0.004,
        pair=jconfig.DPDParams.create(temp=temp, cutoff=1.0, seed=5,
                                      a0=25.0, gamma=3.0),
        capacity=jconfig.Capacity(n_max=n, cell_capacity=20),
        skin=0.3, force_path="nlist").finalize()
    return cfg, jsetup(cfg, jinit(cfg, x, v=v))


def _skewed():
    """JAX's balancing scene (test_slab.py:274-365): 800 atoms stretching
    right from the left 40% of an open 16 x 4 x 4 box, no pair force."""
    box = JBox((0.0, 0.0, 0.0), (16.0, 4.0, 4.0), (False, True, True))
    cfg = jconfig.SceneConfig(
        box=box, masses=(1.0,), dt=0.05,
        pair=jconfig.DPDParams.create(temp=0.0, cutoff=1.0, seed=1, a0=0.0,
                                      gamma=0.0),
        capacity=jconfig.Capacity(n_max=1024, cell_capacity=32),
        skin=0.3, force_path="sweep").finalize()
    r = np.random.default_rng(0)
    x = r.uniform([0.1, 0.0, 0.0], [6.4, 4.0, 4.0], (800, 3))
    v = np.c_[r.uniform(0.5, 3.0, 800), r.normal(0, 0.1, (800, 2))]
    return cfg, jsetup(cfg, jinit(cfg, x, v=v))


def _jax_run(cfg, state, steps, geom_kw=None, **step_kw):
    mesh = jslab.make_mesh(NDEV)
    geom = jslab.make_slab_geom(cfg, NDEV, **(geom_kw or {}))
    s = jslab.shard_by_slab(cfg, geom, state, mesh)
    if step_kw.get("balance_every"):
        s = jslab.with_balance_cuts(geom, s)
    step = jslab.make_slab_step(cfg, mesh, geom, **step_kw)
    for _ in range(steps):
        s = jax.block_until_ready(step(s))
    return s


CASES = {
    # name: (scene, steps, slab geometry, JAX step kwargs, port force_impl)
    "main": (lambda: _obmd(), STEPS, {}, {}, "gathered"),
    "keywords": (lambda: _obmd(near=0.35, maxattempt=2, id_policy="max",
                               vx=(-1.0, 1.0), nfreq=2), STEPS, {}, {},
                 "gathered"),
    "kernel_t0": (lambda: _open_box(0.0), 3, dict(n_loc=200),
                  dict(force_impl="pallas"), "kernel"),
    "kernel_t1": (lambda: _open_box(1.0), 3, dict(n_loc=200),
                  dict(force_impl="pallas"), "kernel"),
    "balance": (_skewed, 12, dict(grow=2.5, n_loc=512, m_max=256),
                dict(balance_every=1), "gathered"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case through the JAX slab step and, in one spawn, the port's;
    plus the main scene on the port's ranks with their own draws."""
    jax_out, port_runs, scenes = {}, [], {}
    for name, (make, steps, geom_kw, jkw, impl) in CASES.items():
        cfg, st = make()
        pcfg = convert.scene_config(cfg).finalize()
        nfreq = cfg.obmd.nfreq if cfg.obmd is not None else 1
        stage_steps = [s for s in range(int(st.step), int(st.step) + steps)
                       if s % nfreq == 0] if cfg.obmd is not None else []
        draws = jax_stage_draws(cfg, st.key, stage_steps) \
            if cfg.obmd is not None else None
        js = _jax_run(cfg, st, steps, geom_kw, **jkw)
        jax_out[name] = jax_arrays(js.replace(nbrs=None))
        if jkw.get("balance_every"):
            jax_out[name]["cuts"] = np.asarray(js.nbrs.cuts)
        scenes[name] = (pcfg, jax_arrays(st), draws)
        port_runs.append(dict(
            cfg=pcfg, arrays=jax_arrays(st), seed=7, steps=steps,
            geom=geom_kw, force_impl=impl, draws=draws,
            balance_every=jkw.get("balance_every", 0)))
    pcfg, arrays, _ = scenes["main"]
    port_runs.append(dict(cfg=pcfg, arrays=arrays, seed=7, steps=STEPS))
    res = pcomm.spawn(pranks.slab_runs, NDEV, "gloo", "cpu", TIMEOUT_S,
                      port_runs, store_dir=str(tmp_path_factory.mktemp("fs")))
    port = {name: res[0][i]["state"] for i, name in enumerate(CASES)}
    port["own_draws"] = res[0][len(CASES)]["state"]
    return dict(jax=jax_out, port=port, scenes=scenes, ranks=res)


def _same_slots(p, j, x_tol=1e-5, v_tol=1e-4):
    for k in ("tag", "alive", "type"):
        assert np.array_equal(p[k], j[k]), k
    for k in ("step", "maxtag", "cell_overflow", "ndeleted", "ninserted",
              "insert_fail", "usher_iters"):
        assert int(p[k]) == int(j[k]), k
    a = j["alive"]
    np.testing.assert_allclose(p["x"][a], j["x"][a], rtol=0, atol=x_tol)
    np.testing.assert_allclose(p["v"][a], j["v"][a], rtol=0, atol=v_tol)


def _by_tag(s):
    a = s["alive"]
    return dict(zip(s["tag"][a].tolist(), s["x"][a]))


@pytest.mark.parametrize("case", ["main", "keywords"])
def test_slab_matches_jax(runs, case):
    p, j = runs["port"][case], runs["jax"][case]
    _same_slots(p, j)
    assert int(j["cell_overflow"]) == 0
    assert int(j["ninserted"]) > 0 and int(j["ndeleted"]) > 0
    for k in ("momentum_force_left", "momentum_force_right"):
        np.testing.assert_allclose(p[k], j[k], rtol=1e-5, atol=1e-3)


def test_slab_matches_sweep(runs):
    """The slab step against the port's single-device sweep engine from
    the same state and draws, by tag (JAX's test_slab.py:51-65)."""
    from obmd_tpu_torch.parallel.ranks import ReplayDraws
    pcfg, arrays, draws = runs["scenes"]["main"]
    state = convert.from_arrays(arrays, seed=7, device="cpu")
    step = pmake_step(pcfg, ReplayDraws(draws))
    for _ in range(STEPS):
        state = step(state)
    ref = convert.to_arrays(state)
    got = runs["port"]["main"]
    for k in ("ndeleted", "ninserted", "cell_overflow"):
        assert int(got[k]) == int(ref[k]), k
    m1, m2 = _by_tag(got), _by_tag(ref)
    assert set(m1) == set(m2)
    assert max(np.abs(m1[t] - m2[t]).max() for t in m1) < 1e-4


def test_slab_own_draws(runs):
    """With the state's generator: every rank drew the same numbers, and
    the run matches the sweep engine on the same seed by tag."""
    assert all(r[len(CASES)]["same_draws"] for r in runs["ranks"])
    pcfg, arrays, _ = runs["scenes"]["main"]
    state = convert.from_arrays(arrays, seed=7, device="cpu")
    step = pmake_step(pcfg)
    for _ in range(STEPS):
        state = step(state)
    ref = convert.to_arrays(state)
    got = runs["port"]["own_draws"]
    assert int(got["ninserted"]) == int(ref["ninserted"]) > 0
    m1, m2 = _by_tag(got), _by_tag(ref)
    assert set(m1) == set(m2)
    assert max(np.abs(m1[t] - m2[t]).max() for t in m1) < 1e-4


@pytest.mark.parametrize("case", ["kernel_t0", "kernel_t1"])
def test_slab_kernel_matches_pallas(runs, case):
    """force_impl="kernel" (the plain version of obmd_pair on the CPU)
    against JAX's force_impl="pallas" in interpret mode, slot for slot
    within 1e-5: at temp 0 and with noise (the kernel's hash is JAX's)."""
    _same_slots(runs["port"][case], runs["jax"][case], v_tol=1e-5)


def test_slab_balance_matches_jax(runs):
    """balance_every=1 on the skewed scene: the live cuts bin for bin and
    the state slot for slot."""
    p, j = runs["port"]["balance"], runs["jax"]["balance"]
    _same_slots(p, j)
    i = list(CASES).index("balance")
    cuts = runs["ranks"][0][i]["cuts"]
    assert np.array_equal(cuts, runs["jax"]["balance"]["cuts"])
    assert all(r[i]["outside"] == 0 for r in runs["ranks"])
    assert not np.allclose(cuts, np.linspace(0.0, 16.0, NDEV + 1))


def test_slab_ownership(runs):
    """After every run each rank's live atoms lie inside its slab."""
    for r in runs["ranks"]:
        assert all(run["outside"] == 0 for run in r)


def test_slab_refusals():
    """The slab step takes the molecule terms and SHAKE
    (tests/test_torch_slab_mol.py, test_torch_slab_constraints.py) and
    refuses what every engine refuses, bonded terms under ATOM-mode
    insertion (engine_cellpad.check_scene), and rigid bodies without the
    molecule template whose span sizes the halo; JAX's own refusals keep
    their texts."""
    sc = jscenes.obmd_dpd_scene(scale=0.35, seed=3, force_path="sweep")
    pcfg = convert.scene_config(sc.cfg).finalize()
    solo = pcomm.Comm.solo("cpu")
    bond = convert.bonded_params(jconfig.BondHarmonicParams(k=10.0, r0=0.5))
    with pytest.raises(NotImplementedError, match="ATOM-mode insertion"):
        pslab.make_slab_step(dataclasses.replace(pcfg, bond=bond), solo)
    closed = dataclasses.replace(pcfg, obmd=None)
    for kw in (dict(bond=bond), dict(shake=ShakeParams(d0=((0.5,),)))):
        assert callable(pslab.make_slab_step(
            dataclasses.replace(closed, **kw), solo))
    with pytest.raises(NotImplementedError, match="molecule template"):
        pslab.make_slab_step(dataclasses.replace(closed, rigid=True), solo)
    per = dataclasses.replace(pcfg, box=dataclasses.replace(
        pcfg.box, periodic=(True, True, True)), obmd=None)
    with pytest.raises(ValueError, match="open \\(non-periodic\\) x"):
        pslab.make_slab_geom(per, 2)
    with pytest.raises(ValueError, match="halo width"):
        pslab.make_slab_geom(pcfg, 16)
