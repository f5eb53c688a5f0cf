"""Float64 pieces of the port on the CPU, the JAX package under
jax_enable_x64 where a test holds the port to it.

- The float64 USHER search: the kernel's binned algorithm in PyTorch
  (usher_search_binned_plain on the float64 grid) against the plain
  usher_search_subset_batch at float64, on seeded subsets at rho 3 with
  rows on the grid's cell faces, under the deck's own search (nattempt
  40), one step at a time from the plain search's positions: verdicts
  and whether the candidate searches on equal and positions within 1e-9
  x Ly, but within 1e-9 x |etarget| of the gate.  The
  float64 plan: its launch keys, its float64 grid and host arrays, the
  scratch of 8-word rows, and the wrapper's refusal of mixed dtypes.
- thermo, profiles and check_invariants of a float64 state against the
  JAX package's, float64 out.
- A checkpoint of a float64 state loads back float64, bit for bit; the
  converter carries a JAX float64 state across unnarrowed.
- The refusals that remain, each naming its reason in the JAX package: a
  float64 scene with an OBMD stage on the cellpad engine (naming the nlist
  engine), MOLECULE-mode insertion at float64 on the single-device engines
  (naming the slab step, which runs it), a float64 restart in the deck
  Interpreter and the C ABI over it (JAX's Interpreter has no dtype), and
  float16 / bfloat16 anywhere; and what runs at float64 since rigid
  bodies and the multi-device steps were held to JAX under x64 (the slab
  and atom decompositions' checks, rigid bodies on every single-device
  engine)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from obmd_tpu import integrate as jint
from obmd_tpu import observe as jobserve
from obmd_tpu import scenes as jscenes
from obmd_tpu_torch import _build, convert, observe
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.config import SceneConfig
from obmd_tpu_torch.forces.usher_kernel import (UsherPlan, launch,
                                                scratch_words,
                                                usher_energy_binned_plain,
                                                usher_search_binned_plain)
from obmd_tpu_torch.integrate import make_step, setup
from obmd_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from obmd_tpu_torch.obmd.subset import (EPSILON, Subset,
                                        usher_search_subset_batch)

from test_torch_support import CPU, jax_arrays

F64 = torch.float64
N, SEED = 300, 5
BOX_L = (N / 3.0) ** (1.0 / 3.0)


@pytest.fixture(scope="module", autouse=True)
def x64():
    """jax_enable_x64 on for this module's tests, restored after them."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def usher_cfg():
    return pscenes.obmd_dpd_config(scale=0.25, force_path="nlist",
                                   dtype="float64").finalize()


def face_subset(cfg, grid, rng, rho=3.0):
    """A float64 subset around one buffer (the region widened by the grid's
    pad) at density rho, a third of its coordinates on the grid's cell
    faces (lo + k / inv on each axis), every ninth row invalid."""
    lo = np.asarray(grid.lo)
    span = np.asarray(grid.cells) * np.asarray(grid.side)
    b = int(rho * np.prod(span))
    x = lo + rng.uniform(0.0, 1.0, (b, 3)) * span
    face = rng.random((b, 3)) < 1.0 / 3.0
    k = rng.integers(0, np.asarray(grid.cells), (b, 3))
    x = np.where(face, lo + k / np.asarray(grid.inv), x)
    valid = np.ones((b,), bool)
    valid[::9] = False
    return Subset(x=torch.from_numpy(x),
                  type=torch.zeros((b,), dtype=torch.int32),
                  valid=torch.from_numpy(valid),
                  overflow=torch.zeros((), dtype=torch.bool))


def test_usher_binned_float64_matches_plain():
    """One search step at a time from the plain search's positions, so
    that the summation order's drift does not compound: the binned step's
    verdict and whether it searches on equal the plain step's and its
    position lies within 1e-9 x Ly, but within 1e-9 x |etarget| of the
    gate; over the whole searches the candidates both accept and refuse,
    some search past ten steps, and the rows on the cell faces are
    filed where the stencil finds them (the binned energies equal the
    all-pairs ones)."""
    cfg = usher_cfg()
    o, u = cfg.obmd, cfg.obmd.usher
    plan = UsherPlan.of(cfg, o.region5, o.region6, F64)
    rng = np.random.default_rng(11)
    subs = [face_subset(cfg, g, rng) for g in plan.grids]
    assert all(s.x.dtype == F64 for s in subs) and u.nattempt == 40
    k = 16
    cands = [torch.from_numpy(np.asarray(r.lo) + rng.uniform(0, 1, (k, 3))
                              * (np.asarray(r.hi) - np.asarray(r.lo)))
             for r in (o.region5, o.region6)]
    ctype = torch.zeros((k,), dtype=torch.int32)

    def with_steps(n):
        return dataclasses.replace(cfg, obmd=dataclasses.replace(
            o, usher=dataclasses.replace(u, nattempt=n)))

    def plain(n, pos):
        return usher_search_subset_batch(with_steps(n), *subs, *pos, ctype,
                                         o.region5, o.region6)
    gate = u.etarget + EPSILON
    ly = cfg.box.lengths[1]
    pos, acc, it = plain(u.nattempt, cands)
    assert int(acc.sum()) > 0 and int((~acc).sum()) > 0
    assert int(it.max()) > 10
    checked = 0
    for n in range(int(it.max())):
        pn, _, itn = plain(n, cands)
        searching = itn == n
        one = plain(1, (pn[0], pn[1]))
        binned = usher_search_binned_plain(with_steps(1), *subs, pn[0],
                                           pn[1], o.region5, o.region6)
        e = [usher_energy_binned_plain(cfg, g, s, p)[0]
             for g, s, p in zip(plan.grids, subs, pn)]
        assert all(bool(torch.isfinite(v).all()) for v in e)
        margin = (torch.stack(e) - gate).abs()
        same = (binned[1] == one[1]) & (binned[2] == one[2])
        assert bool((same | ~searching
                     | (margin < 1e-9 * abs(u.etarget))).all()), n
        held = same & searching
        d = (binned[0] - one[0]).abs().amax(-1)
        assert float(torch.where(held, d, 0.0).max()) <= 1e-9 * ly, n
        checked += int(held.sum())
    assert checked > 4 * k


def test_usher_float64_plan_and_refusals():
    """The float64 plan's launch key, grid and host arrays in float64,
    8-word rows in the scratch; the kernel records of every float64 row;
    the wrapper refuses a float64 subset with float32 candidates and a
    float16 search, and on the CPU the search takes its plain version."""
    import ctypes
    cfg = usher_cfg()
    o = cfg.obmd
    p32 = UsherPlan.of(cfg, o.region5, o.region6)
    p64 = UsherPlan.of(cfg, o.region5, o.region6, F64)
    assert (p32.name, p64.name) == ("usher_search", "usher_search_f64")
    assert p64.coef._type_ is ctypes.c_double
    assert p32.coef._type_ is ctypes.c_float
    g = p64.grids[0]
    assert g.inv[0] == 1.0 / g.side[0] and g.lo == tuple(
        float(v) for v in g.lo)
    w32 = scratch_words(p64.grids, 20, 24)
    assert scratch_words(p64.grids, 20, 24, F64) == w32 + 4 * (20 + 24)
    for law in ("", "_dpdext", "_lj", "_ljrf"):
        k = _build.KERNELS[f"usher_search{law}_f64"]
        assert k.symbol.endswith("_f64") and "float64" in k.replaces
        assert k.argtypes[-2] is ctypes.c_double
    rng = np.random.default_rng(3)
    sub = face_subset(cfg, p64.grids[0], rng, rho=0.1)
    cand = torch.zeros((4, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="float32"):
        launch(cfg, sub, sub, cand, cand, o.region5, o.region6)
    with pytest.raises(ValueError, match="float16"):
        launch(cfg, sub, sub, cand.half(), cand.half(), o.region5,
               o.region6)


def closed_states(path="nlist"):
    kw = dict(n=N, box_l=BOX_L, seed=SEED, dtype="float64")
    js = jscenes.closed_dpd_scene(**kw)
    ps = pscenes.closed_dpd_scene(**kw, device=CPU)
    jcfg = dataclasses.replace(js.cfg, force_path=path).finalize()
    pcfg = dataclasses.replace(ps.cfg, force_path=path).finalize()
    return jcfg, jint.setup(jcfg, js.state), pcfg, setup(pcfg, ps.state)


@pytest.mark.parametrize("alpha,nbuf,dt,tau", [
    (0.7, 1327.0 * 0.25, 0.001464, 0.005), (0.5, 180.0, 0.01, 0.01),
    (0.7, 1327.0 * 9, 0.001464, 0.005)])
def test_feedback_count_float64_matches_jax(alpha, nbuf, dt, tau):
    """The feedback law with a float64 dt, as both nlist stages take it at
    float64 (the float32 head promoted by dtype(dt)): every census count
    gives JAX's budget."""
    import jax.numpy as jnp
    from obmd_tpu.obmd import stage as jstage
    from obmd_tpu_torch.obmd import stage as pstage
    cnt = np.arange(0, 20000, dtype=np.int32)
    assert jnp.asarray(np.float64(dt)).dtype == jnp.float64
    want = np.asarray(jstage.feedback_count(jnp.asarray(cnt), 1, alpha, nbuf,
                                            np.float64(dt), tau))
    got = pstage.feedback_count(torch.from_numpy(cnt), 1, alpha, nbuf,
                                torch.tensor(dt, dtype=F64), tau).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("scene,kw", [
    ("obmd_dpd_scene", dict(scale=0.25, seed=7)),
    ("closed_dpd_scene", dict(n=N, box_l=BOX_L, seed=SEED)),
    ("lj_melt_scene", dict(nx=4))])
def test_scenes_take_float64_as_jax(scene, kw):
    """The three scenes that take a dtype draw the same float64 start in
    both packages, every state field equal and the float leaves
    float64."""
    js = getattr(jscenes, scene)(dtype="float64", **kw)
    ps = getattr(pscenes, scene)(dtype="float64", device=CPU, **kw)
    assert ps.cfg.dtype == js.cfg.dtype == "float64"
    jd, pd = jax_arrays(js.state), convert.to_arrays(ps.state)
    for k in convert.STATE_FIELDS + convert.OBMD_FIELDS:
        if np.issubdtype(jd[k].dtype, np.floating):
            assert jd[k].dtype == np.float64, k
            assert np.asarray(pd[k]).dtype == np.float64, k
        assert np.array_equal(np.asarray(pd[k]), jd[k]), k


def test_observe_float64_matches_jax():
    """thermo and the x profiles of the set-up closed box equal the JAX
    package's to 1e-12 relative, every float output float64;
    check_invariants' counters equal."""
    jcfg, jst, pcfg, pst = closed_states()
    jt = jobserve.make_thermo_fn(jcfg)(jst)
    pt = observe.make_thermo_fn(pcfg)(pst)
    for k in ("temp", "pe", "ke", "pressure", "pxx", "epair", "fmax",
              "fnorm", "press_tensor"):
        want = np.asarray(getattr(jt, k))
        got = getattr(pt, k)
        assert want.dtype == np.float64 and got.dtype == F64, k
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=k)
    jp = jobserve.make_profile_fn(jcfg, 8)(jst)
    pp = observe.make_profile_fn(pcfg, 8)(pst)
    for k in ("density", "vx", "temp", "pxx"):
        want = np.asarray(getattr(jp, k))
        got = getattr(pp, k)
        assert want.dtype == np.float64 and got.dtype == F64, k
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=k)
    want = jobserve.check_invariants(jcfg, jst)
    got = observe.check_invariants(pcfg, pst)
    assert {k: got[k] for k in want} == want


def test_checkpoint_and_convert_keep_float64(tmp_path):
    """A float64 state after one step saves and loads back float64 bit for
    bit, its configuration float64; a JAX float64 state crosses the
    converter as float64, bit for bit."""
    jcfg, jst, pcfg, pst = closed_states()
    pst = make_step(pcfg)(pst)
    path = str(tmp_path / "f64.npz")
    save_checkpoint(path, pcfg, pst)
    cfg, back = load_checkpoint(path, device=CPU)
    assert cfg.dtype == "float64"
    for name in ("x", "v", "f", "q", "sim_time", "lambdaF"):
        a, b = getattr(pst, name), getattr(back, name)
        assert b.dtype == F64 and torch.equal(a, b), name
    for name in ("momentum_force_left", "shear_force_right"):
        assert getattr(back.obmd, name).dtype == F64
    d = jax_arrays(jst)
    assert d["x"].dtype == np.float64
    arrays = convert.to_arrays(convert.from_arrays(d, device=CPU))
    for k in d:
        assert np.asarray(arrays[k]).dtype == d[k].dtype or \
            not np.issubdtype(d[k].dtype, np.floating), k
        assert np.array_equal(np.asarray(arrays[k]), d[k]), k


def test_float64_refusals(tmp_path):
    from obmd_tpu_torch import capi
    from obmd_tpu_torch import integrate as pint
    from obmd_tpu_torch.engine_cellpad import check_scene, check_supported
    from obmd_tpu_torch.io.script import Interpreter
    from obmd_tpu_torch.parallel.atom_decomp import check_atom_decomp
    from obmd_tpu_torch.parallel.slab_decomp import check_slab_scene
    obmd = pscenes.obmd_dpd_config(scale=0.25, dtype="float64").finalize()
    assert obmd.force_path == "cellpad"
    st = pscenes.obmd_dpd_scene(scale=0.25, seed=3, device=CPU,
                                dtype="float64").state
    with pytest.raises(NotImplementedError, match="nlist engine") as err:
        setup(obmd, st)
    assert "_insert" in str(err.value)
    box = pscenes.closed_dpd_scene(n=N, box_l=BOX_L, dtype="float64",
                                   device=CPU).cfg
    check_scene(box.finalize())
    for path in ("cellpad", "nlist"):
        check_supported(dataclasses.replace(box, rigid=True,
                                            force_path=path).finalize())
    mol = dataclasses.replace(pscenes.mol_box_config("dpd"),
                              dtype="float64")
    for path, check in (("cellpad", check_supported),
                        ("nlist", pint.check_supported)):
        with pytest.raises(NotImplementedError, match="slab") as err:
            check(dataclasses.replace(mol, force_path=path).finalize())
        assert "_insert" in str(err.value)
    for check in (check_slab_scene, check_atom_decomp):
        check(obmd)
    check_slab_scene(mol.finalize())
    path = str(tmp_path / "f64.npz")
    ps = pscenes.closed_dpd_scene(n=N, box_l=BOX_L, dtype="float64",
                                  device=CPU)
    save_checkpoint(path, ps.cfg, ps.state)
    with pytest.raises(NotImplementedError, match="deck Interpreter") as err:
        Interpreter(device=CPU, log_fn=lambda *a: None).one(
            f"read_restart {path}")
    assert "no dtype" in str(err.value)
    with pytest.raises(NotImplementedError, match="deck Interpreter") as err:
        capi.Session(CPU).command(f"read_restart {path}")
    assert "no dtype" in str(err.value)
    for dt in ("float16", "bfloat16"):
        with pytest.raises(NotImplementedError, match=dt):
            pscenes.closed_dpd_scene(n=N, box_l=BOX_L, dtype=dt, device=CPU)
        with pytest.raises(NotImplementedError, match=dt):
            check_scene(dataclasses.replace(box.finalize(), dtype=dt))
        with pytest.raises(NotImplementedError, match=dt):
            SceneConfig(box=box.box, masses=(1.0,), pair=box.pair,
                        dt=0.04, capacity=box.capacity,
                        dtype=dt).finalize()
