"""The multi-device steps of the port at float64 against the JAX package's
under jax_enable_x64, on a 4-device CPU mesh.

Each start is a scene of the float32 parity tests, set up there, then
widened: every float leaf cast to float64 and the scene's dtype set to
float64 (as the smoke's phases widen theirs).  The JAX draws are made in
float64 and replayed into the port's ranks.

- The slab decomposition in ATOM mode on the gathered path: OBMD_DPD at
  scale 0.35 (test_torch_slab's `_obmd`), 10 steps.
- Its MOLECULE mode: JAX's molecule scene under `near`
  (test_slab_mol._mol_scene), the molecule USHER
  (test_torch_slab_mol._usher) and rigid trimers under insertion
  (test_torch_slab_constraints._rigid, with test_torch_rigid.jax_midpoint
  swapped into JAX while it traces), and SHAKE water with dynamic
  balancing (test_torch_slab_constraints._water).
- The atom decomposition on OBMD_DPD at scale 0.1 on the nlist engine.
- The kernel path: float32 kernel fields packed from the float64 state
  (the pair kernel's plain version here), on JAX's open DPD box at T 1 and
  on its bonded dimers, against JAX's gathered slab at x64.
- What the port departs from: JAX's own Pallas slab step raises at x64.

Gates: tags, alive, partner tags and the counters (usher_iters included)
exact; x and v within 1e-9 x the box's x length; every float leaf float64
on both sides; on the kernel path the forces within 2e-4 x max|f| after
one step and the positions within 1e-5 after three.  Every port run goes
through one spawn of 4 gloo ranks under a hard timeout."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import obmd_tpu.rigid as jrigid
from obmd_tpu.parallel import atom_decomp as jatom
from obmd_tpu.parallel import slab_decomp as jslab
from obmd_tpu_torch import convert
from obmd_tpu_torch.parallel import comm as pcomm
from obmd_tpu_torch.parallel import ranks as pranks

import test_torch_atom_decomp as atom_case
import test_torch_slab as slab_case
import test_torch_slab_constraints as constraint_case
import test_torch_slab_mol as mol_case
from test_slab_mol import _mol_scene
from test_torch_rigid import jax_midpoint
from test_torch_support import jax_arrays

NDEV = 4
TIMEOUT_S = 240.0
REL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def x64():
    """jax_enable_x64 on for this module's tests, restored after them."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def widened(cfg, state):
    """The scene at float64 and its state with every float leaf cast to
    float64."""
    def up(a):
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating):
            return jnp.asarray(a, jnp.float64)
        return a
    return (dataclasses.replace(cfg, dtype="float64").finalize(),
            jax.tree_util.tree_map(up, state))


def _rigid():
    """The rigid trimers on the slab's nlist path (JAX's slab step reads no
    force_path)."""
    cfg, st = constraint_case._rigid()
    return dataclasses.replace(cfg, force_path="nlist").finalize(), st


# name: (scene, steps, slab geometry, JAX step kwargs, port force_impl,
#        JAX's rigid_kinematics swapped for jax_midpoint)
SLAB = {
    "atom": (slab_case._obmd, 10, {}, {}, "gathered", False),
    "mol": (_mol_scene, 4, {}, {}, "gathered", False),
    "usher": (mol_case._usher, 4, {}, {}, "gathered", False),
    "rigid": (_rigid, 3, {}, {}, "gathered", True),
    "water": (constraint_case._water, 3, constraint_case.WATER_GEOM,
              dict(balance_every=1), "gathered", False),
    "kernel_t1": (lambda: slab_case._open_box(1.0), 3, dict(n_loc=200), {},
                  "kernel", False),
    "dimers_kernel": (mol_case._dimers, 3, dict(n_loc=128), {}, "kernel",
                      False),
}
KERNEL = ("kernel_t1", "dimers_kernel")


def _draws(cfg, st, steps):
    """The JAX stage's float64 draws of `steps` steps for ReplayDraws."""
    if cfg.obmd is None:
        return None
    start = int(st.step)
    nfreq = cfg.obmd.nfreq
    calls = [s for s in range(start, start + steps) if s % nfreq == 0]
    if cfg.obmd.mol is not None:
        return mol_case.jax_mol_draws(cfg, st.key, calls)
    return slab_case.jax_stage_draws(cfg, st.key, calls)


def _jax_slab(cfg, st, steps, geom_kw, step_kw, midpoint):
    """[arrays after each step] of JAX's slab step."""
    mesh = jslab.make_mesh(NDEV)
    geom = jslab.make_slab_geom(cfg, NDEV, **geom_kw)
    s = jslab.shard_by_slab(cfg, geom, st, mesh)
    if step_kw.get("balance_every"):
        s = jslab.with_balance_cuts(geom, s)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        if midpoint:
            mp.setattr(jrigid, "rigid_kinematics", jax_midpoint)
        step = jslab.make_slab_step(cfg, mesh, geom, **step_kw)
        for _ in range(steps):
            s = jax.block_until_ready(step(s))
            out.append(jax_arrays(s.replace(nbrs=None)))
    if step_kw.get("balance_every"):
        out[-1]["cuts"] = np.asarray(s.nbrs.cuts)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through JAX at x64 and, in one spawn, the port."""
    jax_out, starts, slab_runs, lx = {}, {}, [], {}
    for name, (make, steps, geom_kw, jkw, impl, mid) in SLAB.items():
        cfg, st = widened(*make())
        lx[name] = cfg.box.lengths[0]
        draws = _draws(cfg, st, steps)
        jax_out[name] = _jax_slab(cfg, st, steps, geom_kw, jkw, mid)
        starts[name] = jax_arrays(st.replace(nbrs=None))
        run = dict(cfg=convert.scene_config(cfg).finalize(),
                   arrays=starts[name], seed=7, steps=steps, geom=geom_kw,
                   force_impl=impl, draws=draws,
                   balance_every=jkw.get("balance_every", 0))
        slab_runs.append(run)
        if name in KERNEL:
            slab_runs.append(dict(run, steps=1))
    # the atom decomposition's OBMD_DPD at scale 0.1 on the nlist engine,
    # USHER at nattempt 0 (test_torch_atom_decomp's robust scene)
    cfg, st = widened(*atom_case._scene(True))
    lx["atom_decomp"] = cfg.box.lengths[0]
    start = int(st.step)
    draws = slab_case.jax_stage_draws(cfg, st.key,
                                      range(start, start + atom_case.STEPS))
    mesh = jatom.make_mesh(NDEV)
    step = jatom.make_sharded_step(cfg, mesh)
    s = jatom.shard_state(st, mesh)
    for _ in range(atom_case.STEPS):
        s = jax.block_until_ready(step(s))
    jax_out["atom_decomp"] = [jax_arrays(s.replace(nbrs=None))]
    arrays = jax_arrays(st)
    atom_runs = [dict(cfg=convert.scene_config(cfg).finalize(),
                      arrays={k: v for k, v in arrays.items()
                              if k not in ("nlist", "xref")},
                      seed=7, steps=atom_case.STEPS, draws=draws)]
    res = pcomm.spawn(pranks.rank_tasks, NDEV, "gloo", "cpu", TIMEOUT_S,
                      [(pranks.slab_runs, (slab_runs,)),
                       (pranks.atom_runs, (atom_runs,))],
                      store_dir=str(tmp_path_factory.mktemp("fs")))
    port, i = {}, 0
    for name in SLAB:
        port[name] = res[0][0][i]
        i += 1
        if name in KERNEL:
            port[name + "_1"] = res[0][0][i]
            i += 1
    port["atom_decomp"] = res[0][1][0]
    return dict(jax=jax_out, port=port, starts=starts, ranks=res, lx=lx)


EXACT = ("tag", "alive", "type", "mol", "bond1", "bond2", "bond3", "bond4",
         "impr", "rep_atom")
COUNTERS = ("step", "maxtag", "cell_overflow", "ndeleted", "ninserted",
            "insert_fail", "usher_iters")


def _all_float64(d):
    """Every float array of a converter dict is float64."""
    bad = {k: a.dtype for k, a in d.items()
           if np.issubdtype(np.asarray(a).dtype, np.floating)
           and np.asarray(a).dtype != np.float64}
    assert bad == {}, bad
    assert d["x"].dtype == np.float64


def _same_slots(p, j, atol):
    for k in EXACT:
        if k in j:
            assert np.array_equal(p[k], j[k]), k
    for k in COUNTERS:
        assert int(p[k]) == int(j[k]), k
    a = j["alive"]
    np.testing.assert_allclose(p["x"][a], j["x"][a], rtol=0, atol=atol)
    np.testing.assert_allclose(p["v"][a], j["v"][a], rtol=0, atol=atol)


@pytest.mark.parametrize("case", ["atom", "mol", "usher", "rigid", "water"])
def test_slab_float64_matches_jax(runs, case):
    """The gathered slab at float64, slot for slot against JAX's at x64:
    ATOM-mode USHER, molecule insertion under `near` and under the
    molecule USHER, rigid trimers under insertion, SHAKE water with
    balancing; everything float64 on both sides."""
    p, j = runs["port"][case]["state"], runs["jax"][case][-1]
    _all_float64(p)
    _all_float64(j)
    _same_slots(p, j, REL * runs["lx"][case])
    assert int(j["cell_overflow"]) == 0
    if case == "water":
        i = list(SLAB).index("water")
        assert np.array_equal(runs["ranks"][0][0][i]["cuts"], j["cuts"])
    else:
        assert int(j["ninserted"]) > int(runs["starts"][case]["ninserted"])
    for r in runs["ranks"]:
        assert all(run["outside"] == 0 for run in r[0])
        assert all(run["same_draws"] for run in r[0])


@pytest.mark.parametrize("case", KERNEL)
def test_slab_kernel_float64_matches_gathered_jax(runs, case):
    """force_impl="kernel" at float64 (float32 kernel fields, the force
    cast up) against JAX's gathered slab at x64: after one step the same
    slots with the forces within 2e-4 x max|f|, after three the positions
    within 1e-5; the state float64."""
    j1, p1 = runs["jax"][case][0], runs["port"][case + "_1"]["state"]
    for k in ("tag", "alive"):
        assert np.array_equal(p1[k], j1[k]), k
    a = j1["alive"]
    fmax = np.abs(j1["f"][a]).max()
    assert np.abs(p1["f"][a] - j1["f"][a]).max() <= 2e-4 * fmax
    p, j = runs["port"][case]["state"], runs["jax"][case][-1]
    _all_float64(p)
    for k in EXACT:
        if k in j:
            assert np.array_equal(p[k], j[k]), k
    a = j["alive"]
    np.testing.assert_allclose(p["x"][a], j["x"][a], rtol=0, atol=1e-5)
    assert int(p["cell_overflow"]) == 0


def test_atom_decomp_float64_matches_jax(runs):
    """The atom decomposition at float64 against JAX's make_sharded_step
    at x64, slot for slot."""
    p = runs["port"]["atom_decomp"]["state"]
    j = runs["jax"]["atom_decomp"][-1]
    _all_float64(p)
    _all_float64(j)
    _same_slots(p, j, REL * runs["lx"]["atom_decomp"])
    assert int(j["ninserted"]) > 0
    assert runs["port"]["atom_decomp"]["same_draws"]


def test_jax_pallas_slab_fails_at_x64():
    """The reference behaviour the port departs from: JAX's Pallas slab
    step packs the kernel's fields in the state's dtype
    (obmd_tpu/parallel/slab_decomp.py:997-1008) and its float32 kernel
    refuses them at float64; the port's kernel path files float32 fields
    (slab_decomp.file_slab), as the single-device engines do."""
    cfg, st = widened(*slab_case._open_box(0.0))
    mesh = jslab.make_mesh(NDEV)
    geom = jslab.make_slab_geom(cfg, NDEV, n_loc=200)
    s = jslab.shard_by_slab(cfg, geom, st, mesh)
    step = jslab.make_slab_step(cfg, mesh, geom, force_impl="pallas")
    with pytest.raises(ValueError, match="Invalid dtype"):
        step(s)
