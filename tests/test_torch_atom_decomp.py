"""The atom decomposition of the port (obmd_tpu_torch/parallel/
atom_decomp.py) against the JAX package's make_sharded_step on a 4-device
CPU mesh, slot for slot, and against the port's single-device nlist engine
(JAX's test_parallel.py:27-49); the port's dry run; the launcher's
refusals.  The port's ranks run in one spawn of 4 gloo ranks on the CPU;
the JAX step's candidate draws are replayed into them."""
import jax
import numpy as np
import pytest

from obmd_tpu import scenes as jscenes
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.parallel import atom_decomp as jatom
from obmd_tpu_torch import convert
from obmd_tpu_torch.integrate import make_step as pmake_step
from obmd_tpu_torch.parallel import comm as pcomm
from obmd_tpu_torch.parallel import ranks as pranks
from obmd_tpu_torch.parallel.atom_decomp import check_atom_decomp
from obmd_tpu_torch.parallel.dryrun import dryrun_multichip

from test_torch_slab import jax_stage_draws
from test_torch_support import jax_arrays

NDEV = 4
STEPS = 3


def _scene(robust):
    """JAX's test_parallel.py scene; `robust`: nbuf raised so that both
    faces insert and USHER at nattempt 0 with etarget 90 (unmoved
    candidates pass), where every counter is exact (at nattempt 40 a
    search's iteration count at the etarget gate hangs on float32
    order)."""
    import dataclasses
    kw = dict(nbuf=400.0) if robust else {}
    sc = jscenes.obmd_dpd_scene(scale=0.1, seed=0, n_max=1800,
                                insert_kmax=4, cell_capacity=16,
                                force_path="nlist", **kw)
    cfg = sc.cfg
    if robust:
        cfg = dataclasses.replace(cfg, obmd=dataclasses.replace(
            cfg.obmd, usher=dataclasses.replace(cfg.obmd.usher, nattempt=0,
                                                etarget=90.0)))
    cfg = cfg.finalize()
    return cfg, jsetup(cfg, sc.state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out, port_runs = {}, []
    for robust in (False, True):
        cfg, st = _scene(robust)
        start = int(st.step)
        draws = jax_stage_draws(cfg, st.key, range(start, start + STEPS))
        mesh = jatom.make_mesh(NDEV)
        step = jatom.make_sharded_step(cfg, mesh)
        s = jatom.shard_state(st, mesh)
        for _ in range(STEPS):
            s = jax.block_until_ready(step(s))
        arrays = jax_arrays(st)
        pcfg = convert.scene_config(cfg).finalize()
        out[robust] = dict(jax=jax_arrays(s.replace(nbrs=None)), pcfg=pcfg,
                           arrays=arrays, draws=draws)
        port_runs.append(dict(cfg=pcfg, arrays={
            k: v for k, v in arrays.items() if k not in ("nlist", "xref")},
            seed=7, steps=STEPS, draws=draws))
    res = pcomm.spawn(pranks.atom_runs, NDEV, "gloo", "cpu", 150.0,
                      port_runs, store_dir=str(tmp_path_factory.mktemp("fs")))
    for i, robust in enumerate((False, True)):
        out[robust]["port"] = res[0][i]["state"]
        out[robust]["same_draws"] = all(r[i]["same_draws"] for r in res)
    return out


@pytest.mark.parametrize("robust", [False, True])
def test_atom_decomp_matches_jax(runs, robust):
    r = runs[robust]
    p, j = r["port"], r["jax"]
    for k in ("tag", "alive", "type"):
        assert np.array_equal(p[k], j[k]), k
    counters = ("step", "maxtag", "cell_overflow", "ndeleted", "ninserted",
                "insert_fail") + (("usher_iters",) if robust else ())
    for k in counters:
        assert int(p[k]) == int(j[k]), k
    if robust:
        assert int(j["ninserted"]) > 0
    a = j["alive"]
    np.testing.assert_allclose(p["x"][a], j["x"][a], rtol=0, atol=1e-5)
    np.testing.assert_allclose(p["v"][a], j["v"][a], rtol=0, atol=1e-4)
    np.testing.assert_allclose(p["f"][a], j["f"][a], rtol=0,
                               atol=2e-4 * np.abs(j["f"]).max())


@pytest.mark.parametrize("robust", [False, True])
def test_atom_decomp_matches_nlist_engine(runs, robust):
    """Counters equal and positions by tag within 2e-3 of the port's
    single-device nlist engine on the same draws."""
    runs = runs[robust]
    state = convert.from_arrays(runs["arrays"], seed=7, device="cpu")
    step = pmake_step(runs["pcfg"], pranks.ReplayDraws(runs["draws"]))
    for _ in range(STEPS):
        state = step(state)
    ref = convert.to_arrays(state)
    got = runs["port"]
    for k in ("ndeleted", "ninserted"):
        assert int(got[k]) == int(ref[k]), k
    assert int(got["alive"].sum()) == int(ref["alive"].sum())
    m1 = dict(zip(got["tag"][got["alive"]].tolist(), got["x"][got["alive"]]))
    m2 = dict(zip(ref["tag"][ref["alive"]].tolist(), ref["x"][ref["alive"]]))
    assert set(m1) == set(m2)
    assert max(np.abs(m1[t] - m2[t]).max() for t in m1) < 2e-3
    assert runs["same_draws"]


def _jax_dry_paths(world):
    """JAX's paths 1b and 1c (__graft_entry__.py:76-158, the scenes of
    dryrun.mol_scenes) on a world-device mesh, 1b's forces set up without
    the stage as the port's dry run sets them up: (natoms after 1b's step,
    after 1c's, 1b's draws for the port)."""
    import dataclasses
    from obmd_tpu.parallel import slab_decomp as jslab
    from obmd_tpu.state import init_state as jinit
    from obmd_tpu_torch.parallel.dryrun import mol_scenes
    from test_torch_obmd_lj import to_jax
    from test_torch_slab_mol import jax_mol_draws
    mesh = jslab.make_mesh(world)
    (mcfg, mol), (wcfg, water) = mol_scenes(world)
    out = []
    for cfg, inputs, geom_kw, step_kw in (
            (mcfg, mol, {}, {}),
            (wcfg, water, dict(grow=1.5), dict(balance_every=1))):
        jcfg = to_jax(cfg).finalize()
        st = jsetup(dataclasses.replace(jcfg, obmd=None), jinit(jcfg,
                                                               **inputs))
        geom = jslab.make_slab_geom(jcfg, world, **geom_kw)
        s = jslab.shard_by_slab(jcfg, geom, st, mesh)
        if step_kw:
            s = jslab.with_balance_cuts(geom, s)
        s = jslab.make_slab_step(jcfg, mesh, geom, **step_kw)(s)
        out.append(int(s.natoms))
        if jcfg.obmd is not None:
            draws = jax_mol_draws(jcfg, st.key, [0])
    return out[0], out[1], draws


def test_dryrun_gloo_cpu(tmp_path):
    """The dry run's four paths (dryrun_multichip's inputs, rank function
    and line) on 2 gloo ranks: JAX's line, and paths 1b and 1c (MOLECULE
    mode, SHAKE with balancing) at JAX's natoms on the same scenes and
    draws."""
    from obmd_tpu_torch.parallel.dryrun import dry_inputs, dry_line, dry_rank
    n_mol, n_water, draws = _jax_dry_paths(2)
    got = pcomm.spawn(dry_rank, 2, "gloo", "cpu", 150.0,
                      *dry_inputs(2, "cpu", draws),
                      store_dir=str(tmp_path))[0]
    line = dry_line(2, got)
    assert line.startswith("dryrun_multichip(2): ok, slab natoms=")
    assert line.endswith("step=1")
    assert got["mol"] == n_mol > 80
    assert got["water"] == n_water == 90


def test_launch_refusals():
    """NCCL on the CPU names gloo; the default (NCCL on the card) raises
    on a machine without one; an unknown backend raises."""
    import torch
    with pytest.raises(ValueError, match="gloo"):
        pcomm.check_launch(2, "nccl", "cpu")
    with pytest.raises(ValueError, match="backend"):
        pcomm.check_launch(2, "mpi", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            dryrun_multichip(2)
        with pytest.raises(RuntimeError, match="cuda"):
            pcomm.spawn(pranks.atom_runs, 2)


def test_atom_decomp_refusals():
    """The keywords JAX's atom decomposition passes over raise."""
    import dataclasses
    pcfg = convert.scene_config(jscenes.obmd_dpd_config(
        scale=0.1, n_max=1800, force_path="nlist"))
    check_atom_decomp(pcfg.finalize())
    for kw in (dict(maxattempt=2), dict(nfreq=2), dict(id_policy="max"),
               dict(vx=(0.0, 1.0))):
        bad = dataclasses.replace(pcfg, obmd=dataclasses.replace(
            pcfg.obmd, **kw)).finalize()
        with pytest.raises(NotImplementedError, match="one round"):
            check_atom_decomp(bad)


def test_spawn_reports_a_failed_rank(tmp_path):
    """A rank that raises fails the launch with its traceback, and the
    other ranks are killed."""
    with pytest.raises(RuntimeError, match="rank 1"):
        pcomm.spawn(pranks.atom_runs, 2, "gloo", "cpu", 60.0,
                    [dict(cfg=None)], store_dir=str(tmp_path))


def test_collectives(tmp_path):
    """Comm's sums, extrema, all-gather, neighbour exchange and shifts on
    three gloo ranks: the edge ranks receive zeros, as ppermute gives."""
    res = pcomm.spawn(pranks.collectives, 3, "gloo", "cpu", 60.0,
                      store_dir=str(tmp_path))
    for r, got in enumerate(res):
        assert got["sum"] == [6.0, 6.0]
        assert got["max"] == [3.0, 4.0] and got["min"] == [1.0, 0.0]
        assert got["any"] == [True]
        assert got["gather"] == [0, 1, 2]
        right, left = r + 1 < 3, r > 0
        assert got["from_right"] == [[r + 1] * 2 if right else [0, 0],
                                     [right] * 3]
        assert got["from_left"] == [[9.0 + r] * 3 if left else [0.0] * 3]
        assert got["right"] == [99 + r if left else 0]
        assert got["left"] == [101 + r if right else 0]
