"""The OBMD_DPD deck's drain in the port against the JAX engine from one
start: the statistics behind the profile gate (profile_torch.py), which the
reference binary holds at 11,168 atoms from step 3,000 on.

Both engines start from obmd_dpd_scene's uniform gas (the two packages
draw the same one from the same seed), take the reference deck's seeds
(profile_torch.deck_config, with the JAX package's uniform noise or
gaussian noise), run `integrate.equilibrate` and then the deck's steps:
the port on its cellpad engine (the plain versions on the CPU), the JAX
package on its `force_path="nlist"` engine, the one its golden profile
runs validated (validation/run_ours.py, REPORT.md).  Per engine it counts
the atoms deleted at each face (a tag alive before a step and gone after
it, its side from its x before the step), the atoms left, and the density
of the outermost two x bins of each side (bins as wide as the reference
deck's chunks, 0.672) averaged over the sampled steps.  Trajectories
diverge, so the engines are compared statistically.

    python3 tests/test_torch_gate_split.py --scale 0.5 --equil 200 \\
        --steps 3000 [--engines jax port] [--noise uniform] [--threads 4]
    python3 tests/test_torch_gate_split.py --scale 1 --equil 1500 \\
        --steps 60000 --warm 10000 --engines jax

prints one JSON line per engine (the second: the JAX engine through
profile_torch.py's run, on the CPU, with the density RMSE/mean of its
profile against the reference binary's).

    python3 tests/test_torch_gate_split.py --save \
        validation/profile_jax_samestart.npz

runs the JAX engine's same-start reference of the port's main path
(samestart: scale 1, the deck's 1,500 + 60,000 steps, ~1.1-1.7 h on 8 CPU
cores) and saves it for `profile_torch.py --against jax`.  The tests below
hold the face
deletion and the boundary force to the JAX stage slot for slot and run a
short drain at scale 0.25."""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CHUNK = 33.594 / 50            # the reference deck's x chunk width


def _deck(cfg, noise):
    """The reference deck's seeds and noise law on either package's
    config (profile_torch.deck_config's settings)."""
    return dataclasses.replace(
        cfg, pair=dataclasses.replace(cfg.pair, seed=8893,
                                      gaussian_noise=noise == "gaussian"),
        obmd=dataclasses.replace(cfg.obmd, seed=777)).finalize()


def _engine(name, scale, seed, noise):
    """(cfg, state, equilibrate(state, n), run1(state), arrays(state) ->
    (x, tag, alive) numpy) of one engine."""
    if name == "jax":
        import jax
        from obmd_tpu import scenes
        from obmd_tpu.integrate import equilibrate, make_run, setup
        sc = scenes.obmd_dpd_scene(scale=scale, seed=seed,
                                   force_path="nlist")
        cfg = _deck(sc.cfg, noise)
        state = setup(cfg, sc.state)
        step = jax.jit(make_run(cfg, 1))

        def arrays(st):
            return (np.asarray(st.x), np.asarray(st.tag),
                    np.asarray(st.alive))
        return (cfg, state, lambda st, n: equilibrate(cfg, st, n), step,
                arrays)
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.integrate import equilibrate, make_run, setup
    sc = scenes.obmd_dpd_scene(scale=scale, seed=seed, device="cpu")
    cfg = _deck(sc.cfg, noise)
    state = setup(cfg, sc.state)

    def arrays(st):
        return st.x.numpy(), st.tag.numpy(), st.alive.numpy()
    return (cfg, state, lambda st, n: equilibrate(cfg, st, n),
            make_run(cfg, 1), arrays)


def drain(name, scale=0.25, seed=7, noise="uniform", equil=0, steps=50,
          every=10, warm=0):
    """One engine's drain: atoms after equilibrate, then per-face deleted
    counts, atoms left and the outer bins' mean density over the steps
    sampled every `every` after step `warm`; at scale 1 (the reference
    deck's box) also the density RMSE/mean of that mean profile against
    the reference binary's (profile_torch.py's figure)."""
    t0 = time.perf_counter()
    cfg, state, equilibrate, step, arrays = _engine(name, scale, seed, noise)
    n0 = int(arrays(state)[2].sum())
    if equil:
        state = equilibrate(state, equil)
    lx = cfg.box.lengths[0]
    nbins = max(4, round(lx / CHUNK))
    bin_vol = lx / nbins * cfg.box.lengths[1] * cfg.box.lengths[2]
    mid = 0.5 * (cfg.box.lo[0] + cfg.box.hi[0])
    x, tag, alive = arrays(state)
    n_eq = int(alive.sum())
    left = right = 0
    profiles = []
    natoms = {}
    for s in range(1, steps + 1):
        state = step(state)
        x2, tag2, alive2 = arrays(state)
        gone = alive & ~np.isin(tag, tag2[alive2])
        left += int((gone & (x[:, 0] < mid)).sum())
        right += int((gone & (x[:, 0] >= mid)).sum())
        x, tag, alive = x2, tag2, alive2
        if s % 1000 == 0:
            natoms[s] = int(alive.sum())
        if s % every == 0 and s > warm:
            b = np.clip(((x[alive, 0] - cfg.box.lo[0]) * (nbins / lx))
                        .astype(np.int64), 0, nbins - 1)
            profiles.append(np.bincount(b, minlength=nbins) / bin_vol)
    density = np.mean(profiles, axis=0)
    out = dict(engine=name, scale=scale, seed=seed, noise=noise,
               equilibrate_steps=equil, steps=steps, warm=warm,
               natoms_start=n0, natoms_after_equilibrate=n_eq,
               natoms=int(alive.sum()), natoms_at=natoms,
               deleted_left=left, deleted_right=right, nbins=nbins,
               outer_bins=[float(density[i]) for i in (0, 1, -2, -1)],
               wall_s=time.perf_counter() - t0)
    if scale == 1.0:
        import profile_torch
        ref = profile_torch.load_ref(profile_torch.REF["usher"][0])[:, 3]
        out["density_rmse_over_mean"] = float(
            np.sqrt(np.mean((density - ref) ** 2)) / ref.mean())
    return out


@pytest.fixture(scope="module")
def faces():
    """A laid-out scale-0.25 deck lattice (the JAX engine's layout) with
    atoms crowded into the outermost bins and some pushed just past each
    face (0.01-0.3 beyond it, as a step's drift leaves them before the
    stage deletes them), setpoint forces of the deck's size, as both
    packages' states."""
    import jax.numpy as jnp
    from obmd_tpu import engine_cellpad as jec
    from obmd_tpu.cellpad import layout_build as j_layout_build
    from obmd_tpu_torch import convert
    from test_torch_support import jax_arrays, lattice_states
    jcfg, jst, pcfg, _ = lattice_states(scale=0.25, cap=24, seed=17)
    x = np.array(jst.x)
    alive = np.asarray(jst.alive)
    r = np.random.default_rng(5)
    lx = jcfg.box.hi[0]
    lo_cells = np.flatnonzero(alive & (x[:, 0] < 1.0))
    hi_cells = np.flatnonzero(alive & (x[:, 0] > lx - 1.0))
    x[lo_cells, 0] = r.uniform(0.0, 0.67, len(lo_cells))
    x[hi_cells, 0] = r.uniform(lx - 0.67, lx, len(hi_cells))
    x[r.choice(lo_cells, 9, replace=False), 0] = -r.uniform(0.01, 0.3, 9)
    x[r.choice(hi_cells, 6, replace=False), 0] = \
        lx + r.uniform(0.01, 0.3, 6)
    geom = jec.make_geometry(jcfg)
    jst = jst.replace(x=jnp.asarray(x.astype(np.float32)))
    n = int(np.asarray(jst.alive).sum())
    jst = j_layout_build(geom, jcfg.box, jst)
    assert int(np.asarray(jst.alive).sum()) == n      # nothing dropped
    area = jcfg.box.cross_area
    sc = jst.obmd.replace(
        momentum_force_left=jnp.asarray([188.0 * area + 41.0, -3.0, 2.0],
                                        jnp.float32),
        momentum_force_right=jnp.asarray([-188.0 * area + 17.0, 1.0, -4.0],
                                         jnp.float32))
    jst = jst.replace(obmd=sc)
    pst = convert.from_arrays(jax_arrays(jst), device="cpu")
    return jcfg, jst, pcfg, pst


def test_face_deletion_matches_jax_stage(faces):
    """engine_cellpad._delete_outside_sliced (the two face blocks only)
    against the JAX stage's delete_outside over every atom
    (obmd_tpu/obmd/stage.py:44-86, the nlist engine's): the same atoms
    deleted, slot for slot, the same per-side momentum tallies at float32
    summation order."""
    from obmd_tpu.obmd.stage import delete_outside
    from obmd_tpu_torch import convert
    from obmd_tpu_torch import engine_cellpad as pec
    from test_torch_support import jax_arrays
    jcfg, jst, pcfg, pst = faces
    j2, jl, jr = delete_outside(jcfg, jst)
    p2, pl, pr = pec._delete_outside_sliced(pcfg, pec.make_geometry(pcfg),
                                            pst)
    jd, pd = jax_arrays(j2), convert.to_arrays(p2)
    assert int(pd["ndeleted"]) == int(jd["ndeleted"]) == 15
    for k in ("alive", "tag", "v"):
        assert np.array_equal(pd[k], jd[k]), k
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("deleted_first", [False, True])
def test_boundary_force_matches_jax_stage(faces, deleted_first):
    """engine_cellpad._boundary_force_sliced (smooth weights over the
    buffers' slot slices) against the JAX stage's apply_boundary_force
    over every atom (obmd_tpu/obmd/stage.py:598-640), slot by slot within
    1e-5 of the largest per-atom share, on the crowded outermost bins: with
    the atoms past the faces still alive (neither package counts them as
    buffer members) and after the face deletion."""
    import jax.numpy as jnp
    import torch
    from obmd_tpu.obmd.stage import apply_boundary_force, delete_outside
    from obmd_tpu_torch import engine_cellpad as pec
    jcfg, jst, pcfg, pst = faces
    geom = pec.make_geometry(pcfg)
    if deleted_first:
        jst = delete_outside(jcfg, jst)[0]
        pst = pec._delete_outside_sliced(pcfg, geom, pst)[0]
    f = np.zeros((geom.n_slots, 3), np.float32)
    jf = np.asarray(apply_boundary_force(jcfg, jst, jnp.asarray(f)))
    pf = pec._boundary_force_sliced(pcfg, geom, pst,
                                    torch.from_numpy(f)).numpy()
    share = np.abs(jf).max()
    assert share > 1.0
    assert np.abs(pf - jf).max() <= 1e-5 * share
    x0 = np.asarray(jst.x)[:, 0]
    outside = (x0 < 0.0) | (x0 > jcfg.box.hi[0])
    assert not np.any(pf[outside & np.asarray(jst.alive)])
    want = (np.asarray(pst.obmd.momentum_force_left, np.float64)
            + np.asarray(pst.obmd.momentum_force_right, np.float64))
    np.testing.assert_allclose(pf.astype(np.float64).sum(axis=0), want,
                               rtol=1e-5, atol=1e-2)


def test_drain_matches_jax_engine():
    """Thirty steps of the scale-0.25 deck from the raw gas (its stiff
    overlaps throw atoms out of both faces at once): each face's deletions
    in the port within 4 sqrt(n) + 3 of the JAX nlist engine's n, the atoms
    left likewise, and the outer bins' mean density within 25% (+0.1) of
    the JAX engine's."""
    import torch
    torch.set_num_threads(1)
    jx = drain("jax", steps=30, every=5)
    pt = drain("port", steps=30, every=5)
    assert jx["natoms_start"] == pt["natoms_start"]
    for k in ("deleted_left", "deleted_right"):
        assert jx[k] > 0, k
        assert abs(pt[k] - jx[k]) <= 4 * np.sqrt(jx[k]) + 3, (k, pt, jx)
    dn = abs(pt["natoms"] - jx["natoms"])
    assert dn <= 4 * np.sqrt(jx["natoms_start"] - jx["natoms"]) + 3
    for a, b in zip(pt["outer_bins"], jx["outer_bins"]):
        assert abs(a - b) <= 0.25 * b + 0.1, (pt, jx)


def samestart(path, scale=1.0, seed=7, noise="uniform", equil=None,
              steps=None, warm=None):
    """The JAX nlist engine's same-start reference for the port's main
    path (profile_torch.py --against jax): obmd_dpd_scene's uniform gas at
    the reference deck's seeds, `equil` steps of equilibrate, then the
    deck's steps, sampled by profile_torch.deck_series with the JAX
    package's own profile function; saved with its settings to `path`."""
    import subprocess
    import jax
    from obmd_tpu.observe import make_profile_fn
    from obmd_tpu.integrate import make_run
    import profile_torch as pt
    equil = pt.EQUIL if equil is None else equil
    steps = pt.REF["usher"][1] if steps is None else steps
    warm = pt.WARM if warm is None else warm
    t0 = time.perf_counter()
    cfg, state, equilibrate, _, _ = _engine("jax", scale, seed, noise)
    state = equilibrate(state, equil)
    counts0 = [int(state.natoms), int(state.obmd.ndeleted),
               int(state.obmd.ninserted)]
    masses = np.asarray(cfg.masses, np.float64)
    prof = make_profile_fn(cfg, nbins=pt.NBINS)
    lx = cfg.box.lengths[0]

    def arrays(st):
        return (np.asarray(st.x), np.asarray(st.v), np.asarray(st.alive),
                masses[np.asarray(st.type)])

    def profile(st):
        p = prof(st)
        return {k: np.asarray(getattr(p, k), np.float64)
                for k in ("density", "vx", "temp")}

    def log(st, s):
        print(f"step {s} N {int(st.natoms)} ins {int(st.obmd.ninserted)} "
              f"del {int(st.obmd.ndeleted)} {time.perf_counter() - t0:.0f} s",
              file=sys.stderr, flush=True)
    state, out = pt.deck_series(
        state, jax.jit(make_run(cfg, pt.SAMPLE_EVERY)), profile, arrays,
        cfg.box.lo[0], cfg.box.hi[0], steps, warm=warm,
        t_nbins=round(lx / pt.T_BIN), log=log)
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                capture_output=True, text=True,
                                check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = None
    meta = dict(engine="jax", force_path=cfg.force_path, scale=scale,
                scene_seed=seed, pair_seed=cfg.pair.seed,
                obmd_seed=cfg.obmd.seed, noise=noise,
                insertion="usher", equil=equil, steps=steps,
                sample_every=pt.SAMPLE_EVERY, warm=warm, nbins=pt.NBINS,
                t_until=pt.T_UNTIL, t_nbins=round(lx / pt.T_BIN),
                blocks=pt.BLOCKS, jax_version=jax.__version__,
                commit=commit, wall_s=time.perf_counter() - t0)
    for k in ("density", "vx", "temp"):        # the series as block means
        out[f"block_{k}"] = pt.blocks(out.pop(f"series_{k}"))
    np.savez_compressed(
        path, meta=np.asarray(json.dumps(meta)),
        counts_after_equilibrate=np.asarray(counts0, np.int64),
        counts_end=np.asarray([int(state.natoms), int(state.obmd.ndeleted),
                               int(state.obmd.ninserted)], np.int64), **out)
    return meta


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=None,
                    help="0.5 by default; 1 with --save")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--noise", choices=("uniform", "gaussian"),
                    default="uniform")
    ap.add_argument("--equil", type=int, default=None,
                    help="200 by default; profile_torch.EQUIL with --save")
    ap.add_argument("--steps", type=int, default=None,
                    help="3000 by default; the deck's with --save")
    ap.add_argument("--every", type=int, default=50)
    ap.add_argument("--warm", type=int, default=None,
                    help="0 by default; profile_torch.WARM with --save")
    ap.add_argument("--engines", nargs="+", default=["jax", "port"])
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--save", metavar="PATH",
                    help="run the JAX engine's same-start reference "
                         "(samestart) and save it to PATH")
    a = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    if a.save:
        print(json.dumps(samestart(
            a.save, 1.0 if a.scale is None else a.scale, a.seed, a.noise,
            a.equil, a.steps, a.warm)), flush=True)
        return
    a.scale = 0.5 if a.scale is None else a.scale
    a.equil = 200 if a.equil is None else a.equil
    a.steps = 3000 if a.steps is None else a.steps
    a.warm = 0 if a.warm is None else a.warm
    import torch
    torch.set_num_threads(a.threads)
    for name in a.engines:
        print(json.dumps(drain(name, a.scale, a.seed, a.noise, a.equil,
                               a.steps, a.every, a.warm)), flush=True)


if __name__ == "__main__":
    main()
