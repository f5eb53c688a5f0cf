#!/usr/bin/env python3
"""Smoke run of obmd_tpu_torch on one NVIDIA GPU: the quickest proof that
the port builds, is right and runs its main path on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from obmd_tpu_torch/csrc (one nvcc per source,
     all started together);
  3. the whole path at a small size (scale 0.25) on the card against the
     same path on the CPU through the plain versions (check_small_path);
     then each kernel against its plain PyTorch version at bench shapes:
     the pair kernel at filing cap 24 on the set-up scale-9 state, the
     USHER kernel on that state's buffer subsets (K = 16 candidates);
  4. the main path as bench.py drives it: obmd_dpd_scene(scale=9, seed=7),
     setup, equilibrate(1500), repack to cap 15, make_run(400) to settle,
     two timed make_run(400) windows, check_invariants; then an insertion
     phase on the same scene with nbuf raised to 1.05 x census / alpha (at
     steady state the feedback budget is zero on almost every step), 25
     steps at the setup cap, ninserted > 0, check_invariants.  Launch
     counts are zeroed before setup and read after the insertion phase;
  5. the pair kernel against its plain version at cap 15 on the repacked
     state of phase 4, and a torch.profiler trace of two relayout epochs of
     the main path's runner there (device busy time, idle share, the
     operations that take the most device time);
  6. the main-path figures, the kernel figures ({"kernels": [...]}), the
     card line, and last {"ok": true, "device": {...}}.

Tolerances are the CPU tests': pair forces within 2e-4 * max|f| over alive
slots and |sum f| <= 1e-3 * max|f|; USHER verdicts equal on margin-robust
candidates (|E - etarget| >= 0.3 at both final positions), positions within
2e-3, at least 6 candidates checked.  A kernel's ms is the median of 20
launches timed with CUDA events; bound_ms is the larger of its bytes (each
input read once, each output written once; of a dead slot only the x that
marks it dead) over 3.35 TB/s and its float32 operations over 67 TFLOP/s
(H100 SXM data sheet; the work counted from this run's inputs by pair_work
and usher_work).  No PyTorch call computes either kernel's function, so
library_ms is null.  The main path records the most atoms in one cell at
the cap-15 repack and after each production window: the margin left before
a cell overflow, which check_invariants turns into a failure.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time

DEV = "cuda"
# the main path's sizes: bench.py's scene, equilibration, production cap
# and windows; the insertion phase's steps; the small path's deck
SCALE, SEED, EQUIL, NSTEPS, PROD_CAP, INS_STEPS = 9.0, 7, 1500, 400, 15, 25
SMALL_SCALE, SMALL_SEED, SMALL_NBUF, SMALL_STEPS = 0.25, 1, 700.0, 4

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations of one candidate-pair distance test (3 subtractions;
# minimum image on y and z: multiply, round, fused multiply-add each;
# squared norm: 3 multiplies, 2 adds) and of one in-cutoff DPD evaluation
# (rsqrt, r, wd, the relative-velocity dot product, the 32-bit counter
# hash, the uniform noise, the force scalar, the 3-component accumulation
# on both atoms of the pair)
OPS_PAIR_TEST = 14
OPS_PAIR_FORCE = 45
# float32 operations of one (candidate, subset atom) USHER energy/force term
OPS_USHER_TERM = 30


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def sync():
    import torch
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call on the card, timed with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class KeepCounts:
    """Launches made to compare a kernel with its plain version do not
    count: restore the launch counts on exit."""

    def __enter__(self):
        from obmd_tpu_torch import _build
        self.saved = {k: (v.launches, dict(v.launches_by_shape))
                      for k, v in _build.KERNELS.items()}

    def __exit__(self, *exc):
        from obmd_tpu_torch import _build
        for k, (n, by) in self.saved.items():
            _build.KERNELS[k].launches = n
            _build.KERNELS[k].launches_by_shape = by


def pair_work(geom, fld, cut: float):
    """(alive slots, unordered candidate pairs of alive atoms in the 27-cell
    stencil, unordered pairs within the cutoff) of this input: the least
    work of the function, each pair visited once."""
    import torch
    from obmd_tpu_torch.forces.pair_kernel import _neighbor_columns
    nb, nf, cap, lanes = fld.shape
    fl = fld.permute(0, 3, 1, 2).reshape(nb * lanes, nf, cap)
    cols, oks = _neighbor_columns(geom, fld.device)
    live = fl[:, 0, :] < 0.5e8
    ly = geom.dims[1] * geom.cell_size[1]
    lz = geom.dims[2] * geom.cell_size[2]
    not_self = ~torch.eye(cap, dtype=torch.bool, device=fld.device)
    cand = inside = 0
    for o in range(cols.shape[0]):
        xj = fl[cols[o]]
        ok = oks[o][:, None, None] & live[:, :, None] \
            & live[cols[o]][:, None, :]
        if o == 13:                          # the (0, 0, 0) offset
            ok = ok & not_self
        d = [fl[:, c, :, None] - xj[:, c, None, :] for c in range(3)]
        d[1] = d[1] - ly * torch.round(d[1] / ly)
        d[2] = d[2] - lz * torch.round(d[2] / lz)
        rsq = d[0] ** 2 + d[1] ** 2 + d[2] ** 2
        cand += int(ok.sum())
        inside += int((ok & (rsq < cut * cut)).sum())
    return int(live.sum()), cand // 2, inside // 2


def check_pair(cfg, geom, state, label):
    """The pair kernel against its plain version on one state."""
    import torch
    from obmd_tpu_torch.engine_cellpad import pack_fields
    from obmd_tpu_torch.forces.pair_kernel import (DPDCoef, make_pair_kernel,
                                                   pair_forces_plain)
    fld, tag, salt, occ = pack_fields(cfg, geom, state)
    kern = make_pair_kernel(geom, cfg.pair, cfg.dt)
    coef = DPDCoef.create(geom, cfg.pair, cfg.dt)
    with KeepCounts():
        f_k = kern(fld, tag, salt, occ)
        sync()
        f_p = pair_forces_plain(geom, coef, fld, tag, salt)
        sync()
        alive = state.alive.reshape(geom.n_blocks, geom.cap, geom.lanes)
        sel = alive[:, None].expand_as(f_p)
        scale = float(f_p[sel].abs().max())
        err = float((f_k - f_p)[sel].abs().max())
        if not bool(torch.isfinite(f_k).all()):
            fail(f"pair kernel {label}: non-finite forces")
        if not err <= 2e-4 * scale:
            fail(f"pair kernel {label}: max error {err} > 2e-4 * {scale}")
        if bool((f_k[~sel] != 0.0).any()):
            fail(f"pair kernel {label}: force on a dead slot")
        fsum = float(f_k.permute(0, 2, 3, 1).reshape(-1, 3)[
            state.alive].sum(0).abs().max())
        if not fsum <= 1e-3 * scale:
            fail(f"pair kernel {label}: |sum f| {fsum} > 1e-3 * {scale}")
        ms = time_ms(lambda: kern(fld, tag, salt, occ))
        plain = time_ms(lambda: pair_forces_plain(geom, coef, fld, tag, salt),
                        reps=5, warmup=1)
    n_live, n_cand, n_in = pair_work(geom, fld, float(cfg.pair.cut[0][0]))
    slots = geom.n_slots
    # x of every slot (it tells dead from alive), y, z, v and tag of the
    # alive slots, occ, and the force of every slot
    n_bytes = (slots * 4 + n_live * (5 + 1) * 4 + geom.n_blocks * 4
               + slots * 3 * 4)
    b_ms, b_by = bound(n_bytes, n_cand * OPS_PAIR_TEST + n_in * OPS_PAIR_FORCE)
    log(f"pair {label}: max_abs_err {err:.3e} (max|f| {scale:.1f}), "
        f"|sum f| {fsum:.3e}, kernel {ms:.4f} ms, plain {plain:.3f} ms, "
        f"{n_cand} candidate / {n_in} in-cutoff pairs, bound {b_ms:.5f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def usher_work(sub_l, sub_r, iters, k: int):
    """(bytes, operations) of one search on this input: each candidate
    evaluates its energy iters + 1 times against the valid subset atoms."""
    import torch
    n_valid = torch.stack([sub_l.valid.sum(), sub_r.valid.sum()])
    evals = int(((iters + 1).to(torch.int64) * n_valid[:, None]).sum())
    b = max(sub_l.x.shape[0], sub_r.x.shape[0])
    n_bytes = 2 * 5 * b * 4 + 2 * 6 * 4 + 2 * k * (3 * 4 + 3 * 4 + 4 + 4)
    return n_bytes, evals * OPS_USHER_TERM


def check_usher(cfg, geom, state):
    """The USHER kernel against its plain version on the state's buffer
    subsets with K uniform candidates per buffer."""
    import torch
    from obmd_tpu_torch.engine_cellpad import _subset_slice
    from obmd_tpu_torch.forces.usher_kernel import (kernel_inputs, launch,
                                                    usher_search)
    from obmd_tpu_torch.obmd.subset import (_batched_energy_force,
                                            pad_subset,
                                            usher_search_subset_batch)
    o = cfg.obmd
    k = o.insert_kmax
    pad = cfg.pair.max_cut + cfg.skin
    sub_l = _subset_slice(cfg, geom, state, o.region5, pad)
    sub_r = _subset_slice(cfg, geom, state, o.region6, pad)
    g = torch.Generator(device=DEV)
    g.manual_seed(1234)
    u = torch.rand((2, k, 3), generator=g, device=DEV)
    cl = o.region5.sample_uniform(u[0])
    cr = o.region6.sample_uniform(u[1])
    ct = torch.zeros((k,), dtype=torch.int32, device=DEV)
    with KeepCounts():
        pk, ak, ik = usher_search(cfg, sub_l, sub_r, cl, cr, o.region5,
                                  o.region6)
        sync()
        pp, ap, ip = usher_search_subset_batch(cfg, sub_l, sub_r, cl, cr, ct,
                                               o.region5, o.region6)
        sync()
        b = max(sub_l.x.shape[0], sub_r.x.shape[0])
        sl, sr = pad_subset(sub_l, b), pad_subset(sub_r, b)
        sx = torch.stack([sl.x, sr.x])
        st = torch.stack([sl.type, sr.type])
        sv = torch.stack([sl.valid, sr.valid])
        ct2 = torch.stack([ct, ct])
        ek, _ = _batched_energy_force(cfg.pair, sx, st, sv, pk, ct2,
                                      box=cfg.box)
        ep, _ = _batched_energy_force(cfg.pair, sx, st, sv, pp, ct2,
                                      box=cfg.box)
        et = o.usher.etarget
        robust = ((ek - et).abs() >= 0.3) & ((ep - et).abs() >= 0.3)
        checked = int(robust.sum())
        if checked < 6:
            fail(f"USHER: only {checked} margin-robust candidates")
        if not torch.equal(ak[robust], ap[robust]):
            fail("USHER: verdicts differ on margin-robust candidates")
        both = robust & ak & ap
        err = float((pk - pp).abs().amax(-1)[both].max()) \
            if bool(both.any()) else 0.0
        if not err < 2e-3:
            fail(f"USHER: position error {err} >= 2e-3")
        inputs = kernel_inputs(cfg, sub_l, sub_r, cl, cr, o.region5,
                               o.region6)
        ms = time_ms(lambda: launch(cfg, *inputs))
        plain = time_ms(lambda: usher_search_subset_batch(
            cfg, sub_l, sub_r, cl, cr, ct, o.region5, o.region6),
            reps=5, warmup=1)
    n_bytes, n_ops = usher_work(sub_l, sub_r, ik, k)
    b_ms, b_by = bound(n_bytes, n_ops)
    log(f"usher: B={b}, {checked} robust candidates, accepted "
        f"{int(ak.sum())}/{ak.numel()} (plain {int(ap.sum())}), iterations "
        f"{int(ik.sum())} (plain {int(ip.sum())}), max_abs_err {err:.3e}, "
        f"kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {b_ms:.5f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


class SeededDraws:
    """The engine's draw seam fed from one numpy generator, so that a run on
    the card and a run on the CPU try the same candidate positions."""

    def __init__(self, cfg, seed: int):
        import numpy as np
        self.rng = np.random.default_rng(seed)
        self.shape = (2, 1, cfg.obmd.insert_kmax, 3)

    def __call__(self, state, need):
        import numpy as np
        import torch
        u = self.rng.random(self.shape, dtype=np.float32)
        return torch.from_numpy(u).to(state.device) if need else None


SMALL_EXACT = ("type", "tag", "alive", "step", "maxtag", "cell_overflow",
               "ndeleted", "ninserted", "insert_fail", "usher_iters",
               "rebuilds", "overflow", "skin_trips", "tag3d", "occ")
SMALL_CLOSE = ("x", "v", "xref", "sim_time", "momentum_force_left",
               "momentum_force_right", "shear_force_left",
               "shear_force_right")


def check_small_path():
    """The whole path at a small size on the card against the same path on
    the CPU (the plain versions), from one gas and one stream of candidate
    draws: the deck of tests/test_torch_slice.py (nbuf raised so that both
    buffers insert on every step; nattempt = 0, so that no USHER verdict
    sits at the etarget gate, where float32 summation order decides it).
    After setup and after one step, slots, tags, alive, the kernel caches
    and every counter are equal, x, v and the setpoints agree within 1e-4
    and f within 2e-4 * max|f|; after SMALL_STEPS steps the counters and atom
    counts are equal and positions by tag agree within 5e-3 (the CPU
    tests' bars).  Returns the largest position difference by tag."""
    import dataclasses as dc

    import numpy as np
    from obmd_tpu_torch import convert, scenes
    from obmd_tpu_torch.integrate import make_run, setup

    runs = []
    for dev in (DEV, "cpu"):
        sc = scenes.obmd_dpd_scene(scale=SMALL_SCALE, seed=SMALL_SEED,
                                   nbuf=SMALL_NBUF, device=dev)
        cfg = dc.replace(sc.cfg, obmd=dc.replace(
            sc.cfg.obmd, usher=dc.replace(sc.cfg.obmd.usher, nattempt=0)))
        draws = SeededDraws(cfg, SMALL_SEED)
        st = setup(cfg, sc.state, draw=draws)
        out = [convert.to_arrays(st)]
        run = make_run(cfg, 1, draw=draws)
        for _ in range(SMALL_STEPS):
            st = run(st)
            out.append(convert.to_arrays(st))
        runs.append(out)
    dev_run, cpu_run = runs
    for i in (0, 1):
        got, want = dev_run[i], cpu_run[i]
        for k in SMALL_EXACT:
            if not np.array_equal(got[k], want[k]):
                fail(f"small path, state {i}: {k} differs from the CPU's")
        for k in SMALL_CLOSE:
            d = float(np.abs(got[k] - want[k]).max())
            if not d <= 1e-4:
                fail(f"small path, state {i}: {k} differs by {d}")
        fmax = float(np.abs(want["f"]).max())
        d = float(np.abs(got["f"] - want["f"]).max())
        if not d <= 2e-4 * fmax:
            fail(f"small path, state {i}: f differs by {d} (max|f| {fmax})")
    if int(cpu_run[1]["ninserted"]) <= int(cpu_run[0]["ninserted"]):
        fail("small path: the first step inserted no atoms")
    got, want = dev_run[-1], cpu_run[-1]
    for k in ("ndeleted", "ninserted", "insert_fail", "maxtag", "rebuilds",
              "overflow", "cell_overflow", "step"):
        if int(got[k]) != int(want[k]):
            fail(f"small path after {SMALL_STEPS} steps: {k} {int(got[k])} != "
                 f"{int(want[k])}")

    def by_tag(d):
        keep = d["alive"]
        return dict(zip(d["tag"][keep].tolist(), d["x"][keep]))
    mg, mw = by_tag(got), by_tag(want)
    if set(mg) != set(mw):
        fail(f"small path after {SMALL_STEPS} steps: the alive tags differ")
    err = max(float(np.abs(mg[t] - mw[t]).max()) for t in mw)
    if not err < 5e-3:
        fail(f"small path after {SMALL_STEPS} steps: positions by tag differ "
             f"by {err}")
    log(f"small path (scale {SMALL_SCALE}, {len(mw)} atoms, "
        f"{int(want['ninserted'])} inserted, {int(want['ndeleted'])} "
        f"deleted): the card agrees with the CPU, positions by tag within "
        f"{err:.2e} after {SMALL_STEPS} steps")
    return err


def profile_steps(run, state, nsteps: int):
    """Where a main-path step's time goes: torch.profiler over `nsteps`
    steps.  Device busy time is the sum of the device intervals of every
    kernel and copy (one stream, so they do not overlap); the idle share is
    1 - busy / wall.  Returns None when the profiler sees no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        state = run(state)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not by_name:
        return None
    busy_us = sum(us for _, us in by_name.values())
    launches = sum(n for n, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(
        steps=nsteps, wall_ms_per_step=wall_us / nsteps / 1e3,
        device_busy_ms_per_step=busy_us / nsteps / 1e3,
        idle_share=1.0 - busy_us / wall_us,
        device_ops_per_step=launches / nsteps,
        top=[dict(name=name[:90], ms_per_step=us / nsteps / 1e3,
                  calls_per_step=n / nsteps) for name, (n, us) in top])


def repack(cfg, state, cap):
    """bench.py's repack: a fresh layout at another filing capacity."""
    from obmd_tpu_torch.cellpad import layout_build
    from obmd_tpu_torch.engine_cellpad import make_geometry
    cfg = dataclasses.replace(cfg, capacity=dataclasses.replace(
        cfg.capacity, cell_capacity=cap)).finalize()
    geom = make_geometry(cfg)
    return cfg, geom, layout_build(geom, cfg.box, state)


def max_cell_count(geom, state) -> int:
    """The most alive atoms in one cell: what a fresh layout at this
    state must file (more than the filing cap is a cell overflow)."""
    import torch
    cell = geom.cell_of(state.x[state.alive]).long()
    return int(torch.bincount(cell, minlength=geom.n_cells).max())


def run_smoke():
    """Phases 2-5; returns the main-path and kernel figures."""
    import torch
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import auto_rebuild_every, make_geometry
    from obmd_tpu_torch.integrate import equilibrate, make_run, setup
    from obmd_tpu_torch.observe import check_invariants, make_obmd_metrics_fn

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for kern in _build.KERNELS.values():
        log(f"{kern.source}: build {kern.build_seconds} s\n{kern.ptxas_info}")

    # ---- phase 3: the whole path at a small size against the CPU, then the
    # kernels against their plain versions at bench shapes (cap 24)
    with KeepCounts():
        small_err = check_small_path()
    sc = scenes.obmd_dpd_scene(scale=SCALE, seed=SEED, device=DEV)
    geom24 = make_geometry(sc.cfg)
    st = setup(sc.cfg, sc.state)
    sync()
    pair24 = check_pair(sc.cfg, geom24, st, "cap 24")
    usher = check_usher(sc.cfg, geom24, st)
    del st

    # ---- phase 4: the main path, then the insertion phase
    _build.reset_launch_counts()
    t_path = time.perf_counter()
    sc = scenes.obmd_dpd_scene(scale=SCALE, seed=SEED, device=DEV)
    st = setup(sc.cfg, sc.state)
    t_eq = time.perf_counter()
    st = equilibrate(sc.cfg, st, EQUIL)
    sync()
    eq_s = time.perf_counter() - t_eq
    cfg15, geom15, st = repack(sc.cfg, st, PROD_CAP)
    occupancy = [max_cell_count(geom15, st)]
    run = make_run(cfg15, NSTEPS)
    st = run(st)
    sync()
    occupancy.append(max_cell_count(geom15, st))
    windows = []
    for _ in range(2):
        s0 = st.step
        t1 = time.perf_counter()
        st = run(st)
        sync()
        windows.append((time.perf_counter() - t1, st.step - s0))
        occupancy.append(max_cell_count(geom15, st))
    tel = check_invariants(cfg15, st)
    natoms = int(st.natoms)
    st15 = st

    m = make_obmd_metrics_fn(sc.cfg)(st)
    census = 0.5 * (int(m.nbuf_left) + int(m.nbuf_right))
    cfg_ins = dataclasses.replace(sc.cfg, obmd=dataclasses.replace(
        sc.cfg.obmd, nbuf=1.05 * census / sc.cfg.obmd.alpha)).finalize()
    _, _, st = repack(cfg_ins, st, sc.cfg.capacity.cell_capacity)
    ins0 = int(st.obmd.ninserted)
    t_ins = time.perf_counter()
    st = make_run(cfg_ins, INS_STEPS)(st)
    sync()
    ins_s = time.perf_counter() - t_ins
    tel_ins = check_invariants(cfg_ins, st)
    inserted = int(st.obmd.ninserted) - ins0
    if inserted <= 0:
        fail("insertion phase inserted no atoms")
    if not (bool(torch.isfinite(st.x[st.alive]).all())
            and bool(torch.isfinite(st.v[st.alive]).all())):
        fail("non-finite positions or velocities")
    path_s = time.perf_counter() - t_path
    launches = {k.name: (k.launches, dict(k.launches_by_shape))
                for k in _build.KERNELS.values()}
    log(f"main path {path_s:.1f} s (equilibrate {eq_s:.1f} s), telemetry "
        f"{tel}, most atoms in one cell at the repack and after each "
        f"production window {occupancy} (filing cap {PROD_CAP}); insertion "
        f"phase: nbuf {cfg_ins.obmd.nbuf:.1f}, {inserted} inserted in "
        f"{INS_STEPS} steps ({ins_s:.2f} s), {tel_ins}; launches {launches}")
    for name, (n, _) in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    # ---- phase 5: the pair kernel at cap 15 on the repacked state, and a
    # profile of two relayout epochs of the main path's runner
    pair15 = check_pair(cfg15, geom15, st15, "cap 15")
    r_every = auto_rebuild_every(cfg15)
    prof = profile_steps(make_run(cfg15, 2 * r_every), st15, 2 * r_every)
    log(f"profile: {prof}")

    pk = _build.KERNELS["dpd_pair"]
    uk = _build.KERNELS["usher_search"]
    by = launches["dpd_pair"][1]
    kernels = [
        dict(name="dpd_pair (fill cap 15)", route="cuda",
             source=f"obmd_tpu_torch/csrc/{pk.source}",
             replaces="obmd_tpu/forces/pallas_dpd.py:575",
             launches=by.get("cap15", 0), **pair15),
        dict(name="dpd_pair (fill cap 24)", route="cuda",
             source=f"obmd_tpu_torch/csrc/{pk.source}",
             replaces="obmd_tpu/forces/pallas_dpd.py:324",
             launches=by.get("cap24", 0), **pair24),
        dict(name="usher_search", route="cuda",
             source=f"obmd_tpu_torch/csrc/{uk.source}",
             replaces=uk.replaces, launches=launches["usher_search"][0],
             **usher),
    ]
    wall, steps = min(windows)
    path = dict(atoms=natoms, ms_per_step=wall / steps * 1e3,
                mparticle_steps_per_s=steps / wall * natoms / 1e6,
                windows_s=[w for w, _ in windows], build_s=build_s,
                equilibrate_s=eq_s, main_path_s=path_s,
                max_cell_count_cap15=max(occupancy),
                insertion_phase_inserted=inserted,
                small_path_max_pos_err=small_err, profile=prof)
    return dict(path=path, kernels=kernels)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    try:
        import obmd_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"obmd_tpu_torch is not importable here ({e}); run from the "
             "repository root")
    # the path has no matrix product; state the float32 rule explicitly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed rc={smi.returncode}: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    result = run_smoke()
    print(json.dumps(result["path"]))
    print(json.dumps({"kernels": result["kernels"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
