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
  5. the pair kernel and the legacy full-stencil kernel (make_dpd_kernel's
     counterpart, DPD law) against their plain versions and each other at
     cap 15 on the repacked state of phase 4, and a torch.profiler trace of
     two relayout epochs of the main path's runner there (device busy time,
     idle share, the operations that take the most device time);
  6. the main path through the full-stencil kernel: FULL_STEPS steps of
     phase 4's production from the same state, make_run(kernel="full"),
     launch counts zeroed before and read after, check_invariants;
  7. the LJ melt path as bench_lj.py drives it: lj_melt_scene(nx=20)
     (32,000 atoms, fully periodic, cap 36, a p == 1 layout), setup,
     make_run(400) warm, two timed make_run(400) windows, check_invariants;
     thermo (through the pair sweep) at the start and end of the timed
     windows, |dE_tot|/N <= 1e-2 over the 800 steps; launch counts zeroed
     before setup and read after the last window; then a profile of two
     relayout epochs;
  8. the LJ path through the full-stencil kernel: FULL_STEPS steps from the
     ended state of phase 7, counts zeroed before and read after, the same
     energy bar over those steps, check_invariants;
  9. on the ended state of phase 7: forces against the port's pair sweep
     (zero sweep overflow), both kernels against their plain versions and
     each other; then the pair kernel alone at nx = 40 (256,000 atoms, 512
     lanes) on a jittered lattice against its plain version;
 10. the figures of both paths, the kernel figures ({"kernels": [...]}),
     the card line, and last {"ok": true, "device": {...}}.

Tolerances are the CPU tests': pair forces within 2e-4 * max|f| over alive
slots and |sum f| <= 1e-3 * max|f| (kernel against plain, kernel against
kernel, and the LJ kernel's forces against the sweep); USHER verdicts equal
on margin-robust candidates (|E - etarget| >= 0.3 at both final positions),
positions within 2e-3, at least 6 candidates checked.  A kernel's ms is the
median of 20 launches timed with CUDA events; bound_ms is the larger of its
bytes (each input read once, each output written once; of a dead slot only
the x that marks it dead) over 3.35 TB/s and its float32 operations over
67 TFLOP/s (H100 SXM data sheet; the work counted from this run's inputs by
pair_work and usher_work).  No PyTorch call computes any kernel's function,
so library_ms is null.  The main path records the most atoms in one cell at
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
# the LJ melt path (bench_lj.py's deck and windows), the kernel-only check's
# size, and the steps each path runs through the full-stencil kernel
LJ_NX, LJ_STEPS, LJ_WIDE_NX, FULL_STEPS = 20, 400, 40, 200

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
# a periodic x adds its minimum image (3) to the distance test; one
# in-cutoff LJ evaluation: 1/r^2, r^-6 (2 multiplies), the force scalar
# (4), the 3-component accumulation on both atoms of the pair (12)
OPS_MI_X = 3
OPS_LJ_FORCE = 19
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


def pair_work(geom, fld, coef):
    """(alive slots, unordered candidate pairs of alive atoms in the 27-cell
    stencil, unordered pairs within the cutoff) of this input: the least
    work of the function, each pair visited once."""
    import torch
    from obmd_tpu_torch.forces.pair_kernel import _neighbor_columns
    nb, nf, cap, lanes = fld.shape
    fl = fld.permute(0, 3, 1, 2).reshape(nb * lanes, nf, cap)
    icol, cols, oks = _neighbor_columns(geom, fld.device)
    live = fl[:, 0, :] < 0.5e8
    not_self = ~torch.eye(cap, dtype=torch.bool, device=fld.device)
    lengths = (coef.lx if coef.periodic_x else 0.0, coef.ly, coef.lz)
    cand = inside = 0
    for o in range(cols.shape[0]):
        xj = fl[cols[o]]
        ok = oks[o][:, None, None] & live[icol][:, :, None] \
            & live[cols[o]][:, None, :]
        if o == 13:                          # the (0, 0, 0) offset
            ok = ok & not_self
        rsq = 0.0
        for c in range(3):
            d = fl[icol, c, :, None] - xj[:, c, None, :]
            if lengths[c]:
                d = d - lengths[c] * torch.round(d / lengths[c])
            rsq = rsq + d * d
        cand += int(ok.sum())
        inside += int((ok & (rsq < coef.cut * coef.cut)).sum())
    return int(live.sum()), cand // 2, inside // 2


def pair_bound(geom, fld, coef):
    """(bound_ms, bound_by, candidate pairs, in-cutoff pairs) of one
    pair-kernel call on this input."""
    n_live, n_cand, n_in = pair_work(geom, fld, coef)
    slots = geom.n_slots
    # x of every slot (it tells dead from alive), the other fields the law
    # reads of the alive slots (dpd: y, z, v and tag; lj: y, z), occ, and
    # the force of every slot
    per_live = 6 if coef.law == "dpd" else 2
    n_bytes = (slots * 4 + n_live * per_live * 4 + geom.n_blocks * 4
               + slots * 3 * 4)
    test = OPS_PAIR_TEST + (OPS_MI_X if coef.periodic_x else 0)
    force = OPS_PAIR_FORCE if coef.law == "dpd" else OPS_LJ_FORCE
    return bound(n_bytes, n_cand * test + n_in * force) + (n_cand, n_in)


def compare_forces(geom, state, got, want, label):
    """Kernel-layout forces against a reference: max error over alive slots
    within 2e-4 * max|f|, finite, zero on dead slots, |sum f| <= 1e-3 *
    max|f|.  Returns (max error, max|f|, |sum f|)."""
    import torch
    alive = state.alive.reshape(geom.n_blocks, geom.cap, geom.lanes)
    sel = alive[:, None].expand_as(want)
    scale = float(want[sel].abs().max())
    err = float((got - want)[sel].abs().max())
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: non-finite forces")
    if not err <= 2e-4 * scale:
        fail(f"{label}: max error {err} > 2e-4 * {scale}")
    if bool((got[~sel] != 0.0).any()):
        fail(f"{label}: force on a dead slot")
    fsum = float(got.permute(0, 2, 3, 1).reshape(-1, 3)[
        state.alive].sum(0).abs().max())
    if not fsum <= 1e-3 * scale:
        fail(f"{label}: |sum f| {fsum} > 1e-3 * {scale}")
    return err, scale, fsum


def check_pair(cfg, geom, state, label, kernel="pair"):
    """A pair kernel ("pair", make_pair_kernel's, or "full",
    make_dpd_kernel's) against its plain version on one state.
    Returns its figures and its forces."""
    from obmd_tpu_torch.engine_cellpad import _make_kernel, pack_fields
    from obmd_tpu_torch.forces.pair_kernel import (PairCoef, legacy_kwargs,
                                                   pair_forces_plain)
    fld, tag, salt, occ = pack_fields(cfg, geom, state)
    kern = _make_kernel(cfg, geom, kernel)
    coef = PairCoef.create(geom, **legacy_kwargs(cfg.pair, cfg.dt))

    def plain():
        return pair_forces_plain(geom, coef, fld, tag, salt,
                                 legacy=kernel == "full")
    with KeepCounts():
        f_k = kern(fld, tag, salt, occ)
        sync()
        f_p = plain()
        sync()
        err, scale, fsum = compare_forces(geom, state, f_k, f_p,
                                          f"{kernel} kernel {label}")
        ms = time_ms(lambda: kern(fld, tag, salt, occ))
        plain_ms = time_ms(plain, reps=5, warmup=1)
    b_ms, b_by, n_cand, n_in = pair_bound(geom, fld, coef)
    log(f"{kernel} kernel {label}: max_abs_err {err:.3e} (max|f| "
        f"{scale:.1f}), |sum f| {fsum:.3e}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, {n_cand} candidate / {n_in} in-cutoff pairs, "
        f"bound {b_ms:.5f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), f_k


def check_both(cfg, geom, state, label):
    """Both pair kernels against their plain versions and each other."""
    pair, f_pair = check_pair(cfg, geom, state, label, "pair")
    full, f_full = check_pair(cfg, geom, state, label, "full")
    err, _, _ = compare_forces(geom, state, f_full, f_pair,
                               f"full against pair kernel {label}")
    log(f"full against pair kernel {label}: max_abs_err {err:.3e}")
    return pair, full


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


def launch_counts():
    from obmd_tpu_torch import _build
    return {k.name: (k.launches, dict(k.launches_by_shape))
            for k in _build.KERNELS.values()}


def require_launches(launches, want, path):
    """want: {kernel name: the launch shapes it must show, or None for
    any}.  Each kernel of `want` was launched on this path, with exactly
    those shapes; no other kernel was."""
    for name, (n, by) in launches.items():
        if name not in want:
            if n:
                fail(f"{path}: kernel {name} launched {by}, expected none")
            continue
        shapes = want[name]
        if n <= 0 or (shapes is not None and set(by) != set(shapes)):
            fail(f"{path}: kernel {name} launched {by}, expected "
                 f"{shapes or 'some'}")


def thermo_line(t):
    n = int(t.natoms)
    return dict(step=t.step, etot_per_atom=(float(t.pe) + float(t.ke)) / n,
                epair_per_atom=float(t.epair) / n, temp=float(t.temp),
                press=float(t.pressure))


def energy_drift(marks, label):
    """|dE_tot|/N between the first and last thermo line, at most 1e-2."""
    drift = abs(marks[-1]["etot_per_atom"] - marks[0]["etot_per_atom"])
    for m in marks:
        log(f"{label} thermo: step {m['step']} E_tot/N "
            f"{m['etot_per_atom']:.6f} E_pair/N {m['epair_per_atom']:.6f} "
            f"temp {m['temp']:.5f} press {m['press']:.5f}")
    if not drift <= 1e-2:
        fail(f"{label}: |dE_tot|/N {drift} > 1e-2 over "
             f"{marks[-1]['step'] - marks[0]['step']} steps")
    return drift


def check_finite(state, label):
    import torch
    if not (bool(torch.isfinite(state.x[state.alive]).all())
            and bool(torch.isfinite(state.v[state.alive]).all())):
        fail(f"{label}: non-finite positions or velocities")


def run_full_path(cfg, state, label):
    """FULL_STEPS steps through the full-stencil kernel from `state`, with
    the launch counts zeroed before and read after.  Returns (end state,
    ms/step, launches)."""
    from obmd_tpu_torch import _build
    from obmd_tpu_torch.integrate import make_run
    from obmd_tpu_torch.observe import check_invariants
    run = make_run(cfg, FULL_STEPS, kernel="full")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state = run(state)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    tel = check_invariants(cfg, state)
    check_finite(state, label)
    log(f"{label} through the full-stencil kernel: {FULL_STEPS} steps "
        f"{wall:.3f} s, telemetry {tel}, launches {launches}")
    return state, wall / FULL_STEPS * 1e3, launches


def run_obmd():
    """Phases 3-6: the OBMD_DPD main path and its kernel checks."""
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import auto_rebuild_every, make_geometry
    from obmd_tpu_torch.integrate import equilibrate, make_run, setup
    from obmd_tpu_torch.observe import check_invariants, make_obmd_metrics_fn

    # ---- phase 3: the whole path at a small size against the CPU, then the
    # kernels against their plain versions at bench shapes (cap 24)
    with KeepCounts():
        small_err = check_small_path()
    sc = scenes.obmd_dpd_scene(scale=SCALE, seed=SEED, device=DEV)
    geom24 = make_geometry(sc.cfg)
    st = setup(sc.cfg, sc.state)
    sync()
    pair24, _ = check_pair(sc.cfg, geom24, st, "dpd cap 24")
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
    check_finite(st, "OBMD_DPD main path")
    path_s = time.perf_counter() - t_path
    launches = launch_counts()
    log(f"main path {path_s:.1f} s (equilibrate {eq_s:.1f} s), telemetry "
        f"{tel}, most atoms in one cell at the repack and after each "
        f"production window {occupancy} (filing cap {PROD_CAP}); insertion "
        f"phase: nbuf {cfg_ins.obmd.nbuf:.1f}, {inserted} inserted in "
        f"{INS_STEPS} steps ({ins_s:.2f} s), {tel_ins}; launches {launches}")
    require_launches(launches, {"pair": ("dpd-cap15", "dpd-cap24"),
                                "usher_search": None}, "OBMD_DPD main path")

    # ---- phase 5: both pair kernels at cap 15 on the repacked state, and a
    # profile of two relayout epochs of the main path's runner
    pair15, full15 = check_both(cfg15, geom15, st15, "dpd cap 15")
    r_every = auto_rebuild_every(cfg15)
    prof = profile_steps(make_run(cfg15, 2 * r_every), st15, 2 * r_every)
    log(f"profile: {prof}")

    # ---- phase 6: the main path's production through the full kernel
    _, full_ms, full_launches = run_full_path(cfg15, st15, "OBMD_DPD")
    require_launches(full_launches, {"dpd_full": ("dpd-cap15",)},
                     "OBMD_DPD through the full-stencil kernel")

    wall, steps = min(windows)
    path = dict(atoms=natoms, ms_per_step=wall / steps * 1e3,
                mparticle_steps_per_s=steps / wall * natoms / 1e6,
                windows_s=[w for w, _ in windows], equilibrate_s=eq_s,
                main_path_s=path_s, max_cell_count_cap15=max(occupancy),
                insertion_phase_inserted=inserted,
                small_path_max_pos_err=small_err, profile=prof,
                full_kernel_ms_per_step=full_ms)
    by = launches["pair"][1]
    kernels = [
        kernel_line("pair", "dpd, fill cap 15",
                    "obmd_tpu/forces/pallas_dpd.py:575",
                    by["dpd-cap15"], pair15),
        kernel_line("pair", "dpd, fill cap 24",
                    "obmd_tpu/forces/pallas_dpd.py:324",
                    by["dpd-cap24"], pair24),
        kernel_line("usher_search", "dpd", None,
                    launches["usher_search"][0], usher),
        kernel_line("dpd_full", "dpd, fill cap 15", None,
                    full_launches["dpd_full"][0], full15),
    ]
    return path, kernels


def kernel_line(name, config, replaces, launches, figures):
    from obmd_tpu_torch import _build
    k = _build.KERNELS[name]
    return dict(name=f"{name} ({config})", route="cuda",
                source=f"obmd_tpu_torch/csrc/{k.source}",
                replaces=replaces or k.replaces, launches=launches,
                **figures)


def run_lj():
    """Phases 7-9: the LJ melt path, its run through the full-stencil
    kernel, and the LJ kernel checks."""
    import torch
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import auto_rebuild_every, make_geometry
    from obmd_tpu_torch.integrate import (compute_forces, make_grid_spec,
                                          make_run, setup)
    from obmd_tpu_torch.observe import check_invariants, make_thermo_fn

    # ---- phase 7: the LJ melt path
    _build.reset_launch_counts()
    t_path = time.perf_counter()
    sc = scenes.lj_melt_scene(nx=LJ_NX, device=DEV)
    cfg = sc.cfg
    geom = make_geometry(cfg)
    thermo = make_thermo_fn(cfg)
    st = setup(cfg, sc.state)
    run = make_run(cfg, LJ_STEPS)
    st = run(st)
    sync()
    marks = [thermo_line(thermo(st))]
    windows = []
    for _ in range(2):
        s0 = st.step
        t1 = time.perf_counter()
        st = run(st)
        sync()
        windows.append((time.perf_counter() - t1, st.step - s0))
        marks.append(thermo_line(thermo(st)))
    tel = check_invariants(cfg, st)
    check_finite(st, "LJ melt path")
    natoms = int(st.natoms)
    path_s = time.perf_counter() - t_path
    launches = launch_counts()
    log(f"LJ melt path (nx {LJ_NX}, {natoms} atoms, {geom}) {path_s:.1f} s, "
        f"windows {windows}, telemetry {tel}, launches {launches}")
    require_launches(launches, {"pair": ("lj-cap36",)}, "LJ melt path")
    drift = energy_drift(marks, "LJ melt")
    r_every = auto_rebuild_every(cfg)
    prof = profile_steps(make_run(cfg, 2 * r_every), st, 2 * r_every)
    log(f"LJ profile: {prof}")

    # ---- phase 8: the LJ path through the full-stencil kernel
    st_full, full_ms, full_launches = run_full_path(cfg, st, "LJ melt")
    require_launches(full_launches, {"dpd_full": ("lj-cap36",)},
                     "LJ melt through the full-stencil kernel")
    full_drift = energy_drift([marks[-1], thermo_line(thermo(st_full))],
                              "LJ melt, full-stencil kernel")

    # ---- phase 9: the ended state against the sweep, both kernels against
    # their plain versions and each other, then 512 lanes at nx = 40
    pf, ctab = compute_forces(cfg, make_grid_spec(cfg), st)
    if int(ctab.overflow) != 0:
        fail(f"LJ sweep: cell overflow {int(ctab.overflow)}")
    f_sweep = pf.f.reshape(geom.n_blocks, geom.cap, geom.lanes, 3) \
        .permute(0, 3, 1, 2)
    f_path = st.f.reshape(geom.n_blocks, geom.cap, geom.lanes, 3) \
        .permute(0, 3, 1, 2)
    sweep_err, sweep_scale, _ = compare_forces(
        geom, st, f_path, torch.where(st.alive.reshape(
            geom.n_blocks, 1, geom.cap, geom.lanes), f_sweep, 0.0),
        "LJ path forces against the pair sweep")
    log(f"LJ path forces against the pair sweep: max_abs_err "
        f"{sweep_err:.3e} (max|f| {sweep_scale:.1f})")
    pair36, full36 = check_both(cfg, geom, st, "lj cap 36")

    wide = scenes.lj_melt_scene(nx=LJ_WIDE_NX, device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(LJ_WIDE_NX)
    x = wide.state.x + 0.05 * torch.randn(wide.state.x.shape, generator=gen,
                                          device=DEV)
    wgeom = make_geometry(wide.cfg)
    with KeepCounts():
        wst = setup(wide.cfg, wide.state.replace(x=wide.cfg.box.wrap(x)))
    pair_wide, _ = check_pair(wide.cfg, wgeom, wst,
                              f"lj cap 36, {wgeom.lanes} lanes")
    del wst

    wall, steps = min(windows)
    path = dict(atoms=natoms, ms_per_step=wall / steps * 1e3,
                steps_per_s=steps / wall,
                mparticle_steps_per_s=steps / wall * natoms / 1e6,
                windows_s=[w for w, _ in windows], path_s=path_s,
                thermo=marks, etot_drift_per_atom=drift,
                full_kernel_ms_per_step=full_ms,
                full_kernel_etot_drift_per_atom=full_drift,
                forces_vs_sweep_max_abs_err=sweep_err,
                forces_vs_sweep_max_f=sweep_scale,
                wide_check=dict(nx=LJ_WIDE_NX, lanes=wgeom.lanes,
                                slots=wgeom.n_slots, **pair_wide),
                telemetry=tel, profile=prof)
    kernels = [
        kernel_line("pair", "lj, cap 36, periodic x, p == 1",
                    "obmd_tpu/forces/pallas_dpd.py:324",
                    launches["pair"][1]["lj-cap36"], pair36),
        kernel_line("dpd_full", "lj, cap 36, periodic x, p == 1", None,
                    full_launches["dpd_full"][0], full36),
    ]
    return path, kernels


def run_smoke():
    """Phases 2-9; returns both paths' figures and the kernel figures."""
    from obmd_tpu_torch import _build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for kern in _build.KERNELS.values():
        log(f"{kern.name} ({kern.source}): build {kern.build_seconds} s\n"
            f"{kern.ptxas_info}")
    obmd_path, obmd_kernels = run_obmd()
    lj_path, lj_kernels = run_lj()
    return dict(path=dict(build_s=build_s, obmd_dpd=obmd_path,
                          lj_melt=lj_path),
                kernels=obmd_kernels + lj_kernels)


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
