#!/usr/bin/env python3
"""The USHER kernel's warps-per-candidate probe, on the card.

    python3 usher_probe.py [--warps 1 2 4 8] [--unroll 0 4]

Builds csrc/usher_kernel.cu once for each (warps, unroll) pair, with that
many warps searching each candidate for both laws (the source's Warps
trait) and, for unroll > 0, `#pragma unroll <unroll>` on the loop over a
stencil's atoms, one nvcc per variant, all started together, into
csrc/build/.  On the set-up full-size states of the three USHER paths
(obmd_dpd_scene(scale=9), obmd_lj_scene(), obmd_ljrf_scene()) and the
smoke's candidates (K uniform draws a side from seed 1234) it times each
variant's whole C call (chip_smoke.time_ms; twice, in turns) and its
kernels' device time (torch.profiler, 10 calls).  Each (path, variant,
turn) prints one JSON line; the first line is the card's name and power
limit.  Run it from the root of the repo.

    python3 usher_probe.py --replay

instead follows the search's rounding: on OBMD_DPD's set-up subsets with a
seeded third of the valid rows made invalid and 4 x K uniform candidates a
side (seed 9, like the smoke's holes input), it runs the kernel and the
plain version (obmd.subset.usher_search_subset_batch) with nattempt = 0 ..
40 and prints, for each n, the largest and median distance between the
two searches' positions over the candidates still searching in both, and
how many verdicts differ.  The two sum each energy in another order, ~1e-7
apart, and over a search that difference grows; this is why the smoke
compares the kernel with the plain version one step at a time
(chip_smoke.usher_compare).
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import subprocess

import torch

from chip_smoke import time_ms
from obmd_tpu_torch import _build, scenes
from obmd_tpu_torch.engine_cellpad import _subset_slice, make_geometry
from obmd_tpu_torch.forces.usher_kernel import launch
from obmd_tpu_torch.integrate import setup
from obmd_tpu_torch.obmd.subset import usher_search_subset_batch

PATHS = (("dpd", "usher_search", "obmd_usher_search",
          lambda: scenes.obmd_dpd_scene(scale=9, seed=7, device="cuda")),
         ("lj", "usher_search_lj", "obmd_usher_search_lj",
          lambda: scenes.obmd_lj_scene(device="cuda")),
         ("ljrf", "usher_search_ljrf", "obmd_usher_search_lj",
          lambda: scenes.obmd_ljrf_scene(device="cuda")))
KERNEL_NAMES = r"bin_count|bin_scatter|bin_write|usher_kernel<\d>|[Mm]emset"


def variant_source(src: str, warps: int, unroll: int) -> str:
    """The source with `warps` warps a candidate for both laws and, for
    unroll > 0, the pragma on the stencil loop; raises where the source no
    longer holds the text a substitution rewrites."""
    out, n = re.subn(r"(struct Warps<k(?:Dpd|Lj)> \{\n  static constexpr "
                     r"int value = )\d+;", lambda m: f"{m.group(1)}{warps};",
                     src)
    if n != 2:
        raise ValueError(f"usher_kernel.cu: {n} Warps traits, want 2")
    if unroll:
        loop = "  for (int t = threadIdx.x; t < total;"
        if out.count(loop) != 1:
            raise ValueError("usher_kernel.cu: the stencil loop is not "
                             "found once")
        out = out.replace(loop, f"#pragma unroll {unroll}\n{loop}")
    return out


def build(variants):
    """{(warps, unroll): {symbol: bound function}}, building every variant
    at once."""
    src = (_build.CSRC / "usher_kernel.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for w, u in variants:
        path = _build.BUILD_DIR / f"usher_probe_w{w}_u{u}.cu"
        path.write_text(variant_source(src, w, u))
        procs[w, u] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for (w, u), p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc rc={p.returncode}\n{log}")
        lib = ctypes.CDLL(str(
            _build.BUILD_DIR / f"usher_probe_w{w}_u{u}.so"))
        fns[w, u] = {}
        for sym in ("obmd_usher_search", "obmd_usher_search_lj"):
            f = getattr(lib, sym)
            f.argtypes = list(_build.KERNELS["usher_search"].argtypes)
            f.restype = ctypes.c_int
            fns[w, u][sym] = f
    return fns


def kernel_us(fn, calls: int = 10) -> dict:
    """Device microseconds per call of each kernel the call launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(KERNEL_NAMES, e.key)
        if m and e.device_time_total > 0:
            out[m.group(0)] = e.device_time_total / calls
    return out


def _subsets(cfg, state, k: int, seed: int):
    """Both buffer subsets (engine_cellpad's) and k uniform candidates a
    side from `seed` on the card."""
    geom = make_geometry(cfg)
    o = cfg.obmd
    pad = cfg.pair.max_cut + cfg.skin
    subs = [_subset_slice(cfg, geom, state, r, pad)
            for r in (o.region5, o.region6)]
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    u = torch.rand((2, k, 3), generator=g, device="cuda")
    return subs, o.region5.sample_uniform(u[0]), \
        o.region6.sample_uniform(u[1]), g


def replay():
    sc = PATHS[0][3]()
    cfg = sc.cfg
    o = cfg.obmd
    k = 4 * o.insert_kmax
    (sub_l, sub_r), cl, cr, g = _subsets(cfg, setup(cfg, sc.state), k, 9)
    sub_l, sub_r = (s._replace(valid=s.valid & (torch.rand(
        s.valid.shape, generator=g, device="cuda") >= 1 / 3))
        for s in (sub_l, sub_r))
    ct = torch.zeros((k,), dtype=torch.int32, device="cuda")
    for n in range(o.usher.nattempt + 1):
        cfg_n = dataclasses.replace(cfg, obmd=dataclasses.replace(
            o, usher=dataclasses.replace(o.usher, nattempt=n)))
        pk, ak, ik = launch(cfg_n, sub_l, sub_r, cl, cr, o.region5,
                            o.region6)
        pp, ap, ip = usher_search_subset_batch(cfg_n, sub_l, sub_r, cl, cr,
                                               ct, o.region5, o.region6)
        both = (ik == n) & (ip == n)      # still searching in both
        d = (pk - pp).abs().amax(-1)[both]
        print(json.dumps(dict(
            nattempt=n, searching=int(both.sum()),
            max_dpos=float(d.max()) if d.numel() else 0.0,
            median_dpos=float(d.median()) if d.numel() else 0.0,
            verdicts_differ=int((ak != ap).sum()))), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--warps", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--unroll", type=int, nargs="+", default=[0])
    ap.add_argument("--replay", action="store_true")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.replay:
        return replay()
    variants = [(w, u) for w in args.warps for u in args.unroll]
    fns = build(variants)
    for label, key, sym, make in PATHS:
        sc = make()
        cfg = sc.cfg
        o = cfg.obmd
        (sub_l, sub_r), cl, cr, _ = _subsets(cfg, setup(cfg, sc.state),
                                             o.insert_kmax, 1234)
        kern = _build.KERNELS[key]
        saved = kern._fn

        def call():
            return launch(cfg, sub_l, sub_r, cl, cr, o.region5, o.region6)
        for turn in range(2):
            for w, un in variants:
                kern._fn = fns[w, un][sym]
                iters = call()[2]
                print(json.dumps(dict(
                    path=label, warps=w, unroll=un, turn=turn,
                    ms=time_ms(call), kernel_us=kernel_us(call),
                    iters=int(iters.sum()), max_iters=int(iters.max()))),
                    flush=True)
        kern._fn = saved
        del sc


if __name__ == "__main__":
    main()
