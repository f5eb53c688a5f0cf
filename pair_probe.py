#!/usr/bin/env python3
"""The Hopper pair kernel against another tree's, row by row, on one card.

    python3 pair_probe.py --parent DIR [--out FILE]

DIR is another checkout of the repo (e.g. the parent commit, unpacked with
`git archive <commit> | tar -x -C _parent/tree`).  The script builds both
trees' kernels at once (DIR's in a process of its own), makes the rows'
inputs once with this tree: path I's warmed SPC/E water
(`ljrf-t2-excl2-cap150`: open_water_scene, chip_smoke.warmed_water), the
same with its atoms moved across the y and z faces without a relayout
(chip_smoke.stale_inputs), path K's rigid water set up from it, and
OBMD_DPD at scale 9 (`dpd-cap24`), the open LJ fluid (`lj-cap44`) and the
open charged fluid (`ljrf-t2-cap44`) MELT_STEPS steps from their set-up
lattices.  It holds this tree's kernel to its plain version on each row
(chip_smoke.check_pair_inputs: the row, a copy with holes and a copy with
atoms across a face, two launches the same bytes; its log line names the
plan's body, blocks, shared memory and, for the dense body, resident
blocks an SM),
then times each row in a worker process of each tree in turns, parent,
change, change, parent (each tree's own chip_smoke.time_ms), and hashes
each tree's output bytes.  Meanwhile `python3 -m obmd_tpu_torch._build`
lines up the two sources' ptxas figures, and torch.profiler splits the
water rows' C call by kernel.  Prints, before its last line,
the card's name and power limit, and as its last line one JSON object:
per row the four times, whether both trees gave the same bytes, and this
tree's check figures; the ptxas comparison.  Run it from the root of the
repo.  Exits 1 where a check fails.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ORDER = ("parent", "change", "change", "parent")
# steps run from the set-up lattices of the rows other than water, so that
# their forces are a fluid's (at the lattice the sum check's 1e-3 x max|f|
# is below float32 rounding)
MELT_STEPS = 100


def worker(path: str) -> None:
    """Time every row of `path` with the tree in PAIR_PROBE_TREE and print
    {row: {ms, sha}} as one JSON line."""
    tree = os.environ["PAIR_PROBE_TREE"]
    sys.path[:] = [tree] + [p for p in sys.path
                            if p and Path(p).resolve() != ROOT]
    import torch
    from chip_smoke import time_ms
    from obmd_tpu_torch.engine_cellpad import _make_kernel
    rows = torch.load(path, weights_only=False)
    out = {}
    for r in rows:
        kern = _make_kernel(r["cfg"], r["geom"], "pair")
        fld, tag, occ, pbond = (None if t is None else t.cuda()
                                for t in r["inputs"])
        salt = r["salt"]
        f = kern(fld, tag, salt, occ, pbond)
        torch.cuda.synchronize()
        sha = hashlib.sha256(f.cpu().numpy().tobytes()).hexdigest()[:16]
        out[r["name"]] = dict(
            ms=time_ms(lambda: kern(fld, tag, salt, occ, pbond)), sha=sha)
    print(json.dumps(out), flush=True)


def device_split(row, calls: int = 10) -> dict:
    """The device time (ms a call) of each CUDA kernel of one row's C call,
    by name (torch.profiler over `calls` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from obmd_tpu_torch.engine_cellpad import _make_kernel
    kern = _make_kernel(row["cfg"], row["geom"], "pair")
    fld, tag, occ, pbond = row["inputs"]
    kern(fld, tag, row["salt"], occ, pbond)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kern(fld, tag, row["salt"], occ, pbond)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            out[e.key[:80]] = e.device_time_total / calls / 1e3
    return out


def in_tree(tree: Path, *args, background=False):
    """Run this script (or `python3 -c`, args[0] == "-c") with `tree`'s
    package first on the path."""
    env = dict(os.environ, PAIR_PROBE_TREE=str(tree))
    cmd = [sys.executable, *args] if args[0] == "-c" else \
        [sys.executable, str(ROOT / "pair_probe.py"), *args]
    if background:
        return subprocess.Popen(cmd, cwd=tree, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    p = subprocess.run(cmd, cwd=tree, env=env, stdout=subprocess.PIPE,
                       stderr=subprocess.PIPE, text=True)
    if p.returncode != 0:
        sys.exit(f"pair_probe: {tree}: rc={p.returncode}\n{p.stderr[-4000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def make_rows():
    """The rows' configs, geometries and packed inputs (on the card), each
    held to its plain version as it is made (the water lattice first, so
    that a wrong kernel stops the probe before the warm-up)."""
    import chip_smoke as cs
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.engine_cellpad import (_make_kernel, make_geometry,
                                               pack_fields)
    from obmd_tpu_torch.forces.pair_kernel import PairCoef
    from obmd_tpu_torch.integrate import make_run, setup
    rows = []

    def add(name, cfg, state, stale=False):
        geom = make_geometry(cfg)
        fld, tag, salt, occ, pbond = pack_fields(cfg, geom, state)
        if stale:
            fld, _ = cs.stale_inputs(geom, fld)
        figs, _ = cs.check_pair_inputs(
            geom, PairCoef.of(geom, cfg.pair, cfg.dt),
            _make_kernel(cfg, geom, "pair"), (fld, tag, salt, occ, pbond),
            state.alive, name)
        rows.append(dict(name=name, cfg=cfg, geom=geom, salt=salt,
                         inputs=(fld, tag, occ, pbond), check=figs))
    t0 = time.perf_counter()
    sc = scenes.open_water_scene(device="cuda")
    add("ljrf-t2-excl2-cap150 (path I's lattice)", sc.cfg,
        setup(sc.cfg, sc.state))
    st = cs.warmed_water(sc.cfg, sc.state)
    add("ljrf-t2-excl2-cap150 (path I)", sc.cfg, st)
    add("ljrf-t2-excl2-cap150 (path I, atoms across a face)", sc.cfg, st,
        stale=True)
    kcfg = scenes.open_water_config(rigid=True)
    add("ljrf-t2-excl2-cap150 (path K)", kcfg,
        setup(kcfg, scenes.rigid_water_start(kcfg, st)))
    cs.log(f"water rows in {time.perf_counter() - t0:.1f} s")
    for name, make in (
            ("dpd-cap24", lambda: scenes.obmd_dpd_scene(scale=9, seed=7,
                                                        device="cuda")),
            ("lj-cap44", lambda: scenes.obmd_lj_scene(device="cuda")),
            ("ljrf-t2-cap44", lambda: scenes.obmd_ljrf_scene(
                device="cuda"))):
        sc = make()
        add(name, sc.cfg, make_run(sc.cfg, MELT_STEPS)(
            setup(sc.cfg, sc.state)))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker")
    a = ap.parse_args()
    if a.worker:
        worker(a.worker)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("pair_probe: no CUDA device")
    import chip_smoke as cs
    from obmd_tpu_torch import _build
    parent = a.parent.resolve()
    build = in_tree(parent, "-c", "from obmd_tpu_torch import _build; "
                    "_build.build_all([_build.KERNELS['pair']], [])",
                    background=True)
    t0 = time.perf_counter()
    _build.build_all(list(_build.KERNELS.values()), [])
    cs.log(f"this tree's kernels built in {time.perf_counter() - t0:.1f} s")
    src = "obmd_tpu_torch/csrc/pair_kernel.cu"
    ptxas = subprocess.Popen(
        [sys.executable, "-m", "obmd_tpu_torch._build", str(parent / src),
         str(ROOT / src)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        rows = make_rows()
    finally:
        if sys.exc_info()[0] is not None:
            build.kill()
            ptxas.kill()
    split = {r["name"]: device_split(r) for r in rows
             if r["name"].startswith("ljrf-t2-excl2")}
    cs.log(f"device time by kernel (ms a call): {split}")
    log, _ = build.communicate()
    if build.returncode != 0:
        sys.exit(f"pair_probe: the parent's build failed:\n{log[-4000:]}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rows.pt")
        torch.save([dict(name=r["name"], cfg=r["cfg"], geom=r["geom"],
                         salt=r["salt"],
                         inputs=tuple(None if t is None else t.cpu()
                                      for t in r["inputs"]))
                    for r in rows], path)
        turns = [(who, in_tree(parent if who == "parent" else ROOT,
                               "--worker", path)) for who in ORDER]
    log, _ = ptxas.communicate()
    try:
        ptx = json.loads(log.strip().splitlines()[-1])
    except (ValueError, IndexError):
        ptx = {"error": log[-2000:]}
    report = {}
    for r in rows:
        name = r["name"]
        times = {who: [t[name]["ms"] for w, t in turns if w == who]
                 for who in ("parent", "change")}
        shas = {t[name]["sha"] for _, t in turns}
        report[name] = dict(**times, same_bytes=len(shas) == 1,
                            check=r["check"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = dict(rows=report, device_split=split, ptxas=ptx, order=ORDER,
               device=torch.cuda.get_device_name(0))
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(out, indent=1))
    print(card.strip())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
