"""Rank functions of the multi-device steps, for `comm.spawn`: each runs
on every rank a list of runs of the slab or atom decomposition from one
global state, and reports what its caller checks.  They live in the
package because `spawn` pickles a function by its import path.

A run is a dict: `cfg` (the scene), `arrays` (the global state as
convert.to_arrays gives it), `seed` (the state's generator seed, the same
on every rank), `steps`, and optionally `warm` (steps before them),
`draws` (a list of one stage call's draws each, as numpy dicts, replayed
in order; else the state's generator), `geom` (make_slab_geom's keyword
arguments), `force_impl`, `balance_every`, `fields` (return rank 0's
pair-kernel inputs after the last step).  Every rank returns, per run:
its live atoms, its launch counts over the run (warm-up included),
whether every rank drew the same candidates' draws, the host seconds of
the steps after the warm-up (synchronized on the card and over the
ranks), and for the slab its live atoms outside its slab, the cuts and
the seconds of the run's set-up, its steps and what follows them; rank 0
also the gathered global state.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import _build, convert
from ..engine_cellpad import own_draws
from ..obmd.stage import Draws
from .comm import Comm


class ReplayDraws:
    """A draw seam that hands out recorded draws in order, one entry per
    stage call (None where the caller had none; the entry is used up
    whether the call needs atoms or not, as a JAX key chain advances)."""

    def __init__(self, seq):
        self.seq = list(seq)
        self.i = 0

    def __call__(self, state, need) -> Optional[Draws]:
        d = self.seq[self.i]
        self.i += 1
        if not need:
            return None

        def t(k):
            v = d.get(k)
            return None if v is None else torch.from_numpy(
                np.asarray(v)).to(state.device)
        return Draws(t("pos"), t("z"), t("vel"), t("tpl"))


class DrawLog:
    """A draw seam that records what another hands out."""

    def __init__(self, inner):
        self.inner = inner
        self.pos = []

    def __call__(self, state, need):
        u = self.inner(state, need)
        if u is not None:
            self.pos.append(u.pos.reshape(-1))
        return u

    def same_on_all(self, comm: Comm) -> bool:
        """Every rank drew the same numbers (collective)."""
        mine = torch.cat(self.pos) if self.pos else \
            torch.zeros((0,), device=comm.device)
        n = comm.all_gather(torch.tensor([mine.numel()],
                                         device=comm.device))
        if bool((n != n[0]).any()):
            return False
        rows = comm.all_gather(mine[None, :]) if mine.numel() else None
        return rows is None or bool((rows == rows[0]).all())


def _counts():
    return {k.name: dict(k.launches_by_shape)
            for k in _build.KERNELS.values() if k.launches}


def _sync(comm: Comm):
    if comm.device.type == "cuda":
        torch.cuda.synchronize(comm.device)
    comm.sum(torch.zeros((1,), device=comm.device))


def _steps(comm: Comm, step, state, run):
    for _ in range(run.get("warm", 0)):
        state = step(state)
    _sync(comm)
    t0 = time.perf_counter()
    for _ in range(run["steps"]):
        state = step(state)
    _sync(comm)
    return state, time.perf_counter() - t0


def slab_runs(comm: Comm, runs):
    """Runs of the slab decomposition (the module's docstring); each also
    reports the live cuts."""
    from .atom_decomp import gather_state
    from .slab_decomp import (_halo_arrays, file_slab, make_slab_geom,
                              make_slab_step, shard_by_slab,
                              with_balance_cuts)
    out = []
    for run in runs:
        t0 = time.perf_counter()
        cfg = run["cfg"]
        state = convert.from_arrays(run["arrays"], seed=run["seed"],
                                    device=comm.device)
        geom = make_slab_geom(cfg, comm.world, **run.get("geom", {}))
        local = shard_by_slab(cfg, geom, state, comm.rank)
        del state
        bal = run.get("balance_every", 0)
        if bal:
            local = with_balance_cuts(geom, local)
        draws = run.get("draws")
        log = DrawLog(ReplayDraws(draws) if draws is not None
                      else own_draws(cfg))
        step = make_slab_step(cfg, comm, geom,
                              force_impl=run.get("force_impl", "gathered"),
                              balance_every=bal, draw=log)
        _build.reset_launch_counts()
        t1 = time.perf_counter()
        local, secs = _steps(comm, step, local, run)
        t2 = time.perf_counter()
        res = dict(natoms=int(local.natoms), launches=_counts(),
                   seconds=secs, same_draws=log.same_on_all(comm),
                   setup_s=t1 - t0, steps_s=t2 - t1)
        cuts = (local.nbrs.cuts if bal else torch.tensor(
            geom.boundaries, dtype=local.dtype, device=local.device))
        lo, hi = cuts[comm.rank], cuts[comm.rank + 1]
        x0 = local.x[:, 0]
        outside = local.alive & (((x0 < lo) & (comm.rank > 0))
                                 | ((x0 >= hi) & (comm.rank < comm.world - 1)))
        res["outside"] = int(outside.sum())
        res["cuts"] = cuts.cpu().numpy()
        if run.get("fields"):
            xs, v, t, g, q, valid, _, extras = _halo_arrays(
                cfg.finalize(), geom, comm, local, lo, hi)
            fld, tag, occ, pbond, _, over = file_slab(
                cfg, geom.pad_geom, xs, v, t, g, q, valid,
                extras.btags if cfg.bond is not None else None)
            if comm.rank == 0:
                res["fields"] = dict(
                    fld=fld.cpu().numpy(), tag=tag.cpu().numpy(),
                    occ=occ.cpu().numpy(), overflow=int(over),
                    step=local.step,
                    pbond=None if pbond is None else pbond.cpu().numpy())
        full = gather_state(comm, local)
        if comm.rank == 0:
            res["state"] = convert.to_arrays(full)
        res["after_s"] = time.perf_counter() - t2
        out.append(res)
    return out


def rank_clock(comm: Comm):
    """The rank's wall clock (time.time()): a task that times the others
    of a rank_tasks list."""
    return time.time()


def rank_tasks(comm: Comm, tasks):
    """Several rank functions on the same ranks, one spawn for all:
    [fn(comm, *args) for fn, args in tasks], in order."""
    return [fn(comm, *args) for fn, args in tasks]


def atom_runs(comm: Comm, runs):
    """Runs of the atom decomposition (the module's docstring)."""
    from .atom_decomp import gather_state, make_sharded_step, shard_state
    out = []
    for run in runs:
        cfg = run["cfg"]
        state = convert.from_arrays(run["arrays"], seed=run["seed"],
                                    device=comm.device)
        local = shard_state(state, comm.world, comm.rank)
        del state
        draws = run.get("draws")
        log = DrawLog(ReplayDraws(draws) if draws is not None
                      else own_draws(cfg))
        step = make_sharded_step(cfg, comm, draw=log)
        _build.reset_launch_counts()
        local, secs = _steps(comm, step, local, run)
        res = dict(natoms=int(local.natoms), launches=_counts(),
                   seconds=secs, same_draws=log.same_on_all(comm))
        full = gather_state(comm, local)
        if comm.rank == 0:
            res["state"] = convert.to_arrays(full)
        out.append(res)
    return out


def collectives(comm: Comm):
    """Each collective of `Comm` on small tensors of this rank's index:
    what a test of the layer compares with the rank arithmetic."""
    dev = comm.device
    r = float(comm.rank)
    t = torch.tensor([r + 1.0, 2.0 * r], device=dev)
    from_r, from_l = comm.exchange(
        [torch.full((2,), comm.rank, dtype=torch.int32, device=dev),
         torch.ones((3,), dtype=torch.bool, device=dev)],
        [torch.full((3,), 10.0 + r, device=dev)])
    return dict(
        sum=comm.sum(t).tolist(), max=comm.max(t).tolist(),
        min=comm.min(t).tolist(),
        any=comm.max(torch.tensor([comm.rank == 1], device=dev)).tolist(),
        gather=comm.all_gather(torch.tensor([comm.rank], device=dev))
        .tolist(),
        from_right=[x.tolist() for x in from_r],
        from_left=[x.tolist() for x in from_l],
        right=comm.shift(torch.tensor([100 + comm.rank], device=dev),
                         1).tolist(),
        left=comm.shift(torch.tensor([100 + comm.rank], device=dev),
                        -1).tolist())
