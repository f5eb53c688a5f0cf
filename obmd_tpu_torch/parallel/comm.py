"""The collective layer of the multi-device steps, over torch.distributed.

The JAX package runs its multi-device steps under `shard_map` on a 1-D
device mesh, with `lax.psum`, `lax.pmax`, `lax.all_gather` and
`lax.ppermute` (obmd_tpu/parallel/atom_decomp.py, slab_decomp.py).  Here
each rank is one process holding its own rank-local state, and `Comm` is
its view of the group: `sum`, `max`, `min` and `all_gather` are the
all-reduces and the tiled all-gather; `exchange` and `shift` are the
ppermutes to the neighbouring ranks (`_send_right` / `_send_left`), the
edge rank receiving zeros as ppermute gives them.  Every rank must call
the same collectives in the same order: a host-side `if` that guards one
reads a value that is already reduced (or replicated, as the step count).

Backends.  A neighbour exchange is one `batch_isend_irecv` of each
direction's tensors packed into one byte buffer.  Under NCCL every tensor
stays on its card.  Gloo takes CUDA tensors in its all-reduce and
all-gather but not in send and recv (torch 2.11 on the H100: a send of
device memory fails with "Bad address"; `python -m
obmd_tpu_torch.parallel.comm` checks this build), so under gloo an
exchange copies its CUDA buffers to the host before the call and back
after it, and the reductions and the all-gather hand gloo the CUDA
tensors.  The caller chooses the transport: several ranks on one card
need gloo, as NCCL refuses two ranks on one device.

`spawn` starts the ranks: one process each, by the `spawn` start method,
meeting at a FileStore in a temporary directory.  It joins them with a
hard timeout and, on the first failure or the timeout, kills every rank
and raises with each failed rank's traceback.  `Launch` is the same in two
steps: the ranks boot when it is made and take their call from `run`, so
that a caller prepares the ranks' inputs while they boot.
"""
from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _flat_bytes(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, concatenated into one uint8 tensor."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


def _unflat(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> list:
    """Tensors shaped and typed as `like` from the bytes of buf."""
    out, a = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        # a copy: a slice at an odd byte offset cannot be viewed as a
        # wider type
        out.append(buf[a:a + n].clone().view(t.dtype).reshape(t.shape))
        a += n
    return out


class Comm:
    """One rank's collectives over `group` (None: a world of one rank
    with no process group, where every reduction is the identity)."""

    def __init__(self, group, rank: int, world: int, device,
                 backend: Optional[str] = None):
        self.group = group
        self.rank = int(rank)
        self.world = int(world)
        self.device = torch.device(device)
        self.backend = backend
        # gloo's send and recv take no CUDA tensor
        self.p2p_via_host = backend == "gloo" and self.device.type == "cuda"

    @classmethod
    def solo(cls, device) -> "Comm":
        """A single rank without a process group."""
        return cls(None, 0, 1, device)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.p2p_via_host else t

    def _back(self, t: torch.Tensor, device) -> torch.Tensor:
        return t.to(device) if self.p2p_via_host else t

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return t
        if t.dtype == torch.bool:
            buf = t.to(torch.int32)
            dist.all_reduce(buf, op=op, group=self.group)
            return buf > 0
        buf = t.clone()
        dist.all_reduce(buf, op=op, group=self.group)
        return buf

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum over the ranks (`lax.psum`)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the ranks (`lax.pmax`)."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def min(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise minimum over the ranks (`lax.pmin`)."""
        return self._reduce(t, dist.ReduceOp.MIN)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t concatenated along the first axis in rank order
        (`lax.all_gather(..., tiled=True)`; a 0-dim t gives [world])."""
        if self.group is None:
            return t.reshape((-1,) + tuple(t.shape[1:]))
        src = t.contiguous()
        if src.dim() == 0:
            src = src.reshape(1)
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts)

    def exchange(self, to_left: Sequence[torch.Tensor],
                 to_right: Sequence[torch.Tensor]):
        """Send the tensors to_left to rank - 1 and to_right to rank + 1
        in one batch; returns (from_right, from_left): what rank + 1 sent
        left and what rank - 1 sent right, shaped as to_left and to_right
        (zeros where there is no such rank).  Every rank passes tensors of
        the same shapes and types."""
        from_right = [torch.zeros_like(t) for t in to_left]
        from_left = [torch.zeros_like(t) for t in to_right]
        if self.group is None or self.world == 1:
            return from_right, from_left
        dev = (list(to_left) + list(to_right))[0].device
        lo, hi = self.rank - 1, self.rank + 1
        ops, recv = [], {}

        def post(tensors, dst, src, key):
            # tensors go to dst; their like arrive from src
            if not tensors:
                return
            if 0 <= dst < self.world:
                ops.append(dist.P2POp(dist.isend, self._wire(
                    _flat_bytes(tensors)), dst, self.group))
            if 0 <= src < self.world:
                recv[key] = self._wire(torch.empty(
                    sum(t.numel() * t.element_size() for t in tensors),
                    dtype=torch.uint8, device=dev))
                ops.append(dist.P2POp(dist.irecv, recv[key], src,
                                      self.group))

        post(to_left, lo, hi, "right")
        post(to_right, hi, lo, "left")
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        if "left" in recv:
            from_left = _unflat(self._back(recv["left"], dev), to_right)
        if "right" in recv:
            from_right = _unflat(self._back(recv["right"], dev), to_left)
        return from_right, from_left

    def shift(self, val: torch.Tensor, direction: int) -> torch.Tensor:
        """val sent to rank + direction (+1: `_send_right`, -1:
        `_send_left`); returns what arrives from rank - direction, zeros
        on the edge rank that has none."""
        if direction == 1:
            return self.exchange([], [val])[1][0]
        if direction == -1:
            return self.exchange([val], [])[0][0]
        raise ValueError(f"direction must be +1 or -1, not {direction}")


def rank_device(backend: str, device: str, rank: int) -> torch.device:
    """The device of a rank: cuda:rank under NCCL, under gloo the card the
    ranks share round robin (cuda:0 on a one-card machine), or the CPU."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % torch.cuda.device_count())


def check_launch(world: int, backend: str, device: str) -> None:
    """Raise for a launch that cannot run: NCCL on the CPU, more NCCL
    ranks than cards (NCCL refuses two ranks on one device: name gloo),
    a card asked for where there is none.  Nothing switches backend or
    device on its own."""
    if world < 1:
        raise ValueError(f"world must be >= 1, not {world}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' with backend='gloo'")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL runs on the card: pass device='cuda', or "
                             "backend='gloo' for the CPU")
        if world > torch.cuda.device_count():
            raise ValueError(
                f"{world} NCCL ranks on {torch.cuda.device_count()} card(s): "
                "NCCL refuses two ranks on one device; pass backend='gloo' "
                "to share the cards")


def _child(call_path, rank, world, backend, device, store_path, results):
    torch.set_num_threads(1)
    try:
        dev = rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        # booted: wait for the call (Launch.run), or end with the launcher
        parent = os.getppid()
        while not os.path.exists(call_path):
            if os.getppid() != parent:
                return
            time.sleep(0.02)
        with open(call_path, "rb") as fh:
            fn, args = pickle.load(fh)
        out = fn(Comm(dist.group.WORLD, rank, world, dev, backend), *args)
    except BaseException:
        # report first: a rank still waiting in a collective is killed by
        # the launcher
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))
    dist.destroy_process_group()


class Launch:
    """`world` rank processes (the spawn start method, daemonic), started
    here and met at a FileStore in a fresh directory (under store_dir when
    given, else the temporary directory): each imports, takes its device
    and joins the process group, then waits for run's call, so that the
    caller can prepare the ranks' inputs while they boot.  run(fn, *args)
    pickles fn (by its import path) and args once into a file that every
    rank reads (handed to each process at its start, they would be
    written through its pipe while it boots, and the ranks would start
    one after another), runs fn(comm, *args) on every rank and returns
    the results in rank order.  On the first rank that fails, or when
    timeout_s passes from run's call, every rank is killed and
    RuntimeError raised with each failed rank's traceback.  One call a
    launch; close() (run's end) kills what is left."""

    def __init__(self, world: int, backend: str = "nccl",
                 device: str = "cuda", timeout_s: float = 600.0,
                 store_dir: Optional[str] = None):
        import multiprocessing as mp
        check_launch(world, backend, device)
        ctx = mp.get_context("spawn")
        self.world, self.timeout_s = world, timeout_s
        self.tmp = tempfile.mkdtemp(prefix="obmd_ranks_", dir=store_dir)
        self.call_path = os.path.join(self.tmp, "call.pkl")
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_child, args=(
            self.call_path, r, world, backend, device,
            os.path.join(self.tmp, "store"), self.results), name=f"rank{r}",
            daemon=True) for r in range(world)]
        try:
            for p in self.procs:
                p.start()
        except BaseException:
            self.close()
            raise

    def run(self, fn, *args):
        world, results, procs = self.world, self.results, self.procs
        out, failed = {}, {}
        try:
            part = self.call_path + ".part"
            with open(part, "wb") as fh:
                pickle.dump((fn, args), fh, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(part, self.call_path)
            deadline = time.monotonic() + self.timeout_s
            while len(out) < world and not failed:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"{world} ranks did not finish within "
                        f"{self.timeout_s} s (done: {sorted(out)}); every "
                        "rank was killed")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if p.exitcode not in (None, 0) and r not in out:
                            failed[r] = (f"rank {r} exited with code "
                                         f"{p.exitcode} and reported "
                                         "nothing")
                    continue
                if ok:
                    out[rank] = payload
                else:
                    failed[rank] = payload
            if failed:
                # the other ranks' reports, where they failed too
                t_end = time.monotonic() + 1.0
                while time.monotonic() < t_end:
                    try:
                        rank, ok, payload = results.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    if not ok:
                        failed[rank] = payload
                raise RuntimeError("ranks failed:\n" + "\n".join(
                    f"--- rank {r} ---\n{failed[r]}" for r in sorted(failed)))
            return [out[r] for r in range(world)]
        finally:
            self.close()

    def close(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=10)
        self.results.close()
        shutil.rmtree(self.tmp, ignore_errors=True)


def spawn(fn, world: int, backend: str = "nccl", device: str = "cuda",
          timeout_s: float = 600.0, *args, store_dir: Optional[str] = None):
    """Run fn(comm, *args) on `world` ranks, one process each, and return
    their results in rank order: Launch(...).run(fn, *args)."""
    return Launch(world, backend, device, timeout_s, store_dir).run(fn,
                                                                    *args)


def _gloo_op(comm: Comm, op: str):
    """One gloo operation on CUDA tensors, as given (no host copy)."""
    dev = comm.device
    if op == "all_reduce":
        t = torch.ones(4, device=dev)
        dist.all_reduce(t, group=comm.group)
        return t.tolist()
    if op == "all_gather":
        parts = [torch.empty(4, device=dev) for _ in range(comm.world)]
        dist.all_gather(parts, torch.full((4,), float(comm.rank),
                                          device=dev), group=comm.group)
        return [p.tolist() for p in parts]
    peer = 1 - comm.rank
    t = torch.full((4,), float(comm.rank), device=dev)
    r = torch.empty(4, device=dev)
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, peer, comm.group),
            dist.P2POp(dist.irecv, r, peer, comm.group)]):
        w.wait()
    return r.tolist()


def gloo_cuda_support(timeout_s: float = 60.0) -> dict:
    """Which operations this build's gloo takes on CUDA tensors as they
    are: each run on two ranks on the card in a spawn of its own ({op:
    True, or the first line of the failure})."""
    out = {}
    for op in ("all_reduce", "all_gather", "batch_isend_irecv"):
        try:
            res = spawn(_gloo_op, 2, "gloo", "cuda", timeout_s, op)
            want = {"all_reduce": [[2.0] * 4] * 2,
                    "all_gather": [[[0.0] * 4, [1.0] * 4]] * 2,
                    "batch_isend_irecv": [[1.0] * 4, [0.0] * 4]}[op]
            out[op] = True if res == want else f"wrong result {res}"
        except RuntimeError as e:
            lines = [ln for ln in str(e).splitlines() if ln.strip()]
            out[op] = lines[-1][:200]
    return out


if __name__ == "__main__":
    # python -m obmd_tpu_torch.parallel.comm: what gloo takes on the card
    print(torch.__version__, gloo_cuda_support())
