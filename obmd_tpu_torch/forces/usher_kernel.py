"""The whole USHER steered-insertion search in one kernel launch.

Counterpart of `obmd_tpu/forces/pallas_usher.py` (`usher_law`, its DPD and
LJ-family branches, and `usher_search_pallas`).  The Hopper kernel
`csrc/usher_kernel.cu` replaces `make_usher_kernel`, with one C entry point
per law (`obmd_usher_search` for DPD, `obmd_usher_search_lj` for lj/cut and
the neutral lj/cut/rf rows), each law with its own launch count
(`usher_search`, `usher_search_lj`, `usher_search_ljrf`); its plain version is
`obmd.subset.usher_search_subset_batch`, whose arithmetic the kernel follows
(it is also what the JAX engine runs off the TPU).  A CUDA tensor goes to
the kernel, a CPU tensor to the plain version; the choice is the tensors'
device, never an environment variable.

The laws take per-subset-atom coefficient rows against the fix's single
trial type: DPD E = 0.5*a0*rc*wd^2 (rows a0, cut); lj/cut
E = r^-6 (lj3 r^-6 - lj4) - eshift (rows lj3, lj4, cut, eshift).  lj/cut/rf
takes the lj rows with eshift = 0: an ATOM-mode trial atom is neutral
(q = 0), so the reaction field adds nothing to its energy or force
(pallas_usher.py:57-75).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..cells import BIG
from ..config import DPDParams, LJCutParams, LJCutRFParams
from ..geometry import const
from ..obmd.subset import EPSILON, Subset, pad_subset, usher_search_subset_batch


def usher_law(pair):
    """(kernel name, per-atom coefficient rows, padding) for a pair style:
    the rows are a function type_row [B] -> list of [B] float32 rows against
    the trial type, the kernel the `_build.KERNELS` record that evaluates
    them, the padding each row's value on an invalid subset atom (cut = 1,
    every other coefficient 0, so that a padding row contributes exactly
    zero and never divides by zero; pallas_usher.py:276-285); None when this
    port has no kernel law for the style."""
    if isinstance(pair, DPDParams):
        tabs = [np.asarray(pair.a0, np.float32),
                np.asarray(pair.cut, np.float32)]
        name, pads = "usher_search", (0.0, 1.0)
    elif isinstance(pair, (LJCutParams, LJCutRFParams)):
        eps = np.asarray(pair.epsilon, np.float64)
        sig = np.asarray(pair.sigma, np.float64)
        cut = np.asarray(pair.cut, np.float64)
        s6 = sig ** 6
        lj3 = 4.0 * eps * s6 * s6
        lj4 = 4.0 * eps * s6
        if isinstance(pair, LJCutParams) and pair.shift:
            rc6 = (1.0 / cut ** 2) ** 3
            eshift = rc6 * (lj3 * rc6 - lj4)
        else:
            eshift = np.zeros_like(lj3)
        tabs = [t.astype(np.float32) for t in (lj3, lj4, cut, eshift)]
        name = ("usher_search_lj" if isinstance(pair, LJCutParams)
                else "usher_search_ljrf")
        pads = (0.0, 0.0, 1.0, 0.0)
    else:
        return None

    def rows(ct: int, tj: torch.Tensor):
        tj = tj.long()
        return [const(tuple(t[ct].tolist()), torch.float32, tj.device)[tj]
                for t in tabs]
    return name, rows, pads


def subset_rows(pair, ntype: int, ntypes: int, sub: Subset) -> torch.Tensor:
    """[3 + n_coef, B] kernel input: positions (BIG where invalid) and the
    law's coefficient rows ([5, B] for DPD, [7, B] for lj/cut and
    lj/cut/rf)."""
    law = usher_law(pair)
    if law is None:
        raise NotImplementedError(
            f"USHER kernel: no law for {type(pair).__name__}")
    _, law_rows, pads = law
    valid = sub.valid
    x = torch.where(valid[:, None], sub.x, BIG).to(torch.float32)
    coef = law_rows(ntype, torch.clamp(sub.type, 0, ntypes - 1))
    coef = [torch.where(valid, c, pad) for c, pad in zip(coef, pads)]
    return torch.cat([x.t(), torch.stack(coef)], dim=0)


def launch(cfg, rows, cand, bounds):
    """Launch the law's kernel on prepared inputs (kernel_inputs): rows
    f32[2, 3 + n_coef, B], cand f32[2, K, 3], bounds f32[2, 6], all
    contiguous on one CUDA device."""
    name, _, pads = usher_law(cfg.pair)
    b = rows.shape[-1]
    k = cand.shape[1]
    for arg, t, shape in (("rows", rows, (2, 3 + len(pads), b)),
                          ("cand", cand, (2, k, 3)),
                          ("bounds", bounds, (2, 6))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != rows.device
                or t.device.type != "cuda"):
            raise ValueError(f"USHER kernel: {arg} must be contiguous "
                             f"float32{list(shape)} on the card, got "
                             f"{t.dtype}{list(t.shape)} on {t.device}")
    kern = _build.KERNELS[name]
    fn = kern.function()
    u = cfg.obmd.usher
    dev = rows.device
    per = cfg.box.periodic
    ly = float(cfg.box.lengths[1]) if per[1] else 0.0
    lz = float(cfg.box.lengths[2]) if per[2] else 0.0
    pos = torch.empty((2, k, 3), dtype=torch.float32, device=dev)
    acc = torch.empty((2, k), dtype=torch.int32, device=dev)
    iters = torch.empty((2, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(rows.data_ptr(), cand.data_ptr(), bounds.data_ptr(),
                pos.data_ptr(), acc.data_ptr(), iters.data_ptr(), b, k,
                int(u.nattempt), ly, lz, float(u.etarget + EPSILON),
                float(u.etarget), float(u.ds0), float(u.uovlp),
                float(u.dsovlp), float(4.0 * u.eps), EPSILON, stream)
    _build.check(rc, kern)
    kern.count(f"B{b}")
    return pos, acc.bool(), iters


def kernel_inputs(cfg, sub_l: Subset, sub_r: Subset, cand_l, cand_r,
                  region_l, region_r):
    """(rows f32[2, 3 + n_coef, B], cand f32[2, K, 3], bounds f32[2, 6]) on the
    candidates' device (launch checks them)."""
    ct = int(cfg.obmd.ntype)
    b = max(sub_l.x.shape[0], sub_r.x.shape[0])
    rows = torch.stack([subset_rows(cfg.pair, ct, cfg.ntypes, pad_subset(s, b))
                        for s in (sub_l, sub_r)]).contiguous()
    cand = torch.stack([cand_l, cand_r]).contiguous()
    bounds = const(tuple(region_l.lo) + tuple(region_l.hi) + tuple(region_r.lo)
                   + tuple(region_r.hi), torch.float32,
                   cand.device).reshape(2, 6)
    return rows, cand, bounds


def usher_search(cfg, sub_l: Subset, sub_r: Subset, cand_l, cand_r,
                 region_l, region_r):
    """Both buffers' searches: (pos [2,K,3], accepted [2,K], iters [2,K])."""
    if cand_l.device.type == "cpu":
        ctype = torch.full((cand_l.shape[0],), int(cfg.obmd.ntype),
                           dtype=torch.int32)
        return usher_search_subset_batch(cfg, sub_l, sub_r, cand_l, cand_r,
                                         ctype, region_l, region_r)
    if cand_l.device.type != "cuda":
        raise ValueError(f"unsupported device {cand_l.device}")
    return launch(cfg, *kernel_inputs(cfg, sub_l, sub_r, cand_l, cand_r,
                                      region_l, region_r))
