"""Pair laws and the cell-pair force sweep.

Counterpart of `obmd_tpu/forces/pairs.py` for the ported pair styles:
  * DPD    — DPD-BASIC/pair_dpd.cpp:128-137, uniform or gaussian pair
    noise (`rng.pair_noise`);
  * DPD/tstat — pair_dpd_tstat.cpp:96-136: DPD's drag and noise with no
    conservative term and zero energy; a temperature ramp scales the noise
    by `sig_scale_of` (pair_fn's `sig_scale`, pair_sweep's);
  * DPD/ext — pair_dpd_ext.cpp:113-185: DPD's terms with the weights
    wd^ws, plus a transverse drag and noise through the projector
    I - rhat rhat^T with the weight wd^wsT; its force is not along d, so
    its pair_fn returns the force vector (`is_vector_law`,
    `apply_pair_law`); with `tstat_only` (dpd/ext/tstat) no conservative
    term and zero energy;
  * LJ cut — 12-6 LJ (pair_lj_cut.cpp), optionally energy-shifted;
  * LJ cut/rf — 12-6 LJ plus reaction-field Coulomb (the fork's
    pair_lj_cut_rf.cpp:118-131 force, :163-171 energy), charges q_i q_j.
Every law takes per-type-pair coefficient tables.  Every other law raises
NotImplementedError.

`pair_sweep` is the full-neighbour sweep over a dense cell table
(`cells.build_cells`): every pair is computed from both sides and each atom
sums the forces on itself, with no scatter-add.  It is array code in the
reference too (not a TPU kernel), so it stays plain PyTorch on every
device: it is the semantics reference the cellpad kernels are held
against, and what thermo and profiles run on.  The 27 stencil offsets are
looped, never stacked, so one offset's [n_cells, cap, cap, 3] block is the
largest temporary.

`trial_energy_force` is the conservative energy and force on trial
particles over the 27 cells around each (the insertion search of the
atom decomposition, obmd/stage._usher_search).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import rng
from ..cells import BIG, CellTable, GridSpec, gather_padded
from ..config import (DPDExtParams, DPDParams, DPDTstatParams, LJCutParams,
                      LJCutRFParams)
from ..geometry import Box, real_type, reciprocals, rounded

EPS_R = 1.0e-10  # reference EPSILON for the r ~ 0 skip (pair_dpd.cpp:117)


class PairFields(NamedTuple):
    """Outputs of one force sweep."""

    f: torch.Tensor                       # [N, 3] per-atom force
    pe: Optional[torch.Tensor]            # [N] per-atom energy (half shares)
    virial: Optional[torch.Tensor]        # [6] xx, yy, zz, xy, xz, yz
    virial_atom: Optional[torch.Tensor] = None   # [N, 6] per-atom shares


def sig_scale_of(params, step: int,
                 dtype: torch.dtype = torch.float32) -> Optional[float]:
    """The noise-amplitude scale sqrt(T(step) / t_start) of a dpd/tstat
    ramp (pair_dpd_tstat.cpp:52-60), T linear in the step over the window
    `ramp`, or None for a constant-T law.  Computed on the host in `dtype`
    (the state's, or float32 for the pair kernel's launch parameter) as
    the JAX package's sig_scale_of computes it: frac = clip((step - b) /
    max(e - b, 1), 0, 1), t = t_start + frac * (t_stop - t_start),
    sqrt(t / t_start).  (XLA's jitted step takes the divisions as
    multiplications by reciprocals and fuses the multiply-add, so the JAX
    engine's value may differ from this in the last bit.)"""
    if not isinstance(params, DPDTstatParams) or not params.is_ramp:
        return None
    b, e = params.ramp if params.ramp is not None else (0, 1)
    real = real_type(dtype)
    frac = np.clip(real(step - b) / real(max(e - b, 1)), real(0.0),
                   real(1.0))
    t = real(params.temp) + frac * real(params.t_stop - params.temp)
    return float(np.sqrt(t / real(params.temp)))


def _table_names(params):
    if isinstance(params, DPDParams):
        return ("a0", "gamma", "cut", "sigma")
    if isinstance(params, DPDTstatParams):
        return ("gamma", "cut", "sigma")
    if isinstance(params, DPDExtParams):
        return ("a0", "gamma", "gammaT", "ws", "wsT", "cut", "sigma",
                "sigmaT")
    if isinstance(params, LJCutParams):
        return ("epsilon", "sigma", "cut")
    if isinstance(params, LJCutRFParams):
        return ("epsilon", "sigma", "cut", "eps_rf")
    raise NotImplementedError(
        f"pair law {type(params).__name__} is not ported")


def _tables(params, dtype, device):
    """Coefficient tables as [ntypes, ntypes] tensors."""
    return {name: torch.tensor(np.asarray(getattr(params, name)),
                               dtype=dtype, device=device)
            for name in _table_names(params)}


def _lookup(tab: torch.Tensor, ti, tj):
    """Per-pair coefficient; a single-type table is a scalar."""
    if tab.shape == (1, 1):
        return tab[0, 0]
    return tab[ti.long(), tj.long()]


def _lj_consts(eps, sig):
    """LAMMPS lj1..lj4 (pair_lj_cut.cpp init_one)."""
    s6 = sig ** 6
    return 48.0 * eps * s6 * s6, 24.0 * eps * s6, 4.0 * eps * s6 * s6, \
        4.0 * eps * s6


def is_vector_law(params) -> bool:
    """True for a law whose force is not along the separation (dpd/ext's
    transverse friction): its pair_fn returns the force vector."""
    return isinstance(params, DPDExtParams)


def apply_pair_law(params, pair_fn, rsq, d, dv, ti, tj, tag_i, tag_j, salt,
                   **kw):
    """(fvec [..., 3], e) of any law: a vector law's own vector, else
    fpair * d."""
    if is_vector_law(params):
        return pair_fn(rsq, d, dv, ti, tj, tag_i, tag_j, salt, **kw)
    fpair, e = pair_fn(rsq, d, dv, ti, tj, tag_i, tag_j, salt, **kw)
    return fpair[..., None] * d, e


def make_pair_law(params, dt: float, dtype=torch.float32, device="cpu"):
    """pair_fn(rsq, d, dv, ti, tj, tag_i, tag_j, salt) -> (fpair, e) with
    F_i += fpair * d, d = x_i - x_j (fpair carries the 1/r factors); e is
    the full pair energy (the caller halves it per atom).  The lj/cut/rf
    law's pair_fn also takes the charges qi, qj; the dpd/ext law's returns
    (fvec [..., 3], e) (`apply_pair_law` takes either)."""
    tabs = _tables(params, dtype, device)

    if isinstance(params, DPDExtParams):
        return _dpd_ext_law(params, tabs, dt, dtype)

    if isinstance(params, LJCutRFParams):
        qq = rounded(params.qqrd2e, dtype)
        cut_coul = rounded(params.cut_coul, dtype)

        def pair_fn(rsq, d, dv, ti, tj, tag_i, tag_j, salt, qi=None,
                    qj=None):
            cut = _lookup(tabs["cut"], ti, tj)
            eps = _lookup(tabs["epsilon"], ti, tj)
            sig = _lookup(tabs["sigma"], ti, tj)
            erf = _lookup(tabs["eps_rf"], ti, tj)
            lj1, lj2, lj3, lj4 = _lj_consts(eps, sig)
            ok = rsq > EPS_R * EPS_R
            r2inv = torch.where(ok, 1.0 / torch.clamp(rsq, min=EPS_R * EPS_R),
                                0.0)
            r6inv = r2inv * r2inv * r2inv
            in_lj = (rsq < cut * cut) & ok
            flj = torch.where(in_lj, r6inv * (lj1 * r6inv - lj2) * r2inv, 0.0)
            elj = torch.where(in_lj, r6inv * (lj3 * r6inv - lj4), 0.0)
            # reaction field (pair_lj_cut_rf.cpp:118-131, :163-171)
            rf1 = erf - 1.0
            rf2 = 1.0 + 2.0 * erf
            in_coul = (rsq < cut_coul * cut_coul) & ok
            qprod = qq * qi * qj
            rinv = torch.sqrt(r2inv)
            r = torch.sqrt(rsq)
            fcoul = qprod * (r2inv * rinv
                             - (1.0 / cut_coul ** 3) * (2.0 * rf1 / rf2))
            fcoul = torch.where(in_coul, fcoul, 0.0)
            ecoul = (qprod * rinv * (1.0 + (rf1 / rf2) * (r / cut_coul) ** 3)
                     - qprod * (1.0 / cut_coul) * (3.0 * erf / rf2))
            ecoul = torch.where(in_coul, ecoul, 0.0)
            return flj + fcoul, elj + ecoul

        return pair_fn

    if isinstance(params, (DPDParams, DPDTstatParams)):
        dtinvsqrt = rounded(1.0 / np.sqrt(dt), dtype)
        gaussian = params.gaussian_noise
        tstat = isinstance(params, DPDTstatParams)

        def pair_fn(rsq, d, dv, ti, tj, tag_i, tag_j, salt, sig_scale=None):
            cut = _lookup(tabs["cut"], ti, tj)
            gam = _lookup(tabs["gamma"], ti, tj)
            sig = _lookup(tabs["sigma"], ti, tj)
            if sig_scale is not None:
                sig = sig * sig_scale
            r = torch.sqrt(rsq)
            rinv = torch.where(r > EPS_R, 1.0 / torch.clamp(r, min=EPS_R),
                               0.0)
            wd = 1.0 - r * (1.0 / cut)
            dot = (d * dv).sum(-1)
            xi = rng.pair_noise(salt, tag_i, tag_j, gaussian=gaussian,
                                dtype=dtype)
            if tstat:
                fpair = -gam * wd * wd * dot * rinv
            else:
                a0 = _lookup(tabs["a0"], ti, tj)
                fpair = a0 * wd
                fpair = fpair - gam * wd * wd * dot * rinv
            fpair = fpair + sig * wd * xi * dtinvsqrt
            fpair = fpair * rinv
            in_range = (rsq < cut * cut) & (r > EPS_R)
            if tstat:
                return (torch.where(in_range, fpair, 0.0),
                        torch.zeros_like(fpair))
            e = 0.5 * a0 * cut * wd * wd          # pair_dpd.cpp:152 (shifted)
            return (torch.where(in_range, fpair, 0.0),
                    torch.where(in_range, e, 0.0))

        return pair_fn

    shift = params.shift

    def pair_fn(rsq, d, dv, ti, tj, tag_i, tag_j, salt):
        cut = _lookup(tabs["cut"], ti, tj)
        eps = _lookup(tabs["epsilon"], ti, tj)
        sig = _lookup(tabs["sigma"], ti, tj)
        lj1, lj2, lj3, lj4 = _lj_consts(eps, sig)
        in_range = (rsq < cut * cut) & (rsq > EPS_R * EPS_R)
        r2inv = torch.where(in_range, 1.0 / torch.clamp(rsq, min=EPS_R), 0.0)
        r6inv = r2inv * r2inv * r2inv
        fpair = r6inv * (lj1 * r6inv - lj2) * r2inv
        e = r6inv * (lj3 * r6inv - lj4)
        if shift:
            rc2 = 1.0 / (cut * cut)
            rc6 = rc2 * rc2 * rc2
            e = e - rc6 * (lj3 * rc6 - lj4)
        return (torch.where(in_range, fpair, 0.0),
                torch.where(in_range, e, 0.0))

    return pair_fn


def _dpd_ext_law(params, tabs, dt: float, dtype):
    """dpd/ext (pair_dpd_ext.cpp:113-185), op for op as
    obmd_tpu/forces/pairs.py:170-231: the parallel part is DPD's with wdPar
    = wd^ws; the transverse drag and noise act through P u = u - rhat
    (rhat . u) with wdPerp = wd^wsT.  The transverse noise vector is the
    same for both orientations of a pair and takes the sign of tag_i -
    tag_j, so the full-neighbour sums keep Newton's third law bit for
    bit."""
    dtinvsqrt = rounded(1.0 / np.sqrt(dt), dtype)
    gaussian = params.gaussian_noise
    tstat_only = params.tstat_only

    def pair_fn(rsq, d, dv, ti, tj, tag_i, tag_j, salt):
        cut = _lookup(tabs["cut"], ti, tj)
        gam = _lookup(tabs["gamma"], ti, tj)
        gam_t = _lookup(tabs["gammaT"], ti, tj)
        sig = _lookup(tabs["sigma"], ti, tj)
        sig_t = _lookup(tabs["sigmaT"], ti, tj)
        ws = _lookup(tabs["ws"], ti, tj)
        ws_t = _lookup(tabs["wsT"], ti, tj)
        r = torch.sqrt(rsq)
        rinv = torch.where(r > EPS_R, 1.0 / torch.clamp(r, min=EPS_R), 0.0)
        wd = torch.clamp(1.0 - r * (1.0 / cut), min=0.0)
        wd_par = wd ** ws
        wd_perp = wd ** ws_t
        dot = (d * dv).sum(-1)
        xi = rng.pair_noise(salt, tag_i, tag_j, gaussian=gaussian,
                            dtype=dtype)
        xiv = rng.transverse_noise(salt, tag_i, tag_j, gaussian=gaussian,
                                   dtype=dtype)
        sgn = torch.where(tag_i > tag_j, 1.0, -1.0).to(dtype)
        fpar = 0.0 if tstat_only else _lookup(tabs["a0"], ti, tj) * wd
        fpar = fpar - gam * wd_par * wd_par * dot * rinv
        fpar = fpar + sig * wd_par * xi * dtinvsqrt
        fvec = (fpar * rinv)[..., None] * d
        rhat = d * rinv[..., None]

        def proj(u):
            return u - rhat * (rhat * u).sum(-1, keepdim=True)

        fvec = fvec - (gam_t * wd_perp * wd_perp)[..., None] * proj(dv)
        fvec = fvec + (sig_t * wd_perp * sgn * dtinvsqrt)[..., None] \
            * proj(xiv)
        in_range = (rsq < cut * cut) & (r > EPS_R)
        fvec = torch.where(in_range[..., None], fvec, 0.0)
        if tstat_only:
            return fvec, torch.zeros_like(rsq)
        a0 = _lookup(tabs["a0"], ti, tj)
        return fvec, torch.where(in_range, 0.5 * a0 * cut * wd * wd, 0.0)

    return pair_fn


def _scatter_back(vals: torch.Tensor, idx: torch.Tensor, n: int):
    """Cell-major values back to slot order (idx == n rows dropped)."""
    out = torch.zeros((n + 1,) + tuple(vals.shape[2:]), dtype=vals.dtype,
                      device=vals.device)
    out[idx.reshape(-1).long()] = vals.reshape((-1,) + tuple(vals.shape[2:]))
    return out[:n]


def pair_sweep(params, box: Box, spec: GridSpec, ctab: CellTable,
               x, v, types, tag, salt, *, dt: float, q=None,
               sig_scale: Optional[float] = None,
               compute_energy: bool = False,
               compute_virial: bool = False,
               compute_virial_atom: bool = False) -> PairFields:
    """Full force sweep over the cell grid: per-atom forces (zero for dead
    slots), optionally per-atom pe (half of each incident pair's energy),
    the global virial 0.5 sum_pairs d (x) F over both orientations, and the
    per-atom virial shares.  `q`, the per-atom charges, is read by the
    lj/cut/rf law only (the reference's positional charge argument), and
    `sig_scale` by the dpd/tstat law only (a ramp's noise scale; None is
    the law at t_start)."""
    dtype = x.dtype
    dev = x.device
    n = x.shape[0]
    n_cells = spec.n_cells
    cap = spec.capacity
    pair_fn = make_pair_law(params, dt, dtype, dev)
    charged = isinstance(params, LJCutRFParams)

    idx = ctab.table[:n_cells]                       # [n_cells, cap]
    xi = gather_padded(x, idx, BIG)
    vi = gather_padded(v, idx, 0.0)
    ti = gather_padded(types, idx, 0)
    gi = gather_padded(tag, idx, -1)
    qi = gather_padded(q, idx, 0.0) if charged else None

    nbr = torch.from_numpy(spec.stencil_neighbors()).long().to(dev)
    not_self = ~torch.eye(cap, dtype=torch.bool, device=dev)[None]
    near2 = (params.max_cut * 1.001) ** 2

    f_acc = torch.zeros((n_cells, cap, 3), dtype=dtype, device=dev)
    pe_acc = torch.zeros((n_cells, cap), dtype=dtype, device=dev) \
        if compute_energy else None
    w_acc = torch.zeros((6,), dtype=dtype, device=dev) \
        if compute_virial else None
    wa_acc = torch.zeros((n_cells, cap, 6), dtype=dtype, device=dev) \
        if compute_virial_atom else None
    pairs6 = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))

    for k in range(nbr.shape[0]):
        jdx = ctab.table[nbr[k]]                     # [n_cells, cap]
        xj = gather_padded(x, jdx, BIG)
        vj = gather_padded(v, jdx, 0.0)
        tj = gather_padded(types, jdx, 0)
        gj = gather_padded(tag, jdx, -1)
        kw = {}
        if charged:
            kw = dict(qi=qi[:, :, None],
                      qj=gather_padded(q, jdx, 0.0)[:, None, :])
        if sig_scale is not None:
            kw["sig_scale"] = sig_scale

        d = box.min_image(xi[:, :, None, :] - xj[:, None, :, :])
        dv = vi[:, :, None, :] - vj[:, None, :, :]
        rsq = (d * d).sum(-1)
        valid = (xi[:, :, None, 0] < BIG * 0.5) & (xj[:, None, :, 0] < BIG * 0.5)
        if k == 13:                                  # the (0, 0, 0) offset
            valid = valid & not_self
        # the law runs on the pairs within (a hair over) the largest cut
        # only: it is zero beyond its own cut, and the sums below run over
        # the full [cell, i, j] layout, zeros included, in the same order
        sel = (valid & (rsq < near2)).nonzero(as_tuple=True)
        shape = rsq.shape
        kw = {key: (val.expand(shape)[sel] if torch.is_tensor(val) else val)
              for key, val in kw.items()}
        fv, ev = apply_pair_law(
            params, pair_fn, rsq[sel], d[sel], dv[sel],
            ti[:, :, None].expand(shape)[sel],
            tj[:, None, :].expand(shape)[sel],
            gi[:, :, None].expand(shape)[sel],
            gj[:, None, :].expand(shape)[sel], salt, **kw)
        fvec = torch.zeros(shape + (3,), dtype=dtype, device=dev)
        fvec[sel] = fv
        f_acc += fvec.sum(2)
        if compute_energy:
            e = torch.zeros(shape, dtype=dtype, device=dev)
            e[sel] = ev
            pe_acc += 0.5 * e.sum(2)
        if compute_virial:
            w_acc += 0.5 * torch.stack([(d[..., a] * fvec[..., b]).sum()
                                        for a, b in pairs6])
        if compute_virial_atom:
            wa_acc += 0.5 * torch.stack([(d[..., a] * fvec[..., b]).sum(2)
                                         for a, b in pairs6], dim=-1)

    return PairFields(
        f=_scatter_back(f_acc, idx, n),
        pe=_scatter_back(pe_acc, idx, n) if compute_energy else None,
        virial=w_acc,
        virial_atom=(_scatter_back(wa_acc, idx, n) if compute_virial_atom
                     else None))


def trial_energy_force(params, box: Box, spec: GridSpec, ctab: CellTable,
                       x, types, q, cand_x, cand_type, cand_q=None):
    """Energy E [K] and force F [K, 3] on K trial particles cand_x [K, 3]
    of types cand_type [K] against all live atoms filed in ctab: the
    conservative part of the pair law only, as pair->single returns it
    (fix_obmd_merged.cpp:1774-1857 `energy()`; pair_dpd.cpp:401,
    pair_lj_cut_rf.cpp:492/533), over the 27 cells around each trial's
    cell (obmd_tpu/forces/pairs.py:388-469: every one of the 27 offsets,
    a cell that two offsets reach counted twice, as there).  dpd/tstat and
    dpd/ext/tstat have no conservative term: zero."""
    dtype = x.dtype
    dev = x.device
    dims = spec.dims
    charged = isinstance(params, LJCutRFParams)
    inv = reciprocals(spec.cell_size, dtype)
    nd = torch.tensor(dims, dtype=torch.int64, device=dev)
    cc = torch.floor((cand_x - torch.tensor(spec.lo, dtype=dtype, device=dev))
                     * torch.tensor(inv, dtype=dtype, device=dev))
    cc = torch.minimum(torch.clamp(cc.to(torch.int64), min=0), nd - 1)
    offs = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                         for c in (-1, 0, 1)], dtype=torch.int64, device=dev)
    nb = cc[:, None, :] + offs[None, :, :]
    per = torch.tensor(spec.periodic, dtype=torch.bool, device=dev)
    ok = torch.all(per | ((nb >= 0) & (nb < nd)), dim=-1)
    nb = torch.where(per, torch.remainder(nb, nd), nb)
    lin = (nb[..., 0] * dims[1] + nb[..., 1]) * dims[2] + nb[..., 2]
    lin = torch.where(ok, lin, spec.n_cells)
    k = cand_x.shape[0]
    jdx = ctab.table[lin].reshape(k, -1)
    xj = gather_padded(x, jdx, BIG)
    tj = gather_padded(types, jdx, 0)
    d = box.min_image(cand_x[:, None, :] - xj)
    rsq = (d * d).sum(-1)
    valid = xj[..., 0] < BIG * 0.5
    if isinstance(params, DPDTstatParams) or (
            isinstance(params, DPDExtParams) and params.tstat_only):
        return torch.zeros((k,), dtype=dtype, device=dev), \
            torch.zeros_like(cand_x)
    if isinstance(params, (DPDParams, DPDExtParams)):
        tabs = _tables(params, dtype, dev)
        cut = _lookup(tabs["cut"], cand_type[:, None], tj)
        a0 = _lookup(tabs["a0"], cand_type[:, None], tj)
        r = torch.sqrt(rsq)
        rinv = torch.where(r > EPS_R, 1.0 / torch.clamp(r, min=EPS_R), 0.0)
        wd = 1.0 - r / cut
        in_range = (rsq < cut * cut) & (r > EPS_R) & valid
        fpair = torch.where(in_range, a0 * wd * rinv, 0.0)
        e = torch.where(in_range, 0.5 * a0 * cut * wd * wd, 0.0)
    else:
        pair_fn = make_pair_law(params, 1.0, dtype, dev)
        kw = {}
        if charged:
            cq = cand_q if cand_q is not None else \
                torch.zeros((k,), dtype=dtype, device=dev)
            kw = dict(qi=cq[:, None], qj=gather_padded(q, jdx, 0.0))
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        fpair, e = pair_fn(rsq, d, torch.zeros_like(d), cand_type[:, None],
                           tj, zero, zero, 0, **kw)
        fpair = torch.where(valid, fpair, 0.0)
        e = torch.where(valid, e, 0.0)
    return e.sum(-1), (fpair[..., None] * d).sum(1)
