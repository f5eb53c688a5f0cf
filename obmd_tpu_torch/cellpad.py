"""Padded cell-major state layout (the "cellpad" path).

Counterpart of `obmd_tpu/cellpad.py`.  The particle store is the cell
structure: slot = (block, rank, lane), a lane being a cell
(forces/pair_kernel.PadGeometry), so the pair kernel reads state arrays
directly, a buffer region is a contiguous slot range, and inserting an atom
claims a free rank in its cell's lane column.  The layout is rebuilt by a
movers-only relayout once per epoch; within an epoch an atom's filed cell
is stale by at most half a skin, which the cut + skin cell width absorbs.

Slots match the reference exactly: every sort is stable (as `jnp.argsort`
is), and the reference's `mode="drop"` scatters write to one extra sentinel
row that is cut off afterwards.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .forces.pair_kernel import PadGeometry
from .geometry import Box, const_like
from .state import State

I32 = torch.int32
I64 = torch.int64


@dataclasses.dataclass
class PadAux:
    """Per-epoch bookkeeping: reference positions, counters and the kernel
    layout caches (tag3d, occ), rebuilt at relayout and patched by
    insertions; deletions leave stale values the kernel masks out."""

    xref: torch.Tensor         # [n_slots, 3] positions at epoch start
    rebuilds: torch.Tensor     # i32
    overflow: torch.Tensor     # i32 atoms that did not fit their cell
    skin_trips: torch.Tensor   # i32 epochs that exceeded the half skin
    tag3d: Optional[torch.Tensor] = None   # [nb, cap, lanes] i32
    occ: Optional[torch.Tensor] = None     # [nb] i32 max occupied rank + 1

    def replace(self, **kw) -> "PadAux":
        return dataclasses.replace(self, **kw)


def scatter_rows(arr: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """`arr.at[idx].set(vals, mode="drop")`: rows with idx == len(arr) are
    dropped.  Returns a new tensor."""
    n = arr.shape[0]
    out = torch.cat([arr, arr[:1]], dim=0)
    out[idx.long()] = vals.to(arr.dtype).expand(
        (idx.shape[0],) + tuple(arr.shape[1:]))
    return out[:n]


def _fill_rows(like: torch.Tensor, m: int, fill) -> torch.Tensor:
    """m rows shaped like `like`'s, all equal to the scalar `fill` (a fill
    kernel, no host-to-device copy)."""
    return torch.full((m,) + tuple(like.shape[1:]), fill, dtype=like.dtype,
                      device=like.device)


def kernel_caches(geom: PadGeometry, tag, alive) -> dict:
    nb, cap, lanes = geom.n_blocks, geom.cap, geom.lanes
    tag3d = tag.reshape(nb, cap, lanes).clone()
    rank = torch.arange(cap, dtype=I32, device=tag.device)[None, :, None]
    occ = torch.where(alive.reshape(nb, cap, lanes), rank,
                      -1).amax(dim=(1, 2)) + 1
    return dict(tag3d=tag3d, occ=occ.to(I32))


def patch_kernel_caches(geom: PadGeometry, aux: PadAux, slot, tags,
                        n_slots: int) -> PadAux:
    """Write inserted atoms' tags into tag3d and raise occ for their ranks
    (slot == n_slots rows are dropped)."""
    if aux.tag3d is None:
        return aux
    cap, lanes, nb = geom.cap, geom.lanes, geom.n_blocks
    slot = slot.long()
    b = slot // (cap * lanes)
    rem = slot % (cap * lanes)
    r = rem // lanes
    l_ = rem % lanes
    bc = torch.where(slot < n_slots, b, nb)
    tag3d = torch.cat([aux.tag3d, aux.tag3d[:1]], dim=0)
    tag3d[bc, r, l_] = tags.to(I32)
    occ = torch.cat([aux.occ, aux.occ[:1]])
    occ = occ.scatter_reduce(0, bc, (r + 1).to(I32), reduce="amax")
    return aux.replace(tag3d=tag3d[:nb], occ=occ[:nb])


def slot_index(geom: PadGeometry, cell, rank):
    block, lane = geom.slot_of_cell(cell)
    return (block * geom.cap + rank) * geom.lanes + lane


def _center(box: Box, like: torch.Tensor) -> torch.Tensor:
    return const_like([(l + h) * 0.5 for l, h in zip(box.lo, box.hi)], like)


def layout_build(geom: PadGeometry, box: Box, state: State) -> State:
    """(Re)pack the whole state into cell-major padded order."""
    n_slots, n_cells = geom.n_slots, geom.n_cells
    dev = state.x.device
    cell = torch.where(state.alive, geom.cell_of(state.x), n_cells)
    order = torch.sort(cell, stable=True).indices
    sc = cell[order].contiguous()
    start = torch.searchsorted(sc, sc, side="left")
    rank = torch.arange(state.capacity, dtype=I64, device=dev) - start
    ok = (sc < n_cells) & (rank < geom.fcap)
    overflow = ((sc < n_cells) & (rank >= geom.fcap)).sum(dtype=I32)
    dest = torch.where(ok, slot_index(geom, sc.long(), rank), n_slots)

    def scat(src, fill):
        out = torch.full((n_slots,) + tuple(src.shape[1:]), fill,
                         dtype=src.dtype, device=dev)
        return scatter_rows(out, dest, src[order])

    # bond partner slot references follow the permutation: old -> new
    # (an atom that did not fit its cell maps to -1)
    n_cap = state.capacity
    new_of_old = scatter_rows(
        torch.full((n_cap,), -1, dtype=I64, device=dev), order,
        torch.where(ok, dest, -1))

    def remap(bond):
        return torch.where(
            bond >= 0, new_of_old[torch.clamp(bond.long(), 0, n_cap - 1)], -1)

    x = _center(box, state.x).expand(n_slots, 3).contiguous()
    x = scatter_rows(x, dest, state.x[order])
    alive = scatter_rows(torch.zeros((n_slots,), dtype=torch.bool, device=dev),
                         dest, state.alive[order])
    tag = scat(state.tag, -1)
    prev = state.nbrs if isinstance(state.nbrs, PadAux) else None
    zi = torch.zeros((), dtype=I32, device=dev)
    aux = PadAux(
        xref=x,
        rebuilds=(prev.rebuilds + 1 if prev is not None
                  else torch.ones((), dtype=I32, device=dev)),
        overflow=(prev.overflow + overflow if prev is not None else overflow),
        skin_trips=(prev.skin_trips if prev is not None else zi),
        **kernel_caches(geom, tag, alive))

    def slots(col):
        return None if col is None else scat(remap(col).to(I32), -1)

    return state.replace(
        x=x, v=scat(state.v, 0), f=scat(state.f, 0), type=scat(state.type, 0),
        tag=tag, q=scat(state.q, 0), alive=alive, mol=scat(state.mol, 0),
        lambdaF=scat(state.lambdaF, 0), cms_mol=scat(state.cms_mol, 0),
        vcms_mol=scat(state.vcms_mol, 0), rep_atom=scat(state.rep_atom, 0),
        bond1=slots(state.bond1), bond2=slots(state.bond2),
        bond3=slots(state.bond3), bond4=slots(state.bond4),
        impr=slots(state.impr),
        cell_overflow=state.cell_overflow + overflow, nbrs=aux)


def half_skin_tripped(box: Box, skin: float, state: State) -> torch.Tensor:
    """True when some live atom drifted more than skin/2 from its epoch
    reference position (neighbor.cpp:2342)."""
    d = box.min_image(state.x - state.nbrs.xref)
    disp2 = torch.where(state.alive, (d * d).sum(-1), 0.0)
    return disp2.max() > (0.5 * skin) ** 2


def note_skin_check(box: Box, skin: float, state: State) -> State:
    aux: PadAux = state.nbrs
    trip = half_skin_tripped(box, skin, state)
    return state.replace(nbrs=aux.replace(
        skin_trips=aux.skin_trips + trip.to(I32)))


def slot_cells(geom: PadGeometry) -> np.ndarray:
    """Static [n_slots] map slot -> linear cell id (-1 for lane padding)."""
    lanes, s, p, cap = geom.lanes, geom.s, geom.p, geom.cap
    lane = np.arange(lanes)
    if p == 1:
        within = np.where(lane < s, lane, -1)
        slab_off = np.zeros_like(lane)
    else:
        within = np.where(lane < p * s, lane % s, -1)
        slab_off = np.where(lane < p * s, lane // s, 0)
    blocks = np.arange(geom.n_blocks)[:, None]
    slab = blocks * p + slab_off[None, :]
    nx = geom.dims[0]
    cell = np.where((within[None, :] >= 0) & (slab < nx),
                    slab * s + within[None, :], -1)
    return np.broadcast_to(cell[:, None, :],
                           (geom.n_blocks, cap, lanes)).reshape(-1).astype(np.int32)


@functools.lru_cache(maxsize=16)
def _slot_cells_tensor(geom: PadGeometry, device) -> torch.Tensor:
    return torch.from_numpy(slot_cells(geom)).to(device)


def compact_indices(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """`jnp.nonzero(mask, size=size, fill_value=fill)[0]` as int64."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(I64), 0) - 1
    dest = torch.where(mask & (rank < size), rank, size)
    out = torch.full((size + 1,), fill, dtype=I64, device=mask.device)
    out[dest] = torch.arange(n, dtype=I64, device=mask.device)
    return out[:size]


def _ordinals(cell: torch.Tensor) -> torch.Tensor:
    """Position of each entry among the entries of its cell, in index order
    (a stable sort, as the reference)."""
    m = cell.shape[0]
    order = torch.sort(cell, stable=True).indices
    cell_s = cell[order].contiguous()
    first = torch.searchsorted(cell_s, cell_s, side="left")
    ordinal = torch.empty((m,), dtype=I64, device=cell.device)
    ordinal[order] = torch.arange(m, dtype=I64, device=cell.device) - first
    return ordinal


def _cumfree(geom: PadGeometry, alive: torch.Tensor) -> torch.Tensor:
    free = ~alive
    return torch.cumsum(free.reshape(geom.n_blocks, geom.cap, geom.lanes)
                        .to(I32), dim=1, dtype=I32).reshape(-1)


def _column_slots(geom: PadGeometry, cell: torch.Tensor):
    """Rank-0 slot of each cell's column and its fill_cap filing slots."""
    block, lane = geom.slot_of_cell(torch.clamp(cell, 0, geom.n_cells - 1))
    col0 = (block * geom.cap) * geom.lanes + lane
    ranks = torch.arange(geom.fcap, dtype=I64, device=cell.device) * geom.lanes
    return col0, col0[:, None] + ranks[None, :]


def relayout_incremental(geom: PadGeometry, box: Box, state: State,
                         m_max: int = 0, move_f: bool = True,
                         has_bonds: bool = True,
                         has_mol: bool = True,
                         has_charge: bool = True,
                         has_types: bool = True,
                         has_mol_com: bool = True) -> State:
    """Movers-only epoch relayout: each atom whose current cell differs from
    its slot's cell takes a free rank of its current cell (the j-th mover of
    a cell takes the j-th free rank); atoms that cannot be placed stay put
    and are counted in PadAux.overflow.  Moves x, v, tag, alive (and f when
    move_f); with has_bonds, the partner slot columns (two or four) and
    the improper triplets move and every slot reference follows its atom;
    with has_mol, mol moves, and with has_mol_com too the molecule columns
    (lambdaF, cms_mol, vcms_mol, rep_atom); with has_charge, q; with
    has_types, type.
    Callers pass
    engine_cellpad.relayout_flags: a column constant over the scene (no
    bonds, no molecules, no charges, one type) skips its moves."""
    n_slots = geom.n_slots
    if m_max <= 0:
        m_max = max(2048, n_slots // 32)
    aux: PadAux = state.nbrs
    dev = state.x.device
    sc = _slot_cells_tensor(geom, dev)
    cur = geom.cell_of(state.x)
    mover = state.alive & (cur != sc)
    n_mov = mover.sum(dtype=I32)
    midx = compact_indices(mover, m_max, n_slots)
    act = midx < n_slots
    missed = n_mov - act.sum(dtype=I32)
    safe = torch.clamp(midx, 0, n_slots - 1)

    cell = torch.where(act, cur[safe].long(), geom.n_cells)
    ordinal = _ordinals(cell)
    cumfree = _cumfree(geom, state.alive)
    col0, col_slots = _column_slots(geom, cell)
    cf = cumfree[col_slots]                                  # [M, fcap]
    cf_prev = torch.cat([torch.zeros((m_max, 1), dtype=I32, device=dev),
                         cf[:, :-1]], dim=1)
    hit = (cf > cf_prev) & (cf == (ordinal + 1)[:, None])
    landed = act & hit.any(dim=1)
    r = torch.argmax(hit.to(torch.uint8), dim=1)
    slot = torch.where(landed, col0 + r * geom.lanes, n_slots)
    old = torch.where(landed, midx, n_slots)
    unplaced = (act & ~landed).sum(dtype=I32)

    center = _center(box, state.x)
    dst = torch.cat([slot, old])

    def move(arr, fill):
        rows = arr[safe]
        fill_rows = (fill.expand(rows.shape) if isinstance(fill, torch.Tensor)
                     else _fill_rows(arr, m_max, fill))
        return scatter_rows(arr, dst, torch.cat([rows, fill_rows]))

    x = move(state.x, center)
    alive = scatter_rows(state.alive, dst, torch.cat([
        _fill_rows(state.alive, m_max, True),
        _fill_rows(state.alive, m_max, False)]))
    tag = move(state.tag, -1)
    upd = dict(x=x, v=move(state.v, 0.0), alive=alive, tag=tag)
    if move_f:
        upd["f"] = move(state.f, 0.0)
    if has_bonds:
        # every partner reference follows the moves; a reference to an atom
        # that stayed put keeps its slot
        moved_map = scatter_rows(torch.arange(n_slots, dtype=I64, device=dev),
                                 old, torch.where(landed, slot, 0))

        def remap(bond):
            return torch.where(
                bond >= 0,
                moved_map[torch.clamp(bond.long(), 0, n_slots - 1)],
                -1).to(I32)

        for name in ("bond1", "bond2", "bond3", "bond4", "impr"):
            col = getattr(state, name)
            if col is not None:
                upd[name] = remap(move(col, -1))
    if has_charge:
        upd["q"] = move(state.q, 0.0)
    if has_mol:
        upd["mol"] = move(state.mol, 0)
        if has_mol_com:
            upd.update(lambdaF=move(state.lambdaF, 0.0),
                       cms_mol=move(state.cms_mol, 0.0),
                       vcms_mol=move(state.vcms_mol, 0.0),
                       rep_atom=move(state.rep_atom, 0))
    if has_types:
        upd["type"] = move(state.type, 0)
    new = state.replace(**upd)
    return new.replace(nbrs=aux.replace(
        xref=x, rebuilds=aux.rebuilds + 1,
        overflow=aux.overflow + missed + unplaced,
        **kernel_caches(geom, tag, alive)))


def maybe_rebuild(geom: PadGeometry, box: Box, skin: float,
                  state: State, **field_flags) -> State:
    """Half-skin displacement trigger: relayout when it trips.  The test is
    read on the host (one sync); only setup takes this path."""
    if skin <= 0.0 or bool(half_skin_tripped(box, skin, state)):
        return relayout_incremental(geom, box, state, **field_flags)
    return state


def place_insertions(geom: PadGeometry, state: State, pos, accepted):
    """Claim a free rank in each accepted candidate's cell: the j-th
    candidate of a cell takes the column's j-th free rank.  Returns (slot
    [M] int64 with n_slots = failed, landed mask)."""
    n_slots = geom.n_slots
    cell = torch.where(accepted, geom.cell_of(pos).long(), geom.n_cells)
    ordinal = _ordinals(cell)
    free = ~state.alive
    cumfree = _cumfree(geom, state.alive)
    col0, col_slots = _column_slots(geom, cell)
    hit = free[col_slots] & (cumfree[col_slots] == (ordinal + 1)[:, None])
    landed = accepted & hit.any(dim=1)
    r = torch.argmax(hit.to(torch.uint8), dim=1)
    slot = torch.where(landed, col0 + r * geom.lanes, n_slots)
    return slot, landed


def slab_slice_bounds(geom: PadGeometry, box: Box, x_lo: float, x_hi: float):
    """Static slot range [a, b) covering every cell whose x-extent
    intersects [x_lo, x_hi]."""
    csx = geom.cell_size[0]
    nx = geom.dims[0]
    lo_slab = int(np.clip(np.floor((x_lo - geom.lo[0]) / csx), 0, nx - 1))
    hi_slab = int(np.clip(np.floor((x_hi - geom.lo[0]) / csx), 0, nx - 1))
    b0 = lo_slab // geom.p
    b1 = hi_slab // geom.p
    return b0 * geom.cap * geom.lanes, (b1 + 1) * geom.cap * geom.lanes
