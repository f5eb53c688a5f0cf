"""Persistent neighbor structures of the nlist engine: the cell table and
the [N, K] Verlet list.

Counterpart of `obmd_tpu/neighbors.py` (LAMMPS' Neighbor::decide / build
analogue, neighbor.cpp:2312-2402).  The cell table is the sort-based
`cells.build_cells` table; `update_table` re-files the atoms whose cell
changed with masked scatters and a few conflict rounds, and raises
`force_rebuild` when it cannot cope.  The Verlet list holds, per slot, the
slots within cut + skin of it (both halves of every pair), built from the
table's stencil candidates chunk by chunk to bound memory, and is reused
until some atom has moved more than half the skin since the build
(`maybe_rebuild`, neighbor.cpp:2342).  OBMD insertions patch it: the new
atom gets a fresh row and is appended to its neighbours' rows
(`apply_new_rows`).  A deleted atom is masked by `alive` when forces are
computed, and its slot is tombstoned so that the stale ids left in other
rows never name another atom before the next rebuild.

A row takes the first K candidates within cut + skin by the reference's
key 1e9 - r^2 in the positions' dtype, a stable descending sort standing
in for `lax.top_k` (lower index first among equal keys), so integer
outputs equal the JAX package's.  A conflicting scatter in `update_table`
keeps the last mover of the conflict, the largest slot, as XLA's
sequential scatter does.

The rebuild decision is data-dependent (a `lax.cond` in the JAX package):
here `rebuild_needed` computes it on the device and `maybe_rebuild` reads
it on the host, one device-to-host read per call.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .cells import BIG, CellTable, GridSpec, build_cells, gather_padded
from .cellpad import compact_indices
from .forces.gathered import neighbor_slots
from .geometry import Box, rounded

I32 = torch.int32
I64 = torch.int64

# rows of the Verlet list built at once: the [chunk, 27 * cap] candidate
# arrays are the build's largest temporaries (obmd_tpu/neighbors.py:71)
NLIST_CHUNK = 16384


@dataclasses.dataclass
class NeighborState:
    """The nlist engine's persistent structures (the State's nbrs)."""

    table: torch.Tensor       # [n_cells + 1, cap] i32 slots (N = empty)
    cell_id: torch.Tensor     # [N] i32 cell each slot is filed under
    nlist: torch.Tensor       # [N, K] i32 neighbour slots (N = empty)
    ncount: torch.Tensor      # [N] i32 entries per row
    xref: torch.Tensor        # [N, 3] positions at the build or insertion
    tombstone: torch.Tensor   # [N] bool: freed since the last rebuild
    force_rebuild: torch.Tensor   # bool: a structural fallback is due
    rebuilds: torch.Tensor    # i32 full rebuilds so far
    overflow: torch.Tensor    # i32 candidates dropped (cap or K too small)

    def replace(self, **kw) -> "NeighborState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class NeighborParams:
    """Static knobs, from the SceneConfig (integrate.make_neighbor_params)."""

    spec: GridSpec
    k_max: int
    movers_max: int = 1024
    conflict_rounds: int = 4
    cutoff: float = 1.0
    skin: float = 0.3

    def rlist2(self, dtype: torch.dtype) -> float:
        """(cutoff + skin)^2 rounded to the dtype of the distances it is
        compared with, as the JAX package's weakly typed constant is."""
        return rounded((self.cutoff + self.skin) ** 2, dtype)


def full_table(p: NeighborParams, x, alive):
    """(table, cell_id, overflow) of a fresh sort-based filing."""
    ctab = build_cells(p.spec, x, alive)
    cell = torch.where(alive, p.spec.cell_of(x), p.spec.n_cells).to(I32)
    return ctab.table, cell, ctab.overflow


def candidate_slots(p: NeighborParams, table, x):
    """[P, S * cap] candidate slots from the stencil around each position."""
    return neighbor_slots(p.spec, CellTable(table=table, overflow=None), x)


def _first_k(key: torch.Tensor, k: int) -> torch.Tensor:
    """The columns of the k largest keys per row, lower column first among
    equal keys (`lax.top_k`'s order)."""
    return torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]


def first_k_rows(p: NeighborParams, jdx, ok, rsq, n: int):
    """(row [P, K] slots, row_ok, overflow) of candidates jdx with mask ok
    and distances rsq [P, M]: the first K by the key 1e9 - r^2."""
    k = p.k_max
    key = torch.where(ok, 1.0e9 - rsq, -1.0)
    if key.shape[1] < k:
        # a tiny scene: fewer candidates than the row capacity
        pad = k - key.shape[1]
        key = torch.nn.functional.pad(key, (0, pad), value=-1.0)
        jdx = torch.nn.functional.pad(jdx, (0, pad), value=n)
        ok = torch.nn.functional.pad(ok, (0, pad), value=False)
    cols = _first_k(key, k)
    row = torch.gather(jdx, 1, cols)
    row_ok = torch.gather(ok, 1, cols)
    over = torch.clamp(ok.sum(1, dtype=I32) - k, min=0).sum(dtype=I32)
    return row, row_ok, over


def _nlist_chunk(p: NeighborParams, box: Box, table, x, me, xi, ai):
    """Rows of one chunk of slots me [C] at positions xi [C, 3] (alive ai)."""
    n = x.shape[0]
    jdx = candidate_slots(p, table, xi)
    xj = gather_padded(x, jdx, BIG)
    d = box.min_image(xi[:, None, :] - xj)
    rsq = (d * d).sum(-1)
    ok = (rsq < p.rlist2(rsq.dtype)) & (jdx != me[:, None]) \
        & (xj[..., 0] < BIG * 0.5) & ai[:, None]
    row, row_ok, over = first_k_rows(p, jdx, ok, rsq, n)
    return (torch.where(row_ok, row, n).to(I32), row_ok.sum(1, dtype=I32),
            over)


def build_nlist(p: NeighborParams, box: Box, table, x, alive):
    """(nlist [N, K], ncount [N], overflow) within cut + skin from the
    table, NLIST_CHUNK rows at a time."""
    n = x.shape[0]
    me = torch.arange(n, dtype=I32, device=x.device)
    parts = [_nlist_chunk(p, box, table, x, me[a:a + NLIST_CHUNK],
                          x[a:a + NLIST_CHUNK], alive[a:a + NLIST_CHUNK])
             for a in range(0, n, NLIST_CHUNK)]
    return (torch.cat([q[0] for q in parts]), torch.cat([q[1] for q in parts]),
            sum(q[2] for q in parts).to(I32))


def full_rebuild(p: NeighborParams, box: Box, x, alive) -> NeighborState:
    table, cell, cover = full_table(p, x, alive)
    nlist, ncount, nover = build_nlist(p, box, table, x, alive)
    n, dev = x.shape[0], x.device
    return NeighborState(
        table=table, cell_id=cell, nlist=nlist, ncount=ncount,
        xref=x.clone(), tombstone=torch.zeros((n,), dtype=torch.bool,
                                              device=dev),
        force_rebuild=torch.zeros((), dtype=torch.bool, device=dev),
        rebuilds=torch.ones((), dtype=I32, device=dev),
        overflow=(cover + nover).to(I32))


# --------------------------------------------------------------------------
# incremental table maintenance
# --------------------------------------------------------------------------

def update_table(p: NeighborParams, ns: NeighborState, x,
                 alive) -> NeighborState:
    """Re-file the slots whose cell changed (movers, deaths, births): each
    leaves its old row, then takes the first free entry of its new cell's
    row in up to conflict_rounds rounds; of several movers that take one
    entry in a round the last (largest slot) keeps it and the others retry
    from the next column.  More than movers_max movers, or a mover left
    unplaced, sets force_rebuild."""
    n = x.shape[0]
    spec = p.spec
    n_cells, cap, cmax = spec.n_cells, spec.capacity, p.movers_max
    dev = x.device
    new_cell = torch.where(alive, spec.cell_of(x), n_cells).to(I32)
    changed = new_cell != ns.cell_id
    too_many = changed.sum() > cmax
    movers = compact_indices(changed, cmax, n)               # [cmax] i64
    real = movers < n
    trash = n_cells * cap

    old_cell = gather_padded(ns.cell_id, movers, n_cells).long()
    old_rows = ns.table[old_cell]
    at = old_rows == movers[:, None]
    had = at.any(1)
    old_rank = torch.argmax(at.to(torch.uint8), dim=1)
    flat_rm = torch.where(real & had, old_cell * cap + old_rank, trash)
    table_flat = ns.table.reshape(-1).clone()
    table_flat[flat_rm] = n

    tgt = gather_padded(new_cell, movers, n_cells).long()
    want = real & (tgt < n_cells)
    placed = ~want
    rank = torch.zeros((cmax,), dtype=I64, device=dev)
    cols = torch.arange(cap, dtype=I64, device=dev)[None, :]
    mv = movers.to(I32)
    for _ in range(p.conflict_rounds):
        rows = table_flat.reshape(n_cells + 1, cap)[tgt]
        free_ok = (rows == n) & (cols >= rank[:, None])
        has = free_ok.any(1)
        slot = torch.argmax(free_ok.to(torch.uint8), dim=1)
        attempt = ~placed & has
        flat = torch.where(attempt, tgt * cap + slot, trash)
        table_flat = table_flat.scatter_reduce(0, flat, mv, reduce="amax",
                                               include_self=False)
        placed_now = attempt & (table_flat[flat] == mv)
        placed = placed | placed_now
        rank = torch.where(attempt & ~placed_now, slot + 1, rank)
    unresolved = (want & ~placed).any()
    table = table_flat.reshape(n_cells + 1, cap)
    table[n_cells] = n
    return ns.replace(table=table, cell_id=new_cell,
                      force_rebuild=ns.force_rebuild | too_many | unresolved)


# --------------------------------------------------------------------------
# insertion patching: fresh rows and symmetric appends
# --------------------------------------------------------------------------

def patch_insertions(p: NeighborParams, box: Box, ns: NeighborState, x,
                     alive, new_slots) -> NeighborState:
    """Slots new_slots [M] (N = inactive) were just filled: file them in
    the table (update_table), build their rows from the table's stencil
    and append them to their neighbours' rows (apply_new_rows)."""
    n = x.shape[0]
    act = new_slots < n
    ns = update_table(p, ns, x, alive)
    pos = gather_padded(x, new_slots, 0.0)
    jdx = candidate_slots(p, ns.table, pos)
    xj = gather_padded(x, jdx, BIG)
    d = box.min_image(pos[:, None, :] - xj)
    rsq = (d * d).sum(-1)
    ok = (rsq < p.rlist2(rsq.dtype)) & (jdx != new_slots[:, None]) \
        & (xj[..., 0] < BIG * 0.5) & act[:, None]
    row, row_ok, over = first_k_rows(p, jdx, ok, rsq, n)
    return apply_new_rows(p, ns, x, new_slots, row, row_ok, over)


def apply_new_rows(p: NeighborParams, ns: NeighborState, x, new_slots, row,
                   row_ok, row_over) -> NeighborState:
    """Write the fresh rows row [M, K] (row_ok their entries) of the new
    slots new_slots [M] (N = inactive), and append each new atom to the
    rows of its neighbours that are not new themselves (their fresh rows
    already hold the other new atoms), in the order of a stable sort by
    neighbour.  An append past K is dropped, counted as overflow and sets
    force_rebuild."""
    n = x.shape[0]
    k = p.k_max
    m = new_slots.shape[0]
    dev = x.device
    ns_l = new_slots.long()
    act = ns_l < n
    pos = gather_padded(x, ns_l, 0.0)
    row = torch.where(row_ok, row, n).to(I32)
    rcount = row_ok.sum(1, dtype=I32)

    def put(arr, vals):
        out = torch.cat([arr, arr[:1]])
        out[ns_l] = vals.to(arr.dtype)
        return out[:n]
    nlist = put(ns.nlist, row)
    ncount = put(ns.ncount, rcount)
    xref = put(ns.xref, pos)

    is_new = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    is_new[ns_l] = act
    tgt = torch.where(row_ok & ~is_new[row.long()], row, n).reshape(-1)
    src = ns_l.repeat_interleave(k)
    order = torch.sort(tgt, stable=True).indices
    tgt_s = tgt[order].contiguous()
    src_s = src[order]
    start = torch.searchsorted(tgt_s, tgt_s, side="left")
    grp_rank = torch.arange(m * k, dtype=I64, device=dev) - start
    col = gather_padded(ns.ncount, tgt_s, 0).long() + grp_rank
    live = tgt_s < n
    fits = live & (col < k)
    over = (live & (col >= k)).sum(dtype=I32)
    flat = torch.where(fits, tgt_s.long() * k + col, n * k)
    nlist_flat = torch.cat([nlist.reshape(-1), nlist.new_zeros((1,))])
    nlist_flat[flat] = src_s.to(I32)
    nlist = nlist_flat[:n * k].reshape(n, k)
    addc = torch.zeros((n + 1,), dtype=I32, device=dev)
    addc.index_add_(0, tgt_s.long(), fits.to(I32))
    ncount = ncount + addc[:n]
    return ns.replace(nlist=nlist, ncount=ncount, xref=xref,
                      overflow=ns.overflow + (row_over + over).to(I32),
                      force_rebuild=ns.force_rebuild | (over > 0))


# --------------------------------------------------------------------------
# the per-step decision (Neighbor::decide)
# --------------------------------------------------------------------------

def rebuild_needed(p: NeighborParams, box: Box, ns: NeighborState, x,
                   alive) -> torch.Tensor:
    """0-dim bool on the device: some live atom moved more than half the
    skin since the build (minimum image: a periodic wrap is no
    displacement), or force_rebuild is set; always true at skin 0."""
    if p.skin <= 0.0:
        return torch.ones((), dtype=torch.bool, device=x.device)
    d = box.min_image(x - ns.xref)
    disp2 = torch.where(alive, (d * d).sum(-1), 0.0)
    half = rounded((0.5 * p.skin) ** 2, disp2.dtype)
    return (disp2.max() > half) | ns.force_rebuild


def maybe_rebuild(p: NeighborParams, box: Box, ns: NeighborState, x, alive,
                  need: Optional[bool] = None) -> NeighborState:
    """A full rebuild when `need` (rebuild_needed, read on the host here
    when not given), with rebuilds counted up and the fresh overflow added
    to the running one; else ns as it is.  At skin 0 every call rebuilds,
    and the fresh state's overflow replaces the running one, as
    obmd_tpu/neighbors.py:316-318 has it."""
    if p.skin <= 0.0:
        return full_rebuild(p, box, x, alive).replace(
            rebuilds=ns.rebuilds + 1)
    if need is None:
        need = bool(rebuild_needed(p, box, ns, x, alive))
    if not need:
        return ns
    fresh = full_rebuild(p, box, x, alive)
    return fresh.replace(rebuilds=ns.rebuilds + 1,
                         overflow=ns.overflow + fresh.overflow)
