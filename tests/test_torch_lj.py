"""The pair kernels' plain PyTorch versions on the LJ melt's configurations
— the LJ law, periodic x, p == 1 lane-padded layouts, cap 36 — and the
legacy full-stencil kernel (make_dpd_kernel's counterpart), against the JAX
package on the same inputs (its Pallas kernels in interpret mode).

Inputs are the melt's fcc lattice with a 0.05 sigma normal jitter drawn
by numpy.  Tolerances are tests/test_newton_kernel.py's: max error
<= 2e-4 * max|f| over alive slots, |sum f| <= 1e-3 * max|f| (Newton's
third law)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from obmd_tpu import cellpad as jcp
from obmd_tpu import scenes as jscenes
from obmd_tpu.cells import build_cells as jbuild_cells
from obmd_tpu.config import Capacity as JCapacity
from obmd_tpu.config import DPDParams as JDPDParams
from obmd_tpu.config import SceneConfig as JSceneConfig
from obmd_tpu.engine_cellpad import make_geometry as j_make_geometry
from obmd_tpu.forces.pairs import pair_sweep as jpair_sweep
from obmd_tpu.forces.pallas_dpd import make_dpd_kernel as j_make_dpd_kernel
from obmd_tpu.forces.pallas_dpd import make_pair_kernel as j_make_pair_kernel
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.integrate import _salt as j_salt
from obmd_tpu.integrate import make_grid_spec as j_make_grid_spec
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import cellpad as pcp
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.cells import GridSpec
from obmd_tpu_torch.engine_cellpad import make_geometry as p_make_geometry
from obmd_tpu_torch.forces.pair_kernel import (NF, PadGeometry,
                                               _neighbor_columns,
                                               make_dpd_kernel,
                                               make_pair_kernel)

from test_torch_support import jax_arrays, jittered

SALT = 0x9E3779B1


def legacy_kw(params, dt):
    """make_dpd_kernel's keyword arguments for either package's config."""
    if hasattr(params, "a0"):
        return dict(a0=params.a0[0][0], gamma=params.gamma[0][0],
                    sigma=params.sigma[0][0], cut=params.cut[0][0], dt=dt,
                    law="dpd")
    return dict(cut=params.cut[0][0], dt=dt, law="lj",
                lj_eps=params.epsilon[0][0], lj_sig=params.sigma[0][0])


def set_up(jcfg, x, v=None):
    """The JAX engine's set-up state on positions x, as numpy arrays, and
    the kernels' inputs (fld, tag3d, occ)."""
    d = jax_arrays(jsetup(jcfg, jinit_state(jcfg, x, v=v)))
    geom = j_make_geometry(jcfg)
    nb, cap, lanes = geom.n_blocks, geom.cap, geom.lanes
    xm = np.where(d["alive"][:, None], d["x"], np.float32(1e8))
    fld = np.ascontiguousarray(np.concatenate([xm, d["v"]], axis=1)
                               .astype(np.float32)
                               .reshape(nb, cap, lanes, NF).transpose(0, 3, 1, 2))
    return d, geom, fld


def jax_kernels(jcfg, geom, fld, d):
    """(make_pair_kernel, make_dpd_kernel) forces of the JAX package."""
    args = (jnp.asarray(fld), jnp.asarray(d["tag3d"]), jnp.uint32(SALT),
            jnp.asarray(d["occ"]), None)
    f2 = np.asarray(j_make_pair_kernel(geom, params=jcfg.pair,
                                       dt=jcfg.dt)(*args))
    f3 = np.asarray(j_make_dpd_kernel(geom, **legacy_kw(jcfg.pair, jcfg.dt))(
        *args))
    return f2, f3


def port_kernels(pcfg, geom, fld, d):
    """(make_pair_kernel, make_dpd_kernel) forces of the port's plain
    versions."""
    geom = PadGeometry(*geom)
    args = (torch.from_numpy(fld), torch.from_numpy(d["tag3d"].copy()), SALT,
            torch.from_numpy(d["occ"].copy()))
    f2 = make_pair_kernel(geom, pcfg.pair, pcfg.dt)(*args).numpy()
    f3 = make_dpd_kernel(geom, **legacy_kw(pcfg.pair, pcfg.dt))(
        *args).numpy()
    return f2, f3


def jax_sweep(jcfg, d):
    """pair_sweep forces (slot order) and the sweep table's overflow."""
    spec = j_make_grid_spec(jcfg)
    x, alive = jnp.asarray(d["x"]), jnp.asarray(d["alive"])
    tab = jbuild_cells(spec, x, alive)
    pf = jpair_sweep(jcfg.pair, jcfg.box, spec, tab, x, jnp.asarray(d["v"]),
                     jnp.asarray(d["type"]), jnp.asarray(d["tag"]),
                     jnp.zeros(x.shape[0]), j_salt(jcfg, 0), dt=jcfg.dt)
    return np.asarray(pf.f), int(tab.overflow)


def slot_forces(f, d):
    """[nb, 3, cap, lanes] kernel output -> alive rows of [N, 3]."""
    return f.transpose(0, 2, 3, 1).reshape(-1, 3)[d["alive"]]


def assert_close(got, want, d, label):
    """got/want: kernel outputs [nb, 3, cap, lanes] or slot-order [N, 3]."""
    g = slot_forces(got, d) if got.ndim == 4 else got[d["alive"]]
    w = slot_forces(want, d) if want.ndim == 4 else want[d["alive"]]
    scale = np.abs(w).max()
    assert scale > 10.0, label
    err = np.abs(g - w).max()
    assert err <= 2e-4 * scale, (label, err, scale)
    assert np.abs(g.sum(axis=0)).max() <= 1e-3 * scale, label
    if got.ndim == 4:
        dead = ~np.broadcast_to(d["alive"].reshape(
            got.shape[0], 1, got.shape[2], got.shape[3]), got.shape)
        assert np.all(got[dead] == 0.0), label


def test_lj_kernels_match_tpu_kernels_nx11():
    """nx = 11 (6 cells per axis, p == 1, 36 of 128 lanes are cells, cap
    36): the port's make_pair_kernel and make_dpd_kernel plain versions
    against the JAX kernels, which agree with each other there."""
    js = jscenes.lj_melt_scene(nx=11)
    ps = pscenes.lj_melt_scene(nx=11, device="cpu")
    d, geom, fld = set_up(js.cfg, jittered(js.cfg, js.state.x))
    assert (geom.p, geom.s, geom.lanes, geom.cap, geom.periodic_x) == \
        (1, 36, 128, 36, True)
    assert tuple(p_make_geometry(ps.cfg)) == tuple(geom)
    j2, j3 = jax_kernels(js.cfg, geom, fld, d)
    p2, p3 = port_kernels(ps.cfg, geom, fld, d)
    assert_close(p2, j2, d, "pair vs make_pair_kernel")
    assert_close(p3, j3, d, "dpd_full vs make_dpd_kernel")


def test_lj_kernels_match_sweep_on_three_cell_axes():
    """nx = 6 at cell_capacity 48 (3 cells per periodic axis; cap 36
    overflows once atoms move, 32 atoms per cell on average): both plain
    versions against JAX's pair_sweep and make_dpd_kernel.  Not against
    make_pair_kernel: on 3-cell periodic axes the JAX Newton kernel gives
    forces up to ~1.5e9 away from both (ROADMAP.md Queue 3)."""
    js = jscenes.lj_melt_scene(nx=6, cell_capacity=48)
    ps = pscenes.lj_melt_scene(nx=6, cell_capacity=48, device="cpu")
    d, geom, fld = set_up(js.cfg, jittered(js.cfg, js.state.x))
    assert geom.dims == (3, 3, 3) and int(d["overflow"]) == 0
    f_sweep, overflow = jax_sweep(js.cfg, d)
    assert overflow == 0
    args = (jnp.asarray(fld), jnp.asarray(d["tag3d"]), jnp.uint32(SALT),
            jnp.asarray(d["occ"]), None)
    j3 = np.asarray(j_make_dpd_kernel(
        geom, **legacy_kw(js.cfg.pair, js.cfg.dt))(*args))
    p2, p3 = port_kernels(ps.cfg, geom, fld, d)
    for got, name in ((p2, "pair"), (p3, "dpd_full")):
        assert_close(got, f_sweep, d, f"{name} vs pair_sweep")
        assert_close(got, j3, d, f"{name} vs make_dpd_kernel")


def _wide_lattice():
    """An fcc LJ slab of 6 x 22 x 22 unit cells: a 3 x 12 x 12 cell grid,
    s = 144 cells per x-slab, so p == 1 in 256 lanes."""
    js = jscenes.lj_melt_scene(nx=1)
    a = (4.0 / 0.8442) ** (1.0 / 3.0)
    n = np.asarray((6, 22, 22))
    basis = np.asarray([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                        [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(*[np.arange(k) for k in n], indexing="ij"),
                     axis=-1).reshape(-1, 1, 3)
    x = ((cells + basis[None]) * a).reshape(-1, 3)
    box = JBox((0.0, 0.0, 0.0), tuple(float(k * a) for k in n),
               (True, True, True))
    jcfg = dataclasses.replace(js.cfg, box=box, capacity=JCapacity(
        n_max=len(x), cell_capacity=36))
    return jcfg, x


def test_p1_layout_beyond_128_lanes_matches_sweep():
    jcfg, x = _wide_lattice()
    d, geom, fld = set_up(jcfg, jittered(jcfg, x, seed=2))
    assert (geom.p, geom.s, geom.lanes) == (1, 144, 256)
    pcfg = pscenes.lj_melt_scene(nx=1, device="cpu").cfg
    f_sweep, overflow = jax_sweep(jcfg, d)
    assert overflow == 0 and int(d["overflow"]) == 0
    p2, p3 = port_kernels(pcfg, geom, fld, d)
    assert_close(p2, f_sweep, d, "pair vs pair_sweep")
    assert_close(p3, f_sweep, d, "dpd_full vs pair_sweep")


def test_512_lane_layout_of_nx40():
    """The melt at nx = 40 (256,000 atoms): 22 cells per axis, s = 484,
    512 lanes.  Slot cells match the JAX package's, and each real column's
    27 neighbour columns are the stencil_neighbors of the same grid."""
    jcfg = jscenes.lj_melt_scene(nx=40).cfg
    pcfg = pscenes.lj_melt_scene(nx=40, device="cpu").cfg
    geom = p_make_geometry(pcfg)
    assert tuple(geom) == tuple(j_make_geometry(jcfg))
    assert (geom.dims, geom.s, geom.p, geom.lanes, geom.n_slots) == \
        ((22, 22, 22), 484, 1, 512, 405504)
    assert np.array_equal(pcp.slot_cells(geom),
                          jcp.slot_cells(j_make_geometry(jcfg)))
    icol, cols, oks = (t.numpy() for t in _neighbor_columns(geom, "cpu"))
    assert len(icol) == geom.n_cells and oks.all()
    # column -> cell: column = block * lanes + lane, cell = block * s + lane
    cell_of_col = (icol // geom.lanes) * geom.s + icol % geom.lanes
    grid = GridSpec(geom.dims, geom.cell_size, geom.lo, (True,) * 3, 36)
    want = grid.stencil_neighbors()[:, cell_of_col]
    got = (cols // geom.lanes) * geom.s + cols % geom.lanes
    assert np.array_equal(got, want)


def test_dpd_periodic_x_p2_matches_tpu_kernels():
    """A closed DPD box (6 x 4 x 4 cells: s = 16, p = 2 so that the x-slabs
    tile periodic x, 32 of 128 lanes are cells) at cap 24: both plain
    versions against make_pair_kernel and make_dpd_kernel."""
    box = JBox((0.0, 0.0, 0.0), (8.0, 5.5, 5.5), (True, True, True))
    pair = JDPDParams.create(temp=1.0, cutoff=1.0, seed=5, a0=25.0,
                             gamma=4.5)
    r = np.random.default_rng(3)
    n = int(3.0 * box.volume)
    x = r.uniform(0.0, box.hi, (n, 3)).astype(np.float32)
    v = r.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    jcfg = JSceneConfig(box=box, masses=(1.0,), pair=pair, dt=0.01,
                        capacity=JCapacity(n_max=n, cell_capacity=24),
                        skin=0.3, force_path="cellpad").finalize()
    from obmd_tpu_torch import config as pconfig
    from obmd_tpu_torch.geometry import Box as PBox
    pcfg = pconfig.SceneConfig(
        box=PBox(box.lo, box.hi, box.periodic), masses=(1.0,),
        pair=pconfig.DPDParams.create(temp=1.0, cutoff=1.0, seed=5, a0=25.0,
                                      gamma=4.5),
        dt=0.01, capacity=pconfig.Capacity(n_max=n, cell_capacity=24),
        skin=0.3)
    d, geom, fld = set_up(jcfg, x, v)
    assert (geom.dims, geom.s, geom.p, geom.lanes) == ((6, 4, 4), 16, 2, 128)
    assert tuple(p_make_geometry(pcfg)) == tuple(geom)
    j2, j3 = jax_kernels(jcfg, geom, fld, d)
    p2, p3 = port_kernels(pcfg, geom, fld, d)
    assert_close(p2, j2, d, "pair vs make_pair_kernel")
    assert_close(p3, j3, d, "dpd_full vs make_dpd_kernel")
    assert_close(p2, j3, d, "pair vs make_dpd_kernel")


def test_supports():
    """engine_cellpad.supports: the two ported paths' configurations, not
    two types or single-cell periodic axes."""
    from obmd_tpu_torch.engine_cellpad import supports
    lj = pscenes.lj_melt_scene(nx=6, cell_capacity=48, device="cpu").cfg
    assert supports(lj)
    assert supports(pscenes.obmd_dpd_config(scale=0.25))
    assert not supports(dataclasses.replace(lj, masses=(1.0, 1.0)))
    assert not supports(pscenes.lj_melt_scene(nx=2, device="cpu").cfg)
