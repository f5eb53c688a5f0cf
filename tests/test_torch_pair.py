"""The pair kernel's plain PyTorch version against the TPU kernel
(obmd_tpu.forces.pallas_dpd.make_pair_kernel, interpret mode on the CPU) at
filing cap 15 (its big-tile body) and cap 24 (its rank-looped body), on a
set-up OBMD_DPD lattice state.

Tolerances are tests/test_bigtile.py's: max error <= 2e-4 * max|f| over
alive slots (the port sums each slot's 27 cells, the TPU kernel a Newton
half stencil: float32 summation order differs), |sum f| <= 1e-3 * max|f|
(Newton's third law; the noise is pair-symmetric bit for bit)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu.engine_cellpad import make_geometry as j_make_geometry
from obmd_tpu.forces.pallas_dpd import make_pair_kernel as j_make_pair_kernel
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch.engine_cellpad import _forces as p_forces
from obmd_tpu_torch.engine_cellpad import _make_kernel as p_make_kernel
from obmd_tpu_torch.engine_cellpad import make_geometry as p_make_geometry
from obmd_tpu_torch.forces.pair_kernel import (NF, PadGeometry,
                                               legacy_kwargs,
                                               make_dpd_kernel,
                                               make_pair_kernel)

from test_torch_support import jax_arrays, lattice_states
from obmd_tpu_torch import convert


def _packed(d, nb, cap, lanes):
    xm = np.where(d["alive"][:, None], d["x"], np.float32(1e8))
    fld = np.concatenate([xm, d["v"]], axis=1).astype(np.float32)
    return np.ascontiguousarray(
        fld.reshape(nb, cap, lanes, NF).transpose(0, 3, 1, 2))


@pytest.fixture(scope="module", params=[15, 24])
def set_up(request):
    """(jax cfg, set-up jax state, port cfg) at filing cap 15 / 24."""
    jcfg, jst, pcfg, _ = lattice_states(scale=0.25, cap=request.param,
                                        seed=21)
    return jcfg, jsetup(jcfg, jst), pcfg


def test_plain_matches_tpu_kernel(set_up):
    jcfg, jst, pcfg = set_up
    geom = j_make_geometry(jcfg)
    assert tuple(p_make_geometry(pcfg)) == tuple(geom)
    d = jax_arrays(jst)
    nb, c, lanes = geom.n_blocks, geom.cap, geom.lanes
    fld = _packed(d, nb, c, lanes)
    salt = 0x9E3779B1
    f_tpu = np.asarray(j_make_pair_kernel(geom, params=jcfg.pair,
                                          dt=jcfg.dt)(
        jnp.asarray(fld), jnp.asarray(d["tag3d"]), jnp.uint32(salt),
        jnp.asarray(d["occ"]), None))
    kern = make_pair_kernel(PadGeometry(*geom), pcfg.pair, pcfg.dt)
    f_port = kern(torch.from_numpy(fld), torch.from_numpy(d["tag3d"].copy()),
                  salt, torch.from_numpy(d["occ"].copy())).numpy()
    alive = d["alive"].reshape(nb, c, lanes)
    sel = np.broadcast_to(alive[:, None], f_tpu.shape)
    scale = np.abs(f_tpu[sel]).max()
    assert scale > 10.0
    assert np.abs(f_port - f_tpu)[sel].max() <= 2e-4 * scale
    assert np.all(f_port[~sel] == 0.0)          # dead slots get no force
    flin = f_port.transpose(0, 2, 3, 1).reshape(-1, 3)[d["alive"]]
    assert np.abs(flin.sum(axis=0)).max() <= 1e-3 * scale


def test_forces_with_boundary_force_match_jax(set_up):
    """engine _forces (pair kernel + boundary force on the buffer slices)
    against the JAX engine's, on the set-up state; the boundary force adds
    exactly the setpoint forces (sum of f == sum of setpoints)."""
    from obmd_tpu import engine_cellpad as jec
    jcfg, jst, pcfg = set_up
    pst = convert.from_arrays(jax_arrays(jst), device="cpu")
    geom = j_make_geometry(jcfg)
    f_j = np.asarray(jec._forces(jcfg, geom, jec._make_kernel(jcfg, geom),
                                 jst))
    pg = p_make_geometry(pcfg)
    f_p = p_forces(pcfg, pg, make_pair_kernel(pg, pcfg.pair, pcfg.dt),
                   pst).numpy()
    scale = np.abs(f_j).max()
    assert np.abs(f_p - f_j).max() <= 2e-4 * scale
    setpoints = sum(np.asarray(getattr(pst.obmd, k)) for k in (
        "momentum_force_left", "momentum_force_right"))
    np.testing.assert_allclose(f_p.sum(axis=0), setpoints,
                               atol=1e-3 * scale)


def test_wrapper_rejects_what_it_does_not_cover():
    """Wrong dtypes and shapes, a missing or unasked-for pbond, and a
    single-cell periodic axis shorter than twice the cutoff raise
    ValueError; more than 4 types, a channel count other than 2 or 4
    (4, branched topologies, is built with gaussian noise and on single-cell
    or open y/z axes too: tests/test_torch_excl4_rows.py holds those), open
    y/z axes and dpd/tstat or gaussian noise in the full-stencil kernel
    raise NotImplementedError.  p == 1 layouts,
    periodic x, open and single-cell y/z axes (test_open_and_single_cell_y
    below holds them to the TPU kernel), 2-channel exclusion, 2-4 types,
    gaussian noise and dpd/tstat in make_pair_kernel are ported."""
    jcfg, _, pcfg, _ = lattice_states(scale=0.25, cap=15)
    geom = p_make_geometry(pcfg)
    kern = make_pair_kernel(geom, pcfg.pair, pcfg.dt)
    nb, cap, lanes = geom.n_blocks, geom.cap, geom.lanes
    fld = torch.zeros((nb, NF, cap, lanes))
    tag = torch.zeros((nb, cap, lanes), dtype=torch.int32)
    occ = torch.zeros((nb,), dtype=torch.int32)
    with pytest.raises(ValueError):
        kern(fld.double(), tag, 1, occ)
    with pytest.raises(ValueError):
        kern(fld, tag.long(), 1, occ)
    with pytest.raises(ValueError):
        kern(fld[:, :3], tag, 1, occ)
    five = pconfig.DPDParams.create(temp=1.0, cutoff=1.0, seed=1,
                                    a0=np.full((5, 5), 25.0), gamma=4.5,
                                    ntypes=5)
    with pytest.raises(NotImplementedError):
        make_pair_kernel(geom, five, pcfg.dt)
    gauss = pconfig.DPDParams.create(temp=1.0, cutoff=1.0, seed=1, a0=25.0,
                                     gamma=4.5, gaussian_noise=True)
    tstat = pconfig.DPDTstatParams.create(t_start=1.0, t_stop=2.0,
                                          cutoff=1.0, seed=1, gamma=4.5,
                                          ramp=(0, 10))
    for law in (gauss, tstat):
        make_pair_kernel(geom, law, pcfg.dt)
        with pytest.raises(NotImplementedError):
            legacy_kwargs(law, pcfg.dt)
        with pytest.raises(NotImplementedError):
            p_make_kernel(dataclasses.replace(pcfg, pair=law), geom, "full")
    open_y = geom._replace(periodic_yz=(False, True))
    make_pair_kernel(open_y, pcfg.pair, 0.01)
    with pytest.raises(NotImplementedError):
        make_dpd_kernel(open_y)
    one_cell = geom._replace(dims=(8, 1, 8), cell_size=(1.4, 2.5, 1.4))
    make_pair_kernel(one_cell, pcfg.pair, 0.01)
    make_dpd_kernel(one_cell)
    with pytest.raises(ValueError):
        make_pair_kernel(one_cell._replace(cell_size=(1.4, 1.9, 1.4)),
                         pcfg.pair, 0.01)
    make_pair_kernel(geom, pcfg.pair, 0.01, exclude_bonded=True, n_excl=4)
    for g, law in ((geom, gauss), (one_cell, pcfg.pair), (open_y, pcfg.pair)):
        make_pair_kernel(g, law, 0.01, exclude_bonded=True, n_excl=4)
        with pytest.raises(NotImplementedError):
            make_pair_kernel(g, law, 0.01, exclude_bonded=True, n_excl=3)
    pbond = torch.full((nb, 2, cap, lanes), -2, dtype=torch.int32)
    with pytest.raises(ValueError):
        kern(fld, tag, 1, occ, pbond)
    for excl in (make_pair_kernel(geom, pcfg.pair, 0.01, exclude_bonded=True),
                 make_dpd_kernel(geom, exclude_bonded=True)):
        with pytest.raises(ValueError):
            excl(fld, tag, 1, occ)
        with pytest.raises(ValueError):
            excl(fld, tag, 1, occ, pbond[:, :1])
    make_pair_kernel(geom._replace(p=1, lanes=128, s=64), pcfg.pair, 0.01)
    make_pair_kernel(geom._replace(periodic_x=True), pcfg.pair, 0.01)


@pytest.mark.parametrize("layout", ["open-y", "one-cell-y"])
def test_open_and_single_cell_y(layout):
    """The layouts the wrapper once refused, held to the TPU kernel: the
    scale-0.25 lattice with y open, and the lattice cut to a 2.5-long
    periodic y (one cut + skin cell, at least twice the cutoff), each set
    up without the OBMD stage; the plain version against make_pair_kernel
    within 2e-4 * max|f|."""
    from obmd_tpu.geometry import Box as JBox
    from obmd_tpu.state import init_state as jinit_state
    from obmd_tpu_torch.geometry import Box as PBox
    jcfg, jst, pcfg, _ = lattice_states(scale=0.25, cap=24, seed=21)
    lo, hi, per = jcfg.box.lo, list(jcfg.box.hi), [False, True, True]
    if layout == "open-y":
        per[1] = False
    else:
        hi[1] = 2.5
    x, v = np.asarray(jst.x), np.asarray(jst.v)
    keep = np.asarray(jst.alive) & (x[:, 1] < hi[1])
    jcfg = dataclasses.replace(jcfg, box=JBox(lo, tuple(hi), tuple(per)),
                               obmd=None).finalize()
    pcfg = dataclasses.replace(pcfg, box=PBox(lo, tuple(hi), tuple(per)),
                               obmd=None).finalize()
    jst = jsetup(jcfg, jinit_state(jcfg, x[keep], v=v[keep]))
    geom = j_make_geometry(jcfg)
    assert tuple(p_make_geometry(pcfg)) == tuple(geom)
    assert (geom.dims[1] == 1) == (layout == "one-cell-y")
    assert geom.periodic_yz[0] == (layout == "one-cell-y")
    d = jax_arrays(jst)
    nb, c, lanes = geom.n_blocks, geom.cap, geom.lanes
    fld = _packed(d, nb, c, lanes)
    salt = 0x9E3779B1
    f_tpu = np.asarray(j_make_pair_kernel(geom, params=jcfg.pair,
                                          dt=jcfg.dt)(
        jnp.asarray(fld), jnp.asarray(d["tag3d"]), jnp.uint32(salt),
        jnp.asarray(d["occ"]), None))
    kern = make_pair_kernel(PadGeometry(*geom), pcfg.pair, pcfg.dt)
    f_port = kern(torch.from_numpy(fld), torch.from_numpy(d["tag3d"].copy()),
                  salt, torch.from_numpy(d["occ"].copy())).numpy()
    alive = d["alive"].reshape(nb, c, lanes)
    sel = np.broadcast_to(alive[:, None], f_tpu.shape)
    scale = np.abs(f_tpu[sel]).max()
    assert scale > 10.0
    assert np.abs(f_port - f_tpu)[sel].max() <= 2e-4 * scale
    assert np.all(f_port[~sel] == 0.0)
