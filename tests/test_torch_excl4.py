"""The pair kernel's four-channel exclusion rows beyond typed dpd (the rows
molecule-mode insertion of a branched template reaches): (a) dpd with one
type, (b) lj with one type and with two, (c) lj/cut/rf with two types,
each with uniform noise on periodic y and z.  The port's kernel (its plain
version on the CPU) against JAX's make_pair_kernel(exclude_bonded=True,
n_excl=4) in interpret mode on both TPU bodies: the big-tile body at fill
cap 16 and the rank-looped body at cap 24.

The input: stars of scenes' template (arms of 0.55 under dpd, 1.0 under
the LJ laws) centred on a jittered cubic lattice in a cube of 6 (dpd) or
5 (LJ) cut + skin cells per axis, x open as in an OBMD box, y and z
periodic, more than one block, where JAX's make_pair_kernel is right
(ROADMAP Queue 3: on a periodic x axis its minimum image folds the dead
slots' BIG sentinel back into the box); under lj/cut/rf every third bead
charged +-0.5.  Forces within 2e-4 * max|f| and |sum f| <= 1e-3
* max|f| (tests/test_newton_kernel.py's bar); without pbond the forces
differ on exactly the slots with a 1-2 partner inside the cut, so the
exclusions bite.  check_channels takes these rows and every other
four-channel setting (tests/test_torch_excl4_rows.py holds those)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from obmd_tpu.engine_cellpad import make_geometry as j_make_geometry
from obmd_tpu.forces.pallas_dpd import make_pair_kernel as j_make_pair_kernel
from obmd_tpu_torch import cellpad as pcp
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.config import (BondHarmonicParams, Capacity, DPDParams,
                                   DPDTstatParams, LJCutParams,
                                   LJCutRFParams, SceneConfig)
from obmd_tpu_torch.engine_cellpad import (_make_kernel, make_geometry,
                                           pack_fields)
from obmd_tpu_torch.forces.pair_kernel import (PairCoef, check_channels,
                                               launch_key, make_pair_kernel)
from obmd_tpu_torch.geometry import Box
from obmd_tpu_torch.state import init_state

from test_torch_obmd_lj import to_jax
from test_torch_support import CPU

SALT = 0x1F2E3D4C


def _law(row):
    if row == "dpd":
        return DPDParams.create(temp=1.0, cutoff=1.0, seed=3, a0=25.0,
                                gamma=4.5)
    if row in ("lj", "lj-t2"):
        return LJCutParams.create(cutoff=2.5, epsilon=1.0, sigma=1.0,
                                  ntypes=1 if row == "lj" else 2)
    return LJCutRFParams.create(cut_lj=2.5, cut_coul=2.5, ntypes=2,
                                epsilon=pscenes.LJRF_EPSILON,
                                sigma=pscenes.LJRF_SIGMA,
                                eps_rf=pscenes.LJRF_EPS_RF)


def _inputs(row, cap, seed=4):
    """(cfg, geom, state, pack_fields' inputs) of the lattice stars."""
    dpd = row == "dpd"
    pair = _law(row)
    skin = 0.3 if dpd else 0.4
    side, L = (6, 8.0) if dpd else (5, 5 * 2.95)
    arm = 0.55 if dpd else 1.0
    dx = np.asarray(pscenes.STAR_DX) * (arm / 0.55)
    r = np.random.default_rng(seed)
    g = (np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) * (L / side)
    g += r.uniform(-0.15, 0.15, g.shape)
    n_s = len(g)
    x = np.mod(g[:, None] + np.einsum("sij,kj->ski",
                                      pscenes._rotations(r, n_s), dx),
               L).reshape(-1, 3)
    n = len(x)
    types = np.tile(pscenes.STAR_TYPES, n_s) if pair.ntypes > 1 else None
    q = None
    if row == "ljrf-t2":
        q = np.where(np.arange(n) % 3 == 0,
                     0.5 * np.where(np.arange(n) % 2 == 0, 1.0, -1.0), 0.0)
    base = 5 * np.arange(n_s)[:, None] + 1
    bonds = np.stack([np.broadcast_to(base, (n_s, 4)),
                      base + np.arange(1, 5)], -1).reshape(-1, 2)
    cfg = SceneConfig(
        box=Box((0.0,) * 3, (L,) * 3, (False, True, True)),
        masses=(1.0,) * pair.ntypes, pair=pair, dt=0.005,
        capacity=Capacity(n_max=n, cell_capacity=cap),
        bond=BondHarmonicParams(k=40.0, r0=arm), skin=skin,
        branched_topology=True)
    geom = make_geometry(cfg)
    st = pcp.layout_build(geom, cfg.box, init_state(
        cfg, x, types=types, q=q, bonds=bonds, device=CPU))
    assert int(st.cell_overflow) == 0
    return cfg, geom, st, pack_fields(cfg, geom, st)


@pytest.mark.parametrize("cap", [16, 24])
@pytest.mark.parametrize("row", ["dpd", "lj", "lj-t2", "ljrf-t2"])
def test_four_channel_rows_match_tpu_kernel(row, cap):
    """Row a-c at fill cap 16 (the big-tile body) and 24 (rank-looped):
    the plain version against make_pair_kernel(n_excl=4) in interpret mode;
    the launch key names the row; without pbond the forces differ on
    exactly the slots that have a 1-2 partner inside the cut."""
    cfg, geom, st, (fld, tag, _, occ, pbond) = _inputs(row, cap)
    assert geom.fcap == cap and geom.n_blocks > 1
    assert min(geom.dims) >= 5 and pbond.shape[1] == 4
    kern = _make_kernel(cfg, geom)
    coef = PairCoef.of(geom, cfg.pair, cfg.dt)
    assert launch_key(geom, coef, 4) == f"{row}-excl4-cap{cap}"
    got = kern(fld, tag, SALT, occ, pbond).numpy()
    jcfg = to_jax(cfg)
    want = np.asarray(j_make_pair_kernel(
        j_make_geometry(jcfg), params=jcfg.pair, dt=jcfg.dt,
        exclude_bonded=True, n_excl=4)(
        jnp.asarray(fld.numpy()), jnp.asarray(tag.numpy()), jnp.uint32(SALT),
        jnp.asarray(occ.numpy()), jnp.asarray(pbond.numpy())))
    alive = st.alive.numpy()
    g = got.transpose(0, 2, 3, 1).reshape(-1, 3)[alive]
    w = want.transpose(0, 2, 3, 1).reshape(-1, 3)[alive]
    scale = np.abs(w).max()
    assert scale > 1.0
    assert np.abs(g - w).max() <= 2e-4 * scale, np.abs(g - w).max()
    assert np.abs(g.sum(axis=0)).max() <= 1e-3 * scale
    free = make_pair_kernel(geom, cfg.pair, cfg.dt)(fld, tag, SALT, occ)
    differs = (free.numpy() != got).any(axis=1).reshape(-1)
    assert np.array_equal(differs, alive)


def test_check_channels_rows_and_refusals():
    """check_channels takes rows a-c, the typed dpd row, ljrf with one
    type, gaussian noise, the dpd/tstat ramp, a single-cell y axis and
    open y/z at 4 channels, and any law at 2 channels; it refuses another
    channel count, with a message that names the JAX engines' counts."""
    _, geom, _, _ = _inputs("lj", 16)
    _, dgeom, _, _ = _inputs("dpd", 16)
    gauss = dataclasses.replace(_law("dpd"), gaussian_noise=True)
    ramp = DPDTstatParams.create(1.0, 1.0, 3, 4.5, t_stop=2.0,
                                 ramp=(0, 100))
    rf1 = LJCutRFParams.create(cut_lj=2.5, epsilon=1.0, sigma=1.0,
                               eps_rf=80.0)
    thin = dgeom._replace(dims=(6, 1, 6), cell_size=(
        dgeom.cell_size[0], 8.0, dgeom.cell_size[2]))
    open_yz = dgeom._replace(periodic_yz=(False, True))
    ok = [(dgeom, _law("dpd")), (geom, _law("lj")), (geom, _law("lj-t2")),
          (geom, _law("ljrf-t2")),
          (dgeom, DPDParams.create(1.0, 1.0, 3, 25.0, 4.5, ntypes=2)),
          (dgeom, gauss), (dgeom, ramp), (geom, rf1), (thin, _law("dpd")),
          (open_yz, _law("dpd"))]
    for g, law in ok:
        coef = PairCoef.of(g, law, 0.005)
        check_channels(g, coef, 4)
        check_channels(g, coef, 2)
        with pytest.raises(NotImplementedError,
                           match="engine_cellpad.py:75-78"):
            check_channels(g, coef, 3)
