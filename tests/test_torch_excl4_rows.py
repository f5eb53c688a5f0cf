"""The pair kernel's four-channel exclusion rows under the DPD variants and
the thin axes: gaussian noise (the big-tile body at fill cap 16 and the
rank-looped body at cap 24), the dpd/tstat ramp, a film whose z axis is one
cell, and that film with y open.  The port's kernel (its plain version on
the CPU) against JAX's make_pair_kernel(exclude_bonded=True, n_excl=4) in
interpret mode.

The input: the star template (arms of 0.55) centred on a jittered lattice
in an open-x box of DPD cells (cut 1, skin 0.3), y and z periodic of 6
cells, or z one cell of 2.2 (at least twice the cutoff), y periodic or
open; x open, where JAX's make_pair_kernel is right (ROADMAP Queue 3).
Forces within 2e-4 * max|f| (tests/test_newton_kernel.py's bar); the ramp
at a mid-window noise scale, which changes the forces; without pbond the
forces differ on exactly the slots with a 1-2 partner inside the cut.
Gaussian noise is the kernel's stream (0x7F4A7C15, clamp 1e-12), in both
packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from obmd_tpu.engine_cellpad import make_geometry as j_make_geometry
from obmd_tpu.forces.pallas_dpd import make_pair_kernel as j_make_pair_kernel
from obmd_tpu_torch import cellpad as pcp
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.config import (BondHarmonicParams, Capacity, DPDParams,
                                   DPDTstatParams, SceneConfig)
from obmd_tpu_torch.engine_cellpad import (_make_kernel, make_geometry,
                                           pack_fields)
from obmd_tpu_torch.forces.pair_kernel import (PairCoef, launch_key,
                                               make_pair_kernel)
from obmd_tpu_torch.forces.pairs import sig_scale_of
from obmd_tpu_torch.geometry import Box
from obmd_tpu_torch.state import init_state

from test_torch_obmd_lj import to_jax
from test_torch_support import CPU

SALT = 0x5A17C0DE
RAMP = (0, 1000)
MID = 400            # a step inside the ramp: sig_scale ~1.25


def _law(row):
    if row.startswith("gauss"):
        return DPDParams.create(temp=1.0, cutoff=1.0, seed=3, a0=25.0,
                                gamma=4.5, ntypes=2, gaussian_noise=True)
    if row == "ramp":
        return DPDTstatParams.create(t_start=1.0, cutoff=1.0, seed=3,
                                     gamma=4.5, t_stop=2.0, ramp=RAMP)
    return DPDParams.create(temp=1.0, cutoff=1.0, seed=3, a0=25.0, gamma=4.5,
                            ntypes=2)


def _inputs(row, cap, seed=5):
    """(cfg, geom, state, pack_fields' inputs) of the lattice stars of
    `row`: a 6 x 6 x 6-cell cube, or with "1cell" a 6 x 6 x 1 film, y open
    with "openyz"."""
    pair = _law(row)
    thin = "1cell" in row
    y_open = "openyz" in row
    lengths = (7.8, 7.8, 2.2 if thin else 7.8)
    grid = (6, 6, 1 if thin else 6)
    dx = np.asarray(pscenes.STAR_DX)
    r = np.random.default_rng(seed)
    g = (np.stack(np.meshgrid(*[np.arange(n) for n in grid], indexing="ij"),
                  -1).reshape(-1, 3) + 0.5) * (np.asarray(lengths)
                                               / np.asarray(grid))
    g += r.uniform(-0.15, 0.15, g.shape)
    n_s = len(g)
    x = (g[:, None] + np.einsum("sij,kj->ski",
                                pscenes._rotations(r, n_s), dx)).reshape(-1, 3)
    periodic = (False, not y_open, True)
    for a in (1, 2):
        if periodic[a]:
            x[:, a] = np.mod(x[:, a], lengths[a])
        else:
            x[:, a] = np.clip(x[:, a], 0.01, lengths[a] - 0.01)
    n = len(x)
    types = np.tile(pscenes.STAR_TYPES, n_s) if pair.ntypes > 1 else None
    base = 5 * np.arange(n_s)[:, None] + 1
    bonds = np.stack([np.broadcast_to(base, (n_s, 4)),
                      base + np.arange(1, 5)], -1).reshape(-1, 2)
    cfg = SceneConfig(
        box=Box((0.0,) * 3, lengths, periodic),
        masses=(1.0,) * pair.ntypes, pair=pair, dt=0.01,
        capacity=Capacity(n_max=n, cell_capacity=cap),
        bond=BondHarmonicParams(k=40.0, r0=0.55), skin=0.3,
        branched_topology=True)
    geom = make_geometry(cfg)
    st = pcp.layout_build(geom, cfg.box, init_state(
        cfg, x, v=r.normal(0.0, 1.0, x.shape), types=types, bonds=bonds,
        device=CPU))
    assert int(st.cell_overflow) == 0
    return cfg, geom, st, pack_fields(cfg, geom, st)


@pytest.mark.parametrize("row, cap, key", [
    ("gauss", 16, "dpd-t2-gauss-excl4-cap16"),
    ("gauss", 24, "dpd-t2-gauss-excl4-cap24"),
    ("ramp", 24, "dpd-ramp-excl4-cap24"),
    ("1cell", 16, "dpd-t2-excl4-1cell-cap16"),
    ("1cell-openyz", 16, "dpd-t2-excl4-1cell-openyz-cap16")])
def test_four_channel_row_matches_tpu_kernel(row, cap, key):
    """Each row: the plain version against make_pair_kernel(n_excl=4) in
    interpret mode within 2e-4 * max|f|; the launch key names the row; the
    ramp's scale changes the forces; without pbond the forces differ on
    exactly the slots that have a 1-2 partner inside the cut."""
    cfg, geom, st, (fld, tag, _, occ, pbond) = _inputs(row, cap)
    assert geom.fcap == cap and pbond.shape[1] == 4
    if "1cell" in row:
        assert geom.dims[2] == 1
        assert geom.periodic_yz == ("openyz" not in row, True)
    kern = _make_kernel(cfg, geom)
    coef = PairCoef.of(geom, cfg.pair, cfg.dt)
    assert launch_key(geom, coef, 4) == key
    ss = sig_scale_of(cfg.pair, MID)
    got = kern(fld, tag, SALT, occ, pbond, sig_scale=ss).numpy()
    jcfg = to_jax(cfg)
    jkern = j_make_pair_kernel(j_make_geometry(jcfg), params=jcfg.pair,
                               dt=jcfg.dt, exclude_bonded=True, n_excl=4)
    want = np.asarray(jkern(
        jnp.asarray(fld.numpy()), jnp.asarray(tag.numpy()), jnp.uint32(SALT),
        jnp.asarray(occ.numpy()), jnp.asarray(pbond.numpy()),
        None if ss is None else jnp.float32(ss)))
    alive = st.alive.numpy()
    g = got.transpose(0, 2, 3, 1).reshape(-1, 3)[alive]
    w = want.transpose(0, 2, 3, 1).reshape(-1, 3)[alive]
    scale = np.abs(w).max()
    assert scale > 1.0
    assert np.abs(g - w).max() <= 2e-4 * scale, np.abs(g - w).max()
    if row == "ramp":
        assert 1.1 < ss < 1.4
        one = kern(fld, tag, SALT, occ, pbond, sig_scale=1.0).numpy()
        assert np.abs(one - got).max() > 1e-2 * scale
    free = make_pair_kernel(geom, cfg.pair, cfg.dt)(fld, tag, SALT, occ,
                                                    sig_scale=ss)
    differs = (free.numpy() != got).any(axis=1).reshape(-1)
    assert np.array_equal(differs, alive)


def test_gaussian_row_is_not_the_uniform_row():
    """The gaussian row draws other noise than the uniform row on the same
    input (the noise term is on), and two calls give the same bytes."""
    cfg, geom, _, (fld, tag, _, occ, pbond) = _inputs("gauss", 16)
    kern = _make_kernel(cfg, geom)
    a = kern(fld, tag, SALT, occ, pbond).numpy()
    assert np.array_equal(a, kern(fld, tag, SALT, occ, pbond).numpy())
    uni = _make_kernel(dataclasses.replace(cfg, pair=dataclasses.replace(
        cfg.pair, gaussian_noise=False)), geom)
    b = uni(fld, tag, SALT, occ, pbond).numpy()
    assert np.abs(a - b).max() > 1e-2 * np.abs(b).max()
