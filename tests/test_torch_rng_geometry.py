"""obmd_tpu_torch's rng, geometry and layout maps against obmd_tpu's — all
exact (bit for bit), on inputs drawn from numpy seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import rng as jrng
from obmd_tpu.cellpad import slab_slice_bounds as j_slab_bounds
from obmd_tpu.cellpad import slot_cells as j_slot_cells
from obmd_tpu.engine_cellpad import make_geometry as j_make_geometry
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.geometry import RegionBlock as JRegion
from obmd_tpu.scenes import obmd_dpd_config as j_config
from obmd_tpu_torch import rng as prng
from obmd_tpu_torch.cellpad import slab_slice_bounds as p_slab_bounds
from obmd_tpu_torch.cellpad import slot_cells as p_slot_cells
from obmd_tpu_torch.engine_cellpad import make_geometry as p_make_geometry
from obmd_tpu_torch.geometry import Box as PBox
from obmd_tpu_torch.geometry import RegionBlock as PRegion
from obmd_tpu_torch.scenes import obmd_dpd_config as p_config

R = np.random.default_rng(2024)
A = R.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
B = R.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
C = R.integers(0, 2**31, 4096, dtype=np.int64).astype(np.int32)


def _u32(a):
    return np.asarray(a).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_hashes_bitwise():
    assert np.array_equal(_u32(prng._avalanche(_t(A)).numpy()),
                          np.asarray(jrng._avalanche(jnp.asarray(A))))
    assert np.array_equal(_u32(prng.hash2(_t(A), _t(B)).numpy()),
                          np.asarray(jrng.hash2(jnp.asarray(A), jnp.asarray(B))))
    assert np.array_equal(
        _u32(prng.hash3(_t(A), _t(B), _t(C)).numpy()),
        np.asarray(jrng.hash3(jnp.asarray(A), jnp.asarray(B),
                              jnp.asarray(C))))


def test_uniform_and_pair_noise_bitwise():
    bits = prng._avalanche(_t(A))
    assert np.array_equal(
        prng.uniform01(bits).numpy(),
        np.asarray(jrng.uniform01(jrng._avalanche(jnp.asarray(A)))))
    for salt in (0, 7, 0xDEADBEEF):
        got = prng.pair_noise(salt, _t(A), _t(B)).numpy()
        want = np.asarray(jrng.pair_noise(jnp.uint32(salt), jnp.asarray(A),
                                          jnp.asarray(B)))
        assert np.array_equal(got, want), salt
        # symmetric under i <-> j
        assert np.array_equal(prng.pair_noise(salt, _t(B), _t(A)).numpy(), got)


@pytest.mark.parametrize("seed,step,purpose", [
    (2349852, 0, 1), (2349852, 1, 1), (2349852, 123456, 1), (0, 0, 0),
    (872634, 2**31 - 1, 7)])
def test_step_salt_bitwise(seed, step, purpose):
    want = int(np.asarray(jrng.step_salt(seed, jnp.int32(step), purpose)))
    assert prng.step_salt(seed, step, purpose) == want
    # the tensor form agrees with the host-int form
    assert int(prng.step_salt(_t(np.int32(seed)), _t(np.int32(step)),
                              purpose)) == want


def test_box_and_region_bitwise():
    lo, hi = (0.0, 0.0, 0.0), (8.3985, 11.198, 11.198)
    jb, pb = JBox(lo, hi), PBox(lo, hi)
    x = R.uniform(-15.0, 25.0, (2000, 3)).astype(np.float32)
    assert np.array_equal(pb.wrap(_t(x)).numpy(),
                          np.asarray(jb.wrap(jnp.asarray(x))))
    assert np.array_equal(pb.min_image(_t(x)).numpy(),
                          np.asarray(jb.min_image(jnp.asarray(x))))
    assert pb.cross_area == jb.cross_area
    jr, pr = JRegion((0.0, 0.0, 0.0), (1.26, hi[1], hi[2])), \
        PRegion((0.0, 0.0, 0.0), (1.26, hi[1], hi[2]))
    assert np.array_equal(pr.match(_t(x)).numpy(),
                          np.asarray(jr.match(jnp.asarray(x))))
    u = R.uniform(0.0, 1.0, (64, 3)).astype(np.float32)
    assert np.array_equal(pr.sample_uniform(_t(u)).numpy(),
                          np.asarray(jr.sample_uniform(jnp.asarray(u))))


@pytest.mark.parametrize("scale,cap", [(0.25, 24), (0.5, 15), (9.0, 15),
                                       (9.0, 24)])
def test_geometry_cells_and_slots_exact(scale, cap):
    """PadGeometry fields, cell_of, slot_of_cell, slot_cells and the slab
    slice bounds are identical (bench size included)."""
    jg = j_make_geometry(j_config(scale=scale, cell_capacity=cap))
    pcfg = p_config(scale=scale, cell_capacity=cap)
    pg = p_make_geometry(pcfg)
    assert tuple(pg) == tuple(jg)
    assert (pg.fcap, pg.n_slots, pg.n_cells) == (jg.fcap, jg.n_slots,
                                                 jg.n_cells)
    assert np.array_equal(p_slot_cells(pg), j_slot_cells(jg))
    lo, hi = np.asarray(pcfg.box.lo), np.asarray(pcfg.box.hi)
    x = R.uniform(lo - 1.0, hi + 1.0, (4000, 3)).astype(np.float32)
    cj = np.asarray(jg.cell_of(jnp.asarray(x)))
    assert np.array_equal(pg.cell_of(_t(x)).numpy(), cj)
    bj, lj = jg.slot_of_cell(jnp.asarray(cj))
    bp, lp = pg.slot_of_cell(_t(cj).long())
    assert np.array_equal(bp.numpy(), np.asarray(bj))
    assert np.array_equal(lp.numpy(), np.asarray(lj))
    for a, b in ((0.0, 1.2), (lo[0] - 1.0, 2.0), (hi[0] - 3.0, hi[0] + 1.0)):
        assert p_slab_bounds(pg, pcfg.box, a, b) == j_slab_bounds(
            jg, pcfg.box, a, b)
