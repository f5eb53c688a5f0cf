"""The port's output and data formats against the JAX package's, on the
same state (handed over as numpy arrays through convert.from_arrays): the
`dump xyz` and `dump custom` frames are the same bytes as the JAX
package's Python writers (its native writers are switched off in this
test by monkeypatching the hooks of its io/native.py), DCD files are the
same bytes and read back, the `full` and `adress` data files round-trip
and equal the JAX package's `_read_data_py`, and RegionSphere /
RegionCylinder agree with the JAX package's in match, lo, hi and
volume."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import scenes as jscenes
from obmd_tpu import geometry as jgeom
from obmd_tpu.io import dump as jdump
from obmd_tpu.io import dump_dcd as jdcd
from obmd_tpu.io import lammps_data as jio
from obmd_tpu.io import native as jnative
from obmd_tpu_torch import convert
from obmd_tpu_torch import geometry as pgeom
from obmd_tpu_torch.io import dump as pdump
from obmd_tpu_torch.io import dump_dcd as pdcd
from obmd_tpu_torch.io import lammps_data as pio

from tests.test_torch_support import CPU, jax_arrays

ALL_COLS = ("id", "type", "x", "y", "z", "vx", "vy", "vz", "fx", "fy", "fz",
            "q", "mol", "lambdaF", "rep_atom", "cms_x", "cms_y", "cms_z",
            "vcms_x", "vcms_y", "vcms_z")


@pytest.fixture
def python_writers(monkeypatch):
    """The JAX package's writers try its native library first: switch the
    hooks off so both packages run their Python writers."""
    monkeypatch.setattr(jnative, "write_xyz_native",
                        lambda *a, **k: False)
    monkeypatch.setattr(jnative, "write_dump_custom_native",
                        lambda *a, **k: False)


def _states(seed=3, holes=True):
    """A JAX OBMD_DPD state (scale 0.1) with every per-atom column filled
    from a numpy seed and a third of the slots dead, and the same state on
    the port."""
    sc = jscenes.obmd_dpd_scene(scale=0.1, seed=seed)
    st = sc.state
    n = st.x.shape[0]
    r = np.random.default_rng(seed)
    f32 = np.float32
    alive = np.asarray(st.alive) & (r.random(n) > (0.33 if holes else 0.0))
    st = st.replace(
        alive=jnp.asarray(alive),
        f=jnp.asarray(r.normal(0, 30, (n, 3)).astype(f32)),
        q=jnp.asarray(r.normal(0, 0.5, n).astype(f32)),
        mol=jnp.asarray(r.integers(0, 50, n).astype(np.int32)),
        lambdaF=jnp.asarray(r.random(n).astype(f32)),
        cms_mol=jnp.asarray(r.normal(0, 3, (n, 3)).astype(f32)),
        vcms_mol=jnp.asarray(r.normal(0, 1, (n, 3)).astype(f32)),
        rep_atom=jnp.asarray(r.integers(0, 2, n).astype(np.int32)),
        step=jnp.asarray(1234, st.step.dtype))
    pst = convert.from_arrays(jax_arrays(st), device=CPU)
    return sc.cfg, st, convert.scene_config(sc.cfg), pst


@pytest.mark.parametrize("cols", [None, ("id", "x", "vz", "type"), ALL_COLS])
def test_custom_frames_same_bytes(tmp_path, python_writers, cols):
    jcfg, jst, pcfg, pst = _states()
    kw = {} if cols is None else {"cols": cols}
    a, b = tmp_path / "jax.custom", tmp_path / "port.custom"
    for _ in range(2):                      # two appended frames
        jdump.write_custom_frame(str(a), jcfg, jst, **kw)
        pdump.write_custom_frame(str(b), pcfg, pst, **kw)
    assert b.read_bytes() == a.read_bytes()


def test_custom_frame_extra_columns(tmp_path, python_writers):
    jcfg, jst, pcfg, pst = _states(seed=5)
    nal = int(np.asarray(jst.alive).sum())
    extra = {"v_e": np.random.default_rng(1).normal(size=nal)}
    cols = ("id", "v_e", "x")
    a, b = tmp_path / "jax.custom", tmp_path / "port.custom"
    jdump.write_custom_frame(str(a), jcfg, jst, cols=cols, extra=extra)
    pdump.write_custom_frame(str(b), pcfg, pst, cols=cols, extra=extra)
    assert b.read_bytes() == a.read_bytes()


def test_xyz_frames_same_bytes(tmp_path, python_writers):
    jcfg, jst, pcfg, pst = _states(seed=7)
    a, b = tmp_path / "jax.xyz", tmp_path / "port.xyz"
    for append in (False, True):
        jdump.write_xyz_frame(str(a), jcfg, jst, append=append)
        pdump.write_xyz_frame(str(b), pcfg, pst, append=append)
    assert b.read_bytes() == a.read_bytes()


def test_dcd_same_bytes_and_read_back(tmp_path):
    jcfg, jst, pcfg, pst = _states(seed=9)
    a, b = tmp_path / "jax.dcd", tmp_path / "port.dcd"
    for k in range(3):
        shift = np.float32(0.125 * k)
        jst_k = jst.replace(x=jst.x + shift, step=jst.step + 10 * k)
        pst_k = pst.replace(x=pst.x + float(shift), step=pst.step + 10 * k)
        jdcd.write_dcd_frame(str(a), jcfg, jst_k, nevery=10)
        pdcd.write_dcd_frame(str(b), pcfg, pst_k, nevery=10)
    assert b.read_bytes() == a.read_bytes()
    icntrl, cells, frames = pdcd.read_dcd(str(b))
    jicntrl, jcells, jframes = jdcd.read_dcd(str(b))
    assert icntrl == jicntrl and icntrl[0] == 3 and icntrl[3] == 1254
    assert np.array_equal(cells, jcells) and np.array_equal(frames, jframes)
    alive = pst.alive.numpy()
    order = np.argsort(pst.tag.numpy()[alive])
    assert np.array_equal(frames[0], pst.x.numpy()[alive][order])
    # a changed atom count refuses, as dump_dcd.cpp:140 does
    with pytest.raises(ValueError, match="atom count changed"):
        pdcd.write_dcd_frame(str(b), pcfg, pst.replace(
            alive=pst.alive & (pst.tag != pst.tag[alive.nonzero()[0][0]])))


def _data_file(style, seed=2, n=60):
    r = np.random.default_rng(seed)
    x = r.uniform(0.0, 7.0, (n, 3))
    return jio.DataFile(
        natoms=n, ntypes=2, box_lo=np.zeros(3), box_hi=np.full(3, 7.0),
        masses=np.asarray([1.0, 2.5]), x=x,
        types=r.integers(0, 2, n).astype(np.int32),
        tags=np.arange(1, n + 1, dtype=np.int32),
        v=r.normal(0, 1, (n, 3)),
        q=r.normal(0, 0.5, n) if style == "full" else None,
        mol=r.integers(1, 20, n).astype(np.int32),
        bonds=np.asarray([(1, 2), (2, 3), (5, 9)]))


@pytest.mark.parametrize("style", ["full", "adress"])
def test_data_styles_round_trip(tmp_path, style):
    """Written by the port and by the JAX package: the same bytes; read
    back by the port: equal to the JAX package's pure-Python reader, and
    to the DataFile written (positions and velocities to the bit of their
    printed float64)."""
    df = _data_file(style)
    a, b = tmp_path / "jax.data", tmp_path / "port.data"
    jio.write_data(str(a), df, atom_style=style)
    pio.write_data(str(b), pio.DataFile(**dataclasses.asdict(df)),
                   atom_style=style)
    assert b.read_bytes() == a.read_bytes()
    got = pio.read_data(str(b), atom_style=style)
    want = jio._read_data_py(str(b), atom_style=style)
    for f in dataclasses.fields(got):
        assert np.array_equal(np.asarray(getattr(got, f.name)),
                              np.asarray(getattr(want, f.name))), f.name
    for name in ("x", "v", "mol", "types", "tags") + (
            ("q",) if style == "full" else ()):
        assert np.array_equal(getattr(got, name), getattr(df, name)), name
    assert got.q is None if style == "adress" else got.q is not None


def test_full_refuses_fewer_columns(tmp_path):
    df = _data_file("adress")
    p = tmp_path / "m.data"
    jio.write_data(str(p), df, atom_style="adress")
    for mod in (pio, jio):
        read = getattr(mod, "_read_data_py", None) or mod.read_data
        with pytest.raises(ValueError, match="expects 7"):
            read(str(p), atom_style="full")


REGIONS = [
    (dict(center=(1.0, 2.0, 3.0), radius=1.5), "sphere"),
    (dict(center=(0.0, 0.0, 0.0), radius=0.25), "sphere"),
    (dict(axis="x", c1=2.0, c2=1.0, radius=1.2, lo_axis=-1.0, hi_axis=2.5),
     "cylinder"),
    (dict(axis="y", c1=0.5, c2=2.5, radius=0.8, lo_axis=0.0, hi_axis=3.0),
     "cylinder"),
    (dict(axis="z", c1=1.0, c2=1.0, radius=2.0, lo_axis=1.0, hi_axis=1.0),
     "cylinder"),
]


@pytest.mark.parametrize("kw,kind", REGIONS)
def test_curved_regions(kw, kind):
    cls = {"sphere": "RegionSphere", "cylinder": "RegionCylinder"}[kind]
    jr, pr = getattr(jgeom, cls)(**kw), getattr(pgeom, cls)(**kw)
    r = np.random.default_rng(11)
    pts = r.uniform(-2.0, 5.0, (4000, 3))
    pts[:8] = np.asarray(jr.lo)        # on the bounds, inclusive faces
    pts[8:16] = np.asarray(jr.hi)
    for dt in (np.float64, np.float32):
        want = np.asarray(jr.match(jnp.asarray(pts.astype(dt))))
        got = pr.match(torch.from_numpy(pts.astype(dt))).numpy()
        assert np.array_equal(got, want)
    assert pr.lo == jr.lo and pr.hi == jr.hi and pr.volume == jr.volume


def test_cylinder_axis_refused():
    with pytest.raises(ValueError, match="axis"):
        pgeom.RegionCylinder(axis="w", c1=0, c2=0, radius=1, lo_axis=0,
                             hi_axis=1)
