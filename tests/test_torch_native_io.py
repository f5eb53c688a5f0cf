"""The port's native I/O (obmd_tpu_torch/io/native.py over
csrc/obmdio.cpp) against the JAX package's (obmd_tpu/io/native.py over
native/libobmdio.so) and against the port's own Python paths.

Reading: seeded data files of every style the native reader takes read to
the same fields, dtype for dtype, as the JAX package's read_data_native
and the port's _read_data_py; `bond` reads in Python; a malformed file
ends as the JAX package's read_data ends.  Writing, on one seeded state
carried across by convert: the 11-column custom frame is the same bytes
as the JAX package's native frame and within the %.6f rounding of the
port's Python frame; the xyz frame is the same bytes as both JAX writers;
the 8-column frame is written in Python.  The build goes to csrc/build/
and leaves native/ as it was; with the loader switched off the Python
paths run."""
import dataclasses
import os

import numpy as np
import pytest

from obmd_tpu.io import dump as jdump
from obmd_tpu.io import lammps_data as jio
from obmd_tpu.io import native as jnative
from obmd_tpu_torch import _build
from obmd_tpu_torch.io import dump as pdump
from obmd_tpu_torch.io import lammps_data as pio
from obmd_tpu_torch.io import native as pnative

from tests.test_torch_io_formats import _states

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(ROOT, "native")
COLS11 = pdump.NATIVE_CUSTOM_COLS
# %.6f rounds a float32 value to within half a unit of its last place; the
# Python frame's str() reads back to the float32 value itself
ROUND_6F = 5.1e-7


@pytest.fixture
def jax_native():
    """The JAX package's native library, as its tests find it (never
    built here: its loader would run make inside native/)."""
    if not os.path.exists(jnative._LIB_PATH) or not jnative.available():
        pytest.skip("native/libobmdio.so is absent or does not load")
    return jnative


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(pnative, "_load", lambda: None)


def _data_file(style, seed=4, n=80):
    r = np.random.default_rng(seed)
    mol = style in ("molecular", "full", "adress")
    topo = style == "molecular"
    return pio.DataFile(
        natoms=n, ntypes=3, box_lo=np.asarray([-1.5, 0.0, 0.25]),
        box_hi=np.asarray([9.0, 6.5, 7.75]),
        masses=np.asarray([1.0, 2.5, 0.75]),
        x=r.uniform(-1.0, 6.0, (n, 3)),
        types=r.integers(0, 3, n).astype(np.int32),
        tags=r.permutation(np.arange(1, n + 1)).astype(np.int32),
        v=r.normal(0, 1, (n, 3)) if seed % 2 == 0 else None,
        q=r.normal(0, 0.5, n) if style in ("charge", "full") else None,
        mol=r.integers(1, 20, n).astype(np.int32) if mol else None,
        bonds=np.asarray([(1, 2), (2, 3), (3, 4), (5, 9)]) if mol else None,
        angles=np.asarray([(1, 1, 2, 3), (2, 2, 3, 4)]) if topo else None,
        dihedrals=np.asarray([(1, 1, 2, 3, 4)]) if topo else None,
        impropers=np.asarray([(1, 1, 2, 3, 4)]) if topo else None)


def _assert_same(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            assert a is None, f.name
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (f.name, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b), f.name


@pytest.mark.parametrize("style,seed", [
    ("atomic", 4), ("atomic", 5), ("charge", 6), ("molecular", 8),
    ("molecular", 9), ("full", 10), ("adress", 12)])
def test_read_styles(tmp_path, jax_native, style, seed):
    path = str(tmp_path / f"{style}.data")
    pio.write_data(path, _data_file(style, seed), atom_style=style)
    got = pnative.read_data_native(path, style)
    _assert_same(got, jnative.read_data_native(path, style))
    _assert_same(got, pio._read_data_py(path, style))
    _assert_same(pio.read_data(path, style), got)


def test_bond_style_reads_in_python(tmp_path, monkeypatch):
    path = str(tmp_path / "bond.data")
    pio.write_data(path, _data_file("molecular", 6), atom_style="bond")

    def refuse(*a, **k):
        raise AssertionError("the native reader was called for bond")
    monkeypatch.setattr(pnative, "read_data_native", refuse)
    _assert_same(pio.read_data(path, "bond"),
                 pio._read_data_py(path, "bond"))


@pytest.mark.parametrize("case", ["columns", "missing"])
def test_malformed_file_ends_as_jax(tmp_path, jax_native, case):
    """A file with fewer Atoms columns than `full` takes and a missing
    file: the native reader refuses, and both packages' read_data end in
    the Python parser's error."""
    path = str(tmp_path / "m.data")
    if case == "columns":
        pio.write_data(path, _data_file("adress"), atom_style="adress")
        with pytest.raises(OSError, match="expects 7"):
            pnative.read_data_native(path, "full")
    errors = []
    for read in (jio.read_data, pio.read_data):
        with pytest.raises(Exception) as e:
            read(path, atom_style="full")
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


def _first_frame_rows(path, dtype=np.float64):
    """The first custom frame's rows, each value read as `dtype`, as
    float64."""
    lines = open(path).read().splitlines()
    rows = lines[9:9 + int(lines[3])]
    return np.asarray([[dtype(v) for v in ln.split()] for ln in rows],
                      dtype=np.float64)


def test_frames(tmp_path, jax_native, monkeypatch):
    jcfg, jst, pcfg, pst = _states(seed=11)
    j11, p11 = tmp_path / "jax.custom", tmp_path / "port.custom"
    for append in (False, True):
        assert jnative.write_dump_custom_native(str(j11), jcfg, jst, append)
        pdump.write_custom_frame(str(p11), pcfg, pst, cols=COLS11,
                                 append=append)
    assert p11.read_bytes() == j11.read_bytes()
    # the xyz frame: the JAX package's native and Python writers agree
    jx, px = tmp_path / "jax.xyz", tmp_path / "port.xyz"
    jdump.write_xyz_frame(str(jx), jcfg, jst, append=False)
    pdump.write_xyz_frame(str(px), pcfg, pst, append=False)
    assert px.read_bytes() == jx.read_bytes()
    monkeypatch.setattr(jnative, "write_xyz_native", lambda *a, **k: False)
    jdump.write_xyz_frame(str(jx), jcfg, jst, append=False)
    assert px.read_bytes() == jx.read_bytes()
    # the 11-column frame's values within %.6f of the port's Python frame
    monkeypatch.setattr(pnative, "_load", lambda: None)
    py11 = tmp_path / "python.custom"
    pdump.write_custom_frame(str(py11), pcfg, pst, cols=COLS11,
                             append=False)
    nat = _first_frame_rows(str(p11))
    pyt = _first_frame_rows(str(py11), np.float32)
    assert np.array_equal(nat[:, :2], pyt[:, :2])
    assert np.abs(nat[:, 2:] - pyt[:, 2:]).max() <= ROUND_6F


def test_eight_columns_stay_python(tmp_path, monkeypatch):
    jcfg, jst, pcfg, pst = _states(seed=13)

    def refuse(*a, **k):
        raise AssertionError("the native writer was called")
    monkeypatch.setattr(pnative, "write_dump_custom_native", refuse)
    monkeypatch.setattr(jnative, "write_dump_custom_native", refuse)
    a, b = tmp_path / "jax.custom", tmp_path / "port.custom"
    jdump.write_custom_frame(str(a), jcfg, jst)
    pdump.write_custom_frame(str(b), pcfg, pst)
    assert b.read_bytes() == a.read_bytes()


def _listing(folder):
    return sorted((e.name, e.stat().st_mtime_ns) for e in os.scandir(folder))


def test_build_leaves_native_alone(tmp_path, monkeypatch):
    before = _listing(NATIVE_DIR)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build.HOST_LIBRARIES["obmdio"]
    secs = _build.build_all([], [lib])
    out = lib.library_path()
    assert out.parent == tmp_path / "build" and out.exists()
    assert secs["obmdio"] > 0 and not list(out.parent.glob("*.tmp"))
    assert _listing(NATIVE_DIR) == before
    monkeypatch.undo()
    assert pnative.available() and _listing(NATIVE_DIR) == before
    assert lib.library_path().parent == _build.CSRC / "build"


def test_python_paths_without_the_library(tmp_path, no_native,
                                          monkeypatch):
    assert not pnative.available()
    path = str(tmp_path / "full.data")
    pio.write_data(path, _data_file("full"), atom_style="full")
    _assert_same(pio.read_data(path, "full"), pio._read_data_py(path, "full"))
    jcfg, jst, pcfg, pst = _states(seed=15)
    monkeypatch.setattr(jnative, "write_dump_custom_native",
                        lambda *a, **k: False)
    a, b = tmp_path / "jax.custom", tmp_path / "port.custom"
    jdump.write_custom_frame(str(a), jcfg, jst, cols=COLS11)
    pdump.write_custom_frame(str(b), pcfg, pst, cols=COLS11)
    assert b.read_bytes() == a.read_bytes()


@pytest.fixture
def fresh_loader(monkeypatch, tmp_path):
    """The loader as at import, building into an empty folder."""
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_tried", False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return monkeypatch


def test_no_compiler_takes_the_python_paths(fresh_loader):
    def no_cxx():
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    fresh_loader.setattr(_build, "cxx_path", no_cxx)
    assert not pnative.available()
    assert pnative.read_data_native("absent.data") is None


def test_failed_build_raises_with_the_compiler_output(fresh_loader,
                                                      tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "obmdio.cpp").write_text("int obmdio_broken( {\n")
    fresh_loader.setattr(_build, "CSRC", csrc)
    for _ in range(2):   # the failure is not remembered as "unavailable"
        with pytest.raises(RuntimeError, match="obmdio.cpp.*rc=") as err:
            pnative.available()
        assert "obmdio_broken" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))
