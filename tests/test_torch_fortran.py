"""native/obmd.f90, the Fortran module over the C library API, against the
port's C API (obmd_tpu_torch/csrc/obmdc_torch.cpp): tests/test_fortran.py's
interface checks (every bind(c) name defined, with the same argument count
and function or subroutine kind), the port's ten extern "C" definitions
equal to native/obmdc.cpp's in name, return type and parameter list, and
exported by the built library; then, where a Fortran compiler exists,
tests/test_fortran.py's client compiled against the module and the port's
library and run on the plain versions."""
import ctypes
import os
import re
import shutil
import subprocess
import sys
import sysconfig

import pytest

from obmd_tpu_torch import _build

from tests.test_fortran import (CLIENT_F90, _parse_c_protos,
                                _parse_f90_interfaces, _write_deck)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F90 = os.path.join(ROOT, "native", "obmd.f90")
JAX_CPP = os.path.join(ROOT, "native", "obmdc.cpp")
PORT_CPP = os.path.join(ROOT, "obmd_tpu_torch", "csrc", "obmdc_torch.cpp")
SYMBOLS = ("obmd_open", "obmd_last_error", "obmd_command", "obmd_file",
           "obmd_get_natoms", "obmd_get_thermo", "obmd_gather",
           "obmd_gather_int", "obmd_scatter", "obmd_close")


def _read(path):
    with open(path) as fh:
        return fh.read()


def _signatures(cpp):
    """extern-C name -> its definition's head (return type, name and
    parameter list, whitespace folded)."""
    joined = re.sub(r"\s+", " ", cpp)
    return {m.group(2): m.group(0) for m in re.finditer(
        r"(void\s*\*|const char\s*\*|long long|double|int|void) "
        r"(obmd_\w+)\s*\(([^)]*)\)", joined)}


def test_fortran_module_binds_the_port():
    cpp = _read(PORT_CPP)
    bound = _parse_f90_interfaces(_read(F90))
    protos = _parse_c_protos(cpp)
    assert len(bound) >= 9, sorted(bound)
    for name, (nargs, is_fn) in bound.items():
        assert name in protos, f"{name} not defined in obmdc_torch.cpp"
        assert protos[name] == (nargs, is_fn), (name, protos[name])


def test_the_ten_symbols_as_the_jax_abi():
    jax_sigs, port_sigs = _signatures(_read(JAX_CPP)), _signatures(
        _read(PORT_CPP))
    assert set(SYMBOLS) <= set(jax_sigs)
    for sym in SYMBOLS:
        assert port_sigs.get(sym) == jax_sigs[sym], sym
    lib = ctypes.CDLL(str(_build.capi_library()))
    for sym in SYMBOLS:
        assert hasattr(lib, sym), sym


def test_fortran_client_runs_deck(tmp_path):
    fc = shutil.which("gfortran") or shutil.which("flang")
    if fc is None:
        pytest.skip("no Fortran compiler here (gfortran or flang): the "
                    "module's bindings are checked against the port's C "
                    "API above")
    lib = str(_build.capi_library())
    libdir = sysconfig.get_config_var("LIBDIR")
    src = tmp_path / "client.f90"
    src.write_text(CLIENT_F90)
    exe = tmp_path / "client"
    subprocess.run(
        [fc, F90, str(src), "-o", str(exe), "-J", str(tmp_path), lib,
         "-L" + libdir, "-lpython%d.%d" % sys.version_info[:2],
         "-Wl,-rpath," + os.path.dirname(lib), "-Wl,-rpath," + libdir],
        check=True, cwd=str(tmp_path))
    deck, n = _write_deck(tmp_path)
    env = dict(os.environ, OBMD_PLATFORM="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    p = subprocess.run([str(exe), str(deck)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, (p.stdout[-300:], p.stderr[-500:])
    out = p.stdout.strip().splitlines()[-1]
    assert f"natoms={n}" in out and "step=15." in out, out
    assert "id1=1" in out and f"idn={n}" in out, out
